from .ops import (  # noqa: F401
    attention_train_plain, flash_attention, flash_attention_train)
from .ref import attention_bwd_plain, attention_plain, dequantize  # noqa: F401
from .kernel import flash_attention_kernel  # noqa: F401
from .backward import flash_attention_bwd  # noqa: F401
