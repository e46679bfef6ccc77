from .ops import flash_attention  # noqa: F401
from .ref import attention_plain, dequantize  # noqa: F401
from .kernel import flash_attention_kernel  # noqa: F401
