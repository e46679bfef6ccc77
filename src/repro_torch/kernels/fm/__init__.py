from .ops import fm_interaction, fm_interaction_train  # noqa: F401
from .ref import (  # noqa: F401
    fm_interaction_bwd_ref, fm_interaction_naive, fm_interaction_ref)
from .kernel import (  # noqa: F401
    fm_interaction_bwd_kernel, fm_interaction_kernel)
