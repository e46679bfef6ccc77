from .ops import fm_interaction  # noqa: F401
from .ref import fm_interaction_naive, fm_interaction_ref  # noqa: F401
from .kernel import fm_interaction_kernel  # noqa: F401
