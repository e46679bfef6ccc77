from .ops import (  # noqa: F401
    embedding_bag, embedding_gather, gather_aggregate, moe_combine,
    moe_dispatch, pad_sorted_edges, segment_aggregate, segment_sum_sorted)
from .ref import embedding_bag_ref, segment_sum_bwd_ref, segment_sum_ref  # noqa: F401
from .kernel import (  # noqa: F401
    CHUNK_ROWS, FORMS, segment_sum_kernel)
from .embedding_bwd import embedding_bwd_kernel, embedding_bwd_ref  # noqa: F401
from .dispatch_bwd import dispatch_bwd_kernel, dispatch_bwd_ref  # noqa: F401
