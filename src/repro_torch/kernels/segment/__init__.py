from .ops import embedding_bag, pad_sorted_edges, segment_sum_sorted  # noqa: F401
from .ref import embedding_bag_ref, segment_sum_ref  # noqa: F401
from .kernel import (  # noqa: F401
    CHUNK_ROWS, FORMS, chunk_plan, row_ranges, segment_sum_kernel)
