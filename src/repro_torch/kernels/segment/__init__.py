from .ops import embedding_bag, pad_sorted_edges, segment_sum_sorted  # noqa: F401
from .ref import embedding_bag_ref, segment_sum_ref  # noqa: F401
from .kernel import row_ranges, segment_sum_kernel  # noqa: F401
