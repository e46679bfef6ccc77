from .pipeline import (  # noqa: F401
    criteo_like_batch,
    lm_token_batch,
    make_gnn_batch,
    pad_gnn_batch,
)
