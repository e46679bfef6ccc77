from .pipeline import (  # noqa: F401
    build_triplets,
    criteo_like_batch,
    lm_token_batch,
    make_gnn_batch,
    molecule_batch,
    pad_gnn_batch,
)
