"""The repository's examples on the port, one module each:

    python -m repro_torch.examples.quickstart [--n 2000]
    python -m repro_torch.examples.solve_web [--n 50000] [--k 16]
    python -m repro_torch.examples.gnn_partition
    python -m repro_torch.examples.serve_lm [--batch 8] [--gen 32]
    python -m repro_torch.examples.train_lm [--steps 200]

Each takes the flags of the example of the same name under ``examples/``
plus ``--device`` (``cuda``, the default, or ``cpu``), prints what that
example prints, and exposes ``main(argv) -> dict`` of the printed values.
"""
