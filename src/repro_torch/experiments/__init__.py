"""The paper's experiments on the port (the JAX package's ``benchmarks/``
twins): Theorem 2 / Corollary 3, Tables 1-3 and Figures 7/8.

    PYTHONPATH=src python -m repro_torch.experiments.run [--full] [--only X] [--device cpu]

Each module has its reference's flags (plus ``--device``), JSON file name
and keys, and PASS/FAIL gates at the reference's bands; results go under
``results/torch_bench`` unless told otherwise.
"""
