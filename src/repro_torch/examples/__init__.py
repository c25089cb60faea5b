"""One-rank twins of the JAX package's ``examples/`` on the port:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.learned_levels [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_gpt_qsdp --steps 300 [--device cpu]

Each runs on the card unless given ``--device cpu``, on the (1, 1) mesh.
The twin of ``examples/serve_batched.py`` comes with the serve benchmark's
port (ROADMAP A10d).
"""
