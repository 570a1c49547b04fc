"""The JAX package's ``examples/`` for the port, each runnable as
``python -m repro_torch.examples.<quickstart | serve_kv | delegated_moe |
train_lm>`` (on the card by default; ``--device cpu`` for the plain
paths)."""
