"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40, MHA) d_ff=27392
vocab=152064 — QKV bias (values copied from the JAX package's configs).
On one card with T stacked trustee shards the 40 heads are padded to a
multiple of T (none at T = 1, 2, 4, 5 or 8), as JAX pads them for its
mesh."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-32B",
)

SMOKE = CONFIG.with_overrides(
    name="qwen1.5-32b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512,
)
