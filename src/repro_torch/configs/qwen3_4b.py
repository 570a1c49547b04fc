"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA, head_dim=128 explicit (32 * 128 = 4096 !=
d_model, as in Qwen3) (values copied from the JAX package's configs)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-4B",
)

SMOKE = CONFIG.with_overrides(
    name="qwen3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
)
