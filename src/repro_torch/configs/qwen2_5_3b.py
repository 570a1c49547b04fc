"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias (values copied from the JAX package's
configs)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-3B",
)

SMOKE = CONFIG.with_overrides(
    name="qwen2.5-3b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512,
)
