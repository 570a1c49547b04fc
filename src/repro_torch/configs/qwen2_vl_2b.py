"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE over (t, h, w) sections (16, 24, 24) of the 64
frequencies, QKV bias (values copied from the JAX package's configs).
The vision frontend is a stub, as in JAX: the model takes precomputed
patch / text embeddings (B, S, d_model) and the (3, B, S) position
streams."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    input_mode="embeds",
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B",
)

SMOKE = CONFIG.with_overrides(
    name="qwen2-vl-2b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    mrope_sections=(2, 3, 3),
)
