"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000
— GeGLU, head_dim=256, tied embeddings scaled by sqrt(d_model) (values
copied from the JAX package's configs)."""
from .base import ACT_GELU, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    d_ff=24576, vocab_size=256000, head_dim=256,
    act=ACT_GELU, tie_embeddings=True, embed_scale=True,
    source="arXiv:2403.08295; hf:google/gemma-7b",
)

SMOKE = CONFIG.with_overrides(
    name="gemma-7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512, head_dim=16,
)
