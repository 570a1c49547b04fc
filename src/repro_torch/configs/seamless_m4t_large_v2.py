"""seamless-m4t-large-v2 [audio] — 24 encoder + 24 decoder layers,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 (padded to 256,256 for
the vocab shards) — the encoder-decoder backbone (``models/encdec.py``);
the speech frontend is a stub, as in JAX: the encoder takes precomputed
frame embeddings (B, S_src, d_model) (values copied from the JAX
package's configs)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    is_encoder_decoder=True, n_encoder_layers=24,
    input_mode="embeds",
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
)

SMOKE = CONFIG.with_overrides(
    name="seamless-m4t-large-v2-smoke", n_layers=2, n_encoder_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
)
