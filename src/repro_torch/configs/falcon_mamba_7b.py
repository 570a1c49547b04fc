"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) d_ff=0
vocab=65024, ssm_state=16, d_conv 4, expand 2 (d_inner 8192, dt_rank
256) — a pure Mamba-1 stack: every layer is a selective-SSM mixer, with
no attention and no FFN (values copied from the JAX package's configs).
Like the JAX config it has no RMS norms on B, C and dt, which the
published model has."""
from .base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    block_pattern=("mamba",),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2410.05355; hf:tiiuae/falcon-mamba-7b",
)

SMOKE = CONFIG.with_overrides(
    name="falcon-mamba-7b-smoke", n_layers=2, d_model=64,
    vocab_size=512, mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
)
