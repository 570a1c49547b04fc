"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 (d_ff_expert 14336) on every second
layer — a period-8 group of Mamba-1 mixers with attention at position 4
(values copied from the JAX package's configs).  Four 8-layer groups;
51.57 B parameters, 103.1 GB of bf16 weights, so one card serves it at
two of its groups (16 layers, 26.05 B parameters)."""
from .base import FFN_MOE, MambaConfig, ModelConfig, MoEConfig

_PATTERN = ("mamba", "mamba", "mamba", "mamba",
            "attn", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    ffn_kind=FFN_MOE,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    moe_every=2, moe_offset=1,
    block_pattern=_PATTERN,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
)

SMOKE = CONFIG.with_overrides(
    name="jamba-v0.1-52b-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    vocab_size=512, mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
)
