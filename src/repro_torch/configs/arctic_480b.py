"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 (d_ff_expert 4864) beside a dense
residual MLP in every layer (values copied from the JAX package's
configs).  At 16 trustees its 56 heads pad to 64 (8 experts a trustee);
at 4 they split as they are.  About 13.6 B parameters a layer, so one
card serves it at 2 of its 35 layers (27.68 B parameters, 55.4 GB of
bf16 weights)."""
from .base import FFN_MOE_DENSE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    ffn_kind=FFN_MOE_DENSE,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864),
    source="hf:Snowflake/snowflake-arctic-base",
)

SMOKE = CONFIG.with_overrides(
    name="arctic-480b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96),
    vocab_size=512,
)
