"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 (the
dense first layer) vocab=102400, MoE 64 routed experts top-6 + 2 shared,
MLA kv_lora=512, q nope/rope 128/64, v 128 (values copied from
repro/configs)."""
from .base import ATTN_MLA, FFN_MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    attn_kind=ATTN_MLA, mla_kv_lora_rank=512,
    mla_q_nope_dim=128, mla_q_rope_dim=64, mla_v_head_dim=128,
    ffn_kind=FFN_MOE,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408),
    first_layer_dense=True,
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite",
)

SMOKE = CONFIG.with_overrides(
    name="deepseek-v2-lite-16b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=96,
    mla_kv_lora_rank=32, mla_q_nope_dim=16, mla_q_rope_dim=8,
    mla_v_head_dim=16,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared=1, d_ff_expert=96),
    vocab_size=512,
)
