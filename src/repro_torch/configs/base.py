"""The port's configuration dataclasses: the fields of
``repro.configs.base`` that the ported model path reads, with the same
names, defaults and derived helpers, so a configuration reads the same in
both packages.

``ModelConfig`` describes one architecture (``MoEConfig`` its routed
experts, ``MambaConfig`` its selective-SSM mixers), ``ShapeConfig`` one
(seq_len, global_batch, kind) input cell (``SHAPES`` the four production
cells), ``MeshConfig`` the (data, model)
mesh whose shards the port stacks on one device, and ``RunConfig`` couples
them with the precision, training and kernel settings the model paths
read.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

ATTN_GQA = "gqa"          # grouped-query attention (MHA/MQA as cases)
ATTN_MLA = "mla"          # DeepSeek multi-head latent attention
BLOCK_ATTN = "attn"
BLOCK_MAMBA = "mamba"
FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_MOE_DENSE = "moe+dense"   # Arctic-style: MoE with a dense residual
ACT_SILU = "silu"             # SwiGLU gating
ACT_GELU = "gelu"             # GeGLU gating


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    top_k: int = 0
    num_shared: int = 0             # shared (always-on) experts
    d_ff_expert: int = 0            # per-expert hidden size
    capacity_factor: float = 1.25   # primary slot capacity (paper: slot size)
    overflow: str = "second_round"  # "drop" | "second_round" | "defer"
    overflow_factor: float = 1.0    # overflow round capacity factor
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0     # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else -(-d_model // 16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # query heads
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    attn_kind: str = ATTN_GQA
    qkv_bias: bool = False
    qk_norm: bool = False
    mla_kv_lora_rank: int = 0        # MLA latent rank
    mla_q_nope_dim: int = 128
    mla_q_rope_dim: int = 64
    mla_v_head_dim: int = 128
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w)
    act: str = ACT_SILU
    ffn_kind: str = FFN_DENSE
    moe: MoEConfig = field(default_factory=MoEConfig)
    moe_every: int = 1               # layer i is MoE iff i % moe_every
    moe_offset: int = 0              # == moe_offset
    first_layer_dense: bool = False  # deepseek: layer 0 dense in MoE nets
    block_pattern: Tuple[str, ...] = ()   # empty = every layer attention
    mamba: MambaConfig = field(default_factory=MambaConfig)
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: embeds scaled by sqrt(d_model)
    logit_softcap: float = 0.0
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0        # 0 -> n_layers
    input_mode: str = "tokens"       # tokens | embeds
    norm_eps: float = 1e-6
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads == 0:
            return 0
        return self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        """Every layer a Mamba mixer (falcon-mamba-7b)."""
        return bool(self.block_pattern) and all(
            b == BLOCK_MAMBA for b in self.block_pattern)

    @property
    def has_subquadratic_context(self) -> bool:
        """Any Mamba layers (a block pattern): the architecture can serve
        a 500k-token decode on linear state (SSM / hybrid), as JAX's
        property says."""
        return bool(self.block_pattern)

    def block_kind(self, layer: int) -> str:
        if not self.block_pattern:
            return BLOCK_ATTN
        return self.block_pattern[layer % len(self.block_pattern)]

    def layer_ffn_kind(self, layer: int) -> str:
        if self.ffn_kind == FFN_DENSE:
            return FFN_DENSE
        if self.first_layer_dense and layer == 0:
            return FFN_DENSE
        if layer % self.moe_every == self.moe_offset:
            return self.ffn_kind
        return FFN_DENSE

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# the production cells of every architecture (JAX's four input shapes),
# the cells ``launch.dryrun`` sizes
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class MeshConfig:
    """The JAX mesh the port stands for, stacked on one card: its
    ``model`` axis is the trustee axis (the decode KV cache's sequence
    shards, the MoE's experts, the cross-entropy's vocab shards) and its
    ``pod`` / ``data`` axes shard the batch (each data row runs its own
    MoE round over the model-axis trustees)."""
    shape: Tuple[int, ...] = (1, 1)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def trustee_axis(self) -> str:
        return "model"

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_size(self) -> int:
        return self.shape[self.axes.index("model")]

    @property
    def data_size(self) -> int:
        n = 1
        for a, s in zip(self.axes, self.shape):
            if a in ("pod", "data"):
                n *= s
        return n


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    opt_dtype: str = "float32"       # AdamW moments
    grad_accum_dtype: str = "float32"  # the microbatches' grad accumulator
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_accum: int = 1              # microbatches a step
    remat: str = "dots"              # training only: "none" | "dots" | "full"
    zero_sharding: bool = True       # JAX: optimizer state over the data
                                     # axis; a layout with no counterpart
                                     # on one card (nothing reads it)
    grad_compression: str = "none"   # "none" | "int8" | "topk" (as in JAX,
                                     # no step reads it)
    sp_residual: bool = False        # sequence-parallel residual stream:
                                     # in JAX a sharding constraint only,
                                     # the identity on one card
    local_shortcut: bool = True      # MoE dispatch: self-addressed rows
                                     # skip the channel
    mla_absorb: bool = False         # MLA decode scores in latent space
    use_pallas: bool = False         # the port: the CUDA kernels if True
    unroll_layers: bool = False      # JAX's python-loop groups; the port
                                     # always loops
    xent_chunk: int = 512            # seq chunk of the delegated xent
    seed: int = 0


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
