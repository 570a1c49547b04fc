"""Shared layers: RMSNorm, rotary embeddings, the gated MLP, embeddings
and logits (the torch counterparts of ``repro.models.layers``).
Parameters are plain dicts of tensors in the JAX layout; norms, RoPE and
the MLP's gate activation compute in f32 and return the input's dtype;
logits are f32.  ``delegated_softmax_xent`` (training) waits for ROADMAP
queue A 13(d)."""
from __future__ import annotations

import torch


def init_rmsnorm(dim: int, dtype=torch.float32, device=None,
                 lead: tuple = ()):
    return {"scale": torch.ones(lead + (dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6,
            offset: float = 0.0) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (offset + params["scale"].float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S).  Rotates the two halves of
    the last dimension (the JAX package's layout)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    angle = positions.float()[..., None] * freqs              # (..., S, D/2)
    cos = torch.cos(angle)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(angle)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], -1).to(x.dtype)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 from ``gen`` on the generator's device,
    cast to ``dtype`` on ``device``."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            .mul_(scale).to(dtype=dtype, device=device))


def _normal_stacked(gen: torch.Generator, lead: tuple, shape, scale: float,
                    dtype, device) -> torch.Tensor:
    """A ``lead + shape`` leaf of N(0, scale^2) values drawn one
    ``shape`` slice at a time into a preallocated ``dtype`` tensor, so the
    f32 draw never holds more than one slice (a stacked expert leaf of
    deepseek-v2-lite-16b is 4.8 B values: 19.2 GB drawn whole in f32)."""
    shape = tuple(shape)
    if not lead:
        return _normal(gen, shape, scale, dtype, device)
    out = torch.empty(tuple(lead) + shape, dtype=dtype, device=device)
    flat = out.view((-1,) + shape)
    for i in range(flat.shape[0]):
        flat[i].copy_(_normal(gen, shape, scale, torch.float32, device))
    return out


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device=None, lead: tuple = ()) -> dict:
    """Random gate/up/down projections (from ``gen``: not JAX's numbers;
    tests carry JAX weights through ``convert``).  ``lead`` prefixes a
    stacked layer dimension."""
    s_in, s_ff = 1.0 / d_model ** 0.5, 1.0 / d_ff ** 0.5
    return {"w_gate": _normal(gen, lead + (d_model, d_ff), s_in, dtype,
                              device),
            "w_up": _normal(gen, lead + (d_model, d_ff), s_in, dtype,
                            device),
            "w_down": _normal(gen, lead + (d_ff, d_model), s_ff, dtype,
                              device)}


def mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """x (..., D) -> (..., D): the gate's activation in f32, cast back to
    x's dtype before the product with ``up`` (``layers.py:113-127``)."""
    g = torch.matmul(x, params["w_gate"])
    u = torch.matmul(x, params["w_up"])
    gf = g.float()
    if act == "silu":
        a = torch.nn.functional.silu(gf)
    else:
        a = torch.nn.functional.gelu(gf, approximate="tanh")
    return torch.matmul(a.to(x.dtype) * u, params["w_down"])


# ---------------------------------------------------------------------------
# Embedding and logits
# ---------------------------------------------------------------------------

def padded_vocab(cfg, model_axis: int = 1) -> int:
    mult = max(model_axis, 128)
    return ((cfg.vocab_size + mult - 1) // mult) * mult


def init_embed(gen: torch.Generator, cfg, dtype, device=None,
               model_axis: int = 1) -> dict:
    v = padded_vocab(cfg, model_axis)
    params = {"embedding": _normal(gen, (v, cfg.d_model), 0.02, dtype,
                                   device)}
    if not cfg.tie_embeddings:
        params["unembed"] = _normal(gen, (v, cfg.d_model), 0.02, dtype,
                                    device)
    return params


def embed_lookup(params, ids: torch.Tensor, cfg) -> torch.Tensor:
    """ids (B, S) -> (B, S, D): a row read of the table (the JAX package's
    vocab-sharded ``take``; the port's table is whole on one device)."""
    x = params["embedding"][ids.long()]
    if cfg.embed_scale:
        x = (x.float() * cfg.d_model ** 0.5).to(x.dtype)
    return x


def unembed_weight(params, cfg) -> torch.Tensor:
    return params.get("unembed", params["embedding"])


def lm_logits(x: torch.Tensor, w_out: torch.Tensor, cfg) -> torch.Tensor:
    """(B, D) x (V, D) -> (B, V) logits accumulated AND returned in f32
    (JAX's ``preferred_element_type=f32``): a bf16 logits tensor would
    change greedy argmax ties."""
    # bf16 values are exact in f32: the f32 product of the upcast operands
    # is the bf16 product with an f32 accumulator and an f32 result
    logits = torch.matmul(x.float(), w_out.float().T)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
