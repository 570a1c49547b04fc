"""Shared layers: RMSNorm, rotary embeddings, the gated MLP, embeddings
and logits (the torch counterparts of ``repro.models.layers``).
Parameters are plain dicts of tensors in the JAX layout; norms, RoPE and
the MLP's gate activation compute in f32 and return the input's dtype;
logits are f32.  ``delegated_softmax_xent`` is the training loss over T
vocab shards stacked on the device.

``dp_axes`` names the mesh axes that shard the batch (JAX's rule); the
layers here, the cross-entropy and the logits included, compute each
sequence on its own, so the data axis is the identity for them, and
only the MoE (``models.moe``) reads it: each data row delegates its own
sequences."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import meshctx

DP = ("pod", "data")   # the batch axes (the subset present in the mesh)


def dp_axes(run=None) -> Tuple[str, ...]:
    """The axes that shard the batch: the ambient override
    (``meshctx.set_batch_axes``, which ``launch.steps.build_cell``
    installs), else the ``pod`` / ``data`` axes of ``run.mesh`` (of the
    ambient mesh without a ``run``)."""
    override = meshctx.batch_axes()
    if override != "default":
        return tuple(override)
    names = run.mesh.axes if run is not None else \
        meshctx.current_mesh().axis_names
    return tuple(a for a in DP if a in names)


def dp_size(run=None) -> int:
    """The data-parallel factor: ``run.mesh``'s size over ``dp_axes``
    (1 without a ``run``)."""
    if run is None:
        return 1
    n = 1
    for a in dp_axes(run):
        if a in run.mesh.axes:
            n *= int(run.mesh.shape[run.mesh.axes.index(a)])
    return n


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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S), or (3, ..., S) for M-RoPE.
    Rotates the two halves of the last dimension (the JAX package's
    layout).

    M-RoPE (qwen2-vl): the D/2 frequencies are split into consecutive
    sections, of ``mrope_sections`` sizes, that take their angle from the
    (t, h, w) position streams respectively; with three equal streams it
    is plain RoPE, bit for bit."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    if mrope_sections:
        if positions.dim() < 2 or positions.shape[0] != len(mrope_sections):
            raise ValueError(f"M-RoPE takes {len(mrope_sections)} position "
                             f"streams, got positions of shape "
                             f"{tuple(positions.shape)}")
        if sum(mrope_sections) != d // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not sum "
                             f"to the {d // 2} frequencies of head dim {d}")
        # the section of each frequency: the section edges it has passed
        # (no size from data, so it builds on the meta device too)
        freq = torch.arange(d // 2, device=x.device)
        sec_id = torch.zeros_like(freq)                       # (D/2,)
        edge = 0
        for n in mrope_sections[:-1]:
            edge += n
            sec_id = sec_id + (freq >= edge).long()
        pos = positions.movedim(0, -1).float()                # (..., S, 3)
        angle = pos[..., sec_id] * freqs                      # (..., S, D/2)
    else:
        angle = positions.float()[..., None] * freqs          # (..., S, D/2)
    cos = torch.cos(angle)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(angle)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], -1).to(x.dtype)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _is_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def param_generator(device: torch.device, seed: int) -> torch.Generator:
    """The seeded generator a model's weights are drawn from on
    ``device``; on the meta device (shapes only: nothing is drawn) a CPU
    generator that nothing reads."""
    return torch.Generator(device="cpu" if _is_meta(device) else device) \
        .manual_seed(seed)


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 from ``gen`` on the generator's device,
    cast to ``dtype`` on ``device``; on the meta device an empty leaf of
    the shape, nothing drawn."""
    if _is_meta(device):
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=gen.device)
            .mul_(scale).to(dtype=dtype, device=device))


def _normal_stacked(gen: torch.Generator, lead: tuple, shape, scale: float,
                    dtype, device) -> torch.Tensor:
    """A ``lead + shape`` leaf of N(0, scale^2) values drawn one
    ``shape`` slice at a time into a preallocated ``dtype`` tensor, so the
    f32 draw never holds more than one slice (a stacked expert leaf of
    deepseek-v2-lite-16b is 4.8 B values: 19.2 GB drawn whole in f32;
    qwen1.5-32b's stacked w_gate 35.9 GB).  Every stacked leaf is drawn
    this way."""
    shape = tuple(shape)
    if not lead or _is_meta(device):
        return _normal(gen, tuple(lead) + shape, scale, dtype, device)
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
    stacked layer dimension (``_normal_stacked``)."""
    s_in, s_ff = 1.0 / d_model ** 0.5, 1.0 / d_ff ** 0.5
    return {"w_gate": _normal_stacked(gen, lead, (d_model, d_ff), s_in,
                                      dtype, device),
            "w_up": _normal_stacked(gen, lead, (d_model, d_ff), s_in, dtype,
                                    device),
            "w_down": _normal_stacked(gen, lead, (d_ff, d_model), s_ff,
                                      dtype, device)}


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


def _xent_chunk(x_c: torch.Tensor, w_l: torch.Tensor, labels_c: torch.Tensor,
                softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sequence chunk over the T stacked vocab shards: x_c (b, c, D),
    w_l (T, V/T, D), labels_c (b, c) -> (nll, accuracy) (b, c) f32.  Each
    shard holds its own logits (T, b*c, V/T); the max is a max over the
    shard dimension (JAX's ``pmax``, taken on the detached local maxima:
    the shift is gradient-neutral) and the sums are sums over it (its
    ``psum``); the label logit is a delegated GET, answered by the one
    shard that owns the label."""
    b, c, d = x_c.shape
    t, vl, _ = w_l.shape
    # bf16 values are exact in f32: the f32 product of the upcast operands
    # is JAX's bf16 einsum with preferred_element_type=f32
    logits = torch.matmul(x_c.float().reshape(1, b * c, d),
                          w_l.float().transpose(1, 2))       # (T, bc, V/T)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    m_loc = logits.max(dim=-1).values.detach()               # (T, bc)
    m = m_loc.max(dim=0).values                              # pmax
    se = torch.exp(logits - m[None, :, None]).sum(dim=-1)
    lse = torch.log(se.sum(dim=0)) + m                       # psum
    lab = labels_c.reshape(1, b * c).long() \
        - vl * torch.arange(t, device=x_c.device)[:, None]   # (T, bc)
    mine = (lab >= 0) & (lab < vl)
    lab_logit = torch.gather(logits, -1, lab.clamp(0, vl - 1)[..., None])
    lab_logit = torch.where(mine, lab_logit[..., 0],
                            torch.zeros_like(m_loc)).sum(dim=0)
    nll = lse - lab_logit
    # accuracy: the first argmax inside a shard, then the highest index
    # among the shards whose local max is the global one (JAX's pmax of
    # (value, index)); no gradient
    am_loc = logits.detach().argmax(dim=-1) \
        + vl * torch.arange(t, device=x_c.device)[:, None]
    am = torch.where(m_loc >= m, am_loc,
                     torch.full_like(am_loc, -1)).max(dim=0).values
    acc = (am == labels_c.reshape(b * c).long()).float()
    return nll.reshape(b, c), acc.reshape(b, c)


def delegated_softmax_xent(x: torch.Tensor, w_out: torch.Tensor,
                           labels: torch.Tensor, cfg,
                           mask: Optional[torch.Tensor] = None,
                           chunk: int = 512, n_shards: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy with vocab-sharded logits (JAX's
    ``repro.models.layers.delegated_softmax_xent``),
    the full (B, S, V) never materialised: w_out (V, D) is split into
    ``n_shards`` = T vocab shards stacked on the device, (T, V/T, D),
    shard k owning rows [k V/T, (k+1) V/T).  The sequence goes in chunks
    of ``c = min(chunk, S)`` positions (``c = S`` where it does not
    divide S), each chunk under ``torch.utils.checkpoint`` when there is
    more than one, so the f32 logits are bounded by (T, B * c, V/T) in
    both passes.  x (B, S, D), labels (B, S), mask (B, S) or None ->
    (mean nll, correct-token accuracy), both over the mask's positions."""
    v, d = w_out.shape
    if v % n_shards:
        raise ValueError(f"{v} vocab rows do not split over {n_shards} "
                         f"shards")
    w_l = w_out.reshape(n_shards, v // n_shards, d)
    s = x.shape[1]
    c = min(chunk, s)
    if s % c:
        c = s
    softcap = float(cfg.logit_softcap)
    if c == s:
        nll, acc = _xent_chunk(x, w_l, labels, softcap)
    else:
        # no random numbers: the generator's state is not saved (a
        # captured train step may not read it)
        outs = [checkpoint(_xent_chunk, x[:, i:i + c], w_l,
                           labels[:, i:i + c], softcap, use_reentrant=False,
                           preserve_rng_state=False)
                for i in range(0, s, c)]
        nll = torch.cat([o[0] for o in outs], dim=1)
        acc = torch.cat([o[1] for o in outs], dim=1)
    if mask is None:
        return nll.mean(), acc.mean()
    mf = mask.float()
    denom = torch.clamp(mf.sum(), min=1.0)
    return (nll * mf).sum() / denom, (acc * mf).sum() / denom
