"""GQA attention: the prefill/train forward, decode against the
sequence-sharded KV cache, and decode against the delegated page table's
paged pool (the torch counterparts of ``repro.models.attention``).

Parameters are a dict of tensors in the JAX layout — ``w_q`` (D, Hq*Dh),
``w_k`` / ``w_v`` (D, Hkv*Dh), ``w_o`` (Hq*Dh, D), ``b_q`` / ``b_k`` /
``b_v`` with QKV bias, ``q_norm`` / ``k_norm`` with QK norm — so
``convert`` carries JAX weights across as they are; the (padded) head
counts are read off their shapes.  The four projections are plain
``torch.matmul`` (the JAX package leaves them to XLA).  The prefill's
attention is the flash-attention kernel when ``run.use_pallas``; the paged
decode's is the paged-attention kernel.

Decode (``decode_attention``) keeps the JAX package's trustee pattern: the
KV cache's sequence axis is split over T trustees, stacked on one device
as a leading dimension, ``(T, B, Hkv, max_len / T, Dh)``.  Each step PUTs
the new (k, v) row into the shard that owns its position, every shard
answers the query with partial softmax stats (o, m, l) over its own
positions, and ``_merge_stats`` combines them — the JAX ``shard_map``
island, written as one computation batched over the shard dimension.

MLA (``mla_attention``, ``_mla_decode``) and M-RoPE raise
``NotImplementedError`` (ROADMAP queue A 13).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..configs.base import ATTN_MLA, ModelConfig
from ..kernels import ops as kops
from ..kernels import ref as kref
from .layers import apply_rope, init_rmsnorm, rmsnorm

BLOCKWISE_THRESHOLD = 2048
NEG_INF = -1e30


def _unported(cfg: ModelConfig) -> None:
    if cfg.attn_kind == ATTN_MLA:
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP queue A 13)")
    if cfg.mrope_sections:
        raise NotImplementedError(
            "M-RoPE is not ported yet (ROADMAP queue A 13)")


def padded_heads(cfg: ModelConfig, model_axis: int = 1) -> Tuple[int, int]:
    """(n_q_heads_padded, n_kv_heads_padded) for a model axis of
    ``model_axis`` shards, as the JAX package pads them for its mesh."""
    t = model_axis
    hq = cfg.n_heads
    hqp = ((hq + t - 1) // t) * t
    hkv = cfg.n_kv_heads
    if hkv == hq:                      # MHA: pad kv alongside q
        hkvp = hqp
    else:                              # GQA: keep kv; needs hqp % hkv == 0
        hkvp = hkv
        if hqp % hkvp:
            raise ValueError(f"{hqp} padded query heads do not group over "
                             f"{hkvp} KV heads")
    return hqp, hkvp


def kv_sharded(cfg: ModelConfig, model_axis: int = 1) -> bool:
    _, hkvp = padded_heads(cfg, model_axis)
    return hkvp % model_axis == 0


def init_attention(cfg: ModelConfig, dtype=torch.float32, device=None,
                   seed: int = 0, model_axis: int = 1,
                   gen: torch.Generator = None, lead: tuple = ()
                   ) -> Dict[str, torch.Tensor]:
    """Random GQA attention weights: from ``gen`` (drawn on its device),
    else from a CPU generator seeded with ``seed`` — not JAX's numbers;
    tests carry JAX weights through ``convert``.  ``lead`` prefixes a
    stacked layer dimension."""
    _unported(cfg)
    hqp, hkvp = padded_heads(cfg, model_axis)
    dh = cfg.resolved_head_dim
    d = cfg.d_model
    if gen is None:
        gen = torch.Generator().manual_seed(seed)
    s = 1.0 / d ** 0.5

    def proj(hout, live):
        w = torch.randn(lead + (d, hout * dh), generator=gen,
                        device=gen.device) * s
        if live < hout:                # zero the padding heads
            w = w.reshape(lead + (d, hout, dh))
            w[..., live:, :] = 0.0
            w = w.reshape(lead + (d, hout * dh))
        return w.to(dtype).to(device)

    p = {"w_q": proj(hqp, cfg.n_heads),
         "w_k": proj(hkvp, cfg.n_kv_heads),
         "w_v": proj(hkvp, cfg.n_kv_heads)}
    p["w_o"] = proj(hqp, cfg.n_heads).transpose(-2, -1).reshape(
        lead + (hqp * dh, d)).contiguous()
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros(lead + (hqp * dh,), dtype=dtype, device=device)
        p["b_k"] = torch.zeros(lead + (hkvp * dh,), dtype=dtype,
                               device=device)
        p["b_v"] = torch.zeros(lead + (hkvp * dh,), dtype=dtype,
                               device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, device=device, lead=lead)
        p["k_norm"] = init_rmsnorm(dh, device=device, lead=lead)
    return p


def _heads(params, cfg: ModelConfig) -> Tuple[int, int, int]:
    """(padded query heads, padded KV heads, head dim) of a layer's
    weights."""
    dh = cfg.resolved_head_dim
    return params["w_q"].shape[-1] // dh, params["w_k"].shape[-1] // dh, dh


def _project_qkv(params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig):
    """x (B, S, D), positions (B, S) -> rotated q (B, S, Hq, Dh), rotated
    k and v (B, S, Hkv, Dh)."""
    hqp, hkvp, dh = _heads(params, cfg)
    b, s, _ = x.shape
    q = torch.matmul(x, params["w_q"])
    k = torch.matmul(x, params["w_k"])
    v = torch.matmul(x, params["w_v"])
    if cfg.qkv_bias:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    q = q.reshape(b, s, hqp, dh)
    k = k.reshape(b, s, hkvp, dh)
    v = v.reshape(b, s, hkvp, dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


# ---------------------------------------------------------------------------
# prefill / train forward
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, causal: bool = True, scale=None,
                        q_offset: int = 0, block_k: int = 1024):
    """The plain path for long sequences (``attention.blockwise_attention``):
    q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D); KV blocks of ``block_k``
    carrying a running f32 (m, l, acc), so no (Sq, Skv) score matrix is
    held — O(Sq * block_k) memory."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    block_k = min(block_k, skv)
    if skv % block_k:
        raise ValueError(f"Skv {skv} is not a multiple of the block "
                         f"{block_k}")
    qf = q.float().reshape(b, hkv, rep, sq, dh) * scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hkv, rep, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, rep, sq), device=q.device)
    acc = torch.zeros((b, hkv, rep, sq, dh), device=q.device)
    for j in range(0, skv, block_k):
        s = torch.einsum("bgrqd,bgkd->bgrqk", qf,
                         k[:, :, j:j + block_k].float())
        if causal:
            kpos = j + torch.arange(block_k, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.max(dim=-1).values)
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrqk,bgkd->bgrqd", p, v[:, :, j:j + block_k].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, dh).to(q.dtype)


def _core_attention(q, k, v, run, causal: bool = True, q_offset: int = 0):
    """q (B, S, Hq, D), k / v (B, S, Hkv, D) -> (B, S, Hq, D): the
    flash-attention kernel when ``run.use_pallas`` (its plain version on
    CPU tensors), else the plain path — blockwise at 2048 positions and
    up, as in JAX."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if run is not None and run.use_pallas:
        out = kops.flash_attention(qt, kt, vt, q_offset=q_offset,
                                   causal=causal, impl="kernel")
    elif max(q.shape[1], k.shape[1]) >= BLOCKWISE_THRESHOLD:
        out = blockwise_attention(qt, kt, vt, causal=causal,
                                  q_offset=q_offset)
    else:
        out = kops.flash_attention(qt, kt, vt, q_offset=q_offset,
                                   causal=causal, impl="ref")
    return out.transpose(1, 2)


def attention(params, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, run=None) -> torch.Tensor:
    """x (B, S, D); positions (B, S) -> (B, S, D)."""
    _unported(cfg)
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, positions, cfg)
    out = _core_attention(q, k, v, run).reshape(b * s, -1)
    return torch.matmul(out, params["w_o"]).reshape(b, s, cfg.d_model)


# ---------------------------------------------------------------------------
# decode against the sequence-sharded KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None, n_trustees: int = 1, model_axis: int = 1,
                  lead: tuple = ()) -> Dict[str, torch.Tensor]:
    """Zero K and V caches, ``(T, B, Hkv, max_len / T, Dh)``: trustee t
    owns positions [t * max_len / T, (t + 1) * max_len / T) — the JAX
    cache ``(B, Hkv, max_len, Dh)`` with its sequence axis sharded over
    the model axis, stacked.  ``lead`` prefixes a stacked layer
    dimension."""
    _unported(cfg)
    if max_len % n_trustees:
        raise ValueError(f"max_len {max_len} does not split over "
                         f"{n_trustees} trustees")
    _, hkvp = padded_heads(cfg, model_axis)
    shape = lead + (n_trustees, batch, hkvp, max_len // n_trustees,
                    cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _merge_stats(o, m, l):
    """o (T, B, H, D) unnormalised; m, l (T, B, H) -> (B, H, D)."""
    m_g = m.max(dim=0).values
    w = torch.exp(m - m_g[None])
    l_g = (l * w).sum(dim=0)
    o_g = (o * w[..., None]).sum(dim=0)
    return o_g / torch.clamp(l_g, min=1e-30)[..., None]


def decode_attention(params, x: torch.Tensor, pos: torch.Tensor, cache,
                     cfg: ModelConfig, run=None):
    """One-token decode against the stacked, sequence-sharded KV cache.

    x (B, D) new-token activations; pos (B,) its positions; cache from
    ``init_kv_cache``.  Returns (y (B, D), cache) — the cache updated IN
    PLACE (JAX returns a new one): the delegated PUT writes the new row
    into its owner's shard only.  Every shard then answers the query over
    its own positions with (o, m, l), and the merge combines them."""
    _unported(cfg)
    hqp, hkvp, dh = _heads(params, cfg)
    b = x.shape[0]
    q, k, v = _project_qkv(params, x[:, None, :], pos[:, None], cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]            # (B, H, Dh)
    ck, cv = cache["k"], cache["v"]
    t, _, _, s_loc, _ = ck.shape
    my = torch.arange(t, device=x.device)
    pos = pos.long()

    # the delegated PUT: trustee t keeps its own row unless it owns pos
    local = pos[None, :] - my[:, None] * s_loc          # (T, B)
    mine = (local >= 0) & (local < s_loc)
    lp = local.clamp(0, s_loc - 1)
    tt = my[:, None].expand(t, b)
    bb = torch.arange(b, device=x.device)[None, :].expand(t, b)
    for c, new in ((ck, k), (cv, v)):
        rows = c.permute(0, 1, 3, 2, 4)                  # (T, B, S, Hkv, Dh)
        rows.index_put_((tt, bb, lp), torch.where(
            mine[..., None, None], new[None].to(c.dtype), rows[tt, bb, lp]))

    # each trustee's partial attention over its positions
    kpos = my[:, None] * s_loc + torch.arange(s_loc, device=x.device)
    valid = kpos[:, None, :] <= pos[None, :, None]      # (T, B, S)
    rep = hqp // hkvp
    qg = q.float().reshape(b, hkvp, rep, dh)
    s = torch.einsum("bgrd,tbgsd->tbgrs", qg, ck.float()) / math.sqrt(dh)
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    m = s.max(dim=-1).values
    p = torch.exp(s - m[..., None])
    o = torch.einsum("tbgrs,tbgsd->tbgrd", p, cv.float())
    out = _merge_stats(o.reshape(t, b, hqp, dh), m.reshape(t, b, hqp),
                       p.sum(dim=-1).reshape(t, b, hqp)).to(q.dtype)
    y = torch.matmul(out.reshape(b, hqp * dh), params["w_o"])
    return y, cache


# ---------------------------------------------------------------------------
# decode against the delegated page table's paged pool
# ---------------------------------------------------------------------------

def init_paged_kv_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                       dtype=torch.float32, device=None,
                       model_axis: int = 1) -> Dict[str, torch.Tensor]:
    """A shared pool of KV pages: (P, Hkv, PS, Dh).  Page identities are
    GLOBAL ids handed out by ``core.pagetable.DelegatedPageTable``."""
    _, hkvp = padded_heads(cfg, model_axis)
    dh = cfg.resolved_head_dim
    shape = (n_pages, hkvp, page_size, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_decode_attention(params, x: torch.Tensor, pos: torch.Tensor, pool,
                           page_table: torch.Tensor, cfg: ModelConfig):
    """One-token decode against the paged KV pool.

    x (B, D) new-token activations; pos (B,) int token positions; pool from
    ``init_paged_kv_pool``; page_table (B, MP) int32 global page ids (-1
    pad): each row is the sequence's chain from the delegated page table,
    so ``page_table[b, pos[b] // PS]`` names the page the new token's KV
    row lands in.  Returns (y (B, D), pool) — the pool updated IN PLACE:
    the JAX ``.at[page, :, slot].set`` becomes an ``index_put_``, the page
    id clipped into [0, P) as in JAX.  Attention runs the paged-attention
    kernel (its plain version on CPU tensors)."""
    _, _, dh = _heads(params, cfg)
    b = x.shape[0]
    ps = pool["k"].shape[2]
    q, k, v = _project_qkv(params, x[:, None, :], pos[:, None], cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    lengths = (pos + 1).to(torch.int32)
    pos = pos.long()
    page = torch.gather(page_table, 1, (pos // ps)[:, None])[:, 0]
    page = torch.clamp(page, 0, pool["k"].shape[0] - 1).long()
    slot = pos % ps
    for name, val in (("k", k), ("v", v)):
        pool[name].permute(0, 2, 1, 3).index_put_(
            (page, slot), val.to(pool[name].dtype))
    out = kops.paged_attention(q, pool["k"], pool["v"], page_table, lengths)
    y = torch.matmul(out.reshape(b, -1), params["w_o"])
    return y, pool
