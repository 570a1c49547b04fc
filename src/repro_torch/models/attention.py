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
positions, and ``merge_attention_stats`` combines them — the JAX
``shard_map`` island, written as one computation batched over the shard
dimension (``trustee_attention``, which the encoder-decoder model's
cross-attention decode shares).

MLA (DeepSeek's multi-head latent attention) keeps the JAX layout too:
``w_q`` (D, H*(nope+rope)), ``w_dkv`` (D, r), ``latent_norm``, ``w_kr``
(D, rope), ``w_uk`` (r, H*nope), ``w_uv`` (r, H*v), ``w_o`` (H*v, D).  Its
prefill (``mla_attention``) runs the same flash kernel at head dim
nope + rope, V zero-padded up to it; its decode (``_mla_decode``) keeps
the latent cache ``latent`` (T, B, max_len / T, r) and ``k_rope``
(T, B, max_len / T, rope) sequence-sharded over the T stacked trustees,
expanding K and V from the latent (or, with ``run.mla_absorb``, scoring
in latent space) on every trustee's own positions.

With ``cfg.mrope_sections`` (qwen2-vl) the prefill and training attention
rotate q and k by M-RoPE over the (3, B, S) position streams; decode
rotates by plain RoPE on the token's position, as JAX's does.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ATTN_MLA, ModelConfig
from ..kernels import ops as kops
from ..kernels import ref as kref
from .layers import _normal_stacked, apply_rope, init_rmsnorm, rmsnorm

BLOCKWISE_THRESHOLD = 2048
NEG_INF = -1e30


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
    stacked layer dimension (``layers._normal_stacked``)."""
    if gen is None:
        gen = torch.Generator().manual_seed(seed)
    if cfg.attn_kind == ATTN_MLA:
        return _init_mla(cfg, dtype, device, gen, lead)
    hqp, hkvp = padded_heads(cfg, model_axis)
    dh = cfg.resolved_head_dim
    d = cfg.d_model
    s = 1.0 / d ** 0.5

    def proj(hout, live):
        w = _normal_stacked(gen, lead, (d, hout * dh), s, dtype, device)
        if live < hout:                # zero the padding heads
            w.view(lead + (d, hout, dh))[..., live:, :] = 0.0
        return w

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


def _init_mla(cfg: ModelConfig, dtype, device, gen: torch.Generator,
              lead: tuple) -> Dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.mla_q_nope_dim, cfg.mla_q_rope_dim, cfg.mla_v_head_dim
    r = cfg.mla_kv_lora_rank
    s, sr = 1.0 / math.sqrt(d), 1.0 / math.sqrt(r)

    def w(shape, scale):
        return _normal_stacked(gen, lead, shape, scale, dtype, device)
    return {"w_q": w((d, h * (dn + dr)), s),
            "w_dkv": w((d, r), s),
            "latent_norm": init_rmsnorm(r, device=device, lead=lead),
            "w_kr": w((d, dr), s),
            "w_uk": w((r, h * dn), sr),
            "w_uv": w((r, h * dv), sr),
            "w_o": w((h * dv, d), 1.0 / math.sqrt(h * dv))}


def _heads(params, cfg: ModelConfig) -> Tuple[int, int, int]:
    """(padded query heads, padded KV heads, head dim) of a layer's
    weights."""
    dh = cfg.resolved_head_dim
    return params["w_q"].shape[-1] // dh, params["w_k"].shape[-1] // dh, dh


def _project_qkv(params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, mrope: Tuple[int, ...] = ()):
    """x (B, S, D), positions (B, S) (or (3, B, S) with ``mrope``
    sections) -> rotated q (B, S, Hq, Dh), rotated k and v (B, S, Hkv,
    Dh)."""
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
    return (apply_rope(q, positions, cfg.rope_theta, mrope),
            apply_rope(k, positions, cfg.rope_theta, mrope), v)


# ---------------------------------------------------------------------------
# prefill / train forward
# ---------------------------------------------------------------------------

def _block_step(qf, kj, vj, m, l, acc, qpos, j: int, causal: bool):
    """One KV block of ``blockwise_attention``: the running f32 (m, l,
    acc) updated by keys ``j .. j + block``."""
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kj.float())
    if causal:
        kpos = j + torch.arange(kj.shape[2], device=qf.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s,
                        torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.max(dim=-1).values)
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bgrqk,bgkd->bgrqd", p,
                                                vj.float())
    return m_new, l, acc


def blockwise_attention(q, k, v, causal: bool = True, scale=None,
                        q_offset: int = 0, block_k: int = 1024):
    """The plain path for long sequences (``attention.blockwise_attention``):
    q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D); KV blocks of ``block_k``
    carrying a running f32 (m, l, acc), so no (Sq, Skv) score matrix is
    held — O(Sq * block_k) memory.  Under autograd each block is
    rematerialised in the backward (JAX's ``jax.checkpoint`` on the scan
    step), so the backward too holds one block's scores at a time."""
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
    remat = torch.is_grad_enabled()
    for j in range(0, skv, block_k):
        args = (qf, k[:, :, j:j + block_k], v[:, :, j:j + block_k], m, l,
                acc, qpos, j, causal)
        # no random numbers: the generator's state is not saved (a
        # captured train step may not read it)
        m, l, acc = checkpoint(_block_step, *args, use_reentrant=False,
                               preserve_rng_state=False) \
            if remat else _block_step(*args)
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
    """x (B, S, D); positions (B, S), or (3, B, S) for M-RoPE -> (B, S,
    D)."""
    if cfg.attn_kind == ATTN_MLA:
        return mla_attention(params, x, positions, cfg, run)
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, positions, cfg, cfg.mrope_sections)
    out = _core_attention(q, k, v, run).reshape(b * s, -1)
    return torch.matmul(out, params["w_o"]).reshape(b, s, cfg.d_model)


def _mla_project(params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig):
    """x (B, S, D) -> (q_nope (B, S, H, nope), rotated q_rope (B, S, H,
    rope), the normed latent (B, S, r), rotated k_rope (B, S, rope))."""
    h = cfg.n_heads
    dn, dr = cfg.mla_q_nope_dim, cfg.mla_q_rope_dim
    b, s, _ = x.shape
    q = torch.matmul(x, params["w_q"]).reshape(b, s, h, dn + dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    latent = rmsnorm(params["latent_norm"], torch.matmul(x, params["w_dkv"]),
                     cfg.norm_eps)
    k_rope = apply_rope(torch.matmul(x, params["w_kr"])[:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0]
    return q[..., :dn], q_rope, latent, k_rope


def mla_attention(params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, run=None) -> torch.Tensor:
    """MLA prefill: x (B, S, D) -> (B, S, D).  K is the latent's nope
    part beside the shared rotated k_rope (broadcast over heads), V the
    latent's value part zero-padded from ``v_head`` to nope + rope so
    one attention call (the flash kernel under ``run.use_pallas``) serves
    both; the output is sliced back to ``v_head``."""
    h = cfg.n_heads
    dn, dr, dv = cfg.mla_q_nope_dim, cfg.mla_q_rope_dim, cfg.mla_v_head_dim
    b, s, _ = x.shape
    q_nope, q_rope, latent, k_rope = _mla_project(params, x, positions, cfg)
    k_nope = torch.matmul(latent, params["w_uk"]).reshape(b, s, h, dn)
    v = torch.matmul(latent, params["w_uv"]).reshape(b, s, h, dv)
    qq = torch.cat([q_nope, q_rope], -1)
    kk = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], -1)
    if dv < dn + dr:
        v = torch.nn.functional.pad(v, (0, dn + dr - dv))
    out = _core_attention(qq, kk, v, run)[..., :dv]
    return torch.matmul(out.reshape(b, s, h * dv), params["w_o"])


# ---------------------------------------------------------------------------
# decode against the sequence-sharded KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None, n_trustees: int = 1, model_axis: int = 1,
                  lead: tuple = ()) -> Dict[str, torch.Tensor]:
    """Zero K and V caches, ``(T, B, Hkv, max_len / T, Dh)``: trustee t
    owns positions [t * max_len / T, (t + 1) * max_len / T) — the JAX
    cache ``(B, Hkv, max_len, Dh)`` with its sequence axis sharded over
    the model axis, stacked.  MLA keeps ``latent`` (T, B, max_len / T, r)
    and ``k_rope`` (T, B, max_len / T, rope) instead.  ``lead`` prefixes
    a stacked layer dimension."""
    if max_len % n_trustees:
        raise ValueError(f"max_len {max_len} does not split over "
                         f"{n_trustees} trustees")
    if cfg.attn_kind == ATTN_MLA:
        lead = lead + (n_trustees, batch, max_len // n_trustees)
        return {"latent": torch.zeros(lead + (cfg.mla_kv_lora_rank,),
                                      dtype=dtype, device=device),
                "k_rope": torch.zeros(lead + (cfg.mla_q_rope_dim,),
                                      dtype=dtype, device=device)}
    _, hkvp = padded_heads(cfg, model_axis)
    shape = lead + (n_trustees, batch, hkvp, max_len // n_trustees,
                    cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _put_owner(caches, news, pos: torch.Tensor, seq_dim: int) -> None:
    """The delegated PUT, in place: each new row (B, ...) lands in the
    shard of each stacked cache (T, B, ...) that owns its position along
    ``seq_dim``; every other shard keeps its row."""
    t, b = caches[0].shape[:2]
    s_loc = caches[0].shape[seq_dim]
    my = torch.arange(t, device=pos.device)
    local = pos[None, :] - my[:, None] * s_loc          # (T, B)
    mine = (local >= 0) & (local < s_loc)
    lp = local.clamp(0, s_loc - 1)
    tt = my[:, None].expand(t, b)
    bb = torch.arange(b, device=pos.device)[None, :].expand(t, b)
    for c, new in zip(caches, news):
        rows = c.movedim(seq_dim, 2)                     # (T, B, S, ...)
        old = rows[tt, bb, lp]
        m = mine.reshape(mine.shape + (1,) * (old.dim() - 2))
        rows.index_put_((tt, bb, lp), torch.where(m, new[None].to(c.dtype),
                                                  old))


def decode_attention(params, x: torch.Tensor, pos: torch.Tensor, cache,
                     cfg: ModelConfig, run=None):
    """One-token decode against the stacked, sequence-sharded KV cache.

    x (B, D) new-token activations; pos (B,) its positions; cache from
    ``init_kv_cache``.  Returns (y (B, D), cache) — the cache updated IN
    PLACE (JAX returns a new one): the delegated PUT writes the new row
    into its owner's shard only.  Every shard then answers the query over
    its own positions with (o, m, l), and the merge combines them."""
    if cfg.attn_kind == ATTN_MLA:
        return _mla_decode(params, x, pos, cache, cfg, run)
    b = x.shape[0]
    q, k, v = _project_qkv(params, x[:, None, :], pos[:, None], cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]            # (B, H, Dh)
    ck, cv = cache["k"], cache["v"]
    t, _, _, s_loc, _ = ck.shape
    my = torch.arange(t, device=x.device)
    pos = pos.long()

    # the delegated PUT: trustee t keeps its own row unless it owns pos
    _put_owner((ck, cv), (k, v), pos, 3)

    # each trustee's partial attention over its positions
    kpos = my[:, None] * s_loc + torch.arange(s_loc, device=x.device)
    valid = kpos[:, None, :] <= pos[None, :, None]      # (T, B, S)
    out = trustee_attention(q, ck, cv, valid)
    return torch.matmul(out.reshape(b, -1), params["w_o"]), cache


def trustee_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      valid=None) -> torch.Tensor:
    """One query a sequence, q (B, Hq, Dh), against a stacked
    sequence-sharded cache ck / cv (T, B, Hkv, S_loc, Dh): every trustee
    answers over its positions (those ``valid`` (T, B, S_loc) keeps, or
    all) with partial softmax stats (o, m, l) in f32, and
    ``merge_attention_stats`` combines them -> (B, Hq, Dh) in q's dtype.
    The JAX ``shard_map`` island, batched over the shard dimension."""
    t, b, hkvp, _, dh = ck.shape
    hqp = q.shape[1]
    qg = q.float().reshape(b, hkvp, hqp // hkvp, dh)
    s = torch.einsum("bgrd,tbgsd->tbgrs", qg, ck.float()) / math.sqrt(dh)
    if valid is not None:
        s = torch.where(valid[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
    m = s.max(dim=-1).values
    p = torch.exp(s - m[..., None])
    o = torch.einsum("tbgrs,tbgsd->tbgrd", p, cv.float())
    return kref.merge_attention_stats(
        o.reshape(t, b, hqp, dh), m.reshape(t, b, hqp),
        p.sum(dim=-1).reshape(t, b, hqp))[0].to(q.dtype)


def _mla_decode(params, x: torch.Tensor, pos: torch.Tensor, cache,
                cfg: ModelConfig, run=None):
    """One-token MLA decode against the stacked, sequence-sharded latent
    cache (``init_kv_cache``'s MLA branch).  The new token's latent and
    k_rope rows are a delegated PUT to the owner's shard, in place; every
    trustee scores the query against its own positions — expanding K and
    V from the latent (the baseline), or with ``run.mla_absorb`` in
    latent space (q_nope folded through ``w_uk``, the context through
    ``w_uv``) — and the partial (o, m, l) are merged.  Returns (y (B, D),
    cache)."""
    absorb = bool(run is not None and run.mla_absorb)
    h = cfg.n_heads
    dn, dr, dv = cfg.mla_q_nope_dim, cfg.mla_q_rope_dim, cfg.mla_v_head_dim
    r = cfg.mla_kv_lora_rank
    b = x.shape[0]
    pos = pos.long()
    q_nope, q_rope, lat_new, kr_new = _mla_project(
        params, x[:, None, :], pos[:, None], cfg)
    q_nope, q_rope = q_nope[:, 0].float(), q_rope[:, 0].float()  # (B, H, .)
    lat, krope = cache["latent"], cache["k_rope"]
    t, _, s_loc, _ = lat.shape
    _put_owner((lat, krope), (lat_new[:, 0], kr_new[:, 0]), pos, 2)

    kpos = (torch.arange(t, device=x.device)[:, None] * s_loc
            + torch.arange(s_loc, device=x.device))       # (T, S)
    valid = kpos[:, None, :] <= pos[None, :, None]       # (T, B, S)
    w_uk = params["w_uk"].float().reshape(r, h, dn)
    w_uv = params["w_uv"].float().reshape(r, h, dv)
    latf = lat.float()
    if absorb:
        q_eff = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)
        s_nope = torch.einsum("bhr,tbsr->tbhs", q_eff, latf)
    else:
        k_nope = torch.einsum("tbsr,rhn->tbshn", latf, w_uk)
        s_nope = torch.einsum("bhn,tbshn->tbhs", q_nope, k_nope)
    s_rope = torch.einsum("bhr,tbsr->tbhs", q_rope, krope.float())
    sc = (s_nope + s_rope) * (1.0 / math.sqrt(dn + dr))
    sc = torch.where(valid[:, :, None, :], sc, torch.full_like(sc, NEG_INF))
    m = sc.max(dim=-1).values
    p = torch.exp(sc - m[..., None])
    if absorb:
        ctx = torch.einsum("tbhs,tbsr->tbhr", p, latf)
        o = torch.einsum("tbhr,rhv->tbhv", ctx, w_uv)
    else:
        v_full = torch.einsum("tbsr,rhv->tbshv", latf, w_uv)
        o = torch.einsum("tbhs,tbshv->tbhv", p, v_full)
    out = kref.merge_attention_stats(o, m, p.sum(dim=-1))[0].to(x.dtype)
    y = torch.matmul(out.reshape(b, h * dv), params["w_o"])
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
