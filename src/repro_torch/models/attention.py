"""GQA attention pieces of the paged-decode path (the torch counterparts of
``repro.models.attention``: ``padded_heads``, ``init_attention``'s GQA
branch, ``init_paged_kv_pool`` and ``paged_decode_attention``).

Parameters are a dict of tensors in the JAX layout — ``w_q`` (D, Hq*Dh),
``w_k`` / ``w_v`` (D, Hkv*Dh), ``w_o`` (Hq*Dh, D), ``b_q`` / ``b_k`` /
``b_v`` with QKV bias, ``q_norm`` / ``k_norm`` with QK norm — so
``convert.attention_params_from_jax`` carries JAX weights across as they
are.  The four projections are plain ``torch.matmul`` (the JAX package
leaves them to XLA); the attention over the page chains is the
``paged_attention`` kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import apply_rope, init_rmsnorm, rmsnorm


def padded_heads(cfg: ModelConfig, model_axis: int = 1) -> Tuple[int, int]:
    """(n_q_heads_padded, n_kv_heads_padded) for a model axis of
    ``model_axis`` shards (1 on one card: the port's default mesh is
    (1, 1), as the JAX package's is)."""
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


def init_attention(cfg: ModelConfig, dtype=torch.float32, device=None,
                   seed: int = 0, model_axis: int = 1
                   ) -> Dict[str, torch.Tensor]:
    """Random GQA attention weights from ``seed`` (a ``torch.Generator``:
    not JAX's numbers; tests carry JAX weights through ``convert``)."""
    hqp, hkvp = padded_heads(cfg, model_axis)
    dh = cfg.resolved_head_dim
    d = cfg.d_model
    gen = torch.Generator().manual_seed(seed)
    s = 1.0 / d ** 0.5

    def proj(hout, live):
        w = torch.randn((d, hout * dh), generator=gen) * s
        if live < hout:                # zero the padding heads
            w = w.reshape(d, hout, dh)
            w[:, live:] = 0.0
            w = w.reshape(d, hout * dh)
        return w.to(dtype).to(device)

    p = {"w_q": proj(hqp, cfg.n_heads),
         "w_k": proj(hkvp, cfg.n_kv_heads),
         "w_v": proj(hkvp, cfg.n_kv_heads)}
    p["w_o"] = proj(hqp, cfg.n_heads).T.reshape(hqp * dh, d).contiguous()
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((hqp * dh,), dtype=dtype, device=device)
        p["b_k"] = torch.zeros((hkvp * dh,), dtype=dtype, device=device)
        p["b_v"] = torch.zeros((hkvp * dh,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, device=device)
        p["k_norm"] = init_rmsnorm(dh, device=device)
    return p


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
                           page_table: torch.Tensor, cfg: ModelConfig,
                           model_axis: int = 1):
    """One-token decode against the paged KV pool.

    x (B, D) new-token activations; pos (B,) int token positions; pool from
    ``init_paged_kv_pool``; page_table (B, MP) int32 global page ids (-1
    pad): each row is the sequence's chain from the delegated page table,
    so ``page_table[b, pos[b] // PS]`` names the page the new token's KV
    row lands in.  Returns (y (B, D), pool) — the pool updated IN PLACE:
    the JAX ``.at[page, :, slot].set`` becomes an ``index_put_``, the page
    id clipped into [0, P) as in JAX.  Attention runs the paged-attention
    kernel (its plain version on CPU tensors)."""
    hqp, hkvp = padded_heads(cfg, model_axis)
    dh = cfg.resolved_head_dim
    b = x.shape[0]
    ps = pool["k"].shape[2]
    q = torch.matmul(x, params["w_q"])
    k = torch.matmul(x, params["w_k"])
    v = torch.matmul(x, params["w_v"])
    if cfg.qkv_bias:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    q = q.reshape(b, 1, hqp, dh)
    k = k.reshape(b, 1, hkvp, dh)
    v = v.reshape(b, 1, hkvp, dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    posb = pos[:, None]
    q = apply_rope(q, posb, cfg.rope_theta)[:, 0]        # (B, Hq, Dh)
    k = apply_rope(k, posb, cfg.rope_theta)[:, 0]        # (B, Hkv, Dh)
    v = v[:, 0]
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
