"""Encoder-decoder backbone (seamless-m4t-large-v2's text / unit
backbone): the torch counterpart of ``repro.models.encdec``.

The encoder runs pre-norm layers of non-causal self-attention (RoPE over
the frame positions, no bias, no QK norm) and a gated MLP over
precomputed frame embeddings (B, S_src, D): the speech frontend is a
stub, as in JAX.  The decoder's layers are causal self-attention
(``attention.attention``), cross-attention over the encoder memory
(non-causal, no RoPE) and the MLP, each pre-norm residual.  The prefill's
and training's attention calls go through the flash-attention kernel
under ``run.use_pallas``, as the decoder-only stack's do.

Parameters keep JAX's tree and layouts, so ``convert`` carries them
across as a plain tree map: ``embed``; ``encoder`` {ln1, attn, ln2, mlp}
and ``decoder`` {ln1, attn, ln_x, xattn, ln2, mlp}, every leaf stacked
over the layers; ``enc_norm``; ``final_norm``.

Decode keeps the self-attention KV cache over T trustees stacked on the
device (``attention.decode_attention``: the delegated PUT and the merge of
per-trustee partials) and a cross K/V cache sequence-sharded the same way,
``cross_k`` / ``cross_v`` (n_layers, T, B, Hkv, max_len / T, Dh).  Every
trustee answers the query over all its cross positions with (o, m, l) in
f32, merged (``attention.trustee_attention``) — JAX's island
(``encdec.py:211-235``), which masks nothing.  As in JAX, ``init_cache``
makes the cross cache zeros and nothing fills it: ``model.prefill``
returns the encoder memory and the serve never writes it into the cache
(a reference-side note of ROADMAP), so a served token's cross-attention
reads zeros.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig
from ..core.meshctx import resolve_device
from . import attention as attn_mod
from .layers import (apply_rope, delegated_softmax_xent, dtype_of,
                     embed_lookup, init_embed, init_mlp, init_rmsnorm,
                     lm_logits, mlp, param_generator, rmsnorm,
                     unembed_weight)
from .transformer import REMAT, _index, _remat, _unstack


def _check(cfg: ModelConfig, run=None) -> None:
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is not an encoder-decoder model")
    if run is not None and run.remat not in REMAT:
        raise ValueError(f"unknown remat {run.remat!r} (want one of "
                         f"{REMAT})")


def n_encoder_layers(cfg: ModelConfig) -> int:
    return cfg.n_encoder_layers or cfg.n_layers


def init_params(cfg: ModelConfig, run=None, device=None,
                gen: torch.Generator = None) -> Dict[str, Any]:
    """Random parameters drawn on ``device`` (``cuda`` by default) from
    ``gen``, or from a generator on that device seeded with ``run.seed``
    — not JAX's numbers; tests carry JAX weights through ``convert``.
    Projections in ``run.param_dtype`` (bf16 by default), norm scales
    f32, every encoder and decoder leaf stacked over its layers."""
    _check(cfg, run)
    dtype = dtype_of(run.param_dtype) if run is not None else torch.bfloat16
    model_axis = run.mesh.model_size if run is not None else 1
    dev = resolve_device(device)
    if gen is None:
        gen = param_generator(dev, run.seed if run is not None else 0)
    d = cfg.d_model

    def attn(lead):
        return attn_mod.init_attention(cfg, dtype, dev, model_axis=model_axis,
                                       gen=gen, lead=lead)

    def norm(lead):
        return init_rmsnorm(d, device=dev, lead=lead)

    enc, dec = (n_encoder_layers(cfg),), (cfg.n_layers,)
    return {
        "embed": init_embed(gen, cfg, dtype, dev, model_axis),
        "encoder": {"ln1": norm(enc), "attn": attn(enc), "ln2": norm(enc),
                    "mlp": init_mlp(gen, d, cfg.d_ff, dtype, dev, enc)},
        "decoder": {"ln1": norm(dec), "attn": attn(dec), "ln_x": norm(dec),
                    "xattn": attn(dec), "ln2": norm(dec),
                    "mlp": init_mlp(gen, d, cfg.d_ff, dtype, dev, dec)},
        "enc_norm": init_rmsnorm(d, device=dev),
        "final_norm": init_rmsnorm(d, device=dev),
    }


def _attend(p, x, kv, cfg: ModelConfig, run, positions=None):
    """Non-causal attention of x (B, S, D) over kv (B, S_kv, D) with the
    layer's projections and no bias or QK norm, q and k rotated by RoPE
    at ``positions`` when given (the encoder's self-attention; the
    cross-attention has none) -> (B, S, D)."""
    hqp, hkvp, dh = attn_mod._heads(p, cfg)
    b, s, _ = x.shape
    skv = kv.shape[1]
    q = torch.matmul(x, p["w_q"]).reshape(b, s, hqp, dh)
    k = torch.matmul(kv, p["w_k"]).reshape(b, skv, hkvp, dh)
    v = torch.matmul(kv, p["w_v"]).reshape(b, skv, hkvp, dh)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = attn_mod._core_attention(q, k, v, run, causal=False)
    return torch.matmul(o.reshape(b * s, hqp * dh),
                        p["w_o"]).reshape(b, s, cfg.d_model)


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           run=None) -> torch.Tensor:
    """frames (B, S_src, D), the stub frontend's embeddings -> the encoder
    memory (B, S_src, D), after ``enc_norm``."""
    _check(cfg, run)
    b, s, _ = frames.shape
    positions = torch.arange(s, device=frames.device)[None].expand(b, s)
    x = frames
    n = n_encoder_layers(cfg)
    for p in _unstack(params["encoder"], n):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + _attend(p["attn"], h, h, cfg, run, positions)
        x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _decoder_layer(p, x, memory, positions, cfg: ModelConfig, run):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn_mod.attention(p["attn"], h, positions, cfg, run)
    hx = rmsnorm(p["ln_x"], x, cfg.norm_eps)
    x = x + _attend(p["xattn"], hx, memory, cfg, run)
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)


def forward_loss(params, batch, cfg: ModelConfig, run=None):
    """The training objective: batch {"src_embeds" (B, S_src, D),
    "tokens" (B, S), "labels" (B, S), optional "mask" (B, S)} -> (loss,
    metrics): the delegated cross-entropy over T = ``run.mesh.model_size``
    stacked vocab shards, its ``nll`` and ``accuracy``, and the decoder-
    only stack's ``moe_*`` metrics as zeros.  Under autograd each decoder
    layer is rematerialised as ``run.remat`` says (the encoder is not, as
    in JAX)."""
    memory = encode(params, batch["src_embeds"], cfg, run)
    x = embed_lookup(params["embed"], batch["tokens"], cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    remat = run.remat if run is not None and torch.is_grad_enabled() \
        else "none"

    def layer(p, x):
        return _decoder_layer(p, x, memory, positions, cfg, run)
    fn = _remat(layer, remat) if remat != "none" else layer
    for p in _unstack(params["decoder"], cfg.n_layers):
        x = fn(p, x)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    nll, acc = delegated_softmax_xent(
        x, unembed_weight(params["embed"], cfg), batch["labels"], cfg,
        batch.get("mask"), chunk=run.xent_chunk if run is not None else 512,
        n_shards=run.mesh.model_size if run is not None else 1)
    zero = torch.zeros((), device=x.device)
    return nll, {"nll": nll, "accuracy": acc, "moe_aux_loss": zero,
                 "moe_dropped_frac": zero, "moe_max_load": zero}


# ---------------------------------------------------------------------------
# decode: the stacked self-attention KV cache and the cross K/V cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, run=None,
               device=None) -> Dict[str, Any]:
    """Zero decode caches in ``run.activation_dtype`` over the
    ``run.mesh.model_size`` = T trustees: ``self`` {k, v} (n_layers, T,
    B, Hkv, max_len / T, Dh) (``attention.init_kv_cache``) and
    ``cross_k`` / ``cross_v`` of the same shape, zeros as in JAX."""
    _check(cfg, run)
    dtype = dtype_of(run.activation_dtype) if run is not None \
        else torch.bfloat16
    t = run.mesh.model_size if run is not None else 1
    dev = resolve_device(device)
    self_c = attn_mod.init_kv_cache(cfg, batch, max_len, dtype, dev,
                                    n_trustees=t, model_axis=t,
                                    lead=(cfg.n_layers,))
    return {"self": self_c,
            "cross_k": torch.zeros_like(self_c["k"]),
            "cross_v": torch.zeros_like(self_c["v"])}


def _cross_decode(p, h: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """One token's cross-attention, h (B, D), against the stacked cross
    cache ck / cv (T, B, Hkv, S_loc, Dh): each trustee's (o, m, l) over
    all its positions, merged -> (B, D)."""
    hqp, _, dh = attn_mod._heads(p, cfg)
    b = h.shape[0]
    q = torch.matmul(h, p["w_q"]).reshape(b, hqp, dh)
    out = attn_mod.trustee_attention(q, ck, cv)
    return torch.matmul(out.reshape(b, hqp * dh), p["w_o"])


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, run=None):
    """One decoder token: tokens (B,) int (text, not embeddings), pos
    (B,).  Returns (logits (B, V) f32, cache) — the self cache updated in
    place."""
    _check(cfg, run)
    x = embed_lookup(params["embed"], tokens[:, None], cfg)[:, 0]
    for i in range(cfg.n_layers):
        p = _index(params["decoder"], i)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        y, _ = attn_mod.decode_attention(p["attn"], h, pos,
                                         _index(cache["self"], i), cfg, run)
        x = x + y
        hx = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        x = x + _cross_decode(p["xattn"], hx, cache["cross_k"][i],
                              cache["cross_v"][i], cfg)
        x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(x, unembed_weight(params["embed"], cfg), cfg), cache
