"""Decoder-only LM assembly (the torch counterpart of
``repro.models.transformer``), for stacks of dense attention layers.

Layers are organised as in JAX: ``groups`` holds the architecture's
repeating pattern (one layer for a uniform stack), each leaf stacked over
the ``n_groups`` repeats, ``(n_groups, ...)`` under ``groups/pos<j>``, so
a JAX parameter tree carries across as a plain tree map.  JAX scans the
groups; the port loops over them in Python.  Each layer is pre-norm
residual: x += Attn(norm(x)); x += MLP(norm(x)).

Not ported yet, raising ``NotImplementedError`` with their ROADMAP item:
MoE layers (queue A 13(b), kernel B7), Mamba layers (13(c), kernel B8),
the sequence-parallel residual, remat and ``forward_loss`` (training,
13(d)), embedding inputs and a dense prefix layer.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..configs.base import BLOCK_ATTN, BLOCK_MAMBA, FFN_DENSE, ModelConfig
from ..core.meshctx import resolve_device
from . import attention as attn_mod
from .layers import (dtype_of, embed_lookup, init_embed, init_mlp,
                     init_rmsnorm, lm_logits, mlp, rmsnorm, unembed_weight)


class LayerDesc(NamedTuple):
    block: str    # attn | mamba
    ffn: str      # dense | moe | moe+dense | none


def layer_descs(cfg: ModelConfig) -> Tuple[List[LayerDesc], int, int]:
    """Returns (descs for one group, prefix_len, n_groups)."""
    prefix_len = 1 if cfg.first_layer_dense else 0
    group_len = len(cfg.block_pattern) if cfg.block_pattern else 1
    if cfg.ffn_kind != FFN_DENSE:
        group_len = math.lcm(group_len, cfg.moe_every)
    n_scanned = cfg.n_layers - prefix_len
    if n_scanned % group_len:
        raise ValueError(f"{cfg.name}: {n_scanned} layers do not split "
                         f"into groups of {group_len}")
    descs = []
    for j in range(group_len):
        i = prefix_len + j
        block = cfg.block_kind(i)
        if block == BLOCK_MAMBA and cfg.ffn_kind == FFN_DENSE:
            ffn = "none"
        else:
            ffn = cfg.layer_ffn_kind(i)
        descs.append(LayerDesc(block, ffn))
    return descs, prefix_len, n_scanned // group_len


def _check(cfg: ModelConfig, run=None) -> Tuple[List[LayerDesc], int]:
    """(descs, n_groups) of a stack the port runs; raises for the rest."""
    if cfg.input_mode == "embeds":
        raise NotImplementedError("embedding inputs (vlm / audio) are not "
                                  "ported yet (ROADMAP queue A 13)")
    if run is not None and run.sp_residual:
        raise NotImplementedError("the sequence-parallel residual stream "
                                  "is not ported yet (ROADMAP queue A 13)")
    descs, prefix_len, n_groups = layer_descs(cfg)
    if prefix_len:
        raise NotImplementedError("a dense prefix layer (MoE nets) is not "
                                  "ported yet (ROADMAP queue A 13(b))")
    for desc in descs:
        if desc.block != BLOCK_ATTN:
            raise NotImplementedError(
                "Mamba layers are not ported yet (ROADMAP queue A 13(c), "
                "kernel queue B8)")
        if desc.ffn != FFN_DENSE:
            raise NotImplementedError(
                "MoE layers are not ported yet (ROADMAP queue A 13(b), "
                "kernel queue B7)")
    return descs, n_groups


def _index(tree, g: int):
    """Layer ``g`` of a tree of stacked leaves (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                lead: tuple, model_axis: int) -> Dict[str, Any]:
    return {"ln1": init_rmsnorm(cfg.d_model, device=device, lead=lead),
            "attn": attn_mod.init_attention(cfg, dtype, device,
                                            model_axis=model_axis, gen=gen,
                                            lead=lead),
            "ln2": init_rmsnorm(cfg.d_model, device=device, lead=lead),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                            lead=lead)}


def init_params(cfg: ModelConfig, run=None, device=None,
                gen: torch.Generator = None) -> Dict[str, Any]:
    """Random parameters drawn on ``device`` (``cuda`` by default) from
    ``gen``, or from a generator on that device seeded with ``run.seed``
    — not JAX's numbers; tests carry JAX weights through ``convert``.
    Projections in ``run.param_dtype`` (bf16 by default), norm scales
    f32, every layer leaf stacked ``(n_groups, ...)``."""
    descs, n_groups = _check(cfg, run)
    dtype = dtype_of(run.param_dtype) if run is not None else torch.bfloat16
    model_axis = run.mesh.model_size if run is not None else 1
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(
            run.seed if run is not None else 0)
    params: Dict[str, Any] = {"embed": init_embed(gen, cfg, dtype, dev,
                                                  model_axis)}
    params["groups"] = {f"pos{j}": _init_layer(gen, cfg, dtype, dev,
                                               (n_groups,), model_axis)
                        for j in range(len(descs))}
    params["final_norm"] = init_rmsnorm(cfg.d_model, device=dev)
    return params


def count_params(params) -> int:
    return int(sum(leaf.numel() for leaf in _leaves(params)))


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _apply_layer(p, x, positions, cfg: ModelConfig, run):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn_mod.attention(p["attn"], h, positions, cfg, run)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.act)


def _stack_forward(params, x, positions, cfg: ModelConfig, run):
    """Every layer over x (B, S, D), then the final norm -> (B, S, D)."""
    descs, n_groups = _check(cfg, run)
    if run is not None and run.remat != "none" and x.requires_grad:
        raise NotImplementedError("remat applies to a differentiated "
                                  "forward: training is not ported yet "
                                  "(ROADMAP queue A 13(d))")
    for g in range(n_groups):
        for j in range(len(descs)):
            x = _apply_layer(_index(params["groups"][f"pos{j}"], g), x,
                             positions, cfg, run)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _inputs_to_hidden(params, batch, cfg: ModelConfig):
    _check(cfg)
    x = embed_lookup(params["embed"], batch["tokens"], cfg)
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, positions


def prefill(params, batch, cfg: ModelConfig, run=None) -> torch.Tensor:
    """batch {"tokens": (B, S)} -> last-position logits (B, V), f32."""
    x, positions = _inputs_to_hidden(params, batch, cfg)
    x = _stack_forward(params, x, positions, cfg, run)
    return lm_logits(x[:, -1, :], unembed_weight(params["embed"], cfg), cfg)


# ---------------------------------------------------------------------------
# decode (one token, delegated sequence-sharded KV)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, run=None,
               device=None) -> Dict[str, Any]:
    """Zero KV caches in ``run.activation_dtype``, each group position's
    leaves stacked ``(n_groups, T, B, Hkv, max_len / T, Dh)`` over the
    ``run.mesh.model_size`` = T trustees."""
    descs, n_groups = _check(cfg, run)
    dtype = dtype_of(run.activation_dtype) if run is not None \
        else torch.bfloat16
    t = run.mesh.model_size if run is not None else 1
    dev = resolve_device(device)
    return {"groups": {
        f"pos{j}": attn_mod.init_kv_cache(cfg, batch, max_len, dtype, dev,
                                          n_trustees=t, model_axis=t,
                                          lead=(n_groups,))
        for j in range(len(descs))}}


def _apply_layer_decode(p, cache_l, x, pos, cfg: ModelConfig, run):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, cache_l = attn_mod.decode_attention(p["attn"], h, pos, cache_l, cfg,
                                           run)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.act), cache_l


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, run=None):
    """One decode step.  tokens (B,) int; pos (B,).  Returns (logits
    (B, V) f32, cache) — the cache updated in place."""
    descs, n_groups = _check(cfg, run)
    x = embed_lookup(params["embed"], tokens[:, None], cfg)[:, 0]
    for g in range(n_groups):
        for j in range(len(descs)):
            key = f"pos{j}"
            x, _ = _apply_layer_decode(
                _index(params["groups"][key], g),
                _index(cache["groups"][key], g), x, pos, cfg, run)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_logits(x, unembed_weight(params["embed"], cfg), cfg)
    return logits, cache
