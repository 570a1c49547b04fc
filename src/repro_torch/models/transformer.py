"""Decoder-only LM assembly (the torch counterpart of
``repro.models.transformer``): stacks of attention layers (GQA or MLA)
and Mamba-1 mixers, with dense, MoE or MoE + dense FFNs — qwen2.5-3b,
deepseek-v2-lite-16b, falcon-mamba-7b, and hybrids such as jamba's
period-8 pattern.

Layers are organised as in JAX: ``prefix`` is a list of unstacked layers
(deepseek's dense first layer), and ``groups`` holds the architecture's
repeating pattern (one layer for a uniform stack), each leaf stacked over
the ``n_groups`` repeats, ``(n_groups, ...)`` under ``groups/pos<j>``, so
a JAX parameter tree carries across as a plain tree map.  JAX scans the
groups; the port loops over them in Python.  Each layer is pre-norm
residual: x += Mixer(norm(x)), the mixer attention or Mamba
(``mamba.mamba_block``); then x += FFN(norm(x)), the FFN a dense MLP, the
delegated MoE (``moe.moe_block``) or both summed — a pure-SSM stack's
layer has no FFN and no second norm.  The forward collects the MoE
layers' aux metrics as JAX's ``_stack_forward`` does.  The decode cache
holds each attention layer's KV over T trustees and each Mamba layer's
(conv, ssm) state, whole.

``forward_loss`` is the training objective: the stack, then the delegated
cross-entropy over T = ``run.mesh.model_size`` stacked vocab shards, plus
the MoE layers' load-balance loss.  Under autograd ``run.remat`` applies
to each group as JAX's ``jax.checkpoint`` does: "full" recomputes the
whole group in the backward (and, for a multi-layer group, each layer
inside it again), "dots" keeps only the matmul outputs
(``torch.utils.checkpoint`` with a selective policy), "none" keeps
everything.  The dense prefix layers are not rematerialised, as in JAX.

Inputs are token ids, or for an ``input_mode == "embeds"`` model (the
vlm's stub frontend) precomputed embeddings: ``batch["embeds"]`` (B, S,
D) with optional ``batch["positions"]`` — (3, B, S) M-RoPE streams for
qwen2-vl — and in decode a (B, D) embedding as ``tokens``.

``run.sp_residual`` (JAX's sequence-parallel residual) is accepted and
changes nothing: in JAX it is only a sharding constraint that keeps the
residual stream sequence-sharded over the model axis between sublayers
(``transformer.py:97-104``), which on one card, with the shards stacked,
is the identity.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import (BLOCK_ATTN, BLOCK_MAMBA, FFN_DENSE, FFN_MOE,
                            FFN_MOE_DENSE, ModelConfig)
from ..core.meshctx import resolve_device
from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .layers import (delegated_softmax_xent, dtype_of, embed_lookup,
                     init_embed, init_mlp, init_rmsnorm, lm_logits, mlp,
                     param_generator, rmsnorm, unembed_weight)

REMAT = ("none", "dots", "full")


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


def _check(cfg: ModelConfig, run=None
           ) -> Tuple[List[LayerDesc], int, int]:
    """(descs, prefix_len, n_groups) of a decoder-only stack; raises for
    a configuration it cannot run."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                         f"models.encdec runs it")
    if run is not None and run.remat not in REMAT:
        raise ValueError(f"unknown remat {run.remat!r} (want one of "
                         f"{REMAT})")
    descs, prefix_len, n_groups = layer_descs(cfg)
    if run is not None and cfg.ffn_kind != FFN_DENSE \
            and cfg.moe.num_experts % run.mesh.model_size:
        raise ValueError(f"{run.mesh.model_size} trustees do not split "
                         f"{cfg.moe.num_experts} experts")
    return descs, prefix_len, n_groups


def _prefix_desc(cfg: ModelConfig, i: int) -> LayerDesc:
    return LayerDesc(cfg.block_kind(i), FFN_DENSE)


def _index(tree, g: int):
    """Layer ``g`` of a tree of stacked leaves (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _unstack(tree, n: int) -> List[Any]:
    """The ``n`` layers of a tree of stacked leaves, each leaf split by
    one ``unbind`` (views): its backward stacks the layers' gradients in
    one allocation, where indexing each layer would give every layer's
    gradient the whole stacked shape, zero-filled and summed."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, desc: LayerDesc,
                dtype, device, lead: tuple, model_axis: int
                ) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": init_rmsnorm(cfg.d_model, device=device,
                                             lead=lead)}
    if desc.block == BLOCK_ATTN:
        p["attn"] = attn_mod.init_attention(cfg, dtype, device,
                                            model_axis=model_axis, gen=gen,
                                            lead=lead)
    else:
        p["mamba"] = mamba_mod.init_mamba(cfg, dtype, device, gen,
                                          lead=lead)
    if desc.ffn != "none":
        p["ln2"] = init_rmsnorm(cfg.d_model, device=device, lead=lead)
        if desc.ffn in (FFN_MOE, FFN_MOE_DENSE):
            p["moe"] = moe_mod.init_moe(cfg, dtype, device, gen, lead=lead)
        if desc.ffn in (FFN_DENSE, FFN_MOE_DENSE):
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                                lead=lead)
    return p


def init_params(cfg: ModelConfig, run=None, device=None,
                gen: torch.Generator = None) -> Dict[str, Any]:
    """Random parameters drawn on ``device`` (``cuda`` by default) from
    ``gen``, or from a generator on that device seeded with ``run.seed``
    — not JAX's numbers; tests carry JAX weights through ``convert``.
    Projections in ``run.param_dtype`` (bf16 by default), norm scales
    f32, every group leaf stacked ``(n_groups, ...)``, prefix layers
    unstacked in a list."""
    descs, prefix_len, n_groups = _check(cfg, run)
    dtype = dtype_of(run.param_dtype) if run is not None else torch.bfloat16
    model_axis = run.mesh.model_size if run is not None else 1
    dev = resolve_device(device)
    if gen is None:
        gen = param_generator(dev, run.seed if run is not None else 0)
    params: Dict[str, Any] = {"embed": init_embed(gen, cfg, dtype, dev,
                                                  model_axis)}
    if prefix_len:
        params["prefix"] = [_init_layer(gen, cfg, _prefix_desc(cfg, i),
                                        dtype, dev, (), model_axis)
                            for i in range(prefix_len)]
    params["groups"] = {f"pos{j}": _init_layer(gen, cfg, desc, dtype, dev,
                                               (n_groups,), model_axis)
                        for j, desc in enumerate(descs)}
    params["final_norm"] = init_rmsnorm(cfg.d_model, device=dev)
    return params


def count_params(params) -> int:
    return int(sum(leaf.numel() for leaf in _leaves(params)))


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _ffn(p, h, cfg: ModelConfig, desc: LayerDesc, run, seq: bool):
    """The layer's FFN on h (B, S, D), or (B, D) when not ``seq`` (decode:
    the MoE sees it as S = 1) -> (y, MoE aux or {})."""
    y, aux = 0.0, {}
    if desc.ffn in (FFN_MOE, FFN_MOE_DENSE):
        y_moe, aux = moe_mod.moe_block(p["moe"], h if seq else h[:, None],
                                       cfg, run)
        y = y + (y_moe if seq else y_moe[:, 0])
    if desc.ffn in (FFN_DENSE, FFN_MOE_DENSE):
        y = y + mlp(p["mlp"], h, cfg.act)
    return y, aux


def _apply_layer(p, x, positions, cfg: ModelConfig, desc: LayerDesc, run):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if desc.block == BLOCK_ATTN:
        x = x + attn_mod.attention(p["attn"], h, positions, cfg, run)
    else:
        x = x + mamba_mod.mamba_block(p["mamba"], h, cfg, run)
    if desc.ffn == "none":
        return x, {}
    y, aux = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, desc, run,
                  True)
    return x + y, aux


def _add_aux(acc, aux):
    if not aux:
        return acc
    return {"moe_aux_loss": acc["moe_aux_loss"] + aux["moe_aux_loss"],
            "moe_dropped_frac": acc["moe_dropped_frac"]
            + aux["moe_dropped_frac"],
            "moe_max_load": torch.maximum(acc["moe_max_load"],
                                          aux["moe_max_load"])}


# JAX's ``checkpoint_dots``: the results of matmuls are saved, the rest
# is recomputed in the backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` under ``torch.utils.checkpoint`` for ``remat`` "full" (save
    nothing inside) or "dots" (save only the matmul outputs).  The model
    draws no random numbers, so the generator's state is not saved for
    the recomputation (``preserve_rng_state=False``: the same values, and
    no read of the CUDA generator's seed, which a CUDA-graph capture of
    the train step refuses)."""
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _dots_policy))


def _stack_forward(params, x, positions, cfg: ModelConfig, run):
    """Every layer over x (B, S, D), then the final norm -> ((B, S, D),
    aux): the MoE layers' load-balance losses and dropped fractions
    summed, their max loads maxed (JAX's ``_stack_forward``).  Under
    autograd each group is rematerialised as ``run.remat`` says."""
    descs, prefix_len, n_groups = _check(cfg, run)
    aux = {k: torch.zeros((), device=x.device) for k in
           ("moe_aux_loss", "moe_dropped_frac", "moe_max_load")}
    for i in range(prefix_len):
        x, a = _apply_layer(params["prefix"][i], x, positions, cfg,
                            _prefix_desc(cfg, i), run)
        aux = _add_aux(aux, a)
    remat = run.remat if run is not None and torch.is_grad_enabled() \
        else "none"
    # nested remat: a multi-layer group (jamba's period 8) also
    # checkpoints each layer, so its backward holds one layer's internals
    # at a time
    nest = remat == "full" and len(descs) > 1

    def group_fn(gp, x, aux):
        for j, desc in enumerate(descs):
            layer = functools.partial(_apply_layer, positions=positions,
                                      cfg=cfg, desc=desc, run=run)
            if nest:
                layer = _remat(layer, "full")
            x, a = layer(gp[f"pos{j}"], x)
            aux = _add_aux(aux, a)
        return x, aux
    if remat != "none":
        group_fn = _remat(group_fn, remat)
    for gp in _unstack(params["groups"], n_groups):
        x, aux = group_fn(gp, x, aux)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _inputs_to_hidden(params, batch, cfg: ModelConfig):
    """(x (B, S, D), positions (B, S) or the batch's own) of a batch of
    token ids or, for an embeds-input model, of embeddings."""
    _check(cfg)
    if cfg.input_mode == "embeds":
        x = batch["embeds"]
    else:
        x = embed_lookup(params["embed"], batch["tokens"], cfg)
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    return x, positions


def forward_loss(params, batch, cfg: ModelConfig, run=None):
    """The training objective: batch {"tokens" (B, S) or "embeds" (B, S,
    D), "labels" (B, S), optional "mask" (B, S), "positions"} -> (loss,
    metrics), loss = the mean nll + the MoE load-balance loss, metrics
    ``nll``, ``accuracy`` and the three ``moe_*`` (f32 scalars)."""
    x, positions = _inputs_to_hidden(params, batch, cfg)
    x, aux = _stack_forward(params, x, positions, cfg, run)
    nll, acc = delegated_softmax_xent(
        x, unembed_weight(params["embed"], cfg), batch["labels"], cfg,
        batch.get("mask"), chunk=run.xent_chunk if run is not None else 512,
        n_shards=run.mesh.model_size if run is not None else 1)
    return nll + aux["moe_aux_loss"], {"nll": nll, "accuracy": acc, **aux}


def prefill(params, batch, cfg: ModelConfig, run=None) -> torch.Tensor:
    """batch {"tokens": (B, S)} (or {"embeds": (B, S, D), "positions"})
    -> last-position logits (B, V), f32."""
    x, positions = _inputs_to_hidden(params, batch, cfg)
    x, _aux = _stack_forward(params, x, positions, cfg, run)
    return lm_logits(x[:, -1, :], unembed_weight(params["embed"], cfg), cfg)


# ---------------------------------------------------------------------------
# decode (one token, delegated sequence-sharded KV)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, run=None,
               device=None) -> Dict[str, Any]:
    """Zero decode caches in ``run.activation_dtype``: an attention
    layer's KV over the ``run.mesh.model_size`` = T trustees, leaves
    ``(n_groups, T, B, ...)`` (``attention.init_kv_cache``); a Mamba
    layer's (conv, ssm) state whole, ``(n_groups, B, ...)``
    (``mamba.init_mamba_cache``, JAX's layout); prefix layers' in a
    list."""
    descs, prefix_len, n_groups = _check(cfg, run)
    dtype = dtype_of(run.activation_dtype) if run is not None \
        else torch.bfloat16
    t = run.mesh.model_size if run is not None else 1
    dev = resolve_device(device)

    def layer_cache(desc, lead):
        if desc.block == BLOCK_ATTN:
            return attn_mod.init_kv_cache(cfg, batch, max_len, dtype, dev,
                                          n_trustees=t, model_axis=t,
                                          lead=lead)
        return mamba_mod.init_mamba_cache(cfg, batch, dtype, dev, lead=lead)
    cache: Dict[str, Any] = {}
    if prefix_len:
        cache["prefix"] = [layer_cache(_prefix_desc(cfg, i), ())
                           for i in range(prefix_len)]
    cache["groups"] = {f"pos{j}": layer_cache(desc, (n_groups,))
                       for j, desc in enumerate(descs)}
    return cache


def _apply_layer_decode(p, cache_l, x, pos, cfg: ModelConfig,
                        desc: LayerDesc, run):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if desc.block == BLOCK_ATTN:
        y, cache_l = attn_mod.decode_attention(p["attn"], h, pos, cache_l,
                                               cfg, run)
    else:
        y, cache_l = mamba_mod.mamba_decode(p["mamba"], h, cache_l, cfg,
                                            run)
    x = x + y
    if desc.ffn == "none":
        return x, cache_l
    y, _aux = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, desc, run,
                   False)
    return x + y, cache_l


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, run=None):
    """One decode step.  tokens (B,) int, or for an embeds-input model
    (B, D) embeddings; pos (B,).  Returns (logits (B, V) f32, cache) —
    the cache updated in place."""
    descs, prefix_len, n_groups = _check(cfg, run)
    if cfg.input_mode == "embeds":
        x = tokens
    else:
        x = embed_lookup(params["embed"], tokens[:, None], cfg)[:, 0]
    for i in range(prefix_len):
        x, _ = _apply_layer_decode(params["prefix"][i], cache["prefix"][i],
                                   x, pos, cfg, _prefix_desc(cfg, i), run)
    for g in range(n_groups):
        for j, desc in enumerate(descs):
            key = f"pos{j}"
            x, _ = _apply_layer_decode(
                _index(params["groups"][key], g),
                _index(cache["groups"][key], g), x, pos, cfg, desc, run)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_logits(x, unembed_weight(params["embed"], cfg), cfg)
    return logits, cache
