"""Carry entrusted state between the JAX package and the port.

The JAX store holds each state leaf OWNER-MAJOR: a ``(T * rows, ...)``
array whose block ``t`` is trustee ``t``'s shard (what
``trust.trustee_state()`` returns, as numpy after ``np.asarray``).  The
port holds the same leaf STACKED, ``(T, rows, ...)``, on one device.  The
two are one reshape apart; these functions make it, so a test can start
both stores from the same table and compare them row by row.

Model weights keep the JAX tree's keys and layouts — the dense prefix
layers a list, MLA and MoE leaves (experts ``(n_groups, E, D, F)``, the
shared experts' MLP) as JAX holds them — so they carry across as a plain
tree map (``model_params_from_jax``; the encoder-decoder model's tree,
``embed`` / ``encoder`` / ``decoder`` / ``enc_norm`` / ``final_norm``,
too); the decode KV cache (or MLA latent cache, or the encoder-decoder
model's self and cross caches) is stacked by trustee in the port and laid
end to end along the sequence in JAX (``kv_cache_to_global``); a Mamba
layer's (conv, ssm) state has JAX's layout in both
(``mamba_cache_to_numpy``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def stacked_from_owner_major(host_state: Dict[str, np.ndarray],
                             n_trustees: int, device=None,
                             n_clients: int = 0) -> Dict[str, torch.Tensor]:
    """Owner-major numpy leaves ``(T * rows, ...)`` -> stacked tensors
    ``(T, rows, ...)`` on ``device`` (the port's default device when
    None), copied: they never alias the caller's arrays.  ``n_clients``
    > 0 gives dedicated mode's physical layout, ``(n_clients + T, rows,
    ...)`` with the client shards zero (the JAX dedicated store's physical
    leaves, ``(n_clients + T) * rows`` long, stack as ``n_trustees =
    n_clients + T`` with no region to add)."""
    from .core.meshctx import resolve_device
    dev = resolve_device(device)
    out = {}
    for name, leaf in host_state.items():
        a = np.asarray(leaf)
        if a.shape[0] % n_trustees:
            raise ValueError(
                f"state leaf {name!r}: {a.shape[0]} rows do not split over "
                f"{n_trustees} trustees")
        a = a.reshape((n_trustees, -1) + a.shape[1:])
        if n_clients:
            a = np.concatenate([np.zeros((n_clients,) + a.shape[1:],
                                         a.dtype), a])
        out[name] = torch.tensor(np.ascontiguousarray(a), device=dev)
    return out


def owner_major_from_stacked(state: Dict[str, torch.Tensor],
                             n_clients: int = 0) -> Dict[str, np.ndarray]:
    """Stacked tensors ``(T, rows, ...)`` -> owner-major numpy leaves
    ``(T * rows, ...)``, copied: a store's state is live (its serve writes
    in place), and the result is a snapshot of it.  ``n_clients`` > 0
    strips dedicated mode's client region (the first ``n_clients``
    shards) first."""
    return {name: leaf[n_clients:].detach().cpu().numpy().copy().reshape(
                (-1,) + tuple(leaf.shape[2:]))
            for name, leaf in state.items()}


ATTENTION_KEYS = ("w_q", "w_k", "w_v", "w_o", "b_q", "b_k", "b_v",
                  "q_norm", "k_norm")


def attention_params_from_jax(params: Dict, device=None,
                              dtype=None) -> Dict:
    """JAX attention parameters (``repro.models.attention.init_attention``,
    as numpy after ``np.asarray``) -> the port's dict (same keys, same
    layouts: ``w_q`` (D, Hq*Dh), ``w_o`` (Hq*Dh, D), ``q_norm`` /
    ``k_norm`` as ``{"scale": ...}``), copied onto ``device``.  ``dtype``
    casts the projections and biases; norm scales stay f32 as in JAX."""
    from .core.meshctx import resolve_device
    dev = resolve_device(device)
    unknown = sorted(set(params) - set(ATTENTION_KEYS))
    if unknown:
        raise ValueError(f"not attention parameters of the GQA layer: "
                         f"{unknown}")
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = {k: torch.tensor(np.asarray(v), device=dev)
                         for k, v in leaf.items()}
            continue
        t = torch.tensor(np.asarray(leaf), device=dev)
        out[name] = t if dtype is None else t.to(dtype)
    return out


# the leaves JAX keeps in f32 whatever the parameter dtype: norm scales,
# the MoE router, and the Mamba mixer's dt bias, log(-A) and D
F32_LEAVES = ("scale", "router", "b_dt", "log_a", "d_skip")


def model_params_from_jax(params: Dict, device=None, dtype=None) -> Dict:
    """A JAX model tree (``repro.models.model.init_params``, as numpy
    after ``np.asarray``) -> the port's tree: the same keys and layouts
    (layer leaves stacked ``(n_groups, ...)`` under ``groups/pos<j>``),
    copied onto ``device``.  ``dtype`` casts every leaf but those JAX
    keeps in f32 (``F32_LEAVES``)."""
    from .core.meshctx import resolve_device
    dev = resolve_device(device)

    def conv(tree, key=None):
        if isinstance(tree, dict):
            return {k: conv(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v, key) for v in tree]
        t = torch.tensor(np.asarray(tree), device=dev)
        keep = key in F32_LEAVES and t.dtype == torch.float32
        return t if dtype is None or keep else t.to(dtype)
    return conv(params)


def model_params_to_numpy(params: Dict) -> Dict:
    """The port's model tree -> numpy leaves (f32 for bf16 leaves: numpy
    has no bfloat16), copied."""
    if isinstance(params, dict):
        return {k: model_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [model_params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def kv_cache_to_global(cache: Dict) -> Dict:
    """The port's stacked decode cache -> numpy in the JAX layout, the
    trustees' shards laid end to end along the sequence: GQA leaves
    ``k`` / ``v`` ``(..., T, B, Hkv, S/T, Dh)`` -> ``(..., B, Hkv, S,
    Dh)``, MLA leaves ``latent`` / ``k_rope`` ``(..., T, B, S/T, r)`` ->
    ``(..., B, S, r)``; an encoder-decoder cache's ``self`` {k, v} and
    its ``cross_k`` / ``cross_v`` (stacked as ``k`` / ``v`` are) alike,
    nested as JAX nests them.  A hybrid stack's Mamba layers keep their
    ``conv`` / ``ssm`` state whole, in JAX's layout already
    (``mamba_cache_to_numpy``)."""
    def glob(leaf, lead_dims):
        x = leaf.detach().cpu().float().movedim(-lead_dims, -3)
        return x.reshape(x.shape[:-3] + (-1, x.shape[-1])).numpy().copy()

    def leaf(k, v):
        if isinstance(v, dict):
            return kv_cache_to_global(v)
        if k in ("conv", "ssm"):
            return mamba_cache_to_numpy({k: v})[k]
        return glob(v, 4 if k in ("latent", "k_rope") else 5)
    return {k: leaf(k, v) for k, v in cache.items()}


def mamba_cache_to_numpy(cache: Dict) -> Dict[str, np.ndarray]:
    """The port's Mamba decode state -> numpy in the JAX layout (the same:
    ``conv`` (..., B, d_conv - 1, DI), ``ssm`` (..., B, DI, N)), f32."""
    return {k: v.detach().cpu().float().numpy().copy()
            for k, v in cache.items()}
