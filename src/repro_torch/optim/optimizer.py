"""AdamW and its schedule over the port's parameter trees (the torch
counterpart of ``repro.optim.optimizer``).

A tree is a dict (or list) of tensors; leaves are visited in JAX's tree
order (dict keys sorted), so a sum over leaves adds in JAX's order.  The
state mirrors the parameters: the moments ``m`` and ``v`` (f32 unless
given another dtype) and a scalar step count.

``adamw_update`` writes the parameters and the moments IN PLACE (JAX
donates ``params`` and ``opt_state`` to its jitted step and gets new
buffers back); it works one leaf at a time, and a large leaf in blocks
of its leading dimension, so its f32 temporaries stay small and the
clipped f32 gradient is never held whole.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import torch

Pytree = Any


def tree_leaves(tree: Pytree) -> List[torch.Tensor]:
    """Leaves in JAX's tree order: dict keys sorted, lists in order."""
    return list(_walk(tree))


def _walk(tree: Pytree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def tree_unflatten(like: Pytree, leaves) -> Pytree:
    """A tree shaped like ``like`` from ``leaves`` in JAX's tree order."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            out = {k: build(tree[k]) for k in sorted(tree)}
            return {k: out[k] for k in tree}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        return next(it)
    return build(like)


def tree_map(fn, tree: Pytree) -> Pytree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Pytree                # like params
    v: Pytree


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 20
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, f32."""
    s = step.float()
    warm = torch.clamp(s / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0,
                       1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    ratio = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * ratio


def init_adamw(params: Pytree, dtype=torch.float32) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree: Pytree) -> torch.Tensor:
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a true division (``float / tensor`` is a reciprocal times the float)
    return torch.clamp(torch.full_like(norm, max_norm)
                       / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Pytree, max_norm: float
                        ) -> Tuple[Pytree, torch.Tensor]:
    """(the gradients in f32 scaled to a global norm of at most
    ``max_norm``, the norm before)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, state: AdamWState, params: Pytree,
                 grads: Pytree) -> Tuple[Pytree, AdamWState, Dict]:
    """One AdamW step (grads already combined over data parallel):
    clip by the global norm, then the bias-corrected update with
    decoupled weight decay at the scheduled learning rate.  ``params``
    and the moments are updated in place and returned with the new
    state; the metrics are ``grad_norm`` and ``lr``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for leaves in zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(state.m), tree_leaves(state.v)):
        for p, g, m, v in _blocks(*leaves):
            g = g.float() * scale
            mf = b1 * m.float() + (1 - b1) * g
            vf = b2 * v.float() + (1 - b2) * g * g
            delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(mf)
            v.copy_(vf)
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": norm, "lr": lr}


# elements of a leaf one AdamW pass updates at a time: each f32
# temporary is at most 256 MB (a stacked qwen2.5-3b MLP leaf is 0.8 B)
BLOCK_ELEMS = 1 << 26


def _blocks(*leaves):
    """Views of equal-shaped leaves over blocks of their leading
    dimension of at most ``BLOCK_ELEMS`` elements (the whole leaf when it
    is smaller, or 0-d); the update is elementwise, so blocks give the
    same values."""
    lead = leaves[0]
    if lead.dim() == 0 or lead.numel() <= BLOCK_ELEMS:
        yield leaves
        return
    rows = max(1, BLOCK_ELEMS // max(1, lead[0].numel()))
    for i in range(0, lead.shape[0], rows):
        yield tuple(x[i:i + rows] for x in leaves)
