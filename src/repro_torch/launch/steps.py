"""Step functions of the model path: the prefill and decode cells of
``repro.launch.steps.build_cell``, as plain functions — PyTorch runs
eagerly, so there is no jit, and the port's one card needs no shardings.

    plan = build_cell(cfg, ShapeConfig("p", 2048, 4, "prefill"), run)
    logits = plan.step_fn(params, {"tokens": tokens})          # (B, V) f32
    plan = build_cell(cfg, ShapeConfig("d", max_len, 8, "decode"), run)
    next_tok, cache = plan.step_fn(params, cache, tokens, pos)
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from ..configs.base import ModelConfig, RunConfig, ShapeConfig
from ..models import model as M


class CellPlan(NamedTuple):
    cfg: ModelConfig
    shape: ShapeConfig
    run: RunConfig
    step_fn: Any


@torch.no_grad()
def prefill_step(params, batch, cfg: ModelConfig, run=None) -> torch.Tensor:
    """Last-token logits (B, V), f32, of a prompt batch
    ``{"tokens": (B, S)}`` through ``transformer.prefill`` (attention
    through the flash kernel and Mamba layers through the selective-scan
    kernel under ``run.use_pallas``)."""
    return M.prefill(params, batch, cfg, run)


@torch.no_grad()
def serve_step(params, cache, tokens, pos, cfg: ModelConfig, run=None):
    """One greedy decode step: (next token (B,) int32, cache) — the KV or
    Mamba state cache updated in place."""
    logits, cache = M.decode_step(params, cache, tokens, pos, cfg, run)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def build_cell(cfg: ModelConfig, shape: ShapeConfig,
               run: RunConfig = None) -> CellPlan:
    """The step of one (arch x shape) cell, with ``cfg`` and ``run``
    bound: ``prefill_step(params, batch)`` or ``serve_step(params, cache,
    tokens, pos)``.  Training cells wait for ROADMAP queue A 13(d)."""
    if run is None:
        run = RunConfig(model=cfg, shape=shape)
    if shape.kind == "prefill":
        fn = prefill_step
    elif shape.kind == "decode":
        fn = serve_step
    else:
        raise NotImplementedError(f"{shape.kind!r} cells: training is not "
                                  f"ported yet (ROADMAP queue A 13(d))")
    return CellPlan(cfg, shape, run, functools.partial(fn, cfg=cfg, run=run))
