"""Step functions of the model path: the train, prefill and decode cells
of ``repro.launch.steps.build_cell`` (the port's one card needs no
shardings).  JAX jits each step; here each is a captured program
(``core.compiled``: a CUDA graph on the card, captured after one eager
call and replayed; the stand-in on the CPU):

  * decode (``CompiledStep``): keyed by the tokens' and positions' shapes
    and dtypes and the addresses of the weights and the cache, which it
    writes in place as JAX's donated cache;
  * train (``CompiledCell``): keyed by the batch's shapes and dtypes and
    the addresses of the parameters and the optimizer state, which it
    writes in place as JAX's donated ``(params, opt_state)``;
  * prefill (``CompiledCell``): keyed by the batch's shapes and dtypes
    and the weights' addresses; no state.

The train and prefill cells keep one program each (a new key releases
the old); ``plan.release()`` drops a cell's programs and their pools.
``compiled.disable()`` runs every step eagerly.

    plan = build_cell(cfg, ShapeConfig("t", 1024, 4, "train"), run)
    params, opt_state, metrics = plan.step_fn(params, opt_state, batch)
    plan = build_cell(cfg, ShapeConfig("p", 2048, 4, "prefill"), run)
    logits = plan.step_fn(params, {"tokens": tokens})          # (B, V) f32
    plan = build_cell(cfg, ShapeConfig("d", max_len, 8, "decode"), run)
    next_tok, cache = plan.step_fn(params, cache, tokens, pos)

``model.input_specs`` names a cell's batch: an embeds-input model's
prefill and train batches carry ``embeds`` (and M-RoPE's
``positions``), an encoder-decoder model's ``src_embeds`` and
``tokens``, and its prefill returns the encoder memory (B, S_src, D) in
place of logits.

The train step differentiates ``forward_loss`` through the plain
versions, as JAX trains with ``use_pallas=False``: no kernel has a
backward, and a train cell with ``run.use_pallas`` is refused.

``build_cell`` takes JAX's batch-axes rule (``batch_axes_of``): the
mesh's data axes when the global batch splits over the data size, else
``()`` (the batch replicated); it installs them, with ``mesh`` when
given (``meshctx.set_context``), and every step re-installs them, as
JAX's steps do.  The MoE reads them (``models.layers.dp_axes``): each
data row delegates its own sequences.  JAX's other data-axis layouts
(``zero_sharding``'s optimizer state over ``data``, the batch specs)
have no counterpart on one card.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import torch

from ..configs.base import ModelConfig, RunConfig, ShapeConfig
from ..core import compiled, meshctx
from ..models import model as M
from ..models.layers import dtype_of
from ..optim import AdamWConfig, adamw_update
from ..optim.optimizer import (AdamWState, tree_leaves, tree_map,
                               tree_unflatten)


class CellPlan(NamedTuple):
    cfg: ModelConfig
    shape: ShapeConfig
    run: RunConfig
    step_fn: Any

    def release(self) -> None:
        """Drop the step's captured programs and their pools."""
        self.step_fn.__wrapped__.release()


@torch.no_grad()
def prefill_step(params, batch, cfg: ModelConfig, run=None) -> torch.Tensor:
    """Last-token logits (B, V), f32, of a prompt batch
    ``{"tokens": (B, S)}`` (an embeds-input model's ``{"embeds", ...}``)
    through ``model.prefill``, or an encoder-decoder model's encoder
    memory of ``{"src_embeds": (B, S, D), ...}`` (attention through the
    flash kernel and Mamba layers through the selective-scan kernel under
    ``run.use_pallas``)."""
    return M.prefill(params, batch, cfg, run)


@torch.no_grad()
def serve_step(params, cache, tokens, pos, cfg: ModelConfig, run=None):
    """One greedy decode step: (next token (B,) int32, cache) — the KV or
    Mamba state cache updated in place."""
    logits, cache = M.decode_step(params, cache, tokens, pos, cfg, run)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def adamw_config(run: RunConfig) -> AdamWConfig:
    return AdamWConfig(learning_rate=run.learning_rate,
                       weight_decay=run.weight_decay,
                       grad_clip=run.grad_clip)


def _micro(batch: Dict[str, torch.Tensor], accum: int, i: int):
    """Microbatch ``i`` of ``accum`` along the batch dimension; M-RoPE
    positions (3, B, S) carry the batch on their second (JAX's
    ``split_micro``)."""
    def part(k, v):
        if k == "positions" and v.dim() == 3:
            mb = v.shape[1] // accum
            return v[:, i * mb:(i + 1) * mb]
        mb = v.shape[0] // accum
        return v[i * mb:(i + 1) * mb]
    return {k: part(k, v) for k, v in batch.items()}


def value_and_grad(params, batch, cfg: ModelConfig, run: RunConfig):
    """(loss, metrics, grads) of ``forward_loss``; grads in the
    parameters' dtypes, zeros for a leaf the loss does not reach.  The
    parameter leaves are set to require grad."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = M.forward_loss(params, batch, cfg, run)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(p)
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_unflatten(params, grads)


def train_step(params, opt_state, batch, cfg: ModelConfig, run: RunConfig,
               acfg: AdamWConfig):
    """One optimizer step: value-and-grad of ``forward_loss`` (over
    ``run.grad_accum`` microbatches, the gradients summed in
    ``run.grad_accum_dtype`` and averaged), then ``adamw_update`` — the
    parameters and moments updated in place.  Returns (params, opt_state,
    metrics): ``nll``, ``accuracy``, the ``moe_*``, ``grad_norm``, ``lr``
    and ``loss``, f32 scalars on the device."""
    accum = max(1, run.grad_accum)
    if accum == 1:
        loss, metrics, grads = value_and_grad(params, batch, cfg, run)
    else:
        g_dtype = dtype_of(run.grad_accum_dtype)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=g_dtype,
                                               device=p.device), params)
        loss, metrics = 0.0, None
        for i in range(accum):
            l_i, m_i, g_i = value_and_grad(params, _micro(batch, accum, i),
                                            cfg, run)
            for a, c in zip(tree_leaves(grads), tree_leaves(g_i)):
                a.add_(c.to(a.dtype))
            loss = loss + l_i
            metrics = m_i if metrics is None else \
                {k: metrics[k] + m_i[k] for k in metrics}
        grads = tree_map(lambda g: g.float() / accum, grads)
        loss = loss / accum
        metrics = {k: v / accum for k, v in metrics.items()}
    params, opt_state, om = adamw_update(acfg, opt_state, params, grads)
    return params, opt_state, {**metrics, **om, "loss": loss}


def batch_axes_of(run: RunConfig, shape: ShapeConfig):
    """JAX's rule: the mesh's data axes shard the batch when the global
    batch splits over the data size; otherwise ``()``."""
    if shape.global_batch % run.mesh.data_size == 0:
        return run.mesh.data_axes
    return ()


def _decode_body(fn, cache, params, inputs):
    """A decode step as a captured program's function: (state, out)."""
    tokens, pos = inputs
    next_tok, cache = fn(params, cache, tokens, pos)
    return cache, next_tok


class _Programs:
    """A step's captured programs, in ``programs`` by key."""

    def __init__(self, fn):
        self.fn = fn
        self.programs: Dict[Any, compiled.Program] = {}

    def release(self) -> None:
        """Drop every program and its pool (returned to the card)."""
        cuda = any(p.graph is not None for p in self.programs.values())
        for prog in self.programs.values():
            prog.release()
        self.programs.clear()
        if cuda:
            torch.cuda.empty_cache()


class CompiledStep(_Programs):
    """``serve_step`` with ``cfg`` and ``run`` bound, as captured programs:
    one ``compiled.Program`` a (tokens and positions shape and dtype,
    weights' and cache's addresses, device) key, in ``programs``.  The
    cache is held (written in place); the next token comes back fresh
    each call.  Under ``compiled.disable()`` the step runs eagerly."""

    def __call__(self, params, cache, tokens, pos):
        if not compiled.enabled():
            return self.fn(params, cache, tokens, pos)
        key = (compiled.signature((tokens, pos)), compiled.addresses(params),
               compiled.addresses(cache), str(tokens.device))
        prog = self.programs.get(key)
        if prog is None:
            # the program holds the step, not this object: no cycle
            # keeps a graph and its pool alive past the plan
            prog = self.programs[key] = compiled.Program(
                functools.partial(_decode_body, self.fn), "serve_step")
        cache, next_tok = prog(cache, params, (tokens, pos))
        return next_tok, cache


def _device(tree) -> torch.device:
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("a step takes at least one tensor")


def _train_body(fn, state, _fixed, batch):
    """A train step as a captured program's function: the state is
    (params, (step, m, v)), the moments and step of ``AdamWState`` as a
    plain tuple (a program's trees are dicts, lists and tuples)."""
    params, opt = state
    params, opt, metrics = fn(params, AdamWState(*opt), batch)
    return (params, tuple(opt)), metrics


def _prefill_body(fn, state, params, batch):
    """A prefill step as a captured program's function: no state."""
    return state, fn(params, batch)


class CompiledCell(_Programs):
    """``train_step`` (``site`` "train_step"; cfg, run and the AdamW config
    bound) or ``prefill_step`` ("prefill_step"), as ONE captured program
    a cell, keyed by (the batch's shapes and dtypes, the held tensors'
    addresses, device); a call with a new key (another batch shape, or a
    restore onto new tensors, as ``TrainLoop`` does on a restart) first
    releases the program before it with its pool: a full-width model's
    pool takes GBs, and two would not fit beside its weights (and
    moments).

      * train: ``(params, opt_state, batch) -> (params, opt_state,
        metrics)``.  The parameters and moments are held and written in
        place (AdamW's own writes), the new step count copied back into
        ``opt_state.step`` (JAX's donated arguments); the step, learning
        rate and bias corrections stay device tensors, so a replay
        follows the schedule.
      * prefill: ``(params, batch) -> out``.  The weights are held, read
        only; no state.

    The batch is copied into the program's buffers; the metrics, logits
    or encoder memory come back fresh each call.  Under
    ``compiled.disable()`` the step runs eagerly and nothing is
    cached."""

    def __init__(self, fn, site: str):
        super().__init__(fn)
        self.site = site
        self.train = site == "train_step"
        self.body = functools.partial(
            _train_body if self.train else _prefill_body, fn)

    def __call__(self, *args):
        *held, batch = args
        dev = _device(batch)
        if not compiled.enabled() or dev.type == "meta":
            return self.fn(*args)
        if self.train:
            params, opt_state = held
            state, fixed = (params, tuple(opt_state)), ()
        else:
            state, (fixed,) = (), held
        key = (compiled.signature(batch), compiled.addresses((state, fixed)),
               str(dev))
        prog = self.programs.get(key)
        if prog is None:
            self.release()
            prog = self.programs[key] = compiled.Program(self.body,
                                                         self.site)
        _, out = prog(state, fixed, batch)
        return (params, opt_state, out) if self.train else out


def _in_context(fn, axes, mesh):
    """``fn`` with the cell's batch axes (and ``mesh``) installed first."""
    @functools.wraps(fn)
    def step(*args, **kw):
        if mesh is not None:
            meshctx.set_context(mesh, axes)
        else:
            meshctx.set_batch_axes(axes)
        return fn(*args, **kw)
    return step


def build_cell(cfg: ModelConfig, shape: ShapeConfig,
               run: RunConfig = None, mesh=None) -> CellPlan:
    """The step of one (arch x shape) cell, with ``cfg`` and ``run``
    bound: ``train_step(params, opt_state, batch)``,
    ``prefill_step(params, batch)`` or ``serve_step(params, cache,
    tokens, pos)``.  ``mesh`` (a ``StackedMesh`` of ``run.mesh``'s shape)
    is installed as the ambient mesh with the batch axes."""
    if run is None:
        run = RunConfig(model=cfg, shape=shape)
    if mesh is not None and tuple(mesh.dims) != tuple(run.mesh.shape):
        raise ValueError(f"mesh {mesh.dims} is not run.mesh "
                         f"{run.mesh.shape}")
    axes = batch_axes_of(run, shape)
    if mesh is not None:
        meshctx.set_context(mesh, axes)
    else:
        meshctx.set_batch_axes(axes)
    if shape.kind == "train":
        if run.use_pallas:
            raise ValueError(
                "a train cell runs the plain versions: no kernel has a "
                "backward, and JAX trains with use_pallas=False")
        if shape.global_batch % max(1, run.grad_accum):
            raise ValueError(f"batch {shape.global_batch} does not split "
                             f"into {run.grad_accum} microbatches")
        return CellPlan(cfg, shape, run, _in_context(CompiledCell(
            functools.partial(train_step, cfg=cfg, run=run,
                              acfg=adamw_config(run)), "train_step"),
            axes, mesh))
    if shape.kind == "prefill":
        fn = CompiledCell(functools.partial(prefill_step, cfg=cfg, run=run),
                          "prefill_step")
    elif shape.kind == "decode":
        fn = CompiledStep(functools.partial(serve_step, cfg=cfg, run=run))
    else:
        raise ValueError(f"unknown cell kind {shape.kind!r}")
    return CellPlan(cfg, shape, run, _in_context(fn, axes, mesh))
