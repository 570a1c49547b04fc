"""Fault-tolerant driver logic: checkpoint/restart, failure injection,
straggler mitigation, elastic rescale hooks.

The torch counterpart of ``repro.runtime.fault_tolerance``: the same host
logic over the port's checkpoint module (``repro_torch.checkpoint``).

At thousand-node scale the failure model is: (a) hard node loss -> the SPMD
program dies -> the job restarts from the newest checkpoint (possibly on a
different mesh — elastic); (b) stragglers -> per-step deadline accounting
decides between waiting, re-issuing the step (deterministic data pipeline
makes re-issue exact), or excluding the slow host at the next restart.

This module implements the control plane as testable host-side logic:
  * TrainLoop — step loop with periodic atomic checkpoints + resume.
  * FailureInjector — deterministic fault schedule for tests/examples.
  * StragglerMonitor — EWMA step-time tracker with deadline policy.
  * ElasticPlan — decides the new mesh when the healthy-device count drops.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..checkpoint import checkpoint as ckpt


class SimulatedFailure(RuntimeError):
    pass


class TrusteeFailure(RuntimeError):
    """A trustee shard died (or its round tore) during an engine wave.

    Raised by ``DelegationEngine.step()`` when an ``EngineFailureInjector``
    fires (or, in production, when the runtime detects a dead device).
    Carries enough context for the recovery path to act without re-deriving
    engine state: which trusts were in the failed wave, the wave id, the
    failed shard index, and the last session snapshot step (None if the
    session never checkpointed).

    Failure kinds:
      * ``kill``  — the shard is gone; recover via ``session.re_entrust``.
      * ``drop``  — a response wave was lost in flight; state did NOT commit.
      * ``tear``  — the round tore between dispatch and consumption; state
        did NOT commit and pending queues were restored.
    In every kind the failure surfaces BEFORE any future is fulfilled and
    BEFORE any trust state commits, so recovery semantics are uniform:
    restore the last snapshot and replay the waves since.
    """

    def __init__(self, msg: str, *, kind: str = "kill",
                 trusts: Tuple[str, ...] = (), wave_id: int = -1,
                 shard: Optional[int] = None,
                 last_snapshot_step: Optional[int] = None):
        super().__init__(msg)
        self.kind = kind
        self.trusts = tuple(trusts)
        self.wave_id = wave_id
        self.shard = shard
        self.last_snapshot_step = last_snapshot_step


@dataclass
class FailureInjector:
    """Deterministic failure schedule: fail when step in ``at_steps``."""
    at_steps: Tuple[int, ...] = ()
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclass
class EngineFailureInjector:
    """Deterministic trustee-failure schedule keyed on the engine wave counter.

    ``schedule`` maps wave id -> (kind, shard) with kind in
    {"kill", "drop", "tear"}.  Installed via
    ``session.install_injector(inj)``; the engine consults it at two points:
    ``before_dispatch`` (kill — the shard is dead before the round runs) and
    ``after_dispatch`` (drop/tear — the round ran but its results are lost
    before any state committed).  Each entry fires at most once, so replayed
    waves (which get fresh wave ids) are not re-killed unless scheduled.
    """
    schedule: Dict[int, Tuple[str, int]] = field(default_factory=dict)
    fired: set = field(default_factory=set)

    def _probe(self, wave_id: int, phase: str) -> Optional[Tuple[str, int]]:
        entry = self.schedule.get(wave_id)
        if entry is None or wave_id in self.fired:
            return None
        kind = entry[0]
        pre = kind == "kill"
        if (phase == "before") != pre:
            return None
        self.fired.add(wave_id)
        return entry

    def scheduled_after(self, wave_id: int) -> bool:
        """Whether ``after_dispatch(wave_id)`` would fire — read without
        firing: the port's rounds write their tables in place, so the
        engine snapshots them only before a round that will tear."""
        entry = self.schedule.get(wave_id)
        return (entry is not None and wave_id not in self.fired
                and entry[0] != "kill")

    def before_dispatch(self, wave_id: int) -> Optional[Tuple[str, int]]:
        return self._probe(wave_id, "before")

    def after_dispatch(self, wave_id: int) -> Optional[Tuple[str, int]]:
        return self._probe(wave_id, "after")


def delegation_elastic_plan(n_devices: int) -> "ElasticPlan":
    """ElasticPlan ladder for delegation meshes: 1-D (1, k) trustee rings
    shrinking by one shard at a time, so killing any single trustee always
    has a viable next rung (unlike the pow2 training ladder)."""
    ladder = tuple((1, k) for k in range(n_devices, 0, -1))
    return ElasticPlan(ladder=ladder)


@dataclass
class StragglerMonitor:
    """EWMA of step times; flags steps exceeding ``deadline_factor`` x EWMA.

    Mitigation at single-controller scale is re-issue (the deterministic
    pipeline regenerates the identical batch); at multi-controller scale the
    flag feeds the ElasticPlan to exclude the slow host on restart."""
    deadline_factor: float = 3.0
    alpha: float = 0.1
    ewma: Optional[float] = None
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = dt > self.deadline_factor * self.ewma
        if is_straggler:
            self.flagged.append(step)
        else:
            # only track healthy steps so one straggler doesn't poison the EWMA
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


@dataclass
class ElasticPlan:
    """Mesh-downsize ladder: given healthy device count, pick the largest
    (data, model) grid from the allowed ladder that fits."""
    ladder: Tuple[Tuple[int, int], ...] = ((16, 16), (8, 16), (4, 16), (2, 16),
                                           (1, 16), (1, 8), (1, 4), (1, 2),
                                           (1, 1))

    def choose(self, healthy_devices: int) -> Tuple[int, int]:
        for shape in self.ladder:
            if shape[0] * shape[1] <= healthy_devices:
                return shape
        raise RuntimeError("no viable mesh")


@dataclass
class TrainLoopConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 5


def _host_copy(tree: Any) -> Any:
    """Every tensor of a (dict / list / tuple) tree copied to the host."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_host_copy(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _placed_like(tree: Any, like: Any) -> Any:
    """``tree`` (a ``_host_copy``) with each tensor on ``like``'s device."""
    if isinstance(tree, dict):
        return {k: _placed_like(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_placed_like(v, w) for v, w in zip(tree, like)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    if isinstance(tree, torch.Tensor):
        return tree.to(like.device)
    return tree


class TrainLoop:
    """Generic fault-tolerant step loop.

    step_fn(state, step) -> (state, metrics) must be pure w.r.t. the step
    index (deterministic data by step).  It may update the state's
    tensors in place (the port's AdamW does): with an injector, the loop
    keeps a host copy of the initial state, which a restart with no
    checkpoint on disk begins from, as JAX's loop restarts from its
    (immutable) initial arrays.  A restart binds the state to new tensors
    (``ckpt.restore``, or the host copy placed anew): a captured train
    step (``launch.steps.CompiledCell``, one program a cell) then
    captures on the new addresses and releases the program, and the
    pool, of the old ones.
    """

    def __init__(self, cfg: TrainLoopConfig, step_fn: Callable,
                 state: Any, injector: Optional[FailureInjector] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 on_metrics: Optional[Callable] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.injector = injector
        self.monitor = monitor or StragglerMonitor()
        self.on_metrics = on_metrics
        self.restarts = 0

    def resume_step(self) -> int:
        s = ckpt.latest_step(self.cfg.ckpt_dir)
        return 0 if s is None else s

    def run(self, n_steps: int, start_step: Optional[int] = None) -> Dict:
        init_state = self.state if self.injector is None \
            else _host_copy(self.state)
        step = self.resume_step() if start_step is None else start_step
        if step > 0:
            self.state, step, _ = ckpt.restore(self.cfg.ckpt_dir, self.state)
        history = []
        while step < n_steps:
            try:
                t0 = time.monotonic()
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                self.state, metrics = self.step_fn(self.state, step)
                dt = time.monotonic() - t0
                straggler = self.monitor.observe(step, dt)
                if self.on_metrics:
                    self.on_metrics(step, metrics, dt, straggler)
                history.append((step, metrics))
                step += 1
                if step % self.cfg.ckpt_every == 0 or step == n_steps:
                    ckpt.save(self.cfg.ckpt_dir, step, self.state,
                              extra={"restarts": self.restarts})
                    ckpt.prune_old(self.cfg.ckpt_dir, self.cfg.keep)
            except SimulatedFailure:
                # restart-from-checkpoint path (same process in tests; in
                # production this is a fresh job incarnation)
                self.restarts += 1
                if self.restarts > self.cfg.max_retries:
                    raise
                resumed = ckpt.latest_step(self.cfg.ckpt_dir)
                if resumed is None:
                    # no checkpoint on disk: a real restart begins from the
                    # INITIAL state, not the partially-advanced one
                    step = 0
                    self.state = _placed_like(init_state, self.state)
                else:
                    self.state, step, _ = ckpt.restore(self.cfg.ckpt_dir,
                                                       self.state)
        return {"final_step": step, "restarts": self.restarts,
                "history": history,
                "stragglers": list(self.monitor.flagged)}
