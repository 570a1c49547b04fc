"""Continuous serving driver — dispatch-ahead engine rounds.

The torch counterpart of ``repro.launch.streaming``.  ``dispatch()`` runs
``session.step(sync=False)``: the engine issues the wave's round on
PyTorch's current stream and records a CUDA event behind it, and the
driver waits on that event only when it CONSUMES the wave, up to ``depth``
waves later.  In between the host packs and issues the following waves;
they run after wave k on the same stream, so the trustees still apply the
waves in dispatch order and the responses equal a lockstep run's.

``AdmissionControl`` is the host-side row-token bucket (with optional
per-user buckets) bounding the rows in flight across unconsumed waves;
``admit()`` consumes the oldest waves until the bucket has room.

``wave_budget`` sizes the next wave from the session planner's demand
EMA, read only at quiesce points.  ``checkpoint`` quiesces before the
session snapshot; ``recover`` drops the torn waves and re-entrusts (a
kill) or restores (a drop or tear).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class WaveHandle:
    """One dispatched engine round and the bookkeeping to consume it."""
    wave_id: int
    outputs: Any = None              # TrustFutures (or anything) to consume
    rows: int = 0
    rids: Tuple[int, ...] = ()
    on_consume: Optional[Callable[["WaveHandle"], None]] = None
    dispatched_at: float = 0.0
    consumed_at: float = -1.0
    users: Optional[Dict[Any, int]] = None   # per-user row breakdown
    events: List[Any] = field(default_factory=list)  # the wave's CUDA events

    @property
    def wave_latency_s(self) -> float:
        return self.consumed_at - self.dispatched_at


class AdmissionControl:
    """Row-token bucket over the waves in flight (see
    ``repro.launch.streaming.AdmissionControl``).  ``per_user_rows`` adds
    per-user buckets under the global one; a wave refused on any bucket
    consumes nothing."""

    def __init__(self, max_inflight_rows: int,
                 per_user_rows: Optional[int] = None):
        if max_inflight_rows <= 0:
            raise ValueError(
                f"max_inflight_rows must be positive, got {max_inflight_rows}")
        if per_user_rows is not None and per_user_rows <= 0:
            raise ValueError(
                f"per_user_rows must be positive, got {per_user_rows}")
        self.max_inflight_rows = max_inflight_rows
        self.per_user_rows = per_user_rows
        self.inflight_rows = 0
        self.admitted = 0
        self.refused = 0
        self.user_inflight: Dict[Any, int] = {}
        self.user_refused: Dict[Any, int] = {}

    def try_admit(self, rows: int,
                  users: Optional[Dict[Any, int]] = None) -> bool:
        if self.inflight_rows + rows > self.max_inflight_rows:
            self.refused += 1
            return False
        if self.per_user_rows is not None and users:
            over = [u for u, r in users.items()
                    if self.user_inflight.get(u, 0) + r > self.per_user_rows]
            if over:
                self.refused += 1
                for u in over:
                    self.user_refused[u] = self.user_refused.get(u, 0) + 1
                return False
        self.inflight_rows += rows
        self.admitted += rows
        if users:
            for u, r in users.items():
                self.user_inflight[u] = self.user_inflight.get(u, 0) + r
        return True

    def release(self, rows: int,
                users: Optional[Dict[Any, int]] = None) -> None:
        if rows > self.inflight_rows:
            raise RuntimeError("released more rows than admitted")
        self.inflight_rows -= rows
        if users:
            for u, r in users.items():
                left = self.user_inflight.get(u, 0) - r
                if left < 0:
                    raise RuntimeError(
                        f"released more rows than admitted for user {u!r}")
                self.user_inflight[u] = left


class StreamingDriver:
    """Dispatch-ahead driver over one ``TrustSession``.

    ``depth`` is the number of dispatched-but-unconsumed waves allowed to
    remain in flight after ``dispatch()`` returns: 0 is the lockstep loop
    (dispatch, wait, consume), 1 double buffering, larger values queue
    deeper.  ``events`` records ``("dispatch", k)`` / ``("consume", k)`` in
    host order, so a test can see wave k+1 dispatched before wave k was
    consumed."""

    def __init__(self, session, depth: int = 1,
                 admission: Optional[AdmissionControl] = None,
                 headroom: float = 1.5, min_wave: int = 64,
                 max_wave: int = 65536):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self.session = session
        self.depth = depth
        self.admission = admission
        self.headroom = headroom
        self.min_wave = min_wave
        self.max_wave = max_wave
        self._ema_cache: Dict[Any, float] = {}
        self._inflight: deque = deque()
        self._next_wave = 0
        self.events: List[Tuple[str, int]] = []
        self.consumed: List[WaveHandle] = []

    # -- pipeline core ------------------------------------------------------
    def dispatch(self, outputs: Any = None, rows: int = 0,
                 rids: Tuple[int, ...] = (),
                 on_consume: Optional[Callable] = None,
                 users: Optional[Dict[Any, int]] = None) -> WaveHandle:
        """Issue ONE engine round over everything pending on the session
        and park its handle.  Blocks only to keep the pipeline at ``depth``
        in-flight waves (consuming oldest-first)."""
        h = WaveHandle(wave_id=self._next_wave, outputs=outputs, rows=rows,
                       rids=tuple(rids), on_consume=on_consume,
                       dispatched_at=time.perf_counter(), users=users)
        self._next_wave += 1
        self.session.step(sync=False)
        h.events = list(self.session.wave_events)
        self._inflight.append(h)
        self.events.append(("dispatch", h.wave_id))
        while len(self._inflight) > self.depth:
            self._consume_oldest()
        return h

    def admit(self, rows: int,
              users: Optional[Dict[Any, int]] = None) -> None:
        """Reserve ``rows`` admission tokens (and per-user tokens when a
        ``users`` breakdown is given), consuming in-flight waves
        oldest-first until the buckets have room.  No-op without admission
        control.  Raises if ``rows`` can never fit."""
        if self.admission is None:
            return
        if rows > self.admission.max_inflight_rows:
            raise ValueError(
                f"wave of {rows} rows exceeds the admission budget "
                f"{self.admission.max_inflight_rows} outright")
        pu = self.admission.per_user_rows
        if pu is not None and users:
            worst = max(users.values())
            if worst > pu:
                raise ValueError(
                    f"a user's {worst} rows exceed the per-user budget "
                    f"{pu} outright")
        while not self.admission.try_admit(rows, users):
            if not self._inflight:
                raise RuntimeError(
                    "admission bucket too small for already-released rows")
            self._consume_oldest()

    def _consume_oldest(self) -> WaveHandle:
        h = self._inflight.popleft()
        for ev in h.events:          # this wave's device work, not later ones
            ev.synchronize()
        h.consumed_at = time.perf_counter()
        self.events.append(("consume", h.wave_id))
        if self.admission is not None:
            self.admission.release(h.rows, h.users)
        # refresh wave_budget's EMA cache only at QUIESCE points: with waves
        # still in flight the planner's staged demand belongs to an
        # unfinished round, and reading it would wait for that round
        if not self._inflight:
            planner = self.session.planner
            for sig in list(planner._staged):
                self._ema_cache[sig] = planner.ema(sig)
        if h.on_consume is not None:
            h.on_consume(h)
        self.consumed.append(h)
        return h

    def drain(self) -> List[WaveHandle]:
        """Consume every wave still in flight (end of stream)."""
        while self._inflight:
            self._consume_oldest()
        return self.consumed

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def quiesce(self) -> None:
        """Consume every in-flight wave AND flush anything still queued on
        the session: afterwards no wave is in flight and no trust has
        pending submissions."""
        self.drain()
        if not self.session.quiesced():
            self.session.step()
            self.drain()

    def checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        """Quiesce the pipeline, then snapshot the session
        (``TrustSession.checkpoint``): the only correct way to checkpoint
        a streaming session with waves in flight.  Returns the step."""
        self.quiesce()
        return self.session.checkpoint(directory, step=step)

    def recover(self, failure, ckpt_dir: str, survivors=None,
                plan=None) -> int:
        """The failover sequence for a ``TrusteeFailure`` raised out of
        ``dispatch()``: drop the torn in-flight waves without waiting on
        them (their state never committed) and the admission ledger's
        in-flight rows; re-entrust onto the survivors when a shard was
        killed, else restore the last snapshot in place.  Returns the
        snapshot step to replay from: the caller re-submits every wave
        after it inside ``session.replaying()``."""
        self._inflight.clear()
        if self.admission is not None:
            self.admission.inflight_rows = 0
            self.admission.user_inflight.clear()
        if getattr(failure, "kind", "kill") == "kill":
            self.session.re_entrust(
                [failure.shard] if failure.shard is not None else [],
                survivors=survivors, ckpt_dir=ckpt_dir, plan=plan)
        else:
            self.session.restore(ckpt_dir)
        snap = self.session._last_snapshot
        return snap[1] if snap is not None else 0

    def wave_budget(self, trusts, fallback: Optional[int] = None) -> int:
        """Target rows for the next wave, from the planner's demand EMA: a
        wave of ``headroom * EMA * n_pairs`` rows keeps the hot pair's
        expected demand at the planned primary block (§5.3.1).  Reads only
        the EMA cached at quiesce points; before the first one returns
        ``fallback`` (or ``max_wave``)."""
        trusts = [getattr(t, "trust", t) for t in trusts]
        if len(trusts) > 1:
            sig = ("mux", self.session._mux_signature(trusts[0]))
        else:
            sig = ("solo", trusts[0].token)
        ema = self._ema_cache.get(sig)
        if ema is None or ema <= 0:
            return fallback if fallback is not None else self.max_wave
        g = trusts[0].group
        n_pairs = g.n_clients * g.n_trustees * max(1, len(trusts))
        target = int(self.headroom * ema * n_pairs)
        return max(self.min_wave, min(self.max_wave, target))

    # -- telemetry ----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Host-side pipeline telemetry over the consumed waves."""
        waves = self.consumed
        lat = [h.wave_latency_s for h in waves if h.consumed_at >= 0]
        # a wave overlapped if some LATER wave was dispatched before it was
        # consumed
        overlapped, newest = 0, -1
        for kind, wid in self.events:
            if kind == "dispatch":
                newest = max(newest, wid)
            elif newest > wid:
                overlapped += 1
        out = {"waves": len(waves),
               "rows": sum(h.rows for h in waves),
               "depth": self.depth,
               "overlapped_waves": overlapped,
               "mean_wave_latency_s": (sum(lat) / len(lat)) if lat else 0.0}
        if self.admission is not None:
            out["admitted_rows"] = self.admission.admitted
            out["admission_refusals"] = self.admission.refused
            if self.admission.user_refused:
                out["user_refusals"] = dict(self.admission.user_refused)
        return out
