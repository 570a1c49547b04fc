"""DelegationEngine / TrustSession — executes every Trust's channel rounds.

The torch counterpart of ``repro.core.engine``.  Trusts register here at
``entrust`` time (weakly); ``submit`` marks a trust dirty and ``step()``
flushes every dirty trust: channel-compatible trusts (equal
``Trust.fuse_signature``) fuse into ONE multiplexed round, the rest flush
solo.  A round does what the JAX programs do:

  * concatenate the queued batches (an "op" column when more than one op
    is queued; payload fields a batch lacks are zero-filled);
  * pad the fused batch to a multiple of the client count and give each
    stacked client shard a CONTIGUOUS slice, exactly as JAX shards a batch
    with ``P(mesh axes)`` — this is what fixes the (client, slot) serve
    order (dedicated mode packs every row onto the leading ``n_clients``
    shards; the trustee shards hold only inactive padding; a sub-axis
    group's shards are then put in its replica-major order, and the
    responses back in mesh order);
  * one ``channel.delegate`` round over all shards — with
    ``overflow="defer"`` a ``channel.delegate_drain`` — with the request
    combiner of the round's combinable ops when ``combine="ref"``,
    responses sliced back per batch.

The multiplexed round lays the trusts' batches out trust-major with a
"trust" id lane, moves them on the "planes" wire (one request transpose,
one response transpose), and serves each trust's rows through its own op
table and state: with the lane layout (every trust's responses agree)
each trust owns a ``capacity`` lane of every (client, trustee) block,
otherwise every trust takes a masked pass over the shared block.  Each
trust's semantics are its solo semantics over the engine's row layout.

A ``CapacityPlanner`` turns the per-round demand (``group_sizes``) into an
EMA that sizes the next auto-capacity round: every fused round that holds
an auto-capacity trust, and solo rounds of trusts entrusted with
``plan_capacity=True``.

``step(sync=False)`` issues the rounds and returns without reading any
device value; it records a ``torch.cuda.Event`` per wave on PyTorch's
current stream (``wave_events``), so a dispatch-ahead driver can wait for
that wave alone, not for the waves issued after it.

The compiled-program cache (JAX's ``_cache``): each round is a captured
program (``core.compiled``: a CUDA graph on the card, replayed; the
stand-in on the CPU) covering the whole round, from the queued batches
through ``channel.delegate`` / ``delegate_drain`` to the per-batch
responses and the round's stats, which come back as fresh tensors.  It
is keyed as JAX keys it — ``("solo", (token,), batch signature,
capacity, overflow capacity, fuse signature)`` or ``("mux", tokens,
signatures, ...)`` — plus the state leaves' addresses and the device;
the state is written in place, and keeps its addresses.  Entries go as
JAX's go: a dead trust's in ``_prune``, a rebound trust's in
``re_entrust``; and, in the port only, whenever a trust's state is
rebound other than by a round (``Trust.set_state``,
``install_trustee_state``), so no replay reads a stale address.  Under
``compiled.disable()`` a round runs eagerly and nothing is cached.

Failover (DESIGN.md §14): every non-empty step takes a wave id
(``wave_counter``); an installed ``EngineFailureInjector`` kills a shard
before the round is dispatched, or drops / tears it after, before any
state commits or any future is fulfilled.  The port's serves write their
tables in place, so a round that an injector will tear (its entry is
peeked, not fired) runs on the live state after the engine has cloned it
(outside the captured round), and the clone is copied back when the
round tears: a tear leaves every table bit-identical, as JAX's
functional round does.  Without such an entry there is no clone and no
host read.
``checkpoint`` snapshots every trust's logical (owner-major) state at a
quiesce point, ``restore`` puts it back, ``re_entrust`` moves every trust
onto the survivors of a killed shard (``meshctx.survivors_mesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import channel as ch
from . import compiled


def check_payload_fields(named_batches) -> Dict[str, Tuple[str, Tuple]]:
    """Validate the zero-fill widening of a fused batch: ops that share a
    payload field name must agree on its dtype and trailing shape."""
    seen: Dict[str, Tuple[str, Tuple]] = {}
    for label, payload in named_batches:
        for name in sorted(payload.keys()):
            leaf = payload[name]
            sig = (leaf.dtype, tuple(leaf.shape[1:]))
            if name not in seen:
                seen[name] = (label, sig)
            elif seen[name][1] != sig:
                l0, s0 = seen[name]
                raise ValueError(
                    f"fused-batch payload field {name!r} is declared as "
                    f"{s0[0]}{list(s0[1])} by op {l0!r} but as "
                    f"{sig[0]}{list(sig[1])} by op {label!r}; ops fused into "
                    f"one channel round must agree on the dtype and trailing "
                    f"shape of shared payload fields (rename one of the "
                    f"fields or flush between the two submissions)")
    return seen


def _elidable_fields(ops, active_ids, resp_like) -> Tuple[str, ...]:
    """Response fields no active op writes (dropped from the transpose)."""
    if not isinstance(resp_like, dict):
        return ()
    written = set()
    for i in active_ids:
        rf = ops[i].resp_fields
        if rf is None:
            return ()
        written |= set(rf)
    return tuple(sorted(set(resp_like.keys()) - written))


class CapacityPlanner:
    """EMA-based primary-block sizing (paper §5.3.1, adaptive; see
    ``repro.core.engine.CapacityPlanner``).

    Observes the realized max per-(client, trustee) pair demand of each
    round and plans the next round's ``capacity`` as ``headroom * EMA``,
    rounded up to a power of two.  Observations are kept as device
    tensors and read back on the host only inside ``plan()`` / ``ema()``,
    so the round that produced them is never waited for on the hot path."""

    def __init__(self, alpha: float = 0.5, headroom: float = 1.5,
                 min_capacity: int = 4):
        self.alpha = alpha
        self.headroom = headroom
        self.min_capacity = min_capacity
        self._ema: Dict[Any, float] = {}
        self._staged: Dict[Any, Any] = {}

    def observe(self, sig, demand_max) -> None:
        self._staged[sig] = demand_max

    def prune(self, live_sigs) -> None:
        """Drop the entries no live trust can produce again."""
        live = set(live_sigs)
        for d in (self._ema, self._staged):
            for sig in [s for s in d if s not in live]:
                del d[sig]

    def _resolve(self, sig) -> None:
        staged = self._staged.pop(sig, None)
        if staged is None:
            return
        d = float(torch.as_tensor(staged).reshape(-1)[0])
        prev = self._ema.get(sig)
        self._ema[sig] = d if prev is None else \
            self.alpha * d + (1.0 - self.alpha) * prev

    def ema(self, sig) -> Optional[float]:
        self._resolve(sig)
        return self._ema.get(sig)

    def plan(self, sig, fallback: int) -> int:
        """Planned primary capacity, or ``fallback`` with no history yet."""
        ema = self.ema(sig)
        if ema is None or ema <= 0:
            return fallback
        need = max(1, int(math.ceil(self.headroom * ema)))
        return max(self.min_capacity, 1 << (need - 1).bit_length())


class DelegationEngine:
    """Session-wide execution engine for delegation rounds
    (``TrustSession``)."""

    def __init__(self, planner: Optional[CapacityPlanner] = None,
                 donate_states: bool = False):
        self._trusts: Dict[int, Any] = {}
        self._next_token = 0
        self._dirty: List[int] = []
        self._cache: Dict[Any, _Compiled] = {}
        self.planner = planner if planner is not None else CapacityPlanner()
        # JAX's keyword, taken and dropped: the port's rounds write the
        # state in place either way, so ``trust.state()`` stays live (a
        # settled divergence, ROADMAP.md)
        del donate_states
        self.rounds_dispatched = 0
        self._last_step_stats: Dict[str, Dict[str, Any]] = {}
        self._stats_owner: Dict[str, int] = {}
        self.last_step_info: Dict[str, Any] = {"fused": [], "solo": []}
        self.wave_events: List[Any] = []
        # -- resilience: a wave id per non-empty step (failure schedules key
        # on it, snapshots record it, replays get fresh ids)
        self.wave_counter = 0
        self._current_wave = -1
        self.injector = None            # EngineFailureInjector, if installed
        self.dead_shards: set = set()
        self.recovery = {"restores": 0, "replayed_rounds": 0,
                         "recovery_ms": 0.0}
        self._replaying = False
        self._last_snapshot: Optional[Tuple[str, int]] = None

    # -- registry -----------------------------------------------------------
    def register(self, trust) -> int:
        token = self._next_token
        self._next_token += 1
        self._trusts[token] = weakref.ref(trust)
        return token

    def _prune(self) -> None:
        dead = [tok for tok, ref in self._trusts.items() if ref() is None]
        for tok in dead:
            del self._trusts[tok]
        if dead:
            gone = set(dead)
            self._evict(gone)
            self._dirty = [tok for tok in self._dirty if tok not in gone]
            self._stats_owner = {n: tok for n, tok in
                                 self._stats_owner.items()
                                 if tok not in gone}
            # planner entries are keyed ("solo", token) / ("mux", fuse
            # signature): evict the ones no live trust can produce again
            live = [r() for r in self._trusts.values()]
            live_sigs = set()
            for t in live:
                if t is not None:
                    live_sigs.add(("solo", t.token))
                    live_sigs.add(("mux", self._mux_signature(t)))
            self.planner.prune(live_sigs)

    def _evict(self, tokens) -> None:
        """Drop every compiled round whose member set holds one of
        ``tokens``."""
        toks = set(tokens)
        self._cache = {k: v for k, v in self._cache.items()
                       if not toks & set(k[1])}

    def notify(self, trust) -> None:
        if trust.token not in self._dirty:
            self._dirty.append(trust.token)

    def unnotify(self, trust) -> None:
        if trust.token in self._dirty:
            self._dirty.remove(trust.token)

    # -- telemetry ----------------------------------------------------------
    def last_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-trust stats of the most recent round(s):
        ``{trust_name: {rounds, residual, demand_max, dropped,
        resp_bytes_saved, rows_combined, req_bytes_saved,
        impl_fallback}}``.  Reading them waits for the round's device
        work (``dropped`` and ``demand_max`` are device counts).  A fused
        round's members report its round-level ``resp_bytes_saved`` and
        their own ``residual`` (= ``dropped``) and ``demand_max``."""
        out = {name: {k: int(v) for k, v in d.items()}
               for name, d in self._last_step_stats.items()}
        # after a recovery: session-lifetime counters (restores, rounds run
        # inside replaying(), host ms spent restoring and rebinding)
        if self.recovery["restores"]:
            out["recovery"] = {
                "restores": int(self.recovery["restores"]),
                "replayed_rounds": int(self.recovery["replayed_rounds"]),
                "recovery_ms": float(self.recovery["recovery_ms"])}
        return out

    def _stats_key(self, trust) -> str:
        name = trust.name
        owner = self._stats_owner.get(name)
        if owner is None or owner == trust.token:
            self._stats_owner[name] = trust.token
            return name
        return f"{name}#{trust.token}"

    # -- step ---------------------------------------------------------------
    def trusts(self) -> List[Any]:
        """The live registered trusts, in registration order."""
        self._prune()
        return [t for t in (self._trusts[k]() for k in sorted(self._trusts))
                if t is not None]

    def quiesced(self) -> bool:
        """True when no trust has pending submissions (between engine
        rounds the trustee's linear op history has no in-flight prefix)."""
        return not self._dirty and all(not t._pending for t in self.trusts())

    def _mux_signature(self, trust):
        """The trust's fuse signature (``Trust.fuse_signature``), cached on
        the trust."""
        sig = getattr(trust, "_mux_sig", None)
        if sig is None:
            sig = trust.fuse_signature()
            trust._mux_sig = sig
        return sig

    def step(self, sync: bool = True):
        """Flush every pending batch in as few channel rounds as possible:
        channel-compatible trusts fuse into ONE multiplexed round, the rest
        flush solo; ``last_step_info`` names them.  Returns
        ``last_stats()``, UNLESS ``sync=False``: reading the stats waits
        for the round's device work, the barrier a dispatch-ahead driver
        (``launch/streaming.py``) must not pay.  ``sync=False`` issues the
        rounds, records ``wave_events`` (one event on the current stream
        of each CUDA device the rounds ran on; none on the CPU) and
        returns None; ``last_stats()`` later gives the same numbers."""
        self._prune()
        pending = []
        for tok in list(self._dirty):
            ref = self._trusts.get(tok)
            t = ref() if ref is not None else None
            if t is not None and t._pending:
                pending.append(t)
        if pending:
            # one wave id per non-empty step, probed BEFORE the queues are
            # taken, so a kill leaves them queued and notified
            self._current_wave = self.wave_counter
            self.wave_counter += 1
            if self.injector is not None:
                hit = self.injector.before_dispatch(self._current_wave)
                if hit is not None:
                    self._raise_failure(hit, self._current_wave, pending)
        self._dirty.clear()
        self._last_step_stats = {}
        self.last_step_info = {"fused": [], "solo": []}
        groups: Dict[Any, List[Any]] = {}
        for t in pending:
            groups.setdefault(self._mux_signature(t), []).append(t)
        remaining = list(pending)
        try:
            for members in groups.values():
                if len(members) == 1:
                    self.last_step_info["solo"].append(members[0].name)
                    members[0].flush()
                else:
                    self.last_step_info["fused"].append(
                        [t.name for t in members])
                    self._run_mux(members)
                for t in members:
                    remaining.remove(t)
        except Exception:
            # one group failing must not strand the others' pending batches
            # (the failed group restores its own queue and re-notifies)
            for t in remaining:
                if t._pending:
                    self.notify(t)
            raise
        if sync:
            return self.last_stats()
        self.wave_events = []
        for dev in {t.device for t in pending if t.device.type == "cuda"}:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self.wave_events.append(ev)
        return None

    # -- the solo round -----------------------------------------------------
    def _compiled(self, key, build, site) -> "_Compiled":
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = _Compiled(*build(), site)
        return entry

    def run_solo(self, trust, batches, capacity=None):
        """Run ``batches`` ([(op_id, dst, payload)]) of one trust as ONE
        channel round; its demand feeds the planner, which sizes the round
        when the trust was entrusted with ``plan_capacity=True`` and auto
        capacity.  Returns the per-batch responses in request order."""
        sizes = [int(b[1].shape[0]) for b in batches]
        r_total = sum(sizes)
        cfg = trust._cfg_for(r_total, capacity)
        sig = ("solo", trust.token)
        if capacity is None and trust.cfg.capacity == 0 \
                and trust.plan_capacity:
            cap = self.planner.plan(sig, cfg.capacity)
            over = cap if trust.cfg.overflow == "second_round" else 0
            cfg = dataclasses.replace(
                cfg, capacity=cap,
                overflow_capacity=trust.cfg.overflow_capacity or over)
        op_ids = [b[0] for b in batches]
        inputs = _round_inputs(batches, trust.device)
        build = lambda: _build_solo(trust, batches, cfg)       # noqa: E731
        if compiled.enabled():
            key = ("solo", (trust.token,),
                   trust.batch_signature(op_ids, sizes,
                                         [b[2] for b in batches]),
                   cfg.capacity, cfg.overflow_capacity, cfg.fuse_sig(),
                   compiled.addresses(trust._state), str(trust.device))
            entry = self._compiled(key, build, f"solo round of {trust.name}")
        else:
            entry = _Compiled(*build(), None)
        before = self._clone_if_tearing([trust])
        new_state, (resps, tel) = entry(trust._state, inputs)
        # a drop / tear fires here, before the state commits
        self._maybe_tear([trust], before)
        trust._state = new_state
        self.planner.observe(sig, tel["demand_max"])
        self.rounds_dispatched += 1
        if self._replaying:
            self.recovery["replayed_rounds"] += 1
        trust._last_stats = (tel["rounds"], tel["residual"])
        self._last_step_stats[self._stats_key(trust)] = {
            "rounds": tel["rounds"], "residual": tel["residual"],
            "demand_max": tel["demand_max"], "dropped": tel["dropped"],
            "resp_bytes_saved": entry.saved,
            "rows_combined": tel["rows_combined"],
            "req_bytes_saved": tel["req_bytes_saved"],
            "impl_fallback": tel["impl_fallback"]}
        return resps

    # -- the multiplexed round ----------------------------------------------
    def _mux_cfg(self, trusts, r_totals) -> ch.ChannelConfig:
        """One channel config for the fused round.  ``capacity`` is PER
        LANE: the trusts' shared explicit capacity (part of the fuse
        signature), or — with an auto-capacity trust — the planner's
        EMA-sized block, falling back to the static per-trust mean rule
        before any history exists."""
        base = trusts[0].cfg
        explicit = [t.cfg.capacity for t in trusts if t.cfg.capacity > 0]
        fallback = max(t._auto_capacity(rt)
                       for t, rt in zip(trusts, r_totals))
        cap = max(explicit) if explicit else 0
        if any(t.cfg.capacity == 0 for t in trusts):
            cap = max(cap, self.planner.plan(
                ("mux", self._mux_signature(trusts[0])), fallback))
        over = 0
        if base.overflow == "second_round":
            over = max((t.cfg.overflow_capacity for t in trusts),
                       default=0) or cap
        return dataclasses.replace(base, capacity=cap,
                                   overflow_capacity=over,
                                   wire_fmt="planes")

    def _run_mux(self, trusts) -> None:
        """One multiplexed round over ``trusts``' queued batches.  A round
        that raises puts every member's queue back (its state untouched)
        and re-notifies it, so the caller can drop the offending submit
        and step again."""
        entries = []
        for t in trusts:
            pending, t._pending = t._pending, []
            entries.append((t, pending))
        try:
            batches = [[(o, d, p) for (o, d, p, _f) in pend]
                       for _t, pend in entries]
            sizes = [[int(b[1].shape[0]) for b in tb] for tb in batches]
            cfg = self._mux_cfg(trusts, [sum(sz) for sz in sizes])
            inputs = [_round_inputs(tb, trusts[0].device) for tb in batches]
            build = lambda: _build_mux(trusts, batches, cfg)   # noqa: E731
            if compiled.enabled():
                key = ("mux", tuple(t.token for t in trusts),
                       tuple(t.batch_signature([b[0] for b in tb], sz,
                                               [b[2] for b in tb])
                             for t, tb, sz in zip(trusts, batches, sizes)),
                       cfg.capacity, cfg.overflow_capacity, cfg.fuse_sig(),
                       compiled.addresses(tuple(t._state for t in trusts)),
                       str(trusts[0].device))
                entry = self._compiled(
                    key, build,
                    f"fused round of {[t.name for t in trusts]}")
            else:
                entry = _Compiled(*build(), None)
            before = self._clone_if_tearing(trusts)
            new_states, (resps, tel) = entry(
                tuple(t._state for t in trusts), inputs)
            self._maybe_tear(trusts, before)
        except compiled.CaptureError:
            # the round ran (eagerly, before its capture failed): its
            # batches are not put back
            raise
        except Exception:
            for t, pend in entries:
                t._pending = pend + t._pending
                self.notify(t)
            raise
        self.rounds_dispatched += 1
        if self._replaying:
            self.recovery["replayed_rounds"] += 1
        self.planner.observe(("mux", self._mux_signature(trusts[0])),
                             tel["demand_merged"])
        for i, (t, pend) in enumerate(entries):
            t._state = new_states[i]
            t._last_stats = (tel["rounds"], tel["residual"][i])
            self._last_step_stats[self._stats_key(t)] = {
                "rounds": tel["rounds"], "residual": tel["residual"][i],
                "demand_max": tel["demand"][i],
                "dropped": tel["residual"][i],
                "resp_bytes_saved": entry.saved,
                "rows_combined": tel["combined"],
                "req_bytes_saved": tel["req_saved"],
                "impl_fallback": tel["impl_fallback"]}
            for (_o, _d, _p, fut), resp in zip(pend, resps[i]):
                fut._fulfil(resp)

    # -- resilience: snapshot / restore / failover (DESIGN.md §14) ----------
    def install_injector(self, injector) -> None:
        """Install an ``EngineFailureInjector`` (``repro_torch.runtime``):
        its schedule is probed each wave before dispatch (kill) and between
        dispatch and commit (drop / tear)."""
        self.injector = injector

    def _raise_failure(self, hit, wave_id: int, trusts) -> None:
        from ..runtime.fault_tolerance import TrusteeFailure
        kind, shard = hit
        if kind == "kill" and shard is not None:
            self.dead_shards.add(int(shard))
        snap = self._last_snapshot[1] if self._last_snapshot else None
        raise TrusteeFailure(
            f"trustee failure ({kind}) on shard {shard} at wave {wave_id}"
            f" (last snapshot: {'none' if snap is None else snap})",
            kind=kind, trusts=tuple(t.name for t in trusts),
            wave_id=wave_id, shard=shard, last_snapshot_step=snap)

    def _clone_if_tearing(self, trusts):
        """Each trust's physical state, cloned, when the injector will drop
        or tear the current wave (peeked, not fired); else None — the
        round then runs as it would with no injector."""
        if self.injector is None or \
                not self.injector.scheduled_after(self._current_wave):
            return None
        return [{k: v.clone() for k, v in t._state.items()} for t in trusts]

    def _maybe_tear(self, trusts, before) -> None:
        """Fire a drop / tear of the current wave after its round ran: the
        tables the round wrote in place get their clones back, and the
        failure is raised before any state commits."""
        if self.injector is None:
            return
        hit = self.injector.after_dispatch(self._current_wave)
        if hit is None:
            return
        for t, st in zip(trusts, before):
            for k, v in st.items():
                t._state[k].copy_(v)
        self._raise_failure(hit, self._current_wave, trusts)

    @contextlib.contextmanager
    def replaying(self):
        """Mark the enclosed rounds as recovery replays: they count in
        ``recovery["replayed_rounds"]``."""
        prev, self._replaying = self._replaying, True
        try:
            yield
        finally:
            self._replaying = prev

    def _logical_states(self, trusts) -> Dict[str, Dict[str, Any]]:
        """Each trust's logical state, owner-major numpy (the snapshot and
        reshard layout), copied off the device."""
        from ..convert import owner_major_from_stacked
        return {t.name: owner_major_from_stacked(t.trustee_state())
                for t in trusts}

    def checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        """Snapshot every registered trust's LOGICAL state into one atomic,
        crc-checked checkpoint (``repro_torch.checkpoint``), in the JAX
        package's layout and manifest, so either package restores it.
        Requires a quiesced session (the consistent cut between engine
        rounds) and unique trust names (the manifest key).  The manifest
        carries each trust's schema fingerprint, fuse signature, trustee
        count, mode, axes, dedicated count and mesh shape.  Returns the
        step (default: the current wave counter)."""
        from ..checkpoint import checkpoint as ckpt
        trusts = self.trusts()
        busy = sorted(t.name for t in trusts if t._pending)
        if busy:
            raise RuntimeError(
                f"session.checkpoint requires a quiesced session (snapshots "
                f"are taken between engine rounds); trusts with pending "
                f"submissions: {busy} — flush/step/drain first")
        names = [t.name for t in trusts]
        if len(set(names)) != len(names):
            raise ValueError(
                f"session.checkpoint needs unique trust names (the name is "
                f"the manifest key), got {sorted(names)}")
        if step is None:
            step = self.wave_counter
        meta = {}
        for t in trusts:
            g = t.group
            meta[t.name] = {
                "schema": (t.schema.fingerprint()
                           if t.schema is not None else None),
                "fuse_sig": repr(t.cfg.fuse_sig()),
                "n_trustees": g.n_trustees, "mode": g.mode,
                "axes": list(g.axes), "n_dedicated": g.n_dedicated,
                "mesh_shape": list(g.mesh.dims)}
        ckpt.save(directory, step, self._logical_states(trusts),
                  extra={"kind": "trust_session", "wave": self.wave_counter,
                         "trusts": meta})
        self._last_snapshot = (directory, step)
        return step

    def _read_snapshot(self, directory: str, trusts, step):
        from ..checkpoint import checkpoint as ckpt
        tree_like = {t.name: {k: 0 for k in t.trustee_state()}
                     for t in trusts}
        try:
            return ckpt.restore(directory, tree_like, step)
        except KeyError as e:
            raise ValueError(
                f"checkpoint under {directory} has no state for trust "
                f"leaf {e.args[0]!r}: the live session and the snapshot "
                f"disagree on registered trusts") from None

    def restore(self, directory: str, step: Optional[int] = None) -> int:
        """Restore every registered trust's state from a session snapshot,
        matched by trust NAME, its schema fingerprint checked.  A trustee
        count other than the snapshot's re-lays the state out through the
        schema's ``reshard=`` rule.  Pending submissions are dropped:
        recovery replays them from the snapshot wave.  Returns the
        restored step."""
        t0 = time.perf_counter()
        trusts = {t.name: t for t in self.trusts()}
        tree, got_step, extra = self._read_snapshot(
            directory, list(trusts.values()), step)
        meta = (extra or {}).get("trusts", {})
        for name, t in trusts.items():
            m = meta.get(name, {})
            want = t.schema.fingerprint() if t.schema is not None else None
            if m and m.get("schema") != want:
                raise ValueError(
                    f"trust {name!r}: schema fingerprint mismatch "
                    f"(checkpoint {m.get('schema')}, live {want}) — "
                    f"refusing to restore incompatible state")
            host = tree[name]
            old_t = int(m.get("n_trustees", t.n_trustees))
            if old_t != t.n_trustees:
                if t.schema is None or t.schema.reshard is None:
                    raise ValueError(
                        f"trust {name!r}: checkpoint holds {old_t}-trustee "
                        f"state but the live group has {t.n_trustees} "
                        f"trustees and the schema declares no reshard= rule")
                host = t.schema.reshard(host, old_t, t.n_trustees)
            t.install_trustee_state(host)
            t._pending = []
            self.unnotify(t)
        self._last_snapshot = (directory, got_step)
        self.recovery["restores"] += 1
        self.recovery["recovery_ms"] += (time.perf_counter() - t0) * 1e3
        return got_step

    def re_entrust(self, failed_shards, survivors=None,
                   ckpt_dir: Optional[str] = None,
                   step: Optional[int] = None, plan=None) -> None:
        """Failover: rebuild every live trust's trustee group WITHOUT the
        dead shards and move its state onto the survivors.

        ``failed_shards`` are flat stacked-shard slots; ``survivors``
        overrides the surviving slot list; ``plan`` (an ``ElasticPlan``,
        default the delegation ladder) shapes the shrunk mesh
        (``meshctx.survivors_mesh``).  State comes from the snapshot under
        ``ckpt_dir`` (the recovery path: the dead shard's memory is gone,
        and nothing here reads it) or, with ``ckpt_dir`` None, from the
        live state (an administrative re-shard).  A dedicated group keeps
        ``n_dedicated`` clamped to ``[1, axis_size - 1]``.  Each schema is
        rebuilt for the new trustee count through its factory, every
        trust rebound (its fuse signature and stats reset), every
        compiled round of a rebound trust evicted, and the planner
        pruned to the live signatures.  Pending submissions are dropped;
        the caller replays inside ``replaying()``."""
        from .meshctx import survivors_mesh
        from .trust import TrusteeGroup
        t0 = time.perf_counter()
        trusts = self.trusts()
        if not trusts:
            return
        failed = {int(s) for s in failed_shards}
        self.dead_shards |= failed
        if ckpt_dir is None:
            host_states = self._logical_states(trusts)
            metas = {t.name: {"n_trustees": t.n_trustees} for t in trusts}
        else:
            host_states, got_step, extra = self._read_snapshot(
                ckpt_dir, trusts, step)
            metas = (extra or {}).get("trusts", {})
            self._last_snapshot = (ckpt_dir, got_step)
        new_meshes = {}
        for t in trusts:
            g = t.group
            if g.mesh not in new_meshes:
                new_meshes[g.mesh] = survivors_mesh(g.mesh, failed,
                                                    survivors, plan)
            mesh = new_meshes[g.mesh]
            n_ded = g.n_dedicated
            if g.mode == "dedicated":
                n_ded = max(1, min(g.n_dedicated, mesh.size - 1))
            new_group = TrusteeGroup(mesh, g.axis, mode=g.mode,
                                     n_dedicated=n_ded)
            new_t = new_group.n_trustees
            old_t = int(metas.get(t.name, {}).get("n_trustees",
                                                  t.n_trustees))
            host = host_states[t.name]
            schema = t.schema
            if new_t != old_t:
                if schema is None or schema.reshard is None:
                    raise ValueError(
                        f"trust {t.name!r}: cannot re-entrust from {old_t} "
                        f"to {new_t} trustees — the schema declares no "
                        f"reshard= rule")
                host = schema.reshard(host, old_t, new_t)
                if t.schema_factory is not None:
                    schema = t.schema_factory(new_t)
            t._pending = []
            self.unnotify(t)
            t.rebind(new_group, schema=schema, logical_state=host)
        # every compiled round whose member set touches a rebound trust
        # carries the old group and fuse signature: evict them
        self._evict(t.token for t in trusts)
        live_sigs = set()
        for t in self.trusts():
            live_sigs.add(("solo", t.token))
            live_sigs.add(("mux", self._mux_signature(t)))
        self.planner.prune(live_sigs)
        self.recovery["restores"] += 1
        self.recovery["recovery_ms"] += (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# Round builders
# ---------------------------------------------------------------------------

def _concat_lanes(lane_maps, payloads, sizes, dev) -> Dict[str, torch.Tensor]:
    """Concatenate the batches' payload fields into wire lanes:
    ``lane_maps[i]`` maps batch i's field names to lanes; a batch that
    lacks a lane gets zeros shaped like the first batch that has it."""
    like: Dict[str, torch.Tensor] = {}
    for lmap, p in zip(lane_maps, payloads):
        for field, leaf in p.items():
            like.setdefault(lmap[field], leaf)
    rows = {}
    for lane in sorted(like):
        parts = []
        for lmap, p, n in zip(lane_maps, payloads, sizes):
            field = next((f for f, ln in lmap.items() if ln == lane), None)
            if field is not None and field in p:
                parts.append(p[field].to(dev))
            else:
                parts.append(torch.zeros((n,) + tuple(like[lane].shape[1:]),
                                         dtype=like[lane].dtype, device=dev))
        rows[lane] = torch.cat(parts, 0)
    return rows


_SPAN = "__span"          # the combine span column, never on the wire


def _shard_rows(dst: torch.Tensor, rows: Dict[str, torch.Tensor], group):
    """Pad a fused batch so each of the group's origin shards (every shard
    of the mesh in shared mode, the leading ``n_clients`` in dedicated
    mode) gets an equal CONTIGUOUS slice of ``ceil(R / n_origins)`` rows
    (the JAX batch sharding; padding rows are inactive, dst = -1, and the
    trustee shards of dedicated mode hold only padding) and stack it (D,
    R_dev, ...).  The combine span column pads with -1."""
    d = group.mesh.size
    r_total = dst.shape[0]
    r_dev = -(-r_total // group.n_origins)
    pad = d * r_dev - r_total
    dev = dst.device
    if pad:
        dst = torch.cat([dst, torch.full((pad,), -1, dtype=dst.dtype,
                                         device=dev)])
        rows = {k: torch.cat([v, torch.full((pad,) + tuple(v.shape[1:]),
                                            -1 if k == _SPAN else 0,
                                            dtype=v.dtype, device=dev)])
                for k, v in rows.items()}
    return dst.reshape(d, r_dev), \
        {k: v.reshape((d, r_dev) + tuple(v.shape[1:]))
         for k, v in rows.items()}, r_dev


def _group_perm(group, dev):
    """The group's replica-major shard order (``TrusteeGroup.
    shard_order``) and its inverse as index tensors on ``dev``, or None
    when it is the mesh order.  Built once, with a round's entry: a
    captured round copies nothing from the host."""
    order = group.shard_order()
    if order is None:
        return None
    return (torch.as_tensor(order, device=dev),
            torch.as_tensor(np.argsort(order), device=dev))


def _group_rows(dst: torch.Tensor, rows: Dict[str, torch.Tensor], perm):
    """The stacked request rows (mesh order) in the group's order
    (``_group_perm``)."""
    if perm is None:
        return dst, rows
    idx = perm[0]
    return dst[idx], {k: v[idx] for k, v in rows.items()}


def _mesh_order(resp: Dict[str, torch.Tensor], perm
                ) -> Dict[str, torch.Tensor]:
    """Responses stacked in a group's layout back in mesh order."""
    if perm is None:
        return resp
    return {k: v[perm[1]] for k, v in resp.items()}


def _combine_plan(cfg: ch.ChannelConfig, decls):
    """The round's combiner: one ``CombineSpan`` for each ``(tid, oid,
    combine declaration, wire lane map)`` whose op declares an archetype
    (``tid`` None in a solo round or a merged-response round).  Returns
    (RequestCombiner or None, {(tid, oid): span})."""
    if cfg.combine_impl == "off":
        return None, {}
    spans, span_of = [], {}
    for tid, oid, decl, lanes in decls:
        if decl is None:
            continue
        kind, key, field, resp = ch.as_combine_decl(decl)
        lane = (lambda f: f) if lanes is None else lanes.__getitem__
        span_of[(tid, oid)] = len(spans)
        spans.append(ch.CombineSpan(
            kind, key_lane=lane(key),
            sum_lane=lane(field) if kind == "sum" else None,
            resp_tid=tid, resp_field=resp))
    if not spans:
        return None, {}
    return ch.RequestCombiner(tuple(spans)), span_of


def _span_column(spans, sizes, dev) -> torch.Tensor:
    """Each batch's combine span (-1: never combined), row by row."""
    return torch.cat([torch.full((n,), sp, dtype=torch.int32, device=dev)
                      for sp, n in zip(spans, sizes)], 0)


def _payload_sig(payload) -> Tuple:
    """The (shape, dtype) of each payload leaf: a schema-less trust's
    batch-signature part (JAX's ``_payload_sig``)."""
    return tuple((k, tuple(v.shape), str(v.dtype))
                 for k, v in payload.items())


def _round_inputs(batches, dev):
    """A round's fresh inputs: each batch's (dst int32, payload) on the
    round's device (what a captured round copies into its buffers)."""
    return [(b[1].to(dev, torch.int32), {k: v.to(dev) for k, v in
                                          b[2].items()})
            for b in batches]


class _Compiled:
    """One entry of the compiled-program cache: a round built by
    ``_build_solo`` / ``_build_mux`` (``fn`` and the response bytes the
    round saves) and its captured programs, one an input signature (as a
    jitted function traces once an input aval).  ``site`` None runs the
    round eagerly (``compiled.disable()``)."""

    def __init__(self, fn, saved, site):
        self.fn, self.saved, self.site = fn, saved, site
        self.programs: Dict[Any, compiled.Program] = {}

    def __call__(self, state, inputs):
        if self.site is None:
            return self.fn(state, None, inputs)
        sig = compiled.signature(inputs)
        prog = self.programs.get(sig)
        if prog is None:
            prog = self.programs[sig] = compiled.Program(self.fn, self.site)
        return prog(state, None, inputs)


def _build_solo(trust, batches, cfg: ch.ChannelConfig):
    """A solo round (JAX's ``_build_solo``): what the host plans once —
    the serve table, the combine plan, the shard order — and ``fn(state,
    None, inputs)`` doing the round's device work on ``inputs``
    (``_round_inputs``).  ``fn`` returns (new state, (per-batch
    responses, stats)); the stats are device tensors or ints.  Returns
    (fn, response bytes saved)."""
    sizes = [int(b[1].shape[0]) for b in batches]
    ops = trust.ops
    op_ids = [b[0] for b in batches]
    check_payload_fields(
        [(ops[oid].name, p) for (oid, _d, p) in batches])
    active = tuple(sorted(set(op_ids)))
    cfg = dataclasses.replace(
        cfg, elide_resp=_elidable_fields(ops, active, trust.resp_like))
    serve = ch.serve_optable(ops, active_ids=active,
                             serve_impl=cfg.serve_impl, cfg=cfg)
    # request combining: one span a combinable active op
    combiner, span_of = _combine_plan(
        cfg, [(None, oid, ops[oid].combine, None) for oid in active])
    dev = trust.device
    group = trust.group
    d = group.mesh.size
    n_trustees = trust.n_trustees
    perm = _group_perm(group, dev)
    if combiner is not None:
        combiner.kinds(dev)
    multi_op = len(set(op_ids)) > 1
    spans = [span_of.get((None, oid), -1) for oid in op_ids]
    n_slots = cfg.n_slots(n_trustees)
    saved = 0 if (n_slots == 1 and cfg.local_shortcut) \
        else ch.resp_elision_bytes(trust.resp_like, cfg,
                                   n_slots * cfg.total_capacity())

    def fn(state, _fixed, inputs):
        rows: Dict[str, torch.Tensor] = {}
        if multi_op:
            rows["op"] = torch.cat(
                [torch.full((n,), oid, dtype=torch.int16, device=dev)
                 for oid, n in zip(op_ids, sizes)], 0)
        payloads = [p for _d, p in inputs]
        rows.update(_concat_lanes([{k: k for k in p} for p in payloads],
                                  payloads, sizes, dev))
        if combiner is not None:
            rows[_SPAN] = _span_column(spans, sizes, dev)
        dst, rows, r_dev = _shard_rows(
            torch.cat([x for x, _p in inputs], 0), rows, group)
        dst, rows = _group_rows(dst, rows, perm)
        span = rows.pop(_SPAN, None)
        new_state, resp, info = _round(state, dst, rows, serve, n_trustees,
                                       cfg, combiner, span)
        resp = _mesh_order(resp, perm)
        tel = {"rounds": info.rounds, "residual": info.residual,
               "demand_max": info.group_sizes.max(),
               "dropped": info.dropped.sum(),
               "rows_combined": info.rows_combined,
               "req_bytes_saved": info.req_bytes_saved,
               "impl_fallback": info.impl_fallback}
        return new_state, (_split_spans(resp, d * r_dev, [sizes])[0], tel)
    return fn, saved


def _round(state, dst, rows, serve, n_trustees, cfg, combiner, span):
    """One round: ``delegate``, or under ``overflow="defer"`` the drain
    (even at ``max_rounds=1``, so rounds and residual are counted)."""
    fn = ch.delegate_drain if cfg.overflow == "defer" else ch.delegate
    return fn(state, dst, rows, serve, n_trustees, cfg, combine=combiner,
              combine_span=span)


def _split_spans(resp, n_flat: int, sizes_per_trust, srcs=None):
    """Slice the fused responses (D, R_dev, ...) back per (trust, batch),
    trust-major; ``srcs`` gives each trust its own response dict."""
    out, off = [], 0
    for tid, sizes in enumerate(sizes_per_trust):
        src = resp if srcs is None else srcs[tid]
        flat = {k: v.reshape((n_flat,) + tuple(v.shape[2:]))
                for k, v in src.items()}
        out.append([])
        for n in sizes:
            out[-1].append({k: v[off:off + n] for k, v in flat.items()})
            off += n
    return out


def _resp_sig(trust):
    like = trust.resp_like
    if not isinstance(like, dict):
        return ("tree", id(like))
    return tuple((k, tuple(v.shape[1:]), str(v.dtype))
                 for k, v in sorted(like.items()))


def _build_mux(trusts, batches, cfg: ch.ChannelConfig):
    """ONE multiplexed round for several trusts' queued batches (JAX's
    ``_build_mux``).  Rows concatenate in (trust, batch) order with
    "trust" and "op" id lanes; payload fields whose dtype and trailing
    shape agree across trusts share a wire lane, the others get
    per-trust lanes ``field@tid``.  The host plans once; ``fn(states,
    None, inputs)`` (``inputs``: each trust's ``_round_inputs``) returns
    (new states, (per-trust per-batch responses, telemetry)).  Returns
    (fn, response bytes saved)."""
    group = trusts[0].group
    n_trusts = len(trusts)
    n_trustees = group.n_trustees
    d = group.mesh.size
    dev = trusts[0].device

    # field plan: intra-trust mismatches are errors, cross-trust ones get
    # namespaced lanes
    per_trust_fields = []
    for t, tb in zip(trusts, batches):
        seen = check_payload_fields(
            [(f"{t.name}.{t.ops[oid].name}", p) for (oid, _d, p) in tb])
        per_trust_fields.append({name: sig for name, (_l, sig)
                                 in seen.items()})
    lane_of: List[Dict[str, str]] = [dict() for _ in trusts]
    for name in sorted(set().union(*[set(f) for f in per_trust_fields])):
        sigs = {tid: f[name] for tid, f in enumerate(per_trust_fields)
                if name in f}
        shared = len(set(sigs.values())) == 1
        for tid in sigs:
            lane_of[tid][name] = name if shared else f"{name}@{tid}"

    # one merged response dict when every trust's responses agree; the
    # lane layout needs it, and a channel of local rows only has no lanes
    merged_resp = len({_resp_sig(t) for t in trusts}) == 1
    t_send = cfg.n_slots(n_trustees)     # client blocks a shard receives
    strided = merged_resp and not (t_send == 1 and cfg.local_shortcut)
    if strided:
        cfg = dataclasses.replace(cfg, n_lanes=n_trusts)
    c2 = cfg.second_capacity()
    tables = tuple((t.ops, tuple(sorted({oid for (oid, _d, _p) in tb})))
                   for t, tb in zip(trusts, batches))

    # response elision: fields no trust's active ops write leave the
    # response transpose; in the lane layout so do the rows of a lane whose
    # trust writes nothing (a PUT-only trust)
    elidable = [_elidable_fields(ops_t, active, t.resp_like)
                for t, (ops_t, active) in zip(trusts, tables)]
    if merged_resp and isinstance(trusts[0].resp_like, dict):
        all_fields = set(trusts[0].resp_like)
        common = set.intersection(*[set(e) for e in elidable])
        lanes_off = tuple(tid for tid, e in enumerate(elidable)
                          if set(e) == all_fields)
        if len(lanes_off) == n_trusts:
            common, lanes_off = all_fields, ()   # nothing responds at all
        elif not strided:
            lanes_off = ()                       # masked layout: no lanes
        cfg = dataclasses.replace(cfg, elide_resp=tuple(sorted(common)),
                                  elide_lanes=lanes_off)

    if strided:
        serve = ch.serve_multiplex_strided(
            tables, tuple(lane_of), n_lanes=n_trusts, t_send=t_send,
            c1=cfg.capacity, c2=c2, serve_impl=cfg.serve_impl, cfg=cfg)
    else:
        serve = ch.serve_multiplex(tables, tuple(lane_of),
                                   merge_resp=merged_resp,
                                   serve_impl=cfg.serve_impl, cfg=cfg)

    # request combining: one span a combinable (trust, op), on the wire
    # lanes; a non-merged round rebuilds the sum prior in "field@tid"
    combiner, span_of = _combine_plan(
        cfg, [(None if merged_resp else tid, oid, ops_t[oid].combine,
               lane_of[tid])
              for tid, (ops_t, active) in enumerate(tables)
              for oid in active])

    # wire lanes: "op" only when some trust dispatches several ops, "trust"
    # only when the serve reads it (masked layout, or a shortcut tail)
    need_op = any(len(active) > 1 for _ops, active in tables)
    need_trust = (not strided) or cfg.local_shortcut
    flat = [(tid, oid) for tid, tb in enumerate(batches)
            for (oid, _dst, _p) in tb]
    sizes = [int(b[1].shape[0]) for tb in batches for b in tb]
    spans = [span_of.get((None if merged_resp else tid, oid), -1)
             for tid, oid in flat]
    perm = _group_perm(group, dev)
    if combiner is not None:
        combiner.kinds(dev)
    n_rows = t_send * cfg.n_lanes * cfg.total_capacity()
    saved = 0 if (t_send == 1 and cfg.local_shortcut) \
        else ch.resp_elision_bytes(trusts[0].resp_like, cfg, n_rows)
    trust_sizes = [[int(b[1].shape[0]) for b in tb] for tb in batches]

    def fn(states, _fixed, inputs):
        pays = [p for tin in inputs for _d, p in tin]
        dst = torch.cat([x for tin in inputs for x, _p in tin], 0)
        tid_col = torch.cat([torch.full((n,), tid, dtype=torch.int16,
                                        device=dev)
                             for (tid, _o), n in zip(flat, sizes)], 0)
        rows: Dict[str, torch.Tensor] = {}
        if need_op:
            rows["op"] = torch.cat([torch.full((n,), oid, dtype=torch.int16,
                                               device=dev)
                                    for (_t, oid), n in zip(flat, sizes)], 0)
        if need_trust:
            rows["trust"] = tid_col
        rows.update(_concat_lanes([lane_of[tid] for tid, _o in flat], pays,
                                  sizes, dev))
        if strided:
            # virtual bins: lane tid of trustee t is bin t * n_trusts + tid
            dst = torch.where(dst >= 0,
                              dst * n_trusts + tid_col.to(torch.int32), -1)
        rows["__tid"] = tid_col
        if combiner is not None:
            rows[_SPAN] = _span_column(spans, sizes, dev)
        dst, rows, r_dev = _shard_rows(dst, rows, group)
        dst, rows = _group_rows(dst, rows, perm)
        tid_l = rows.pop("__tid").long()
        span = rows.pop(_SPAN, None)

        new_states, resp, info = _round(states, dst, rows, serve,
                                        n_trustees, cfg, combiner, span)
        resp = _mesh_order(resp, perm)

        # telemetry, all device tensors: per-trust rows left unserved,
        # per-trust max pair demand, and the merged demand the planner
        # observes
        res_pt = torch.zeros(n_trusts + 1, dtype=torch.int64, device=dev) \
            .index_add_(0, torch.where(info.dropped, tid_l,
                                       n_trusts).reshape(-1),
                        torch.ones(d * r_dev, dtype=torch.int64, device=dev))
        if strided:
            demand_pt = info.group_sizes.reshape(d, -1, n_trusts) \
                .amax(dim=(0, 1))
        else:
            act = dst >= 0
            if cfg.local_shortcut:
                # a shard's own trustee is its group index
                act &= dst != torch.arange(d, device=dev)[:, None] \
                    % n_trustees
            idx = torch.where(act, tid_l * n_trustees
                              + torch.clamp(dst, 0, n_trustees - 1),
                              n_trusts * n_trustees)
            pair = torch.zeros((d, n_trusts * n_trustees + 1),
                               dtype=torch.int64, device=dev) \
                .scatter_add_(1, idx, torch.ones_like(idx))
            demand_pt = pair[:, :-1].reshape(d, n_trusts, n_trustees) \
                .amax(dim=(0, 2))
        srcs = None
        if not merged_resp:
            srcs = [{k.rsplit("@", 1)[0]: v for k, v in resp.items()
                     if k.rsplit("@", 1)[1] == str(tid)}
                    for tid in range(n_trusts)]
        out = _split_spans(resp, d * r_dev, trust_sizes, srcs)
        tel = {"residual": list(res_pt[:-1].unbind(0)),
               "demand": list(demand_pt.unbind(0)),
               "demand_merged": info.group_sizes.max(),
               "impl_fallback": info.impl_fallback, "rounds": info.rounds,
               "combined": info.rows_combined,
               "req_saved": info.req_bytes_saved}
        return new_states, (out, tel)
    return fn, saved


# ``TrustSession`` is the user-facing name, ``DelegationEngine`` the
# implementation-side one.  Same class.
TrustSession = DelegationEngine
