"""DelegationEngine / TrustSession — executes every Trust's channel rounds.

The torch counterpart of ``repro.core.engine``.  Trusts register here at
``entrust`` time (weakly); ``submit`` marks a trust dirty and ``step()``
flushes every dirty trust.  A round runs eagerly — PyTorch has no ``jit``
boundary to cache — as the JAX solo program does:

  * concatenate the queued batches (an "op" column when more than one op
    is queued; payload fields a batch lacks are zero-filled);
  * pad the fused batch to a multiple of the mesh size and give each
    stacked client shard a CONTIGUOUS slice, exactly as JAX shards a batch
    with ``P(axes)`` — this is what fixes the (client, slot) serve order;
  * one ``channel.delegate`` round over all shards, responses sliced back
    per batch.

This slice flushes each pending trust solo.  A step in which two or more
channel-compatible trusts are pending would fuse them into one
multiplexed round in JAX; that round is not ported yet and raises.

``step(sync=False)`` issues the rounds and returns without reading any
device value; it records a ``torch.cuda.Event`` per wave on PyTorch's
current stream (``wave_events``), so a dispatch-ahead driver can wait for
that wave alone, not for the waves issued after it.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Tuple

import torch

from . import channel as ch


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


class DelegationEngine:
    """Session-wide execution engine for delegation rounds
    (``TrustSession``)."""

    def __init__(self):
        self._trusts: Dict[int, Any] = {}
        self._next_token = 0
        self._dirty: List[int] = []
        self.rounds_dispatched = 0
        self._last_step_stats: Dict[str, Dict[str, Any]] = {}
        self._stats_owner: Dict[str, int] = {}
        self.wave_events: List[Any] = []

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
            self._dirty = [tok for tok in self._dirty if tok not in gone]
            self._stats_owner = {n: tok for n, tok in
                                 self._stats_owner.items()
                                 if tok not in gone}

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
        work (``dropped`` and ``demand_max`` are device counts)."""
        return {name: {k: int(v) for k, v in d.items()}
                for name, d in self._last_step_stats.items()}

    def _stats_key(self, trust) -> str:
        name = trust.name
        owner = self._stats_owner.get(name)
        if owner is None or owner == trust.token:
            self._stats_owner[name] = trust.token
            return name
        return f"{name}#{trust.token}"

    # -- step ---------------------------------------------------------------
    def trusts(self) -> List[Any]:
        """The live registered trusts."""
        self._prune()
        return [t for t in (r() for r in self._trusts.values())
                if t is not None]

    def quiesced(self) -> bool:
        """True when no trust has pending submissions (between engine
        rounds the trustee's linear op history has no in-flight prefix)."""
        return not self._dirty and all(not t._pending for t in self.trusts())

    def step(self, sync: bool = True):
        """Flush every pending batch.  Returns ``last_stats()``, UNLESS
        ``sync=False``: reading the stats waits for the round's device work,
        the barrier a dispatch-ahead driver (``launch/streaming.py``) must
        not pay.  ``sync=False`` issues the rounds, records ``wave_events``
        (one event on the current stream of each CUDA device the rounds ran
        on; none on the CPU) and returns None; ``last_stats()`` later gives
        the same numbers."""
        self._prune()
        pending = []
        for tok in list(self._dirty):
            ref = self._trusts.get(tok)
            t = ref() if ref is not None else None
            if t is not None and t._pending:
                pending.append(t)
        groups: Dict[Any, List[Any]] = {}
        for t in pending:
            groups.setdefault(t.fuse_signature(), []).append(t)
        fusable = [[t.name for t in g] for g in groups.values() if len(g) > 1]
        if fusable:
            raise NotImplementedError(
                f"session.step() with channel-compatible trusts "
                f"{fusable} pending would fuse them into one multiplexed "
                f"round, which is not ported to repro_torch yet (ROADMAP.md "
                f"queue A: multiplexed round); flush() them one by one")
        self._dirty.clear()
        self._last_step_stats = {}
        for t in pending:
            t.flush()
        if sync:
            return self.last_stats()
        self.wave_events = []
        for dev in {t.device for t in pending if t.device.type == "cuda"}:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self.wave_events.append(ev)
        return None

    # -- the solo round -----------------------------------------------------
    def run_solo(self, trust, batches, capacity=None):
        """Run ``batches`` ([(op_id, dst, payload)]) of one trust as ONE
        channel round.  Returns the per-batch responses in request
        order."""
        sizes = [int(b[1].shape[0]) for b in batches]
        r_total = sum(sizes)
        cfg = trust._cfg_for(r_total, capacity)
        ops = trust.ops
        op_ids = [b[0] for b in batches]
        check_payload_fields(
            [(ops[oid].name, p) for (oid, _d, p) in batches])
        active = tuple(sorted(set(op_ids)))
        cfg = dataclasses.replace(
            cfg, elide_resp=_elidable_fields(ops, active, trust.resp_like))
        serve = ch.serve_optable(ops, active_ids=active,
                                 serve_impl=cfg.serve_impl, cfg=cfg)
        dev = trust.device
        dsts = [b[1].to(dev, torch.int32) for b in batches]
        payloads = [b[2] for b in batches]
        dst = torch.cat(dsts, 0)
        rows: Dict[str, torch.Tensor] = {}
        if len(set(op_ids)) > 1:
            rows["op"] = torch.cat(
                [torch.full((n,), oid, dtype=torch.int16, device=dev)
                 for oid, n in zip(op_ids, sizes)], 0)
        names = set()
        for p in payloads:
            names |= set(p.keys())
        for name in sorted(names):
            like = next(p[name] for p in payloads if name in p)
            rows[name] = torch.cat(
                [p[name].to(dev) if name in p else
                 torch.zeros((n,) + tuple(like.shape[1:]), dtype=like.dtype,
                             device=dev)
                 for p, n in zip(payloads, sizes)], 0)

        # pad so every client shard gets an equal CONTIGUOUS slice (the
        # JAX batch sharding); padding rows are inactive (dst = -1)
        d = trust.group.mesh.size
        r_dev = -(-r_total // d)
        pad = d * r_dev - r_total
        if pad:
            dst = torch.cat([dst, torch.full((pad,), -1, dtype=torch.int32,
                                             device=dev)])
            rows = {k: torch.cat([v, torch.zeros((pad,) + tuple(v.shape[1:]),
                                                 dtype=v.dtype, device=dev)])
                    for k, v in rows.items()}
        dst = dst.reshape(d, r_dev)
        rows = {k: v.reshape((d, r_dev) + tuple(v.shape[1:]))
                for k, v in rows.items()}

        new_state, resp, info = ch.delegate(trust._state, dst, rows, serve,
                                            trust.n_trustees, cfg)
        trust._state = new_state
        self.rounds_dispatched += 1
        n_rows = trust.n_trustees * cfg.total_capacity()
        saved = 0 if (trust.n_trustees == 1 and cfg.local_shortcut) \
            else ch.resp_elision_bytes(trust.resp_like, cfg, n_rows)
        self._last_step_stats[self._stats_key(trust)] = {
            "rounds": 1, "residual": 0,
            "demand_max": info.group_sizes.max(),
            "dropped": info.dropped.sum(),
            "resp_bytes_saved": saved, "rows_combined": 0,
            "req_bytes_saved": 0, "impl_fallback": info.impl_fallback}
        flat = {k: v.reshape((d * r_dev,) + tuple(v.shape[2:]))
                for k, v in resp.items()}
        out, off = [], 0
        for n in sizes:
            out.append({k: v[off:off + n] for k, v in flat.items()})
            off += n
        return out


# ``TrustSession`` is the user-facing name, ``DelegationEngine`` the
# implementation-side one.  Same class.
TrustSession = DelegationEngine
