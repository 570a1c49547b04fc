"""Failover runs that chip_smoke.py and the tests share: a KV store's
mixed-op trace with a trustee killed mid-trace (or a wave dropped or torn)
and the page table's chaos run, each checked against its sequential
oracle.

A KV wave is kv_mixed's mix — GET/PUT/ADD/CAS batches in one session
round, Zipf keys, integer-valued payloads.  Without the local shortcut a
wave's rows of one op serve in request order whatever the shard count
(each client shard holds a contiguous slice), and the phases run GET, PUT,
ADD, CAS, so the oracle applies each op batch whole, in that order, and a
wave replayed on the survivors must answer as it did the first time.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

MIX = (("get", 0.4), ("put", 0.2), ("add", 0.2), ("cas", 0.2))


def mixed_waves(seed: int, n_keys: int, width: int, rows: int,
                n_waves: int, alpha: float = 1.0):
    """(initial table, waves): each wave [(op, keys, values, expect)] of
    kv_mixed's shares summing to ``rows``; CAS expects hit the live value
    of an in-order replay about half the time."""
    from ..core import SequentialKVReference
    from ..core.routing import sample_keys
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 8, (n_keys, width)).astype(np.float32)
    sizes = [int(rows * share) for _op, share in MIX[:3]]
    sizes.append(rows - sum(sizes))
    sim = SequentialKVReference(n_keys, width)
    sim.prefill(init)
    waves = []
    for _ in range(n_waves):
        wave = []
        for (op, _share), n in zip(MIX, sizes):
            keys = sample_keys(rng, n_keys, n, "zipf",
                               alpha).astype(np.int32)
            vals = rng.integers(0, 8, (n, width)).astype(np.float32)
            expect = None
            if op == "cas":
                rand = rng.integers(0, 8, (n, width)).astype(np.float32)
                expect = np.where(rng.random(n)[:, None] < 0.5,
                                  sim.table[keys], rand)
            wave.append((op, keys, vals, expect))
        oracle_wave(sim, wave)
        waves.append(wave)
    return init, waves


def oracle_wave(ref, wave) -> List[Dict[str, np.ndarray]]:
    """One wave on the sequential oracle: each op batch whole, in phase
    order, in request order (the serve order without the shortcut)."""
    out = []
    for op, keys, vals, expect in wave:
        if op == "get":
            out.append({"value": ref.get(keys)})
        elif op == "put":
            ref.put(keys, vals)
            out.append({})
        elif op == "add":
            out.append({"value": ref.add(keys, vals)})
        else:
            flag, old = ref.cas(keys, expect, vals)
            out.append({"flag": flag, "value": old})
    return out


def submit_wave(store, wave, dev):
    """Queue one wave's op batches on ``store``; returns their futures."""
    op = store.trust.op
    t = lambda a: torch.as_tensor(a, device=dev)
    futs = []
    for name, keys, vals, expect in wave:
        if name == "get":
            futs.append(op.get.then(t(keys)))
        elif name == "put":
            futs.append(op.put.then(t(keys), t(vals)))
        elif name == "add":
            futs.append(op.add.then(t(keys), t(vals)))
        else:
            futs.append(op.cas.then(t(keys), value=t(vals),
                                    expect=t(expect)))
    return futs


def acks(wave, futs) -> List[Dict[str, np.ndarray]]:
    """The acknowledged responses (the fulfilled futures), on the host."""
    out = []
    for (name, *_), fut in zip(wave, futs):
        r = fut.result()
        if name == "put":
            out.append({})
        elif name == "cas":
            out.append({"flag": r["flag"].cpu().numpy(),
                        "value": r["value"].cpu().numpy()})
        else:
            out.append({"value": r["value"].cpu().numpy()})
    return out


def same_acks(a, b) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def run_kv_chaos(store, sess, waves, ckdir: str, dev, *,
                 schedule: Optional[dict] = None, snap_every: int = 0,
                 sync: Callable[[], None] = lambda: None) -> dict:
    """Drive ``waves`` through ``store`` (one session step a wave) with
    the kills of ``schedule`` ({wave: ("kill", shard)}) installed and a
    snapshot at the start and every ``snap_every`` waves.  A kill
    re-entrusts onto the survivors from the last snapshot and replays the
    waves since it inside ``sess.replaying()``, then the killed wave runs
    again.  Returns the acked history ({wave: (acks, shard count)}), the
    failures, whether every replayed ack equalled the original, the wave
    run first on the survivors, and host times (``sync`` waits for the
    device): each wave's final run, each checkpoint, each replayed wave,
    the whole run."""
    from ..runtime import EngineFailureInjector, TrusteeFailure
    if schedule:
        sess.install_injector(EngineFailureInjector(schedule=dict(schedule)))
    out = dict(acked={}, failures=[], replay_equal=True, wave_s={},
               ckpt_ms=[], replay_ms=[], first_after=None)

    def snapshot():
        sync()
        t0 = time.perf_counter()
        sess.checkpoint(ckdir)
        out["ckpt_ms"].append((time.perf_counter() - t0) * 1e3)

    def one(w):
        futs = submit_wave(store, waves[w], dev)
        sess.step()
        return acks(waves[w], futs)

    sync()
    start = time.perf_counter()
    if snap_every:
        snapshot()
    snap_wave, w = 0, 0
    while w < len(waves):
        sync()
        t0 = time.perf_counter()
        try:
            resp = one(w)
        except TrusteeFailure as e:
            out["failures"].append((e.kind, e.shard, e.wave_id))
            sess.re_entrust([e.shard], ckpt_dir=ckdir)
            with sess.replaying():
                for rw in range(snap_wave, w):
                    sync()
                    t1 = time.perf_counter()
                    r2 = one(rw)
                    sync()
                    out["replay_ms"].append((time.perf_counter() - t1) * 1e3)
                    out["replay_equal"] &= same_acks(r2, out["acked"][rw][0])
                    out["acked"][rw] = (r2, store.group.axis_size)
            out["first_after"] = w
            continue
        sync()
        out["wave_s"][w] = time.perf_counter() - t0
        out["acked"][w] = (resp, store.group.axis_size)
        w += 1
        if snap_every and w % snap_every == 0:
            snapshot()
            snap_wave = w
    sync()
    out["seconds"] = time.perf_counter() - start
    return out


def tear_and_retry(store, sess, wave, dev, kind: str, shard: int = 0):
    """Drop or tear one wave (the session's next) after its round ran:
    whether the failure was raised, whether every table stayed
    bit-identical, whether the futures stayed open and queued, and the
    acks of the retry (a plain next step)."""
    from ..runtime import EngineFailureInjector, TrusteeFailure
    sess.install_injector(EngineFailureInjector(
        schedule={sess.wave_counter: (kind, shard)}))
    before = {k: v.clone() for k, v in store.trust.state().items()}
    futs = submit_wave(store, wave, dev)
    raised = False
    try:
        sess.step()
    except TrusteeFailure as e:
        raised = e.kind == kind
    unchanged = all(torch.equal(before[k], v)
                    for k, v in store.trust.state().items())
    still_open = not any(f.ready() for f in futs) and bool(
        store.trust._pending)
    sess.step()
    return dict(raised=raised, unchanged=unchanged, still_open=still_open,
                acks=acks(wave, futs))


def check_kv_history(init, waves, acked):
    """The acked history against the sequential oracle: (None, or the
    first wave that disagrees; the oracle's final table)."""
    from ..core import SequentialKVReference
    ref = SequentialKVReference(init.shape[0], init.shape[1])
    ref.prefill(init)
    bad = None
    for i, wave in enumerate(waves):
        if not same_acks(acked[i][0], oracle_wave(ref, wave)) \
                and bad is None:
            bad = f"wave {i} differs from the sequential oracle"
    return bad, ref.dump()


# -- the page table -----------------------------------------------------------

PT_FIELDS = {"alloc": ("pages", "n", "flag"),
             "append": ("page", "n", "flag"), "free": ("n", "flag"),
             "lookup": ("pages", "n", "flag")}


def paged_waves(seed: int, rows: int, n_waves: int, max_seqs: int,
                max_pages: int, page_size: int):
    """``tests/_paged_battery.py``'s decode-shaped op mix: appends
    dominate, with allocs, lookups and frees of ``rows`` unique live
    sequences (a wave frees only when that many are known)."""
    rng = np.random.default_rng(seed)
    known, waves = set(), []
    for _ in range(n_waves):
        op = rng.choice(["alloc", "append", "append", "lookup", "free"],
                        p=[0.2, 0.25, 0.25, 0.2, 0.1])
        if op == "free" and len(known) < rows:
            op = "append"
        if op == "alloc":
            seqs = rng.integers(0, max_seqs, rows).astype(np.int32)
            extra = rng.integers(1, max_pages + 1, rows).astype(np.int32)
            known.update(int(s) for s in seqs)
        elif op == "append":
            seqs = rng.integers(0, max_seqs, rows).astype(np.int32)
            extra = rng.integers(0, max_pages * page_size,
                                 rows).astype(np.int32)
            known.update(int(s) for s in seqs)
        elif op == "lookup":
            seqs = rng.integers(0, max_seqs, rows).astype(np.int32)
            extra = None
        else:
            seqs = rng.choice(sorted(known), rows,
                              replace=False).astype(np.int32)
            extra = None
            known.difference_update(int(s) for s in seqs)
        waves.append((str(op), seqs, extra))
    return waves


def table_wave(pt, sess, wave) -> Dict[str, np.ndarray]:
    """One page-table wave in one session step -> its globalized acks."""
    op, seqs, extra = wave
    call = getattr(pt, f"{op}_then")
    fut = call(seqs, extra) if extra is not None else call(seqs)
    sess.step()
    fields = tuple(f for f in ("pages", "page") if f in PT_FIELDS[op])
    got = pt.globalize(fut.result(), seqs, fields=fields)
    return {f: np.asarray(got[f]) for f in PT_FIELDS[op]}


def run_paged_chaos(pt, sess, waves, ckdir: str, *, kill_wave: int,
                    kill_shard: int, snap_every: int,
                    survivors: int) -> dict:
    """Kill ``kill_shard`` at ``kill_wave`` (a snapshot boundary), move
    the table onto the survivors and reshard the oracle the same way;
    every ack is held against the oracle, the audit after the failover
    and at the end, then every live sequence freed (no page leaked).
    Returns the acks, the final state, the audits and any disagreement."""
    from ..core import SequentialPageTable
    from ..runtime import EngineFailureInjector, TrusteeFailure
    oracle = SequentialPageTable(pt.n_pages, pt.max_seqs, pt.page_size,
                                 pt.max_pages, pt.t)
    sess.install_injector(EngineFailureInjector(
        schedule={kill_wave: ("kill", kill_shard)}))
    sess.checkpoint(ckdir)
    out = dict(acks={}, failures=0, errors=[], audits=[])
    w = 0
    while w < len(waves):
        try:
            got = table_wave(pt, sess, waves[w])
        except TrusteeFailure as e:
            out["failures"] += 1
            if waves[w][0] == "free":     # the torn wave's free bookkeeping
                pt._known.update(int(s) for s in waves[w][1])
            sess.re_entrust([e.shard], ckpt_dir=ckdir)
            oracle.reshard(survivors)
            out["audits"].append(pt.audit())
            continue
        op, seqs, extra = waves[w]
        want = getattr(oracle, op)(*((seqs, extra) if extra is not None
                                     else (seqs,)))
        for f in PT_FIELDS[op]:
            if not np.array_equal(got[f], want[f]):
                out["errors"].append(f"wave {w} {op}.{f}")
        out["acks"][w] = got
        w += 1
        if w % snap_every == 0 and w <= kill_wave:
            sess.checkpoint(ckdir)
    st, want = pt.dump(), oracle.dump()
    out["errors"] += [f"state {k}" for k in want
                      if not np.array_equal(np.asarray(st[k]), want[k])]
    out["state"] = {k: np.asarray(v) for k, v in st.items()}
    out["audits"].append(pt.audit())
    live = sorted(pt._known)
    while live:
        batch, live = live[:len(waves[0][1])], live[len(waves[0][1]):]
        table_wave(pt, sess, ("free", np.array(batch, np.int32), None))
    out["final_audit"] = pt.audit()
    return out
