"""Differential checking of the delegated page table: record the op
batches a page table was given, replay them on the sequential oracle in
serve order, and a stress trace that drives every path of the serve.

``launch.paged_decode.run_decode(check=True)``, ``chip_smoke.py`` and the
tests use it; the page table itself does not.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.pagetable import PHASES, DelegatedPageTable, SequentialPageTable


def record_submissions(pt: DelegatedPageTable, log: List) -> None:
    """Log every ``*_then`` submission (op, seqs, arg, future) in order."""
    for op in PHASES:
        fn = getattr(pt, op + "_then")

        def rec(seqs, *args, _fn=fn, _op=op, then=None):
            fut = _fn(seqs, *args, then=then)
            log.append((_op, np.asarray(seqs, np.int32),
                        np.asarray(args[0], np.int32) if args else None, fut))
            return fut
        setattr(pt, op + "_then", rec)


_FIELDS = {"alloc": ("pages", "n", "flag"), "append": ("page", "n", "flag"),
           "free": ("n", "flag"), "lookup": ("pages", "n", "flag")}


def replay_waves(pt: DelegatedPageTable, waves) -> int:
    """Replay each recorded wave's op batches ([(op, seqs, arg, future)])
    through a fresh ``SequentialPageTable`` in serve order and require
    every response the page table gave, and its final state, to equal the
    oracle's.  Serve order, per trustee: op phase (alloc, append, free,
    lookup), then channel rows before the shortcut's self-addressed rows,
    then client, then issue order; the fused batch gives each client
    shard a contiguous slice (client = fused position // rows per client;
    in dedicated mode the clients are the leading shards).  Valid
    while no (client, trustee) pair overflows the round's primary block,
    which the replay checks.  Returns the rows replayed."""
    t = pt.t
    n_clients = pt.group.n_clients      # dedicated: the leading shards
    shortcut = pt.trust.cfg.local_shortcut
    oracle = SequentialPageTable(pt.n_pages, pt.max_seqs, pt.page_size,
                                 pt.max_pages, t)
    rows = 0
    for w, wave in enumerate(waves):
        sizes = [len(e[1]) for e in wave]
        r_total = sum(sizes)
        r_dev = -(-r_total // n_clients)
        capacity = pt.trust._cfg_for(r_total, None).capacity
        if r_dev > capacity:
            raise ValueError(f"wave {w}: {r_dev} rows per client may "
                             f"overflow capacity {capacity}; the replay "
                             f"models the primary block only")
        seqs = np.concatenate([e[1] for e in wave])
        ops = np.concatenate([np.full(n, PHASES.index(e[0]))
                              for e, n in zip(wave, sizes)])
        args = np.concatenate([e[2] if e[2] is not None else
                               np.zeros(n, np.int32)
                               for e, n in zip(wave, sizes)])
        pos = np.arange(r_total)
        local = ((seqs % t) == pos // r_dev) if shortcut \
            else np.zeros(r_total, bool)
        want: Dict[str, np.ndarray] = {
            "pages": np.zeros((r_total, pt.max_pages), np.int32),
            **{k: np.zeros(r_total, np.int32) for k in ("page", "n", "flag")}}
        order = np.lexsort((pos, local))
        for phase, op in enumerate(PHASES):
            idx = order[ops[order] == phase]
            if not len(idx):
                continue
            a = (seqs[idx],) if op in ("free", "lookup") \
                else (seqs[idx], args[idx])
            for k, v in getattr(oracle, op)(*a).items():
                want[k][idx] = v
        off = 0
        for (op, s, _, fut), n in zip(wave, sizes):
            got = pt.globalize(fut.result(), s)
            for f in _FIELDS[op]:
                if not np.array_equal(got[f], want[f][off:off + n]):
                    raise AssertionError(
                        f"page table wave {w}: {op} field {f!r} differs from "
                        f"the sequential oracle replayed in serve order")
            off += n
        rows += r_total
    final = pt.dump()
    for k, v in oracle.dump().items():
        if not np.array_equal(final[k], v):
            raise AssertionError(f"page table state {k!r} differs from the "
                                 f"sequential oracle after the last wave")
    return rows


STRESS_GEOMETRY = dict(n_pages=126, max_seqs=64, page_size=4, max_pages=16)


def stress_waves(seed: int, n_random: int = 24, rows: int = 12):
    """Op-batch waves [[(op, seqs, arg or None), ...], ...] that drive every
    path of the serve on ``STRESS_GEOMETRY`` over 8 trustees (16 local
    pages; trustees 6 and 7 hold one phantom page each):

      * wave 2: one alloc evicts three victims (an eviction cascade);
      * wave 3: an append past an evicted chain's end heals it with a
        three-page re-alloc after evicting another victim;
      * wave 4: free and alloc of one sequence in one wave, an alloc (of
        more than ``max_pages``, clipped) that evicts every other chain of
        its owner, and one larger than its owner's pool (infeasible);
      * then ``n_random`` waves of all four ops at once, ``rows`` rows each
        (a wave skips ``free`` while fewer sequences are known), with page
        counts past ``max_pages``, negative ones and positions out of range.

    Every ``free`` names sequences the facade knows, as its contract asks.
    Batch sizes repeat, so a compiled (JAX) page table reuses its programs."""
    rng = np.random.default_rng(seed)
    a = lambda *x: np.array(x, np.int32)
    waves = [
        [("alloc", a(8, 16, 24, 32, 40, 48, 56), a(3, 3, 3, 3, 1, 1, 1))],
        [("lookup", a(8, 16, 24, 32), None)],
        [("alloc", a(0), a(4))],
        [("append", a(40), a(9))],
        [("free", a(0), None), ("alloc", a(0, 16, 7), a(2, 20, 16))],
    ]
    g = STRESS_GEOMETRY
    known = {0, 8, 16, 24, 32, 40, 48, 56, 7}
    known.discard(0)
    for _ in range(n_random):
        wave = []
        for op in PHASES:
            n = rows
            if op == "free":
                if len(known) < n:
                    continue
                seqs = rng.choice(sorted(known), n,
                                  replace=False).astype(np.int32)
                known.difference_update(int(s) for s in seqs)
                wave.append(("free", seqs, None))
                continue
            seqs = rng.integers(0, g["max_seqs"], n).astype(np.int32)
            if op == "alloc":
                arg = rng.integers(-1, g["max_pages"] + 3, n)
            elif op == "append":
                arg = rng.integers(-2, (g["max_pages"] + 1) * g["page_size"],
                                   n)
            else:
                arg = None
            if op != "lookup":
                known.update(int(s) for s in seqs)
            wave.append((str(op), seqs,
                         None if arg is None else arg.astype(np.int32)))
        waves.append(wave)
    return waves


def submit_waves(pt: DelegatedPageTable, waves) -> List[List]:
    """Submit each wave's batches through the facade's ``*_then`` handles
    and run it as one engine round; returns the recorded waves
    [[(op, seqs, arg, future), ...], ...] for ``replay_waves``."""
    out = []
    for wave in waves:
        entries = []
        for op, seqs, arg in wave:
            fn = getattr(pt, op + "_then")
            fut = fn(seqs) if arg is None else fn(seqs, arg)
            entries.append((op, seqs, arg, fut))
        pt.session.step()
        out.append(entries)
    return out
