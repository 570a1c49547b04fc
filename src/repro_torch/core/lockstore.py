"""Lock-based baselines (paper §6: the lanes delegation is compared
against), the sequential KV oracle and the lock-acquisition order.

The port of ``repro.core.lockstore`` (the port imports nothing of
``repro``):

  * ``FetchRMWStore`` — the general lock analog: fetch rows, mutate them
    on the client, write them back, one round per conflict rank
    (readers-writer or mutex);
  * ``AtomicAddStore`` — the fetch-and-add instruction analog;
  * ``SequentialKVReference`` / ``conflict_ranks`` — host-side numpy;
  * ``pad_writes`` — the KV benchmark's padding of a write subset.

Both stores wrap a ``DelegatedKVStore`` with the local shortcut off, so
the lock-backed table is a Trust like any other: it takes the same
``session=`` / ``name=`` keywords and can ride the same multiplexed
engine round as the delegated stores it is compared against.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def conflict_ranks(keys: np.ndarray, n_clients: int) -> Tuple[np.ndarray, int]:
    """Rank of each request among all requests to the same key (FIFO per
    client, round-robin over clients).  Returns (ranks, n_rounds)."""
    keys = np.asarray(keys)
    flat = keys.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_keys = flat[order]
    seg_start = np.searchsorted(sorted_keys, sorted_keys, side="left")
    ranks_flat = np.arange(flat.shape[0]) - seg_start
    ranks = np.empty_like(ranks_flat)
    ranks[order] = ranks_flat
    ranks = ranks.reshape(keys.shape)
    return ranks.astype(np.int32), int(ranks.max(initial=0)) + 1


class SequentialKVReference:
    """Host-side sequential oracle for the delegated KV semantics.

    Applies one channel round at a time.  GET/PUT/ADD reduce to plain
    sequential application row by row in serve order; CAS compares every
    row against the round-START table and commits the matching rows
    last-writer-wins.  Rows with ``key < 0`` are inactive.  Valid only
    when no row of the round overflows into the second_round block, which
    would permute the inter-client conflict order."""

    def __init__(self, n_keys: int, value_width: int = 4, dtype=np.float32):
        self.table = np.zeros((n_keys, value_width), dtype)
        self.value_width = value_width
        self.dtype = dtype

    def prefill(self, values: np.ndarray) -> None:
        self.table[: values.shape[0]] = values

    def dump(self) -> np.ndarray:
        return self.table.copy()

    def _resp(self, n):
        return np.zeros((n, self.value_width), self.dtype)

    def get(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        out = self._resp(len(keys))
        act = keys >= 0
        out[act] = self.table[keys[act]]
        return out

    def put(self, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        for i in range(len(keys)):          # sequential == last-writer-wins
            if keys[i] >= 0:
                self.table[keys[i]] = values[i]
        return self._resp(len(keys))

    def add(self, keys: np.ndarray, deltas: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        out = self._resp(len(keys))
        for i in range(len(keys)):
            if keys[i] >= 0:
                out[i] = self.table[keys[i]]
                self.table[keys[i]] = self.table[keys[i]] + deltas[i]
        return out

    def cas(self, keys: np.ndarray, expect: np.ndarray, values: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.asarray(keys)
        snapshot = self.table.copy()        # round-start view for every row
        flags = np.zeros((len(keys),), np.int32)
        old = self._resp(len(keys))
        for i in range(len(keys)):
            if keys[i] < 0:
                continue
            old[i] = snapshot[keys[i]]
            if np.array_equal(snapshot[keys[i]],
                              np.asarray(expect[i], self.table.dtype)):
                flags[i] = 1
                self.table[keys[i]] = values[i]
        return flags, old


def pad_writes(wkeys: np.ndarray, wvals: torch.Tensor, ranks: np.ndarray,
               n_rounds: int, mult: int):
    """Pad a variable-length write subset to a multiple of ``mult`` (the
    device count in the JAX benchmark, ``benchmarks/kv_store.py``);
    padded rows get rank ``n_rounds``, so no round activates them.
    Returns (keys, values, ranks, n_rounds)."""
    n = len(wkeys)
    pad = (-n) % mult
    keys = torch.as_tensor(np.concatenate(
        [wkeys, np.zeros(pad, wkeys.dtype)]), device=wvals.device)
    rk = np.concatenate([np.asarray(ranks), np.full(pad, n_rounds)])
    vals = torch.cat([wvals[:n], torch.zeros((pad,) + tuple(wvals.shape[1:]),
                                             dtype=wvals.dtype,
                                             device=wvals.device)], 0)
    return keys, vals, rk, n_rounds


class FetchRMWStore:
    """General lock analog: fetch rows, mutate them on the client, write
    them back (see ``repro.core.lockstore.FetchRMWStore``).

    The fetch and the write-back go through the delegated channel (on a
    mesh they ARE the gather and the scatter), so the comparison against
    ``DelegatedKVStore`` isolates the algorithmic difference: the value
    bytes moved twice plus serialisation rounds, against one request
    round."""

    def __init__(self, mesh, n_keys: int, value_width: int = 4,
                 dtype=torch.float32, rw_lock: bool = False, **kw):
        from .kvstore import DelegatedKVStore
        kw.setdefault("name", "rw-lock" if rw_lock else "rmw-lock")
        self.store = DelegatedKVStore(mesh, n_keys, value_width, dtype=dtype,
                                      local_shortcut=False, **kw)
        self.rw_lock = rw_lock
        self.value_width = value_width
        self.n_rounds_executed = 0

    def dump(self) -> np.ndarray:
        return self.store.dump()

    def prefill(self, values) -> None:
        self.store.prefill(values)

    def _ranks(self, ranks, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ranks), device=like.device)

    def rmw(self, keys: torch.Tensor, crit_fn: Callable, ranks, n_rounds: int,
            payload: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply ``crit_fn(value_row, payload_row) -> new_row`` under mutual
        exclusion, one round per conflict rank: a GET masked by ``where=``,
        then ``crit_fn``, then a masked PUT.  ``ranks`` / ``n_rounds`` come
        from ``conflict_ranks``.  Returns each row's fetched value."""
        keys = torch.as_tensor(keys, device=self.store.trust.device)
        ranks = self._ranks(ranks, keys)
        out = torch.zeros((keys.shape[0], self.value_width),
                          dtype=self.store.dtype, device=keys.device)
        op = self.store.trust.op
        for r in range(n_rounds):
            active = ranks == r
            ks = torch.where(active, keys, torch.full_like(keys, -1))
            # acquire + fetch: rows travel owner -> client
            got = op.get(ks, where=active)["value"]
            new_rows = crit_fn(got, payload if payload is not None else got)
            # write back + release: rows travel client -> owner
            op.put(ks, new_rows, where=active)
            out = torch.where(active[:, None], got, out)
            self.n_rounds_executed += 1
        return out

    def get(self, keys: torch.Tensor) -> torch.Tensor:
        """Readers-writer lock: reads are a single parallel round.  A key
        below 0 marks an inactive row (the oracle's convention) and reads
        zeros; the JAX store would serve it, wrapping the index."""
        keys = torch.as_tensor(keys, device=self.store.trust.device)
        return self.store.trust.op.get(keys, where=keys >= 0)["value"]

    def put(self, keys: torch.Tensor, values: torch.Tensor, ranks,
            n_rounds: int) -> None:
        """With ``rw_lock`` the writers serialise by ``ranks``: each round
        an exclusive acquire (a masked GET) and a masked PUT.  Without it
        the write is an ``rmw`` whose ranks are recomputed from the keys:
        the caller's ``ranks`` / ``n_rounds`` are ignored, as in the JAX
        store (``repro.core.lockstore``), which the port copies."""
        keys = torch.as_tensor(keys, device=self.store.trust.device)
        if self.rw_lock:
            ranks = self._ranks(ranks, keys)
            op = self.store.trust.op
            for r in range(n_rounds):
                active = ranks == r
                op.get(keys, where=active)            # exclusive acquire
                op.put(keys, values, where=active)
                self.n_rounds_executed += 1
        else:
            self.rmw(keys, lambda _v, p: p,
                     *conflict_ranks(keys.cpu().numpy(), 0), payload=values)


class AtomicAddStore:
    """Fetch-and-add instruction analog: a commutative scatter-add with no
    serialisation rounds, for commutative ops only — the restriction real
    atomics have; the strongest baseline of the Fig. 6 microbenchmark."""

    def __init__(self, mesh, n_keys: int, value_width: int = 4,
                 dtype=torch.float32, **kw):
        from .kvstore import DelegatedKVStore
        kw.setdefault("name", "atomic-add")
        self.store = DelegatedKVStore(mesh, n_keys, value_width, dtype=dtype,
                                      local_shortcut=False, **kw)

    def dump(self) -> np.ndarray:
        return self.store.dump()

    def prefill(self, values) -> None:
        self.store.prefill(values)

    def add(self, keys: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        return self.store.add(keys, deltas)
