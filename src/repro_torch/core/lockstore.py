"""The sequential KV oracle and the lock-acquisition order, host-side numpy.

The port's own copy of ``SequentialKVReference`` and ``conflict_ranks``
from ``repro.core.lockstore`` (the port imports nothing of ``repro``).
The lock-analog stores of that module are not ported yet (ROADMAP.md
queue A: lock baselines).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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
