"""Key -> trustee routing, and the workload generators of the benchmarks.

Torch counterparts of ``repro.core.routing``'s routers; the generators are
host-side numpy, copied so the port imports nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch


def mod_router(keys: torch.Tensor, n_trustees: int) -> torch.Tensor:
    """Object id -> trustee by modulo (the paper's per-object assignment)."""
    return torch.remainder(keys, n_trustees).to(torch.int32)


def default_n_dedicated(axis_size: int) -> int:
    """Default reserved-trustee count: half the mesh (the paper's balanced
    dedicated split), at least one shard."""
    return max(1, axis_size // 2)


def partition_clients_trustees(axis_size: int, n_dedicated: int
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Split the stacked shards into (client_slots, trustee_slots): the LAST
    ``n_dedicated`` shards are the reserved trustees, the leading
    ``axis_size - n_dedicated`` the clients."""
    if not 0 < n_dedicated < axis_size:
        raise ValueError(
            f"n_dedicated must be in (0, {axis_size}), got {n_dedicated}")
    n_clients = axis_size - n_dedicated
    return (np.arange(n_clients, dtype=np.int32),
            np.arange(n_clients, axis_size, dtype=np.int32))


def trustee_device_slot(dst: torch.Tensor, n_clients: int) -> torch.Tensor:
    """Dedicated mode: trustee id [0, T) -> its shard past the clients;
    -1 stays -1."""
    return torch.where(dst >= 0, dst + n_clients, -1).to(torch.int32)


def local_index(keys: torch.Tensor, n_trustees: int) -> torch.Tensor:
    """Index of a key within its owner's local shard (mod router)."""
    return torch.div(keys, n_trustees, rounding_mode="floor").to(torch.int32)


def zipf_probs(n: int, alpha: float = 1.0) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


def sample_keys(rng: np.random.Generator, n_keys: int, n_samples: int,
                dist: str = "uniform", alpha: float = 1.0) -> np.ndarray:
    if dist == "uniform":
        return rng.integers(0, n_keys, size=n_samples, dtype=np.int64)
    if dist == "zipf":
        p = zipf_probs(n_keys, alpha)
        return rng.choice(n_keys, size=n_samples, p=p).astype(np.int64)
    raise ValueError(dist)
