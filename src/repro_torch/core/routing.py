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


def block_router(keys: torch.Tensor, n_keys_total: int,
                 n_trustees: int) -> torch.Tensor:
    """Contiguous range partition: trustee t owns [t*B, (t+1)*B)."""
    block = -(-n_keys_total // n_trustees)
    return torch.clamp(torch.div(keys, block, rounding_mode="floor"), 0,
                       n_trustees - 1).to(torch.int32)


def page_router(positions: torch.Tensor, page_size: int,
                n_trustees: int) -> torch.Tensor:
    """KV-cache page owner: page p lives on trustee p % T (round-robin
    pages)."""
    return torch.remainder(
        torch.div(positions, page_size, rounding_mode="floor"),
        n_trustees).to(torch.int32)


_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for x in [0, 2^32) held in int64, by 16-bit halves
    of c so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = torch.bitwise_and(x * (c >> 16), 0xFFFF) << 16
    return torch.bitwise_and(lo + hi, _U32)


def hash_router(keys: torch.Tensor, n_trustees: int) -> torch.Tensor:
    """splitmix-style integer hash, then mod: decorrelates hot keys from
    trustee ids.  JAX's uint32 arithmetic, wrapping at 2^32 (a negative
    key is its two's-complement word), carried in int64."""
    x = torch.bitwise_and(keys.to(torch.int64), _U32)
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return torch.remainder(x, n_trustees).to(torch.int32)


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


def expected_max_load(n_keys: int, n_trustees: int, n_requests: int,
                      dist: str = "uniform", alpha: float = 1.0) -> float:
    """Expected requests a round at the busiest trustee under the mod
    router, to size channel capacity (the paper's slot-size trade-off,
    §5.3.1)."""
    if dist == "uniform":
        return n_requests / n_trustees
    p = zipf_probs(n_keys, alpha)
    owner = np.arange(n_keys) % n_trustees
    per_trustee = np.bincount(owner, weights=p, minlength=n_trustees)
    return float(per_trustee.max() * n_requests)


def sample_keys(rng: np.random.Generator, n_keys: int, n_samples: int,
                dist: str = "uniform", alpha: float = 1.0) -> np.ndarray:
    if dist == "uniform":
        return rng.integers(0, n_keys, size=n_samples, dtype=np.int64)
    if dist == "zipf":
        p = zipf_probs(n_keys, alpha)
        return rng.choice(n_keys, size=n_samples, p=p).astype(np.int64)
    raise ValueError(dist)
