"""The paper's key-value store service (§6.3) end to end.

The torch counterpart of the JAX package's ``examples/serve_kv.py``.  A
batched GET/PUT server over a delegated table, with the async
(apply_then) pipeline of the memcached port (§7): parse -> route ->
delegate -> order responses -> reply.  Compares against the lock-analog
backend (a readers-writer lock) under a zipfian (hot-key) workload — the
paper's headline scenario.  ``service_round`` is one round of either
backend; it returns the round's GET responses.

Run:  python -m repro_torch.examples.serve_kv [--requests 4096]
      [--device cpu]   (on the card by default, 8 stacked shards)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (DelegatedKVStore, FetchRMWStore, StackedMesh,
                              conflict_ranks, current_session, use_session)
from repro_torch.core.routing import sample_keys

N_SHARDS = 8
W = 4


def make_stores(mesh, n_keys: int, rng: np.random.Generator):
    """The delegated store and the rw-lock store, each prefilled from
    ``rng`` (the delegated one first, as JAX's example draws them)."""
    store = DelegatedKVStore(mesh, n_keys, W)
    store.prefill(rng.normal(size=(n_keys, W)).astype(np.float32))
    lock = FetchRMWStore(mesh, n_keys, W, rw_lock=True)
    lock.prefill(rng.normal(size=(n_keys, W)).astype(np.float32))
    return store, lock


def service_round(st, keys_np: np.ndarray, is_write: np.ndarray,
                  backend: str) -> torch.Tensor:
    """One round: GETs of the rows that do not write, PUTs of ones on the
    rows that do; returns the (R, W) GET responses (rows that write: zeros
    from the delegated store, unspecified from the lock store)."""
    dev = st.trust.device if backend == "trust" else st.store.trust.device
    keys = torch.as_tensor(keys_np, dtype=torch.int32, device=dev)
    vals = torch.ones((len(keys_np), W), dtype=torch.float32, device=dev)
    reads = torch.as_tensor(~is_write, device=dev)
    if backend == "trust":
        # typed handles: the schema routes the keys and validates the rows;
        # where= deactivates the other op's subset
        g = st.trust.op.get.then(keys, where=reads)
        st.trust.op.put.then(keys, vals, where=~reads)
        # the session step flushes every registered trust's pending
        # batches: more entrusted objects would ride this one multiplexed
        # channel round (DESIGN.md §8)
        current_session().step()
        return g.result()["value"]
    gk = torch.where(reads, keys, torch.full_like(keys, -1))
    out = st.get(gk)
    wk = keys_np[is_write]
    if len(wk):
        ranks, n = conflict_ranks(wk, N_SHARDS)
        st.put(torch.as_tensor(wk, dtype=torch.int32, device=dev),
               vals[: len(wk)], ranks, min(n, 16))
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-keys", type=int, default=100_000)
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--write-pct", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain paths")
    args = ap.parse_args(argv)

    mesh = StackedMesh((1, N_SHARDS), ("data", "model"), device=args.device)
    rng = np.random.default_rng(0)
    result = {}
    with use_session():
        store, lock = make_stores(mesh, args.n_keys, rng)
        for backend, st in (("trust", store), ("rw-lock", lock)):
            keys_np = sample_keys(rng, args.n_keys, args.requests, "zipf")
            is_write = rng.random(args.requests) < args.write_pct / 100
            service_round(st, keys_np, is_write, backend)     # warm-up
            _sync(mesh.device)
            t0 = time.perf_counter()
            for _ in range(args.rounds):
                out = service_round(st, keys_np, is_write, backend)
            _sync(mesh.device)
            dt = time.perf_counter() - t0
            total = args.rounds * args.requests
            result[backend] = dict(kops=total / dt / 1e3,
                                   ms_a_round=dt / args.rounds * 1e3,
                                   keys=keys_np, is_write=is_write,
                                   last=out.cpu().numpy())
            print(f"{backend:8s}: {total/dt/1e3:8.1f} kops "
                  f"({dt/args.rounds*1e3:.1f} ms/round, zipf hot-key, "
                  f"{args.write_pct}% writes)")
    return result


if __name__ == "__main__":
    main()
