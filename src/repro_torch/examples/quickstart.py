"""Quickstart: the typed Trust<T> API in five minutes (paper Figs. 1-3).

The torch counterpart of the JAX package's ``examples/quickstart.py``.
Entrusted state is reachable only through declared operations: declare
``Field``s, ``OpSpec``s and a ``TrustSchema``; ``entrust`` derives the op
table, the response structure and the routing rule, and the Trust grows
typed op handles — ``trust.op.inc(deltas)`` — that validate every
argument before anything rides the channel.

The mesh is 8 shards stacked on one device (a ``StackedMesh``); every
shard is both client and trustee (the paper's default).

Run:  python -m repro_torch.examples.quickstart [--device cpu]
(on the card by default).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (DelegatedKVStore, Field, OpSpec, SchemaError,
                              StackedMesh, TrusteeGroup, TrustSchema,
                              use_session)

N_SHARDS = 8


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def run(device=None) -> dict:
    """Every step of the quickstart; returns what it printed, by name."""
    out = {}
    mesh = StackedMesh((1, N_SHARDS), ("data", "model"), device=device)
    dev = mesh.device

    # --- Fig. 1: entrust a counter, apply typed ops to it -------------------
    def inc(state, rows, m, client):
        # stacked: state["ct"] (T, 1), rows["delta"] and m (T, N)
        delta = torch.where(m, rows["delta"], torch.zeros_like(rows["delta"]))
        ct = state["ct"]
        new = ct.clone()
        new[:, 0] += delta.sum(dim=1)
        return {"ct": new}, {"value": ct[:, :1].expand(m.shape)}

    # the schema is the delegated object's contract: payload / response
    # fields, which fields each op writes, and the key -> owner rule (the
    # counter lives on trustee 0)
    counter_schema = TrustSchema(
        "counter",
        ops=[OpSpec("inc",
                    payload=[Field("delta", (), torch.float32)],
                    response=[Field("value", (), torch.float32)],
                    writes=["value"], serve=inc)],
        state={"ct": Field("ct", (), torch.float32)},
        route=lambda payload, t: torch.zeros_like(payload["delta"],
                                                  dtype=torch.int32))

    group = TrusteeGroup(mesh, ("data", "model"))
    # one counter slot a trustee; trustee 0 owns the counter
    ct0 = torch.zeros((group.n_trustees, 1))
    ct0[0, 0] = 17.0
    trust = group.entrust({"ct": ct0}, schema=counter_schema, capacity=8)
    trust.op.inc(torch.ones((2,), device=dev))
    res = trust.op.inc(torch.zeros((1,), device=dev))
    out["counter"] = float(res["value"][0])
    print(f"counter value: {out['counter']}  (paper asserts 19)")
    assert out["counter"] == 19.0

    # a bad argument raises before any channel round
    try:
        trust.op.inc(torch.zeros((2, 3), dtype=torch.int32, device=dev))
    except SchemaError as e:
        out["schema_error"] = str(e)
        print(f"typed API rejected a bad batch: {e}")
    else:
        raise AssertionError("SchemaError not raised for a bad batch")

    # --- Fig. 3: apply_then — async delegation with a then-callback --------
    got = []
    trust.op.inc.then(torch.ones((1,), device=dev),
                      then=lambda r: got.append(float(r["value"][0])))
    trust.flush()
    out["then_value"] = got[0]
    print(f"async then-callback saw counter = {got[0]}")

    # --- the KV store (paper §6.3) in three lines ---------------------------
    store = DelegatedKVStore(mesh, n_keys=1024, value_width=4)
    store.put(torch.arange(8, device=dev),
              torch.arange(8.0, device=dev)[:, None].repeat(1, 4))
    out["get"] = _np(store.get(torch.tensor([3, 5], device=dev))[:, 0])
    print("GET [3, 5] ->", out["get"])

    # fetch-and-add, the paper's microbenchmark op, through the same
    # typed handles the facade wraps
    old = store.trust.op.add(torch.tensor([3, 3, 3], device=dev),
                             torch.ones((3, 4), device=dev))
    out["fetch_adds"] = _np(old["value"][:, 0])
    print("three racing fetch-and-adds on key 3 returned (FIFO):",
          out["fetch_adds"])

    # --- the session engine: ONE round for ALL trusts (DESIGN.md §8) --------
    # every entrusted object registers with the session; step() fuses all
    # pending submits — the KV store and a second counters table — into a
    # single multiplexed channel round
    from repro_torch.core import current_session
    session = current_session()
    counters = DelegatedKVStore(mesh, n_keys=64, value_width=4,
                                name="counters")
    fut = store.trust.op.get.then(torch.tensor([3, 5], device=dev))
    counters.trust.op.put.then(torch.arange(4, device=dev),
                               torch.ones((4, 4), device=dev))
    bumped = counters.trust.op.add.then(torch.arange(4, device=dev),
                                        torch.ones((4, 4), device=dev))
    session.step()              # ONE fused round serves both trusts
    out["fused_get"] = _np(fut.result()["value"][:, 0])
    out["fused_counters"] = _np(bumped.result()["value"][:, 0])
    out["stats"] = session.last_stats()
    print("fused-round GET [3, 5] ->", out["fused_get"])
    print("fused-round counters ->", out["fused_counters"])
    print("engine stats:", out["stats"])

    # --- dedicated mode: reserved trustee shards (paper's second runtime) --
    # the trailing shards hold the table and serve the rest; the client
    # API is unchanged
    ded = DelegatedKVStore(mesh, n_keys=1024, value_width=4,
                           mode="dedicated", n_dedicated=mesh.size // 2)
    ded.put(torch.arange(8, device=dev),
            torch.arange(8.0, device=dev)[:, None].repeat(1, 4))
    out["dedicated_get"] = _np(ded.get(torch.tensor([3, 5], device=dev))[:, 0])
    print("dedicated-mode GET [3, 5] ->", out["dedicated_get"])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain paths")
    args = ap.parse_args(argv)
    with use_session():
        return run(args.device)


if __name__ == "__main__":
    main()
