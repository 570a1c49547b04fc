"""Delegated MoE routing: expert-load counters as a Trust.

The torch counterpart of the JAX package's ``examples/delegated_moe.py``.
The paper's fetch-and-add microbenchmark (Fig 6) becomes load-bearing
here: per-expert token counters live under trustee ownership as a typed
``TrustSchema`` with two handles —

  add(expert, delta) -> count     fetch-and-add; returns the running
                                  total AFTER this token landed, with
                                  same-round priors resolved in request
                                  order (client id, slot order)
  get(expert)        -> count     read the live total

and the router closes the loop: each wave reads the LIVE counts through
the ``get`` handle and penalises overloaded experts before taking the
top-1, so hot experts shed tokens to cold ones without any lock around
the counter array.  A host-side tally shadows every routed assignment;
the delegated counters must end equal to it.

Run:  python -m repro_torch.examples.delegated_moe [--device cpu]
(on the card by default, 8 stacked shards).
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.core import (StackedMesh, TrusteeGroup, routing,
                              use_session)
from repro_torch.core.opspec import Field, OpSpec, TrustSchema

N_SHARDS = 8


# ---------------------------------------------------------------------------
# the counter schema: one int32 slot per expert, mod-partitioned over
# trustees (expert e lives on trustee e % T at local row e // T)
# ---------------------------------------------------------------------------
def make_counter_schema(n_trustees: int) -> TrustSchema:
    t = n_trustees

    def local_idx(rows):
        return (rows["expert"] // t).to(torch.int32)

    def serve_add(state, rows, m, client):
        # stacked over trustees: counts (T, L); rows and m (T, N)
        counts = state["counts"]
        n_local = counts.shape[1]
        # fetch-and-add with in-round request-order priors: sort by slot
        # (stable), segmented exclusive prefix sum over the sorted deltas
        idx = torch.where(m, local_idx(rows), n_local).long()
        delta = torch.where(m, rows["delta"], 0).long()
        order = torch.argsort(idx, dim=1, stable=True)
        idx_s = torch.gather(idx, 1, order)
        delta_s = torch.gather(delta, 1, order)
        incl = torch.cumsum(delta_s, 1)
        excl = incl - delta_s
        seg_start = torch.searchsorted(idx_s, idx_s, side="left")
        prior = torch.zeros_like(delta).scatter(
            1, order, excl - torch.gather(excl, 1, seg_start))
        base = torch.gather(counts.long(), 1, torch.where(m, idx, 0))
        new = torch.where(m, base + prior + delta, 0).to(torch.int32)
        padded = torch.cat([counts.long(), torch.zeros_like(
            counts[:, :1], dtype=torch.long)], 1)
        padded = padded.scatter_add(1, idx, delta)      # idx n_local: drop
        return {**state, "counts": padded[:, :n_local].to(torch.int32)}, \
            {"count": new}

    def serve_get(state, rows, m, client):
        idx = torch.where(m, local_idx(rows), 0).long()
        cur = torch.gather(state["counts"], 1, idx)
        return state, {"count": torch.where(m, cur, 0).to(torch.int32)}

    expert_f = Field("expert", (), torch.int32)
    delta_f = Field("delta", (), torch.int32)
    resp = (Field("count", (), torch.int32),)
    return TrustSchema(
        "moe_counts",
        ops=[OpSpec("add", payload=(expert_f, delta_f), response=resp,
                    writes=("count",), serve=serve_add),
             OpSpec("get", payload=(expert_f,), response=resp,
                    writes=("count",), serve=serve_get)],
        state={"counts": Field("counts", (), torch.int32)},
        route=lambda payload, t_: routing.mod_router(payload["expert"], t_))


class DelegatedExpertCounters:
    """Facade over the counter trust: experts in, counts out."""

    def __init__(self, mesh: StackedMesh, n_experts: int, axis=None,
                 capacity: Optional[int] = None, local_shortcut: bool = True,
                 session=None, name: str = "moe_counts"):
        axis = axis if axis is not None else tuple(mesh.axis_names)
        group = TrusteeGroup(mesh, axis)
        t = group.n_trustees
        self.n_experts = n_experts
        self.n_padded = ((n_experts + t - 1) // t) * t
        self.t = t
        self.device = mesh.device
        schema_factory = lambda t_: make_counter_schema(t_)
        # owner-major: trustee i holds slots [i * L, (i + 1) * L)
        self.trust = group.entrust(
            {"counts": torch.zeros((t, self.n_padded // t),
                                   dtype=torch.int32)},
            schema=schema_factory(t), capacity=capacity,
            local_shortcut=local_shortcut, session=session, name=name,
            schema_factory=schema_factory)

    def _i32(self, x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                               device=self.device)

    def add(self, experts, deltas=None) -> np.ndarray:
        experts = self._i32(experts)
        deltas = torch.ones_like(experts) if deltas is None \
            else self._i32(deltas)
        r = self.trust.op.add(experts, deltas)
        return r["count"].cpu().numpy()

    def get(self, experts) -> np.ndarray:
        r = self.trust.op.get(self._i32(experts))
        return r["count"].cpu().numpy()

    def add_then(self, experts, deltas=None, then=None):
        experts = self._i32(experts)
        deltas = torch.ones_like(experts) if deltas is None \
            else self._i32(deltas)
        return self.trust.op.add.then(experts, deltas, then=then)

    def dump(self) -> np.ndarray:
        """Counts in expert order (host gather; tests/reporting only)."""
        owner_major = self.trust.trustee_state()["counts"].reshape(-1) \
            .cpu().numpy()
        n_local = self.n_padded // self.t
        out = np.zeros_like(owner_major)
        for i in range(self.t):
            out[np.arange(i, self.n_padded, self.t)] = \
                owner_major[i * n_local:(i + 1) * n_local]
        return out[: self.n_experts]


# ---------------------------------------------------------------------------
# the toy router: live counts bias the top-1 choice toward cold experts
# ---------------------------------------------------------------------------
def route_wave(logits: np.ndarray, counts: np.ndarray, lam: float,
               tokens_per_wave: int) -> np.ndarray:
    """Top-1 over load-penalised logits.  The penalty is the expert's
    surplus over a perfectly balanced share, in units of one wave."""
    if lam > 0.0:
        surplus = (counts - counts.mean()) / max(1, tokens_per_wave)
        logits = logits - lam * surplus[None, :]
    return np.argmax(logits, axis=-1).astype(np.int32)


def run_routing(mesh: StackedMesh, n_experts: int = 16, n_tokens: int = 64,
                n_waves: int = 30, lam: float = 1.0, seed: int = 0,
                verbose: bool = False):
    """Drive ``n_waves`` routing waves through the delegated counters.

    Returns a dict with the delegated counts, the host-side tally of every
    routed assignment (the agreement target), the unbiased baseline's
    tally, and both load-imbalance numbers (max load / mean load).

    The counters run without the local shortcut: on a mesh of several
    shards the shortcut serves a trustee's self-addressed rows after its
    channel rows, which is not request order (JAX's package does the
    same; its example runs on one device, where every row is
    self-addressed and the order holds)."""
    rng = np.random.default_rng(seed)
    counters = DelegatedExpertCounters(mesh, n_experts,
                                       capacity=max(n_tokens, n_experts),
                                       local_shortcut=False)
    # intrinsic popularity skew: without feedback, hot experts stay hot
    popularity = np.zeros((n_experts,), np.float32)
    popularity[: max(1, n_experts // 8)] = 1.5
    host_tally = np.zeros((n_experts,), np.int64)
    base_tally = np.zeros((n_experts,), np.int64)
    assignments = []
    for w in range(n_waves):
        logits = rng.normal(size=(n_tokens, n_experts)).astype(np.float32)
        logits += popularity[None, :]
        live = counters.get(np.arange(n_experts, dtype=np.int32))
        assign = route_wave(logits, live.astype(np.float64), lam, n_tokens)
        base_tally += np.bincount(np.argmax(logits, -1), minlength=n_experts)
        running = counters.add(assign)
        host_tally += np.bincount(assign, minlength=n_experts)
        assignments.append(assign)
        # the add handle's running totals must agree with the host replay
        # of this wave in request order (single client: slot order)
        replay = live.astype(np.int64).copy()
        for i, e in enumerate(assign):
            replay[e] += 1
            assert running[i] == replay[e], (w, i)
        if verbose:
            print(f"wave {w:3d}  max-load {host_tally.max():5d}  "
                  f"biased-imbalance "
                  f"{host_tally.max() / max(1.0, host_tally.mean()):.3f}")
    mean = max(1.0, float(host_tally.mean()))
    return {
        "counters": counters,
        "delegated": counters.dump().astype(np.int64),
        "host_tally": host_tally,
        "assignments": np.concatenate(assignments),
        "imbalance_biased": float(host_tally.max()) / mean,
        "imbalance_unbiased": float(base_tally.max()) /
            max(1.0, float(base_tally.mean())),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain paths")
    args = ap.parse_args(argv)
    mesh = StackedMesh((1, N_SHARDS), ("data", "model"), device=args.device)
    with use_session():
        res = run_routing(mesh, verbose=True)
    agree = bool(np.array_equal(res["delegated"], res["host_tally"]))
    print("\ndelegated counts == host tally of routed tokens:", agree)
    print(f"imbalance (max/mean)  unbiased {res['imbalance_unbiased']:.3f}"
          f"  ->  load-aware {res['imbalance_biased']:.3f}")
    if not agree:
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
