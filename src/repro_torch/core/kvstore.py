"""DelegatedKVStore — the paper's key-value store (§6.3) as a Trust.

The torch counterpart of ``repro.core.kvstore``.  State: a direct-indexed
table of fixed-width values, mod-partitioned over the trustees and held
STACKED as ``{"table": (T, K_local, W)}`` — trustee ``t`` owns the keys
``{k : k % T == t}`` at local index ``k // T`` (the JAX owner-major
``(T * K_local, W)`` table is its reshape; ``convert.py`` maps between
them).  Ops:

  GET(key)                 -> value
  PUT(key, value)          -> ()         (no response on the wire)
  ADD(key, delta)          -> old value  (fetch-and-add)
  CAS(key, expect, value)  -> success flag and the current value

Within one channel round, writers to one key resolve last-writer-wins in
serve order (client, slot), GET reads the round-entry table, PUT commits
before ADD, and CAS compares against the post-ADD table.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import routing
from .channel import launch_or_defer, report_impl_event
from .meshctx import StackedMesh
from .opspec import Combine, Field, OpSpec, TrustSchema
from .trust import TrusteeGroup
from ..kernels import ops as kops
from ..kernels.ref import (LANE_ADD, LANE_CAS, LANE_GET, LANE_PUT,
                           take_rows)

LANE_IDS = ("get", "put", "add", "cas")


def _mask(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    m = m.reshape(tuple(m.shape) + (1,) * (x.dim() - m.dim()))
    return torch.where(m, x, torch.zeros_like(x))


def _commit_rows(table: torch.Tensor, idx: torch.Tensor, win: torch.Tensor,
                 value: torch.Tensor) -> torch.Tensor:
    """Write each winning row to its key (winners have unique keys per
    shard): a narrow scatter of row numbers, then a K-row gather."""
    t, k = table.shape[:2]
    n = idx.shape[1]
    pos = torch.arange(n, dtype=torch.int32, device=idx.device).expand(t, n)
    winner = torch.full((t, k + 1), -1, dtype=torch.int32,
                        device=idx.device)
    winner.scatter_(1, torch.where(win, idx, k).long(),
                    torch.where(win, pos, -1))
    winner = winner[:, :k]
    has = (winner >= 0)[..., None]
    return torch.where(has, take_rows(value, torch.clamp(winner, min=0)),
                       table)


def _ordered_last_writer(table: torch.Tensor, idx: torch.Tensor,
                         rows: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Masked-serve last-writer-wins: scatter-max each request's sequence
    number, gather the winner."""
    t, k = table.shape[:2]
    n = idx.shape[1]
    safe = torch.where(m, idx, k).long()
    seq = torch.arange(1, n + 1, dtype=torch.int32,
                       device=idx.device).expand(t, n)
    winner = torch.zeros((t, k + 1), dtype=torch.int32, device=idx.device) \
        .scatter_reduce_(1, safe, torch.where(m, seq, 0), "amax")[:, :k]
    win_rows = take_rows(rows, torch.clamp(winner - 1, min=0))
    return torch.where((winner > 0)[..., None], win_rows, table)


class KVTableServe:
    """Fused grouped serve for the KV op-mix, shared by the four ops of one
    table.  ``serve_lax`` applies the mix as plain PyTorch segment
    primitives over the shared grouping (serve_impl="ref");
    ``serve_kernel`` routes it through the CUDA serve kernels
    (serve_impl="kernel").  A non-f32 table falls back from the kernels to
    ``serve_lax``, reporting the event (``TypeError`` under
    ``strict_impl``)."""

    def __init__(self, n_trustees: int, value_width: int, dtype):
        self.n_trustees = n_trustees
        self.value_width = value_width
        self.dtype = dtype

    def local_idx(self, rows) -> torch.Tensor:
        return routing.local_index(rows["key"], self.n_trustees)

    def table_idx(self, rows, n_local: int) -> torch.Tensor:
        """Local index clamped into the table: reads and writes never leave
        the shard (the JAX kernel path's clamp)."""
        return torch.clamp(self.local_idx(rows), 0, n_local - 1)

    def group_key(self, state, rows):
        return self.local_idx(rows), state["table"].shape[1]

    def _lane_masks(self, ops, ids, received):
        multi = len(ids) > 1
        op_col = received.rows["op"] if multi else None
        return {ops[i].kernel_lane:
                (received.valid & (op_col == i)) if multi else received.valid
                for i in ids}

    def serve(self, ops, ids, state, received, impl: str, cfg=None):
        if impl == "kernel":
            return self.serve_kernel(ops, ids, state, received, cfg)
        return self.serve_lax(ops, ids, state, received)

    def serve_lax(self, ops, ids, state, received):
        """The plain grouped serve (the JAX ``serve_lax``), functional."""
        rows, g = received.rows, received.grouping
        table = state["table"]
        t, n_local = table.shape[:2]
        n = received.valid.shape[1]
        lanes = self._lane_masks(ops, ids, received)
        idx = self.table_idx(rows, n_local)
        value = rows.get("value")
        pos = torch.arange(n, dtype=torch.int32,
                           device=table.device).expand(t, n)

        def at(tbl, m):
            return take_rows(tbl, torch.where(m, idx, 0))

        resp_value = torch.zeros((t, n, self.value_width), dtype=table.dtype,
                                 device=table.device)
        if "get" in lanes:
            m = lanes["get"]
            resp_value = resp_value + _mask(at(table, m), m)
        if "put" in lanes:
            m = lanes["put"]
            table = _commit_rows(table, idx,
                                 m & (g.inv == g.seg_end_row - 1), value)
        if "add" in lanes:
            m = lanes["add"]
            delta = _mask(value, m)
            delta_s = take_rows(delta, g.order)
            excl = torch.cumsum(delta_s, dim=1) - delta_s
            prior = take_rows(excl - take_rows(excl, g.seg_start), g.inv)
            base = at(table, m)
            resp_value = resp_value + _mask(base + prior, m)
            table = torch.cat([table, torch.zeros_like(table[:, :1])], 1)
            table = table.index_put(
                (torch.arange(t, device=table.device)[:, None],
                 torch.where(m, idx, n_local).long()),
                delta, accumulate=True)[:, :n_local]
        if "cas" in lanes:
            m = lanes["cas"]
            cur = at(table, m)
            ok = m & torch.all(cur == rows["expect"], dim=-1)
            ok_s = take_rows(ok[..., None], g.order)[..., 0]
            run = torch.cummax(torch.where(ok_s, pos, -1), dim=1).values
            end = torch.clamp(g.seg_end - 1, 0, n - 1)
            write_s = (pos == torch.gather(run, 1, end.long())) & ok_s
            table = _commit_rows(
                table, idx, take_rows(write_s[..., None], g.inv)[..., 0],
                value)
            resp_value = resp_value + _mask(cur, m)
            flag = ok.to(torch.int32)
        else:
            flag = torch.zeros((t, n), dtype=torch.int32, device=table.device)
        return {**state, "table": table}, {"value": resp_value, "flag": flag}

    def serve_kernel(self, ops, ids, state, received, cfg=None):
        """The grouped mix through the CUDA serve kernels, updating the
        trustee's table IN PLACE (the Trust owns its state exclusively).
        Phase order: GET gather; PUT commit; ADD gather and commit; CAS
        gather, compare and commit — each kernel issued after the last on
        one stream, once the checks of all of them have passed."""
        table = state["table"]
        if table.dtype != torch.float32:
            event = (f"serve_kernel: table dtype {table.dtype} is not "
                     f"float32; fell back to serve_lax")
            report_impl_event(event)
            if cfg is not None and cfg.strict_impl:
                raise TypeError(
                    event + " (ChannelConfig.strict_impl=True forbids the "
                    "fallback; use serve_impl='ref' or an f32 table)")
            return self.serve_lax(ops, ids, state, received)
        rows, g = received.rows, received.grouping
        t, n_local, w = table.shape
        n = received.valid.shape[1]
        lanes = self._lane_masks(ops, ids, received)
        lane = torch.full((t, n), -1, dtype=torch.int32, device=table.device)
        for name, m in lanes.items():
            lane = torch.where(m, LANE_IDS.index(name), lane)
        keys = torch.where(lane >= 0, self.table_idx(rows, n_local),
                           n_local).to(torch.int32).contiguous()
        resp = torch.zeros((t, n, w), dtype=torch.float32,
                           device=table.device)
        flag = torch.zeros((t, n), dtype=torch.int32, device=table.device)
        value = rows["value"].to(torch.float32).contiguous() \
            if "value" in rows else None
        order, seg_end = g.order.contiguous(), g.seg_end.contiguous()
        calls = []                      # (serve op, its arguments), in order
        if "get" in lanes:
            calls.append(("gather", (table, keys, lane, LANE_GET, resp)))
        if "put" in lanes:
            calls.append(("scatter_last", (
                table, keys, order, seg_end,
                (lane == LANE_PUT).to(torch.int32), value)))
        if "add" in lanes:
            calls.append(("gather", (table, keys, lane, LANE_ADD, resp)))
            calls.append(("segmented_add", (
                table, keys, lane, order, g.seg_start.contiguous(), seg_end,
                value, resp)))
        if "cas" in lanes:
            expect = rows["expect"].to(torch.float32).contiguous()
            calls.append(("gather", (table, keys, lane, LANE_CAS, resp,
                                     expect, flag)))
            calls.append(("scatter_last", (table, keys, order, seg_end, flag,
                                           value)))
        # the table is written in place, so every check of the round runs
        # before its first launch: a round that raises there leaves the
        # table as it was, and Trust.flush may re-queue its batches (a
        # multiplexed serve holds the launches until every member's checks
        # have passed)
        for name, args in calls:
            kops.check(name, *args)

        def launch():
            for name, args in calls:
                getattr(kops, name)(*args)
        launch_or_defer(launch)
        return {**state, "table": table}, {"value": resp, "flag": flag}


def kv_reshard(host_state: Dict[str, np.ndarray], old_t: int,
               new_t: int) -> Dict[str, np.ndarray]:
    """Re-lay out an owner-major KV table (numpy, ``(T * K_local, W)``) for
    a different trustee count; the extra rows are phantom keys past the
    key space (zero, never routed to)."""
    table = np.asarray(host_state["table"])
    n_old = table.shape[0]
    if n_old % old_t:
        raise ValueError(f"table rows {n_old} not divisible by {old_t}")
    n_local = n_old // old_t
    key_order = np.zeros_like(table)
    for i in range(old_t):
        key_order[np.arange(i, n_old, old_t)] = \
            table[i * n_local:(i + 1) * n_local]
    n_new = ((n_old + new_t - 1) // new_t) * new_t
    if n_new != n_old:
        key_order = np.concatenate(
            [key_order,
             np.zeros((n_new - n_old,) + table.shape[1:], table.dtype)], 0)
    nl2 = n_new // new_t
    out = np.zeros((n_new,) + table.shape[1:], table.dtype)
    for i in range(new_t):
        out[i * nl2:(i + 1) * nl2] = key_order[np.arange(i, n_new, new_t)]
    return {**{k: np.asarray(v) for k, v in host_state.items()},
            "table": out}


def make_kv_schema(n_trustees: int, value_width: int,
                   dtype=torch.float32) -> TrustSchema:
    """The paper's KV store as a declarative ``TrustSchema``: typed
    payload/response Fields, per-op ``writes`` (elision), the mod router,
    the masked per-op serves (serve_impl="masked") and ONE fused provider
    for the grouped serves ("ref" / "kernel")."""
    fused = KVTableServe(n_trustees, value_width, dtype)

    def local_idx(rows, state):
        return fused.table_idx(rows, state["table"].shape[1])

    def get(state, rows, m, client):
        vals = take_rows(state["table"],
                         torch.where(m, local_idx(rows, state), 0))
        return state, {"value": _mask(vals, m),
                       "flag": torch.zeros(m.shape, dtype=torch.int32,
                                           device=m.device)}

    def put(state, rows, m, client):
        table = _ordered_last_writer(state["table"], local_idx(rows, state),
                                     rows["value"], m)
        return {**state, "table": table}, \
               {"value": torch.zeros(tuple(m.shape) + (value_width,),
                                     dtype=dtype, device=m.device),
                "flag": torch.zeros(m.shape, dtype=torch.int32,
                                    device=m.device)}

    def add(state, rows, m, client):
        # per-op sort + segmented exclusive prefix sum
        table = state["table"]
        t, n_local = table.shape[:2]
        idx = torch.where(m, local_idx(rows, state), n_local)
        delta = _mask(rows["value"], m)
        idx_s, order = torch.sort(idx, dim=1, stable=True)
        delta_s = take_rows(delta, order)
        incl = torch.cumsum(delta_s, dim=1)
        excl = incl - delta_s
        seg_start = torch.searchsorted(idx_s, idx_s, side="left")
        prior_s = excl - take_rows(excl, seg_start)
        prior = torch.zeros_like(delta)
        prior[torch.arange(t, device=m.device)[:, None], order] = prior_s
        base = take_rows(table, torch.where(m, idx, 0))
        old = _mask(base + prior, m)
        padded = torch.cat([table, torch.zeros_like(table[:, :1])], 1)
        padded = padded.index_put(
            (torch.arange(t, device=m.device)[:, None], idx.long()), delta,
            accumulate=True)
        return {**state, "table": padded[:, :n_local]}, \
               {"value": old, "flag": torch.zeros(m.shape, dtype=torch.int32,
                                                  device=m.device)}

    def cas(state, rows, m, client):
        idx = local_idx(rows, state)
        cur = take_rows(state["table"], torch.where(m, idx, 0))
        ok = m & torch.all(cur == rows["expect"], dim=-1)
        table = _ordered_last_writer(state["table"], idx, rows["value"], ok)
        return {**state, "table": table}, \
               {"value": _mask(cur, m), "flag": ok.to(torch.int32)}

    key_f = Field("key", (), torch.int32)
    value_f = Field("value", (value_width,), dtype)
    expect_f = Field("expect", (value_width,), dtype)
    resp = (Field("value", (value_width,), dtype),
            Field("flag", (), torch.int32))
    kw = dict(response=resp, group_key=fused.group_key, fused=fused)
    return TrustSchema(
        "kv",
        ops=[OpSpec("get", payload=(key_f,), writes=("value",), serve=get,
                    kernel_lane="get", combine=Combine("dedupe"), **kw),
             OpSpec("put", payload=(key_f, value_f), writes=(), serve=put,
                    kernel_lane="put", combine=Combine("last"), **kw),
             OpSpec("add", payload=(key_f, value_f), writes=("value",),
                    serve=add, kernel_lane="add", combine=Combine("sum"),
                    **kw),
             OpSpec("cas", payload=(key_f, value_f, expect_f),
                    writes=("value", "flag"), serve=cas, kernel_lane="cas",
                    **kw)],
        state={"table": Field("table", (value_width,), dtype)},
        route=lambda payload, t: routing.mod_router(payload["key"], t),
        reshard=kv_reshard)


def make_kv_ops(n_trustees: int, value_width: int,
                dtype=torch.float32):
    """The compiled op table of ``make_kv_schema`` (one ``DelegatedOp``
    an OpSpec; the JAX package's back-compat name)."""
    return make_kv_schema(n_trustees, value_width, dtype).delegated_ops()


class DelegatedKVStore:
    """The store facade of the KV-store benchmarks (see
    ``repro.core.kvstore.DelegatedKVStore``), on a ``StackedMesh``.

    ``mode="shared"`` entrusts the table to every shard of ``axis``
    (default the whole mesh; a sub-axis such as ``"model"`` keeps one copy
    of the table per replica, each served by its own replica's shards, as
    JAX's does); with ``mode="dedicated"`` the last ``n_dedicated`` shards
    hold it and serve the other (client) shards, whose region of the
    physical table stays zero.  ``state`` optionally starts the store from
    a stacked LOGICAL state dict, (T, rows, ...) (for example one carried
    across from the JAX store by ``convert.py``); it is copied onto the
    mesh's device."""

    def __init__(self, mesh: StackedMesh, n_keys: int, value_width: int = 4,
                 axis: Any = None, dtype=torch.float32,
                 capacity: Optional[int] = None,
                 overflow: str = "second_round", overflow_capacity: int = 0,
                 local_shortcut: bool = True, mode: str = "shared",
                 n_dedicated: int = 0, max_rounds: int = 1,
                 pack_impl: str = "kernel", serve_impl: str = "kernel",
                 name: Optional[str] = None, plan_capacity: bool = False,
                 session=None, strict_impl: bool = False,
                 serve_blocks: Any = None, pack_blocks: Any = None,
                 combine: str = "off",
                 state: Optional[Dict[str, torch.Tensor]] = None):
        axis = axis if axis is not None else tuple(mesh.axis_names)
        group = TrusteeGroup(mesh, axis, mode=mode, n_dedicated=n_dedicated)
        t = group.n_trustees
        self.group = group
        self.mode = mode
        self.n_keys = n_keys
        self.n_keys_padded = ((n_keys + t - 1) // t) * t
        self.value_width = value_width
        self.t = t
        self.dtype = dtype
        # the factory lets failover rebuild the schema for another trustee
        # count (the serve's local index bakes T in); the schema's
        # reshard= rule re-lays the table out
        schema_factory = lambda t_: make_kv_schema(t_, value_width, dtype)
        self.schema = schema_factory(t)
        if state is None:
            state = {"table": torch.zeros(
                (t, self.n_keys_padded // t, value_width), dtype=dtype,
                device=mesh.device)}
        self.trust = group.entrust(
            state, schema=self.schema, capacity=capacity, overflow=overflow,
            overflow_capacity=overflow_capacity,
            local_shortcut=local_shortcut, max_rounds=max_rounds,
            pack_impl=pack_impl, serve_impl=serve_impl, name=name,
            plan_capacity=plan_capacity, session=session,
            strict_impl=strict_impl, serve_blocks=serve_blocks,
            pack_blocks=pack_blocks, combine=combine,
            schema_factory=schema_factory)
        self.trust._on_rebuild.append(self._on_trust_rebuild)

    def _on_trust_rebuild(self, trust) -> None:
        """Failover hook: the trust was rebound onto a new trustee group —
        refresh the cached layout (trustee count, schema, padded key
        space) so route / prefill / dump follow the survivors' layout."""
        self.group = trust.group
        self.mode = trust.group.mode
        self.t = trust.n_trustees
        self.schema = trust.schema
        table = trust.trustee_state()["table"]
        self.n_keys_padded = int(table.shape[0] * table.shape[1])

    @property
    def session(self):
        return self.trust.session

    def route(self, keys: torch.Tensor) -> torch.Tensor:
        """Key -> trustee (the schema's router), for the stringly shims."""
        return routing.mod_router(keys, self.t)

    def _payload(self, keys, value=None, expect=None):
        """Payload dict for the stringly shims (``trust.apply``/``submit``)."""
        dev = self.trust.device
        p = {"key": torch.as_tensor(keys, device=dev).to(torch.int32)}
        if value is not None:
            p["value"] = torch.as_tensor(value, device=dev).to(self.dtype)
        if expect is not None:
            p["expect"] = torch.as_tensor(expect, device=dev).to(self.dtype)
        return p

    # -- sync API ------------------------------------------------------------
    def get(self, keys):
        return self.trust.op.get(keys)["value"]

    def put(self, keys, values):
        self.trust.op.put(keys, values)

    def add(self, keys, deltas):
        return self.trust.op.add(keys, deltas)["value"]

    def cas(self, keys, expect, values):
        r = self.trust.op.cas(keys, value=values, expect=expect)
        return r["flag"], r["value"]

    # -- async API (apply_then) ---------------------------------------------
    def get_then(self, keys, then=None):
        return self.trust.op.get.then(keys, then=then)

    def put_then(self, keys, values, then=None):
        return self.trust.op.put.then(keys, values, then=then)

    def add_then(self, keys, deltas, then=None):
        return self.trust.op.add.then(keys, deltas, then=then)

    def cas_then(self, keys, expect, values, then=None):
        return self.trust.op.cas.then(keys, value=values, expect=expect,
                                      then=then)

    def flush(self):
        self.trust.flush()

    # -- bulk load / inspection ----------------------------------------------
    def prefill(self, values: np.ndarray) -> None:
        """Install table contents in key order (set-up before timed runs)."""
        values = np.asarray(values)
        padded = np.zeros((self.n_keys_padded, self.value_width),
                          dtype=values.dtype)
        padded[: values.shape[0]] = values
        stacked = padded.reshape(-1, self.t, self.value_width) \
            .transpose(1, 0, 2)
        table = torch.as_tensor(np.ascontiguousarray(stacked),
                                device=self.trust.device).to(self.dtype)
        table = self.group.physical_state({"table": table})["table"]
        self.trust.set_state({**self.trust.state(), "table": table})

    def dump(self) -> np.ndarray:
        """The table in key order, on the host: a copy, never a view of the
        live table."""
        stacked = self.trust.trustee_state()["table"].cpu().numpy()
        return stacked.transpose(1, 0, 2).reshape(
            self.n_keys_padded, self.value_width)[: self.n_keys].copy()

    def client_region(self) -> np.ndarray:
        """Dedicated mode: the physical table rows on the client shards,
        owner-major ``(n_clients * K_local, W)`` (empty in shared mode).
        They must stay zero: state lives only on the trustee shards."""
        full = self.trust.state()["table"]
        n_cli = full.shape[0] - self.t
        return full[:n_cli].reshape(-1, self.value_width).cpu().numpy()
