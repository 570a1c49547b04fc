"""DelegatedPageTable — a Trust-owned paged KV-cache page table.

The torch counterpart of ``repro.core.pagetable``.  Continuous-batching
decode allocates, appends to, looks up and frees per-sequence chains of
fixed-size KV-cache pages on every decode step: the hot, lock-guarded
object of paged-attention servers.  Here the page table is entrusted: the
free list, the chains, the LRU stamps and the eviction policy live on the
owning trustee, and clients reach them only through channel rounds.

State (STACKED on the trustee dimension; trustee ``i`` owns sequence ids
``{s : s % T == i}`` and a private local page pool; global page id =
``local * T + owner``):

  used       (T, PL)        0 free · 1 allocated · 2 phantom pad
  chains     (T, SL, MP)    local page ids per chain slot, -1 pad
  chain_len  (T, SL)        pages currently chained
  last_used  (T, SL)        LRU stamp (per-trustee logical clock)
  clock      (T, 1)         per-trustee clock
  evictions  (T, 1)         capacity-pressure eviction counter

Ops (one ``TrustSchema``, op-phase order alloc, append, free, lookup):

  alloc(seq, n)    -> pages, n, flag   extend seq's chain by n pages
  append(seq, pos) -> page,  n, flag   page slot for token ``pos``; the
                                       crossing into a fresh page
                                       allocates exactly what is missing
  free(seq)        -> n, flag          release the whole chain
  lookup(seq)      -> pages, n, flag   the chain (block-sparse KV layout)

Each op is served as a masked per-op pass over the trustee's rows in
serve order, strictly sequential per trustee (the paper's model) — on the
card by the ``pagetable_serve`` CUDA kernel, on the CPU by its plain
version — bit-identical to ``SequentialPageTable`` (the host oracle) and
to the JAX serve.  Allocation is deterministic: the lowest-numbered free
local pages, all-or-nothing; under capacity pressure the LRU victim (min
``last_used``, ties to the lowest local seq index, never the requesting
seq) is evicted whole until the request fits or no victim remains.

In dedicated mode (``mode="dedicated"``) the last ``n_dedicated`` shards
own the table and serve the client shards; the serve runs over every
stacked shard, and a client shard, which receives no rows, keeps its zero
region.  ``pagetable_reshard`` (a copy of the JAX package's, on the
owner-major host state) re-lays the table out for failover onto another
trustee count.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.ref import PT_OPS
from . import routing
from .meshctx import StackedMesh, to_device_async
from .opspec import Field, ListField, OpSpec, SchemaError, TrustSchema
from .trust import TrusteeGroup

_I32MAX = np.iinfo(np.int32).max
PHASES = ("alloc", "append", "free", "lookup")      # the op-phase order


def _ceil_to(n: int, t: int) -> int:
    return ((n + t - 1) // t) * t


# ---------------------------------------------------------------------------
# Initial state (shared by the facade and the sequential oracle)
# ---------------------------------------------------------------------------

def initial_pagetable_state(n_pages: int, max_seqs: int, max_pages: int,
                            n_trustees: int) -> Dict[str, np.ndarray]:
    """Owner-major host state for a fresh page table (the JAX layout;
    ``convert.stacked_from_owner_major`` stacks it).  Pages past
    ``n_pages`` (padding to a multiple of the trustee count) are marked
    phantom (``used == 2``) so the allocator can never hand them out."""
    t = n_trustees
    p_pad = _ceil_to(n_pages, t)
    s_pad = _ceil_to(max_seqs, t)
    pl = p_pad // t
    used = np.zeros((t, pl), np.int32)
    for g in range(n_pages, p_pad):
        used[g % t, g // t] = 2
    return {
        "used": used.reshape(-1),
        "chains": np.full((s_pad, max_pages), -1, np.int32),
        "chain_len": np.zeros((s_pad,), np.int32),
        "last_used": np.zeros((s_pad,), np.int32),
        "clock": np.zeros((t,), np.int32),
        "evictions": np.zeros((t,), np.int32),
    }


def pagetable_reshard(host_state: Dict[str, np.ndarray], old_t: int,
                      new_t: int) -> Dict[str, np.ndarray]:
    """Re-layout a page table for a different trustee count (failover).

    Unlike the KV table, rows cannot simply move: both the seq→owner map
    (``seq % T``) and the page-id map (``local * T + owner``) change with
    ``T``, and a chain must reference pages on its OWN owner.  So the
    reshard keeps the logical contents (which seqs hold how many pages,
    their LRU stamps) and deterministically RE-ALLOCATES every chain on
    its new owner: seqs in ascending global id take the lowest-numbered
    free local pages.  Page identities change across failover — clients
    must re-``lookup`` (the decode driver re-gathers page lists every
    wave anyway; DESIGN.md §15 documents the contract).  If a new owner
    cannot hold its seqs' pages (shrunk pool / lumpy assignment), LRU
    seqs are dropped — the same victim rule the serve path uses — and
    count as evictions.  Conservation (no leaked, no double-chained
    pages) holds by construction."""
    used = np.asarray(host_state["used"])
    chains = np.asarray(host_state["chains"])
    cl = np.asarray(host_state["chain_len"])
    lu = np.asarray(host_state["last_used"])
    clock = np.asarray(host_state["clock"])
    ev = np.asarray(host_state["evictions"])
    mp = chains.shape[1]
    s_old, p_old = cl.shape[0], used.shape[0]
    assert s_old % old_t == 0 and p_old % old_t == 0, (s_old, p_old, old_t)
    sl_old, pl_old = s_old // old_t, p_old // old_t

    def key_order(a, nl):
        out = np.zeros_like(a)
        for i in range(old_t):
            out[np.arange(i, a.shape[0], old_t)] = a[i * nl:(i + 1) * nl]
        return out

    used_k = key_order(used, pl_old)          # global page id -> status
    cl_k = key_order(cl, sl_old).copy()       # global seq id  -> chain len
    lu_k = key_order(lu, sl_old)
    n_real = int(np.sum(used_k != 2))

    p_new = _ceil_to(n_real, new_t)
    s_new = _ceil_to(s_old, new_t)
    pl_new, sl_new = p_new // new_t, s_new // new_t
    used2 = np.zeros((new_t, pl_new), np.int32)
    for g in range(n_real, p_new):
        used2[g % new_t, g // new_t] = 2
    chains2 = np.full((new_t, sl_new, mp), -1, np.int32)
    cl2 = np.zeros((new_t, sl_new), np.int32)
    lu2 = np.zeros((new_t, sl_new), np.int32)

    dropped = 0
    for o in range(new_t):
        cap = int(np.sum(used2[o] == 0))
        seqs = [s for s in range(s_old) if s % new_t == o and cl_k[s] > 0]
        while sum(int(cl_k[s]) for s in seqs) > cap:
            victim = min(seqs, key=lambda s: (int(lu_k[s]), s))
            cl_k[victim] = 0
            seqs.remove(victim)
            dropped += 1
        for s in seqs:
            n = int(cl_k[s])
            pages = np.flatnonzero(used2[o] == 0)[:n]
            used2[o, pages] = 1
            chains2[o, s // new_t, :n] = pages.astype(np.int32)
            cl2[o, s // new_t] = n
            lu2[o, s // new_t] = lu_k[s]

    clock2 = np.full((new_t,), int(clock.max(initial=0)), np.int32)
    ev2 = np.zeros((new_t,), np.int32)
    ev2[0] = int(ev.sum()) + dropped
    return {"used": used2.reshape(-1), "chains": chains2.reshape(s_new, mp),
            "chain_len": cl2.reshape(-1), "last_used": lu2.reshape(-1),
            "clock": clock2, "evictions": ev2}


# ---------------------------------------------------------------------------
# The schema
# ---------------------------------------------------------------------------

def make_pagetable_schema(n_trustees: int, page_size: int,
                          max_pages: int) -> TrustSchema:
    """The page table as a declarative ``TrustSchema``.

    The ops declare no ``group_key``/``fused`` provider: they run as masked
    per-op passes, in declaration order (alloc,
    append, free, lookup), each ONE ``pagetable_serve`` call over every
    trustee's rows in serve order — the CUDA kernel for CUDA state, its
    plain version for CPU state.  The state is updated in place."""
    t, mp, ps = n_trustees, max_pages, page_size

    def serve(op: str, arg_field: Optional[str]):
        code = PT_OPS[op]

        def fn(state, rows, m, client):
            seq = rows["seq"].to(torch.int32).contiguous()
            arg = seq if arg_field is None else \
                rows[arg_field].to(torch.int32).contiguous()
            pages, page, n, flag = kops.pagetable_serve(
                code, state, seq, arg, m.contiguous(), t, ps)
            return state, {"pages": pages, "page": page, "n": n,
                           "flag": flag}
        return fn

    seq_f = Field("seq", (), torch.int32)
    n_f = Field("n", (), torch.int32)
    pos_f = Field("pos", (), torch.int32)
    resp = (ListField("pages", max_len=mp, dtype=torch.int32),
            Field("page", (), torch.int32),
            Field("n", (), torch.int32),
            Field("flag", (), torch.int32))
    kw = dict(response=resp)
    return TrustSchema(
        "pagetable",
        ops=[OpSpec("alloc", payload=(seq_f, n_f),
                    writes=("pages", "n", "flag"), serve=serve("alloc", "n"),
                    **kw),
             OpSpec("append", payload=(seq_f, pos_f),
                    writes=("page", "n", "flag"),
                    serve=serve("append", "pos"), **kw),
             OpSpec("free", payload=(seq_f,), writes=("n", "flag"),
                    serve=serve("free", None), **kw),
             OpSpec("lookup", payload=(seq_f,),
                    writes=("pages", "n", "flag"),
                    serve=serve("lookup", None), **kw)],
        state={"used": Field("used", (), torch.int32),
               "chains": Field("chains", (mp,), torch.int32),
               "chain_len": Field("chain_len", (), torch.int32),
               "last_used": Field("last_used", (), torch.int32),
               "clock": Field("clock", (), torch.int32),
               "evictions": Field("evictions", (), torch.int32)},
        route=lambda payload, t_: routing.mod_router(payload["seq"], t_),
        reshard=pagetable_reshard)


# ---------------------------------------------------------------------------
# Sequential oracle (the differential anchor; a copy of the JAX package's)
# ---------------------------------------------------------------------------

class SequentialPageTable:
    """Host-side sequential allocator with IDENTICAL semantics: per-
    trustee state in the same owner-major layout, requests applied one at
    a time in serve order.  Returns GLOBAL page ids like the facade."""

    def __init__(self, n_pages: int, max_seqs: int, page_size: int,
                 max_pages: int, n_trustees: int):
        self.page_size = page_size
        self.max_pages = max_pages
        self.t = n_trustees
        self._load(initial_pagetable_state(n_pages, max_seqs, max_pages,
                                           n_trustees))

    def _load(self, st: Dict[str, np.ndarray]) -> None:
        t, mp = self.t, self.max_pages
        self.used = np.asarray(st["used"]).reshape(t, -1).copy()
        self.chains = np.asarray(st["chains"]).reshape(t, -1, mp).copy()
        self.chain_len = np.asarray(st["chain_len"]).reshape(t, -1).copy()
        self.last_used = np.asarray(st["last_used"]).reshape(t, -1).copy()
        self.clock = np.asarray(st["clock"]).copy()
        self.evictions = np.asarray(st["evictions"]).copy()

    def dump(self) -> Dict[str, np.ndarray]:
        return {"used": self.used.reshape(-1),
                "chains": self.chains.reshape(-1, self.max_pages),
                "chain_len": self.chain_len.reshape(-1),
                "last_used": self.last_used.reshape(-1),
                "clock": self.clock.copy(),
                "evictions": self.evictions.copy()}

    def reshard(self, new_t: int) -> None:
        """Re-lay the oracle out for ``new_t`` trustees with the very
        ``pagetable_reshard`` the failover path runs, so a chaos trace
        stays comparable across a trustee-count change."""
        st = pagetable_reshard(self.dump(), self.t, new_t)
        self.t = new_t
        self._load(st)

    # -- core allocator (mirrors the serve's _evict_alloc exactly) ---------
    def _evict_alloc(self, o: int, seq_l: int, k: int, want: bool) -> bool:
        used, cl = self.used[o], self.chain_len[o]
        lu, chains = self.last_used[o], self.chains[o]
        sl = cl.shape[0]
        elig = (cl > 0) & (np.arange(sl) != seq_l)
        reclaimable = int(np.sum(np.where(elig, cl, 0)))
        free0 = int(np.sum(used == 0))
        do = bool(want) and (free0 + reclaimable >= k) \
            and (int(cl[seq_l]) + k <= self.max_pages)
        if not do:
            return False
        while int(np.sum(used == 0)) < k:
            elig = (cl > 0) & (np.arange(sl) != seq_l)
            key = np.where(elig, lu.astype(np.int64) * sl + np.arange(sl),
                           _I32MAX)
            v = int(np.argmin(key))
            used[chains[v, :cl[v]]] = 0
            chains[v] = -1
            cl[v] = 0
            self.evictions[o] += 1
        pages = np.flatnonzero(used == 0)[:k]
        start = int(cl[seq_l])
        chains[seq_l, start:start + k] = pages.astype(np.int32)
        used[pages] = 1
        cl[seq_l] += k
        return True

    def _touch(self, o: int, seq_l: int) -> None:
        self.last_used[o, seq_l] = self.clock[o]
        self.clock[o] += 1

    def _globalize(self, local: np.ndarray, owner: np.ndarray) -> np.ndarray:
        return np.where(local >= 0, local * self.t
                        + owner.reshape(owner.shape + (1,) * (local.ndim - 1)),
                        -1).astype(np.int32)

    # -- ops (batch in serve order) ---------------------------------------
    def alloc(self, seqs, ns) -> Dict[str, np.ndarray]:
        seqs, ns = np.asarray(seqs), np.asarray(ns)
        r = len(seqs)
        pages = np.full((r, self.max_pages), -1, np.int32)
        n = np.zeros((r,), np.int32)
        flag = np.zeros((r,), np.int32)
        for i, (s, k) in enumerate(zip(seqs, ns)):
            o, sl = int(s) % self.t, int(s) // self.t
            k = int(np.clip(k, 0, self.max_pages))
            did = self._evict_alloc(o, sl, k, k > 0)
            self._touch(o, sl)
            pages[i] = self.chains[o, sl]
            n[i] = self.chain_len[o, sl]
            flag[i] = int(did)
        owner = (seqs % self.t).astype(np.int32)
        return {"pages": self._globalize(pages, owner), "n": n, "flag": flag}

    def append(self, seqs, poss) -> Dict[str, np.ndarray]:
        seqs, poss = np.asarray(seqs), np.asarray(poss)
        r = len(seqs)
        page = np.full((r,), -1, np.int32)
        n = np.zeros((r,), np.int32)
        flag = np.zeros((r,), np.int32)
        for i, (s, p) in enumerate(zip(seqs, poss)):
            o, sl = int(s) % self.t, int(s) // self.t
            page_idx = int(p) // self.page_size
            inrange = 0 <= page_idx < self.max_pages
            k = int(np.clip(page_idx + 1 - self.chain_len[o, sl], 0,
                            self.max_pages))
            did = self._evict_alloc(o, sl, k, inrange and k > 0)
            ok = inrange and (k == 0 or did)
            page[i] = self.chains[o, sl, min(page_idx, self.max_pages - 1)] \
                if ok else -1
            flag[i] = (k if did else 0) if ok else -1
            self._touch(o, sl)
            n[i] = self.chain_len[o, sl]
        owner = (seqs % self.t).astype(np.int32)
        return {"page": self._globalize(page, owner), "n": n, "flag": flag}

    def free(self, seqs) -> Dict[str, np.ndarray]:
        seqs = np.asarray(seqs)
        n = np.zeros((len(seqs),), np.int32)
        for i, s in enumerate(seqs):
            o, sl = int(s) % self.t, int(s) // self.t
            cl = int(self.chain_len[o, sl])
            self.used[o, self.chains[o, sl, :cl]] = 0
            self.chains[o, sl] = -1
            self.chain_len[o, sl] = 0
            self.clock[o] += 1
            n[i] = cl
        return {"n": n, "flag": np.ones((len(seqs),), np.int32)}

    def lookup(self, seqs) -> Dict[str, np.ndarray]:
        seqs = np.asarray(seqs)
        r = len(seqs)
        pages = np.full((r, self.max_pages), -1, np.int32)
        n = np.zeros((r,), np.int32)
        flag = np.zeros((r,), np.int32)
        for i, s in enumerate(seqs):
            o, sl = int(s) % self.t, int(s) // self.t
            self._touch(o, sl)
            pages[i] = self.chains[o, sl]
            n[i] = self.chain_len[o, sl]
            flag[i] = int(self.chain_len[o, sl] > 0)
        owner = (seqs % self.t).astype(np.int32)
        return {"pages": self._globalize(pages, owner), "n": n, "flag": flag}


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

class DelegatedPageTable:
    """High-level page-table facade (sibling of ``DelegatedKVStore``).

    Callers speak GLOBAL ids: sequence ids in ``[0, max_seqs)`` and global
    page ids (``local * T + owner``) directly indexing the shared page
    pool.  ``free`` of a sequence this facade never allocated (or already
    freed) raises ``SchemaError`` naming the op.  Host arguments go to the
    card through pinned memory without a host sync; responses stay on the
    device until ``globalize`` copies them to the host.  The page table
    serves through ``pagetable_serve`` (the kernel for CUDA state, its
    plain version for CPU state) and packs with the Trust's default.
    ``axis`` (default the whole mesh) may name a sub-axis, as JAX's does:
    the table then has one replica per coordinate of the other axes, each
    allocated by its own replica's requests, and ``dump`` / ``audit``
    read replica 0."""

    def __init__(self, mesh: StackedMesh, n_pages: int, max_seqs: int = 64,
                 page_size: int = 16, max_pages: int = 8,
                 axis: Any = None, capacity: Optional[int] = None,
                 local_shortcut: bool = True, mode: str = "shared",
                 n_dedicated: int = 0, name: Optional[str] = None,
                 session=None):
        from ..convert import stacked_from_owner_major
        axis = axis if axis is not None else tuple(mesh.axis_names)
        group = TrusteeGroup(mesh, axis, mode=mode, n_dedicated=n_dedicated)
        t = group.n_trustees
        if max_pages > _ceil_to(n_pages, t) // t:
            raise SchemaError(
                f"max_pages={max_pages} exceeds a trustee's local pool "
                f"({n_pages} pages / {t} trustees); one chain must fit on "
                f"its owner")
        self.n_pages = n_pages
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.max_pages = max_pages
        self.mode = mode
        host0 = initial_pagetable_state(n_pages, max_seqs, max_pages, t)
        state = stacked_from_owner_major(host0, t, device=mesh.device)
        schema_factory = lambda t_: make_pagetable_schema(
            t_, page_size, max_pages)
        self.schema = schema_factory(t)
        self.trust = group.entrust(
            state, schema=self.schema, capacity=capacity,
            local_shortcut=local_shortcut, name=name or "pagetable",
            session=session, schema_factory=schema_factory)
        self.group = group
        self.t = t
        self._known = set()
        self.trust._on_rebuild.append(self._on_trust_rebuild)

    def _on_trust_rebuild(self, trust) -> None:
        """Failover hook: the trust was re-entrusted onto a new group —
        refresh the cached layout.  Page identities changed with the
        re-layout (``pagetable_reshard``); the known sequences stay, since
        sequence ids are stable."""
        self.group = trust.group
        self.mode = trust.group.mode
        self.t = trust.n_trustees
        self.schema = trust.schema
        self.n_pages = int((trust.trustee_state()["used"] != 2).sum())

    @property
    def session(self):
        return self.trust.session

    # -- validation / transfer ---------------------------------------------
    def _check_seqs(self, op: str, seqs) -> np.ndarray:
        s = np.asarray(seqs, np.int64)
        bad = s[(s < 0) | (s >= self.max_seqs)]
        if bad.size:
            raise SchemaError(
                f"op {op!r}: seq_id(s) {sorted(set(int(b) for b in bad))} "
                f"outside [0, {self.max_seqs})")
        return s.astype(np.int32)

    def _dev(self, a) -> torch.Tensor:
        return to_device_async(a, self.trust.device)

    def _note_known(self, seqs) -> None:
        self._known.update(int(s) for s in np.asarray(seqs).reshape(-1))

    def _check_free(self, seqs) -> np.ndarray:
        s = self._check_seqs("free", seqs)
        unknown = sorted({int(x) for x in s} - self._known)
        if unknown:
            raise SchemaError(
                f"op 'free': unknown seq_id(s) {unknown} — never allocated "
                f"by this table (or already freed)")
        self._known.difference_update(int(x) for x in s)
        return s

    def globalize(self, resp: Dict[str, Any], seqs,
                  fields=("pages", "page")) -> Dict[str, np.ndarray]:
        """Copy a response to the host and map its trustee-local page ids
        to global ids (``local * T + owner``; -1 padding passes through)."""
        owner = (np.asarray(seqs, np.int64) % self.t).astype(np.int32)
        out = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v)) for k, v in resp.items()}
        for f in fields:
            if f in out:
                x = out[f]
                ow = owner.reshape(owner.shape + (1,) * (x.ndim - 1))
                out[f] = np.where(x >= 0, x * self.t + ow, -1).astype(np.int32)
        return out

    # -- sync API ----------------------------------------------------------
    def alloc(self, seqs, n_pages) -> Dict[str, np.ndarray]:
        s = self._check_seqs("alloc", seqs)
        self._note_known(s)
        r = self.trust.op.alloc(self._dev(s), self._dev(n_pages))
        return self.globalize(r, s, fields=("pages",))

    def append(self, seqs, positions) -> Dict[str, np.ndarray]:
        s = self._check_seqs("append", seqs)
        self._note_known(s)
        r = self.trust.op.append(self._dev(s), self._dev(positions))
        return self.globalize(r, s, fields=("page",))

    def free(self, seqs) -> Dict[str, np.ndarray]:
        s = self._check_free(seqs)
        r = self.trust.op.free(self._dev(s))
        return self.globalize(r, s, fields=())

    def lookup(self, seqs) -> Dict[str, np.ndarray]:
        s = self._check_seqs("lookup", seqs)
        r = self.trust.op.lookup(self._dev(s))
        return self.globalize(r, s, fields=("pages",))

    # -- async API (session rounds) ----------------------------------------
    def _wrap_then(self, then, seqs, fields):
        if then is None:
            return None
        return lambda resp: then(self.globalize(resp, seqs, fields))

    def alloc_then(self, seqs, n_pages, then=None):
        s = self._check_seqs("alloc", seqs)
        self._note_known(s)
        return self.trust.op.alloc.then(
            self._dev(s), self._dev(n_pages),
            then=self._wrap_then(then, s, ("pages",)))

    def append_then(self, seqs, positions, then=None):
        s = self._check_seqs("append", seqs)
        self._note_known(s)
        return self.trust.op.append.then(
            self._dev(s), self._dev(positions),
            then=self._wrap_then(then, s, ("page",)))

    def free_then(self, seqs, then=None):
        s = self._check_free(seqs)
        return self.trust.op.free.then(self._dev(s), then=then)

    def lookup_then(self, seqs, then=None):
        s = self._check_seqs("lookup", seqs)
        return self.trust.op.lookup.then(
            self._dev(s), then=self._wrap_then(then, s, ("pages",)))

    def flush(self):
        self.trust.flush()

    # -- introspection ------------------------------------------------------
    def client_region(self) -> Dict[str, np.ndarray]:
        """Dedicated mode: every state leaf's rows on the client shards,
        owner-major (empty in shared mode); they must stay zero."""
        n_cli = self.group.n_clients if self.mode == "dedicated" else 0
        return {k: v[:n_cli].cpu().numpy().reshape((-1,)
                                                   + tuple(v.shape[2:]))
                for k, v in self.trust.state().items()}

    def dump(self) -> Dict[str, np.ndarray]:
        """Trustee state, owner-major (the JAX layout), on the host: a
        copy, never a view of the live state."""
        from ..convert import owner_major_from_stacked
        return owner_major_from_stacked(self.trust.trustee_state())

    def audit(self) -> Dict[str, Any]:
        """Alloc/free conservation: every ``used == 1`` page is chained by
        exactly one sequence and chains reference only allocated pages."""
        st = self.dump()
        t = self.t
        used = st["used"].reshape(t, -1)
        chains = st["chains"].reshape(t, -1, self.max_pages)
        cl = st["chain_len"].reshape(t, -1)
        allocated = int(np.sum(used == 1))
        chained = int(np.sum(cl))
        ok = allocated == chained
        for o in range(t):
            pages = [int(p) for s in range(cl.shape[1])
                     for p in chains[o, s, :cl[o, s]]]
            ok &= len(pages) == len(set(pages))
            ok &= all(used[o, p] == 1 for p in pages)
            ok &= bool(np.all(chains[o][np.arange(self.max_pages)[None, :]
                                        >= cl[o][:, None]] == -1))
        return {"allocated": allocated, "chained": chained,
                "leaked": allocated - chained,
                "free": int(np.sum(used == 0)),
                "phantom": int(np.sum(used == 2)),
                "evictions": int(st["evictions"].sum()),
                "consistent": bool(ok)}
