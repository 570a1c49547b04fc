"""Plain PyTorch versions of the main path's kernels.

Each function here computes exactly what its CUDA kernel computes, on any
device, and is what the kernel wrappers run for CPU tensors.  The tests
hold these against the JAX package; ``chip_smoke.py`` holds each CUDA
kernel against them on the card.

All serve functions take STACKED trustee tensors — a leading ``T`` shard
dimension — and update ``table`` / ``resp`` in place, as the kernels do.
Row arrays (``keys``, ``lane``, ``value``, ``expect``, ``flag``) are in
request coordinates; ``order`` / ``sid`` / ``seg_end`` are the per-shard
grouping in sorted coordinates (``channel.Grouping``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

LANE_GET, LANE_PUT, LANE_ADD, LANE_CAS = 0, 1, 2, 3


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard row gather: ``x`` (B, N, ...), ``idx`` (B, M) ->
    (B, M, ...) with ``out[b, m] = x[b, idx[b, m]]``."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx.long()]


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------

def delegation_pack(dst: torch.Tensor, payload: torch.Tensor, n_trustees: int,
                    capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bin rows by destination with per-destination capacity, FIFO within
    each destination (``repro.kernels.ref.delegation_pack``).

    dst: (R,) int32 in [-1, T); payload: (R, W) of any dtype — or both with
    one extra leading shard dimension.  Returns (slots (T*C, W),
    counts (T,) clamped at C, request_slot (R,) with -1 for inactive or
    over-capacity rows)."""
    squeeze = dst.dim() == 1
    if squeeze:
        dst, payload = dst[None], payload[None]
    t, c = n_trustees, capacity
    b, r = dst.shape
    dev = dst.device
    key = torch.where(dst < 0, torch.full_like(dst, t), dst).to(torch.int32)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    grid = torch.arange(t + 1, dtype=torch.int32, device=dev).expand(b, t + 1)
    starts = torch.searchsorted(key_s, grid.contiguous()).to(torch.int32)
    pos_s = torch.arange(r, dtype=torch.int32, device=dev) \
        - starts.gather(-1, key_s.long())
    ok = (key_s < t) & (pos_s < c)
    rows = key_s * c + torch.clamp(pos_s, max=c - 1)
    idx = torch.where(ok, rows, torch.full_like(rows, t * c))
    slots = torch.zeros((b, t * c + 1) + tuple(payload.shape[2:]),
                        dtype=payload.dtype, device=dev)
    slots[torch.arange(b, device=dev)[:, None], idx.long()] = \
        take_rows(payload, order)
    slots = slots[:, :t * c]
    counts = torch.clamp(starts[:, 1:] - starts[:, :-1], max=c)
    request_slot = torch.empty_like(key).scatter_(
        -1, order, torch.where(ok, rows, torch.full_like(rows, -1)))
    if squeeze:
        return slots[0], counts[0], request_slot[0]
    return slots, counts, request_slot


def pack_stacked(dst: torch.Tensor, words: torch.Tensor, n_trustees: int,
                 capacity: int, capacity2: int = 0):
    """The pack kernel's function over every client shard at once.

    dst (D, R) int32, words (D, R, W) int32.  A row's FIFO rank r within
    its destination t places it in the primary block at slot t*C + r when
    r < C, in the second_round block at t*C2 + (r - C) when
    C <= r < C + C2, and nowhere otherwise — the same placement as the
    JAX channel's rerun of the pack on the rows the primary block
    rejected.  Returns (slots (D, T*C, W), slots2 (D, T*C2, W),
    counts (D, T), counts2 (D, T), request_slot (D, R) in [0, T*C + T*C2)
    or -1, totals (D, T) — the pre-capacity demand)."""
    t, c, c2 = n_trustees, capacity, capacity2
    d, r = dst.shape
    w = words.shape[-1]
    cc = c + c2
    slots_all, _, req_all = delegation_pack(dst, words, t, cc)
    blocks = slots_all.reshape(d, t, cc, w)
    slots = blocks[:, :, :c].reshape(d, t * c, w)
    slots2 = blocks[:, :, c:].reshape(d, t * c2, w)
    dest, rank = torch.div(req_all, cc, rounding_mode="floor"), req_all % cc
    request_slot = torch.where(
        req_all < 0, req_all,
        torch.where(rank < c, dest * c + rank, t * c + dest * c2 + rank - c))
    active = dst >= 0
    totals = torch.zeros((d, t + 1), dtype=torch.int32, device=dst.device) \
        .scatter_add_(1, torch.where(active, dst, t).long(),
                      torch.ones_like(dst))[:, :t]
    counts = torch.clamp(totals, max=c)
    counts2 = torch.clamp(totals - c, min=0, max=c2)
    return slots, slots2, counts, counts2, request_slot, totals


# ---------------------------------------------------------------------------
# trustee serve (the three serve kernels)
# ---------------------------------------------------------------------------

def gather(table: torch.Tensor, keys: torch.Tensor, lane: torch.Tensor,
           which: int, out: torch.Tensor,
           expect: Optional[torch.Tensor] = None,
           flag: Optional[torch.Tensor] = None) -> None:
    """Rows of lane ``which`` read their table line into ``out``; with
    ``expect`` (the CAS lane) they also set ``flag = all(cur == expect)``.
    Rows of other lanes are left untouched.  table (T, K, W); keys, lane
    (T, N) int32; out, expect (T, N, W); flag (T, N) int32."""
    k = table.shape[1]
    m = lane == which
    cur = take_rows(table, torch.clamp(keys, 0, k - 1))
    out[m] = cur[m]
    if expect is not None:
        flag[m] = torch.all(cur == expect, dim=-1)[m].to(flag.dtype)


def scatter_last(table: torch.Tensor, keys: torch.Tensor,
                 order: torch.Tensor, seg_end: torch.Tensor,
                 flag: torch.Tensor, value: torch.Tensor) -> None:
    """Last-writer-wins commit: in every segment, the flagged row with the
    greatest sorted position (the last in request order) writes its whole
    value row into its key's table line.  ``seg_end[p]`` is one past the
    last sorted position of p's segment, so ``seg_end - 1`` names the
    segment.  One lane per call, so each key has at most one winner."""
    t, n = keys.shape
    pos = torch.arange(n, dtype=torch.int32, device=keys.device).expand(t, n)
    flagged = take_rows(flag[..., None], order)[..., 0] != 0
    seg = seg_end.long() - 1
    last = torch.full((t, n), -1, dtype=torch.int32, device=keys.device) \
        .scatter_reduce_(1, seg,
                         torch.where(flagged, pos, torch.full_like(pos, -1)),
                         "amax")
    ti, pi = torch.nonzero(flagged & (torch.gather(last, 1, seg) == pos),
                           as_tuple=True)
    rows = order[ti, pi].long()
    table[ti, keys[ti, rows].long()] = value[ti, rows]


def segmented_add(table: torch.Tensor, keys: torch.Tensor, lane: torch.Tensor,
                  order: torch.Tensor, sid: torch.Tensor,
                  seg_end: torch.Tensor, value: torch.Tensor,
                  resp: torch.Tensor) -> None:
    """Fetch-and-add over the sorted segments: every ADD row adds its
    segment-exclusive prefix of deltas (its prior) to ``resp`` — which
    holds the ADD base read after the PUT commit — and each segment's last
    row adds the segment total to its table line."""
    t, n = keys.shape
    is_add = take_rows(lane[..., None], order)[..., 0] == LANE_ADD
    vs = take_rows(value, order)
    delta = torch.where(is_add[..., None], vs, torch.zeros_like(vs))
    incl = torch.cumsum(delta, dim=1)
    excl = incl - delta
    prior = excl - take_rows(excl, sid)
    ti, pi = torch.nonzero(is_add, as_tuple=True)
    rows = order[ti, pi].long()
    resp[ti, rows] += prior[ti, pi]
    pos = torch.arange(n, device=keys.device)
    lt, lp = torch.nonzero(is_add & (seg_end.long() - 1 == pos),
                           as_tuple=True)
    lrows = order[lt, lp].long()
    table[lt, keys[lt, lrows].long()] += prior[lt, lp] + delta[lt, lp]


# ---------------------------------------------------------------------------
# page-table serve (the trustee's serial application of one op pass)
# ---------------------------------------------------------------------------

PT_ALLOC, PT_APPEND, PT_FREE, PT_LOOKUP = 0, 1, 2, 3
PT_OPS = {"alloc": PT_ALLOC, "append": PT_APPEND, "free": PT_FREE,
          "lookup": PT_LOOKUP}
_I32MAX = 2 ** 31 - 1


def _evict_alloc(used, chains, cl, lu, ev, seq_l, k, want):
    """Batched over the T trustees: evict LRU victims until ``k`` local
    pages are free, then chain the ``k`` lowest-numbered free pages onto
    ``seq_l``.  All-or-nothing per trustee.  Returns the commit mask (T,)."""
    t, sl = cl.shape
    mp = chains.shape[2]
    dev = cl.device
    tix = torch.arange(t, device=dev)
    sidx = torch.arange(sl, device=dev)
    elig = (cl > 0) & (sidx[None] != seq_l[:, None])
    reclaimable = torch.where(elig, cl, 0).sum(1)
    free0 = (used == 0).sum(1)
    do = want & (free0 + reclaimable >= k) & (cl[tix, seq_l] + k <= mp)
    while True:
        # a trustee with no victim left stops (unreachable on a consistent
        # state: admission counted the reclaimable pages)
        elig = (cl > 0) & (sidx[None] != seq_l[:, None])
        need = do & ((used == 0).sum(1) < k) & elig.any(1)
        if not bool(need.any()):
            break
        key = torch.where(elig, lu.long() * sl + sidx[None], _I32MAX)
        v = key.argmin(1)
        tn, vn = tix[need], v[need]
        vchain = chains[tn, vn]
        vmask = torch.arange(mp, device=dev)[None] < cl[tn, vn][:, None]
        used[tn[:, None].expand_as(vchain)[vmask], vchain[vmask].long()] = 0
        chains[tn, vn] = -1
        cl[tn, vn] = 0
        ev[tn, 0] += 1
    free = used == 0
    rank = torch.cumsum(free.to(torch.int32), 1)
    take = do[:, None] & free & (rank <= k[:, None])
    tt, pp = take.nonzero(as_tuple=True)
    chains[tt, seq_l[tt], (cl[tt, seq_l[tt]] + rank[tt, pp] - 1).long()] \
        = pp.to(torch.int32)
    used[take] = 1
    cl[tix, seq_l] += torch.where(do, k, 0).to(torch.int32)
    return do


def pagetable_serve(op: int, used: torch.Tensor, chains: torch.Tensor,
                    chain_len: torch.Tensor, last_used: torch.Tensor,
                    clock: torch.Tensor, evictions: torch.Tensor,
                    seq: torch.Tensor, arg: torch.Tensor, valid: torch.Tensor,
                    n_trustees: int, page_size: int):
    """One op pass of the delegated page table over every trustee, rows in
    serve order (``repro.core.pagetable.make_pagetable_schema``'s
    ``lax.scan`` per op, with its eviction ``while_loop``).

    State (stacked, int32, updated IN PLACE): used (T, PL), chains
    (T, SL, MP), chain_len / last_used (T, SL), clock / evictions (T, 1).
    Rows: seq (T, N) global sequence ids, arg (T, N) the page count of
    ``alloc`` or the token position of ``append`` (ignored otherwise),
    valid (T, N) bool.  ``op`` is one of PT_ALLOC, PT_APPEND, PT_FREE,
    PT_LOOKUP.  Returns (pages (T, N, MP), page (T, N), n (T, N),
    flag (T, N)), int32, with trustee-LOCAL page ids and zeros on rows
    that are not valid.

    Masked rows are no-ops, so the loop runs over each trustee's valid
    rows (compacted in serve order) only, every step batched over the T
    trustees."""
    t, n = seq.shape
    mp = chains.shape[2]
    sl = chain_len.shape[1]
    dev = seq.device
    i32 = dict(dtype=torch.int32, device=dev)
    pages = torch.zeros((t, n, mp), **i32)
    page = torch.zeros((t, n), **i32)
    n_out = torch.zeros((t, n), **i32)
    flag = torch.zeros((t, n), **i32)
    counts = valid.sum(1)
    order = torch.sort((~valid).to(torch.int8), dim=1, stable=True).indices
    steps = int(counts.max()) if n else 0
    tix = torch.arange(t, device=dev)
    minus1 = torch.full((mp,), -1, **i32)
    for j in range(steps):
        live = counts > j
        row = order[:, j]
        seq_g = seq[tix, row]
        a = arg[tix, row]
        seq_l = torch.clamp(torch.div(seq_g, n_trustees,
                                      rounding_mode="floor"), 0, sl - 1).long()
        lt, lr, ls = tix[live], row[live], seq_l[live]
        if op == PT_FREE:
            cl_s = chain_len[tix, seq_l]
            vmask = (torch.arange(mp, device=dev)[None] < cl_s[:, None]) \
                & live[:, None]
            ch = chains[tix, seq_l]
            used[tix[:, None].expand_as(ch)[vmask], ch[vmask].long()] = 0
            chains[lt, ls] = -1
            chain_len[lt, ls] = 0
            clock[:, 0] += live.to(torch.int32)
            n_out[lt, lr] = cl_s[live]
            flag[lt, lr] = 1
            continue
        if op == PT_ALLOC:
            k = torch.clamp(a, 0, mp)
            did = _evict_alloc(used, chains, chain_len, last_used, evictions,
                               seq_l, k, live & (k > 0))
        elif op == PT_APPEND:
            page_idx = torch.div(a, page_size, rounding_mode="floor")
            inrange = (page_idx >= 0) & (page_idx < mp)
            k = torch.clamp(page_idx + 1 - chain_len[tix, seq_l], 0, mp)
            did = _evict_alloc(used, chains, chain_len, last_used, evictions,
                               seq_l, k, live & inrange & (k > 0))
            ok = live & inrange & ((k == 0) | did)
            pg = torch.where(ok, chains[tix, seq_l, torch.clamp(
                page_idx, 0, mp - 1).long()], -1)
            fl = torch.where(ok, torch.where(did, k, 0), -1)
        # _touch: stamp the clock, then advance it
        last_used[lt, ls] = clock[lt, 0]
        clock[:, 0] += live.to(torch.int32)
        n_out[lt, lr] = chain_len[lt, ls]
        if op == PT_ALLOC:
            pages[lt, lr] = chains[lt, ls]
            page[lt, lr] = -1
            flag[lt, lr] = did[live].to(torch.int32)
        elif op == PT_APPEND:
            pages[lt, lr] = minus1
            page[lt, lr] = pg[live].to(torch.int32)
            flag[lt, lr] = fl[live].to(torch.int32)
        else:
            pages[lt, lr] = chains[lt, ls]
            page[lt, lr] = -1
            flag[lt, lr] = (chain_len[lt, ls] > 0).to(torch.int32)
    return pages, page, n_out, flag


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse decode attention over a paged KV pool
    (``repro.kernels.ref.paged_attention``).

    q (B, Hq, D), one query token per sequence; k_pages / v_pages
    (P, Hkv, PS, D); page_table (B, MP) global page ids, -1 padded, ids
    clipped into [0, P); lengths (B,) live positions (>= 1).  f32 math,
    output in q's dtype -> (B, Hq, D)."""
    b, hq, d = q.shape
    p, hkv, ps, _ = k_pages.shape
    mp = page_table.shape[1]
    rep = hq // hkv
    safe = torch.clamp(page_table.long(), 0, p - 1)
    k = k_pages[safe].transpose(1, 2).reshape(b, hkv, mp * ps, d)
    v = v_pages[safe].transpose(1, 2).reshape(b, hkv, mp * ps, d)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else 1.0 / float(d) ** 0.5
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * scale
    pos = torch.arange(mp * ps, device=q.device)
    s = torch.where(pos[None, None, :] < lengths.to(q.device)[:, None, None],
                    s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", w, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# grouped matmul — the trustee's expert FFN over slotted token groups
# ---------------------------------------------------------------------------

def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, F) -> (E, C, F), one matmul per expert
    (``repro.kernels.ref.grouped_matmul``): the operands' products and
    sums in f32 — bf16 values are exact in f32, so this is the bf16
    product with an f32 accumulator — and the result in x's dtype.

    ``counts`` (E,) int32, when given, is each expert's filled rows (the
    pack's counts): x's rows at and past ``counts[e]`` are zero (the pack
    zero-fills them), and so are the result's rows there.  It is a hint,
    not a new function: with it or without, zero rows give zero rows."""
    y = torch.bmm(x.float(), w.float())
    if counts is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        y = torch.where((rows[None, :] < counts.to(x.device)[:, None])
                        [..., None], y, torch.zeros_like(y))
    return y.to(x.dtype)


def moe_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, act: str = "silu",
            gmm=grouped_matmul,
            counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gated expert FFN on slotted tokens, (E, C, D) -> (E, C, D)
    (``repro.kernels.ref.moe_ffn``): the gate's activation in f32, times
    the up projection in f32, rounded to x's dtype before the down
    projection.  ``gmm`` computes the three grouped matmuls (the MoE
    layer passes the kernel's wrapper), each given ``counts`` (see
    ``grouped_matmul``: silu(0) * 0 = gelu(0) * 0 = 0, so the down
    projection's input is zero past the counts too)."""
    g = gmm(x, w_gate, counts)
    u = gmm(x, w_up, counts)
    gf = g.float()
    a = torch.nn.functional.silu(gf) if act == "silu" else \
        torch.nn.functional.gelu(gf, approximate="tanh")
    return gmm((a * u.float()).to(x.dtype), w_down, counts)


# ---------------------------------------------------------------------------
# flash attention (prefill) and the partial-softmax merge of decode
# ---------------------------------------------------------------------------

def _gqa_logits(q, k, causal, scale, q_offset):
    """f32 scores (B, Hq, Sq, Skv) of q (B, Hq, Sq, D) against k
    (B, Hkv, Skv, D), query head h reading KV head h // (Hq / Hkv); masked
    entries NEG_INF."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / float(d) ** 0.5
    qg = q.float().reshape(b, hkv, rep, sq, d)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    s = s.reshape(b, hq, sq, skv)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(skv, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def _gqa_pv(p, v):
    """(B, Hq, Sq, Skv) weights x v (B, Hkv, Skv, D) -> f32 (B, Hq, Sq, D)."""
    b, hq, sq, skv = p.shape
    hkv = v.shape[1]
    pg = p.reshape(b, hkv, hq // hkv, sq, skv)
    return torch.einsum("bgrqk,bgkd->bgrqd", pg, v.float()).reshape(
        b, hq, sq, v.shape[-1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal (or full) GQA attention (``repro.kernels.ref.flash_attention``).

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D), Hq a multiple of Hkv; scale
    1/sqrt(D) unless given; query i sits at position ``q_offset + i`` and
    sees keys j <= that position when ``causal``.  f32 math, output in
    q's dtype -> (B, Hq, Sq, D)."""
    s = _gqa_logits(q, k, causal, scale, q_offset)
    return _gqa_pv(torch.softmax(s, dim=-1), v).to(q.dtype)


def flash_attention_stats(q, k, v, causal: bool = True,
                          scale: Optional[float] = None, q_offset: int = 0):
    """The partial-softmax form (``ref.flash_attention_stats``): returns
    f32 (o unnormalised (B, Hq, Sq, D), m (B, Hq, Sq), l (B, Hq, Sq)) for a
    merge across shards of the key sequence."""
    s = _gqa_logits(q, k, causal, scale, q_offset)
    m = s.max(dim=-1).values
    p = torch.exp(s - m[..., None])
    return _gqa_pv(p, v), m, p.sum(dim=-1)


def merge_attention_stats(os, ms, ls):
    """Merge per-shard partials stacked along a leading shard axis
    (``ref.merge_attention_stats``) -> (o normalised, m, l)."""
    m = ms.max(dim=0).values
    w = torch.exp(ms - m[None])
    l = (ls * w).sum(dim=0)
    o = (os * w[..., None]).sum(dim=0)
    return o / torch.clamp(l[..., None], min=1e-30), m, l


# ---------------------------------------------------------------------------
# selective scan — the Mamba-1 recurrence
# ---------------------------------------------------------------------------

# time steps whose exp(dt * a) and dt * b * x the sequential scan makes in
# one pass: (B, 16, DI, N) f32 temporaries, 33.5 MB at falcon-mamba-7b's
# prefill (B 4, DI 8192, N 16), where the whole sequence would be 4.3 GB
SCAN_BLOCK = 16


def _decay(dtf: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """exp(dt * a) in f32: the product in f32, as JAX forms it, its exp
    taken in f64 and rounded.  On the CPU torch's f32 exp is MKL VML's,
    which on a newly started intra-op thread has been seen to return one
    thread's share of a call good to only ~13 bits (1.5e-4 relative); an
    f64 exp rounded to f32 is good to the f32 rounding either way."""
    return torch.exp((dtf * a).double()).float()


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential scan (``repro.kernels.ref.selective_scan``).

    x, dt: (B, S, DI); a: (DI, N); b, c: (B, S, N); d: (DI,); h0:
    (B, DI, N) or None (zeros).  In f32, step by step:
    h_t = exp(dt_t * a) * h_{t-1} + dt_t * b_t * x_t;
    y_t = c_t . h_t + d * x_t.  Returns (y (B, S, DI) in x's dtype,
    h_final (B, DI, N) f32).  The associative form of JAX's "ref" path
    computes the same function up to f32 rounding.  Differentiable: under
    autograd, with an input that requires grad, each step's state is a
    new tensor (the same products and sums, in the same order) in place
    of a write into the block's buffer."""
    bsz, s, di = x.shape
    n = a.shape[1]
    grad = torch.is_grad_enabled() and any(
        v is not None and v.requires_grad for v in (x, dt, a, b, c, d, h0))
    a, d = a.float(), d.float()
    h = torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=x.device)
    for t0 in range(0, s, SCAN_BLOCK):
        t1 = min(t0 + SCAN_BLOCK, s)
        dtf = dt[:, t0:t1].float()[..., None]                 # (B, L, DI, 1)
        da = _decay(dtf, a)                                   # (B, L, DI, N)
        dbx = dtf * b[:, t0:t1, None, :].float() \
            * x[:, t0:t1, :, None].float()
        if grad:
            steps = []
            for j in range(t1 - t0):
                h = da[:, j] * h + dbx[:, j]
                steps.append(h)
            hs = torch.stack(steps, 1)
        else:
            hs = torch.empty_like(da)
            for j in range(t1 - t0):
                torch.mul(da[:, j], h, out=hs[:, j])
                hs[:, j] += dbx[:, j]
                h = hs[:, j]
        y[:, t0:t1] = torch.einsum("bldn,bln->bld", hs,
                                   c[:, t0:t1].float())
    y += d * x.float()
    return y.to(x.dtype), h.clone()


def selective_scan_step(x, dt, a, b, c, d, h):
    """One decode step: x, dt (B, DI); b, c (B, N); h (B, DI, N) ->
    (y (B, DI) in x's dtype, the new state (B, DI, N) f32)."""
    xf, dtf = x.float(), dt.float()[..., None]
    da = _decay(dtf, a.float())
    dbx = dtf * b.float()[:, None, :] * xf[..., None]
    h = da * h.float() + dbx
    y = torch.einsum("bdn,bn->bd", h, c.float()) + d.float() * xf
    return y.to(x.dtype), h
