"""Cases of the KV serve kernels that chip_smoke.py and the GPU tests
share."""
from __future__ import annotations

import numpy as np
import torch


def far_winner_flags(order: torch.Tensor, tile: int) -> torch.Tensor:
    """Request-order int32 flags for a grouping whose shards each hold one
    segment of every row, flagged at sorted positions chosen so that the
    winner lies tiles before its segment's end (``tile`` sorted rows a
    kernel block).  Shard s takes pattern s % 4:
      0: rows 3, tile + tile // 2, 2 * tile + 52 — the last of them wins
         and its block reads forward to the end of the shard;
      1: rows tile - 1 (a tile's last row) and 5 * tile — the first reads
         forward four tiles to the second, which wins;
      2: nothing flagged — no row wins;
      3: the shard's last row alone."""
    t, n = order.shape
    if n < 6 * tile:
        raise ValueError(f"far_winner_flags: N {n} < 6 tiles of {tile}")
    patterns = ([3, tile + tile // 2, 2 * tile + 52], [tile - 1, 5 * tile], [],
                [n - 1])
    flag = torch.zeros((t, n), dtype=torch.int32, device=order.device)
    for s in range(t):
        pos = torch.tensor(patterns[s % 4], dtype=torch.long,
                           device=order.device)
        flag[s, order[s, pos].long()] = 1
    return flag


# the fill of ``out`` and ``flag`` before a gather: a row the gather must
# not touch keeps it
GATHER_FILL, GATHER_FLAG_FILL = -7.0, -7


def gather_case(device, t, n, k, w, seed, mix=(0.4, 0.2, 0.2, 0.2),
                inactive=0.1, outside=0.0, misalign=False):
    """One shard set of gather inputs: lanes drawn from ``mix`` (GET, PUT,
    ADD, CAS), an ``inactive`` share on lane -1 with the sentinel key K;
    an ``outside`` share of the lane rows keyed -1 or K (read clamped);
    integer-valued table lines; CAS expect rows half the live line, half
    another row.  ``misalign`` puts ``out`` 4 bytes off 16-byte alignment
    (the word-by-word moves)."""
    rng = np.random.default_rng(seed)
    lane = rng.choice(4, size=(t, n), p=mix)
    lane = np.where(rng.random((t, n)) < inactive, -1, lane)
    keys = rng.integers(0, k, (t, n))
    off = (lane >= 0) & (rng.random((t, n)) < outside)
    keys = np.where(off, np.where(rng.random((t, n)) < 0.5, -1, k), keys)
    keys = np.where(lane >= 0, keys, k)
    table = rng.integers(0, 8, (t, k, w)).astype(np.float32)
    other = rng.integers(0, 8, (t, n, w)).astype(np.float32)
    live = table[np.arange(t)[:, None], np.clip(keys, 0, k - 1)]
    expect = np.where(rng.random((t, n, 1)) < 0.5, live, other)
    T = lambda a, dt: torch.as_tensor(a.astype(dt), device=device)
    return dict(table=T(table, np.float32), keys=T(keys, np.int32),
                lane=T(lane, np.int32), expect=T(expect, np.float32),
                misalign=misalign)


def run_gather(case, impl):
    """The serve's three gathers on one case, in its order — GET, the ADD
    base, the CAS current with expect and flag — into ``out`` and ``flag``
    filled with GATHER_FILL / GATHER_FLAG_FILL first.  Returns (out,
    flag)."""
    from ..kernels import ops as kops
    table, keys, lane = case["table"], case["keys"], case["lane"]
    t, n = keys.shape
    w = table.shape[-1]
    dev = table.device
    off = 1 if case["misalign"] else 0
    out = torch.full((t * n * w + off,), GATHER_FILL, device=dev)[off:] \
        .view(t, n, w)
    flag = torch.full((t, n), GATHER_FLAG_FILL, dtype=torch.int32,
                      device=dev)
    kops.gather(table, keys, lane, 0, out, impl=impl)
    kops.gather(table, keys, lane, 2, out, impl=impl)
    kops.gather(table, keys, lane, 3, out, expect=case["expect"], flag=flag,
                impl=impl)
    return out, flag


def gather_edge_cases():
    """(label, ``gather_case`` keywords) at the edges of the gather
    kernel's plan (``kernels.delegation_serve.gather_plan``)."""
    from ..kernels.delegation_serve import gather_plan
    per = gather_plan(1, 307_200, 4, 4)["rows_a_block"]
    m = 307_200 // per
    return [
        ("lane keys -1 and K read the clamped line",
         dict(t=8, n=5000, k=999, w=4, seed=41, outside=0.3)),
        ("N one past a multiple of the plan's rows a block",
         dict(t=1, n=m * per + 1, k=4096, w=4, seed=42)),
        ("N one short of a multiple of the plan's rows a block",
         dict(t=1, n=m * per - 1, k=4096, w=4, seed=43)),
        ("every row GET: ADD and CAS lanes without rows",
         dict(t=8, n=3000, k=999, w=4, seed=44, mix=(1.0, 0.0, 0.0, 0.0),
              inactive=0.0)),
        ("every row CAS", dict(t=8, n=3000, k=999, w=4, seed=45,
                               mix=(0.0, 0.0, 0.0, 1.0), inactive=0.0)),
        ("W 3, word moves", dict(t=8, n=5037, k=999, w=3, seed=46,
                                 outside=0.05)),
        ("out 4 bytes off 16-byte alignment",
         dict(t=8, n=5037, k=999, w=4, seed=47, misalign=True)),
        ("W 32, the widest row a thread moves",
         dict(t=4, n=2000, k=300, w=32, seed=48, outside=0.05)),
        ("rows of 1100 words, a warp a row",
         dict(t=2, n=1500, k=64, w=1100, seed=49, outside=0.05)),
        ("rows of 33 words, a warp a row, word moves",
         dict(t=2, n=1500, k=64, w=33, seed=50, misalign=True)),
    ]


def gather_contract(case, out, flag):
    """What a gather result owes its contract, beside equality with the
    plain version: (lane rows keyed outside [0, K) that read their clamped
    line, rows of no read lane that kept ``out``'s fill, rows of no CAS
    lane that kept ``flag``'s fill) — each a bool — and the number of lane
    rows keyed outside."""
    table, keys, lane = case["table"], case["keys"], case["lane"]
    k = table.shape[1]
    read = (lane == 0) | (lane == 2) | (lane == 3)
    off = read & ((keys < 0) | (keys >= k))
    line = torch.take_along_dim(
        table, keys.clamp(0, k - 1).long()[..., None], dim=1)
    clamped = bool(torch.equal(out[off], line[off]))
    kept = bool((out[~read] == GATHER_FILL).all())
    kept_flag = bool((flag[lane != 3] == GATHER_FLAG_FILL).all())
    return clamped, kept, kept_flag, int(off.sum())


def virtual_bin_pack_case(device, d, r, t, lanes, c, c2, w, seed,
                          hot_lane=0, empty_lane=None, inactive=0.1):
    """Pack inputs at a multiplexed round's virtual bins ``trustee * lanes
    + lane``: half of every client's rows on lane ``hot_lane`` of trustee
    0 (past C + C2, so rows drop), none on lane ``empty_lane``, an
    ``inactive`` share at -1, int32 words above 2^24.  Returns (dst, words,
    bins, C, C2) in ``delegation_pack``'s argument order."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, t, (d, r))
    lane = rng.integers(0, lanes, (d, r))
    if empty_lane is not None:
        lane = np.where(lane == empty_lane, (empty_lane + 1) % lanes, lane)
    hot = rng.random((d, r)) < 0.5
    dst, lane = np.where(hot, 0, dst), np.where(hot, hot_lane, lane)
    bins = np.where(rng.random((d, r)) < inactive, -1, dst * lanes + lane)
    words = rng.integers(-2 ** 31, 2 ** 31 - 1, (d, r, w), dtype=np.int64)
    return (torch.as_tensor(bins.astype(np.int32), device=device),
            torch.as_tensor(words.astype(np.int32), device=device),
            t * lanes, c, c2)


def lane_serve_case(device, t, n_lanes, c1, c2, k, w, seed, tid=0,
                    mix=(0.4, 0.2, 0.2, 0.2), n_local=0, hot=0.07):
    """The serve kernels' inputs on lane ``tid``'s sub-buffer, as the
    strided multiplexed serve forms it: a received buffer of the lane
    layout (T trustees x T client blocks x ``n_lanes`` lanes of ``c1``
    rows, then of ``c2`` rows, then ``n_local`` local rows), each block
    filled up to a random count; ``channel.lane_rows`` takes the lane's
    rows (contiguous), which are then grouped by (op lane, key) as the
    serve groups them.  Integer-valued payloads; a ``hot`` share of the
    rows on key 0.  Returns the ``serve_case`` dict of chip_smoke.py plus
    ``base`` (the response rows before an ADD)."""
    from ..core.channel import lane_rows, make_grouping
    rng = np.random.default_rng(seed)

    def blocks(c):
        cnt = rng.integers(0, c + 1, (t, t, n_lanes, 1))
        return (np.arange(c) < cnt).reshape(t, t * n_lanes * c)

    valid = np.concatenate([blocks(c1)] + ([blocks(c2)] if c2 else [])
                           + [rng.random((t, n_local)) < 0.5], 1)
    n = valid.shape[1]
    lane = np.where(valid, rng.choice(4, size=(t, n), p=mix), -1)
    keys = np.where(rng.random((t, n)) < hot, 0, rng.integers(0, k, (t, n)))
    keys = np.where(lane >= 0, keys, k)
    table = rng.integers(0, 8, (t, k, w)).astype(np.float32)
    value = rng.integers(0, 8, (t, n, w)).astype(np.float32)
    live = table[np.arange(t)[:, None], np.minimum(keys, k - 1)]
    expect = np.where(rng.random((t, n, 1)) < 0.5, live, value)
    base = rng.integers(0, 8, (t, n, w)).astype(np.float32)

    def sub(a, dt):
        return lane_rows(torch.as_tensor(a.astype(dt), device=device), tid,
                         n_lanes, t, c1, c2)

    lane_t, keys_t = sub(lane, np.int32), sub(keys, np.int32)
    g = make_grouping(torch.where(lane_t >= 0, lane_t * k + keys_t, 4 * k))
    return dict(table=torch.as_tensor(table, device=device), keys=keys_t,
                lane=lane_t, value=sub(value, np.float32),
                expect=sub(expect, np.float32), base=sub(base, np.float32),
                order=g.order.contiguous(), sid=g.seg_start.contiguous(),
                seg_end=g.seg_end.contiguous())


def dedicated_pack_case(device, d, n_clients, r, lanes, c, w, seed,
                        hot=0.5, inactive=0.1):
    """Pack inputs of a dedicated round, as ``channel._to_device_slots``
    gives them: D shards of which the first ``n_clients`` originate rows,
    bound for the trustee shard slots ``n_clients .. D - 1`` (x ``lanes``
    virtual bins each); the trustee shards' rows are all -1.  A ``hot``
    share goes to the first trustee's lane 0, past ``c`` (the defer: no
    second block, those rows are flagged).  Int32 words above 2^24.
    Returns (dst, words, bins, C, 0) in ``delegation_pack``'s argument
    order."""
    rng = np.random.default_rng(seed)
    t = d - n_clients
    dst = n_clients + rng.integers(0, t, (d, r))
    lane = rng.integers(0, lanes, (d, r))
    hot_m = rng.random((d, r)) < hot
    dst, lane = np.where(hot_m, n_clients, dst), np.where(hot_m, 0, lane)
    bins = dst * lanes + lane
    bins = np.where(rng.random((d, r)) < inactive, -1, bins)
    bins[n_clients:] = -1
    words = rng.integers(-2 ** 31, 2 ** 31 - 1, (d, r, w), dtype=np.int64)
    return (torch.as_tensor(bins.astype(np.int32), device=device),
            torch.as_tensor(words.astype(np.int32), device=device),
            d * lanes, c, 0)


def zero_region_serve_case(device, d, n_clients, c, k, w, seed,
                           mix=(0.4, 0.2, 0.2, 0.2), hot=0.07):
    """The serve kernels' inputs on a dedicated round's received rows:
    (D, D * c) blocks, each filled to a random count on the trustee
    shards and empty on the first ``n_clients`` shards, whose table
    slices are zeros (the client region).  Integer-valued payloads,
    grouped by (op lane, key) as the serve groups them.  Returns the
    ``serve_case`` dict of chip_smoke.py plus ``base``."""
    from ..core.channel import make_grouping
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, c + 1, (d, d, 1))
    cnt[:n_clients] = 0
    valid = (np.arange(c) < cnt).reshape(d, d * c)
    n = valid.shape[1]
    lane = np.where(valid, rng.choice(4, size=(d, n), p=mix), -1)
    keys = np.where(rng.random((d, n)) < hot, 0, rng.integers(0, k, (d, n)))
    keys = np.where(lane >= 0, keys, k)
    table = rng.integers(0, 8, (d, k, w)).astype(np.float32)
    table[:n_clients] = 0
    value = rng.integers(0, 8, (d, n, w)).astype(np.float32)
    live = table[np.arange(d)[:, None], np.minimum(keys, k - 1)]
    expect = np.where(rng.random((d, n, 1)) < 0.5, live, value)
    base = rng.integers(0, 8, (d, n, w)).astype(np.float32)
    T = lambda a, dt=np.float32: torch.as_tensor(a.astype(dt),
                                                 device=device)
    lane_t, keys_t = T(lane, np.int32), T(keys, np.int32)
    g = make_grouping(torch.where(lane_t >= 0, lane_t * k + keys_t, 4 * k))
    return dict(table=T(table), keys=keys_t, lane=lane_t, value=T(value),
                expect=T(expect), base=T(base), order=g.order.contiguous(),
                sid=g.seg_start.contiguous(),
                seg_end=g.seg_end.contiguous())


# a pack past 2^31 words: 2,200,000 rows of 1,000 words to 8 destinations
# (8.8 GB of words in, 9.0 GB of slots out), the size of the MoE channel
# packs of the dry run's prefill_32k cells
WIDE_PACK = dict(r=2_200_000, t=8, c=280_000, c2=16, w=1000)


def wide_pack_check(dev, seed: int = 31) -> dict:
    """The pack kernel against its plain version where both the words read
    and the slots written lie past 2^31 words (the kernels address words
    with 64-bit offsets), drawn on ``dev``: 10% of the rows inactive, the
    rest uniform over the destinations.  Returns what each output matched
    (all six must) and the sizes; the buffers are freed before it
    returns."""
    from ..kernels import ops
    p = WIDE_PACK
    g = torch.Generator(device=dev).manual_seed(seed)
    dst = torch.randint(0, p["t"], (1, p["r"]), generator=g, device=dev,
                        dtype=torch.int32)
    off = torch.rand((1, p["r"]), generator=g, device=dev) < 0.1
    dst = torch.where(off, torch.full_like(dst, -1), dst)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, p["r"], p["w"]),
                          generator=g, device=dev, dtype=torch.int32)
    args = (dst, words, p["t"], p["c"], p["c2"])
    got = ops.delegation_pack(*args, impl="kernel")
    want = ops.delegation_pack(*args, impl="ref")
    names = ("slots", "slots2", "counts", "counts2", "request_slot",
             "totals")
    out = {n: bool(torch.equal(a, b)) for n, a, b in zip(names, got, want)}
    out.update(words=words.numel(), slot_words=got[0].numel()
               + got[1].numel())
    return out
