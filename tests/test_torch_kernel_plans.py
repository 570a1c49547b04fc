"""The host-side plans of the two kernels redesigned for Hopper, held
here on the CPU where the kernels themselves cannot run.

  * ``selective_scan.scan_plan(N)``: lanes a channel x states a lane
    that cover each of the N states exactly once (padding past N), with
    the lanes dividing 32 so a channel's lanes sit in one warp; every plan
    is an instance the CUDA source builds; N past 64 is refused.  At the
    N of each plan's padded and exact edges the wrapper (the plain
    version, on CPU tensors) equals the JAX package's sequential scan.
  * ``pagetable_serve.smem_bytes(PL, SL, MP)``: the shared memory a
    trustee's block takes, from the layout the CUDA source states, and
    the refusal (``ValueError``) exactly where it passes the 227 KB a
    block can hold.
  * the KV serve's ``scatter_last`` / ``segmented_add``: the tiles the
    wrappers plan are the CUDA sources' THREADS x ITEMS, the look-back
    descriptors are all the scratch there is (no N-sized buffer), rows
    move as float4 only where W % 4 == 0 and the buffers are aligned, and
    the plain ``scatter_last`` under its (order, seg_end) signature equals
    the JAX package's ``_scatter_last`` Pallas kernel (interpret mode).
  * the KV serve's ``gather``: ``gather_plan`` and its constants are the
    CUDA source's, its grid fills the card at the main paths' shapes and
    covers every row once; the plain gather (GET on T0, the ADD base on
    T1, the CAS current and flag on T2) equals the JAX package's
    ``_gather`` Pallas kernel (interpret mode), reads a key outside the
    table clamped and leaves the other rows as they were.
"""
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import delegation_serve as kds
from repro_torch.kernels import pagetable_serve as kpt
from repro_torch.kernels import selective_scan as kss

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("n", [1, 2, 4, 8, 12, 16, 32, 40, 64])
def test_scan_plan_covers_each_state_once(n):
    lanes, spl = kss.scan_plan(n)
    assert 32 % lanes == 0 and spl % 4 == 0     # float4 shares of B, C
    held = [g * spl + i for g in range(lanes) for i in range(spl)]
    live = [s for s in held if s < n]
    assert sorted(live) == list(range(n))       # each state once
    # the fewest lanes that hold N: the plan before it does not
    i = kss.LANES.index(lanes)
    assert i == 0 or kss.LANES[i - 1] * spl < n


def test_scan_plans_are_the_cuda_instances():
    src = _source("selective_scan.cu")
    body = re.search(r"#define SCAN_PLANS\(X, T\)(.*)\n", src).group(1)
    assert tuple(int(a) for a in re.findall(r"X\(T, (\d+)\)", body)) \
        == kss.LANES
    assert re.search(r"constexpr int SPL = (\d+);", src).group(1) \
        == str(kss.STATES_A_LANE)
    assert re.search(r"constexpr int N_MAX = (\d+);", src).group(1) \
        == str(kss.MAX_STATE) == str(kss.LANES[-1] * kss.STATES_A_LANE)


@pytest.mark.parametrize("n", [0, kss.MAX_STATE + 1])
def test_scan_plan_refuses_n_outside_the_kernel(n):
    with pytest.raises(ValueError, match="states a channel"):
        kss.scan_plan(n)


@pytest.mark.parametrize("n", [2, 12, 32, 40])
def test_scan_wrapper_matches_jax_at_plan_edges(n):
    """N 2 and 12 leave padding states in a plan, 32 fills four lanes of
    eight exactly, 40 pads eight lanes of eight: on CPU tensors the
    wrapper runs the plain version, which equals JAX's sequential scan."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops as tops
    rng = np.random.default_rng(n)
    b, s, di = 2, 24, 12
    x = rng.normal(size=(b, s, di)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, di))) * 0.1).astype(np.float32)
    a = (-np.arange(1, n + 1)[None, :]
         * rng.uniform(0.5, 1.5, (di, 1))).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    d = rng.normal(size=(di,)).astype(np.float32)
    h0 = rng.normal(size=(b, di, n)).astype(np.float32)
    args = (x, dt, a, bm, cm, d, h0)
    y, h = tops.selective_scan(*(torch.as_tensor(v) for v in args))
    jy, jh = jref.selective_scan(x, dt, a, bm, cm, d, h0=h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2e-5,
                               atol=2e-5)


def _pt_constants():
    src = _source("pagetable_serve.cu")
    nt = int(re.search(r"constexpr int NT = (\d+);", src).group(1))
    listed = int(re.search(r"constexpr int LIST = (\d+);", src).group(1))
    return nt, listed


def test_pagetable_constants_are_the_cuda_source():
    assert (kpt._THREADS, kpt._LIST) == _pt_constants()


@pytest.mark.parametrize("pl,sl,mp", [
    (512, 8, 64),       # the paged decode's trustee
    (16, 8, 16),        # the stress trace's
    (200, 16, 16),      # PL off the 32-page bitmap words
    (2048, 64, 64),     # more bitmap words than lanes
    (33, 33, 3),        # a sequence bitmap of two words
])
def test_pagetable_smem_bytes(pl, sl, mp):
    """The layout the kernel carves: chains, chain_len and last_used as
    int32; ``used`` and its dirty marks as bitmaps of PL bits; a bitmap
    of the touched sequences; the listed rows' (row, seq, arg); the block
    scan's warp sums and total."""
    nt, listed = _pt_constants()
    words = (pl + 31) // 32
    ints = (sl * mp + 2 * sl + 2 * words + (sl + 31) // 32
            + 3 * listed + nt // 32 + 1)
    assert kpt.smem_bytes(pl, sl, mp) == 4 * ints
    assert kpt.check_fits(pl, sl, mp) == 4 * ints
    # ``used`` costs two bits a page: the bitmap and its dirty marks
    assert kpt.smem_bytes(pl + 32, sl, mp) - kpt.smem_bytes(pl, sl, mp) \
        == 8


@pytest.mark.parametrize("pl,mp", [(512, 64), (4096, 16), (100, 1)])
def test_pagetable_refusal_threshold(pl, mp):
    """check_fits refuses exactly the first SL whose state passes the
    227 KB of shared memory a block can hold."""
    limit = 227 * 1024
    sl = 1
    while kpt.smem_bytes(pl, sl + 1, mp) <= limit:
        sl += 1
    assert kpt.check_fits(pl, sl, mp) <= limit
    with pytest.raises(ValueError, match="exceeds the 232448 bytes"):
        kpt.check_fits(pl, sl + 1, mp)


def _tile(name):
    src = _source(name)
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    items = int(re.search(r"constexpr int ITEMS = (\d+);", src).group(1))
    return threads, items


def test_serve_tiles_are_the_cuda_constants():
    threads, items = _tile("scatter_last.cu")
    assert threads * items == kds.SCATTER_TILE_ROWS
    assert threads % 32 == 0 and threads * items // 32 <= 32  # chunks
    threads, items = _tile("segmented_add.cu")
    assert threads * items == kds.SEGADD_TILE_ROWS
    assert threads % 32 == 0 and threads // 32 <= 32          # warps


@pytest.mark.parametrize("t,n,w,vec", [
    (8, 139_264, 4, 4),     # kv_mixed: 136 tiles a shard
    (8, 10_240, 4, 4),      # kv_paper's shape
    (8, 3 * 1024 + 1, 3, 1),
    (2, 1500, 1100, 4),     # wide rows: 275 word groups a tile
    (1, 1, 1, 1),
])
def test_segmented_add_plan(t, n, w, vec):
    """A tile of every shard; the descriptors (a tile's aggregate row, a
    status word a tile and word group, the ticket) are the only scratch,
    far below the N x W floats the three-launch design round-tripped."""
    plan = kds.segmented_add_plan(t, n, w, vec)
    tiles = -(-n // kds.SEGADD_TILE_ROWS)
    assert plan == dict(tiles=tiles, agg=t * tiles * w,
                        status=t * tiles * (w // vec) + 1)
    scratch = 4 * (plan["agg"] + plan["status"])
    if n >= kds.SEGADD_TILE_ROWS:
        assert scratch < 4 * t * n * w / 100
    if (t, n) == (8, 139_264):
        assert scratch == 21_764                 # bytes at kv_mixed


def test_word_vec_needs_width_and_alignment():
    x = torch.zeros(64)
    assert kds.word_vec(4, x, x) == 4
    assert kds.word_vec(8, x) == 4
    assert kds.word_vec(3, x) == 1
    assert kds.word_vec(4, x, x[1:]) == 1        # 4 bytes off 16


def _jax_scatter_last(table, keys_s, sid, ok, value_s):
    """JAX's _scatter_last (interpret mode) on one shard's sorted rows,
    padded as its delegation_serve wrapper pads them."""
    import functools

    import jax
    import jax.numpy as jnp
    from repro.kernels import delegation_serve as jds
    k, w = table.shape
    n = keys_s.shape[0]
    br, bk = jds.row_block(n, 128), jds.key_block(k, 128)
    np_, kp, wp = -(-n // br) * br, -(-k // bk) * bk, -(-w // 128) * 128
    row = lambda x, fill: jnp.pad(jnp.asarray(x), (0, np_ - n),
                                  constant_values=fill).reshape(1, np_)
    run = jax.jit(functools.partial(jds._scatter_last, br=br, bk=bk,
                                    interpret=True))
    out = run(jnp.pad(jnp.asarray(table), ((0, kp - k), (0, wp - w))),
              row(np.where(keys_s >= k, kp, keys_s), kp), row(sid, -1),
              row(ok, 0),
              jnp.pad(jnp.asarray(value_s), ((0, np_ - n), (0, wp - w))))
    return np.asarray(out)[:k, :w]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("lane_id", [1, 3])
def test_plain_scatter_last_matches_jax(seed, lane_id):
    """The serve's PUT commit (every PUT row flagged) and a CAS commit
    (half the CAS rows flagged), rows grouped by (op, key) with a hot key
    over several of JAX's 128-row tiles: the plain version, given
    seg_end, writes the table JAX's kernel writes."""
    from repro_torch.core import make_grouping
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(seed)
    n, k, w = 1024, 40, 3
    lane = rng.choice(4, n, p=(0.2, 0.15, 0.45, 0.2))
    lane = np.where(rng.random(n) < 0.1, -1, lane)
    keys = np.where(rng.random(n) < 0.7, 3, rng.integers(0, k, n))
    keys = np.where(lane >= 0, keys, k).astype(np.int32)
    table = rng.integers(0, 8, (k, w)).astype(np.float32)
    value = rng.integers(0, 8, (n, w)).astype(np.float32)
    flag = (lane == lane_id) & (rng.random(n) < (1.0 if lane_id == 1
                                                   else 0.5))
    flag = flag.astype(np.int32)
    g = make_grouping(torch.as_tensor(
        np.where(lane >= 0, lane * k + keys, 4 * k).astype(np.int32)))
    order = g.order.numpy()
    got = torch.as_tensor(table)[None].clone()
    tref.scatter_last(got, torch.as_tensor(keys)[None], g.order[None],
                      g.seg_end[None], torch.as_tensor(flag)[None],
                      torch.as_tensor(value)[None])
    want = _jax_scatter_last(table, keys[order], g.seg_start.numpy(),
                             flag[order], value[order])
    assert np.array_equal(got[0].numpy(), want)
    assert not np.array_equal(want, table)          # something was written


def test_gather_constants_are_the_cuda_source():
    src = _source("gather.cu")
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                       src).group(1))
    assert const("THREADS") == kds.GATHER_THREADS
    assert const("WIDE_WORDS") == kds.GATHER_WIDE_WORDS
    # the wide path's rows a block: a warp a row
    assert re.search(r"constexpr int WARPS = THREADS / 32;", src)
    # the launch takes its grid from the plan: no second grid in the source
    assert re.search(r"go<<<blocks, THREADS, 0, s>>>", src)
    assert re.search(r"gather_empty_kernel<<<blocks, THREADS,", src)


@pytest.mark.parametrize("t,n,w,vec,blocks", [
    (8, 10_240, 4, 4, 320),         # kv_paper: two blocks an SM of 132
    (8, 139_264, 4, 4, 4352),       # kv_mixed
    (2, 1500, 1100, 4, 375),        # rows of 1,100 words: a warp a row
    (8, 5037, 3, 1, 158),           # word moves
    (1, 1, 1, 1, 1),
])
def test_gather_plan(t, n, w, vec, blocks):
    """The grid covers every one of the T*N rows exactly once, a row to a
    thread (narrow rows) or to a warp (wide rows), with no idle block;
    at the main paths' shapes it fills the H100's 132 SMs twice over."""
    plan = kds.gather_plan(t, n, w, vec)
    rows = t * n
    assert plan["wide"] == (w > kds.GATHER_WIDE_WORDS)
    assert plan["vec"] == vec and plan["blocks"] == blocks
    per = kds.GATHER_THREADS // 32 if plan["wide"] else kds.GATHER_THREADS
    assert plan["rows_a_block"] == per
    b, slot = np.meshgrid(np.arange(plan["blocks"]), np.arange(per),
                          indexing="ij")
    taken = (b * per + slot).ravel()
    taken = taken[taken < rows]
    assert np.array_equal(np.sort(taken), np.arange(rows))  # each row once
    assert (plan["blocks"] - 1) * per < rows                # no idle block
    if n in (10_240, 139_264):
        assert plan["blocks"] >= 2 * 132


def test_gather_plan_refuses_a_vec_without_an_instance():
    with pytest.raises(ValueError, match="vec=2"):
        kds.gather_plan(8, 100, 4, 2)


def test_gather_refuses_an_empty_table():
    """K 0 has no line to clamp to: refused before any launch."""
    table = torch.zeros((2, 0, 4))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="K 0"):
        kds.gather(table, idx, idx, 0, torch.zeros((2, 3, 4)))


def _gather_edge_cases():
    from repro_torch.testing.serve import gather_edge_cases
    return gather_edge_cases()


@pytest.mark.parametrize("label,kw", _gather_edge_cases())
def test_plain_gather_keeps_its_contract(label, kw):
    """The wrapper on CPU tensors (the plain version) at the kernel plan's
    edges: lane rows keyed outside the table read the clamped line, PUT
    and inactive rows keep ``out``, non-CAS rows keep ``flag``."""
    from repro_torch.testing.serve import (gather_case, gather_contract,
                                           run_gather)
    case = gather_case(torch.device("cpu"), **kw)
    out, flag = run_gather(case, "kernel")
    clamped, kept, kept_flag, _ = gather_contract(case, out, flag)
    assert clamped and kept and kept_flag, label


def _jax_gather(t0, t1, t2, keys, lane):
    """JAX's _gather (interpret mode) on one shard with zero ADD deltas
    (priors 0, so no carry: ``cont`` 0), padded as its delegation_serve
    wrapper pads; returns the (N, W) responses."""
    import functools

    import jax
    import jax.numpy as jnp
    from repro.kernels import delegation_serve as jds
    k, w = t0.shape
    n = keys.shape[0]
    br, bk = jds.row_block(n, 128), jds.key_block(k, 128)
    np_, kp, wp = -(-n // br) * br, -(-k // bk) * bk, -(-w // 128) * 128
    row = lambda x, fill: jnp.pad(jnp.asarray(x), (0, np_ - n),
                                  constant_values=fill).reshape(1, np_)
    tbl = lambda x: jnp.pad(jnp.asarray(x), ((0, kp - k), (0, wp - w)))
    run = jax.jit(functools.partial(jds._gather, br=br, bk=bk,
                                    interpret=True))
    resp = run(tbl(t0), tbl(t1), tbl(t2),
               row(np.where(keys >= k, kp, keys), kp), row(lane, -1),
               row(np.zeros(n, np.int32), -1),
               jnp.zeros((np_, wp), jnp.float32),
               jnp.zeros((1, np_ // br), jnp.int32))
    return np.asarray(resp)[:n, :w]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("w", [3, 4])
def test_plain_gather_matches_jax(seed, w):
    """Three table snapshots T0 / T1 / T2 (the serve's GET, ADD-base and
    CAS-current phases): three plain gathers equal JAX's one-hot gather
    kernel row for row, and the plain CAS flag equals JAX's ``ok_cas``
    (``lane == 3 & all(resp == expect)``, delegation_serve.py:317).
    Exact on integer-valued tables."""
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(seed)
    n, k = 700, 300
    lane = rng.choice(4, n, p=(0.3, 0.2, 0.25, 0.25))
    lane = np.where(rng.random(n) < 0.1, -1, lane)
    keys = np.where(rng.random(n) < 0.3, 5, rng.integers(0, k, n))
    keys = np.where(lane >= 0, keys, k).astype(np.int32)
    snaps = [rng.integers(0, 8, (k, w)).astype(np.float32) for _ in range(3)]
    live = snaps[2][np.minimum(keys, k - 1)]
    expect = np.where(rng.random((n, 1)) < 0.5, live,
                      rng.integers(0, 8, (n, w))).astype(np.float32)
    T = lambda a: torch.as_tensor(a)[None]
    out = torch.zeros((1, n, w))
    flag = torch.zeros((1, n), dtype=torch.int32)
    tref.gather(T(snaps[0]), T(keys), T(lane.astype(np.int32)), 0, out)
    tref.gather(T(snaps[1]), T(keys), T(lane.astype(np.int32)), 2, out)
    tref.gather(T(snaps[2]), T(keys), T(lane.astype(np.int32)), 3, out,
                T(expect), flag)
    resp = _jax_gather(*snaps, keys, lane.astype(np.int32))
    ok_cas = (lane == 3) & np.all(resp == expect, axis=-1)
    assert np.array_equal(out[0].numpy(), resp)
    assert np.array_equal(flag[0].numpy(), ok_cas.astype(np.int32))
    assert ok_cas.any() and (~ok_cas[lane == 3]).any()     # both outcomes
