"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``gpu`` marker and skips where no CUDA
device is present (decided in the ``cuda`` fixture).  The module imports
no JAX, so it also runs where JAX is not installed.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_*.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (DelegatedKVStore, SequentialKVReference,
                              StackedMesh, make_grouping, use_session)
from repro_torch.kernels import ops as tops

pytestmark = pytest.mark.gpu
VW = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _pack_case(seed, d, r, t, w, hot):
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, t, (d, r))
    dst = np.where(rng.random((d, r)) < hot, 0, dst).astype(np.int32)
    words = rng.integers(-2 ** 31, 2 ** 31 - 1, (d, r, w), dtype=np.int64)
    return dst, words.astype(np.int32)


@pytest.mark.parametrize("r,c,c2,hot", [(1037, 64, 64, 0.0),   # ragged R
                                        (512, 1, 1, 0.0),      # capacity 1
                                        (4096, 300, 700, 0.9)])
def test_pack_kernel_matches_plain(cuda, r, c, c2, hot):
    """Exact, int32 words above 2^24 included."""
    dst, words = _pack_case(r, 8, r, 8, 10, hot)
    dst, words = (torch.as_tensor(a, device=cuda) for a in (dst, words))
    got = tops.delegation_pack(dst, words, 8, c, c2, impl="kernel")
    torch.cuda.synchronize()
    want = tops.delegation_pack(dst, words, 8, c, c2, impl="ref")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the pack kernels' count and rank blocks take 2048-row chunks of a shard
# (kernels/delegation_pack.py: CHUNK)
@pytest.mark.parametrize("d,r,t,c,c2,w,hot,inactive", [
    (4, 50_000, 8, 5000, 2000, 5, 0.3, 0.1),     # 25 chunks a shard
    # one destination's FIFO run over the chunks' edges, C and C + C2
    # inside a chunk ...
    (2, 9000, 4, 2500, 1000, 3, 0.9, 0.0),
    # ... and on a chunk's edge: rank 2048 opens slots2, 4096 is dropped
    (2, 8192, 2, 2048, 2048, 3, 1.0, 0.0),
    (4, 12_000, 4, 2500, 2048, 2049, 0.5, 0.1),  # the MoE channel's rows
    (4, 6000, 16, 512, 0, 1024, 0.0, 0.5),       # the trustees' pack
    (3, 5000, 8, 200, 100, 1, 0.0, 0.1),         # W 1
    (2, 3000, 8, 10, 10, 4, 0.0, 1.0),           # every row inactive
    (3, 1, 4, 2, 1, 7, 0.0, 0.0),                # R 1
])
def test_pack_kernel_matches_plain_where_the_chunks_meet(
        cuda, d, r, t, c, c2, w, hot, inactive):
    """Exact in all six outputs where the chunked design can go wrong."""
    rng = np.random.default_rng(r + w)
    dst = rng.integers(0, t, (d, r))
    dst = np.where(rng.random((d, r)) < hot, 0, dst)
    dst = np.where(rng.random((d, r)) < inactive, -1, dst).astype(np.int32)
    words = rng.integers(-2 ** 31, 2 ** 31 - 1, (d, r, w), dtype=np.int64)
    dst, words = (torch.as_tensor(a, device=cuda)
                  for a in (dst, words.astype(np.int32)))
    got = tops.delegation_pack(dst, words, t, c, c2, impl="kernel")
    torch.cuda.synchronize()
    want = tops.delegation_pack(dst, words, t, c, c2, impl="ref")
    for g, w_, what in zip(got, want, ("slots", "slots2", "counts",
                                       "counts2", "request_slot",
                                       "totals")):
        assert torch.equal(g, w_), what


def _serve_case(dev, seed, t=8, n=5000, k=700, integer=True, hot=0.6,
                w=VW, mix=None, inactive=0.1):
    rng = np.random.default_rng(seed)
    lane = rng.choice(4, (t, n), p=mix)
    lane = np.where(rng.random((t, n)) < inactive, -1, lane)
    keys = np.where(rng.random((t, n)) < hot, 1, rng.integers(0, k, (t, n)))
    keys = np.where(lane >= 0, keys, k)
    draw = (lambda s: rng.integers(0, 8, s).astype(np.float32)) if integer \
        else (lambda s: rng.normal(size=s).astype(np.float32))
    table, value = draw((t, k, w)), draw((t, n, w))
    live = table[np.arange(t)[:, None], np.minimum(keys, k - 1)]
    expect = np.where(rng.random((t, n, 1)) < 0.5, live, value)
    g = make_grouping(torch.as_tensor(
        np.where(lane >= 0, lane * k + keys, 4 * k).astype(np.int32),
        device=dev))
    T = lambda a, dt=np.float32: torch.as_tensor(a.astype(dt), device=dev)
    return dict(table=T(table), keys=T(keys, np.int32),
                lane=T(lane, np.int32), value=T(value), expect=T(expect),
                base=T(draw((t, n, w))), order=g.order,
                sid=g.seg_start, seg_end=g.seg_end)


def _run_serve_kernels(c, impl):
    """The serve's phase order on one case: GET gather, CAS gather and
    compare, PUT commit, ADD scan and commit."""
    table = c["table"].clone()
    t, n = c["keys"].shape
    out = torch.zeros((t, n, table.shape[-1]), device=table.device)
    flag = torch.zeros((t, n), dtype=torch.int32, device=table.device)
    tops.gather(table, c["keys"], c["lane"], 0, out, impl=impl)
    tops.gather(table, c["keys"], c["lane"], 3, out, expect=c["expect"],
                flag=flag, impl=impl)
    tops.scatter_last(table, c["keys"], c["order"], c["seg_end"],
                      (c["lane"] == 1).to(torch.int32), c["value"], impl=impl)
    resp = c["base"].clone()
    tops.segmented_add(table, c["keys"], c["lane"], c["order"], c["sid"],
                       c["seg_end"], c["value"], resp, impl=impl)
    torch.cuda.synchronize()
    return out, flag, table, resp


@pytest.mark.parametrize("seed,hot", [(0, 0.6), (1, 0.0), (2, 0.98)])
def test_serve_kernels_match_plain(cuda, seed, hot):
    """Exact on integer-valued payloads; hot=0.98 puts each lane's
    segment of key 1 (~1100 rows) over two segmented_add tiles."""
    c = _serve_case(cuda, seed, hot=hot)
    for g, w in zip(_run_serve_kernels(c, "kernel"),
                    _run_serve_kernels(c, "ref")):
        assert torch.equal(g, w)


def test_serve_kernels_rows_wider_than_a_block(cuda):
    """Rows of 1100 words, more than the 1024 threads of one block: the
    kernels loop over the words.  Exact on integer-valued payloads."""
    c = _serve_case(cuda, 4, t=2, n=1500, k=64, hot=0.5, w=1100)
    for g, w in zip(_run_serve_kernels(c, "kernel"),
                    _run_serve_kernels(c, "ref")):
        assert torch.equal(g, w)


def test_segmented_add_general_floats(cuda):
    """f32 sums in another order: within 2e-3 on segments of ~3000 N(0,1)
    deltas (prefix sums of magnitude ~100); and the kernel's order is
    fixed (its look-back sums aggregates only, in a fixed tree), so five
    runs agree bit for bit."""
    c = _serve_case(cuda, 3, integer=False)
    got = _run_serve_kernels(c, "kernel")
    want = _run_serve_kernels(c, "ref")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-3)
    for _ in range(4):
        for g, again in zip(got, _run_serve_kernels(c, "kernel")):
            assert torch.equal(g, again)


def test_segmented_add_one_segment_over_every_tile(cuda):
    """A kv_mixed-sized shard (T 8, N 139,264: 136 tiles of 1024 rows)
    whose rows are all ADD rows of one key: every tile but the first looks
    back to tile 0.  Exact on integer-valued payloads (sums < 2^24)."""
    c = _serve_case(cuda, 5, n=139_264, k=125_000, hot=1.0, w=4,
                    mix=(0.0, 0.0, 1.0, 0.0), inactive=0.0)
    assert int((c["sid"] == 0).sum()) == 8 * 139_264     # one segment
    for g, w in zip(_run_serve_kernels(c, "kernel"),
                    _run_serve_kernels(c, "ref")):
        assert torch.equal(g, w)


def test_scatter_last_winner_tiles_before_its_segment_end(cuda):
    """One CAS segment a shard; the flagged winner lies tiles before the
    segment's end with no flagged row after it (its block reads forward
    over 45 tiles), a tile's last row reads forward four tiles to the next
    flagged row, a shard has none flagged, one only its last row
    (testing.serve.far_winner_flags).  Exact."""
    from repro_torch.kernels.delegation_serve import SCATTER_TILE_ROWS
    from repro_torch.testing.serve import far_winner_flags
    tile = SCATTER_TILE_ROWS
    c = _serve_case(cuda, 6, n=48 * tile, k=64, hot=1.0, w=4,
                    mix=(0.0, 0.0, 0.0, 1.0), inactive=0.0)
    flag = far_winner_flags(c["order"], tile)
    got, want = c["table"].clone(), c["table"].clone()
    tops.scatter_last(got, c["keys"], c["order"], c["seg_end"], flag,
                      c["value"], impl="kernel")
    torch.cuda.synchronize()
    tops.scatter_last(want, c["keys"], c["order"], c["seg_end"], flag,
                      c["value"], impl="ref")
    assert torch.equal(got, want)
    win = c["order"][0, 2 * tile + 52].long()
    assert torch.equal(got[0, 1], c["value"][0, win])
    assert torch.equal(got[2], c["table"][2])            # none flagged


@pytest.mark.parametrize("extra", [1, -1])
def test_serve_kernels_n_off_a_tile_multiple(cuda, extra):
    """N one past and one short of three segmented_add tiles (twelve
    scatter_last tiles): the last tile of each is ragged.  Exact on
    integer-valued payloads."""
    from repro_torch.kernels.delegation_serve import (SCATTER_TILE_ROWS,
                                                      SEGADD_TILE_ROWS)
    assert SEGADD_TILE_ROWS % SCATTER_TILE_ROWS == 0
    c = _serve_case(cuda, 7, n=3 * SEGADD_TILE_ROWS + extra, hot=0.5)
    for g, w in zip(_run_serve_kernels(c, "kernel"),
                    _run_serve_kernels(c, "ref")):
        assert torch.equal(g, w)


def test_store_kernel_path_matches_oracle_on_card(cuda):
    """A mixed GET/PUT/ADD/CAS round trip through the store on the card,
    kernel path, against the sequential oracle (no shortcut, no
    overflow), and every kernel launched."""
    n_keys, r = 1000, 512
    rng = np.random.default_rng(9)
    init = rng.integers(0, 8, (n_keys, VW)).astype(np.float32)
    ref = SequentialKVReference(n_keys, VW)
    ref.prefill(init)
    tops.reset_launch_counts()
    with use_session() as sess:
        st = DelegatedKVStore(StackedMesh((2, 4), device=cuda), n_keys, VW,
                              capacity=4 * r, local_shortcut=False)
        st.prefill(init)
        for _ in range(3):
            k = [np.where(rng.random(r) < 0.5, 7, rng.integers(0, n_keys, r))
                 .astype(np.int32) for _ in range(4)]
            v = [rng.integers(0, 8, (r, VW)).astype(np.float32)
                 for _ in range(4)]
            e = np.where(rng.random((r, 1)) < 0.5, ref.table[k[3]], v[3])
            T = lambda a: torch.as_tensor(a, device=cuda)
            fg = st.get_then(T(k[0]))
            st.put_then(T(k[1]), T(v[1]))
            fa = st.add_then(T(k[2]), T(v[2]))
            fc = st.cas_then(T(k[3]), T(e), T(v[3]))
            stats = sess.step()[st.trust.name]
            assert stats["impl_fallback"] == 0 and stats["dropped"] == 0
            assert np.array_equal(fg.result()["value"].cpu().numpy(),
                                  ref.get(k[0]))
            ref.put(k[1], v[1])
            assert np.array_equal(fa.result()["value"].cpu().numpy(),
                                  ref.add(k[2], v[2]))
            flags, old = ref.cas(k[3], e, v[3])
            assert np.array_equal(fc.result()["flag"].cpu().numpy(), flags)
            assert np.array_equal(fc.result()["value"].cpu().numpy(), old)
        assert np.array_equal(st.dump(), ref.dump())
    counts = tops.launch_counts()
    assert all(counts[k] > 0 for k in ("delegation_pack", "gather",
                                       "scatter_last", "segmented_add"))
