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


def _gather_edge_cases():
    from repro_torch.testing.serve import gather_edge_cases
    return gather_edge_cases()


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


def test_pack_kernel_past_2_31_words(cuda):
    """Words read and slots written past 2^31 words: exact in all six
    outputs (``testing.serve.wide_pack_check``)."""
    from repro_torch.testing.serve import wide_pack_check
    got = wide_pack_check(cuda)
    assert got["words"] >= 2 ** 31 and got["slot_words"] >= 2 ** 31
    assert all(got[k] for k in ("slots", "slots2", "counts", "counts2",
                                "request_slot", "totals")), got


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


@pytest.mark.parametrize("hot_lane,empty_lane", [(0, 1), (1, 0)])
def test_pack_kernel_at_virtual_bins(cuda, hot_lane, empty_lane):
    """A multiplexed round's pack: 8 trustees x 2 lanes, one lane of
    trustee 0 hot past C + C2 (rows drop), the other lane empty; exact."""
    from repro_torch.testing.serve import virtual_bin_pack_case
    args = virtual_bin_pack_case(cuda, 8, 2048, 8, 2, 64, 32, 10,
                                 seed=60 + hot_lane, hot_lane=hot_lane,
                                 empty_lane=empty_lane)
    got = tops.delegation_pack(*args, impl="kernel")
    torch.cuda.synchronize()
    want = tops.delegation_pack(*args, impl="ref")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    counts, totals = got[2], got[5]
    assert (totals[:, empty_lane::2] == 0).all()
    assert (counts[:, hot_lane] == 64).all() and \
        (totals[:, hot_lane] > 96).all()


@pytest.mark.parametrize("tid,c2,n_local", [(0, 0, 0), (1, 64, 300)])
def test_serve_kernels_on_a_lane_sub_buffer(cuda, tid, c2, n_local):
    """The three serve kernels on one lane's rows as the strided
    multiplexed serve forms them (``channel.lane_rows``), with and without
    a second_round block and a local tail; exact."""
    from repro_torch.testing.serve import lane_serve_case
    c = lane_serve_case(cuda, 8, 2, 256, c2, 999, VW, seed=70 + tid,
                        tid=tid, n_local=n_local)
    for g, w in zip(_run_serve_kernels(c, "kernel"),
                    _run_serve_kernels(c, "ref")):
        assert torch.equal(g, w)


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


def _gather_both(cuda, kw):
    from repro_torch.testing.serve import gather_case, run_gather
    case = gather_case(cuda, **kw)
    got = run_gather(case, "kernel")
    torch.cuda.synchronize()
    want = run_gather(case, "ref")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return case, got


def test_gather_lane_keys_outside_the_table_read_the_clamped_line(cuda):
    """GET, ADD and CAS rows keyed -1 or K read line 0 or K - 1, as the
    plain version does (a key past the table is clamped on every path).
    Exact."""
    from repro_torch.testing.serve import gather_contract
    case, (out, flag) = _gather_both(
        cuda, dict(t=8, n=5000, k=999, w=4, seed=41, outside=0.3))
    clamped, _, _, n_off = gather_contract(case, out, flag)
    assert clamped and n_off > 1000
    k = case["keys"]
    assert bool(((k == -1) & (case["lane"] >= 0)).any())
    assert bool(((k == 999) & (case["lane"] >= 0)).any())


def test_gather_leaves_the_other_rows_as_they_were(cuda):
    """``out`` and ``flag`` filled with a sentinel first: PUT and inactive
    rows keep it in ``out``, every row but CAS's keeps it in ``flag``."""
    from repro_torch.testing.serve import gather_contract
    case, (out, flag) = _gather_both(
        cuda, dict(t=8, n=5000, k=999, w=4, seed=40))
    _, kept, kept_flag, _ = gather_contract(case, out, flag)
    assert kept and kept_flag


@pytest.mark.parametrize("label,kw", _gather_edge_cases())
def test_gather_kernel_at_the_plan_edges(cuda, label, kw):
    """N one past / short of the plan's rows a block, lanes with no rows
    and with every row, W 3, a misaligned ``out``, W 32, and rows a warp
    each (W 33, 1100): exact, and the contract held."""
    from repro_torch.testing.serve import gather_contract
    case, (out, flag) = _gather_both(cuda, kw)
    clamped, kept, kept_flag, _ = gather_contract(case, out, flag)
    assert clamped and kept and kept_flag, label


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
    lanes = tops.KERNELS["gather"].lane_launches
    assert all(lanes[i] > 0 for i in (0, 2, 3)) and lanes[1] == 0
    assert sum(lanes) == counts["gather"]


# ---------------------------------------------------------------------------
# dedicated mode and the defer drain: the kernels' new layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", [1, 2])
def test_pack_kernel_at_dedicated_slots_with_defer(cuda, lanes):
    """A dedicated round's pack under the defer drain: 5 client shards
    send to the 3 trustee shard slots (x lanes), the trustee shards send
    nothing, a hot lane past C is flagged (no second block); the retry
    round re-packs only those rows.  Exact in all six outputs."""
    from repro_torch.testing.serve import dedicated_pack_case
    dst, words, bins, c, c2 = dedicated_pack_case(cuda, 8, 5, 3000, lanes,
                                                  64, 6, seed=80 + lanes)
    for _round in range(2):
        got = tops.delegation_pack(dst, words, bins, c, c2, impl="kernel")
        torch.cuda.synchronize()
        want = tops.delegation_pack(dst, words, bins, c, c2, impl="ref")
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        req, totals = got[4], got[5]
        assert (req[5:] == -1).all() and (totals[5:] == 0).all()
        assert (totals[:5, :5 * lanes] == 0).all()
        deferred = (req < 0) & (dst >= 0)
        assert deferred[:5].any() or _round == 1
        dst = torch.where(deferred, dst, -1)     # the retry round's rows


def test_serve_kernels_over_a_zero_client_region(cuda):
    """The three serve kernels on a dedicated round's received rows: the
    client shards receive none and their table slices (zeros) stay zero;
    the trustee shards' rows exact against the plain versions."""
    from repro_torch.testing.serve import zero_region_serve_case
    c = zero_region_serve_case(cuda, 8, 5, 256, 999, VW, seed=90)
    got = _run_serve_kernels(c, "kernel")
    for g, w in zip(got, _run_serve_kernels(c, "ref")):
        assert torch.equal(g, w)
    out, flag, table, resp = got
    assert not table[:5].any() and not out[:5].any() and not flag[:5].any()


def test_pagetable_serve_over_dedicated_shards(cuda):
    """P2 launched over every stacked shard, 4 of 8 trustees: the stress
    trace through a dedicated page table on the card equals the CPU run
    (the plain version) bit for bit, and the 4 client shards' state
    stays zero."""
    from repro_torch.core import DelegatedPageTable
    from repro_torch.testing.pagetable import (STRESS_GEOMETRY,
                                               replay_waves, stress_waves,
                                               submit_waves)
    g = STRESS_GEOMETRY
    runs = {}
    tops.reset_launch_counts()
    for dev in (cuda, torch.device("cpu")):
        with use_session():
            pt = DelegatedPageTable(StackedMesh((2, 4), device=dev),
                                    g["n_pages"], max_seqs=g["max_seqs"],
                                    page_size=g["page_size"],
                                    max_pages=g["max_pages"], capacity=256,
                                    mode="dedicated", n_dedicated=4)
            rec = submit_waves(pt, stress_waves(7))
            replay_waves(pt, rec)
            runs[dev.type] = ([[pt.globalize(f.result(), s) for _, s, _, f
                                in w] for w in rec], pt.dump(),
                              pt.client_region())
    assert tops.launch_counts()["pagetable_serve"] > 0
    (gw, gs, gr), (ww, ws, _) = runs["cuda"], runs["cpu"]
    for a, b in zip(gw, ww):
        for ra, rb in zip(a, b):
            assert all(np.array_equal(ra[k], rb[k]) for k in rb)
    assert all(np.array_equal(gs[k], ws[k]) for k in ws)
    assert all(v.size and not v.any() for v in gr.values())


# ---------------------------------------------------------------------------
# failover: the kernels under a drop / tear, a kill and a re-laid page table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["drop", "tear"])
@pytest.mark.parametrize("path", ["solo", "fused", "drain"])
def test_tear_on_the_kernel_path_leaves_every_table(cuda, path, kind):
    """A drop / tear after a solo round, a fused round of two trusts and a
    defer drain's rounds, all on the CUDA kernels (which write the tables
    in place): every member's table bit-identical to before the wave, its
    futures open and queued; the retry answers as an undisturbed run of
    the wave does, and leaves its tables."""
    from repro_torch.core import TrustSession
    from repro_torch.runtime import EngineFailureInjector, TrusteeFailure
    from repro_torch.testing import failover as fo
    n_keys = 997
    init, waves = fo.mixed_waves(31, n_keys, VW, 1024, 1)

    def stores_of(sess):
        kw = dict(capacity=1024, local_shortcut=False, session=sess)
        if path == "drain":
            kw.update(capacity=16, overflow="defer", max_rounds=12)
        out = [DelegatedKVStore(StackedMesh((2, 4), device=cuda), n_keys,
                                VW, name=f"kv{i}", **kw)
               for i in range(2 if path == "fused" else 1)]
        for st in out:
            st.prefill(init)
        return out

    sess = TrustSession()
    calm = stores_of(sess)
    calm_futs = [fo.submit_wave(st, waves[0], cuda) for st in calm]
    sess.step()
    sess = TrustSession()
    stores = stores_of(sess)
    before = [{k: v.clone() for k, v in st.trust.state().items()}
              for st in stores]
    sess.install_injector(EngineFailureInjector(schedule={0: (kind, 1)}))
    tops.reset_launch_counts()
    futs = [fo.submit_wave(st, waves[0], cuda) for st in stores]
    with pytest.raises(TrusteeFailure):
        sess.step()
    assert tops.launch_counts()["scatter_last"] > 0     # the round ran
    for st, b in zip(stores, before):
        assert all(torch.equal(v, b[k]) for k, v in st.trust.state().items())
    assert not any(f.ready() for fs in futs for f in fs)
    assert all(st.trust._pending for st in stores)
    sess.step()
    for st, fs, c, cfs in zip(stores, futs, calm, calm_futs):
        assert fo.same_acks(fo.acks(waves[0], fs), fo.acks(waves[0], cfs))
        assert np.array_equal(st.dump(), c.dump())
    if path != "drain":               # in request order: the oracle's
        ref = SequentialKVReference(n_keys, VW)
        ref.prefill(init)
        assert fo.same_acks(fo.acks(waves[0], futs[0]),
                            fo.oracle_wave(ref, waves[0]))


def test_small_chaos_run_kernel_path_equals_ref_path(cuda):
    """A trustee killed mid-trace, re-entrusted onto 7 shards from the
    snapshot, the waves since it replayed: the kernel path's acked history
    and table == the ref path's == the sequential oracle."""
    import tempfile
    from repro_torch.core import TrustSession
    from repro_torch.testing import failover as fo
    n_keys = 4099
    init, waves = fo.mixed_waves(32, n_keys, VW, 1176, 12)
    runs = {}
    for impl in ("kernel", "ref"):
        sess = TrustSession()
        st = DelegatedKVStore(StackedMesh((2, 4), device=cuda), n_keys, VW,
                              capacity=1176, local_shortcut=False,
                              pack_impl=impl, serve_impl=impl, session=sess)
        st.prefill(init)
        with tempfile.TemporaryDirectory() as ckdir:
            runs[impl] = fo.run_kv_chaos(
                st, sess, waves, ckdir, cuda, schedule={7: ("kill", 3)},
                snap_every=4, sync=torch.cuda.synchronize)
        runs[impl]["table"] = st.dump()
        assert sess.last_stats()["recovery"]["replayed_rounds"] == 3
        assert runs[impl]["replay_equal"] and st.t == 7
    k, r = runs["kernel"], runs["ref"]
    assert all(fo.same_acks(k["acked"][i][0], r["acked"][i][0])
               for i in range(len(waves)))
    bad, table = fo.check_kv_history(init, waves, k["acked"])
    assert bad is None
    assert np.array_equal(k["table"], table)
    assert np.array_equal(r["table"], table)


def test_pagetable_reshard_then_p2_matches_plain(cuda):
    """The stress trace's state re-laid out for 7 trustees
    (``pagetable_reshard``, installed through ``re_entrust``), then more
    stress waves: P2 on the card == its plain version on the CPU, bit for
    bit, and the audit holds."""
    from repro_torch.core import DelegatedPageTable
    from repro_torch.testing.pagetable import (STRESS_GEOMETRY,
                                               replay_waves, stress_waves,
                                               submit_waves)
    g = STRESS_GEOMETRY
    runs = []
    tops.reset_launch_counts()
    for dev in (cuda, torch.device("cpu")):
        with use_session() as sess:
            pt = DelegatedPageTable(StackedMesh((2, 4), device=dev),
                                    g["n_pages"], max_seqs=g["max_seqs"],
                                    page_size=g["page_size"],
                                    max_pages=g["max_pages"], capacity=256,
                                    local_shortcut=False)
            replay_waves(pt, submit_waves(pt, stress_waves(5)))
            sess.re_entrust([3])
            assert pt.t == 7 and pt.audit()["consistent"]
            rec = submit_waves(pt, stress_waves(6, n_random=8))
            runs.append(([[pt.globalize(f.result(), s)
                           for _, s, _, f in w] for w in rec],
                         pt.dump(), pt.audit()))
    assert tops.launch_counts()["pagetable_serve"] > 0
    (gw, gs, ga), (ww, ws, wa) = runs
    for a, b in zip(gw, ww):
        for ra, rb in zip(a, b):
            assert all(np.array_equal(ra[k], rb[k]) for k in rb)
    assert all(np.array_equal(gs[k], ws[k]) for k in ws)
    assert ga == wa and ga["consistent"]


# ---------------------------------------------------------------------------
# training: no kernel cuts a gradient; the card's loss and gradients
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_inputs_that_require_grad_on_card(cuda):
    """Every wrapper raises on a CUDA input that requires grad, before it
    launches (its counter does not move); under ``torch.no_grad()`` the
    same call launches."""
    bf = dict(device=cuda, dtype=torch.bfloat16)
    q = torch.randn(1, 2, 64, 128, **bf).requires_grad_()
    x = torch.randn(2, 8, 64, **bf).requires_grad_()
    w = torch.randn(2, 64, 32, **bf)
    f32 = dict(device=cuda, dtype=torch.float32)
    scan = dict(x=torch.randn(1, 8, 16, **f32).requires_grad_(),
                dt=torch.rand(1, 8, 16, **f32), a=-torch.rand(16, 4, **f32),
                b=torch.randn(1, 8, 4, **f32), c=torch.randn(1, 8, 4, **f32),
                d=torch.ones(16, **f32))
    pages = torch.randn(4, 1, 16, 128, **bf).requires_grad_()
    table = torch.zeros(1, 8, 4, **f32).requires_grad_()
    i32 = dict(device=cuda, dtype=torch.int32)
    calls = {
        "flash_attention": lambda: tops.flash_attention(q, q, q),
        "grouped_matmul": lambda: tops.grouped_matmul(x, w),
        "selective_scan": lambda: tops.selective_scan(**scan),
        "paged_attention": lambda: tops.paged_attention(
            q[0, :, :1, :].transpose(0, 1).contiguous(), pages, pages,
            torch.arange(4, **i32)[None], torch.full((1,), 40, **i32)),
        "gather": lambda: tops.gather(
            table, torch.zeros(1, 3, **i32), torch.zeros(1, 3, **i32), 0,
            torch.zeros(1, 3, 4, **f32)),
    }
    for name, call in calls.items():
        tops.reset_launch_counts()
        with pytest.raises(RuntimeError, match=f"{name}: an input requires "
                                               f"grad"):
            call()
        assert tops.launch_counts()[name] == 0, name
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        assert tops.launch_counts()[name] == 1, name


@pytest.mark.parametrize("arch,t", [("qwen2.5-3b", 1),
                                    ("deepseek-v2-lite-16b", 4),
                                    ("falcon-mamba-7b", 1)])
def test_smoke_forward_loss_on_card_matches_cpu(cuda, arch, t):
    """The SMOKE config's loss and every gradient leaf on the card against
    the port's CPU path on the same weights and batch, f32: loss rtol
    1e-5, each leaf 1e-4 in relative RMS (cuBLAS and the CPU's BLAS sum
    in other orders); deepseek's every fed expert has a gradient."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import model as TM
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.testing.train import (ExpertRows,
                                           expert_grads_follow_rows,
                                           worst_leaf)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_arch(arch)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2, "train"),
                    mesh=MeshConfig((1, t), ("data", "model")),
                    param_dtype="float32", activation_dtype="float32",
                    remat="dots", xent_chunk=16)
    params = TM.init_params(cfg, run, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_c, _, grads_c = value_and_grad(params, batch, cfg, run)
    on_card = tree_map(lambda p: p.detach().to(cuda), params)
    with ExpertRows() as rec:
        loss_g, _, grads_g = value_and_grad(
            on_card, {k: v.to(cuda) for k, v in batch.items()}, cfg, run)
    np.testing.assert_allclose(loss_g.item(), loss_c.item(), rtol=1e-5)
    from repro_torch.optim.optimizer import tree_leaves
    worst, i = worst_leaf(grads_g, [g.numpy() for g in
                                    tree_leaves(grads_c)])
    assert worst < 1e-4, (arch, i, worst)
    if t > 1:
        r = expert_grads_follow_rows(
            grads_g["groups"]["pos0"]["moe"]["w_gate"], rec.counts)
        assert r["experts_fed"] > 0 and r["fed_without_grad"] == 0, r


# ---------------------------------------------------------------------------
# captured programs (core/compiled.py): the serve step and the rounds as
# CUDA graphs, equal to the eager path
# ---------------------------------------------------------------------------

def _captured_and_eager(run):
    """``run()`` captured (the default) and under ``compiled.disable()``,
    each with the launch counters zeroed before it: ((out, counts) x 2)."""
    from repro_torch.core import compiled
    res = []
    for eager in (False, True):
        tops.reset_launch_counts()
        if eager:
            with compiled.disable():
                out = run()
        else:
            out = run()
        torch.cuda.synchronize()
        res.append((out, tops.launch_counts()))
    return res


def test_captured_smoke_serve_equals_eager(cuda):
    """The SMOKE qwen2.5-3b and deepseek-v2-lite-16b serves (the MoE's
    channel round and the grouped matmul inside the decode step) on the
    card: the captured decode steps' tokens and launch counts equal the
    eager path's, and the step replayed."""
    from repro_torch.core import compiled
    from repro_torch.launch import serve
    for arch in ("qwen2.5-3b", "deepseek-v2-lite-16b"):
        argv = ["--arch", arch, "--smoke", "--batch", "4", "--prompt-len",
                "8", "--gen", "8", "--mesh-model", "4"]
        compiled.reset_captures()
        (a, ca), (b, cb) = _captured_and_eager(lambda: serve.main(argv))
        assert np.array_equal(a, b), arch
        assert ca == cb, (arch, ca, cb)
        caps = [c for c in compiled.captures() if c["site"] == "serve_step"]
        assert len(caps) == 1 and caps[0]["pool_bytes"] > 0, caps


def test_captured_kv_paper_round_equals_eager(cuda):
    """kv_paper-sized rounds (1,000,000 x 4 f32 on a 2x4 stacked mesh,
    8192 requests a round, 5% PUT, the shortcut on, second_round) through
    session.step(): captured, every response, table and stat and the
    launch counts equal the eager path's; one compiled round, replayed."""
    n_keys, r, w = 1_000_000, 8192, 4
    rng = np.random.default_rng(11)
    init = rng.integers(0, 8, (n_keys, w)).astype(np.float32)
    trace = [(rng.integers(0, n_keys, r).astype(np.int32),
              rng.random(r) < 0.05,
              rng.integers(0, 8, (r, w)).astype(np.float32))
             for _ in range(4)]

    def run():
        with use_session() as sess:
            st = DelegatedKVStore(StackedMesh((2, 4), device=cuda), n_keys,
                                  w, capacity=r // 8,
                                  overflow="second_round")
            st.prefill(init)
            outs = []
            for keys, is_put, vals in trace:
                T = lambda a: torch.as_tensor(a, device=cuda)
                k = T(keys)
                fut = st.trust.op.get.then(k, where=T(~is_put))
                st.trust.op.put.then(k, T(vals), where=T(is_put))
                outs.append((sess.step()[st.trust.name],
                             fut.result()["value"].cpu().numpy()))
            return outs, st.dump(), len(sess._cache)
    (got, cg), (want, cw) = _captured_and_eager(run)
    for (sg, vg), (sw, vw) in zip(got[0], want[0]):
        assert sg == sw and np.array_equal(vg, vw)
    assert np.array_equal(got[1], want[1])
    assert got[2] == 1 and want[2] == 0
    assert cg == cw and cg["delegation_pack"] > 0, (cg, cw)


def test_host_read_inside_a_captured_step_raises(cuda):
    """A host read inside a captured call fails the capture: the program
    raises CaptureError naming its site and CUDA's error (after its eager
    first call), and refuses every later call."""
    from repro_torch.core import compiled

    def fn(state, _fixed, x):
        if float(x.sum()) > 0:                 # a host read
            state["acc"].add_(x)
        return state, state["acc"] * 2
    state = {"acc": torch.zeros(16, device=cuda)}
    prog = compiled.Program(fn, "host-read probe")
    x = torch.ones(16, device=cuda)
    with pytest.raises(compiled.CaptureError, match="host-read probe"):
        prog(state, None, x)
    assert torch.equal(state["acc"], torch.ones(16, device=cuda))
    with pytest.raises(compiled.CaptureError):
        prog(state, None, x)
    # the device is usable after the failed capture
    ok = compiled.Program(lambda s, _f, y: (s, y + 1), "after")
    for i in range(3):
        _s, out = ok({}, None, torch.full((4,), float(i), device=cuda))
        assert torch.equal(out, torch.full((4,), i + 1.0, device=cuda))


def test_captured_round_holds_every_kernel_launch(cuda, tmp_path):
    """The ctypes-loaded kernels launch on PyTorch's current stream, so a
    capture records them: the captured round's graph holds one kernel
    node a launch its capture counted (four a pack call)."""
    from repro_torch.core import compiled
    n_keys, r = 1000, 512
    rng = np.random.default_rng(5)
    compiled.DEBUG_GRAPHS = True
    try:
        with use_session() as sess:
            st = DelegatedKVStore(StackedMesh((2, 4), device=cuda), n_keys,
                                  VW, capacity=r, local_shortcut=False)
            T = lambda a: torch.as_tensor(a, device=cuda)
            k = [T(rng.integers(0, n_keys, r).astype(np.int32))
                 for _ in range(4)]
            v = T(rng.integers(0, 8, (r, VW)).astype(np.float32))
            st.get_then(k[0])
            st.put_then(k[1], v)
            st.add_then(k[2], v)
            st.cas_then(k[3], v, v)
            sess.step()
            (entry,) = sess._cache.values()
            (prog,) = entry.programs.values()
            path = str(tmp_path / "round.dot")
            prog.graph.debug_dump(path)
    finally:
        compiled.DEBUG_GRAPHS = False
    dot = open(path).read()
    deltas = prog.deltas[0]
    for name, label, per in (("delegation_pack", "delegation_pack_", 4),
                             ("gather", "gather_kernel", 1),
                             ("scatter_last", "scatter_last_kernel", 1),
                             ("segmented_add", "segmented_add_kernel", 1)):
        assert deltas[name] > 0, name
        assert dot.count(label) >= per * deltas[name], (name, deltas)


# ---------------------------------------------------------------------------
# the captured train, prefill and paged steps (launch/steps.CompiledCell,
# paged_decode's write_kv), equal to the eager path
# ---------------------------------------------------------------------------

def _smoke_cell(arch, t, kind, s=32, b=2, **kw):
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    cfg = get_smoke_arch(arch)
    run = RunConfig(model=cfg, shape=ShapeConfig("c", s, b, kind),
                    mesh=MeshConfig((1, t), ("data", "model")), **kw)
    return cfg, run


@pytest.mark.parametrize("arch,t,remat,accum", [
    ("qwen2.5-3b", 1, "full", 2), ("qwen2.5-3b", 1, "dots", 1),
    ("deepseek-v2-lite-16b", 4, "none", 1), ("falcon-mamba-7b", 1, "full", 1)])
def test_captured_smoke_train_equals_eager(cuda, arch, t, remat, accum):
    """Three SMOKE train steps on the card, captured (one CUDA graph of
    the forward, the backward and AdamW, replayed) and eager from the same
    weights: every parameter, moment, step count and metric bit for bit;
    no kernel launched.  The replays' learning rate follows ``schedule``
    through the warm-up, where it changes every step (a rate frozen into
    the graph at capture would repeat the first step's)."""
    from repro_torch.launch.steps import adamw_config, build_cell
    from repro_torch.models import model as TM
    from repro_torch.optim import init_adamw, schedule
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    cfg, run = _smoke_cell(arch, t, "train", remat=remat, grad_accum=accum,
                           xent_chunk=16)
    init = TM.init_params(cfg, run, device="cpu")
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(3):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 33))
                               .astype(np.int32), device=cuda)
        batches.append({"tokens": toks[:, :-1].contiguous(),
                        "labels": toks[:, 1:].contiguous()})

    def run_steps():
        plan = build_cell(cfg, run.shape, run)
        params = tree_map(lambda p: p.to(cuda, copy=True), init)
        opt = init_adamw(params)
        ms = []
        for batch in batches:
            params, opt, m = plan.step_fn(params, opt, batch)
            ms.append({k: v.clone() for k, v in m.items()})
        progs = plan.step_fn.__wrapped__.programs
        return (tree_leaves(params) + tree_leaves(tuple(opt)), ms,
                [p.replays for p in progs.values()])
    (got, cg), (want, cw) = _captured_and_eager(run_steps)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(got[1], want[1])
               for k in a)
    # one program: the first call ran it eagerly and captured, two replays
    assert got[2] == [2] and want[2] == []
    assert cg == cw and not any(cg.values()), cg
    acfg = adamw_config(run)
    lrs = [m["lr"] for m in got[1]]
    for i, lr in enumerate(lrs):
        want_lr = schedule(acfg, torch.tensor(i + 1, dtype=torch.int32,
                                              device=cuda))
        assert torch.equal(lr, want_lr), (i, lr, want_lr)
    assert len({float(lr) for lr in lrs}) == len(lrs)


@pytest.mark.parametrize("arch,t,pallas", [
    ("qwen2.5-3b", 1, False), ("deepseek-v2-lite-16b", 4, False),
    ("falcon-mamba-7b", 1, True), ("jamba-v0.1-52b", 4, False),
    ("seamless-m4t-large-v2", 1, False)])
def test_captured_smoke_prefill_equals_eager(cuda, arch, t, pallas):
    """Three SMOKE prefills on the card, captured and eager on the same
    bf16 weights and batches: the logits (the encoder memory) bit for bit
    and the launch counts equal (falcon through the scan kernel; the
    flash kernel refuses SMOKE's head dim, so the others run plain)."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as TM
    cfg, run = _smoke_cell(arch, t, "prefill", use_pallas=pallas)
    params = TM.init_params(cfg, run, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    batches = []
    for _ in range(3):
        batch = {}
        for name, (shp, dtype) in TM.input_specs(cfg, run.shape,
                                                 run).items():
            batch[name] = (torch.randn(shp, generator=gen, device=cuda)
                           * 0.02).to(dtype) if dtype.is_floating_point \
                else torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                   device=cuda, dtype=dtype)
        batches.append(batch)

    def run_prefills():
        plan = build_cell(cfg, run.shape, run)
        outs = [plan.step_fn(params, b) for b in batches]
        return outs, [p.replays for p in
                      plan.step_fn.__wrapped__.programs.values()]
    (got, cg), (want, cw) = _captured_and_eager(run_prefills)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert got[1] == [2] and want[1] == []
    assert cg == cw, (cg, cw)
    if pallas:
        assert cg["selective_scan"] > 0


def test_captured_paged_callbacks_equal_eager_on_card(cuda):
    """The paged decode (the JAX example's geometry) on the card, its
    attention callback captured (one CUDA graph a shape) and eager: every
    decode output, the final pool and page table bit for bit, the launch
    counts equal, no leaked page."""
    from repro_torch.launch.paged_decode import run_decode
    kw = dict(n_requests=16, device=cuda, record=True, seed=2)
    (got, cg), (want, cw) = _captured_and_eager(lambda: run_decode(**kw))
    assert got["programs"]["count"] > 1 and want["programs"]["count"] == 0
    assert len(got["ys"]) == len(want["ys"]) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got["ys"], want["ys"]))
    assert all(torch.equal(got["pool"][k], want["pool"][k])
               for k in ("k", "v"))
    assert cg == cw and cg["paged_attention"] > 0, (cg, cw)
    assert got["audit"]["leaked"] == 0 and got["audit"]["consistent"]
