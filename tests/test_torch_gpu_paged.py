"""The paged-decode slice's CUDA kernels against their plain PyTorch
versions, on the card: ``paged_attention`` in f32, bf16 and f16 at the
main path's shapes and at the edge cases (a chain over several splits, B
1, pages read without bulk copies, length 0), ``pagetable_serve`` bit for bit on
the stress trace and on random op passes straight through the kernel (a
main-path geometry, PL 200 off the bitmap's 32-page words, PL 2048 with
more words than lanes, received rows past the kernel's 8192-row
compaction pass, more valid rows than its 2048-row list, trustees with no valid row whose state must stay untouched, and
phantom pages holding 2 that no row touches).  Every test carries the ``gpu`` marker and skips where
no CUDA device is present (decided in the ``cuda`` fixture); the module
imports no JAX.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_*.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DelegatedPageTable, StackedMesh, use_session
from repro_torch.kernels import ops as tops
from repro_torch.kernels.paged_attention import TOLERANCE
from repro_torch.testing.pagetable import (STRESS_GEOMETRY, replay_waves,
                                           stress_waves, submit_waves)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _pa_case(dev, dtype, b, hq, hkv, d, p, ps, mp, lengths, seed,
             pad_inside=False):
    """Random q and pools; each sequence's chain is a random run of
    distinct pages covering its length, -1 past it (and, with
    ``pad_inside``, one -1 inside it, read as page 0)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, d))
    k = rng.normal(size=(p, hkv, ps, d))
    v = rng.normal(size=(p, hkv, ps, d))
    tbl = np.full((b, mp), -1, np.int32)
    for i, n in enumerate(lengths):
        live = min(-(-int(n) // ps), mp)
        tbl[i, :live] = rng.choice(p, live, replace=False)
        if pad_inside and live > 1:
            tbl[i, rng.integers(0, live)] = -1
    T = lambda a, dt=dtype: torch.as_tensor(a).to(dev, dt)
    return (T(q), T(k), T(v), T(tbl, torch.int32),
            T(np.asarray(lengths), torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", [
    # the main path's shapes: qwen2.5-3b attention (16 q / 2 kv heads of
    # 128), 16-token pages, 64-page chains, 64 sequences
    dict(b=64, hq=16, hkv=2, d=128, p=4096, ps=16, mp=64,
         lengths=list(range(1, 1025, 16))),
    dict(b=6, hq=16, hkv=2, d=128, p=64, ps=16, mp=4,
         lengths=[1, 16, 17, 32, 33, 64]),          # page boundaries
    dict(b=4, hq=4, hkv=4, d=64, p=40, ps=8, mp=5,
         lengths=[40, 1, 9, 39]),                   # rep 1, MP*PS == len
    dict(b=5, hq=8, hkv=2, d=128, p=80, ps=16, mp=8,
         lengths=[128, 100, 50, 17, 2], pad_inside=True),
    # B 1, one chain over all 16 splits of MP 64
    dict(b=1, hq=16, hkv=2, d=128, p=256, ps=16, mp=64, lengths=[1024]),
    # one sequence longer than a split beside short ones
    dict(b=3, hq=16, hkv=2, d=128, p=256, ps=16, mp=64,
         lengths=[700, 3, 64]),
    # 216-byte bf16 / f16 pages: read without bulk copies
    dict(b=3, hq=4, hkv=2, d=36, p=30, ps=3, mp=10, lengths=[30, 1, 17]),
    # D 64, two 16-position groups a page; 16 query heads on one KV head
    dict(b=4, hq=8, hkv=1, d=64, p=40, ps=32, mp=6,
         lengths=[192, 33, 1, 100]),
    dict(b=2, hq=16, hkv=1, d=128, p=40, ps=16, mp=8, lengths=[128, 77]),
    # 32-64 KB pages: fewer stages than a split's pages, so the ring
    # refills a stage
    dict(b=2, hq=4, hkv=2, d=256, p=40, ps=64, mp=16, lengths=[1000, 64]),
])
def test_paged_attention_kernel_matches_plain(cuda, dtype, case):
    """Within ``TOLERANCE`` of the working dtype (f32: 2e-5): f32 sums in
    another order, and in bf16 or f16 one rounding flip at most."""
    args = _pa_case(cuda, dtype, seed=len(case["lengths"]), **case)
    got = tops.paged_attention(*args)
    torch.cuda.synchronize()
    want = tops.paged_attention(*args, impl="ref")
    rtol, atol = TOLERANCE[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        float(err.max())


def test_paged_attention_length_zero_answers_zeros(cuda):
    """A length of 0 is undefined: the kernel answers zeros (the plain
    version a mean of V; ROADMAP queue C's settled divergence)."""
    args = _pa_case(cuda, torch.bfloat16, b=3, hq=16, hkv=2, d=128, p=64,
                    ps=16, mp=64, lengths=[0, 40, 0], seed=3)
    got = tops.paged_attention(*args)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all()) and bool((got[2] == 0).all())
    want = tops.paged_attention(*args, impl="ref")
    rtol, atol = TOLERANCE[torch.bfloat16]
    err = (got[1].float() - want[1].float()).abs()
    assert bool((err <= atol + rtol * want[1].float().abs()).all())


@pytest.mark.parametrize("shortcut", [True, False])
def test_pagetable_serve_kernel_matches_plain_and_oracle(cuda, shortcut):
    """The stress trace (eviction cascades, heals, infeasible requests,
    free and alloc in one wave) through the page table on the card and on
    the CPU: every response and the final state bit for bit, and both
    equal to the sequential oracle replayed in serve order."""
    g = STRESS_GEOMETRY
    runs = {}
    tops.reset_launch_counts()
    for dev in (cuda, torch.device("cpu")):
        with use_session():
            pt = DelegatedPageTable(StackedMesh((2, 4), device=dev),
                                    g["n_pages"], max_seqs=g["max_seqs"],
                                    page_size=g["page_size"],
                                    max_pages=g["max_pages"], capacity=256,
                                    local_shortcut=shortcut)
            rec = submit_waves(pt, stress_waves(5))
            replay_waves(pt, rec)
            runs[dev.type] = ([[pt.globalize(f.result(), s) for _, s, _, f
                                in w] for w in rec], pt.dump())
    assert tops.launch_counts()["pagetable_serve"] > 0
    (gw, gs), (ww, ws) = runs["cuda"], runs["cpu"]
    for a, b in zip(gw, ww):
        for ra, rb in zip(a, b):
            assert all(np.array_equal(ra[k], rb[k]) for k in rb)
    assert all(np.array_equal(gs[k], ws[k]) for k in ws)


_PT_NAMES = ("used", "chains", "chain_len", "last_used", "clock",
             "evictions")


def _pt_fresh(t, pl, sl, mp):
    z = lambda *sh: torch.zeros(sh, dtype=torch.int32)
    return {"used": z(t, pl), "chains": torch.full((t, sl, mp), -1,
                                                   dtype=torch.int32),
            "chain_len": z(t, sl), "last_used": z(t, sl), "clock": z(t, 1),
            "evictions": z(t, 1)}


def _pt_rows(rng, t, sl, n, p_valid, idle, arg):
    """seq (each row routed to its own trustee), arg, valid; the trustees
    in ``idle`` get no valid row."""
    seq = rng.integers(0, sl, (t, n)) * t + np.arange(t)[:, None]
    valid = rng.random((t, n)) < p_valid
    valid[list(idle)] = False
    return (torch.as_tensor(seq, dtype=torch.int32),
            torch.as_tensor(arg, dtype=torch.int32),
            torch.as_tensor(valid))


@pytest.mark.parametrize("t,pl,sl,mp,n,p_valid", [
    (8, 512, 8, 64, 4112, 0.02),    # the paged decode's geometry
    (4, 200, 16, 16, 300, 0.02),    # PL off the bitmap's 32-page words
    (2, 2048, 64, 64, 9000, 0.02),  # 64 words > 32 lanes; 2 passes
    (2, 256, 32, 16, 5000, 0.6),    # ~3000 valid rows: 2 list windows
])
def test_pagetable_serve_kernel_random_passes(cuda, t, pl, sl, mp, n,
                                              p_valid):
    """Random alloc / append / lookup / free passes on a state filled by
    the plain version until allocations evict: every valid row's
    responses and the whole state bit for bit the plain version's; the
    idle trustees' state untouched; phantom pages (used == 2) that no
    row touches still 2.  Where the chains can outgrow the pool, the
    passes evict."""
    rng = np.random.default_rng(pl + n)
    ps = 16
    plain = _pt_fresh(t, pl, sl, mp)
    for _ in range(6):       # fill the pools (plain only)
        rows = _pt_rows(rng, t, sl, 64, 0.5, (),
                        rng.integers(1, mp + 1, (t, 64)))
        tops.pagetable_serve(0, plain, *rows, t, ps)
    free = np.argwhere(plain["used"].numpy() == 0)
    for ti, p in free[rng.choice(len(free), min(len(free), 3 * t),
                                 replace=False)]:
        plain["used"][ti, p] = 2             # phantom: never handed out
    phantom = plain["used"] == 2
    card = {k: v.to(cuda, copy=True) for k, v in plain.items()}
    idle = (t - 1,)
    passes = [(0, lambda: rng.integers(-2, mp + 4, (t, n))),
              (1, lambda: rng.integers(-ps, (mp + 2) * ps, (t, n))),
              (3, lambda: np.zeros((t, n))),
              (2, lambda: np.zeros((t, n))),
              (0, lambda: rng.integers(1, mp // 2 + 1, (t, n)))]
    tops.reset_launch_counts()
    for op, arg in passes:
        seq, a, valid = _pt_rows(rng, t, sl, n, p_valid, idle, arg())
        before = {k: v.clone() for k, v in card.items()}
        want = tops.pagetable_serve(op, plain, seq, a, valid, t, ps)
        got = tops.pagetable_serve(op, card, seq.to(cuda), a.to(cuda),
                                   valid.to(cuda), t, ps)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu()[valid], w[valid]), op
        for k in _PT_NAMES:
            assert torch.equal(card[k].cpu(), plain[k]), (op, k)
            assert torch.equal(card[k][list(idle)], before[k][list(idle)])
        assert bool((card["used"].cpu()[phantom] == 2).all()), op
    assert tops.launch_counts()["pagetable_serve"] == len(passes)
    if pl < sl * mp:          # the chains can outgrow the pool
        assert int(plain["evictions"].sum()) > 0


def test_pagetable_serve_kernel_info_and_empty_launch(cuda):
    """The kernel as built at the paged decode's trustee (PL 512, SL 8,
    MP 64) fits a block, and the empty launch of its grid runs without
    counting as a serve launch."""
    from repro_torch.kernels import pagetable_serve as kpt
    info = kpt.kernel_info(512, 8, 64)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    assert info["smem"] == kpt.smem_bytes(512, 8, 64)
    before = tops.launch_counts()["pagetable_serve"]
    kpt.empty_launch(8, info["smem"], cuda)
    torch.cuda.synchronize()
    assert tops.launch_counts()["pagetable_serve"] == before
