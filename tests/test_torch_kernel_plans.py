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
"""
import os
import re

import numpy as np
import pytest
import torch

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
