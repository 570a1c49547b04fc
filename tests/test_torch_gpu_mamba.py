"""The Mamba slice's CUDA kernel on the card: ``selective_scan`` against
its plain version at the falcon-mamba-7b prefill's shape and at ragged,
short and generic-N ones (every lane plan of ``scan_plan``, padded and
exact, and an 8192-step sequence), in bf16 and f32, from h0 and from
zeros, within ``kernels/selective_scan.py::tolerance``; every plan built
without spills; two launches over the halves of
a sequence, the second from the first's h_final, against one launch; a
zero dt and a decay that underflows to 0; what the kernel refuses; and a
2-layer full-width falcon-mamba-7b prefill whose kernel path equals its
plain path.  Every test carries the ``gpu`` marker and skips where no
CUDA device is present (decided in the ``cuda`` fixture); the module
imports no JAX.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_*.py

The 2-layer prefill's logits are held to 2e-2 relative RMS: the two
paths differ only in the scan, whose bf16 outputs differ by about one
bf16 ulp (2^-8 relative), carried through two layers and the final norm.
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels.selective_scan import tolerance
from repro_torch.testing.model import ScanCheck, scan_within

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(dev, b, s, di, n, dtype, h0=False, seed=0, dt_scale=0.1):
    """x, dt (>= 0) in ``dtype``; a (< 0, S4D-like), b, c, d, h0 f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *sh: torch.randn(sh, generator=g, device=dev)
    a = -torch.arange(1, n + 1, device=dev, dtype=torch.float32) \
        * torch.rand((di, 1), generator=g, device=dev).add_(0.5)
    return (r(b, s, di).to(dtype), (r(b, s, di).abs() * dt_scale).to(dtype),
            a, r(b, s, n), r(b, s, n), r(di), r(b, di, n) if h0 else None)


def _check(args):
    got = tops.selective_scan(*args)
    torch.cuda.synchronize()
    want = tops.selective_scan(*args, impl="ref")
    ok, err = scan_within(got, want, args)
    assert ok, err
    assert got[0].dtype == args[0].dtype and got[1].dtype == torch.float32
    return got, want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,di,n,h0", [
    (4, 2048, 8192, 16, False),     # the falcon-mamba-7b prefill
    (2, 512, 8192, 16, True),
    (2, 333, 200, 16, True),        # ragged S and DI
    (1, 1, 128, 4, False),          # one step
    (1, 64, 256, 8, True),          # N off the exact instances
    (3, 130, 96, 4, False),         # DI under one tile
    (2, 100, 300, 64, True),        # the largest N
    (1, 257, 1000, 1, False),
    (2, 300, 512, 2, True),         # N 2: padding states in one lane
    (2, 200, 640, 32, True),        # N 32: four lanes of eight
    (2, 150, 384, 12, False),       # N 12: two lanes, four states padding
    (1, 96, 264, 40, True),         # N 40: eight lanes, ragged DI
    (1, 8192, 512, 16, True),       # the state carried over 8192 steps
])
def test_scan_kernel_matches_plain(cuda, dtype, b, s, di, n, h0):
    _check(_inputs(cuda, b, s, di, n, dtype, h0, seed=s + di))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 8, 16, 32, 64])
def test_scan_kernel_plans_build_without_spills(cuda, dtype, n):
    """Every lane plan's kernel holds its states in registers (no local
    memory) and two blocks fit an SM."""
    from repro_torch.kernels.selective_scan import kernel_info, scan_plan
    info = kernel_info(dtype, n)
    assert (info["lanes"], info["states_a_lane"]) == scan_plan(n)
    assert info["local_bytes"] == 0 and info["registers"] <= 128
    assert info["blocks_per_sm"] >= 2


def test_scan_kernel_chunk_carry(cuda):
    args = _inputs(cuda, 2, 1024, 512, 16, torch.float32, h0=True, seed=7)
    x, dt, a, b, c, d, h0 = args
    y, h = tops.selective_scan(*args)
    half = slice(0, 512), slice(512, 1024)
    y1, h1 = tops.selective_scan(x[:, half[0]], dt[:, half[0]], a,
                                 b[:, half[0]], c[:, half[0]], d, h0)
    y2, h2 = tops.selective_scan(x[:, half[1]], dt[:, half[1]], a,
                                 b[:, half[1]], c[:, half[1]], d, h1)
    torch.cuda.synchronize()
    _, atol_y, atol_h = tolerance(*args)
    assert bool(((torch.cat([y1, y2], 1) - y).abs() <= atol_y).all())
    assert bool(((h2 - h).abs() <= atol_h).all())


def test_scan_kernel_edge_values(cuda):
    x, dt, a, b, c, d, h0 = _inputs(cuda, 2, 96, 256, 16, torch.float32,
                                    h0=True, seed=3)
    # dt = 0: the state is carried unchanged and y = C . h0 + D x
    zero = torch.zeros_like(dt)
    (y, h), _ = _check((x, zero, a, b, c, d, h0))
    assert torch.equal(h, h0)
    # a very negative dt * a: the decay underflows to 0 at every step
    big = torch.full_like(dt, 100.0)
    (y, h), _ = _check((x, big, a * 100, b, c, d, h0))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())


def test_scan_kernel_refuses_what_it_does_not_take(cuda):
    args = list(_inputs(cuda, 1, 16, 64, 16, torch.float32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tops.selective_scan(args[0].half(), args[1].half(), *args[2:])
    with pytest.raises(TypeError, match="dt must be"):
        tops.selective_scan(args[0], args[1].to(torch.bfloat16), *args[2:])
    big = list(_inputs(cuda, 1, 16, 64, 65, torch.float32))
    with pytest.raises(ValueError, match="at most 64 states"):
        tops.selective_scan(*big)
    with pytest.raises(ValueError, match="a has shape"):
        tops.selective_scan(args[0], args[1], args[2][:32], *args[3:])
    with pytest.raises(TypeError, match="b must be"):
        tops.selective_scan(*args[:3], args[3].double(), *args[4:])


def test_full_width_prefill_through_the_kernel(cuda):
    """Two falcon-mamba-7b layers at full width (d_model 4096, d_inner
    8192, N 16, vocab 65024, bf16), B 2 x 256: every scan launch within
    tolerance of the plain version; the kernel path's logits within 2e-2
    relative RMS of the plain path's."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    cfg = get_arch("falcon-mamba-7b").with_overrides(n_layers=2)
    run = RunConfig(model=cfg, shape=ShapeConfig("p", 256, 2, "prefill"),
                    remat="none", use_pallas=True)
    params = M.init_params(cfg, run, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda)
    tops.reset_launch_counts()
    with ScanCheck() as chk:
        kern = build_cell(cfg, run.shape, run).step_fn(params,
                                                       {"tokens": tokens})
        torch.cuda.synchronize()
    assert tops.launch_counts()["selective_scan"] == 2
    s = chk.summary()
    assert s["scan_calls"] == 2 and s["scan_calls_out_of_tolerance"] == 0, s
    plain_run = dataclasses.replace(run, use_pallas=False)
    plain = build_cell(cfg, run.shape, plain_run).step_fn(
        params, {"tokens": tokens})
    rel = float((kern - plain).norm() / plain.norm())
    assert rel < 2e-2, rel
    assert bool(torch.isfinite(kern).all())
