"""The MoE slice's CUDA kernels on the card: ``grouped_matmul`` against its
plain version at the deepseek-v2-lite-16b prefill's and decode's shapes,
ragged C / D / F, E = 1 and C = 1, and with per-expert ``counts`` (0, a
partial tile, exactly a tile, C), within
``kernels/grouped_matmul.py::tolerance``; f32 refused; ``flash_attention``
at head dim 192 (the MLA prefill); and a 2-layer deepseek-width model
(the dense first layer and one MoE layer, full widths, T = 4) whose kernel
path equals its plain path.  Every test carries the ``gpu`` marker and
skips where no CUDA device is present (decided in the ``cuda`` fixture);
the module imports no JAX.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_*.py
"""
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.testing.model import (FlashCheck, GmmCheck, flash_within,
                                       gmm_within)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _xw(dev, e, c, d, f, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((e, c, d), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((e, d, f), generator=g, device=dev) / d ** 0.5).to(
        torch.bfloat16)
    return x, w


@pytest.mark.parametrize("e,c,d,f", [
    (64, 3072, 2048, 1408),     # prefill B 4 x 2048, T 4: gate / up
    (64, 3072, 1408, 2048),     # and down
    (64, 8, 2048, 1408),        # decode B 8, T 4
    (64, 8, 1408, 2048),
    (3, 13, 72, 40),            # ragged C, D, F
    (2, 200, 77, 33),           # D and F not multiples of 8
    (1, 129, 256, 136),         # E = 1
    (4, 1, 2048, 1408),         # C = 1
])
def test_grouped_matmul_kernel_matches_plain(cuda, e, c, d, f):
    x, w = _xw(cuda, e, c, d, f)
    got = tops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    want = tops.grouped_matmul(x, w, impl="ref")
    ok, err = gmm_within(got, want, x, w)
    assert ok, err
    assert got.shape == (e, c, f) and got.dtype == torch.bfloat16


def test_grouped_matmul_zero_rows_answer_zeros(cuda):
    x, w = _xw(cuda, 4, 64, 256, 128)
    x[:, 20:] = 0
    got = tops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert bool((got[:, 20:] == 0).all())


def _counted(x, seed=0):
    """counts cycling through 0, a partial 128-row tile, exactly a tile
    and C (the prefill's shape: the serve's spread around a quarter of
    C), x's rows at and past each count zeroed as the pack leaves them"""
    e, c, _ = x.shape
    if c >= 1024:
        g = torch.Generator().manual_seed(seed)
        n = torch.randint(c // 8, c // 2, (e,), generator=g)
        n[:4] = torch.tensor([0, 77, 128, c])
    else:
        n = torch.tensor([[0, min(77, c), min(128, c), c][i % 4]
                          for i in range(e)])
    counts = n.to(torch.int32).to(x.device)
    rows = torch.arange(c, device=x.device)
    x = torch.where((rows[None, :] < counts[:, None])[..., None], x,
                    torch.zeros_like(x))
    return x, counts


@pytest.mark.parametrize("e,c,d,f", [
    (64, 3072, 2048, 1408),     # prefill gate / up
    (64, 3072, 1408, 2048),     # prefill down
    (64, 8, 2048, 1408),        # decode
    (5, 300, 136, 264),         # ragged C and F, D past one stage
    (4, 13, 72, 40),            # ragged C, D, F
    (4, 200, 77, 33),           # D and F not multiples of 8
])
def test_grouped_matmul_kernel_with_counts(cuda, e, c, d, f):
    """Tiles at and past counts[e] are stored as zeros with no product:
    the whole (E, C, F) output is within the tolerance of the plain
    version with the counts and without them, and zero past the counts."""
    x, w = _xw(cuda, e, c, d, f, seed=c)
    x, counts = _counted(x, seed=d)
    tops.reset_launch_counts()
    got = tops.grouped_matmul(x, w, counts)
    torch.cuda.synchronize()
    for want in (tops.grouped_matmul(x, w, counts, impl="ref"),
                 tops.grouped_matmul(x, w, impl="ref")):
        ok, err = gmm_within(got, want, x, w)
        assert ok, err
    rows = torch.arange(c, device=cuda)
    past = (rows[None, :] >= counts[:, None])[..., None].expand_as(got)
    assert bool((got[past] == 0).all())
    assert tops.launch_counts()["grouped_matmul"] == 1


def test_grouped_matmul_refuses_bad_counts(cuda):
    x, w = _xw(cuda, 4, 16, 64, 32)
    for bad in (torch.zeros(4, dtype=torch.int64, device=cuda),
                torch.zeros(3, dtype=torch.int32, device=cuda),
                torch.zeros(4, dtype=torch.int32)):
        with pytest.raises(ValueError, match="counts"):
            tops.grouped_matmul(x, w, bad)


def test_grouped_matmul_refuses_f32(cuda):
    x, w = _xw(cuda, 2, 16, 64, 32)
    with pytest.raises(TypeError, match="bfloat16"):
        tops.grouped_matmul(x.float(), w.float())
    with pytest.raises(ValueError, match="E, D, F"):
        tops.grouped_matmul(x, w[:, :32])


@pytest.mark.parametrize("b,h,s", [(4, 16, 2048), (1, 4, 333), (2, 16, 64)])
def test_flash_kernel_at_head_dim_192(cuda, b, h, s):
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn((b, s, h, 192), generator=g, device=cuda)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    v = torch.nn.functional.pad(v[..., :128], (0, 64))   # MLA's padded V
    got = tops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ok, err = flash_within(got, tops.flash_attention(q, k, v, impl="ref"), v)
    assert ok, err
    assert bool((got[..., 128:] == 0).all())


def test_two_layer_deepseek_kernel_path_equals_plain_path(cuda,
                                                         monkeypatch):
    """deepseek-v2-lite-16b at full width, cut to 2 layers (the dense
    first layer and one MoE layer), B 2 x 256, T = 4 trustees: the kernel
    path (flash at D 192, the grouped matmul, every call held against its
    plain version) and the plain path, its router pinned to the kernel
    path's choice of experts, give the same logits within 2e-2 relative
    RMS: the kernels round at the places the plain path rounds, their f32
    sums taken in another order (one bf16 ulp, 2^-8, at a rounding), and
    the flash kernel also rounds P to bf16.  (Unpinned, a token whose
    6th and 7th router probabilities lie closer than that rounding takes
    another expert in one path and moves by a whole expert's output.)"""
    import dataclasses
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import compiled
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    chosen, real_top_k = [], moe_mod.top_k

    def record(probs, k):
        vals, idx = real_top_k(probs, k)
        chosen.append(idx)
        return vals, idx

    def replay(probs, k):
        idx = chosen.pop(0)
        return torch.gather(probs, -1, idx), idx
    cfg = get_arch("deepseek-v2-lite-16b").with_overrides(n_layers=2)
    run = RunConfig(model=cfg, shape=ShapeConfig("p", 256, 2, "prefill"),
                    mesh=MeshConfig((1, 4), ("data", "model")),
                    remat="none", use_pallas=True)
    params = M.init_params(cfg, run, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda)
    tops.reset_launch_counts()
    monkeypatch.setattr(moe_mod, "top_k", record)
    with FlashCheck() as fchk, GmmCheck() as gchk:
        kern = build_cell(cfg, run.shape, run).step_fn(params,
                                                       {"tokens": tokens})
        torch.cuda.synchronize()
    counts = tops.launch_counts()
    assert counts["flash_attention"] == 2 and counts["grouped_matmul"] == 3
    assert fchk.summary()["flash_calls_out_of_tolerance"] == 0
    assert gchk.summary()["gmm_calls_out_of_tolerance"] == 0
    plain_run = dataclasses.replace(run, use_pallas=False)
    monkeypatch.setattr(moe_mod, "top_k", replay)
    # the replayed router is host state that each run of the step pops:
    # the plain path runs once, eagerly (a captured prefill's first call
    # runs the step twice, eagerly and into the capture)
    with compiled.disable():
        plain = build_cell(cfg, run.shape, plain_run).step_fn(
            params, {"tokens": tokens})
    assert not chosen
    rel = float((kern - plain).norm() / plain.norm())
    assert rel < 2e-2, rel
    assert bool(torch.isfinite(kern).all())
