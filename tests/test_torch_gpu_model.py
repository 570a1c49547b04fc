"""The model slice's CUDA kernel on the card: ``flash_attention`` against
its plain version at the prefill's shapes and at the edge cases (MQA,
MHA, ``q_offset`` with Sq < Skv, ``causal=False``, D 64 and 32, ragged
tails, the model's (B, S, H, D) layout), within
``kernels/flash_attention.py::tolerance``; and a short full-width
qwen2.5-3b prefill through it.  Every test carries the ``gpu`` marker and
skips where no CUDA device is present (decided in the ``cuda`` fixture);
the module imports no JAX.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_*.py
"""
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.testing.model import FlashCheck, flash_within

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _qkv(dev, b, hq, hkv, sq, skv, d, seed=0, bshd=False):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(h, s):
        shape = (b, s, h, d) if bshd else (b, h, s, d)
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        return x.transpose(1, 2) if bshd else x
    return rnd(hq, sq), rnd(hkv, skv), rnd(hkv, skv)


@pytest.mark.parametrize("shape,kw", [
    # the qwen2.5-3b prefill: 16 query / 2 KV heads of 128, 2048 tokens
    (dict(b=4, hq=16, hkv=2, sq=2048, skv=2048, d=128), {}),
    (dict(b=2, hq=16, hkv=2, sq=512, skv=512, d=128, bshd=True), {}),
    (dict(b=2, hq=8, hkv=1, sq=512, skv=512, d=128), {}),          # MQA
    (dict(b=2, hq=4, hkv=4, sq=384, skv=384, d=128), {}),          # MHA
    (dict(b=2, hq=16, hkv=2, sq=256, skv=1024, d=128),
     dict(q_offset=768)),                                          # shard
    (dict(b=2, hq=4, hkv=2, sq=256, skv=640, d=128), dict(causal=False)),
    (dict(b=2, hq=8, hkv=2, sq=1024, skv=1024, d=64), {}),
    (dict(b=1, hq=4, hkv=2, sq=256, skv=256, d=32), {}),
    (dict(b=2, hq=4, hkv=2, sq=200, skv=200, d=128), {}),          # ragged
    (dict(b=1, hq=4, hkv=1, sq=77, skv=333, d=64), dict(causal=False)),
    (dict(b=1, hq=8, hkv=2, sq=100, skv=357, d=128), dict(q_offset=257)),
])
def test_flash_kernel_matches_plain(cuda, shape, kw):
    q, k, v = _qkv(cuda, **shape)
    got = tops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = tops.flash_attention(q, k, v, impl="ref", **kw)
    ok, err = flash_within(got, want, v)
    assert ok, err
    assert got.shape == q.shape and got.dtype == torch.bfloat16


@pytest.mark.parametrize("shape,kw", [
    # the wgmma kernel's 128-row query tiles, its 128-key (D 128) and
    # 64-key (D 192) KV tiles: ragged Sq and Skv at both
    (dict(b=2, hq=4, hkv=2, sq=300, skv=300, d=128), {}),
    (dict(b=1, hq=4, hkv=4, sq=333, skv=333, d=192), {}),
    (dict(b=2, hq=4, hkv=2, sq=40, skv=40, d=128), {}),            # Sq < 64
    (dict(b=2, hq=4, hkv=4, sq=1, skv=1, d=192), {}),              # Skv 1
    (dict(b=1, hq=8, hkv=2, sq=200, skv=397, d=128),
     dict(q_offset=197)),                          # offset off the tiles
    (dict(b=1, hq=8, hkv=8, sq=300, skv=377, d=192), dict(q_offset=77)),
    (dict(b=1, hq=16, hkv=2, sq=512, skv=512, d=192), {}),         # rep 8
    (dict(b=1, hq=8, hkv=1, sq=256, skv=256, d=192), {}),          # MQA
    (dict(b=2, hq=4, hkv=4, sq=256, skv=256, d=192), {}),          # MHA
    (dict(b=2, hq=16, hkv=16, sq=384, skv=384, d=192, bshd=True), {}),
    (dict(b=2, hq=4, hkv=4, sq=256, skv=640, d=192), dict(causal=False)),
    # D 256 (gemma-7b): its 64-key KV tiles
    (dict(b=1, hq=4, hkv=4, sq=333, skv=333, d=256), {}),
    (dict(b=2, hq=4, hkv=4, sq=1, skv=1, d=256), {}),
    (dict(b=1, hq=8, hkv=8, sq=300, skv=377, d=256), dict(q_offset=77)),
    (dict(b=1, hq=8, hkv=1, sq=256, skv=256, d=256), {}),          # MQA
    (dict(b=2, hq=4, hkv=4, sq=200, skv=640, d=256), dict(causal=False)),
])
def test_flash_kernel_matches_plain_at_the_tile_edges(cuda, shape, kw):
    q, k, v = _qkv(cuda, seed=7, **shape)
    got = tops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = tops.flash_attention(q, k, v, impl="ref", **kw)
    ok, err = flash_within(got, want, v)
    assert ok, err


def test_flash_d256_at_the_gemma_prefill(cuda):
    """gemma-7b's prefill attention (16 heads of 256, B 4 x 2048, the
    model's (B, S, H, D) layout) within the tolerance, and the kernel as
    built: the wgmma kernel, 192 KB of shared memory and over, its
    registers read."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(cuda, 4, 16, 16, 2048, 2048, 256, seed=11, bshd=True)
    got = tops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ok, err = flash_within(got, tops.flash_attention(q, k, v, impl="ref"),
                           v)
    assert ok, err
    info = fa.kernel_info(256)
    assert info["kernel"] == "wgmma" and info["registers"] > 0, info
    assert info["smem"] >= 192 * 1024, info


def test_flash_offset_equals_rows_of_full_launch(cuda):
    q, k, v = _qkv(cuda, 1, 4, 2, 1024, 1024, 128, seed=3)
    full = tops.flash_attention(q, k, v)
    half = tops.flash_attention(q[:, :, 512:], k, v, q_offset=512)
    torch.cuda.synchronize()
    assert torch.equal(full[:, :, 512:], half)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 4, 2, 64, 64, 128)
    with pytest.raises(TypeError, match="bfloat16"):
        tops.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention(q[..., :96], k[..., :96], v[..., :96])
    with pytest.raises(ValueError, match="q_offset"):
        tops.flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="scale"):
        tops.flash_attention(q, k, v, scale=-0.1)


def test_full_width_prefill_through_the_kernel(cuda):
    """qwen2.5-3b at full width (36 layers), B 1 x 256: 36 flash launches,
    each held against the plain version; finite f32 logits."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    cfg = get_arch("qwen2.5-3b")
    run = RunConfig(model=cfg, shape=ShapeConfig("p", 256, 1, "prefill"),
                    remat="none", use_pallas=True)
    params = M.init_params(cfg, run, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), device=cuda)
    tops.reset_launch_counts()
    with FlashCheck() as chk:
        logits = build_cell(cfg, run.shape, run).step_fn(
            params, {"tokens": tokens})
        torch.cuda.synchronize()
    assert tops.launch_counts()["flash_attention"] == cfg.n_layers
    s = chk.summary()
    assert s["flash_calls"] == cfg.n_layers, s
    assert s["flash_calls_out_of_tolerance"] == 0, s
    assert logits.shape == (1, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
