"""The dry run on the meta device and the H100 rooflines
(``repro_torch.launch.dryrun`` / ``rooflines``), against the JAX
package's plain-Python counterparts (its configs, ``rooflines`` and the
cell rules of ``launch.dryrun``; nothing of JAX is compiled):

  * ``SHAPES``, ``cell_runnable``, ``model_flops``, ``_n_groups`` /
    ``_reduced`` and ``render``'s header equal JAX's;
  * each per-kernel bound function gives PERF.md's bound column at the
    table's shapes, to its printed digits (the kernels whose work does
    not depend on the data: flash, grouped matmul, paged attention, the
    scan);
  * a dense cell's counted FLOPs equal a closed form, exactly;
  * the 1- and 2-group extrapolation equals the full-depth count for a
    dense, an MoE and a hybrid architecture at SMOKE width on (2, 4);
  * qwen2-vl-2b's prefill (M-RoPE) builds on meta; no tensor off the meta
    device is seen; a decode cell's arguments are ``serve.check_fits``'s
    bytes;
  * the kernel wrappers' meta branch checks as the card does and records
    its work, and launches nothing.
"""
import contextlib
import io
import os

import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import (get_arch, get_smoke_arch,
                                          list_archs)
from repro_torch.launch import dryrun, rooflines

MESH24 = MeshConfig((2, 4), ("data", "model"))


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side on one intra-op thread: SMOKE-sized ops gain
    nothing from more, and beside the other test workers on the same
    cores the extra threads spin against them."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_dryrun():
    """JAX's dry-run module, imported with the environment it sets (a
    512-device XLA flag for its own process) put back at once."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


def test_shapes_equal_jax():
    from repro.configs.base import SHAPES, SHAPES_BY_NAME
    key = lambda s: (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode)
    assert [key(s) for s in tbase.SHAPES] == [key(s) for s in SHAPES]
    assert sorted(tbase.SHAPES_BY_NAME) == sorted(SHAPES_BY_NAME)


@pytest.mark.parametrize("arch", list_archs())
def test_cell_rules_equal_jax(arch, jax_dryrun):
    from repro.configs.base import SHAPES
    from repro.configs.registry import get_arch as jget
    from repro.launch import rooflines as jr
    jd = jax_dryrun
    for ts, js in zip(tbase.SHAPES, SHAPES):
        assert dryrun.cell_runnable(get_arch(arch), ts) == \
            jd.cell_runnable(jget(arch), js)
    cfg, jcfg = get_arch(arch), jget(arch)
    assert dryrun._n_groups(cfg) == jd._n_groups(jcfg)
    for g in (1, 2):
        a, b = dryrun._reduced(cfg, g), jd._reduced(jcfg, g)
        assert (a.n_layers, a.n_encoder_layers) == \
            (b.n_layers, b.n_encoder_layers)
    assert dryrun.RUN_OVERRIDES.get(arch, {}) == {
        k: v for k, v in jd.RUN_OVERRIDES.get(arch, {}).items()
        if k != "fsdp_inference"}
    assert dryrun.TRAIN_REMAT == jd.TRAIN_REMAT
    for kind in ("train", "prefill", "decode"):
        for n, tok in ((3_085_938_688, 1_048_576), (2_660_000_000, 128)):
            assert rooflines.model_flops(kind, n, tok) == \
                jr.model_flops(kind, n, tok)


def test_render_prints_jax_header():
    from repro.launch import rooflines as jr
    heads = []
    for mod in (rooflines, jr):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.render([])
        heads.append(buf.getvalue().splitlines()[0])
    assert heads[0] == heads[1]
    assert rooflines.fraction({"roofline": dict(
        compute_s=2.0, memory_s=1.0, collective_s=0.5,
        model_flops_per_chip=rooflines.PEAK_FLOPS)}) == 0.5


# PERF.md §6, bound ms column (NVIDIA H100 80GB HBM3): the shapes of each
# row and the bound it prints
@pytest.mark.parametrize("args,want", [
    # flash: qwen D 128 / deepseek MLA D 192 prefill, B 4 x 2048, causal
    ((4, 16, 2, 2048, 2048, 128), 0.069518),
    ((4, 16, 16, 2048, 2048, 192), 0.104277),
    ((4, 16, 16, 2048, 2048, 256), 0.139035),      # gemma
    ((4, 32, 8, 2048, 2048, 128), 0.139035),       # qwen3-4b, jamba
    ((4, 40, 40, 2048, 2048, 128), 0.173794),      # qwen1.5-32b
    ((4, 12, 2, 2048, 2048, 128), 0.052138),       # qwen2-vl-2b
    ((4, 56, 8, 2048, 2048, 128), 0.243312),       # arctic
])
def test_flash_bound_matches_perf_table(args, want):
    w = rooflines.flash_work(*args)
    assert round(w.ms, 6) == want and w.bound_by == "operations"


def test_flash_bound_not_causal():
    # seamless's encoder: D 64, 16 heads, not causal
    w = rooflines.flash_work(4, 16, 16, 2048, 2048, 64, causal=False)
    assert round(w.ms, 6) == 0.069484


@pytest.mark.parametrize("shape,kw,want,by", [
    ((64, 3072, 2048, 1408), dict(rows=49152, experts=64), 0.335544,
     "bytes"),                                     # deepseek prefill
    ((64, 8, 2048, 1408), dict(rows=48, experts=32), 0.055578,
     "bytes"),                                     # deepseek decode step
    ((16, 4096, 4096, 14336), dict(rows=16384, experts=16), 1.945546,
     "operations"),                                # jamba gate projection
    ((128, 512, 7168, 4864), dict(rows=16384, experts=128), 2.924745,
     "bytes"),                                     # arctic gate projection
])
def test_gmm_bound_matches_perf_table(shape, kw, want, by):
    w = rooflines.gmm_work(*shape, **kw)
    assert round(w.ms, 6) == want and w.bound_by == by


def test_paged_and_scan_bounds_match_perf_table():
    # paged decode at qwen2.5-3b attention width: B 63, 1,320 live pages
    # of 16 (20,577 positions)
    w = rooflines.paged_attention_work(63, 16, 2, 16, 128, 1320)
    assert round(w.ms, 6) == 0.006610 and w.bound_by == "bytes"
    # falcon prefill's scan: B 4 x 2048, DI 8192, N 16, bf16, 1980 MHz
    w = rooflines.scan_work(4, 2048, 8192, 16, 2, clock_mhz=1980)
    assert round(w.ms, 6) == 0.256768 and w.bound_by == "exponentials"


def test_causal_pairs_closed_form():
    import numpy as np
    for sq, skv, off in ((5, 5, 0), (5, 9, 4), (5, 3, 0), (7, 4, 2),
                         (3, 10, 0), (1, 1, 0), (4, 4, 9)):
        seen = int(np.clip(off + np.arange(sq) + 1, 0, skv).sum())
        assert rooflines.causal_pairs(sq, skv, off) == seen


def _cell(tmp, arch, shape, cfg=None, mesh=MESH24, **kw):
    return dryrun.run_cell(arch, shape.name, "single",
                           cfg=get_smoke_arch(arch) if cfg is None else cfg,
                           mesh_config=mesh, shape=shape, art_dir=str(tmp),
                           verbose=False, **kw)


def test_dense_prefill_flops_equal_closed_form(tmp_path):
    """qwen2.5-3b at full width, 2 layers, B 2 x 64 through the flash
    kernel's meta branch: the projections, the MLP, the attention kernel's
    4 D per kept pair and the last position's logits — exactly."""
    cfg = get_arch("qwen2.5-3b").with_overrides(n_layers=2)
    r = _cell(tmp_path, "qwen2.5-3b",
              ShapeConfig("prefill_32k", 64, 2, "prefill"), cfg=cfg)
    assert r["status"] == "ok", r.get("trace")
    b, s, d, hq, hkv, dh, f, v, layers = 2, 64, 2048, 16, 2, 128, 11008, \
        151936, 2
    t = b * s
    per_layer = (2 * t * d * hq * dh + 2 * 2 * t * d * hkv * dh
                 + 2 * t * hq * dh * d + 3 * 2 * t * d * f
                 + 4 * dh * hq * b * (s * (s + 1) // 2))
    assert r["cost"]["flops"] == layers * per_layer + 2 * b * d * v
    assert r["kernels"]["flash_attention"]["calls"] == layers
    assert r["devices"] == ["meta"]


@pytest.mark.parametrize("arch,shape,layers", [
    ("qwen2.5-3b", ShapeConfig("train_4k", 32, 8, "train"), 4),
    ("deepseek-v2-lite-16b", ShapeConfig("decode_32k", 64, 4, "decode"), 4),
    ("jamba-v0.1-52b", ShapeConfig("decode_32k", 64, 4, "decode"), 24),
])
def test_extrapolation_equals_full_depth_count(arch, shape, layers,
                                               tmp_path):
    cfg = get_smoke_arch(arch).with_overrides(n_layers=layers)
    r = _cell(tmp_path, arch, shape, cfg=cfg)
    assert r["status"] == "ok", r.get("trace")
    ex = r["extrapolation"]
    assert ex["n_groups"] >= 3
    assert r["cost"] == ex["cost_as_counted"]
    assert r["collectives"] == ex["coll_as_counted"]
    assert r["devices"] == ["meta"]
    if arch != "qwen2.5-3b":        # the MoE's channel rounds and kernels
        assert r["collectives"]["all-to-all"]["count"] > 0
        assert {"delegation_pack", "grouped_matmul"} <= set(r["kernels"])


def test_mrope_prefill_builds_on_meta(tmp_path):
    cfg = get_arch("qwen2-vl-2b").with_overrides(n_layers=1)
    r = _cell(tmp_path, "qwen2-vl-2b",
              ShapeConfig("prefill_32k", 64, 2, "prefill"), cfg=cfg)
    assert r["status"] == "ok", r.get("trace")
    assert r["devices"] == ["meta"]
    assert r["kernels"]["flash_attention"]["calls"] == 1


def test_decode_arguments_are_check_fits_bytes(tmp_path):
    from repro_torch.models import model as M
    cfg = get_smoke_arch("qwen3-4b")
    shape = ShapeConfig("decode_32k", 64, 4, "decode")
    r = _cell(tmp_path, "qwen3-4b", shape, cfg=cfg)
    assert r["status"] == "ok", r.get("trace")
    run = RunConfig(model=cfg, shape=shape, mesh=MESH24, use_pallas=True)
    inputs = sum(torch.Size(s).numel() * torch.empty((), dtype=dt)
                 .element_size()
                 for s, dt in M.input_specs(cfg, shape, run).values())
    assert r["memory"]["argument_size_in_bytes"] == (
        M.param_nbytes(cfg, run) + M.cache_nbytes(cfg, 4, 64, run) + inputs)
    assert r["hbm_bytes_per_device"] == (
        r["memory"]["argument_size_in_bytes"]
        + r["memory"]["temp_size_in_bytes"])
    assert r["fits_hbm"] and r["roofline"]["bottleneck"] == "memory"


def test_counting_mode_peak_shares_views():
    with dryrun.CountingMode() as mode:
        x = torch.empty((1024,), device="meta")
        y = x[:512].view(2, 256)          # a view: no new storage
        z = y + 1                         # 2 KB more
        del x, y
    assert mode.peak == 4096 + 2048
    assert mode.devices == {"meta"}
    assert mode.nbytes == 2048 + 2048     # z: y read, z written
    del z


def test_wrappers_meta_branch_records_work_and_launches_nothing():
    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    m = dict(device="meta")
    q = torch.empty((2, 4, 64, 128), dtype=torch.bfloat16, **m)
    k = torch.empty((2, 2, 64, 128), dtype=torch.bfloat16, **m)
    x = torch.empty((4, 16, 64), dtype=torch.bfloat16, **m)
    w = torch.empty((4, 64, 32), dtype=torch.bfloat16, **m)
    with rooflines.counting_kernels() as tally:
        o = kops.flash_attention(q, k, k)
        g = kops.grouped_matmul(x, w)
        y, h = kops.selective_scan(
            torch.empty((1, 32, 64), dtype=torch.bfloat16, **m),
            torch.empty((1, 32, 64), dtype=torch.bfloat16, **m),
            torch.empty((64, 16), **m), torch.empty((1, 32, 16), **m),
            torch.empty((1, 32, 16), **m), torch.empty((64,), **m))
        kops.delegation_pack(torch.empty((8, 16), dtype=torch.int32, **m),
                             torch.empty((8, 16, 3), dtype=torch.int32, **m),
                             8, 4, 2)
    assert o.shape == q.shape and o.device.type == "meta"
    assert g.shape == (4, 16, 32) and y.dtype == torch.bfloat16 \
        and h.shape == (1, 64, 16)
    assert tally.by_kernel["flash_attention"]["ops"] == \
        rooflines.flash_work(2, 4, 2, 64, 64, 128).ops
    assert tally.by_kernel["grouped_matmul"]["bytes"] == \
        rooflines.gmm_work(4, 16, 64, 32).nbytes
    assert tally.by_kernel["delegation_pack"]["bytes"] == \
        rooflines.pack_work(8, 16, 3, 8, 4, 2).nbytes
    assert set(kops.launch_counts().values()) == {0}
    # a pack past 2^31 words (the MoE channel of a prefill_32k cell) is
    # the kernels' to take; a shard's rows past int32 are not
    big = kops.delegation_pack(
        torch.empty((16, 98_304), dtype=torch.int32, **m),
        torch.empty((16, 98_304, 2049), dtype=torch.int32, **m), 16, 8192,
        8192)
    assert big[0].shape == (16, 16 * 8192, 2049)
    with pytest.raises(ValueError, match="2\\^31"):
        kops.delegation_pack(torch.empty((1, 2 ** 31), dtype=torch.int32, **m),
                             torch.empty((1, 2 ** 31, 1), dtype=torch.int32,
                                         **m), 8, 4)
    # the meta branch comes after the card's checks
    with pytest.raises(TypeError, match="bfloat16"):
        kops.flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="head dim"):
        kops.flash_attention(q[..., :16], k[..., :16], k[..., :16])


def test_render_delegation_and_serve_bound():
    d = rooflines.delegation_serve_roofline(8192, 125_000, 4)
    assert d["bottleneck"] == "memory" and d["hbm_bytes"] > 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = rooflines.render_delegation([1024, 8192], 125_000, 4)
    assert len(rows) == 2 and buf.getvalue().startswith("rows")


def test_mrope_train_microbatches_split_positions():
    """A qwen2-vl-2b train step over 2 microbatches cuts M-RoPE's (3, B,
    S) positions along the batch, as JAX's ``_stack_micro`` does: its
    loss is the mean of the two halves' losses."""
    from repro_torch.launch.steps import _micro, build_cell, value_and_grad
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import init_adamw
    cfg = get_smoke_arch("qwen2-vl-2b")
    shape = ShapeConfig("t", 16, 4, "train")
    run = RunConfig(model=cfg, shape=shape, grad_accum=2, remat="none",
                    param_dtype="float32", activation_dtype="float32")
    g = torch.Generator().manual_seed(0)
    batch = {"embeds": torch.randn((4, 16, cfg.d_model), generator=g),
             "positions": torch.randint(0, 16, (3, 4, 16), generator=g,
                                        dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (4, 16),
                                     generator=g, dtype=torch.int32)}
    half = _micro(batch, 2, 1)
    assert torch.equal(half["positions"], batch["positions"][:, 2:])
    assert torch.equal(half["embeds"], batch["embeds"][2:])
    params = M.init_params(cfg, run, "cpu")
    want = sum(value_and_grad(params, _micro(batch, 2, i), cfg, run)[0]
               for i in range(2)) / 2
    plan = build_cell(cfg, shape, run)
    _, _, metrics = plan.step_fn(params, init_adamw(params), batch)
    assert float(metrics["loss"]) == pytest.approx(float(want), rel=1e-6)
