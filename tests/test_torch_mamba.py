"""The port's Mamba slice (falcon-mamba-7b) against the JAX package, on
the CPU, with inputs and weights drawn with numpy (JAX SMOKE weights
carried across by ``convert``, their norm scales, conv bias, dt bias,
log(-A) and D perturbed from a numpy seed so none is a constant):

  * the plain scans — ``ref.selective_scan`` (sequential) and
    ``selective_scan_step`` — == JAX's ``ref.selective_scan``,
    ``selective_scan_assoc``, ``selective_scan_chunked`` (chunk sizes
    that do and do not divide S), ``selective_scan_step`` and the Pallas
    kernel in interpret mode, at the four shapes of
    ``tests/test_kernels.py``, from h0 and from zeros; the sequential scan
    carried chunk by chunk through h0 == one scan; and the kernel's stated
    tolerance covers the port's sequential scan against JAX's;
  * ``mamba_block`` == JAX's with ``use_pallas`` True and False and with
    JAX's ``mamba_chunked`` (the port has one plain path); ``mamba_decode``
    over 16 steps and its final (conv, ssm) cache == JAX's;
  * the falcon-mamba-7b SMOKE model (2 layers, d_model 64, d_inner 128,
    N 4, vocab 512): ``prefill`` == JAX ``M.prefill`` on both paths; 16
    teacher-forced ``decode_step`` logits and the final caches == JAX's;
    the serve's greedy tokens == a JAX decode loop's argmax wherever the
    top-2 margin exceeds ``MARGIN``; two serve runs and ``--mesh-model``
    1 and 4 give the same tokens; prefill and decode agree (bf16 and f32)
    as ``chip_smoke.py`` checks them; the configuration == JAX's;
  * a hybrid stack built from JAX's jamba SMOKE fields (an 8-layer group
    of Mamba, attention and MoE layers): prefill and 8 decode steps ==
    JAX's at T = 1;
  * ``convert`` keeps JAX's f32 leaves in f32 under a ``dtype``.

Tolerances: the sequential scans, and everything built on the scan in
f32, rtol = atol = 2e-5 (the same steps in the same order, summed by
another library: observed under 1e-5 at |y| up to 18); against JAX's
associative scan and the Pallas kernel 2e-4, JAX's own between its refs
(``tests/test_kernels.py``).  bf16 serve tokens are compared where JAX's
top-2 margin exceeds ``MARGIN`` = 0.02, as in ``test_torch_model.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

ARCH = "falcon-mamba-7b"
TOL = dict(rtol=2e-5, atol=2e-5)
TOL_ASSOC = dict(rtol=2e-4, atol=2e-4)
MARGIN = 0.02
B, STEPS = 2, 16
SERVE = dict(batch=2, prompt_len=8, gen=12)
SERVE_ARGV = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
              "8", "--gen", "12", "--device", "cpu"]
SCAN_SHAPES = [(1, 64, 256, 16), (2, 128, 64, 8), (1, 32, 8, 4),
               (2, 96, 40, 16)]


@pytest.fixture(autouse=True)
def _reset_mesh():
    from repro.core import meshctx
    meshctx.set_context(meshctx._default_mesh(), "default")
    yield


def _scan_inputs(b, s, di, n, seed=0, h0=True):
    """x, dt (>= 0), a (< 0), b, c, d, h0 as numpy f32."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    return (f(b, s, di), np.abs(f(b, s, di)) * 0.1, -np.abs(f(di, n)),
            f(b, s, n), f(b, s, n), f(di), f(b, di, n) if h0 else None)


def _jnp(args):
    import jax.numpy as jnp
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args):
    return [None if a is None else torch.as_tensor(a) for a in args]


def _perturb(tree, rng):
    """Norm scales, the conv bias, dt bias, log(-A) and D of a JAX tree
    moved off their constant initial values."""
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "scale" or k == "d_skip":
            v = (1 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
        elif k in ("conv_b", "log_a"):
            v = (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
        elif k == "b_dt":
            v = (v + 0.5 * rng.normal(size=v.shape)).astype(np.float32)
        out[k] = _perturb(v, rng)
    return out


def _jax_run(cfg, dtype="float32", use_pallas=False, kind="decode",
             chunked=False, chunk=8):
    from repro.configs.base import MeshConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("t", STEPS, B, kind),
                     mesh=MeshConfig((1, 1), ("data", "model")),
                     remat="none", param_dtype=dtype,
                     activation_dtype=dtype, use_pallas=use_pallas,
                     mamba_chunked=chunked, mamba_chunk=chunk)


def _port_run(cfg, dtype="float32", use_pallas=False, kind="decode"):
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("t", STEPS, B, kind),
                     mesh=MeshConfig((1, 1), ("data", "model")),
                     remat="none", param_dtype=dtype,
                     activation_dtype=dtype, use_pallas=use_pallas)


def _configs():
    from repro.configs.registry import SMOKE_ARCHS
    from repro_torch.configs.registry import get_smoke_arch
    return SMOKE_ARCHS[ARCH], get_smoke_arch(ARCH)


def _jax_params(cfg=None, seed=1):
    import jax
    from repro.models import model as JM
    cfg = cfg if cfg is not None else _configs()[0]
    p = jax.tree_util.tree_map(np.array, JM.init_params(
        jax.random.PRNGKey(seed), cfg, _jax_run(cfg)))
    return _perturb(p, np.random.default_rng(5))


def _port_params(p, dtype=None):
    from repro_torch import convert
    return convert.model_params_from_jax(p, device="cpu", dtype=dtype)


def _tokens(vocab, b=B, s=STEPS):
    return np.random.default_rng(9).integers(0, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the plain scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,di,n", SCAN_SHAPES)
def test_plain_scans_match_jax(b, s, di, n, with_h0):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels.selective_scan import tolerance
    args = _scan_inputs(b, s, di, n, h0=with_h0)
    *xs, h0 = args
    got_y, got_h = tref.selective_scan(*_torch(args))
    assert got_y.dtype == torch.float32 and got_h.shape == (b, di, n)
    seq = jref.selective_scan(*_jnp(xs), h0=_jnp([h0])[0])
    assoc = jref.selective_scan_assoc(*_jnp(xs), h0=_jnp([h0])[0])
    pallas = jops.selective_scan(*_jnp(xs), h0=_jnp([h0])[0],
                                 impl="pallas", bdi=8, bs=min(s, 32))
    for (want_y, want_h), tol in ((seq, TOL), (assoc, TOL_ASSOC),
                                  (pallas, TOL_ASSOC)):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **tol)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **tol)
    # the kernel's stated bound covers two sequential f32 scans
    rtol, atol_y, atol_h = tolerance(*_torch(args))
    assert rtol == 0.0
    err_y = np.abs(got_y.numpy() - np.asarray(seq[0]))
    err_h = np.abs(got_h.numpy() - np.asarray(seq[1]))
    assert (err_y <= atol_y.numpy()).all() and (err_h <= atol_h.numpy()).all()


@pytest.mark.parametrize("chunk", [7, 32, 48, 1000])
def test_chunked_scan_matches_jax(chunk):
    """The port's sequential scan == JAX's chunked one (a lax.scan over
    chunks, the associative scan inside; the associative scan alone where
    ``chunk`` does not divide S), and the sequential scan run ``chunk``
    steps at a time, each from the last one's h_final, == one scan."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    args = _scan_inputs(2, 96, 40, 16, seed=1)
    *xs, h0 = args
    want = tref.selective_scan(*_torch(args))
    jax_chunked = jref.selective_scan_chunked(*_jnp(xs), h0=_jnp([h0])[0],
                                              chunk=chunk)
    x, dt, a, b, c, d = _torch(xs)
    ys, h = [], torch.as_tensor(h0)
    for t0 in range(0, x.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        y, h = tref.selective_scan(x[:, sl], dt[:, sl], a, b[:, sl],
                                   c[:, sl], d, h0=h)
        ys.append(y)
    for w, j, g in zip(want, jax_chunked, (torch.cat(ys, 1), h)):
        np.testing.assert_allclose(w.numpy(), np.asarray(j), **TOL_ASSOC)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_scan_step_matches_jax_and_the_scan():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    x, dt, a, b, c, d, h0 = _scan_inputs(2, 16, 32, 8, seed=2)
    full_y, full_h = tref.selective_scan(*_torch((x, dt, a, b, c, d, h0)))
    th, jh = torch.as_tensor(h0), _jnp([h0])[0]
    for t in range(16):
        step = [x[:, t], dt[:, t], a, b[:, t], c[:, t], d]
        ty, th = tref.selective_scan_step(*_torch(step), th)
        jy, jh = jref.selective_scan_step(*_jnp(step), jh)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(ty.numpy(), full_y[:, t].numpy(), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(th.numpy(), full_h.numpy(), **TOL)


def test_kernel_wrapper_runs_the_plain_version_on_cpu():
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels.selective_scan import tolerance
    args = _torch(_scan_inputs(1, 40, 24, 4, seed=3))
    before = tops.launch_counts()["selective_scan"]
    got = tops.selective_scan(*args)
    want = tref.selective_scan(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tops.launch_counts()["selective_scan"] == before
    bf = [t.to(torch.bfloat16) if i < 2 else t for i, t in enumerate(args)]
    y, h = tops.selective_scan(*bf)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    rtol, atol_y, atol_h = tolerance(*bf)
    assert rtol > 2.0 ** -7 and atol_y.shape == y.shape \
        and atol_h.shape == h.shape
    with pytest.raises(ValueError, match="dt >= 0"):
        tolerance(args[0], -args[1], *args[2:])


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "kernel", "chunked"])
def test_mamba_block_matches_jax(mode):
    import jax
    import jax.numpy as jnp
    from repro.models import mamba as jmamba
    from repro_torch.models import mamba as tmamba
    jcfg, tcfg = _configs()
    mp = {k: v[0] for k, v in _jax_params()["groups"]["pos0"]["mamba"]
          .items()}
    x = np.random.default_rng(3).normal(size=(B, STEPS, jcfg.d_model)) \
        .astype(np.float32)
    kw = dict(use_pallas=mode == "kernel", kind="prefill")
    want = jax.jit(lambda p, xx: jmamba.mamba_block(
        p, xx, jcfg, _jax_run(jcfg, chunked=mode == "chunked", **kw)))(
        jax.tree_util.tree_map(jnp.asarray, mp), jnp.asarray(x))
    got = tmamba.mamba_block(_port_params(mp), torch.as_tensor(x), tcfg,
                             _port_run(tcfg, **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mamba_decode_matches_jax():
    import jax
    import jax.numpy as jnp
    from repro.models import mamba as jmamba
    from repro_torch import convert
    from repro_torch.models import mamba as tmamba
    jcfg, tcfg = _configs()
    mp = {k: v[1] for k, v in _jax_params()["groups"]["pos0"]["mamba"]
          .items()}
    jcache = jmamba.init_mamba_cache(jcfg, B, jnp.float32)
    tcache = tmamba.init_mamba_cache(tcfg, B, torch.float32, "cpu")
    step = jax.jit(lambda c, xx: jmamba.mamba_decode(
        jax.tree_util.tree_map(jnp.asarray, mp), xx, c, jcfg))
    tp = _port_params(mp)
    rng = np.random.default_rng(4)
    for _ in range(STEPS):
        x = rng.normal(size=(B, jcfg.d_model)).astype(np.float32)
        want, jcache = step(jcache, jnp.asarray(x))
        got, tcache = tmamba.mamba_decode(tp, torch.as_tensor(x), tcache,
                                          tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = convert.mamba_cache_to_numpy(tcache)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(got[k], np.asarray(jcache[k]), **TOL)


# ---------------------------------------------------------------------------
# the falcon-mamba-7b SMOKE model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_jax(use_pallas):
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro_torch.launch.steps import build_cell
    jcfg, tcfg = _configs()
    p = _jax_params()
    toks = _tokens(jcfg.vocab_size)
    run = _jax_run(jcfg, use_pallas=use_pallas, kind="prefill")
    want = jax.jit(lambda p_, t: JM.prefill(p_, {"tokens": t}, jcfg, run))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(toks))
    trun = _port_run(tcfg, use_pallas=use_pallas, kind="prefill")
    got = build_cell(tcfg, trun.shape, trun).step_fn(
        _port_params(p), {"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _decode_traces(jcfg, tcfg, p, steps):
    """JAX's and the port's logits (steps, B, V) and final caches of a
    teacher-forced decode over ``_tokens`` at T = 1."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro_torch.models import model as TM
    toks = _tokens(jcfg.vocab_size)
    run = _jax_run(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jcache = JM.init_cache(jcfg, B, STEPS, run)
    step = jax.jit(lambda c, tok, pos: JM.decode_step(jp, c, tok, pos, jcfg,
                                                      run))
    trun = _port_run(tcfg)
    tp = _port_params(p)
    tcache = TM.init_cache(tcfg, B, STEPS, trun, device="cpu")
    want, got = [], []
    for i in range(steps):
        logits, jcache = step(jcache, jnp.asarray(toks[:, i]),
                              jnp.full((B,), i, jnp.int32))
        want.append(np.asarray(logits))
        logits, tcache = TM.decode_step(
            tp, tcache, torch.as_tensor(toks[:, i]),
            torch.full((B,), i, dtype=torch.int32), tcfg, trun)
        got.append(logits.numpy())
    return np.stack(want), np.stack(got), jcache, tcache


def test_decode_matches_jax():
    from repro_torch import convert
    jcfg, tcfg = _configs()
    want, got, jcache, tcache = _decode_traces(jcfg, tcfg, _jax_params(),
                                               STEPS)
    np.testing.assert_allclose(got, want, **TOL)
    tc = convert.mamba_cache_to_numpy(tcache["groups"]["pos0"])
    assert tc["conv"].shape == (jcfg.n_layers, B, 3, 128)
    assert tc["ssm"].shape == (jcfg.n_layers, B, 128, 4)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(
            tc[k], np.asarray(jcache["groups"]["pos0"][k]), **TOL)


def _bf16_but_f32_leaves(tree, key=None):
    import jax.numpy as jnp
    from repro_torch.convert import F32_LEAVES
    if isinstance(tree, dict):
        return {k: _bf16_but_f32_leaves(v, k) for k, v in tree.items()}
    return jnp.asarray(tree, jnp.float32 if key in F32_LEAVES else
                       jnp.bfloat16)


def test_serve_tokens_match_jax_decode_loop():
    """Every greedy token of the port's serve == JAX's argmax at that step
    of a JAX decode loop (bf16, in process) on the serve's weights, fed
    the same prompt and then the port's earlier tokens, wherever JAX's
    top-2 margin exceeds ``MARGIN``."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro_torch import convert
    from repro_torch.launch import serve
    from repro_torch.models import model as TM
    jcfg, tcfg = _configs()
    gen = serve.main(SERVE_ARGV)
    pl, g, b = SERVE["prompt_len"], SERVE["gen"], SERVE["batch"]
    assert gen.shape == (b, g)
    trun = _port_run(tcfg, dtype="bfloat16")
    jp = _bf16_but_f32_leaves(convert.model_params_to_numpy(
        TM.init_params(tcfg, trun, device="cpu")))     # serve's weights
    run = _jax_run(jcfg, "bfloat16")
    cache = JM.init_cache(jcfg, b, pl + g, run)
    step = jax.jit(lambda c, tok, pos: JM.decode_step(jp, c, tok, pos, jcfg,
                                                      run))
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               size=(pl, b))
    want, margin = [], []
    for i in range(pl + g - 1):
        tok = prompt[i] if i < pl else gen[:, i - pl]
        logits, cache = step(cache, jnp.asarray(tok, jnp.int32),
                             jnp.full((b,), i, jnp.int32))
        if i >= pl - 1:
            logits = np.asarray(logits)
            top2 = np.sort(logits, axis=-1)[:, -2:]
            want.append(logits.argmax(-1))
            margin.append(top2[:, 1] - top2[:, 0])
    want, margin = np.stack(want, 1), np.stack(margin, 1)
    clear = margin > MARGIN
    np.testing.assert_array_equal(gen[clear], want[clear])
    assert clear.sum() >= gen.size // 2, "too few tokens clear the margin"


def test_serve_is_deterministic():
    from repro_torch.launch import serve
    stats = {}
    a = serve.main(SERVE_ARGV, stats=stats)
    b = serve.main(SERVE_ARGV)
    np.testing.assert_array_equal(a, b)
    assert stats["steps"] == SERVE["prompt_len"] + SERVE["gen"] - 1


def test_serve_tokens_do_not_depend_on_mesh_model():
    """JAX shards the state's channels over the model axis with no
    channel round; the port keeps the state whole: T = 1 and T = 4 give
    the same tokens."""
    from repro_torch.launch import serve
    a = serve.main(SERVE_ARGV + ["--mesh-model", "1"])
    b = serve.main(SERVE_ARGV + ["--mesh-model", "4"])
    np.testing.assert_array_equal(a, b)


def test_prefill_agrees_with_serve_decode_at_last_prompt_position():
    """As chip_smoke checks it at full width: the serve's decode logits at
    the last prompt position against ``prefill_step`` (the kernel path)
    on the same prompt and weights, bf16 within the Mamba bound (10%:
    64 layers amplify bf16 roundings, see ``testing/model.py``) and, at
    2 layers, where it reads about 1%, within the dense 5%; and in f32 a
    teacher-forced decode against the prefill within 1e-4."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as TM
    from repro_torch.testing.model import (DecodeLogits, logits_agreement,
                                           prefill_decode_rtol)
    _, tcfg = _configs()
    pl = SERVE["prompt_len"]
    with DecodeLogits(pos=pl - 1) as rec:
        serve.main(SERVE_ARGV)
    run = _port_run(tcfg, dtype="bfloat16", use_pallas=True)
    params = TM.init_params(tcfg, run, device="cpu")     # serve's weights
    prompt = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, size=(pl, SERVE["batch"])).T
    plan = build_cell(tcfg, ShapeConfig("p", pl, SERVE["batch"], "prefill"),
                      run)
    logits = plan.step_fn(params, {"tokens": torch.as_tensor(prompt)})
    res = logits_agreement(logits, rec.logits, torch.bfloat16, tcfg)
    assert prefill_decode_rtol(tcfg, torch.bfloat16) == 0.1
    assert res["ok"] and res["rel_rms"] < 0.05, res
    run = _port_run(tcfg)
    params = _port_params(_jax_params())
    toks = torch.as_tensor(_tokens(tcfg.vocab_size))
    cache = TM.init_cache(tcfg, B, STEPS, run, device="cpu")
    for i in range(STEPS):
        dec, cache = TM.decode_step(params, cache, toks[:, i],
                                    torch.full((B,), i, dtype=torch.int32),
                                    tcfg, run)
    res = logits_agreement(TM.prefill(params, {"tokens": toks}, tcfg, run),
                           dec, torch.float32, tcfg)
    assert res["ok"] and res["argmax_agree"] == 1.0, res


def test_config_matches_jax():
    from repro.configs.registry import ARCHS, SMOKE_ARCHS
    from repro.models.transformer import layer_descs
    from repro_torch.configs.registry import get_arch, get_smoke_arch
    from repro_torch.models.transformer import layer_descs as t_descs
    for jcfg, tcfg in ((ARCHS[ARCH], get_arch(ARCH)),
                       (SMOKE_ARCHS[ARCH], get_smoke_arch(ARCH))):
        for f in dataclasses.fields(tcfg):
            a, b = getattr(tcfg, f.name), getattr(jcfg, f.name)
            if f.name in ("moe", "mamba"):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert set(tcfg.block_pattern) == {"mamba"} \
            and jcfg.is_attention_free
        assert tcfg.mamba.resolved_dt_rank(tcfg.d_model) == \
            jcfg.mamba.resolved_dt_rank(jcfg.d_model)
        assert [tuple(d) for d in t_descs(tcfg)[0]] == \
            [tuple(d) for d in layer_descs(jcfg)[0]]
        assert t_descs(tcfg)[1:] == layer_descs(jcfg)[1:]


def test_convert_keeps_jax_f32_leaves():
    """Under a ``dtype`` the leaves JAX keeps in f32 (norm scales, the
    Mamba dt bias, log(-A) and D) stay f32; the projections are cast."""
    from repro_torch import convert
    p = _jax_params()
    bf = _port_params(p, dtype=torch.bfloat16)
    m = bf["groups"]["pos0"]["mamba"]
    for k in ("b_dt", "log_a", "d_skip"):
        assert m[k].dtype == torch.float32, k
        np.testing.assert_array_equal(m[k].numpy(),
                                      p["groups"]["pos0"]["mamba"][k])
    for k in ("w_in", "conv_w", "conv_b", "w_x", "w_dt", "w_out"):
        assert m[k].dtype == torch.bfloat16, k
    assert bf["groups"]["pos0"]["ln1"]["scale"].dtype == torch.float32
    back = convert.model_params_to_numpy(_port_params(p))
    np.testing.assert_array_equal(back["groups"]["pos0"]["mamba"]["log_a"],
                                  p["groups"]["pos0"]["mamba"]["log_a"])


# ---------------------------------------------------------------------------
# a hybrid stack: jamba's SMOKE pattern
# ---------------------------------------------------------------------------

def _hybrid_configs():
    """JAX's jamba SMOKE config and the port's."""
    from repro.configs.registry import SMOKE_ARCHS
    from repro_torch.configs.registry import get_smoke_arch
    return SMOKE_ARCHS["jamba-v0.1-52b"], get_smoke_arch("jamba-v0.1-52b")


def test_hybrid_stack_matches_jax():
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro_torch.models import model as TM
    from repro_torch.models.transformer import layer_descs
    jcfg, tcfg = _hybrid_configs()
    descs = layer_descs(tcfg)[0]
    assert {d.block for d in descs} == {"attn", "mamba"} and \
        {d.ffn for d in descs} == {"dense", "moe"}
    p = _jax_params(jcfg, seed=2)
    toks = _tokens(jcfg.vocab_size)
    run = _jax_run(jcfg, kind="prefill")
    want = jax.jit(lambda p_, t: JM.prefill(p_, {"tokens": t}, jcfg, run))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(toks))
    got = TM.prefill(_port_params(p), {"tokens": torch.as_tensor(toks)},
                     tcfg, _port_run(tcfg, kind="prefill"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, got, _, _ = _decode_traces(jcfg, tcfg, p, 8)
    np.testing.assert_allclose(got, want, **TOL)
