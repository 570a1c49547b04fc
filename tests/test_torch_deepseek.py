"""The port's deepseek-v2-lite-16b model path against the JAX package's
model functions, at SMOKE width (3 layers: a dense first layer and 2 MoE
layers; d_model 64, 4 heads, MLA rank 32, nope / rope / v dims 16 / 8 /
16; 4 routed experts top-2 and 1 shared expert; vocab 512) on the CPU, on
weights carried across by ``convert`` (norm scales drawn with numpy):

  * ``mla_attention`` == JAX with ``use_pallas`` True (the Pallas flash
    kernel in interpret mode) and False; ``_mla_decode`` over a
    teacher-forced trace with ``mla_absorb`` off and on, its outputs and
    the latent cache;
  * ``prefill`` last-position logits == JAX ``M.prefill`` with
    ``use_pallas`` True and False;
  * ``decode_step`` logits at every step of a 16-step teacher-forced trace
    == JAX, with T = 1 trustee in-process and T = 4 stacked trustees
    against JAX on a 1x4 mesh of 8 virtual devices (one subprocess: this
    module run as a script; its MoE runs the mask-partition mode), with
    ``mla_absorb`` off and on, and the final latent caches == JAX's; the
    T = 4 prefill (the MoE's seq mode) == JAX;
  * ``serve.main``'s greedy tokens == the argmax of a JAX loop of
    ``M.decode_step`` on the same weights, fed the same prompt and then
    the port's tokens, wherever the top-2 logit margin exceeds ``MARGIN``;
  * prefill and decode agree at the last prompt position, through
    ``testing/model.py`` as ``chip_smoke.py`` checks it on the card;
  * ``convert`` round trip (the prefix list, MLA and MoE leaves); the
    configuration == JAX's; deepseek no longer raises, jamba, arctic and
    falcon-mamba still do, naming their item; T not dividing the expert
    count raises ``ValueError``.

Tolerances: f32 logits, attention outputs and caches rtol = atol = 2e-5
(the same math summed in another order by another library).  bf16 serve
tokens are compared where JAX's top-2 margin exceeds ``MARGIN`` = 0.02:
XLA and PyTorch round the bf16 activations at other places, and at these
weights (|logit| < 0.9, a bf16 ulp 2^-9..2^-8 there) their bf16 logits
differ by up to about 0.012, three ulps, where both routed a token to
the same experts; at two prompt steps a router near-tie sent a token to
another expert in one package, and that row's logits differed by up to
0.07 (no compared token had one).  Of the 64 generated tokens, 39 clear
the margin and all of them agree; the two that differ have margins of
0.0004 and 0.0006.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import dataclasses
import subprocess

import numpy as np
import pytest
import torch

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=2e-5, atol=2e-5)
MARGIN = 0.02
B, STEPS = 3, 16
SERVE = dict(batch=4, prompt_len=8, gen=16, mesh_model=4)
SERVE_ARGV = ["--arch", ARCH, "--smoke", "--batch", "4", "--prompt-len", "8",
              "--gen", "16", "--mesh-model", "4", "--device", "cpu"]


def _jax_params():
    """JAX SMOKE weights (f32) as numpy, with norm scales (the layers',
    the MLA latent norm's and the final one) drawn from a numpy seed."""
    import jax
    from repro.configs.registry import SMOKE_ARCHS
    from repro.models import model as JM
    cfg = SMOKE_ARCHS[ARCH]
    p = jax.tree_util.tree_map(np.array, JM.init_params(
        jax.random.PRNGKey(1), cfg, _jax_run(cfg, 1, "float32")))
    rng = np.random.default_rng(5)

    def scales(tree):
        if isinstance(tree, list):
            return [scales(v) for v in tree]
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k == "scale":
                v = (1 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
            out[k] = scales(v)
        return out
    return cfg, scales(p)


def _jax_run(cfg, t, dtype, use_pallas=False, kind="decode", absorb=False):
    from repro.configs.base import MeshConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("t", STEPS, B, kind),
                     mesh=MeshConfig((1, t), ("data", "model")),
                     remat="none", param_dtype=dtype,
                     activation_dtype=dtype, use_pallas=use_pallas,
                     mla_absorb=absorb)


def _port_run(t, dtype="float32", use_pallas=False, kind="decode",
              absorb=False):
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    cfg = get_smoke_arch(ARCH)
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("t", STEPS, B, kind),
                          mesh=MeshConfig((1, t), ("data", "model")),
                          remat="none", param_dtype=dtype,
                          activation_dtype=dtype, use_pallas=use_pallas,
                          mla_absorb=absorb)


def _tokens(vocab):
    return np.random.default_rng(9).integers(0, vocab, (B, STEPS)).astype(
        np.int32)


def _port_params(p, dtype=None):
    from repro_torch import convert
    return convert.model_params_from_jax(p, device="cpu", dtype=dtype)


def _caches(cache):
    """{layer name: {"latent", "k_rope"}} of a cache tree, numpy in the
    JAX layout (the port's via ``convert.kv_cache_to_global``)."""
    from repro_torch import convert
    out = {f"prefix{i}": c for i, c in enumerate(cache["prefix"])}
    out["pos0"] = cache["groups"]["pos0"]
    if isinstance(out["pos0"]["latent"], torch.Tensor):
        return {k: convert.kv_cache_to_global(v) for k, v in out.items()}
    return {k: {n: np.asarray(a) for n, a in v.items()}
            for k, v in out.items()}


def _port_decode_trace(t, absorb=False):
    """The port's logits (STEPS, B, V) and final caches of a
    teacher-forced decode over ``_tokens`` with T = ``t`` trustees."""
    from repro_torch.models import model as TM
    _, p = _jax_params()
    tcfg, run = _port_run(t, absorb=absorb)
    params = _port_params(p)
    cache = TM.init_cache(tcfg, B, STEPS, run, device="cpu")
    toks = _tokens(tcfg.vocab_size)
    out = []
    for i in range(STEPS):
        logits, cache = TM.decode_step(
            params, cache, torch.as_tensor(toks[:, i]),
            torch.full((B,), i, dtype=torch.int32), tcfg, run)
        out.append(logits.numpy())
    return np.stack(out), _caches(cache)


def _jax_decode_trace(t, absorb=False):
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    cfg, p = _jax_params()
    run = _jax_run(cfg, t, "float32", absorb=absorb)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    cache = JM.init_cache(cfg, B, STEPS, run)
    step = jax.jit(lambda c, tok, pos: JM.decode_step(jp, c, tok, pos, cfg,
                                                      run))
    toks = _tokens(cfg.vocab_size)
    out = []
    for i in range(STEPS):
        logits, cache = step(cache, jnp.asarray(toks[:, i]),
                             jnp.full((B,), i, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out), _caches(cache)


def _jax_prefill(t, use_pallas):
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    cfg, p = _jax_params()
    run = _jax_run(cfg, t, "float32", use_pallas, "prefill")
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    toks = jnp.asarray(_tokens(cfg.vocab_size))
    return np.asarray(jax.jit(lambda p_, x: JM.prefill(
        p_, {"tokens": x}, cfg, run))(jp, toks))


def _port_prefill(t, use_pallas):
    from repro_torch.launch.steps import build_cell
    cfg, p = _jax_params()
    tcfg, run = _port_run(t, use_pallas=use_pallas, kind="prefill")
    plan = build_cell(tcfg, run.shape, run)
    out = plan.step_fn(_port_params(p),
                       {"tokens": torch.as_tensor(_tokens(cfg.vocab_size))})
    assert out.dtype == torch.float32 and out.shape == (B, cfg.vocab_size)
    return out.numpy()


def _close_caches(got, want):
    assert got.keys() == want.keys()
    for layer in got:
        for n in ("latent", "k_rope"):
            np.testing.assert_allclose(got[layer][n], want[layer][n], **TOL,
                                       err_msg=f"{layer}/{n}")


@pytest.fixture(autouse=True)
def _reset_mesh():
    from repro.core import meshctx
    meshctx.set_context(meshctx._default_mesh(), "default")
    yield


# ---------------------------------------------------------------------------
# MLA, prefill and decode at T = 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_mla_attention_matches_jax(use_pallas):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    cfg, p = _jax_params()
    ap = p["prefix"][0]["attn"]
    x = np.random.default_rng(3).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    pos = np.tile(np.arange(12), (2, 1))
    want = jax.jit(lambda a, xx: jattn.attention(
        a, xx, jnp.asarray(pos), cfg,
        _jax_run(cfg, 1, "float32", use_pallas, "prefill")))(
        jax.tree_util.tree_map(jnp.asarray, ap), jnp.asarray(x))
    tcfg, run = _port_run(1, use_pallas=use_pallas, kind="prefill")
    got = tattn.attention(_port_params(ap), torch.as_tensor(x),
                          torch.as_tensor(pos), tcfg, run)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_matches_jax(absorb):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro_torch import convert
    from repro_torch.models import attention as tattn
    cfg, p = _jax_params()
    ap = p["prefix"][0]["attn"]
    jrun = _jax_run(cfg, 1, "float32", absorb=absorb)
    tcfg, run = _port_run(1, absorb=absorb)
    jcache = jattn.init_kv_cache(cfg, B, 8, jnp.float32)
    tcache = tattn.init_kv_cache(tcfg, B, 8, torch.float32, "cpu")
    step = jax.jit(lambda c, xx, pp: jattn.decode_attention(
        jax.tree_util.tree_map(jnp.asarray, ap), xx, pp, c, cfg, jrun))
    tp = _port_params(ap)
    rng = np.random.default_rng(4)
    for i in range(8):
        x = rng.normal(size=(B, cfg.d_model)).astype(np.float32)
        pos = np.full((B,), i, np.int32)
        want, jcache = step(jcache, jnp.asarray(x), jnp.asarray(pos))
        got, tcache = tattn.decode_attention(
            tp, torch.as_tensor(x), torch.as_tensor(pos), tcache, tcfg, run)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = convert.kv_cache_to_global(tcache)
    for n in ("latent", "k_rope"):
        np.testing.assert_allclose(got[n], np.asarray(jcache[n]), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_jax(use_pallas):
    np.testing.assert_allclose(_port_prefill(1, use_pallas),
                               _jax_prefill(1, use_pallas), **TOL)


def test_decode_matches_jax_one_trustee():
    got, got_cache = _port_decode_trace(1)
    want, want_cache = _jax_decode_trace(1)
    np.testing.assert_allclose(got, want, **TOL)
    _close_caches(got_cache, want_cache)


# ---------------------------------------------------------------------------
# T = 4 and the serve loop, against JAX on 8 virtual devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_deepseek") / "runs.npz"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([src,
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _unflat_caches(runs, prefix):
    out = {}
    for key, v in runs.items():
        if key.startswith(prefix):
            layer, n = key[len(prefix):].split("/")
            out.setdefault(layer, {})[n] = v
    return out


@pytest.mark.parametrize("absorb", [False, True])
def test_decode_matches_jax_four_trustees(jax_runs, absorb):
    tag = f"t4_absorb{int(absorb)}"
    got, got_cache = _port_decode_trace(4, absorb)
    np.testing.assert_allclose(got, jax_runs[f"{tag}/logits"], **TOL)
    _close_caches(got_cache, _unflat_caches(jax_runs, f"{tag}/cache/"))


def test_prefill_matches_jax_four_trustees(jax_runs):
    np.testing.assert_allclose(_port_prefill(4, False),
                               jax_runs["t4/prefill"], **TOL)


def test_serve_tokens_match_jax_decode_loop(jax_runs):
    """Every greedy token of the port's serve == JAX's argmax at that step
    of a JAX decode loop fed the same prompt and the port's earlier
    tokens, wherever JAX's top-2 margin exceeds ``MARGIN``."""
    from repro_torch.launch import serve
    stats = {}
    gen = serve.main(SERVE_ARGV, stats=stats)
    assert stats["steps"] == SERVE["prompt_len"] + SERVE["gen"] - 1
    np.testing.assert_array_equal(gen, jax_runs["serve/port_tokens"])
    want, margin = jax_runs["serve/tokens"], jax_runs["serve/margin"]
    assert gen.shape == want.shape == (SERVE["batch"], SERVE["gen"])
    clear = margin > MARGIN
    np.testing.assert_array_equal(gen[clear], want[clear])
    assert clear.sum() >= gen.size // 2, "too few tokens clear the margin"


def test_prefill_agrees_with_serve_decode_at_last_prompt_position():
    """As chip_smoke checks it at full width: the serve loop's decode
    logits at the last prompt position against ``prefill_step`` on the
    same prompt and weights (bf16, T = 4: the prefill's MoE in seq mode,
    the decode's in mask-partition mode), and in f32 at T = 1."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as TM
    from repro_torch.testing.model import (DecodeLogits, MoEStats,
                                           logits_agreement)
    pl = SERVE["prompt_len"]
    with DecodeLogits(pos=pl - 1) as rec, MoEStats() as dec_moe:
        serve.main(SERVE_ARGV)
    tcfg, run = _port_run(SERVE["mesh_model"], dtype="bfloat16")
    assert dec_moe.summary()["moe_calls"] == 2 * (pl + SERVE["gen"] - 1)
    params = TM.init_params(tcfg, run, device="cpu")  # serve's weights
    prompt = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, size=(pl, SERVE["batch"])).T
    plan = build_cell(tcfg, ShapeConfig("p", pl, SERVE["batch"], "prefill"),
                      run)
    with MoEStats() as pre_moe:
        logits = plan.step_fn(params, {"tokens": torch.as_tensor(prompt)})
    assert pre_moe.summary()["moe_calls"] == 2
    res = logits_agreement(logits, rec.logits, torch.bfloat16, tcfg)
    assert res["ok"], res
    # in f32 the two paths agree to the f32 tolerance
    tcfg, run = _port_run(1)
    _, p = _jax_params()
    params = _port_params(p)
    toks = torch.as_tensor(_tokens(tcfg.vocab_size))
    cache = TM.init_cache(tcfg, B, STEPS, run, device="cpu")
    for i in range(STEPS):
        dec, cache = TM.decode_step(params, cache, toks[:, i],
                                    torch.full((B,), i, dtype=torch.int32),
                                    tcfg, run)
    res = logits_agreement(TM.prefill(params, {"tokens": toks}, tcfg, run),
                           dec, torch.float32, tcfg)
    assert res["ok"] and res["argmax_agree"] == 1.0, res


# ---------------------------------------------------------------------------
# conversion, configuration, refusals
# ---------------------------------------------------------------------------

def test_convert_round_trip():
    from repro_torch import convert
    _, p = _jax_params()
    back = convert.model_params_to_numpy(_port_params(p))

    def flat(t, pre=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in flat(v, f"{pre}/{k}").items()}
        if isinstance(t, list):
            return {k2: v2 for i, v in enumerate(t)
                    for k2, v2 in flat(v, f"{pre}/{i}").items()}
        return {pre: t}
    a, b = flat(p), flat(back)
    assert a.keys() == b.keys()
    assert "/groups/pos0/moe/w_gate" in a and "/prefix/0/mlp/w_up" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    bf = _port_params(p, dtype=torch.bfloat16)
    moe = bf["groups"]["pos0"]["moe"]
    assert moe["w_gate"].dtype == torch.bfloat16
    assert tuple(moe["w_gate"].shape) == (2, 4, 64, 96)
    assert moe["router"].dtype == torch.float32
    assert bf["prefix"][0]["attn"]["latent_norm"]["scale"].dtype == \
        torch.float32


def test_port_config_matches_jax():
    from repro.configs.registry import ARCHS, SMOKE_ARCHS
    from repro.models.model import active_param_count
    from repro.models.transformer import layer_descs
    from repro_torch.configs.registry import get_arch, get_smoke_arch
    from repro_torch.models import model as TM
    from repro_torch.models.transformer import layer_descs as t_descs
    for jcfg, tcfg in ((ARCHS[ARCH], get_arch(ARCH)),
                       (SMOKE_ARCHS[ARCH], get_smoke_arch(ARCH))):
        for f in dataclasses.fields(tcfg):
            a, b = getattr(tcfg, f.name), getattr(jcfg, f.name)
            if f.name in ("moe", "mamba"):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert [tuple(d) for d in t_descs(tcfg)[0]] == \
            [tuple(d) for d in layer_descs(jcfg)[0]]
        assert t_descs(tcfg)[1:] == layer_descs(jcfg)[1:]
        n = 15_647_895_040
        assert TM.active_param_count(tcfg, n) == active_param_count(jcfg, n)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "arctic-480b"])
def test_jamba_and_arctic_are_registered(arch):
    """The other two MoE architectures are registered, full and SMOKE, as
    JAX's configs: every field, the layer groups (jamba: 8-layer groups of
    Mamba and attention, MoE at odd positions; arctic: one MoE + dense
    layer), the active parameters of a total, and the padded heads at 4
    and 16 trustees (arctic's 56 to 64 at 16, as JAX pads them for its
    mesh)."""
    import types
    from repro.configs.registry import ARCHS, SMOKE_ARCHS
    from repro.core import meshctx as jmeshctx
    from repro.models import attention as JA
    from repro.models.model import active_param_count
    from repro.models.transformer import layer_descs
    from repro_torch.configs.registry import get_arch, get_smoke_arch
    from repro_torch.models import attention as TA
    from repro_torch.models import model as TM
    from repro_torch.models.transformer import layer_descs as t_descs
    for jcfg, tcfg in ((ARCHS[arch], get_arch(arch)),
                       (SMOKE_ARCHS[arch], get_smoke_arch(arch))):
        for f in dataclasses.fields(tcfg):
            a, b = getattr(tcfg, f.name), getattr(jcfg, f.name)
            if f.name in ("moe", "mamba"):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert [tuple(d) for d in t_descs(tcfg)[0]] == \
            [tuple(d) for d in layer_descs(jcfg)[0]]
        assert t_descs(tcfg)[1:] == layer_descs(jcfg)[1:]
        n = 51_570_315_264
        assert TM.active_param_count(tcfg, n) == active_param_count(jcfg, n)
        prev = jmeshctx.current_mesh()
        try:
            for t in (4, 16):
                jmeshctx.set_mesh(types.SimpleNamespace(shape={"model": t}))
                assert TA.padded_heads(tcfg, t) == JA.padded_heads(jcfg)
        finally:
            jmeshctx.set_mesh(prev)
    assert TA.padded_heads(get_arch("arctic-480b"), 16) == (64, 8)


def test_deepseek_is_served_and_trustees_must_divide_the_experts():
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = get_arch(ARCH)
    assert cfg.moe.num_experts == 64 and cfg.n_layers == 27
    for t in (1, 2, 4, 8, 16, 32, 64):
        run = RunConfig(model=cfg, shape=ShapeConfig("d", 64, 8, "decode"),
                        mesh=MeshConfig((1, t), ("data", "model")))
        transformer._check(cfg, run)
    run = dataclasses.replace(run, mesh=MeshConfig((1, 3), ("data",
                                                            "model")))
    with pytest.raises(ValueError, match="experts"):
        transformer._check(cfg, run)
    argv = SERVE_ARGV[:]
    argv[argv.index("--mesh-model") + 1] = "3"
    with pytest.raises(ValueError, match="experts"):
        serve.main(argv)


# ---------------------------------------------------------------------------
# the JAX side on 8 virtual devices (this module run as a script)
# ---------------------------------------------------------------------------

def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import meshctx
    from repro.models import model as JM
    from repro_torch import convert
    from repro_torch.models import model as TM
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
    meshctx.set_context(mesh, ("data",))
    res = {}

    # T = 4, f32, teacher-forced over _tokens, absorb off and on
    for absorb in (False, True):
        tag = f"t4_absorb{int(absorb)}"
        logits, caches = _jax_decode_trace(4, absorb)
        res[f"{tag}/logits"] = logits
        for layer, c in caches.items():
            for n, v in c.items():
                res[f"{tag}/cache/{layer}/{n}"] = v
    res["t4/prefill"] = _jax_prefill(4, False)

    # the serve loop (bf16, T = 4) on the port's serve weights, fed the
    # prompt and then the port's own greedy tokens
    from repro_torch.launch import serve
    cfg, _ = _jax_params()
    port = serve.main(SERVE_ARGV)
    tcfg, trun = _port_run(SERVE["mesh_model"], dtype="bfloat16")
    jp = _bf16_but_f32(convert.model_params_to_numpy(
        TM.init_params(tcfg, trun, device="cpu")))    # serve's weights
    run = _jax_run(cfg, 4, "bfloat16")
    pl, g, b = SERVE["prompt_len"], SERVE["gen"], SERVE["batch"]
    max_len = -(-(pl + g) // 4) * 4
    cache = JM.init_cache(cfg, b, max_len, run)
    step = jax.jit(lambda c, tok, pos: JM.decode_step(jp, c, tok, pos, cfg,
                                                      run))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(pl, b))
    tokens, margins = [], []
    for i in range(pl + g - 1):
        tok = prompt[i] if i < pl else port[:, i - pl]
        logits, cache = step(cache, jnp.asarray(tok, jnp.int32),
                             jnp.full((b,), i, jnp.int32))
        if i >= pl - 1:
            logits = np.asarray(logits)
            top2 = np.sort(logits, axis=-1)[:, -2:]
            tokens.append(logits.argmax(-1))
            margins.append(top2[:, 1] - top2[:, 0])
    res["serve/port_tokens"] = port
    res["serve/tokens"] = np.stack(tokens, 1)
    res["serve/margin"] = np.stack(margins, 1)
    np.savez(out_path, **res)


def _bf16_but_f32(tree, key=None):
    """numpy leaves -> JAX bf16, but the norm scales and the router, which
    the JAX package keeps in f32."""
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _bf16_but_f32(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16_but_f32(v, key) for v in tree]
    return jnp.asarray(tree, jnp.float32 if key in ("scale", "router")
                       else jnp.bfloat16)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
