"""The port's qwen2.5-3b model path against the JAX package's model
functions, at SMOKE width (2 layers, d_model 64, 4 query / 2 KV heads of
16, vocab 512) on the CPU, on weights carried across by ``convert``
(nonzero QKV biases and norm scales, drawn with numpy):

  * the layers — ``mlp``, ``embed_lookup``, ``lm_logits`` (f32 logits from
    bf16 operands) — == JAX;
  * ``prefill`` last-position logits == JAX ``M.prefill`` with
    ``use_pallas`` True (the Pallas flash kernel in interpret mode) and
    False;
  * ``decode_step`` logits at every step of a teacher-forced 16-step trace
    == JAX, with T = 1 trustee in-process and T = 4 stacked trustees
    against JAX on a 1x4 mesh of 8 virtual devices (one subprocess: this
    module run as a script), and the final KV cache == JAX's;
  * ``serve.main``'s greedy tokens == the argmax of a JAX loop of
    ``M.decode_step`` on the same weights, fed the same prompt and then
    the port's tokens, at every step whose top-2 logit margin exceeds
    ``MARGIN`` (JAX ``serve.main`` itself fails on this JAX, see ROADMAP
    queue C); two serve runs are identical;
  * prefill and decode agree at the last prompt position, through
    ``testing/model.py`` as ``chip_smoke.py`` checks it on the card;
  * ``convert`` round trip; the serve refuses a depth the card cannot
    hold (jamba, arctic at their published depths) before drawing a
    weight, and the unported serve flags raise ``NotImplementedError``
    naming their ROADMAP item; every arch's config is JAX's; the formerly
    unported model paths take a train step; entry points
    default to ``cuda`` and raise without a card.

Tolerances: f32 logits and caches 2e-5 (rtol and atol — the same math
summed in another order by another library); bf16 serve tokens compared
where JAX's top-2 margin exceeds ``MARGIN`` = 0.02: both packages round
every bf16 activation, but XLA and PyTorch fuse and accumulate in
different orders, and their bf16 logits at these weights (|logit| < 0.7,
a bf16 ulp 2^-8 there) differ by up to about 0.009 — two ulps; a margin
of twice that decides the same argmax in both.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import subprocess

import numpy as np
import pytest
import torch

TOL = dict(rtol=2e-5, atol=2e-5)
MARGIN = 0.02
B, STEPS = 3, 16
SERVE = dict(batch=4, prompt_len=8, gen=16, mesh_model=4)
SERVE_ARGV = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "4",
              "--prompt-len", "8", "--gen", "16", "--mesh-model", "4",
              "--device", "cpu"]


def _jax_params():
    """JAX SMOKE weights (f32) as numpy, with nonzero QKV biases and norm
    scales drawn from a numpy seed."""
    import jax
    from repro.configs.registry import SMOKE_ARCHS
    from repro.models import model as JM
    cfg = SMOKE_ARCHS["qwen2.5-3b"]
    p = jax.tree_util.tree_map(np.array, JM.init_params(
        jax.random.PRNGKey(1), cfg, _jax_run(cfg, 1, "float32")))
    rng = np.random.default_rng(5)
    attn = p["groups"]["pos0"]["attn"]
    for name in ("b_q", "b_k", "b_v"):
        attn[name] = rng.normal(size=attn[name].shape).astype(np.float32)
    for ln in ("ln1", "ln2"):
        s = p["groups"]["pos0"][ln]["scale"]
        p["groups"]["pos0"][ln]["scale"] = (
            1 + 0.2 * rng.normal(size=s.shape)).astype(np.float32)
    return cfg, p


def _jax_run(cfg, t, dtype, use_pallas=False, kind="decode"):
    from repro.configs.base import MeshConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("t", STEPS, B, kind),
                     mesh=MeshConfig((1, t), ("data", "model")),
                     remat="none", param_dtype=dtype,
                     activation_dtype=dtype, use_pallas=use_pallas)


def _port_run(t, dtype="float32", use_pallas=False, kind="decode"):
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    cfg = get_smoke_arch("qwen2.5-3b")
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("t", STEPS, B, kind),
                          mesh=MeshConfig((1, t), ("data", "model")),
                          remat="none", param_dtype=dtype,
                          activation_dtype=dtype, use_pallas=use_pallas)


def _tokens(vocab):
    return np.random.default_rng(9).integers(0, vocab, (B, STEPS)).astype(
        np.int32)


def _port_params(p, dtype=None):
    from repro_torch import convert
    return convert.model_params_from_jax(p, device="cpu", dtype=dtype)


def _port_decode_trace(t):
    """The port's logits (STEPS, B, V) and final cache (JAX layout) of a
    teacher-forced decode over ``_tokens`` with T = ``t`` trustees."""
    from repro_torch import convert
    from repro_torch.models import model as TM
    _, p = _jax_params()
    tcfg, run = _port_run(t)
    params = _port_params(p)
    cache = TM.init_cache(tcfg, B, STEPS, run, device="cpu")
    toks = _tokens(tcfg.vocab_size)
    out = []
    for i in range(STEPS):
        logits, cache = TM.decode_step(
            params, cache, torch.as_tensor(toks[:, i]),
            torch.full((B,), i, dtype=torch.int32), tcfg, run)
        out.append(logits.numpy())
    return np.stack(out), convert.kv_cache_to_global(cache["groups"]["pos0"])


@pytest.fixture(autouse=True)
def _reset_mesh():
    from repro.core import meshctx
    meshctx.set_context(meshctx._default_mesh(), "default")
    yield


# ---------------------------------------------------------------------------
# layers, prefill, decode at T = 1
# ---------------------------------------------------------------------------

def test_layers_match_jax():
    import jax.numpy as jnp
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    cfg, p = _jax_params()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    mp = {k: v[0] for k, v in p["groups"]["pos0"]["mlp"].items()}
    T = torch.as_tensor
    np.testing.assert_allclose(
        tl.mlp({k: T(v) for k, v in mp.items()}, T(x)).numpy(),
        np.asarray(jl.mlp({k: jnp.asarray(v) for k, v in mp.items()},
                          jnp.asarray(x))), **TOL)
    ids = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    emb = {k: T(v) for k, v in p["embed"].items()}
    np.testing.assert_array_equal(
        tl.embed_lookup(emb, T(ids), cfg).numpy(),
        np.asarray(jl.embed_lookup({k: jnp.asarray(v) for k, v in
                                    p["embed"].items()}, jnp.asarray(ids),
                                   cfg)))
    assert tl.padded_vocab(cfg) == jl.padded_vocab(cfg) == cfg.vocab_size
    # logits from bf16 operands are accumulated and returned in f32
    xb = T(x[:, 0]).to(torch.bfloat16)
    wb = T(p["embed"]["unembed"]).to(torch.bfloat16)
    got = tl.lm_logits(xb, wb, cfg)
    want = jl.lm_logits(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                        jnp.asarray(wb.float().numpy(), jnp.bfloat16), cfg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_jax(use_pallas):
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro_torch.launch.steps import build_cell
    cfg, p = _jax_params()
    toks = _tokens(cfg.vocab_size)
    want = JM.prefill(jax.tree_util.tree_map(jnp.asarray, p),
                      {"tokens": jnp.asarray(toks)}, cfg,
                      _jax_run(cfg, 1, "float32", use_pallas, "prefill"))
    tcfg, run = _port_run(1, use_pallas=use_pallas, kind="prefill")
    plan = build_cell(tcfg, run.shape, run)
    got = plan.step_fn(_port_params(p), {"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_matches_jax_one_trustee():
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    cfg, p = _jax_params()
    run = _jax_run(cfg, 1, "float32")
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    cache = JM.init_cache(cfg, B, STEPS, run)
    step = jax.jit(lambda c, tok, pos: JM.decode_step(jp, c, tok, pos, cfg,
                                                      run))
    toks = _tokens(cfg.vocab_size)
    want = []
    for i in range(STEPS):
        logits, cache = step(cache, jnp.asarray(toks[:, i]),
                             jnp.full((B,), i, jnp.int32))
        want.append(np.asarray(logits))
    got, got_cache = _port_decode_trace(1)
    np.testing.assert_allclose(got, np.stack(want), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(got_cache[k],
                                   np.asarray(cache["groups"]["pos0"][k]),
                                   **TOL)


# ---------------------------------------------------------------------------
# T = 4 and the serve loop, against JAX on 8 virtual devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_model") / "runs.npz"
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


def test_decode_matches_jax_four_trustees(jax_runs):
    got, got_cache = _port_decode_trace(4)
    np.testing.assert_allclose(got, jax_runs["t4/logits"], **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(got_cache[k], jax_runs[f"t4/cache/{k}"],
                                   **TOL)


def test_serve_tokens_match_jax_decode_loop(jax_runs):
    """Every greedy token of the port's serve == JAX's argmax at that step
    of a JAX decode loop fed the same prompt and the port's earlier
    tokens, wherever JAX's top-2 margin exceeds ``MARGIN``."""
    from repro_torch.launch import serve
    gen = serve.main(SERVE_ARGV)
    np.testing.assert_array_equal(gen, jax_runs["serve/port_tokens"])
    want, margin = jax_runs["serve/tokens"], jax_runs["serve/margin"]
    assert gen.shape == want.shape == (SERVE["batch"], SERVE["gen"])
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


def test_prefill_agrees_with_serve_decode_at_last_prompt_position():
    """As chip_smoke checks it at full width: the serve loop's decode
    logits at the last prompt position against ``prefill_step`` on the
    same prompt and weights (bf16)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as TM
    from repro_torch.testing.model import DecodeLogits, logits_agreement
    pl = SERVE["prompt_len"]
    with DecodeLogits(pos=pl - 1) as rec:
        serve.main(SERVE_ARGV)
    tcfg, run = _port_run(SERVE["mesh_model"], dtype="bfloat16")
    params = TM.init_params(tcfg, run, device="cpu")  # serve's weights
    prompt = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, size=(pl, SERVE["batch"])).T
    plan = build_cell(tcfg, ShapeConfig("p", pl, SERVE["batch"], "prefill"),
                      run)
    logits = plan.step_fn(params, {"tokens": torch.as_tensor(prompt)})
    res = logits_agreement(logits, rec.logits, torch.bfloat16)
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
                           dec, torch.float32)
    assert res["ok"] and res["argmax_agree"] == 1.0, res


# ---------------------------------------------------------------------------
# conversion, refusals, device
# ---------------------------------------------------------------------------

def test_convert_round_trip():
    from repro_torch import convert
    _, p = _jax_params()
    back = convert.model_params_to_numpy(_port_params(p))
    flat = lambda t, pre="": ({pre: t} if not isinstance(t, dict) else {
        k2: v2 for k, v in t.items() for k2, v2 in flat(v, pre + "/" + k)
        .items()})
    a, b = flat(p), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    bf = _port_params(p, dtype=torch.bfloat16)
    assert bf["groups"]["pos0"]["attn"]["w_q"].dtype == torch.bfloat16
    assert bf["groups"]["pos0"]["ln1"]["scale"].dtype == torch.float32
    assert bf["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("extra", [
    ["--delegation-mode", "dedicated"],
    ["--drain-rounds", "2"],
    ["--session", "--delegation-mode", "dedicated"]])
def test_serve_dedicated_and_drain_flags_run(extra):
    """``--delegation-mode dedicated`` (alone and with ``--session``) and
    ``--drain-rounds 2``: the plain serve's tokens, a ledger counting
    every request's generated tokens (dedicated: on the last 2 of the 4
    shards, the client shards' region zero; the drain: residual 0), and
    the session-wide mode restored afterwards."""
    from repro_torch.core import meshctx
    from repro_torch.launch import serve
    stats = {}
    gen = serve.main(SERVE_ARGV + extra, stats=stats)
    np.testing.assert_array_equal(gen, serve.main(SERVE_ARGV))
    b, g = SERVE["batch"], SERVE["gen"]
    assert stats["ledger"].tolist() == [g] * b
    if "dedicated" in extra:
        assert stats["client_region"].shape == (2 * b // 2, 1)
        assert not stats["client_region"].any()
    else:
        assert stats["drain"]["residual"] == 0 and \
            stats["drain"]["rounds"] <= 2, stats["drain"]
    if "--session" in extra:
        assert int(stats["meter"].sum()) == b * g
        assert stats["fused_waves"] == [[["ledger", "meter"]]] * g
    assert meshctx.delegation_mode() == ("shared", 0)


@pytest.mark.parametrize("extra,item", [
    (["--mesh-data", "2"], "queue A 13"),
])
def test_unported_serve_flags_raise(extra, item):
    """``--mesh-data 2`` (once refused as ``item``) runs: the qwen model
    computes each sequence on its own, so the (2, T) mesh's tokens are
    the (1, T) mesh's, and the session ledger and meter span all 2 * T
    shards of the mesh (the meter one key a shard)."""
    from repro_torch.launch import serve
    stats = {}
    gen = serve.main(SERVE_ARGV + extra + ["--session"], stats=stats)
    np.testing.assert_array_equal(gen, serve.main(SERVE_ARGV))
    b, g = SERVE["batch"], SERVE["gen"]
    assert stats["ledger"].tolist() == [g] * b
    assert stats["meter"].shape == (2 * SERVE["mesh_model"],)
    assert int(stats["meter"].sum()) == b * g


@pytest.mark.parametrize("extra,replayed", [
    (["--chaos", "6", "--chaos-snap-every", "4"], 2),
    (["--stream-depth", "2", "--serve-impl", "pallas", "--chaos", "9",
      "--chaos-snap-every", "4"], 1),
    (["--stream-depth", "2", "--chaos", "8", "--chaos-snap-every", "8"], 0),
])
def test_serve_chaos_recovers_the_ledger(extra, replayed):
    """``--session --chaos WAVE``: the session round torn at that wave is
    recovered (the last snapshot restored, the waves since it replayed,
    the torn wave retried), directly or through the streaming driver; the
    tokens are the plain serve's and the ledger counts ``--gen`` tokens a
    request.  ``--chaos`` without ``--session`` is refused."""
    from repro_torch.launch import serve
    stats = {}
    gen = serve.main(SERVE_ARGV + ["--session"] + extra, stats=stats)
    np.testing.assert_array_equal(gen, serve.main(SERVE_ARGV))
    b, g = SERVE["batch"], SERVE["gen"]
    assert stats["ledger"].tolist() == [g] * b
    assert int(stats["meter"].sum()) == b * g
    rec = stats["recovery"]
    assert rec["restores"] == 1 and rec["replayed_rounds"] == replayed
    assert len(stats["fused_waves"]) == g + replayed
    with pytest.raises(SystemExit):
        serve.main(SERVE_ARGV + ["--chaos", "3"])


@pytest.mark.parametrize("extra,t", [
    ([], 4), (["--stream-depth", "2"], 4),
    (["--stream-depth", "1", "--serve-impl", "pallas"], 4),
    (["--serve-impl", "masked"], 1)])
def test_serve_session_ledger_and_meter(extra, t):
    """``--session``: each generated token's ledger and meter ADDs ride
    ONE fused engine round (the lane layout over 4 trustees, the masked
    layout of local rows on 1), directly or through the streaming driver;
    the tokens are the plain serve's, the ledger counts every request's
    generated tokens and the meter sums them."""
    from repro_torch.launch import serve
    i = SERVE_ARGV.index("--mesh-model")
    plain_argv = SERVE_ARGV[:i + 1] + [str(t)] + SERVE_ARGV[i + 2:]
    argv = plain_argv + ["--session"] + extra
    stats = {}
    gen = serve.main(argv, stats=stats)
    np.testing.assert_array_equal(gen, serve.main(plain_argv))
    b, g = SERVE["batch"], SERVE["gen"]
    assert stats["ledger"].tolist() == [g] * b
    assert int(stats["meter"].sum()) == b * g
    assert stats["fused_waves"] == [[["ledger", "meter"]]] * g
    assert stats["step_info"] == {"fused": [["ledger", "meter"]],
                                  "solo": []}


@pytest.mark.parametrize("arch,fits", [
    ("arctic-480b", "2 layers"), ("jamba-v0.1-52b", r"16 layers \(2 of 4 "
                                                    r"groups\)")])
def test_full_depth_is_refused_before_any_weight(arch, fits, monkeypatch):
    """serve.main at the published depth on a card with 60 GB free (the
    free figure faked: the fit check reads ``serve._free_bytes``) raises
    ``ValueError`` naming the bytes of the weights and cache and the
    largest depth that fits, before a weight or the cache is drawn; that
    depth passes the check."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as TM
    free = 60 * 10 ** 9
    monkeypatch.setattr(serve, "_free_bytes", lambda dev: free)

    def shapes_only(fn, i):
        """``fn`` for the check's shapes (the meta device) only."""
        def guarded(*a, **kw):
            dev = kw.get("device", a[i] if len(a) > i else None)
            assert str(dev) == "meta", "a weight or the cache was allocated"
            return fn(*a, **kw)
        return guarded
    monkeypatch.setattr(TM, "init_params", shapes_only(TM.init_params, 2))
    monkeypatch.setattr(TM, "init_cache", shapes_only(TM.init_cache, 4))
    cfg = get_arch(arch)
    run = RunConfig(model=cfg, shape=ShapeConfig("cli", 64, 4, "decode"),
                    mesh=MeshConfig((1, 4), ("data", "model")))
    need = TM.param_nbytes(cfg, run) + TM.cache_nbytes(cfg, 4, 64, run)
    argv = ["--arch", arch, "--batch", "4", "--prompt-len", "32", "--gen",
            "32", "--mesh-model", "4", "--device", "cpu"]
    with pytest.raises(ValueError, match=f"{need / 1e9:.2f} GB .* "
                       f"{free / 1e9:.2f} GB are free; the largest depth "
                       f"that fits is {fits}"):
        serve.main(argv)
    n = int(fits.split()[0])
    serve.check_fits(cfg.with_overrides(n_layers=n), run, 4, 64,
                     torch.device("cpu"))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", [
    "qwen2.5-3b", "deepseek-v2-lite-16b", "falcon-mamba-7b", "qwen3-4b",
    "gemma-7b", "qwen1.5-32b", "qwen2-vl-2b", "seamless-m4t-large-v2",
    "jamba-v0.1-52b", "arctic-480b"])
def test_port_config_matches_jax(arch, smoke):
    """Every ported architecture's config, full and SMOKE, field by field
    (each of the port's fields is JAX's; the MoE and Mamba sub-configs
    compared as dicts)."""
    import dataclasses
    from repro.configs.registry import ARCHS, SMOKE_ARCHS
    from repro_torch.configs.registry import get_arch, get_smoke_arch
    pairs = ((SMOKE_ARCHS[arch], get_smoke_arch(arch)) if smoke
             else (ARCHS[arch], get_arch(arch)),)
    for jcfg, tcfg in pairs:
        for f in dataclasses.fields(tcfg):
            a, b = getattr(tcfg, f.name), getattr(jcfg, f.name)
            if f.name in ("moe", "mamba"):   # each package's own classes
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert [tcfg.block_kind(i) for i in range(4)] == \
            [jcfg.block_kind(i) for i in range(4)]
        assert [tcfg.layer_ffn_kind(i) for i in range(4)] == \
            [jcfg.layer_ffn_kind(i) for i in range(4)]


def test_unported_model_paths_raise():
    """The model paths that raised before they were ported — embedding
    inputs (with M-RoPE) and the encoder-decoder — build, and their train
    cells take a step on a batch of ``model.input_specs``; a train cell of the
    token model too."""
    import dataclasses
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as TM
    from repro_torch.optim import init_adamw
    _, run = _port_run(1)
    shape = ShapeConfig("t", 8, 2, "train")
    rng = np.random.default_rng(4)
    for arch in ("qwen2.5-3b", "qwen2-vl-2b", "seamless-m4t-large-v2"):
        tcfg = get_smoke_arch(arch)
        plan = build_cell(tcfg, shape, dataclasses.replace(
            run, model=tcfg, shape=shape))
        params = TM.init_params(tcfg, plan.run, device="cpu")
        before = params["final_norm"]["scale"].clone()
        batch = {}
        for name, (shp, dtype) in TM.input_specs(tcfg, shape,
                                                 plan.run).items():
            if name == "positions":
                batch[name] = torch.arange(8, dtype=dtype).expand(shp)
            elif dtype.is_floating_point:
                batch[name] = torch.as_tensor(
                    rng.normal(size=shp), dtype=dtype) * 0.02
            else:
                batch[name] = torch.as_tensor(
                    rng.integers(0, tcfg.vocab_size, shp), dtype=dtype)
        params, opt, metrics = plan.step_fn(params, init_adamw(params),
                                            batch)
        assert np.isfinite(float(metrics["loss"])) and int(opt.step) == 1
        assert not torch.equal(before, params["final_norm"]["scale"])


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.models import model as TM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg, run = _port_run(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(tcfg, run)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(SERVE_ARGV[:-2])


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

    # T = 4, f32, teacher-forced over _tokens
    cfg, p = _jax_params()
    run = _jax_run(cfg, 4, "float32")
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
    res["t4/logits"] = np.stack(out)
    for k in ("k", "v"):
        res[f"t4/cache/{k}"] = np.asarray(cache["groups"]["pos0"][k])

    # the serve loop (bf16, T = 4) on the port's serve weights, fed the
    # prompt and then the port's own greedy tokens
    from repro_torch.launch import serve
    port = serve.main(SERVE_ARGV)
    tcfg, trun = _port_run(SERVE["mesh_model"], dtype="bfloat16")
    jp = _bf16_but_scales(convert.model_params_to_numpy(
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


def _bf16_but_scales(tree, key=None):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _bf16_but_scales(v, k) for k, v in tree.items()}
    return jnp.asarray(tree, jnp.float32 if key == "scale" else
                       jnp.bfloat16)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
