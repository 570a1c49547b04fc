"""The rest of the model zoo that fits one card — qwen3-4b (QK norm),
gemma-7b (GeGLU, tied and scaled embeddings), qwen1.5-32b (QKV bias,
MHA), qwen2-vl-2b (M-RoPE, embedding inputs) and seamless-m4t-large-v2
(the encoder-decoder model) — against the JAX package's model functions,
at SMOKE width on the CPU in f32, on weights carried across by
``convert`` (norm scales and QKV biases drawn with numpy):

  * ``prefill``'s last-position logits (seamless: the encoder memory) ==
    JAX ``M.prefill``, with ``use_pallas`` off and on (on CPU tensors the
    kernel's wrapper runs the plain version);
  * the logits of a teacher-forced 4-step decode and the final self cache
    (and seamless's cross cache, filled with numpy values so that its
    cross-attention decode is exercised) in JAX's layout, at T = 1 and T
    = 4 stacked trustees against JAX on a 1x4 mesh;
  * ``forward_loss`` and every gradient leaf == ``jax.value_and_grad`` of
    JAX's ``forward_loss``;
  * M-RoPE's ``apply_rope`` == JAX's with distinct (t, h, w) streams, and
    bit for bit plain RoPE with three equal streams; ``sp_residual`` is
    bit for bit the identity; GeGLU and the tied, scaled embedding ==
    JAX's layers; ``input_specs`` == JAX's for every architecture and
    cell kind;
  * ``serve.main``: deterministic; its greedy tokens == the argmax of a
    JAX loop of ``M.decode_step`` (bf16, T = 4) on the serve's weights,
    fed the same prompt (qwen2-vl-2b: JAX's embeddings prompt, --gen 1)
    and then the port's tokens, wherever JAX's top-2 margin exceeds
    ``MARGIN``; ``--gen 2`` on qwen2-vl-2b raises; the encoder-decoder
    tree's ``convert`` round trip; the trainer runs an embeds model and
    the encoder-decoder model.

The JAX side runs on 8 virtual devices in one subprocess (this module run
as a script); it jits its prefill and decode steps and
``value_and_grad`` of ``forward_loss`` (no optimizer step).

Tolerances: f32 logits, memories and caches 2e-5 (rtol and atol), the
loss and metrics rtol 1e-5, each gradient leaf 1e-4 in relative RMS —
the same f32 math summed in another order by another library, as in
``test_torch_model.py`` and ``test_torch_train.py``.  M-RoPE 1e-6 (one
rotation in f32).  bf16 serve tokens are compared where JAX's top-2
margin exceeds ``MARGIN`` = 0.02 (``test_torch_model.py`` says why).
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

ARCHS = ("qwen3-4b", "gemma-7b", "qwen1.5-32b", "qwen2-vl-2b",
         "seamless-m4t-large-v2")
ALL_ARCHS = ARCHS + ("qwen2.5-3b", "deepseek-v2-lite-16b",
                     "falcon-mamba-7b")
B, S, S_SRC, STEPS, XENT_CHUNK = 2, 8, 12, 4, 4
TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL, GRAD_RMS = 1e-5, 1e-4
MARGIN = 0.02
SERVE = dict(batch=4, prompt_len=4, gen=4, mesh_model=4)


def serve_argv(arch):
    gen = 1 if arch == "qwen2-vl-2b" else SERVE["gen"]
    return ["--arch", arch, "--smoke", "--batch", str(SERVE["batch"]),
            "--prompt-len", str(SERVE["prompt_len"]), "--gen", str(gen),
            "--mesh-model", str(SERVE["mesh_model"]), "--device", "cpu"]


def _jax_run(cfg, t, dtype="float32", kind="train"):
    from repro.configs.base import MeshConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("t", S, B, kind),
                     mesh=MeshConfig((1, t), ("data", "model")),
                     remat="none", param_dtype=dtype,
                     activation_dtype=dtype, xent_chunk=XENT_CHUNK)


def _port_run(arch, t, dtype="float32", **kw):
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    cfg = get_smoke_arch(arch)
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                          mesh=MeshConfig((1, t), ("data", "model")),
                          param_dtype=dtype, activation_dtype=dtype,
                          xent_chunk=XENT_CHUNK, **{"remat": "none", **kw})


def _inputs(arch, d, vocab):
    """The numpy inputs of ``arch``: ``batch`` (its train batch — tokens,
    embeddings with distinct M-RoPE streams, or an encoder-decoder's
    frames and tokens — with labels and a mask) and ``dec`` (STEPS
    decode inputs: token ids, or (B, D) embeddings)."""
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    batch = {"labels": toks[:, 1:],
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if arch == "qwen2-vl-2b":
        batch["embeds"] = rng.normal(size=(B, S, d)).astype(np.float32)
        t = np.arange(S)
        pos = np.stack([t, t // 2, t % 3 + 5])        # distinct streams
        batch["positions"] = np.broadcast_to(pos[:, None], (3, B, S)) \
            .astype(np.int32).copy()
        dec = rng.normal(size=(STEPS, B, d)).astype(np.float32)
    elif arch == "seamless-m4t-large-v2":
        batch["src_embeds"] = rng.normal(size=(B, S_SRC, d)).astype(
            np.float32)
        batch["tokens"] = toks[:, :-1]
        dec = rng.integers(0, vocab, (STEPS, B)).astype(np.int32)
    else:
        batch["tokens"] = toks[:, :-1]
        dec = rng.integers(0, vocab, (STEPS, B)).astype(np.int32)
    return batch, dec


def _cross(arch, shape):
    """Numpy values for seamless's cross cache (JAX's layout), so that its
    cross-attention decode reads something other than zeros."""
    return np.random.default_rng(len(arch) + 1).normal(
        size=shape).astype(np.float32)


def _flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _tree(runs, head):
    """The nested tree saved under ``head`` (digit keys: list indices)."""
    tree = {}
    for key, leaf in runs.items():
        if key.startswith(head):
            *path, last = key[len(head):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def _params(runs, arch):
    from repro_torch import convert
    return convert.model_params_from_jax(_tree(runs, f"{arch}/params/"),
                                         device="cpu")


def _to_stacked(a, t):
    """A JAX-layout cache leaf (..., B, H, S, Dh) -> the port's stacked
    (..., T, B, H, S/T, Dh)."""
    x = torch.as_tensor(a)
    s = x.shape[-2]
    x = x.reshape(x.shape[:-2] + (t, s // t, x.shape[-1]))
    return x.movedim(-3, -5).contiguous()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_zoo") / "runs.npz"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([src,
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the JAX side, 8 virtual devices, one subprocess
# ---------------------------------------------------------------------------

def _jax_params(arch):
    """JAX SMOKE weights (f32) as numpy, every norm scale and QKV bias
    drawn from a numpy seed."""
    import jax
    from repro.configs.registry import SMOKE_ARCHS
    from repro.models import model as JM
    cfg = SMOKE_ARCHS[arch]
    p = jax.tree_util.tree_map(np.array, jax.jit(
        lambda k: JM.init_params(k, cfg, _jax_run(cfg, 1)))(
        jax.random.PRNGKey(1)))
    rng = np.random.default_rng(5)

    def draw(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k == "scale":
                v = (1 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
            elif k in ("b_q", "b_k", "b_v"):
                v = rng.normal(size=v.shape).astype(np.float32)
            out[k] = draw(v)
        return out
    return cfg, draw(p)


def _jax_decode(JM, jp, cfg, run, dec, max_len, cross=None):
    """A teacher-forced JAX decode: (logits (STEPS, B, V), final cache)."""
    import jax
    import jax.numpy as jnp
    cache = JM.init_cache(cfg, B, max_len, run)
    if cross is not None:
        cache = {**cache, "cross_k": jnp.asarray(cross[0]),
                 "cross_v": jnp.asarray(cross[1])}
    step = jax.jit(lambda c, tok, pos: JM.decode_step(jp, c, tok, pos, cfg,
                                                      run))
    out = []
    for i in range(STEPS):
        logits, cache = step(cache, jnp.asarray(dec[i]),
                             jnp.full((B,), i, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out), jax.tree_util.tree_map(np.asarray, cache)


def _jax_serve(JM, cfg, arch):
    """JAX's serve loop (bf16, T = 4) on the port's serve weights, fed the
    prompt JAX's serve draws and then the port's own tokens: (port tokens,
    JAX's argmax tokens, their top-2 margins)."""
    import jax
    import jax.numpy as jnp
    from repro_torch import convert
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as TM
    port = serve.main(serve_argv(arch))
    gen, pl, b = port.shape[1], SERVE["prompt_len"], SERVE["batch"]
    t = SERVE["mesh_model"]
    max_len = -(-(pl + gen) // t) * t
    tcfg = get_smoke_arch(arch)
    trun = RunConfig(model=tcfg, shape=ShapeConfig("cli", max_len, b,
                                                   "decode"),
                     mesh=MeshConfig((1, t), ("data", "model")))
    jp = _bf16_but_scales(convert.model_params_to_numpy(
        TM.init_params(tcfg, trun, device="cpu")))      # the serve's weights
    run = _jax_run(cfg, t, "bfloat16", kind="decode")
    cache = JM.init_cache(cfg, b, max_len, run)
    step = jax.jit(lambda c, tok, pos: JM.decode_step(jp, c, tok, pos, cfg,
                                                      run))
    rng = np.random.default_rng(0)
    if cfg.input_mode == "embeds" and not JM.is_encdec(cfg):
        prompt = jnp.asarray(rng.normal(size=(pl, b, cfg.d_model)) * 0.02,
                             jnp.bfloat16)
    else:
        prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(pl, b)),
                             jnp.int32)
    tokens, margins = [], []
    for i in range(pl + gen - 1):
        tok = prompt[i] if i < pl else jnp.asarray(port[:, i - pl],
                                                   jnp.int32)
        logits, cache = step(cache, tok, jnp.full((b,), i, jnp.int32))
        if i >= pl - 1:
            logits = np.asarray(logits)
            top2 = np.sort(logits, axis=-1)[:, -2:]
            tokens.append(logits.argmax(-1))
            margins.append(top2[:, 1] - top2[:, 0])
    return port, np.stack(tokens, 1), np.stack(margins, 1)


def _bf16_but_scales(tree, key=None):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _bf16_but_scales(v, k) for k, v in tree.items()}
    return jnp.asarray(tree, jnp.float32 if key == "scale" else
                       jnp.bfloat16)


def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import meshctx
    from repro.models import model as JM
    res = {}

    def mesh(t):
        meshctx.set_context(Mesh(np.array(jax.devices()[:t]).reshape(1, t),
                                 ("data", "model")), ("data",))
    for arch in ARCHS:
        cfg, p = _jax_params(arch)
        for path, leaf in _flat_paths(p).items():
            res[f"{arch}/params/{path}"] = leaf
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        batch, dec = _inputs(arch, cfg.d_model, cfg.vocab_size)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        pre = {k: v for k, v in jb.items() if k not in ("labels", "mask")}
        mesh(1)
        run = _jax_run(cfg, 1)
        res[f"{arch}/prefill"] = np.asarray(jax.jit(
            lambda pp, bb: JM.prefill(pp, bb, cfg, run))(jp, pre))
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda pp: JM.forward_loss(pp, jb, cfg, run), has_aux=True))(jp)
        res[f"{arch}/loss"] = np.asarray(loss)
        for k, v in metrics.items():
            res[f"{arch}/metric/{k}"] = np.asarray(v)
        for path, g in _flat_paths(jax.tree_util.tree_map(
                np.asarray, grads)).items():
            res[f"{arch}/grad/{path}"] = g
        for t in (1, 4):
            mesh(t)
            run = _jax_run(cfg, t, kind="decode")
            cross = None
            if JM.is_encdec(cfg):
                c = JM.init_cache(cfg, B, STEPS, run)["cross_k"]
                cross = (_cross(arch, c.shape), _cross(arch + "v", c.shape))
            logits, cache = _jax_decode(JM, jp, cfg, run, dec, STEPS, cross)
            res[f"{arch}/t{t}/logits"] = logits
            for path, leaf in _flat_paths(cache).items():
                res[f"{arch}/t{t}/cache/{path}"] = leaf
        mesh(SERVE["mesh_model"])
        port, tokens, margins = _jax_serve(JM, cfg, arch)
        res[f"{arch}/serve/port"] = port
        res[f"{arch}/serve/tokens"] = tokens
        res[f"{arch}/serve/margin"] = margins
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the port against the JAX side
# ---------------------------------------------------------------------------

def _port_batch(arch, runs):
    from repro_torch.configs.registry import get_smoke_arch
    cfg = get_smoke_arch(arch)
    batch, dec = _inputs(arch, cfg.d_model, cfg.vocab_size)
    return ({k: torch.as_tensor(v) for k, v in batch.items()},
            torch.as_tensor(dec))


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-30))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(jax_runs, arch, use_pallas):
    from repro_torch.models import model as TM
    cfg, run = _port_run(arch, 1, use_pallas=use_pallas)
    batch, _ = _port_batch(arch, jax_runs)
    batch = {k: v for k, v in batch.items() if k not in ("labels", "mask")}
    with torch.no_grad():
        got = TM.prefill(_params(jax_runs, arch), batch, cfg, run)
    want = jax_runs[f"{arch}/prefill"]
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(jax_runs, arch, t):
    """A teacher-forced 4-step decode at T stacked trustees: every step's
    logits, and the final caches in JAX's layout (seamless: the cross
    cache filled with the numpy values JAX's side got)."""
    from repro_torch import convert
    from repro_torch.models import model as TM
    cfg, run = _port_run(arch, t)
    _, dec = _port_batch(arch, jax_runs)
    params = _params(jax_runs, arch)
    cache = TM.init_cache(cfg, B, STEPS, run, device="cpu")
    head = f"{arch}/t{t}/cache/"
    if TM.is_encdec(cfg):
        for k in ("cross_k", "cross_v"):
            cache[k].copy_(_to_stacked(jax_runs[head + k], t))
    logits = []
    with torch.no_grad():
        for i in range(STEPS):
            out, cache = TM.decode_step(params, cache, dec[i],
                                        torch.full((B,), i,
                                                   dtype=torch.int32),
                                        cfg, run)
            logits.append(out.numpy())
    np.testing.assert_allclose(np.stack(logits),
                               jax_runs[f"{arch}/t{t}/logits"], **TOL)
    got = _flat_paths(convert.kv_cache_to_global(cache))
    want = {k[len(head):]: v for k, v in jax_runs.items()
            if k.startswith(head)}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(jax_runs, arch):
    from repro_torch.launch.steps import value_and_grad
    cfg, run = _port_run(arch, 1)
    batch, _ = _port_batch(arch, jax_runs)
    loss, metrics, grads = value_and_grad(_params(jax_runs, arch), batch,
                                          cfg, run)
    np.testing.assert_allclose(float(loss), jax_runs[f"{arch}/loss"],
                               rtol=LOSS_RTOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), jax_runs[f"{arch}/metric/{k}"],
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    got = _flat_paths(grads)
    want = {k[len(f"{arch}/grad/"):]: v for k, v in jax_runs.items()
            if k.startswith(f"{arch}/grad/")}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert _rel_rms(got[k].numpy(), v) <= GRAD_RMS, k


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_jax_decode_loop(jax_runs, arch):
    """The port's greedy tokens == JAX's argmax at every step whose top-2
    margin clears ``MARGIN`` (JAX ``serve.main`` itself fails on these
    architectures with this JAX: ROADMAP, reference side)."""
    from repro_torch.launch import serve
    gen = serve.main(serve_argv(arch))
    np.testing.assert_array_equal(gen, jax_runs[f"{arch}/serve/port"])
    want = jax_runs[f"{arch}/serve/tokens"]
    clear = jax_runs[f"{arch}/serve/margin"] > MARGIN
    assert gen.shape == want.shape
    np.testing.assert_array_equal(gen[clear], want[clear])
    # at random SMOKE weights the logits are small (std ~0.16 at 512
    # vocab rows of N(0, 0.02^2) against a normed state), so a quarter of
    # the tokens clearing the margin keeps the check from being vacuous
    assert clear.sum() >= max(1, gen.size // 4), \
        "too few tokens clear the margin"


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_is_deterministic(arch):
    from repro_torch.launch import serve
    stats = {}
    a = serve.main(serve_argv(arch), stats=stats)
    np.testing.assert_array_equal(a, serve.main(serve_argv(arch)))
    assert stats["steps"] == SERVE["prompt_len"] + a.shape[1] - 1


def test_embeds_serve_past_the_first_token_raises():
    """JAX's loop feeds a generated token's id where an embeds model's
    decode takes a (B, D) embedding: only --gen 1 is defined."""
    from repro_torch.launch import serve
    argv = serve_argv("qwen2-vl-2b")
    argv[argv.index("--gen") + 1] = "2"
    with pytest.raises(NotImplementedError, match="--gen 2"):
        serve.main(argv)


# ---------------------------------------------------------------------------
# M-RoPE, sp_residual, the layers, input_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections,d", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_mrope_matches_jax(sections, d):
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 7, 3, d)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 7)).astype(np.int32)
    got = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                        sections)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # three equal streams: plain RoPE, bit for bit
    same = torch.as_tensor(np.broadcast_to(pos[:1], pos.shape).copy())
    assert torch.equal(TL.apply_rope(torch.as_tensor(x), same, 1e6,
                                     sections),
                       TL.apply_rope(torch.as_tensor(x), same[0], 1e6))
    with pytest.raises(ValueError, match="position streams"):
        TL.apply_rope(torch.as_tensor(x), same[0], 1e6, sections)


def test_sp_residual_is_the_identity(jax_runs):
    """JAX's sequence-parallel residual is a sharding constraint: the
    port's loss, gradients and prefill are bit for bit the same with it."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import model as TM
    arch = "qwen3-4b"
    batch, _ = _port_batch(arch, jax_runs)
    out = {}
    for sp in (False, True):
        cfg, run = _port_run(arch, 1, sp_residual=sp)
        params = _params(jax_runs, arch)
        loss, _, grads = value_and_grad(params, batch, cfg, run)
        with torch.no_grad():
            pre = TM.prefill(params, {"tokens": batch["tokens"]}, cfg, run)
        out[sp] = (loss, _flat_paths(grads), pre)
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][2], out[True][2])
    for k, g in out[False][1].items():
        assert torch.equal(g, out[True][1][k]), k


def test_geglu_and_the_tied_scaled_embedding_match_jax():
    """gemma-7b's layers: the GeGLU MLP (tanh GELU in f32) and the tied
    embedding scaled by sqrt(d_model), read and used as the unembedding."""
    import jax.numpy as jnp
    from repro.configs.registry import SMOKE_ARCHS
    from repro.models import layers as JL
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.models import layers as TL
    jcfg, tcfg = SMOKE_ARCHS["gemma-7b"], get_smoke_arch("gemma-7b")
    rng = np.random.default_rng(3)
    d, f = tcfg.d_model, tcfg.d_ff
    w = {k: rng.normal(size=s).astype(np.float32) / 8 for k, s in
         (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    got = TL.mlp({k: torch.as_tensor(v) for k, v in w.items()},
                 torch.as_tensor(x), tcfg.act)
    want = JL.mlp({k: jnp.asarray(v) for k, v in w.items()},
                  jnp.asarray(x), jcfg.act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    emb = {"embedding": rng.normal(size=(512, d)).astype(np.float32)}
    ids = rng.integers(0, 512, (2, 5)).astype(np.int32)
    temb = {k: torch.as_tensor(v) for k, v in emb.items()}
    jemb = {k: jnp.asarray(v) for k, v in emb.items()}
    np.testing.assert_allclose(
        TL.embed_lookup(temb, torch.as_tensor(ids), tcfg).numpy(),
        np.asarray(JL.embed_lookup(jemb, jnp.asarray(ids), jcfg)), **TOL)
    assert TL.unembed_weight(temb, tcfg) is temb["embedding"]


def test_final_hidden_is_what_the_loss_reads():
    """``testing.model.FinalHidden`` (chip_smoke's phase-11 check of
    seamless's forward_loss) keeps the final decoder hidden state, (B, S,
    D): the cross-entropy of it is the loss, bit for bit, and the loss
    with the recorder on is the loss without it."""
    from repro_torch.models import encdec
    from repro_torch.models import model as TM
    from repro_torch.models.layers import unembed_weight
    from repro_torch.testing.model import FinalHidden
    arch = "seamless-m4t-large-v2"
    cfg, run = _port_run(arch, 2)
    params = TM.init_params(cfg, run, device="cpu")
    np_batch, _ = _inputs(arch, cfg.d_model, cfg.vocab_size)
    batch = {k: torch.as_tensor(v) for k, v in np_batch.items()}
    with torch.no_grad():
        loss, _ = TM.forward_loss(params, batch, cfg, run)
        with FinalHidden() as rec:
            again, _ = TM.forward_loss(params, batch, cfg, run)
        nll, _ = encdec.delegated_softmax_xent(
            rec.hidden, unembed_weight(params["embed"], cfg),
            batch["labels"], cfg, batch["mask"], chunk=run.xent_chunk,
            n_shards=run.mesh.model_size)
    assert rec.hidden.shape == (B, S, cfg.d_model)
    assert torch.equal(loss, again) and torch.equal(nll, loss)
    assert encdec.delegated_softmax_xent is not rec._call


@pytest.mark.parametrize("kind", ["attention", "mlp"])
def test_stacked_leaves_are_drawn_a_layer_at_a_time(kind):
    """Every stacked leaf is drawn one layer slice at a time from the
    generator, in leaf order, whatever its size: the stacked draw equals
    the slices drawn one after another from an equally seeded
    generator."""
    from repro_torch.models import attention as TA
    from repro_torch.models import layers as TL
    cfg, _ = _port_run("qwen3-4b", 1)
    lead, d = (3,), cfg.d_model

    def draw(gen):
        if kind == "mlp":
            return TL.init_mlp(gen, d, cfg.d_ff, torch.float32, "cpu",
                               lead=lead)
        return TA.init_attention(cfg, torch.float32, "cpu", gen=gen,
                                 lead=lead)
    got = draw(torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    shapes = {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
              "w_down": (cfg.d_ff, d)} if kind == "mlp" else {
        "w_q": got["w_q"].shape[1:], "w_k": got["w_k"].shape[1:],
        "w_v": got["w_v"].shape[1:], "w_o": got["w_o"].shape[1:][::-1]}
    for name, shape in shapes.items():
        scale = 1.0 / shape[0] ** 0.5 if kind == "mlp" else 1.0 / d ** 0.5
        want = torch.stack([torch.randn(shape, generator=gen) * scale
                            for _ in range(lead[0])])
        if name == "w_o":
            want = want.transpose(-2, -1)
        assert torch.equal(got[name], want), name


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_match_jax(arch, kind):
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.registry import ARCHS as JARCHS
    from repro.models import model as JM
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as TM
    cfg = get_arch(arch)
    run = RunConfig(model=cfg, shape=ShapeConfig("c", 64, 4, kind))
    got = TM.input_specs(cfg, run.shape, run)
    want = JM.input_specs(JARCHS[arch], JShape("c", 64, 4, kind))
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in got.items():
        assert shape == want[k].shape, k
        assert str(dtype).split(".")[-1] == str(want[k].dtype), k


# ---------------------------------------------------------------------------
# convert, the trainer
# ---------------------------------------------------------------------------

def test_encdec_convert_round_trip(jax_runs):
    from repro_torch import convert
    arch = "seamless-m4t-large-v2"
    p = _tree(jax_runs, f"{arch}/params/")
    assert sorted(p) == ["decoder", "embed", "enc_norm", "encoder",
                         "final_norm"]
    assert {"ln_x", "xattn"} <= set(p["decoder"])
    back = _flat_paths(convert.model_params_to_numpy(
        convert.model_params_from_jax(p, device="cpu")))
    want = _flat_paths(p)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_trainer_runs_embeds_and_encdec_models(arch):
    """launch.train on the stub-frontend batches (embeddings moved to the
    card's activation dtype): six steps of finite losses."""
    from repro_torch.launch import train
    stats = {}
    hist = train.main(["--arch", arch, "--smoke", "--steps", "6", "--batch",
                       "2", "--seq", "16", "--lr", "5e-3", "--log-every",
                       "100", "--device", "cpu"], stats=stats)
    losses = [l for _, l in hist]
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert {"embeds", "src_embeds"} & set(
        stats["pipeline"].model_batch_at(0))


if __name__ == "__main__":
    _jax_main(sys.argv[1])
