"""The last two architectures of the JAX registry — jamba-v0.1-52b (a
period-8 group of Mamba and attention layers, MoE on every second layer)
and arctic-480b (a 128-expert top-2 MoE beside a dense residual MLP) —
and the last public names of ``repro.core``, against the JAX package.

At SMOKE width on the CPU in f32, on weights carried across by
``convert`` (norm scales drawn with numpy):

  * ``prefill``'s last-position logits == JAX ``M.prefill``, with
    ``use_pallas`` off and on (on CPU tensors the kernels' wrappers run
    their plain versions);
  * the logits of a teacher-forced 4-step decode and the final cache —
    jamba's attention KV over the trustees beside its Mamba (conv, ssm)
    state — in JAX's layout, at T = 1 and T = 4 stacked trustees against
    JAX on a 1x4 mesh;
  * ``forward_loss`` and every gradient leaf == ``jax.value_and_grad`` of
    JAX's ``forward_loss``;
  * ``serve.main``: deterministic; its greedy tokens == the argmax of a
    JAX loop of ``M.decode_step`` (bf16, T = 4) on the serve's weights
    wherever JAX's top-2 margin exceeds ``MARGIN``; ``launch.train
    --smoke`` takes two steps of finite loss;
  * in bf16 on the serve's weights and prompt, the port's prefill and
    its serve's decode at the last prompt position are no further apart
    than JAX's prefill and decode are, and each is within
    ``BF16_PACKAGES_RMS`` of JAX's;
  * ``channel.delegate_async`` then ``wait()``: bit for bit JAX's on an
    integer-exact GET/PUT/ADD/CAS round over 8 stacked shards, the local
    shortcut off and on, combining off and on — every response, the
    dropped rows and the tables — and the same as ``delegate``; the
    response transposes wait for ``wait()``;
  * ``block_router`` / ``page_router`` / ``hash_router`` (uint32,
    wrapping at 2^32) and ``expected_max_load`` == JAX's on seeded keys;
    ``make_kv_ops`` is ``make_kv_schema(...).delegated_ops()``;
    ``constrain`` is the identity; the config properties and
    ``pad_to_multiple`` == JAX's for every architecture; the port's
    ``repro_torch.core.__all__`` covers JAX's;
  * ``testing.model.GmmCheck`` holds a call against its plain version a
    chunk of experts at a time, with the whole call's verdict and error;
    ``ChunkedPlainGmm`` leaves the plain prefill's logits as they are.

The JAX side runs on 8 virtual devices in one subprocess (this module run
as a script); it jits its steps and ``value_and_grad``.

Tolerances (``test_torch_zoo.py``'s, for the same reasons): f32 logits
and caches 2e-5 (rtol and atol), the loss and metrics rtol 1e-5, each
gradient leaf 1e-4 in relative RMS; bf16 serve tokens where JAX's top-2
margin exceeds ``MARGIN`` = 0.02; bf16 logits against JAX's 5e-2 in
relative RMS.  The KV round and the routers are exact.
"""
import dataclasses
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import subprocess

import numpy as np
import pytest
import torch

ARCHS = ("jamba-v0.1-52b", "arctic-480b")
B, S, STEPS, XENT_CHUNK = 2, 8, 4, 4
TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL, GRAD_RMS = 1e-5, 1e-4
MARGIN = 0.02
# the port's bf16 logits against JAX's on the same weights and prompt:
# the two packages round activations to bf16 at different places, as a
# dense model's bf16 prefill and decode do (``testing.model``'s
# ``PREFILL_DECODE_RTOL``, 5e-2)
BF16_PACKAGES_RMS = 5e-2
SERVE = dict(batch=4, prompt_len=4, gen=4, mesh_model=4)

# the KV round of delegate_async: 8 shards, 64 rows a shard over 128 keys
# (16 a trustee, hot keys so that segments combine and pairs overflow
# their 6 + 4 slots), 3 f32 words a value
KV_DEV, KV_ROWS, KV_KEYS, KV_VW, KV_CAP, KV_CAP2 = 8, 64, 128, 3, 6, 4
KV_CASES = {"plain": (False, False), "shortcut": (True, False),
            "combine": (False, True), "shortcut_combine": (True, True)}


def serve_argv(arch):
    return ["--arch", arch, "--smoke", "--batch", str(SERVE["batch"]),
            "--prompt-len", str(SERVE["prompt_len"]), "--gen",
            str(SERVE["gen"]), "--mesh-model", str(SERVE["mesh_model"]),
            "--device", "cpu"]


def _jax_run(cfg, t, dtype="float32", kind="train"):
    from repro.configs.base import MeshConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("t", S, B, kind),
                     mesh=MeshConfig((1, t), ("data", "model")),
                     remat="none", param_dtype=dtype,
                     activation_dtype=dtype, xent_chunk=XENT_CHUNK)


def _port_run(arch, t, **kw):
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    cfg = get_smoke_arch(arch)
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                          mesh=MeshConfig((1, t), ("data", "model")),
                          param_dtype="float32", activation_dtype="float32",
                          xent_chunk=XENT_CHUNK, **{"remat": "none", **kw})


def _inputs(arch, vocab):
    """A train batch (tokens, labels, a mask) and STEPS decode tokens."""
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    return batch, rng.integers(0, vocab, (STEPS, B)).astype(np.int32)


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
    """The nested tree saved under ``head``."""
    tree = {}
    for key, leaf in runs.items():
        if key.startswith(head):
            *path, last = key[len(head):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[last] = leaf
    return tree


def _params(runs, arch):
    from repro_torch import convert
    return convert.model_params_from_jax(_tree(runs, f"{arch}/params/"),
                                         device="cpu")


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-30))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_hybrid") / "runs.npz"
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
# the KV round, both packages: seeded integer-exact rows
# ---------------------------------------------------------------------------

def kv_inputs():
    """(table (D*K/D, VW), and per shard-major rows: op, key, value,
    expect (D*R, ...)), a Zipf-hot mix of the four ops."""
    rng = np.random.default_rng(27)
    n = KV_DEV * KV_ROWS
    hot = rng.integers(0, 6, n)
    key = np.where(rng.random(n) < 0.5, hot, rng.integers(0, KV_KEYS, n))
    table = rng.integers(0, 8, (KV_KEYS, KV_VW)).astype(np.float32)
    value = rng.integers(0, 8, (n, KV_VW)).astype(np.float32)
    # a shard's table rows are its keys, key // D, in key order
    local = table.reshape(KV_KEYS // KV_DEV, KV_DEV, KV_VW) \
        .transpose(1, 0, 2).reshape(KV_KEYS, KV_VW)
    expect = np.where(rng.random((n, 1)) < 0.5, table[key], value)
    return local, {"op": rng.integers(0, 4, n).astype(np.int32),
                   "key": key.astype(np.int32), "value": value,
                   "expect": expect.astype(np.float32)}


def kv_spans(pkg):
    """The KV ops' combine spans (GET dedupe, PUT last, ADD sum; CAS
    none): the span of a row is its op, CAS's -1."""
    return (pkg.CombineSpan("dedupe", "key"), pkg.CombineSpan("last", "key"),
            pkg.CombineSpan("sum", "key", sum_lane="value"))


def _jax_kv_round(shortcut, combine):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    from repro.core import channel as jch
    from repro.core import make_kv_ops, serve_optable
    mesh = Mesh(np.array(jax.devices()[:KV_DEV]), ("model",))
    cfg = jch.ChannelConfig(axis="model", capacity=KV_CAP,
                            overflow="second_round",
                            overflow_capacity=KV_CAP2,
                            local_shortcut=shortcut,
                            combine_impl="ref" if combine else "off")
    serve = serve_optable(make_kv_ops(KV_DEV, KV_VW), active_ids=(0, 1, 2, 3),
                          serve_impl="ref")
    comb = jch.RequestCombiner(kv_spans(jch)) if combine else None

    def body(table, op, key, value, expect):
        payload = {"op": op, "key": key, "value": value, "expect": expect}
        dst = (key % KV_DEV).astype(jnp.int32)
        span = jnp.where(op < 3, op, -1).astype(jnp.int32)
        state, fut, info = jch.delegate_async(
            {"table": table}, dst, payload, serve, KV_DEV, cfg,
            combine=comb, combine_span=span if combine else None)
        resp = fut.wait()
        return state["table"], resp["value"], resp["flag"], info.dropped

    spec = P("model")
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 5,
                          out_specs=(spec,) * 4, check_rep=False))
    table, rows = kv_inputs()
    out = f(jnp.asarray(table), *(jnp.asarray(rows[k]) for k in
                                  ("op", "key", "value", "expect")))
    return [np.asarray(o) for o in out]


def _port_kv_round(shortcut, combine, sync=False):
    from repro_torch.core import channel as ch
    from repro_torch.core import make_kv_ops, serve_optable
    cfg = ch.ChannelConfig(capacity=KV_CAP, overflow="second_round",
                           overflow_capacity=KV_CAP2, local_shortcut=shortcut,
                           combine_impl="ref" if combine else "off")
    serve = serve_optable(make_kv_ops(KV_DEV, KV_VW), (0, 1, 2, 3),
                          serve_impl="kernel", cfg=cfg)
    table, rows = kv_inputs()
    stack = lambda a: torch.as_tensor(a).reshape(
        (KV_DEV, -1) + a.shape[1:])
    payload = {k: stack(v) for k, v in rows.items()}
    dst = (payload["key"] % KV_DEV).to(torch.int32)
    span = torch.where(payload["op"] < 3, payload["op"], -1)
    kw = dict(combine=ch.RequestCombiner(kv_spans(ch)), combine_span=span) \
        if combine else {}
    state = {"table": stack(table)}
    if sync:
        state, resp, info = ch.delegate(state, dst, payload, serve, KV_DEV,
                                        cfg, **kw)
        moves = None
    else:
        with ch.collect_transposes() as moves:
            state, fut, info = ch.delegate_async(state, dst, payload, serve,
                                                 KV_DEV, cfg, **kw)
            served = list(moves)
            resp = fut.wait()
        moves = (served, list(moves))
    out = [state["table"], resp["value"], resp["flag"], info.dropped]
    return [o.reshape((-1,) + tuple(o.shape[2:])).numpy() for o in out], moves


# ---------------------------------------------------------------------------
# the JAX side, 8 virtual devices, one subprocess
# ---------------------------------------------------------------------------

def _jax_params(arch):
    """SMOKE weights (f32) in JAX's layout as numpy: the port's draw on
    the CPU (seed 1; JAX's own init compiles for longer than the rest of
    an architecture's checks) through ``convert``, every norm scale drawn
    from a numpy seed."""
    from repro.configs.registry import SMOKE_ARCHS
    from repro_torch import convert
    from repro_torch.models import model as TM
    _, trun = _port_run(arch, 1)
    p = convert.model_params_to_numpy(TM.init_params(
        trun.model, trun, device="cpu", gen=torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(5)

    def draw(tree):
        if not isinstance(tree, dict):
            return tree
        return {k: (1 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
                if k == "scale" else draw(v) for k, v in tree.items()}
    return SMOKE_ARCHS[arch], draw(p)


def _bf16_but_f32_leaves(tree, key=None):
    import jax.numpy as jnp
    from repro_torch.convert import F32_LEAVES
    if isinstance(tree, dict):
        return {k: _bf16_but_f32_leaves(v, k) for k, v in tree.items()}
    return jnp.asarray(tree, jnp.float32 if key in F32_LEAVES else
                       jnp.bfloat16)


def _jax_serve(JM, cfg, arch):
    """JAX's decode loop (bf16, T = 4) on the port's serve weights, fed
    the serve's prompt and then the port's own tokens, and each package's
    bf16 prefill of the prompt on those weights: {"port": the port's
    tokens, "tokens": JAX's argmax tokens, "margin": their top-2 margins,
    and the last prompt position's logits of each package's "prefill" and
    "decode" (the port's serve's own decode step, ``DecodeLogits``)}."""
    import jax
    import jax.numpy as jnp
    from repro_torch import convert
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as TM
    from repro_torch.testing.model import DecodeLogits
    pl, b, t = SERVE["prompt_len"], SERVE["batch"], SERVE["mesh_model"]
    with DecodeLogits(pos=pl - 1) as rec:
        port = serve.main(serve_argv(arch))
    gen = port.shape[1]
    max_len = -(-(pl + gen) // t) * t
    tcfg = get_smoke_arch(arch)
    mesh = MeshConfig((1, t), ("data", "model"))
    trun = RunConfig(model=tcfg, shape=ShapeConfig("cli", max_len, b,
                                                   "decode"), mesh=mesh)
    tp = TM.init_params(tcfg, trun, device="cpu")     # the serve's weights
    jp = _bf16_but_f32_leaves(convert.model_params_to_numpy(tp))
    run = _jax_run(cfg, t, "bfloat16", kind="decode")
    cache = JM.init_cache(cfg, b, max_len, run)
    step = jax.jit(lambda c, tok, pos: JM.decode_step(jp, c, tok, pos, cfg,
                                                      run))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(pl, b))
    jprompt = jnp.asarray(prompt, jnp.int32)
    out = {"port": port}
    tokens, margins = [], []
    for i in range(pl + gen - 1):
        tok = jprompt[i] if i < pl else jnp.asarray(port[:, i - pl],
                                                    jnp.int32)
        logits, cache = step(cache, tok, jnp.full((b,), i, jnp.int32))
        if i >= pl - 1:
            logits = np.asarray(logits)
            top2 = np.sort(logits, axis=-1)[:, -2:]
            tokens.append(logits.argmax(-1))
            margins.append(top2[:, 1] - top2[:, 0])
        if i == pl - 1:
            out["jax/decode"] = logits.astype(np.float32)
    out["tokens"], out["margin"] = np.stack(tokens, 1), np.stack(margins, 1)
    prun = dataclasses.replace(run, shape=dataclasses.replace(
        run.shape, seq_len=pl, global_batch=b, kind="prefill"))
    out["jax/prefill"] = np.asarray(jax.jit(
        lambda pp, tt: JM.prefill(pp, {"tokens": tt}, cfg, prun))(
        jp, jprompt.T), np.float32)
    pshape = ShapeConfig("prompt", pl, b, "prefill")
    with torch.no_grad():
        out["port/prefill"] = build_cell(
            tcfg, pshape, dataclasses.replace(trun, shape=pshape)).step_fn(
            tp, {"tokens": torch.as_tensor(prompt.T)}).float().numpy()
    out["port/decode"] = rec.logits.float().numpy()
    return out


def _jax_arch(arch):
    """One architecture's JAX results (run in its own thread: the JAX
    package keeps its mesh context per thread)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import meshctx
    from repro.models import model as JM
    res = {}

    def mesh(t):
        meshctx.set_context(Mesh(np.array(jax.devices()[:t]).reshape(1, t),
                                 ("data", "model")), ("data",))
    cfg, p = _jax_params(arch)
    for path, leaf in _flat_paths(p).items():
        res[f"{arch}/params/{path}"] = leaf
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    batch, dec = _inputs(arch, cfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh(1)
    run = _jax_run(cfg, 1)
    res[f"{arch}/prefill"] = np.asarray(jax.jit(
        lambda pp, tt: JM.prefill(pp, {"tokens": tt}, cfg, run))(
        jp, jb["tokens"]))
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
        cache = JM.init_cache(cfg, B, STEPS, run)
        step = jax.jit(lambda c, tok, pos: JM.decode_step(
            jp, c, tok, pos, cfg, run))
        logits = []
        for i in range(STEPS):
            out, cache = step(cache, jnp.asarray(dec[i]),
                              jnp.full((B,), i, jnp.int32))
            logits.append(np.asarray(out))
        res[f"{arch}/t{t}/logits"] = np.stack(logits)
        for path, leaf in _flat_paths(jax.tree_util.tree_map(
                np.asarray, cache)).items():
            res[f"{arch}/t{t}/cache/{path}"] = leaf
    mesh(SERVE["mesh_model"])
    for k, v in _jax_serve(JM, cfg, arch).items():
        res[f"{arch}/serve/{k}"] = v
    return res


def _jax_kv():
    res = {}
    for name, (shortcut, combine) in KV_CASES.items():
        for i, o in enumerate(_jax_kv_round(shortcut, combine)):
            res[f"kv/{name}/{i}"] = o
    return res


def _jax_main(out_path):
    """Both architectures and the KV rounds, each in a thread of its own
    (XLA compiles them side by side)."""
    from concurrent.futures import ThreadPoolExecutor
    res = {}
    with ThreadPoolExecutor(len(ARCHS) + 1) as pool:
        jobs = [pool.submit(_jax_arch, a) for a in ARCHS]
        jobs.append(pool.submit(_jax_kv))
        for job in jobs:
            res.update(job.result())
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# the models against the JAX side
# ---------------------------------------------------------------------------

def _port_batch(arch):
    from repro_torch.configs.registry import get_smoke_arch
    batch, dec = _inputs(arch, get_smoke_arch(arch).vocab_size)
    return ({k: torch.as_tensor(v) for k, v in batch.items()},
            torch.as_tensor(dec))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(jax_runs, arch, use_pallas):
    from repro_torch.models import model as TM
    cfg, run = _port_run(arch, 1, use_pallas=use_pallas)
    batch, _ = _port_batch(arch)
    with torch.no_grad():
        got = TM.prefill(_params(jax_runs, arch),
                         {"tokens": batch["tokens"]}, cfg, run)
    want = jax_runs[f"{arch}/prefill"]
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(jax_runs, arch, t):
    """A teacher-forced 4-step decode at T stacked trustees: every step's
    logits, and the final cache in JAX's layout (jamba: the attention
    layers' KV beside the Mamba layers' conv and ssm state)."""
    from repro_torch import convert
    from repro_torch.models import model as TM
    cfg, run = _port_run(arch, t)
    _, dec = _port_batch(arch)
    params = _params(jax_runs, arch)
    cache = TM.init_cache(cfg, B, STEPS, run, device="cpu")
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
    head = f"{arch}/t{t}/cache/"
    got = _flat_paths(convert.kv_cache_to_global(cache))
    want = {k[len(head):]: v for k, v in jax_runs.items()
            if k.startswith(head)}
    assert sorted(got) == sorted(want)
    if arch == "jamba-v0.1-52b":
        assert {k.split("/")[-1] for k in want} == {"k", "v", "conv", "ssm"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(jax_runs, arch):
    from repro_torch.launch.steps import value_and_grad
    cfg, run = _port_run(arch, 1)
    batch, _ = _port_batch(arch)
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
    margin clears ``MARGIN``."""
    from repro_torch.launch import serve
    gen = serve.main(serve_argv(arch))
    np.testing.assert_array_equal(gen, jax_runs[f"{arch}/serve/port"])
    want = jax_runs[f"{arch}/serve/tokens"]
    clear = jax_runs[f"{arch}/serve/margin"] > MARGIN
    assert gen.shape == want.shape
    np.testing.assert_array_equal(gen[clear], want[clear])
    assert clear.sum() >= max(1, gen.size // 4), \
        "too few tokens clear the margin"


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_decode_gap_is_no_more_than_jaxs(jax_runs, arch):
    """In bf16 the prefill's logits at the last prompt position and the
    decode's there are two readings of one function, apart by the two
    paths' roundings: on the serve's weights and prompt the port's two
    are no further apart than JAX's own two are (JAX's prefill rounds the
    Mamba conv after each add, a settled divergence), and each package's
    prefill is near the other's."""
    r = {k: jax_runs[f"{arch}/serve/{k}"] for k in (
        "port/prefill", "port/decode", "jax/prefill", "jax/decode")}
    port_gap = _rel_rms(r["port/prefill"], r["port/decode"])
    jax_gap = _rel_rms(r["jax/prefill"], r["jax/decode"])
    assert 0 < jax_gap and port_gap <= jax_gap, (port_gap, jax_gap)
    for which in ("prefill", "decode"):
        assert _rel_rms(r[f"port/{which}"], r[f"jax/{which}"]) \
            <= BF16_PACKAGES_RMS, which


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_is_deterministic_and_takes_a_config(arch):
    """Two serves give the same tokens, and ``cfg=`` in place of
    ``--arch --smoke`` serves the same model."""
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch import serve
    stats = {}
    a = serve.main(serve_argv(arch), stats=stats)
    np.testing.assert_array_equal(a, serve.main(serve_argv(arch)))
    argv = serve_argv(arch)[3:]                 # no --arch, no --smoke
    np.testing.assert_array_equal(
        a, serve.main(argv, cfg=get_smoke_arch(arch)))
    assert stats["steps"] == SERVE["prompt_len"] + a.shape[1] - 1
    with pytest.raises(SystemExit):
        serve.main(serve_argv(arch), cfg=get_smoke_arch(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_takes_two_smoke_steps(arch):
    from repro_torch.launch import train
    hist = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                       "2", "--seq", "16", "--log-every", "100",
                       "--device", "cpu"])
    losses = [l for _, l in hist]
    assert len(losses) == 2 and np.all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# the core names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(KV_CASES))
def test_delegate_async_matches_jax(jax_runs, case):
    """delegate_async then wait() == JAX's bit for bit (the table, every
    response value and flag, the dropped rows) and == delegate; the
    serve has run (the request moved) before wait(), the response moves
    in wait()."""
    shortcut, combine = KV_CASES[case]
    got, (before, after) = _port_kv_round(shortcut, combine)
    for i, (g, what) in enumerate(zip(got, ("table", "value", "flag",
                                            "dropped"))):
        np.testing.assert_array_equal(g, jax_runs[f"kv/{case}/{i}"],
                                      err_msg=what)
    sync, _ = _port_kv_round(shortcut, combine, sync=True)
    for g, s in zip(got, sync):
        np.testing.assert_array_equal(g, s)
    assert "response" not in before and after[-1] == "response"
    assert got[3].any(), "no row overflowed its slots"


def test_routers_match_jax():
    import jax.numpy as jnp
    from repro.core import routing as JR
    from repro_torch.core import routing as TR
    rng = np.random.default_rng(7)
    keys = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 4000),
                           [0, -1, 2 ** 31 - 1, -2 ** 31, 65535, 65536]]
                          ).astype(np.int32)
    pos = rng.integers(0, 1 << 20, 4000).astype(np.int32)
    tk, tp = torch.as_tensor(keys), torch.as_tensor(pos)
    for t in (1, 3, 8, 16):
        for got, want in (
                (TR.hash_router(tk, t), JR.hash_router(jnp.asarray(keys), t)),
                (TR.block_router(tk, 1000, t),
                 JR.block_router(jnp.asarray(keys), 1000, t)),
                (TR.page_router(tp, 16, t),
                 JR.page_router(jnp.asarray(pos), 16, t))):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for dist, alpha in (("uniform", 1.0), ("zipf", 1.0), ("zipf", 1.3)):
        assert TR.expected_max_load(1000, 8, 8192, dist, alpha) == \
            JR.expected_max_load(1000, 8, 8192, dist, alpha)


def test_make_kv_ops_constrain_and_the_exports():
    """``make_kv_ops`` is the schema's compiled op table (JAX's back-compat
    name), ``constrain`` the identity on stacked shards, and the port's
    ``repro_torch.core.__all__`` holds every name of JAX's."""
    import repro.core as jcore
    import repro_torch.core as tcore
    ops = tcore.make_kv_ops(8, 3)
    want = tcore.make_kv_schema(8, 3).delegated_ops()
    assert [(o.name, o.kernel_lane, o.resp_fields) for o in ops] == \
        [(o.name, o.kernel_lane, o.resp_fields) for o in want]
    assert [o.name for o in ops] == \
        [o.name for o in jcore.make_kv_ops(8, 3)]
    x = torch.arange(12.0).reshape(3, 4)
    assert tcore.constrain(x, "data", None) is x
    assert set(jcore.__all__) <= set(tcore.__all__)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_properties_match_jax(smoke):
    from repro.configs import base as jbase
    from repro.configs.registry import ARCHS, SMOKE_ARCHS
    from repro_torch.configs import base as tbase
    from repro_torch.configs.registry import get_arch, get_smoke_arch
    jarchs = SMOKE_ARCHS if smoke else ARCHS
    get = get_smoke_arch if smoke else get_arch
    for name, jcfg in jarchs.items():
        tcfg = get(name)
        for prop in ("is_attention_free", "has_subquadratic_context",
                     "resolved_head_dim"):
            assert getattr(tcfg, prop) == getattr(jcfg, prop), (name, prop)
    for x, m in ((0, 8), (1, 8), (56, 16), (64, 16), (65024, 128)):
        assert tbase.pad_to_multiple(x, m) == jbase.pad_to_multiple(x, m)


def test_gmm_check_by_chunks_gives_the_whole_verdict():
    """``GmmCheck`` runs the plain version and the tolerance a chunk of
    experts at a time: its plain output is the whole call's bit for bit,
    and a kernel output within the tolerance, or off by more in one
    expert, gets the same verdict and error whether the check takes
    every expert at once or one at a time, and the whole call's
    ``gmm_within``."""
    from repro_torch.kernels import ref
    from repro_torch.testing.model import GmmCheck, gmm_within
    gen = torch.Generator().manual_seed(3)
    e, c, d, f = 7, 24, 16, 40
    x = torch.randn((e, c, d), generator=gen).to(torch.bfloat16)
    w = torch.randn((e, d, f), generator=gen).to(torch.bfloat16)
    counts = torch.tensor([24, 0, 5, 17, 24, 1, 9], dtype=torch.int32)
    x[torch.arange(c)[None, :] >= counts[:, None]] = 0
    whole = ref.grouped_matmul(x, w, counts)
    bad = whole.clone()
    bad[4, 3, 7] += 2.0
    verdicts = []
    for plain_bytes in (1, 3 * 4 * d * f, 1 << 40):   # 1, 3, 7 experts
        chk = GmmCheck()
        chk.plain_bytes = plain_bytes
        with chk:
            plain = chk._plain(x, w, counts)
            assert torch.equal(plain, whole)
            verdicts.append((chk._within(whole, plain, (x, w, counts)),
                             chk._within(bad, plain, (x, w, counts))))
    assert verdicts[0] == verdicts[1] == verdicts[2]
    assert verdicts[0] == (gmm_within(whole, whole, x, w),
                           gmm_within(bad, whole, x, w))
    assert verdicts[0][1][0] is False and verdicts[0][0][0] is True


def test_chunked_plain_gmm_is_the_plain_path(monkeypatch):
    """Under ``ChunkedPlainGmm`` (one expert a chunk here) arctic's plain
    bf16 prefill gives the logits of the plain path bit for bit, and the
    plain grouped matmul is itself again after the context."""
    from repro_torch.kernels import ref
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as TM
    from repro_torch.testing.model import ChunkedPlainGmm, GmmCheck
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    cfg = get_smoke_arch("arctic-480b")
    shape = ShapeConfig("prompt", 8, 4, "prefill")
    run = RunConfig(model=cfg, shape=shape,
                    mesh=MeshConfig((1, 4), ("data", "model")))
    params = TM.init_params(cfg, run, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 8)))
    step = build_cell(cfg, shape, run).step_fn
    want = step(params, {"tokens": tokens})
    calls = []
    plain = ref.grouped_matmul

    def counted(x, w, counts=None):
        calls.append(x.shape[0])
        return plain(x, w, counts)
    monkeypatch.setattr(ref, "grouped_matmul", counted)
    monkeypatch.setattr(GmmCheck, "plain_bytes", 1)
    with ChunkedPlainGmm():
        got = step(params, {"tokens": tokens})
    assert ref.grouped_matmul is counted
    assert calls and set(calls) == {1}
    assert torch.equal(got, want)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
