"""The captured train, prefill and paged-decode steps
(``launch/steps.CompiledCell``, ``launch/paged_decode.run_decode``'s
``write_kv``) on the CPU stand-in of
``core/compiled.py``, at SMOKE width:

  (a) captured == eager (``compiled.disable()``) bit for bit over 3 train
      steps — every parameter, both moments, the step count and every
      metric: qwen2.5-3b under grad_accum 1 and 2 and remat none / dots /
      full, deepseek-v2-lite-16b (the MoE over 4 trustees, the "ref"
      pack), falcon-mamba-7b and seamless-m4t-large-v2;
  (b) 3 captured train steps on a (2, 4) mesh against JAX's jitted
      ``build_cell`` train step (``src/repro/launch/steps.py``) on a (2, 4)
      mesh of 8 virtual devices: the losses and metrics within rtol 1e-5
      (``tests/test_torch_train.py``'s), every parameter after the steps
      within 1e-4 of its RMS in relative RMS or 1e-3 x lr absolute
      (``tests/test_torch_dataaxis.py``'s bound for the same comparison:
      a leaf whose true gradient is zero, as the key bias's under a
      softmax, moves by AdamW's normalised rounding noise, up to lr a
      step, in both packages);
  (c) the programs: the same addresses replay one program, a restore
      onto new tensors makes one new program and releases the old, the
      trainer with an injected failure gives the eager trajectory, the
      replayed steps' ``lr`` follows ``schedule`` with no tensor read
      into Python inside the step;
  (d) captured prefill == eager bit for bit: dense, MoE (its channel's
      transposes counted the same), Mamba, hybrid, embeds with M-RoPE
      and encoder-decoder; a new batch shape releases the old program;
  (e) the paged decode's callbacks captured give the eager outputs, pool
      and page table bit for bit, one program a distinct shape;
  (f) ``compiled.disable()`` caches nothing at the three sites;
  (g) ``TrustSession`` takes JAX's ``donate_states``.

The JAX side of (b) runs in one subprocess: this module, run as a script.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import contextlib
import subprocess

import numpy as np
import pytest

B, S, STEPS, XENT_CHUNK = 2, 16, 3, 8
LOSS_RTOL, PARAM_RMS = 1e-5, 1e-4
JB, JMESH = 4, (2, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side on one intra-op thread (SMOKE-sized ops gain
    nothing from more beside the other test workers)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(arch, t=1, remat="none", b=B, data=1, **kw):
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    cfg = get_smoke_arch(arch)
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("t", S, b, "train"),
                          mesh=MeshConfig((data, t), ("data", "model")),
                          remat=remat, param_dtype="float32",
                          activation_dtype="float32", xent_chunk=XENT_CHUNK,
                          **kw)


def _batch(cfg, shape, run, seed):
    """A batch of ``model.input_specs`` drawn from a numpy seed: token ids
    and labels in the vocab, embeddings N(0, 0.02^2), M-RoPE's three
    position streams equal."""
    import torch
    from repro_torch.models import model as M
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shp, dtype) in M.input_specs(cfg, shape, run).items():
        if name == "positions":
            out[name] = torch.arange(shp[-1], dtype=dtype)[None, None] \
                .expand(shp).contiguous()
        elif dtype.is_floating_point:
            out[name] = torch.as_tensor(
                rng.normal(size=shp) * 0.02).to(dtype)
        else:
            out[name] = torch.as_tensor(
                rng.integers(0, cfg.vocab_size, shp).astype(np.int32))
    return out


def _train(cfg, run, eager, steps=STEPS, params=None):
    """``steps`` train steps from seed-0 weights (or ``params``): (params,
    opt_state, [metrics], plan)."""
    from repro_torch.core import compiled
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.optim import init_adamw
    plan = build_cell(cfg, run.shape, run)
    if params is None:
        params = M.init_params(cfg, run, "cpu")
    opt = init_adamw(params)
    metrics = []
    with (compiled.disable() if eager else contextlib.nullcontext()):
        for i in range(steps):
            params, opt, m = plan.step_fn(params, opt,
                                          _batch(cfg, run.shape, run, i))
            metrics.append({k: v.clone() for k, v in m.items()})
    return params, opt, metrics, plan


def _leaves(params, opt):
    from repro_torch.optim.optimizer import tree_leaves
    return tree_leaves(params) + tree_leaves(tuple(opt))


def _same_training(a, b):
    import torch
    la, lb = _leaves(a[0], a[1]), _leaves(b[0], b[1])
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"leaf {i} differs"
    assert [sorted(m) for m in a[2]] == [sorted(m) for m in b[2]]
    for i, (ma, mb) in enumerate(zip(a[2], b[2])):
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (i, k)


TRAIN_CASES = [("qwen2.5-3b", 1, accum, remat) for accum in (1, 2)
               for remat in ("none", "dots", "full")] + [
    ("deepseek-v2-lite-16b", 4, 1, "none"),
    ("falcon-mamba-7b", 1, 1, "full"),
    ("seamless-m4t-large-v2", 1, 1, "dots")]


@pytest.mark.parametrize(
    "arch,t,accum,remat", TRAIN_CASES,
    ids=[f"{a.split('-')[0]}-T{t}-accum{g}-{r}" for a, t, g, r in TRAIN_CASES])
def test_captured_train_equals_eager(arch, t, accum, remat):
    cfg, run = _run(arch, t, remat, grad_accum=accum)
    got = _train(cfg, run, eager=False)
    want = _train(cfg, run, eager=True)
    _same_training(got, want)
    (prog,) = got[3].step_fn.__wrapped__.programs.values()
    assert prog.replays == STEPS and prog.site == "train_step"
    # the step count lives in the held tensor, written in place
    assert int(got[1].step) == STEPS


# ---------------------------------------------------------------------------
# (b) against JAX's jitted train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_train(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_compiled_steps") / "train.npz"
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


def _jax_batches(vocab):
    rng = np.random.default_rng(42)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (JB, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _flat(tree, prefix):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _tree(flat, prefix):
    """The nested tree saved flat under ``prefix`` (digit keys: lists)."""
    tree = {}
    for key, leaf in flat.items():
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
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


def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import base
    from repro.configs.registry import SMOKE_ARCHS
    from repro.launch.steps import build_cell
    from repro.models import model as JM
    from repro.optim import init_adamw
    mesh = Mesh(np.array(jax.devices()).reshape(JMESH), ("data", "model"))
    cfg = SMOKE_ARCHS["qwen2.5-3b"]
    shape = base.ShapeConfig("t", S, JB, "train")
    run = base.RunConfig(model=cfg, shape=shape,
                         mesh=base.MeshConfig(JMESH, ("data", "model")),
                         remat="none", param_dtype="float32",
                         activation_dtype="float32", xent_chunk=XENT_CHUNK,
                         zero_sharding=True)
    plan = build_cell(cfg, shape, mesh, run)
    p0 = jax.jit(lambda k: JM.init_params(k, cfg, run))(
        jax.random.PRNGKey(3))
    res = _flat(jax.tree_util.tree_map(np.asarray, p0), "params")
    params = jax.device_put(p0, plan.param_shardings)
    opt = jax.jit(lambda p: init_adamw(p),
                  out_shardings=plan.opt_shardings)(params)
    for i, batch in enumerate(_jax_batches(cfg.vocab_size)):
        params, opt, m = plan.step_fn(
            params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        for k, v in m.items():
            res[f"step{i}/{k}"] = np.asarray(v)
    res.update(_flat(jax.tree_util.tree_map(np.asarray, params), "final"))
    np.savez(out_path, **res)


def test_captured_train_matches_jax_train_step(jax_train):
    import torch
    from repro_torch import convert
    from repro_torch.core import meshctx
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim import init_adamw
    cfg, run = _run("qwen2.5-3b", JMESH[1], b=JB, data=JMESH[0],
                    zero_sharding=True)
    params = convert.model_params_from_jax(_tree(jax_train, "params/"),
                                           device="cpu")
    opt = init_adamw(params, torch.float32)
    with meshctx.kept_context():
        plan = build_cell(cfg, run.shape, run,
                          meshctx.StackedMesh(JMESH, device="cpu"))
        for i, batch in enumerate(_jax_batches(cfg.vocab_size)):
            params, opt, m = plan.step_fn(
                params, opt, {k: torch.as_tensor(v)
                              for k, v in batch.items()})
            for k in ("loss", "nll", "accuracy", "grad_norm", "lr"):
                np.testing.assert_allclose(
                    m[k].numpy(), jax_train[f"step{i}/{k}"],
                    rtol=LOSS_RTOL, err_msg=f"step {i} {k}")
    (prog,) = plan.step_fn.__wrapped__.programs.values()
    assert prog.replays == STEPS
    got = _flat(convert.model_params_to_numpy(params), "final")
    finals = sorted(k for k in jax_train if k.startswith("final/"))
    assert finals and finals == sorted(got)
    lr = run.learning_rate
    for k in finals:
        a, b = got[k].astype(np.float64), jax_train[k].astype(np.float64)
        rms = np.sqrt(np.mean((a - b) ** 2))
        assert rms <= max(PARAM_RMS * np.sqrt(np.mean(b ** 2)),
                          1e-3 * lr), k


# ---------------------------------------------------------------------------
# (c) the programs
# ---------------------------------------------------------------------------

def test_same_addresses_replay_one_program_and_a_restore_makes_one_new():
    import torch
    from repro_torch.core import compiled
    from repro_torch.models import model as M
    from repro_torch.optim import init_adamw
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    cfg, run = _run("qwen2.5-3b")
    init = M.init_params(cfg, run, "cpu")
    params, opt, first, plan = _train(
        cfg, run, eager=False, steps=1,
        params=tree_map(lambda p: p.clone(), init))
    progs = plan.step_fn.__wrapped__.programs
    (old,) = progs.values()
    ptrs = compiled.addresses((params, tuple(opt)))
    # a restore in place keeps the addresses: the same program replays,
    # and from the restored state it repeats the first step
    for p, h in zip(tree_leaves(params), tree_leaves(init)):
        p.detach().copy_(h)
    for x in tree_leaves(tuple(opt)):
        x.zero_()
    batch = _batch(cfg, run.shape, run, 0)
    params, opt, again = plan.step_fn(params, opt, batch)
    assert compiled.addresses((params, tuple(opt))) == ptrs
    assert list(progs.values()) == [old] and old.replays == 2
    assert all(torch.equal(again[k], first[0][k]) for k in again)
    # a restore onto new tensors (as TrainLoop's ckpt.restore): one new
    # program, the old one released
    params = tree_map(lambda p: p.detach().clone(), params)
    opt = init_adamw(params)
    params, opt, m = plan.step_fn(params, opt, batch)
    (new,) = progs.values()
    assert new is not old and new.replays == 1
    assert old.graph is None and old._out is None
    with pytest.raises(compiled.CaptureError, match="released"):
        old((), (), batch)
    assert torch.isfinite(m["loss"])


def test_train_loop_with_an_injected_failure_gives_the_eager_trajectory(
        tmp_path):
    from repro_torch.core import compiled
    from repro_torch.launch import train
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "8", "--batch",
            "2", "--seq", "16", "--ckpt-every", "3", "--log-every", "1000",
            "--device", "cpu", "--inject-failure-at"]
    stats = {}
    got = train.main(argv + ["4", "--ckpt-dir", str(tmp_path / "a")],
                     stats=stats)
    with compiled.disable():
        want = train.main(argv + ["4", "--ckpt-dir", str(tmp_path / "b")])
    assert got == want
    assert [s for s, _ in got] == [0, 1, 2, 3, 3, 4, 5, 6, 7]
    # the restart restored onto new tensors: one program is left, keyed by
    # the restored state's addresses
    progs = stats["plan"].step_fn.__wrapped__.programs
    (key,) = progs
    params, opt = stats["state"]
    assert key[1] == compiled.addresses((params, tuple(opt)))
    # before the first checkpoint the restart begins from the initial state
    early = train.main(argv + ["1", "--ckpt-dir", str(tmp_path / "c")])
    with compiled.disable():
        clean = train.main(argv[:-1] + ["--ckpt-dir", str(tmp_path / "d")])
    assert early[1:] == clean and early[0] == clean[0]


class _NoHostRead:
    """A ``TorchFunctionMode`` that raises on any read of a tensor's value
    into Python while a program runs its step (``compiled.capturing()``,
    true in the CPU stand-in as during a capture on the card): there, such
    a value (a learning rate taken as a float from the step count) would
    be frozen into the graph, and every replay would reuse it."""
    READS = {"item", "tolist", "numpy", "__float__", "__int__", "__bool__",
             "__index__"}

    def __new__(cls):
        from torch.overrides import TorchFunctionMode
        from repro_torch.core import compiled

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                name = getattr(func, "__name__", "")
                if compiled.capturing() and name in cls.READS:
                    raise AssertionError(f"{name}: a host read inside the "
                                         f"captured step")
                return func(*args, **(kwargs or {}))
        return Mode()


def test_replayed_steps_lr_follows_the_schedule():
    import torch
    from repro_torch.launch.steps import adamw_config
    from repro_torch.optim import schedule
    cfg, run = _run("qwen2.5-3b", learning_rate=1e-2)
    acfg = adamw_config(run)
    with _NoHostRead():
        _, opt, metrics, plan = _train(cfg, run, eager=False, steps=5)
    (prog,) = plan.step_fn.__wrapped__.programs.values()
    assert prog.replays == 5
    for i, m in enumerate(metrics):
        want = schedule(acfg, torch.tensor(i + 1, dtype=torch.int32))
        assert torch.equal(m["lr"], want), (i, m["lr"], want)
    # warm-up: the rate changes every step
    assert len({float(m["lr"]) for m in metrics}) == 5


def test_no_host_read_catches_a_rate_taken_as_a_float(monkeypatch):
    """The check above fails a train step whose learning rate is a Python
    float taken from the step count."""
    from repro_torch.optim import optimizer
    real = optimizer.schedule

    def frozen(cfg, step):
        return real(cfg, step) * 0 + float(real(cfg, step))
    monkeypatch.setattr(optimizer, "schedule", frozen)
    cfg, run = _run("qwen2.5-3b")
    with _NoHostRead(), pytest.raises(AssertionError, match="__float__"):
        _train(cfg, run, eager=False, steps=1)


# ---------------------------------------------------------------------------
# (d) prefill
# ---------------------------------------------------------------------------

PREFILL = [("qwen2.5-3b", 1), ("deepseek-v2-lite-16b", 4),
           ("falcon-mamba-7b", 1), ("jamba-v0.1-52b", 4),
           ("qwen2-vl-2b", 1), ("seamless-m4t-large-v2", 1)]


@pytest.mark.parametrize("arch,t", PREFILL, ids=[a for a, _ in PREFILL])
def test_captured_prefill_equals_eager(arch, t):
    import torch
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.core import collect_transposes, compiled
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    cfg = get_smoke_arch(arch)
    shape = ShapeConfig("p", S, B, "prefill")
    run = RunConfig(model=cfg, shape=shape,
                    mesh=MeshConfig((1, t), ("data", "model")),
                    remat="none", param_dtype="float32",
                    activation_dtype="float32")
    params = M.init_params(cfg, run, "cpu")
    plan = build_cell(cfg, shape, run)
    batches = [_batch(cfg, shape, run, seed) for seed in range(3)]
    got, moves = [], []
    for batch in batches:
        with collect_transposes() as mv:
            got.append(plan.step_fn(params, batch))
        moves.append(list(mv))
    with compiled.disable():
        want, want_moves = [], []
        for batch in batches:
            with collect_transposes() as mv:
                want.append(plan.step_fn(params, batch))
            want_moves.append(list(mv))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert moves == want_moves
    if cfg.ffn_kind != "dense":
        assert moves[0], "the MoE prefill reported no transpose"
    assert len({a.data_ptr() for a in got}) == len(got)
    (prog,) = plan.step_fn.__wrapped__.programs.values()
    assert prog.replays == 3 and prog.site == "prefill_step"


def test_a_new_prefill_shape_releases_the_old_program():
    """One prefill program a cell: a batch of another shape captures anew
    and releases the program before it with its pool; ``plan.release()``
    drops the last."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import compiled
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    cfg, run = _run("qwen2.5-3b")
    shape = ShapeConfig("p", S, B, "prefill")
    params = M.init_params(cfg, run, "cpu")
    plan = build_cell(cfg, shape, run)
    progs = plan.step_fn.__wrapped__.programs
    short = _batch(cfg, ShapeConfig("p", S // 2, B, "prefill"), run, 1)
    got = [plan.step_fn(params, _batch(cfg, shape, run, 0)),
           plan.step_fn(params, short)]
    (prog,) = progs.values()
    assert prog.replays == 1
    plan.step_fn(params, _batch(cfg, shape, run, 0))
    (again,) = progs.values()
    assert again is not prog and prog.graph is None and prog._in is None
    with pytest.raises(compiled.CaptureError, match="released"):
        prog((), params, short)
    with compiled.disable():
        want = plan.step_fn(params, short)
    assert torch.equal(got[1], want)
    plan.release()
    assert not progs


# ---------------------------------------------------------------------------
# (e) the paged decode's callbacks
# ---------------------------------------------------------------------------

def test_captured_paged_callbacks_equal_eager(monkeypatch):
    import torch
    from repro_torch.core import compiled
    from repro_torch.launch import paged_decode as pd
    shapes = set()
    real = pd.att.paged_decode_attention

    def seen(params, x, *a, **kw):
        shapes.add(tuple(x.shape))
        return real(params, x, *a, **kw)
    monkeypatch.setattr(pd.att, "paged_decode_attention", seen)
    kw = dict(n_requests=12, device="cpu", record=True, seed=3)
    got = pd.run_decode(**kw)
    assert got["programs"]["count"] == len(shapes) > 1
    with compiled.disable():
        want = pd.run_decode(**kw)
    assert want["programs"]["count"] == 0
    assert got["tokens"] == want["tokens"] and got["kv_writes"] == \
        want["kv_writes"]
    assert len(got["ys"]) == len(want["ys"]) > 0
    for a, b in zip(got["ys"], want["ys"]):
        assert np.array_equal(a, b)
    for k in ("k", "v"):
        assert torch.equal(got["pool"][k], want["pool"][k])
    assert all(np.array_equal(got["dump"][k], want["dump"][k])
               for k in want["dump"])
    assert got["audit"]["leaked"] == 0 and got["audit"]["consistent"]


# ---------------------------------------------------------------------------
# (f) disable, (g) donate_states
# ---------------------------------------------------------------------------

def test_disable_caches_nothing_at_the_new_sites():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import compiled
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    cfg, run = _run("qwen2.5-3b")
    compiled.reset_captures()
    _, _, _, plan = _train(cfg, run, eager=True, steps=2)
    assert not plan.step_fn.__wrapped__.programs
    shape = ShapeConfig("p", S, B, "prefill")
    pplan = build_cell(cfg, shape, run)
    with compiled.disable():
        pplan.step_fn(M.init_params(cfg, run, "cpu"),
                      _batch(cfg, shape, run, 0))
    assert not pplan.step_fn.__wrapped__.programs
    assert not compiled.captures()


def test_trust_session_takes_jax_donate_states():
    """``TrustSession(donate_states=True)`` (JAX's streaming sessions,
    ``benchmarks/loadgen.py`` and ``recovery.py``), ``False`` and the
    default all run a round in place: ``trust.state()`` is the live state
    either way (the port's rounds always write it in place)."""
    import torch
    import repro_torch.core as pkg
    for donate in (None, False, True):
        sess = pkg.TrustSession() if donate is None \
            else pkg.TrustSession(donate_states=donate)
        st = pkg.DelegatedKVStore(pkg.StackedMesh((1, 4), device="cpu"), 64,
                                  2, capacity=16, session=sess)
        live = st.trust.state()
        st.put(torch.arange(8, dtype=torch.int32),
               torch.ones(8, 2, dtype=torch.float32))
        assert st.trust.state() is live
        assert float(st.dump()[:8].sum()) == 16.0


if __name__ == "__main__":
    _jax_main(sys.argv[1])
