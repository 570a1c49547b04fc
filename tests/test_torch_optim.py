"""The port's optimizers and token pipeline against the JAX package's,
on the CPU:

  * ``schedule``, ``clip_by_global_norm`` and ``adamw_update`` (each step
    from the same state, clipping engaged and not, through warmup, the
    cosine and its floor) within 2 f32 ulps of JAX — elementwise f32 math
    in the same order.  Two inputs are each library's own, and the test
    carries their one-ulp differences through instead of hiding them:
    the cosine (XLA's and torch's f32 ``cos`` differ by one ulp on ~5% of
    arguments; near the end of the decay ``1 + cos`` cancels, and one ulp
    of the cosine is up to 8 ulps of the rate), and the global norm's
    sum of squares (summed in another order: one ulp of the norm, hence
    of the clip scale, which ``b1 * m + (1 - b1) * g`` can cancel into
    many ulps of a small moment).  So ``schedule`` is held to 2 ulps plus
    one ulp of its cosine carried through the formula; the update is
    held to 2 ulps unclipped and, clipped, on gradients whose sum of
    squares is exact in f32 (dyadic values: the same norm in any order);
    ``clip_by_global_norm`` holds the norm and the clipped gradients of
    general f32 values to 2 ulps;
  * ``int8_quantize`` bit for bit;
  * ``GradChannelCombiner`` against JAX's on 8 virtual devices (one
    subprocess: this module run as a script), the battery's harness with
    each client's error carry kept per client: every step, from JAX's
    inputs of that step (table, moments, carries and each client's
    owner-major gradient), the port's p, m and v within 1e-6 of JAX's
    (relative to each tensor's largest magnitude: the owners' sums over
    clients run in another order) and the carries within 2 ulps of the
    carried target's magnitude; then the battery's own 60-step
    run on the port (``err_final < 0.05``) and ``combine_op_spec``
    refusing a dtype or row-shape drift;
  * ``TokenPipeline``'s batches == JAX's, bit for bit, for the synthetic
    stream and a memmap token file (written by the test), and for the
    embeddings batch.
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

ULPS = 2
COMBINER_RTOL = 1e-6
STEPS = 60


def _tree(rng):
    return {"b": {"w": rng.normal(size=(6, 5)).astype(np.float32),
                  "s": rng.normal(size=(5,)).astype(np.float32)},
            "a": [rng.normal(size=(3, 4)).astype(np.float32),
                  rng.normal(size=(7,)).astype(np.float32)]}


def _jax(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    from repro_torch.optim.optimizer import tree_map
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _leaves(tree):
    import jax
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _ulps(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_max_ulp(
            np.asarray(g, np.float32), np.asarray(w, np.float32), ULPS)


def test_schedule_within_two_ulps():
    import jax.numpy as jnp
    from repro.optim import AdamWConfig as JC, schedule as jsched
    from repro_torch.optim import AdamWConfig as TC, schedule as tsched
    for kw in (dict(warmup_steps=3, total_steps=10),
               dict(learning_rate=1e-3, warmup_steps=20, total_steps=200,
                    min_lr_ratio=0.05)):
        c = TC(**kw)
        for s in range(0, 220):
            want = np.float32(jsched(JC(**kw), jnp.int32(s)))
            got = tsched(c, torch.tensor(s, dtype=torch.int32)).numpy()
            prog = min(max((s - c.warmup_steps) / max(
                1, c.total_steps - c.warmup_steps), 0.0), 1.0)
            cos_ulp = np.spacing(np.float32(abs(np.cos(np.pi * prog))))
            carried = c.learning_rate * min(1.0, s / c.warmup_steps) \
                * (1 - c.min_lr_ratio) * 0.5 * cos_ulp
            assert abs(float(got) - float(want)) <= \
                ULPS * np.spacing(want) + carried, (kw, s, got, want)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_within_two_ulps(max_norm):
    from repro.optim import clip_by_global_norm as jclip
    from repro_torch.optim import clip_by_global_norm as tclip
    from repro_torch.optim.optimizer import tree_leaves
    g = _tree(np.random.default_rng(1))
    jg, jn = jclip(_jax(g), max_norm)
    tg, tn = tclip(_torch(g), max_norm)
    _ulps([tn.numpy()] + [x.numpy() for x in tree_leaves(tg)],
          [jn] + _leaves(jg))


def _dyadic(rng, tree, scale):
    """``tree``'s shapes filled with multiples of 1/8 in [-2, 2] times a
    power of two: every square and every partial sum of squares is exact
    in f32, so the global norm is the same in any summation order."""
    from repro_torch.optim.optimizer import tree_map
    return tree_map(lambda a: (rng.integers(-16, 17, a.shape) / 8
                               * scale).astype(np.float32), tree)


@pytest.mark.parametrize("grads", ["unclipped", "clipped_exact_norm"])
def test_adamw_update_within_two_ulps(grads):
    """Five steps with warmup 2 of 4 steps (warmup, cosine, floor), each
    from JAX's state of the step before; the update is in place in the
    port and returns the same tensors."""
    from repro.optim import (AdamWConfig as JC, adamw_update as jupd,
                             init_adamw as jinit)
    from repro_torch.optim import (AdamWConfig as TC, AdamWState,
                                   adamw_update as tupd)
    from repro_torch.optim.optimizer import tree_leaves
    rng = np.random.default_rng(2)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=4)
    params = _jax(_tree(rng))
    state = jinit(params)
    for _ in range(5):
        g = _tree(rng)
        g = _dyadic(rng, g, 8.0) if grads == "clipped_exact_norm" \
            else _mul(g, 0.1)
        tp = _torch(params)
        ts = AdamWState(torch.tensor(np.asarray(state.step)),
                        _torch(state.m), _torch(state.v))
        tp_out, ts_out, tm = tupd(TC(**kw), ts, tp, _torch(g))
        params, state, jm = jupd(JC(**kw), state, params, _jax(g))
        assert tree_leaves(tp_out)[0] is tree_leaves(tp)[0]
        assert float(jm["grad_norm"]) > 1.0 or grads == "unclipped"
        _ulps([tm["grad_norm"].numpy(), tm["lr"].numpy()],
              [jm["grad_norm"], jm["lr"]])
        for got, want in ((tp_out, params), (ts_out.m, state.m),
                          (ts_out.v, state.v)):
            _ulps([x.numpy() for x in tree_leaves(got)], _leaves(want))
        assert int(ts_out.step) == int(state.step)


def _mul(tree, k):
    from repro_torch.optim.optimizer import tree_map
    return tree_map(lambda a: (a * k).astype(np.float32), tree)


def test_adamw_blocks_give_the_same_update(monkeypatch):
    """A leaf updated in blocks of its leading dimension (as a stacked
    layer leaf of qwen2.5-3b is) gets the same values as in one pass."""
    from repro_torch.optim import AdamWConfig, adamw_update, init_adamw
    from repro_torch.optim import optimizer
    from repro_torch.optim.optimizer import tree_leaves
    rng = np.random.default_rng(6)
    outs = []
    for block in (optimizer.BLOCK_ELEMS, 7):
        monkeypatch.setattr(optimizer, "BLOCK_ELEMS", block)
        params = _torch(_tree(np.random.default_rng(5)))
        state = init_adamw(params)
        for _ in range(3):
            grads = _torch(_mul(_tree(rng), 3.0))
            params, state, _ = adamw_update(AdamWConfig(), state, params,
                                            grads)
        outs.append(tree_leaves(params) + tree_leaves(state.m)
                    + tree_leaves(state.v))
        rng = np.random.default_rng(6)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_descent_check_holds_on_any_draw(seed):
    """``testing.train.descent_check`` (chip_smoke's phase-10 gate) on the
    qwen2.5-3b SMOKE config in f32 from three weight seeds: a step sized
    for a first-order change of -DESCENT_DROP lowers the loss by that
    change within DESCENT_RTOL; the same step turned round (a negative
    drop) raises it and fails the check; ``first_adamw_step`` with
    ``restore`` puts the weights back."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import model as TM
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.testing.train import (DESCENT_DROP, descent_check,
                                           first_adamw_step)
    cfg = get_smoke_arch("qwen2.5-3b")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 2, "train"),
                    mesh=MeshConfig((1, 1), ("data", "model")),
                    param_dtype="float32", activation_dtype="float32",
                    remat="none", seed=seed)
    batch = {k: torch.as_tensor(v) for k, v in TokenPipeline(
        DataConfig(vocab_size=cfg.vocab_size), cfg, run.shape)
        .batch_at(seed).items()}
    params = TM.init_params(cfg, run, device="cpu")
    before = [p.detach().clone() for p in tree_leaves(params)]
    _, _, grads = value_and_grad(params, batch, cfg, run)
    r = first_adamw_step(params, grads, batch, cfg, run, 1e-3, restore=True)
    assert np.isfinite(r["loss"]) and r["first_order"] < 0
    for p, b in zip(tree_leaves(params), before):
        assert torch.equal(p, b)
    up = descent_check(params, batch, cfg, run, drop=-DESCENT_DROP)
    assert up["change"] > 0 and not up["ok"]
    for p, b in zip(tree_leaves(params), before):
        p.detach().copy_(b)
    down = descent_check(params, batch, cfg, run)
    assert down["ok"] and down["change"] < 0
    assert abs(down["first_order"] + DESCENT_DROP) < 0.01 * DESCENT_DROP


def test_int8_quantize_bit_for_bit():
    import jax.numpy as jnp
    from repro.optim import int8_dequantize as jdq, int8_quantize as jq
    from repro_torch.optim import int8_dequantize as tdq, int8_quantize as tq
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(64, 96)) * rng.uniform(1e-3, 30, (64, 1))
         ).astype(np.float32)
    x[3] = 0.0                                 # the 1e-12 scale floor
    x[5, ::7] = 127.5 * x[5].max() / 127       # halves: round to even
    q, s = jq(jnp.asarray(x))
    tq_, ts = tq(torch.as_tensor(x))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    np.testing.assert_array_equal(tdq(tq_, ts).numpy(),
                                  np.asarray(jdq(q, s)))


# ---------------------------------------------------------------------------
# GradChannelCombiner against JAX on 8 virtual devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_combiner(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_optim") / "combiner.npz"
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


def _jax_main(out_path):
    """The battery's ``grad_channel_combiner_int8`` harness, each client's
    error carry kept as its own shard (``P("data")``), every step's
    inputs and outputs recorded."""
    import jax
    import jax.flatten_util  # noqa: F401 (the combiner's ravel_pytree)
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.optim import AdamWConfig
    from repro.optim.delegated import GradChannelCombiner
    from repro_torch.testing.train import COMBINER as C
    mesh = Mesh(np.array(jax.devices()).reshape(8, 1), ("data", "model"))
    rng = np.random.default_rng(0)
    target = jnp.asarray(rng.normal(size=(C["d"], C["k"])), jnp.float32)
    comb = GradChannelCombiner(mesh, AdamWConfig(learning_rate=C["lr"],
                                                 weight_decay=0.0),
                               axis="data", chunk=C["chunk"])
    opt, _ = comb.init({"w": jnp.zeros((C["d"], C["k"]), jnp.float32)})
    upd = comb.step_fn()
    xs = jnp.asarray(rng.normal(size=(8, C["n"], C["d"])), jnp.float32)
    rows, t, chunk = comb._rows, comb._t, comb.chunk
    err = jnp.zeros((t * rows, chunk), jnp.float32)
    n = C["d"] * C["k"]

    def local(opt_shard, err_l, x_l):
        tbl = jax.lax.all_gather(opt_shard["p"], "data", tiled=True)
        w = tbl.reshape(t, rows // t, chunk).swapaxes(0, 1).reshape(-1)[
            :n].reshape(C["d"], C["k"])
        x = x_l[0]
        res = x @ w - x @ target
        g = jnp.einsum("nd,nk->dk", x, res) / x.shape[0]
        flat = jnp.zeros((rows * chunk,)).at[:n].set(g.reshape(-1))
        flat = flat.reshape(rows // t, t, chunk).swapaxes(0, 1).reshape(-1)
        new_opt, new_err = upd(opt_shard, err_l, flat)
        return new_opt, new_err, flat[None]

    spec = {"p": P("data", None), "m": P("data", None),
            "v": P("data", None), "step": P()}
    step = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec, P("data", None),
                                    P("data", None, None)),
        out_specs=(spec, P("data", None), P("data", None)),
        check_rep=False))
    res = {}
    for i in range(STEPS):
        for k in ("p", "m", "v", "step"):
            res[f"{i}/in/{k}"] = np.asarray(opt[k])
        res[f"{i}/in/err"] = np.asarray(err)
        opt, err, grads = step(opt, err, xs)
        res[f"{i}/grads"] = np.asarray(grads)
        for k in ("p", "m", "v", "step"):
            res[f"{i}/out/{k}"] = np.asarray(opt[k])
        res[f"{i}/out/err"] = np.asarray(err)
    np.savez(out_path, **res)


def _combiner():
    from repro_torch.optim import AdamWConfig, GradChannelCombiner
    from repro_torch.testing.train import COMBINER as C
    comb = GradChannelCombiner(C["shards"], AdamWConfig(
        learning_rate=C["lr"], weight_decay=0.0), chunk=C["chunk"])
    comb.init({"w": torch.zeros((C["d"], C["k"]))}, device="cpu")
    return comb


def test_combiner_steps_match_jax(jax_combiner):
    comb = _combiner()
    update = comb.step_fn()
    t, rows, chunk = comb._t, comb._rows, comb.chunk
    blocks = lambda a: torch.as_tensor(a).reshape(t, rows // t, chunk)
    for i in range(STEPS):
        z = lambda k: jax_combiner[f"{i}/{k}"]
        opt = {k: blocks(z(f"in/{k}")) for k in ("p", "m", "v")}
        opt["step"] = torch.as_tensor(z("in/step"))
        out, err = update(opt, torch.as_tensor(z("in/err")).reshape(
            t, rows, chunk), torch.as_tensor(z("grads")))
        for k in ("p", "m", "v"):
            want = z(f"out/{k}").reshape(t, rows // t, chunk)
            np.testing.assert_allclose(
                out[k].numpy(), want, rtol=0,
                atol=COMBINER_RTOL * np.abs(want).max(), err_msg=f"{i} {k}")
        # the carry is target - q * scale, target = gradient + carry:
        # held to 2 ulps of the target's magnitude (XLA may fuse the
        # product into the difference, one rounding fewer)
        want = z("out/err").reshape(t, rows, chunk)
        target = z("grads").reshape(t, rows, chunk) + z("in/err").reshape(
            t, rows, chunk)
        np.testing.assert_allclose(
            err.numpy(), want, rtol=0,
            atol=2 * np.spacing(np.abs(target).max()), err_msg=f"{i} err")
        assert int(out["step"]) == int(z("out/step")) == i + 1


def test_combiner_battery_converges_and_params_of_unpermutes():
    from repro_torch.testing.train import combiner_battery
    r = combiner_battery("cpu")
    assert r["err_final"] < 0.05, r["err_final"]
    comb = _combiner()
    flat = torch.arange(comb._rows * comb.chunk, dtype=torch.float32)
    opt = {"p": comb.owner_major(flat)}
    w = comb.params_of(opt)["w"]
    np.testing.assert_array_equal(w.reshape(-1).numpy(),
                                  np.arange(w.numel(), dtype=np.float32))
    # row r of the flat table is owner r % T's, at r // T
    assert opt["p"][3, 2, 0] == (2 * comb._t + 3) * comb.chunk


def test_combine_op_spec_refuses_drift():
    from repro_torch.core.opspec import SchemaError
    from repro_torch.optim import combine_op_spec
    comb = _combiner()
    update = comb.step_fn()
    spec = combine_op_spec(comb.chunk)
    q, scale = spec.payload
    assert (q.row_shape, q.dtype) == ((comb.chunk,), torch.int8)
    with pytest.raises(SchemaError, match="expects dtype"):
        q.bind(torch.zeros((2, comb.chunk)), spec.name)
    with pytest.raises(SchemaError, match="row shape"):
        q.bind(torch.zeros((2, comb.chunk + 1), dtype=torch.int8), spec.name)
    with pytest.raises(SchemaError, match="row shape"):
        scale.bind(torch.zeros((2, 2)), spec.name)
    opt, err = comb.init({"w": torch.zeros((64, 32))}, device="cpu")
    with pytest.raises(ValueError, match="owner-major"):
        update(opt, err, torch.zeros((comb._t, comb._rows * comb.chunk + 1)))


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["synthetic", "memmap"])
def test_token_pipeline_matches_jax(tmp_path, kind):
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.registry import SMOKE_ARCHS
    from repro.data import DataConfig as JData, TokenPipeline as JPipe
    from repro_torch.configs.base import ShapeConfig as TShape
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.data import DataConfig as TData, TokenPipeline as TPipe
    path = None
    if kind == "memmap":            # a token file of its own, no corpus
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(4).integers(0, 500, 10_000).astype(
            np.int32).tofile(path)
    for seed, arch in ((0, "qwen2.5-3b"), (7, "falcon-mamba-7b")):
        jp = JPipe(JData(seed=seed, kind=kind, path=path, vocab_size=400),
                   SMOKE_ARCHS[arch], JShape("t", 33, 5, "train"))
        tp = TPipe(TData(seed=seed, kind=kind, path=path, vocab_size=400),
                   get_smoke_arch(arch), TShape("t", 33, 5, "train"))
        for step in (0, 1, 17, 123456):
            want, got = jp.model_batch_at(step), tp.model_batch_at(step)
            assert sorted(want) == sorted(got) == ["labels", "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            want = jp.embeds_batch_at(step, 16)
            got = tp.embeds_batch_at(step, 16)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


if __name__ == "__main__":
    _jax_main(sys.argv[1])
