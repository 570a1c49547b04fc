"""The port's training path against the JAX package's, on the CPU in f32,
at SMOKE width (qwen2.5-3b, falcon-mamba-7b at T = 1 trustee;
deepseek-v2-lite-16b on a 1x4 mesh: its MoE over 4 stacked trustees and
the cross-entropy over 4 vocab shards), on weights carried across by
``convert`` (norm scales and qwen's QKV biases drawn with numpy):

  * ``forward_loss``'s loss and metrics, and every gradient leaf, against
    ``jax.value_and_grad`` of JAX's ``forward_loss`` on unsharded
    parameters, with the port's remat "none", "dots" and "full" (JAX's
    "none"), the cross-entropy in chunks of 8 of S = 16;
  * ``delegated_softmax_xent`` at T = 1 and 4 (nll, accuracy and the
    gradients of x and w_out) with a mask, a softcap, a chunk that does
    not divide S, labels on the shard edges, and logits exact in f32 so
    that ties are frequent and JAX's tie rule decides the accuracy;
  * the plain blockwise attention, rematerialised per KV block, against
    JAX's under autograd; nested remat over jamba's 8-layer group;
  * ``grad_accum=2`` against 1 on the same batch; the MoE without the
    kernels gives every expert that received a row a non-zero gradient
    (and no other); every kernel wrapper refuses an input that requires
    grad; the trainer's loss falls (``test_system``'s 60-step check) and
    a run resumed after an injected failure ends on the clean run's loss;
    the training fields of ``RunConfig`` are JAX's.

The JAX side runs on 8 virtual devices in one subprocess (this module
run as a script).

Tolerances: loss and metrics rtol 1e-5; each gradient leaf 1e-4 in
relative RMS (the same f32 math summed in another order by another
library; the largest measured is ~2e-6).  falcon-mamba-7b is held to
1e-4 as well, for its own reason: JAX's plain scan is the associative
form (a log-depth tree of products and sums) and the port's the
sequential recurrence, so their f32 roundings differ (~1e-6 measured).
The cross-entropy: nll rtol 1e-5, accuracy exact (the logits are exact),
gradients 1e-5 in relative RMS.
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

B, S, XENT_CHUNK = 2, 16, 8
MODELS = {"qwen": ("qwen2.5-3b", 1), "falcon": ("falcon-mamba-7b", 1),
          "deepseek": ("deepseek-v2-lite-16b", 4)}
LOSS_RTOL, GRAD_RMS = 1e-5, 1e-4
# (name, vocab shards, chunk, mask, softcap) over S = 24
XENT_CASES = [("t1", 1, 8, False, 0.0), ("t4", 4, 8, True, 0.0),
              ("t4_softcap_ragged", 4, 5, True, 2.0),
              ("t1_softcap_whole", 1, 64, True, 2.0)]
XS, XD, XV = 24, 32, 512


def _jax_params(arch):
    """JAX SMOKE weights (f32) as numpy, every norm scale (and qwen's QKV
    biases) drawn from a numpy seed (made in the subprocess, which saves
    them for the port's side: ``_params``)."""
    import jax
    from repro.configs.registry import SMOKE_ARCHS
    from repro.models import model as JM
    cfg = SMOKE_ARCHS[arch]
    run = _jax_run(cfg, 1)
    p = jax.tree_util.tree_map(np.array, jax.jit(
        lambda k: JM.init_params(k, cfg, run))(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(5)

    def draw(tree):
        if isinstance(tree, list):
            return [draw(v) for v in tree]
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


def _jax_run(cfg, t):
    from repro.configs.base import MeshConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                     mesh=MeshConfig((1, t), ("data", "model")),
                     remat="none", param_dtype="float32",
                     activation_dtype="float32", xent_chunk=XENT_CHUNK)


def _port_run(arch, t, remat="none", **kw):
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    cfg = get_smoke_arch(arch)
    return cfg, RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                          mesh=MeshConfig((1, t), ("data", "model")),
                          remat=remat, param_dtype="float32",
                          activation_dtype="float32",
                          xent_chunk=XENT_CHUNK, **kw)


def _batch(vocab):
    rng = np.random.default_rng(9)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _xent_inputs(name):
    """x (B, 24, 32) and w_out (512, 32) in multiples of 1/4 and 1/8
    (every logit and partial sum exact in f32, so ties are frequent and
    the same in both packages), labels covering the shard edges of T = 4
    (127 | 128, 255 | 256, 383 | 384), a mask."""
    rng = np.random.default_rng([ord(ch) for ch in name])
    x = rng.integers(-2, 3, (B, XS, XD)).astype(np.float32) / 4
    w = rng.integers(-2, 3, (XV, XD)).astype(np.float32) / 8
    labels = rng.integers(0, XV, (B, XS)).astype(np.int32)
    edges = [0, 127, 128, 255, 256, 383, 384, 511]
    labels[0, :len(edges)] = edges
    labels[1, -len(edges):] = edges[::-1]
    mask = rng.random((B, XS)) < 0.7
    return x, w, labels, mask


BLOCK_K = 8


def _blockwise_inputs():
    """q (1, 4, 32, 16), k / v (1, 2, 32, 16) f32 and a random cotangent
    for the output."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(1, 4, 32, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 32, 16)).astype(np.float32)
            for _ in range(2))
    return q, k, v, rng.normal(size=q.shape).astype(np.float32)


def _flat_paths(tree, prefix=""):
    """{"a/b/0/c": leaf} of a tree of dicts and lists."""
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


def _params(jax_runs, name):
    """The JAX weights of model ``name`` the subprocess saved, as the
    nested tree (digit keys are list indices: the dense prefix)."""
    tree = {}
    head = f"{name}/params/"
    for key, leaf in jax_runs.items():
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


def _port_params(p):
    from repro_torch import convert
    return convert.model_params_from_jax(p, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side on one intra-op thread: SMOKE-sized ops gain
    nothing from more, and beside the other test workers on the same
    cores the extra threads spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the JAX side, 8 virtual devices, one subprocess
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_train") / "runs.npz"
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
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import meshctx
    from repro.models import model as JM
    from repro.models.layers import delegated_softmax_xent
    res = {}
    for name, (arch, t) in MODELS.items():
        mesh = Mesh(np.array(jax.devices()[:t]).reshape(1, t),
                    ("data", "model"))
        meshctx.set_context(mesh, ("data",))
        cfg, p = _jax_params(arch)
        for path, leaf in _flat_paths(p).items():
            res[f"{name}/params/{path}"] = leaf
        run = _jax_run(cfg, t)
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()}
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda pp: JM.forward_loss(pp, batch, cfg, run), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, p))
        res[f"{name}/loss"] = np.asarray(loss)
        for k, v in metrics.items():
            res[f"{name}/metric/{k}"] = np.asarray(v)
        for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
            res[f"{name}/grad/{i}"] = np.asarray(g)
    from repro.configs.registry import SMOKE_ARCHS
    for name, t, chunk, masked, softcap in XENT_CASES:
        mesh = Mesh(np.array(jax.devices()[:t]).reshape(1, t),
                    ("data", "model"))
        meshctx.set_context(mesh, ("data",))
        cfg = SMOKE_ARCHS["qwen2.5-3b"].with_overrides(logit_softcap=softcap)
        x, w, labels, mask = _xent_inputs(name)
        m = jnp.asarray(mask) if masked else None

        def f(xx, ww):
            nll, acc = delegated_softmax_xent(xx, ww, jnp.asarray(labels),
                                              cfg, m, chunk=chunk)
            return nll, acc
        (nll, acc), (dx, dw) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
        for k, v in (("nll", nll), ("acc", acc), ("dx", dx), ("dw", dw)):
            res[f"xent/{name}/{k}"] = np.asarray(v)
    from repro.models.attention import blockwise_attention
    q, k, v, r = _blockwise_inputs()
    out, grads = jax.jit(jax.value_and_grad(
        lambda q_, k_, v_: jnp.sum(blockwise_attention(
            q_, k_, v_, block_k=BLOCK_K) * r), argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    res["blockwise/out"] = np.asarray(out)
    for name, g in zip("qkv", grads):
        res[f"blockwise/d{name}"] = np.asarray(g)
    np.savez(out_path, **res)


# ---------------------------------------------------------------------------
# forward_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_loss_and_grads_match_jax(jax_runs, name, remat):
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.testing.train import worst_leaf
    arch, t = MODELS[name]
    p = _params(jax_runs, name)
    cfg, run = _port_run(arch, t, remat)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size).items()}
    loss, metrics, grads = value_and_grad(_port_params(p), batch, cfg, run)
    np.testing.assert_allclose(float(loss), jax_runs[f"{name}/loss"],
                               rtol=LOSS_RTOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), jax_runs[f"{name}/metric/{k}"],
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    want = [jax_runs[f"{name}/grad/{i}"] for i in
            range(sum(k.startswith(f"{name}/grad/") for k in jax_runs))]
    worst, i = worst_leaf(grads, want)
    assert worst < GRAD_RMS, (name, remat, i, worst)


@pytest.mark.parametrize("case", XENT_CASES, ids=[c[0] for c in XENT_CASES])
def test_delegated_xent_matches_jax(jax_runs, case):
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.models.layers import delegated_softmax_xent
    from repro_torch.testing.train import rel_rms
    name, t, chunk, masked, softcap = case
    cfg = get_smoke_arch("qwen2.5-3b").with_overrides(logit_softcap=softcap)
    x, w, labels, mask = _xent_inputs(name)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    nll, acc = delegated_softmax_xent(
        xt, wt, torch.as_tensor(labels), cfg,
        torch.as_tensor(mask) if masked else None, chunk=chunk, n_shards=t)
    nll.backward()
    want = lambda k: jax_runs[f"xent/{name}/{k}"]
    np.testing.assert_allclose(nll.item(), want("nll"), rtol=1e-5)
    assert float(acc) == float(want("acc"))
    assert rel_rms(xt.grad.numpy(), want("dx")) < 1e-5
    assert rel_rms(wt.grad.numpy(), want("dw")) < 1e-5


def test_xent_tie_rule_picks_the_highest_tied_shard():
    """One position whose top logit is tied in shards 0 (twice: rows 3
    and 7) and 2 (row 300): the accuracy counts row 300, JAX's rule (the
    first argmax inside a shard, the highest index among tied shards)."""
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.models.layers import delegated_softmax_xent
    cfg = get_smoke_arch("qwen2.5-3b")
    w = torch.zeros((XV, 4))
    w[[3, 7, 300], 0] = 1.0
    x = torch.zeros((1, 1, 4))
    x[..., 0] = 1.0
    for label, hit in ((300, 1.0), (3, 0.0), (7, 0.0)):
        _, acc = delegated_softmax_xent(x, w, torch.tensor([[label]]), cfg,
                                        n_shards=4)
        assert float(acc) == hit, label
    _, acc = delegated_softmax_xent(x, w, torch.tensor([[3]]), cfg)
    assert float(acc) == 1.0        # one shard: its first argmax


def test_blockwise_attention_rematerialised_per_block_matches_jax(
        jax_runs):
    """The plain long-sequence attention under autograd: four KV blocks
    of 8, each rematerialised in the backward, against JAX's
    ``blockwise_attention`` (its scan step under ``jax.checkpoint``):
    the loss rtol 1e-5, the gradients of q, k and v 1e-5 in relative
    RMS."""
    from repro_torch.models.attention import blockwise_attention
    from repro_torch.testing.train import rel_rms
    q, k, v, r = (torch.tensor(a, requires_grad=i < 3)
                  for i, a in enumerate(_blockwise_inputs()))
    out = torch.sum(blockwise_attention(q, k, v, block_k=BLOCK_K) * r)
    out.backward()
    np.testing.assert_allclose(out.item(), jax_runs["blockwise/out"],
                               rtol=1e-5)
    for name, t in zip("qkv", (q, k, v)):
        assert rel_rms(t.grad.numpy(), jax_runs[f"blockwise/d{name}"]) \
            < 1e-5, name


def test_nested_remat_over_a_hybrid_group():
    """jamba's SMOKE pattern (one 8-layer group of Mamba and attention
    layers, dense and MoE FFNs): remat "full" also checkpoints each layer
    inside the group, so a layer runs three times (the forward, the
    group's recompute, its own recompute) where "none" runs it once; the
    gradients of "none", "dots" and "full" agree."""
    from repro_torch.configs import base as tbase
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import model as TM
    from repro_torch.models import transformer
    from repro_torch.testing.train import worst_leaf
    cfg = get_smoke_arch("jamba-v0.1-52b")
    descs, _, n_groups = transformer.layer_descs(cfg)
    assert len(descs) == 8
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size).items()}
    layer = transformer._apply_layer
    calls, grads = {}, {}
    for remat in ("none", "dots", "full"):
        run = tbase.RunConfig(model=cfg, shape=tbase.ShapeConfig(
            "t", S, B, "train"), remat=remat, param_dtype="float32",
            activation_dtype="float32")
        params = TM.init_params(cfg, run, device="cpu")
        n = [0]

        def counted(*a, **k):
            n[0] += 1
            return layer(*a, **k)
        transformer._apply_layer = counted
        try:
            _, _, grads[remat] = value_and_grad(params, batch, cfg, run)
        finally:
            transformer._apply_layer = layer
        calls[remat] = n[0]
    # the group's recompute runs each layer again, and a layer's own
    # checkpoint again in its backward (torch stops a recompute early once
    # it has what the backward needs, so the last layer may skip it)
    per_pass = 8 * n_groups
    assert calls["none"] == per_pass and calls["dots"] == 2 * per_pass, \
        calls
    assert 2 * per_pass < calls["full"] <= 3 * per_pass, calls
    from repro_torch.optim.optimizer import tree_leaves
    for remat in ("dots", "full"):
        worst, i = worst_leaf(grads[remat], [g.numpy() for g in
                                             tree_leaves(grads["none"])])
        assert worst < 1e-6, (remat, i, worst)


def test_grad_accum_two_matches_one(jax_runs):
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as TM
    from repro_torch.optim import init_adamw
    from repro_torch.testing.train import rel_rms
    p = _params(jax_runs, "qwen")
    outs = []
    for accum in (1, 2):
        cfg, run = _port_run("qwen2.5-3b", 1, grad_accum=accum)
        plan = build_cell(cfg, run.shape, run)
        params = _port_params(p)
        batch = {k: torch.as_tensor(v)
                 for k, v in _batch(cfg.vocab_size).items()}
        params, opt, metrics = plan.step_fn(params, init_adamw(params),
                                            batch)
        outs.append((TM.count_params(params), params, metrics))
    from repro_torch.optim.optimizer import tree_leaves
    for a, b in zip(tree_leaves(outs[0][1]), tree_leaves(outs[1][1])):
        assert rel_rms(b.detach().numpy(), a.detach().numpy()) < 1e-6
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(outs[1][2][k]),
                                   float(outs[0][2][k]), rtol=1e-5)


def test_moe_without_kernels_feeds_expert_gradients(jax_runs):
    """deepseek SMOKE at T = 4, ``use_pallas`` False: the dispatch is the
    plain pack, the block transpose, the trustees' plain pack by expert
    and the unpack, all differentiable: every expert that received a row
    has a non-zero gradient in each of w_gate / w_up / w_down, no other
    has one, and the router's gradient is non-zero."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.testing.train import (ExpertRows,
                                           expert_grads_follow_rows)
    p = _params(jax_runs, "deepseek")
    cfg, run = _port_run("deepseek-v2-lite-16b", 4)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size).items()}
    with ExpertRows() as rec:
        _, _, grads = value_and_grad(_port_params(p), batch, cfg, run)
    moe = grads["groups"]["pos0"]["moe"]
    for leaf in ("w_gate", "w_up", "w_down"):
        r = expert_grads_follow_rows(moe[leaf], rec.counts)
        assert r["experts_fed"] > 0, r
        assert r["fed_without_grad"] == 0 and r["grad_without_rows"] == 0, \
            (leaf, r)
    assert float(moe["router"].abs().max()) > 0


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """Each wrapper refuses before it runs (here before its plain version
    on CPU tensors, as it would before a launch on the card); under
    ``torch.no_grad()`` the same call runs.  The wrappers whose inputs
    are all integer words (no tensor of theirs can require grad) share
    the same check."""
    from repro_torch.kernels import ops as kops
    x = torch.randn(2, 4, 8, 16, requires_grad=True)
    e = torch.randn(2, 8, 16, requires_grad=True)
    w = torch.randn(2, 16, 8)
    s = dict(x=torch.randn(1, 4, 8, requires_grad=True),
             dt=torch.rand(1, 4, 8), a=-torch.rand(8, 2), b=torch.randn(1, 4, 2),
             c=torch.randn(1, 4, 2), d=torch.ones(8))
    table = torch.zeros(1, 4, 2, requires_grad=True)
    calls = {
        "flash_attention": lambda: kops.flash_attention(x, x, x),
        "grouped_matmul": lambda: kops.grouped_matmul(e, w),
        "selective_scan": lambda: kops.selective_scan(**s),
        "paged_attention": lambda: kops.paged_attention(
            x[:, :, 0], x.reshape(8, 1, 8, 16), x.reshape(8, 1, 8, 16),
            torch.zeros(2, 1, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32)),
        "gather": lambda: kops.gather(
            table, torch.zeros(1, 3, dtype=torch.int32),
            torch.zeros(1, 3, dtype=torch.int32), 0, torch.zeros(1, 3, 2)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: an input requires "
                                               f"grad"):
            call()
        with torch.no_grad():
            call()
    from repro_torch.kernels import _build
    for name in ("scatter_last", "segmented_add", "pagetable_serve",
                 "delegation_pack"):
        with pytest.raises(RuntimeError, match=name):
            _build.refuse_grad(name, None, table)


def test_train_cell_refuses_the_kernels_and_unported_flags():
    """A train cell refuses the kernels; ``--mesh-data 2`` (once refused)
    trains: a dense model computes each sequence on its own, so its
    losses on the (2, 1) mesh are the (1, 1) mesh's."""
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_cell
    cfg, run = _port_run("qwen2.5-3b", 1, use_pallas=True)
    with pytest.raises(ValueError, match="no kernel has a backward"):
        build_cell(cfg, run.shape, run)
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "2", "--batch",
            "4", "--seq", "16", "--device", "cpu"]
    got = train.main(argv + ["--mesh-data", "2"])
    want = train.main(argv)
    assert [s for s, _ in got] == [0, 1]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=1e-5)


def test_trainer_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "1"])


def test_port_training_fields_match_jax():
    from repro.configs.base import RunConfig as JRun
    from repro_torch.configs.base import RunConfig as TRun
    fields = ("opt_dtype", "grad_accum_dtype", "learning_rate",
              "weight_decay", "grad_clip", "grad_accum", "remat",
              "zero_sharding", "grad_compression", "xent_chunk",
              "unroll_layers", "use_pallas")
    jd = {f.name: f.default for f in dataclasses.fields(JRun)}
    td = {f.name: f.default for f in dataclasses.fields(TRun)}
    assert {k: td[k] for k in fields} == {k: jd[k] for k in fields}


# ---------------------------------------------------------------------------
# the trainer end to end (tests/test_system.py's two train checks)
# ---------------------------------------------------------------------------

def test_train_loss_decreases_e2e():
    from repro_torch.launch.train import main
    hist = main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "60",
                 "--batch", "8", "--seq", "64", "--lr", "5e-3",
                 "--log-every", "1000", "--device", "cpu"])
    first = np.mean([l for _, l in hist[:5]])
    last = np.mean([l for _, l in hist[-5:]])
    assert last < first - 0.5, (first, last)


def test_train_resume_identical_trajectory(tmp_path):
    """A failure injected at step 12 resumes from the step-10 checkpoint
    and ends on the clean run's loss; a failure before the first
    checkpoint restarts from the initial state (the trainer updates its
    tensors in place: the loop's host copy of them)."""
    from repro_torch.launch.train import main
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "20", "--batch",
            "4", "--seq", "32", "--ckpt-every", "5", "--log-every", "1000",
            "--device", "cpu"]
    h_fail = main(argv + ["--ckpt-dir", str(tmp_path / "a"),
                          "--inject-failure-at", "12"])
    h_ok = main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert h_fail[-1][0] == h_ok[-1][0]
    np.testing.assert_allclose(h_fail[-1][1], h_ok[-1][1], rtol=1e-4)
    short = argv[:4] + ["3"] + argv[5:]
    early = main(short + ["--ckpt-dir", str(tmp_path / "c"),
                          "--inject-failure-at", "1"])
    clean = main(short)
    assert [s for s, _ in early] == [0, 0, 1, 2]
    assert early[1:] == clean and early[0] == clean[0]


if __name__ == "__main__":
    _jax_main(sys.argv[1])
