"""The port's MoE layer against the JAX package's, at deepseek-v2-lite-16b
SMOKE width (d_model 64, 4 routed experts top-2, 1 shared expert,
d_ff_expert 96) on the CPU, on JAX weights carried across by ``convert``:

  * the plain ``grouped_matmul`` and ``moe_ffn`` == ``repro.kernels.ref``
    (and the Pallas grouped-matmul kernel in interpret mode), in f32 and
    in bf16, also given per-expert counts on zero-padded slots;
  * ``moe_block`` with the pack's counts == with them dropped, bit for
    bit;
  * ``moe_block`` == JAX ``moe_block``: its output, ``moe_aux_loss``,
    ``moe_dropped_frac`` and ``moe_max_load``, after asserting that the
    port's router chose JAX's experts (``top_k`` keeps ``lax.top_k``'s
    order).  At T = 1 in-process: seq mode with the local shortcut on and
    off, ``second_round`` and ``drop`` overflow, a capacity factor of
    0.25 that drops rows, decode-shaped S = 1, and the kernel path
    (``use_pallas``).  At T = 2 and T = 4 against JAX on a 1xT mesh of 8
    virtual devices (one subprocess: this module run as a script): seq
    mode (S a multiple of T) and mask-partition mode (S = 1 and S = 30),
    with and without drops;
  * ``top_k`` breaks ties to the lower index; T not dividing the expert
    count raises ``ValueError``.

Tolerances: f32 outputs and aux metrics rtol = atol = 2e-5 (the same math
summed in another order by another library); the max load exactly (it
counts rows), the dropped fraction to 1e-6 relative (the same count of
dropped tokens, its f32 mean summed in another order). bf16 grouped
matmul: one bf16 ulp, rtol 2^-7 (both round an f32 sum once).
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

TOL = dict(rtol=2e-5, atol=2e-5)
B = 3
# name: (trustees, batch, seq, MoEConfig overrides, local shortcut)
CASES = {
    "t1_seq": (1, B, 16, {}, True),
    "t1_seq_no_shortcut": (1, B, 16, {}, False),
    "t1_drop_tight": (1, B, 16, dict(overflow="drop", capacity_factor=0.25),
                      False),
    "t1_second_round_tight": (1, B, 16, dict(capacity_factor=0.25,
                                             overflow_factor=0.25), False),
    "t1_decode": (1, 8, 1, {}, True),
    "t2_seq": (2, B, 16, {}, True),
    "t4_seq": (4, B, 16, {}, True),
    "t4_seq_drop_tight": (4, 4, 64, dict(overflow="drop",
                                         capacity_factor=0.25), True),
    "t4_seq_second_round_tight": (4, 4, 64, dict(capacity_factor=0.25,
                                                 overflow_factor=0.25),
                                  False),
    "t4_mask_decode": (4, 8, 1, {}, True),
    "t4_mask_tight": (4, 4, 30, dict(overflow="drop",
                                     capacity_factor=0.25), True),
    "t4_mask_second_round_tight": (4, 4, 30, dict(capacity_factor=0.25,
                                                  overflow_factor=0.25),
                                   True),
}
T1 = [k for k, v in CASES.items() if v[0] == 1]
MULTI = [k for k, v in CASES.items() if v[0] > 1]


def _jax_cfg(moe_kw):
    from repro.configs.registry import SMOKE_ARCHS
    cfg = SMOKE_ARCHS["deepseek-v2-lite-16b"]
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **moe_kw))


def _port_cfg(moe_kw):
    from repro_torch.configs.registry import get_smoke_arch
    cfg = get_smoke_arch("deepseek-v2-lite-16b")
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **moe_kw))


def _moe_params():
    """JAX SMOKE MoE weights (f32) as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    p = jmoe.init_moe(jax.random.PRNGKey(4), _jax_cfg({}), jnp.float32)
    return jax.tree_util.tree_map(np.array, p)


def _x(b, s, d, seed=11):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _jax_run(cfg, t, shortcut, use_pallas=False):
    from repro.configs.base import MeshConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("t", 16, B, "prefill"),
                     mesh=MeshConfig((1, t), ("data", "model")),
                     remat="none", param_dtype="float32",
                     activation_dtype="float32", local_shortcut=shortcut,
                     use_pallas=use_pallas)


def _port_run(cfg, t, shortcut, use_pallas=False):
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("t", 16, B, "prefill"),
                     mesh=MeshConfig((1, t), ("data", "model")),
                     remat="none", param_dtype="float32",
                     activation_dtype="float32", local_shortcut=shortcut,
                     use_pallas=use_pallas)


def _jax_case(name, use_pallas=False):
    """JAX ``moe_block`` on case ``name`` under the current mesh ->
    numpy (y, aux_loss, dropped_frac, max_load, top_e, probs)."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    t, b, s, kw, shortcut = CASES[name]
    cfg = _jax_cfg(kw)
    p = jax.tree_util.tree_map(jnp.asarray, _moe_params())
    x = jnp.asarray(_x(b, s, cfg.d_model))
    run = _jax_run(cfg, t, shortcut, use_pallas)
    y, aux = jax.jit(lambda p, x: jmoe.moe_block(p, x, cfg, run))(p, x)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), -1)
    _, top_e = jax.lax.top_k(probs, cfg.moe.top_k)
    return {"y": np.asarray(y),
            "aux_loss": np.asarray(aux["moe_aux_loss"]),
            "dropped_frac": np.asarray(aux["moe_dropped_frac"]),
            "max_load": np.asarray(aux["moe_max_load"]),
            "top_e": np.asarray(top_e), "probs": np.asarray(probs)}


def _port_case(name, use_pallas=False):
    from repro_torch import convert
    from repro_torch.models import moe as tmoe
    t, b, s, kw, shortcut = CASES[name]
    cfg = _port_cfg(kw)
    p = convert.model_params_from_jax(_moe_params(), device="cpu")
    x = torch.as_tensor(_x(b, s, cfg.d_model))
    y, aux = tmoe.moe_block(p, x, cfg, _port_run(cfg, t, shortcut,
                                                  use_pallas))
    probs = torch.softmax(x @ p["router"], -1)
    return {"y": y.numpy(), "aux_loss": aux["moe_aux_loss"].numpy(),
            "dropped_frac": aux["moe_dropped_frac"].numpy(),
            "max_load": aux["moe_max_load"].numpy(),
            "top_e": tmoe.top_k(probs, cfg.moe.top_k)[1].numpy()}


def _compare(got, want, name):
    k = got["top_e"].shape[-1]
    np.testing.assert_array_equal(got["top_e"], want["top_e"],
                                  err_msg=f"{name}: experts chosen")
    srt = -np.sort(-want["probs"], axis=-1)
    gap = float((srt[..., k - 1] - srt[..., k]).min())
    assert gap > 1e-6, f"{name}: k-th / (k+1)-th probability gap {gap}"
    np.testing.assert_allclose(got["y"], want["y"], **TOL, err_msg=name)
    np.testing.assert_allclose(got["aux_loss"], want["aux_loss"], **TOL)
    # a mean of per-token flags: the same count, summed in another order
    np.testing.assert_allclose(got["dropped_frac"], want["dropped_frac"],
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got["max_load"], want["max_load"])


@pytest.fixture(autouse=True)
def _reset_mesh():
    from repro.core import meshctx
    meshctx.set_context(meshctx._default_mesh(), "default")
    yield


# ---------------------------------------------------------------------------
# the plain expert FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_and_moe_ffn_plain_match_jax(dtype):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(7)
    e, c, d, f = 3, 13, 72, 40
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    wg, wu = (rng.normal(size=(e, d, f)).astype(np.float32) / 8
              for _ in range(2))
    wd = rng.normal(size=(e, f, d)).astype(np.float32) / 6
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    J = lambda a: jnp.asarray(a, jdt)
    T = lambda a: torch.as_tensor(a).to(tdt)
    tol = TOL if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    got = tops.grouped_matmul(T(x), T(wg))
    assert got.dtype == tdt and got.shape == (e, c, f)
    want = jref.grouped_matmul(J(x), J(wg))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    pallas = jops.grouped_matmul(J(x), J(wg), impl="pallas")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), **tol)
    # the kernel wrapper on CPU tensors is its plain version
    np.testing.assert_array_equal(
        tops.grouped_matmul(T(x), T(wg), impl="kernel").float().numpy(),
        tref.grouped_matmul(T(x), T(wg)).float().numpy())
    if dtype == "float32":
        np.testing.assert_allclose(
            tref.moe_ffn(T(x), T(wg), T(wu), T(wd)).numpy(),
            np.asarray(jref.moe_ffn(J(x), J(wg), J(wu), J(wd))), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_and_moe_ffn_with_counts_match_jax(dtype):
    """With the pack's per-expert counts (0, a partial tile, C) and the
    slots past them zero, as the pack leaves them: the plain grouped
    matmul and expert FFN given the counts == JAX's (which has no counts:
    its zero rows give zero rows) and the Pallas kernel in interpret
    mode; the rows past the counts are exactly zero."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(8)
    e, c, d, f = 4, 13, 72, 40
    counts = np.array([0, 5, 13, 1], np.int32)
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    x[np.arange(c)[None, :] >= counts[:, None]] = 0
    wg, wu = (rng.normal(size=(e, d, f)).astype(np.float32) / 8
              for _ in range(2))
    wd = rng.normal(size=(e, f, d)).astype(np.float32) / 6
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    J = lambda a: jnp.asarray(a, jdt)
    T = lambda a: torch.as_tensor(a).to(tdt)
    n = torch.as_tensor(counts)
    tol = TOL if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-6)
    got = tops.grouped_matmul(T(x), T(wg), n)
    past = np.arange(c)[None, :] >= counts[:, None]
    assert (got.float().numpy()[past] == 0).all()
    for want in (jref.grouped_matmul(J(x), J(wg)),
                 jops.grouped_matmul(J(x), J(wg), impl="pallas")):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)
    # the counts are a hint: the same result without them, bit for bit
    assert torch.equal(got, tref.grouped_matmul(T(x), T(wg)))
    y = tref.moe_ffn(T(x), T(wg), T(wu), T(wd), counts=n)
    assert (y.float().numpy()[past] == 0).all()
    assert torch.equal(y, tref.moe_ffn(T(x), T(wg), T(wu), T(wd)))
    if dtype == "float32":
        np.testing.assert_allclose(
            y.numpy(), np.asarray(jref.moe_ffn(J(x), J(wg), J(wu), J(wd))),
            **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ["t1_seq", "t1_second_round_tight",
                                  "t4_seq_drop_tight", "t4_mask_decode"])
def test_moe_block_with_counts_equals_without(name, use_pallas,
                                              monkeypatch):
    """The trustees' expert FFN given the pack's counts (the layer's own
    path) == the same layer with the counts dropped, bit for bit: the
    counts only tell the grouped matmul which slots are filled."""
    from repro_torch.models import moe as tmoe
    seen = []
    real = tmoe._expert_ffn

    def record(x_e, weights, act, use_kernel, counts):
        seen.append(counts)
        return real(x_e, weights, act, use_kernel, counts)
    monkeypatch.setattr(tmoe, "_expert_ffn", record)
    got = _port_case(name, use_pallas)
    assert seen and all(c is not None and c.dtype == torch.int32
                        for c in seen)
    monkeypatch.setattr(
        tmoe, "_expert_ffn",
        lambda x_e, weights, act, use_kernel, counts: real(
            x_e, weights, act, use_kernel, None))
    want = _port_case(name, use_pallas)
    for k in ("y", "aux_loss", "dropped_frac", "max_load", "top_e"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_top_k_breaks_ties_to_the_lower_index():
    from repro_torch.models.moe import top_k
    p = torch.tensor([[0.125, 0.375, 0.375, 0.25, 0.375],
                      [0.25, 0.25, 0.25, 0.25, 0.0]])
    vals, idx = top_k(p, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert vals.tolist() == [[0.375] * 3, [0.25] * 3]


# ---------------------------------------------------------------------------
# moe_block at T = 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", T1)
def test_moe_block_matches_jax_one_trustee(name):
    _compare(_port_case(name), _jax_case(name), name)


def test_moe_block_drops_rows_where_capacity_is_tight():
    for name in ("t1_drop_tight", "t1_second_round_tight"):
        assert float(_port_case(name)["dropped_frac"]) > 0, name
    assert float(_port_case("t1_seq_no_shortcut")["dropped_frac"]) == 0


def test_moe_block_kernel_path_matches_jax_pallas():
    """``use_pallas``: the port's grouped-matmul kernel path (its plain
    version on CPU tensors) against JAX's Pallas kernel in interpret
    mode."""
    got = _port_case("t1_seq", use_pallas=True)
    _compare(got, _jax_case("t1_seq", use_pallas=True), "t1_seq pallas")
    np.testing.assert_array_equal(got["y"], _port_case("t1_seq")["y"])


def test_trustees_must_divide_the_experts():
    from repro_torch import convert
    from repro_torch.models import moe as tmoe
    cfg = _port_cfg({})
    p = convert.model_params_from_jax(_moe_params(), device="cpu")
    x = torch.as_tensor(_x(B, 6, cfg.d_model))
    with pytest.raises(ValueError, match="experts"):
        tmoe.moe_block(p, x, cfg, _port_run(cfg, 3, True))


# ---------------------------------------------------------------------------
# T = 2 and T = 4, against JAX on 8 virtual devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_multi(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_moe") / "runs.npz"
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
        res = {}
        for key in z.files:
            name, field = key.split("/")
            res.setdefault(name, {})[field] = z[key]
        return res


@pytest.mark.parametrize("name", MULTI)
def test_moe_block_matches_jax_mesh(jax_multi, name):
    _compare(_port_case(name), jax_multi[name], name)


def test_moe_block_mesh_cases_cover_both_modes_and_drops(jax_multi):
    dropped = {n: float(jax_multi[n]["dropped_frac"]) for n in MULTI}
    assert dropped["t4_seq_drop_tight"] > 0
    assert dropped["t4_mask_tight"] > 0
    assert dropped["t4_mask_second_round_tight"] > 0
    assert dropped["t4_seq"] == dropped["t4_mask_decode"] == 0


def _jax_main(out_path):
    import jax
    from jax.sharding import Mesh
    from repro.core import meshctx
    res = {}
    for name in MULTI:
        t = CASES[name][0]
        mesh = Mesh(np.array(jax.devices()[:t]).reshape(1, t),
                    ("data", "model"))
        meshctx.set_context(mesh, ("data",))
        for field, v in _jax_case(name).items():
            res[f"{name}/{field}"] = v
    np.savez(out_path, **res)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
