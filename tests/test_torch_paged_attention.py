"""The port's paged-decode attention against the JAX package's, on
numpy-seeded inputs, in f32 on the CPU (tolerance 2e-5: f32 sums taken in
another order by another library):

  * ``ref.paged_attention`` (what the CUDA kernel computes) == JAX
    ``kops.paged_attention`` with ``impl="ref"`` and with the Pallas kernel
    in interpret mode — ragged chains, -1 pads inside and past the live
    length, lengths on and one past page boundaries, GQA rep 1, 2 and 8;
  * the CUDA wrapper's split plan covers every live page of a chain
    exactly once, for lengths of 0, 1, a page, one past a page, MP * PS
    and past it;
  * RMSNorm and RoPE == the JAX layers;
  * ``paged_decode_attention`` at qwen2.5-3b SMOKE width (QKV bias,
    nonzero biases) and with QK norm == the JAX layer with the same
    weights carried through ``convert.attention_params_from_jax`` — the
    output and the KV pool after every step.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")    # collect where JAX is absent
import jax.numpy as jnp  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, b, hq, hkv, d, p, ps, mp, lengths, pad_inside=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(p, hkv, ps, d)).astype(np.float32)
    v = rng.normal(size=(p, hkv, ps, d)).astype(np.float32)
    tbl = np.full((b, mp), -1, np.int32)
    for i, n in enumerate(lengths):
        live = min(-(-int(n) // ps), mp)
        tbl[i, :live] = rng.choice(p, live, replace=False)
        if pad_inside and live > 1:
            tbl[i, rng.integers(0, live)] = -1
    return q, k, v, tbl, np.asarray(lengths, np.int32)


CASES = {
    "ragged_gqa2": dict(b=4, hq=4, hkv=2, d=16, p=12, ps=8, mp=3,
                        lengths=[1, 7, 13, 24]),
    "page_boundaries_gqa8": dict(b=6, hq=16, hkv=2, d=32, p=30, ps=4, mp=5,
                                 lengths=[1, 4, 5, 8, 9, 20]),
    "mha_full_chain": dict(b=3, hq=4, hkv=4, d=8, p=10, ps=4, mp=3,
                           lengths=[12, 1, 5]),
    "pads_inside": dict(b=4, hq=8, hkv=2, d=16, p=40, ps=4, mp=6,
                        lengths=[24, 17, 9, 2], pad_inside=True),
}


@pytest.mark.parametrize("mp", [1, 2, 3, 4, 5, 8, 15, 16, 64, 65])
def test_split_plan_covers_every_live_page_once(mp):
    """Split s of ``split_plan(mp)`` reads pages [s * pps, (s + 1) * pps)
    of the live ones (the kernel's rule): together the splits read each
    live page once and no other, and a split reads pages exactly when it
    starts before the live pages end (the merge's rule for which partials
    exist)."""
    from repro_torch.kernels.paged_attention import split_plan
    ps = 16
    pps, ns = split_plan(mp)
    assert pps >= 1 and (ns - 1) * pps < mp <= ns * pps
    rng = np.random.default_rng(mp)
    lengths = {0, 1, ps, ps + 1, mp * ps, mp * ps + 5}
    lengths |= set(rng.integers(1, mp * ps + 1, 20).tolist())
    for n in sorted(lengths):
        live = min(mp, -(-n // ps))
        spans = [range(s * pps, min((s + 1) * pps, live)) for s in range(ns)]
        pages = [j for r in spans for j in r]
        assert len(spans) == ns
        assert sorted(pages) == list(range(live)), n
        assert len(pages) == len(set(pages)), n
        assert [len(r) > 0 for r in spans] == \
            [s * pps < live for s in range(ns)], n


@pytest.mark.parametrize("jax_impl", ["ref", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_paged_attention_matches_jax(name, jax_impl):
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as kops
    q, k, v, tbl, lens = _case(len(name), **CASES[name])
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl),
        jnp.asarray(lens), impl=jax_impl, interpret=True))
    T = torch.as_tensor
    for impl in ("ref", "kernel"):      # "kernel" on CPU: the plain version
        got = kops.paged_attention(T(q), T(k), T(v), T(tbl), T(lens),
                                   impl=impl).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_layers_match_jax():
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 5)).astype(np.int32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            tl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                          theta).numpy(),
            np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     theta)), **TOL)
    np.testing.assert_allclose(
        tl.rmsnorm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x),
                   1e-6).numpy(),
        np.asarray(jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                              1e-6)), **TOL)


def _jax_params(cfg, seed):
    """JAX init, then nonzero biases and norm scales from numpy."""
    from repro.models import attention as jatt
    p = jax.tree_util.tree_map(np.asarray, jatt.init_attention(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for k in ("b_q", "b_k", "b_v"):
        if k in p:
            p[k] = rng.normal(size=p[k].shape).astype(np.float32)
    for k in ("q_norm", "k_norm"):
        if k in p:
            p[k] = {"scale": (1 + 0.1 * rng.normal(
                size=p[k]["scale"].shape)).astype(np.float32)}
    return p


def _smoke(qk_norm):
    from repro.configs.qwen2_5_3b import SMOKE as JSMOKE
    from repro_torch.configs.qwen2_5_3b import SMOKE
    assert all(getattr(SMOKE, f) == getattr(JSMOKE, f) for f in (
        "d_model", "n_heads", "n_kv_heads", "qkv_bias", "qk_norm",
        "rope_theta", "norm_eps", "resolved_head_dim"))
    if not qk_norm:
        return JSMOKE, SMOKE
    kw = dict(qk_norm=True, qkv_bias=False)
    return JSMOKE.with_overrides(**kw), SMOKE.with_overrides(**kw)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_paged_decode_attention_matches_jax_layer(qk_norm):
    from repro.models import attention as jatt
    from repro_torch import convert
    from repro_torch.models import attention as tatt
    jcfg, cfg = _smoke(qk_norm)
    jp = _jax_params(jcfg, 5)
    tp = convert.attention_params_from_jax(jp, device="cpu")
    assert set(tp) == set(jp)
    rng = np.random.default_rng(6)
    b, n_pages, ps, mp = 3, 12, 4, 4
    pool0 = rng.normal(size=(n_pages, cfg.n_kv_heads, ps,
                             cfg.resolved_head_dim)).astype(np.float32)
    jpool = {"k": jnp.asarray(pool0), "v": jnp.asarray(pool0 * 0.5)}
    tpool = tatt.init_paged_kv_pool(cfg, n_pages, ps, device="cpu")
    tpool["k"].copy_(torch.as_tensor(pool0))
    tpool["v"].copy_(torch.as_tensor(pool0 * 0.5))
    tbl = np.array([[3, 7, 1, -1], [0, 2, 4, 5], [11, -1, -1, -1]],
                   np.int32)
    for pos in ([0, 5, 2], [3, 13, 3], [4, 15, 1]):
        pos = np.asarray(pos, np.int32)
        x = rng.normal(size=(b, cfg.d_model)).astype(np.float32)
        jy, jpool = jatt.paged_decode_attention(
            jp, jnp.asarray(x), jnp.asarray(pos), jpool, jnp.asarray(tbl),
            jcfg)
        ty, tpool = tatt.paged_decode_attention(
            tp, torch.as_tensor(x), torch.as_tensor(pos), tpool,
            torch.as_tensor(tbl), cfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(tpool[k].numpy(),
                                       np.asarray(jpool[k]), **TOL)
