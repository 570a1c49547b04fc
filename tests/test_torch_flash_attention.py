"""The port's plain flash attention against the JAX package's, on
numpy-seeded inputs, in f32 on the CPU.

  * ``ref.flash_attention`` (what the CUDA kernel computes) == JAX
    ``ref.flash_attention`` and == the Pallas kernel in interpret mode, on
    the cases of ``tests/test_kernels.py::test_flash_attention`` (MHA,
    GQA, MQA with a longer KV, D 32-128, causal and not) and its
    ``q_offset`` case; the port's ``ops.flash_attention`` wrapper on CPU
    tensors (its ``impl="kernel"`` path) runs the plain version;
  * ``flash_attention_stats`` + ``merge_attention_stats`` == JAX's pair
    and == monolithic attention (``test_merge_attention_stats``);
  * ``blockwise_attention`` == the JAX blockwise path and the plain
    version at 2048 keys.

Tolerance 2e-5 (rtol and atol): the same f32 math, summed in another
order by another library.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")    # collect where JAX is absent
import jax.numpy as jnp  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _qkv(seed, b, hq, hkv, sq, skv, dh):
    return (_rand(seed, b, hq, sq, dh), _rand(seed + 1, b, hkv, skv, dh),
            _rand(seed + 2, b, hkv, skv, dh))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh", [
    (1, 4, 4, 128, 128, 64),      # MHA
    (2, 4, 2, 256, 256, 64),      # GQA
    (1, 8, 1, 128, 256, 32),      # MQA, longer kv
    (2, 2, 2, 384, 384, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_attention_matches_jax(b, hq, hkv, sq, skv, dh, causal):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops as kops
    q, k, v = _qkv(b * 100 + sq + dh, b, hq, hkv, sq, skv, dh)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_ref = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal))
    want_pallas = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                                  impl="pallas"))
    T = torch.as_tensor
    for impl in ("ref", "kernel"):      # "kernel" on CPU: the plain version
        got = kops.flash_attention(T(q), T(k), T(v), causal=causal,
                                   impl=impl).numpy()
        np.testing.assert_allclose(got, want_ref, **TOL)
        np.testing.assert_allclose(got, want_pallas, **TOL)


def test_flash_attention_offset_matches_jax_and_sharded_rows():
    """q_offset reproduces the causal rows of a query block that starts
    mid-sequence — the sequence-sharded case of
    ``test_flash_attention_offset_matches_sharded_rows``."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as kops
    q, k, v = _qkv(7, 1, 2, 2, 256, 256, 64)
    T = torch.as_tensor
    full = kops.flash_attention(T(q), T(k), T(v)).numpy()
    half = kops.flash_attention(T(q[:, :, 128:]), T(k), T(v),
                                q_offset=128).numpy()
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q[:, :, 128:]), jnp.asarray(k), jnp.asarray(v),
        q_offset=jnp.int32(128), impl="pallas"))
    np.testing.assert_allclose(half, full[:, :, 128:], **TOL)
    np.testing.assert_allclose(half, want, **TOL)


def test_stats_and_merge_match_jax_and_monolithic():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    b, h, s, dh, t = 2, 4, 256, 64, 4
    q, k, v = _qkv(11, b, h, h, 1, s, dh)
    parts_t, parts_j = [], []
    for i in range(t):
        sl = slice(i * s // t, (i + 1) * s // t)
        parts_t.append(tref.flash_attention_stats(
            torch.as_tensor(q), torch.as_tensor(k[:, :, sl]),
            torch.as_tensor(v[:, :, sl]), causal=False))
        parts_j.append(jref.flash_attention_stats(
            jnp.asarray(q), jnp.asarray(k[:, :, sl]),
            jnp.asarray(v[:, :, sl]), causal=False))
    for pt, pj in zip(parts_t, parts_j):
        for a, bb in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(bb), **TOL)
    merged = tref.merge_attention_stats(*(torch.stack([p[i] for p in
                                                       parts_t])
                                          for i in range(3)))
    jmerged = jref.merge_attention_stats(*(jnp.stack([p[i] for p in
                                                      parts_j])
                                           for i in range(3)))
    for a, bb in zip(merged, jmerged):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), **TOL)
    full = tref.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), causal=False)
    np.testing.assert_allclose(merged[0][:, :, 0].numpy(),
                               full[:, :, 0].numpy(), **TOL)


@pytest.mark.parametrize("q_offset", [0, 1024])
def test_blockwise_matches_jax_and_plain(q_offset):
    """The plain path for 2048 keys and up (KV blocks of 1024)."""
    from repro.models import attention as jatt
    from repro_torch.kernels import ref as tref
    from repro_torch.models import attention as tatt
    q, k, v = _qkv(13, 1, 4, 2, 64, 2048, 32)
    T = torch.as_tensor
    got = tatt.blockwise_attention(T(q), T(k), T(v), q_offset=q_offset)
    want = jatt.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tref.flash_attention(T(q), T(k), T(v), q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("d,kernel,rows", [(32, "mma.sync", 64),
                                           (64, "wgmma", 128),
                                           (128, "wgmma", 128),
                                           (192, "wgmma", 128),
                                           (256, "wgmma", 128)])
def test_flash_dispatch_by_head_dim(d, kernel, rows):
    """D 64, 128, 192 and 256 (every main path's) take the TMA + wgmma
    kernel with 128-row query tiles; only D 32 keeps the mma.sync kernel;
    a head dim neither takes is refused."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.kernel_for(d) == kernel
    assert fa.query_tile(d) == rows
    with pytest.raises(ValueError, match="head dim"):
        fa.kernel_for(96)
