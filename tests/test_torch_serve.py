"""The port's trustee serve against the JAX package's, on the same
numpy-seeded rows: the shared grouping and its tile metadata, and the
grouped KV serve — port "kernel" (on CPU: the kernels' plain versions),
"ref" and "masked" == JAX ``KVTableServe.serve_lax`` and the tiled Pallas
serve (interpret mode, br=128, one segment spanning several row tiles).
Bit-identical on integer-exact payloads; general floats within the
tolerance stated below.  The CUDA kernels against their plain versions
are in test_torch_gpu.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")    # collect where JAX is absent
import jax.numpy as jnp  # noqa: E402
from repro.core import Received as JReceived  # noqa: E402
from repro.core import make_grouping as j_make_grouping  # noqa: E402
from repro.core import make_kv_ops  # noqa: E402
from repro.core import serve_optable as j_serve_optable  # noqa: E402
from repro.core.channel import ChannelConfig as JChannelConfig  # noqa: E402

from repro_torch.core import (ChannelConfig, DelegatedKVStore,  # noqa: E402
                              Received, StackedMesh, collect_impl_events,
                              make_grouping, make_kv_schema, serve_optable,
                              use_session)

T_KEYS = 8           # trustees the keys are routed over (local key = k // 8)
VW = 3


def _rows(seed, n, n_local, integer=True, hot=0.7):
    rng = np.random.default_rng(seed)
    op = rng.choice(4, n, p=(0.2, 0.15, 0.45, 0.2)).astype(np.int16)
    local = rng.integers(0, n_local, n)
    local = np.where(rng.random(n) < hot, 3, local)
    key = (local * T_KEYS + 5).astype(np.int32)
    valid = rng.random(n) < 0.9
    if integer:
        value = rng.integers(0, 8, (n, VW)).astype(np.float32)
        table = rng.integers(0, 8, (n_local, VW)).astype(np.float32)
    else:
        value = rng.normal(size=(n, VW)).astype(np.float32)
        table = rng.normal(size=(n_local, VW)).astype(np.float32)
    expect = np.where(rng.random((n, 1)) < 0.5, table[local], value)
    return dict(op=op, key=key, value=value,
                expect=expect.astype(np.float32), valid=valid, table=table)


def _jax_serve(case, impl):
    rows = {k: jnp.asarray(case[k]) for k in ("op", "key", "value", "expect")}
    n = case["key"].shape[0]
    recv = JReceived(rows, jnp.asarray(case["valid"]),
                     jnp.zeros((n,), jnp.int32))
    cfg = JChannelConfig(serve_block_rows=128, serve_block_keys=128)
    serve = j_serve_optable(make_kv_ops(T_KEYS, VW), active_ids=(0, 1, 2, 3),
                            serve_impl=impl, cfg=cfg)
    state, resp = jax.jit(serve)({"table": jnp.asarray(case["table"])}, recv)
    return (np.asarray(state["table"]), np.asarray(resp["value"]),
            np.asarray(resp["flag"]))


def _torch_serve(cases, impl):
    """The port's serve over len(cases) STACKED trustee shards."""
    stack = lambda k: torch.as_tensor(np.stack([c[k] for c in cases]))
    rows = {k: stack(k) for k in ("op", "key", "value", "expect")}
    t, n = rows["key"].shape
    recv = Received(rows, stack("valid"), torch.zeros((t, n),
                                                      dtype=torch.int32))
    ops = make_kv_schema(T_KEYS, VW).delegated_ops()
    serve = serve_optable(ops, (0, 1, 2, 3), serve_impl=impl,
                          cfg=ChannelConfig())
    state, resp = serve({"table": stack("table")}, recv)
    return (state["table"].numpy(), resp["value"].numpy(),
            resp["flag"].numpy())


def test_grouping_and_tile_meta_match_jax():
    rng = np.random.default_rng(0)
    n, sentinel = 700, 4 * 50
    gid = rng.integers(0, sentinel, n)
    gid = np.where(rng.random(n) < 0.3, 7, gid)                   # hot
    gid = np.where(rng.random(n) < 0.1, sentinel, gid).astype(np.int32)
    got = make_grouping(torch.as_tensor(gid))
    for n_bins in (0, sentinel):
        want = j_make_grouping(jnp.asarray(gid), n_bins)
        for field in got._fields:
            assert np.array_equal(getattr(got, field).numpy(),
                                  np.asarray(getattr(want, field))), field
        for br in (128, 256):
            tm, wm = got.tile_meta(br), want.tile_meta(br)
            assert (tm.block_rows, tm.n_tiles) == (wm.block_rows, wm.n_tiles)
            for field in ("first_sid", "last_sid", "cont"):
                assert np.array_equal(getattr(tm, field).numpy(),
                                      np.asarray(getattr(wm, field))), field
    # stacked shards group independently
    two = np.stack([gid, gid[::-1].copy()])
    g2 = make_grouping(torch.as_tensor(two))
    w2 = j_make_grouping(jnp.asarray(two[1]))
    assert np.array_equal(g2.order[1].numpy(), np.asarray(w2.order))
    assert np.array_equal(g2.seg_end_row[1].numpy(),
                          np.asarray(w2.seg_end_row))


def test_serve_matches_jax_integer_exact():
    """One ADD segment of ~320 rows spans three 128-row tiles of the JAX
    kernel (its cross-tile carry) and more than one 256-row scan block of
    the port's segmented scan."""
    cases = [_rows(1, 1024, 40), _rows(2, 1024, 40)]
    jax_ref = [_jax_serve(c, "ref") for c in cases]
    jax_pallas = _jax_serve(cases[0], "pallas")
    for a, b in zip(jax_pallas, jax_ref[0]):
        assert np.array_equal(a, b)
    for impl in ("kernel", "ref", "masked"):
        got = _torch_serve(cases, impl)
        for shard in range(2):
            for g, w, what in zip(got, jax_ref[shard],
                                  ("table", "value", "flag")):
                assert np.array_equal(g[shard], w), f"{impl} {what}"


def test_serve_matches_jax_general_floats():
    """General f32 payloads: PUT/GET/CAS values move exactly; ADD priors
    and totals are sums of up to ~320 N(0,1) deltas taken in another order
    than XLA's cumsum, so they agree within atol 1e-4 (a few ulps of
    partial sums of magnitude up to ~30)."""
    case = _rows(3, 1024, 40, integer=False)
    want = _jax_serve(case, "ref")
    for impl in ("kernel", "ref", "masked"):
        got = _torch_serve([case], impl)
        np.testing.assert_allclose(got[0][0], want[0], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[1][0], want[1], rtol=0, atol=1e-4)
        assert np.array_equal(got[2][0], want[2]), impl


def test_non_f32_kernel_serve_reports_fallback_and_strict_raises():
    case = _rows(4, 256, 20)
    rows = {k: torch.as_tensor(case[k]) for k in ("op", "key")}
    rows["value"] = torch.as_tensor(case["value"]).double()[None]
    rows["expect"] = torch.as_tensor(case["expect"]).double()[None]
    rows["op"], rows["key"] = rows["op"][None], rows["key"][None]
    recv = Received(rows, torch.as_tensor(case["valid"])[None],
                    torch.zeros((1, 256), dtype=torch.int32))
    ops = make_kv_schema(T_KEYS, VW, torch.float64).delegated_ops()
    state = {"table": torch.as_tensor(case["table"]).double()[None]}
    serve = serve_optable(ops, (0, 1, 2, 3), "kernel", ChannelConfig())
    with collect_impl_events() as events:
        s_k, r_k = serve(state, recv)
    assert len(events) == 1 and "float32" in events[0]
    s_r, r_r = serve_optable(ops, (0, 1, 2, 3), "ref")(state, recv)
    assert torch.equal(s_k["table"], s_r["table"])
    assert torch.equal(r_k["value"], r_r["value"])
    strict = serve_optable(ops, (0, 1, 2, 3), "kernel",
                           ChannelConfig(strict_impl=True))
    with pytest.raises(TypeError, match="strict_impl"):
        strict(state, recv)
    # the engine surfaces the event per round
    with use_session():
        st = DelegatedKVStore(StackedMesh((2, 4), device="cpu"), 40, VW,
                              dtype=torch.float64, pack_impl="ref")
        st.get(torch.arange(16))
        assert st.session.last_stats()[st.trust.name]["impl_fallback"] == 1
