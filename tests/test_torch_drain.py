"""The defer drain of the port (``overflow="defer"``, ``max_rounds``;
``channel.delegate_drain``) against the JAX package on 8 virtual CPU
devices (one subprocess: this module, run as a script), bit for bit on
integer-exact payloads — every response, the final tables and the
``rounds`` / ``residual`` JAX's ``while_loop`` counts:

  * ``tests/_drain_battery.py``: with per-client disjoint keys, a
    capacity-1 drain of up to 32 rounds gives what one round of capacity
    R gives, shared (with and without the shortcut) and dedicated (3
    trustees), with the pack "ref" or the pack kernel and the serve "ref",
    the serve kernels or "masked"; ``max_rounds`` too small reports the
    residual and commits exactly R - residual increments; the pack kernel
    inside the drain equals the "ref" pack;
  * ``tests/_engine_battery.py``'s ``mux_defer_drain_matches_sequential``:
    a fused round of two trusts drains as their solo rounds do;
  * the MoE layer with ``overflow="defer"`` at the deepseek-v2-lite-16b
    SMOKE width, at T = 1 in process and T = 4 on the 8 devices (JAX's one
    ``delegate`` in which the deferred rows count as dropped);
  * ``serve.main --drain-rounds 3``: the plain serve's tokens, the ledger
    counting every generated token, residual 0;
  * ``step(sync=False)`` issues a drain with no read of a device value on
    the host; a drain whose retry serve would raise raises before round 1
    writes the table.

The port issues every retry round, each masked by the rows still
remaining: the rounds with none left change nothing and are not counted.
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

N_KEYS, VW, R, N_TRACE = 120, 2, 64, 8
OPS = ("get", "put", "add", "cas")
# name: (mode keywords, trustees, clients, seed)
DRAINS = {"shared": ({"local_shortcut": False}, 8, 8, 50),
          "shortcut": ({"local_shortcut": True}, 8, 8, 51),
          "dedicated": ({"mode": "dedicated", "n_dedicated": 3}, 3, 5, 52)}
IMPLS = (("ref", "ref"), ("kernel", "kernel"), ("ref", "masked"))


def owned_keys(n_trustees, n_clients):
    """Per-client disjoint key sets spanning every trustee."""
    return {c: np.array([k for k in range(N_KEYS)
                         if (k // n_trustees) % n_clients == c])
            for c in range(n_clients)}


def gen_trace(seed, n_trustees, n_clients):
    """``_drain_battery.gen_trace``: each row's keys from its client's own
    set, skewed onto a few keys; a CAS round takes distinct keys."""
    from repro_torch.core import SequentialKVReference
    rng = np.random.default_rng(seed)
    own = owned_keys(n_trustees, n_clients)
    r_per = -(-R // n_clients)
    client_of = np.minimum(np.arange(R) // r_per, n_clients - 1)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    ref = SequentialKVReference(N_KEYS, VW)
    ref.prefill(init)
    rounds = []
    for _ in range(N_TRACE):
        op = OPS[int(rng.integers(0, 4))]
        if op == "cas":
            per_client = {c: rng.choice(own[c], size=min(len(own[c]), r_per),
                                        replace=False)
                          for c in range(n_clients)}
            idx = np.arange(R) - client_of * r_per
            keys = np.array([per_client[c][i % len(per_client[c])]
                             for c, i in zip(client_of, idx)], np.int32)
        else:
            keys = np.array([rng.choice(own[c][:max(2, len(own[c]) // 3)])
                             for c in client_of], np.int32)
        vals = rng.integers(0, 8, (R, VW)).astype(np.float32)
        expect = None
        if op == "cas":
            live = ref.table[keys].copy()
            rand = rng.integers(0, 8, (R, VW)).astype(np.float32)
            expect = np.where(rng.random(R)[:, None] < 0.5, live, rand)
        rounds.append((op, keys, vals, expect))
        if op == "put":
            ref.put(keys, vals)
        elif op == "add":
            ref.add(keys, vals)
        elif op == "cas":
            ref.cas(keys, expect, vals)
    return init, rounds


def replay(store, rounds, conv):
    out = {}
    for i, (op, keys, vals, expect) in enumerate(rounds):
        k = conv(keys)
        if op == "get":
            out[f"{i}/value"] = np.asarray(store.get(k))
        elif op == "put":
            store.put(k, conv(vals))
        elif op == "add":
            out[f"{i}/value"] = np.asarray(store.add(k, conv(vals)))
        else:
            f, o = store.cas(k, conv(expect), conv(vals))
            out[f"{i}/flag"], out[f"{i}/value"] = np.asarray(f), np.asarray(o)
        s = store.trust.last_drain_stats()
        out[f"{i}/drain"] = np.asarray([s["rounds"], s["residual"]])
    out["table"] = np.asarray(store.dump())
    return out


# -- the fused round (_engine_battery._defer) -------------------------------

E_KEYS, E_R, E_ROUNDS = 67, 48, 8


def gen_pair_trace(seed):
    rng = np.random.default_rng(seed)
    init = rng.integers(1, 8, (E_KEYS, VW)).astype(np.float32)
    rounds = []
    for _ in range(E_ROUNDS):
        op = OPS[int(rng.integers(0, 4))]
        keys = rng.choice(E_KEYS, E_R, replace=False).astype(np.int32)
        vals = rng.integers(0, 8, (E_R, VW)).astype(np.float32)
        expect = rng.integers(0, 8, (E_R, VW)).astype(np.float32)
        rounds.append((op, keys, vals, expect))
    return init, rounds


def _payload(op, keys, vals, expect, conv):
    p = {"key": conv(keys)}
    if op != "get":
        p["value"] = conv(vals)
    if op == "cas":
        p["expect"] = conv(expect)
    return p


def defer_pair(pkg, mesh, session, **kw):
    kw = dict(capacity=2, local_shortcut=False, overflow="defer",
              max_rounds=16, session=session, **kw)
    lkw = {k: v for k, v in kw.items() if k != "local_shortcut"}
    return (pkg.DelegatedKVStore(mesh, E_KEYS, VW, name="kv", **kw),
            pkg.FetchRMWStore(mesh, E_KEYS, VW, **lkw).store)


def drive_pair(stores, session, conv, fused):
    traces = [gen_pair_trace(s) for s in (22, 23)]
    for st, (init, _r) in zip(stores, traces):
        st.prefill(init)
    out = {}
    for rnd in range(E_ROUNDS):
        futs = []
        for i, (st, (_init, rounds)) in enumerate(zip(stores, traces)):
            op, keys, vals, expect = rounds[rnd]
            args = (op, st.route(conv(keys)),
                    _payload(op, keys, vals, expect, conv))
            futs.append((i, op, st.trust.submit(*args) if fused
                         else st.trust.apply(*args)))
        if fused:
            session.step()
            stats = session.last_stats()
            for i, st in enumerate(stores):
                s = stats[st.trust.name]
                out[f"{rnd}/{i}/stats"] = np.asarray(
                    [s["rounds"], s["residual"], s["demand_max"]])
        for i, op, r in futs:
            r = r.result() if fused else r
            out[f"{rnd}/{i}/value"] = np.asarray(r["value"])
            if op == "cas":
                out[f"{rnd}/{i}/flag"] = np.asarray(r["flag"])
    for i, st in enumerate(stores):
        out[f"final/{i}"] = np.asarray(st.dump())
    return out


# -- MoE overflow="defer" ----------------------------------------------------

# name: (trustees, batch, seq, local shortcut); capacity factor 0.25
# defers rows (at T = 1 only with the shortcut off: it takes every row)
MOE = {"t1": (1, 3, 16, False), "t4_seq": (4, 4, 64, True),
       "t4_mask": (4, 4, 30, True)}
MOE_KW = dict(overflow="defer", capacity_factor=0.25)


def _moe_inputs():
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import SMOKE_ARCHS
    from repro.models import moe as jmoe
    cfg = SMOKE_ARCHS["deepseek-v2-lite-16b"]
    p = jmoe.init_moe(jax.random.PRNGKey(4), cfg, jnp.float32)
    return jax.tree_util.tree_map(np.array, p)


def _moe_x(b, s, d):
    return np.random.default_rng(11).normal(size=(b, s, d)).astype(
        np.float32)


def jax_moe(name):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro.configs.registry import SMOKE_ARCHS
    from repro.models import moe as jmoe
    t, b, s, shortcut = MOE[name]
    cfg = SMOKE_ARCHS["deepseek-v2-lite-16b"]
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **MOE_KW))
    p = jax.tree_util.tree_map(jnp.asarray, _moe_inputs())
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 16, b, "prefill"),
                    mesh=MeshConfig((1, t), ("data", "model")),
                    remat="none", param_dtype="float32",
                    activation_dtype="float32", local_shortcut=shortcut)
    y, aux = jax.jit(lambda p, x: jmoe.moe_block(p, x, cfg, run))(
        p, jnp.asarray(_moe_x(b, s, cfg.d_model)))
    return {"y": np.asarray(y),
            "dropped_frac": np.asarray(aux["moe_dropped_frac"]),
            "max_load": np.asarray(aux["moe_max_load"])}


# ---------------------------------------------------------------------------
# both sides
# ---------------------------------------------------------------------------

def _mesh(pkg):
    if pkg.__name__ == "repro.core":
        import jax
        from jax.sharding import Mesh
        return Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    return pkg.StackedMesh((2, 4), device="cpu")


def run_cases(pkg, conv, pack="ref", serve="ref"):
    mesh = _mesh(pkg)
    kw = dict(pack_impl=pack, serve_impl=serve)
    res = {}
    for name, (mode_kw, t, c, seed) in DRAINS.items():
        init, rounds = gen_trace(seed, t, c)
        with pkg.use_session():
            st = pkg.DelegatedKVStore(mesh, N_KEYS, VW, capacity=1,
                                      overflow="defer", max_rounds=32,
                                      **mode_kw, **kw)
            st.prefill(init)
            res.update({f"{name}/{k}": v
                        for k, v in replay(st, rounds, conv).items()})
    with pkg.use_session():
        st = pkg.DelegatedKVStore(mesh, N_KEYS, VW, capacity=1,
                                  overflow="defer", max_rounds=2,
                                  local_shortcut=False, **kw)
        st.prefill(np.zeros((N_KEYS, VW), np.float32))
        res["residual/old"] = np.asarray(st.add(
            conv(np.zeros(R, np.int32)), conv(np.ones((R, VW), np.float32))))
        s = st.trust.last_drain_stats()
        res["residual/drain"] = np.asarray([s["rounds"], s["residual"]])
        res["residual/table"] = np.asarray(st.dump())
    init, rounds = gen_trace(61, 8, 8)
    rounds = [r for r in rounds if r[0] == "add"][:2] or rounds[:2]
    with pkg.use_session():
        st = pkg.DelegatedKVStore(mesh, N_KEYS, VW, capacity=1,
                                  overflow="defer", max_rounds=16,
                                  local_shortcut=False, **kw)
        st.prefill(init)
        res.update({f"pack_drain/{k}": v
                    for k, v in replay(st, rounds, conv).items()})
    sess = pkg.TrustSession()
    res.update({f"mux/{k}": v for k, v in drive_pair(
        defer_pair(pkg, mesh, sess, **kw), sess, conv, True).items()})
    return res


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_drain") / "runs.npz"
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


@pytest.fixture(scope="module")
def port_runs():
    import torch
    import repro_torch.core as pkg
    return {impl: run_cases(pkg, torch.as_tensor, *impl) for impl in IMPLS}


def _sub(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "/")}


def _same(got, want, what, skip=()):
    assert want, what
    for k in sorted(want):
        if k.endswith(skip):
            continue
        assert k in got, f"{what}: {k} missing"
        assert got[k].shape == want[k].shape and np.array_equal(
            got[k], want[k]), f"{what}: {k} differs:\n{got[k]}\n{want[k]}"


@pytest.mark.parametrize("impl", IMPLS,
                         ids=lambda i: f"pack_{i[0]}-serve_{i[1]}")
@pytest.mark.parametrize("case", list(DRAINS) + ["residual", "pack_drain",
                                                 "mux"])
def test_drain_matches_jax_on_8_devices(jax_runs, port_runs, case, impl):
    _same(_sub(port_runs[impl], case), _sub(jax_runs, case),
          f"{case} {impl} vs JAX")


@pytest.mark.parametrize("case", list(DRAINS))
def test_drain_equals_one_round_of_ample_capacity(port_runs, case):
    """The battery's acceptance property: drained over bounded rounds, a
    capacity-1 store answers as one round of capacity R does, with some
    round drained over several and nothing left unserved."""
    import torch
    import repro_torch.core as pkg
    mode_kw, t, c, seed = DRAINS[case]
    init, rounds = gen_trace(seed, t, c)
    with pkg.use_session():
        big = pkg.DelegatedKVStore(pkg.StackedMesh((2, 4), device="cpu"),
                                   N_KEYS, VW, capacity=R, **mode_kw)
        big.prefill(init)
        want = replay(big, rounds, torch.as_tensor)
    got = _sub(port_runs[("kernel", "kernel")], case)
    _same(got, want, f"{case} drain vs capacity R", skip=("drain",))
    used = [got[f"{i}/drain"] for i in range(N_TRACE)]
    assert max(u[0] for u in used) > 1 and max(u[1] for u in used) == 0, used


def test_residual_is_reported_and_conserved(port_runs):
    """max_rounds 2 of a capacity-1 block: 8 clients x 1 slot x 2 rounds
    = 16 of 64 increments land, 48 are reported residual with zero
    responses, and the 16 served answer their priors 0..15 per client."""
    res = _sub(port_runs[("kernel", "kernel")], "residual")
    assert res["drain"].tolist() == [2, R - 16]
    assert res["table"][0, 0] == 16 and not res["table"][1:].any()
    want = np.zeros(R, np.float32)
    want[0::8] = np.arange(8)          # round 1: each client's first row
    want[1::8] = 8 + np.arange(8)      # round 2: its second, in order
    assert np.array_equal(res["old"][:, 0], want), res["old"][:, 0]


def test_pack_kernel_inside_the_drain_equals_the_ref_pack(port_runs):
    _same(_sub(port_runs[("kernel", "kernel")], "pack_drain"),
          _sub(port_runs[("ref", "ref")], "pack_drain"), "pack kernel drain")
    assert max(v[0] for k, v in _sub(port_runs[("ref", "ref")],
                                     "pack_drain").items()
               if k.endswith("drain")) > 1


def test_fused_drain_matches_solo_drains(port_runs):
    import torch
    import repro_torch.core as pkg
    got = _sub(port_runs[("kernel", "kernel")], "mux")
    sess = pkg.TrustSession()
    want = drive_pair(defer_pair(pkg, pkg.StackedMesh((2, 4), device="cpu"),
                                 pkg.TrustSession()), sess,
                      torch.as_tensor, False)
    _same(got, want, "fused drain vs solo drains")
    for k, v in got.items():
        if k.endswith("stats"):
            assert v[1] == 0 and v[0] >= 1, (k, v)


def _port_moe(name):
    import torch
    from repro_torch import convert
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.models import moe as tmoe
    t, b, s, shortcut = MOE[name]
    cfg = get_smoke_arch("deepseek-v2-lite-16b")
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **MOE_KW))
    p = convert.model_params_from_jax(_moe_inputs(),
                                      device="cpu")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 16, b, "prefill"),
                    mesh=MeshConfig((1, t), ("data", "model")),
                    remat="none", param_dtype="float32",
                    activation_dtype="float32", local_shortcut=shortcut)
    y, aux = tmoe.moe_block(p, torch.as_tensor(_moe_x(b, s, cfg.d_model)),
                            cfg, run)
    return {"y": y.numpy(), "dropped_frac": aux["moe_dropped_frac"].numpy(),
            "max_load": aux["moe_max_load"].numpy()}


def _moe_compare(got, want, name):
    np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=2e-5,
                               err_msg=name)
    np.testing.assert_allclose(got["dropped_frac"], want["dropped_frac"],
                               rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_array_equal(got["max_load"], want["max_load"])
    assert float(got["dropped_frac"]) > 0, f"{name}: nothing deferred"


def test_moe_defer_matches_jax_one_trustee():
    """T = 1 in process: the deferred rows count as dropped, as JAX's one
    ``delegate`` counts them (tolerances as tests/test_torch_moe.py)."""
    from repro.core import meshctx
    meshctx.set_context(meshctx._default_mesh(), "default")
    _moe_compare(_port_moe("t1"), jax_moe("t1"), "t1")


@pytest.mark.parametrize("name", ["t4_seq", "t4_mask"])
def test_moe_defer_matches_jax_on_4_trustees(jax_runs, name):
    _moe_compare(_port_moe(name), _sub(jax_runs, f"moe_{name}"), name)


def test_serve_drain_rounds_counts_every_token():
    """``--drain-rounds 3`` alone and with ``--session``: the plain serve's
    tokens, the ledger counting every request's generated tokens, the
    drain residual 0 within its 3-round bound."""
    from repro_torch.launch import serve
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "4",
            "--prompt-len", "4", "--gen", "6", "--mesh-model", "4",
            "--device", "cpu"]
    plain = serve.main(argv)
    for extra in (["--drain-rounds", "3"],
                  ["--drain-rounds", "3", "--session"]):
        stats = {}
        np.testing.assert_array_equal(serve.main(argv + extra, stats=stats),
                                      plain)
        assert stats["ledger"].tolist() == [6] * 4, extra
        assert stats["drain"]["residual"] == 0, stats["drain"]
        assert 1 <= stats["drain"]["rounds"] <= 3, stats["drain"]


def test_async_step_with_defer_reads_nothing_back(monkeypatch):
    """``step(sync=False)`` issues a fused and a solo drain without reading
    a device value on the host (``item``, ``tolist``, truth values and
    conversions patched to raise); the stats read afterwards are the
    synchronous step's."""
    import torch
    import repro_torch.core as pkg
    rng = np.random.default_rng(9)
    keys = [torch.as_tensor(rng.integers(0, E_KEYS, E_R).astype(np.int32))
            for _ in range(3)]
    ones = torch.ones((E_R, VW))

    def run(sync):
        sess = pkg.TrustSession()
        mesh = pkg.StackedMesh((2, 4), device="cpu")
        kw = dict(capacity=1, overflow="defer", max_rounds=6,
                  session=sess)
        a = pkg.DelegatedKVStore(mesh, E_KEYS, VW, name="a", **kw)
        b = pkg.DelegatedKVStore(mesh, E_KEYS, VW, name="b", **kw)
        solo = pkg.DelegatedKVStore(mesh, E_KEYS, VW, name="solo",
                                    overflow="defer", max_rounds=6,
                                    capacity=1, local_shortcut=False,
                                    session=sess)
        futs = [a.add_then(keys[0], ones), b.add_then(keys[1], ones),
                solo.add_then(keys[2], ones)]
        if sync:
            sess.step()
        else:
            with monkeypatch.context() as m:
                def refuse(*_a, **_k):
                    raise AssertionError("a host read inside step")
                for name in ("item", "tolist", "__bool__", "__int__",
                             "__float__", "__index__", "numpy"):
                    m.setattr(torch.Tensor, name, refuse)
                assert sess.step(sync=False) is None
        return ([f.result()["value"].numpy() for f in futs],
                sess.last_stats(), [s.dump() for s in (a, b, solo)])

    got, want = run(False), run(True)
    for x, y in zip(got[0] + got[2], want[0] + want[2]):
        np.testing.assert_array_equal(x, y)
    assert got[1] == want[1]
    assert all(d["rounds"] > 1 for d in got[1].values()), got[1]


def test_retry_serve_checks_run_before_round_one_writes(monkeypatch):
    """With the shortcut, round 1's serve takes another shape than the
    retry rounds'; a check that fails only on the retry shape raises
    before round 1 launches, so the table is as it was and the batch
    stays queued."""
    import torch
    import repro_torch.core as pkg
    from repro_torch.kernels import ops as kops
    mesh = pkg.StackedMesh((2, 4), device="cpu")
    with pkg.use_session():
        st = pkg.DelegatedKVStore(mesh, E_KEYS, VW, capacity=1,
                                  overflow="defer", max_rounds=4)
        st.prefill(np.arange(E_KEYS * VW, dtype=np.float32)
                   .reshape(E_KEYS, VW))
        before = st.dump()
        retry_rows = 8 * 1
        real = kops.check

        def check(name, *args, **kw):
            if args[1].shape[1] == retry_rows:
                raise ValueError("retry-shaped check refused")
            return real(name, *args, **kw)
        monkeypatch.setattr(kops, "check", check)
        keys = torch.zeros(64, dtype=torch.int32)
        st.add_then(keys, torch.ones((64, VW)))
        with pytest.raises(ValueError, match="retry-shaped"):
            st.flush()
        assert np.array_equal(st.dump(), before)
        assert len(st.trust._pending) == 1
        monkeypatch.setattr(kops, "check", real)
        st.flush()
        residual = st.trust.last_drain_stats()["residual"]
        assert 0 < residual < 64
        assert st.dump()[0, 0] == before[0, 0] + 64 - residual


def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import repro.core as pkg
    from repro.core import meshctx
    res = run_cases(pkg, jnp.asarray)
    for name in ("t4_seq", "t4_mask"):
        t = MOE[name][0]
        meshctx.set_context(Mesh(np.array(jax.devices()[:t]).reshape(1, t),
                                 ("data", "model")), ("data",))
        res.update({f"moe_{name}/{k}": v for k, v in jax_moe(name).items()})
    np.savez(out_path, **res)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
