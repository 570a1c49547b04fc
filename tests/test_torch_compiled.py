"""Captured programs (``repro_torch/core/compiled.py``): the engine's
compiled-program cache against JAX's, and the CPU stand-in's plumbing.

  (a) one sequence of submissions through JAX's ``DelegationEngine`` (2x4
      mesh of 8 virtual CPU devices) and the port's (2x4 stacked mesh):
      a solo trust at two batch sizes, a ``plan_capacity`` trust whose
      planned capacity changes its round, a fused pair, a dead trust
      pruned and a ``re_entrust`` onto 7 survivors.  After each step
      ``len(_cache)`` and the misses (calls of ``_build_solo`` /
      ``_build_mux``) equal JAX's; the port's keys add the state's
      addresses and the device;
  (b) the CPU stand-in: three decode steps' tokens are distinct tensors
      equal to the eager path's; a round leaves the state's addresses as
      they were (the plain serve's new leaf copied back); a restore then a
      round equals eager; each round's stats and the planner's staged
      demand are tensors of their own;
  (c) ``disable()`` caches nothing;
  (d) a kernel check entered inside a captured call raises.

The JAX side runs in one subprocess: this module, run as a script.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import gc
import json
import subprocess

import numpy as np
import pytest

N_KEYS, W = 96, 2


def _batch(seed, r):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_KEYS, r).astype(np.int32),
            rng.integers(0, 8, (r, W)).astype(np.float32))


def cache_sequence(pkg, engine_mod, mesh, conv):
    """The submissions of (a); returns [(step, len(_cache), misses)]."""
    builds = {"n": 0}
    for name in ("_build_solo", "_build_mux"):
        real = getattr(engine_mod, name)

        def counted(*a, _real=real, **kw):
            builds["n"] += 1
            return _real(*a, **kw)
        setattr(engine_mod, name, counted)
    sess = pkg.TrustSession()
    init = np.random.default_rng(1).integers(0, 8, (N_KEYS, W)) \
        .astype(np.float32)
    kw = dict(local_shortcut=False, session=sess)
    a = pkg.DelegatedKVStore(mesh, N_KEYS, W, capacity=16, name="a", **kw)
    p = pkg.DelegatedKVStore(mesh, N_KEYS, W, plan_capacity=True, name="p",
                             **kw)
    b = pkg.DelegatedKVStore(mesh, N_KEYS, W, capacity=16, name="b", **kw)
    c = pkg.DelegatedKVStore(mesh, N_KEYS, W, capacity=16, name="c", **kw)
    for st in (a, p, b, c):
        st.prefill(init)
    del st
    log = []

    def put(st, seed, r):
        k, v = _batch(seed, r)
        st.trust.submit("put", st.route(conv(k)),
                        {"key": conv(k), "value": conv(v)})

    def mark(step):
        log.append((step, len(sess._cache), builds["n"]))

    put(a, 1, 64)
    a.flush()
    mark("solo 64")
    put(a, 2, 64)
    a.flush()
    mark("solo 64 again")
    put(a, 3, 96)
    a.flush()
    mark("solo 96")
    for i in range(3):
        # the skewed keys' demand plans a capacity unlike the fallback's
        k = np.full(64, 8 * i, np.int32)
        p.trust.submit("get", p.route(conv(k)), {"key": conv(k)})
        p.flush()
        mark(f"planned {i}")
    for i in range(2):
        put(b, 10 + i, 64)
        put(c, 20 + i, 64)
        sess.step()
        mark(f"fused {i}")
    del c
    gc.collect()
    put(a, 4, 64)
    sess.step()
    mark("dead trust pruned")
    sess.re_entrust([3])
    mark("re_entrust")
    put(a, 5, 63)
    a.flush()
    mark("solo on 7 survivors")
    return log


def _port_sequence():
    import torch
    import repro_torch.core as pkg
    from repro_torch.core import engine
    real = (engine._build_solo, engine._build_mux)
    try:
        return cache_sequence(pkg, engine,
                              pkg.StackedMesh((2, 4), device="cpu"),
                              torch.as_tensor)
    finally:
        engine._build_solo, engine._build_mux = real


@pytest.fixture(scope="module")
def jax_log(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_compiled") / "log.json"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([src,
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return [tuple(x) for x in json.load(f)]


def test_cache_entries_and_misses_equal_jax(jax_log):
    got = _port_sequence()
    assert got == jax_log
    steps = dict((s, (n, m)) for s, n, m in got)
    # the sequence holds every event it names: a hit, a planner-sized
    # capacity change, a fused program, a prune and an eviction
    assert steps["solo 64 again"] == steps["solo 64"]
    assert steps["planned 2"][1] > steps["planned 0"][1]
    assert steps["fused 1"][1] == steps["fused 0"][1]
    assert steps["dead trust pruned"][0] < steps["fused 1"][0]
    assert steps["re_entrust"][0] == 0
    assert 4 <= got[-1][2] <= 8


def test_port_keys_add_addresses_and_device():
    import torch
    import repro_torch.core as pkg
    sess = pkg.TrustSession()
    st = pkg.DelegatedKVStore(pkg.StackedMesh((2, 4), device="cpu"), N_KEYS,
                              W, capacity=16, local_shortcut=False,
                              session=sess)
    k, v = _batch(0, 64)
    st.put(torch.as_tensor(k), torch.as_tensor(v))
    (key,) = sess._cache
    assert key[0] == "solo" and key[1] == (st.trust.token,)
    from repro_torch.core import compiled
    assert key[-2] == compiled.addresses(st.trust._state)
    assert key[-1] == "cpu"
    # a rebinding other than by a round evicts the trust's rounds
    st.prefill(np.zeros((N_KEYS, W), np.float32))
    assert not sess._cache


# ---------------------------------------------------------------------------
# (b)-(d): the stand-in
# ---------------------------------------------------------------------------

def _decode_plan():
    import torch
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    cfg = get_smoke_arch("qwen2.5-3b")
    shape = ShapeConfig("d", 8, 2, "decode")
    run = RunConfig(model=cfg, shape=shape,
                    mesh=MeshConfig((1, 2), ("data", "model")),
                    remat="none", use_pallas=True)
    plan = build_cell(cfg, shape, run)
    params = M.init_params(cfg, run, "cpu")
    return plan, params, lambda: M.init_cache(cfg, 2, 8, run, "cpu"), cfg


def _decode(plan, params, cache, cfg, steps=3):
    import torch
    out = []
    tok = torch.tensor([3, 5], dtype=torch.int32)
    for i in range(steps):
        tok, cache = plan.step_fn(params, cache, tok,
                                  torch.full((2,), i, dtype=torch.int32))
        out.append(tok)
    return out, cache


def test_stand_in_decode_tokens_are_fresh_and_equal_eager():
    import torch
    from repro_torch.core import compiled
    plan, params, new_cache, cfg = _decode_plan()
    cache = new_cache()
    ptrs = compiled.addresses(cache)
    got, cache2 = _decode(plan, params, cache, cfg)
    assert cache2 is cache and compiled.addresses(cache) == ptrs
    assert len({t.data_ptr() for t in got}) == 3
    with compiled.disable():
        want, _ = _decode(plan, params, new_cache(), cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    (prog,) = plan.step_fn.__wrapped__.programs.values()
    assert prog.replays == 3


def _kv_store(sess, impl="ref", **kw):
    import repro_torch.core as pkg
    st = pkg.DelegatedKVStore(pkg.StackedMesh((2, 4), device="cpu"), N_KEYS,
                              W, capacity=16, serve_impl=impl,
                              pack_impl=impl, session=sess, **kw)
    st.prefill(np.random.default_rng(1).integers(0, 8, (N_KEYS, W))
               .astype(np.float32))
    return st


def _mixed_round(st, seed):
    import torch
    rng = np.random.default_rng(seed)
    T = torch.as_tensor
    k = [rng.integers(0, N_KEYS, 48).astype(np.int32) for _ in range(3)]
    v = [rng.integers(0, 8, (48, W)).astype(np.float32) for _ in range(3)]
    futs = [st.get_then(T(k[0])), st.add_then(T(k[1]), T(v[1]))]
    st.put_then(T(k[2]), T(v[2]))
    return futs


def test_stand_in_round_keeps_the_state_addresses():
    """The plain serve builds a new table (``padded[:, :n_local]``); the
    captured round copies it back, so the state keeps its addresses and
    dict, and answers as the eager round."""
    import torch
    import repro_torch.core as pkg
    from repro_torch.core import compiled
    res = {}
    for eager in (False, True):
        sess = pkg.TrustSession()
        st = _kv_store(sess)
        state = st.trust._state
        ptrs = compiled.addresses(state)
        got = []
        with (compiled.disable() if eager else _null()):
            for seed in range(3):
                futs = _mixed_round(st, seed)
                sess.step()
                got += [f.result()["value"] for f in futs]
        if not eager:
            assert st.trust._state is state
            assert compiled.addresses(st.trust._state) == ptrs
            assert len(sess._cache) == 1
        res[eager] = got + [torch.as_tensor(st.dump())]
    assert all(torch.equal(a, b) for a, b in zip(res[False], res[True]))


def _null():
    import contextlib
    return contextlib.nullcontext()


def test_stand_in_restore_then_round_equals_eager(tmp_path):
    import torch
    import repro_torch.core as pkg
    from repro_torch.core import compiled
    res = {}
    for eager in (False, True):
        sess = pkg.TrustSession()
        st = _kv_store(sess, impl="kernel")
        with (compiled.disable() if eager else _null()):
            _mixed_round(st, 0)
            sess.step()
            sess.checkpoint(str(tmp_path / f"ck{eager}"))
            _mixed_round(st, 1)
            sess.step()
            n_before = len(sess._cache)
            sess.restore(str(tmp_path / f"ck{eager}"))
            if not eager:
                assert n_before == 1 and len(sess._cache) == 0
            futs = _mixed_round(st, 2)
            sess.step()
        res[eager] = [f.result()["value"] for f in futs] + \
            [torch.as_tensor(st.dump())]
    assert all(torch.equal(a, b) for a, b in zip(res[False], res[True]))


def test_stand_in_stats_and_staged_demand_are_fresh_each_round():
    import repro_torch.core as pkg
    sess = pkg.TrustSession()
    st = _kv_store(sess, impl="kernel", plan_capacity=False)
    seen, staged = [], []
    for seed in range(3):
        _mixed_round(st, seed)
        sess.step(sync=False)
        s = sess._last_step_stats[st.trust.name]
        seen.append({k: v for k, v in s.items() if hasattr(v, "data_ptr")})
        staged.append(sess.planner._staged[("solo", st.trust.token)])
    values = [{k: int(v) for k, v in d.items()} for d in seen]
    for key in seen[0]:
        assert len({d[key].data_ptr() for d in seen}) == 3, key
    assert len({t.data_ptr() for t in staged}) == 3
    # what an earlier round handed out is not overwritten by later rounds
    assert values == [{k: int(v) for k, v in d.items()} for d in seen]


def test_disable_caches_nothing():
    import repro_torch.core as pkg
    from repro_torch.core import compiled
    sess = pkg.TrustSession()
    st = _kv_store(sess, impl="kernel")
    plan, params, new_cache, cfg = _decode_plan()
    with compiled.disable():
        assert not compiled.enabled()
        for seed in range(2):
            _mixed_round(st, seed)
            sess.step()
        _decode(plan, params, new_cache(), cfg)
    assert compiled.enabled()
    assert len(sess._cache) == 0
    assert not plan.step_fn.__wrapped__.programs


def test_check_context_inside_a_captured_call_raises():
    """A kernel check compares on the host: entered inside a captured call
    it raises (it never runs the call eagerly); entered outside, the
    call runs eagerly under it and nothing is cached."""
    import torch
    from repro_torch.core import compiled
    from repro_torch.testing.model import FlashCheck, GmmCheck

    def fn(state, _fixed, x):
        with FlashCheck():
            return state, x + 1
    prog = compiled.Program(fn, "checked step")
    with pytest.raises(compiled.CaptureError, match="FlashCheck"):
        prog({}, None, torch.zeros(3))
    with pytest.raises(compiled.CaptureError, match="host"):
        compiled.Program(lambda s, f, x: (s, compiled.forbid_host_read(
            "a probe")), "probe")({}, None, torch.zeros(1))
    plan, params, new_cache, cfg = _decode_plan()
    with GmmCheck():
        assert not compiled.enabled()
        _decode(plan, params, new_cache(), cfg)
    assert not plan.step_fn.__wrapped__.programs


def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import repro.core as pkg
    from repro.core import engine
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    log = cache_sequence(pkg, engine, mesh, jnp.asarray)
    with open(out_path, "w") as f:
        json.dump(log, f)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
