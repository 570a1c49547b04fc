"""The multiplexed engine round and the capacity planner of the port
(``core/engine.py``, ``core/channel.py``) against the JAX package.

Pairs of trusts on a 2x4 stacked mesh, after ``tests/_engine_battery.py``:
each round every trust queues one or two op batches and ONE
``session.step()`` serves them all.  On integer-exact payloads the port
is bit-identical to JAX's fused round on a 2x4 mesh of 8 virtual CPU
devices — every response, the per-trust ``residual`` / ``demand_max``
and the final tables — and, where the trust-major layout keeps each
trust's serve order (no overflow; distinct keys under the shortcut), to
the same batches flushed one trust at a time:

  * shared without the shortcut (kv + the inner table of a
    ``FetchRMWStore``), the lane layout;
  * shared with the shortcut (kv + kv2, distinct keys), the lane layout
    with the local tail;
  * the pack kernel (JAX's Pallas pack in interpret mode);
  * mismatched value widths (kv + counters): the masked layout;
  * a PUT-only trust, whose lane stays off the response transpose;
  * ``second_round`` overflow (rows overflow and drop);
  * auto capacity: three fused steps whose planned capacities equal JAX's;
  * ``plan_capacity=True`` over solo rounds.

A step reads 2 block transposes (one request, one response), and the
``CapacityPlanner`` plans, EMAs and quantises as the JAX class does.  The
JAX side runs in one subprocess: this module, run as a script.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import subprocess

import numpy as np
import pytest

N_KEYS, R, N_ROUNDS = 131, 48, 6
WIDTHS = {"kv": 2, "rmw-lock": 2, "kv2": 2, "counters": 1}
# name -> (the pair's stores, store keywords, distinct keys, PUT-only
# second trust, the same batches flushed solo give the same answers)
PAIRS = {
    "shared": (("kv", "rmw-lock"),
               dict(capacity=R, local_shortcut=False, overflow="drop"),
               False, False, True),
    "shortcut": (("kv", "kv2"),
                 dict(capacity=R, local_shortcut=True, overflow="drop"),
                 True, False, True),
    "pack_kernel": (("kv", "rmw-lock"),
                    dict(capacity=R, local_shortcut=False, overflow="drop",
                         pack_impl="kernel"), False, False, True),
    "widths": (("kv", "counters"),
               dict(capacity=R, local_shortcut=False, overflow="drop"),
               False, False, True),
    "put_only": (("kv", "rmw-lock"),
                 dict(capacity=R, local_shortcut=False, overflow="drop"),
                 False, True, True),
    "second_round": (("kv", "rmw-lock"),
                     dict(capacity=3, local_shortcut=False,
                          overflow="second_round", overflow_capacity=3),
                     False, False, False),
    "auto": (("kv", "kv2"), dict(capacity=None, local_shortcut=False),
             False, False, False),
}
AUTO_STEPS = 3


def gen_trace(seed, width, distinct=False, put_only=False,
              n_rounds=N_ROUNDS):
    """Per round one or two op batches of R rows (integer-valued
    payloads); ``distinct`` draws a round's keys without replacement."""
    rng = np.random.default_rng(seed)
    init = rng.integers(1, 8, (N_KEYS, width)).astype(np.float32)
    rounds = []
    for _ in range(n_rounds):
        n_ops = 1 if put_only else int(rng.integers(1, 3))
        ops = ["put"] if put_only else \
            list(rng.choice(["get", "put", "add", "cas"], n_ops,
                            replace=False))
        keys = rng.choice(N_KEYS, n_ops * R, replace=False) if distinct \
            else rng.integers(0, N_KEYS, n_ops * R)
        batch = []
        for i, op in enumerate(ops):
            k = keys[i * R:(i + 1) * R].astype(np.int32)
            v = rng.integers(0, 8, (R, width)).astype(np.float32)
            e = rng.integers(0, 8, (R, width)).astype(np.float32)
            batch.append((str(op), k, v, e))
        rounds.append(batch)
    return init, rounds


def traces(tag):
    names, _kw, distinct, put_only, _seq = PAIRS[tag]
    return [gen_trace(20 + i, WIDTHS[n], distinct, put_only and i == 1,
                      AUTO_STEPS if tag == "auto" else N_ROUNDS)
            for i, n in enumerate(names)]


def _payload(op, k, v, e, conv):
    p = {"key": conv(k)}
    if op != "get":
        p["value"] = conv(v)
    if op == "cas":
        p["expect"] = conv(e)
    return p


def build_pair(pkg, mesh, tag, session, impl="ref"):
    """The pair's two stores; a "rmw-lock" member is the inner table of a
    ``FetchRMWStore`` (its shortcut is always off).  ``impl`` is the
    port's serve (and, unless the pair fixes it, pack) implementation;
    the JAX stores run "ref", with the Pallas pack for "pack_kernel"."""
    names, kw, *_ = PAIRS[tag]
    kw = dict(kw)
    if pkg.__name__ == "repro.core":
        kw["pack_impl"] = "pallas" if kw.get("pack_impl") == "kernel" \
            else "ref"
        kw["serve_impl"] = "ref"
    else:
        kw["pack_impl"] = kw.get("pack_impl", impl)
        kw["serve_impl"] = impl
    out = []
    for name in names:
        if name == "rmw-lock":
            lkw = {k: v for k, v in kw.items() if k != "local_shortcut"}
            out.append(pkg.FetchRMWStore(mesh, N_KEYS, WIDTHS[name],
                                         session=session, **lkw).store)
        else:
            out.append(pkg.DelegatedKVStore(mesh, N_KEYS, WIDTHS[name],
                                            name=name, session=session, **kw))
    return out


def drive(stores, trs, session, conv, fused=True, planner_sig=None):
    """Queue every trust's batches of a round, then one ``session.step()``
    (``fused``) or one flush per trust.  Returns {key: array}."""
    out = {}
    for rnd in range(len(trs[0][1])):
        futs = []
        for tid, (st, (_init, rounds)) in enumerate(zip(stores, trs)):
            for bi, (op, k, v, e) in enumerate(rounds[rnd]):
                futs.append((f"{rnd}/{tid}/{bi}", op, st.trust.submit(
                    op, st.route(conv(k)), _payload(op, k, v, e, conv))))
        if fused:
            session.step()
            stats = session.last_stats()
            out[f"{rnd}/fused"] = np.asarray(
                [len(g) for g in session.last_step_info["fused"]])
            for tid, st in enumerate(stores):
                s = stats[st.trust.name]
                out[f"{rnd}/{tid}/stats"] = np.asarray(
                    [s["rounds"], s["residual"], s["demand_max"]])
            if planner_sig is not None:
                out[f"{rnd}/plan"] = np.asarray(session.planner.plan(
                    ("mux", session._mux_signature(stores[0].trust)), -1))
        else:
            for st in stores:
                st.flush()
        for key, op, fut in futs:
            r = fut.result()
            out[f"{key}/value"] = np.asarray(r["value"])
            if op == "cas":
                out[f"{key}/flag"] = np.asarray(r["flag"])
    for tid, st in enumerate(stores):
        out[f"final/{tid}"] = np.asarray(st.dump())
    return out


def solo_planned(pkg, mesh, session, conv):
    """``plan_capacity=True``: four solo rounds of 96 rows, the planned
    capacity read after each."""
    st = pkg.DelegatedKVStore(mesh, N_KEYS, 2, local_shortcut=False,
                              plan_capacity=True, name="planned",
                              session=session)
    init, rounds = gen_trace(40, 2, n_rounds=4)
    st.prefill(init)
    out = {}
    for rnd, batch in enumerate(rounds):
        futs = [(op, st.trust.submit(op, st.route(conv(k)),
                                     _payload(op, k, v, e, conv)))
                for op, k, v, e in batch]
        st.flush()
        out[f"{rnd}/plan"] = np.asarray(session.planner.plan(
            ("solo", st.trust.token), -1))
        for bi, (op, fut) in enumerate(futs):
            out[f"{rnd}/{bi}/value"] = np.asarray(fut.result()["value"])
    out["final"] = np.asarray(st.dump())
    return out


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def _port_run(tag, impl, fused=True):
    import torch
    import repro_torch.core as pkg
    from repro_torch.core import StackedMesh, TrustSession
    mesh = StackedMesh((2, 4), device="cpu")
    sess = TrustSession()
    stores = build_pair(pkg, mesh, tag, sess, impl)
    trs = traces(tag)
    for st, (init, _r) in zip(stores, trs):
        st.prefill(init)
    return drive(stores, trs, sess, torch.as_tensor, fused,
                 planner_sig=tag == "auto"), sess


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mux") / "runs.npz"
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


def _same(got, want, what, keys=None):
    keys = sorted(want) if keys is None else keys
    assert keys, what
    for k in keys:
        assert k in got, f"{what}: {k} missing"
        assert np.array_equal(got[k], want[k]), \
            f"{what}: {k} differs: {got[k]} vs {want[k]}"


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("tag", list(PAIRS))
def test_fused_round_matches_jax_on_8_devices(jax_runs, tag, impl):
    got, _sess = _port_run(tag, impl)
    want = {k[len(tag) + 1:]: v for k, v in jax_runs.items()
            if k.startswith(tag + "/")}
    _same(got, want, f"{tag} impl={impl} vs JAX")
    assert all((got[f"{r}/fused"] == [2]).all()
               for r in range(len(traces(tag)[0][1])))
    if tag == "second_round":
        # the case sequential solo rounds cannot cover: rows overflowed
        # into the second_round block and rows dropped
        assert sum(int(got[f"{r}/{t}/stats"][1]) for r in range(N_ROUNDS)
                   for t in (0, 1)) > 0


@pytest.mark.parametrize("tag", [t for t in PAIRS if PAIRS[t][4]])
def test_fused_round_matches_solo_rounds(tag):
    got, _ = _port_run(tag, "kernel")
    want, _ = _port_run(tag, "kernel", fused=False)
    _same(got, want, f"{tag} fused vs solo",
          [k for k in want if not k.endswith(("stats", "fused"))])


def test_auto_capacity_plans_equal_jax(jax_runs):
    got, sess = _port_run("auto", "kernel")
    plans = [int(got[f"{r}/plan"]) for r in range(AUTO_STEPS)]
    assert plans == [int(jax_runs[f"auto/{r}/plan"])
                     for r in range(AUTO_STEPS)]
    assert plans[-1] > 0 and plans[-1] & (plans[-1] - 1) == 0, plans


def test_plan_capacity_over_solo_rounds_equals_jax(jax_runs):
    import torch
    import repro_torch.core as pkg
    from repro_torch.core import StackedMesh, TrustSession
    sess = TrustSession()
    got = solo_planned(pkg, StackedMesh((2, 4), device="cpu"), sess,
                       torch.as_tensor)
    want = {k[len("planned/"):]: v for k, v in jax_runs.items()
            if k.startswith("planned/")}
    _same(got, want, "plan_capacity=True vs JAX")
    assert int(got["3/plan"]) > 0


def test_per_trust_stats_and_two_transposes_a_step(jax_runs):
    """The stats keys are JAX's plus the port's ``dropped``; one fused
    step moves one request and one response transpose; a PUT-only lane
    stays off the response transpose; the masked layout has no lanes."""
    import torch
    from repro_torch.core import collect_transposes
    for tag, want in (("shared", ["request", "response"]),
                      ("widths", ["request", "response"]),
                      ("put_only", ["request", "response lanes [0]"])):
        import repro_torch.core as pkg
        sess = pkg.TrustSession()
        stores = build_pair(pkg, pkg.StackedMesh((2, 4), device="cpu"), tag,
                            sess, "kernel")
        trs = traces(tag)
        for st, (init, rounds) in zip(stores, trs):
            st.prefill(init)
            for op, k, v, e in rounds[0]:
                st.trust.submit(op, st.route(torch.as_tensor(k)),
                                _payload(op, k, v, e, torch.as_tensor))
        with collect_transposes() as moves:
            stats = sess.step()
        assert moves == want, (tag, moves)
        assert set(stats) == {st.trust.name for st in stores}
        for d in stats.values():
            assert set(d) == set(jax_runs["stats_keys"]) | {"dropped"}, d
            assert d["rounds"] == 1 and d["impl_fallback"] == 0, d
            assert d["rows_combined"] == 0 and d["req_bytes_saved"] == 0
        if tag == "put_only":
            # the kv lane's flag field and the whole PUT lane stay off the
            # wire: 8 x 2 x 48 rows, one word each, plus the PUT lane's 8 x
            # 48 rows of value words (2 a row)
            assert d["resp_bytes_saved"] == 8 * 2 * R * 4 + 8 * R * 2 * 4


def test_failed_fused_round_restores_every_queue(monkeypatch):
    """A fused round that raises after the first member's serve was built
    writes no table and puts every member's batches back; the retry
    answers as a clean round does."""
    import torch
    from repro_torch.core import kvstore
    got = {}
    for fail in (False, True):
        import repro_torch.core as pkg
        sess = pkg.TrustSession()
        stores = build_pair(pkg, pkg.StackedMesh((2, 4), device="cpu"),
                            "shared", sess, "kernel")
        trs = traces("shared")
        futs = []
        for st, (init, rounds) in zip(stores, trs):
            st.prefill(init)
            for op, k, v, e in rounds[0]:
                futs.append(st.trust.submit(
                    op, st.route(torch.as_tensor(k)),
                    _payload(op, k, v, e, torch.as_tensor)))
        if fail:
            real = kvstore.KVTableServe.serve_kernel
            calls = []

            def second_fails(self, *a, **kw):
                calls.append(1)
                if len(calls) == 2:
                    raise RuntimeError("injected serve failure")
                return real(self, *a, **kw)
            monkeypatch.setattr(kvstore.KVTableServe, "serve_kernel",
                                second_fails)
            before = [st.dump() for st in stores]
            with pytest.raises(RuntimeError, match="injected"):
                sess.step()
            monkeypatch.setattr(kvstore.KVTableServe, "serve_kernel", real)
            assert all(np.array_equal(st.dump(), b)
                       for st, b in zip(stores, before))
            assert all(st.trust._pending for st in stores)
            assert not any(f.ready() for f in futs)
        sess.step()
        got[fail] = [np.asarray(f.result()["value"]) for f in futs] + \
            [st.dump() for st in stores]
    assert all(np.array_equal(a, b) for a, b in zip(got[False], got[True]))


@pytest.mark.parametrize("field,value,extra", [
    ("mode", "dedicated", dict(n_dedicated=3)),
    ("overflow", "defer", dict(capacity=2, max_rounds=16))])
def test_fused_round_runs_dedicated_and_defer(field, value, extra):
    """The fused round's dedicated and defer branches (JAX ``_build_mux``'s)
    run: on per-round distinct keys (order-free under the drain) a round
    of the kv and rmw-lock tables answers as their solo rounds, both
    fused every round; the drain takes more than one round and leaves
    nothing; the client shards stay zero (tests/test_torch_dedicated.py
    and tests/test_torch_drain.py hold both against JAX)."""
    import torch
    import repro_torch.core as pkg
    kw = dict(capacity=R, local_shortcut=False, overflow="drop")
    kw.update({field: value}, **extra)
    runs = {}
    for fused in (True, False):
        sess = pkg.TrustSession()
        mesh = pkg.StackedMesh((2, 4), device="cpu")
        stores = [pkg.DelegatedKVStore(mesh, N_KEYS, 2, name="kv",
                                       session=sess, **kw),
                  pkg.FetchRMWStore(mesh, N_KEYS, 2, session=sess,
                                    **{k: v for k, v in kw.items()
                                       if k != "local_shortcut"}).store]
        trs = [gen_trace(20 + i, 2, distinct=True) for i in range(2)]
        for st, (init, _r) in zip(stores, trs):
            st.prefill(init)
        runs[fused] = drive(stores, trs, sess, torch.as_tensor, fused)
        if field == "mode":
            assert all(not st.client_region().any() for st in stores)
    got, want = runs[True], runs[False]
    _same(got, want, f"{field}={value} fused vs solo",
          [k for k in want if not k.endswith(("stats", "fused"))])
    assert all((got[f"{r}/fused"] == [2]).all() for r in range(N_ROUNDS))
    stats = np.stack([got[f"{r}/{t}/stats"] for r in range(N_ROUNDS)
                      for t in (0, 1)])
    assert not stats[:, 1].any(), stats
    if field == "overflow":
        assert stats[:, 0].max() > 1, stats


def test_capacity_planner_matches_jax_class():
    pytest.importorskip("jax")
    from repro.core.engine import CapacityPlanner as JPlanner
    from repro_torch.core import CapacityPlanner
    import torch
    rng = np.random.default_rng(3)
    for alpha, headroom, floor in ((0.5, 1.5, 4), (0.25, 2.0, 1),
                                   (0.9, 1.0, 8)):
        a, b = JPlanner(alpha, headroom, floor), \
            CapacityPlanner(alpha, headroom, floor)
        assert a.plan("s", 7) == b.plan("s", 7) == 7
        for _ in range(12):
            d = int(rng.integers(0, 300))
            a.observe("s", np.asarray([d], np.int32))
            b.observe("s", torch.tensor(d))
            if rng.random() < 0.7:
                assert a.plan("s", -1) == b.plan("s", -1)
                assert a.ema("s") == b.ema("s")
        a.prune([])
        b.prune([])
        assert b.ema("s") is None and b.plan("s", 5) == 5


def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import repro.core as pkg
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    res = {}
    for tag in PAIRS:
        sess = pkg.TrustSession()
        stores = build_pair(pkg, mesh, tag, sess)
        trs = traces(tag)
        for st, (init, _r) in zip(stores, trs):
            st.prefill(init)
        out = drive(stores, trs, sess, jnp.asarray,
                    planner_sig=tag == "auto")
        res.update({f"{tag}/{k}": v for k, v in out.items()})
        if tag == "shared":
            res["stats_keys"] = np.asarray(sorted(
                sess.last_stats()[stores[0].trust.name]))
    sess = pkg.TrustSession()
    out = solo_planned(pkg, mesh, sess, jnp.asarray)
    res.update({f"planned/{k}": v for k, v in out.items()})
    np.savez(out_path, **res)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
