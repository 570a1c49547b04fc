"""Trustee failover in the port (``TrustSession.checkpoint`` / ``restore``
/ ``re_entrust``, ``EngineFailureInjector``, ``StreamingDriver.recover``)
against the JAX package on 8 virtual CPU devices (one subprocess: this
module, run as a script), bit for bit on integer-exact payloads.

Every check of ``tests/_failover_battery.py`` runs on both packages
through the same driver code below, and the port's acknowledged history,
final tables and recovery counters must equal JAX's:

  * a trustee shard killed mid-trace (shared, shortcut at a snapshot
    boundary, dedicated, a kill three waves past the snapshot), the state
    re-entrusted onto 7 stacked survivors from the last snapshot and the
    waves since it replayed — each replayed ack equal to the original,
    the whole history equal to the sequential oracle served in order at
    each wave's device count;
  * a two-trust snapshot on the 2x4 mesh restored on the 1x8 mesh;
  * drop and tear: the round ran, nothing committed, the retry serves;
  * the quiesce guard, the schema-fingerprint guard, the streaming
    driver's checkpoint / recover;

and beyond the battery: a JAX session snapshot restored into the port
(on the 2x4 mesh, and on 7 shards through ``kv_reshard`` /
``pagetable_reshard``), the dead shard's slot overwritten with garbage
before ``re_entrust`` (the same result: nothing reads it), an
administrative ``re_entrust(ckpt_dir=None)`` from the live state, and
``_paged_battery.py``'s chaos check (the page table killed at a snapshot
boundary, the oracle resharded the same way).

The in-process checks are ``tests/test_failover.py``'s single-device ones
and the host logic of ``runtime/fault_tolerance.py`` against JAX's.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import shutil
import subprocess
import tempfile
import types

import numpy as np
import pytest

N_KEYS = 37          # prime: owner-shard padding and reshard padding
VW = 2
R = 56               # divisible by 8 and 7: serve order survives 8 -> 7
N_WAVES = 20
SNAP_EVERY = 4
OPS = ("get", "put", "add", "cas")

# name: (store knobs, shortcut, kill wave, kill shard, seed, replay exact)
CHAOS = {
    "chaos_shared": ({"local_shortcut": False}, False, 9, 3, 60, True),
    "chaos_shortcut": ({"local_shortcut": True}, True, 8, 3, 61, False),
    "chaos_dedicated": ({"mode": "dedicated", "n_dedicated": 3}, False, 9,
                        6, 62, True),
    "chaos_offset": ({"local_shortcut": False}, False, 11, 5, 63, True),
}


# ---------------------------------------------------------------------------
# the two packages behind one face
# ---------------------------------------------------------------------------

def jax_pkg():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import repro.core as core
    import repro.runtime as runtime
    from repro.launch import streaming
    devs = np.array(jax.devices())
    return types.SimpleNamespace(
        name="jax", core=core, runtime=runtime, streaming=streaming,
        conv=jnp.asarray,
        mesh=lambda shape: Mesh(devs[:int(np.prod(shape))].reshape(shape),
                                ("data", "model")))


def port_pkg():
    import torch
    import repro_torch.core as core
    import repro_torch.runtime as runtime
    from repro_torch.launch import streaming
    return types.SimpleNamespace(
        name="port", core=core, runtime=runtime, streaming=streaming,
        conv=torch.as_tensor,
        mesh=lambda shape: core.StackedMesh(shape, device="cpu"))


def gen_trace(pkg, seed):
    """``_failover_battery.gen_trace``: one op a wave, integer-valued
    rows, CAS expects hitting a request-order replay about half the time."""
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    sim = pkg.core.SequentialKVReference(N_KEYS, VW)
    sim.prefill(init)
    waves = []
    for _ in range(N_WAVES):
        op = OPS[int(rng.integers(0, 4))]
        keys = rng.integers(0, N_KEYS, R).astype(np.int32)
        vals = rng.integers(0, 8, (R, VW)).astype(np.float32)
        expect = None
        if op == "cas":
            live = sim.table[keys].copy()
            rand = rng.integers(0, 8, (R, VW)).astype(np.float32)
            expect = np.where(rng.random(R)[:, None] < 0.5, live, rand)
        if op == "get":
            sim.get(keys)
        elif op == "put":
            sim.put(keys, vals)
        elif op == "add":
            sim.add(keys, vals)
        else:
            sim.cas(keys, expect, vals)
        waves.append((op, keys, vals, expect))
    return init, waves


def serve_perm(keys, n_dev, shortcut):
    """A wave's serve order: request order without the shortcut; with it
    each trustee's channel rows first, its self-addressed rows last (a
    permutation that depends on the device count)."""
    if not shortcut:
        return np.arange(len(keys))
    client = np.arange(len(keys)) // (len(keys) // n_dev)
    local = (keys % n_dev) == client
    return np.concatenate([np.where(~local)[0], np.where(local)[0]])


def ref_wave(ref, wave, n_dev, shortcut):
    op, keys, vals, expect = wave
    perm = serve_perm(keys, n_dev, shortcut)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    if op == "get":
        return {"value": ref.get(keys[perm])[inv]}
    if op == "put":
        ref.put(keys[perm], vals[perm])
        return {}
    if op == "add":
        return {"value": ref.add(keys[perm], vals[perm])[inv]}
    fl, old = ref.cas(keys[perm], expect[perm], vals[perm])
    return {"flag": fl[inv], "value": old[inv]}


def submit(pkg, store, wave):
    op, keys, vals, expect = wave
    k = pkg.conv(keys)
    if op == "get":
        return store.get_then(k)
    if op == "put":
        return store.put_then(k, pkg.conv(vals))
    if op == "add":
        return store.add_then(k, pkg.conv(vals))
    return store.cas_then(k, pkg.conv(expect), pkg.conv(vals))


def ack(op, fut):
    """The acknowledged response (the fulfilled future), as numpy."""
    if op == "put":
        return {}
    r = fut.result()
    out = {"value": np.asarray(r["value"])}
    if op == "cas":
        out["flag"] = np.asarray(r["flag"])
    return out


def store_wave(pkg, store, sess, wave):
    fut = submit(pkg, store, wave)
    sess.step()
    return ack(wave[0], fut)


def same(a, b, what):
    assert set(a) == set(b), f"{what}: fields {sorted(a)} vs {sorted(b)}"
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{what}: {k} differs"


def history(acked):
    out = {}
    for i, (resp, n_dev) in acked.items():
        out[f"w{i}/n_dev"] = np.asarray(n_dev)
        out.update({f"w{i}/{k}": v for k, v in resp.items()})
    return out


# ---------------------------------------------------------------------------
# the battery's checks, on either package
# ---------------------------------------------------------------------------

def run_chaos(pkg, mode_kw, shortcut, kill_wave, kill_shard, seed,
              replay_exact, poison=False):
    """Kill ``kill_shard`` at engine wave ``kill_wave``, re-entrust onto
    the survivors from the last snapshot, replay the waves since it,
    finish the trace; the whole acknowledged history must equal the
    oracle served at each wave's device count.  ``poison`` overwrites the
    dead shard's slot of the live state with garbage first."""
    core = pkg.core
    mesh = pkg.mesh((2, 4))
    init, waves = gen_trace(pkg, seed)
    ckdir = tempfile.mkdtemp(prefix="failover_")
    try:
        with core.use_session(core.TrustSession()) as sess, \
                core.use_mesh(mesh):
            store = core.DelegatedKVStore(mesh, N_KEYS, VW, capacity=R,
                                          name="kv", **mode_kw)
            store.prefill(init)
            sess.install_injector(pkg.runtime.EngineFailureInjector(
                schedule={kill_wave: ("kill", kill_shard)}))
            sess.checkpoint(ckdir)
            snapshot_wave, acked, failures, replays, w = 0, {}, 0, 0, 0
            while w < len(waves):
                try:
                    resp = store_wave(pkg, store, sess, waves[w])
                except pkg.runtime.TrusteeFailure as e:
                    failures += 1
                    assert e.kind == "kill" and e.shard == kill_shard
                    assert e.wave_id == kill_wave, (e.wave_id, kill_wave)
                    assert e.last_snapshot_step is not None
                    assert "kv" in e.trusts
                    if poison:
                        st = store.trust.state()["table"]
                        st[kill_shard].fill_(float("nan"))
                    sess.re_entrust([e.shard], ckpt_dir=ckdir)
                    replays += w - snapshot_wave
                    with sess.replaying():
                        for rw in range(snapshot_wave, w):
                            r2 = store_wave(pkg, store, sess, waves[rw])
                            if replay_exact:
                                same(r2, acked[rw][0], f"replay {rw}")
                            acked[rw] = (r2, store.group.axis_size)
                    continue
                acked[w] = (resp, store.group.axis_size)
                w += 1
                if w % SNAP_EVERY == 0:
                    sess.checkpoint(ckdir)
                    snapshot_wave = w
            assert failures == 1, f"injector fired {failures}x"
            assert store.group.axis_size == 7
            if store.mode != "dedicated":
                assert store.t == 7, f"T did not shrink ({store.t})"
            ref = core.SequentialKVReference(N_KEYS, VW)
            ref.prefill(init)
            for i in range(len(waves)):
                resp, n_dev = acked[i]
                same(resp, ref_wave(ref, waves[i], n_dev, shortcut),
                     f"wave {i} vs the oracle")
            table = np.asarray(store.dump())
            assert np.array_equal(table, ref.dump()), "final table"
            rec = sess.last_stats()["recovery"]
            assert rec["restores"] >= 1 and rec["recovery_ms"] > 0
            assert rec["replayed_rounds"] == replays, (rec, replays)
            out = history(acked)
            out.update(table=table, replayed=np.asarray(replays),
                       restores=np.asarray(rec["restores"]),
                       replayed_rounds=np.asarray(rec["replayed_rounds"]),
                       t=np.asarray(store.t))
            if store.mode == "dedicated":
                region = np.asarray(store.client_region())
                assert region.size and not region.any(), "client region"
            return out
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def run_elastic(pkg):
    """A two-trust session snapshots on the 2x4 mesh and restores into a
    fresh session on the 1x8 mesh: states and post-restore GETs equal."""
    core = pkg.core
    rng = np.random.default_rng(70)
    init_a = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    init_b = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    keys = rng.integers(0, N_KEYS, R).astype(np.int32)
    vals = rng.integers(0, 8, (R, VW)).astype(np.float32)
    k2 = rng.integers(0, N_KEYS, R).astype(np.int32)
    ckdir = tempfile.mkdtemp(prefix="elastic_")
    kw = dict(capacity=R, local_shortcut=False)
    try:
        mesh_a = pkg.mesh((2, 4))
        with core.use_session(core.TrustSession()) as s1, \
                core.use_mesh(mesh_a):
            a = core.DelegatedKVStore(mesh_a, N_KEYS, VW, name="a", **kw)
            b = core.DelegatedKVStore(mesh_a, N_KEYS, VW, name="b", **kw)
            a.prefill(init_a)
            b.prefill(init_b)
            a.add_then(pkg.conv(keys), pkg.conv(vals))
            b.put_then(pkg.conv(keys), pkg.conv(vals))
            s1.step()
            step = s1.checkpoint(ckdir)
            want_a, want_b = np.asarray(a.dump()), np.asarray(b.dump())
        mesh_b = pkg.mesh((1, 8))
        with core.use_session(core.TrustSession()) as s2, \
                core.use_mesh(mesh_b):
            a2 = core.DelegatedKVStore(mesh_b, N_KEYS, VW, name="a", **kw)
            b2 = core.DelegatedKVStore(mesh_b, N_KEYS, VW, name="b", **kw)
            got_step = s2.restore(ckdir)
            assert got_step == step
            got_a, got_b = np.asarray(a2.dump()), np.asarray(b2.dump())
            assert np.array_equal(got_a, want_a)
            assert np.array_equal(got_b, want_b)
            get = np.asarray(a2.get(pkg.conv(k2)))
            assert np.array_equal(get, want_a[k2])
        return {"a": got_a, "b": got_b, "get": get,
                "step": np.asarray(got_step)}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def run_drop_tear(pkg):
    """drop / tear fire after the round ran and before it commits: the
    table unchanged, the future open, the queue kept; the retry serves."""
    core = pkg.core
    mesh = pkg.mesh((2, 4))
    rng = np.random.default_rng(71)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    keys = rng.integers(0, N_KEYS, R).astype(np.int32)
    vals = rng.integers(0, 8, (R, VW)).astype(np.float32)
    ref = core.SequentialKVReference(N_KEYS, VW)
    ref.prefill(init)
    want = ref.add(keys, vals)
    out = {}
    for kind in ("drop", "tear"):
        with core.use_session(core.TrustSession()) as sess, \
                core.use_mesh(mesh):
            store = core.DelegatedKVStore(mesh, N_KEYS, VW, capacity=R,
                                          name="kv", local_shortcut=False)
            store.prefill(init)
            sess.install_injector(pkg.runtime.EngineFailureInjector(
                schedule={0: (kind, 2)}))
            fut = store.add_then(pkg.conv(keys), pkg.conv(vals))
            with pytest.raises(pkg.runtime.TrusteeFailure) as ei:
                sess.step()
            assert ei.value.kind == kind and ei.value.wave_id == 0
            after = np.asarray(store.dump())
            assert np.array_equal(after, init), f"{kind}: state committed"
            assert not fut.ready() and store.trust._pending
            sess.step()
            got = np.asarray(fut.result()["value"])
            assert np.array_equal(got, want), f"{kind}: retry response"
            out.update({f"{kind}/after_failure": after, f"{kind}/retry": got,
                        f"{kind}/table": np.asarray(store.dump())})
    return out


def run_guards(pkg):
    """The quiesce guard and the schema-fingerprint guard."""
    core = pkg.core
    mesh = pkg.mesh((2, 4))
    ckdir = tempfile.mkdtemp(prefix="guards_")
    kw = dict(capacity=R, name="kv", local_shortcut=False)
    try:
        with core.use_session(core.TrustSession()) as sess, \
                core.use_mesh(mesh):
            store = core.DelegatedKVStore(mesh, N_KEYS, VW, **kw)
            store.add_then(pkg.conv(np.zeros(R, np.int32)),
                           pkg.conv(np.ones((R, VW), np.float32)))
            with pytest.raises(RuntimeError, match="quiesced.*kv"):
                sess.checkpoint(ckdir)
            sess.step()
            sess.checkpoint(ckdir)
        with core.use_session(core.TrustSession()) as s2, \
                core.use_mesh(mesh):
            core.DelegatedKVStore(mesh, N_KEYS, VW + 1, **kw)
            with pytest.raises(ValueError, match="fingerprint") as ei:
                s2.restore(ckdir)
            assert "kv" in str(ei.value)
        return {"ok": np.asarray(1)}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def run_streaming(pkg):
    """StreamingDriver: checkpoint() quiesces first; a kill raised out of
    dispatch() recovers through recover(); the replayed stream's history
    equals the oracle."""
    core = pkg.core
    mesh = pkg.mesh((2, 4))
    init, waves = gen_trace(pkg, 80)
    ckdir = tempfile.mkdtemp(prefix="stream_")
    try:
        with core.use_session(core.TrustSession()) as sess, \
                core.use_mesh(mesh):
            store = core.DelegatedKVStore(mesh, N_KEYS, VW, capacity=R,
                                          name="kv", local_shortcut=False)
            store.prefill(init)
            driver = pkg.streaming.StreamingDriver(sess, depth=1)
            sess.install_injector(pkg.runtime.EngineFailureInjector(
                schedule={9: ("kill", 5)}))
            driver.checkpoint(ckdir)
            snapshot_wave, acked, w = 0, {}, 0
            while w < len(waves):
                fut = submit(pkg, store, waves[w])
                try:
                    driver.dispatch(outputs=fut, rows=R)
                except pkg.runtime.TrusteeFailure as e:
                    snap = driver.recover(e, ckdir)
                    assert snap == e.last_snapshot_step
                    assert driver.inflight == 0
                    with sess.replaying():
                        for rw in range(snapshot_wave, w):
                            r2 = store_wave(pkg, store, sess, waves[rw])
                            same(r2, acked[rw][0], f"stream replay {rw}")
                    continue
                driver.drain()
                acked[w] = (ack(waves[w][0], fut), 8)
                w += 1
                if w % SNAP_EVERY == 0:
                    driver.checkpoint(ckdir)
                    snapshot_wave = w
            ref = core.SequentialKVReference(N_KEYS, VW)
            ref.prefill(init)
            for i in range(len(waves)):
                same(acked[i][0], ref_wave(ref, waves[i], 8, False),
                     f"stream wave {i}")
            table = np.asarray(store.dump())
            assert np.array_equal(table, ref.dump())
            rec = sess.last_stats()["recovery"]
            out = history(acked)
            out.update(table=table, restores=np.asarray(rec["restores"]),
                       replayed_rounds=np.asarray(rec["replayed_rounds"]))
            return out
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def run_live_reentrust(pkg):
    """An administrative re-shard: ``re_entrust([2], ckpt_dir=None)`` moves
    the live state onto 7 shards between waves; the trace goes on."""
    core = pkg.core
    mesh = pkg.mesh((2, 4))
    init, waves = gen_trace(pkg, 64)
    with core.use_session(core.TrustSession()) as sess, core.use_mesh(mesh):
        store = core.DelegatedKVStore(mesh, N_KEYS, VW, capacity=R,
                                      name="kv", local_shortcut=False)
        store.prefill(init)
        acked = {}
        for w, wave in enumerate(waves):
            if w == 7:
                sess.re_entrust([2])
                assert store.t == 7 and store.group.axis_size == 7
            acked[w] = (store_wave(pkg, store, sess, wave),
                        store.group.axis_size)
        ref = core.SequentialKVReference(N_KEYS, VW)
        ref.prefill(init)
        for i, wave in enumerate(waves):
            same(acked[i][0], ref_wave(ref, wave, acked[i][1], False),
                 f"live wave {i}")
        out = history(acked)
        out["table"] = np.asarray(store.dump())
        out["restores"] = np.asarray(sess.last_stats()["recovery"]
                                     ["restores"])
        return out


# -- the page table: _paged_battery.py's chaos check ------------------------

PT = dict(max_seqs=64, n_pages=128, page_size=4, max_pages=4)


def gen_paged_trace(seed, n_waves=N_WAVES):
    """``_paged_battery.gen_trace``'s decode-shaped op mix."""
    from repro_torch.testing.failover import paged_waves
    return paged_waves(seed, R, n_waves, PT["max_seqs"], PT["max_pages"],
                       PT["page_size"])


def table_wave(pt, sess, wave):
    from repro_torch.testing.failover import table_wave as wave_of
    return wave_of(pt, sess, wave)


def run_paged_chaos(pkg):
    """Kill trustee shard 3 at a snapshot boundary, re-entrust onto the 7
    survivors, reshard the oracle with the same re-layout: every later ack
    equals the oracle's, the audit stays consistent, no page leaks."""
    core = pkg.core
    mesh = pkg.mesh((2, 4))
    waves = gen_paged_trace(94)
    kill_wave = SNAP_EVERY * 2
    ckdir = tempfile.mkdtemp(prefix="paged_chaos_")
    try:
        with core.use_session(core.TrustSession()) as sess, \
                core.use_mesh(mesh):
            pt = core.DelegatedPageTable(
                mesh, PT["n_pages"], max_seqs=PT["max_seqs"],
                page_size=PT["page_size"], max_pages=PT["max_pages"],
                capacity=R, local_shortcut=False)
            oracle = core.SequentialPageTable(
                PT["n_pages"], PT["max_seqs"], PT["page_size"],
                PT["max_pages"], pt.t)
            sess.install_injector(pkg.runtime.EngineFailureInjector(
                schedule={kill_wave: ("kill", 3)}))
            sess.checkpoint(ckdir)
            out, failures, w = {}, 0, 0
            while w < len(waves):
                try:
                    got = table_wave(pt, sess, waves[w])
                except pkg.runtime.TrusteeFailure as e:
                    failures += 1
                    assert e.kind == "kill" and "pagetable" in e.trusts
                    if waves[w][0] == "free":
                        pt._known.update(int(s) for s in waves[w][1])
                    sess.re_entrust([e.shard], ckpt_dir=ckdir)
                    assert pt.t == 7
                    oracle.reshard(7)
                    assert pt.audit()["consistent"]
                    continue
                op, seqs, extra = waves[w]
                want = getattr(oracle, op)(*((seqs, extra) if extra
                                             is not None else (seqs,)))
                for f in got:
                    assert np.array_equal(got[f], want[f]), (w, op, f)
                    out[f"w{w}/{f}"] = got[f]
                w += 1
                if w % SNAP_EVERY == 0 and w <= kill_wave:
                    sess.checkpoint(ckdir)
            assert failures == 1
            st_got, st_want = pt.dump(), oracle.dump()
            for k in st_want:
                assert np.array_equal(np.asarray(st_got[k]), st_want[k]), k
                out[f"state/{k}"] = np.asarray(st_got[k])
            aud = pt.audit()
            assert aud["consistent"] and aud["leaked"] == 0, aud
            live = sorted(pt._known)
            while live:
                batch, live = live[:R], live[R:]
                table_wave(pt, sess, ("free", np.array(batch, np.int32),
                                      None))
            assert pt.audit()["allocated"] == 0, "leaked pages at the end"
            out["audit"] = np.asarray([aud["allocated"], aud["evictions"],
                                       aud["free"], aud["phantom"]])
            return out
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


# -- a snapshot carried from JAX into the port -------------------------------

SNAP_WAVES = 6


def snapshot_session(pkg, ckdir):
    """A KV store and a page table on the 2x4 mesh, a few waves, then one
    session snapshot; returns their dumps at the snapshot."""
    core = pkg.core
    mesh = pkg.mesh((2, 4))
    init, waves = gen_trace(pkg, 66)
    with core.use_session(core.TrustSession()) as sess, core.use_mesh(mesh):
        kv = core.DelegatedKVStore(mesh, N_KEYS, VW, capacity=R, name="kv",
                                   local_shortcut=False)
        kv.prefill(init)
        pt = core.DelegatedPageTable(
            mesh, PT["n_pages"], max_seqs=PT["max_seqs"],
            page_size=PT["page_size"], max_pages=PT["max_pages"],
            capacity=R, local_shortcut=False)
        for wave, pwave in zip(waves[:SNAP_WAVES],
                               gen_paged_trace(95, SNAP_WAVES)):
            fut = submit(pkg, kv, wave)
            table_wave(pt, sess, pwave)          # one step serves both
            ack(wave[0], fut)
        sess.checkpoint(ckdir)
        out = {"kv": np.asarray(kv.dump())}
        out.update({f"pt/{k}": np.asarray(v) for k, v in pt.dump().items()})
        return out


def restore_session(pkg, ckdir, shape):
    """Restore ``ckdir`` into fresh same-named trusts on a ``shape`` mesh."""
    core = pkg.core
    mesh = pkg.mesh(shape)
    with core.use_session(core.TrustSession()) as sess, core.use_mesh(mesh):
        kv = core.DelegatedKVStore(mesh, N_KEYS, VW, capacity=R, name="kv",
                                   local_shortcut=False)
        pt = core.DelegatedPageTable(
            mesh, PT["n_pages"], max_seqs=PT["max_seqs"],
            page_size=PT["page_size"], max_pages=PT["max_pages"],
            capacity=R, local_shortcut=False)
        step = sess.restore(ckdir)
        out = {"kv": np.asarray(kv.dump()), "step": np.asarray(step)}
        out.update({f"pt/{k}": np.asarray(v) for k, v in pt.dump().items()})
        assert pt.audit()["consistent"]
        return out


# ---------------------------------------------------------------------------
# both sides
# ---------------------------------------------------------------------------

def run_all(pkg, snap_dir=None):
    res = {}

    def put(name, d):
        res.update({f"{name}/{k}": np.asarray(v) for k, v in d.items()})

    for name, args in CHAOS.items():
        put(name, run_chaos(pkg, *args))
    put("elastic", run_elastic(pkg))
    put("drop_tear", run_drop_tear(pkg))
    put("guards", run_guards(pkg))
    put("streaming", run_streaming(pkg))
    put("live", run_live_reentrust(pkg))
    put("paged_chaos", run_paged_chaos(pkg))
    if snap_dir is not None:
        put("snapshot", snapshot_session(pkg, snap_dir))
    return res


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("jax_failover")
    out, snap = base / "runs.npz", base / "snap"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([src,
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out), str(snap)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    return res, str(snap)


@pytest.fixture(scope="module")
def port_runs():
    return run_all(port_pkg())


def _sub(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "/")}


def _same(got, want, what):
    assert want, what
    assert sorted(got) == sorted(want), f"{what}: keys differ"
    for k in sorted(want):
        assert got[k].shape == want[k].shape and np.array_equal(
            got[k], want[k]), f"{what}: {k} differs:\n{got[k]}\n{want[k]}"


CHECKS = list(CHAOS) + ["elastic", "drop_tear", "guards", "streaming",
                        "live", "paged_chaos"]


@pytest.mark.parametrize("name", CHECKS)
def test_failover_battery_matches_jax_on_8_devices(jax_runs, port_runs,
                                                   name):
    """The port's acked history, final tables and recovery counters equal
    JAX's (each side also held its own battery assertions: the oracle,
    bit-identical replays, drop / tear leaving the table)."""
    _same(_sub(port_runs, name), _sub(jax_runs[0], name), f"{name} vs JAX")


def test_poisoned_dead_slot_gives_the_same_result(jax_runs):
    """Garbage in the killed shard's slot changes nothing: the state comes
    from the snapshot, never from the dead shard's memory."""
    got = run_chaos(port_pkg(), *CHAOS["chaos_shared"], poison=True)
    _same({k: np.asarray(v) for k, v in got.items()},
          _sub(jax_runs[0], "chaos_shared"), "poisoned run vs JAX")


@pytest.mark.parametrize("shape", [(2, 4), (1, 7)])
def test_jax_session_snapshot_restores_in_the_port(jax_runs, shape):
    """JAX's session snapshot (a KV store and a page table, 8 trustees)
    restores into the port: on the 2x4 mesh as it was, on 7 shards
    through the schemas' reshard rules (the JAX rules give the same)."""
    from repro.core import kv_reshard, pagetable_reshard
    res, snap = jax_runs
    want = _sub(res, "snapshot")
    got = restore_session(port_pkg(), snap, shape)
    assert int(got["step"]) == SNAP_WAVES
    assert np.array_equal(got["kv"], want["kv"])
    pt_want = {k[3:]: v for k, v in want.items() if k.startswith("pt/")}
    if shape == (1, 7):
        pt_want = pagetable_reshard(pt_want, 8, 7)
        kv7 = kv_reshard({"table": np.zeros((40, VW), np.float32)}, 8, 7)
        assert kv7["table"].shape == (42, VW)
    for k, v in pt_want.items():
        assert np.array_equal(got[f"pt/{k}"], v), k


# ---------------------------------------------------------------------------
# in process: tests/test_failover.py's single-device checks
# ---------------------------------------------------------------------------

def _store_and_session():
    import repro_torch.core as core
    sess = core.TrustSession()
    st = core.DelegatedKVStore(core.StackedMesh((1, 1), device="cpu"), 13,
                               2, capacity=16, name="kv", session=sess)
    return st, sess


def _t(a):
    import torch
    return torch.as_tensor(a)


def test_checkpoint_restore_round_trip(tmp_path):
    st, sess = _store_and_session()
    rng = np.random.default_rng(0)
    st.prefill(rng.integers(0, 8, (13, 2)).astype(np.float32))
    keys = _t(rng.integers(0, 13, 16).astype(np.int32))
    vals = _t(rng.integers(0, 8, (16, 2)).astype(np.float32))
    st.add_then(keys, vals)
    sess.step()
    want = st.dump()
    step = sess.checkpoint(str(tmp_path))
    assert step == sess.wave_counter == 1
    st.add_then(keys, vals)
    sess.step()
    assert not np.array_equal(st.dump(), want)
    assert sess.restore(str(tmp_path)) == step
    assert np.array_equal(st.dump(), want)
    rec = sess.last_stats()["recovery"]
    assert rec["restores"] == 1 and rec["recovery_ms"] > 0


def test_restore_drops_pending_submissions(tmp_path):
    st, sess = _store_and_session()
    st.prefill(np.ones((13, 2), np.float32))
    sess.checkpoint(str(tmp_path))
    fut = st.add_then(_t(np.zeros(4, np.int32)),
                      _t(np.ones((4, 2), np.float32)))
    sess.restore(str(tmp_path))
    assert not st.trust._pending
    sess.step()
    assert not fut.ready()


def test_kill_failure_carries_context(tmp_path):
    from repro_torch.runtime import EngineFailureInjector, TrusteeFailure
    st, sess = _store_and_session()
    st.prefill(np.zeros((13, 2), np.float32))
    snap = sess.checkpoint(str(tmp_path))
    sess.install_injector(EngineFailureInjector(schedule={0: ("kill", 0)}))
    st.add_then(_t(np.zeros(4, np.int32)), _t(np.ones((4, 2), np.float32)))
    with pytest.raises(TrusteeFailure) as ei:
        sess.step()
    e = ei.value
    assert e.kind == "kill" and e.shard == 0 and e.wave_id == 0
    assert e.last_snapshot_step == snap and e.trusts == ("kv",)
    assert 0 in sess.dead_shards
    assert st.trust._pending          # the queue survived the kill


def test_wave_counter_and_no_recovery_entry_without_recovery():
    st, sess = _store_and_session()
    st.prefill(np.zeros((13, 2), np.float32))
    sess.step()
    assert sess.wave_counter == 0     # nothing pending: no wave
    st.add_then(_t(np.zeros(4, np.int32)), _t(np.ones((4, 2), np.float32)))
    sess.step()
    assert sess.wave_counter == 1
    assert "recovery" not in sess.last_stats()


def test_untorn_step_clones_nothing_and_reads_nothing(monkeypatch):
    """With an injector whose entries are other waves (or fired),
    ``step(sync=False)`` runs today's round: no state clone and no device
    value read on the host (``clone``, ``item``, ``tolist``, ``numpy``,
    truth values and conversions patched to raise)."""
    import torch
    from repro_torch.runtime import EngineFailureInjector
    st, sess = _store_and_session()
    st.prefill(np.zeros((13, 2), np.float32))
    sess.install_injector(EngineFailureInjector(
        schedule={5: ("tear", 0), 0: ("kill", 3)}))
    sess.injector.fired.add(0)
    keys, vals = _t(np.arange(8, dtype=np.int32)), _t(np.ones((8, 2),
                                                               np.float32))
    st.add_then(keys, vals)

    def refuse(*a, **k):
        raise AssertionError("a device value was read or a state cloned")
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                     "__index__", "numpy", "clone"):
            m.setattr(torch.Tensor, name, refuse)
        assert sess.step(sync=False) is None
    assert sess.wave_counter == 1
    assert st.dump()[:8].sum() == 16


@pytest.mark.parametrize("kind", ["drop", "tear"])
@pytest.mark.parametrize("path", ["solo", "fused", "drain", "combine",
                                  "kernel"])
def test_tear_leaves_every_table_bit_identical(kind, path):
    """A drop / tear on each round the engine runs — a solo flush, a fused
    round of two trusts, a defer drain's several rounds, a combined round,
    and the serve "kernel" path (the kernels' plain versions here, which
    write in place as the kernels do) — leaves every member's physical
    state bit-identical and its futures open; the retry serves."""
    import torch
    import repro_torch.core as core
    from repro_torch.runtime import EngineFailureInjector, TrusteeFailure
    mesh = core.StackedMesh((2, 4), device="cpu")
    sess = core.TrustSession()
    kw = dict(capacity=R, session=sess, local_shortcut=False,
              serve_impl="kernel", pack_impl="kernel")
    if path == "drain":
        kw.update(capacity=2, overflow="defer", max_rounds=6)
    if path == "combine":
        kw.update(combine="ref")
    if path == "kernel":
        kw.update(mode="dedicated", n_dedicated=3)
    rng = np.random.default_rng(5)
    stores = [core.DelegatedKVStore(mesh, N_KEYS, VW, name=f"kv{i}", **kw)
              for i in range(2 if path == "fused" else 1)]
    for st in stores:
        st.prefill(rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32))
    before = [{k: v.clone() for k, v in st.trust.state().items()}
              for st in stores]
    sess.install_injector(EngineFailureInjector(schedule={0: (kind, 1)}))
    futs = []
    for st in stores:
        keys = torch.as_tensor(rng.integers(0, 6, R).astype(np.int32))
        vals = torch.as_tensor(rng.integers(0, 8, (R, VW))
                               .astype(np.float32))
        futs.append(st.add_then(keys, vals))
        futs.append(st.put_then(keys.flip(0), vals))
    with pytest.raises(TrusteeFailure):
        sess.step()
    assert sess.last_step_info["fused" if path == "fused" else "solo"] \
        or path != "fused"
    for st, b in zip(stores, before):
        for k, v in st.trust.state().items():
            assert torch.equal(v, b[k]), (path, kind, k)
    assert not any(f.ready() for f in futs)
    sess.step()
    assert all(f.ready() for f in futs)
    assert any(not torch.equal(st.trust.state()["table"], b["table"])
               for st, b in zip(stores, before))


def test_schema_fingerprints_equal_jax():
    """The port's fingerprint is JAX's hex string for the same contract
    (T-independent, width-dependent): the KV schema at T 4 / 8 and W 2 /
    3, the page table, and the lock baselines' tables."""
    import repro.core as jc
    import repro_torch.core as tc
    for t in (4, 8):
        for w in (2, 3):
            assert tc.make_kv_schema(t, w).fingerprint() == \
                jc.make_kv_schema(t, w).fingerprint()
    a = tc.make_kv_schema(4, 2).fingerprint()
    assert a == tc.make_kv_schema(8, 2).fingerprint()
    assert a != tc.make_kv_schema(4, 3).fingerprint()
    assert tc.make_pagetable_schema(8, 16, 4).fingerprint() == \
        jc.make_pagetable_schema(8, 16, 4).fingerprint()
    for cls in ("FetchRMWStore", "AtomicAddStore"):
        port = getattr(tc, cls)(tc.StackedMesh((1, 1), device="cpu"), 16, 1,
                                session=tc.TrustSession())
        from jax.sharding import Mesh
        import jax
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
        jx = getattr(jc, cls)(mesh, 16, 1, session=jc.TrustSession())
        assert port.store.schema.fingerprint() == \
            jx.store.schema.fingerprint(), cls


def test_host_logic_matches_jax(tmp_path):
    """``EngineFailureInjector``, ``ElasticPlan`` / the delegation ladder,
    ``StragglerMonitor`` and ``TrainLoop`` (a numpy step function, an
    injected failure, a resume) give JAX's histories."""
    import repro.runtime as jr
    import repro_torch.runtime as tr
    sched = {3: ("kill", 1), 5: ("tear", 2), 7: ("drop", 0)}
    probes = [(w, ph) for w in range(9) for ph in ("before", "after")] * 2

    def trace(mod):
        inj = mod.EngineFailureInjector(schedule=dict(sched))
        return [getattr(inj, f"{ph}_dispatch")(w) for w, ph in probes]
    assert trace(tr) == trace(jr)
    inj = tr.EngineFailureInjector(schedule=dict(sched))
    assert inj.scheduled_after(5) and not inj.scheduled_after(3)
    inj.after_dispatch(5)
    assert not inj.scheduled_after(5)
    for n in (8, 7, 3):
        p, q = tr.delegation_elastic_plan(n), jr.delegation_elastic_plan(n)
        assert p.ladder == q.ladder
        assert [p.choose(k) for k in range(1, n + 1)] == \
            [q.choose(k) for k in range(1, n + 1)]
    assert [tr.ElasticPlan().choose(k) for k in (1, 5, 100, 300)] == \
        [jr.ElasticPlan().choose(k) for k in (1, 5, 100, 300)]
    times = [1.0, 1.1, 5.0, 1.0, 0.9, 9.0, 1.2]
    mons = [m.StragglerMonitor() for m in (tr, jr)]
    flags = [[mon.observe(i, dt) for i, dt in enumerate(times)]
             for mon in mons]
    assert flags[0] == flags[1] and mons[0].flagged == mons[1].flagged
    assert mons[0].ewma == mons[1].ewma

    def step_fn(state, step):
        w = np.asarray(state["w"]) + np.float32(step + 1)
        return {"w": w}, {"loss": float(w.sum())}

    def loop(mod, d):
        cfg = mod.TrainLoopConfig(ckpt_dir=str(tmp_path / d), ckpt_every=3,
                                  keep=2)
        lp = mod.TrainLoop(cfg, step_fn, {"w": np.zeros(4, np.float32)},
                           injector=mod.FailureInjector(at_steps=(4, 7)))
        out = lp.run(10)
        return ([(s, m["loss"]) for s, m in out["history"]],
                out["final_step"], out["restarts"],
                np.asarray(lp.state["w"]).tolist())
    assert loop(tr, "port") == loop(jr, "jax")


def test_survivors_mesh_and_nested_launch():
    """``survivors_mesh``: the ladder's rung, the old axis names, leading
    axes 1, the same device.  ``launch_serve``: the two-hop serve of
    ``tests/test_system.py``'s nested check, and on the 2x4 mesh against
    the plain composition of the two rounds."""
    import torch
    import repro_torch.core as core
    from repro_torch.core import channel as ch
    from repro_torch.runtime import ElasticPlan
    m = core.StackedMesh((2, 4), device="cpu")
    s = core.survivors_mesh(m, [3])
    assert s.dims == (1, 7) and s.axis_names == m.axis_names
    assert s.device == m.device
    assert core.survivors_mesh(m, [], survivors=[0, 1, 2]).dims == (1, 3)
    assert core.survivors_mesh(m, [1, 2], plan=ElasticPlan(
        ladder=((1, 4), (1, 2)))).dims == (1, 4)
    with pytest.raises(RuntimeError, match="no surviving"):
        core.survivors_mesh(m, range(8))

    def inner_serve(state, received):
        idx = torch.where(received.valid, received.rows["key"], 0).long()
        vals = state[torch.arange(state.shape[0])[:, None], idx]
        return state, {"v": torch.where(received.valid, vals, 0.0)}

    def outer_pre(state, received):
        dst = torch.where(received.valid, received.rows["key"] % 2, -1)
        return state, dst, {"key": received.rows["key"] // 2}, None

    def outer_post(state, inner_resp, carry, received):
        return state, {"y": inner_resp["v"] * 2.0}

    # tests/test_system.py: one shard, the inner table arange(8)
    cfg = ch.ChannelConfig(axis="model", capacity=8, local_shortcut=False)
    serve = core.launch_serve(
        lambda st, rv: (st, torch.where(rv.valid, 0 * rv.rows["key"], -1),
                        {"key": rv.rows["key"]}, None),
        inner_serve, outer_post, 1, cfg)
    keys = torch.tensor([[3, 5, 1]], dtype=torch.int32)
    (_o, _i), resp, _info = ch.delegate(
        (None, torch.arange(8.0)[None]), torch.zeros((1, 3),
                                                     dtype=torch.int32),
        {"key": keys}, serve, 1, cfg)
    assert torch.equal(resp["y"], torch.arange(8.0)[keys.long()] * 2)
    # the 2x4 mesh: the outer trust on 8 trustees, the inner one on 2 (its
    # state stacked over its 2 trustees)
    d, n = 8, 12
    cfg8 = ch.ChannelConfig(axis=("data", "model"), capacity=n)
    inner = torch.arange(2 * 16, dtype=torch.float32).reshape(2, 16)
    gen = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 32, (d, n), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, d, (d, n), generator=gen, dtype=torch.int32)
    serve = core.launch_serve(outer_pre, inner_serve, outer_post, 2, cfg8)
    (_o, _i), resp, _info = ch.delegate((None, inner), dst, {"key": keys},
                                        serve, d, cfg8)
    want = 2.0 * inner[(keys % 2).long(), (keys // 2).long()]
    assert torch.equal(resp["y"], want)


def _jax_main(out_path, snap_dir):
    pkg = jax_pkg()
    res = run_all(pkg, snap_dir)
    np.savez(out_path, **res)


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
