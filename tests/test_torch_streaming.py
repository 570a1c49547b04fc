"""The port's streaming driver (``launch/streaming.py``) on the CPU, over a
KV store on a 2x4 stacked mesh, and against the JAX ``StreamingDriver``:

  * depth 0 is lockstep (dispatch k, consume k, dispatch k+1, ...);
  * depth 2 gives the responses and the final table of depth 0, and the
    event log shows the overlap (wave k+1 dispatched before wave k was
    consumed);
  * the JAX driver on a 1x1 mesh and the port on a 1x1 stacked mesh give
    the same event log and the same responses at depth 0, 1 and 2;
  * admission backpressures: in-flight rows never exceed the bucket, the
    per-user buckets refuse a hot user, oversize waves raise;
  * ``quiesce`` flushes what is still queued; the knobs not ported raise
    naming their ROADMAP.md item;
  * ``wave_budget`` equals the JAX driver's on the same waves, a solo
    trust's and two trusts' fused into one round, on a 2x4 mesh of 8
    virtual devices (one subprocess: this module, run as a script);
  * the paged entry points run on ``cuda`` unless asked for the CPU.
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

N_KEYS, ROWS = 32, 16
BUDGET_WAVES = 6


def _budgets(stores, drv, waves, conv):
    """Fetch-and-add waves on every store, one dispatch a wave; the wave
    budget read after each dispatch (with a fallback of -1) and after the
    final drain."""
    out = []
    for keys in waves:
        for st in stores:
            st.add_then(conv(keys), conv(np.ones((len(keys), 1),
                                                 np.float32)))
        drv.dispatch(rows=len(keys) * len(stores))
        out.append(drv.wave_budget(stores, fallback=-1))
    drv.drain()
    out.append(drv.wave_budget(stores))
    return out


def budget_runs(pkg, driver, mesh, conv):
    """``wave_budget`` of a solo trust and of two fused trusts, at depth 1
    (the cache refreshes when the pipeline empties) and 0."""
    res = {}
    for n_stores in (1, 2):
        for depth in (0, 1):
            sess = pkg.TrustSession()
            stores = [pkg.DelegatedKVStore(mesh, N_KEYS, 1, session=sess,
                                           name=f"kv{i}",
                                           local_shortcut=False)
                      for i in range(n_stores)]
            for st in stores:
                st.prefill(np.zeros((N_KEYS, 1), np.float32))
            drv = driver(sess, depth=depth, min_wave=4)
            res[f"{n_stores}/{depth}"] = np.asarray(_budgets(
                stores, drv, _waves(BUDGET_WAVES, rows=64, seed=n_stores),
                conv))
    return res


@pytest.fixture(scope="module")
def jax_budgets(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_budget") / "runs.npz"
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


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("n_stores", [1, 2])
def test_wave_budget_matches_jax_driver(jax_budgets, n_stores, depth):
    import repro_torch.core as pkg
    from repro_torch.launch.streaming import StreamingDriver
    got = budget_runs(pkg, StreamingDriver,
                      pkg.StackedMesh((2, 4), device="cpu"),
                      torch.as_tensor)[f"{n_stores}/{depth}"]
    want = jax_budgets[f"{n_stores}/{depth}"]
    assert np.array_equal(got, want), (got, want)
    # the EMA is read only where the pipeline is empty: after every wave
    # at depth 0, and only after the drain at depth 1 (the fallback, -1,
    # before it)
    assert got[-1] > 0
    assert (got[:-1] > 0).all() if depth == 0 else (got[:-1] == -1).all()


def _store(sess, mesh=(2, 4), capacity=ROWS):
    from repro_torch.core import DelegatedKVStore, StackedMesh
    st = DelegatedKVStore(StackedMesh(mesh, device="cpu"), N_KEYS, 1,
                          session=sess, name="kv", capacity=capacity,
                          local_shortcut=False)
    st.prefill(np.zeros((N_KEYS, 1), np.float32))
    return st


def _waves(n, rows=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, N_KEYS, rows).astype(np.int32) for _ in range(n)]


def _drive(drv, st, waves, conv, users=None):
    """One fetch-and-add wave per key batch; the responses are read when
    the wave is consumed.  Returns the responses in wave order."""
    got = {}
    for i, keys in enumerate(waves):
        drv.admit(len(keys), users)
        fut = st.add_then(conv(keys), conv(np.ones((len(keys), 1),
                                                   np.float32)))
        drv.dispatch(outputs=fut, rows=len(keys), users=users,
                     on_consume=lambda h, i=i, fut=fut: got.__setitem__(
                         i, np.asarray(fut.result()["value"])))
    drv.drain()
    return [got[i] for i in range(len(waves))]


def test_depth_zero_is_lockstep():
    from repro_torch.core import use_session
    from repro_torch.launch.streaming import StreamingDriver
    with use_session() as sess:
        drv = StreamingDriver(sess, depth=0)
        _drive(drv, _store(sess), _waves(3), torch.as_tensor)
    assert drv.events == [("dispatch", 0), ("consume", 0),
                          ("dispatch", 1), ("consume", 1),
                          ("dispatch", 2), ("consume", 2)]
    assert drv.stats()["overlapped_waves"] == 0


def test_depth_two_matches_depth_zero_and_overlaps():
    from repro_torch.core import use_session
    from repro_torch.launch.streaming import StreamingDriver
    waves = _waves(6)
    runs = {}
    for depth in (0, 2):
        with use_session() as sess:
            st = _store(sess)
            drv = StreamingDriver(sess, depth=depth)
            runs[depth] = (_drive(drv, st, waves, torch.as_tensor),
                           st.dump(), drv)
    for a, b in zip(runs[0][0], runs[2][0]):
        assert np.array_equal(a, b)
    assert np.array_equal(runs[0][1], runs[2][1])
    ev = runs[2][2].events
    assert ev.index(("dispatch", 1)) < ev.index(("consume", 0))
    assert ev.index(("dispatch", 2)) < ev.index(("consume", 0))
    assert runs[2][2].stats()["overlapped_waves"] >= 4
    assert [w for k, w in ev if k == "consume"] == list(range(6))


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_matches_jax_driver(depth):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import DelegatedKVStore as JStore
    from repro.core import TrustSession
    from repro.launch.streaming import StreamingDriver as JDriver
    from repro_torch.core import use_session
    from repro_torch.launch.streaming import StreamingDriver
    waves = _waves(5, seed=depth)
    ses = TrustSession()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jst = JStore(mesh, N_KEYS, 1, session=ses, name="kv", capacity=ROWS,
                 local_shortcut=False)
    jst.prefill(np.zeros((N_KEYS, 1), np.float32))
    jdrv = JDriver(ses, depth=depth)
    want = _drive(jdrv, jst, waves, jnp.asarray)
    with use_session() as sess:
        st = _store(sess, mesh=(1, 1))
        drv = StreamingDriver(sess, depth=depth)
        got = _drive(drv, st, waves, torch.as_tensor)
        final = st.dump()
    assert drv.events == jdrv.events
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(final, np.asarray(jst.dump()))
    assert drv.stats()["overlapped_waves"] == \
        jdrv.stats()["overlapped_waves"]


def test_admission_backpressures():
    from repro_torch.core import use_session
    from repro_torch.launch.streaming import AdmissionControl, StreamingDriver
    with use_session() as sess:
        st = _store(sess)
        adm = AdmissionControl(2 * ROWS, per_user_rows=ROWS)
        drv = StreamingDriver(sess, depth=10, admission=adm)
        seen = []
        for i, keys in enumerate(_waves(5)):
            drv.admit(ROWS, {"hot": ROWS})
            seen.append((adm.inflight_rows, drv.inflight))
            fut = st.add_then(torch.as_tensor(keys), torch.ones(ROWS, 1))
            drv.dispatch(outputs=fut, rows=ROWS, users={"hot": ROWS})
        drv.drain()
        # the per-user bucket holds one wave of the hot user at a time
        assert all(rows <= ROWS and inflight == 0 for rows, inflight in seen)
        assert adm.inflight_rows == 0 and adm.admitted == 5 * ROWS
        assert adm.user_refused["hot"] >= 4
        with pytest.raises(ValueError, match="admission budget"):
            drv.admit(2 * ROWS + 1)
        with pytest.raises(ValueError, match="per-user budget"):
            drv.admit(ROWS + 1, {"u": ROWS + 1})
        # without per-user limits two waves fit: the third waits
        adm2 = AdmissionControl(2 * ROWS)
        drv2 = StreamingDriver(sess, depth=10, admission=adm2)
        for keys in _waves(4):
            drv2.admit(ROWS)
            assert adm2.inflight_rows <= 2 * ROWS and drv2.inflight <= 1
            st.add_then(torch.as_tensor(keys), torch.ones(ROWS, 1))
            drv2.dispatch(rows=ROWS)
        drv2.drain()
        assert adm2.refused >= 2


def test_quiesce_and_knobs_not_ported(tmp_path):
    """``quiesce`` consumes every wave and flushes the session;
    ``checkpoint`` quiesces before its snapshot, and ``recover`` after a
    tear drops the in-flight waves and restores that snapshot."""
    from repro_torch.core import use_session
    from repro_torch.launch.streaming import StreamingDriver
    from repro_torch.runtime import EngineFailureInjector, TrusteeFailure
    with pytest.raises(ValueError, match="depth"):
        StreamingDriver(None, depth=-1)
    with use_session() as sess:
        st = _store(sess)
        drv = StreamingDriver(sess, depth=2)
        _drive(drv, st, _waves(2), torch.as_tensor)
        fut = st.get_then(torch.arange(4))
        assert not sess.quiesced()
        drv.quiesce()
        assert sess.quiesced() and fut.ready() and drv.inflight == 0
        st.add_then(torch.arange(4), torch.ones((4, st.value_width)))
        step = drv.checkpoint(str(tmp_path))
        assert sess.quiesced() and step == sess.wave_counter
        snap = st.dump()
        sess.install_injector(EngineFailureInjector(
            schedule={sess.wave_counter + 1: ("tear", 0)}))
        st.add_then(torch.arange(4), torch.ones((4, st.value_width)))
        drv.dispatch(rows=4)
        st.add_then(torch.arange(4), torch.ones((4, st.value_width)))
        with pytest.raises(TrusteeFailure) as ei:
            drv.dispatch(rows=4)
        assert drv.recover(ei.value, str(tmp_path)) == step
        assert drv.inflight == 0 and not st.trust._pending
        assert np.array_equal(st.dump(), snap)


def test_paged_entry_points_default_to_cuda():
    """The paged-decode entry point and the page table run on ``cuda``
    unless asked for the CPU, and raise where there is no card."""
    from repro_torch.core import DelegatedPageTable, StackedMesh
    from repro_torch.launch.paged_decode import main, run_decode
    if torch.cuda.is_available():
        assert StackedMesh((2, 4)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_decode(n_requests=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DelegatedPageTable(StackedMesh((2, 4)), 64)
    assert main(["--device", "cpu"]) == 0


def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import repro.core as pkg
    from repro.launch.streaming import StreamingDriver
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    np.savez(out_path, **budget_runs(pkg, StreamingDriver, mesh,
                                     jnp.asarray))


if __name__ == "__main__":
    _jax_main(sys.argv[1])
