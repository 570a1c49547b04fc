"""The lock baselines of the port (``core/lockstore.py``): ``FetchRMWStore``
and ``AtomicAddStore`` against the JAX stores on a 2x4 mesh of 8 virtual
CPU devices (one subprocess: this module, run as a script), bit for bit
on integer-exact payloads — every returned row, the final tables and
``n_rounds_executed``:

  * ``rmw`` with ``crit_fn = lambda v, p: p`` (the mutex lane: every row
    writes its payload) and with ``lambda v, p: v + 1`` (the MCS
    fetch-and-add lane), ranks from ``conflict_ranks`` whole and capped as
    the benchmarks cap them;
  * ``put`` with ``rw_lock`` (writers serialised by rank, the write subset
    padded by ``pad_writes``), and without it, where the store ignores the
    caller's ranks — given deliberately wrong ones here — and recomputes
    them from the keys;
  * ``AtomicAddStore.add``.

In the port itself: the lanes' tables equal the round-by-round oracle
and, uncapped, the ``bincount`` of the keys (``tests/_md_battery.py``);
both stores ride a fused round beside a delegated store.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import subprocess

import numpy as np
import pytest

N_KEYS, VW, R, N_DEV = 37, 2, 64, 8
CAP_MUTEX, CAP_MCS, CAP_RW = 4, 6, 3


def gen(seed):
    """Keys half on three hot keys, integer-valued rows, 20% writes."""
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    keys = np.where(rng.random(R) < 0.5, rng.integers(0, 3, R),
                    rng.integers(0, N_KEYS, R)).astype(np.int32)
    vals = rng.integers(0, 8, (R, VW)).astype(np.float32)
    is_write = rng.random(R) < 0.2
    return init, keys, vals, is_write


def lanes(pkg, mesh, conv, pad_writes, kw):
    """Every lane of both stores on one trace (``kw``: the stores' channel
    keywords); returns {key: array}."""
    conflict_ranks = pkg.conflict_ranks
    init, keys, vals, is_write = gen(7)
    out = {}
    k, v = conv(keys), conv(vals)
    ranks, n_rounds = conflict_ranks(keys, N_DEV)
    out["n_rounds"] = np.asarray(n_rounds)
    for lane, crit, cap, payload in (
            ("mutex", lambda a, p: p, None, v),
            ("mutex_capped", lambda a, p: p, CAP_MUTEX, v),
            ("mcs", lambda a, p: a + 1.0, None, None),
            ("mcs_capped", lambda a, p: a + 1.0, CAP_MCS, None)):
        st = pkg.FetchRMWStore(mesh, N_KEYS, VW, **kw)
        st.prefill(init)
        rounds = n_rounds if cap is None else min(n_rounds, cap)
        got = st.rmw(k, crit, np.minimum(ranks, rounds - 1), rounds,
                     payload=payload)
        out[f"{lane}/out"] = np.asarray(got)
        out[f"{lane}/final"] = np.asarray(st.dump())
        out[f"{lane}/rounds"] = np.asarray(st.n_rounds_executed)

    # readers-writer: GETs one parallel round, the write subset padded to a
    # multiple of the device count, ranks capped
    st = pkg.FetchRMWStore(mesh, N_KEYS, VW, rw_lock=True, **kw)
    st.prefill(init)
    out["rw/get"] = np.asarray(st.get(conv(keys[~is_write])))
    wranks, wrounds = conflict_ranks(keys[is_write], N_DEV)
    wrounds = min(wrounds, CAP_RW)
    wk, wv, wr, _ = pad_writes(keys[is_write], v[np.flatnonzero(is_write)],
                               np.minimum(wranks, wrounds - 1), wrounds,
                               N_DEV)
    st.put(wk, wv, wr, wrounds)
    out["rw/final"] = np.asarray(st.dump())
    out["rw/rounds"] = np.asarray(st.n_rounds_executed)

    # no rw_lock: put ignores the ranks it is given and recomputes them
    st = pkg.FetchRMWStore(mesh, N_KEYS, VW, **kw)
    st.prefill(init)
    st.put(k, v, np.zeros(R, np.int32), 1)
    out["put/final"] = np.asarray(st.dump())
    out["put/rounds"] = np.asarray(st.n_rounds_executed)

    at = pkg.AtomicAddStore(mesh, N_KEYS, VW, **kw)
    at.prefill(init)
    out["atomic/out"] = np.asarray(at.add(k, v))
    out["atomic/final"] = np.asarray(at.dump())
    return out


def _pad_writes_jax(wkeys, wvals, ranks, n_rounds, mult):
    """``benchmarks/kv_store.py``'s padding, for the JAX side."""
    import jax.numpy as jnp
    n = len(wkeys)
    pad = (-n) % mult
    wk = np.concatenate([wkeys, np.zeros(pad, wkeys.dtype)])
    rk = np.concatenate([np.asarray(ranks), np.full(pad, n_rounds)])
    wv = jnp.concatenate([wvals[:n], jnp.zeros((pad,) + wvals.shape[1:],
                                               wvals.dtype)], 0)
    return jnp.asarray(wk), wv, rk, n_rounds


def _port_lanes(impl):
    import torch
    import repro_torch.core as pkg
    from repro_torch.core import StackedMesh, use_session
    with use_session():
        return lanes(pkg, StackedMesh((2, 4), device="cpu"), torch.as_tensor,
                     pkg.pad_writes, dict(pack_impl=impl, serve_impl=impl))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_lock") / "runs.npz"
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


@pytest.fixture(scope="module")
def port_runs():
    return {impl: _port_lanes(impl) for impl in ("kernel", "ref")}


LANES = ("mutex", "mutex_capped", "mcs", "mcs_capped", "rw", "put", "atomic")


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("lane", LANES)
def test_lane_matches_jax_store_on_8_devices(jax_runs, port_runs, lane,
                                             impl):
    got = port_runs[impl]
    keys = [k for k in jax_runs if k.startswith(lane + "/")]
    assert keys
    for k in keys:
        assert np.array_equal(got[k], jax_runs[k]), f"{k} impl={impl}"


def test_rounds_are_what_the_ranks_imply(port_runs):
    from repro_torch.core import conflict_ranks
    got = port_runs["kernel"]
    init, keys, vals, is_write = gen(7)
    n = int(got["n_rounds"])
    assert n > CAP_MCS > CAP_MUTEX
    assert int(got["mutex/rounds"]) == int(got["mcs/rounds"]) == n
    assert int(got["mutex_capped/rounds"]) == CAP_MUTEX
    assert int(got["mcs_capped/rounds"]) == CAP_MCS
    assert int(got["rw/rounds"]) == min(
        conflict_ranks(keys[is_write], N_DEV)[1], CAP_RW)
    # put without rw_lock: the ranks of the keys, not the ones it was given
    assert int(got["put/rounds"]) == n


def test_rw_get_reads_inactive_rows_as_zeros():
    """The KV benchmark hands the readers-writer GET its writes' rows as
    key -1: the port's store reads them as inactive rows (zeros)."""
    import torch
    from repro_torch.core import FetchRMWStore, StackedMesh, use_session
    init, keys, _vals, is_write = gen(7)
    with use_session():
        st = FetchRMWStore(StackedMesh((2, 4), device="cpu"), N_KEYS, VW,
                           rw_lock=True)
        st.prefill(init)
        got = st.get(torch.as_tensor(np.where(is_write, -1, keys))).numpy()
    assert np.array_equal(got, np.where(is_write[:, None], 0, init[keys]))


def test_lanes_match_the_round_by_round_oracle(port_runs):
    """Each rmw round is a GET then a PUT of the round's rows in request
    order; uncapped, the MCS lane and the atomic add count the keys
    (``bincount``), as the JAX package's battery checks."""
    from repro_torch.core import SequentialKVReference, conflict_ranks
    got = port_runs["kernel"]
    init, keys, vals, is_write = gen(7)
    ranks, n = conflict_ranks(keys, N_DEV)
    for lane, cap, crit in (("mutex", n, lambda a: vals),
                            ("mutex_capped", CAP_MUTEX, lambda a: vals),
                            ("mcs", n, lambda a: a + 1),
                            ("mcs_capped", CAP_MCS, lambda a: a + 1)):
        ref = SequentialKVReference(N_KEYS, VW)
        ref.prefill(init)
        rk = np.minimum(ranks, cap - 1)
        want = np.zeros((R, VW), np.float32)
        for r in range(cap):
            ks = np.where(rk == r, keys, -1)
            got_r = ref.get(ks)
            ref.put(ks, crit(got_r))
            want[rk == r] = got_r[rk == r]
        assert np.array_equal(got[f"{lane}/out"], want), lane
        assert np.array_equal(got[f"{lane}/final"], ref.dump()), lane
    count = np.bincount(keys, minlength=N_KEYS).astype(np.float32)
    assert np.array_equal(got["mcs/final"] - init, count[:, None]
                          .repeat(VW, 1))
    ones_add = got["atomic/final"] - init
    want_add = np.zeros_like(init)
    np.add.at(want_add, keys, vals)
    assert np.array_equal(ones_add, want_add)


def test_lock_store_rides_a_fused_round():
    """A ``FetchRMWStore``'s table and an ``AtomicAddStore``'s fuse with a
    delegated store into one ``session.step()`` when their channel
    signatures agree, and answer as their solo rounds do."""
    import torch
    from repro_torch.core import (AtomicAddStore, DelegatedKVStore,
                                  FetchRMWStore, StackedMesh, TrustSession)
    init, keys, vals, _ = gen(9)
    k, v = torch.as_tensor(keys), torch.as_tensor(vals)
    out = {}
    for fused in (True, False):
        sess = TrustSession()
        mesh = StackedMesh((2, 4), device="cpu")
        kw = dict(capacity=R, session=sess)
        kv = DelegatedKVStore(mesh, N_KEYS, VW, local_shortcut=False,
                              name="kv", **kw)
        lock = FetchRMWStore(mesh, N_KEYS, VW, **kw)
        atom = AtomicAddStore(mesh, N_KEYS, VW, **kw)
        stores = (kv, lock.store, atom.store)
        for st in stores:
            st.prefill(init)
        futs = [kv.add_then(k, v), lock.store.get_then(k),
                atom.store.add_then(k, v)]
        if fused:
            sess.step()
            assert sess.last_step_info["fused"] == \
                [["kv", "rmw-lock", "atomic-add"]]
        else:
            for st in stores:
                st.flush()
        out[fused] = [f.result()["value"].numpy() for f in futs] + \
            [st.dump() for st in stores]
    assert all(np.array_equal(a, b) for a, b in zip(out[True], out[False]))


def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import repro.core as pkg
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    res = lanes(pkg, mesh, jnp.asarray, _pad_writes_jax, {})
    np.savez(out_path, **res)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
