"""End to end: a 1,024-op mixed GET/PUT/ADD/CAS trace through the port's
DelegatedKVStore on 8 stacked shards (a 2x4 StackedMesh on the CPU).

  * every configuration — local shortcut on/off x pack {ref, kernel} x
    serve {ref, kernel, masked} — is bit-identical to the JAX package's
    sequential oracle ``repro.core.SequentialKVReference``, replayed in the
    channel's serve order (self-addressed rows after the channel rows);
  * the port is bit-identical to the JAX ``DelegatedKVStore`` on a 2x4 mesh
    of 8 virtual CPU devices — every response and the final owner-major
    table — including under capacity overflow (second_round and dropped
    rows), where the oracle no longer holds.  Both stores start from the
    same table, carried across by ``repro_torch.convert``.  The JAX side
    runs in one subprocess: this module, run as a script.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import subprocess

import numpy as np
import pytest

N_KEYS, VW, R, N_ROUNDS, SEED = 37, 2, 64, 4, 50
N_DEV = 8
OPS = ("get", "put", "add", "cas")
# JAX store configurations replayed by the port (capacity R never overflows:
# the fused round is 4R rows, 4R/8 = 32 per client shard)
CONFIGS = {
    "plain": dict(capacity=R, local_shortcut=False),
    "shortcut": dict(capacity=R, local_shortcut=True),
    "auto_capacity": dict(capacity=None, local_shortcut=True),
    "overflow": dict(capacity=3, local_shortcut=False),
}


def gen_trace(seed):
    """Per round one batch per op, R rows each, keys half on 3 hot keys;
    integer-valued payloads (exact adds); CAS expects hit a plain-order
    replay about half the time."""
    from repro_torch.core import SequentialKVReference
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    sim = SequentialKVReference(N_KEYS, VW)
    sim.prefill(init)
    rounds = []
    for _ in range(N_ROUNDS):
        batches = {}
        for op in OPS:
            keys = rng.integers(0, N_KEYS, R)
            keys = np.where(rng.random(R) < 0.5, rng.integers(0, 3, R), keys)
            keys = keys.astype(np.int32)
            vals = rng.integers(0, 8, (R, VW)).astype(np.float32)
            expect = None
            if op == "cas":
                live = sim.table[keys].copy()
                rand = rng.integers(0, 8, (R, VW)).astype(np.float32)
                expect = np.where(rng.random(R)[:, None] < 0.5, live, rand)
            batches[op] = (keys, vals, expect)
        sim.get(batches["get"][0])
        sim.put(*batches["put"][:2])
        sim.add(*batches["add"][:2])
        sim.cas(batches["cas"][0], batches["cas"][2], batches["cas"][1])
        rounds.append(batches)
    return init, rounds


def oracle(init, rounds, shortcut):
    """The JAX package's oracle replayed in serve order: the four op
    batches fuse into one 4R-row batch, sharded contiguously over the 8
    clients; with the shortcut each op's self-addressed rows serve after
    its channel rows (tests/_diff_battery.py:mixed_ref_responses)."""
    from repro.core import SequentialKVReference
    ref = SequentialKVReference(N_KEYS, VW)
    ref.prefill(init)
    outs = []
    for batches in rounds:
        out = {}
        for oi, op in enumerate(OPS):
            keys, vals, expect = batches[op]
            perm = np.arange(R)
            if shortcut:
                client = (oi * R + np.arange(R)) // (4 * R // N_DEV)
                local = (keys % N_DEV) == client
                perm = np.concatenate([np.where(~local)[0],
                                       np.where(local)[0]])
            inv = np.empty_like(perm)
            inv[perm] = np.arange(R)
            if op == "get":
                out["get"] = ref.get(keys[perm])[inv]
            elif op == "put":
                ref.put(keys[perm], vals[perm])
            elif op == "add":
                out["add"] = ref.add(keys[perm], vals[perm])[inv]
            else:
                fl, old = ref.cas(keys[perm], expect[perm], vals[perm])
                out["cas_flag"], out["cas_old"] = fl[inv], old[inv]
        outs.append(out)
    return outs, ref.dump()


def run_rounds(store, rounds, conv):
    """Each round: get/put/add/cas .then on the store's typed handles, then
    one flush — a single fused channel round.  Works for both packages'
    stores (``conv`` turns numpy into their arrays)."""
    outs = []
    for b in rounds:
        fg = store.get_then(conv(b["get"][0]))
        store.put_then(conv(b["put"][0]), conv(b["put"][1]))
        fa = store.add_then(conv(b["add"][0]), conv(b["add"][1]))
        ck, cv, ce = b["cas"]
        fc = store.cas_then(conv(ck), conv(ce), conv(cv))
        store.flush()
        outs.append({"get": np.asarray(fg.result()["value"]),
                     "add": np.asarray(fa.result()["value"]),
                     "cas_flag": np.asarray(fc.result()["flag"]),
                     "cas_old": np.asarray(fc.result()["value"])})
    return outs, store.dump()


def _assert_same(got, want, what):
    g_outs, g_table = got
    w_outs, w_table = want
    for i, (g, w) in enumerate(zip(g_outs, w_outs)):
        for k in w:
            assert np.array_equal(g[k], w[k]), f"{what} round {i}: {k}"
    assert np.array_equal(g_table, w_table), f"{what}: final table"


def _port_store(**kw):
    from repro_torch.core import DelegatedKVStore, StackedMesh
    return DelegatedKVStore(StackedMesh((2, 4), device="cpu"), N_KEYS, VW,
                            **kw)


@pytest.mark.parametrize("serve", ["ref", "kernel", "masked"])
@pytest.mark.parametrize("pack", ["ref", "kernel"])
@pytest.mark.parametrize("shortcut", [False, True])
def test_port_matches_sequential_oracle(shortcut, pack, serve):
    import torch
    from repro_torch.core import use_session
    init, rounds = gen_trace(SEED)
    with use_session():
        st = _port_store(capacity=R, local_shortcut=shortcut,
                         pack_impl=pack, serve_impl=serve)
        st.prefill(init)
        got = run_rounds(st, rounds, torch.as_tensor)
        stats = st.session.last_stats()[st.trust.name]
        assert stats["dropped"] == 0 and stats["impl_fallback"] == 0
    _assert_same(got, oracle(init, rounds, shortcut),
                 f"shortcut={shortcut} pack={pack} serve={serve}")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_e2e") / "runs.npz"
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


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("tag", list(CONFIGS))
def test_port_matches_jax_store_on_8_devices(jax_runs, tag, impl):
    import torch
    from repro_torch import convert
    from repro_torch.core import use_session
    init, rounds = gen_trace(SEED)
    state = convert.stacked_from_owner_major(
        {"table": jax_runs[f"{tag}/init"]}, N_DEV, device="cpu")
    with use_session():
        st = _port_store(state=state, pack_impl=impl, serve_impl=impl,
                         **CONFIGS[tag])
        got_outs, _ = run_rounds(st, rounds, torch.as_tensor)
        final = convert.owner_major_from_stacked(
            st.trust.trustee_state())["table"]
    want_outs = [{k: jax_runs[f"{tag}/{i}/{k}"] for k in got_outs[0]}
                 for i in range(N_ROUNDS)]
    _assert_same((got_outs, final), (want_outs, jax_runs[f"{tag}/final"]),
                 f"{tag} impl={impl} vs JAX")
    if tag == "overflow":
        # the case the oracle cannot cover: rows overflowed into the
        # second_round block or were dropped (zero responses)
        assert any((o["get"] == 0).all(axis=1).any() for o in got_outs)


def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import DelegatedKVStore
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    init, rounds = gen_trace(SEED)
    res = {}
    for tag, kw in CONFIGS.items():
        st = DelegatedKVStore(mesh, N_KEYS, VW, **kw)
        st.prefill(init)
        res[f"{tag}/init"] = np.asarray(st.trust.trustee_state()["table"])
        outs, _ = run_rounds(st, rounds, jnp.asarray)
        for i, o in enumerate(outs):
            for k, v in o.items():
                res[f"{tag}/{i}/{k}"] = v
        res[f"{tag}/final"] = np.asarray(st.trust.trustee_state()["table"])
    np.savez(out_path, **res)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
