"""The port's examples (``repro_torch.examples``) against the JAX package's
``examples/`` on the same inputs.  JAX's side runs once, in one
subprocess on 8 virtual CPU devices (this module, run as a script); the
port's on 8 shards stacked on the CPU.

  * quickstart: every printed value, and the engine stats on the keys the
    settled divergences leave equal (``resp_bytes_saved`` and
    ``req_bytes_saved`` are the wire formats', ROADMAP);
  * delegated_moe: ``run_routing(n_experts=8, n_tokens=32, n_waves=6,
    seed=3)`` — assignments, delegated counts, host tally — bit for bit
    with JAX's (its test's case, one device); one add round with the
    shortcut on 8 shards bit for bit with JAX's 8 devices;
  * serve_kv: the trust and rw-lock GET responses of two rounds at 1024
    keys and 256 requests, bit for bit with each other, with
    ``SequentialKVReference`` and with JAX's stores;
  * train_lm at the 10m preset for 6 steps: finite losses.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import ast
import contextlib
import importlib.util
import io
import subprocess

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
N_KEYS, REQUESTS, ROUNDS, WRITE_PCT, W = 1024, 256, 2, 5, 4
SAME_STATS = ("rounds", "residual", "demand_max", "rows_combined",
              "impl_fallback")


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side on one intra-op thread: SMOKE-sized ops gain
    nothing from more, and beside the other test workers on the same
    cores the extra threads spin against them."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serve_kv_traffic():
    """The table and each round's keys and write mask (serve_kv's
    zipf traffic, from one seed)."""
    from repro_torch.core.routing import sample_keys
    rng = np.random.default_rng(0)
    table = rng.normal(size=(N_KEYS, W)).astype(np.float32)
    rounds = []
    for _ in range(ROUNDS):
        keys = sample_keys(rng, N_KEYS, REQUESTS, "zipf")
        rounds.append((keys, rng.random(REQUESTS) < WRITE_PCT / 100))
    return table, rounds


# quickstart's printed lines: (prefix, name, how its value reads)
_QUICKSTART = (
    ("counter value: ", "counter", lambda v: float(v.split()[0])),
    ("typed API rejected a bad batch: ", "schema_error", str),
    ("async then-callback saw counter = ", "then_value", float),
    ("GET [3, 5] -> ", "get", None),
    ("three racing fetch-and-adds on key 3 returned (FIFO): ",
     "fetch_adds", None),
    ("fused-round GET [3, 5] -> ", "fused_get", None),
    ("fused-round counters -> ", "fused_counters", None),
    ("engine stats: ", "stats", ast.literal_eval),
    ("dedicated-mode GET [3, 5] -> ", "dedicated_get", None),
)


def _parse_quickstart(text):
    """The values a quickstart printed, by name (arrays as f32)."""
    out = {}
    for line in text.splitlines():
        for prefix, name, read in _QUICKSTART:
            if line.startswith(prefix):
                v = line[len(prefix):]
                out[name] = np.array(v.strip("[] ").split(), np.float32) \
                    if read is None else read(v)
                break
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    import pickle
    out = tmp_path_factory.mktemp("jax_examples") / "runs.pkl"
    src = os.path.join(ROOT, "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([src,
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def test_quickstart_prints_jaxs_values(jax_runs):
    from repro_torch.core import use_session
    from repro_torch.examples import quickstart
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), use_session():
        got = quickstart.run("cpu")
    # the port's own lines parse to what it returned
    printed = _parse_quickstart(buf.getvalue())
    want = _parse_quickstart(jax_runs["quickstart"])
    assert set(printed) == set(want) == set(got)
    assert got["counter"] == want["counter"] == 19.0
    assert got["then_value"] == want["then_value"]
    assert got["schema_error"] == want["schema_error"]
    for k in ("get", "fetch_adds", "fused_get", "fused_counters",
              "dedicated_get"):
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(printed[k], want[k]), k
    assert set(got["stats"]) == set(want["stats"])
    for name, st in want["stats"].items():
        for k in SAME_STATS:
            assert got["stats"][name][k] == st[k], (name, k)


def test_delegated_moe_routing_bit_for_bit(jax_runs):
    from repro_torch.core import StackedMesh, use_session
    from repro_torch.examples import delegated_moe as dm
    want = jax_runs["moe"]
    with use_session():
        res = dm.run_routing(StackedMesh((1, 8), device="cpu"), n_experts=8,
                             n_tokens=32, n_waves=6, seed=3)
        live = res["counters"].get(np.arange(8, dtype=np.int32))
    for k in ("assignments", "delegated", "host_tally"):
        assert np.array_equal(res[k], want[k]), k
    assert np.array_equal(live.astype(np.int64), want["delegated"])
    assert res["imbalance_biased"] == want["imbalance_biased"]
    assert res["imbalance_unbiased"] == want["imbalance_unbiased"]
    with use_session():
        c = dm.DelegatedExpertCounters(StackedMesh((1, 8), device="cpu"),
                                       4, capacity=8)
        got = c.add(np.array([1, 1, 3, 1, 3], np.int32))
        assert got.tolist() == want["add_8_shards"]
        assert c.dump().tolist() == [0, 3, 0, 2]


def test_serve_kv_responses_bit_for_bit(jax_runs):
    from repro_torch.core import SequentialKVReference, StackedMesh
    from repro_torch.core import use_session
    from repro_torch.examples import serve_kv
    table, rounds = serve_kv_traffic()
    mesh = StackedMesh((1, 8), device="cpu")
    got = {}
    with use_session():
        store = serve_kv.DelegatedKVStore(mesh, N_KEYS, W)
        lock = serve_kv.FetchRMWStore(mesh, N_KEYS, W, rw_lock=True)
        for backend, st in (("trust", store), ("rw-lock", lock)):
            st.prefill(table)
            got[backend] = [serve_kv.service_round(
                st, keys, wr, backend).numpy() for keys, wr in rounds]
    ref = SequentialKVReference(N_KEYS, W)
    ref.prefill(table)
    for i, (keys, wr) in enumerate(rounds):
        reads = ~wr
        want = ref.get(keys)
        ref.put(keys[wr], np.ones((int(wr.sum()), W), np.float32))
        for backend in ("trust", "rw-lock"):
            g = got[backend][i]
            assert np.array_equal(g[reads], want[reads]), (backend, i)
            assert np.array_equal(
                g[reads], jax_runs["serve_kv"][backend][i][reads]), \
                (backend, i)
        assert not got["trust"][i][wr].any()
    assert np.array_equal(store.dump(), ref.dump())
    assert np.array_equal(lock.dump(), ref.dump())
    assert np.array_equal(store.dump(), jax_runs["serve_kv"]["final"])


def test_train_lm_losses_finite(tmp_path):
    from repro_torch.examples import train_lm
    stats = {}
    hist = train_lm.main(["--preset", "10m", "--steps", "6", "--ckpt-dir",
                          str(tmp_path), "--device", "cpu"], stats=stats)
    assert [s for s, _ in hist] == list(range(6))
    assert np.isfinite([l for _, l in hist]).all()
    assert all(np.isfinite(m["grad_norm"]) for m in stats["metrics"])


# ---------------------------------------------------------------------------
# JAX's side (the module run as a script on 8 virtual devices)
# ---------------------------------------------------------------------------

def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_serve_kv():
    """JAX's ``examples/serve_kv.py`` service round (a closure there),
    over JAX's stores on the 8 devices, on the same traffic."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import (DelegatedKVStore, FetchRMWStore,
                            conflict_ranks, current_session)
    devs = np.array(jax.devices())
    mesh = Mesh(devs.reshape(1, len(devs)), ("data", "model"))
    table, rounds = serve_kv_traffic()
    store = DelegatedKVStore(mesh, N_KEYS, W)
    store.prefill(table)
    lock = FetchRMWStore(mesh, N_KEYS, W, rw_lock=True)
    lock.prefill(table)

    def service_round(st, keys_np, is_write, backend):
        keys = jnp.asarray(keys_np)
        vals = jnp.ones((len(keys_np), W), jnp.float32)
        if backend == "trust":
            g = st.trust.op.get.then(keys, where=jnp.asarray(~is_write))
            st.trust.op.put.then(keys, vals, where=jnp.asarray(is_write))
            current_session().step()
            return g.result()["value"]
        gk = jnp.where(jnp.asarray(~is_write), keys, -1)
        out = st.get(gk)
        wk = keys_np[is_write]
        if len(wk):
            ranks, n = conflict_ranks(wk, len(devs))
            st.put(jnp.asarray(wk), vals[: len(wk)], ranks, min(n, 16))
        return out

    res = {}
    for backend, st in (("trust", store), ("rw-lock", lock)):
        res[backend] = [np.asarray(service_round(st, k, w, backend))
                        for k, w in rounds]
    res["final"] = store.dump()
    return res


def _jax_main(out_path):
    import pickle
    import jax
    from jax.sharding import Mesh
    runs = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _load_example("quickstart").main()
    runs["quickstart"] = buf.getvalue()
    moe = _load_example("delegated_moe")
    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    res = moe.run_routing(mesh1, n_experts=8, n_tokens=32, n_waves=6,
                          seed=3)
    mesh8 = Mesh(np.array(jax.devices()).reshape(1, -1), ("data", "model"))
    c = moe.DelegatedExpertCounters(mesh8, 4, capacity=8)
    runs["moe"] = {k: res[k] for k in ("assignments", "delegated",
                                       "host_tally", "imbalance_biased",
                                       "imbalance_unbiased")}
    runs["moe"]["add_8_shards"] = c.add(
        np.array([1, 1, 3, 1, 3], np.int32)).tolist()
    runs["serve_kv"] = _jax_serve_kv()
    with open(out_path, "wb") as f:
        pickle.dump(runs, f)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
