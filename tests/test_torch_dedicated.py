"""Dedicated trustee mode of the port (``TrusteeGroup(mode="dedicated")``)
against the JAX package on 8 virtual CPU devices (one subprocess: this
module, run as a script), bit for bit on integer-exact payloads — every
response, the final owner-major tables, the per-trust stats and the zero
client region:

  * ``tests/_diff_battery.py``: a 16-round GET/PUT/ADD/CAS trace on the
    2x4 mesh with 3 trustees and on the 1x8 mesh with 4, and the mixed
    conflict-heavy rounds (all four ops fused, 5 hot keys) with the pack
    "ref" or the pack kernel and the serve "ref", the serve kernels or
    "masked" — each also against the sequential oracle;
  * ``tests/_md_battery.py``: the 2x4 round trip (responses route back to
    the issuing clients, 5 client shards of zeros), CAS on the 1x8 mesh,
    and ``second_round`` overflow with every row on one trustee;
  * ``tests/_engine_battery.py``'s ``mux_dedicated_matches_sequential``:
    a KV store and a ``FetchRMWStore`` table with 3 trustees in ONE
    ``session.step()`` a round, against the same batches applied solo;
  * ``tests/_streaming_battery.py``'s dedicated pairs: the streaming
    driver at depth 2 against lockstep steps, the serve "ref" and
    "masked";
  * ``tests/_paged_battery.py``'s dedicated page table (4 trustees):
    every wave against the oracle in serve order, conservation, and the
    client shards' state all zeros.

The rows of a round land on the leading client shards, ceil(R / n_clients)
each, as JAX shards them.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import subprocess

import numpy as np
import pytest

N_KEYS, VW, R, N_ROUNDS = 37, 2, 64, 16
OPS = ("get", "put", "add", "cas")
# (pack, serve): each pack ("ref", the kernel's plain version) and each
# serve ("ref", the kernels' plain versions, "masked") at least once
IMPLS = (("ref", "ref"), ("kernel", "kernel"), ("ref", "masked"),
         ("kernel", "masked"))


def _oracle(n_keys, width):
    from repro_torch.core import SequentialKVReference
    return SequentialKVReference(n_keys, width)


def gen_trace(seed, n_keys=N_KEYS, r=R, n_rounds=N_ROUNDS):
    """``_diff_battery.gen_trace``: one op a round, integer-valued rows,
    CAS expects hitting the live value about half the time."""
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 8, (n_keys, VW)).astype(np.float32)
    ref = _oracle(n_keys, VW)
    ref.prefill(init)
    rounds = []
    for _ in range(n_rounds):
        op = OPS[int(rng.integers(0, 4))]
        keys = rng.integers(0, n_keys, r).astype(np.int32)
        vals = rng.integers(0, 8, (r, VW)).astype(np.float32)
        expect = None
        if op == "cas":
            live = ref.table[keys].copy()
            rand = rng.integers(0, 8, (r, VW)).astype(np.float32)
            expect = np.where(rng.random(r)[:, None] < 0.5, live, rand)
        rounds.append((op, keys, vals, expect))
    return init, rounds


def oracle_replay(init, rounds, n_keys=N_KEYS):
    ref = _oracle(n_keys, VW)
    ref.prefill(init)
    out = {}
    for i, (op, keys, vals, expect) in enumerate(rounds):
        if op == "get":
            out[f"{i}/value"] = ref.get(keys)
        elif op == "put":
            ref.put(keys, vals)
        elif op == "add":
            out[f"{i}/value"] = ref.add(keys, vals)
        else:
            out[f"{i}/flag"], out[f"{i}/value"] = ref.cas(keys, expect, vals)
    out["table"] = ref.dump()
    return out


def replay(store, rounds, conv):
    """The trace through the store's sync API -> {key: array}."""
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
    out["table"] = np.asarray(store.dump())
    out["client_region"] = np.asarray(store.client_region())
    return out


# -- the mixed conflict-heavy rounds (_diff_battery) ------------------------

N_HOT, N_MIXED = 5, 4


def gen_mixed_trace(seed):
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    sim = _oracle(N_KEYS, VW)
    sim.prefill(init)
    rounds = []
    for _ in range(N_MIXED):
        batches = {}
        for op in OPS:
            keys = rng.integers(0, N_HOT, R).astype(np.int32)
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


def mixed_oracle(init, rounds):
    ref = _oracle(N_KEYS, VW)
    ref.prefill(init)
    out = {}
    for i, b in enumerate(rounds):
        out[f"{i}/get"] = ref.get(b["get"][0])
        ref.put(*b["put"][:2])
        out[f"{i}/add"] = ref.add(*b["add"][:2])
        out[f"{i}/cas_flag"], out[f"{i}/cas"] = ref.cas(
            b["cas"][0], b["cas"][2], b["cas"][1])
    out["table"] = ref.dump()
    return out


def mixed_replay(store, rounds, conv):
    """Each round's four op batches in ONE flush (op-table order)."""
    out = {}
    for i, b in enumerate(rounds):
        fg = store.get_then(conv(b["get"][0]))
        store.put_then(conv(b["put"][0]), conv(b["put"][1]))
        fa = store.add_then(conv(b["add"][0]), conv(b["add"][1]))
        ck, cv, ce = b["cas"]
        fc = store.trust.submit("cas", store.route(conv(ck)),
                                store._payload(conv(ck), conv(cv), conv(ce)))
        store.flush()
        out[f"{i}/get"] = np.asarray(fg.result()["value"])
        out[f"{i}/add"] = np.asarray(fa.result()["value"])
        out[f"{i}/cas_flag"] = np.asarray(fc.result()["flag"])
        out[f"{i}/cas"] = np.asarray(fc.result()["value"])
    out["table"] = np.asarray(store.dump())
    out["client_region"] = np.asarray(store.client_region())
    return out


# -- _md_battery's dedicated checks ------------------------------------------

def md_2x4(pkg, mesh, conv):
    n_keys = 53
    vals = np.arange(n_keys * 2, dtype=np.float32).reshape(n_keys, 2)
    keys = np.random.default_rng(0).integers(0, n_keys, 64).astype(np.int32)
    st = pkg.DelegatedKVStore(mesh, n_keys, 2, capacity=32,
                              mode="dedicated", n_dedicated=3)
    st.prefill(vals)
    out = {"get": np.asarray(st.get(conv(keys)))}
    st.put(conv(keys), conv(np.full((64, 2), 7, np.float32)))
    out["after_put"] = np.asarray(st.dump())
    out["add"] = np.asarray(st.add(conv(keys), conv(np.ones((64, 2),
                                                            np.float32))))
    out["table"] = np.asarray(st.dump())
    out["client_region"] = np.asarray(st.client_region())
    out["physical"] = physical_table(pkg, st)
    return out


def physical_table(pkg, st):
    """The store's physical table, owner-major: the client region, then
    the trustees' shards (JAX shards it over the whole mesh)."""
    if pkg.__name__ == "repro.core":
        return np.asarray(st.trust.state()["table"])
    from repro_torch import convert
    return convert.owner_major_from_stacked(st.trust.state())["table"]


def md_1x8(pkg, mesh, conv):
    st = pkg.DelegatedKVStore(mesh, 16, 1, capacity=16, mode="dedicated",
                              n_dedicated=4)
    st.prefill(np.zeros((16, 1), np.float32))
    keys = np.array([3] * 8 + [5] * 8, np.int32)
    f, o = st.cas(conv(keys), conv(np.zeros((16, 1), np.float32)),
                  conv(np.arange(16, dtype=np.float32).reshape(16, 1)))
    return {"flag": np.asarray(f), "old": np.asarray(o),
            "table": np.asarray(st.dump()),
            "client_region": np.asarray(st.client_region())}


def md_overflow(pkg, mesh, conv):
    st = pkg.DelegatedKVStore(mesh, 6, 1, capacity=3,
                              overflow="second_round", overflow_capacity=16,
                              mode="dedicated", n_dedicated=2)
    st.prefill(np.zeros((6, 1), np.float32))
    keys = (2 * np.random.default_rng(1).integers(0, 3, 64)).astype(np.int32)
    old = st.add(conv(keys), conv(np.ones((64, 1), np.float32)))
    stats = st.session.last_stats()[st.trust.name]
    return {"old": np.asarray(old), "table": np.asarray(st.dump()),
            "client_region": np.asarray(st.client_region()),
            "stats": np.asarray([stats["rounds"], stats["residual"],
                                 stats["demand_max"]])}


# -- the fused round (_engine_battery) and the streaming driver -------------

E_KEYS, E_R, E_ROUNDS = 67, 48, 8


def gen_pair_trace(seed, n_rounds=E_ROUNDS):
    rng = np.random.default_rng(seed)
    init = rng.integers(1, 8, (E_KEYS, VW)).astype(np.float32)
    rounds = []
    for _ in range(n_rounds):
        op = OPS[int(rng.integers(0, 4))]
        keys = rng.integers(0, E_KEYS, E_R).astype(np.int32)
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


def _resp(op, resp):
    if op == "cas":
        return np.asarray(resp["flag"]), np.asarray(resp["value"])
    return np.asarray(resp["value"]), None


def engine_pair(pkg, mesh, session, other):
    kw = dict(capacity=E_R, mode="dedicated", n_dedicated=3,
              overflow="drop", session=session)
    kv = pkg.DelegatedKVStore(mesh, E_KEYS, VW, name="kv", **kw)
    if other == "rmw-lock":
        return kv, pkg.FetchRMWStore(mesh, E_KEYS, VW, **kw).store
    return kv, pkg.DelegatedKVStore(mesh, E_KEYS, VW, name=other, **kw)


def drive(stores, traces, session, conv, mode):
    """"fused": one session.step() a round (stats kept); "solo": one
    apply a store a round."""
    out = {}
    for rnd in range(len(traces[0][1])):
        futs = []
        for i, (st, (_init, rounds)) in enumerate(zip(stores, traces)):
            op, keys, vals, expect = rounds[rnd]
            args = (op, st.route(conv(keys)),
                    _payload(op, keys, vals, expect, conv))
            if mode == "solo":
                futs.append((i, op, st.trust.apply(*args)))
            else:
                futs.append((i, op, st.trust.submit(*args)))
        if mode == "fused":
            session.step()
            out[f"{rnd}/fused"] = np.asarray(
                [len(g) for g in session.last_step_info["fused"]])
            stats = session.last_stats()
            for i, st in enumerate(stores):
                s = stats[st.trust.name]
                out[f"{rnd}/{i}/stats"] = np.asarray(
                    [s["rounds"], s["residual"], s["demand_max"]])
        for i, op, r in futs:
            r = r if mode == "solo" else r.result()
            v, f = _resp(op, r)
            out[f"{rnd}/{i}/value"] = v
            if f is not None:
                out[f"{rnd}/{i}/flag"] = f
    for i, st in enumerate(stores):
        out[f"final/{i}"] = np.asarray(st.dump())
        out[f"region/{i}"] = np.asarray(st.client_region())
    return out


STREAM_SEEDS = {"ref": (38, 39), "masked": (40, 41)}


def stream_pair(pkg, mesh, session, serve_impl):
    kw = dict(capacity=E_R, mode="dedicated", n_dedicated=3,
              session=session, serve_impl=serve_impl)
    return (pkg.DelegatedKVStore(mesh, E_KEYS, VW, name="kv", **kw),
            pkg.DelegatedKVStore(mesh, E_KEYS, VW, name="kv2", **kw))


def _then(st, op, keys, vals, expect, conv):
    if op == "get":
        return st.get_then(conv(keys))
    if op == "put":
        return st.put_then(conv(keys), conv(vals))
    if op == "add":
        return st.add_then(conv(keys), conv(vals))
    return st.cas_then(conv(keys), conv(expect), conv(vals))


def stream_drive(stores, traces, session, conv, driver=None):
    """Lockstep (one blocking step a wave), or through ``driver``."""
    out = {}
    n = len(traces[0][1])
    for rnd in range(n):
        futs = []
        for i, (st, (_init, rounds)) in enumerate(zip(stores, traces)):
            op, keys, vals, expect = rounds[rnd]
            futs.append((i, op, _then(st, op, keys, vals, expect, conv)))
        if driver is None:
            session.step()
        else:
            driver.admit(2 * E_R)
            driver.dispatch(outputs=[f for _i, _o, f in futs], rows=2 * E_R)
        for i, op, fut in futs:
            out[f"{rnd}/{i}"] = (op, fut)
    if driver is not None:
        driver.drain()
    res = {}
    for key, (op, fut) in out.items():
        if op != "put":
            v, f = _resp(op, fut.result())
            res[f"{key}/value"] = v
            if f is not None:
                res[f"{key}/flag"] = f
    for i, st in enumerate(stores):
        res[f"final/{i}"] = np.asarray(st.dump())
    return res


# -- the page table (_paged_battery) ----------------------------------------

PT = dict(max_seqs=64, n_pages=128, page_size=4, max_pages=4, r=56,
          n_waves=20)
PT_FIELDS = {"alloc": ("pages", "n", "flag"),
             "append": ("page", "n", "flag"), "free": ("n", "flag"),
             "lookup": ("pages", "n", "flag")}


def gen_paged_waves(seed):
    rng = np.random.default_rng(seed)
    known, waves = set(), []
    r, mp, ps = PT["r"], PT["max_pages"], PT["page_size"]
    for _ in range(PT["n_waves"]):
        op = rng.choice(["alloc", "append", "append", "lookup", "free"],
                        p=[0.2, 0.25, 0.25, 0.2, 0.1])
        if op == "free" and len(known) < r:
            op = "append"
        if op == "alloc":
            seqs = rng.integers(0, PT["max_seqs"], r).astype(np.int32)
            extra = rng.integers(1, mp + 1, r).astype(np.int32)
            known.update(int(s) for s in seqs)
        elif op == "append":
            seqs = rng.integers(0, PT["max_seqs"], r).astype(np.int32)
            extra = rng.integers(0, mp * ps, r).astype(np.int32)
            known.update(int(s) for s in seqs)
        elif op == "lookup":
            seqs = rng.integers(0, PT["max_seqs"], r).astype(np.int32)
            extra = None
        else:
            seqs = rng.choice(sorted(known), r, replace=False) \
                .astype(np.int32)
            extra = None
            known.difference_update(int(s) for s in seqs)
        waves.append((str(op), seqs, extra))
    return waves


def paged_run(pkg, mesh, session):
    """Every wave as ONE engine round -> {key: array}."""
    pt = pkg.DelegatedPageTable(mesh, PT["n_pages"],
                                max_seqs=PT["max_seqs"],
                                page_size=PT["page_size"],
                                max_pages=PT["max_pages"], capacity=PT["r"],
                                mode="dedicated", n_dedicated=4,
                                session=session)
    out = {}
    for i, (op, seqs, extra) in enumerate(gen_paged_waves(92)):
        call = getattr(pt, f"{op}_then")
        fut = call(seqs, extra) if extra is not None else call(seqs)
        session.step()
        fields = tuple(f for f in ("pages", "page") if f in PT_FIELDS[op])
        got = pt.globalize(fut.result(), seqs, fields=fields)
        for f in PT_FIELDS[op]:
            out[f"{i}/{f}"] = np.asarray(got[f])
    for k, v in pt.dump().items():
        out[f"state/{k}"] = np.asarray(v)
    out["audit"] = np.asarray([pt.audit()["allocated"],
                               pt.audit()["evictions"],
                               int(pt.audit()["consistent"])])
    return out, pt


# ---------------------------------------------------------------------------
# both sides
# ---------------------------------------------------------------------------

def _meshes(pkg):
    if pkg.__name__ == "repro.core":
        import jax
        from jax.sharding import Mesh
        devs = np.array(jax.devices())
        return {"2x4": Mesh(devs.reshape(2, 4), ("data", "model")),
                "1x8": Mesh(devs.reshape(1, 8), ("data", "model"))}
    return {"2x4": pkg.StackedMesh((2, 4), device="cpu"),
            "1x8": pkg.StackedMesh((1, 8), device="cpu")}


def run_cases(pkg, conv, pack="ref", serve="ref"):
    """Every case of the module on one package -> {name/key: array}.  The
    port takes ``pack`` / ``serve`` ("kernel": the CUDA kernels' plain
    versions on the CPU); JAX runs "ref"."""
    meshes = _meshes(pkg)
    kw = dict(pack_impl=pack, serve_impl=serve, capacity=R)
    res = {}

    def put(name, d):
        res.update({f"{name}/{k}": v for k, v in d.items()})

    for name, mesh, seed, t in (("diff_2x4", "2x4", 44, 3),
                                ("diff_1x8", "1x8", 45, 4)):
        with pkg.use_session():
            init, rounds = gen_trace(seed)
            st = pkg.DelegatedKVStore(meshes[mesh], N_KEYS, VW,
                                      mode="dedicated", n_dedicated=t, **kw)
            st.prefill(init)
            put(name, replay(st, rounds, conv))
    with pkg.use_session():
        init, rounds = gen_mixed_trace(52)
        st = pkg.DelegatedKVStore(meshes["2x4"], N_KEYS, VW,
                                  mode="dedicated", n_dedicated=3, **kw)
        st.prefill(init)
        put("mixed", mixed_replay(st, rounds, conv))
    for name, fn, mesh in (("md_2x4", md_2x4, "2x4"),
                           ("md_1x8", md_1x8, "1x8"),
                           ("md_overflow", md_overflow, "2x4")):
        with pkg.use_session():
            put(name, fn(pkg, meshes[mesh], conv))
    return res


def run_sessions(pkg, conv):
    """The fused pair, the lockstep streaming pairs and the page table."""
    mesh = _meshes(pkg)["2x4"]
    res = {}
    sess = pkg.TrustSession()
    stores = engine_pair(pkg, mesh, sess, "rmw-lock")
    traces = [gen_pair_trace(s) for s in (14, 15)]
    for st, (init, _r) in zip(stores, traces):
        st.prefill(init)
    res.update({f"mux/{k}": v
                for k, v in drive(stores, traces, sess, conv,
                                  "fused").items()})
    for impl, seeds in STREAM_SEEDS.items():
        sess = pkg.TrustSession()
        stores = stream_pair(pkg, mesh, sess, impl)
        traces = [gen_pair_trace(s, 12) for s in seeds]
        for st, (init, _r) in zip(stores, traces):
            st.prefill(init)
        res.update({f"stream_{impl}/{k}": v
                    for k, v in stream_drive(stores, traces, sess,
                                             conv).items()})
    out, _pt = paged_run(pkg, mesh, pkg.TrustSession())
    res.update({f"paged/{k}": v for k, v in out.items()})
    return res


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dedicated") / "runs.npz"
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


def _sub(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "/")}


def _same(got, want, what):
    assert want, what
    for k in sorted(want):
        assert k in got, f"{what}: {k} missing"
        assert got[k].shape == want[k].shape and np.array_equal(
            got[k], want[k]), f"{what}: {k} differs:\n{got[k]}\n{want[k]}"


@pytest.fixture(scope="module")
def port_cases():
    import torch
    import repro_torch.core as pkg
    return {impl: run_cases(pkg, torch.as_tensor, *impl) for impl in IMPLS}


@pytest.fixture(scope="module")
def port_sessions():
    import torch
    import repro_torch.core as pkg
    return run_sessions(pkg, torch.as_tensor)


@pytest.mark.parametrize("impl", IMPLS,
                         ids=lambda i: f"pack_{i[0]}-serve_{i[1]}")
@pytest.mark.parametrize("case", ["diff_2x4", "diff_1x8", "mixed", "md_2x4",
                                  "md_1x8", "md_overflow"])
def test_dedicated_store_matches_jax_on_8_devices(jax_runs, port_cases,
                                                  case, impl):
    got = _sub(port_cases[impl], case)
    _same(got, _sub(jax_runs, case), f"{case} {impl} vs JAX")
    region = got["client_region"]
    assert region.size and not region.any(), f"{case}: client shards hold " \
        f"state"


@pytest.mark.parametrize("case,seed", [("diff_2x4", 44), ("diff_1x8", 45)])
def test_dedicated_trace_matches_the_oracle(port_cases, case, seed):
    want = oracle_replay(*gen_trace(seed))
    _same(_sub(port_cases[("kernel", "kernel")], case), want,
          f"{case} vs the oracle")


def test_mixed_dedicated_rounds_match_the_oracle(port_cases):
    want = mixed_oracle(*gen_mixed_trace(52))
    for impl, res in port_cases.items():
        _same(_sub(res, "mixed"), want, f"mixed {impl} vs the oracle")


def test_md_dedicated_checks(port_cases):
    """The battery's own assertions: GET routes back to the issuing
    clients, PUT and ADD land on the trustees, 5 client shards of zeros;
    every same-key CAS on the 1x8 mesh races value 0 and the last writer
    wins; every overflowing ADD lands."""
    res = port_cases[("kernel", "kernel")]
    vals = np.arange(106, dtype=np.float32).reshape(53, 2)
    keys = np.random.default_rng(0).integers(0, 53, 64)
    assert np.array_equal(res["md_2x4/get"], vals[keys])
    cnt = np.bincount(keys, minlength=53)
    want = np.where(cnt[:, None] > 0, 7 + cnt[:, None], vals)
    assert np.array_equal(res["md_2x4/table"], want.astype(np.float32))
    assert res["md_2x4/client_region"].shape == (5 * 18, 2)
    assert res["md_1x8/flag"].sum() == 16 and not res["md_1x8/old"].any()
    assert res["md_1x8/table"][3, 0] == 7 and res["md_1x8/table"][5, 0] == 15
    ok = (2 * np.random.default_rng(1).integers(0, 3, 64))
    assert np.array_equal(res["md_overflow/table"][:, 0],
                          np.bincount(ok, minlength=6).astype(np.float32))


def test_convert_carries_the_client_region(jax_runs, port_cases):
    """``convert`` between JAX's physical dedicated table (owner-major, the
    client region first) and the port's stacked one: the logical table
    stacks behind 5 client shards of zeros into the port's state, bit for
    bit, and stripping the region gives the logical table back."""
    from repro_torch import convert
    phys = jax_runs["md_2x4/physical"]
    assert phys.shape == (8 * 18, 2)
    assert np.array_equal(port_cases[("kernel", "kernel")]
                          ["md_2x4/physical"], phys)
    stacked = convert.stacked_from_owner_major({"table": phys[5 * 18:]}, 3,
                                               device="cpu", n_clients=5)
    assert np.array_equal(stacked["table"].numpy().reshape(-1, 2), phys)
    back = convert.owner_major_from_stacked(stacked, n_clients=5)["table"]
    assert np.array_equal(back, phys[5 * 18:])


def test_fused_dedicated_round_matches_jax_and_solo_rounds(jax_runs,
                                                           port_sessions):
    import torch
    import repro_torch.core as pkg
    got = _sub(port_sessions, "mux")
    _same(got, _sub(jax_runs, "mux"), "fused dedicated round vs JAX")
    assert all((got[f"{r}/fused"] == [2]).all() for r in range(E_ROUNDS))
    sess = pkg.TrustSession()
    stores = engine_pair(pkg, pkg.StackedMesh((2, 4), device="cpu"),
                         pkg.TrustSession(), "rmw-lock")
    traces = [gen_pair_trace(s) for s in (14, 15)]
    for st, (init, _r) in zip(stores, traces):
        st.prefill(init)
    solo = drive(stores, traces, sess, torch.as_tensor, "solo")
    _same(got, solo, "fused vs solo rounds")
    for k, v in got.items():
        if k.startswith("region/"):
            assert v.size and not v.any(), k


@pytest.mark.parametrize("impl", list(STREAM_SEEDS))
def test_streaming_dedicated_matches_lockstep_and_jax(jax_runs,
                                                      port_sessions, impl):
    import torch
    import repro_torch.core as pkg
    from repro_torch.launch.streaming import AdmissionControl, StreamingDriver
    lock = _sub(port_sessions, f"stream_{impl}")
    _same(lock, _sub(jax_runs, f"stream_{impl}"),
          f"lockstep dedicated {impl} vs JAX")
    sess = pkg.TrustSession()
    stores = stream_pair(pkg, pkg.StackedMesh((2, 4), device="cpu"), sess,
                         impl)
    traces = [gen_pair_trace(s, 12) for s in STREAM_SEEDS[impl]]
    for st, (init, _r) in zip(stores, traces):
        st.prefill(init)
    drv = StreamingDriver(sess, depth=2,
                          admission=AdmissionControl(2 * E_R * 3))
    got = stream_drive(stores, traces, sess, torch.as_tensor, drv)
    _same(got, lock, f"streaming dedicated {impl} vs lockstep")
    overlap = any(
        kind == "consume" and any(
            k == "dispatch" and w > wid for k, w in
            drv.events[:drv.events.index(("consume", wid))])
        for kind, wid in drv.events)
    assert overlap, drv.events


def test_dedicated_page_table_matches_jax_and_the_oracle(jax_runs,
                                                         port_sessions):
    import repro_torch.core as pkg
    got = _sub(port_sessions, "paged")
    _same(got, _sub(jax_runs, "paged"), "dedicated page table vs JAX")
    oracle = pkg.SequentialPageTable(PT["n_pages"], PT["max_seqs"],
                                     PT["page_size"], PT["max_pages"], 4)
    for i, (op, seqs, extra) in enumerate(gen_paged_waves(92)):
        want = getattr(oracle, op)(*((seqs, extra) if extra is not None
                                     else (seqs,)))
        for f in PT_FIELDS[op]:
            assert np.array_equal(got[f"{i}/{f}"], want[f]), (i, op, f)
    for k, v in oracle.dump().items():
        assert np.array_equal(got[f"state/{k}"], v), k
    allocated, evictions, consistent = got["audit"]
    assert consistent and evictions > 0, got["audit"]
    _out, pt = paged_run(pkg, pkg.StackedMesh((2, 4), device="cpu"),
                         pkg.TrustSession())
    region = pt.client_region()
    assert set(region) == set(pt.trust.state()) and all(
        v.size and not v.any() for v in region.values()), region
    assert pt.trust.state()["used"].shape[0] == 8 and pt.t == 4


def test_dedicated_layout_rows_and_refusals():
    """Rows land on the leading client shards, ceil(R / n_clients) each,
    and never on a trustee shard; ``n_dedicated`` outside (0, D) and a
    sub-axis dedicated group raise as in JAX; ``local_trustees`` follows
    the session-wide mode."""
    import torch
    import repro_torch.core as pkg
    from repro_torch.core import channel as ch, meshctx
    from repro_torch.core.engine import _shard_rows
    mesh = pkg.StackedMesh((2, 4), device="cpu")
    dst, rows, r_dev = _shard_rows(
        torch.arange(11, dtype=torch.int32), {"k": torch.arange(11)},
        pkg.TrusteeGroup(mesh, ("data", "model"), mode="dedicated",
                         n_dedicated=3))
    assert r_dev == 3 and (dst[5:] == -1).all()
    assert dst[:4].reshape(-1)[:11].tolist() == list(range(11))
    cfg = ch.ChannelConfig(mode="dedicated", n_clients=5)
    slots = ch._to_device_slots(torch.zeros((8, 2), dtype=torch.int32), cfg)
    assert (slots[:5] == 5).all() and (slots[5:] == -1).all()
    assert cfg.n_slots(3) == 8
    for n in (0, 8):
        with pytest.raises(ValueError, match=r"n_dedicated must be in"):
            pkg.TrusteeGroup(mesh, ("data", "model"), mode="dedicated",
                             n_dedicated=n)
    with pytest.raises(ValueError, match="whole mesh"):
        pkg.TrusteeGroup(mesh, "model", mode="dedicated", n_dedicated=2)
    prev = meshctx.delegation_mode()
    try:
        with pkg.use_mesh(mesh):
            meshctx.set_delegation_mode("dedicated", 3)
            g = pkg.local_trustees()
            assert (g.mode, g.n_trustees, g.n_clients) == ("dedicated", 3, 5)
            with pytest.raises(ValueError, match="whole mesh"):
                pkg.local_trustees(axis="model", mode="dedicated")
    finally:
        meshctx.set_delegation_mode(*prev)


def _jax_main(out_path):
    import jax.numpy as jnp
    import repro.core as pkg
    res = run_cases(pkg, jnp.asarray)
    res.update(run_sessions(pkg, jnp.asarray))
    np.savez(out_path, **res)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
