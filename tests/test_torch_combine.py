"""Request combining of the port (``combine="ref"``;
``channel.RequestCombiner``) against the JAX package on 8 virtual CPU
devices (one subprocess: this module, run as a script), bit for bit on
integer-exact payloads, after ``tests/_combine_battery.py``'s seven
checks: Zipf hot-key GET/PUT/ADD/CAS traces (1,024 ops) shared, with the
shortcut and dedicated; a conflict-heavy Zipf(1.1) trace that must halve
the wire rows; two stores in one fused round; the defer drain with ample
capacity and under pressure.  For every check, with ``combine="ref"``
every response, the final table and the per-round ``rows_combined`` /
``req_bytes_saved`` equal JAX's; with "off" and "ref" every response and
the table equal the sequential oracle's (JAX's "off" run is the oracle's
too, as ``tests/_combine_battery.py`` holds).  The one exception is a settled
divergence: on the fused round's "planes" wire the port moves an int32
element as one 32-bit word and counts 4 bytes, where JAX counts 8 (its
hi/lo f32 planes), so ``req_bytes_saved`` there differs by 4 bytes a
combined row's key.

After ``tests/test_combine_prior.py``: ``RequestCombiner.pre`` / ``post``
as pure functions equal JAX's on the same rows (seeded), and the ADD
priors they rebuild equal a sequential per-request replay exactly.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import subprocess

import numpy as np
import pytest

N_KEYS, VW, R, N_ROUNDS, N_DEV = 37, 2, 64, 16, 8
OPS = ("get", "put", "add", "cas")


def gen_zipf_trace(seed, alpha=1.1, n_keys=N_KEYS, r=R, n_rounds=N_ROUNDS):
    """``_combine_battery.gen_zipf_trace``."""
    from repro_torch.core import SequentialKVReference
    from repro_torch.core.routing import sample_keys
    rng = np.random.default_rng(seed)
    init = rng.integers(0, 8, (n_keys, VW)).astype(np.float32)
    ref = SequentialKVReference(n_keys, VW)
    ref.prefill(init)
    rounds = []
    for _ in range(n_rounds):
        op = OPS[int(rng.integers(0, 4))]
        keys = sample_keys(rng, n_keys, r, "zipf", alpha).astype(np.int32)
        vals = rng.integers(0, 8, (r, VW)).astype(np.float32)
        expect = None
        if op == "cas":
            live = ref.table[keys].copy()
            rand = rng.integers(0, 8, (r, VW)).astype(np.float32)
            expect = np.where(rng.random(r)[:, None] < 0.5, live, rand)
        rounds.append((op, keys, vals, expect))
    return init, rounds


def oracle(init, rounds, n_keys=N_KEYS, order_of=None):
    from repro_torch.core import SequentialKVReference
    ref = SequentialKVReference(n_keys, VW)
    ref.prefill(init)
    out = {}
    for i, (op, keys, vals, expect) in enumerate(rounds):
        perm = order_of(keys) if order_of else np.arange(len(keys))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        k, v = keys[perm], vals[perm]
        if op == "get":
            out[f"{i}/value"] = ref.get(k)[inv]
        elif op == "put":
            ref.put(k, v)
        elif op == "add":
            out[f"{i}/value"] = ref.add(k, v)[inv]
        else:
            f, o = ref.cas(k, expect[perm], v)
            out[f"{i}/flag"], out[f"{i}/value"] = f[inv], o[inv]
    out["table"] = ref.dump()
    return out


def shortcut_order(keys):
    """Serve order with the shortcut: channel rows, then local rows."""
    client = np.arange(R) // (R // N_DEV)
    local = (keys % N_DEV) == client
    return np.concatenate([np.where(~local)[0], np.where(local)[0]])


def replay(store, rounds, conv):
    """The trace through the sync API, each flush's combine stats kept."""
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
        s = store.session.last_stats()[store.trust.name]
        out[f"{i}/stats"] = np.asarray([s["rows_combined"],
                                        s["req_bytes_saved"],
                                        s["residual"]])
    out["table"] = np.asarray(store.dump())
    return out


# name: (trace keywords, store keywords, serve-order model)
CHECKS = {
    "shared": (dict(seed=60), dict(local_shortcut=False), None),
    "shortcut": (dict(seed=61), dict(local_shortcut=True), shortcut_order),
    "dedicated": (dict(seed=62), dict(mode="dedicated", n_dedicated=3),
                  None),
    "conflict_heavy": (dict(seed=63, n_keys=16, r=256, n_rounds=4),
                       dict(local_shortcut=False), None),
    "drain_ample": (dict(seed=65), dict(local_shortcut=False,
                                        overflow="defer", max_rounds=4),
                    None),
}


def mux_run(pkg, mesh, combine, conv):
    """Two stores, ADD + PUT on one and GET on the other, in ONE
    ``session.step()`` a round."""
    from repro_torch.core.routing import sample_keys
    rng = np.random.default_rng(64)
    sess = pkg.TrustSession()
    a = pkg.DelegatedKVStore(mesh, N_KEYS, VW, capacity=96, combine=combine,
                             session=sess, name="a")
    b = pkg.DelegatedKVStore(mesh, 53, VW, capacity=96, combine=combine,
                             session=sess, name="b")
    out = {}
    for rnd in range(6):
        ka = sample_keys(rng, N_KEYS, 96, "zipf", 1.2).astype(np.int32)
        kb = sample_keys(rng, 53, 96, "zipf", 1.2).astype(np.int32)
        va = rng.integers(0, 8, (96, VW)).astype(np.float32)
        f1 = a.trust.op.add.then(conv(ka), conv(va))
        f2 = b.trust.op.get.then(conv(kb))
        a.trust.op.put.then(conv(ka), conv(va))
        stats = sess.step()
        out[f"{rnd}/add"] = np.asarray(f1.result()["value"])
        out[f"{rnd}/get"] = np.asarray(f2.result()["value"])
        out[f"{rnd}/fused"] = np.asarray(
            [len(g) for g in sess.last_step_info["fused"]])
        for name in ("a", "b"):
            out[f"{rnd}/{name}/stats"] = np.asarray(
                [stats[name]["rows_combined"],
                 stats[name]["req_bytes_saved"]])
    out["table_a"], out["table_b"] = np.asarray(a.dump()), np.asarray(
        b.dump())
    return out


def pressure_run(pkg, mesh, conv):
    from repro_torch.core.routing import sample_keys
    rng = np.random.default_rng(66)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    st = pkg.DelegatedKVStore(mesh, N_KEYS, VW, capacity=2,
                              overflow="defer", max_rounds=16,
                              combine="ref", local_shortcut=False)
    st.prefill(init)
    out = {"init": init}
    for i in range(8):
        keys = sample_keys(rng, N_KEYS, R, "zipf", 1.1).astype(np.int32)
        vals = rng.integers(0, 8, (R, VW)).astype(np.float32)
        out[f"{i}/keys"], out[f"{i}/vals"] = keys, vals
        out[f"{i}/value"] = np.asarray(st.add(conv(keys), conv(vals)))
        s = st.session.last_stats()[st.trust.name]
        out[f"{i}/stats"] = np.asarray([s["rounds"], s["residual"],
                                        s["rows_combined"]])
    out["table"] = np.asarray(st.dump())
    return out


def _mesh(pkg):
    if pkg.__name__ == "repro.core":
        import jax
        from jax.sharding import Mesh
        return Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    return pkg.StackedMesh((2, 4), device="cpu")


def run_checks(pkg, conv, pack="ref", serve="ref", combines=("off", "ref")):
    """Every check on one package -> {name/combine/key: array}; JAX runs
    combine "ref" alone (its "off" is the oracle's, as the port's is)."""
    mesh = _mesh(pkg)
    res = {}
    for name, (tkw, skw, _order) in CHECKS.items():
        init, rounds = gen_zipf_trace(**tkw)
        n_keys = tkw.get("n_keys", N_KEYS)
        for combine in combines:
            with pkg.use_session():
                st = pkg.DelegatedKVStore(mesh, n_keys, VW,
                                          capacity=tkw.get("r", R),
                                          combine=combine, pack_impl=pack,
                                          serve_impl=serve, **skw)
                st.prefill(init)
                res.update({f"{name}/{combine}/{k}": v
                            for k, v in replay(st, rounds, conv).items()})
    for combine in combines:
        res.update({f"mux/{combine}/{k}": v
                    for k, v in mux_run(pkg, mesh, combine, conv).items()})
    with pkg.use_session():
        res.update({f"pressure/{k}": v
                    for k, v in pressure_run(pkg, mesh, conv).items()})
    return res


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

IMPLS = (("ref", "ref"), ("kernel", "kernel"))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_combine") / "runs.npz"
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
    return {impl: run_checks(pkg, torch.as_tensor, *impl) for impl in IMPLS}


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
@pytest.mark.parametrize("name", list(CHECKS))
def test_combine_matches_jax_and_the_oracle(jax_runs, port_runs, name, impl):
    tkw, _skw, order = CHECKS[name]
    want = oracle(*gen_zipf_trace(**tkw), n_keys=tkw.get("n_keys", N_KEYS),
                  order_of=order)
    _same(_sub(port_runs[impl], f"{name}/ref"), _sub(jax_runs, f"{name}/ref"),
          f"{name} combine=ref {impl} vs JAX")
    for combine in ("off", "ref"):
        _same(_sub(port_runs[impl], f"{name}/{combine}"), want,
              f"{name} combine={combine} {impl} vs the oracle")
    combined = [_sub(port_runs[impl], f"{name}/{c}") for c in ("off", "ref")]
    n_off = sum(int(v[0]) for k, v in combined[0].items()
                if k.endswith("stats"))
    n_ref = sum(int(v[0]) for k, v in combined[1].items()
                if k.endswith("stats"))
    assert n_off == 0 and n_ref > 0, (n_off, n_ref)
    if name == "conflict_heavy":
        assert n_ref >= 256 * 4 // 2, n_ref


def test_combine_stats_count_the_rows_kept_off_the_wire(port_runs):
    """``rows_combined`` of a solo round is the host count of rows that
    share a (client, destination, op, key) with an earlier row; a row's
    request bytes on the tree wire are its key (4) and, for PUT and ADD,
    its 2 f32 values."""
    res = port_runs[("kernel", "kernel")]
    init, rounds = gen_zipf_trace(seed=60)
    for i, (op, keys, _v, _e) in enumerate(rounds):
        client = np.arange(R) // (R // N_DEV)
        n_rows = 0 if op == "cas" else R - len(set(zip(client, keys)))
        combined, saved, residual = res[f"shared/ref/{i}/stats"]
        assert combined == n_rows and residual == 0, (i, op)
        assert saved == combined * (4 if op == "get" else 12), (i, op)


@pytest.mark.parametrize("impl", IMPLS,
                         ids=lambda i: f"pack_{i[0]}-serve_{i[1]}")
def test_fused_round_combines_as_jax(jax_runs, port_runs, impl):
    """The fused round: every response and table equal JAX's with
    combining on, and the port's with it off; both stores fused, rows
    combined inside the round; the request bytes saved are the port's
    wire words (op and trust int16 lanes 4 bytes each, the int32 key 4,
    two f32 values 8: 20 a row) where JAX counts 24 (its int32 key as two
    planes)."""
    off, ref = (_sub(port_runs[impl], f"mux/{c}") for c in ("off", "ref"))
    want = _sub(jax_runs, "mux/ref")
    _same(ref, want, f"mux combine=ref {impl} vs JAX", skip=("stats",))
    for k in [k for k in want if k.endswith("stats")]:
        assert ref[k][0] == want[k][0], k
        assert ref[k][1] == 20 * ref[k][0], k
        assert want[k][1] == 24 * want[k][0], k
    _same(ref, off, "mux combine ref vs off", skip=("stats",))
    assert not any(v[0] for k, v in off.items() if k.endswith("stats"))
    assert all((off[f"{r}/fused"] == [2]).all() for r in range(6))
    assert sum(int(v[0]) for k, v in ref.items() if k.endswith("stats")) > 0


@pytest.mark.parametrize("impl", IMPLS,
                         ids=lambda i: f"pack_{i[0]}-serve_{i[1]}")
def test_pressured_drain_fully_drains(jax_runs, port_runs, impl):
    """Capacity 2 under pressure: a combined segment is sent or deferred
    whole, so the schedule differs from combining off; the drain still
    empties and the ADD-only table lands on the oracle's; every response,
    the rounds and the rows combined equal JAX's."""
    from repro_torch.core import SequentialKVReference
    got = _sub(port_runs[impl], "pressure")
    _same(got, _sub(jax_runs, "pressure"), f"pressured drain {impl} vs JAX")
    ref = SequentialKVReference(N_KEYS, VW)
    ref.prefill(got["init"])
    for i in range(8):
        ref.add(got[f"{i}/keys"], got[f"{i}/vals"])
        assert got[f"{i}/stats"][1] == 0, got[f"{i}/stats"]
    assert np.array_equal(got["table"], ref.dump())
    assert max(int(got[f"{i}/stats"][0]) for i in range(8)) > 1


# -- the combiner as pure functions (tests/test_combine_prior.py) -----------

N_TRUSTEES, PLANE = 4, 1 << 15


def _combine_case(rng, n):
    n_keys = int(rng.integers(1, 9))
    keys = rng.integers(0, n_keys, n).astype(np.int32)
    deltas = rng.integers(-(PLANE - 1), PLANE, (n, 2)).astype(np.float32)
    dsts = rng.integers(-1, N_TRUSTEES, n).astype(np.int32)
    table = rng.integers(-(PLANE - 1), PLANE, (n_keys, 2)).astype(np.float32)
    return keys, deltas, dsts, table


def _trustee_fetch_add(keys, new_dst, new_vals, table_init):
    """The trustee side, simulated: fetch-and-add the representatives in
    row (slot) order."""
    tables = {d: table_init.copy() for d in range(N_TRUSTEES)}
    resp = np.zeros(new_vals.shape, np.float32)
    for i in range(len(keys)):
        if new_dst[i] < 0:
            continue
        t = tables[new_dst[i] % N_TRUSTEES]
        resp[i] = t[keys[i]]
        t[keys[i]] += new_vals[i]
    return resp


def _port_combine(kind, keys, vals, dsts, table):
    import torch
    from repro_torch.core import channel as ch
    comb = ch.RequestCombiner((ch.CombineSpan(
        kind, key_lane="key", sum_lane="value" if kind == "sum" else None),))
    t = lambda a: torch.as_tensor(a)[None]
    new_dst, new_rows, ctx = comb.pre(
        t(dsts), {"key": t(keys), "value": t(vals)},
        torch.zeros((1, len(keys)), dtype=torch.int32))
    new_dst, new_vals = new_dst[0].numpy(), new_rows["value"][0].numpy()
    resp = _trustee_fetch_add(keys, new_dst, new_vals, table)
    out, dropped = comb.post({"value": t(resp)},
                             torch.zeros((1, len(keys)), dtype=torch.bool),
                             ctx)
    return (new_dst, new_vals, ctx.rep_row[0].numpy(),
            ctx.combined[0].numpy(), out["value"][0].numpy(),
            dropped[0].numpy())


def _jax_combine(kind, keys, vals, dsts, table):
    import jax.numpy as jnp
    from repro.core import channel as jch
    comb = jch.RequestCombiner((jch.CombineSpan(
        kind, key_lane="key", sum_lane="value" if kind == "sum" else None),))
    new_dst, new_rows, ctx = comb.pre(
        jnp.asarray(dsts), {"key": jnp.asarray(keys),
                            "value": jnp.asarray(vals)},
        jnp.zeros((len(keys),), jnp.int32))
    new_dst, new_vals = np.asarray(new_dst), np.asarray(new_rows["value"])
    resp = _trustee_fetch_add(keys, new_dst, new_vals, table)
    out, dropped = comb.post({"value": jnp.asarray(resp)},
                             jnp.zeros((len(keys),), bool), ctx)
    return (new_dst, new_vals, np.asarray(ctx.rep_row),
            np.asarray(ctx.combined), np.asarray(out["value"]),
            np.asarray(dropped))


@pytest.mark.parametrize("kind", ["sum", "dedupe", "last"])
def test_combiner_pre_post_match_jax(kind):
    """20 seeded batches (keys over 1-8 values, -1 destinations,
    16-bit-plane integer deltas): every output of ``pre`` and ``post``
    equals JAX's on batches of 13 and 64 rows (two shapes: JAX compiles
    its eager ops once a shape), and for "sum" the rebuilt priors equal a
    sequential per-request replay of the original rows at 1-64 rows."""
    total = 0
    for seed in range(20):
        rng = np.random.default_rng(seed)
        case = _combine_case(rng, (13, 64)[seed % 2])
        got, want = _port_combine(kind, *case), _jax_combine(kind, *case)
        for g, w, what in zip(got, want, ("dst", "values", "rep_row",
                                          "combined", "responses",
                                          "dropped")):
            assert np.array_equal(g, w), f"seed {seed}: {what}"
        total += int(got[3].sum())
        if kind == "sum":
            case = _combine_case(rng, int(rng.integers(1, 65)))
            keys, deltas, dsts, table = case
            got = _port_combine(kind, *case)
            seq = _trustee_fetch_add(keys, dsts, deltas, table)
            active = dsts >= 0
            assert np.array_equal(got[4][active], seq[active]), seed
    assert total > 0


def test_dedupe_and_last_keep_their_representatives():
    """GET's representative is a segment's first row, PUT's its last; the
    representative's response fans back to every row of the segment."""
    import torch
    from repro_torch.core import channel as ch
    keys = np.array([3, 3, 1, 3, 1], np.int32)
    vals = np.arange(10, dtype=np.float32).reshape(5, 2)
    for kind, want_rep in (("dedupe", [0, 2]), ("last", [3, 4])):
        comb = ch.RequestCombiner((ch.CombineSpan(kind, key_lane="key"),))
        new_dst, _rows, ctx = comb.pre(
            torch.zeros((1, 5), dtype=torch.int32),
            {"key": torch.as_tensor(keys)[None],
             "value": torch.as_tensor(vals)[None]},
            torch.zeros((1, 5), dtype=torch.int32))
        live = new_dst[0].numpy() >= 0
        assert sorted(np.where(live)[0].tolist()) == want_rep, kind
        resp = np.where(live[:, None], keys[:, None] * 100.0, 0.0) \
            .astype(np.float32).repeat(2, 1)
        out, dropped = comb.post({"value": torch.as_tensor(resp)[None]},
                                 torch.zeros((1, 5), dtype=torch.bool), ctx)
        assert np.array_equal(out["value"][0].numpy(),
                              (keys[:, None] * 100.0).repeat(2, 1)), kind
        assert not dropped.any()


def _jax_main(out_path):
    import jax.numpy as jnp
    import repro.core as pkg
    np.savez(out_path, **run_checks(pkg, jnp.asarray, combines=("ref",)))


if __name__ == "__main__":
    _jax_main(sys.argv[1])
