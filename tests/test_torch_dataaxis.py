"""The data axis of the port against the JAX package on a (2, 4) mesh of 8
virtual CPU devices (one subprocess: this module, run as a script).

Sub-axis trustee groups (``TrusteeGroup(mesh, "model")``: 4 trustees, the
state in 2 replicas, one per data row), on integer-exact payloads, bit
for bit:

  * JAX's replica semantics: both data rows PUT one key, each row's round
    writes its own replica, a GET from a row reads that row's replica and
    the read-back (``dump``) shows data row 0's; also a group over
    ``"data"`` (trustee ``i // 4``, replica ``i % 4``), shortcut on and
    off;
  * a sub-axis KV store over several rounds of GET / PUT / ADD / CAS
    batches: shortcut on and off, ``second_round``, ``defer``
    (``max_rounds`` 3) and ``combine="ref"``, each with the port's kernel
    serve and its plain one — every response, the round's stats and the
    read-back;
  * a fused round of two sub-axis trusts, and a whole-mesh trust of the
    same session that does not fuse with them;
  * a sub-axis page table (alloc, lookup, append from both data rows,
    the read-back and its audit);
  * ``local_trustees()`` (the 4-trustee ``"model"`` group) and
    ``local_trustees(("data", "model"))`` (8 trustees);
  * a sub-axis trust's checkpoint (its manifest entry and its logical
    state: replica 0), a kill of one shard, ``re_entrust`` onto the 7
    survivors from the snapshot and the replayed rounds;
  * ``launch/mesh.py``'s meshes: JAX's shapes and axis names.

The data axis of the models (the delegated MoE, decode, serve, training)
is in the second half of this module.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import json
import shutil
import subprocess
import tempfile

import numpy as np
import pytest

N_KEYS, VW, R, N_ROUNDS = 61, 2, 48, 3
STATS = ("rounds", "residual", "demand_max", "rows_combined",
         "req_bytes_saved", "resp_bytes_saved")
# name: (group axis, store knobs, key range of the trace)
KV_CASES = {
    "model_shortcut": ("model", dict(capacity=8, local_shortcut=True),
                       N_KEYS),
    "model_no_shortcut": ("model", dict(capacity=8, local_shortcut=False),
                          N_KEYS),
    "model_second_round": ("model", dict(capacity=2, local_shortcut=False,
                                         overflow="second_round",
                                         overflow_capacity=1), N_KEYS),
    "model_defer": ("model", dict(capacity=1, overflow="defer",
                                  max_rounds=3, local_shortcut=True),
                    N_KEYS),
    "model_combine": ("model", dict(capacity=8, combine="ref",
                                    local_shortcut=False), 9),
    "data_shortcut": ("data", dict(capacity=8, local_shortcut=True),
                      N_KEYS),
}
PROBES = [(axis, sc) for axis in ("model", "data") for sc in (True, False)]


# ---------------------------------------------------------------------------
# the runs both packages make
# ---------------------------------------------------------------------------

def gen_trace(seed, key_range=N_KEYS, n_rounds=N_ROUNDS):
    """Per round one or two op batches of R rows (integer-valued
    payloads): R / 8 rows on each of the 8 origin shards, so each data
    row draws its own stream."""
    rng = np.random.default_rng(seed)
    init = rng.integers(1, 8, (N_KEYS, VW)).astype(np.float32)
    rounds = []
    for _ in range(n_rounds):
        n_ops = int(rng.integers(1, 3))
        batch = []
        for op in rng.choice(["get", "put", "add", "cas"], n_ops,
                             replace=False):
            k = rng.integers(0, key_range, R).astype(np.int32)
            v = rng.integers(0, 8, (R, VW)).astype(np.float32)
            e = rng.integers(0, 8, (R, VW)).astype(np.float32)
            batch.append((str(op), k, v, e))
        rounds.append(batch)
    return init, rounds


def _payload(op, k, v, e, conv):
    p = {"key": conv(k)}
    if op != "get":
        p["value"] = conv(v)
    if op == "cas":
        p["expect"] = conv(e)
    return p


def _knobs(pkg, kw, impl):
    kw = dict(kw)
    if pkg.__name__ == "repro.core":
        kw.update(pack_impl="ref", serve_impl="ref")
    else:
        kw.update(pack_impl=impl, serve_impl=impl)
    return kw


def drive(stores, rounds_of, sess, conv, fused):
    """Queue each store's op batches of a round, then one
    ``session.step()`` (``fused``) or one flush a store; returns every
    response, each round's stats and the read-backs."""
    out = {}
    for rnd in range(len(rounds_of[0])):
        futs = []
        for sid, st in enumerate(stores):
            for bi, (op, k, v, e) in enumerate(rounds_of[sid][rnd]):
                futs.append((f"{rnd}/{sid}/{bi}", st.trust.submit(
                    op, st.route(conv(k)), _payload(op, k, v, e, conv))))
        if fused:
            sess.step()
            out[f"{rnd}/fused"] = np.asarray(
                [len(g) for g in sess.last_step_info["fused"]]
                + [-len(sess.last_step_info["solo"])])
        else:
            for st in stores:
                st.flush()
        stats = sess.last_stats()
        for sid, st in enumerate(stores):
            s = stats[st.trust.name]
            # a fused round moves the "planes" wire, whose int32 columns
            # JAX counts as two 16-bit planes and the port as one word:
            # its resp_bytes_saved differ by design
            keys = STATS[:-1] if fused and st.trust.group.axis_size < 8 \
                else STATS
            out[f"{rnd}/{sid}/stats"] = np.asarray(
                [int(s[k]) for k in keys])
        for key, fut in futs:
            for field, val in fut.result().items():
                out[f"{key}/{field}"] = np.asarray(val)
    for sid, st in enumerate(stores):
        out[f"final/{sid}"] = np.asarray(st.dump())
    return out


def run_probe(pkg, mesh, conv, axis, shortcut):
    """Data row 0's shards PUT key 5 := 100 + shard, data row 1's := 200
    + shard; then every shard GETs key 5."""
    with pkg.use_session(pkg.TrustSession()):
        st = pkg.DelegatedKVStore(mesh, 16, 1, axis=axis,
                                  local_shortcut=shortcut,
                                  **_knobs(pkg, {}, "ref"))
        keys = np.full(8, 5, np.int32)
        vals = np.asarray([[100 + i if i < 4 else 200 + i]
                           for i in range(8)], np.float32)
        st.put(conv(keys), conv(vals))
        return {"get": np.asarray(st.get(conv(keys)))[:, 0],
                "dump": np.asarray(st.dump())[:, 0],
                "n_trustees": np.asarray(st.trust.n_trustees)}


def run_kv(pkg, mesh, conv, name, impl="ref"):
    axis, kw, key_range = KV_CASES[name]
    init, rounds = gen_trace(30 + sorted(KV_CASES).index(name), key_range)
    with pkg.use_session(pkg.TrustSession()) as sess:
        st = pkg.DelegatedKVStore(mesh, N_KEYS, VW, axis=axis, name="kv",
                                  **_knobs(pkg, kw, impl))
        st.prefill(init)
        return drive([st], [rounds], sess, conv, fused=False)


def run_fused(pkg, mesh, conv, impl="ref"):
    """Two sub-axis trusts fuse into one round; a whole-mesh trust of the
    same session flushes solo beside them."""
    traces = [gen_trace(50 + i) for i in range(3)]
    with pkg.use_session(pkg.TrustSession()) as sess:
        stores = [pkg.DelegatedKVStore(
            mesh, N_KEYS, VW, axis=axis, name=name,
            **_knobs(pkg, dict(capacity=8, local_shortcut=False), impl))
            for name, axis in (("a", "model"), ("b", "model"),
                               ("whole", ("data", "model")))]
        for st, (init, _r) in zip(stores, traces):
            st.prefill(init)
        return drive(stores, [r for _i, r in traces], sess, conv,
                     fused=True)


FO_ROUNDS, FO_SNAP, FO_KILL = 6, 3, 4


def run_failover(pkg, mesh, conv, ckdir, impl="ref"):
    """A sub-axis store: rounds 0-2, a snapshot, rounds 3-4, shard 5
    killed before round 4's retry, re-entrusted onto the 7 survivors from
    the snapshot, rounds 3.. replayed and the trace finished."""
    init, rounds = gen_trace(70, n_rounds=FO_ROUNDS)
    out = {}
    with pkg.use_session(pkg.TrustSession()) as sess:
        st = pkg.DelegatedKVStore(
            mesh, N_KEYS, VW, axis="model", name="kv",
            **_knobs(pkg, dict(capacity=16, local_shortcut=False), impl))
        st.prefill(init)

        def one(rnd, tag):
            futs = [(bi, st.trust.submit(op, st.route(conv(k)),
                                         _payload(op, k, v, e, conv)))
                    for bi, (op, k, v, e) in enumerate(rounds[rnd])]
            sess.step()
            for bi, fut in futs:
                for field, val in fut.result().items():
                    out[f"{tag}{rnd}/{bi}/{field}"] = np.asarray(val)

        for rnd in range(FO_KILL):
            one(rnd, "")
            if rnd + 1 == FO_SNAP:
                sess.checkpoint(ckdir)
        out["before"] = np.asarray(st.dump())
        sess.re_entrust([5], ckpt_dir=ckdir)
        out["t_after"] = np.asarray([st.trust.n_trustees,
                                     st.trust.group.mesh.size])
        with sess.replaying():
            for rnd in range(FO_SNAP, FO_KILL):
                one(rnd, "replay")
        for rnd in range(FO_KILL, FO_ROUNDS):
            one(rnd, "")
        out["final"] = np.asarray(st.dump())
        out["replayed"] = np.asarray(
            sess.last_stats()["recovery"]["replayed_rounds"])
    return out


def run_pagetable(pkg, mesh, conv):
    """A page table over the "model" axis: each data row's allocations
    land in its own replica; lookups and appends from each row, then the
    read-back (replica 0) and its audit."""
    with pkg.use_session(pkg.TrustSession()):
        pt = pkg.DelegatedPageTable(mesh, n_pages=64, max_seqs=16,
                                    page_size=4, max_pages=4, axis="model")
        seqs = np.arange(8, dtype=np.int32)
        out = {}
        for name, r in (("alloc", pt.alloc(seqs, np.full(8, 2, np.int32))),
                        ("lookup", pt.lookup(seqs[::-1].copy())),
                        ("append", pt.append(seqs, np.full(8, 9, np.int32))),
                        ("lookup2", pt.lookup(seqs))):
            out.update({f"{name}/{k}": np.asarray(v) for k, v in r.items()})
        out.update({f"dump/{k}": np.asarray(v) for k, v in pt.dump().items()})
        audit = pt.audit()
        out["audit"] = np.asarray([audit["allocated"], audit["chained"],
                                   int(audit["consistent"])])
        return out


def read_snapshot(ckpt_mod, ckdir):
    """A snapshot's logical state and its manifest entry (the fields both
    packages write alike)."""
    tree, step, extra = ckpt_mod.restore(ckdir, {"kv": {"table": 0}})
    meta = extra["trusts"]["kv"]
    keep = {k: meta[k] for k in ("schema", "n_trustees", "mode", "axes",
                                 "n_dedicated", "mesh_shape")}
    return np.asarray(tree["kv"]["table"]), json.dumps(keep, sort_keys=True)


# ---------------------------------------------------------------------------
# the JAX side, once for the module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dataaxis") / "runs.npz"
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


def _want(runs, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in runs.items() if k.startswith(prefix + "/")}


def _same(got, want, what):
    assert want, what
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    for k in want:
        assert np.array_equal(got[k], want[k]), \
            f"{what}: {k} differs:\n{got[k]}\nvs JAX\n{want[k]}"


def _port():
    import repro_torch.core as pkg
    mesh = pkg.StackedMesh((2, 4), device="cpu")
    return pkg, mesh


def _conv(a):
    import torch
    return torch.as_tensor(a)


@pytest.mark.parametrize("axis,shortcut", PROBES)
def test_rows_write_their_own_replicas_as_in_jax(jax_runs, axis, shortcut):
    pkg, mesh = _port()
    got = run_probe(pkg, mesh, _conv, axis, shortcut)
    want = _want(jax_runs, f"probe_{axis}_{int(shortcut)}")
    _same(got, want, f"probe {axis} shortcut={shortcut}")
    if axis == "model":
        # the two rows read different replicas; the read-back is row 0's
        assert got["get"][0] != got["get"][4]
        assert got["dump"][5] == got["get"][0]
        assert got["n_trustees"] == 4


def test_group_layouts():
    """Shard i of a (2, 4) mesh: member i % 4 of replica i // 4 in a
    "model" group, member i // 4 of replica i % 4 in a "data" group; a
    group over both axes in either order is every shard, row-major over
    the axes as given."""
    from repro_torch.core import meshctx
    mesh = meshctx.StackedMesh((2, 4), device="cpu")
    i = np.arange(8)
    g, r = meshctx.group_coords(mesh, "model")
    assert np.array_equal(g, i % 4) and np.array_equal(r, i // 4)
    g, r = meshctx.group_coords(mesh, "data")
    assert np.array_equal(g, i // 4) and np.array_equal(r, i % 4)
    g, r = meshctx.group_coords(mesh, ("data", "model"))
    assert np.array_equal(g, i) and not r.any()
    g, _ = meshctx.group_coords(mesh, ("model", "data"))
    assert np.array_equal(g, (i % 4) * 2 + i // 4)
    order, n, reps = meshctx.group_order(
        meshctx.StackedMesh((2, 3, 4), ("pod", "data", "model"),
                            device="cpu"), ("data",))
    assert (n, reps) == (3, 8) and order[:4].tolist() == [0, 4, 8, 1]
    with pytest.raises(ValueError, match="distinct axes"):
        meshctx.group_order(mesh, ("model", "model"))


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("name", sorted(KV_CASES))
def test_subaxis_kv_store_matches_jax(jax_runs, name, impl):
    pkg, mesh = _port()
    _same(run_kv(pkg, mesh, _conv, name, impl), _want(jax_runs, name), name)


def test_subaxis_kv_cases_exercise_their_knobs(jax_runs):
    """The traces reach what each case is for: rows dropped past the
    second block, rows deferred and drained in extra rounds, rows
    combined, replicas that differ."""
    stats = {n: np.stack([jax_runs[f"{n}/{r}/0/stats"]
                          for r in range(N_ROUNDS)]) for n in KV_CASES}
    assert (stats["model_defer"][:, 0] > 1).any()
    assert (stats["model_combine"][:, 3] > 0).any()
    # a pair's demand past the primary and second blocks (2 + 1 rows)
    assert (stats["model_second_round"][:, 2] > 3).any()
    pkg, mesh = _port()
    with pkg.use_session(pkg.TrustSession()):
        st = pkg.DelegatedKVStore(mesh, N_KEYS, VW, axis="model",
                                  capacity=8, pack_impl="ref",
                                  serve_impl="ref")
        init, rounds = gen_trace(30)
        st.prefill(init)
        drive([st], [rounds], st.session, _conv, fused=False)
        table = st.trust.state()["table"]
        assert table.shape[0] == 8
        assert not np.array_equal(table[:4].numpy(), table[4:].numpy())
        assert np.array_equal(st.trust.trustee_state()["table"].numpy(),
                              table[:4].numpy())


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_fused_subaxis_round_matches_jax(jax_runs, impl):
    from repro_torch.core import collect_transposes
    pkg, mesh = _port()
    got = run_fused(pkg, mesh, _conv, impl)
    _same(got, _want(jax_runs, "fused"), "fused")
    # two sub-axis trusts fused, the whole-mesh one solo, every round
    assert all(got[f"{r}/fused"].tolist() == [2, -1]
               for r in range(N_ROUNDS))
    with pkg.use_session(pkg.TrustSession()) as sess:
        a, b = (pkg.DelegatedKVStore(mesh, N_KEYS, VW, axis="model",
                                     name=n, capacity=8, overflow="drop",
                                     local_shortcut=False)
                for n in "ab")
        keys = _conv(np.arange(16, dtype=np.int32))
        for st in (a, b):
            st.trust.op.get.then(keys)
        with collect_transposes() as moves:
            sess.step()
        assert moves == ["request", "response"]


def test_local_trustees_on_a_data_axis(jax_runs):
    pkg, mesh = _port()
    with pkg.use_mesh(mesh):
        g = pkg.local_trustees()
        gw = pkg.local_trustees(("data", "model"))
    assert [g.n_trustees, g.n_replicas, gw.n_trustees] == \
        jax_runs["local_trustees"].tolist() == [4, 2, 8]
    assert g.axes == ("model",) and g.mode == "shared"
    with pytest.raises(ValueError, match="whole mesh"):
        pkg.TrusteeGroup(mesh, "model", mode="dedicated", n_dedicated=2)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_subaxis_checkpoint_kill_and_reentrust_match_jax(jax_runs, impl):
    from repro_torch.checkpoint import checkpoint as ckpt
    pkg, mesh = _port()
    ckdir = tempfile.mkdtemp(prefix="dataaxis_fo_")
    try:
        got = run_failover(pkg, mesh, _conv, ckdir, impl)
        table, meta = read_snapshot(ckpt, ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    _same(got, _want(jax_runs, "failover"), "failover")
    assert got["t_after"].tolist() == [7, 7]
    assert np.array_equal(table, jax_runs["snapshot/table"])
    assert meta == str(jax_runs["snapshot/meta"])
    assert json.loads(meta)["axes"] == ["model"]
    assert json.loads(meta)["n_trustees"] == 4


def test_subaxis_pagetable_matches_jax(jax_runs):
    pkg, mesh = _port()
    got = run_pagetable(pkg, mesh, _conv)
    _same(got, _want(jax_runs, "pagetable"), "pagetable")
    # a row's lookups of the other row's sequences find no chain in its
    # replica; its own sequences' chains are there; the read-back is
    # replica 0, data row 0's sequences only
    assert (got["lookup/pages"] == -1).all()
    assert (got["lookup2/pages"][:, :3] >= 0).all()
    assert got["dump/chain_len"].reshape(4, 4)[:, 1:].sum() == 0


def test_launch_mesh_matches_jax(jax_runs):
    from repro_torch.launch import mesh as lm
    got = {
        "local": lm.make_local_mesh(2, 4, device="cpu"),
        "prod": lm.make_production_mesh(device="cpu"),
        "pod": lm.make_production_mesh(multi_pod=True, device="cpu"),
        "cfg": lm.make_mesh_from_config(lm.mesh_config(), device="cpu"),
    }
    for k, m in got.items():
        assert json.dumps([list(m.dims), list(m.axis_names)]) == \
            str(jax_runs[f"mesh/{k}"]), k
    assert lm.mesh_config(multi_pod=True).data_size == 32
    assert lm.mesh_config().trustee_axis == "model"


def _row_stream(rng, ref, n_keys, rows, mix):
    """One data row's op batches of a round: ``rows`` requests split by
    ``mix`` ((op, share), ...); CAS expects hit the row's table half the
    time; inactive rows (the other ops' share of a kv_paper round) carry
    key -1."""
    from repro_torch.core.routing import sample_keys
    out, left = [], rows
    for i, (op, share) in enumerate(mix):
        n = left if i == len(mix) - 1 else int(rows * share)
        left -= n
        keys = sample_keys(rng, n_keys, n, "zipf").astype(np.int32)
        vals = rng.integers(0, 8, (n, VW)).astype(np.float32)
        expect = np.where(rng.random(n)[:, None] < 0.5, ref.table[keys],
                          rng.integers(0, 8, (n, VW))).astype(np.float32)
        out.append((op, keys, vals, expect))
    return out


@pytest.mark.parametrize("shortcut", [True, False])
def test_subaxis_store_rows_equal_their_oracles(shortcut):
    """chip_smoke's phase 12 (a) at a small size: each data row draws its
    own stream (GET/PUT/ADD/CAS), the kernel path == the plain path, each
    replica == the oracle fed its own row's requests, the read-back ==
    replica 0."""
    import torch
    from repro_torch.core import (DelegatedKVStore, SequentialKVReference,
                                  StackedMesh, use_session)
    from repro_torch.testing import dataaxis as da
    n_keys, rows, rounds = 4096, 512, 3
    mix = (("get", 0.4), ("put", 0.2), ("add", 0.2), ("cas", 0.2))
    rng = np.random.default_rng(12)
    init = rng.integers(0, 8, (n_keys, VW)).astype(np.float32)
    refs = [SequentialKVReference(n_keys, VW) for _ in range(2)]
    for ref in refs:
        ref.prefill(init)
    stores = {}
    for impl in ("kernel", "ref"):
        with use_session() as sess:
            st = DelegatedKVStore(StackedMesh((2, 4), device="cpu"), n_keys,
                                  VW, axis="model", capacity=rows // 4,
                                  local_shortcut=shortcut, pack_impl=impl,
                                  serve_impl=impl, session=sess)
            st.prefill(init)
            stores[impl] = (st, sess)
    for _ in range(rounds):
        row_batches = [_row_stream(rng, ref, n_keys, rows, mix)
                       for ref in refs]
        batches = da.fused_round(row_batches, 4)
        got = {}
        for impl, (st, sess) in stores.items():
            futs = da.submit(torch, torch.device("cpu"), st, batches)
            sess.step()
            got[impl] = da.responses(futs, batches)
        want = [r for ref, rb in zip(refs, row_batches)
                for r in da.row_oracle(ref, rb, shortcut, 4)]
        for a, b, w in zip(got["kernel"], got["ref"], want):
            assert da.same(a, b) and da.same(a, w)
    for impl, (st, _sess) in stores.items():
        reps = da.replica_tables(st)
        assert len(reps) == 2 and not np.array_equal(reps[0], reps[1])
        for rep, ref in zip(reps, refs):
            assert np.array_equal(rep, ref.dump()), impl
        assert np.array_equal(st.dump(), reps[0])
    with pytest.raises(ValueError, match="multiple of 4"):
        da.fused_round([row_batches[0], row_batches[1][:1]], 4)


# ---------------------------------------------------------------------------
# the models on the data axis
#
# Tolerances: f32 outputs, logits and aux metrics rtol = atol = 2e-5 (the
# same math summed in another order by another library); the MoE's max
# load exactly (it counts rows) and its dropped fraction to 1e-6 relative
# (the same count of dropped tokens); training losses rtol 1e-5 and the
# parameters after 3 AdamW steps 1e-4 in relative RMS a leaf, or 1e-3 of
# the learning rate in RMS: Adam's first steps move each weight by about
# the learning rate whatever the gradient's size, so a leaf whose
# gradient is zero in exact arithmetic (the key bias, which adds the same
# score to every key of a query) moves by its rounding noise's sign.
# ---------------------------------------------------------------------------

TOL = dict(rtol=2e-5, atol=2e-5)
# name: (batch, seq, MoE overrides, batch axes on the (2, 4) mesh)
MOE_CASES = {
    "seq_drop": (4, 64, dict(capacity_factor=0.5, overflow="drop"),
                 ("data",)),
    "seq_second_round": (4, 64, dict(capacity_factor=0.5,
                                     overflow_factor=0.25), ("data",)),
    "decode_drop": (256, 1, dict(capacity_factor=0.25, overflow="drop"),
                    ("data",)),
    "mask_drop": (4, 30, dict(capacity_factor=0.5, overflow="drop"),
                  ("data",)),
    "replicated": (3, 64, dict(capacity_factor=0.5, overflow="drop"), ()),
}
DECODE_ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b")
DB, DSTEPS = 4, 8
TRAIN = {"qwen": ("qwen2.5-3b", dict(d_model=64, n_layers=2, d_ff=128,
                                     vocab_size=512), {}),
         "deepseek": ("deepseek-v2-lite-16b", {},
                      dict(capacity_factor=0.5, overflow="drop"))}
TB, TS, TSTEPS = 4, 32, 3


def _arctic_cfgs(moe_kw):
    """JAX's arctic SMOKE config and the port's, each at one layer (8
    experts, top-2) with ``moe_kw``."""
    import dataclasses
    from repro.configs.registry import SMOKE_ARCHS
    from repro_torch.configs.registry import get_smoke_arch
    out = []
    for cfg in (SMOKE_ARCHS["arctic-480b"], get_smoke_arch("arctic-480b")):
        cfg = cfg.with_overrides(n_layers=1)
        out.append(cfg.with_overrides(
            moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return tuple(out)


def _run(base, cfg, shape, mesh, **kw):
    return base.RunConfig(model=cfg, shape=shape,
                          mesh=base.MeshConfig(mesh, ("data", "model")),
                          remat="none", param_dtype="float32",
                          activation_dtype="float32", **kw)


def _moe_x(b, s, d):
    return (np.random.default_rng(b * 100 + s).normal(size=(b, s, d))
            * 0.3).astype(np.float32)


def jax_moe(name, mesh):
    import jax
    import jax.numpy as jnp
    from repro.configs import base
    from repro.core import meshctx
    from repro.models import moe as jmoe
    b, s, kw, axes = MOE_CASES[name]
    cfg, _ = _arctic_cfgs(kw)
    p = jmoe.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    x = jnp.asarray(_moe_x(b, s, cfg.d_model))
    out = {"params/" + k: np.asarray(v) for k, v in p.items()}
    for tag, m in (("dp", mesh), ("t4", None)):
        if m is None:
            m = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                                  ("data", "model"))
        meshctx.set_context(m, axes if tag == "dp" else ("data",))
        run = _run(base, cfg, base.ShapeConfig("t", s, b, "prefill"),
                   tuple(m.devices.shape))
        y, aux = jax.jit(lambda p_, x_: jmoe.moe_block(p_, x_, cfg, run))(
            p, x)
        out[f"{tag}/y"] = np.asarray(y)
        for k in ("moe_aux_loss", "moe_dropped_frac", "moe_max_load"):
            out[f"{tag}/{k}"] = np.asarray(aux[k])
    return out


def port_moe(name, want, use_pallas=False, mesh=(2, 4)):
    import torch
    from repro_torch.configs import base
    from repro_torch.core import meshctx
    from repro_torch.models import moe as tmoe
    b, s, kw, axes = MOE_CASES[name]
    _, cfg = _arctic_cfgs(kw)
    p = {k[len("params/"):]: torch.as_tensor(v) for k, v in want.items()
         if k.startswith("params/")}
    run = _run(base, cfg, base.ShapeConfig("t", s, b, "prefill"), mesh,
               use_pallas=use_pallas)
    with meshctx.kept_context():
        meshctx.set_batch_axes(axes if mesh[0] > 1 else ("data",))
        y, aux = tmoe.moe_block(p, torch.as_tensor(_moe_x(b, s, cfg.d_model)),
                                cfg, run)
    return y.numpy(), {k: v.numpy() for k, v in aux.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_on_a_data_axis_matches_jax(jax_runs, name, use_pallas):
    """``moe_block`` on (2, 4): each data row's own capacities, so the
    drop mask is not the (1, 4) run's (asserted on JAX's outputs), except
    with the batch replicated (B = 3), where it is the (1, 4) run."""
    want = _want(jax_runs, f"moe/{name}")
    y, aux = port_moe(name, want, use_pallas)
    np.testing.assert_allclose(y, want["dp/y"], **TOL)
    np.testing.assert_allclose(aux["moe_aux_loss"], want["dp/moe_aux_loss"],
                               **TOL)
    np.testing.assert_allclose(aux["moe_dropped_frac"],
                               want["dp/moe_dropped_frac"], rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(aux["moe_max_load"],
                                  want["dp/moe_max_load"])
    assert want["dp/moe_dropped_frac"] > 0
    same_as_t4 = np.array_equal(want["dp/y"], want["t4/y"])
    assert same_as_t4 == (name == "replicated"), name
    if name != "replicated":
        assert want["dp/moe_dropped_frac"] != want["t4/moe_dropped_frac"]
        assert want["dp/moe_max_load"] < want["t4/moe_max_load"]


def test_moe_batch_must_split_over_the_data_rows(jax_runs):
    """B = 3 over 2 data rows raises unless the batch axes are ``()``."""
    import torch
    from repro_torch.configs import base
    from repro_torch.core import meshctx
    from repro_torch.models import moe as tmoe
    _, cfg = _arctic_cfgs({})
    want = _want(jax_runs, "moe/replicated")
    p = {k[len("params/"):]: torch.as_tensor(v) for k, v in want.items()
         if k.startswith("params/")}
    run = _run(base, cfg, base.ShapeConfig("t", 8, 3, "prefill"), (2, 4))
    with meshctx.kept_context():
        meshctx.set_batch_axes(("data",))
        with pytest.raises(ValueError, match="data rows"):
            tmoe.moe_block(p, torch.zeros(3, 8, cfg.d_model), cfg, run)


def _arch_cfgs(arch, overrides=None, moe_kw=None):
    import dataclasses
    from repro.configs.registry import SMOKE_ARCHS
    from repro_torch.configs.registry import get_smoke_arch
    out = []
    for cfg in (SMOKE_ARCHS[arch], get_smoke_arch(arch)):
        if overrides:
            cfg = cfg.with_overrides(**overrides)
        if moe_kw:
            cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                             **moe_kw))
        out.append(cfg)
    return out


def _tree(flat, prefix):
    """The nested params tree saved flat under ``prefix``."""
    tree = {}
    for key, leaf in flat.items():
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def _flat(tree, prefix):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _decode_tokens(vocab):
    return np.random.default_rng(17).integers(0, vocab, (DB, DSTEPS)) \
        .astype(np.int32)


def jax_decode(arch, mesh):
    import jax
    import jax.numpy as jnp
    from repro.configs import base
    from repro.core import meshctx
    from repro.models import model as JM
    cfg, _ = _arch_cfgs(arch)
    meshctx.set_context(mesh, ("data",))
    run = _run(base, cfg, base.ShapeConfig("d", DSTEPS, DB, "decode"),
               (2, 4))
    p = JM.init_params(jax.random.PRNGKey(7), cfg, run)
    cache = JM.init_cache(cfg, DB, DSTEPS, run)
    step = jax.jit(lambda c, t, q: JM.decode_step(p, c, t, q, cfg, run))
    toks = _decode_tokens(cfg.vocab_size)
    logits = []
    for i in range(DSTEPS):
        lg, cache = step(cache, jnp.asarray(toks[:, i]),
                         jnp.full((DB,), i, jnp.int32))
        logits.append(np.asarray(lg))
    out = _flat(jax.tree_util.tree_map(np.asarray, p), "params")
    out["logits"] = np.stack(logits)
    return out


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_on_a_data_axis_matches_jax(jax_runs, arch):
    """A teacher-forced decode on (2, 4) (batch axes ("data",)) through
    ``build_cell``'s decode step == JAX's ``decode_step`` loop under
    ``set_context(mesh, ("data",))``, every step's logits."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import base
    from repro_torch.core import meshctx
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as TM
    want = _want(jax_runs, f"decode/{arch}")
    _, cfg = _arch_cfgs(arch)
    shape = base.ShapeConfig("d", DSTEPS, DB, "decode")
    run = _run(base, cfg, shape, (2, 4))
    params = convert.model_params_from_jax(_tree(want, "params/"),
                                           device="cpu")
    with meshctx.kept_context():
        plan = build_cell(cfg, shape, run,
                          meshctx.StackedMesh((2, 4), device="cpu"))
        assert meshctx.batch_axes() == ("data",)
        cache = TM.init_cache(cfg, DB, DSTEPS, run, device="cpu")
        toks = _decode_tokens(cfg.vocab_size)
        for i in range(DSTEPS):
            lg, cache = TM.decode_step(params, cache,
                                       torch.as_tensor(toks[:, i]),
                                       torch.full((DB,), i,
                                                  dtype=torch.int32),
                                       cfg, run)
            np.testing.assert_allclose(lg.numpy(), want["logits"][i], **TOL,
                                       err_msg=f"{arch} step {i}")
        nxt, _ = plan.step_fn(params, TM.init_cache(cfg, DB, DSTEPS, run,
                                                    device="cpu"),
                              torch.as_tensor(toks[:, 0]),
                              torch.zeros(DB, dtype=torch.int32))
        assert np.array_equal(nxt.numpy(), want["logits"][0].argmax(-1))


SERVE_ARGV = ["--arch", "deepseek-v2-lite-16b", "--smoke", "--batch", "4",
              "--prompt-len", "6", "--gen", "6", "--mesh-data", "2",
              "--mesh-model", "4", "--device", "cpu"]


def _own_decode_loop(argv):
    """The serve's tokens rebuilt from a loop of the port's own decode
    step on the (2, 4) mesh: the serve's weights, prompt and cell."""
    import torch
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke_arch
    from repro_torch.core import meshctx
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as TM
    b, pl, g = 4, 6, 6
    cfg = get_smoke_arch("deepseek-v2-lite-16b")
    max_len = -(-(pl + g) // 4) * 4
    shape = ShapeConfig("cli", max_len, b, "decode")
    run = RunConfig(model=cfg, shape=shape,
                    mesh=MeshConfig((2, 4), ("data", "model")),
                    remat="none", use_pallas=True)
    with meshctx.kept_context():
        plan = build_cell(cfg, shape, run,
                          meshctx.StackedMesh((2, 4), device="cpu"))
        params = TM.init_params(cfg, run, torch.device("cpu"))
        cache = TM.init_cache(cfg, b, max_len, run, torch.device("cpu"))
        prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   size=(pl, b))
        prev, out = None, []
        for i in range(pl + g - 1):
            tok = torch.as_tensor(prompt[i], dtype=torch.int32) \
                if i < pl else prev
            prev, cache = plan.step_fn(params, cache, tok,
                                       torch.full((b,), i,
                                                  dtype=torch.int32))
            if i >= pl - 1:
                out.append(prev.numpy())
    return np.stack(out, 1)


@pytest.mark.parametrize("extra", [[], ["--session"],
                                   ["--delegation-mode", "dedicated"]])
def test_serve_on_a_data_axis(jax_runs, extra):
    """``serve.main --mesh-data 2 --mesh-model 4`` (deepseek SMOKE, its
    MoE per data row): the tokens of a loop of the port's own decode
    step; with ``--session`` the ledger counts every request's tokens and
    the meter has a key for each of the 8 shards; in dedicated mode the
    ledger's trustees are JAX's ``partition_clients_trustees(8, 4)``."""
    from repro_torch.launch import serve
    stats = {}
    gen = serve.main(SERVE_ARGV + extra, stats=stats)
    np.testing.assert_array_equal(gen, _own_decode_loop(SERVE_ARGV))
    if "--session" in extra:
        assert stats["ledger"].tolist() == [6] * 4
        assert stats["meter"].shape == (8,)
        assert int(stats["meter"].sum()) == 4 * 6
    if "dedicated" in extra:
        clients, trustees = stats["partition"]
        assert clients.tolist() == jax_runs["partition/clients"].tolist()
        assert trustees.tolist() == jax_runs["partition/trustees"].tolist()
        assert stats["ledger"].tolist() == [6] * 4
        assert not stats["client_region"].any()


def _train_batches(vocab):
    rng = np.random.default_rng(42)
    out = []
    for _ in range(TSTEPS):
        toks = rng.integers(0, vocab, (TB, TS + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def jax_train(name, mesh):
    import jax
    import jax.numpy as jnp
    from repro.configs import base
    from repro.launch.steps import build_cell
    from repro.models import model as JM
    from repro.optim import init_adamw
    arch, over, moe_kw = TRAIN[name]
    cfg, _ = _arch_cfgs(arch, over, moe_kw)
    shape = base.ShapeConfig("t", TS, TB, "train")
    run = _run(base, cfg, shape, (2, 4), zero_sharding=True)
    plan = build_cell(cfg, shape, mesh, run)
    p0 = jax.jit(lambda k: JM.init_params(k, cfg, run))(
        jax.random.PRNGKey(2))
    out = _flat(jax.tree_util.tree_map(np.asarray, p0), "params")
    params = jax.device_put(p0, plan.param_shardings)
    opt = jax.jit(lambda p: init_adamw(p),
                  out_shardings=plan.opt_shardings)(params)
    for i, batch in enumerate(_train_batches(cfg.vocab_size)):
        params, opt, m = plan.step_fn(
            params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        for k in ("loss", "moe_dropped_frac", "moe_max_load"):
            if k in m:
                out[f"step{i}/{k}"] = np.asarray(m[k])
    out.update(_flat(jax.tree_util.tree_map(np.asarray, params), "final"))
    return out


def port_train(name, want, mesh=(2, 4)):
    import torch
    from repro_torch import convert
    from repro_torch.configs import base
    from repro_torch.core import meshctx
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim import init_adamw
    arch, over, moe_kw = TRAIN[name]
    _, cfg = _arch_cfgs(arch, over, moe_kw)
    shape = base.ShapeConfig("t", TS, TB, "train")
    run = _run(base, cfg, shape, mesh, zero_sharding=mesh[0] > 1)
    params = convert.model_params_from_jax(_tree(want, "params/"),
                                           device="cpu")
    opt = init_adamw(params, torch.float32)
    out = {}
    with meshctx.kept_context():
        plan = build_cell(cfg, shape, run,
                          meshctx.StackedMesh(mesh, device="cpu"))
        for i, batch in enumerate(_train_batches(cfg.vocab_size)):
            params, opt, m = plan.step_fn(
                params, opt, {k: torch.as_tensor(v)
                              for k, v in batch.items()})
            for k in ("loss", "moe_dropped_frac", "moe_max_load"):
                if k in m:
                    out[f"step{i}/{k}"] = m[k].numpy()
    out.update(_flat(convert.model_params_to_numpy(params), "final"))
    return out


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_training_on_a_data_axis_matches_jax(jax_runs, name):
    """Three steps of the train cell on (2, 4) == JAX's ``build_cell``
    step on a (2, 4) mesh (``zero_sharding`` on): the losses, the MoE's
    drops and load, and every parameter after the steps.  deepseek's
    tight capacity makes its MoE drop other rows than on (1, 4)."""
    want = _want(jax_runs, f"train/{name}")
    got = port_train(name, want)
    for i in range(TSTEPS):
        np.testing.assert_allclose(got[f"step{i}/loss"],
                                   want[f"step{i}/loss"], rtol=1e-5)
    finals = [k for k in want if k.startswith("final/")]
    assert finals and sorted(finals) == sorted(
        k for k in got if k.startswith("final/"))
    lr = 3e-4                                  # RunConfig's default
    for k in finals:
        a, b = got[k].astype(np.float64), want[k].astype(np.float64)
        rms = np.sqrt(np.mean((a - b) ** 2))
        assert rms <= max(1e-4 * np.sqrt(np.mean(b ** 2)), 1e-3 * lr), k
    if name == "deepseek":
        for i in range(TSTEPS):
            np.testing.assert_allclose(got[f"step{i}/moe_dropped_frac"],
                                       want[f"step{i}/moe_dropped_frac"],
                                       rtol=1e-6)
            np.testing.assert_array_equal(got[f"step{i}/moe_max_load"],
                                          want[f"step{i}/moe_max_load"])
        t4 = port_train(name, want, mesh=(1, 4))
        assert want["step0/moe_dropped_frac"] > 0
        assert t4["step0/moe_dropped_frac"] != want["step0/moe_dropped_frac"]


# ---------------------------------------------------------------------------

def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import repro.core as pkg
    from repro.checkpoint import checkpoint as ckpt
    from repro.launch import mesh as lm
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    res = {}

    def put(prefix, d):
        res.update({f"{prefix}/{k}": v for k, v in d.items()})

    for axis, sc in PROBES:
        put(f"probe_{axis}_{int(sc)}", run_probe(pkg, mesh, jnp.asarray,
                                                 axis, sc))
    for name in KV_CASES:
        put(name, run_kv(pkg, mesh, jnp.asarray, name))
    put("fused", run_fused(pkg, mesh, jnp.asarray))
    put("pagetable", run_pagetable(pkg, mesh, jnp.asarray))
    with pkg.use_mesh(mesh):
        res["local_trustees"] = np.asarray(
            [pkg.local_trustees().n_trustees,
             mesh.size // pkg.local_trustees().axis_size,
             pkg.local_trustees(("data", "model")).n_trustees])
    ckdir = tempfile.mkdtemp(prefix="dataaxis_fo_jax_")
    try:
        put("failover", run_failover(pkg, mesh, jnp.asarray, ckdir))
        table, meta = read_snapshot(ckpt, ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    res["snapshot/table"] = table
    res["snapshot/meta"] = np.asarray(meta)
    from repro.core import meshctx
    from repro.core.routing import partition_clients_trustees
    clients, trustees = partition_clients_trustees(8, 4)
    res["partition/clients"], res["partition/trustees"] = clients, trustees
    for name in MOE_CASES:
        put(f"moe/{name}", jax_moe(name, mesh))
    for arch in DECODE_ARCHS:
        put(f"decode/{arch}", jax_decode(arch, mesh))
    for name in TRAIN:
        put(f"train/{name}", jax_train(name, mesh))
    meshctx.set_context(meshctx._default_mesh(), "default")
    for k, m in (("local", lm.make_local_mesh(2, 4)),
                 ("prod", lm.mesh_config()),
                 ("pod", lm.mesh_config(multi_pod=True)),
                 ("cfg", lm.mesh_config())):
        dims = m.devices.shape if hasattr(m, "devices") else m.shape
        names = m.axis_names if hasattr(m, "axis_names") else m.axes
        res[f"mesh/{k}"] = np.asarray(json.dumps([list(dims), list(names)]))
    np.savez(out_path, **res)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
