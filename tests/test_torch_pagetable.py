"""The port's delegated page table against the JAX package's.

  * the plain page-table serve (``ref.pagetable_serve``, what the CUDA
    kernel computes) == the JAX schema's per-op ``lax.scan`` serve, pass
    by pass, on numpy-seeded rows that evict, heal and overflow;
  * the port's copy of ``SequentialPageTable`` == the JAX oracle, and the
    port's ``pagetable_reshard`` == JAX's (the oracle's ``reshard`` loads
    its result);
  * the port's ``DelegatedPageTable`` (8 stacked shards on the CPU) == the
    sequential oracle replayed in serve order, and == the JAX
    ``DelegatedPageTable`` on a 2x4 mesh of 8 virtual CPU devices — every
    response and the final owner-major state, bit for bit, with the local
    shortcut on and off.  The JAX side runs in one subprocess: this module,
    run as a script.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import subprocess

import numpy as np
import pytest

T, SEED = 8, 17
CAPACITY = 256


def _geometry():
    from repro_torch.testing.pagetable import STRESS_GEOMETRY
    return STRESS_GEOMETRY


def _pass_rows(rng, op, n, sl, mp, ps):
    """Per-trustee rows of one op pass: (T, N) global seqs owned by each
    trustee, the op's argument, a valid mask with holes."""
    local = rng.integers(0, sl, (T, n))
    seq = (local * T + np.arange(T)[:, None]).astype(np.int32)
    if op == "alloc":
        arg = rng.integers(-1, mp + 3, (T, n))
    elif op == "append":
        arg = rng.integers(-2, (mp + 1) * ps, (T, n))
    else:
        arg = seq
    valid = rng.random((T, n)) < 0.8
    return seq, arg.astype(np.int32), valid


def test_plain_serve_matches_jax_serve_pass_by_pass():
    import jax
    import jax.numpy as jnp
    import torch
    from repro.core.pagetable import initial_pagetable_state as j_init
    from repro.core.pagetable import make_pagetable_schema as j_schema
    from repro_torch import convert
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import PT_OPS
    g = _geometry()
    ps, mp = g["page_size"], g["max_pages"]
    host = j_init(g["n_pages"], g["max_seqs"], mp, T)
    sl = host["chain_len"].shape[0] // T
    schema = j_schema(T, ps, mp)
    serves = {o.name: jax.jit(o.serve) for o in schema.ops}
    state = convert.stacked_from_owner_major(host, T, device="cpu")
    shards = [{k: jnp.asarray(v.reshape((T, -1) + v.shape[1:])[t])
               for k, v in host.items()} for t in range(T)]
    rng = np.random.default_rng(SEED)
    ops = ["alloc", "alloc", "append", "lookup", "free", "append", "alloc",
           "append", "free", "lookup", "alloc", "append"]
    for i, op in enumerate(ops):
        seq, arg, valid = _pass_rows(rng, op, 20, sl, mp, ps)
        got = kops.pagetable_serve(PT_OPS[op], state, torch.as_tensor(seq),
                                   torch.as_tensor(arg),
                                   torch.as_tensor(valid), T, ps)
        key = {"alloc": "n", "append": "pos"}.get(op)
        for t in range(T):
            rows = {"seq": jnp.asarray(seq[t])}
            if key:
                rows[key] = jnp.asarray(arg[t])
            shards[t], resp = serves[op](shards[t], rows,
                                         jnp.asarray(valid[t]),
                                         jnp.zeros(20, jnp.int32))
            for f, g_ in zip(("pages", "page", "n", "flag"), got):
                assert np.array_equal(g_[t].numpy(), np.asarray(resp[f])), \
                    f"pass {i} ({op}) trustee {t}: {f}"
        for k, leaf in state.items():
            want = np.stack([np.asarray(shards[t][k]) for t in range(T)])
            assert np.array_equal(leaf.numpy(), want), f"pass {i}: {k}"
    assert int(state["evictions"].sum()) > 0


def test_oracle_copy_matches_jax_oracle():
    from repro.core import SequentialPageTable as JOracle
    from repro_torch.core import SequentialPageTable
    from repro_torch.testing.pagetable import stress_waves
    g = _geometry()
    args = (g["n_pages"], g["max_seqs"], g["page_size"], g["max_pages"], T)
    a, b = SequentialPageTable(*args), JOracle(*args)
    for wave in stress_waves(SEED):
        for op, seqs, arg in wave:
            x = (seqs,) if arg is None else (seqs, arg)
            ra, rb = getattr(a, op)(*x), getattr(b, op)(*x)
            assert all(np.array_equal(ra[k], rb[k]) for k in rb)
    assert all(np.array_equal(a.dump()[k], b.dump()[k]) for k in b.dump())
    assert int(a.evictions.sum()) > 0


def _consistent_state(seed, old_t):
    """A consistent owner-major page-table state: the oracle driven by
    the stress waves (evictions, heals, frees) over ``old_t`` trustees."""
    from repro_torch.core import SequentialPageTable
    from repro_torch.testing.pagetable import stress_waves
    g = _geometry()
    oracle = SequentialPageTable(g["n_pages"], g["max_seqs"],
                                 g["page_size"], g["max_pages"], old_t)
    for wave in stress_waves(seed):
        for op, seqs, arg in wave:
            getattr(oracle, op)(*((seqs,) if arg is None else (seqs, arg)))
    return oracle


def _crowded_state():
    """Eight 4-page chains of sequences 0, 5, ..., 35 on 8 trustees (one
    a trustee, its whole pool) — on 5 trustees they all map to trustee
    0, whose pool holds 3 of them: the re-layout must drop 5 LRU chains."""
    from repro_torch.core import SequentialPageTable
    oracle = SequentialPageTable(64, 64, 4, 4, 8)
    seqs = np.arange(0, 40, 5, dtype=np.int32)
    oracle.alloc(seqs, np.full(8, 4, np.int32))
    oracle.lookup(seqs[::-1])         # distinct LRU stamps
    return oracle


@pytest.mark.parametrize("seed,old_t,new_t", [
    (17, 8, 7), (18, 8, 5), (19, 4, 8), (20, 8, 8), (None, 8, 5)])
def test_pagetable_reshard_matches_jax(seed, old_t, new_t):
    """``pagetable_reshard`` (the port's copy) == JAX's on consistent
    states, 8 -> 7, 8 -> 5, 4 -> 8, 8 -> 8, and a crowded state whose new
    owner cannot hold its chains (the LRU ones dropped and counted as
    evictions); the result passes the facade's audit rules, and
    ``SequentialPageTable.reshard`` takes the new trustee count and loads
    the re-laid state."""
    from repro.core.pagetable import pagetable_reshard as j_reshard
    from repro_torch.core import pagetable_reshard
    oracle = _crowded_state() if seed is None else \
        _consistent_state(seed, old_t)
    before = oracle.dump()
    got = pagetable_reshard(before, old_t, new_t)
    want = j_reshard({k: v.copy() for k, v in before.items()}, old_t, new_t)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    used = got["used"].reshape(new_t, -1)
    cl = got["chain_len"].reshape(new_t, -1)
    assert int((used == 1).sum()) == int(cl.sum())      # no leaked page
    dropped = int(got["evictions"].sum() - before["evictions"].sum())
    if seed is None:
        assert dropped == 5 and int(cl.sum()) == 12
    oracle.reshard(new_t)
    assert oracle.t == new_t
    for k, v in oracle.dump().items():
        assert np.array_equal(v, got[k]), k


def _port_run(shortcut):
    import torch  # noqa: F401
    from repro_torch.core import DelegatedPageTable, StackedMesh, use_session
    from repro_torch.testing.pagetable import (replay_waves, stress_waves,
                                               submit_waves)
    g = _geometry()
    with use_session():
        pt = DelegatedPageTable(StackedMesh((2, 4), device="cpu"),
                                g["n_pages"], max_seqs=g["max_seqs"],
                                page_size=g["page_size"],
                                max_pages=g["max_pages"], capacity=CAPACITY,
                                local_shortcut=shortcut)
        rec = submit_waves(pt, stress_waves(SEED))
        rows = replay_waves(pt, rec)
        resps = [[(op, pt.globalize(f.result(), s)) for op, s, _, f in w]
                 for w in rec]
        stacked = {k: v.clone() for k, v in pt.trust.trustee_state().items()}
        return resps, pt.dump(), pt.audit(), rows, stacked


@pytest.mark.parametrize("shortcut", [False, True])
def test_facade_matches_sequential_oracle(shortcut):
    resps, _, audit, rows, _ = _port_run(shortcut)
    assert rows > 1000 and audit["consistent"] and audit["leaked"] == 0
    assert audit["evictions"] > 0
    flags = {op: np.concatenate([r["flag"] for w in resps for o, r in w
                                 if o == op]) for op in ("alloc", "append")}
    assert (flags["alloc"] == 0).any(), "no infeasible alloc"
    assert (flags["append"] > 1).any(), "no append healed a chain"
    assert (flags["append"] < 0).any(), "no append out of range"


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_pagetable") / "runs.npz"
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


@pytest.mark.parametrize("shortcut", [False, True])
def test_facade_matches_jax_pagetable_on_8_devices(jax_runs, shortcut):
    import torch
    from repro_torch import convert
    resps, dump, audit, _, stacked = _port_run(shortcut)
    tag = f"shortcut{int(shortcut)}"
    for i, wave in enumerate(resps):
        for j, (op, r) in enumerate(wave):
            for k, v in r.items():
                want = jax_runs[f"{tag}/{i}/{j}/{k}"]
                assert np.array_equal(v, want), f"wave {i} {op} {k}"
    for k, v in dump.items():
        assert np.array_equal(v, jax_runs[f"{tag}/final/{k}"]), k
    assert audit["evictions"] == int(jax_runs[f"{tag}/final/evictions"].sum())
    # the JAX owner-major state carried to the port's stacked layout
    carried = convert.stacked_from_owner_major(
        {k: jax_runs[f"{tag}/final/{k}"] for k in stacked}, T, device="cpu")
    for k, v in stacked.items():
        assert torch.equal(carried[k], v), k


def test_facade_contract_and_list_field():
    import torch
    from repro_torch.core import (DelegatedPageTable, ListField, SchemaError,
                                  StackedMesh, use_session)
    from repro_torch.core.pagetable import pagetable_reshard
    with use_session():
        pt = DelegatedPageTable(StackedMesh((2, 4), device="cpu"), 64,
                                max_seqs=16, page_size=4, max_pages=8)
        with pytest.raises(SchemaError, match="unknown seq_id"):
            pt.free([3])
        with pytest.raises(SchemaError, match="outside"):
            pt.alloc([16], [1])
        r = pt.alloc([3, 11], [2, 3])
        assert r["flag"].tolist() == [1, 1] and r["n"].tolist() == [2, 3]
        pages = pt.schema.ops[0].response[0]
        assert isinstance(pages, ListField) and pages.row_shape == (8,)
        assert pages.counts(torch.as_tensor(r["pages"])).tolist() == [2, 3]
        assert pages.trim(r["pages"][1]).tolist() == \
            [p for p in r["pages"][1] if p >= 0]
        assert (r["pages"][:, :2] % T == np.array([[3], [3]])).all()
        assert pt.free([3, 11])["n"].tolist() == [2, 3]
        assert pt.audit()["allocated"] == 0
    with use_session():
        # dedicated mode: 2 trustees own the table, the 6 client shards
        # keep a zero region, global page ids are local * 2 + owner
        pt = DelegatedPageTable(StackedMesh((2, 4), device="cpu"), 64,
                                max_seqs=16, page_size=4, max_pages=8,
                                mode="dedicated", n_dedicated=2)
        assert pt.t == 2 and pt.trust.state()["used"].shape == (8, 32)
        r = pt.alloc([3, 10], [2, 3])
        assert r["flag"].tolist() == [1, 1] and r["n"].tolist() == [2, 3]
        assert (r["pages"][0, :2] % 2 == 1).all()
        assert (r["pages"][1, :3] % 2 == 0).all()
        assert pt.lookup([3])["pages"][0, :2].tolist() == \
            r["pages"][0, :2].tolist()
        assert pt.audit()["allocated"] == 5
        assert pt.free([3, 10])["n"].tolist() == [2, 3]
        assert pt.audit()["allocated"] == 0 and pt.audit()["consistent"]
        assert all(v.size and not v.any()
                   for v in pt.client_region().values())
    # a fresh table re-laid out for 7 trustees is a fresh 7-trustee table
    from repro_torch.core import initial_pagetable_state
    got = pagetable_reshard(initial_pagetable_state(64, 16, 8, 8), 8, 7)
    want = initial_pagetable_state(64, 16, 8, 7)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(SchemaError, match="row_shape"):
        ListField("x", row_shape=(3,), max_len=4)


def _jax_main(out_path):
    import jax
    from jax.sharding import Mesh
    from repro.core import DelegatedPageTable, TrustSession, use_session
    from repro_torch.testing.pagetable import stress_waves
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    g = _geometry()
    res = {}
    for shortcut in (False, True):
        tag = f"shortcut{int(shortcut)}"
        with use_session(TrustSession()) as sess:
            pt = DelegatedPageTable(mesh, g["n_pages"],
                                    max_seqs=g["max_seqs"],
                                    page_size=g["page_size"],
                                    max_pages=g["max_pages"],
                                    capacity=CAPACITY,
                                    local_shortcut=shortcut)
            for i, wave in enumerate(stress_waves(SEED)):
                futs = []
                for op, seqs, arg in wave:
                    fn = getattr(pt, op + "_then")
                    futs.append((seqs, fn(seqs) if arg is None
                                 else fn(seqs, arg)))
                sess.step()
                for j, (seqs, fut) in enumerate(futs):
                    for k, v in pt.globalize(fut.result(), seqs).items():
                        res[f"{tag}/{i}/{j}/{k}"] = v
            for k, v in pt.dump().items():
                res[f"{tag}/final/{k}"] = v
    np.savez(out_path, **res)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
