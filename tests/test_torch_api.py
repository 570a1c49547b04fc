"""The port's API surface: call-time schema validation, the default
device, the knobs of this slice (dedicated mode, the defer drain,
combining) and those the port does not carry yet, the fused step, state
conversion, and the import boundary (the port and chip_smoke.py import
neither jax nor repro)."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import (DelegatedKVStore, SchemaError, StackedMesh,
                              TrusteeGroup, make_kv_schema, use_session)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")


def _store(**kw):
    return DelegatedKVStore(StackedMesh((2, 4), device="cpu"), 37, 2, **kw)


@pytest.mark.parametrize("call,match", [
    (lambda op: op.put(torch.arange(8), torch.zeros(8, 3)), "row shape"),
    (lambda op: op.put(torch.arange(8), torch.zeros(8, 2, dtype=torch.int32)),
     "kind"),
    (lambda op: op.get(torch.zeros(8)), "kind"),
    (lambda op: op.cas(torch.arange(8), value=torch.zeros(8, 2)), "missing"),
    (lambda op: op.get(torch.arange(8), bogus=1), "no payload field"),
    (lambda op: op.put(torch.arange(8), torch.zeros(7, 2)), "batch size"),
    (lambda op: op.get.then(torch.arange(8), then=None, value=1),
     "no payload field"),
])
def test_bad_batch_raises_before_anything_queues(call, match):
    with use_session() as sess:
        st = _store(capacity=8)
        st.prefill(np.arange(74, dtype=np.float32).reshape(37, 2))
        good = st.get_then(torch.arange(4))
        with pytest.raises(SchemaError, match=match):
            call(st.trust.op)
        assert len(st.trust._pending) == 1 and sess.rounds_dispatched == 0
        sess.step()
        assert np.array_equal(good.result()["value"].numpy(),
                              np.arange(8, dtype=np.float32).reshape(4, 2))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert StackedMesh((2, 4)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackedMesh((2, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.stacked_from_owner_major({"table": np.zeros((8, 2))}, 8)


@pytest.mark.parametrize("kw,stat", [
    (dict(mode="dedicated", n_dedicated=3), "dropped"),
    (dict(overflow="defer", capacity=1, max_rounds=8), "rounds"),
    (dict(overflow="defer", max_rounds=2, capacity=1), "residual"),
    (dict(combine="ref"), "rows_combined"),
])
def test_knobs_carried_now_run(kw, stat):
    """Dedicated mode, the defer drain and request combining run: a
    GET / ADD round on 37 keys answers as the sequential oracle, and the
    knob shows in the round's stats (dedicated: nothing dropped and 5
    client shards of zeros; capacity 1 with the drain: more than one
    round; ``max_rounds=2``: rows left over, answering zeros; combining:
    rows combined)."""
    from repro_torch.core import SequentialKVReference
    keys = torch.as_tensor(np.random.default_rng(2).integers(0, 6, 48))
    init = np.arange(74, dtype=np.float32).reshape(37, 2)
    with use_session() as sess:
        st = _store(**kw)
        st.prefill(init)
        got = st.get(keys).numpy()
        st.add(keys, torch.ones(48, 2))
        stats = sess.last_stats()[st.trust.name]
    ref = SequentialKVReference(37, 2)
    ref.prefill(init)
    want = ref.get(keys.numpy())
    if stat == "residual":
        # the rows left over answer zeros; the rest read the table
        assert stats["residual"] > 0 and stats["rounds"] == 2, stats
        served = got.any(-1) | ~want.any(-1)
        assert 0 < served.sum() < 48
        assert np.array_equal(got[served], want[served])
        return
    assert np.array_equal(got, want)
    ref.add(keys.numpy(), np.ones((48, 2), np.float32))
    assert np.array_equal(st.dump(), ref.dump())
    if stat == "dropped":
        assert stats["dropped"] == 0 and st.client_region().shape == (65, 2)
        assert not st.client_region().any()
    else:
        assert stats[stat] > (1 if stat == "rounds" else 0), stats


@pytest.mark.parametrize("kw,refusal", [
    (dict(serve_blocks="auto"), None),
    (dict(pack_blocks="auto"), None),
    (dict(serve_blocks=(128, 128)), "Pallas tile"),
    (dict(pack_blocks=(256, 512)), "Pallas tile"),
], ids=["kw0-'auto' kernel blocks", "kw1-'auto' kernel blocks",
        "kw2-'auto' kernel blocks", "kw3-'auto' kernel blocks"])
def test_knobs_not_carried_raise_naming_roadmap(kw, refusal):
    """``"auto"`` blocks are the kernels' own launch plans: a store built
    with them serves a round exactly as the default store does.  A fixed
    Pallas tile pair has no counterpart and raises, saying why."""
    if refusal is not None:
        with use_session():
            with pytest.raises(NotImplementedError, match=refusal):
                _store(**kw)
        return
    rng = np.random.default_rng(9)
    init = rng.integers(0, 8, (37, 2)).astype(np.float32)
    keys = torch.as_tensor(rng.integers(0, 37, 40), dtype=torch.int32)
    vals = torch.as_tensor(rng.integers(0, 8, (40, 2)).astype(np.float32))
    out = []
    for extra in (kw, {}):
        with use_session():
            st = _store(capacity=8, **extra)
            st.prefill(init)
            old = st.add(keys, vals)
            out.append((old.numpy(), st.get(keys).numpy(), st.dump()))
    for a, b in zip(*out):
        assert np.array_equal(a, b)


def test_async_step_sub_axis_and_fused_round_raise():
    """``step(sync=False)`` on an idle session; a sub-axis trustee group
    is JAX's (4 trustees of the "model" axis, the state in 2 replicas);
    two channel-compatible trusts pending fuse into ONE round that
    answers as the two solo rounds do; a trust pending alone flushes
    solo."""
    rng = np.random.default_rng(4)
    init = rng.integers(0, 8, (37, 2)).astype(np.float32)
    keys = [torch.as_tensor(rng.integers(0, 37, 24)) for _ in range(2)]
    vals = [torch.as_tensor(rng.integers(0, 8, (24, 2)).astype(np.float32))
            for _ in range(2)]
    runs = {}
    for fused in (True, False):
        with use_session() as sess:
            assert sess.step(sync=False) is None and sess.quiesced()
            g = TrusteeGroup(StackedMesh((2, 4), device="cpu"), "model")
            assert (g.n_trustees, g.n_replicas, g.n_origins) == (4, 2, 8)
            # the shortcut's local rows and the auto capacity depend on
            # the row layout, which fusing changes: both off here
            a, b = (_store(name=n, capacity=24, local_shortcut=False)
                    for n in "ab")
            a.prefill(init)
            b.prefill(init)
            futs = [a.add_then(keys[0], vals[0]), b.get_then(keys[1]),
                    b.put_then(keys[0], vals[1])]
            if fused:
                sess.step()
                assert sess.last_step_info == {"fused": [["a", "b"]],
                                               "solo": []}
                assert sess.rounds_dispatched == 1
            else:
                a.flush()
                b.flush()
                assert sess.rounds_dispatched == 2
            runs[fused] = [f.result()["value"].numpy() for f in futs] \
                + [a.dump(), b.dump()]
            a.get_then(keys[1])
            sess.step()          # one pending trust flushes solo
            assert sess.last_step_info == {"fused": [], "solo": ["a"]}
            assert not a.trust._pending
    assert all(np.array_equal(x, y) for x, y in zip(runs[True], runs[False]))


def test_convert_round_trip_and_store_start_state():
    rng = np.random.default_rng(0)
    t, n_keys, w = 8, 37, 2
    owner_major = rng.integers(0, 9, (40, w)).astype(np.float32)
    state = convert.stacked_from_owner_major({"table": owner_major}, t,
                                             device="cpu")
    assert state["table"].shape == (t, 5, w)
    back = convert.owner_major_from_stacked(state)
    assert np.array_equal(back["table"], owner_major)
    state["table"][0, 0] += 1        # both directions copy: no aliasing
    assert np.array_equal(back["table"], owner_major)
    assert owner_major[0, 0] + 1 == state["table"][0, 0, 0]
    state["table"][0, 0] -= 1
    with use_session():
        st = DelegatedKVStore(StackedMesh((2, 4), device="cpu"), n_keys, w,
                              state=state)
        keys = np.arange(n_keys)
        want = owner_major[(keys % t) * 5 + keys // t]
        assert np.array_equal(st.dump(), want)
        assert np.array_equal(st.get(torch.as_tensor(keys)).numpy(), want)
        st.put(torch.as_tensor(keys), torch.zeros(n_keys, w))
        # the store copied the state: the caller's tensors are untouched
        assert np.array_equal(convert.owner_major_from_stacked(state)
                              ["table"], owner_major)


def test_failed_kernel_round_leaves_table_and_queue_intact(monkeypatch):
    """The kernel serve writes the table in place, so it runs the checks
    of all a round's kernels before the first launch.  A round whose last
    check (the ADD scan's, after the GET gather and the PUT commit) raises
    has written nothing; flush re-queues its batches, and the retry
    answers as if the round had never failed."""
    from repro_torch.kernels import ops as kops
    rng = np.random.default_rng(5)
    init = rng.integers(0, 8, (37, 2)).astype(np.float32)
    keys = [torch.as_tensor(np.where(rng.random(48) < 0.5, 3,
                                     rng.integers(0, 37, 48)))
            for _ in range(4)]
    vals = [torch.as_tensor(rng.integers(0, 8, (48, 2)).astype(np.float32))
            for _ in range(4)]

    def boom(*args):
        raise RuntimeError("injected check failure")

    outs = []
    for fail in (False, True):
        with use_session() as sess:
            st = _store(capacity=48)
            st.prefill(init)
            futs = [st.get_then(keys[0]), st.put_then(keys[1], vals[1]),
                    st.add_then(keys[2], vals[2]),
                    st.cas_then(keys[3], vals[2], vals[3])]
            if fail:
                monkeypatch.setitem(kops.CHECKS, "segmented_add", boom)
                with pytest.raises(RuntimeError, match="injected"):
                    st.flush()
                monkeypatch.undo()
                assert np.array_equal(st.dump(), init)
                assert len(st.trust._pending) == 4
                assert not any(f.ready() for f in futs)
                assert sess.rounds_dispatched == 0
            st.flush()
            outs.append([f.result()[k] for f in futs for k in ("value", "flag")]
                        + [torch.as_tensor(st.dump())])
    assert not np.array_equal(outs[0][-1].numpy(), init)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_stringly_shims_match_typed_handles():
    rng = np.random.default_rng(3)
    keys = torch.as_tensor(rng.integers(0, 37, 64))
    vals = torch.as_tensor(rng.integers(0, 8, (64, 2)).astype(np.float32))
    init = rng.integers(0, 8, (37, 2)).astype(np.float32)
    outs = []
    for typed in (True, False):
        with use_session():
            st = _store(capacity=64)
            st.prefill(init)
            if typed:
                f = st.cas_then(keys, vals, vals + 1)
                st.put_then(keys, vals)
                st.flush()
                got = st.get(keys)
            else:
                f = st.trust.submit("cas", st.route(keys),
                                    st._payload(keys, vals + 1, vals))
                st.trust.submit("put", st.route(keys),
                                st._payload(keys, vals))
                st.flush()
                got = st.trust.apply("get", st.route(keys),
                                     {"key": keys})["value"]
            outs.append((f.result()["flag"], f.result()["value"], got,
                         st.dump()))
        with pytest.raises(KeyError):
            st.trust.submit("nope", st.route(keys), {"key": keys})
    for a, b in zip(*outs):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_kv_reshard_matches_jax_and_local_trustees():
    from repro_torch.core import kv_reshard, local_trustees, use_mesh
    rng = np.random.default_rng(1)
    table = rng.integers(0, 9, (40, 2)).astype(np.float32)
    got = kv_reshard({"table": table}, 8, 7)["table"]
    keys = np.arange(40)             # key k: owner k % T, local row k // T
    assert got.shape == (42, 2)
    assert np.array_equal(got[(keys % 7) * 6 + keys // 7],
                          table[(keys % 8) * 5 + keys // 8])
    try:
        from repro.core import kv_reshard as jax_kv_reshard
    except ImportError:
        jax_kv_reshard = None
    if jax_kv_reshard is not None:
        assert np.array_equal(
            got, jax_kv_reshard({"table": table}, 8, 7)["table"])
    with use_mesh(StackedMesh((1, 8), device="cpu")):
        assert local_trustees().n_trustees == 8
    with use_mesh(StackedMesh((2, 4), device="cpu")):
        g = local_trustees()           # JAX's default: the "model" group
        assert (g.axes, g.n_trustees, g.n_replicas) == (("model",), 4, 2)
        assert local_trustees(("data", "model")).n_trustees == 8


def test_stats_report_elided_response_bytes():
    """A PUT-only round moves no response; a GET-only round drops the
    flag column: resp_bytes_saved = rows per shard x elided bytes per row
    (the JAX tree wire format's count)."""
    with use_session() as sess:
        st = _store(capacity=8)          # 8 trustees x (8 + 8) rows
        st.put(torch.arange(16), torch.ones(16, 2))
        assert sess.last_stats()[st.trust.name]["resp_bytes_saved"] == \
            128 * (2 * 4 + 4)
        st.get(torch.arange(16))
        stats = sess.last_stats()[st.trust.name]
        assert stats["resp_bytes_saved"] == 128 * 4
        assert (stats["rounds"], stats["residual"], stats["dropped"]) == \
            (1, 0, 0)


def test_schema_build_time_checks():
    from repro_torch.core import Field, OpSpec, TrustSchema
    with pytest.raises(SchemaError, match="reserved"):
        OpSpec("x", payload=(Field("where"),))
    with pytest.raises(SchemaError, match="agree"):
        TrustSchema("s", ops=[OpSpec("a", payload=(Field("k", (), torch.int32),)),
                              OpSpec("b", payload=(Field("k", (2,)),))])
    schema = make_kv_schema(8, 4)
    with pytest.raises(SchemaError, match="state leaf"):
        schema.validate_state({"table": torch.zeros(8, 5, 3)})


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f} imports {mod}"
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, repro_torch, repro_torch.core, repro_torch.convert, "
         "repro_torch.kernels.ops; "
         "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
         "or m == 'repro' for m in sys.modules))"],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
