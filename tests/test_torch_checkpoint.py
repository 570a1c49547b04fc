"""The port's checkpoint module (``repro_torch.checkpoint``) and its
on-disk compatibility with the JAX package's (``repro.checkpoint``).

The host-level cases of ``tests/test_checkpoint.py`` run on the port —
atomic publish (a torn ``.tmp`` never restores, a stale one is replaced),
crc integrity, bfloat16 bit for bit, placement (a device, a placement
function, the ``tree_like`` leaf's device), the empty directory, a
dangling or missing ``LATEST``, ``prune_old`` pinning ``LATEST`` and
``keep=0`` — and files pass between the packages both ways: the JAX side
(one subprocess: this module, run as a script, on one CPU device)
restores a tree and a session snapshot the port wrote, and writes a tree
the port restores.  The port's session snapshot is a KV store of 8
trustees on the 2x4 stacked mesh; the JAX session restores it on one
device, through ``kv_reshard`` (8 -> 1).
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

N_KEYS, VW = 37, 2


def _np_tree():
    """The tree both packages write: an f32 table, an int32 leaf, a nested
    bfloat16 leaf (as its uint16 bit pattern) and a list."""
    bf = np.linspace(-3, 3, 16).astype(np.float32)
    bits = (bf.view(np.uint32) >> 16).astype(np.uint16)   # truncated bf16
    return {"table": np.arange(24, dtype=np.float32).reshape(8, 3),
            "ids": np.arange(5, dtype=np.int32) - 2,
            "nested": {"bf": bits},
            "lst": [np.full((2,), 7, np.int32), np.zeros((1, 2), np.float32)]}


def _torch_tree():
    import torch
    t = _np_tree()
    return {"table": torch.as_tensor(t["table"]),
            "ids": torch.as_tensor(t["ids"]),
            "nested": {"bf": torch.from_numpy(t["nested"]["bf"].view(
                np.int16)).view(torch.bfloat16)},
            "lst": [torch.as_tensor(x) for x in t["lst"]]}


def _same_tree(got, want):
    import torch
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_tree(a, b)
    else:
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(torch.int16)
        assert torch.equal(got, want)


@pytest.fixture
def ckpt():
    from repro_torch.checkpoint import checkpoint
    return checkpoint


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py's cases on the port
# ---------------------------------------------------------------------------

def test_torn_tmp_never_restored(tmp_path, ckpt):
    t = _torch_tree()
    ckpt.save(str(tmp_path), 1, t)
    torn = os.path.join(tmp_path, "step_00000002.tmp")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        f.write('{"step": 2')
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, step, _ = ckpt.restore(str(tmp_path), t)
    assert step == 1


def test_save_overwrites_stale_tmp(tmp_path, ckpt):
    t = _torch_tree()
    stale = os.path.join(tmp_path, "step_00000003.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "garbage"), "w") as f:
        f.write("x")
    ckpt.save(str(tmp_path), 3, t)
    assert not os.path.exists(stale)
    out, step, _ = ckpt.restore(str(tmp_path), t, step=3)
    _same_tree(out, t)


def test_crc_corruption_detected(tmp_path, ckpt):
    t = _torch_tree()
    path = ckpt.save(str(tmp_path), 1, t)
    npz = os.path.join(path, "arrays.npz")
    data = {k: np.array(v) for k, v in np.load(npz).items()}
    data["table"].flat[5] += 1.0
    np.savez(npz, **data)
    with pytest.raises(IOError, match="corruption.*table"):
        ckpt.restore(str(tmp_path), t)


def test_bfloat16_round_trip_bit_exact(tmp_path, ckpt):
    import torch
    t = _torch_tree()
    t["nested"]["bf"] = torch.linspace(-3, 3, 16).to(torch.bfloat16)
    ckpt.save(str(tmp_path), 1, t)
    with open(os.path.join(tmp_path, "step_00000001",
                           "manifest.json")) as f:
        meta = json.load(f)["leaves"]["nested/bf"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [16]
    out, _, _ = ckpt.restore(str(tmp_path), t)
    got = out["nested"]["bf"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       t["nested"]["bf"].view(torch.int16))


def test_restore_places_each_leaf(tmp_path, ckpt):
    """A ``tree_like`` tensor leaf comes back a tensor on its device, a
    non-tensor one as numpy (bfloat16: a CPU tensor); ``device`` puts every
    leaf there; ``place(name, leaf)`` decides each."""
    import torch
    t = _torch_tree()
    ckpt.save(str(tmp_path), 7, t)
    like = {"table": 0, "ids": torch.zeros(1, dtype=torch.int32),
            "nested": {"bf": 0}, "lst": [0, 0]}
    out, step, _ = ckpt.restore(str(tmp_path), like)
    assert step == 7
    assert isinstance(out["table"], np.ndarray)
    assert isinstance(out["ids"], torch.Tensor)
    assert out["nested"]["bf"].dtype == torch.bfloat16
    out, _, _ = ckpt.restore(str(tmp_path), like, device="cpu")
    _same_tree(out, t)
    seen = []

    def place(name, leaf):
        seen.append(name)
        return ("placed", name)
    out, _, _ = ckpt.restore(str(tmp_path), like, place=place)
    assert out["lst"][1] == ("placed", "lst/1")
    assert sorted(seen) == ["ids", "lst/0", "lst/1", "nested/bf", "table"]
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), {"missing": 0})


def test_restore_empty_dir_raises_filenotfound_naming_directory(tmp_path,
                                                               ckpt):
    target = str(tmp_path / "nothing_here")
    with pytest.raises(FileNotFoundError, match="nothing_here"):
        ckpt.restore(target, _torch_tree())


def test_latest_step_tolerates_dangling_pointer(tmp_path, ckpt):
    t = _torch_tree()
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), s, t)
    shutil.rmtree(os.path.join(tmp_path, "step_00000003"))
    assert ckpt.latest_step(str(tmp_path)) == 2
    _, step, _ = ckpt.restore(str(tmp_path), t)
    assert step == 2


def test_latest_step_tolerates_missing_pointer(tmp_path, ckpt):
    ckpt.save(str(tmp_path), 4, _torch_tree())
    os.remove(os.path.join(tmp_path, "LATEST"))
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_latest_step_empty_dir_is_none(tmp_path, ckpt):
    assert ckpt.latest_step(str(tmp_path)) is None
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_prune_old_never_deletes_latest_target(tmp_path, ckpt):
    t = _torch_tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t)
    with open(os.path.join(tmp_path, "LATEST"), "w") as f:
        f.write("step_00000002")
    ckpt.prune_old(str(tmp_path), keep=1)
    left = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert left == ["step_00000002", "step_00000005"]
    _, step, _ = ckpt.restore(str(tmp_path), t)
    assert step == 2


def test_prune_keep_zero_still_pins_latest(tmp_path, ckpt):
    t = _torch_tree()
    for s in (1, 2):
        ckpt.save(str(tmp_path), s, t)
    ckpt.prune_old(str(tmp_path), keep=0)
    left = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert left == ["step_00000002"]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _port_session_snapshot(ckdir):
    """A port KV store of 8 trustees (2x4 stacked), a few rounds, one
    session snapshot; returns its table in key order."""
    import torch
    import repro_torch.core as core
    rng = np.random.default_rng(3)
    sess = core.TrustSession()
    st = core.DelegatedKVStore(core.StackedMesh((2, 4), device="cpu"),
                               N_KEYS, VW, capacity=64, name="kv",
                               session=sess, local_shortcut=False)
    st.prefill(rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32))
    for _ in range(3):
        st.add_then(torch.as_tensor(rng.integers(0, N_KEYS, 64)
                                    .astype(np.int32)),
                    torch.as_tensor(rng.integers(0, 8, (64, VW))
                                    .astype(np.float32)))
        sess.step()
    assert sess.checkpoint(ckdir) == 3
    return st.dump()


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The port writes its files, then the JAX side reads them and writes
    its own (one subprocess)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    base = tmp_path_factory.mktemp("cross")
    ckpt.save(str(base / "port_tree"), 11, _torch_tree(),
              extra={"by": "port"})
    table = _port_session_snapshot(str(base / "port_session"))
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([src,
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(base)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(base / "jax_read.npz") as z:
        read = {k: z[k] for k in z.files}
    return base, read, table


def test_jax_checkpoint_restores_in_the_port(cross):
    """A tree JAX saved (bfloat16 included) restores in the port bit for
    bit, with JAX's ``extra``."""
    from repro_torch.checkpoint import checkpoint as ckpt
    base, _read, _table = cross
    out, step, extra = ckpt.restore(str(base / "jax_tree"), _torch_tree())
    assert step == 12 and extra == {"by": "jax"}
    _same_tree(out, _torch_tree())


def test_port_checkpoint_restores_in_jax(cross):
    """JAX restored the tree the port saved, bit for bit (its bfloat16
    leaf as the same bits)."""
    _base, read, _table = cross
    want = _np_tree()
    assert int(read["step"]) == 11 and str(read["by"]) == "port"
    for k in ("table", "ids"):
        assert read[k].dtype == want[k].dtype
        assert np.array_equal(read[k], want[k]), k
    assert np.array_equal(read["nested/bf"], want["nested"]["bf"])
    assert np.array_equal(read["lst/0"], want["lst"][0])


def test_port_session_snapshot_restores_in_jax(cross):
    """JAX's ``TrustSession.restore`` takes the port's session snapshot (8
    trustees) on one device: the schema fingerprint checks out, the table
    re-lays out through ``kv_reshard`` and reads back in key order."""
    _base, read, table = cross
    assert int(read["session_step"]) == 3
    assert np.array_equal(read["session_table"], table)


def _jax_main(base):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.checkpoint import checkpoint as jckpt
    import repro.core as core
    t = _np_tree()
    like = {"table": jnp.zeros(1), "ids": jnp.zeros(1),
            "nested": {"bf": jnp.zeros(1)}, "lst": [0, 0]}
    out, step, extra = jckpt.restore(os.path.join(base, "port_tree"), like)
    assert out["nested"]["bf"].dtype == jnp.bfloat16
    read = {"step": step, "by": extra["by"],
            "table": np.asarray(out["table"]), "ids": np.asarray(out["ids"]),
            "nested/bf": np.asarray(out["nested"]["bf"]).view(np.uint16),
            "lst/0": np.asarray(out["lst"][0])}
    jtree = dict(t, nested={"bf": jnp.asarray(
        t["nested"]["bf"].view(jnp.bfloat16))})
    jckpt.save(os.path.join(base, "jax_tree"), 12, jtree,
               extra={"by": "jax"})
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    with core.use_session(core.TrustSession()) as sess:
        st = core.DelegatedKVStore(mesh, N_KEYS, VW, capacity=64, name="kv",
                                   local_shortcut=False)
        read["session_step"] = sess.restore(
            os.path.join(base, "port_session"))
        read["session_table"] = np.asarray(st.dump())
    np.savez(os.path.join(base, "jax_read.npz"), **read)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
