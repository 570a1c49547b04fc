"""Atomic, integrity-checked checkpoints of a tree of tensors.

The torch counterpart of ``repro.checkpoint.checkpoint``, with the same
on-disk format, so a snapshot written by either package restores in the
other:

    <dir>/step_<N>/
        manifest.json     step, and for each leaf its shape, dtype, crc32
        arrays.npz        one entry per leaf, keyed by its "/"-joined path
    <dir>/LATEST          atomically updated pointer file

  * atomic publish: write ``step_<N>.tmp``, fsync, rename, then replace
    ``LATEST`` (tmp, fsync, rename): a torn write is never a checkpoint;
  * integrity: a crc32 of each leaf's stored bytes, checked on load;
  * bfloat16 leaves are stored as their ``uint16`` bit pattern, with
    ``"bfloat16"`` in the manifest (numpy has no bfloat16);
  * leaves are saved in their logical layout, read back with ``.cpu()``
    at a quiesce point; ``restore`` places each leaf on a device (or
    through a placement function), so the layout it lands in may differ
    from the one it was saved from.

A tree is nested dicts, lists and tuples whose leaves are torch tensors,
numpy arrays or scalars.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Pytree = Any

_SEP = "/"


def _flatten(tree: Pytree, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Leaves keyed by their "/"-joined dict key / list index path, in the
    order JAX's tree flattening visits them (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
        return out
    return {_SEP.join(prefix): tree}


def _unflatten(like: Pytree, leaves: Dict[str, Any],
               prefix: Tuple[str, ...] = ()) -> Pytree:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(v, leaves, prefix + (str(i),))
                 for i, v in enumerate(like)]
        # a NamedTuple (the optimizer state) takes its fields positionally
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    return leaves[_SEP.join(prefix)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(stored array, manifest dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _fsync_write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def save(directory: str, step: int, tree: Pytree,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write a checkpoint; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in _flatten(tree).items():
        arr, stored_dtype = _to_numpy(leaf)
        arrays[name] = arr
        manifest["leaves"][name] = {
            "shape": list(arr.shape), "dtype": stored_dtype,
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes())}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    _fsync_write(os.path.join(tmp, "manifest.json"), json.dumps(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    ptr_tmp = os.path.join(directory, "LATEST.tmp")
    _fsync_write(ptr_tmp, os.path.basename(final))
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    return final


def _scan_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.isdir(os.path.join(directory, d)):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """The step ``LATEST`` names, or — when it is missing or dangling —
    the newest published ``step_*`` directory; None when there is none."""
    ptr = os.path.join(directory, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        if os.path.isdir(os.path.join(directory, name)):
            return int(name.split("_")[1])
    steps = _scan_steps(directory)
    return steps[-1] if steps else None


def _host_leaf(arr: np.ndarray, stored_dtype: str):
    """A stored array as read back: numpy, or a CPU bfloat16 tensor for a
    bfloat16 leaf (numpy has no bfloat16)."""
    if stored_dtype != "bfloat16":
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
        .view(torch.bfloat16)


def _place(leaf, like, device):
    """A restored leaf on ``device`` when one is given, else where its
    ``tree_like`` leaf lives: a tensor ``like`` gives a tensor on its
    device, anything else leaves the leaf on the host (numpy, or a CPU
    tensor for bfloat16)."""
    if device is None and not isinstance(like, torch.Tensor):
        return leaf
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf.to(device if device is not None else like.device)


def restore(directory: str, tree_like: Pytree, step: Optional[int] = None,
            device=None, place: Optional[Callable[[str, Any], Any]] = None
            ) -> Tuple[Pytree, int, Dict[str, Any]]:
    """Restore into the structure of ``tree_like``.  Each leaf goes on
    ``device`` when given, else where its ``tree_like`` leaf lives (see
    ``_place``); ``place(name, leaf)`` — the leaf's path and its host
    value (numpy, bfloat16 as a CPU tensor) — overrides both.  Returns
    (tree, step, the manifest's ``extra``).  A leaf the checkpoint lacks
    raises ``KeyError``, a crc mismatch ``IOError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for name, like in _flatten(tree_like).items():
            meta = manifest["leaves"][name]
            arr = data[name]
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
                    != meta["crc32"]:
                raise IOError(f"checkpoint corruption in leaf {name}")
            leaf = _host_leaf(arr, meta["dtype"])
            out[name] = place(name, leaf) if place is not None \
                else _place(leaf, like, device)
    return _unflatten(tree_like, out), manifest["step"], \
        manifest.get("extra", {})


def prune_old(directory: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints (never the one LATEST points at)."""
    if not os.path.isdir(directory):
        return
    pinned = None
    ptr = os.path.join(directory, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        if name.startswith("step_") and os.path.isdir(
                os.path.join(directory, name)):
            pinned = int(name.split("_")[1])
    steps = _scan_steps(directory)
    for s in steps[:-keep] if keep > 0 else steps:
        if s == pinned:
            continue
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
