"""Delegation pack — the channel's client-side pack phase.

Counterpart of ``repro/kernels/delegation_pack.py``.  The CUDA kernel
(``csrc/delegation_pack.cu``) packs every client shard in one launch and
places both the primary and the second_round block (the JAX channel reruns
its kernel on the rejected rows for the latter).  The payload rides as
32-bit words: f32 and int32 columns are reinterpreted, narrower ints and
bools widened, so every value — integers above 2^24 included — comes back
bit for bit.

On CPU tensors the wrapper runs the plain version (``ref.pack_stacked``);
on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"delegation_pack_launch": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                                   _P, _P, _P, _P, _I, _P)}
_MAX_SMEM = 48 * 1024


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"delegation_pack: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"delegation_pack: {name} must be {dtype}, got "
                        f"{x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"delegation_pack: {name} has shape "
                         f"{list(x.shape)}, expected {list(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"delegation_pack: {name} must be contiguous")


def delegation_pack(dst: torch.Tensor, words: torch.Tensor, n_trustees: int,
                    capacity: int, capacity2: int = 0):
    """Pack every client shard's rows into per-trustee slots.

    dst (D, R) int32 in [-1, T); words (D, R, W) int32.  Returns
    (slots (D, T*C, W), slots2 (D, T*C2, W), counts (D, T),
    counts2 (D, T), request_slot (D, R), totals (D, T)) — see
    ``ref.pack_stacked`` for the contract.  ``delegation_pack.launches``
    counts kernel launches."""
    if capacity < 1 or capacity2 < 0:
        raise ValueError(f"delegation_pack: capacity must be >= 1 and "
                         f"capacity2 >= 0, got {capacity}, {capacity2}")
    if dst.device.type == "cpu":
        return ref.pack_stacked(dst, words, n_trustees, capacity, capacity2)
    if dst.device.type != "cuda":
        raise ValueError(f"delegation_pack: unsupported device {dst.device}")
    d, r = dst.shape
    w = words.shape[-1]
    t, c, c2 = n_trustees, capacity, capacity2
    _check("dst", dst, torch.int32, (d, r), dst.device)
    _check("words", words, torch.int32, (d, r, w), dst.device)
    if t * 4 > _MAX_SMEM:
        raise ValueError(f"delegation_pack: {t} trustees exceed the "
                         f"kernel's shared-memory counters")
    if max(d * t * (c + c2), d * r) * max(w, 1) >= 2 ** 31:
        raise ValueError("delegation_pack: buffers exceed 2^31 words")
    kw = dict(dtype=torch.int32, device=dst.device)
    slots = torch.empty((d, t * c, w), **kw)
    slots2 = torch.empty((d, t * c2, w), **kw)
    counts = torch.empty((d, t), **kw)
    counts2 = torch.empty((d, t), **kw)
    request_slot = torch.empty((d, r), **kw)
    totals = torch.empty((d, t), **kw)
    if d == 0:
        return slots, slots2, counts, counts2, request_slot, totals
    threads = min(1024, max(32, -(-r // 32) * 32))
    lib = _build.library("delegation_pack.cu", _SIG)
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    err = lib.delegation_pack_launch(
        dst.data_ptr(), words.data_ptr(), d, r, w, t, c, c2,
        slots.data_ptr(), slots2.data_ptr(), counts.data_ptr(),
        counts2.data_ptr(), request_slot.data_ptr(), totals.data_ptr(),
        threads, stream)
    _build.check(err, "delegation_pack")
    delegation_pack.launches += 1
    return slots, slots2, counts, counts2, request_slot, totals


delegation_pack.launches = 0
