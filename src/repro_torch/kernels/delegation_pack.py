"""Delegation pack — the channel's client-side pack phase.

Counterpart of ``repro/kernels/delegation_pack.py``.  The CUDA kernels
(``csrc/delegation_pack.cu``) pack every client shard in one call and
place both the primary and the second_round block (the JAX channel reruns
its kernel on the rejected rows for the latter).  The payload rides as
32-bit words: f32 and int32 columns are reinterpreted, narrower ints and
bools widened, so every value — integers above 2^24 included — comes back
bit for bit.

A call launches four kernels, all named ``delegation_pack_*``: count the
rows of each (chunk, shard) per destination, scan the chunks, rank each
chunk's rows FIFO and place every slot row (its source row or zeros).
``launch_plan`` sets their grids from the shapes alone, so a call reads
nothing back from the card.

On CPU tensors the wrapper runs the plain version (``ref.pack_stacked``);
on CUDA tensors it launches the kernels or raises; on meta tensors (a dry
run) it checks the call as for the card, adds its work with every slot
counted filled (``launch.rooflines.pack_work``) to the active tally and
returns empty meta outputs.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from ..launch import rooflines
from . import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"delegation_pack_launch": (_P, _P) + (_I,) * 6 + (_P,) * 7
        + (_I,) * 6 + (_P,)}
# the shared memory a block may opt in to on Hopper (227 KB); the rank
# kernel keeps 1 + 2 * warps int32 counters a destination there
_MAX_SMEM = 232448
CHUNK = 2048            # rows of a shard that one count / rank block takes
PLACE_THREADS = 256     # threads of a place block (csrc: PLACE_THREADS)


class Plan(NamedTuple):
    """The launch parameters of one call, from the shapes alone."""
    chunk: int          # rows a (chunk, shard) block of count / rank takes
    n_chunks: int       # chunks a shard: ceil(R / chunk)
    rank_threads: int   # threads of a rank block (a multiple of 32)
    group: int          # lanes a slot row in the place kernel (8, 16,
    #                     32), or 0: a flat walk, a thread a word
    place_blocks: int   # blocks of the place kernel's grid-stride walk
    vec: bool           # 16-byte copies (W % 4 == 0, aligned words)


def launch_plan(r: int, w: int, t: int, slot_rows: int, sms: int,
                aligned: bool = True) -> Plan:
    """The grids of one call: ``r`` rows a shard of ``w`` words to ``t``
    destinations, ``slot_rows`` = D * T * (C + C2) slot rows in all, on a
    card of ``sms`` multiprocessors; ``aligned`` when the words start on a
    16-byte boundary."""
    n_chunks = -(-r // CHUNK)
    warps = min(32, max(1, -(-min(r, CHUNK) // 32)))
    if t:
        warps = min(warps, max(1, (_MAX_SMEM // 4 // t - 1) // 2))
    vec = aligned and w % 4 == 0 and w >= 32
    lanes = w // 4 if vec else w
    group = 0
    if w >= 32:
        group = 8
        while group < min(lanes, 32):
            group *= 2
        per_block = PLACE_THREADS // 32 * (32 // group)    # slot rows
        need = -(-slot_rows // per_block)
    else:
        need = -(-slot_rows * w // PLACE_THREADS)           # slot words
    place_blocks = min(need, 8 * sms)
    return Plan(CHUNK, n_chunks, 32 * warps, group, place_blocks, vec)


def chunk_rows(plan: Plan, r: int) -> List[Tuple[int, int]]:
    """The [lo, hi) rows of a shard that each chunk's blocks take, in
    order, as the count and rank kernels compute them."""
    return [(c * plan.chunk, min((c + 1) * plan.chunk, r))
            for c in range(plan.n_chunks)]


def place_rows(plan: Plan, slot_rows: int, w: int) -> List[int]:
    """Every (slot row, word) the place kernel writes, as row * w + word,
    in the order of its walk: flat, a thread a word (group 0), or a group
    of lanes a row, each lane a word of it in ``group``."""
    threads = plan.place_blocks * PLACE_THREADS
    if plan.group == 0:
        return [e for tid in range(threads)
                for e in range(tid, slot_rows * w, threads)]
    rpw = 32 // plan.group
    step = threads // 32 * rpw
    return [row * w + k for warp in range(threads // 32)
            for sub in range(rpw)
            for row in range(warp * rpw + sub, slot_rows, step)
            for k in range(w)]


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
    counts calls that launched the kernels (four a call at every main
    path's shapes)."""
    _build.refuse_grad("delegation_pack", dst, words)
    if capacity < 1 or capacity2 < 0:
        raise ValueError(f"delegation_pack: capacity must be >= 1 and "
                         f"capacity2 >= 0, got {capacity}, {capacity2}")
    if dst.device.type == "cpu":
        return ref.pack_stacked(dst, words, n_trustees, capacity, capacity2)
    if dst.device.type not in ("cuda", "meta"):
        raise ValueError(f"delegation_pack: unsupported device {dst.device}")
    d, r = dst.shape
    w = words.shape[-1]
    t, c, c2 = n_trustees, capacity, capacity2
    _check("dst", dst, torch.int32, (d, r), dst.device)
    _check("words", words, torch.int32, (d, r, w), dst.device)
    if 3 * t * 4 > _MAX_SMEM:
        raise ValueError(f"delegation_pack: {t} trustees exceed the "
                         f"kernel's shared-memory counters")
    if d > 65535:
        raise ValueError(f"delegation_pack: {d} client shards exceed the "
                         f"grid's 65535")
    # the kernels number a shard's rows and slots in int32 and address
    # words with 64-bit offsets
    if max(r, t * (c + c2)) >= 2 ** 31:
        raise ValueError("delegation_pack: a shard's rows or slots exceed "
                         "2^31")
    kw = dict(dtype=torch.int32, device=dst.device)
    slots = torch.empty((d, t * c, w), **kw)
    slots2 = torch.empty((d, t * c2, w), **kw)
    counts = torch.empty((d, t), **kw)
    counts2 = torch.empty((d, t), **kw)
    request_slot = torch.empty((d, r), **kw)
    totals = torch.empty((d, t), **kw)
    if dst.device.type == "meta":
        # a dry run: which rows are placed is data, so every slot is
        # counted filled
        rooflines.record("delegation_pack", rooflines.pack_work(
            d, r, w, t, c, c2))
        return slots, slots2, counts, counts2, request_slot, totals
    if d == 0:
        return slots, slots2, counts, counts2, request_slot, totals
    sms = torch.cuda.get_device_properties(dst.device).multi_processor_count
    plan = launch_plan(r, w, t, d * t * (c + c2), sms,
                       words.data_ptr() % 16 == 0)
    scratch = torch.empty(d * plan.n_chunks * t + d * t * (c + c2), **kw)
    lib = _build.library("delegation_pack.cu", _SIG)
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    err = lib.delegation_pack_launch(
        dst.data_ptr(), words.data_ptr(), d, r, w, t, c, c2,
        slots.data_ptr(), slots2.data_ptr(), counts.data_ptr(),
        counts2.data_ptr(), request_slot.data_ptr(), totals.data_ptr(),
        scratch.data_ptr(), plan.chunk, plan.n_chunks, plan.rank_threads,
        plan.group, plan.place_blocks, int(plan.vec), stream)
    _build.check(err, "delegation_pack")
    delegation_pack.launches += 1
    return slots, slots2, counts, counts2, request_slot, totals


delegation_pack.launches = 0
