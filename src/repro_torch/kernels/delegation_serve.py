"""Delegation serve — the trustee's serve phase as three CUDA kernels.

Counterpart of ``repro/kernels/delegation_serve.py``.  The JAX serve ran
four tiled ``pallas_call``s over three kernel bodies and threaded three
table snapshots between them (T0 -> T1 -> T2 -> T3), because a TPU output
block may only be revisited on consecutive grid steps.  The port updates
the trustee's table IN PLACE — the Trust owns its state exclusively — and
keeps the phase order by issuing the kernels in order on one stream
(``core.kvstore.KVTableServe.serve_kernel``):

  gather(GET)          reads the round-entry table          (T0)
  scatter_last(PUT)    last PUT row per segment commits      T0 -> T1
  gather(ADD)          ADD base                             (T1)
  segmented_add        priors into the responses, segment
                       totals into the table                 T1 -> T2
  gather(CAS, expect)  CAS current + compare                (T2)
  scatter_last(CAS)    last matching CAS row commits         T2 -> T3

Every kernel serves all T stacked shards in one launch.  On CPU tensors a
wrapper runs its plain version from ``ref``; on CUDA tensors it launches
its kernel or raises; on meta tensors (a dry run) it checks the call as
for the card and adds its work, every row counted in the lane
(``launch.rooflines``), to the active tally, and writes nothing.  Each wrapper's ``check_*`` holds everything that
can raise before its launch (argument checks, loading the library), so
the serve runs all the checks of a round before its first write.  Each
wrapper's ``launches`` counts its kernel launches, one a call on the card
(``segmented_add`` first zeroes its descriptors' status words with one
``cudaMemsetAsync``); ``gather.lane_launches`` splits gather's by lane.

``row_block`` / ``key_block`` / ``num_row_tiles`` keep the JAX tiling rule
that ``channel.Grouping.tile_meta`` shares; the CUDA kernels need no row
tiles of their own.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..launch import rooflines
from . import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def row_block(n: int, br: int) -> int:
    """Effective row-block size for an N-row batch (the JAX kernels'
    clamp rule: multiples of 128, small batches in one tile)."""
    return max(128, min(br, -(-n // 128) * 128))


def key_block(k: int, bk: int) -> int:
    """Effective key-block size for a K-line table (same clamp rule)."""
    return max(128, min(bk, -(-k // 128) * 128))


def num_row_tiles(n: int, br: int) -> int:
    return -(-n // row_block(n, br))


def _check(fn, name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{fn}: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {list(x.shape)}, "
                         f"expected {list(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _dims(fn, table, keys):
    if table.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{fn}: unsupported device {table.device}")
    if table.dim() != 3 or keys.dim() != 2:
        raise ValueError(f"{fn}: table must be (T, K, W) and keys (T, N)")
    t, k, w = table.shape
    n = keys.shape[1]
    if max(t * n, t * k) * max(w, 1) >= 2 ** 31:
        raise ValueError(f"{fn}: buffers exceed 2^31 elements")
    return t, k, w, n


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------

_GATHER_SIG = {"gather_launch": (_P, _P, _P, _I, _P, _P, _P) + (_I,) * 6
                                 + (_P,),
               "gather_empty_launch": (_I, _P)}

# gather.cu's launch shape: blocks of GATHER_THREADS, a row a thread;
# rows wider than GATHER_WIDE_WORDS take a warp each
GATHER_THREADS = 256
GATHER_WIDE_WORDS = 32


def gather_plan(t: int, n: int, w: int, vec: int) -> dict:
    """The one grid of a ``gather`` launch over the T*N rows: rows
    ``wide`` (a warp a row, ``GATHER_THREADS // 32`` rows a block) or not
    (a row a thread), the rows a block takes and the ``blocks`` that cover
    every row once.  ``vec`` (``word_vec``: 1 or 4) picks the instance; it
    does not change the grid."""
    if vec not in (1, 4):
        raise ValueError(f"gather_plan: vec={vec} is not 1 or 4")
    wide = w > GATHER_WIDE_WORDS
    per = GATHER_THREADS // 32 if wide else GATHER_THREADS
    return dict(wide=wide, rows_a_block=per, blocks=-(-(t * n) // per),
                vec=vec)


def check_gather(table: torch.Tensor, keys: torch.Tensor,
                 lane: torch.Tensor, which: int, out: torch.Tensor,
                 expect: Optional[torch.Tensor] = None,
                 flag: Optional[torch.Tensor] = None) -> None:
    """Check a ``gather`` call's arguments and, on the card, load its
    library: everything that can raise before the launch."""
    if which not in (ref.LANE_GET, ref.LANE_PUT, ref.LANE_ADD, ref.LANE_CAS):
        raise ValueError(f"gather: which={which!r} is not a lane id")
    t, k, w, n = _dims("gather", table, keys)
    if k == 0 and t * n:
        raise ValueError("gather: the table has no lines to read (K 0)")
    dev = table.device
    _check("gather", "table", table, torch.float32, (t, k, w), dev)
    _check("gather", "keys", keys, torch.int32, (t, n), dev)
    _check("gather", "lane", lane, torch.int32, (t, n), dev)
    _check("gather", "out", out, torch.float32, (t, n, w), dev)
    if (expect is None) != (flag is None):
        raise ValueError("gather: expect and flag come together")
    if expect is not None:
        _check("gather", "expect", expect, torch.float32, (t, n, w), dev)
        _check("gather", "flag", flag, torch.int32, (t, n), dev)
    if dev.type == "cuda":
        _build.library("gather.cu", _GATHER_SIG)


def gather(table: torch.Tensor, keys: torch.Tensor, lane: torch.Tensor,
           which: int, out: torch.Tensor,
           expect: Optional[torch.Tensor] = None,
           flag: Optional[torch.Tensor] = None) -> None:
    """Rows of lane ``which`` read their table line into ``out`` (a key
    outside [0, K) reads the clamped line); with ``expect``, also ``flag =
    all(cur == expect)`` (the CAS lane).  Other rows keep ``out`` and
    ``flag`` as they were.  See ``ref.gather``."""
    _build.refuse_grad("gather", table, out, expect)
    check_gather(table, keys, lane, which, out, expect, flag)
    if table.device.type == "cpu":
        return ref.gather(table, keys, lane, which, out, expect, flag)
    if table.device.type == "meta":     # a dry run: every row in the lane
        t, k, w = table.shape
        rooflines.record("gather", rooflines.gather_work(
            t, keys.shape[1], w, cas=expect is not None))
        return None
    t, k, w = table.shape
    n = keys.shape[1]
    if t * n == 0:
        return None
    bufs = (table, out) if expect is None else (table, out, expect)
    plan = gather_plan(t, n, w, word_vec(w, *bufs))
    lib = _build.library("gather.cu", _GATHER_SIG)
    err = lib.gather_launch(
        table.data_ptr(), keys.data_ptr(), lane.data_ptr(), int(which),
        None if expect is None else expect.data_ptr(), out.data_ptr(),
        None if flag is None else flag.data_ptr(), t, n, k, w, plan["vec"],
        plan["blocks"], _stream(table))
    _build.check(err, "gather")
    gather.launches += 1
    gather.lane_launches[which] += 1
    return None


gather.launches = 0
gather.lane_launches = [0, 0, 0, 0]     # by lane id: GET, PUT, ADD, CAS


def gather_empty_launch(plan: dict, device) -> None:
    """An empty kernel on ``plan``'s grid and block: the floor a gather
    launch is weighed against.  Not counted in ``gather.launches``."""
    lib = _build.library("gather.cu", _GATHER_SIG)
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(lib.gather_empty_launch(plan["blocks"], stream),
                 "gather (empty launch)")

# ---------------------------------------------------------------------------

_SCATTER_SIG = {"scatter_last_launch": (_P,) * 6 + (_I,) * 5 + (_P,)}

# the sorted rows a block takes: each source's TILE = THREADS * ITEMS
SCATTER_TILE_ROWS = 256      # scatter_last.cu
SEGADD_TILE_ROWS = 1024      # segmented_add.cu


def word_vec(w: int, *xs: torch.Tensor) -> int:
    """Words a kernel thread moves at once: a float4 where the row width
    is a multiple of 4 and every row buffer is 16-byte aligned, else 1."""
    return 4 if w % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in xs) \
        else 1


def segmented_add_plan(t: int, n: int, w: int, vec: int) -> dict:
    """One ``segmented_add`` launch: its tiles a shard (a block each) and
    the descriptors, its only scratch — ``agg`` floats (a tile's aggregate
    row) and ``status`` words (one a tile and group of ``vec`` words, then
    the ticket; zeroed before the launch)."""
    tiles = -(-n // SEGADD_TILE_ROWS)
    return dict(tiles=tiles, agg=t * tiles * w,
                status=t * tiles * (w // vec) + 1)


def check_scatter_last(table: torch.Tensor, keys: torch.Tensor,
                       order: torch.Tensor, seg_end: torch.Tensor,
                       flag: torch.Tensor, value: torch.Tensor) -> None:
    """Check a ``scatter_last`` call's arguments and, on the card, load its
    library: everything that can raise before the launch."""
    t, k, w, n = _dims("scatter_last", table, keys)
    dev = table.device
    _check("scatter_last", "table", table, torch.float32, (t, k, w), dev)
    for name, x in (("keys", keys), ("order", order), ("seg_end", seg_end),
                    ("flag", flag)):
        _check("scatter_last", name, x, torch.int32, (t, n), dev)
    _check("scatter_last", "value", value, torch.float32, (t, n, w), dev)
    if dev.type == "cuda":
        _build.library("scatter_last.cu", _SCATTER_SIG)


def scatter_last(table: torch.Tensor, keys: torch.Tensor,
                 order: torch.Tensor, seg_end: torch.Tensor,
                 flag: torch.Tensor, value: torch.Tensor) -> None:
    """In every segment the last flagged row writes its value row into its
    table line, in place.  See ``ref.scatter_last``."""
    _build.refuse_grad("scatter_last", table, value)
    check_scatter_last(table, keys, order, seg_end, flag, value)
    if table.device.type == "cpu":
        return ref.scatter_last(table, keys, order, seg_end, flag, value)
    if table.device.type == "meta":     # a dry run: every row commits
        t, k, w = table.shape
        rooflines.record("scatter_last", rooflines.scatter_last_work(
            t, keys.shape[1], w))
        return None
    t, k, w = table.shape
    n = keys.shape[1]
    if t * n * w == 0:
        return None
    lib = _build.library("scatter_last.cu", _SCATTER_SIG)
    err = lib.scatter_last_launch(
        table.data_ptr(), keys.data_ptr(), order.data_ptr(),
        seg_end.data_ptr(), flag.data_ptr(), value.data_ptr(), t, n, k, w,
        word_vec(w, table, value), _stream(table))
    _build.check(err, "scatter_last")
    scatter_last.launches += 1
    return None


scatter_last.launches = 0

# ---------------------------------------------------------------------------

_SEGADD_SIG = {"segmented_add_launch": (_P,) * 10 + (_I,) * 5 + (_P,)}


def check_segmented_add(table: torch.Tensor, keys: torch.Tensor,
                        lane: torch.Tensor, order: torch.Tensor,
                        sid: torch.Tensor, seg_end: torch.Tensor,
                        value: torch.Tensor, resp: torch.Tensor) -> None:
    """Check a ``segmented_add`` call's arguments and, on the card, load its
    library: everything that can raise before the launch."""
    t, k, w, n = _dims("segmented_add", table, keys)
    dev = table.device
    _check("segmented_add", "table", table, torch.float32, (t, k, w), dev)
    for name, x in (("keys", keys), ("lane", lane), ("order", order),
                    ("sid", sid), ("seg_end", seg_end)):
        _check("segmented_add", name, x, torch.int32, (t, n), dev)
    _check("segmented_add", "value", value, torch.float32, (t, n, w), dev)
    _check("segmented_add", "resp", resp, torch.float32, (t, n, w), dev)
    if dev.type == "cuda":
        _build.library("segmented_add.cu", _SEGADD_SIG)


def segmented_add(table: torch.Tensor, keys: torch.Tensor, lane: torch.Tensor,
                  order: torch.Tensor, sid: torch.Tensor,
                  seg_end: torch.Tensor, value: torch.Tensor,
                  resp: torch.Tensor) -> None:
    """ADD rows add their segment-exclusive prior to ``resp``; each
    segment's last ADD row adds the segment total to its table line.  See
    ``ref.segmented_add``."""
    _build.refuse_grad("segmented_add", table, value, resp)
    check_segmented_add(table, keys, lane, order, sid, seg_end, value, resp)
    if table.device.type == "cpu":
        return ref.segmented_add(table, keys, lane, order, sid, seg_end,
                                 value, resp)
    if table.device.type == "meta":     # a dry run: every row an ADD row
        t, k, w = table.shape
        rooflines.record("segmented_add", rooflines.segmented_add_work(
            t, keys.shape[1], w))
        return None
    t, k, w = table.shape
    n = keys.shape[1]
    if t * n * w == 0:
        return None
    dev = table.device
    vec = word_vec(w, table, value, resp)
    plan = segmented_add_plan(t, n, w, vec)
    agg = torch.empty(plan["agg"], dtype=torch.float32, device=dev)
    status = torch.empty(plan["status"], dtype=torch.int32, device=dev)
    lib = _build.library("segmented_add.cu", _SEGADD_SIG)
    err = lib.segmented_add_launch(
        table.data_ptr(), resp.data_ptr(), keys.data_ptr(), lane.data_ptr(),
        order.data_ptr(), sid.data_ptr(), seg_end.data_ptr(),
        value.data_ptr(), agg.data_ptr(), status.data_ptr(), t, n, k, w, vec,
        _stream(table))
    _build.check(err, "segmented_add")
    segmented_add.launches += 1
    return None


segmented_add.launches = 0
