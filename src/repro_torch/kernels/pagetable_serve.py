"""Page-table serve — the delegated page table's trustee serve, one op pass.

Port-only kernel: the JAX page table serves each op as a ``lax.scan`` over
the trustee's rows with an eviction ``while_loop`` per alloc / append step
(``repro/core/pagetable.py:250-315``), not a Pallas kernel.  The CUDA
kernel (``csrc/pagetable_serve.cu``) runs one block per trustee: the
block compacts the pass's valid rows and loads the state into shared
memory (``used`` as a bitmap), one warp applies the rows in serve order,
and the block writes back only what the rows changed;
``ref.pagetable_serve`` is its plain version.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises; on meta tensors (a dry run) it checks the
call as for the card, adds its work with every row counted valid
(``launch.rooflines.pagetable_work``) to the active tally and returns
empty meta responses.  Either way the state tensors are updated
IN PLACE and the responses are fresh tensors.  The kernel writes the
responses of valid rows only and leaves the rest unwritten (the plain
version zeroes them): the masked pass that calls it keeps valid rows
only, so no response buffer is filled first.
"""
from __future__ import annotations

import ctypes

import torch

from ..launch import rooflines
from . import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"pagetable_serve_launch": (_I,) * 8 + (_P,) * 13 + (_I, _P),
        "pagetable_empty_launch": (_I, _I, _P),
        "pagetable_serve_info": (_I, _P)}
_MAX_SMEM = 227 * 1024
# csrc/pagetable_serve.cu: NT threads a block, LIST valid rows listed
# (row, seq, arg) in shared memory for each serial walk
_THREADS, _LIST = 256, 2048
_STATE = ("used", "chains", "chain_len", "last_used", "clock", "evictions")


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"pagetable_serve: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"pagetable_serve: {name} must be {dtype}, got "
                        f"{x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"pagetable_serve: {name} has shape "
                         f"{list(x.shape)}, expected {list(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"pagetable_serve: {name} must be contiguous")


def smem_bytes(pl: int, sl: int, mp: int) -> int:
    """Shared memory a block takes for a trustee of ``pl`` local pages and
    ``sl`` local sequences of ``mp`` pages: the chains, chain_len and
    last_used as int32, ``used`` and its dirty marks as bitmaps of ``pl``
    bits, the touched sequences' bitmap, the row list and the scan's warp
    sums (``smem_needed`` in the CUDA source)."""
    words = -(-pl // 32)
    return 4 * (sl * mp + 2 * sl + 2 * words + -(-sl // 32) + 3 * _LIST
                + _THREADS // 32 + 1)


def check_fits(pl: int, sl: int, mp: int) -> int:
    """``smem_bytes(pl, sl, mp)``, or ValueError where a trustee's state
    exceeds the shared memory a block can hold."""
    smem = smem_bytes(pl, sl, mp)
    if smem > _MAX_SMEM:
        raise ValueError(f"pagetable_serve: a trustee's state ({smem} bytes) "
                         f"exceeds the {_MAX_SMEM} bytes of shared memory "
                         f"a block can hold")
    return smem


def empty_launch(n_trustees: int, smem: int, device) -> None:
    """Launch a kernel that does nothing on the serve's grid, block and
    shared memory: the floor a serve launch is weighed against.  Not
    counted in ``pagetable_serve.launches``."""
    lib = _build.library("pagetable_serve.cu", _SIG)
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(lib.pagetable_empty_launch(n_trustees, smem, stream),
                 "pagetable_serve (empty launch)")


def kernel_info(pl: int, sl: int, mp: int) -> dict:
    """The CUDA kernel as built, at a trustee of ``pl`` pages and ``sl``
    sequences of ``mp`` pages: registers a thread, local (spill) bytes a
    thread, its shared memory, resident blocks an SM."""
    smem = check_fits(pl, sl, mp)
    lib = _build.library("pagetable_serve.cu", _SIG)
    out = (ctypes.c_int * 3)()
    _build.check(lib.pagetable_serve_info(smem, out), "pagetable_serve_info")
    return dict(registers=out[0], local_bytes=out[1], smem=smem,
                blocks_per_sm=out[2], warps_a_block=_THREADS // 32)


def pagetable_serve(op: int, used: torch.Tensor, chains: torch.Tensor,
                    chain_len: torch.Tensor, last_used: torch.Tensor,
                    clock: torch.Tensor, evictions: torch.Tensor,
                    seq: torch.Tensor, arg: torch.Tensor, valid: torch.Tensor,
                    n_trustees: int, page_size: int):
    """One op pass over every trustee; see ``ref.pagetable_serve`` for the
    contract (responses of rows that are not valid are unspecified here).
    ``pagetable_serve.launches`` counts kernel launches."""
    _build.refuse_grad("pagetable_serve", used, chains, chain_len,
                       last_used, clock, evictions, seq, arg, valid)
    if op not in ref.PT_OPS.values():
        raise ValueError(f"pagetable_serve: unknown op {op}")
    if page_size < 1 or n_trustees < 1:
        raise ValueError("pagetable_serve: page_size and n_trustees must be "
                         ">= 1")
    dev = seq.device
    if dev.type == "cpu":
        return ref.pagetable_serve(op, used, chains, chain_len, last_used,
                                   clock, evictions, seq, arg, valid,
                                   n_trustees, page_size)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"pagetable_serve: unsupported device {dev}")
    t, n = seq.shape
    pl = used.shape[1]
    sl, mp = chains.shape[1], chains.shape[2]
    i32 = torch.int32
    for name, x, shape in (("used", used, (t, pl)),
                           ("chains", chains, (t, sl, mp)),
                           ("chain_len", chain_len, (t, sl)),
                           ("last_used", last_used, (t, sl)),
                           ("clock", clock, (t, 1)),
                           ("evictions", evictions, (t, 1)),
                           ("seq", seq, (t, n)), ("arg", arg, (t, n))):
        _check(name, x, shape, i32, dev)
    _check("valid", valid, (t, n), torch.bool, dev)
    if max(t * n * mp, t * sl * mp, t * pl) >= 2 ** 31:
        raise ValueError("pagetable_serve: buffers exceed 2^31 elements")
    smem = check_fits(pl, sl, mp)
    kw = dict(dtype=i32, device=dev)
    pages = torch.empty((t, n, mp), **kw)
    page = torch.empty((t, n), **kw)
    n_out = torch.empty((t, n), **kw)
    flag = torch.empty((t, n), **kw)
    if dev.type == "meta":
        # a dry run: validity is data, so every row is counted valid
        state = (used, chains, chain_len, last_used, clock, evictions)
        rooflines.record("pagetable_serve", rooflines.pagetable_work(
            op in (ref.PT_OPS["alloc"], ref.PT_OPS["append"]),
            sum(x.numel() for x in state), t * n, None, mp))
        return pages, page, n_out, flag
    if t == 0 or n == 0:
        return pages, page, n_out, flag
    lib = _build.library("pagetable_serve.cu", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # a block a stacked shard (t: in dedicated mode the client shards
    # too, which hold no rows); n_trustees divides the sequence ids
    err = lib.pagetable_serve_launch(
        op, t, n_trustees, n, pl, sl, mp, page_size, used.data_ptr(),
        chains.data_ptr(), chain_len.data_ptr(), last_used.data_ptr(),
        clock.data_ptr(), evictions.data_ptr(), seq.data_ptr(),
        arg.data_ptr(), valid.data_ptr(), pages.data_ptr(), page.data_ptr(),
        n_out.data_ptr(), flag.data_ptr(), smem, stream)
    _build.check(err, "pagetable_serve")
    pagetable_serve.launches += 1
    return pages, page, n_out, flag


pagetable_serve.launches = 0
