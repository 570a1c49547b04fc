"""Page-table serve — the delegated page table's trustee serve, one op pass.

Port-only kernel: the JAX page table serves each op as a ``lax.scan`` over
the trustee's rows with an eviction ``while_loop`` per alloc / append step
(``repro/core/pagetable.py:250-315``), not a Pallas kernel.  The CUDA
kernel (``csrc/pagetable_serve.cu``) runs one warp per trustee over its
rows in serve order, the state in shared memory; ``ref.pagetable_serve``
is its plain version.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.  Either way the state tensors are updated
IN PLACE and the responses are fresh tensors.  The kernel writes the
responses of valid rows only and leaves the rest unwritten (the plain
version zeroes them): the masked pass that calls it keeps valid rows
only, so no response buffer is filled first.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"pagetable_serve_launch": (_I,) * 7 + (_P,) * 13 + (_I, _P)}
_MAX_SMEM = 227 * 1024
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


def pagetable_serve(op: int, used: torch.Tensor, chains: torch.Tensor,
                    chain_len: torch.Tensor, last_used: torch.Tensor,
                    clock: torch.Tensor, evictions: torch.Tensor,
                    seq: torch.Tensor, arg: torch.Tensor, valid: torch.Tensor,
                    n_trustees: int, page_size: int):
    """One op pass over every trustee; see ``ref.pagetable_serve`` for the
    contract (responses of rows that are not valid are unspecified here).
    ``pagetable_serve.launches`` counts kernel launches."""
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
    if dev.type != "cuda":
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
    smem = 4 * (pl + sl * mp + 2 * sl)
    if smem > _MAX_SMEM:
        raise ValueError(f"pagetable_serve: a trustee's state ({smem} bytes) "
                         f"exceeds the {_MAX_SMEM} bytes of shared memory "
                         f"a block can hold")
    kw = dict(dtype=i32, device=dev)
    pages = torch.empty((t, n, mp), **kw)
    page = torch.empty((t, n), **kw)
    n_out = torch.empty((t, n), **kw)
    flag = torch.empty((t, n), **kw)
    if t == 0 or n == 0:
        return pages, page, n_out, flag
    lib = _build.library("pagetable_serve.cu", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pagetable_serve_launch(
        op, n_trustees, n, pl, sl, mp, page_size, used.data_ptr(),
        chains.data_ptr(), chain_len.data_ptr(), last_used.data_ptr(),
        clock.data_ptr(), evictions.data_ptr(), seq.data_ptr(),
        arg.data_ptr(), valid.data_ptr(), pages.data_ptr(), page.data_ptr(),
        n_out.data_ptr(), flag.data_ptr(), smem, stream)
    _build.check(err, "pagetable_serve")
    pagetable_serve.launches += 1
    return pages, page, n_out, flag


pagetable_serve.launches = 0
