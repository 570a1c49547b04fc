"""Paged decode attention — one query token per sequence over its chain of
KV pages.

Counterpart of ``repro/kernels/paged_attention.py`` (``_pa_kernel``).  The
CUDA kernel (``csrc/paged_attention.cu``) splits each chain over several
blocks (``split_plan``: a fixed run of pages per split, from MP alone, so
the lengths stay on the card), loads each live page once for all the
query heads of its group with bulk copies kept in flight, runs the
products on the tensor cores in bf16 / f16 (one warp for all the heads of
a group) and the online softmax in f32, and the last split of a group to
finish merges the group's partials in split order;
``ref.paged_attention`` is its plain version.  On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches
the kernel or raises; on meta tensors (a dry run) it checks the call's
shapes and dtypes, adds its work with every page of the table counted
live (``launch.rooflines.paged_attention_work``) to the active tally and
returns an empty meta output.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..launch import rooflines
from . import _build, ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"paged_attention_launch": (_I,) + (_P,) * 9 + (_I,) * 10
        + (_F, _I, _I, _I, _P)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_SMEM = 227 * 1024
_MAX_D = 256
# pages a split takes at most, the bulk-copy stages a block keeps in
# flight at most, and the tensor-core kernel's warps a block
PAGES_PER_SPLIT = 4
_STAGES = 4
_MMA_WARPS = 4

# the kernel against its plain version, |err| <= atol + rtol * |plain|:
# f32 sums in another order (online softmax page by page against one
# softmax over the gathered chain) move results by ~1e-6 relative; in
# bf16 that can flip the output's rounding by one ulp, at most 2^-7
# relative (8 significant bits), in f16 2^-10 (11 bits)
TOLERANCE = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-5),
             torch.float16: (2.0 ** -10, 1e-5)}


def _fail(msg, exc=ValueError):
    raise exc(f"paged_attention: {msg}")


def split_plan(mp: int):
    """(pages per split, splits) of a chain of ``mp`` pages: split s takes
    pages [s * pps, min((s + 1) * pps, live)) of a chain with ``live``
    pages, and the splits past ``live`` do nothing.  Short chains take a
    page or two a split so that they still spread over several blocks."""
    pps = max(1, min(PAGES_PER_SPLIT, mp // 4))
    return pps, -(-mp // pps)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D); k_pages / v_pages (P, Hkv, PS, D) in q's dtype;
    page_table (B, MP) int32 global page ids (-1 pad); lengths (B,) int32,
    each >= 1 -> (B, Hq, D) in q's dtype.  ``paged_attention.launches``
    counts kernel launches."""
    _build.refuse_grad("paged_attention", q, k_pages, v_pages)
    dev = q.device
    if dev.type == "cpu":
        return ref.paged_attention(q, k_pages, v_pages, page_table, lengths,
                                   scale)
    if dev.type not in ("cuda", "meta"):
        _fail(f"unsupported device {dev}")
    if q.dim() != 3 or k_pages.dim() != 4:
        _fail("q must be (B, Hq, D) and the pools (P, Hkv, PS, D)")
    b, hq, d = q.shape
    p, hkv, ps, d2 = k_pages.shape
    mp = page_table.shape[-1] if page_table.dim() == 2 else -1
    if q.dtype not in _DTYPES:
        _fail(f"q must be float32, bfloat16 or float16, got {q.dtype}",
              TypeError)
    for name, x, shape, dt in (
            ("k_pages", k_pages, (p, hkv, ps, d), q.dtype),
            ("v_pages", v_pages, (p, hkv, ps, d), q.dtype),
            ("page_table", page_table, (b, mp), torch.int32),
            ("lengths", lengths, (b,), torch.int32), ("q", q, (b, hq, d),
                                                      q.dtype)):
        if x.device != dev:
            _fail(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dt:
            _fail(f"{name} must be {dt}, got {x.dtype}", TypeError)
        if tuple(x.shape) != tuple(shape):
            _fail(f"{name} has shape {list(x.shape)}, expected "
                  f"{list(shape)}")
        if not x.is_contiguous():
            _fail(f"{name} must be contiguous")
    if d2 != d or d > _MAX_D or hkv < 1 or hq % hkv or hq // hkv > 32:
        _fail(f"needs D <= {_MAX_D} equal in q and the pools and Hq a "
              f"multiple of Hkv with at most 32 query heads per KV head; "
              f"got q {list(q.shape)}, pools {list(k_pages.shape)}")
    if p < 1 or ps < 1 or mp < 1:
        _fail("needs a non-empty pool, pages and page table")
    item = q.element_size()
    if dev.type == "meta":
        # a dry run: the lengths are data, so every page of the table is
        # counted live; the kernel's plan reads pointers and is not made
        rooflines.record("paged_attention", rooflines.paged_attention_work(
            b, hq, hkv, ps, d, b * mp, item))
        return torch.empty(q.shape, dtype=q.dtype, device=dev)
    pps, ns = split_plan(mp)
    page_bytes = ps * d * item
    rep = hq // hkv
    scores = -(-4 * rep * ps // 8) * 8
    bulk = (page_bytes % 16 == 0 and k_pages.data_ptr() % 16 == 0
            and v_pages.data_ptr() % 16 == 0
            and 2 * page_bytes + scores + 16 <= _MAX_SMEM)
    # the merge's weights: (ns + 1) floats a query head of the group
    merge = 4 * rep * (ns + 1) if ns > 1 else 0
    # the tensor cores take bf16 / f16 pages of 16-position groups at D 64
    # or 128 for up to 16 query heads a KV head, every page of a split in
    # flight at once; the rest the CUDA cores
    region = -(-max(2 * pps * page_bytes,
                    4 * _MMA_WARPS * rep * (d + 2)) // 16) * 16
    mma = (bulk and q.dtype != torch.float32 and ps % 16 == 0
           and d in (64, 128) and rep <= 16 and q.data_ptr() % 16 == 0
           and region + 16 * pps + merge <= _MAX_SMEM)
    if mma:
        nst = pps
        smem = region + 16 * nst + merge
    else:
        nst = min(_STAGES, pps)
        while nst > 1 and \
                nst * 2 * page_bytes + scores + 16 * nst + merge > _MAX_SMEM:
            nst -= 1
        smem = (nst * 2 * page_bytes if bulk else 0) + scores + 16 * nst \
            + merge
    if smem > _MAX_SMEM:
        _fail(f"a page's scores ({smem} bytes of shared memory) exceed "
              f"the {_MAX_SMEM} bytes a block can hold")
    if max(p * hkv * ps * d, b * hq * d, b * mp, b * hq * ns * d) >= 2 ** 31:
        _fail("buffers exceed 2^31 elements")
    out = torch.empty_like(q)
    if b == 0:
        return out
    part_ml = part_acc = counter = None
    if ns > 1:
        part_ml = torch.empty((b, hq, ns, 2), dtype=torch.float32,
                              device=dev)
        part_acc = torch.empty((b, hq, ns, d), dtype=torch.float32,
                               device=dev)
        counter = torch.zeros((b * hkv,), dtype=torch.int32, device=dev)
    sc = float(scale) if scale is not None else 1.0 / float(d) ** 0.5
    lib = _build.library("paged_attention.cu", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.paged_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), ptr(part_ml), ptr(part_acc), ptr(counter), b, hq,
        hkv, p, ps, d, mp, pps, ns, nst, sc, 2 if mma else int(not bulk),
        region, smem, stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
