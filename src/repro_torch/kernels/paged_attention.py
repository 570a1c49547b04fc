"""Paged decode attention — one query token per sequence over its chain of
KV pages.

Counterpart of ``repro/kernels/paged_attention.py`` (``_pa_kernel``).  The
CUDA kernel (``csrc/paged_attention.cu``) runs one block per (sequence,
KV head), loads each live page once for all the query heads of its group
and keeps the online softmax in f32; ``ref.paged_attention`` is its plain
version.  On CPU tensors the wrapper runs the plain version; on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"paged_attention_launch": (_I,) + (_P,) * 6 + (_I,) * 7
        + (_F, _I, _I, _P)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_SMEM = 227 * 1024
_MAX_D = 256

# the kernel against its plain version, |err| <= atol + rtol * |plain|:
# f32 sums in another order (online softmax page by page against one
# softmax over the gathered chain) move results by ~1e-6 relative; in
# bf16 that can flip the output's rounding by one ulp, at most 2^-7
# relative (8 significant bits)
TOLERANCE = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}


def _fail(msg, exc=ValueError):
    raise exc(f"paged_attention: {msg}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D); k_pages / v_pages (P, Hkv, PS, D) in q's dtype;
    page_table (B, MP) int32 global page ids (-1 pad); lengths (B,) int32,
    each >= 1 -> (B, Hq, D) in q's dtype.  ``paged_attention.launches``
    counts kernel launches."""
    dev = q.device
    if dev.type == "cpu":
        return ref.paged_attention(q, k_pages, v_pages, page_table, lengths,
                                   scale)
    if dev.type != "cuda":
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
    smem = -(-2 * ps * d * item // 16) * 16 + 4 * (hq // hkv) * ps
    if smem > _MAX_SMEM:
        _fail(f"a page of K and V ({smem} bytes of shared memory) exceeds "
              f"the {_MAX_SMEM} bytes a block can hold")
    if max(p * hkv * ps * d, b * hq * d, b * mp) >= 2 ** 31:
        _fail("buffers exceed 2^31 elements")
    out = torch.empty_like(q)
    if b == 0:
        return out
    vec = int((ps * d * item) % 16 == 0 and k_pages.data_ptr() % 16 == 0
              and v_pages.data_ptr() % 16 == 0)
    sc = float(scale) if scale is not None else 1.0 / float(d) ** 0.5
    lib = _build.library("paged_attention.cu", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, hq, hkv, p, ps, d, mp, sc, vec, smem, stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
