"""Flash attention forward — causal (or full) GQA attention over a whole
prompt, the prefill's attention.

Counterpart of ``repro/kernels/flash_attention.py`` (``_fa_kernel``).  The
CUDA kernels (``csrc/flash_attention.cu``) run one block per query tile
of a (batch, query head), loop over KV tiles up to the causal diagonal
with the online softmax in registers, and run both products on the
tensor cores; ``ref.flash_attention`` is their plain version.  Which
kernel a launch takes is a choice by head dimension (``kernel_for``):
D 64, 128, 192 and 256 — every main path's — the warp-specialised one
(TMA loads into an mbarrier ring, ``wgmma`` for both products, 128-row
query tiles; at D 256, gemma-7b's, its 64 x 256 f32 accumulator leaves
ptxas short of registers, and it spills: ``kernel_info``); D 32 the
simple ``mma.sync`` one (64-row query tiles).  On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches
a kernel or raises; on meta tensors (a dry run, ``launch.dryrun``) it
checks the call as for the card, adds its work
(``launch.rooflines.flash_work``) to the active tally and returns an
empty meta output.  The kernels take bf16 only: f32 or f16 on the card
raises ``TypeError``.  A ragged tail of Sq or Skv is masked in the kernel
(the Pallas wrapper refuses one).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..launch import rooflines
from . import _build, ref

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIG = {"flash_attention_launch": (_P,) * 4 + (_I,) * 6 + (_L,) * 12
        + (_F, _I, _I, _P),
        "flash_attention_info": (_I, _P)}
HEAD_DIMS = (32, 64, 128, 192, 256)
WGMMA_HEAD_DIMS = (64, 128, 192, 256)


def kernel_for(d: int) -> str:
    """The kernel that takes head dimension ``d``: "wgmma" (TMA + wgmma,
    warp-specialised) for D 64, 128, 192 and 256, "mma.sync" for D 32.
    The C launcher makes the same choice."""
    if d in WGMMA_HEAD_DIMS:
        return "wgmma"
    if d in HEAD_DIMS:
        return "mma.sync"
    _fail(f"head dim {d} not in {HEAD_DIMS}")


def query_tile(d: int) -> int:
    """Query rows a block of ``kernel_for(d)`` takes."""
    return 128 if kernel_for(d) == "wgmma" else 64


def kernel_info(d: int) -> dict:
    """The CUDA kernel that takes head dimension ``d``, as built:
    registers a thread, local (spill) bytes a thread and dynamic shared
    memory a block."""
    kernel_for(d)
    lib = _build.library("flash_attention.cu", _SIG)
    out = (ctypes.c_int * 3)()
    _build.check(lib.flash_attention_info(d, out), "flash_attention_info")
    return dict(kernel=kernel_for(d), registers=out[0], local_bytes=out[1],
                smem=out[2])


def tolerance(v: torch.Tensor):
    """(rtol, atol) of the kernel against its plain version, compared in
    bf16, |err| <= atol + rtol * |plain|.  Both round their f32 result to
    bf16, which alone can differ by one ulp, 2^-7 relative.  The kernel
    also rounds P (each weight in [0, 1]) to bf16 for the PV product,
    relative error at most 2^-9 a weight, so the normalised output moves
    by at most 2^-9 * max|v|; 1e-5 covers the f32 sums taken in another
    order."""
    return 2.0 ** -7, 2.0 ** -9 * float(v.float().abs().max()) + 1e-5


def _fail(msg, exc=ValueError):
    raise exc(f"flash_attention: {msg}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` if its pointer is 16-byte aligned, its last dimension
    contiguous and its other strides multiples of 8 values (TMA's 16-byte
    strides, the mma.sync kernel's 16-byte row loads); else a contiguous
    copy."""
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in x.stride()[:-1])):
        return x
    return x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: Optional[int] = None, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D), Hq a multiple of Hkv; any
    strides (a (B, S, H, D) tensor transposed to (B, H, S, D) is read in
    place) -> (B, Hq, Sq, D) in q's dtype and q's layout.  ``q_offset``
    (an int >= 0) shifts the query positions.  ``flash_attention.launches``
    counts kernel launches."""
    _build.refuse_grad("flash_attention", q, k, v)
    off = 0 if q_offset is None else int(q_offset)
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   q_offset=off)
    if dev.type not in ("cuda", "meta"):
        _fail(f"unsupported device {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        _fail("q must be (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D)")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev:
            _fail(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != torch.bfloat16:
            _fail(f"the kernel takes bfloat16 only; {name} is {x.dtype}",
                  TypeError)
    if tuple(k.shape) != (b, hkv, skv, d) or tuple(v.shape) != tuple(
            k.shape):
        _fail(f"k and v must be (B, Hkv, Skv, D) with q's B and D; got q "
              f"{list(q.shape)}, k {list(k.shape)}, v {list(v.shape)}")
    if d not in HEAD_DIMS:
        _fail(f"head dim {d} not in {HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        _fail(f"{hq} query heads do not group over {hkv} KV heads")
    if off < 0:
        _fail(f"q_offset must be >= 0, got {off}")
    if b * hq > 65535 or -(-sq // query_tile(d)) * b * hq >= 2 ** 31:
        _fail(f"B * Hq = {b * hq} x {sq} queries exceed the grid")
    if max(sq, skv) + off >= 2 ** 31:
        _fail("positions exceed int32")
    if dev.type == "meta":              # a dry run: shapes and work only
        rooflines.record("flash_attention", rooflines.flash_work(
            b, hq, hkv, sq, skv, d, off, causal, q.element_size()))
        return torch.empty(q.shape, dtype=q.dtype, device=dev)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)           # q's layout, so a transpose is free
    if out.stride(-1) != 1 or any(s % 8 for s in out.stride()[:-1]):
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    if b * hq * sq == 0:
        return out
    if skv == 0:                        # nothing to attend to: l = 0
        return out.zero_()
    sc = float(scale) if scale is not None else 1.0 / float(d) ** 0.5
    if not sc > 0:
        _fail(f"scale must be > 0 (the kernels fold it into the "
              f"exponent), got {sc}")
    lib = _build.library("flash_attention.cu", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        hkv, sq, skv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], sc, int(bool(causal)), off, stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
