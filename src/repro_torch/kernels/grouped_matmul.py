"""Grouped matmul — one matmul per expert, the MoE trustee's expert FFN.

Counterpart of ``repro/kernels/grouped_matmul.py`` (``_gmm_kernel``).  The
CUDA kernel (``csrc/grouped_matmul.cu``) runs a persistent block on each
SM over the 128 x 128 output tiles: one producer thread keeps a ring of
TMA loads in flight and two warpgroups multiply with ``wgmma`` (bf16 ->
f32).  Given ``counts`` (each expert's filled rows, on the card), a tile
that starts at or past ``counts[e]`` is stored as zeros with no product;
the counts are never read back to the host.  ``ref.grouped_matmul`` is
its plain version.  On CPU tensors the wrapper runs the plain version; on
CUDA tensors it launches the kernel or raises; on meta tensors (a dry
run) it checks the call as for the card, adds its work over every slot
(the filled rows are data; ``launch.rooflines.gmm_work``, as
``torch.bmm`` computes it) to the active tally and returns an empty meta
output.  The kernel takes bf16
only: f32 or f16 on the card raises ``TypeError``.  A ragged C, D or F is
masked in the kernel (the Pallas wrapper pads them); D or F not a
multiple of 8 takes its ``mma.sync`` kernel, which TMA cannot feed.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..launch import rooflines
from . import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"grouped_matmul_launch": (_P, _P, _P, _P, _I, _I, _I, _I,
                                   _P)}
# the fraction of an f32 accumulation's magnitude that one add may lose
# on the tensor cores: 2^-22, four f32 ulps (their internal sums are not
# IEEE-rounded)
_ACC_EPS = 2.0 ** -22


def tolerance(x: torch.Tensor, w: torch.Tensor):
    """(rtol, atol) of the kernel against its plain version, compared in
    bf16, |err| <= atol + rtol * |plain| elementwise.  Both round an f32
    sum to bf16 once, which alone can differ by one ulp, 2^-7 relative.
    The two f32 sums of the same D products differ by at most
    2 * D * eps * sum_d |x_cd * w_df| (the sums taken in another order);
    atol is that bound, an (E, C, F) tensor, with eps = 2^-22."""
    d = x.shape[-1]
    mag = torch.bmm(x.float().abs(), w.float().abs())
    return 2.0 ** -7, 2.0 * d * _ACC_EPS * mag + 1e-6


def _fail(msg, exc=ValueError):
    raise exc(f"grouped_matmul: {msg}")


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, F) -> (E, C, F) in x's dtype: the products
    summed in f32, one matmul per expert.  ``counts`` (E,) int32, when
    given, is each expert's filled rows: x's rows at and past
    ``counts[e]`` must be zero, and the result's rows there are zero (see
    ``ref.grouped_matmul``).  ``grouped_matmul.launches`` counts kernel
    launches."""
    _build.refuse_grad("grouped_matmul", x, w)
    dev = x.device
    if dev.type == "cpu":
        return ref.grouped_matmul(x, w, counts)
    if dev.type not in ("cuda", "meta"):
        _fail(f"unsupported device {dev}")
    if x.dim() != 3 or w.dim() != 3:
        _fail("x must be (E, C, D) and w (E, D, F)")
    e, c, d = x.shape
    f = w.shape[2]
    if tuple(w.shape[:2]) != (e, d):
        _fail(f"w must be (E, D, F) with x's E and D; got x "
              f"{list(x.shape)}, w {list(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.device != dev:
            _fail(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.bfloat16:
            _fail(f"the kernel takes bfloat16 only; {name} is {t.dtype}",
                  TypeError)
    if counts is not None:
        if counts.device != dev or counts.dtype != torch.int32 \
                or tuple(counts.shape) != (e,):
            _fail(f"counts must be an ({e},) int32 tensor on {dev}; got "
                  f"{tuple(counts.shape)} {counts.dtype} on {counts.device}")
        counts = counts.contiguous()
    tiles = e * -(-c // 128) * -(-f // 128)
    if e > 65535 or -(-c // 128) > 65535 or tiles >= 2 ** 31:
        _fail(f"E = {e}, C = {c} or F = {f} exceeds the grid")
    if max(e * c * d, e * d * f, e * c * f) >= 2 ** 40:
        _fail("operands too large")
    if dev.type == "meta":
        # a dry run: the filled rows are data, so every slot is counted
        rooflines.record("grouped_matmul", rooflines.gmm_work(
            e, c, d, f, item=x.element_size()))
        return torch.empty((e, c, f), dtype=x.dtype, device=dev)
    x, w = x.contiguous(), w.contiguous()
    if d == 0:
        return torch.zeros((e, c, f), dtype=x.dtype, device=dev)
    out = torch.empty((e, c, f), dtype=x.dtype, device=dev)
    if e * c * f == 0:
        return out
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            _fail(f"{name} is not 16-byte aligned")
    lib = _build.library("grouped_matmul.cu", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.grouped_matmul_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if counts is None else counts.data_ptr(), e, c, d, f, stream)
    _build.check(err, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
