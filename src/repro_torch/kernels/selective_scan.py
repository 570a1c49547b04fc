"""Selective scan — the Mamba-1 SSM recurrence of the prefill.

Counterpart of ``repro/kernels/selective_scan.py`` (``_scan_kernel``).  The
CUDA kernel (``csrc/selective_scan.cu``) splits each channel's N states
over a few lanes of a warp (``scan_plan``), keeps them in f32 registers,
walks time in chunks double-buffered in shared memory, and sums y over
the channel's lanes with shuffles; ``ref.selective_scan`` is its plain
version.  On CPU tensors the wrapper runs the plain version; on CUDA
tensors it launches the kernel or raises; on meta tensors (a dry run) it
checks the call as for the card, adds its work
(``launch.rooflines.scan_work``) to the active tally and returns empty
meta outputs.  x and dt are bf16 or f32 (the
same), y comes back in x's dtype, every other operand is f32.  A ragged
S or DI is masked in the kernel (the Pallas wrapper asserts S % 64 == 0
and DI % 256 == 0).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..launch import rooflines
from . import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"selective_scan_launch": (_I,) + (_P,) * 9 + (_I,) * 5 + (_P,),
        "selective_scan_info": (_I, _I, _P)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 64          # N past this raises: csrc/selective_scan.cu N_MAX
# lanes a channel of the kernel's instances (SCAN_PLANS in
# csrc/selective_scan.cu), each lane holding STATES_A_LANE states
LANES = (1, 2, 4, 8)
STATES_A_LANE = 8
_THREADS = 256          # a block's threads: csrc/selective_scan.cu NT
_ULP = 2.0 ** -23       # an f32 ulp, relative to the value, at most
# the f32 difference one step may add between the kernel and the plain
# version, in ulps of the step's magnitude (see ``tolerance``)
_STEP_ULPS = 8


def tolerance(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[float, torch.Tensor, torch.Tensor]:
    """(rtol, atol_y (B, S, DI), atol_h (B, DI, N)) of the kernel against
    its plain version on these inputs: |y_kernel - y_plain| <= atol_y +
    rtol * |y_plain| compared in x's dtype, and |h_kernel - h_plain| <=
    atol_h in f32.  For dt >= 0 and a <= 0 (the model's softplus and
    -exp), so each step's decay exp(dt * a) lies in [0, 1].

    One step's f32 difference between the two: the kernel's exp is
    ``__expf``'s ``ex2.approx`` of x log2 e (its .ftz form), off by at
    most 2 + 1.173 |dt a| ulps, the plain version's by 2;
    (4 + 1.173 x) e^-x <= 4 e^(-x/2) for x >= 0, so the decayed state
    moves by at most 4 ulps of sqrt(exp(dt a)) |h|.  The kernel multiplies
    dt * x then B (the plain version dt * B then x) and may contract the
    update into an FMA: a few ulps of |dt x B| and of the sum.  Under 8
    ulps of H'_t = sqrt(exp(dt_t a)) H'_{t-1} + |dt_t x_t B_t| (from
    |h0|), which bounds |h_t|.  Carried forward, a step's difference
    decays by exp(dt a) <= sqrt(exp(dt a)), so after t + 1 steps the state
    differs by at most 8 (t + 1) ulps of H'_t.  y adds the N-term dot
    product with C and D * x, summed in another order on each side:
    (N + 2) ulps of y'_t = sum_n |C_n| H'_n + |D x|.  So
    atol_y = (8 (t + 1) + N + 2) ulps of y'_t and atol_h = 8 (S + 1) ulps
    of H'_S, where H' and y' are the plain scan of (2|x|, dt / 2, a, |B|,
    |C|, |D| / 2, |h0|).  In bf16 both sides round their f32 y once more,
    each by half a bf16 ulp: rtol 2^-7 (plus 1% on both for the rounding
    of the bound itself); in f32 rtol is 0.  1e-30 covers the kernel's
    exp flushing a denormal decay to 0."""
    if bool((dt < 0).any()) or bool((a > 0).any()):
        raise ValueError("selective_scan.tolerance holds for dt >= 0 and "
                         "a <= 0 only")
    n = a.shape[1]
    s = x.shape[1]
    y_abs, h_abs = ref.selective_scan(
        2 * x.float().abs(), dt.float() / 2, a, b.float().abs(),
        c.float().abs(), d.float().abs() / 2,
        None if h0 is None else h0.float().abs())
    steps = torch.arange(1, s + 1, device=x.device, dtype=torch.float32)
    atol_y = ((_STEP_ULPS * steps + n + 2) * _ULP)[None, :, None] * y_abs
    atol_h = _STEP_ULPS * (s + 1) * _ULP * h_abs + 1e-30
    if x.dtype == torch.float32:
        return 0.0, atol_y + 1e-30, atol_h
    return 1.01 * 2.0 ** -7, 1.01 * atol_y + 1e-30, atol_h


def scan_plan(n: int) -> Tuple[int, int]:
    """(lanes, states a lane) of the kernel for N states a channel: the
    fewest lanes that hold N.  Lane g of a channel keeps states g * spl ..
    g * spl + spl - 1; those at N and past it are padding (zeros)."""
    if not 1 <= n <= MAX_STATE:
        _fail(f"the kernel keeps at most {MAX_STATE} states a channel; "
              f"got N = {n}")
    return next((lanes, STATES_A_LANE) for lanes in LANES
                if n <= lanes * STATES_A_LANE)


def kernel_info(dtype: torch.dtype, n: int) -> dict:
    """The CUDA kernel of ``scan_plan(n)`` for x in ``dtype``, as built:
    registers a thread, local (spill) bytes a thread,
    dynamic shared memory a block, resident blocks an SM, warps a block."""
    lanes, spl = scan_plan(n)
    lib = _build.library("selective_scan.cu", _SIG)
    out = (ctypes.c_int * 4)()
    _build.check(lib.selective_scan_info(_DTYPES[dtype], lanes, out),
                 "selective_scan_info")
    return dict(lanes=lanes, states_a_lane=spl, registers=out[0],
                local_bytes=out[1], smem=out[2], blocks_per_sm=out[3],
                warps_a_block=_THREADS // 32)


def _fail(msg, exc=ValueError):
    raise exc(f"selective_scan: {msg}")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt (B, S, DI); a (DI, N); b, c (B, S, N); d (DI,); h0 (B, DI, N)
    or None (zeros) -> (y (B, S, DI) in x's dtype, h_final (B, DI, N)
    f32); see ``ref.selective_scan``.  ``selective_scan.launches`` counts
    kernel launches."""
    _build.refuse_grad("selective_scan", x, dt, a, b, c, d, h0)
    dev = x.device
    if dev.type == "cpu":
        return ref.selective_scan(x, dt, a, b, c, d, h0)
    if dev.type not in ("cuda", "meta"):
        _fail(f"unsupported device {dev}")
    if x.dim() != 3 or a.dim() != 2:
        _fail("x must be (B, S, DI) and a (DI, N)")
    bsz, s, di = x.shape
    n = a.shape[1]
    if x.dtype not in _DTYPES:
        _fail(f"the kernel takes x in float32 or bfloat16, not {x.dtype}",
              TypeError)
    lanes, _ = scan_plan(n)
    want = (("dt", dt, (bsz, s, di), x.dtype),
            ("a", a, (di, n), torch.float32),
            ("b", b, (bsz, s, n), torch.float32),
            ("c", c, (bsz, s, n), torch.float32),
            ("d", d, (di,), torch.float32))
    if h0 is not None:
        want += (("h0", h0, (bsz, di, n), torch.float32),)
    for name, t, shape, dtype in want:
        if t.device != dev:
            _fail(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            _fail(f"{name} must be {dtype}, got {t.dtype}", TypeError)
        if tuple(t.shape) != shape:
            _fail(f"{name} has shape {list(t.shape)}, expected "
                  f"{list(shape)}")
    if bsz > 65535:
        _fail(f"B = {bsz} exceeds the grid")
    if dev.type == "meta":              # a dry run: shapes and work only
        rooflines.record("selective_scan", rooflines.scan_work(
            bsz, s, di, n, x.element_size()))
        return (torch.empty((bsz, s, di), dtype=x.dtype, device=dev),
                torch.empty((bsz, di, n), dtype=torch.float32, device=dev))
    x, dt, a, b, c, d = (t.contiguous() for t in (x, dt, a, b, c, d))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty_like(x)
    h = torch.empty((bsz, di, n), dtype=torch.float32, device=dev)
    if bsz * di == 0:
        return y, h
    lib = _build.library("selective_scan.cu", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.selective_scan_launch(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), d.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        bsz, s, di, n, lanes, stream)
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    return y, h


selective_scan.launches = 0
