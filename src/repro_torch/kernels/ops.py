"""Public wrappers for the main path's kernels.

Every op takes ``impl`` in {"ref", "kernel"} (the JAX package's "ref" and
"pallas"):

  * "ref"    — the plain PyTorch version from ``ref.py``, on any device;
  * "kernel" — the CUDA kernel on CUDA tensors (built at first use); on
               CPU tensors its plain version, which is how the CPU tests
               reach the kernel path.

``launch_counts()`` reads each kernel wrapper's launch counter and
``reset_launch_counts()`` zeroes them, so a run can show that its main
path went through the kernels.  ``check(name, ...)`` runs a serve
kernel's pre-launch checks on the arguments of its call, so a caller
that writes in place can check a whole round before its first launch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import ref
from .delegation_pack import delegation_pack as _pack_kernel
from .delegation_serve import gather as _gather_kernel
from .delegation_serve import scatter_last as _scatter_last_kernel
from .delegation_serve import segmented_add as _segmented_add_kernel
from .delegation_serve import (check_gather, check_scatter_last,
                               check_segmented_add)
from .flash_attention import flash_attention as _flash_attention_kernel
from .grouped_matmul import grouped_matmul as _grouped_matmul_kernel
from .paged_attention import paged_attention as _paged_attention_kernel
from .pagetable_serve import pagetable_serve as _pagetable_serve_kernel
from .selective_scan import selective_scan as _selective_scan_kernel

KERNELS = {"delegation_pack": _pack_kernel, "gather": _gather_kernel,
           "scatter_last": _scatter_last_kernel,
           "segmented_add": _segmented_add_kernel,
           "pagetable_serve": _pagetable_serve_kernel,
           "paged_attention": _paged_attention_kernel,
           "flash_attention": _flash_attention_kernel,
           "grouped_matmul": _grouped_matmul_kernel,
           "selective_scan": _selective_scan_kernel}
CHECKS = {"gather": check_gather, "scatter_last": check_scatter_last,
          "segmented_add": check_segmented_add}


def _pick(impl: str, kernel, plain):
    if impl == "kernel":
        return kernel
    if impl == "ref":
        return plain
    raise ValueError(f"unknown impl {impl!r} (want 'ref' or 'kernel')")


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _gather_kernel.lane_launches = [0, 0, 0, 0]


def check(name: str, *args, **kwargs) -> None:
    """Raise now whatever the serve op ``name`` would raise before its
    launch, given the arguments of its call."""
    CHECKS[name](*args, **kwargs)


def delegation_pack(dst, words, n_trustees: int, capacity: int,
                    capacity2: int = 0, impl: str = "kernel"):
    """Stacked pack of int32 payload words; see ``ref.pack_stacked``."""
    return _pick(impl, _pack_kernel, ref.pack_stacked)(
        dst, words, n_trustees, capacity, capacity2)


def gather(table, keys, lane, which: int, out,
           expect: Optional[torch.Tensor] = None,
           flag: Optional[torch.Tensor] = None, impl: str = "kernel"):
    return _pick(impl, _gather_kernel, ref.gather)(
        table, keys, lane, which, out, expect, flag)


def scatter_last(table, keys, order, seg_end, flag, value,
                 impl: str = "kernel"):
    return _pick(impl, _scatter_last_kernel, ref.scatter_last)(
        table, keys, order, seg_end, flag, value)


def segmented_add(table, keys, lane, order, sid, seg_end, value, resp,
                  impl: str = "kernel"):
    return _pick(impl, _segmented_add_kernel, ref.segmented_add)(
        table, keys, lane, order, sid, seg_end, value, resp)


def pagetable_serve(op: int, state, seq, arg, valid, n_trustees: int,
                    page_size: int, impl: str = "kernel"):
    """One page-table op pass over every trustee; ``state`` is the stacked
    state dict, updated in place.  See ``ref.pagetable_serve``."""
    return _pick(impl, _pagetable_serve_kernel, ref.pagetable_serve)(
        op, state["used"], state["chains"], state["chain_len"],
        state["last_used"], state["clock"], state["evictions"], seq, arg,
        valid, n_trustees, page_size)


def paged_attention(q, k_pages, v_pages, page_table, lengths,
                    scale: Optional[float] = None, impl: str = "kernel"):
    """Paged decode attention; see ``ref.paged_attention``."""
    return _pick(impl, _paged_attention_kernel, ref.paged_attention)(
        q, k_pages, v_pages, page_table, lengths, scale)


def flash_attention(q, k, v, q_offset: Optional[int] = None,
                    causal: bool = True, scale: Optional[float] = None,
                    impl: str = "kernel"):
    """Causal (or full) GQA attention forward; see ``ref.flash_attention``
    (``q_offset`` None means 0)."""
    off = 0 if q_offset is None else int(q_offset)
    return _pick(impl, _flash_attention_kernel, ref.flash_attention)(
        q, k, v, q_offset=off, causal=causal, scale=scale)


def grouped_matmul(x, w, counts=None, impl: str = "kernel"):
    """(E, C, D) @ (E, D, F) -> (E, C, F), one matmul per expert, f32
    sums; ``counts`` (E,) int32 the filled rows of each expert, or None
    for every row; see ``ref.grouped_matmul``."""
    return _pick(impl, _grouped_matmul_kernel, ref.grouped_matmul)(
        x, w, counts)


def selective_scan(x, dt, a, b, c, d, h0=None, impl: str = "kernel"):
    """The Mamba-1 recurrence over (B, S, DI) from ``h0`` (zeros when
    None) -> (y in x's dtype, h_final f32); see ``ref.selective_scan``
    (JAX's "ref" is the associative form of the same function)."""
    return _pick(impl, _selective_scan_kernel, ref.selective_scan)(
        x, dt, a, b, c, d, h0)
