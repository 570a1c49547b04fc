"""Build and load the CUDA kernels: ``nvcc`` -> shared library -> ``ctypes``.

Every source under ``csrc/`` has a plain C interface (no PyTorch headers),
so each compiles in seconds into its own shared library under
``src/repro_torch/build/`` (ignored by git).  The libraries are built at
first use, all sources in parallel (one ``nvcc`` per source, started
together), and cached under a name that hashes the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt.  A failed build raises with ``nvcc``'s output.  Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("delegation_pack.cu", "scatter_last.cu", "segmented_add.cu",
           "gather.cu", "pagetable_serve.cu", "paged_attention.cu",
           "flash_attention.cu", "grouped_matmul.cu", "selective_scan.cu")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built with the CUDA "
            "toolkit's nvcc at first use on a machine with the card")
    return path


def _lib_path(source: str) -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    # the source and every shared header under csrc/ it may include
    for name in [source] + sorted(f for f in os.listdir(CSRC)
                                  if f.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing, in parallel.
    Returns, for each source compiled, the wall seconds until its compile
    was seen to end (they are waited for in order, so a source that ends
    before one listed ahead of it is seen when that one ends); empty when
    all were cached."""
    todo = [s for s in sources if not os.path.exists(_lib_path(s))]
    if not todo:
        return {}
    nvcc = _nvcc()
    os.makedirs(BUILD, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for s in todo:
        out = _lib_path(s)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, s)]
        procs.append((s, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed, seconds = [], {}
    for s, out, tmp, p in procs:
        log, _ = p.communicate()
        seconds[s] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"--- nvcc {s} (exit {p.returncode}) ---\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(source: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use), with
    ``argtypes`` set from ``signatures`` ({function: argtypes}) and every
    function returning the ``cudaError_t`` of its launches as an int."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(_lib_path(source))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[source] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C launcher reported a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize()`` would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad.  A kernel is
    a ``ctypes`` call that writes into tensors torch allocated: its output
    would carry no ``grad_fn``, and the gradient would stop there with no
    error.  No kernel has a backward; a differentiated path calls the
    plain versions (``impl="ref"``), as JAX trains without its Pallas
    kernels."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the CUDA kernel has no "
            f"backward (its output would be cut from the graph); call the "
            f"plain version (impl='ref') or run under torch.no_grad()")
