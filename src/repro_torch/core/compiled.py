"""Captured programs — the counterpart of ``jax.jit`` for one function.

JAX runs every model step and every channel round as a compiled program
(``repro.launch.steps`` jits ``train_step``, ``prefill_step`` and
``serve_step``, ``repro.core.engine`` keeps a compiled-program cache, the
paged-decode example jits its attention step).  The port's call sites:
``launch.steps.CompiledStep`` / ``CompiledCell`` (train and prefill),
the engine's ``_cache`` and ``launch.paged_decode``'s ``write_kv``.  On
the card the counterpart is a CUDA graph: the
launches of one call captured once and replayed as one launch, the same
kernels on the same addresses.  A ``Program`` is one call site of one key:

    prog = Program(fn, "serve_step")
    state, out = prog(state, fixed, inputs)

``fn(state, fixed, inputs) -> (new_state, out)``:

  * ``state`` — tensors the call writes (a KV table, a decode cache), held
    at fixed addresses: a ``new_state`` leaf that is not its ``state``
    leaf is copied back into it, inside the graph, so a replay leaves
    every state leaf where it was;
  * ``fixed`` — tensors the call only reads (the weights), held at fixed
    addresses;
  * ``inputs`` — the fresh tensors of each call (tokens, positions,
    request rows), copied into the program's static buffers;
  * ``out`` — any tree; each tensor leaf is handed back as a FRESH tensor
    every call (a later replay never overwrites what an earlier call
    returned), every other leaf as the first call made it.

The caller keys programs: a key holds the inputs' shapes and dtypes
(``signature``) and the addresses of the held tensors (``addresses``),
so a program is never replayed on tensors other than the ones it
captured.

On the card, the first call of a program runs ``fn`` eagerly on a side
stream (the warm-up: its effect is that call's result), then captures
the same call with ``torch.cuda.CUDAGraph`` on that stream — capture
executes nothing, so nothing is applied twice.  Later calls copy the
inputs into the static buffers and replay.  A capture that fails (a host
read, a synchronize, a copy from pageable memory inside the call)
raises ``CaptureError`` naming the call site and CUDA's error; the
program then refuses every later call.  Nothing falls back to eager.

On meta tensors (a dry run) the function runs as it is.  On CPU tensors
a stand-in goes through the same plumbing: every call copies the inputs
into the static buffers, runs ``fn`` on them (the plain versions, as
every CPU path does), copies the outputs into static outputs and hands
back fresh copies, so the CPU tests exercise the aliasing and the
address logic.  ``capturing()`` is true while the
stand-in runs ``fn``, as it is during a capture on the card, so a host
read guarded by ``forbid_host_read`` raises on both.

``disable()`` (``jax.disable_jit()``'s counterpart) runs every call
eagerly and caches nothing; it is the only way to the eager path.

The kernels' launch counters (``kernels.ops.launch_counts``) move only
where a Python wrapper runs: a program records the counters' change over
its capture, takes it back (nothing launched) and adds it on every
replay, so the counts read the same eager or captured; so do the reports
of the side channels (``side_channel``: the channel's transposes and
implementation events).  Each program keeps a private memory pool for
the intermediates of its graph (``pool_bytes``), freed with it.
``captures()`` lists every capture made (site, capture ms, pool bytes);
each program keeps its own, with ``replays``; ``release()`` drops a
program and its pool at once (a caller that rebinds the held state
keys a new program and releases the old).
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

_local = threading.local()
_captures: List[Dict[str, Any]] = []
_side_streams: Dict[int, Any] = {}
# the sink lists of the side channels that code inside a captured call
# reports to (``side_channel``)
_side_channels: List[List[list]] = []
# true: each capture keeps CUDA's graph (``CUDAGraph.enable_debug_mode``),
# so ``program.graph.debug_dump(path)`` writes its nodes as a DOT file
DEBUG_GRAPHS = False


class CaptureError(RuntimeError):
    """A call could not be captured as a CUDA graph (or hit a host read
    inside a captured call)."""


def _depth(name: str) -> int:
    return getattr(_local, name, 0)


@contextlib.contextmanager
def disable():
    """Run every captured call site eagerly while the body runs, caching
    nothing (``jax.disable_jit()``)."""
    _local.disabled = _depth("disabled") + 1
    try:
        yield
    finally:
        _local.disabled -= 1


def enabled() -> bool:
    """False inside ``disable()``."""
    return _depth("disabled") == 0


def capturing() -> bool:
    """True while a program captures its call (or the CPU stand-in runs
    it)."""
    return _depth("capturing") > 0


def forbid_host_read(what: str) -> None:
    """Raise when ``what`` — code that reads device values on the host —
    runs inside a captured call: a replay would not run it."""
    if capturing():
        raise CaptureError(
            f"{what} reads device values on the host inside a captured "
            f"call; run it under repro_torch.core.compiled.disable()")


@contextlib.contextmanager
def _capturing():
    _local.capturing = _depth("capturing") + 1
    try:
        yield
    finally:
        _local.capturing -= 1


def side_channel(sinks: List[list]) -> List[list]:
    """Register ``sinks``, a module's list of sink lists that its code
    appends reports to (every sink gets each report, as
    ``channel.collect_transposes`` does), and return it.  A capture
    records the reports its call makes (they reach no sink: the capture
    runs nothing), and every replay appends them to the sinks present
    then, so a caller counts the same reports eager or captured."""
    _side_channels.append(sinks)
    return sinks


def captures() -> List[Dict[str, Any]]:
    """Every capture made so far: ``site``, ``capture_ms``,
    ``pool_bytes`` (the stand-in's first calls with 0 and 0)."""
    return list(_captures)


def reset_captures() -> None:
    _captures.clear()


# ---------------------------------------------------------------------------
# trees: dicts (insertion order), lists and tuples
# ---------------------------------------------------------------------------

def _walk(t, leaves: list):
    if isinstance(t, dict):
        return ("d", tuple((k, _walk(v, leaves)) for k, v in t.items()))
    if isinstance(t, (list, tuple)) and not hasattr(t, "_fields"):
        return ("l" if isinstance(t, list) else "t",
                tuple(_walk(v, leaves) for v in t))
    leaves.append(t)
    return None


def flatten(tree) -> Tuple[list, Any]:
    """(leaves, spec) of a tree of dicts, lists and tuples.  (Module-level
    recursion: a nested recursive function is a reference cycle, which
    would keep the leaves — a model's weights — alive until a garbage
    collection.)"""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _build(s, it):
    if s is None:
        return next(it)
    kind, kids = s
    if kind == "d":
        return {k: _build(v, it) for k, v in kids}
    out = [_build(v, it) for v in kids]
    return out if kind == "l" else tuple(out)


def unflatten(spec, leaves):
    return _build(spec, iter(leaves))


def signature(tree) -> Tuple:
    """The shapes and dtypes of a tree's tensor leaves (a key part)."""
    leaves, spec = flatten(tree)
    return (spec, tuple((tuple(x.shape), str(x.dtype), x.device.type)
                        if isinstance(x, torch.Tensor) else ("const", x)
                        for x in leaves))


def addresses(tree) -> Tuple[int, ...]:
    """The data addresses of a tree's tensor leaves (a key part)."""
    leaves, _ = flatten(tree)
    return tuple(x.data_ptr() for x in leaves if isinstance(x, torch.Tensor))


def _copy(x):
    """A fresh copy of ``x`` (a tensor) or ``x`` itself (anything else)."""
    if not isinstance(x, torch.Tensor):
        return x
    return torch.empty_like(x, memory_format=torch.contiguous_format) \
        .copy_(x)


def _device_of(*trees) -> Optional[torch.device]:
    for tree in trees:
        for x in flatten(tree)[0]:
            if isinstance(x, torch.Tensor):
                return x.device
    return None


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

def _counters():
    from ..kernels import ops as kops
    return kops.KERNELS, kops.KERNELS["gather"]


def _read_counters() -> Tuple[Dict[str, int], List[int]]:
    kernels, gather = _counters()
    return ({n: fn.launches for n, fn in kernels.items()},
            list(gather.lane_launches))


def _set_counters(counts: Dict[str, int], lanes: List[int]) -> None:
    kernels, gather = _counters()
    for n, v in counts.items():
        kernels[n].launches = v
    gather.lane_launches = list(lanes)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def _side_stream(dev: torch.device):
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    s = _side_streams.get(idx)
    if s is None:
        s = _side_streams[idx] = torch.cuda.Stream(device=idx)
    return s


class Program:
    """One captured call site of one key (see the module docstring).
    ``site`` names it in errors and in ``captures()``; ``capture_ms``,
    ``pool_bytes`` (device bytes the capture reserved for its private
    pool; 0 for the stand-in) and ``replays`` are its readings, and
    ``deltas`` the launch counts of one call."""

    def __init__(self, fn: Callable, site: str):
        self.fn, self.site = fn, site
        self.graph = None
        self.error: Optional[CaptureError] = None
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.replays = 0
        self.deltas: Optional[Tuple[Dict[str, int], List[int]]] = None
        self.reports: List[list] = [[] for _ in _side_channels]
        self._in: Optional[list] = None
        self._out = None              # (spec, leaves) of the static outputs
        self._cuda = None

    def release(self) -> None:
        """Drop the graph, its static buffers and its private pool (the
        pool's blocks go back to the allocator's cache, which
        ``torch.cuda.empty_cache()`` returns to the card).  The program
        then refuses every call."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self._in = self._out = None
        self.error = CaptureError(f"{self.site}: the program was released")

    # -- plumbing shared by the card and the stand-in -----------------------
    def _load_inputs(self, inputs) -> Any:
        leaves, spec = flatten(inputs)
        if self._in is None:
            self._in = [_copy(x) for x in leaves]
            self._in_spec = spec
        else:
            if spec != self._in_spec or len(leaves) != len(self._in):
                raise ValueError(f"{self.site}: the inputs' structure "
                                 f"changed under one key")
            for buf, x in zip(self._in, leaves):
                if isinstance(buf, torch.Tensor):
                    if buf.shape != x.shape or buf.dtype != x.dtype:
                        raise ValueError(
                            f"{self.site}: input {tuple(x.shape)} "
                            f"{x.dtype} does not match the program's "
                            f"{tuple(buf.shape)} {buf.dtype}")
                    if buf.data_ptr() != x.data_ptr():
                        buf.copy_(x)
        return unflatten(self._in_spec, self._in)

    @staticmethod
    def _commit(state, new_state) -> None:
        """Copy each ``new_state`` leaf that is not its ``state`` leaf
        into it."""
        held, spec = flatten(state)
        new, spec2 = flatten(new_state)
        if spec != spec2 or len(held) != len(new):
            raise ValueError("a captured call must return its state in the "
                             "structure it was given")
        for h, n in zip(held, new):
            if not isinstance(h, torch.Tensor):
                continue
            if n is h or (n.data_ptr() == h.data_ptr()
                          and n.shape == h.shape
                          and n.stride() == h.stride()):
                continue
            if n.shape != h.shape or n.dtype != h.dtype:
                raise ValueError(
                    f"a captured call's new state leaf {tuple(n.shape)} "
                    f"{n.dtype} cannot replace {tuple(h.shape)} {h.dtype} "
                    f"in place")
            h.copy_(n)

    def _fresh(self):
        """The outputs as fresh tensors (the static ones copied)."""
        spec, leaves = self._out
        return unflatten(spec, [_copy(x) for x in leaves])

    # -- the call ------------------------------------------------------------
    def __call__(self, state, fixed, inputs):
        if self.error is not None:
            raise self.error
        dev = _device_of(state, fixed, inputs)
        if dev is not None and dev.type == "meta":
            # a dry run: nothing runs and nothing is copied
            return self.fn(state, fixed, inputs)
        cuda = dev is not None and dev.type == "cuda"
        if self._cuda is None:
            self._cuda = cuda
        elif self._cuda != cuda:
            raise ValueError(f"{self.site}: a program runs on one device")
        if not cuda:
            return self._stand_in(state, fixed, inputs)
        if self.graph is None:
            return self._first_call(state, fixed, inputs, dev)
        self._load_inputs(inputs)
        self.graph.replay()
        self.replays += 1
        for sinks, rec in zip(_side_channels, self.reports):
            for sink in sinks:
                sink.extend(rec)
        counts, lanes = _read_counters()
        d_counts, d_lanes = self.deltas
        _set_counters({n: v + d_counts.get(n, 0) for n, v in counts.items()},
                      [a + b for a, b in zip(lanes, d_lanes)])
        return state, self._fresh()

    def _stand_in(self, state, fixed, inputs):
        """The CPU path: the same static buffers and copies, ``fn`` run on
        them every call."""
        assert not any(isinstance(x, torch.Tensor) and x.is_cuda
                       for tree in (state, fixed, inputs)
                       for x in flatten(tree)[0]), \
            "a CUDA tensor never takes the CPU stand-in"
        buffers = self._load_inputs(inputs)
        with _capturing():
            new_state, out = self.fn(state, fixed, buffers)
        self._commit(state, new_state)
        leaves, spec = flatten(out)
        if self._out is None:
            self._out = (spec, [_copy(x) for x in leaves])
            self.deltas = ({}, [0, 0, 0, 0])
            _captures.append({"site": self.site, "capture_ms": 0.0,
                              "pool_bytes": 0})
        else:
            for buf, x in zip(self._out[1], leaves):
                if isinstance(buf, torch.Tensor):
                    buf.copy_(x)
        self.replays += 1
        return state, self._fresh()

    def _first_call(self, state, fixed, inputs, dev):
        """Run eagerly on the side stream (the warm-up), then capture."""
        main = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        buffers = self._load_inputs(inputs)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            new_state, out = self.fn(state, fixed, buffers)
            self._commit(state, new_state)
        main.wait_stream(side)
        leaves, spec = flatten(out)
        for x in leaves:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(main)
        eager = unflatten(spec, [_copy(x) for x in leaves])
        self._capture(state, fixed, buffers, dev, side)
        return state, eager

    def _capture(self, state, fixed, buffers, dev, side) -> None:
        counts0, lanes0 = _read_counters()
        if DEBUG_GRAPHS:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            graph.enable_debug_mode()
        else:
            graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph empties the allocator's cache on entry: empty it
        # first, so the reserved bytes' change is the capture's pool
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        # a collection during the capture could destroy another program's
        # graph, whose release the capture mode refuses: none runs here
        gc_on = gc.isenabled()
        gc.disable()
        # the side channels' reports go to recorders, not to the sinks
        outer = [list(sinks) for sinks in _side_channels]
        recs: List[list] = [[] for _ in _side_channels]
        for sinks, rec in zip(_side_channels, recs):
            sinks[:] = [rec]
        try:
            with _capturing():
                # torch.cuda.graph's "global" mode: during the capture, any
                # CUDA call of this process that could synchronize fails
                with torch.cuda.graph(graph, stream=side):
                    new_state, out = self.fn(state, fixed, buffers)
                    self._commit(state, new_state)
        except Exception as e:            # noqa: BLE001 — re-raised below
            self.error = CaptureError(
                f"capture of {self.site} failed (the call ran eagerly once "
                f"before the capture, and its effect stands): "
                f"{type(e).__name__}: {e}")
            raise self.error from e
        finally:
            for sinks, old in zip(_side_channels, outer):
                sinks[:] = old
            if gc_on:
                gc.enable()
            counts1, lanes1 = _read_counters()
            _set_counters(counts0, lanes0)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0
        self.deltas = ({n: counts1[n] - counts0[n] for n in counts0},
                       [b - a for a, b in zip(lanes0, lanes1)])
        self.reports = recs
        leaves, spec = flatten(out)
        self._out = (spec, leaves)
        self.graph = graph
        _captures.append({"site": self.site,
                          "capture_ms": self.capture_ms,
                          "pool_bytes": self.pool_bytes})
