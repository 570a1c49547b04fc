"""Continuous-batching GQA decode over the delegated page table — the
port's paged-decode entry point (the counterpart of
``examples/paged_decode.py::run_decode``, parametrised by configuration,
pool geometry and dtype).

A ``PagedDecodeDriver`` runs a stream of requests through the Trust-owned
page table — every wave ONE engine round (free + alloc + append + lookup)
— and the two model callbacks do one attention layer's math against a
real paged KV pool:

  on_prefill  writes the prompt's KV into the pages the alloc returned,
              replaying positions one by one (as the JAX example does)
  on_decode   runs one ``paged_decode_attention`` step per sequence over
              the block-sparse page list the same round served

Both callbacks go through one function, ``write_kv`` (gather the new
tokens' embeddings from the stream, write their K/V rows into the pool,
attend), which JAX's example jits and retraces for each shape: here it
is a captured program (``core.compiled``: a CUDA graph on the card, the
stand-in on the CPU) keyed by the shapes of its inputs (the sequence
slots, the positions and the chains), so a run makes at most
``max_seqs`` of them.  The pool is its state, written in place; the
attention weights and the embedding stream are fixed; the output comes
back fresh each call.  ``compiled.disable()`` runs it eagerly.  The run
releases its programs when it ends; ``stats["programs"]`` has their
count, total capture ms and total pool bytes.

It runs on ``cuda`` unless given ``device="cpu"`` (and raises without a
card rather than fall back).  With ``check=True`` it also holds every
wave's page-table responses against a replay of the same op batches
through ``SequentialPageTable`` in serve order, and every attention call's
kernel output against the plain ``paged_attention`` on the same pool and
chains.

    PYTHONPATH=src python -m repro_torch.launch.paged_decode [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import DelegatedPageTable, StackedMesh, compiled
from ..core.meshctx import resolve_device, to_device_async, use_session
from ..models import attention as att
from ..testing.attention import AttentionCheck
from ..testing.pagetable import record_submissions, replay_waves
from .paged_serve import DecodeRequest, PagedDecodeDriver
from .streaming import AdmissionControl


def demo_config() -> ModelConfig:
    """The JAX example's toy attention layer (``make_cfg``)."""
    return ModelConfig(name="paged-demo", family="dense", n_layers=1,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab_size=256)


def make_requests(rng: np.random.Generator, n: int,
                  prompt: Tuple[int, int], gen: Tuple[int, int],
                  n_users: int = 4) -> List[DecodeRequest]:
    """``n`` requests, ``prompt_len`` uniform in [prompt[0], prompt[1]) and
    ``gen_len`` in [gen[0], gen[1]), users ``u{i % n_users}``."""
    return [DecodeRequest(rid=i, prompt_len=int(rng.integers(*prompt)),
                          gen_len=int(rng.integers(*gen)),
                          user=f"u{i % n_users}")
            for i in range(n)]


def _write_kv_body(cfg, pool, fixed, inputs):
    """One attention step as a captured program's function: (pool, y)."""
    params, xs = fixed
    s, p, tbl = inputs
    y, pool = att.paged_decode_attention(params, xs[s.long(), p.long()], p,
                                         pool, tbl, cfg)
    return pool, y


class _RecordingDriver(PagedDecodeDriver):
    """Cuts the submission log into waves at every dispatch."""

    def __init__(self, pagetable, log, **kw):
        super().__init__(pagetable, **kw)
        self._log = log
        self.waves: List[List] = []

    def dispatch(self, *args, **kw):
        self.waves.append(list(self._log))
        self._log.clear()
        return super().dispatch(*args, **kw)


def run_decode(cfg: Optional[ModelConfig] = None,
               requests: Optional[Sequence[DecodeRequest]] = None,
               n_requests: int = 24, n_pages: int = 64, max_seqs: int = 16,
               page_size: int = 4, max_pages: int = 8,
               capacity: int = 128, mesh_shape: Tuple[int, int] = (1, 8),
               depth: int = 2, admission: Tuple[int, int] = (512, 256),
               dtype=torch.float32, device=None, seed: int = 0,
               params: Optional[Dict] = None, xs=None, check: bool = False,
               record: bool = False) -> Dict[str, Any]:
    """Run a stream of decode requests end to end (the page table with the
    local shortcut, as in the JAX example); returns the driver's
    ``serve_stats()`` plus wall time, rates, the audit, the KV writes and
    the host time spent issuing the model callbacks.

    Defaults are the JAX example's (``examples/paged_decode.py``).
    ``xs`` is the token-embedding stream, (max_seqs, max_pages*page_size,
    d_model), one row per (seq slot, position), so a replay re-derives
    identical KV (numpy, or a tensor made on the card).  Without ``xs`` and
    ``requests`` both are drawn the JAX example's way from
    ``numpy.random.default_rng(seed)``, the stream first.  ``params`` are
    attention weights in the JAX layout (random from ``seed`` when None).
    ``check`` adds the oracle replay and the kernel-vs-plain attention
    check (``stats["check"]``) and every wave's page-table responses
    (``stats["pt_responses"]``); ``record`` keeps every decode call's
    output (``stats["ys"]``), the final page-table state
    (``stats["dump"]``) and the final KV pool (``stats["pool"]``, its
    tensors in their dtype), on the host."""
    cfg = cfg or demo_config()
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    max_total = max_pages * page_size
    if xs is None:
        xs = rng.normal(size=(max_seqs, max_total, cfg.d_model))
    xs = torch.as_tensor(xs).to(dev, dtype)
    if requests is None:
        requests = make_requests(rng, n_requests, (2, max_total // 2),
                                 (4, max_total // 2))
    if params is None:
        params = att.init_attention(cfg, dtype, dev, seed=seed)
    pool = att.init_paged_kv_pool(cfg, n_pages, page_size, dtype, dev)
    # host seconds spent issuing the model callbacks (no sync inside them)
    spans = {"prefill_s": 0.0, "decode_s": 0.0, "prefill_calls": 0,
             "decode_calls": 0}
    acc = {"kv_writes": 0, "ysum": torch.zeros((), device=dev), "ys": []}
    # JAX's jitted step: one program a shape of the inputs
    programs: Dict[Any, compiled.Program] = {}
    body = functools.partial(_write_kv_body, cfg)

    def write_kv(seqs, positions, chains):
        inputs = tuple(to_device_async(a, dev)
                       for a in (seqs, positions, chains))
        acc["kv_writes"] += len(seqs)
        if not compiled.enabled():
            return body(pool, (params, xs), inputs)[1]
        key = compiled.signature(inputs)
        prog = programs.get(key)
        if prog is None:
            prog = programs[key] = compiled.Program(body, "paged_write_kv")
        return prog(pool, (params, xs), inputs)[1]

    def on_prefill(seqs, lengths, chains):
        t0 = time.perf_counter()
        # ragged prompt lengths: step position by position
        for t in range(int(np.max(lengths))):
            live = lengths > t
            if not live.any():
                break
            write_kv(seqs[live], np.full(int(live.sum()), t, np.int32),
                     chains[live])
            spans["prefill_calls"] += 1
        spans["prefill_s"] += time.perf_counter() - t0

    def on_decode(seqs, positions, chains):
        t0 = time.perf_counter()
        y = write_kv(seqs, positions, chains)
        acc["ysum"] += y.float().sum()
        if record:
            acc["ys"].append(y)
        spans["decode_calls"] += 1
        spans["decode_s"] += time.perf_counter() - t0

    mesh = StackedMesh(mesh_shape, device=dev)
    attention_check = AttentionCheck(dtype, dev) if check else None
    with use_session(), attention_check or contextlib.nullcontext():
        pt = DelegatedPageTable(mesh, n_pages, max_seqs=max_seqs,
                                page_size=page_size, max_pages=max_pages,
                                capacity=capacity)
        kw = dict(depth=depth,
                  admission=AdmissionControl(admission[0],
                                             per_user_rows=admission[1]),
                  on_prefill=on_prefill, on_decode=on_decode,
                  max_active=max_seqs)
        log: List = []
        if check:
            record_submissions(pt, log)
            drv = _RecordingDriver(pt, log, **kw)
        else:
            drv = PagedDecodeDriver(pt, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        stats = drv.run([DecodeRequest(r.rid, r.prompt_len, r.gen_len,
                                       user=r.user) for r in requests])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        stats["wall_s"] = wall
        stats["tokens_per_s"] = stats["tokens"] / wall if wall else 0.0
        stats["pt_rows_per_s"] = stats["pt_rows"] / wall if wall else 0.0
        stats["kv_writes"] = acc["kv_writes"]
        stats["host"] = spans
        stats["y_checksum"] = float(acc["ysum"])
        stats["audit"] = pt.audit()
        stats["device"] = str(dev)
        stats["programs"] = {
            "count": len(programs),
            "capture_ms": sum(p.capture_ms for p in programs.values()),
            "pool_bytes": sum(p.pool_bytes for p in programs.values())}
        if record:
            stats["ys"] = [y.float().cpu().numpy() for y in acc["ys"]]
            stats["pool"] = {k: v.cpu() for k, v in pool.items()}
            stats["dump"] = pt.dump()
        if check:
            stats["pt_responses"] = [
                [(op, pt.globalize(fut.result(), seqs))
                 for op, seqs, _, fut in wave] for wave in drv.waves]
            stats["check"] = {
                "waves": len(drv.waves),
                "rows_replayed": replay_waves(pt, drv.waves),
                **attention_check.summary()}
    for prog in programs.values():
        prog.release()
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    stats = run_decode(device=args.device, check=args.check)
    stats.pop("ys", None)
    print(json.dumps(stats, default=str))
    a = stats["audit"]
    ok = (a["consistent"] and a["leaked"] == 0 and a["allocated"] == 0
          and stats["failed"] == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
