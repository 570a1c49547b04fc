"""Roofline terms of one NVIDIA H100 SXM, for dry-run cells and kernels.

The torch counterpart of ``repro.launch.rooflines``.  Three terms per
(arch x shape x mesh) cell, in seconds:

    compute    = counted FLOPs / PEAK_FLOPS
    memory     = counted bytes / HBM_BW
    collective = the channel's block-transpose bytes / TRANSPOSE_BW

The counts come from ``launch.dryrun``: the step run on the meta device
under a counting dispatch mode (FLOPs by ``torch.utils.flop_counter``'s
formulas, the bytes each aten op reads and writes, and each kernel's work
from its wrapper's meta branch, by the functions below).  The port stacks
every shard of the JAX mesh on one card, so its all_to_alls are block
transposes of stacked tensors (``core/channel.py``'s ``_a2a``): copies
through the card's memory, read once and written once.  There is no link
term.

Each kernel has one function of its shapes (``pack_work``,
``gather_work``, ``scatter_last_work``, ``segmented_add_work``,
``flash_work``, ``gmm_work``, ``scan_work``, ``paged_attention_work``,
``pagetable_work``) returning a ``KernelWork``: the operations, the bytes
the function must move (each input read once, each output written once),
the exponentials, and its bound in ms — the larger of the times those
take at the card's peaks.  Where the work depends on the data (the rows a
pack places, the filled slots of a grouped matmul, a lane's rows), the
caller passes what its data needs; left out, every slot is counted.

Not ported from JAX's module:

  * ``collective_bytes`` parses XLA's optimized HLO text; the dry run
    counts the transposes itself (``core.channel.collect_transpose_bytes``).
  * ``attention_scan_correction`` adds back the kv-block scan body that
    XLA's cost analysis counts once; an eager count sees every op.
  * ``select_serve_blocks`` / ``select_pack_blocks`` choose a Pallas tile
    pair; the port's kernels choose their own grids, and a fixed tile
    pair is refused (``core/trust.py``).

Constants: NVIDIA H100 SXM5 80GB HBM3 data sheet (dense tensor-core bf16,
f32 on the CUDA cores, HBM3 bandwidth, memory) and the Hopper tuning
guide (16 MUFU ex2 results a clock per SM, 132 SMs, 1980 MHz maximum SM
clock).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s (data sheet)
F32_FLOPS = 67e12            # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes / s
HBM_BYTES = 80e9             # the card's memory, bytes (80 GB)
SFU_EXP_PER_CLOCK = 16       # ex2 results a clock per SM (MUFU)
SM_COUNT = 132
SM_CLOCK_MHZ = 1980.0        # maximum SM clock
# the channel's all_to_all on one card is a block transpose: a copy
# through HBM, so its bandwidth is the memory's
TRANSPOSE_BW = HBM_BW


class KernelWork(NamedTuple):
    """One kernel call's work: ``ops`` operations (at ``peak`` a second),
    ``nbytes`` moved, ``exps`` exponentials; ``ms`` the bound, the larger
    of the three times, and ``bound_by`` which one it is ("operations",
    "bytes" or "exponentials")."""
    ops: int
    nbytes: int
    exps: int
    ms: float
    bound_by: str


def _work(ops, nbytes, exps=0, peak=PEAK_FLOPS,
          clock_mhz=SM_CLOCK_MHZ) -> KernelWork:
    times = {"operations": ops / peak * 1e3,
             "bytes": nbytes / HBM_BW * 1e3,
             "exponentials": exps / (SFU_EXP_PER_CLOCK * SM_COUNT
                                     * clock_mhz * 1e6) * 1e3}
    by = max(times, key=times.get)
    return KernelWork(int(ops), int(nbytes), int(exps), times[by], by)


# ---------------------------------------------------------------------------
# per-kernel bounds
# ---------------------------------------------------------------------------

def pack_work(d: int, r: int, w: int, t: int, c: int, c2: int = 0,
              placed: Optional[int] = None) -> KernelWork:
    """``delegation_pack`` of D client shards of R rows of W words to T
    destinations at capacities C, C2: dst in and the words of the rows
    the pack places (``placed``: each destination's first C + C2 rows; an
    inactive or dropped row's words need not be read; None: every slot,
    at most every row), both slot blocks, request_slot and the counts,
    counts2 and totals out — all 32-bit."""
    if placed is None:
        placed = min(d * r, d * t * (c + c2))
    return _work(0, 4 * (d * r + placed * w + d * t * (c + c2) * w
                         + d * r + 3 * d * t))


def gather_work(t: int, n: int, w: int, rows: Optional[int] = None,
                cas: bool = False) -> KernelWork:
    """``gather`` over T x N rows of a W-word table: every row's key and
    lane in, a line in and a row out for each of the lane's ``rows``
    (None: every row); CAS (``cas``) also an expect row in and a flag
    out."""
    rows = t * n if rows is None else rows
    extra = 4 * rows * w + 4 * rows if cas else 0
    return _work(0, 2 * 4 * t * n + 2 * 4 * rows * w + extra)


def scatter_last_work(t: int, n: int, w: int,
                      heads: Optional[int] = None) -> KernelWork:
    """``scatter_last``: every row's order, seg_end and flag in; a value
    row in, a line out and its key for each of the ``heads`` segments
    that commit (None: every row)."""
    heads = t * n if heads is None else heads
    return _work(0, 3 * 4 * t * n + 2 * 4 * heads * w + 4 * heads)


def segmented_add_work(t: int, n: int, w: int, adds: Optional[int] = None,
                       segs: Optional[int] = None) -> KernelWork:
    """``segmented_add``: every row's order, sid, seg_end and lane in; a
    delta in and a response in and out for each of the ``adds`` ADD rows;
    a table line in and out for each of the ``segs`` ADD segments (None:
    every row, each its own segment); f32 adds, one a word of an ADD
    row."""
    adds = t * n if adds is None else adds
    segs = adds if segs is None else segs
    return _work(adds * w, 4 * 4 * t * n + 3 * 4 * adds * w
                 + 2 * 4 * segs * w, peak=F32_FLOPS)


def causal_pairs(sq: int, skv: int, q_offset: int = 0,
                 causal: bool = True) -> int:
    """(query, key) pairs attention keeps: query i sees keys
    [0, q_offset + i] clipped to [0, skv) when causal, all skv keys
    otherwise."""
    if not causal:
        return sq * skv
    lo, hi = q_offset + 1, q_offset + sq          # seen before clipping
    full = max(0, hi - max(lo - 1, skv))          # queries that see all
    top = min(hi, skv)                            # partial: lo .. top
    part = (top * (top + 1) - (lo - 1) * lo) // 2 if top >= lo else 0
    return part + full * skv


def flash_work(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
               q_offset: int = 0, causal: bool = True,
               item: int = 2) -> KernelWork:
    """``flash_attention``: 4 * D operations per (query head, kept query-key
    pair) — QK^T and PV on the tensor cores — and q, k, v read once and out
    written once.  Its exponentials (one a kept pair) are counted but left
    out of the bound: at D >= 64 the products take longer."""
    pairs = b * hq * causal_pairs(sq, skv, q_offset, causal)
    nbytes = 2 * (b * hq * sq * d + b * hkv * skv * d) * item
    w = _work(4 * d * pairs, nbytes)
    return w._replace(exps=pairs)


def gmm_work(e: int, c: int, d: int, f: int, rows: Optional[int] = None,
             experts: Optional[int] = None, item: int = 2,
             peak: float = PEAK_FLOPS) -> KernelWork:
    """``grouped_matmul`` (E, C, D) @ (E, D, F): the filled slots'
    products (``rows``; an empty slot answers zeros and needs no product),
    their rows and the weights of the ``experts`` that have one read
    once, and the whole (E, C, F) output written once, as the contract
    writes it.  None counts every slot and expert, as ``torch.bmm``
    computes it."""
    rows = e * c if rows is None else rows
    experts = e if experts is None else experts
    return _work(2 * rows * d * f,
                 item * (rows * d + experts * d * f + e * c * f), peak=peak)


def scan_work(bsz: int, s: int, di: int, n: int, item: int = 2,
              clock_mhz: float = SM_CLOCK_MHZ) -> KernelWork:
    """``selective_scan`` over (B, S, DI) with N states: one exp(dt * a)
    and 6 f32 flops per (b, t, channel, state) — dt * a, dt x * B, the
    update's multiply-add and C's multiply-add — and 3 per (b, t,
    channel) — dt * x and D * x added; x, dt and y at ``item`` bytes, a,
    b, c, d and h_final f32, each read or written once.  The exponentials
    take the SFU's 16 a clock per SM at ``clock_mhz``."""
    exps = bsz * s * di * n
    flops = 6 * exps + 3 * bsz * s * di
    nbytes = (3 * bsz * s * di * item + 4 * (di * n + 2 * bsz * s * n + di)
              + 4 * bsz * di * n)
    return _work(flops, nbytes, exps, peak=F32_FLOPS, clock_mhz=clock_mhz)


def paged_attention_work(b: int, hq: int, hkv: int, ps: int, d: int,
                         live_pages: int, item: int = 2) -> KernelWork:
    """``paged_attention``: the ``live_pages`` K and V pages of every
    sequence once (each page (Hkv, PS, D)), q in and out written; 4 * D
    operations and an exponential per (query head, live position)."""
    nbytes = 2 * live_pages * hkv * ps * d * item + 2 * b * hq * d * item
    pairs = live_pages * ps * hq
    return _work(4 * d * pairs, nbytes, pairs)


def pagetable_work(op_reads_arg: bool, state_words: int, rows: int,
                   valid: Optional[int], mp: int) -> KernelWork:
    """One ``pagetable_serve`` op pass: the ``state_words`` int32 state
    read once and written once, every row's valid byte, the ``valid``
    rows' seq (and arg, for alloc and append: ``op_reads_arg``) and their
    responses (MP pages, page, n, flag).  None: every row valid."""
    valid = rows if valid is None else valid
    return _work(0, 2 * 4 * state_words + rows
                 + 4 * valid * (1 + bool(op_reads_arg))
                 + 4 * valid * (mp + 3))


def delegation_serve_roofline(n_rows: int, n_keys: int, width: int,
                              dtype_bytes: int = 4) -> Dict[str, float]:
    """Closed-form H100 bound of ONE serve round of the Hopper serve
    (``kernels/delegation_serve``: gather GET, scatter_last PUT, gather
    ADD, segmented_add, gather CAS, scatter_last CAS) on one trustee shard
    of ``n_keys`` lines of ``width`` words, ``n_rows`` rows a round: each
    of the six kernels reads every row's key and lane; each row's payload
    is read once (a CAS row also its expect), each table line a row
    touches is read once and a written one written once (at most
    min(rows, keys) lines), and each row's response (value and flag) is
    written once.  The compute term is the ADD's f32 sums, a word of a
    row each."""
    n, k, w = n_rows, n_keys, width
    row_bytes = w * dtype_bytes
    lines = min(n, k)
    hbm_bytes = (6 * 2 * 4 * n             # key and lane, every kernel
                 + n * row_bytes           # payload rows
                 + n * row_bytes           # CAS expect rows (at most)
                 + 2 * lines * row_bytes   # lines touched: in, out
                 + n * (row_bytes + 4))    # responses: value and flag
    flops = float(n * w)
    compute_s = flops / F32_FLOPS
    memory_s = hbm_bytes / HBM_BW
    return {"n_rows": n, "n_keys": k, "width": w, "flops": flops,
            "hbm_bytes": hbm_bytes, "compute_s": compute_s,
            "memory_s": memory_s,
            "bottleneck": "compute" if compute_s >= memory_s else "memory"}


# ---------------------------------------------------------------------------
# the dry run's tally of the kernels' work (the wrappers' meta branches)
# ---------------------------------------------------------------------------

_TALLIES: List["KernelTally"] = []


class KernelTally:
    """Each kernel's calls and work seen by the meta branches while this
    tally is active (``counting_kernels``)."""

    def __init__(self):
        self.by_kernel: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, work: KernelWork) -> None:
        k = self.by_kernel.setdefault(
            name, {"calls": 0, "ops": 0, "bytes": 0, "exps": 0, "ms": 0.0})
        k["calls"] += 1
        k["ops"] += work.ops
        k["bytes"] += work.nbytes
        k["exps"] += work.exps
        k["ms"] += work.ms

    def total(self, key: str) -> float:
        return sum(v[key] for v in self.by_kernel.values())


@contextlib.contextmanager
def counting_kernels():
    """Collect every kernel wrapper's meta-branch work inside the block."""
    tally = KernelTally()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def record(name: str, work: KernelWork) -> None:
    """A kernel wrapper's meta branch: add one call's work to every
    active tally."""
    for tally in _TALLIES:
        tally.add(name, work)


# ---------------------------------------------------------------------------
# whole-step terms
# ---------------------------------------------------------------------------

@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops_per_chip: float
    useful_ratio: float          # MODEL_FLOPS / counted FLOPs
    bottleneck: str

    def as_dict(self):
        return dict(self.__dict__)


def model_flops(kind: str, n_active: int, tokens: int) -> float:
    """6ND (train: fwd+bwd), 2ND (prefill/decode fwd)."""
    if kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def derive(cost: Dict[str, float], coll: Dict[str, Dict[str, float]],
           n_chips: int, kind: str, n_active: int, tokens: int
           ) -> RooflineTerms:
    """The three terms of a counted step: ``cost`` {"flops", "bytes
    accessed", ...} of the whole step on ``n_chips`` cards (one: the port
    stacks the mesh on one card), ``coll`` {kind: {"count", "bytes"}}
    its transposes' bytes (read and written)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(sum(v["bytes"] for v in coll.values()))
    mf_chip = model_flops(kind, n_active, tokens) / n_chips
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = cbytes / TRANSPOSE_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return RooflineTerms(compute_s, memory_s, collective_s, flops, byts,
                         cbytes, mf_chip,
                         (mf_chip / flops) if flops else 0.0, bottleneck)


def fraction(d) -> float:
    """Roofline fraction: achieved-vs-peak useful compute if the step ran
    exactly at its binding term."""
    r = d["roofline"]
    t = max(r["compute_s"], r["memory_s"], r["collective_s"])
    if t <= 0:
        return 0.0
    return r["model_flops_per_chip"] / PEAK_FLOPS / t


# ---------------------------------------------------------------------------
# report rendering
# ---------------------------------------------------------------------------

def load_cells(art_dir: str, mesh: str = "single", tag: str = ""):
    """Dry-run artifact cells (``launch.dryrun.ARTIFACT_DIR``/*.json) for
    one (mesh, tag) slice, in filename order."""
    import glob as _glob
    import json as _json
    import os as _os
    cells = []
    for p in sorted(_glob.glob(_os.path.join(art_dir, "*.json"))):
        with open(p) as f:
            d = _json.load(f)
        if d.get("mesh") != mesh or d.get("tag", "") != tag:
            continue
        cells.append(d)
    return cells


def render(cells, fmt: str = "md"):
    """Print the roofline table of dry-run cells; returns the rows."""
    rows = []
    for d in cells:
        if d["status"] == "skipped":
            rows.append((d["arch"], d["shape"], "SKIP",
                         d.get("reason", "")[:60], "", "", "", "", ""))
            continue
        if d["status"] == "error":
            rows.append((d["arch"], d["shape"], "ERR",
                         d.get("error", "")[:60], "", "", "", "", ""))
            continue
        r = d["roofline"]
        rows.append((
            d["arch"], d["shape"], r["bottleneck"],
            f"{r['compute_s']*1e3:.1f}", f"{r['memory_s']*1e3:.1f}",
            f"{r['collective_s']*1e3:.1f}", f"{r['useful_ratio']:.2f}",
            f"{fraction(d)*100:.1f}%",
            "yes" if d.get("fits_hbm") else "NO",
        ))
    header = ("arch", "shape", "bottleneck", "compute_ms", "memory_ms",
              "collective_ms", "useful", "roofline_frac", "fits_hbm")
    _print_table(header, rows, fmt)
    return rows


def render_delegation(r_sweep, n_keys: int, width: int, fmt: str = "md"):
    """Print the closed-form serve bound over a row-batch sweep (JAX's
    columns that keep their meaning: no tiles, no VMEM)."""
    rows = []
    for r in r_sweep:
        d = delegation_serve_roofline(r, n_keys, width)
        rows.append((
            f"{r}", f"{n_keys}", f"{width}", f"{d['flops']/1e9:.2f}",
            f"{d['hbm_bytes']/1e6:.2f}", f"{d['compute_s']*1e6:.1f}",
            f"{d['memory_s']*1e6:.1f}", d["bottleneck"],
        ))
    header = ("rows", "keys", "W", "gflops", "MB_moved", "compute_us",
              "memory_us", "bottleneck")
    _print_table(header, rows, fmt)
    return rows


def _print_table(header, rows, fmt):
    if fmt == "csv":
        print(",".join(header))
        for r in rows:
            print(",".join(str(x) for x in r))
        return
    widths = [max(len(str(h)), max((len(str(r[i])) for r in rows),
                                   default=0))
              for i, h in enumerate(header)]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)))
    print("-|-".join("-" * w for w in widths))
    for r in rows:
        print(" | ".join(str(x).ljust(w) for x, w in zip(r, widths)))
