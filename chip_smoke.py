#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, one card

Phases (any failure raises and exits non-zero; nothing is caught):

  1. device and build — the card's name and power limit, then the nine
     CUDA kernels built from csrc/ with nvcc (in parallel), and the
     registers, spills, shared memory and resident warps of the
     page-table serve and the selective scan as built;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at adversarial ones: for the KV kernels a hot
     segment over many tiles, one ADD segment over every tile of a
     kv_mixed shard, a scatter_last winner tiles before its segment's
     end, N one past and one short of a tile multiple, general floats
     (segmented_add five times, bit for bit run to run), all-distinct
     keys, ragged row
     counts, capacity 1, int32 words above 2^24, a hot destination whose
     FIFO run crosses the pack kernels' 2048-row chunks (rows of 2,049
     words, C and C + C2 inside a chunk and on a chunk's edge), exact on
     integer-exact payloads; paged_attention in bf16, f32 and f16 (length
     1, lengths on and one past page boundaries, -1 pads inside and past
     the length,
     MP*PS == length, Hkv == Hq, B 1 with one chain over every split, a
     chain longer than a split beside short ones, pages read without
     bulk copies) within the tolerance stated in
     kernels/paged_attention.py;
     pagetable_serve bit for bit on a stress trace (eviction cascades,
     infeasible requests, appends that heal an evicted chain, free and
     alloc in one wave), the local shortcut on and off; flash_attention
     (bf16) at the prefill's shape and layout, MQA, MHA, q_offset with
     Sq < Skv, causal=False, D 64 and 32, ragged tails, D 192 at the MLA
     prefill's shape and ragged, and at the edges of the wgmma kernel's
     128-row query and 128- / 64-key KV tiles (Sq < 64, Skv 1, a q_offset
     off the tiles, GQA rep 8, MQA, MHA, (B, S, H, D) views and
     causal=False at D 192), within the
     tolerance stated in kernels/flash_attention.py, a q_offset launch bit
     for bit equal to the rows of the full launch, and f32 refused;
     grouped_matmul (bf16) at the deepseek prefill's and decode's shapes
     (gate / up and down, empty slots answering zeros, per-expert counts
     as the serve spreads them, and counts of 0, a partial 128-row tile,
     exactly a tile and C, the rows past them zero), ragged C / D / F,
     E = 1 and C = 1, within the tolerance stated in
     kernels/grouped_matmul.py over the whole output, and f32 refused; selective_scan at the
     falcon-mamba-7b prefill's shape (B 4 x 2048, DI 8192, N 16) in bf16,
     in f32 and from h0, two launches over the halves (the second from the
     first's h_final) against one, ragged S 333 / DI 200, S 1 with N 4,
     N 8, dt = 0 and a decay that underflows to 0, within the tolerance
     stated in kernels/selective_scan.py, and f16 and N past 64 refused;
  3. kv_paper — the paper's KV store (Fig. 8/9 as benchmarks/kv_store.py
     runs it): 1,000,000 keys x 4 f32, a 2x4 stacked mesh (8 trustees),
     shared mode with the local shortcut, second_round overflow, 8192
     requests a round (5% PUT / 95% GET) through get.then / put.then and
     session.step(), 20 Zipf(1) rounds then 20 uniform rounds;
     (a) auto capacity: the kernel path equals the plain "ref" path bit
     for bit; (b) capacity = rows per client shard: the kernel path equals
     the sequential oracle bit for bit;
  4. kv_mixed — all four ops every round (65,536 rows, GET/PUT/ADD/CAS
     40/20/20/20, Zipf(1), integer-valued payloads), against the oracle,
     with the local shortcut on and off;
  5. paged decode — repro_torch.launch.paged_decode at qwen2.5-3b attention
     width (16 query / 2 KV heads of 128, QKV bias, bf16 weights,
     activations and pool), a 4096-page pool of 16-token pages, 64-page
     chains, 64 sequences over 8 trustees (2x4, shared, shortcut on),
     driver depth 2, 256 requests (prompts 16-255 tokens, 64-511 generated):
     a check run (every request completes, zero leaked pages, every wave's
     page-table responses == the oracle replayed in serve order, every
     page-table pass == the plain version bit for bit, every attention
     call == the plain version), then the timed run;
  6. qwen serve — the qwen2.5-3b model path at full width (36 layers,
     d_model 2048, 16 / 2 heads of 128, d_ff 11008, vocab 151936, bf16;
     3.40 B random parameters drawn on the card): prefill_step at B 4 x
     2048 tokens through the flash kernel (a check run holding each of
     its 36 launches against the plain version, then timed runs), then
     repro_torch.launch.serve (8 requests, 128 prompt tokens teacher-forced
     then 128 generated, the KV cache's sequence split over 4 stacked
     trustees), then the prefill's last-position logits on the serve's
     prompt against the serve's decode logits at that position;
  7. deepseek serve — the deepseek-v2-lite-16b MoE path at full width
     and depth (27 layers: a dense first layer and 26 MoE layers of 64
     routed experts top-6 plus 2 shared, d_ff_expert 1408; MLA rank 512,
     nope / rope / v 128 / 64 / 128; d_model 2048, 16 heads, vocab
     102400, bf16; 15.65 B random parameters drawn on the card, after
     phase 6's weights are freed): prefill_step at B 4 x 2048 tokens with
     the experts over 4 stacked trustees, every MoE layer's tokens
     delegated over the channel (the pack kernel) to the trustees' expert
     FFN (the pack kernel again, then three grouped-matmul launches given
     the pack's per-expert counts) — a check run holding each of its 27
     flash launches (D 192), 78 grouped-matmul launches and 52 packs
     (all six outputs, exactly) against the plain versions (the filled
     128-row tiles counted), then timed runs;
     then repro_torch.launch.serve (8 requests, 64 prompt tokens
     teacher-forced then 64 generated, the latent cache's sequence and the
     experts over 4 trustees); then the prefill's last-position logits on
     the serve's prompt against the serve's decode logits there, the MoE
     dropped fractions of both beside them; then one decode step with
     mla_absorb on against off from the same cache, in bf16 and in f32
     (weights drawn in f32 from the same seed; at full depth where they
     fit, else 4 layers with bf16 at that depth beside it);
  8. falcon serve — the falcon-mamba-7b path at full width and depth (64
     Mamba-1 layers, d_model 4096, d_inner 8192, dt_rank 256, N 16, vocab
     65024, bf16; 7.27 B random parameters drawn on the card, after phase
     7's weights are freed): prefill_step at B 4 x 2048 tokens through the
     selective-scan kernel (a check run holding each of its 64 launches
     against the plain version, then timed runs), then
     repro_torch.launch.serve (8 requests, 128 prompt tokens
     teacher-forced then 128 generated, the Mamba (conv, ssm) state cache,
     whose decode step is the plain recurrence as in JAX), then the
     prefill's last-position logits on the serve's prompt against the
     serve's decode logits at that position, in bf16 and (weights drawn
     in f32 from the same seed, a teacher-forced decode) in f32;
  9. times — each kernel at the main path's shapes: the median of five
     profiler readings of its own kernels (their spread and the records
     the profiler kept beside it) and CUDA events with the host ahead of
     the card, beside its bound (bytes over 3.35 TB/s, or for
     flash_attention and grouped_matmul flops over 989 TFLOP/s where
     that is the larger; for selective_scan the largest of bytes, f32
     flops over 67 TFLOP/s and exponentials over the SFU's 16 a clock per
     SM at the measured clock), its plain version and a library call where one
     PyTorch call computes the same function (flash also at the MLA
     prefill's D 192, grouped_matmul at the prefill's and a decode step's
     shapes, paged_attention with the L2 warm and flushed; the page-table
     serve beside an empty launch of its grid, its latency floor; the
     selective scan beside its inner loop's issue floor from the SASS;
     scatter_last and segmented_add beside the random read through
     order that each makes for every row, alone: torch.gather of the
     flag / lane words).
     Every plain
     and library reading is CUDA events with the host ahead, the
     profiler's reading and the records it kept beside it, and its share
     of its own work's bound (torch.bmm's counts every slot, as it
     multiplies every one); one under its bound is marked as not a time.
     Then each path's ops/s or tokens/s on a host clock; the device's
     busy share and top device ops (the deepseek and falcon prefills' are
     taken at the end of phases 7 and 8, while their weights are on the
     card).

Launch counters are zeroed just before each main path (phases 3, 4, the
timed run of 5, each timed prefill of 6, 7 and 8, and the serves of 7
and 8) and read just after; every kernel of a path must have launched
there. The line
before the last is {"kernels": [...]}; the last is the device line.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12             # H100 SXM bf16 dense tensor-core peak
N_KEYS, VW, MESH = 1_000_000, 4, (2, 4)
SOURCES = {
    "delegation_pack": ("src/repro_torch/csrc/delegation_pack.cu",
                        "src/repro/kernels/delegation_pack.py:38"),
    "gather": ("src/repro_torch/csrc/gather.cu",
               "src/repro/kernels/delegation_serve.py:133"),
    "scatter_last": ("src/repro_torch/csrc/scatter_last.cu",
                     "src/repro/kernels/delegation_serve.py:83"),
    "segmented_add": ("src/repro_torch/csrc/segmented_add.cu",
                      "src/repro/kernels/delegation_serve.py:116"),
    "pagetable_serve": ("src/repro_torch/csrc/pagetable_serve.cu",
                        "src/repro/core/pagetable.py:250"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:31"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:26"),
    "grouped_matmul": ("src/repro_torch/csrc/grouped_matmul.cu",
                       "src/repro/kernels/grouped_matmul.py:25"),
    "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:25"),
}
KV_KERNELS = ("delegation_pack", "gather", "scatter_last", "segmented_add")
# what each kernel's launches are called in a profiler trace, and the
# launches one call makes where that is more than one
LAUNCHES_PER_CALL = {"delegation_pack": 4}
KERNEL_NAMES = {"delegation_pack": "delegation_pack_",
                "gather": "gather_kernel",
                "scatter_last": "scatter_last_kernel",
                "segmented_add": "segmented_add_kernel",
                "pagetable_serve": "pagetable_serve_kernel",
                "paged_attention": "paged_attention_",
                "flash_attention": "flash_attention_",
                "grouped_matmul": "grouped_matmul_kernel",
                "selective_scan": "selective_scan_kernel"}
PAGED_KERNELS = ("delegation_pack", "pagetable_serve", "paged_attention")
# the paged-decode main path: one qwen2.5-3b attention layer (16 query / 2
# KV heads of 128, QKV bias, rope 1e6) in bf16 over a 4096-page pool of
# 16-token pages, 8 trustees, the driver and admission of
# benchmarks/paged_decode.py
PAGED = dict(n_pages=4096, page_size=16, max_pages=64, max_seqs=64,
             capacity=4 * 64, mesh_shape=MESH, depth=2,
             admission=(16 * 64, 8 * 64))
N_REQUESTS, PROMPT, GEN = 256, (16, 256), (64, 512)


def say(*parts):
    print(*parts, flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2 inputs
# ---------------------------------------------------------------------------

def pack_case(torch, dev, d, r, t, c, c2, w, seed, hot=0.0, big_words=False,
              inactive=0.1):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, t, (d, r))
    if hot:
        dst = np.where(rng.random((d, r)) < hot, 0, dst)
    dst = np.where(rng.random((d, r)) < inactive, -1, dst).astype(np.int32)
    if big_words:
        words = rng.integers(-2 ** 31, 2 ** 31 - 1, (d, r, w), dtype=np.int64)
    else:
        words = rng.integers(0, 8, (d, r, w))
    return (torch.as_tensor(dst, device=dev),
            torch.as_tensor(words.astype(np.int32), device=dev), t, c, c2)


def serve_case(torch, dev, t, n, k, w, mix, seed, hot=0.07, integer=True,
               distinct=False, inactive=0.1):
    """Synthetic received rows of one serve round, grouped as the channel
    groups them: lanes drawn from ``mix``, Zipf-like hot key 0 on a
    ``hot`` share of rows, inactive rows on the sentinel key."""
    from repro_torch.core.channel import make_grouping
    rng = np.random.default_rng(seed)
    lane = rng.choice(4, size=(t, n), p=mix)
    lane = np.where(rng.random((t, n)) < inactive, -1, lane)
    if distinct:
        keys = np.stack([rng.permutation(k)[:n] for _ in range(t)])
    else:
        keys = rng.integers(0, k, (t, n))
        keys = np.where(rng.random((t, n)) < hot, 0, keys)
    keys = np.where(lane >= 0, keys, k)
    if integer:
        table = rng.integers(0, 8, (t, k, w)).astype(np.float32)
        value = rng.integers(0, 8, (t, n, w)).astype(np.float32)
    else:
        table = rng.normal(size=(t, k, w)).astype(np.float32)
        value = rng.normal(size=(t, n, w)).astype(np.float32)
    live = table[np.arange(t)[:, None], np.minimum(keys, k - 1)]
    expect = np.where(rng.random((t, n, 1)) < 0.5, live, value)
    gid = np.where(lane >= 0, lane.astype(np.int64) * k + keys, 4 * k)
    T = lambda a, dt=None: torch.as_tensor(a if dt is None else a.astype(dt),
                                           device=dev)
    g = make_grouping(T(gid, np.int32))
    return dict(table=T(table), keys=T(keys, np.int32), lane=T(lane, np.int32),
                value=T(value), expect=T(expect.astype(np.float32)),
                order=g.order.contiguous(), sid=g.seg_start.contiguous(),
                seg_end=g.seg_end.contiguous())


def run_serve_kernel(torch, name, case, impl, base=None):
    """Run one serve kernel (impl "kernel" or "ref") on copies of the case;
    returns its outputs."""
    from repro_torch.kernels import ops as kops
    table = case["table"].clone()
    t, n = case["keys"].shape
    w = table.shape[-1]
    if name == "gather":
        out = torch.zeros((t, n, w), device=table.device)
        flag = torch.zeros((t, n), dtype=torch.int32, device=table.device)
        kops.gather(table, case["keys"], case["lane"], 3, out,
                    expect=case["expect"], flag=flag, impl=impl)
        kops.gather(table, case["keys"], case["lane"], 0, out, impl=impl)
        return [out, flag]
    if name == "scatter_last":
        flag = case.get("flag")
        if flag is None:
            flag = (case["lane"] == 1).to(torch.int32)
        kops.scatter_last(table, case["keys"], case["order"],
                          case["seg_end"], flag, case["value"], impl=impl)
        return [table]
    resp = base.clone()
    kops.segmented_add(table, case["keys"], case["lane"], case["order"],
                       case["sid"], case["seg_end"], case["value"], resp,
                       impl=impl)
    return [table, resp]


def max_err(got, want):
    err = 0.0
    for a, b in zip(got, want):
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def phase_kernels(torch, dev, shapes):
    """Each kernel against its plain version; returns max abs err per
    kernel over the main-path-shape cases."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.delegation_serve import (SCATTER_TILE_ROWS,
                                                      SEGADD_TILE_ROWS)
    from repro_torch.testing.serve import far_winner_flags
    errs = {k: 0.0 for k in SOURCES}
    p_main, p_mixed = shapes["pack_paper"], shapes["pack_mixed"]
    pack_cases = [
        ("kv_paper shape", dict(**p_main, seed=1, hot=0.07), True),
        ("kv_mixed shape", dict(**p_mixed, seed=2, hot=0.07), True),
        ("ragged R", dict(d=8, r=1037, t=8, c=64, c2=64, w=6, seed=3), False),
        ("capacity 1", dict(d=8, r=512, t=8, c=1, c2=1, w=6, seed=4), False),
        ("one hot destination", dict(d=8, r=4096, t=8, c=300, c2=700, w=3,
                                     seed=5, hot=0.9), False),
        ("int32 words above 2^24", dict(d=8, r=2048, t=8, c=128, c2=128,
                                        w=10, seed=6, big_words=True), False),
        # the count and rank kernels take 2048-row chunks of a shard: a hot
        # destination's FIFO run over 6 chunks of rows of 2,049 words, C
        # and C + C2 inside a chunk, then on a chunk's edge
        ("6 chunks, a hot destination, W 2049",
         dict(d=4, r=12_000, t=4, c=2500, c2=2048, w=2049, seed=7, hot=0.5,
              big_words=True), False),
        ("C and C + C2 on the chunks' edges",
         dict(d=2, r=8192, t=2, c=2048, c2=2048, w=3, seed=8, hot=1.0,
              inactive=0.0), False),
    ]
    for label, kw, main in pack_cases:
        args = pack_case(torch, dev, **kw)
        got = kops.delegation_pack(*args, impl="kernel")
        torch.cuda.synchronize()
        want = kops.delegation_pack(*args, impl="ref")
        for a, b, nm in zip(got, want, ("slots", "slots2", "counts",
                                         "counts2", "request_slot",
                                         "totals")):
            require(torch.equal(a, b), f"delegation_pack [{label}]: {nm} "
                    f"differs from the plain version")
        if main:
            errs["delegation_pack"] = max(errs["delegation_pack"],
                                          max_err(got, want))
        say(f"[kernels] delegation_pack [{label}] == plain (exact)")

    s_paper, s_mixed = shapes["serve_paper"], shapes["serve_mixed"]
    serve_cases = [
        ("kv_paper shape", dict(**s_paper, seed=11), True, True),
        ("kv_mixed shape", dict(**s_mixed, seed=12), True, True),
        ("hot segment over 8 tiles",
         dict(t=8, n=8192, k=4096, w=4, mix=(0.0, 0.0, 1.0, 0.0), seed=13,
              hot=0.98, inactive=0.0), False, True),
        # every tile of a kv_mixed-sized shard looks back to tile 0
        ("one ADD segment over every tile of a kv_mixed shard",
         dict(t=8, n=s_mixed["n"], k=s_mixed["k"], w=4,
              mix=(0.0, 0.0, 1.0, 0.0), seed=18, hot=1.0, inactive=0.0),
         False, True),
        ("N one past a tile multiple",
         dict(t=8, n=3 * SEGADD_TILE_ROWS + 1, k=999, w=4,
              mix=(0.1, 0.3, 0.4, 0.2), seed=19, hot=0.5), False, True),
        ("N one short of a tile multiple",
         dict(t=8, n=3 * SEGADD_TILE_ROWS - 1, k=999, w=4,
              mix=(0.1, 0.3, 0.4, 0.2), seed=20, hot=0.5), False, True),
        ("all-distinct keys", dict(t=8, n=6000, k=8192, w=4,
                                   mix=(0.25, 0.25, 0.25, 0.25), seed=14,
                                   distinct=True), False, True),
        ("ragged N", dict(t=8, n=5037, k=999, w=3,
                          mix=(0.1, 0.3, 0.4, 0.2), seed=15, hot=0.3),
         False, True),
        ("rows of 1100 words", dict(t=2, n=1500, k=64, w=1100,
                                    mix=(0.25, 0.25, 0.25, 0.25), seed=17,
                                    hot=0.5), False, True),
        ("general floats", dict(t=8, n=8192, k=1000, w=4,
                                mix=(0.0, 0.0, 1.0, 0.0), seed=16, hot=0.5,
                                integer=False), False, False),
    ]
    far = serve_case(torch, dev, t=8, n=48 * SCATTER_TILE_ROWS, k=64, w=4,
                     mix=(0.0, 0.0, 0.0, 1.0), seed=22, hot=1.0,
                     inactive=0.0)
    far["flag"] = far_winner_flags(far["order"], SCATTER_TILE_ROWS)
    got = run_serve_kernel(torch, "scatter_last", far, "kernel")
    torch.cuda.synchronize()
    require(torch.equal(got[0], run_serve_kernel(torch, "scatter_last", far,
                                                 "ref")[0]),
            "scatter_last [winner tiles before its segment's end]: differs "
            "from the plain version")
    say("[kernels] scatter_last [winner tiles before its segment's end] == "
        "plain (exact)")
    for label, kw, main, exact in serve_cases:
        case = serve_case(torch, dev, **kw)
        base = torch.as_tensor(
            np.random.default_rng(kw["seed"]).integers(
                0, 8, tuple(case["value"].shape)).astype(np.float32),
            device=dev)
        for name in ("gather", "scatter_last", "segmented_add"):
            got = run_serve_kernel(torch, name, case, "kernel", base)
            torch.cuda.synchronize()
            want = run_serve_kernel(torch, name, case, "ref", base)
            err = max_err(got, want)
            if exact or name != "segmented_add":
                require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"{name} [{label}]: differs from the plain version "
                        f"(max abs err {err})")
                tol = "exact"
            else:
                # f32 sums taken in another order: a segment of ~4000
                # N(0,1) deltas has prefix sums of magnitude ~100, whose
                # rounding differs by a few ulps of 100 per add
                require(err <= 2e-3, f"{name} [{label}]: max abs err {err}")
                # the kernel's order is fixed: four more runs, bit for bit
                for _ in range(4):
                    again = run_serve_kernel(torch, name, case, "kernel",
                                             base)
                    require(all(torch.equal(a, b)
                                for a, b in zip(got, again)),
                            f"{name} [{label}]: differs from run to run")
                tol = (f"max abs err {err:.3g} <= 2e-3; five runs bit for "
                       f"bit")
            if main:
                errs[name] = max(errs[name], err)
            say(f"[kernels] {name} [{label}] == plain ({tol})")
    return errs


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def oracle_round(ref, batches, shortcut, n_dev):
    """Replay one fused round of op batches [(op, keys, vals, expect)] —
    inactive rows carry key -1 — on the sequential oracle in serve order.
    The fused batch concatenates the op batches and gives each client
    shard a contiguous slice (client = fused position // rows per client);
    under the local shortcut each op's self-addressed rows serve after its
    channel rows (tests/_diff_battery.py orders the oracle the same way)."""
    sizes = [len(b[1]) for b in batches]
    r_dev = -(-sum(sizes) // n_dev)
    out, off = [], 0
    for (op, keys, vals, expect), n in zip(batches, sizes):
        perm = np.arange(n)
        if shortcut:
            client = (off + np.arange(n)) // r_dev
            local = (keys >= 0) & ((keys % n_dev) == client)
            perm = np.concatenate([np.where(~local)[0], np.where(local)[0]])
        off += n
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        k = keys[perm]
        if op == "get":
            out.append(ref.get(k)[inv])
        elif op == "put":
            ref.put(k, vals[perm])
            out.append(None)
        elif op == "add":
            out.append(ref.add(k, vals[perm])[inv])
        else:
            fl, old = ref.cas(k, expect[perm], vals[perm])
            out.append((fl[inv], old[inv]))
    return out


def make_store(dev, pack_impl, serve_impl, capacity, init, session, name):
    from repro_torch.core import DelegatedKVStore, StackedMesh
    st = DelegatedKVStore(StackedMesh(MESH, device=dev), N_KEYS, VW,
                          capacity=capacity, pack_impl=pack_impl,
                          serve_impl=serve_impl, session=session, name=name)
    st.prefill(init)
    return st


def check_stats(stats, name):
    require(stats[name]["impl_fallback"] == 0,
            f"{name}: the serve fell back from the kernels")


def paper_trace(rng, rounds=40, r=8192):
    from repro_torch.core.routing import sample_keys
    trace = []
    for i in range(rounds):
        keys = sample_keys(rng, N_KEYS, r, "zipf" if i < rounds // 2
                           else "uniform").astype(np.int32)
        is_put = rng.random(r) < 0.05
        vals = rng.integers(0, 8, (r, VW)).astype(np.float32)
        trace.append((keys, is_put, vals))
    return trace


def run_paper(torch, dev, store, trace, session):
    """kv_paper rounds through the typed handles + session.step().
    Returns (GET responses per round, dropped rows total, seconds)."""
    outs, dropped = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for keys, is_put, vals in trace:
        k = torch.as_tensor(keys, device=dev)
        fut = store.trust.op.get.then(
            k, where=torch.as_tensor(~is_put, device=dev))
        store.trust.op.put.then(k, torch.as_tensor(vals, device=dev),
                                where=torch.as_tensor(is_put, device=dev))
        stats = session.step()
        check_stats(stats, store.trust.name)
        dropped += stats[store.trust.name]["dropped"]
        outs.append(fut.result()["value"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return [o.cpu().numpy() for o in outs], dropped, secs


def phase_paper(torch, dev, report):
    from repro_torch.core import SequentialKVReference, use_session
    rng = np.random.default_rng(2024)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    trace = paper_trace(rng)
    r = len(trace[0][0])
    n_dev = MESH[0] * MESH[1]

    # (a) auto capacity: kernel path == plain path, bit for bit
    runs = {}
    for impl in ("kernel", "ref"):
        with use_session() as sess:
            st = make_store(dev, impl, impl, None, init, sess,
                            f"kv_paper_a_{impl}")
            outs, dropped, secs = run_paper(torch, dev, st, trace, sess)
            runs[impl] = (outs, st.dump(), dropped, secs)
    (ko, kt, kd, ks), (ro, rt, rd, rs) = runs["kernel"], runs["ref"]
    for i, (a, b) in enumerate(zip(ko, ro)):
        require(np.array_equal(a, b), f"kv_paper (a) round {i}: GET "
                f"responses of the kernel and ref paths differ")
    require(np.array_equal(kt, rt), "kv_paper (a): final tables differ")
    require(kd == rd, f"kv_paper (a): dropped rows differ ({kd} vs {rd})")
    say(f"[kv_paper a] auto capacity: kernel path == ref path bit for bit "
        f"({len(trace)} rounds, every GET response and the final table); "
        f"dropped rows kernel {kd}, ref {rd}")
    report["kv_paper_a_kernel_ops_s"] = r * len(trace) / ks
    report["kv_paper_a_ref_ops_s"] = r * len(trace) / rs

    # (b) capacity = rows per client shard: kernel path == oracle
    cap = 2 * r // n_dev
    with use_session() as sess:
        st = make_store(dev, "kernel", "kernel", cap, init, sess,
                        "kv_paper_b")
        outs, dropped, secs = run_paper(torch, dev, st, trace, sess)
        final = st.dump()
    require(dropped == 0, f"kv_paper (b): {dropped} rows overflowed")
    ref = SequentialKVReference(N_KEYS, VW)
    ref.prefill(init)
    for i, (keys, is_put, vals) in enumerate(trace):
        want = oracle_round(
            ref, [("get", np.where(is_put, -1, keys), vals, None),
                  ("put", np.where(is_put, keys, -1), vals, None)],
            True, n_dev)
        require(np.array_equal(outs[i], want[0]),
                f"kv_paper (b) round {i}: GET responses differ from the "
                f"sequential oracle")
    require(np.array_equal(final, ref.dump()),
            "kv_paper (b): final table differs from the sequential oracle")
    say(f"[kv_paper b] capacity {cap}: kernel path == sequential oracle bit "
        f"for bit ({len(trace)} rounds, every GET response and the final "
        f"table)")
    report["kv_paper_b_kernel_ops_s"] = r * len(trace) / secs


def mixed_trace(rng, init, rounds=8, r=65536):
    from repro_torch.core import SequentialKVReference
    from repro_torch.core.routing import sample_keys
    sizes = {"get": int(r * 0.4), "put": int(r * 0.2), "add": int(r * 0.2)}
    sizes["cas"] = r - sum(sizes.values())
    sim = SequentialKVReference(N_KEYS, VW)
    sim.prefill(init)
    trace = []
    for _ in range(rounds):
        batches = []
        for op in ("get", "put", "add", "cas"):
            n = sizes[op]
            keys = sample_keys(rng, N_KEYS, n, "zipf").astype(np.int32)
            vals = rng.integers(0, 8, (n, VW)).astype(np.float32)
            expect = None
            if op == "cas":
                live = sim.table[keys].copy()
                rand = rng.integers(0, 8, (n, VW)).astype(np.float32)
                expect = np.where(rng.random(n)[:, None] < 0.5, live, rand)
            batches.append((op, keys, vals, expect))
        # CAS expects hit the round-start table of a plain-order replay
        # about half the time
        oracle_round(sim, batches, False, 8)
        trace.append(batches)
    return trace


def phase_mixed(torch, dev, report):
    from repro_torch.core import (DelegatedKVStore, SequentialKVReference,
                                  StackedMesh, use_session)
    rng = np.random.default_rng(7)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    trace = mixed_trace(rng, init)
    n_dev = MESH[0] * MESH[1]
    r_total = sum(len(b[1]) for b in trace[0])
    for shortcut in (True, False):
        ref = SequentialKVReference(N_KEYS, VW)
        ref.prefill(init)
        with use_session() as sess:
            st = DelegatedKVStore(StackedMesh(MESH, device=dev), N_KEYS, VW,
                                  capacity=-(-r_total // n_dev),
                                  local_shortcut=shortcut, session=sess,
                                  name="kv_mixed")
            st.prefill(init)
            op = st.trust.op
            secs = 0.0
            for i, batches in enumerate(trace):
                T = lambda a: torch.as_tensor(a, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                futs = []
                for name, keys, vals, expect in batches:
                    if name == "get":
                        futs.append(op.get.then(T(keys)))
                    elif name == "put":
                        futs.append(op.put.then(T(keys), T(vals)))
                    elif name == "add":
                        futs.append(op.add.then(T(keys), T(vals)))
                    else:
                        futs.append(op.cas.then(T(keys), value=T(vals),
                                                expect=T(expect)))
                stats = sess.step()
                torch.cuda.synchronize()
                secs += time.perf_counter() - t0
                check_stats(stats, "kv_mixed")
                require(stats["kv_mixed"]["dropped"] == 0,
                        "kv_mixed: rows overflowed")
                want = oracle_round(ref, batches, shortcut, n_dev)
                for (name, *_), fut, w in zip(batches, futs, want):
                    res = fut.result()
                    if name in ("get", "add"):
                        got_ok = np.array_equal(res["value"].cpu().numpy(), w)
                    elif name == "cas":
                        got_ok = (np.array_equal(res["flag"].cpu().numpy(),
                                                 w[0]) and
                                  np.array_equal(res["value"].cpu().numpy(),
                                                 w[1]))
                    else:
                        got_ok = True
                    require(got_ok, f"kv_mixed shortcut={shortcut} round "
                            f"{i}: {name} responses differ from the oracle")
            require(np.array_equal(st.dump(), ref.dump()),
                    f"kv_mixed shortcut={shortcut}: final table differs")
        say(f"[kv_mixed] shortcut={shortcut}: == sequential oracle bit for "
            f"bit ({len(trace)} rounds x {r_total} rows, every response and "
            f"the final table)")
        report[f"kv_mixed_shortcut_{shortcut}_ops_s"] = \
            r_total * len(trace) / secs


# ---------------------------------------------------------------------------
# phase 9: times
# ---------------------------------------------------------------------------

def device_events(torch, fn, iters=20, name=None):
    """The CUDA activity (kernels, memsets, copies) of ``iters`` calls —
    with ``name``, only the kernels whose name holds it — from
    torch.profiler (CUPTI), as key averages."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and (name is None or name in e.key)]


def device_readings(torch, fn, name, n=5, iters=20, per_call=1):
    """``n`` profiler readings of the ``name`` kernels' device time per
    call, each over ``iters`` calls: (median, min, max, the kernel records
    the profiler kept in each reading — ``iters * per_call`` unless
    records were lost).  A call launches ``per_call`` kernels, each of its
    own name once: a reading's time per call is the sum of each kernel's
    mean record, so a reading that lost records is not biased (where a
    kernel kept no record at all, the mean of all records kept times
    ``per_call``); one that kept none is left out (all zeros when every
    reading kept none)."""
    xs, seen = [], []
    for _ in range(n):
        evs = device_events(torch, fn, iters, name)
        kept = sum(e.count for e in evs)
        seen.append(kept)
        if kept and len(evs) == per_call:
            xs.append(sum(e.self_device_time_total / e.count for e in evs)
                      / 1e3)
        elif kept:
            xs.append(sum(e.self_device_time_total for e in evs) / kept
                      * per_call / 1e3)
    if not xs:
        return 0.0, 0.0, 0.0, seen
    xs.sort()
    return xs[len(xs) // 2], xs[0], xs[-1], seen


def ahead_ms(torch, fn, iters=50, sleep_cycles=40_000_000):
    """CUDA-event time per call with the host ahead of the card: the stream
    first spins while the host issues every call, so the events time the
    card's back-to-back work and not the host's issue rate.  The spin is
    ``sleep_cycles`` clocks (some 20 ms) or, where one call's host issue
    time asks for more, twice the issue time of ``iters`` calls at 2 GHz
    (at most some 2 s).  Returns (device ms per call, host ms per call to
    issue, whether the host finished issuing before the spin ended)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    one = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = min(max(sleep_cycles, int(2 * one * iters * 2e9)), 4_000_000_000)
    e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    torch.cuda._sleep(cycles)
    a.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters, host / iters, host < e0.elapsed_time(a)


# the host's calls that each leave one device record: launches, memsets
# and copies (the profiler keeps every host event; it loses device ones)
DEVICE_WORK_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemset", "cudaMemcpy")


def yardstick(torch, fn, iters=20):
    """A plain or library reading: CUDA events with the host ahead of the
    card (``ahead_ms``), and beside it torch.profiler's over ``iters``
    calls, whose lost device records would bias a sum low: its time per
    call is the mean record kept times the launches, memsets and copies
    the host made a call.  Returns (events ms, profiler ms, records kept,
    records the calls made, host ahead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ev, _, ahead = ahead_ms(torch, fn, iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    kept = sum(e.count for e in dev)
    made = sum(e.count for e in evs if e.device_type == DeviceType.CPU
               and e.key.startswith(DEVICE_WORK_CALLS))
    prof_ms = (sum(e.self_device_time_total for e in dev) / kept * made
               / iters / 1e3 if kept else 0.0)
    return ev, prof_ms, kept, made, ahead


def share(ms, bound):
    """A reading against the bound of its own work: the share of the
    bound, or where the reading is below it, not a time at all."""
    if ms < bound:
        return f"below its bound {bound:.6f} ms: not a time"
    return f"{100 * bound / ms:.1f}% of its bound {bound:.6f} ms"


def reading(label, r, bound):
    """One yardstick reading (``yardstick``'s tuple) for a times line."""
    ms, prof, kept, want, ahead = r
    return (f"{label} {ms:.6f} ms (CUDA events, host "
            f"{'ahead' if ahead else 'NOT ahead'}; profiler {prof:.6f} ms "
            f"from {kept} of {want} records; {share(ms, bound)})")


def sm_clock_under(torch, fn, calls):
    """The card's SM clock and its maximum, MHz, from nvidia-smi, queried
    while the card works through ``calls`` calls of ``fn`` issued just
    before."""
    for _ in range(calls):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    return out


def pack_bytes(torch, args):
    """dst in and the words of the rows the pack places (each
    destination's first C + C2 rows: an inactive or dropped row's words
    need not be read); both slot blocks, request_slot and the counts,
    counts2 and totals out — all 32-bit."""
    dst, words, t, c, c2 = args
    d, r, w = words.shape
    per = torch.zeros((d, t + 1), dtype=torch.int64, device=dst.device)
    per.scatter_add_(1, torch.where(dst >= 0, dst, t).long(),
                     torch.ones_like(dst, dtype=torch.int64))
    placed = int(per[:, :t].clamp(max=c + c2).sum())
    return 4 * (dst.numel() + placed * w + d * t * (c + c2) * w
                + dst.numel() + 3 * d * t)


def serve_bytes(torch, name, case):
    t, n = case["keys"].shape
    w = case["table"].shape[-1]
    lane = case["lane"]
    idx = 4 * t * n
    if name == "gather":     # the GET lane: keys, lane, a line in, a row out
        rows = int((lane == 0).sum())
        return 2 * idx + 2 * 4 * rows * w
    order, sid = case["order"], case["sid"]
    lane_s = torch.gather(lane, 1, order.long())
    pos = torch.arange(n, device=lane.device)
    if name == "scatter_last":   # order, seg_end, flag; a row in, a line out
        heads = int(((sid == pos) & (lane_s == 1)).sum())
        return 3 * idx + 2 * 4 * heads * w + 4 * heads
    adds = int((lane_s == 2).sum())
    segs = int(((sid == pos) & (lane_s == 2)).sum())
    # order, sid, seg_end, lane; deltas in; responses in and out; a table
    # line in and out per segment
    return 4 * idx + 3 * 4 * adds * w + 2 * 4 * segs * w


def busy_share(torch, run_round, rounds, top=0):
    """Device busy share of whole rounds: device time (profiler) over the
    host wall time of ``rounds`` rounds ending in a synchronize.  With
    ``top``, also returns the ``top`` device ops by total time as
    (name, ms, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_round()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ops) / 1e6
    if not top:
        return busy, wall
    dev_ops.sort(key=lambda e: -e.self_device_time_total)
    return busy, wall, [(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in dev_ops[:top]]


def phase_times(torch, dev, shapes, errs, per_round, gpu):
    """Each kernel's time at the main path's shapes beside its bound, its
    plain version and a library yardstick; the busy share of a round."""
    from repro_torch.kernels import ops as kops
    measured = {}

    def emit(name, label, fn_kernel, fn_plain, fn_lib, nbytes, lib_bytes=0,
             floor=None):
        ms, lo, hi, seen = device_readings(
            torch, fn_kernel, KERNEL_NAMES[name],
            per_call=LAUNCHES_PER_CALL.get(name, 1))
        ev, host, ahead = ahead_ms(torch, fn_kernel)
        if ms == 0:                 # the profiler kept no kernel record
            ms = ev
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        plain = yardstick(torch, fn_plain, iters=5)
        lib = yardstick(torch, fn_lib) if fn_lib is not None else None
        lib_txt = "library n/a" if lib is None else reading(
            "library", lib, lib_bytes / HBM_BYTES_PER_S * 1e3)
        if floor is not None:       # (what, call, its bytes)
            lib_txt += ", " + reading(floor[0], yardstick(torch, floor[1]),
                                      floor[2] / HBM_BYTES_PER_S * 1e3)
        say(f"[times] {gpu} | {name} @ {label}: {ms:.6f} ms/call (median "
            f"of the profiler readings that kept records, each the sum of "
            f"its kernels' mean records, {lo:.6f}..{hi:.6f}, "
            f"records kept per reading of 20 calls {seen}; CUDA events with "
            f"the host {'ahead' if ahead else 'NOT ahead'} {ev:.6f} ms/call,"
            f" host issue {host:.6f} ms/call), bound {bound:.6f} ms "
            f"({nbytes} bytes), {reading('plain', plain, bound)}, "
            f"{lib_txt}, {per_round[label][name]:.3f} calls/round on the "
            f"main path")
        measured[(name, label)] = (ms, plain[0], bound,
                                   None if lib is None else lib[0])

    for label, key in (("kv_paper", "pack_paper"), ("kv_mixed", "pack_mixed")):
        args = pack_case(torch, dev, **shapes[key], seed=21, hot=0.07)
        emit("delegation_pack", label,
             lambda: kops.delegation_pack(*args),
             lambda: kops.delegation_pack(*args, impl="ref"), None,
             pack_bytes(torch, args))

    for label, key in (("kv_paper", "serve_paper"),
                       ("kv_mixed", "serve_mixed")):
        case = serve_case(torch, dev, **shapes[key], seed=31)
        t, n = case["keys"].shape
        w = case["table"].shape[-1]
        out = torch.zeros((t, n, w), device=dev)
        flag_put = (case["lane"] == 1).to(torch.int32)
        resp = torch.zeros((t, n, w), device=dev)
        table = case["table"].clone()
        k = table.shape[1]
        calls = {
            "gather": lambda impl: kops.gather(
                table, case["keys"], case["lane"], 0, out, impl=impl),
            "scatter_last": lambda impl: kops.scatter_last(
                table, case["keys"], case["order"], case["seg_end"],
                flag_put, case["value"], impl=impl),
        }
        if label == "kv_mixed":      # kv_paper's rounds carry no ADD rows
            calls["segmented_add"] = lambda impl: kops.segmented_add(
                table, case["keys"], case["lane"], case["order"],
                case["sid"], case["seg_end"], case["value"], resp,
                impl=impl)
        # library yardsticks (timed here only; the port never calls them):
        # index_select reads the GET lane's lines, index_add_ adds the ADD
        # lane's deltas into the table (the totals, not the priors)
        get_rows = (case["lane"] == 0).nonzero()
        flat_idx = (get_rows[:, 0] * k
                    + case["keys"][get_rows[:, 0], get_rows[:, 1]]).long()
        add_rows = (case["lane"] == 2).nonzero()
        add_idx = (add_rows[:, 0] * k
                   + case["keys"][add_rows[:, 0], add_rows[:, 1]]).long()
        add_val = case["value"][add_rows[:, 0], add_rows[:, 1]]
        flat_table = table.view(-1, w)
        library = {
            "gather": lambda: flat_table.index_select(0, flat_idx),
            "scatter_last": None,
            "segmented_add": lambda: flat_table.index_add_(0, add_idx,
                                                           add_val),
        }
        # what each library call must move: its int64 indices and the rows
        # read and written (index_add_: each distinct line in and out once)
        lib_bytes = {
            "gather": 8 * flat_idx.numel() + 2 * 4 * flat_idx.numel() * w,
            "scatter_last": 0,
            "segmented_add": 8 * add_idx.numel() + 4 * add_val.numel()
            + 2 * 4 * int(torch.unique(add_idx).numel()) * w,
        }
        # the random read through ``order`` that each commit kernel makes
        # for every row (scatter_last its flag, segmented_add its lane),
        # alone: torch.gather of int32 words by an int64 index, 16 bytes a
        # row (index in, word in, word out)
        order_l = case["order"].long()
        floors = {name: (f"its {what} gather alone (torch.gather through "
                         f"order)",
                         lambda src=src: torch.gather(src, 1, order_l),
                         16 * t * n)
                  for name, what, src in (
                      ("scatter_last", "flag", flag_put),
                      ("segmented_add", "lane", case["lane"]))}
        for name, call in calls.items():
            emit(name, label, lambda: call("kernel"), lambda: call("ref"),
                 library[name], serve_bytes(torch, name, case),
                 lib_bytes[name], floors.get(name))

    rows = []
    for name in KV_KERNELS:
        # the JSON line carries kv_paper's shapes; segmented_add runs only
        # in kv_mixed's ADD rounds, so it carries kv_mixed's
        label = "kv_mixed" if name == "segmented_add" else "kv_paper"
        ms, plain, bound, lib = measured[(name, label)]
        src, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": per_round["launches"][name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                     "bound_ms": bound, "bound_by": "bytes",
                     "library_ms": lib, "shapes": label})
    return rows


def phase_busy(torch, dev, gpu):
    """Device busy share over whole kv_paper / kv_mixed rounds (kernel
    path), from a profiler trace: the rest of the wall time the card
    waits for the host."""
    from repro_torch.core import DelegatedKVStore, StackedMesh, use_session
    rng = np.random.default_rng(99)
    init = np.zeros((N_KEYS, VW), np.float32)
    paper = paper_trace(rng, rounds=1)[0]
    mixed = mixed_trace(rng, init, rounds=1)[0]
    with use_session() as sess:
        st = make_store(dev, "kernel", "kernel", None, init, sess,
                        "busy_paper")
        keys = torch.as_tensor(paper[0], device=dev)
        put = torch.as_tensor(paper[1], device=dev)
        vals = torch.as_tensor(paper[2], device=dev)

        def paper_round():
            st.trust.op.get.then(keys, where=~put)
            st.trust.op.put.then(keys, vals, where=put)
            sess.step()
        busy, wall = busy_share(torch, paper_round, 10)
        say(f"[busy] {gpu} | kv_paper round: " + (
            f"device busy {busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
            f"over 10 rounds ({100 * busy / wall:.1f}% busy)" if busy > 0
            else "device busy share not measured (the profiler recorded "
                 "no device activity)"))
    with use_session() as sess:
        st = DelegatedKVStore(StackedMesh(MESH, device=dev), N_KEYS, VW,
                              capacity=65536 // (MESH[0] * MESH[1]),
                              session=sess, name="busy_mixed")
        args = [(op, torch.as_tensor(k, device=dev),
                 torch.as_tensor(v, device=dev),
                 None if e is None else torch.as_tensor(e, device=dev))
                for op, k, v, e in mixed]

        def mixed_round():
            for op, k, v, e in args:
                h = st.trust.op[op]
                if op == "get":
                    h.then(k)
                elif op == "cas":
                    h.then(k, value=v, expect=e)
                else:
                    h.then(k, v)
            sess.step()
        busy, wall = busy_share(torch, mixed_round, 5)
        say(f"[busy] {gpu} | kv_mixed round: " + (
            f"device busy {busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
            f"over 5 rounds ({100 * busy / wall:.1f}% busy)" if busy > 0
            else "device busy share not measured (the profiler recorded "
                 "no device activity)"))


# ---------------------------------------------------------------------------
# phase 2, paged: the paged-decode kernels against their plain versions
# ---------------------------------------------------------------------------

PA_MAIN = dict(b=64, hq=16, hkv=2, d=128, p=4096, ps=16, mp=64)


def pa_case(torch, dev, dtype, b, hq, hkv, d, p, ps, mp, lengths, seed,
            pad_inside=False):
    """Random q and pools; each chain a run of distinct random pages
    covering its length, -1 past it (and, with ``pad_inside``, one -1
    inside it, which the kernel reads as page 0)."""
    rng = np.random.default_rng(seed)
    tbl = np.full((b, mp), -1, np.int32)
    for i, n in enumerate(lengths):
        live = min(-(-int(n) // ps), mp)
        tbl[i, :live] = rng.choice(p, live, replace=False)
        if pad_inside and live > 1:
            tbl[i, rng.integers(0, live)] = -1
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev,
                                     dtype=torch.float32).to(dtype)
    return (rnd(b, hq, d), rnd(p, hkv, ps, d), rnd(p, hkv, ps, d),
            torch.as_tensor(tbl, device=dev),
            torch.as_tensor(np.asarray(lengths, np.int32), device=dev))


def pa_tolerance(torch, dtname):
    """The kernel against its plain version, compared in the working dtype
    (``kernels/paged_attention.py::TOLERANCE`` states why)."""
    from repro_torch.kernels.paged_attention import TOLERANCE
    return TOLERANCE[getattr(torch, dtname)]


def pa_within(torch, got, want, dtname):
    rtol, atol = pa_tolerance(torch, dtname)
    err = (got.float() - want.float()).abs()
    return bool((err <= atol + rtol * want.float().abs()).all()), \
        float(err.max())


def phase_paged_kernels(torch, dev, errs):
    """paged_attention (bf16 and f32) and pagetable_serve against their
    plain versions: the main path's shapes and the edge cases."""
    from repro_torch.core import DelegatedPageTable, StackedMesh, use_session
    from repro_torch.testing.pagetable import (
        STRESS_GEOMETRY, replay_waves, stress_waves, submit_waves)
    from repro_torch.kernels import ops as kops
    g16 = dict(hq=16, hkv=2, d=128, ps=16)
    cases = [
        ("main path shapes", dict(**PA_MAIN, lengths=list(range(1, 1025, 16))),
         True),
        ("B 1, one chain over every split", dict(b=1, hq=16, hkv=2, d=128,
                                                 p=256, ps=16, mp=64,
                                                 lengths=[1024]), False),
        ("one chain longer than a split beside short ones",
         dict(b=3, p=256, mp=64, lengths=[700, 3, 64], **g16), False),
        ("216-byte bf16 pages, read without bulk copies",
         dict(b=3, hq=4, hkv=2, d=36, p=30, ps=3, mp=10, lengths=[30, 1, 17]),
         False),
        ("length 1", dict(b=8, p=64, mp=4, lengths=[1] * 8, **g16), False),
        ("on and one past page boundaries",
         dict(b=6, p=64, mp=4, lengths=[16, 17, 32, 33, 48, 49], **g16),
         False),
        ("-1 pads inside and past the length",
         dict(b=5, p=80, mp=8, lengths=[128, 100, 50, 17, 2],
              pad_inside=True, **g16), False),
        ("MP*PS == length", dict(b=4, p=64, mp=4, lengths=[64] * 4, **g16),
         False),
        ("Hkv == Hq (rep 1)", dict(b=4, hq=4, hkv=4, d=64, p=40, ps=8, mp=5,
                                   lengths=[40, 1, 9, 39]), False),
    ]
    errs["paged_attention"] = 0.0
    for dtname in ("bfloat16", "float32", "float16"):
        for i, (label, kw, main) in enumerate(cases):
            args = pa_case(torch, dev, getattr(torch, dtname), seed=40 + i,
                           **kw)
            got = kops.paged_attention(*args)
            torch.cuda.synchronize()
            want = kops.paged_attention(*args, impl="ref")
            ok, err = pa_within(torch, got, want, dtname)
            rtol, atol = pa_tolerance(torch, dtname)
            require(ok, f"paged_attention [{label}, {dtname}]: max abs err "
                    f"{err} beyond {atol} + {rtol} * |plain|")
            if main and dtname == "bfloat16":
                errs["paged_attention"] = max(errs["paged_attention"], err)
            say(f"[kernels] paged_attention [{label}, {dtname}] == plain "
                f"(max abs err {err:.3g}; |err| <= {atol:g} + {rtol:g} "
                f"* |plain|)")

    g = STRESS_GEOMETRY
    for shortcut in (True, False):
        runs = {}
        for side, d in (("card", dev), ("plain", torch.device("cpu"))):
            with use_session():
                pt = DelegatedPageTable(StackedMesh(MESH, device=d),
                                        g["n_pages"], max_seqs=g["max_seqs"],
                                        page_size=g["page_size"],
                                        max_pages=g["max_pages"],
                                        capacity=256, local_shortcut=shortcut)
                rec = submit_waves(pt, stress_waves(61))
                rows = replay_waves(pt, rec)
                resps = [[(op, pt.globalize(f.result(), s))
                          for op, s, _, f in w] for w in rec]
                runs[side] = (resps, pt.dump(), pt.audit())
        (gw, gs, ga), (ww, ws, _) = runs["card"], runs["plain"]
        for i, (a, b) in enumerate(zip(gw, ww)):
            for (op, ra), (_, rb) in zip(a, b):
                require(all(np.array_equal(ra[k], rb[k]) for k in rb),
                        f"pagetable_serve [stress, shortcut={shortcut}] wave "
                        f"{i} {op}: the card differs from the plain version")
        require(all(np.array_equal(gs[k], ws[k]) for k in ws),
                f"pagetable_serve [stress, shortcut={shortcut}]: final state "
                f"differs from the plain version")
        flags = lambda o: np.concatenate([r["flag"] for w in gw
                                          for op, r in w if op == o])
        say(f"[kernels] pagetable_serve [stress trace, shortcut={shortcut}] "
            f"== plain bit for bit and == the sequential oracle in serve "
            f"order ({rows} rows, {ga['evictions']} evictions, "
            f"{int((flags('alloc') == 0).sum())} infeasible allocs, "
            f"{int((flags('append') > 1).sum())} healing appends)")
    errs["pagetable_serve"] = 0.0


# ---------------------------------------------------------------------------
# phase 2, flash attention: the prefill kernel against its plain version
# ---------------------------------------------------------------------------

# the qwen2.5-3b prefill's attention: B 4 x 2048 tokens, 16 query / 2 KV
# heads of 128, causal, bf16
FA_MAIN = dict(b=4, hq=16, hkv=2, sq=2048, skv=2048, d=128)
# the deepseek-v2-lite-16b prefill's MLA attention: 16 heads of 128 nope +
# 64 rope dims, V padded from 128 to 192
FA_MLA = dict(b=4, hq=16, hkv=16, sq=2048, skv=2048, d=192)


def fa_case(torch, dev, b, hq, hkv, sq, skv, d, seed, bshd=False):
    """Random bf16 q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D); with
    ``bshd`` each is a (B, S, H, D) tensor seen transposed, the layout the
    model passes."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(h, s):
        shape = (b, s, h, d) if bshd else (b, h, s, d)
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        return x.transpose(1, 2) if bshd else x
    return rnd(hq, sq), rnd(hkv, skv), rnd(hkv, skv)


def phase_flash_kernels(torch, dev, errs):
    """flash_attention against its plain version: the main path's shape
    and the edge cases, within ``kernels/flash_attention.py::tolerance``."""
    from repro_torch.kernels import ops as kops
    from repro_torch.testing.model import flash_within
    cases = [
        ("main path shape, causal", FA_MAIN, {}, True),
        ("main path layout (B, S, H, D) views", dict(FA_MAIN, sq=512,
                                                     skv=512, bshd=True),
         {}, False),
        ("MQA (Hkv 1)", dict(b=2, hq=8, hkv=1, sq=512, skv=512, d=128), {},
         False),
        ("MHA (Hkv == Hq)", dict(b=2, hq=4, hkv=4, sq=384, skv=384, d=128),
         {}, False),
        ("q_offset 768, Sq 256 < Skv 1024 (a sequence shard)",
         dict(b=2, hq=16, hkv=2, sq=256, skv=1024, d=128),
         dict(q_offset=768), False),
        ("causal=False, Sq 256, Skv 640", dict(b=2, hq=4, hkv=2, sq=256,
                                               skv=640, d=128),
         dict(causal=False), False),
        ("D 64", dict(b=2, hq=8, hkv=2, sq=1024, skv=1024, d=64), {}, False),
        ("D 32", dict(b=1, hq=4, hkv=2, sq=256, skv=256, d=32), {}, False),
        ("ragged Sq = Skv = 200", dict(b=2, hq=4, hkv=2, sq=200, skv=200,
                                       d=128), {}, False),
        ("ragged Sq 77, Skv 333, causal=False",
         dict(b=1, hq=4, hkv=1, sq=77, skv=333, d=64), dict(causal=False),
         False),
        ("ragged Sq 100 at q_offset 257 of Skv 357",
         dict(b=1, hq=8, hkv=2, sq=100, skv=357, d=128),
         dict(q_offset=257), False),
        ("D 192, the MLA prefill's shape and layout",
         dict(FA_MLA, bshd=True), {}, False),
        ("D 192, ragged Sq = Skv = 333", dict(b=1, hq=4, hkv=4, sq=333,
                                             skv=333, d=192), {}, False),
        # the edges of the wgmma kernel's 128-row query tiles and its 128-
        # (D 128) and 64-key (D 192) KV tiles
        ("Sq 40 < 64: one warpgroup without rows",
         dict(b=2, hq=4, hkv=2, sq=40, skv=40, d=128), {}, False),
        ("Skv 1, D 192", dict(b=2, hq=4, hkv=4, sq=1, skv=1, d=192), {},
         False),
        ("ragged Sq = Skv = 300", dict(b=2, hq=4, hkv=2, sq=300, skv=300,
                                       d=128), {}, False),
        ("q_offset 197 off the tiles, Skv 397",
         dict(b=1, hq=8, hkv=2, sq=200, skv=397, d=128),
         dict(q_offset=197), False),
        ("D 192, q_offset 77, Skv 377",
         dict(b=1, hq=8, hkv=8, sq=300, skv=377, d=192),
         dict(q_offset=77), False),
        ("D 192, GQA rep 8", dict(b=1, hq=16, hkv=2, sq=512, skv=512,
                                  d=192), {}, False),
        ("D 192, MQA", dict(b=1, hq=8, hkv=1, sq=256, skv=256, d=192), {},
         False),
        ("D 192, causal=False, Sq 256, Skv 640",
         dict(b=2, hq=4, hkv=4, sq=256, skv=640, d=192),
         dict(causal=False), False),
    ]
    errs["flash_attention"] = 0.0
    for i, (label, shape, kw, main) in enumerate(cases):
        q, k, v = fa_case(torch, dev, seed=70 + i, **shape)
        got = kops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = kops.flash_attention(q, k, v, impl="ref", **kw)
        ok, err = flash_within(got, want, v)
        require(ok, f"flash_attention [{label}]: max abs err {err} beyond "
                f"the tolerance")
        if main:
            errs["flash_attention"] = err
        say(f"[kernels] flash_attention [{label}] == plain (bf16, max abs "
            f"err {err:.3g})")
    # q_offset reproduces the rows of a query block that starts mid-sequence
    q, k, v = fa_case(torch, dev, seed=90, b=1, hq=4, hkv=2, sq=1024,
                      skv=1024, d=128)
    full = kops.flash_attention(q, k, v)
    half = kops.flash_attention(q[:, :, 512:], k, v, q_offset=512)
    torch.cuda.synchronize()
    require(torch.equal(full[:, :, 512:], half),
            "flash_attention: the q_offset 512 launch differs from the "
            "second half of the full launch")
    say("[kernels] flash_attention [q_offset 512 == rows 512.. of the full "
        "launch] bit for bit")
    try:
        kops.flash_attention(q.float(), k.float(), v.float())
    except TypeError as e:
        say(f"[kernels] flash_attention refuses f32 on the card: {e}")
    else:
        raise AssertionError("flash_attention accepted f32 on the card")


# ---------------------------------------------------------------------------
# phase 2, grouped matmul: the MoE expert FFN kernel against its plain
# version
# ---------------------------------------------------------------------------

# the deepseek-v2-lite-16b expert FFN's shapes on the main path, T = 4:
# the prefill's B 4 x 2048 tokens fill cap2 = 3072 slots per expert, a
# decode step's B 8 tokens cap2 = 8
GMM_PREFILL = dict(e=64, c=3072, d=2048, f=1408)
GMM_DECODE = dict(e=64, c=8, d=2048, f=1408)


def gmm_case(torch, dev, e, c, d, f, seed, fill=1.0, counts=None):
    """Random bf16 x (E, C, D) and w (E, D, F) at the weights' scale;
    with ``fill`` < 1 only that leading share of each expert's slots is
    filled, the rest zero (the serve's empty slots).  ``counts``: "serve"
    draws each expert's filled rows around ``fill`` of C (some experts
    empty, as a decode step leaves them), "edges" cycles through 0, a
    partial 128-row tile, exactly a tile and C; x's rows past them zero,
    the counts returned (else None)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((e, c, d), generator=g, device=dev).to(torch.bfloat16)
    x[:, int(round(fill * c)):] = 0
    w = (torch.randn((e, d, f), generator=g, device=dev) / d ** 0.5).to(
        torch.bfloat16)
    if counts is None:
        return x, w, None
    rng = np.random.default_rng(seed)
    if counts == "serve":
        n = rng.integers(0, max(1, int(2 * fill * c)) + 1, e)
        n[rng.random(e) < 0.25] = 0
    else:
        n = np.array([[0, min(77, c), min(128, c), c][i % 4]
                      for i in range(e)])
    n = torch.as_tensor(np.minimum(n, c).astype(np.int32), device=dev)
    x[torch.arange(c, device=dev)[None, :] >= n[:, None]] = 0
    return x, w, n


def phase_gmm_kernels(torch, dev, errs):
    """grouped_matmul against its plain version: the prefill's and the
    decode's shapes (gate / up and down), with per-expert counts (the
    serve's spread, and 0, a partial tile, exactly a tile and C), ragged
    C / D / F, E = 1, C = 1, zero slots, within
    ``kernels/grouped_matmul.py::tolerance`` over the whole (E, C, F)
    output; f32 refused."""
    from repro_torch.kernels import ops as kops
    from repro_torch.testing.model import gmm_within
    cases = [
        ("prefill gate / up, a quarter of the slots filled",
         dict(GMM_PREFILL, fill=0.25), True),
        ("prefill gate / up, the serve's counts",
         dict(GMM_PREFILL, fill=0.25, counts="serve"), True),
        ("prefill down, the serve's counts",
         dict(GMM_PREFILL, d=1408, f=2048, fill=0.25, counts="serve"), False),
        ("prefill down", dict(GMM_PREFILL, d=1408, f=2048), False),
        ("decode gate / up", GMM_DECODE, False),
        ("decode gate / up, the serve's counts",
         dict(GMM_DECODE, fill=0.75, counts="serve"), False),
        ("decode down", dict(GMM_DECODE, d=1408, f=2048), False),
        ("counts 0, 77, 128, C 300, ragged F 264",
         dict(e=8, c=300, d=136, f=264, counts="edges"), False),
        ("counts 0, 77, 128, C 200, D 77, F 33",
         dict(e=4, c=200, d=77, f=33, counts="edges"), False),
        ("ragged C 13, D 72, F 40", dict(e=3, c=13, d=72, f=40), False),
        ("D 77, F 33 (not multiples of 8)", dict(e=2, c=200, d=77, f=33),
         False),
        ("E 1", dict(e=1, c=129, d=2048, f=1408), False),
        ("C 1", dict(e=64, c=1, d=2048, f=1408), False),
    ]
    errs["grouped_matmul"] = 0.0
    for i, (label, shape, main) in enumerate(cases):
        x, w, counts = gmm_case(torch, dev, seed=110 + i, **shape)
        got = kops.grouped_matmul(x, w, counts)
        torch.cuda.synchronize()
        want = kops.grouped_matmul(x, w, counts, impl="ref")
        ok, err = gmm_within(got, want, x, w)
        require(ok, f"grouped_matmul [{label}]: max abs err {err} beyond "
                f"the tolerance")
        if counts is not None:
            past = torch.arange(x.shape[1], device=dev)[None, :] \
                >= counts[:, None]
            require(bool((got[past] == 0).all()),
                    f"grouped_matmul [{label}]: a row past the counts did "
                    f"not answer zeros")
            ok, _ = gmm_within(got, kops.grouped_matmul(x, w, impl="ref"),
                               x, w)
            require(ok, f"grouped_matmul [{label}]: beyond the tolerance of "
                    f"the plain version without the counts")
        if "fill" in shape:
            c0 = int(round(shape["fill"] * shape["c"]))
            require(bool((got[:, c0:] == 0).all()),
                    "grouped_matmul: an empty slot did not answer zeros")
        if main:
            errs["grouped_matmul"] = max(errs["grouped_matmul"], err)
        filled = "" if counts is None else (
            f"; {int(((counts.long() + 127) // 128).sum())} of "
            f"{x.shape[0] * -(-x.shape[1] // 128)} 128-row tiles filled")
        say(f"[kernels] grouped_matmul [{label}] == plain (bf16, max abs "
            f"err {err:.3g}{filled})")
    try:
        kops.grouped_matmul(x.float(), w.float())
    except TypeError as e:
        say(f"[kernels] grouped_matmul refuses f32 on the card: {e}")
    else:
        raise AssertionError("grouped_matmul accepted f32 on the card")


# ---------------------------------------------------------------------------
# phase 5: the paged-decode main path
# ---------------------------------------------------------------------------

def paged_inputs(torch, dev, seed=2026):
    """qwen2.5-3b attention weights (bf16, random from ``seed``; QKV biases
    zero as the JAX init makes them), the token stream made on the card,
    and 256 requests."""
    from repro_torch.configs.qwen2_5_3b import CONFIG
    from repro_torch.launch.paged_decode import make_requests
    from repro_torch.models.attention import init_attention
    params = init_attention(CONFIG, torch.bfloat16, dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn((PAGED["max_seqs"],
                      PAGED["max_pages"] * PAGED["page_size"],
                      CONFIG.d_model), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    reqs = make_requests(np.random.default_rng(seed), N_REQUESTS, PROMPT,
                         GEN)
    return CONFIG, params, xs, reqs


def paged_run(torch, dev, inputs, check=False, n_requests=None):
    from repro_torch.launch.paged_decode import run_decode
    cfg, params, xs, reqs = inputs
    return run_decode(cfg, requests=reqs[:n_requests], dtype=torch.bfloat16,
                      device=dev, params=params, xs=xs, check=check,
                      **PAGED)


PT_STATE = ("used", "chains", "chain_len", "last_used", "clock",
            "evictions")


class KernelRecorder:
    """During the check run: holds every page-table pass against the plain
    version (on a copy of the state the pass found: the valid rows'
    responses and the whole state after it, bit for bit), keeps per op the
    pass with the most valid rows (state before and after, rows,
    responses), and the paged_attention call over the most live pages —
    the main path's own inputs, for the timings."""

    def __init__(self, kops):
        self.kops = kops
        self.passes, self.attention, self.best_pages = {}, None, -1
        self.checked, self.differ = 0, []
        self._pt, self._pa = kops.pagetable_serve, kops.paged_attention

    def __enter__(self):
        self.kops.pagetable_serve = self.pagetable_serve
        self.kops.paged_attention = self.paged_attention
        return self

    def __exit__(self, *exc):
        self.kops.pagetable_serve = self._pt
        self.kops.paged_attention = self._pa

    def pagetable_serve(self, op, state, seq, arg, valid, t, ps, **kw):
        import torch
        from repro_torch.kernels import ref
        n = int(valid.sum())
        before = {k: v.clone() for k, v in state.items()}
        out = self._pt(op, state, seq, arg, valid, t, ps, **kw)
        plain = {k: v.clone() for k, v in before.items()}
        want = ref.pagetable_serve(op, *[plain[k] for k in PT_STATE], seq,
                                   arg, valid, t, ps)
        self.checked += 1
        # the kernel leaves the responses of rows that are not valid
        # unwritten: compare valid rows only
        if not (all(torch.equal(x[valid], y[valid])
                    for x, y in zip(out, want))
                and all(torch.equal(state[k], plain[k]) for k in plain)):
            self.differ.append((op, n))
        if n > self.passes.get(op, (0,))[0]:
            self.passes[op] = (n, before, (seq.clone(), arg.clone(),
                                           valid.clone(), t, ps),
                               [o.clone() for o in out],
                               {k: v.clone() for k, v in state.items()})
        return out

    def paged_attention(self, q, k, v, tbl, lengths, scale=None,
                        impl="kernel"):
        if impl == "kernel":
            ps = k.shape[2]
            pages = int(((lengths.long() + ps - 1) // ps).sum())
            if pages > self.best_pages:
                self.best_pages = pages
                self.attention = (q.clone(), k, v, tbl.clone(),
                                  lengths.clone())
        return self._pa(q, k, v, tbl, lengths, scale, impl=impl)


def phase_paged(torch, dev, gpu, report, errs):
    """The slice's main path: run_decode at qwen2.5-3b attention width.
    (a) a check run: every request completes, the audit is clean, every
    wave's page-table responses equal the oracle replayed in serve order,
    every attention call's kernel output equals the plain version, and
    every page-table pass equals the plain serve bit for bit; (b) the
    timed run, counters zeroed just before it."""
    from repro_torch.kernels import ops as kops
    inputs = paged_inputs(torch, dev)
    with KernelRecorder(kops) as rec:
        stats = paged_run(torch, dev, inputs, check=True)
    chk = stats["check"]
    a = stats["audit"]
    require(stats["completed"] == N_REQUESTS and stats["failed"] == 0,
            f"paged decode: {stats['completed']} of {N_REQUESTS} requests "
            f"completed, {stats['failed']} failed")
    require(a["consistent"] and a["leaked"] == 0 and a["allocated"] == 0,
            f"paged decode: audit {a}")
    require(chk["rows_replayed"] == stats["pt_rows"],
            "paged decode: not every page-table row was replayed")
    require(chk["attention_out_of_tolerance"] == 0,
            f"paged decode: {chk['attention_out_of_tolerance']} attention "
            f"outputs beyond the bf16 tolerance (max abs err "
            f"{chk['attention_max_abs_err']})")
    errs["paged_attention"] = max(errs.get("paged_attention", 0.0),
                                  chk["attention_max_abs_err"])
    require(not rec.differ, f"pagetable_serve: {len(rec.differ)} of "
            f"{rec.checked} main-path passes differ from the plain version "
            f"(op, valid rows): {rec.differ[:8]}")
    say(f"[paged check] {N_REQUESTS}/{N_REQUESTS} requests, "
        f"{stats['tokens']} tokens, {stats['restarts']} restarts, "
        f"{a['evictions']} evictions, audit clean; {chk['waves']} waves, "
        f"{chk['rows_replayed']} page-table rows == the sequential oracle "
        f"in serve order; {chk['attention_calls']} attention calls == plain "
        f"(bf16, max abs err {chk['attention_max_abs_err']:.3g}); all "
        f"{rec.checked} page-table passes == plain bit for bit (the "
        f"largest of each op: "
        + ", ".join(f"op {o}: {v[0]} rows"
                    for o, v in sorted(rec.passes.items())) + ")")

    kops.reset_launch_counts()
    stats = paged_run(torch, dev, inputs)
    counts = kops.launch_counts()
    say(f"[main path] paged decode launches: {json.dumps(counts)}")
    for k in PAGED_KERNELS:
        require(counts[k] > 0, f"kernel {k} was not launched on the paged "
                f"main path")
    require(stats["completed"] == N_REQUESTS and stats["failed"] == 0,
            "paged decode (timed run): requests failed")
    say(f"[paged] {gpu} | {stats['tokens']} tokens in "
        f"{stats['wall_s']:.3f} s: {stats['tokens_per_s']:.1f} tokens/s, "
        f"{stats['pt_rows_per_s']:.1f} page-table rows/s "
        f"({stats['pt_rows']} rows, {stats['waves']} waves), request "
        f"latency p50 {stats['p50_ms']:.1f} ms p99 {stats['p99_ms']:.1f} ms, "
        f"{stats['restarts']} restarts, {stats['kv_writes']} KV writes; "
        f"host time issuing the model: prefill replay "
        f"{stats['host']['prefill_s']:.3f} s over "
        f"{stats['host']['prefill_calls']} one-position steps, decode "
        f"{stats['host']['decode_s']:.3f} s over "
        f"{stats['host']['decode_calls']} steps; the rest of the wall time "
        f"is the page-table waves and the driver")
    report["paged"] = stats
    return counts, rec, stats["waves"], inputs


# ---------------------------------------------------------------------------
# phase 6: the qwen2.5-3b serve path at full width
# ---------------------------------------------------------------------------

# prefill_step at B 4 x 2048 tokens; serve.main over 8 requests, 128
# prompt tokens teacher-forced and 128 generated, the KV cache's sequence
# split over 4 stacked trustees (36 x 2 x 8 x 2 x 256 x 128 bf16, 37.7 MB)
QWEN_PREFILL = dict(batch=4, seq=2048)
QWEN_SERVE = dict(batch=8, prompt_len=128, gen=128, mesh_model=4)
QWEN_TIMED_RUNS = 3


def qwen_serve_argv():
    q = QWEN_SERVE
    return ["--arch", "qwen2.5-3b", "--batch", str(q["batch"]),
            "--prompt-len", str(q["prompt_len"]), "--gen", str(q["gen"]),
            "--mesh-model", str(q["mesh_model"])]


def phase_qwen(torch, dev, gpu, report, errs):
    """The slice's main path at full width (36 layers, d_model 2048, 16 / 2
    heads of 128, d_ff 11008, vocab 151936, bf16, random weights from seed
    0 drawn on the card, the serve's own): (a) prefill_step at B 4 x 2048
    through the flash kernel — a check run holding every layer's kernel
    call against the plain version, then timed runs, each with the
    counters zeroed just before it and 36 flash launches read just after;
    (b) serve.main, 8 x (128 + 128) tokens over 4 trustees; (c) the
    prefill's last-position logits on the serve's prompt against the
    serve's decode logits at that position."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.testing.model import (DecodeLogits, FlashCheck,
                                           logits_agreement)
    cfg = get_arch("qwen2.5-3b")
    b, s = QWEN_PREFILL["batch"], QWEN_PREFILL["seq"]
    mesh = MeshConfig((1, QWEN_SERVE["mesh_model"]), ("data", "model"))
    run = RunConfig(model=cfg, shape=ShapeConfig("prefill", s, b, "prefill"),
                    mesh=mesh, remat="none", use_pallas=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, run, dev)
    torch.cuda.synchronize()
    n_params = M.count_params(params)
    say(f"[qwen] {cfg.name}: {n_params / 1e9:.3f} B parameters drawn on the "
        f"card in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated)")
    plan = build_cell(cfg, run.shape, run)
    gen = torch.Generator(device=dev).manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    kops.reset_launch_counts()
    with FlashCheck() as chk:
        logits = plan.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
    n_flash = kops.launch_counts()["flash_attention"]
    c = chk.summary()
    require(n_flash == cfg.n_layers and c["flash_calls"] == cfg.n_layers,
            f"prefill check run: {n_flash} flash launches, "
            f"{c['flash_calls']} checked, want {cfg.n_layers}")
    require(c["flash_calls_out_of_tolerance"] == 0,
            f"prefill: {c['flash_calls_out_of_tolerance']} flash calls "
            f"beyond the tolerance (max abs err {c['flash_max_abs_err']})")
    require(tuple(logits.shape) == (b, cfg.vocab_size)
            and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()),
            f"prefill logits: {tuple(logits.shape)} {logits.dtype}, finite "
            f"{bool(torch.isfinite(logits).all())}")
    errs["flash_attention"] = max(errs.get("flash_attention", 0.0),
                                  c["flash_max_abs_err"])
    say(f"[qwen check] prefill B {b} x {s}: {n_flash} flash launches, every "
        f"layer's call == plain (max abs err {c['flash_max_abs_err']:.3g}); "
        f"logits ({b}, {cfg.vocab_size}) f32, finite")

    secs = []
    for _ in range(QWEN_TIMED_RUNS):
        kops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = plan.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = kops.launch_counts()
        require(counts["flash_attention"] == cfg.n_layers,
                f"prefill timed run: {counts['flash_attention']} flash "
                f"launches, want {cfg.n_layers}")
        require(bool(torch.isfinite(again).all()),
                "prefill timed run: logits not finite")
    say(f"[main path] qwen prefill launches (each of {QWEN_TIMED_RUNS} timed "
        f"runs): {json.dumps(counts)}")
    med = sorted(secs)[len(secs) // 2]
    report["qwen_prefill"] = dict(seconds=secs, tokens_per_s=b * s / med)
    say(f"[qwen] {gpu} | prefill B {b} x {s}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in secs)
        + f" ms; median {b * s / med:.1f} tokens/s")
    chk_inputs = chk.first
    del params, logits, again

    prompt_len = QWEN_SERVE["prompt_len"]
    stats = {}
    kops.reset_launch_counts()
    with DecodeLogits(pos=prompt_len - 1) as rec:
        out = serve.main(qwen_serve_argv(), stats=stats)
    counts = kops.launch_counts()
    say(f"[main path] qwen serve launches: {json.dumps(counts)} (decode "
        f"attention is the plain trustee island, as in JAX)")
    require(out.shape == (QWEN_SERVE["batch"], QWEN_SERVE["gen"])
            and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
            f"serve tokens: shape {out.shape}, range {out.min()}..{out.max()}")
    require(rec.logits is not None and bool(torch.isfinite(rec.logits)
                                            .all()),
            "serve: no finite decode logits at the last prompt position")
    report["qwen_serve"] = stats
    say(f"[qwen] {gpu} | serve {QWEN_SERVE['batch']} x ({prompt_len} + "
        f"{QWEN_SERVE['gen']}) over {QWEN_SERVE['mesh_model']} trustees: "
        f"{stats['steps']} steps in {stats['seconds']:.3f} s, "
        f"{stats['ms_per_step']:.3f} ms/step, {stats['tokens_per_s']:.1f} "
        f"tokens/s (batch x steps over the loop's wall time)")

    # the serve's weights (seed 0 on the card, as serve.main draws them)
    # through prefill_step on the serve's prompt
    params = M.init_params(cfg, run, dev)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(prompt_len, QWEN_SERVE["batch"])).T
    plan = build_cell(cfg, ShapeConfig("prompt", prompt_len,
                                       QWEN_SERVE["batch"], "prefill"), run)
    pre = plan.step_fn(params, {"tokens": torch.as_tensor(prompt,
                                                          device=dev)})
    agree = logits_agreement(pre, rec.logits, torch.bfloat16)
    require(agree["ok"], f"prefill vs serve decode logits at position "
            f"{prompt_len - 1}: {agree}")
    say(f"[qwen check] prefill logits at position {prompt_len - 1} == the "
        f"serve's decode logits there: relative RMS {agree['rel_rms']:.4g} "
        f"<= {agree['rtol']}, max abs {agree['max_abs']:.4g}, argmax agrees "
        f"on {agree['argmax_agree'] * 100:.1f}% of rows")
    report["qwen_agreement"] = agree
    del params, pre
    return cfg.n_layers, chk_inputs, run


# ---------------------------------------------------------------------------
# phase 7: the deepseek-v2-lite-16b MoE serve path at full width
# ---------------------------------------------------------------------------

# prefill_step at B 4 x 2048 tokens with the experts over T = 4 trustees;
# serve.main over 8 requests, 64 prompt tokens teacher-forced and 64
# generated, the latent cache's sequence and the experts over 4 trustees
DS_ARCH = "deepseek-v2-lite-16b"
DS_PREFILL = dict(batch=4, seq=2048, mesh_model=4)
DS_SERVE = dict(batch=8, prompt_len=64, gen=64, mesh_model=4)
DS_TIMED_RUNS = 2
DS_ABSORB_STEPS = 16


def ds_serve_argv():
    q = DS_SERVE
    return ["--arch", DS_ARCH, "--batch", str(q["batch"]),
            "--prompt-len", str(q["prompt_len"]), "--gen", str(q["gen"]),
            "--mesh-model", str(q["mesh_model"])]


class FirstCalls:
    """Inside the context, keeps copies of the arguments of the first
    ``n`` kernel calls of ``kops.<name>`` (for the times phase) in
    ``calls``; the calls run unchanged."""

    def __init__(self, name, n=1):
        self.name, self.n, self.calls = name, n, []

    def __enter__(self):
        from repro_torch.kernels import ops as kops
        self._kops, self._fn = kops, getattr(kops, self.name)
        setattr(kops, self.name, self._call)
        return self

    def __exit__(self, *exc):
        setattr(self._kops, self.name, self._fn)

    def _call(self, *args, impl="kernel"):
        if len(self.calls) < self.n and impl == "kernel":
            self.calls.append(tuple(a.clone() if hasattr(a, "clone")
                                    else a for a in args))
        return self._fn(*args, impl=impl)


def absorb_agreement(torch, dev, M, cfg, run, params, prompt):
    """Logits of one decode step with mla_absorb on against off, each from
    its own copy of the same cache (the serve's prompt teacher-forced for
    ``DS_ABSORB_STEPS`` steps), held to ``logits_agreement`` in the
    run's activation dtype."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.testing.model import logits_agreement
    q = DS_SERVE
    t = q["mesh_model"]
    max_len = -(-(q["prompt_len"] + q["gen"]) // t) * t
    drun = dataclasses.replace(run, shape=ShapeConfig(
        "decode", max_len, q["batch"], "decode"))
    cache = M.init_cache(cfg, q["batch"], max_len, drun, dev)
    ptok = torch.as_tensor(prompt, device=dev)
    for i in range(DS_ABSORB_STEPS):
        pos = torch.full((q["batch"],), i, dtype=torch.int32, device=dev)
        M.decode_step(params, cache, ptok[:, i], pos, cfg, drun)
    pos = torch.full((q["batch"],), DS_ABSORB_STEPS, dtype=torch.int32,
                     device=dev)
    tok = ptok[:, DS_ABSORB_STEPS]

    def copy(tree):
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [copy(v) for v in tree]
        return tree.clone()
    outs = {}
    for absorb in (False, True):
        outs[absorb], _ = M.decode_step(
            params, copy(cache), tok, pos, cfg,
            dataclasses.replace(drun, mla_absorb=absorb))
    return logits_agreement(outs[True], outs[False],
                            getattr(torch, run.activation_dtype), cfg)


def phase_deepseek(torch, dev, gpu, report, errs):
    """The slice's main path at full width (27 layers: a dense first layer
    and 26 MoE layers of 64 routed experts top-6 plus 2 shared, MLA with
    rank 512, d_model 2048, vocab 102400, bf16; 15.65 B random parameters
    from seed 0 drawn on the card, the serve's own): (a) prefill_step at
    B 4 x 2048 over T = 4 trustees — a check run holding each of its 27
    flash launches (D 192) and 78 grouped-matmul launches against the plain
    versions, then timed runs, each with the counters zeroed just before it
    and read just after; (b) serve.main, 8 x (64 + 64) tokens over 4
    trustees; (c) the prefill's last-position logits on the serve's prompt
    against the serve's decode logits there, the MoE's dropped fractions
    of both beside them; (d) one decode step with mla_absorb on against
    off from the same cache."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.testing.model import (DecodeLogits, FlashCheck,
                                           GmmCheck, MoEStats, PackCheck,
                                           logits_agreement)
    cfg = get_arch(DS_ARCH)
    n_moe = cfg.n_layers - 1
    b, s = DS_PREFILL["batch"], DS_PREFILL["seq"]
    mesh = MeshConfig((1, DS_PREFILL["mesh_model"]), ("data", "model"))
    run = RunConfig(model=cfg, shape=ShapeConfig("prefill", s, b, "prefill"),
                    mesh=mesh, remat="none", use_pallas=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, run, dev)
    torch.cuda.synchronize()
    n_params = M.count_params(params)
    say(f"[deepseek] {cfg.name}: {n_params / 1e9:.3f} B parameters "
        f"({M.active_param_count(cfg, n_params) / 1e9:.3f} B active a "
        f"token) drawn on the card in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated)")
    plan = build_cell(cfg, run.shape, run)
    gen = torch.Generator(device=dev).manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    kops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with FlashCheck() as fchk, GmmCheck() as gchk, PackCheck() as pchk, \
            MoEStats() as moe, FirstCalls("delegation_pack", 2) as packs:
        logits = plan.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
    counts = kops.launch_counts()
    f, g, pk = fchk.summary(), gchk.summary(), pchk.summary()
    require(counts["delegation_pack"] == 2 * n_moe
            and pk["pack_calls"] == 2 * n_moe
            and pk["pack_calls_out_of_tolerance"] == 0,
            f"deepseek prefill check run: {counts['delegation_pack']} pack "
            f"launches, {pk['pack_calls']} checked, "
            f"{pk['pack_calls_out_of_tolerance']} differing from the plain "
            f"version; want {2 * n_moe}, all equal")
    require(counts["flash_attention"] == cfg.n_layers
            and f["flash_calls"] == cfg.n_layers,
            f"deepseek prefill check run: {counts['flash_attention']} flash "
            f"launches, {f['flash_calls']} checked, want {cfg.n_layers}")
    require(counts["grouped_matmul"] == 3 * n_moe
            and g["gmm_calls"] == 3 * n_moe,
            f"deepseek prefill check run: {counts['grouped_matmul']} "
            f"grouped-matmul launches, {g['gmm_calls']} checked, want "
            f"{3 * n_moe}")
    require(f["flash_calls_out_of_tolerance"] == 0
            and g["gmm_calls_out_of_tolerance"] == 0,
            f"deepseek prefill: kernel calls beyond the tolerance: {f} {g}")
    require(tuple(logits.shape) == (b, cfg.vocab_size)
            and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()),
            f"deepseek prefill logits: {tuple(logits.shape)} "
            f"{logits.dtype}, finite {bool(torch.isfinite(logits).all())}")
    errs["flash_attention"] = max(errs.get("flash_attention", 0.0),
                                  f["flash_max_abs_err"])
    errs["grouped_matmul"] = max(errs.get("grouped_matmul", 0.0),
                                 g["gmm_max_abs_err"])
    m = moe.summary()
    say(f"[deepseek check] prefill B {b} x {s} over "
        f"{DS_PREFILL['mesh_model']} trustees: {counts['flash_attention']} "
        f"flash launches (D 192) and {counts['grouped_matmul']} "
        f"grouped-matmul launches at {g['gmm_shapes']}, every call == plain "
        f"over its whole output (max abs err flash "
        f"{f['flash_max_abs_err']:.3g}, grouped matmul "
        f"{g['gmm_max_abs_err']:.3g}); {pk['pack_calls']} pack launches "
        f"at {pk['pack_shapes']}, every call == plain in all six outputs "
        f"(exact); the pack's counts left "
        f"{g['gmm_filled_tiles']} of {g['gmm_tiles']} 128-row tiles of the "
        f"{g['gmm_calls']} launches filled; logits ({b}, {cfg.vocab_size}) f32, "
        f"finite; MoE dropped fraction of tokens mean "
        f"{m['moe_dropped_frac_mean']:.6f}, max "
        f"{m['moe_dropped_frac_max']:.6f} over {m['moe_calls']} layers, max "
        f"load {m['moe_max_load']:.0f} rows; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"launches {json.dumps(counts)}")
    # layer 1's inputs, for the times phase (the weights copied out of
    # the stacked leaf, so the leaf can be freed)
    mla_inputs = fchk.first
    gmm_prefill = (gchk.first[0], gchk.first[1].clone(), gchk.first[2])
    del fchk, gchk, pchk, logits

    secs = []
    for _ in range(DS_TIMED_RUNS):
        kops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = plan.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = kops.launch_counts()
        for k, want in (("flash_attention", cfg.n_layers),
                        ("grouped_matmul", 3 * n_moe),
                        ("delegation_pack", 2 * n_moe)):
            require(counts[k] == want, f"deepseek prefill timed run: "
                    f"{counts[k]} {k} launches, want {want}")
        require(bool(torch.isfinite(again).all()),
                "deepseek prefill timed run: logits not finite")
    say(f"[main path] deepseek prefill launches (each of {DS_TIMED_RUNS} "
        f"timed runs): {json.dumps(counts)}")
    prefill_counts = dict(counts)
    med = sorted(secs)[len(secs) // 2]
    report["deepseek_prefill"] = dict(seconds=secs, tokens_per_s=b * s / med)
    say(f"[deepseek] {gpu} | prefill B {b} x {s}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in secs)
        + f" ms; median {b * s / med:.1f} tokens/s")
    del params, again
    torch.cuda.empty_cache()

    prompt_len = DS_SERVE["prompt_len"]
    stats = {}
    kops.reset_launch_counts()
    with DecodeLogits(pos=prompt_len - 1) as rec, MoEStats() as dec_moe, \
            FirstCalls("grouped_matmul") as first:
        out = serve.main(ds_serve_argv(), stats=stats)
    counts = kops.launch_counts()
    steps = stats["steps"]
    say(f"[main path] deepseek serve launches over {steps} steps: "
        f"{json.dumps(counts)} (decode attention is the plain trustee "
        f"island, as in JAX; the experts run the kernels)")
    require(counts["grouped_matmul"] == 3 * n_moe * steps,
            f"deepseek serve: {counts['grouped_matmul']} grouped-matmul "
            f"launches, want {3 * n_moe * steps}")
    require(out.shape == (DS_SERVE["batch"], DS_SERVE["gen"])
            and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
            f"serve tokens: shape {out.shape}, range {out.min()}..{out.max()}")
    require(rec.logits is not None and bool(torch.isfinite(rec.logits)
                                            .all()),
            "serve: no finite decode logits at the last prompt position")
    report["deepseek_serve"] = stats
    dm = dec_moe.summary()
    say(f"[deepseek] {gpu} | serve {DS_SERVE['batch']} x ({prompt_len} + "
        f"{DS_SERVE['gen']}) over {DS_SERVE['mesh_model']} trustees: "
        f"{steps} steps in {stats['seconds']:.3f} s, "
        f"{stats['ms_per_step']:.3f} ms/step, {stats['tokens_per_s']:.1f} "
        f"tokens/s (batch x steps over the loop's wall time); MoE dropped "
        f"fraction of tokens mean {dm['moe_dropped_frac_mean']:.6f}, max "
        f"{dm['moe_dropped_frac_max']:.6f}")

    # the serve's weights (seed 0 on the card, as serve.main draws them)
    # through prefill_step on the serve's prompt
    params = M.init_params(cfg, run, dev)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(prompt_len, DS_SERVE["batch"])).T
    pplan = build_cell(cfg, ShapeConfig("prompt", prompt_len,
                                        DS_SERVE["batch"], "prefill"), run)
    with MoEStats() as pre_moe:
        pre = pplan.step_fn(params, {"tokens": torch.as_tensor(prompt,
                                                               device=dev)})
    agree = logits_agreement(pre, rec.logits, torch.bfloat16, cfg)
    pm = pre_moe.summary()
    say(f"[deepseek check] prefill logits at position {prompt_len - 1} vs "
        f"the serve's decode logits there: relative RMS "
        f"{agree['rel_rms']:.4g} (<= {agree['rtol']}), max abs "
        f"{agree['max_abs']:.4g}, argmax agrees on "
        f"{agree['argmax_agree'] * 100:.1f}% of rows; MoE dropped fraction "
        f"of tokens: prefill mean {pm['moe_dropped_frac_mean']:.6f} (max "
        f"{pm['moe_dropped_frac_max']:.6f}), serve decode mean "
        f"{dm['moe_dropped_frac_mean']:.6f} (max "
        f"{dm['moe_dropped_frac_max']:.6f})")
    require(agree["ok"], f"deepseek prefill vs serve decode logits at "
            f"position {prompt_len - 1}: {agree}")
    report["deepseek_agreement"] = dict(agree, prefill_dropped=pm,
                                        decode_dropped=dm)

    # one decode step with mla_absorb on against off, from the same cache:
    # in bf16 at full depth, then in f32 (weights drawn in f32 from the
    # same seed) at full depth where they fit on the card, else at 4
    # layers (the dense layer and 3 MoE layers) with bf16 at that depth
    # beside it
    del pre
    ab = absorb_agreement(torch, dev, M, cfg, run, params, prompt)
    say(f"[deepseek check] decode step at position {DS_ABSORB_STEPS} with "
        f"mla_absorb on vs off (the same cache), bf16, {cfg.n_layers} "
        f"layers: relative RMS {ab['rel_rms']:.4g} (<= {ab['rtol']}), max "
        f"abs {ab['max_abs']:.4g}, argmax agrees on "
        f"{ab['argmax_agree'] * 100:.1f}% of rows")
    require(ab["ok"], f"mla_absorb on vs off: {ab}")
    del params
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    fcfg = cfg if 4 * n_params * 1.1 < free else \
        cfg.with_overrides(n_layers=4)
    # the plain path: the grouped-matmul kernel takes bf16 only
    frun = dataclasses.replace(run, model=fcfg, param_dtype="float32",
                               activation_dtype="float32", use_pallas=False)
    params = M.init_params(fcfg, frun, dev)
    ab32 = absorb_agreement(torch, dev, M, fcfg, frun, params, prompt)
    del params
    torch.cuda.empty_cache()
    ab16 = ab
    if fcfg is not cfg:
        crun = dataclasses.replace(run, model=fcfg)
        params = M.init_params(fcfg, crun, dev)
        ab16 = absorb_agreement(torch, dev, M, fcfg, crun, params, prompt)
        del params
        torch.cuda.empty_cache()
    verdict = ("within 1e-4 in f32: the bf16 reading is bf16 rounding"
               if ab32["rel_rms"] <= 1e-4 else
               "beyond 1e-4 in f32: a fault of the absorbed form (ROADMAP "
               "queue C)")
    say(f"[deepseek check] mla_absorb on vs off at {fcfg.n_layers} layers "
        f"({free / 2 ** 30:.1f} GiB free for {4 * n_params / 2 ** 30:.1f} "
        f"GiB of f32 weights at full depth): f32 relative RMS "
        f"{ab32['rel_rms']:.4g}, max abs {ab32['max_abs']:.4g}, argmax "
        f"agrees on {ab32['argmax_agree'] * 100:.1f}% of rows; bf16 "
        f"relative RMS {ab16['rel_rms']:.4g}, argmax on "
        f"{ab16['argmax_agree'] * 100:.1f}%; {verdict}")
    report["deepseek_absorb"] = dict(ab, f32=ab32, f32_layers=fcfg.n_layers,
                                     bf16_at_f32_depth=ab16)
    # the serve's weights again, for the times phase
    params = M.init_params(cfg, run, dev)
    return (prefill_counts, mla_inputs, gmm_prefill, first.calls[0],
            packs.calls, params, run)


def short(name, n=60):
    return name if len(name) <= n else name[:n] + "..."


def phase_qwen_busy(torch, dev, gpu, run):
    """Where the time of the qwen path goes: the device busy share and the
    top device ops of one B 4 x 2048 prefill call, and of 16 decode steps
    of the serve's shape (8 sequences at positions 128-143 of a 256-long
    cache over 4 trustees), from a profiler trace.  The weights (seed 0)
    are drawn again here and freed at the end."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    cfg = run.model
    params = M.init_params(cfg, run, dev)
    b, s = QWEN_PREFILL["batch"], QWEN_PREFILL["seq"]
    plan = build_cell(cfg, ShapeConfig("prefill", s, b, "prefill"), run)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev)
    busy, wall, tops = busy_share(
        torch, lambda: plan.step_fn(params, {"tokens": tokens}), 1, 8)
    say(f"[busy] {gpu} | qwen prefill B {b} x {s}: device busy "
        f"{busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
        f"({100 * busy / wall:.1f}% busy); top device ops: " + "; ".join(
            f"{short(n)} {ms:.3f} ms / {c} calls" for n, ms, c in tops))
    q = QWEN_SERVE
    t = q["mesh_model"]
    max_len = -(-(q["prompt_len"] + q["gen"]) // t) * t
    dplan = build_cell(cfg, ShapeConfig("decode", max_len, q["batch"],
                                        "decode"),
                       dataclasses.replace(run, use_pallas=False))
    cache = M.init_cache(cfg, q["batch"], max_len, dplan.run, dev)
    tok = torch.zeros((q["batch"],), dtype=torch.int32, device=dev)

    def steps():
        nonlocal tok
        for i in range(16):
            pos = torch.full((q["batch"],), q["prompt_len"] + i,
                             dtype=torch.int32, device=dev)
            tok, _ = dplan.step_fn(params, cache, tok, pos)
    busy, wall, tops = busy_share(torch, steps, 1, 8)
    say(f"[busy] {gpu} | qwen decode, 16 steps of B {q['batch']} over "
        f"{q['mesh_model']} trustees: device busy {busy * 1e3:.3f} ms of "
        f"{wall * 1e3:.3f} ms wall ({100 * busy / wall:.1f}% busy, "
        f"{wall * 1e3 / 16:.3f} ms wall a step under the profiler); top "
        f"device ops: " + "; ".join(
            f"{short(n)} {ms:.3f} ms / {c} calls" for n, ms, c in tops))
    del params, cache
    torch.cuda.empty_cache()


def fa_work(q, k, q_offset, causal):
    """(flops, bytes) flash attention must do on these inputs: 4 * D flops
    per (query head, kept query-key pair) — QK^T and PV — and q, k, v read
    once and out written once."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    if causal:
        seen = np.clip(q_offset + np.arange(sq) + 1, 0, skv)
        pairs = int(seen.sum())
    else:
        pairs = sq * skv
    flops = 4 * b * hq * d * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return flops, nbytes


def phase_flash_times(torch, dev, gpu, inputs, launches,
                      label="qwen prefill"):
    """flash_attention at a prefill's own inputs (layer 0's q, k, v of
    the check run, in the model's (B, S, H, D) layout): the median of five
    profiler readings, CUDA events with the host ahead, the bound
    (operations), the plain version and SDPA (timed here only)."""
    from repro_torch.kernels import ops as kops
    q, k, v, q_offset, causal, scale = inputs
    fa = lambda: kops.flash_attention(q, k, v, q_offset, causal, scale)
    ms, lo, hi, seen = device_readings(torch, fa,
                                       KERNEL_NAMES["flash_attention"])
    ev, host, ahead = ahead_ms(torch, fa)
    clk = sm_clock_under(torch, fa, max(1, int(800 / max(ev, 1e-3))))
    plain = yardstick(torch, lambda: kops.flash_attention(
        q, k, v, q_offset, causal, scale, impl="ref"), iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = yardstick(torch, lambda: sdpa(q, k, v, is_causal=causal,
                                        scale=scale, enable_gqa=True))
    flops, nbytes = fa_work(q, k, q_offset or 0, causal)
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    b, hq, sq, d = q.shape
    say(f"[times] {gpu} | flash_attention @ {label} (B {b}, Hq {hq}, "
        f"Hkv {k.shape[1]}, S {sq}, D {d}, causal): {ms:.6f} ms/call (median "
        f"of 5 profiler readings of the kernel, {lo:.6f}..{hi:.6f}, kernel "
        f"records kept per reading of 20 calls {seen}; CUDA events with the "
        f"host {'ahead' if ahead else 'NOT ahead'} {ev:.6f} ms/call, host "
        f"issue {host:.6f} ms/call; SM clock under back-to-back calls, max: "
        f"{clk}), {flops / ms / 1e9:.1f} TFLOP/s; bound {bound:.6f} ms "
        f"(operations {t_ops:.6f} ms for {flops} flops, bytes "
        f"{t_bytes:.6f} ms for {nbytes} bytes); "
        f"{reading('plain', plain, bound)}; "
        f"{reading('library', lib, bound)} (scaled_dot_product_attention, "
        f"is_causal, enable_gqa: the same function); {launches} launches a "
        f"prefill call")
    return ("flash_attention", launches, ms, plain[0], bound, lib[0],
            f"{label}, B {b} x {sq}, D {d}", "operations")


def gmm_work(x, w, counts=None):
    """(flops, bytes) the grouped matmul must do on these inputs: the
    filled slots' products (rows of x that are not all zero: an empty slot
    answers zeros and needs no product), their rows and the weights of
    the experts that have one read once, and the whole (E, C, F) output
    written once, as the contract writes it; and the same counting every
    slot, as torch.bmm computes it.  Also the filled rows, the experts
    with one, and (with ``counts``) the filled 128-row tiles."""
    e, c, d = x.shape
    f = w.shape[2]
    filled = x.ne(0).any(-1)                      # (E, C)
    rows = int(filled.sum())
    experts = int(filled.any(-1).sum())
    need = (2 * rows * d * f,
            2 * (rows * d + experts * d * f + e * c * f))
    dense = (2 * e * c * d * f, 2 * (e * c * d + e * d * f + e * c * f))
    tiles = (int(((counts.long() + 127) // 128).sum()) if counts is not None
             else e * -(-c // 128))
    return need, dense, rows, experts, tiles


def phase_gmm_times(torch, dev, gpu, args, launches, label):
    """grouped_matmul at the main path's own inputs (layer 1's gate
    projection, with the pack's counts): the median of five profiler
    readings, CUDA events with the host ahead, the bound over the filled
    slots (and over every slot beside it), the plain version and torch.bmm
    (timed here only; it multiplies every slot, so its own bound is the
    every-slot one)."""
    from repro_torch.kernels import ops as kops
    x, w, counts = args
    gm = lambda: kops.grouped_matmul(x, w, counts)
    ms, lo, hi, seen = device_readings(torch, gm,
                                       KERNEL_NAMES["grouped_matmul"])
    ev, host, ahead = ahead_ms(torch, gm)
    if ms == 0:                 # the profiler kept no kernel record
        ms = ev
    clk = sm_clock_under(torch, gm, max(1, int(800 / max(ev, 1e-3))))
    plain = yardstick(torch, lambda: kops.grouped_matmul(
        x, w, counts, impl="ref"), iters=5)
    lib = yardstick(torch, lambda: torch.bmm(x, w))
    (flops, nbytes), (dflops, dbytes), rows, experts, tiles = gmm_work(
        x, w, counts)
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    dense = max(dflops / BF16_FLOPS, dbytes / HBM_BYTES_PER_S) * 1e3
    # the plain version multiplies every slot in f32, off the tensor cores
    plain_bound = max(dflops / F32_FLOPS, dbytes / HBM_BYTES_PER_S) * 1e3
    e, c, d = x.shape
    say(f"[times] {gpu} | grouped_matmul @ {label} (E {e}, C {c}, D {d}, F "
        f"{w.shape[2]}; {rows} of {e * c} slots filled, {experts} experts "
        f"with one, {tiles} of {e * -(-c // 128)} 128-row tiles filled): "
        f"{ms:.6f} ms/call (median of 5 profiler readings of the "
        f"kernel, {lo:.6f}..{hi:.6f}, kernel records kept per reading of 20 "
        f"calls {seen}; CUDA events with the host "
        f"{'ahead' if ahead else 'NOT ahead'} {ev:.6f} ms/call, host issue "
        f"{host:.6f} ms/call; SM clock under back-to-back calls, max: "
        f"{clk}), {flops / ms / 1e9:.1f} TFLOP/s over the filled slots; "
        f"bound {bound:.6f} ms by {by} over the filled slots (operations "
        f"{t_ops:.6f} ms for {flops} flops, bytes {t_bytes:.6f} ms for "
        f"{nbytes} bytes; over every slot {dense:.6f} ms, {dflops} flops, "
        f"{dbytes} bytes); {reading('plain', plain, plain_bound)} (f32 "
        f"products of every slot at 67 TFLOP/s); "
        f"{reading('library', lib, dense)} (torch.bmm, bf16, every slot); "
        f"{launches} launches a call of the path")
    return ("grouped_matmul", launches, ms, plain[0], bound, lib[0],
            f"{label}, E {e} x C {c}, D {d}", by)


def phase_ds_pack_times(torch, gpu, packs, counts):
    """delegation_pack at the deepseek prefill's own inputs (layer 1's
    channel pack of the clients' (token, expert) rows, 2,049 words each,
    and the trustees' second-level pack by expert): profiler readings,
    the bound (bytes), the plain version."""
    from repro_torch.kernels import ops as kops
    for label, args in zip(("channel pack", "trustee pack by expert"),
                           packs):
        pk = lambda: kops.delegation_pack(*args)
        ms, lo, hi, seen = device_readings(
            torch, pk, KERNEL_NAMES["delegation_pack"], iters=5,
            per_call=LAUNCHES_PER_CALL["delegation_pack"])
        ev, host, ahead = ahead_ms(torch, pk, iters=5)
        if ms == 0:                 # the profiler kept no kernel record
            ms = ev
        plain = yardstick(torch, lambda: kops.delegation_pack(
            *args, impl="ref"), iters=3)
        nbytes = pack_bytes(torch, args)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        d, r, w = args[1].shape
        say(f"[times] {gpu} | delegation_pack @ deepseek prefill, {label} "
            f"({d} shards x {r} rows of {w} words to {args[2]} "
            f"destinations, capacity {args[3]} + {args[4]}): {ms:.6f} "
            f"ms/call (median of the profiler readings of 5 calls that "
            f"kept records, each the sum of the "
            f"{LAUNCHES_PER_CALL['delegation_pack']} kernels' mean records, "
            f"{lo:.6f}..{hi:.6f}, records kept {seen}; CUDA "
            f"events with the host {'ahead' if ahead else 'NOT ahead'} "
            f"{ev:.6f} ms/call), bound {bound:.6f} ms ({nbytes} bytes), "
            f"{reading('plain', plain, bound)}, library n/a, "
            f"{counts['delegation_pack'] // 2} such launches a prefill call")


def phase_deepseek_busy(torch, dev, gpu, params, run):
    """Where the time of the deepseek prefill goes: the device busy share
    and the top device ops of one B 4 x 2048 call over 4 trustees, from a
    profiler trace."""
    from repro_torch.launch.steps import build_cell
    cfg = run.model
    b, s = DS_PREFILL["batch"], DS_PREFILL["seq"]
    plan = build_cell(cfg, run.shape, run)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev)
    busy, wall, tops = busy_share(
        torch, lambda: plan.step_fn(params, {"tokens": tokens}), 1, 10)
    say(f"[busy] {gpu} | deepseek prefill B {b} x {s} over "
        f"{DS_PREFILL['mesh_model']} trustees: device busy "
        f"{busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
        f"({100 * busy / wall:.1f}% busy); top device ops: " + "; ".join(
            f"{short(n)} {ms:.3f} ms / {c} calls" for n, ms, c in tops))


# ---------------------------------------------------------------------------
# phase 2, Mamba: the selective-scan kernel against its plain version
# ---------------------------------------------------------------------------

# the falcon-mamba-7b prefill's scan: B 4 x 2048 tokens, d_inner 8192, N 16
SCAN_PREFILL = dict(b=4, s=2048, di=8192, n=16)
SFU_EXP_PER_CLOCK = 16          # ex2 results a clock per SM (MUFU)
SM_COUNT = 132                  # H100 SXM
F32_FLOPS = 67e12               # H100 SXM f32, outside the tensor cores
F32_LANES_PER_CLOCK = 128       # f32 instructions (FFMA, FMUL) a clock per SM
# the scan's f32 instructions per (b, t, channel, state) besides its exp:
# dt * a, (dt x) * B, the update's FFMA and C's FFMA
SCAN_F32_INSTR = 4
# f32 instructions of an exponential computed as a polynomial on the f32
# pipes (exp2: range reduction 2, a degree-3 Horner 3, the exponent's
# scale 1) — an assumed count, not measured
POLY_EXP_INSTR = 6
SCHEDULERS_PER_SM = 4           # each issues one warp instruction a clock


def sass_loop(lib_path, must):
    """(instructions, MUFU instructions) of the innermost loop (the
    shortest backward branch's body) holding MUFU instructions in the
    first function of the library whose mangled name holds every string
    of ``must``, from cuobjdump's SASS; None where cuobjdump or the
    function is missing."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if not all(m in func.split("\n", 1)[0] for m in must):
            continue
        code = []               # (address, opcode, operands) in order
        for line in func.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)(.*)", line)
            if m:
                code.append((int(m.group(1), 16), m.group(2), m.group(3)))
        best = None
        for at, op, rest in code:
            b = re.match(r"\s+(0x[0-9a-f]+)", rest) if op == "BRA" else None
            if b is None or int(b.group(1), 16) >= at:
                continue
            body = [o for a, o, _ in code if int(b.group(1), 16) <= a <= at]
            mufu = sum(o.startswith("MUFU") for o in body)
            if mufu and (best is None or len(body) < best[0]):
                best = (len(body), mufu)
        return best
    return None


def scan_case(torch, dev, b, s, di, n, dtype, seed, h0=False):
    """Inputs at the model's own scales: x ~ N(0, 1); dt = softplus of
    N(log(expm1(0.01)), 2), the initial dt bias with a spread the random
    projections give it (dt from about 1e-4 to 1); S4D-real
    a = -(1 .. N) per channel times U(0.5, 1.5); b, c ~ N(0, 1);
    d ~ 1 + N(0, 0.1^2); h0 ~ N(0, 1) when asked for."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *sh: torch.randn(sh, generator=g, device=dev)
    dt = torch.nn.functional.softplus(r(b, s, di) * 2 - 4.6)
    a = -torch.arange(1, n + 1, device=dev, dtype=torch.float32) \
        * torch.rand((di, 1), generator=g, device=dev).add_(0.5)
    return (r(b, s, di).to(dtype), dt.to(dtype), a, r(b, s, n), r(b, s, n),
            1 + 0.1 * r(di), r(b, di, n) if h0 else None)


def phase_scan_kernels(torch, dev, errs):
    """selective_scan against its plain version within
    ``kernels/selective_scan.py::tolerance``: the falcon-mamba-7b
    prefill's shape in bf16 and f32, from h0, a chunk carry (two launches
    over the halves, the second from the first's h_final, against one),
    ragged S and DI, S = 1 with N 4, N 8, dt = 0, a decay that underflows
    to 0; f16 and N past the kernel's maximum refused."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.selective_scan import MAX_STATE, tolerance
    from repro_torch.testing.model import scan_within
    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        ("prefill shape, bf16", dict(SCAN_PREFILL, dtype=bf), True),
        ("prefill shape, f32", dict(SCAN_PREFILL, dtype=f32), False),
        ("prefill shape, bf16, from h0", dict(SCAN_PREFILL, dtype=bf,
                                              h0=True), False),
        ("ragged S 333, DI 200", dict(b=2, s=333, di=200, n=16, dtype=bf,
                                      h0=True), False),
        ("S 1, B 1, N 4", dict(b=1, s=1, di=256, n=4, dtype=f32), False),
        ("N 8", dict(b=2, s=256, di=1024, n=8, dtype=bf, h0=True), False),
    ]
    errs["selective_scan"] = 0.0
    for i, (label, shape, main) in enumerate(cases):
        args = scan_case(torch, dev, seed=130 + i, **shape)
        got = kops.selective_scan(*args)
        torch.cuda.synchronize()
        want = kops.selective_scan(*args, impl="ref")
        ok, err = scan_within(got, want, args)
        require(ok, f"selective_scan [{label}]: max abs err {err} beyond "
                f"the tolerance")
        if main:
            errs["selective_scan"] = err
        say(f"[kernels] selective_scan [{label}] == plain (max abs err "
            f"{err:.3g})")

    # a chunk carry: the halves, the second from the first's h_final
    x, dt, a, b, c, d, h0 = args = scan_case(torch, dev, seed=140, h0=True,
                                             **dict(SCAN_PREFILL, dtype=f32))
    y, h = kops.selective_scan(*args)
    half = SCAN_PREFILL["s"] // 2
    first, second = slice(0, half), slice(half, None)
    y1, h1 = kops.selective_scan(x[:, first], dt[:, first], a, b[:, first],
                                 c[:, first], d, h0)
    y2, h2 = kops.selective_scan(x[:, second], dt[:, second], a,
                                 b[:, second], c[:, second], d, h1)
    torch.cuda.synchronize()
    _, atol_y, atol_h = tolerance(*args)
    err_y = (torch.cat([y1, y2], 1) - y).abs()
    err_h = (h2 - h).abs()
    require(bool((err_y <= atol_y).all()) and bool((err_h <= atol_h).all()),
            f"selective_scan chunk carry: max abs err {float(err_y.max())} "
            f"/ {float(err_h.max())} beyond the tolerance")
    say(f"[kernels] selective_scan [two launches over the halves == one "
        f"launch] (f32, max abs err y {float(err_y.max()):.3g}, h_final "
        f"{float(err_h.max()):.3g})")

    x, dt, a, b, c, d, h0 = scan_case(torch, dev, 2, 96, 256, 16, f32, 150,
                                      h0=True)
    for label, args in (
            ("dt = 0", (x, torch.zeros_like(dt), a, b, c, d, h0)),
            ("dt * a below -5000: the decay underflows to 0",
             (x, torch.full_like(dt, 100.0), a * 100, b, c, d, h0))):
        got = kops.selective_scan(*args)
        torch.cuda.synchronize()
        ok, err = scan_within(got, kops.selective_scan(*args, impl="ref"),
                              args)
        require(ok and bool(torch.isfinite(got[0]).all()),
                f"selective_scan [{label}]: max abs err {err}")
        if label == "dt = 0":
            require(torch.equal(got[1], h0), "selective_scan [dt = 0]: "
                    "the state moved")
        say(f"[kernels] selective_scan [{label}] == plain (f32, max abs err "
            f"{err:.3g})")
    for label, args, exc in (
            ("float16", (x.half(), dt.half(), a, b, c, d), TypeError),
            (f"N {MAX_STATE + 1}",
             scan_case(torch, dev, 1, 8, 64, MAX_STATE + 1, f32, 151),
             ValueError)):
        try:
            kops.selective_scan(*args)
        except exc as e:
            say(f"[kernels] selective_scan refuses {label}: {e}")
        else:
            raise AssertionError(f"selective_scan accepted {label}")


# ---------------------------------------------------------------------------
# phase 8: the falcon-mamba-7b serve path at full width
# ---------------------------------------------------------------------------

FM_ARCH = "falcon-mamba-7b"
FM_PREFILL = dict(batch=4, seq=2048)
FM_SERVE = dict(batch=8, prompt_len=128, gen=128)
FM_TIMED_RUNS = 3
# weight and prompt seeds besides the serve's own 0 at which the bf16
# prefill-vs-decode agreement is read and held to the same bound
FM_AGREE_SEEDS = (1, 2, 3)


def fm_serve_argv():
    q = FM_SERVE
    return ["--arch", FM_ARCH, "--batch", str(q["batch"]),
            "--prompt-len", str(q["prompt_len"]), "--gen", str(q["gen"])]


def fm_decode_logits(torch, M, cfg, params, run, tokens, dev):
    """The logits at the last position of ``tokens`` (B, L) teacher-forced
    through ``decode_step`` one position at a time from an empty cache."""
    from repro_torch.configs.base import ShapeConfig
    bsz, n = tokens.shape
    drun = dataclasses.replace(run, shape=ShapeConfig("decode", n, bsz,
                                                      "decode"))
    cache = M.init_cache(cfg, bsz, n, drun, dev)
    for i in range(n):
        pos = torch.full((bsz,), i, dtype=torch.int32, device=dev)
        logits, cache = M.decode_step(params, cache, tokens[:, i], pos, cfg,
                                      drun)
    return logits


def phase_falcon(torch, dev, gpu, report, errs, busy=False):
    """The slice's main path at full width and depth (64 Mamba-1 layers,
    d_model 4096, d_inner 8192, dt_rank 256, N 16, d_conv 4, vocab 65024,
    bf16; 7.27 B random parameters from seed 0 drawn on the card, the
    serve's own, after phase 7's weights are freed): (a) prefill_step at
    B 4 x 2048 — a check run holding each of its 64 selective-scan
    launches against the plain version, then timed runs, each with the
    counters zeroed just before it and 64 scan launches read just after;
    (b) serve.main, 8 x (128 + 128) tokens with the Mamba state cache
    (the decode's step is the plain recurrence, as in JAX: no kernel);
    (c) the prefill's last-position logits on the serve's prompt against
    the serve's decode logits there, in bf16 — and at the weight and
    prompt seeds ``FM_AGREE_SEEDS`` against a teacher-forced decode — and,
    on the f32 weights the bf16 ones are rounded from, in f32, with each
    bf16 path's distance from the f32 logits and the kernel prefill's from
    the plain one; with
    ``busy``, (d) the device busy share and top device ops of one prefill
    call."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.testing.model import (DecodeLogits, ScanCheck,
                                           logits_agreement)
    cfg = get_arch(FM_ARCH)
    b, s = FM_PREFILL["batch"], FM_PREFILL["seq"]
    run = RunConfig(model=cfg, shape=ShapeConfig("prefill", s, b, "prefill"),
                    remat="none", use_pallas=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, run, dev)
    torch.cuda.synchronize()
    n_params = M.count_params(params)
    say(f"[falcon] {cfg.name}: {n_params / 1e9:.3f} B parameters drawn on "
        f"the card in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated)")
    plan = build_cell(cfg, run.shape, run)
    gen = torch.Generator(device=dev).manual_seed(19)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    kops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with ScanCheck() as chk:
        logits = plan.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
    counts = kops.launch_counts()
    c = chk.summary()
    require(counts["selective_scan"] == cfg.n_layers
            and c["scan_calls"] == cfg.n_layers,
            f"falcon prefill check run: {counts['selective_scan']} scan "
            f"launches, {c['scan_calls']} checked, want {cfg.n_layers}")
    require(c["scan_calls_out_of_tolerance"] == 0,
            f"falcon prefill: {c['scan_calls_out_of_tolerance']} scan calls "
            f"beyond the tolerance (max abs err {c['scan_max_abs_err']})")
    require(tuple(logits.shape) == (b, cfg.vocab_size)
            and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()),
            f"falcon prefill logits: {tuple(logits.shape)} {logits.dtype}, "
            f"finite {bool(torch.isfinite(logits).all())}")
    errs["selective_scan"] = max(errs.get("selective_scan", 0.0),
                                 c["scan_max_abs_err"])
    say(f"[falcon check] prefill B {b} x {s}: {counts['selective_scan']} "
        f"scan launches at {c['scan_shapes']}, every call == plain (max abs "
        f"err {c['scan_max_abs_err']:.3g}); logits ({b}, {cfg.vocab_size}) "
        f"f32, finite; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    scan_inputs = chk.first
    del chk, logits

    secs = []
    for _ in range(FM_TIMED_RUNS):
        kops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = plan.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = kops.launch_counts()
        require(counts["selective_scan"] == cfg.n_layers,
                f"falcon prefill timed run: {counts['selective_scan']} scan "
                f"launches, want {cfg.n_layers}")
        require(bool(torch.isfinite(again).all()),
                "falcon prefill timed run: logits not finite")
    say(f"[main path] falcon prefill launches (each of {FM_TIMED_RUNS} timed "
        f"runs): {json.dumps(counts)}")
    prefill_counts = dict(counts)
    med = sorted(secs)[len(secs) // 2]
    report["falcon_prefill"] = dict(seconds=secs, tokens_per_s=b * s / med)
    say(f"[falcon] {gpu} | prefill B {b} x {s}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in secs)
        + f" ms; median {b * s / med:.1f} tokens/s")
    del params, again
    torch.cuda.empty_cache()

    prompt_len = FM_SERVE["prompt_len"]
    stats = {}
    kops.reset_launch_counts()
    with DecodeLogits(pos=prompt_len - 1) as rec:
        out = serve.main(fm_serve_argv(), stats=stats)
    counts = kops.launch_counts()
    say(f"[main path] falcon serve launches over {stats['steps']} steps: "
        f"{json.dumps(counts)} (the Mamba decode step is the plain "
        f"recurrence, as in JAX: no kernel)")
    require(out.shape == (FM_SERVE["batch"], FM_SERVE["gen"])
            and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
            f"serve tokens: shape {out.shape}, range {out.min()}..{out.max()}")
    require(rec.logits is not None and bool(torch.isfinite(rec.logits)
                                            .all()),
            "serve: no finite decode logits at the last prompt position")
    report["falcon_serve"] = stats
    say(f"[falcon] {gpu} | serve {FM_SERVE['batch']} x ({prompt_len} + "
        f"{FM_SERVE['gen']}), the Mamba (conv, ssm) state cache: "
        f"{stats['steps']} steps in {stats['seconds']:.3f} s, "
        f"{stats['ms_per_step']:.3f} ms/step, {stats['tokens_per_s']:.1f} "
        f"tokens/s (batch x steps over the loop's wall time)")

    # the serve's weights (seed 0 on the card, as serve.main draws them)
    # through prefill_step on the serve's prompt
    params = M.init_params(cfg, run, dev)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(prompt_len, FM_SERVE["batch"])).T
    pplan = build_cell(cfg, ShapeConfig("prompt", prompt_len,
                                        FM_SERVE["batch"], "prefill"), run)
    pre = pplan.step_fn(params, {"tokens": torch.as_tensor(prompt,
                                                           device=dev)})
    plain = build_cell(cfg, pplan.shape, dataclasses.replace(
        run, use_pallas=False)).step_fn(
            params, {"tokens": torch.as_tensor(prompt, device=dev)})
    agree = logits_agreement(pre, rec.logits, torch.bfloat16, cfg)
    say(f"[falcon check] prefill logits (the scan kernel) at position "
        f"{prompt_len - 1} vs the serve's decode logits there (the plain "
        f"step): relative RMS {agree['rel_rms']:.4g} (<= {agree['rtol']}), "
        f"max abs {agree['max_abs']:.4g}, argmax agrees on "
        f"{agree['argmax_agree'] * 100:.1f}% of rows")
    if busy:
        bt = torch.randint(0, cfg.vocab_size, (b, s), device=dev)
        sec, wall, tops = busy_share(
            torch, lambda: plan.step_fn(params, {"tokens": bt}), 1, 10)
        say(f"[busy] {gpu} | falcon prefill B {b} x {s}: device busy "
            f"{sec * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
            f"({100 * sec / wall:.1f}% busy); top device ops: " + "; ".join(
                f"{short(n)} {ms:.3f} ms / {c} calls" for n, ms, c in tops))
    del params
    torch.cuda.empty_cache()

    # the same bf16 agreement at other weight and prompt seeds: the
    # prefill (the scan kernel) against the serve's decode step
    # teacher-forced through the prompt, each held to the same bound
    sweep = {0: agree}
    for seed in FM_AGREE_SEEDS:
        srun = dataclasses.replace(run, seed=seed)
        sparams = M.init_params(cfg, srun, dev)
        stok = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, size=(FM_SERVE["batch"], prompt_len)),
            device=dev)
        spre = pplan.step_fn(sparams, {"tokens": stok})
        sdec = fm_decode_logits(torch, M, cfg, sparams, srun, stok, dev)
        sweep[seed] = logits_agreement(spre, sdec, torch.bfloat16, cfg)
        del sparams, spre, sdec
        torch.cuda.empty_cache()
    say(f"[falcon check] bf16 prefill vs teacher-forced decode at position "
        f"{prompt_len - 1}, by weight and prompt seed (0: the serve's): "
        + ", ".join(f"seed {k} relative RMS {v['rel_rms']:.4g} argmax "
                    f"{v['argmax_agree'] * 100:.1f}%"
                    for k, v in sweep.items())
        + f"; largest {max(v['rel_rms'] for v in sweep.values()):.4g} "
        f"(<= {agree['rtol']})")

    # the same comparison in f32, on the f32 weights the bf16 ones are
    # rounded from (the same seed): the math without bf16 rounding, and
    # how far each bf16 path lies from it
    frun = dataclasses.replace(run, param_dtype="float32",
                               activation_dtype="float32")
    fparams = M.init_params(cfg, frun, dev)
    ptok = torch.as_tensor(prompt, device=dev)
    pre32 = build_cell(cfg, pplan.shape, frun).step_fn(fparams,
                                                       {"tokens": ptok})
    dec32 = fm_decode_logits(torch, M, cfg, fparams, frun, ptok, dev)
    del fparams
    torch.cuda.empty_cache()
    agree32 = logits_agreement(pre32, dec32, torch.float32, cfg)
    rel = lambda u, v: float((u.float() - v.float()).norm() / v.norm())
    far = {"prefill_bf16_vs_f32": rel(pre, pre32),
           "decode_bf16_vs_f32": rel(rec.logits, dec32),
           "prefill_kernel_vs_plain_bf16": rel(pre, plain)}
    say(f"[falcon check] in f32 (weights drawn in f32 from the same seed): "
        f"prefill (the scan kernel) vs a teacher-forced decode at position "
        f"{prompt_len - 1}: relative RMS {agree32['rel_rms']:.4g} (<= "
        f"{agree32['rtol']}), argmax agrees on "
        f"{agree32['argmax_agree'] * 100:.1f}% of rows; relative RMS from "
        f"the f32 logits: bf16 prefill {far['prefill_bf16_vs_f32']:.4g}, "
        f"bf16 serve decode {far['decode_bf16_vs_f32']:.4g}; bf16 prefill "
        f"through the kernel vs through the plain scan "
        f"{far['prefill_kernel_vs_plain_bf16']:.4g}")
    require(agree32["ok"], f"falcon prefill vs decode logits in f32 at "
            f"position {prompt_len - 1}: {agree32}")
    for k, v in sweep.items():
        require(v["ok"], f"falcon prefill vs decode logits in bf16 at "
                f"seed {k}, position {prompt_len - 1}: {v}")
    report["falcon_agreement"] = dict(agree, f32=agree32, **far, by_seed={
        k: v["rel_rms"] for k, v in sweep.items()})
    del pre, plain, pre32, dec32
    return prefill_counts, scan_inputs


def scan_work(x, a):
    """(exponentials, f32 flops, bytes) the scan must do on these inputs:
    one exp(dt * a) and 6 flops per (b, t, channel, state) — dt * a,
    dt x * B, the update's multiply-add and C's multiply-add — and 3 per
    (b, t, channel) — dt * x and D * x added; x, dt, a, b, c, d (and h0)
    read once, y and h_final written once."""
    bsz, s, di = x.shape
    n = a.shape[1]
    exps = bsz * s * di * n
    flops = 6 * exps + 3 * bsz * s * di
    item = x.element_size()
    nbytes = (3 * bsz * s * di * item + 4 * (di * n + 2 * bsz * s * n + di)
              + 4 * bsz * di * n)
    return exps, flops, nbytes


def phase_scan_times(torch, dev, gpu, inputs, launches):
    """selective_scan at the falcon prefill's own inputs (layer 0's x, dt,
    a, b, c, d of the check run): the median of five profiler readings,
    CUDA events with the host ahead, the SM clock under back-to-back
    calls, the bound (the larger of bytes over 3.35 TB/s, f32 flops over
    67 TFLOP/s and exponentials over the SFU's 16 a clock per SM at that
    clock), the floor with the exponentials shared between the SFU and
    the f32 pipes, the plain version."""
    from repro_torch.kernels import ops as kops
    sc = lambda: kops.selective_scan(*inputs)
    ms, lo, hi, seen = device_readings(torch, sc,
                                       KERNEL_NAMES["selective_scan"])
    ev, host, ahead = ahead_ms(torch, sc)
    if ms == 0:                 # the profiler kept no kernel record
        ms = ev
    clk = sm_clock_under(torch, sc, max(1, int(800 / max(ev, 1e-3))))
    mhz = float(clk.split(",")[0].split()[0])
    plain = yardstick(torch, lambda: kops.selective_scan(*inputs,
                                                         impl="ref"),
                      iters=2)
    exps, flops, nbytes = scan_work(inputs[0], inputs[2])
    t_exp = exps / (SFU_EXP_PER_CLOCK * SM_COUNT * mhz * 1e6) * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_exp, t_ops, t_bytes)
    by = {t_exp: "exponentials", t_ops: "f32 flops",
          t_bytes: "bytes"}[bound]
    # the SFU-only bound above leaves the f32 pipes part idle: a share f
    # of the exponentials computed as polynomials there balances the two
    # units where (1 - f) / SFU = (SCAN_F32_INSTR + POLY_EXP_INSTR f) / F32
    r_s, r_f = SFU_EXP_PER_CLOCK, F32_LANES_PER_CLOCK
    share = (r_f - SCAN_F32_INSTR * r_s) / (r_f + POLY_EXP_INSTR * r_s)
    t_mixed = max(t_exp * (1 - share), t_bytes)
    # the schedulers' floor for the inner loop as compiled: its warp
    # instructions per exponential, one issued a clock per scheduler
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import scan_plan
    lanes, _ = scan_plan(inputs[2].shape[1])
    loop = sass_loop(_build._lib_path("selective_scan.cu"),
                     ("selective_scan_kernel", "nv_bfloat16",
                      f"Li{lanes}EE"))
    if loop is None:
        issue = "the inner loop's issue floor not measured (no cuobjdump)"
    else:
        t_issue = (exps / 32 * loop[0] / loop[1]
                   / (SCHEDULERS_PER_SM * SM_COUNT * mhz * 1e6) * 1e3)
        issue = (f"the inner loop issues {loop[0]} instructions for "
                 f"{loop[1]} exponentials a thread (SASS): the schedulers' "
                 f"issue floor {t_issue:.6f} ms")
    bsz, s, di = inputs[0].shape
    say(f"[times] {gpu} | selective_scan @ falcon prefill (B {bsz}, S {s}, "
        f"DI {di}, N {inputs[2].shape[1]}, {inputs[0].dtype}): {ms:.6f} "
        f"ms/call (median of 5 profiler readings of the kernel, "
        f"{lo:.6f}..{hi:.6f}, kernel records kept per reading of 20 calls "
        f"{seen}; CUDA events with the host "
        f"{'ahead' if ahead else 'NOT ahead'} {ev:.6f} ms/call, host issue "
        f"{host:.6f} ms/call; SM clock under back-to-back calls, max: "
        f"{clk}), {exps / ms / 1e9:.3f} T exponentials/s; "
        f"{reading('plain', plain, bound)}, bound {bound:.6f} ms by {by} "
        f"(exponentials "
        f"{t_exp:.6f} ms for {exps} at {SFU_EXP_PER_CLOCK} a clock on "
        f"{SM_COUNT} SMs at {mhz:.0f} MHz, f32 flops {t_ops:.6f} ms for "
        f"{flops}, bytes {t_bytes:.6f} ms for {nbytes}; the SFU and the "
        f"f32 pipes together, {share * 100:.1f}% of the exponentials as "
        f"{POLY_EXP_INSTR}-instruction polynomials beside "
        f"{SCAN_F32_INSTR} f32 instructions an element: {t_mixed:.6f} ms; "
        f"{issue}), library n/a: no "
        f"PyTorch call computes the recurrence, {launches} launches a "
        f"prefill call")
    return ("selective_scan", launches, ms, plain[0], bound, None,
            f"falcon prefill, B {bsz} x {s}, DI {di}",
            "bytes" if by == "bytes" else "operations")


def pt_bytes(op, state, args):
    """What one op pass needs: the state read once and written once, every
    row's valid byte, the valid rows' seq (and arg, for alloc and append)
    and their responses (MP pages, page, n, flag).  The rows that are not
    valid cost their valid byte only."""
    from repro_torch.kernels.ref import PT_OPS
    seq, arg, valid = args[:3]
    n = int(valid.sum())
    mp = state["chains"].shape[-1]
    st = sum(v.numel() for v in state.values())
    reads_arg = op in (PT_OPS["alloc"], PT_OPS["append"])
    return 2 * 4 * st + valid.numel() + 4 * n * (1 + reads_arg) \
        + 4 * n * (mp + 3)


def pa_bytes(q, k, lengths):
    """Live K and V pages of every (sequence, KV head) once, q and out."""
    _, hkv, ps, d = k.shape
    live = int(((lengths.long() + ps - 1) // ps).sum())
    return 2 * live * hkv * ps * d * k.element_size() \
        + 2 * q.numel() * q.element_size()


def phase_paged_times(torch, dev, gpu, rec, waves, counts, inputs):
    """The paged kernels at the main path's own inputs (recorded in the
    check run): device time, plain time, bound, and for attention the
    library yardstick; then the device busy share of paged waves."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import split_plan
    rows = []
    # pagetable_serve: the append pass with the most rows (it carries the
    # allocation path); every call restores the pass's entry state first.
    # The kernel's own time comes from the profiler's kernel events (the
    # restore's copies are not among them); the plain version's is all its
    # device work, the restore timed alone and subtracted
    op, (n, before, args, out, _) = 1, rec.passes[1]
    work = {k: v.clone() for k, v in before.items()}

    def restore():
        for k in PT_STATE:
            work[k].copy_(before[k])
    st = [work[k] for k in PT_STATE]
    ms, lo, hi, seen = device_readings(
        torch, lambda: (restore(), kops.pagetable_serve(op, work, *args)),
        KERNEL_NAMES["pagetable_serve"])
    nbytes = pt_bytes(op, before, args)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    # the latency floor beside the byte bound: a kernel that does nothing,
    # launched on the same grid, block and shared memory
    from repro_torch.kernels import pagetable_serve as kpt
    pl, (sl, mp) = before["used"].shape[1], before["chains"].shape[1:]
    smem = kpt.smem_bytes(pl, sl, mp)
    floor, f_lo, f_hi, f_seen = device_readings(
        torch, lambda: kpt.empty_launch(args[3], smem, dev),
        "pagetable_empty_kernel")
    ms_restore = yardstick(torch, restore)
    plain_r = yardstick(torch, lambda: (restore(), ref.pagetable_serve(
        op, *st, *args)), iters=5)
    # the plain reading less the restore's own
    plain_r = (plain_r[0] - ms_restore[0], plain_r[1] - ms_restore[1]) \
        + plain_r[2:]
    plain = plain_r[0]
    t0 = time.perf_counter()
    for _ in range(3):
        restore()
        ref.pagetable_serve(op, *st, *args)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / 3 * 1e3
    t_, n_rows = args[0].shape
    say(f"[times] {gpu} | pagetable_serve @ paged decode (append pass, "
        f"{n} valid of {t_} x {n_rows} received rows): {ms:.6f} ms/launch "
        f"(median of 5 profiler readings of the kernel, {lo:.6f}..{hi:.6f},"
        f" kernel records kept per reading of 20 calls {seen}), bound "
        f"{bound:.6f} ms ({nbytes} bytes), latency floor {floor:.6f} ms "
        f"(an empty kernel on the same {args[3]} blocks of 256 threads "
        f"and {smem} bytes of shared memory, median of 5 profiler readings "
        f"{f_lo:.6f}..{f_hi:.6f}, records kept {f_seen}; the serve "
        f"{ms - floor:.6f} ms above it), "
        f"{reading('plain', plain_r, bound)} less the state's restore, "
        f"{plain_wall:.3f} ms wall, library n/a, "
        f"{counts['pagetable_serve'] / waves:.3f} launches/wave")
    rows.append(("pagetable_serve", counts["pagetable_serve"], ms, plain,
                 bound, None, "paged decode, append pass"))

    # paged_attention: the decode call with the most live pages.  Device
    # time as the median of five profiler readings (their spread beside
    # it), the same with the L2 flushed before every call (a 256 MiB fill:
    # the call's live K/V fit in the 50 MB L2 when calls run back to back),
    # and CUDA events with the host ahead of the card
    q, k, v, tbl, lengths = rec.attention
    pa = lambda: kops.paged_attention(q, k, v, tbl, lengths)
    ms, lo, hi, seen = device_readings(torch, pa,
                                       KERNEL_NAMES["paged_attention"])
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    cold, cold_lo, cold_hi, _ = device_readings(
        torch, lambda: (flush.zero_(), pa()),
        KERNEL_NAMES["paged_attention"])
    del flush
    ev, host, ahead = ahead_ms(torch, pa)
    if ms == 0:                 # the profiler kept no kernel record
        ms = ev
    # the SM clock while the card runs some 0.8 s of back-to-back calls
    clk = sm_clock_under(torch, pa, max(1, int(800 / max(ev, 1e-3))))
    plain = yardstick(torch, lambda: kops.paged_attention(
        q, k, v, tbl, lengths, impl="ref"), iters=5)
    # library yardstick (timed here only; the port never calls it):
    # scaled_dot_product_attention over the already-gathered dense K/V of
    # the same live lengths; it excludes the gather
    b, hq, d = q.shape
    _, hkv, ps, _ = k.shape
    split = split_plan(tbl.shape[1])[0]
    lmax = int(lengths.max())
    mp_live = -(-lmax // ps)
    safe = tbl[:, :mp_live].clamp(min=0).long()
    kd = k[safe].transpose(1, 2).reshape(b, hkv, mp_live * ps, d)
    vd = v[safe].transpose(1, 2).reshape(b, hkv, mp_live * ps, d)
    mask = (torch.arange(mp_live * ps, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = yardstick(torch, lambda: sdpa(q4, kd, vd, attn_mask=mask,
                                        enable_gqa=True))
    nbytes = pa_bytes(q, k, lengths)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    # SDPA's own work: the gathered K / V (every sequence padded to the
    # longest), q, the mask and the output
    lib_bytes = (kd.numel() + vd.numel() + 2 * q.numel()) * q.element_size() \
        + mask.numel()
    lib_bound = lib_bytes / HBM_BYTES_PER_S * 1e3
    say(f"[times] {gpu} | paged_attention @ paged decode (B={b}, "
        f"{int(lengths.sum())} live positions, lengths "
        f"{int(lengths.min())}..{lmax}): {ms:.6f} ms/call (median of 5 "
        f"profiler readings of the kernel, {lo:.6f}..{hi:.6f}, kernel "
        f"records kept per reading of 20 calls {seen}; L2 flushed "
        f"before each call {cold:.6f}, {cold_lo:.6f}..{cold_hi:.6f}; CUDA "
        f"events with the host ahead {ev:.6f} ms/call, host issue "
        f"{host:.6f} ms/call, host {'ahead' if ahead else 'NOT ahead'}; SM "
        f"clock under back-to-back calls, max: {clk}; {split} pages a "
        f"split), bound {bound:.6f} ms ({nbytes} bytes; "
        f"{100 * bound / ms:.1f}% of it, "
        f"{f'{100 * bound / cold:.1f}%' if cold else 'not measured'} with "
        f"the L2 flushed), {reading('plain', plain, bound)}, "
        f"{reading('library', lib, lib_bound)} (scaled_dot_product_attention"
        f" over the gathered dense K/V, excludes the gather; its own bound "
        f"counts the padded K/V), {counts['paged_attention'] / waves:.3f} "
        f"calls/wave")
    rows.append(("paged_attention", counts["paged_attention"], ms, plain[0],
                 bound, lib[0], "paged decode, largest decode call"))

    busy, wall, tops = busy_share(
        torch, lambda: paged_run(torch, dev, inputs, n_requests=32), 1, 12)
    say(f"[busy] {gpu} | paged decode (32 requests): " + (
        f"device busy {busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
        f"({100 * busy / wall:.1f}% busy); top device ops: " + "; ".join(
            f"{n} {ms:.3f} ms / {c} calls" for n, ms, c in tops)
        if busy > 0 else "device busy share not measured (the profiler "
                         "recorded no device activity)"))
    return rows


def kernel_info(torch, n_dev):
    """Registers, spills, shared memory and resident warps of the
    page-table serve and the selective scan at the main paths' shapes, as
    built (cudaFuncGetAttributes and the occupancy calculator; ptxas -v
    reports the same registers)."""
    from repro_torch.kernels import pagetable_serve as kpt
    from repro_torch.kernels import selective_scan as kss
    pl = -(-PAGED["n_pages"] // n_dev)
    sl = -(-PAGED["max_seqs"] // n_dev)
    i = kpt.kernel_info(pl, sl, PAGED["max_pages"])
    say(f"[build] pagetable_serve at the paged decode's trustee (PL {pl}, "
        f"SL {sl}, MP {PAGED['max_pages']}): {i['registers']} registers, "
        f"{i['local_bytes']} bytes local (spills), {i['smem']} bytes of "
        f"shared memory, one block of {i['warps_a_block']} warps a trustee "
        f"({n_dev} blocks; at most {i['blocks_per_sm']} an SM)")
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        i = kss.kernel_info(dtype, SCAN_PREFILL["n"])
        blocks = SCAN_PREFILL["b"] * -(-SCAN_PREFILL["di"] * i["lanes"]
                                       // (32 * i["warps_a_block"]))
        warps = min(i["blocks_per_sm"], blocks / sm) * i["warps_a_block"]
        say(f"[build] selective_scan ({dtype}, N {SCAN_PREFILL['n']}: "
            f"{i['lanes']} lanes x {i['states_a_lane']} states a channel): "
            f"{i['registers']} registers, {i['local_bytes']} bytes local "
            f"(spills), {i['smem']} bytes of shared memory a block, at most "
            f"{i['blocks_per_sm']} blocks of {i['warps_a_block']} warps an "
            f"SM; the falcon prefill's {blocks} blocks keep {warps:.2f} "
            f"warps resident on each of {sm} SMs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build    # fails outside a checkout
    from repro_torch.kernels import ops as kops

    # -- phase 1 ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    name = torch.cuda.get_device_name(0)
    gpu = f"{name}, power limit {smi.split(',')[-1].strip()}"
    say(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    built = _build.build_all()
    say(f"[build] nvcc (sm_90a, {len(_build.SOURCES)} sources in parallel): "
        f"{max(built.values(), default=0.0):.2f} s compiling, "
        f"{time.perf_counter() - t0:.2f} s in all; grouped_matmul.cu (TMA "
        f"maps, wgmma) done after "
        f"{built.get('grouped_matmul.cu', 0.0):.2f} s")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    n_dev = MESH[0] * MESH[1]
    kernel_info(torch, n_dev)
    k_local = N_KEYS // n_dev
    r_paper = 2 * 8192 // n_dev          # fused GET + PUT batch per client
    c_paper = max(4, 2 * (r_paper // n_dev))
    r_mixed = 65536 // n_dev
    shapes = {
        "pack_paper": dict(d=n_dev, r=r_paper, t=n_dev, c=c_paper,
                           c2=c_paper, w=6),
        "pack_mixed": dict(d=n_dev, r=r_mixed, t=n_dev, c=r_mixed,
                           c2=r_mixed, w=10),
        "serve_paper": dict(t=n_dev, n=n_dev * 2 * c_paper + r_paper,
                            k=k_local, w=VW, mix=(0.95, 0.05, 0.0, 0.0)),
        "serve_mixed": dict(t=n_dev, n=n_dev * 2 * r_mixed + r_mixed,
                            k=k_local, w=VW, mix=(0.4, 0.2, 0.2, 0.2)),
    }
    report = {}

    errs = {}
    if 2 in phases:
        errs = phase_kernels(torch, dev, shapes)
        phase_paged_kernels(torch, dev, errs)
        phase_flash_kernels(torch, dev, errs)
        phase_gmm_kernels(torch, dev, errs)
        phase_scan_kernels(torch, dev, errs)

    # the main paths, each with the counters zeroed just before it and read
    # just after: kv_paper (a) and (b), 40 kernel-path rounds each (the (a)
    # ref path launches none); kv_mixed, 8 rounds with the shortcut and 8
    # without; the paged decode's timed run
    launches = {k: 0 for k in SOURCES}
    per_round = {"kv_paper": {}, "kv_mixed": {}}
    for phase, label, rounds, run in (
            (3, "kv_paper", 80, lambda: phase_paper(torch, dev, report)),
            (4, "kv_mixed", 16, lambda: phase_mixed(torch, dev, report))):
        if phase not in phases:
            continue
        kops.reset_launch_counts()
        run()
        counts = kops.launch_counts()
        per_round[label] = {k: v / rounds for k, v in counts.items()}
        say(f"[main path] {label} launches over {rounds} kernel-path "
            f"rounds: {json.dumps(counts)}")
        for k in (("delegation_pack", "gather", "scatter_last")
                  if label == "kv_paper" else KV_KERNELS):
            require(counts[k] > 0, f"kernel {k} was not launched on the "
                    f"{label} main path")
        for k, v in counts.items():
            launches[k] += v
    for k, v in report.items():
        say(f"[ops/s] {gpu} | {k}: {v:.1f}")
    paged = None
    if 5 in phases:
        paged = phase_paged(torch, dev, gpu, report, errs)
        for k, v in paged[0].items():
            launches[k] += v
    qwen = None
    if 6 in phases:
        qwen = phase_qwen(torch, dev, gpu, report, errs)
        launches["flash_attention"] += qwen[0]
    deep = None
    if 7 in phases:
        deep = phase_deepseek(torch, dev, gpu, report, errs)
        for k, v in deep[0].items():
            launches[k] += v
        if 9 in phases:
            # the deepseek prefill's busy share now: its weights leave the
            # card before phase 8 draws falcon-mamba-7b's
            phase_deepseek_busy(torch, dev, gpu, deep[5], deep[6])
        deep = deep[:5] + (deep[6],)
        torch.cuda.empty_cache()
    falcon = None
    if 8 in phases:
        falcon = phase_falcon(torch, dev, gpu, report, errs,
                              busy=9 in phases)
        for k, v in falcon[0].items():
            launches[k] += v
    per_round["launches"] = launches
    say(f"[main path] kernel launches over phases 3-8 (one prefill call in "
        f"phases 6, 7 and 8): {json.dumps(launches)}")

    if 9 in phases:
        require(phases >= {2, 3, 4, 5, 6, 7, 8},
                "phase 9 reports the main paths' launches and the kernels' "
                "errors against their plain versions: run phases 2-8")
        rows = phase_times(torch, dev, shapes, errs, per_round, gpu)
        counts, rec, waves, inputs = paged
        timed = [r + ("bytes",) for r in phase_paged_times(
            torch, dev, gpu, rec, waves, counts, inputs)]
        timed.append(phase_flash_times(torch, dev, gpu, qwen[1], qwen[0]))
        ds_counts, mla_inputs, gmm_prefill, gmm_decode, ds_packs, ds_run = \
            deep
        phase_ds_pack_times(torch, gpu, ds_packs, ds_counts)
        phase_flash_times(torch, dev, gpu, mla_inputs,
                          ds_counts["flash_attention"],
                          label="deepseek MLA prefill")
        timed.append(phase_gmm_times(torch, dev, gpu, gmm_prefill,
                                     ds_counts["grouped_matmul"],
                                     "deepseek prefill"))
        phase_gmm_times(torch, dev, gpu, gmm_decode,
                        3 * (ds_run.model.n_layers - 1),
                        "deepseek decode step")
        timed.append(phase_scan_times(torch, dev, gpu, falcon[1],
                                      falcon[0]["selective_scan"]))
        phase_qwen_busy(torch, dev, gpu, qwen[2])
        for k in ("qwen_prefill", "qwen_serve", "deepseek_prefill",
                  "deepseek_serve", "falcon_prefill", "falcon_serve"):
            say(f"[tokens/s] {gpu} | {k}: {report[k]['tokens_per_s']:.1f}")
        for (kname, n, ms, plain, bound, lib, label, by) in timed:
            src, replaces = SOURCES[kname]
            rows.append({"name": kname, "route": "cuda", "source": src,
                         "replaces": replaces, "launches": launches[kname],
                         "max_abs_err": errs[kname], "ms": ms,
                         "plain_ms": plain, "bound_ms": bound,
                         "bound_by": by, "library_ms": lib,
                         "shapes": label})
        phase_busy(torch, dev, gpu)
        say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
