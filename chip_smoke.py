#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 1,2,4c,4d,4e   # a subset

Phases (any failure raises and exits non-zero; nothing is caught):

  1. device and build — the card's name and power limit, then the nine
     CUDA kernels built from csrc/ with nvcc (in parallel), the
     registers, spills and shared memory of the flash-attention kernel at
     each head dim it takes (D 256 included), and the
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
     integer-exact payloads, and a pack whose words in and slots out
     both lie past 2^31 words (2,200,000 rows of 1,000 words); the
     gather's three lanes with ``out`` and
     ``flag`` filled with a sentinel that every other row keeps, lane rows
     keyed -1 and K reading the clamped line, and the edges of its plan
     (N one past and one short of the plan's rows a block, a lane with no
     rows and one with every row, W 3, an ``out`` 4 bytes off 16-byte
     alignment, W 32, a warp a row at W 33 and 1100), exact;
     paged_attention in bf16, f32 and f16 (length
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
     causal=False at D 192), D 256 at the gemma-7b prefill's shape and
     layout, ragged, Skv 1, off-tile q_offset, MQA and causal=False, D 64
     not causal at the seamless encoder's and cross-attention's shapes,
     within the
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
 4a. kv_mux — the multiplexed session round: two trusts' batches in ONE
     session.step() a round, 20 Zipf(1) rounds on kv_paper's mesh and
     1,000,000 x 4 table, shortcut off, overflow "drop", capacity the rows
     of a client shard of the fused batch: (a) the lane layout — kv
     (kv_paper's traffic, 8192 rows) beside the inner table of a
     FetchRMWStore (8192 rows of kv_mixed's mix); (b) the masked layout —
     kv beside the Fig. 6 counters (8192 x 1, 4096 ADDs a round); (c) one
     round where the lock table only PUTs. Each round: every trust's
     responses and final table == its sequential oracle and the kernel
     path == the ref path bit for bit, both trusts fused, 2 block
     transposes a step (in (c) the request's and lane 0's response);
     ops/s of the fused step beside the same batches flushed one trust at
     a time, and the busy share of each;
 4b. kv_locks — the paper's lock lanes beside delegation at kv_paper's
     size (benchmarks/kv_store.py, fetch_add.py): rw-lock (GETs in one
     round, writes serialised by rank, capped at 32 and padded) and mutex
     (an rmw of every row, capped at 32) over 10 rounds of 8192 requests
     (5% writes; 5 Zipf(1), 5 uniform) beside the delegated store of
     phase 3; Fig. 6 fetch-and-add (delegated add, MCS rmw capped at 64,
     atomic add) over 4096 requests on 1, 64 and 8192 counters, uniform
     and Zipf(1). Every lane: kernel == ref bit for bit, == the oracle
     applied in request order; fetch-and-add tables == the bincount;
     n_rounds_executed as the ranks imply; ops/s raw and, for a capped
     lane, charged for the uncapped convoy;
 4c. kv_dedicated — kv_paper's table and traffic on the 2x4 stacked mesh
     with the last 4 shards dedicated trustees serving the first 4 (40
     rounds), then kv_mixed's mix (65,536 rows, 5 rounds); capacity the
     rows of a client shard: the kernel path == the ref path == the
     sequential oracle bit for bit, the client shards' region all zeros;
     ops/s and busy share beside the shared store's;
 4d. kv_drain — kv_mixed's mix with overflow "defer" at capacity 512 (half
     a pair's mean load), shortcut off: max_rounds 8 drains every row
     (residual 0, kernel == ref); per-client disjoint keys, one op a
     round, == the oracle; max_rounds 2 reports a residual and lands
     exactly R - residual increments; one dedicated drain round; the cost
     of the retry rounds with nothing left;
 4e. kv_combine — Zipf(1.1) over 1,000,000 keys, kv_mixed's mix at 65,536
     rows a round: combine "ref" == "off" == the oracle bit for bit,
     rows_combined == the host count of duplicate (client, destination,
     op, key) rows; ops/s of both and the wire rows saved;
  5. paged decode — repro_torch.launch.paged_decode at qwen2.5-3b attention
     width (16 query / 2 KV heads of 128, QKV bias, bf16 weights,
     activations and pool), a 4096-page pool of 16-token pages, 64-page
     chains, 64 sequences over 8 trustees (2x4, shared, shortcut on),
     driver depth 2, 128 requests (prompts 16-255 tokens, 64-511 generated):
     a check run (every request completes, zero leaked pages, every wave's
     page-table responses == the oracle replayed in serve order, every
     page-table pass == the plain version bit for bit, every attention
     call == the plain version), then the timed run; before it, a
     dedicated page table (4 of 8 shards trustees) at this geometry and
     at phase 2's stress geometry, phase 2's stress trace through it: the
     card == the plain version == the oracle in serve order, the client
     shards' state zeros;
  6. qwen serve — the qwen2.5-3b model path at full width (36 layers,
     d_model 2048, 16 / 2 heads of 128, d_ff 11008, vocab 151936, bf16;
     3.40 B random parameters drawn on the card): prefill_step at B 4 x
     2048 tokens through the flash kernel (a check run holding each of
     its 36 launches against the plain version, then timed runs), then
     repro_torch.launch.serve (8 requests, 64 prompt tokens teacher-forced
     then 64 generated, the KV cache's sequence split over 4 stacked
     trustees), then the same serve with --session --stream-depth 2
     --serve-impl pallas (each generated token's ledger and meter ADDs in
     one fused round through the CUDA serve kernels: tokens == the plain
     serve's, the ledger 64 a request, the meter summing 8 x 64, every
     wave fused), the same session serve with --delegation-mode
     dedicated (the ledger and meter on the last 2 of 4 shards) and with
     --drain-rounds 3 (a one-row block drained over up to 3 rounds, inside
     the driver's step(sync=False)), each:
     tokens == the plain serve's, ledger 64 a request, residual 0; then
     the prefill's last-position logits on the serve's prompt against the
     serve's decode logits at that position;
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
     (weights drawn in f32 from the same seed, at 4 layers, with bf16 at
     that depth beside it);
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
     flag / lane words; the gather lane by lane — GET at kv_paper, GET,
     the ADD base and the CAS current with expect and flag at kv_mixed —
     with the L2 flushed and warm, beside an empty launch of its grid (its
     latency floor), its keys and lanes read alone, index_select of the
     lane's lines (GET, ADD) and its launches per lane on the main
     paths).
     Every plain
     and library reading is CUDA events with the host ahead, the
     profiler's reading and the records it kept beside it, and its share
     of its own work's bound (torch.bmm's counts every slot, as it
     multiplies every one); one under its bound is marked as not a time.
     Then each path's ops/s or tokens/s on a host clock; the device's
     busy share and top device ops (the deepseek and falcon prefills' are
     taken at the end of phases 7 and 8, while their weights are on the
     card);
 11. the rest of the zoo that fits one card — qwen3-4b (36 layers, d_model
     2560, 32 / 8 heads of 128, QK norm), gemma-7b (28 layers, d_model
     3072, 16 heads of 256, GeGLU, tied and scaled embeddings, vocab
     256000), qwen1.5-32b (64 layers, d_model 5120, 40 heads of 128, QKV
     bias, d_ff 27392: 35.2 B parameters, 70.4 GB of bf16), qwen2-vl-2b
     (28 layers, d_model 1536, 12 / 2 heads of 128, M-RoPE, embeddings
     in) and seamless-m4t-large-v2 (24 encoder + 24 decoder layers,
     d_model 1024, 16 heads of 64, vocab 256256), each at full width and
     depth, random weights drawn on the card (every stacked leaf a layer
     at a time, as every model's are) after the last one's are freed (run
     after phase 8, before phase 9): serve.main
     over 4 requests x (32 prompt + 32 generated) over 4 trustees, twice
     (the tokens equal), qwen2-vl-2b an embeddings prompt and --gen 1;
     prefill_step at B 4 x 2048 through the flash kernel (a check run
     holding every launch against the plain version, then 2 timed runs);
     the prefill's last-position logits on the serve's prompt against
     the decode's there (5% relative RMS, qwen2-vl-2b's three position
     streams equal) — for seamless-m4t-large-v2 the prefill is the
     encoder (D 64, not causal), held to its plain path, and forward_loss
     under no_grad (S_src 2048, S_tgt 512: causal self-attention and
     cross-attention over the memory through the kernel, every launch
     checked) to the plain path, its final decoder hidden state by
     relative RMS and its loss (testing/model.py ENCDEC_RTOL); prefill
     and serve tokens/s and peak allocated GB (less what the phase found
     allocated at its start); then the flash kernel
     timed at each one's prefill shape as phase 9 times it;
 12. the data axis (run after phase 11, before phase 9) — (a) kv_subaxis:
     a DelegatedKVStore over the "model" axis of the 2x4 stacked mesh (4
     trustees, kv_paper's 1,000,000 x 4 f32 table in 2 replicas), 20
     kv_paper rounds (4096 requests a data row, each row its own Zipf(1)
     stream, 5% PUT) and one kv_mixed round (32,768 rows a data row):
     the kernel path (every pack launch == plain) == the ref path == a
     sequential oracle fed that data row's requests, every response and
     each replica bit for bit, the read-back == replica 0; ops/s beside
     a whole-mesh store's on the same rows (a reading); (b)
     deepseek_dp_serve: deepseek-v2-lite-16b at full width and depth on
     the (2, 4) mesh (each data row's tokens delegated to its own 4
     expert trustees): a prefill_step check run at B 4 x 2048 (every
     flash, pack and grouped-matmul launch against the plain version),
     serve.main --mesh-data 2 --mesh-model 4 over 8 x (64 + 64), again
     with --session (tokens equal run to run, the ledger 64 a request,
     the meter's 8 keys summing to 8 x 64), the prefill's last-position
     logits on the serve's prompt within the MoE bound of the decode's;
     (c) deepseek_dp_train: its train cell at full width, 2 layers, f32,
     B 4 x 256 on the (2, 4) mesh, value and grad on the card against the
     port's CPU path (loss 1e-5, gradients 1e-4 relative RMS, the MoE's
     drops equal), 3 steps of finite loss, then launch.train --mesh-data
     2 --mesh-model 4 --n-layers 2 for 3 steps; no kernel launched;
 13. jamba-v0.1-52b and arctic-480b at full width, at the depth one card
     holds (run after phase 12, before phase 9, each model's weights freed
     before the next is drawn): jamba 16 of its 32 layers (two 8-layer
     groups of Mamba and attention layers, MoE of 16 experts top-2 on
     every second layer; 26.05 B parameters), arctic 2 of its 35 (56 / 8
     heads, 128 experts top-2 beside a dense MLP; 27.68 B), bf16, random
     weights drawn on the card a layer at a time: serve.main at the
     published depth refused before any allocation; prefill_step at B 4
     x 2048 over 4 trustees (a check run holding every flash, grouped-
     matmul and pack launch, and jamba's 14 scans, against the plain
     version, then 2 timed runs); flash and the grouped matmul timed at
     the new shapes as phase 9 times them; serve.main(cfg=...) over 4 x
     (32 + 32), twice (the tokens equal); the prefill's last-position
     logits on the serve's prompt held to the plain path's in bf16 (the
     model's bf16 bound, 10%), and against the decode's there, in bf16
     as a reading (with the plain prefill's, and the expert rows the
     trustees dropped) and in f32 at 8 / 1 layers held to 1e-4;
     tokens/s and peak allocated GB;
 14. the examples and the dry run (run after phase 13, before phase 9) —
     (a) repro_torch.examples' quickstart, serve_kv and delegated_moe on
     8 stacked shards on the card: quickstart's printed values equal the
     JAX package's example's and the CPU run's (engine stats included);
     serve_kv's service round on the delegated store and the rw-lock
     store over one 100,000 x 4 table, 2 rounds of 4096 zipf requests
     (5% writes): every GET == SequentialKVReference and both tables ==
     the oracle's; delegated_moe's run_routing (8 experts, 32 tokens, 6
     waves, seed 3): assignments, counts and tally == the CPU run's, the
     counts == the routed tokens' tally; their KV kernels (quickstart:
     all four; serve_kv: pack, gather, scatter_last; delegated_moe: the
     pack) must launch; (b) train_lm, 10m preset, 20 steps, losses and
     grad norms finite, no kernel launched; (c) launch.dryrun of
     qwen1.5-32b x decode_32k (the (16, 16) mesh, B 128 x 32,768, on the
     meta device): memory allocated on the card and every launch counter
     unchanged across it; (d) the dry-run cells of the shapes phases 6,
     7, 8 and 10 time; after phase 10 their terms beside those phases'
     medians, mfu = model FLOPs / 989 TFLOP/s / the measured step
     (readings);
 15. the compiled step (run after phase 14, before phase 9) — every serve's
     decode step and every KV and paged round of the phases above runs as
     a captured CUDA graph (repro_torch.core.compiled; only a kernel
     check's run, which compares on the host, is eager); here each path
     runs twice on the same weights and traffic, under
     compiled.disable() and captured: qwen2.5-3b and deepseek-v2-lite-16b
     serve.main at full width and depth, 8 x (32 + 32) over 4 trustees
     (deepseek's MoE channel round and the grouped matmul inside the
     captured decode), 20 kv_paper rounds, 8 kv_mux fused steps, 8
     kv_drain steps at capacity 512 with "defer", and a kv_failover run of
     8 waves (snapshots at 0 and 4, shard 3 killed at 6, re-entrusted
     onto 7 from the snapshot, 2 waves replayed); (e) qwen2.5-3b's train
     step at full width and depth (B 4 x 1024, remat "full", bf16
     weights, f32 moments), 4 steps eager, the initial state restored in
     place, 4 steps captured; (f) build_cell's prefill through the
     kernels at B 4 x 2048 for qwen2.5-3b, deepseek-v2-lite-16b (4
     trustees) and falcon-mamba-7b, 3 calls each way on 3 distinct
     batches; (g) phase 5's
     paged decode, its model callback eager and captured (one program a
     shape).  Gates: the tokens and the last step's logits, every
     answer, table and stat, every train step's metrics and every leaf's
     checksum, each prefill call's logits against the eager call's on
     its batch, every paged decode output, the final KV pool and page
     table bit for bit, the launch counts equal both ways, no
     leaked page, and after the re-entrust no compiled round left on the
     old addresses.  Readings: ms a step or ops/s, the host's issue time
     a step (no synchronize), the busy share of 5 decode steps or 10
     rounds (2 train steps, 1 prefill, a 4-request paged run), each
     program's capture ms and
     pool bytes, the train step's peak GB, the _cache entries at the
     end.  The timed prefills of phases 6-8, 11 and 13 and the trainer of
     phases 10 and 12 run captured too (each prefill's first call,
     untimed, captures; the trainer's first step does), each timed
     prefill held bit for bit to its eager check run's logits;
 10. qwen train — (a) repro_torch.launch.train on qwen2.5-3b at full width
     and depth (bf16 weights, f32 AdamW moments, remat "full", the
     synthetic stream, B 4 x 1024, 8 steps; weights drawn on the card
     after the earlier phases' are freed): every loss and grad norm
     finite, ms a step (median of steps 2-8), tokens/s, peak allocated
     GB; then two steps on one repeated batch at the schedule's lr, the
     busy share of one profiled step, and from the trained weights one
     AdamW step from zero moments on that batch at each lr of
     TRAIN_SWEEP, each beside the change its gradient predicts
     (readings), and the gate that a step lowers the loss on these
     weights: a step sized so that its first-order change is -3e-2
     lowers the loss by that change within 10% (testing/train.py
     descent_check); (b) the card against the port's
     CPU path on the same weights and batch in f32 at full width and 2
     layers — qwen2.5-3b B 1 x 256, deepseek-v2-lite-16b B 1 x 128 (its
     dense first layer and one MoE layer of 64 experts over 4 stacked
     trustees: every expert fed a row has a gradient), falcon-mamba-7b B
     1 x 64: the loss within 1e-5 relative and each gradient leaf within
     1e-4 relative RMS; remat "full" and "dots" against "none" on the
     card within 1e-5; one AdamW step on the CPU's gradients, the card's
     update against the CPU's within 1e-5 relative RMS a leaf; and the
     same gate on other draws: qwen2.5-3b at 2 layers in f32 drawn from
     each of TRAIN_DESCENT_SEEDS, a step sized for a first-order change
     of -1e-2; (c) the SMOKE
     trainer resumed after a failure
     injected at step 12 (a checkpoint every 5) ends on the clean run's
     loss (rtol 1e-4); (d) tests/_md_battery.py's
     grad_channel_combiner_int8 on 8 stacked shards: err_final < 0.05 on
     the card, its final table within 1e-5 of the port's CPU run, and the
     CPU run's 60 steps replayed on the card from their inputs within
     1e-5 of its outputs.  The training path runs the plain
     versions (no kernel has a backward, as JAX trains without its
     Pallas kernels): its launch counts must read 0.

Phase 2 also holds the multiplexed round's kernel shapes: the pack at
virtual bins (8 trustees x 2 lanes, a hot lane and an empty one) and
the three serve kernels on one lane's sub-buffer as the strided serve
forms it, exact.

Launch counters are zeroed just before each main path (phases 3, 4,
4a-4e, the timed run of 5, each timed prefill of 6, 7, 8, 11 and 13, the
session serves of 6, the serves of 7, 8, 11 and 13, each of 12 (a)-(c),
each example of 14 and its dry run, each run of 15, and phase 10's
trainer) and read just after; every kernel of a path must have launched
there (phase 10's: none).  A captured program adds its capture's
launches on every replay, so the counts read the same eager or
captured.  "[time]" lines give the wall time through each
phase.  The line before the last is {"kernels": [...]};
the last is the device line.
"""
import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# the kernels' bounds and the card's peaks: one implementation, the
# package's (plain Python; fails outside a checkout)
from repro_torch.launch import rooflines  # noqa: E402

HBM_BYTES_PER_S = rooflines.HBM_BW      # H100 SXM HBM3 (data sheet)
BF16_FLOPS = rooflines.PEAK_FLOPS       # bf16 dense tensor-core peak
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
# 128 requests: 256 took ~270 s of the script's time limit in the check
# and timed runs, room that phase 11 needs
N_REQUESTS, PROMPT, GEN = 128, (16, 256), (64, 512)


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
    from repro_torch.testing.serve import (far_winner_flags, gather_case,
                                           gather_contract,
                                           gather_edge_cases, run_gather)
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
    # words read and slots written past 2^31 words (the dry run's
    # prefill_32k MoE packs are of that size)
    from repro_torch.testing.serve import WIDE_PACK, wide_pack_check
    t0 = time.perf_counter()
    wide = wide_pack_check(dev)
    torch.cuda.empty_cache()
    require(all(wide[k] for k in ("slots", "slots2", "counts", "counts2",
                                  "request_slot", "totals"))
            and min(wide["words"], wide["slot_words"]) >= 2 ** 31,
            f"delegation_pack past 2^31 words: {wide}")
    say(f"[kernels] delegation_pack [past 2^31 words: {WIDE_PACK['r']} rows "
        f"of {WIDE_PACK['w']} words, {wide['words']} words in, "
        f"{wide['slot_words']} slot words out] == plain (exact, "
        f"{time.perf_counter() - t0:.1f} s)")

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
    # the gather's contract and its plan's edges: out and flag filled with
    # a sentinel first, the three lanes in the serve's order
    for label, kw in gather_edge_cases():
        case = gather_case(dev, **kw)
        got = run_gather(case, "kernel")
        torch.cuda.synchronize()
        want = run_gather(case, "ref")
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"gather [{label}]: differs from the plain version (max abs "
                f"err {max_err(got, want)})")
        clamped, kept, kept_flag, n_off = gather_contract(case, *got)
        require(clamped, f"gather [{label}]: a lane row keyed outside the "
                f"table did not read its clamped line")
        require(kept and kept_flag, f"gather [{label}]: a row of another "
                f"lane lost its sentinel")
        say(f"[kernels] gather [{label}] == plain (exact); {n_off} lane "
            f"rows keyed outside the table read the clamped line, every "
            f"other row kept its sentinel")
    return errs


def phase_mux_kernels(torch, dev):
    """The multiplexed round's kernel shapes against the plain versions,
    exact: the pack at virtual bins (8 trustees x 2 lanes, a hot lane and
    an empty one), and gather, scatter_last and segmented_add on one
    lane's sub-buffer as the strided serve forms it (``lane_rows``)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.testing.serve import (lane_serve_case,
                                           virtual_bin_pack_case)
    n_dev = MESH[0] * MESH[1]
    c = -(-3 * MUX_ROWS // n_dev)        # kv_mux's lane capacity (3072)
    for label, kw in (
            ("kv_mux shape, lane 0 hot, lane 1 empty",
             dict(d=n_dev, r=c, t=n_dev, lanes=2, c=c, c2=0, w=10, seed=81,
                  hot_lane=0, empty_lane=1)),
            ("lane 1 hot past C + C2, lane 0 empty",
             dict(d=n_dev, r=4096, t=n_dev, lanes=2, c=256, c2=128, w=10,
                  seed=82, hot_lane=1, empty_lane=0))):
        args = virtual_bin_pack_case(dev, **kw)
        got = kops.delegation_pack(*args, impl="kernel")
        torch.cuda.synchronize()
        want = kops.delegation_pack(*args, impl="ref")
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"delegation_pack [virtual bins: {label}]: differs from the "
                f"plain version")
        require(bool((got[5][:, kw["empty_lane"]::2] == 0).all()),
                f"delegation_pack [virtual bins: {label}]: the empty lane "
                f"has rows")
        say(f"[kernels] delegation_pack [virtual bins, {n_dev} trustees x 2 "
            f"lanes: {label}] == plain (exact)")
    for label, kw in (
            ("kv_mux shape, lane 1 (kv_mixed's mix)",
             dict(t=n_dev, n_lanes=2, c1=c, c2=0, k=N_KEYS // n_dev, w=VW,
                  seed=83, tid=1)),
            ("lane 0 with a second_round block and a local tail",
             dict(t=n_dev, n_lanes=2, c1=512, c2=256, k=999, w=VW, seed=84,
                  tid=0, n_local=700, hot=0.5))):
        case = lane_serve_case(dev, **kw)
        for name in ("gather", "scatter_last", "segmented_add"):
            got = run_serve_kernel(torch, name, case, "kernel", case["base"])
            torch.cuda.synchronize()
            want = run_serve_kernel(torch, name, case, "ref", case["base"])
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"{name} [lane sub-buffer: {label}]: differs from the "
                    f"plain version (max abs err {max_err(got, want)})")
        say(f"[kernels] gather, scatter_last, segmented_add [lane sub-buffer:"
            f" {label}, {tuple(case['keys'].shape)} rows] == plain (exact)")


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


def make_store(dev, pack_impl, serve_impl, capacity, init, session, name,
               **kw):
    """A store on kv_paper's mesh and table; ``kw`` the other knobs."""
    from repro_torch.core import DelegatedKVStore, StackedMesh
    st = DelegatedKVStore(StackedMesh(MESH, device=dev), N_KEYS, VW,
                          capacity=capacity, pack_impl=pack_impl,
                          serve_impl=serve_impl, session=session, name=name,
                          **kw)
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


def mixed_trace(rng, init, rounds=8, r=65536, alpha=1.0):
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
            keys = sample_keys(rng, N_KEYS, n, "zipf",
                               alpha).astype(np.int32)
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
# phase 4a: the multiplexed session round (kv_mux)
# ---------------------------------------------------------------------------

MUX_ROUNDS = 20
MUX_ROWS = 8192
MIXED_SHARES = (("get", 0.4), ("put", 0.2), ("add", 0.2), ("cas", 0.2))


def kv_batches(rng):
    """kv_paper's traffic as two op batches (GET, PUT; inactive rows keyed
    -1): 95% GET / 5% PUT, Zipf(1), integer-valued payloads."""
    from repro_torch.core.routing import sample_keys
    r = MUX_ROWS
    keys = sample_keys(rng, N_KEYS, r, "zipf").astype(np.int32)
    is_put = rng.random(r) < 0.05
    vals = rng.integers(0, 8, (r, VW)).astype(np.float32)
    return [("get", np.where(is_put, -1, keys), vals, None),
            ("put", np.where(is_put, keys, -1), vals, None)]


def mixed_batches(rng, sim, put_only=False):
    """kv_mixed's op mix (GET/PUT/ADD/CAS 40/20/20/20, Zipf(1)) as op
    batches; CAS expects hit ``sim``'s table about half the time, and
    ``sim`` replays the round.  ``put_only``: one PUT batch of r rows."""
    from repro_torch.core.routing import sample_keys
    r = MUX_ROWS
    shares = (("put", 1.0),) if put_only else MIXED_SHARES
    sizes = [int(r * s) for _op, s in shares]
    sizes[-1] = r - sum(sizes[:-1])
    batches = []
    for (op, _s), n in zip(shares, sizes):
        keys = sample_keys(rng, N_KEYS, n, "zipf").astype(np.int32)
        vals = rng.integers(0, 8, (n, VW)).astype(np.float32)
        expect = None
        if op == "cas":
            live = sim.table[keys].copy()
            rand = rng.integers(0, 8, (n, VW)).astype(np.float32)
            expect = np.where(rng.random(n)[:, None] < 0.5, live, rand)
        batches.append((op, keys, vals, expect))
    oracle_round(sim, batches, False, 8)
    return batches


def submit_batches(torch, dev, store, batches):
    """Queue op batches (inactive rows keyed -1) on a store's typed
    handles; returns their futures."""
    op = store.trust.op
    futs = []
    for name, keys, vals, expect in batches:
        k = torch.as_tensor(keys, device=dev)
        where = k >= 0
        if name == "get":
            futs.append(op.get.then(k, where=where))
        elif name == "cas":
            futs.append(op.cas.then(k, value=torch.as_tensor(vals,
                                                             device=dev),
                                    expect=torch.as_tensor(expect,
                                                           device=dev),
                                    where=where))
        else:
            futs.append(op[name].then(k, torch.as_tensor(vals, device=dev),
                                      where=where))
    return futs


def results(futs, batches):
    out = []
    for (name, *_), fut in zip(batches, futs):
        r = fut.result()
        if name in ("get", "add"):
            out.append(r["value"].cpu().numpy())
        elif name == "cas":
            out.append((r["flag"].cpu().numpy(), r["value"].cpu().numpy()))
        else:
            out.append(None)
    return out


def same_answers(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def mux_pair(dev, layout, impl, session, init):
    """The two stores of a kv_mux layout on kv_paper's mesh: "strided" —
    kv (1,000,000 x 4) and the inner table of a FetchRMWStore (1,000,000 x
    4); "masked" — kv beside the Fig. 6 counters (8192 x 1).  Shortcut
    off, overflow "drop", capacity the rows of a client shard of the
    fused batch."""
    from repro_torch.core import (DelegatedKVStore, FetchRMWStore,
                                  StackedMesh)
    mesh = StackedMesh(MESH, device=dev)
    fused_rows = MUX_ROWS * 2 + (MUX_ROWS if layout == "strided"
                                 else MUX_ROWS // 2)
    kw = dict(capacity=-(-fused_rows // (MESH[0] * MESH[1])),
              overflow="drop", pack_impl=impl, serve_impl=impl,
              session=session)
    kv = DelegatedKVStore(mesh, N_KEYS, VW, local_shortcut=False, name="kv",
                          **kw)
    if layout == "strided":
        other = FetchRMWStore(mesh, N_KEYS, VW, **kw).store
    else:
        other = DelegatedKVStore(mesh, MUX_ROWS, 1, local_shortcut=False,
                                 name="counters", **kw)
    for st, v in zip((kv, other), init):
        st.prefill(v)
    return kv, other


def mux_traces(layout, rounds=MUX_ROUNDS, put_only=False):
    """Per round the kv batches and the other trust's batches: kv_mixed's
    mix on the lock table ("strided"; ``put_only``: PUTs alone), 4096
    counter ADDs ("masked").  Returns the two initial tables and the
    trace."""
    from repro_torch.core import SequentialKVReference
    rng = np.random.default_rng(4040 if layout == "strided" else 4041)
    init_kv = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    if layout == "strided":
        init_o = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
        sim = SequentialKVReference(N_KEYS, VW)
        sim.prefill(init_o)
    else:
        init_o = np.zeros((MUX_ROWS, 1), np.float32)
    trace = []
    for _ in range(rounds):
        kvb = kv_batches(rng)
        if layout == "strided":
            other = mixed_batches(rng, sim, put_only=put_only)
        else:
            keys = rng.integers(0, MUX_ROWS, MUX_ROWS // 2).astype(np.int32)
            other = [("add", keys, np.ones((len(keys), 1), np.float32),
                      None)]
        trace.append((kvb, other))
    return (init_kv, init_o), trace


def run_mux(torch, dev, stores, trace, session, fused=True, moves=None):
    """The trace's rounds, one ``session.step()`` each (``fused``) or one
    flush a trust.  Returns (answers per round per trust, seconds on the
    host clock around a synchronize, last step infos); the answers reach
    the host after the clock stops, as phase 3's do."""
    from repro_torch.core import collect_transposes
    futs_all, infos = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batches in trace:
        futs = [submit_batches(torch, dev, st, b)
                for st, b in zip(stores, batches)]
        if fused:
            with collect_transposes() as tr:
                stats = session.step()
            infos.append(session.last_step_info)
            if moves is not None:
                moves.append(list(tr))
        else:
            for st in stores:
                st.flush()
            stats = session.last_stats()
        for st in stores:
            require(stats[st.trust.name]["dropped"] == 0
                    and stats[st.trust.name]["impl_fallback"] == 0,
                    f"kv_mux: {st.trust.name} dropped rows or fell back from "
                    f"the kernels")
        futs_all.append(futs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    outs = [[results(f, b) for f, b in zip(futs, batches)]
            for futs, batches in zip(futs_all, trace)]
    return outs, secs, infos


def mux_oracle(init, trace, widths):
    from repro_torch.core import SequentialKVReference
    refs = []
    for v, w in zip(init, widths):
        ref = SequentialKVReference(v.shape[0], w)
        ref.prefill(v)
        refs.append(ref)
    outs = [[oracle_round(ref, b, False, 8) for ref, b in zip(refs, batches)]
            for batches in trace]
    return outs, [ref.dump() for ref in refs]


def check_mux(label, got, tables, want, want_tables):
    for i, (g_round, w_round) in enumerate(zip(got, want)):
        for tid, (g, w) in enumerate(zip(g_round, w_round)):
            for j, (a, b) in enumerate(zip(g, w)):
                require(same_answers(a, b), f"{label} round {i}: trust {tid}"
                        f" batch {j} differs")
    for tid, (a, b) in enumerate(zip(tables, want_tables)):
        require(np.array_equal(a, b), f"{label}: trust {tid}'s final table "
                f"differs")


def phase_mux(torch, dev, gpu):
    """kv_mux: two trusts' batches in ONE session.step() a round, on
    kv_paper's mesh and table.  (a) the lane layout — kv (kv_paper's
    traffic) beside the inner table of a FetchRMWStore (kv_mixed's op
    mix); (b) the masked layout — kv beside the Fig. 6 counters; (c) a
    round where the lock table only PUTs, its lane off the response
    transpose.  Each: == each trust's sequential oracle and the ref path
    bit for bit, both trusts fused, 2 transposes a step.  Times: the fused
    step against the same batches flushed one trust at a time."""
    from repro_torch.core import TrustSession
    half = MUX_ROUNDS // 2
    busy = {}
    for layout, widths in (("strided", (VW, VW)), ("masked", (VW, 1))):
        init, trace = mux_traces(layout)
        want, want_tables = mux_oracle(init, trace, widths)
        pairs = {}
        for label in ("ref", "fused", "solo"):
            sess = TrustSession()
            pairs[label] = (mux_pair(dev, layout, "ref" if label == "ref"
                                     else "kernel", sess, init), sess)
        got = {k: [] for k in pairs}
        secs = {k: [] for k in pairs}
        moves, infos = [], []
        # the ref path, then the kernel path fused and one trust at a time
        # in the order fused, solo, solo, fused over the two halves of the
        # trace (each pair of stores still takes the rounds in order)
        for label, part in (("ref", trace), ("fused", trace[:half]),
                            ("solo", trace[:half]), ("solo", trace[half:]),
                            ("fused", trace[half:])):
            stores, sess = pairs[label]
            out, t, inf = run_mux(torch, dev, stores, part, sess,
                                  fused=label != "solo", moves=moves)
            got[label] += out
            secs[label].append(t)
            infos += inf
        for label, (stores, _s) in pairs.items():
            check_mux(f"kv_mux {layout} {label}", got[label],
                      [st.dump() for st in stores], want, want_tables)
        other = pairs["fused"][0][1].trust.name
        require(all(info["fused"] == [["kv", other]] for info in infos),
                f"kv_mux {layout}: a step did not fuse both trusts")
        require(all(m == ["request", "response"] for m in moves),
                f"kv_mux {layout}: transposes a step {moves[:3]}")
        say(f"[kv_mux {layout}] {MUX_ROUNDS} rounds x 2 trusts (kv + "
            f"{other}): the kernel path fused, the same batches flushed one "
            f"trust at a time and the ref path fused each == both trusts' "
            f"sequential oracles bit for bit (every response, both final "
            f"tables); every step fused both trusts, 2 block transposes a "
            f"step (request, response)")
        ops = sum(int((b[1] >= 0).sum()) for batches in trace
                  for bs in batches for b in bs)
        fused_secs, solo_secs = sum(secs["fused"]), sum(secs["solo"])
        fused_stores, fused_sess = pairs["fused"]
        stores, sess = pairs["solo"]
        for label, st_pair, ses, fused in (
                ("fused", fused_stores, fused_sess, True),
                ("solo", stores, sess, False)):
            batches = trace[0]

            def one_round():
                for s, b in zip(st_pair, batches):
                    submit_batches(torch, dev, s, b)
                if fused:
                    ses.step()
                else:
                    for s in st_pair:
                        s.flush()
            busy[label] = busy_share(torch, one_round, 10)
        say(f"[kv_mux {layout}] {gpu} | {ops} ops over {MUX_ROUNDS} rounds: "
            f"fused step {ops / fused_secs:.1f} ops/s, one trust at a time "
            f"{ops / solo_secs:.1f} ops/s (host clock around a synchronize;"
            f" halves in the order fused, solo, solo, fused: "
            + ", ".join(f"{1e3 * t:.1f}" for t in (
                secs["fused"][0], *secs["solo"], secs["fused"][1]))
            + " ms); device busy " + ", ".join(
                f"{lb} {100 * b / w:.1f}% ({b * 1e3:.3f} of {w * 1e3:.3f} ms"
                f" over 10 rounds)" if b > 0 else f"{lb} not measured"
                for lb, (b, w) in busy.items()))

    # (c) one round where the lock table only PUTs
    init, trace = mux_traces("strided", rounds=1, put_only=True)
    want, want_tables = mux_oracle(init, trace, (VW, VW))
    for impl in ("kernel", "ref"):
        sess = TrustSession()
        stores = mux_pair(dev, "strided", impl, sess, init)
        moves = []
        got, _, infos = run_mux(torch, dev, stores, trace, sess, moves=moves)
        check_mux(f"kv_mux put-only {impl}", got,
                  [st.dump() for st in stores], want, want_tables)
        require(moves == [["request", "response lanes [0]"]],
                f"kv_mux put-only: transposes {moves}")
        saved = sess.last_stats()["rmw-lock"]["resp_bytes_saved"]
    say(f"[kv_mux put-only] rmw-lock only PUTs: == the oracles and kernel "
        f"== ref bit for bit; the step made 1 request transpose and 1 "
        f"response transpose of lane 0 (kv) alone: lane 1 (rmw-lock) stayed "
        f"off it ({saved} response bytes a shard saved)")


# ---------------------------------------------------------------------------
# phase 4b: the paper's lock lanes at kv_paper's size (kv_locks)
# ---------------------------------------------------------------------------

LOCK_ROUNDS = 10                # 5 Zipf(1) then 5 uniform
RW_CAP, MUTEX_CAP, MCS_CAP = 32, 32, 64
FA_REQUESTS = 4096
FA_OBJECTS = (1, 64, 8192)


def lock_trace(rng):
    """kv_paper's requests for the lock lanes: (keys, is_put, values) a
    round, 5% writes, Zipf(1) then uniform."""
    from repro_torch.core.routing import sample_keys
    trace = []
    for i in range(LOCK_ROUNDS):
        dist = "zipf" if i < LOCK_ROUNDS // 2 else "uniform"
        keys = sample_keys(rng, N_KEYS, MUX_ROWS, dist).astype(np.int32)
        is_put = rng.random(MUX_ROWS) < 0.05
        vals = rng.integers(0, 8, (MUX_ROWS, VW)).astype(np.float32)
        trace.append((keys, is_put, vals))
    return trace


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rw_lane(torch, dev, store, trace, n_dev):
    """benchmarks/kv_store.py's rwlock lane: the GETs in one parallel
    round, the writes serialised by rank (capped at 32, padded)."""
    from repro_torch.core import conflict_ranks, pad_writes
    outs, rounds = [], []
    for keys, is_put, vals in trace:
        v = torch.as_tensor(vals, device=dev)
        outs.append(store.get(torch.as_tensor(np.where(is_put, -1, keys),
                                              device=dev)))
        wranks, wrounds = conflict_ranks(keys[is_put], n_dev)
        capped = min(wrounds, RW_CAP)
        if is_put.any():
            wk, wv, wr, _ = pad_writes(keys[is_put],
                                       v[torch.as_tensor(np.flatnonzero(
                                           is_put), device=dev)],
                                       np.minimum(wranks, capped - 1),
                                       capped, n_dev)
            store.put(wk, wv, wr, capped)
        rounds.append((wrounds, capped))
    return outs, rounds


def mutex_lane(torch, dev, store, trace, n_dev):
    """benchmarks/kv_store.py's mutex lane: every row (GET and PUT) an rmw
    of ``crit_fn = lambda v, p: p``, ranks capped at 32."""
    from repro_torch.core import conflict_ranks
    outs, rounds = [], []
    for keys, _is_put, vals in trace:
        ranks, n = conflict_ranks(keys, n_dev)
        capped = min(n, MUTEX_CAP)
        outs.append(store.rmw(torch.as_tensor(keys, device=dev),
                              lambda _v, p: p, np.minimum(ranks, capped - 1),
                              capped, payload=torch.as_tensor(vals,
                                                              device=dev)))
        rounds.append((n, capped))
    return outs, rounds


def lock_oracle_rw(init, trace, n_dev):
    from repro_torch.core import SequentialKVReference, conflict_ranks
    ref = SequentialKVReference(N_KEYS, VW)
    ref.prefill(init)
    outs = []
    for keys, is_put, vals in trace:
        outs.append(ref.get(np.where(is_put, -1, keys)))
        wk, wv = keys[is_put], vals[is_put]
        wranks, wrounds = conflict_ranks(wk, n_dev)
        rk = np.minimum(wranks, min(wrounds, RW_CAP) - 1)
        for r in range(min(wrounds, RW_CAP) if len(wk) else 0):
            ks = np.where(rk == r, wk, -1)
            ref.get(ks)
            ref.put(ks, wv)
    return outs, ref.dump()


def rmw_oracle(ref, keys, ranks, rounds, crit):
    out = np.zeros((len(keys), ref.value_width), np.float32)
    for r in range(rounds):
        ks = np.where(ranks == r, keys, -1)
        got = ref.get(ks)
        ref.put(ks, crit(got))
        out[ranks == r] = got[ranks == r]
    return out


def phase_locks(torch, dev, gpu):
    """kv_locks: the paper's lock lanes beside delegation, at kv_paper's
    size (benchmarks/kv_store.py, fetch_add.py): rw-lock and mutex over
    10 rounds of 8192 requests (5% writes; 5 Zipf(1), 5 uniform) beside
    the delegated store of phase 3; the Fig. 6 fetch-and-add lanes
    (delegated add, MCS rmw, atomic add) over 4096 requests on 1, 64 and
    8192 counters, uniform and Zipf(1).  Every lane: kernel path == ref
    path bit for bit, == the oracle applied in request order; the
    fetch-and-add tables == the bincount of the keys (MCS where no rank
    is capped); n_rounds_executed what the ranks imply."""
    from repro_torch.core import (AtomicAddStore, DelegatedKVStore,
                                  FetchRMWStore, SequentialKVReference,
                                  StackedMesh, TrustSession, conflict_ranks)
    from repro_torch.core.routing import sample_keys
    n_dev = MESH[0] * MESH[1]
    rng = np.random.default_rng(2025)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    trace = lock_trace(rng)
    ops = LOCK_ROUNDS * MUX_ROWS
    mesh = StackedMesh(MESH, device=dev)
    cap = MUX_ROWS // n_dev               # the rows of a client shard

    # the delegated store of phase 3 on the same trace
    sess = TrustSession()
    st = make_store(dev, "kernel", "kernel", None, init, sess, "kv_locks")
    _o, _d, secs = run_paper(torch, dev, st, trace, sess)
    lines = [f"delegated {ops / secs:.1f}"]

    want_rw = lock_oracle_rw(init, trace, n_dev)
    ref = SequentialKVReference(N_KEYS, VW)
    ref.prefill(init)
    want_mx = []
    for keys, _p, vals in trace:
        ranks, n = conflict_ranks(keys, n_dev)
        c = min(n, MUTEX_CAP)
        want_mx.append(rmw_oracle(ref, keys, np.minimum(ranks, c - 1), c,
                                  lambda g, v=vals: v))
    want_mx = (want_mx, ref.dump())
    for lane, fn, kw, want in (("rw-lock", rw_lane, dict(rw_lock=True),
                                want_rw),
                               ("mutex", mutex_lane, {}, want_mx)):
        got = {}
        for impl in ("kernel", "ref"):
            lock = FetchRMWStore(mesh, N_KEYS, VW, capacity=cap,
                                 pack_impl=impl, serve_impl=impl,
                                 session=TrustSession(), **kw)
            lock.prefill(init)
            (outs, rounds), secs = timed(
                torch, lambda: fn(torch, dev, lock, trace, n_dev))
            got[impl] = ([o.cpu().numpy() for o in outs], lock.dump())
            check_stats(lock.store.session.last_stats(),
                        lock.store.trust.name)
            implied = sum(c for _n, c in rounds)
            require(lock.n_rounds_executed == implied,
                    f"kv_locks {lane} {impl}: {lock.n_rounds_executed} "
                    f"rounds executed, the ranks imply {implied}")
            if impl == "kernel":
                k_secs, k_rounds = secs, rounds
        for impl in ("kernel", "ref"):
            outs, table = got[impl]
            require(all(np.array_equal(a, b) for a, b in zip(outs, want[0]))
                    and np.array_equal(table, want[1]),
                    f"kv_locks {lane} {impl}: differs from the oracle")
        full = sum(n for n, _c in k_rounds)
        done = sum(c for _n, c in k_rounds)
        charged = k_secs * full / done
        lines.append(f"{lane} raw {ops / k_secs:.1f} ({done} serialised "
                     f"rounds, ranks capped at "
                     f"{RW_CAP if lane == 'rw-lock' else MUTEX_CAP}), "
                     f"charged for the uncapped convoy ({full} rounds) "
                     f"{ops / charged:.1f}")
        say(f"[kv_locks {lane}] {LOCK_ROUNDS} rounds x {MUX_ROWS}: kernel "
            f"== ref == the oracle in request order bit for bit (every "
            f"returned row, the final table); n_rounds_executed {done} as "
            f"the capped ranks imply")
    say(f"[kv_locks] {gpu} | ops/s over {ops} requests: " + "; ".join(lines))

    # Fig. 6: fetch-and-add over 1, 64 and 8192 counters
    fa = []
    for n_obj in FA_OBJECTS:
        for dist in ("uniform", "zipf"):
            keys = sample_keys(rng, n_obj, FA_REQUESTS, dist).astype(np.int32)
            k = torch.as_tensor(keys, device=dev)
            ones = torch.ones((FA_REQUESTS, 1), device=dev)
            count = np.bincount(keys, minlength=n_obj).astype(np.float32)
            ranks, n = conflict_ranks(keys, n_dev)
            capped = min(n, MCS_CAP)
            ref = SequentialKVReference(n_obj, 1)
            want_mcs = rmw_oracle(ref, keys, np.minimum(ranks, capped - 1),
                                  capped, lambda g: g + 1)
            want_mcs_table = ref.dump()
            zeros = np.zeros((n_obj, 1), np.float32)
            fcap = FA_REQUESTS // n_dev
            row = {}
            for impl in ("kernel", "ref"):
                skw = dict(capacity=fcap, pack_impl=impl, serve_impl=impl,
                           session=TrustSession())
                deleg = DelegatedKVStore(mesh, n_obj, 1, name="fa", **skw)
                mcs = FetchRMWStore(mesh, n_obj, 1, **skw)
                atom = AtomicAddStore(mesh, n_obj, 1, **skw)
                for s in (deleg, mcs, atom):
                    s.prefill(zeros)
                d_out, d_secs = timed(torch, lambda: deleg.add(k, ones))
                m_out, m_secs = timed(torch, lambda: mcs.rmw(
                    k, lambda v, p: v + 1.0, np.minimum(ranks, capped - 1),
                    capped))
                a_out, a_secs = timed(torch, lambda: atom.add(k, ones))
                for st in (deleg, mcs.store, atom.store):
                    check_stats(st.session.last_stats(), st.trust.name)
                require(mcs.n_rounds_executed == capped,
                        f"fetch-add mcs: {mcs.n_rounds_executed} rounds, "
                        f"want {capped}")
                require(np.array_equal(deleg.dump()[:, 0], count)
                        and np.array_equal(atom.dump()[:, 0], count),
                        f"fetch-add {n_obj} {dist} {impl}: the delegated or "
                        f"atomic table is not the bincount of the keys")
                require(np.array_equal(m_out.cpu().numpy(), want_mcs)
                        and np.array_equal(mcs.dump(), want_mcs_table),
                        f"fetch-add {n_obj} {dist} {impl}: mcs differs from "
                        f"the oracle")
                require(capped < n or np.array_equal(mcs.dump()[:, 0],
                                                     count),
                        f"fetch-add {n_obj} {dist}: uncapped mcs is not the "
                        f"bincount")
                row[impl] = [x.cpu().numpy() for x in (d_out, m_out, a_out)]
                if impl == "kernel":
                    secs = (d_secs, m_secs, a_secs)
            require(all(np.array_equal(a, b)
                        for a, b in zip(row["kernel"], row["ref"])),
                    f"fetch-add {n_obj} {dist}: kernel and ref paths differ")
            d_s, m_s, a_s = secs
            r = FA_REQUESTS
            fa.append(f"{n_obj} {dist}: delegated {r / d_s:.1f}, mcs raw "
                      f"{r / m_s:.1f} ({capped} rounds) charged "
                      f"{r / (m_s * n / capped):.1f} ({n} rounds), atomic "
                      f"{r / a_s:.1f}")
    say(f"[kv_locks fetch-add] {FA_REQUESTS} requests, every lane kernel == "
        f"ref bit for bit, delegated and atomic tables == the bincount, mcs "
        f"== the round-by-round oracle (== the bincount where uncapped)")
    say(f"[kv_locks fetch-add] {gpu} | ops/s: " + "; ".join(fa))


# ---------------------------------------------------------------------------
# phases 4c-4e: dedicated mode, the defer drain, request combining
# ---------------------------------------------------------------------------

DED_TRUSTEES = 4                # kv_dedicated: 4 clients, 4 trustees
MIXED_ROWS = 65536
DED_MIXED_ROUNDS = 5
DRAIN_CAPACITY = 512            # half the 1,024-row mean load of a pair
DRAIN_ROUNDS = 8
COMBINE_ROUNDS = 5


def run_rounds(torch, dev, store, trace, session):
    """Op-batch rounds, one ``session.step()`` each, timed on the host
    clock around a synchronize.  Returns (answers per round, stats per
    round, seconds); the answers reach the host after the clock stops."""
    futs_all, stats = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batches in trace:
        futs_all.append(submit_batches(torch, dev, store, batches))
        stats.append(session.step()[store.trust.name])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for s in stats:
        check_stats({store.trust.name: s}, store.trust.name)
    return ([results(f, b) for f, b in zip(futs_all, trace)], stats, secs)


def check_rounds(label, got, want):
    for i, (g_round, w_round) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g_round, w_round)):
            require(same_answers(a, b), f"{label} round {i} batch {j} "
                    f"differs")


def step_busy(torch, dev, store, session, batches, rounds=10):
    """Device busy share of one op-batch round, ``rounds`` times."""
    def one_round():
        submit_batches(torch, dev, store, batches)
        session.step(sync=False)
    return busy_share(torch, one_round, rounds)


def busy_text(b):
    busy, wall = b
    return (f"{100 * busy / wall:.1f}% ({busy * 1e3:.3f} of {wall * 1e3:.3f} "
            f"ms)" if busy > 0 else "not measured")


def paper_batches(keys, is_put, vals):
    return [("get", np.where(is_put, -1, keys), vals, None),
            ("put", np.where(is_put, keys, -1), vals, None)]


def phase_dedicated(torch, dev, gpu, report):
    """kv_dedicated: kv_paper's table and traffic on the 2x4 stacked mesh
    with the last 4 shards dedicated trustees serving the first 4 (40
    rounds of 8192 requests, 20 Zipf(1) then 20 uniform), then kv_mixed's
    four-op mix (65,536 rows, 5 rounds); capacity the rows of a client
    shard.  The kernel path == the ref path == the sequential oracle bit
    for bit, the client shards' region all zeros; ops/s and busy share
    beside the shared store's."""
    from repro_torch.core import SequentialKVReference, use_session
    n_dev = MESH[0] * MESH[1]
    n_cli = n_dev - DED_TRUSTEES
    ded = dict(mode="dedicated", n_dedicated=DED_TRUSTEES)
    rng = np.random.default_rng(2024)        # phase 3's table and traffic
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    trace = [paper_batches(*t) for t in paper_trace(rng)]
    r = sum(len(b[1]) for b in trace[0]) // 2
    rng = np.random.default_rng(7)           # phase 4's
    init_m = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    mixed = mixed_trace(rng, init_m, rounds=DED_MIXED_ROUNDS, r=MIXED_ROWS)
    busy = {}
    for label, tr, ini in (("paper", trace, init), ("mixed", mixed, init_m)):
        rows = sum(len(b[1]) for b in tr[0])
        runs = {}
        for impl in ("kernel", "ref"):
            with use_session() as sess:
                st = make_store(dev, impl, impl, -(-rows // n_cli), ini,
                                sess, f"kv_ded_{impl}", **ded)
                got, stats, secs = run_rounds(torch, dev, st, tr, sess)
                require(all(s["dropped"] == 0 for s in stats),
                        f"kv_dedicated {label}: rows overflowed")
                region = st.client_region()
                require(region.shape == (n_cli * (N_KEYS // DED_TRUSTEES),
                                         VW) and not region.any(),
                        f"kv_dedicated {label}: the client region holds "
                        f"state")
                runs[impl] = (got, st.dump(), secs)
                if impl == "kernel":
                    busy[f"dedicated {label}"] = step_busy(
                        torch, dev, st, sess, tr[0])
        ref = SequentialKVReference(N_KEYS, VW)
        ref.prefill(ini)
        want = [oracle_round(ref, b, False, n_dev) for b in tr]
        for impl, (got, table, _s) in runs.items():
            check_rounds(f"kv_dedicated {label} {impl}", got, want)
            require(np.array_equal(table, ref.dump()),
                    f"kv_dedicated {label} {impl}: final table differs")
        ops = sum(int((b[1] >= 0).sum()) for bs in tr for b in bs)
        report[f"kv_dedicated_{label}_ops_s"] = ops / runs["kernel"][2]
        with use_session() as sess:
            st = make_store(dev, "kernel", "kernel", -(-rows // n_dev), ini,
                            sess, "kv_shared", local_shortcut=False)
            busy[f"shared {label}"] = step_busy(torch, dev, st, sess, tr[0])
        say(f"[kv_dedicated {label}] {len(tr)} rounds x {rows} rows, "
            f"{DED_TRUSTEES} trustees serving {n_cli} clients: the kernel "
            f"path == the ref path == the sequential oracle bit for bit "
            f"(every response, the final table); the {n_cli} client shards' "
            f"region all zeros")
    shared = {"paper": report.get("kv_paper_b_kernel_ops_s"),
              "mixed": report.get("kv_mixed_shortcut_False_ops_s")}
    say(f"[kv_dedicated] {gpu} | ops/s: kv_paper traffic "
        f"{report['kv_dedicated_paper_ops_s']:.1f} (phase 3 (b), shared "
        f"with the shortcut: "
        + (f"{shared['paper']:.1f}" if shared["paper"] else "not run")
        + f"), kv_mixed {report['kv_dedicated_mixed_ops_s']:.1f} (phase 4, "
        f"shared without the shortcut: "
        + (f"{shared['mixed']:.1f}" if shared["mixed"] else "not run")
        + "); device busy over 10 rounds: "
        + ", ".join(f"{k} {busy_text(v)}" for k, v in busy.items()))


def owned_key(keys, client, n_trustees, n_clients):
    """Map keys onto client-owned keys: client c owns {k : (k // T) % C ==
    c} (tests/_drain_battery.py:57-67); the trustee (k % T) is kept."""
    span = n_trustees * n_clients
    return ((keys // span) * n_clients + client) * n_trustees \
        + keys % n_trustees


def disjoint_trace(rng, init):
    """One op a round (GET, PUT, ADD, CAS), 65,536 rows, Zipf(1) keys
    mapped onto each row's client's own keys; the CAS round takes each
    client's keys without repeats, its expects hitting the live table
    about half the time."""
    from repro_torch.core import SequentialKVReference
    from repro_torch.core.routing import sample_keys
    n_dev = MESH[0] * MESH[1]
    r_dev = MIXED_ROWS // n_dev
    client = np.arange(MIXED_ROWS) // r_dev
    sim = SequentialKVReference(N_KEYS, VW)
    sim.prefill(init)
    trace = []
    for op in ("get", "put", "add", "cas"):
        if op == "cas":
            # distinct owned keys: j * T * C + c * T + t, (j, t) drawn once
            idx = [rng.choice(N_KEYS // n_dev, r_dev, replace=False)
                   for _ in range(n_dev)]
            keys = np.concatenate([(i // n_dev) * n_dev * n_dev + c * n_dev
                                   + i % n_dev for c, i in enumerate(idx)])
        else:
            keys = owned_key(sample_keys(rng, N_KEYS, MIXED_ROWS, "zipf"),
                             client, n_dev, n_dev)
        keys = keys.astype(np.int32)
        vals = rng.integers(0, 8, (MIXED_ROWS, VW)).astype(np.float32)
        expect = None
        if op == "cas":
            live = sim.table[keys].copy()
            rand = rng.integers(0, 8, (MIXED_ROWS, VW)).astype(np.float32)
            expect = np.where(rng.random(MIXED_ROWS)[:, None] < 0.5, live,
                              rand)
        batch = [(op, keys, vals, expect)]
        oracle_round(sim, batch, False, n_dev)
        trace.append(batch)
    return trace


def phase_drain(torch, dev, gpu, report):
    """kv_drain: kv_mixed's mix with overflow="defer" at capacity 512, half
    a (client, trustee) pair's 1,024-row mean load, shortcut off.  (a)
    max_rounds 8 drains every row: residual 0, the kernel path == the ref
    path bit for bit; (b) per-client disjoint keys, one op a round: == the
    sequential oracle; (c) max_rounds 2: residual > 0, exactly R -
    residual increments land; (d) one dedicated drain round; (e) the
    cost of the retry rounds with nothing left (max_rounds 8 against
    max_rounds = the rounds the trace needs)."""
    from repro_torch.core import SequentialKVReference, use_session
    n_dev = MESH[0] * MESH[1]
    rng = np.random.default_rng(7)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    trace = mixed_trace(rng, init, rounds=DED_MIXED_ROUNDS, r=MIXED_ROWS)
    defer = dict(overflow="defer", local_shortcut=False)
    out = {}
    for impl in ("kernel", "ref"):
        with use_session() as sess:
            st = make_store(dev, impl, impl, DRAIN_CAPACITY, init, sess,
                            f"kv_drain_{impl}", max_rounds=DRAIN_ROUNDS,
                            **defer)
            out[impl] = run_rounds(torch, dev, st, trace, sess) \
                + (st.dump(),)
    (kg, ks, ksec, kt), (rg, rs, _rsec, rt) = out["kernel"], out["ref"]
    check_rounds("kv_drain (a) kernel vs ref", kg, rg)
    require(np.array_equal(kt, rt), "kv_drain (a): final tables differ")
    rounds = [int(s["rounds"]) for s in ks]
    require(all(s["residual"] == 0 for s in ks) and rounds ==
            [int(s["rounds"]) for s in rs] and max(rounds) > 1,
            f"kv_drain (a): rounds {rounds}, residual "
            f"{[s['residual'] for s in ks]}")
    ops = len(trace) * MIXED_ROWS
    report["kv_drain_ops_s"] = ops / ksec
    say(f"[kv_drain a] {len(trace)} rounds x {MIXED_ROWS} rows, capacity "
        f"{DRAIN_CAPACITY}, max_rounds {DRAIN_ROUNDS}: residual 0, rounds "
        f"{rounds}; the kernel path == the ref path bit for bit (every "
        f"response, the final table)")

    dtrace = disjoint_trace(rng, init)
    ref = SequentialKVReference(N_KEYS, VW)
    ref.prefill(init)
    want = [oracle_round(ref, b, False, n_dev) for b in dtrace]
    with use_session() as sess:
        st = make_store(dev, "kernel", "kernel", DRAIN_CAPACITY, init, sess,
                        "kv_drain_disjoint", max_rounds=DRAIN_ROUNDS,
                        **defer)
        got, stats, _s = run_rounds(torch, dev, st, dtrace, sess)
    check_rounds("kv_drain (b) vs the oracle", got, want)
    require(np.array_equal(st.dump(), ref.dump()),
            "kv_drain (b): final table differs from the oracle")
    require(all(s["residual"] == 0 for s in stats),
            "kv_drain (b): rows left")
    say(f"[kv_drain b] per-client disjoint keys, GET / PUT / ADD / CAS "
        f"rounds of {MIXED_ROWS} rows: == the sequential oracle bit for bit "
        f"(rounds {[int(s['rounds']) for s in stats]}, residual 0)")

    from repro_torch.core.routing import sample_keys
    keys = sample_keys(rng, N_KEYS, MIXED_ROWS, "zipf").astype(np.int32)
    with use_session() as sess:
        st = make_store(dev, "kernel", "kernel", DRAIN_CAPACITY,
                        np.zeros((N_KEYS, VW), np.float32), sess,
                        "kv_drain_short", max_rounds=2, **defer)
        got, stats, _s = run_rounds(
            torch, dev, st, [[("add", keys,
                               np.ones((MIXED_ROWS, VW), np.float32),
                               None)]], sess)
        s = stats[0]
        total = float(st.dump().sum())
    require(s["rounds"] == 2 and s["residual"] > 0
            and s["dropped"] == s["residual"]
            and total == (MIXED_ROWS - s["residual"]) * VW,
            f"kv_drain (c): {s}, table sum {total}")
    say(f"[kv_drain c] max_rounds 2: residual {s['residual']} of "
        f"{MIXED_ROWS} rows reported, exactly {MIXED_ROWS - s['residual']} "
        f"increments landed")

    runs = {}
    for impl in ("kernel", "ref"):
        with use_session() as sess:
            st = make_store(dev, impl, impl, DRAIN_CAPACITY, init, sess,
                            f"kv_drain_ded_{impl}",
                            max_rounds=4 * DRAIN_ROUNDS, mode="dedicated",
                            n_dedicated=DED_TRUSTEES, overflow="defer")
            runs[impl] = run_rounds(torch, dev, st, trace[:1], sess) \
                + (st.dump(),)
    (kg2, ks2, _k, kt2), (rg2, _rs, _r, rt2) = runs["kernel"], runs["ref"]
    check_rounds("kv_drain (d) dedicated kernel vs ref", kg2, rg2)
    require(np.array_equal(kt2, rt2) and ks2[0]["residual"] == 0,
            f"kv_drain (d): {ks2[0]}")
    say(f"[kv_drain d] dedicated ({DED_TRUSTEES} trustees), one round of "
        f"{MIXED_ROWS} rows at capacity {DRAIN_CAPACITY}: {ks2[0]['rounds']} "
        f"rounds, residual 0, kernel == ref bit for bit")

    need = max(rounds)
    secs = {}
    for label, m in (("8", DRAIN_ROUNDS), ("need", need),
                     ("8 again", DRAIN_ROUNDS)):
        with use_session() as sess:
            st = make_store(dev, "kernel", "kernel", DRAIN_CAPACITY, init,
                            sess, "kv_drain_t", max_rounds=m, **defer)
            _g, stats, t = run_rounds(torch, dev, st, trace, sess)
            require(all(s["residual"] == 0 for s in stats),
                    f"kv_drain (e) max_rounds {m}: rows left")
            secs[label] = t
            if label == "8":
                busy = step_busy(torch, dev, st, sess, trace[0])
    empty = sum(DRAIN_ROUNDS - r for r in rounds)
    t8 = (secs["8"] + secs["8 again"]) / 2
    per_empty = (t8 - secs["need"]) / empty if empty else float("nan")
    report["kv_drain_empty_round_ms"] = 1e3 * per_empty
    say(f"[kv_drain] {gpu} | {ops} ops: max_rounds {DRAIN_ROUNDS} "
        f"{ops / secs['8']:.1f} and {ops / secs['8 again']:.1f} ops/s, "
        f"max_rounds {need} (the most any round needs) "
        f"{ops / secs['need']:.1f} ops/s; {empty} retry rounds with nothing "
        f"left cost {1e3 * (t8 - secs['need']):.3f} ms, "
        f"{1e3 * per_empty:.3f} ms each (host clock around a synchronize); "
        f"device busy over 10 rounds at max_rounds {DRAIN_ROUNDS} "
        f"{busy_text(busy)}")


def combined_rows(batches, n_dev):
    """Host count of the rows combining keeps off the wire: rows sharing
    (client, destination, op, key) with an earlier row, CAS excluded."""
    r_dev = -(-sum(len(b[1]) for b in batches) // n_dev)
    off, n = 0, 0
    for op, keys, _v, _e in batches:
        pos = off + np.arange(len(keys))
        off += len(keys)
        if op == "cas":
            continue
        client = pos // r_dev
        n += len(keys) - len(set(zip(client.tolist(), keys.tolist())))
    return n


def phase_combine(torch, dev, gpu, report):
    """kv_combine: Zipf(1.1) over 1,000,000 keys, kv_mixed's mix at 65,536
    rows a round (CAS never combines), shortcut off, capacity the rows of
    a client shard: combine "ref" == "off" == the sequential oracle bit
    for bit (every response, the table); rows_combined == the host count
    of duplicate (client, destination, op, key) rows; ops/s of both."""
    from repro_torch.core import SequentialKVReference, use_session
    n_dev = MESH[0] * MESH[1]
    rng = np.random.default_rng(1111)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    trace = mixed_trace(rng, init, rounds=COMBINE_ROUNDS, r=MIXED_ROWS,
                        alpha=1.1)
    ref = SequentialKVReference(N_KEYS, VW)
    ref.prefill(init)
    want = [oracle_round(ref, b, False, n_dev) for b in trace]
    runs, busy = {}, {}
    for combine in ("off", "ref"):
        with use_session() as sess:
            st = make_store(dev, "kernel", "kernel", MIXED_ROWS // n_dev,
                            init, sess, f"kv_combine_{combine}",
                            local_shortcut=False, combine=combine)
            got, stats, secs = run_rounds(torch, dev, st, trace, sess)
            require(all(s["dropped"] == 0 for s in stats),
                    f"kv_combine {combine}: rows overflowed")
            runs[combine] = (got, stats, secs, st.dump())
            busy[combine] = step_busy(torch, dev, st, sess, trace[0])
    for combine, (got, _s, _t, table) in runs.items():
        check_rounds(f"kv_combine {combine} vs the oracle", got, want)
        require(np.array_equal(table, ref.dump()),
                f"kv_combine {combine}: final table differs")
    host = [combined_rows(b, n_dev) for b in trace]
    comb = [int(s["rows_combined"]) for s in runs["ref"][1]]
    require(comb == host and sum(comb) > 0 and not any(
        s["rows_combined"] for s in runs["off"][1]),
        f"kv_combine: rows_combined {comb}, host count {host}")
    saved = sum(int(s["req_bytes_saved"]) for s in runs["ref"][1])
    ops = len(trace) * MIXED_ROWS
    for combine in ("off", "ref"):
        report[f"kv_combine_{combine}_ops_s"] = ops / runs[combine][2]
    say(f"[kv_combine] {len(trace)} rounds x {MIXED_ROWS} rows, Zipf(1.1): "
        f"combine ref == off == the sequential oracle bit for bit (every "
        f"response, the final table); rows combined {comb} == the host "
        f"count of duplicate (client, destination, op, key) rows")
    say(f"[kv_combine] {gpu} | combine off "
        f"{report['kv_combine_off_ops_s']:.1f} ops/s, ref "
        f"{report['kv_combine_ref_ops_s']:.1f} ops/s; wire rows saved "
        f"{sum(comb)} of {ops} ({100 * sum(comb) / ops:.1f}%), "
        f"{saved} request bytes; device busy over 10 rounds: off "
        f"{busy_text(busy['off'])}, ref {busy_text(busy['ref'])}")


# ---------------------------------------------------------------------------
# phase 4f: failover (kv_failover)
# ---------------------------------------------------------------------------

FO_ROWS = 8232                  # a wave: divisible by 8 and by 7 shards
FO_CAPACITY = 2058              # rows of the largest client shard reached
FO_WAVES = 40
FO_SNAP_EVERY = 8
FO_KILL = {"shared": (21, 3), "dedicated": (21, 6)}
FO_DEDICATED = 3                # (b): 3 of 8 shards trustees
FO_PAGED_ROWS = 56              # a page-table wave: divisible by 8 and 7
FO_PAGED_WAVES = 20


def fo_store(dev, impl, init, sess, **kw):
    return make_store(dev, impl, impl, FO_CAPACITY, init, sess, "kv",
                      local_shortcut=False, **kw)


def fo_chaos(torch, dev, impl, init, waves, schedule, snap_every, **kw):
    """One 40-wave run of ``testing.failover.run_kv_chaos`` on a fresh
    store; returns its record with the final table, stats and layout."""
    import shutil
    import tempfile
    from repro_torch.core import use_session
    from repro_torch.testing import failover as fo
    ckdir = tempfile.mkdtemp(prefix="kv_failover_")
    try:
        with use_session() as sess:
            st = fo_store(dev, impl, init, sess, **kw)
            out = fo.run_kv_chaos(st, sess, waves, ckdir, dev,
                                  schedule=schedule, snap_every=snap_every,
                                  sync=lambda: device_sync(torch, dev))
            out.update(table=st.dump(), stats=sess.last_stats(), t=st.t,
                       shards=st.group.axis_size,
                       region=st.client_region())
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return out


def device_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def fo_check(label, init, waves, runs, replays):
    """(a) / (b)'s checks: one kill, every replayed ack == its original,
    the whole history and the final table == the oracle, the kernel path
    == the ref path, ``replayed_rounds``."""
    from repro_torch.testing import failover as fo
    k = runs["kernel"]
    for impl, r in runs.items():
        require(len(r["failures"]) == 1 and r["failures"][0][0] == "kill",
                f"kv_failover {label} {impl}: failures {r['failures']}")
        require(r["replay_equal"], f"kv_failover {label} {impl}: a replayed "
                f"wave answered otherwise than its original ack")
        rec = r["stats"]["recovery"]
        require(rec["replayed_rounds"] == replays and rec["restores"] == 1,
                f"kv_failover {label} {impl}: recovery {rec}")
        require(r["shards"] == MESH[0] * MESH[1] - 1,
                f"kv_failover {label} {impl}: {r['shards']} shards after "
                f"the kill")
    bad, want = fo.check_kv_history(init, waves, k["acked"])
    require(bad is None, f"kv_failover {label}: {bad}")
    require(np.array_equal(k["table"], want),
            f"kv_failover {label}: final table differs from the oracle")
    r = runs["ref"]
    require(all(fo.same_acks(k["acked"][i][0], r["acked"][i][0])
                for i in range(len(waves)))
            and np.array_equal(k["table"], r["table"]),
            f"kv_failover {label}: the kernel and ref paths differ")


def phase_failover(torch, dev, gpu, report):
    """kv_failover: (a) kv_paper's table (1,000,000 x 4 f32, 2x4 stacked,
    shared, shortcut off), kv_mixed's mix at 8,232 rows a wave, capacity
    2,058, 40 waves with a snapshot every 8: shard 3 killed at wave 21,
    the state re-entrusted onto 7 from the wave-16 snapshot, 5 waves
    replayed; (b) the same, dedicated with 3 of 8 trustees, trustee shard
    6 killed; (c) a drop and a tear on the kernel path; (d) the page table
    at phase 5's geometry, shard 3 killed at a snapshot boundary.  Launch
    counters are zeroed before each part; (a) must launch the four KV
    kernels, (d) the page-table serve.  Returns the launches."""
    import shutil
    import tempfile
    from repro_torch.core import (DelegatedPageTable, SequentialKVReference,
                                  StackedMesh, use_session)
    from repro_torch.kernels import ops as kops
    from repro_torch.testing import failover as fo
    total = {k: 0 for k in SOURCES}

    def counted(need):
        counts = kops.launch_counts()
        for k in need:
            require(counts[k] > 0, f"kernel {k} was not launched on the "
                    f"kv_failover path")
        for k, v in counts.items():
            total[k] += v
        return counts

    init, waves = fo.mixed_waves(23, N_KEYS, VW, FO_ROWS, FO_WAVES)
    replays = FO_KILL["shared"][0] - FO_KILL["shared"][0] \
        // FO_SNAP_EVERY * FO_SNAP_EVERY
    # (a) shared, shortcut off
    runs = {}
    for impl in ("kernel", "ref"):
        kops.reset_launch_counts()
        runs[impl] = fo_chaos(torch, dev, impl, init, waves,
                              {FO_KILL["shared"][0]: ("kill",
                                                      FO_KILL["shared"][1])},
                              FO_SNAP_EVERY)
        counts = counted(KV_KERNELS if impl == "kernel" else ())
        if impl == "kernel":
            say(f"[main path] kv_failover (a) launches: "
                f"{json.dumps(counts)}")
    fo_check("(a)", init, waves, runs, replays)
    k = runs["kernel"]
    require(k["t"] == MESH[0] * MESH[1] - 1, f"kv_failover (a): T {k['t']}")
    say(f"[kv_failover a] {FO_WAVES} waves x {FO_ROWS} rows, shard "
        f"{FO_KILL['shared'][1]} killed at wave {FO_KILL['shared'][0]}: "
        f"re-entrusted onto {k['shards']} shards from the snapshot, "
        f"{replays} waves replayed, each == its original ack; the whole "
        f"acked history and the final table == the sequential oracle; "
        f"kernel path == ref path bit for bit")
    # snapshots every 8 against none (no kill), kernel path, none first
    secs = {}
    for snap in (0, FO_SNAP_EVERY, FO_SNAP_EVERY, 0):
        kops.reset_launch_counts()
        r = fo_chaos(torch, dev, "kernel", init, waves, None, snap)
        counted(KV_KERNELS)
        require(all(fo.same_acks(r["acked"][i][0], k["acked"][i][0])
                    for i in range(FO_WAVES)),
                "kv_failover: an undisturbed run differs from the chaos run")
        secs.setdefault(snap, []).append(r["seconds"])
    ops = FO_ROWS * FO_WAVES
    with_s, without = min(secs[FO_SNAP_EVERY]), min(secs[0])
    first = k["first_after"]
    report["kv_failover_snapshots_ops_s"] = ops / with_s
    report["kv_failover_no_snapshots_ops_s"] = ops / without
    say(f"[kv_failover a] {gpu} | checkpoint of the {N_KEYS * VW * 4 / 1e6:.0f}"
        f" MB table: " + ", ".join(f"{x:.3f}" for x in k["ckpt_ms"])
        + f" ms; recovery_ms {k['stats']['recovery']['recovery_ms']:.3f}; "
        f"a replayed round " + ", ".join(f"{x:.3f}" for x in k["replay_ms"])
        + f" ms; the first wave on {k['shards']} shards (wave {first}) "
        f"{FO_ROWS / k['wave_s'][first]:.1f} ops/s")
    say(f"[kv_failover a] {gpu} | {FO_WAVES} waves, snapshot every "
        f"{FO_SNAP_EVERY}: {ops / with_s:.1f} ops/s ("
        + ", ".join(f"{x:.3f}" for x in secs[FO_SNAP_EVERY])
        + f" s) against none: {ops / without:.1f} ops/s ("
        + ", ".join(f"{x:.3f}" for x in secs[0]) + " s)")

    # (b) dedicated, 3 of 8 trustees, a trustee shard killed
    ded = dict(mode="dedicated", n_dedicated=FO_DEDICATED)
    kill = FO_KILL["dedicated"]
    runs = {}
    for impl in ("kernel", "ref"):
        kops.reset_launch_counts()
        runs[impl] = fo_chaos(torch, dev, impl, init, waves,
                              {kill[0]: ("kill", kill[1])}, FO_SNAP_EVERY,
                              **ded)
        counted(KV_KERNELS if impl == "kernel" else ())
        require(runs[impl]["region"].size and not runs[impl]["region"].any(),
                f"kv_failover (b) {impl}: the client region holds state")
    fo_check("(b)", init, waves, runs, replays)
    require(runs["kernel"]["t"] == FO_DEDICATED,
            f"kv_failover (b): T {runs['kernel']['t']}")
    say(f"[kv_failover b] dedicated, {FO_DEDICATED} of {MESH[0] * MESH[1]} "
        f"shards trustees: trustee shard {kill[1]} killed at wave {kill[0]},"
        f" re-entrusted onto {runs['kernel']['shards']} shards "
        f"({runs['kernel']['shards'] - FO_DEDICATED} clients), {replays} "
        f"waves replayed == the originals; history and table == the "
        f"oracle, kernel == ref, the client region zeros; recovery_ms "
        f"{runs['kernel']['stats']['recovery']['recovery_ms']:.3f}")

    # (c) a drop and a tear on the kernel path
    kops.reset_launch_counts()
    ref = SequentialKVReference(N_KEYS, VW)
    ref.prefill(init)
    with use_session() as sess:
        st = fo_store(dev, "kernel", init, sess)
        for i, kind in enumerate(("drop", "tear")):
            r = fo.tear_and_retry(st, sess, waves[i], dev, kind, shard=2)
            require(r["raised"] and r["unchanged"] and r["still_open"],
                    f"kv_failover (c) {kind}: {r}")
            require(fo.same_acks(r["acks"], fo.oracle_wave(ref, waves[i])),
                    f"kv_failover (c) {kind}: the retry's acks differ from "
                    f"the oracle")
        require(np.array_equal(st.dump(), ref.dump()),
                "kv_failover (c): the table after the retries differs")
    counted(KV_KERNELS)
    say("[kv_failover c] a drop (wave 0) and a tear (wave 1) on the kernel "
        "path: the round ran, every table stayed bit-identical, the futures "
        "stayed open and queued; each retry == the oracle")

    # (d) the page table at phase 5's geometry, shard 3 killed
    g = PAGED
    pwaves = fo.paged_waves(94, FO_PAGED_ROWS, FO_PAGED_WAVES,
                            g["max_seqs"], g["max_pages"], g["page_size"])
    res = {}
    for pdev in (dev, torch.device("cpu")):
        kops.reset_launch_counts()
        ckdir = tempfile.mkdtemp(prefix="paged_failover_")
        try:
            with use_session() as sess:
                pt = DelegatedPageTable(
                    StackedMesh(MESH, device=pdev), g["n_pages"],
                    max_seqs=g["max_seqs"], page_size=g["page_size"],
                    max_pages=g["max_pages"], capacity=FO_PAGED_ROWS,
                    local_shortcut=False, session=sess)
                res[pdev.type] = fo.run_paged_chaos(
                    pt, sess, pwaves, ckdir, kill_wave=8, kill_shard=3,
                    snap_every=4, survivors=MESH[0] * MESH[1] - 1)
                res[pdev.type]["t"] = pt.t
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        if pdev.type == "cuda":
            counted(("pagetable_serve",))
    card = res[dev.type]
    plain = res["cpu"]
    require(card["failures"] == 1 and card["t"] == MESH[0] * MESH[1] - 1,
            f"kv_failover (d): failures {card['failures']}, T {card['t']}")
    require(not card["errors"], f"kv_failover (d): {card['errors'][:4]}")
    require(all(a["consistent"] for a in card["audits"])
            and card["final_audit"]["allocated"] == 0,
            f"kv_failover (d): audits {card['audits']}, at the end "
            f"{card['final_audit']}")
    require(all(all(np.array_equal(card["acks"][w][f], plain["acks"][w][f])
                    for f in card["acks"][w]) for w in card["acks"])
            and all(np.array_equal(card["state"][x], plain["state"][x])
                    for x in card["state"]),
            "kv_failover (d): the card differs from the plain version")
    say(f"[kv_failover d] page table at phase 5's geometry "
        f"({g['n_pages']} pages of {g['page_size']}, {g['max_pages']}-page "
        f"chains, {g['max_seqs']} sequences), {FO_PAGED_WAVES} waves x "
        f"{FO_PAGED_ROWS} rows, shard 3 killed at wave 8 (a snapshot): "
        f"every ack == the resharded oracle, the card == the plain "
        f"version, audits consistent "
        f"({card['audits'][-1]['allocated']} pages allocated), 0 pages "
        f"leaked at the end")
    return total


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


def pack_work(torch, args):
    """``rooflines.pack_work`` at these inputs: the rows the pack places
    are each destination's first C + C2 (an inactive or dropped row's
    words need not be read)."""
    dst, words, t, c, c2 = args
    d, r, w = words.shape
    per = torch.zeros((d, t + 1), dtype=torch.int64, device=dst.device)
    per.scatter_add_(1, torch.where(dst >= 0, dst, t).long(),
                     torch.ones_like(dst, dtype=torch.int64))
    placed = int(per[:, :t].clamp(max=c + c2).sum())
    return rooflines.pack_work(d, r, w, t, c, c2, placed)


def serve_work(torch, name, case, which=0):
    """``rooflines``' bound of a serve kernel at this case's data: the
    gather lane's rows (CAS: with expect and flag), scatter_last's PUT
    segments, segmented_add's ADD rows and segments."""
    t, n = case["keys"].shape
    w = case["table"].shape[-1]
    lane = case["lane"]
    if name == "gather":
        return rooflines.gather_work(t, n, w, int((lane == which).sum()),
                                     cas=which == 3)
    order, sid = case["order"], case["sid"]
    lane_s = torch.gather(lane, 1, order.long())
    pos = torch.arange(n, device=lane.device)
    if name == "scatter_last":
        return rooflines.scatter_last_work(
            t, n, w, int(((sid == pos) & (lane_s == 1)).sum()))
    return rooflines.segmented_add_work(
        t, n, w, int((lane_s == 2).sum()),
        int(((sid == pos) & (lane_s == 2)).sum()))


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


def capture_first(torch, label, plan, params, batch):
    """A prefill cell's first call, untimed: a captured program's first
    call runs the step eagerly and captures it (``core.compiled``), so
    the timed calls after it replay; the capture's time and pool are
    printed apart."""
    from repro_torch.core import compiled
    n = len(compiled.captures())
    plan.step_fn(params, batch)
    torch.cuda.synchronize()
    for c in compiled.captures()[n:]:
        say(f"[compiled] {label}: {c['site']} captured in "
            f"{c['capture_ms']:.1f} ms, pool {c['pool_bytes'] / 2 ** 20:.1f} "
            f"MiB (the timed calls replay it)")


def same_as_check(torch, label, got, ref):
    """A timed call's output (a replay) against ``ref``, the eager check
    run's on the same batch (kept on the host), bit for bit."""
    got = got.cpu()
    require(torch.equal(got, ref),
            f"{label}: a timed call differs from the check run (max abs "
            f"diff {float((got.float() - ref.float()).abs().max()):.3g})")


def park(torch, tree, dev):
    """``tree`` (tuples, lists and dicts; other leaves as they are) with
    every tensor moved to ``dev``: kernel inputs kept for a later timing
    wait on the host while a large model's step is captured beside its
    weights (phase 9's during phases 11-15: qwen1.5-32b's prefill
    program needs the ~3 GB they hold; phase 13's during its prefill's
    capture)."""
    if isinstance(tree, dict):
        return {k: park(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(park(torch, v, dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree


def lane_lines(case, which):
    """The flat table lines (int64, shard * K + key) that the rows of lane
    ``which`` read, in row order: an index for index_select / index_add_."""
    k = case["table"].shape[1]
    rows = (case["lane"] == which).nonzero()
    return (rows[:, 0] * k + case["keys"][rows[:, 0], rows[:, 1]]).long()


GATHER_LANES = {0: "GET", 2: "ADD", 3: "CAS"}


def gather_times(torch, dev, gpu, label, case, per_round, measured):
    """The gather at one main path's shapes, lane by lane (kv_paper's
    rounds read GET only; kv_mixed's GET, the ADD base and the CAS current
    with its compare): the profiler's and CUDA events' readings beside the
    lane's byte bound, an empty launch of the same grid (the latency
    floor), the plain version, index_select of the lane's lines (GET, ADD)
    and the launches per lane on the main path."""
    from repro_torch.kernels import delegation_serve as kds
    from repro_torch.kernels import ops as kops
    table, keys, lane = case["table"], case["keys"], case["lane"]
    t, n = keys.shape
    k, w = table.shape[1:]
    out = torch.zeros((t, n, w), device=dev)
    flag = torch.zeros((t, n), dtype=torch.int32, device=dev)
    plan = kds.gather_plan(t, n, w, kds.word_vec(w, table, out,
                                                 case["expect"]))
    floor, f_lo, f_hi, f_seen = device_readings(
        torch, lambda: kds.gather_empty_launch(plan, dev),
        "gather_empty_kernel")
    f_ev, _, f_ahead = ahead_ms(torch, lambda: kds.gather_empty_launch(
        plan, dev))
    # the keys and lanes alone: the kernel over a lane tensor with no row
    # of any lane, which reads its T*N keys and lanes and nothing else
    none = torch.full_like(lane, -1)
    idx_ms = device_readings(torch, lambda: kds.gather(
        table, keys, none, 0, out), KERNEL_NAMES["gather"])[0]
    shape = f"{plan['blocks']} blocks of {kds.GATHER_THREADS} threads"
    say(f"[times] {gpu} | gather latency floor @ {label}: {floor:.6f} ms "
        f"(an empty kernel on the gather's grid, {shape}; median of 5 "
        f"profiler readings {f_lo:.6f}..{f_hi:.6f}, records kept {f_seen}; "
        f"CUDA events with the host {'ahead' if f_ahead else 'NOT ahead'} "
        f"{f_ev:.6f} ms/call); the keys and lanes alone (no row of the "
        f"lane) {idx_ms:.6f} ms by the profiler, bound "
        f"{8 * t * n / HBM_BYTES_PER_S * 1e3:.6f} ms")
    # the L2 flushed before each call (a 256 MiB fill), as a serve round's
    # other work may leave it
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    lanes = (0,) if label == "kv_paper" else (0, 2, 3)
    for which in lanes:
        cas = which == 3
        kw = dict(expect=case["expect"], flag=flag) if cas else {}
        call = lambda impl, which=which, kw=kw: kops.gather(
            table, keys, lane, which, out, impl=impl, **kw)
        ms, lo, hi, seen = device_readings(torch, lambda: call("kernel"),
                                           KERNEL_NAMES["gather"])
        cold = device_readings(torch, lambda: (flush.zero_(),
                                               call("kernel")),
                               KERNEL_NAMES["gather"])[0]
        ev, host, ahead = ahead_ms(torch, lambda: call("kernel"))
        if ms == 0:                 # the profiler kept no kernel record
            ms = ev
        work = serve_work(torch, "gather", case, which)
        nbytes, bound = work.nbytes, work.ms
        plain = yardstick(torch, lambda: call("ref"), iters=5)
        if cas:
            lib_txt = ("library n/a (no one PyTorch call reads the lines "
                       "and compares them with expect: index_select, eq and "
                       "all are three calls with two intermediates)")
            lib = None
        else:
            idx = lane_lines(case, which)
            flat = table.view(-1, w)
            lib = yardstick(torch, lambda: flat.index_select(0, idx))
            lib_bound = (8 * idx.numel() + 2 * 4 * idx.numel() * w) \
                / HBM_BYTES_PER_S * 1e3
            lib_txt = (reading("library", lib, lib_bound)
                       + " (index_select of the lane's lines)")
        rows = int((lane == which).sum())
        name = GATHER_LANES[which]
        say(f"[times] {gpu} | gather @ {label} {name} ({rows} of {t} x {n} "
            f"rows{', expect and flag' if cas else ''}): {ms:.6f} ms/call "
            f"(median of the profiler readings that kept records, "
            f"{lo:.6f}..{hi:.6f}, records kept per reading of 20 calls "
            f"{seen}; L2 flushed before each call {cold:.6f}; CUDA events "
            f"with the host {'ahead' if ahead else 'NOT ahead'} {ev:.6f} "
            f"ms/call, host issue {host:.6f} ms/call; {ms - floor:.6f} ms "
            f"above the latency floor), bound {bound:.6f} ms ({nbytes} bytes; "
            f"{share(ev, bound)} by events), {reading('plain', plain, bound)}"
            f", {lib_txt}, "
            f"{per_round['gather_lanes'][label][which]:.3f} launches/round "
            f"of this lane on the main path")
        measured[("gather", f"{label} {name}")] = (
            ms, plain[0], bound, None if lib is None else lib[0])
        if which == 0:
            measured[("gather", label)] = measured[("gather",
                                                    f"{label} {name}")]
    del flush


def phase_times(torch, dev, shapes, errs, per_round, gpu):
    """Each kernel's time at the main path's shapes beside its bound, its
    plain version and a library yardstick; the busy share of a round."""
    from repro_torch.kernels import ops as kops
    measured = {}

    def emit(name, label, fn_kernel, fn_plain, fn_lib, work, lib_bytes=0,
             floor=None):
        ms, lo, hi, seen = device_readings(
            torch, fn_kernel, KERNEL_NAMES[name],
            per_call=LAUNCHES_PER_CALL.get(name, 1))
        ev, host, ahead = ahead_ms(torch, fn_kernel)
        if ms == 0:                 # the profiler kept no kernel record
            ms = ev
        nbytes, bound = work.nbytes, work.ms
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
             pack_work(torch, args))

    for label, key in (("kv_paper", "serve_paper"),
                       ("kv_mixed", "serve_mixed")):
        case = serve_case(torch, dev, **shapes[key], seed=31)
        t, n = case["keys"].shape
        w = case["table"].shape[-1]
        flag_put = (case["lane"] == 1).to(torch.int32)
        resp = torch.zeros((t, n, w), device=dev)
        table = case["table"].clone()
        gather_times(torch, dev, gpu, label, case, per_round, measured)
        calls = {
            "scatter_last": lambda impl: kops.scatter_last(
                table, case["keys"], case["order"], case["seg_end"],
                flag_put, case["value"], impl=impl),
        }
        if label == "kv_mixed":      # kv_paper's rounds carry no ADD rows
            calls["segmented_add"] = lambda impl: kops.segmented_add(
                table, case["keys"], case["lane"], case["order"],
                case["sid"], case["seg_end"], case["value"], resp,
                impl=impl)
        # library yardstick (timed here only; the port never calls it):
        # index_add_ adds the ADD lane's deltas into the table (the totals,
        # not the priors)
        add_idx = lane_lines(case, 2)
        add_rows = (case["lane"] == 2).nonzero()
        add_val = case["value"][add_rows[:, 0], add_rows[:, 1]]
        flat_table = table.view(-1, w)
        library = {
            "scatter_last": None,
            "segmented_add": lambda: flat_table.index_add_(0, add_idx,
                                                           add_val),
        }
        # what each library call must move: its int64 indices and the rows
        # read and written (index_add_: each distinct line in and out once)
        lib_bytes = {
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
                 library[name], serve_work(torch, name, case),
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
# the gemma-7b prefill: 16 heads of 256
FA_GEMMA = dict(b=4, hq=16, hkv=16, sq=2048, skv=2048, d=256)


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
        # D 256 (gemma-7b): 64-key KV tiles, the register split
        ("D 256, the gemma prefill's shape and layout", dict(FA_GEMMA,
                                                            bshd=True),
         {}, False),
        ("D 256, ragged Sq = Skv = 333", dict(b=1, hq=4, hkv=4, sq=333,
                                             skv=333, d=256), {}, False),
        ("D 256, Skv 1", dict(b=2, hq=4, hkv=4, sq=1, skv=1, d=256), {},
         False),
        ("D 256, q_offset 77, Skv 377",
         dict(b=1, hq=8, hkv=8, sq=300, skv=377, d=256),
         dict(q_offset=77), False),
        ("D 256, MQA", dict(b=1, hq=8, hkv=1, sq=256, skv=256, d=256), {},
         False),
        ("D 256, causal=False, Sq 200, Skv 640",
         dict(b=2, hq=4, hkv=4, sq=200, skv=640, d=256),
         dict(causal=False), False),
        # the seamless encoder and its decoder's cross-attention (D 64)
        ("D 64, causal=False, the seamless encoder's shape",
         dict(b=4, hq=16, hkv=16, sq=2048, skv=2048, d=64, bshd=True),
         dict(causal=False), False),
        ("D 64, causal=False, Sq 512 over Skv 2048 (cross-attention)",
         dict(b=4, hq=16, hkv=16, sq=512, skv=2048, d=64, bshd=True),
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
    and ``N_REQUESTS`` requests."""
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


def paged_run(torch, dev, inputs, check=False, n_requests=None,
              record=False):
    from repro_torch.launch.paged_decode import run_decode
    cfg, params, xs, reqs = inputs
    return run_decode(cfg, requests=reqs[:n_requests], dtype=torch.bfloat16,
                      device=dev, params=params, xs=xs, check=check,
                      record=record, **PAGED)


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
        # the comparisons read the host: the rounds run eagerly
        from repro_torch.core import compiled
        compiled.forbid_host_read("KernelRecorder")
        self._eager = compiled.disable()
        self._eager.__enter__()
        self.kops.pagetable_serve = self.pagetable_serve
        self.kops.paged_attention = self.paged_attention
        return self

    def __exit__(self, *exc):
        self.kops.pagetable_serve = self._pt
        self.kops.paged_attention = self._pa
        self._eager.__exit__(*exc)

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


def paged_dedicated(torch, dev):
    """A dedicated page table (the last 4 of the 8 shards trustees) at
    phase 5's geometry and at phase 2's stress geometry, driven by phase
    2's stress trace: on the card == the plain version (the CPU) bit for
    bit, every wave == the oracle replayed in serve order, and the client
    shards' state all zeros after it."""
    from repro_torch.core import DelegatedPageTable, StackedMesh, use_session
    from repro_torch.testing.pagetable import (
        STRESS_GEOMETRY, replay_waves, stress_waves, submit_waves)
    for label, g in (("phase 5's geometry", PAGED),
                     ("the stress geometry", STRESS_GEOMETRY)):
        runs = {}
        for side, d in (("card", dev), ("plain", torch.device("cpu"))):
            with use_session():
                pt = DelegatedPageTable(StackedMesh(MESH, device=d),
                                        g["n_pages"], max_seqs=g["max_seqs"],
                                        page_size=g["page_size"],
                                        max_pages=g["max_pages"],
                                        capacity=256, mode="dedicated",
                                        n_dedicated=DED_TRUSTEES)
                rec = submit_waves(pt, stress_waves(61))
                rows = replay_waves(pt, rec)
                resps = [[pt.globalize(f.result(), sq) for _o, sq, _a, f
                          in w] for w in rec]
                runs[side] = (resps, pt.dump(), pt.audit(),
                              pt.client_region())
        (gw, gs, ga, gr), (ww, ws, _a, _r) = runs["card"], runs["plain"]
        require(all(all(np.array_equal(ra[k], rb[k]) for k in rb)
                    for a, b in zip(gw, ww) for ra, rb in zip(a, b))
                and all(np.array_equal(gs[k], ws[k]) for k in ws),
                f"pagetable_serve [dedicated, {label}]: the card differs "
                f"from the plain version")
        require(ga["consistent"] and ga["leaked"] == 0 and all(
            v.size and not v.any() for v in gr.values()),
            f"pagetable_serve [dedicated, {label}]: audit {ga}, or the "
            f"client region holds state")
        say(f"[paged dedicated] {label}, {DED_TRUSTEES} trustees serving "
            f"{MESH[0] * MESH[1] - DED_TRUSTEES} clients, the stress trace: "
            f"the card == the plain version bit for bit, == the sequential "
            f"oracle in serve order ({rows} rows, {ga['evictions']} "
            f"evictions), audit clean, the client shards' state all zeros")


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

    paged_dedicated(torch, dev)

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

# prefill_step at B 4 x 2048 tokens; serve.main over 8 requests, 64
# prompt tokens teacher-forced and 64 generated (128 + 128 before phase 12
# needed the time), the KV cache's sequence split over 4 stacked trustees
# (36 x 2 x 8 x 2 x 128 x 128 bf16, 18.9 MB)
QWEN_PREFILL = dict(batch=4, seq=2048)
QWEN_SERVE = dict(batch=8, prompt_len=64, gen=64, mesh_model=4)
QWEN_TIMED_RUNS = 3
QWEN_CHAOS = dict(wave=40, snap_every=8)   # the chaos session serve


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
    (b) serve.main, 8 x (64 + 64) tokens over 4 trustees; (c) the
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

    ref = logits.cpu()
    capture_first(torch, "qwen prefill", plan, params, {"tokens": tokens})
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
        same_as_check(torch, "qwen prefill", again, ref)
    say(f"[main path] qwen prefill launches (each of {QWEN_TIMED_RUNS} timed "
        f"runs): {json.dumps(counts)}")
    med = sorted(secs)[len(secs) // 2]
    report["qwen_prefill"] = dict(seconds=secs, tokens_per_s=b * s / med)
    say(f"[qwen] {gpu} | prefill B {b} x {s}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in secs)
        + f" ms; median {b * s / med:.1f} tokens/s")
    chk_inputs = chk.first
    plan.release()
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

    # the --session serve: each generated token's ledger and meter ADDs in
    # one fused round, through a streaming driver of depth 2, on the CUDA
    # serve kernels
    sstats = {}
    session_flags = ["--session", "--stream-depth", "2", "--serve-impl",
                     "pallas"]
    kops.reset_launch_counts()
    sout = serve.main(qwen_serve_argv() + session_flags, stats=sstats)
    session_counts = kops.launch_counts()
    say(f"[main path] qwen session serve launches: "
        f"{json.dumps(session_counts)}")
    for k in ("delegation_pack", "segmented_add", "gather"):
        require(session_counts[k] > 0, f"kernel {k} was not launched on the "
                f"session serve's path")
    b, g = QWEN_SERVE["batch"], QWEN_SERVE["gen"]
    require(np.array_equal(sout, out), "session serve: the generated tokens "
            "differ from the plain serve's")
    require(sstats["ledger"].tolist() == [g] * b,
            f"session serve: ledger {sstats['ledger'].tolist()}")
    require(int(sstats["meter"].sum()) == b * g,
            f"session serve: meter {sstats['meter'].tolist()}")
    require(sstats["fused_waves"] == [[["ledger", "meter"]]] * g,
            "session serve: a wave was not one fused round of both trusts")
    report["qwen_session_serve"] = sstats
    for label, extra in (("dedicated", ["--delegation-mode", "dedicated"]),
                         ("drain", ["--drain-rounds", "3"])):
        xstats = {}
        kops.reset_launch_counts()
        xout = serve.main(qwen_serve_argv() + session_flags + extra,
                          stats=xstats)
        xcounts = kops.launch_counts()
        say(f"[main path] qwen session serve ({label}) launches: "
            f"{json.dumps(xcounts)}")
        for k in ("delegation_pack", "segmented_add", "gather"):
            require(xcounts[k] > 0, f"kernel {k} was not launched on the "
                    f"{label} session serve's path")
            session_counts[k] += xcounts[k]
        require(np.array_equal(xout, out), f"{label} session serve: the "
                f"generated tokens differ from the plain serve's")
        require(xstats["ledger"].tolist() == [g] * b
                and int(xstats["meter"].sum()) == b * g,
                f"{label} session serve: ledger {xstats['ledger'].tolist()},"
                f" meter {xstats['meter'].tolist()}")
        require(not xstats["client_region"].any(),
                f"{label} session serve: the ledger's client region holds "
                f"state")
        if label == "drain":
            require(xstats["drain"]["residual"] == 0,
                    f"drain session serve: {xstats['drain']}")
        report[f"qwen_session_{label}_serve"] = xstats
        say(f"[qwen session {label}] {gpu} | serve "
            + " ".join(session_flags + extra) + f": tokens == the plain "
            f"serve's, ledger {g} for each of {b} requests, meter sum "
            f"{b * g}"
            + (f", the ledger's drain {xstats['drain']}"
               if label == "drain" else ", the ledger and meter on the "
               "last 2 of 4 shards, their client region zeros")
            + f"; {xstats['tokens_per_s']:.1f} tokens/s "
            f"({xstats['ms_per_step']:.3f} ms/step)")
    # the same session serve with its round torn at wave 40: the snapshot
    # of wave 40 restored, nothing to replay, the torn wave retried
    chaos_flags = ["--chaos", str(QWEN_CHAOS["wave"]), "--chaos-snap-every",
                   str(QWEN_CHAOS["snap_every"])]
    cstats = {}
    kops.reset_launch_counts()
    cout = serve.main(qwen_serve_argv() + session_flags + chaos_flags,
                      stats=cstats)
    ccounts = kops.launch_counts()
    say(f"[main path] qwen session serve (chaos) launches: "
        f"{json.dumps(ccounts)}")
    for k in ("delegation_pack", "segmented_add", "gather"):
        require(ccounts[k] > 0, f"kernel {k} was not launched on the chaos "
                f"session serve's path")
        session_counts[k] += ccounts[k]
    crec = cstats["recovery"]
    require(np.array_equal(cout, out), "chaos session serve: the generated "
            "tokens differ from the plain serve's")
    require(cstats["ledger"].tolist() == [g] * b
            and int(cstats["meter"].sum()) == b * g,
            f"chaos session serve: ledger {cstats['ledger'].tolist()}, "
            f"meter {cstats['meter'].tolist()}")
    require(crec is not None and crec["restores"] == 1, f"chaos session "
            f"serve: recovery {crec}")
    report["qwen_session_chaos_serve"] = cstats
    say(f"[qwen session chaos] {gpu} | serve " + " ".join(
        session_flags + chaos_flags) + f": the round torn at wave "
        f"{QWEN_CHAOS['wave']} recovered ({crec}); tokens == the plain "
        f"serve's, ledger {g} for each of {b} requests; "
        f"{cstats['tokens_per_s']:.1f} tokens/s "
        f"({cstats['ms_per_step']:.3f} ms/step)")
    say(f"[qwen session] {gpu} | serve --session --stream-depth 2 "
        f"--serve-impl pallas: tokens == the plain serve's, ledger "
        f"{g} for each of {b} requests, meter {sstats['meter'].tolist()} "
        f"(sum {b * g}), all {g} waves fused [['ledger', 'meter']]; "
        f"{sstats['tokens_per_s']:.1f} tokens/s beside the plain serve's "
        f"{stats['tokens_per_s']:.1f} ({sstats['ms_per_step']:.3f} vs "
        f"{stats['ms_per_step']:.3f} ms/step)")

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
    return cfg.n_layers, chk_inputs, run, session_counts


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
# the f32 absorbed-vs-expanded reading's depth: 4 layers (it ran at full
# depth, 62.6 GB of f32 weights, where they fit; cut for phase 13's time)
DS_ABSORB_F32_LAYERS = 4


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
    ref = logits.cpu()
    del fchk, gchk, pchk, logits

    capture_first(torch, "deepseek prefill", plan, params,
                  {"tokens": tokens})
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
        same_as_check(torch, "deepseek prefill", again, ref)
    say(f"[main path] deepseek prefill launches (each of {DS_TIMED_RUNS} "
        f"timed runs): {json.dumps(counts)}")
    prefill_counts = dict(counts)
    med = sorted(secs)[len(secs) // 2]
    report["deepseek_prefill"] = dict(seconds=secs, tokens_per_s=b * s / med)
    say(f"[deepseek] {gpu} | prefill B {b} x {s}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in secs)
        + f" ms; median {b * s / med:.1f} tokens/s")
    plan.release()
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
    # same seed) at DS_ABSORB_F32_LAYERS layers (the dense layer and 3 MoE
    # layers) with bf16 at that depth beside it
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
    fcfg = cfg.with_overrides(n_layers=DS_ABSORB_F32_LAYERS)
    # the plain path: the grouped-matmul kernel takes bf16 only
    frun = dataclasses.replace(run, model=fcfg, param_dtype="float32",
                               activation_dtype="float32", use_pallas=False)
    params = M.init_params(fcfg, frun, dev)
    ab32 = absorb_agreement(torch, dev, M, fcfg, frun, params, prompt)
    del params
    torch.cuda.empty_cache()
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
        f"(f32 weights at full depth would be "
        f"{4 * n_params / 2 ** 30:.1f} GiB): f32 relative RMS "
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
    """``rooflines.flash_work`` at these inputs' shapes."""
    b, hq, sq, d = q.shape
    return rooflines.flash_work(b, hq, k.shape[1], sq, k.shape[2], d,
                                q_offset, causal, q.element_size())


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
    if ms == 0:                 # the profiler kept no kernel record
        ms = ev
    clk = sm_clock_under(torch, fa, max(1, int(800 / max(ev, 1e-3))))
    plain = yardstick(torch, lambda: kops.flash_attention(
        q, k, v, q_offset, causal, scale, impl="ref"), iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = yardstick(torch, lambda: sdpa(q, k, v, is_causal=causal,
                                        scale=scale, enable_gqa=True))
    work = fa_work(q, k, q_offset or 0, causal)
    flops, nbytes, bound = work.ops, work.nbytes, work.ms
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b, hq, sq, d = q.shape
    say(f"[times] {gpu} | flash_attention @ {label} (B {b}, Hq {hq}, "
        f"Hkv {k.shape[1]}, S {sq}, D {d}, "
        f"{'causal' if causal else 'not causal'}): {ms:.6f} ms/call (median "
        f"of 5 profiler readings of the kernel, {lo:.6f}..{hi:.6f}, kernel "
        f"records kept per reading of 20 calls {seen}; CUDA events with the "
        f"host {'ahead' if ahead else 'NOT ahead'} {ev:.6f} ms/call, host "
        f"issue {host:.6f} ms/call; SM clock under back-to-back calls, max: "
        f"{clk}), {flops / ms / 1e9:.1f} TFLOP/s; bound {bound:.6f} ms "
        f"(operations {t_ops:.6f} ms for {flops} flops, bytes "
        f"{t_bytes:.6f} ms for {nbytes} bytes); "
        f"{reading('plain', plain, bound)}; "
        f"{reading('library', lib, bound)} (scaled_dot_product_attention, "
        f"is_causal={bool(causal)}, enable_gqa: the same function); "
        f"{launches} launches a prefill call")
    return ("flash_attention", launches, ms, plain[0], bound, lib[0],
            f"{label}, B {b} x {sq}, D {d}", "operations")


def gmm_work(x, w, counts=None):
    """``rooflines.gmm_work`` at these inputs: over the filled slots (rows
    of x that are not all zero: an empty slot answers zeros and needs no
    product) and the experts that have one, and over every slot, as
    torch.bmm computes it.  Also the filled rows, the experts with one,
    and (with ``counts``) the filled 128-row tiles."""
    e, c, d = x.shape
    f = w.shape[2]
    filled = x.ne(0).any(-1)                      # (E, C)
    rows = int(filled.sum())
    experts = int(filled.any(-1).sum())
    item = x.element_size()
    need = rooflines.gmm_work(e, c, d, f, rows, experts, item)
    dense = rooflines.gmm_work(e, c, d, f, item=item)
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
    need, every, rows, experts, tiles = gmm_work(x, w, counts)
    flops, nbytes, bound, by = need.ops, need.nbytes, need.ms, need.bound_by
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    dflops, dbytes, dense = every.ops, every.nbytes, every.ms
    # the plain version multiplies every slot in f32, off the tensor cores
    e, c, d = x.shape
    plain_bound = rooflines.gmm_work(e, c, d, w.shape[2],
                                     item=x.element_size(),
                                     peak=F32_FLOPS).ms
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
        work = pack_work(torch, args)
        nbytes, bound = work.nbytes, work.ms
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
SFU_EXP_PER_CLOCK = rooflines.SFU_EXP_PER_CLOCK   # MUFU ex2 a clock per SM
SM_COUNT = rooflines.SM_COUNT                     # H100 SXM
F32_FLOPS = rooflines.F32_FLOPS                   # f32, off the tensor cores
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
    ref = logits.cpu()
    del chk, logits

    capture_first(torch, "falcon prefill", plan, params, {"tokens": tokens})
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
        same_as_check(torch, "falcon prefill", again, ref)
    say(f"[main path] falcon prefill launches (each of {FM_TIMED_RUNS} timed "
        f"runs): {json.dumps(counts)}")
    prefill_counts = dict(counts)
    med = sorted(secs)[len(secs) // 2]
    report["falcon_prefill"] = dict(seconds=secs, tokens_per_s=b * s / med)
    say(f"[falcon] {gpu} | prefill B {b} x {s}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in secs)
        + f" ms; median {b * s / med:.1f} tokens/s")
    plan.release()
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


def scan_work(x, a, mhz):
    """``rooflines.scan_work`` at these inputs' shapes, the exponentials
    at ``mhz``."""
    bsz, s, di = x.shape
    return rooflines.scan_work(bsz, s, di, a.shape[1], x.element_size(),
                               clock_mhz=mhz)


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
    work = scan_work(inputs[0], inputs[2], mhz)
    exps, flops, nbytes, bound = work.exps, work.ops, work.nbytes, work.ms
    t_exp = exps / (SFU_EXP_PER_CLOCK * SM_COUNT * mhz * 1e6) * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = {"operations": "f32 flops"}.get(work.bound_by, work.bound_by)
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


def pt_work(op, state, args):
    """``rooflines.pagetable_work`` of one op pass at these inputs: the
    valid rows are this pass's."""
    from repro_torch.kernels.ref import PT_OPS
    seq, arg, valid = args[:3]
    return rooflines.pagetable_work(
        op in (PT_OPS["alloc"], PT_OPS["append"]),
        sum(v.numel() for v in state.values()), valid.numel(),
        int(valid.sum()), state["chains"].shape[-1])


def pa_work(q, k, lengths):
    """``rooflines.paged_attention_work`` at these inputs: the live pages
    of every sequence."""
    b, hq, d = q.shape
    _, hkv, ps, _ = k.shape
    live = int(((lengths.long() + ps - 1) // ps).sum())
    return rooflines.paged_attention_work(b, hq, hkv, ps, d, live,
                                          k.element_size())


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
    need = pt_work(op, before, args)
    nbytes, bound = need.nbytes, need.ms
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
    need = pa_work(q, k, lengths)
    nbytes, bound = need.nbytes, need.ms
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


# ---------------------------------------------------------------------------
# phase 10: training (qwen train)
# ---------------------------------------------------------------------------

TRAIN = dict(batch=4, seq=1024, steps=8, remat="full")
# (b): the card against the port's CPU path, f32, full width, 2 layers
TRAIN_CHECK = (("qwen2.5-3b", 256, 1), ("deepseek-v2-lite-16b", 128, 4),
               ("falcon-mamba-7b", 64, 1))
TRAIN_LOSS_RTOL, TRAIN_GRAD_RMS, REMAT_GRAD_RMS = 1e-5, 1e-4, 1e-5
# (a): the lrs of the one-step readings from the trained weights (the
# first is the schedule's at step 9 of 8: 3e-3 x 9 / 20)
TRAIN_SWEEP = (1.35e-3, 3e-4, 1e-4, 3e-5)
# (a)'s gate: descent_check on the trained bf16 weights.  A bf16 weight
# of 0.022 has an ulp of 1.2e-4 and keeps a step under half of it, so the
# step is sized for a larger first-order change than f32's (lr = 3e-2 /
# the gradient's L1 norm, ~2.6e-5 on PR 25's run, where lr 3e-5 read
# 98% of its first-order change)
TRAIN_DROP_BF16 = 3e-2
# (b): one AdamW step, the card's against the CPU's on the same gradients
# (the same f32 arithmetic in another order: ~1e-7); the descent gate's
# weight seeds
UPDATE_RMS, TRAIN_DESCENT_SEEDS = 1e-5, (0, 1, 2)
RESUME = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "20", "--batch",
          "4", "--seq", "32", "--ckpt-every", "5", "--log-every", "1000"]
COMBINER_TOL = 1e-5


def train_argv():
    t = TRAIN
    return ["--arch", "qwen2.5-3b", "--steps", str(t["steps"]), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]), "--remat", t["remat"],
            "--log-every", "1"]


def phase_train(torch, dev, gpu, report):
    """(a) the trainer at qwen2.5-3b's full width and depth in bf16, its
    times; (b) the card against the port's CPU path in f32 at full width
    and 2 layers, and remat "full" / "dots" against "none"; (c) resume
    after an injected failure; (d) the gradient combiner.  Returns the
    kernel launches of the training path (none is expected: it runs the
    plain versions, as JAX trains without its Pallas kernels)."""
    import math
    import shutil
    import tempfile
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import compiled
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_update, init_adamw
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.testing.train import (DESCENT_DROP, DESCENT_RTOL,
                                           ExpertRows, combiner_battery,
                                           combiner_replay, constant_lr,
                                           descent_check,
                                           expert_grads_follow_rows,
                                           first_adamw_step, worst_leaf)
    torch.cuda.empty_cache()
    say(f"[train] card memory allocated at the start: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # (a) the trainer at full width and depth
    t = TRAIN
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    compiled.reset_captures()
    stats = {}
    t0 = time.perf_counter()
    hist = train.main(train_argv(), stats=stats)
    wall = time.perf_counter() - t0
    launches = kops.launch_counts()
    (cap,) = [c for c in compiled.captures() if c["site"] == "train_step"]
    for m in stats["metrics"]:
        require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                f"qwen train: a loss or grad_norm is not finite: {m}")
    step_ms = sorted(stats["step_s"][1:t["steps"]])[(t["steps"] - 1) // 2] \
        * 1e3
    tokens = t["batch"] * t["seq"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    report["qwen_train"] = {"tokens_per_s": tokens / step_ms * 1e3,
                            "capture_ms": cap["capture_ms"],
                            "pool_bytes": cap["pool_bytes"]}
    say(f"[train] {gpu} | qwen2.5-3b train ({stats['n_params'] / 1e9:.3f} B "
        f"params, bf16, AdamW f32 moments, remat {t['remat']}, B "
        f"{t['batch']} x {t['seq']}): losses "
        f"{[round(l, 4) for _, l in hist]}, grad norms "
        f"{[round(m['grad_norm'], 3) for m in stats['metrics']]}; "
        f"{step_ms:.1f} ms a step (median of steps 2-{t['steps']}, the "
        f"captured step replayed; steps "
        f"{[round(s * 1e3, 1) for s in stats['step_s']]} ms, the first "
        f"running eagerly and capturing: {cap['capture_ms']:.1f} ms "
        f"capture, pool {cap['pool_bytes'] / 1e9:.2f} GB), "
        f"{tokens / step_ms * 1e3:.1f} tokens/s, peak allocated {peak:.2f} "
        f"GB, {wall:.1f} s in all (weights drawn on the card included)")
    params, opt = stats.pop("state")
    plan = stats["plan"]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             stats["pipeline"].model_batch_at(t["steps"]).items()}
    losses, lrs = [], []
    for _ in range(2):
        params, opt, m = plan.step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    say(f"[train] {gpu} | two steps on one repeated batch at the "
        f"schedule's lr {lrs[0]:.4g}, {lrs[1]:.4g}: loss {losses[0]:.6f} "
        f"-> {losses[1]:.6f} (a reading; the gates are the descent checks below)")
    report["qwen_train"]["repeated_batch"] = losses

    def one_step():
        nonlocal params, opt
        params, opt, m = plan.step_fn(params, opt, batch)
        float(m["loss"])
    busy, bwall, tops = busy_share(torch, one_step, 1, 10)
    say(f"[busy] {gpu} | qwen train step: " + (
        f"device busy {busy * 1e3:.3f} ms of {bwall * 1e3:.3f} ms wall "
        f"({100 * busy / bwall:.1f}% busy); top device ops: " + "; ".join(
            f"{short(n)} {ms:.3f} ms / {c} calls" for n, ms, c in tops)
        if busy > 0 else "device busy share not measured (the profiler "
                         "recorded no device activity)"))
    report["qwen_train"]["busy"] = busy / bwall if busy > 0 else None
    plan.release()
    del opt
    torch.cuda.empty_cache()
    loss0, _, grads = value_and_grad(params, batch, plan.cfg, plan.run)
    l1 = sum(float(g.double().abs().sum()) for g in tree_leaves(grads))
    sweep = [first_adamw_step(params, grads, batch, plan.cfg, plan.run, lr,
                              restore=True) for lr in TRAIN_SWEEP]
    say(f"[train] {gpu} | from the trained weights, one AdamW step from "
        f"zero moments on that batch (loss {float(loss0):.6f}, gradient "
        f"L1 norm {l1:.6g}): " + "; ".join(
            f"lr {r['lr']:.3g}: loss {r['loss']:.6f}, change "
            f"{r['loss'] - float(loss0):+.6f} against {r['first_order']:+.6f}"
            f" to first order" for r in sweep))
    report["qwen_train"]["sweep"] = dict(loss0=float(loss0), grad_l1=l1,
                                         steps=sweep)
    del grads
    r = descent_check(params, batch, plan.cfg, plan.run,
                      drop=TRAIN_DROP_BF16)
    say(f"[train] {gpu} | the gate at full depth, bf16: a step of lr "
        f"{r['lr']:.4g} (= {TRAIN_DROP_BF16} / the gradient's L1 norm "
        f"{r['grad_l1']:.6g}) changes the loss {r['loss0']:.6f} -> "
        f"{r['loss']:.6f} ({r['change']:+.6f}) against "
        f"{r['first_order']:+.6f} to first order")
    require(r["ok"], f"qwen2.5-3b at full depth: the step did not lower the "
            f"loss by its first-order change within {DESCENT_RTOL}: {r}")
    report["qwen_train"]["descent"] = [r]
    del params, plan, batch, stats
    torch.cuda.empty_cache()
    say(f"[time] phase 10 (a): {time.perf_counter() - t0:.1f} s")

    # (b) the card against the port's CPU path, f32, full width, 2 layers
    t1 = time.perf_counter()
    for arch, seq, n_trustees in TRAIN_CHECK:
        cfg = get_arch(arch).with_overrides(n_layers=2)
        run = RunConfig(model=cfg, shape=ShapeConfig("t", seq, 1, "train"),
                        mesh=MeshConfig((1, n_trustees), ("data", "model")),
                        param_dtype="float32", activation_dtype="float32",
                        remat="none")
        params = M.init_params(cfg, run, dev)
        host = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size), cfg,
                             run.shape).batch_at(0)
        tc = time.perf_counter()
        with ExpertRows() as rec:
            loss_g, met_g, grads_g = value_and_grad(
                params, {k: torch.as_tensor(v, device=dev)
                         for k, v in host.items()}, cfg, run)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - tc
        tc = time.perf_counter()
        cpu_params = tree_map(lambda p: p.detach().cpu(), params)
        loss_c, met_c, grads_c = value_and_grad(
            cpu_params, {k: torch.as_tensor(v) for k, v in host.items()},
            cfg, run)
        t_cpu = time.perf_counter() - tc
        want = tree_leaves(grads_c)
        rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
        worst, i = worst_leaf(grads_g, want)
        line = (f"[train] {gpu} | {arch} at full width, 2 layers, f32, B 1 x "
                f"{seq}, {n_trustees} trustee(s): loss card "
                f"{loss_g.item():.7f} CPU {loss_c.item():.7f} (relative "
                f"{rel:.2e}), worst gradient leaf {worst:.2e} relative RMS "
                f"(leaf {i} of {len(want)}); value and grad {t_card:.1f} s "
                f"on the card (first call), {t_cpu:.1f} s on the CPU "
                f"({torch.get_num_threads()} threads)")
        require(rel < TRAIN_LOSS_RTOL and worst < TRAIN_GRAD_RMS,
                f"{arch}: the card's loss or gradients disagree with the "
                f"CPU's: {line}")
        if n_trustees > 1:
            r = expert_grads_follow_rows(
                grads_g["groups"]["pos0"]["moe"]["w_gate"], rec.counts)
            line += (f"; {r['experts_fed']} experts fed, "
                     f"{r['fed_without_grad']} of them without a gradient, "
                     f"dropped {float(met_g['moe_dropped_frac']):.4f}")
            require(r["experts_fed"] > 0 and r["fed_without_grad"] == 0,
                    f"{arch}: a fed expert has no gradient: {r}")
        if arch == "qwen2.5-3b":
            for remat in ("full", "dots"):
                _, _, grads_r = value_and_grad(
                    params, {k: torch.as_tensor(v, device=dev)
                             for k, v in host.items()}, cfg,
                    dataclasses.replace(run, remat=remat))
                w_r, _ = worst_leaf(grads_r, tree_leaves(grads_g))
                line += f"; remat {remat} vs none {w_r:.2e}"
                require(w_r < REMAT_GRAD_RMS, f"remat {remat}: {w_r}")
                del grads_r
            # one AdamW step on the CPU's gradients, the card's update
            # against the CPU's
            moved = []
            for p, g in ((params, tree_map(lambda x: x.to(dev), grads_c)),
                         (cpu_params, grads_c)):
                q = tree_map(lambda x: x.detach().clone(), p)
                adamw_update(constant_lr(run, TRAIN_SWEEP[-1]),
                             init_adamw(q), q, g)
                moved.append([a - b.detach() for a, b in
                              zip(tree_leaves(q), tree_leaves(p))])
                del q, g
            w_u, _ = worst_leaf(moved[0], moved[1])
            line += (f"; one AdamW step (lr {TRAIN_SWEEP[-1]:.3g}) on the "
                     f"CPU's gradients, the card's update vs the CPU's "
                     f"{w_u:.2e}")
            require(w_u < UPDATE_RMS, f"the card's AdamW update against "
                    f"the CPU's: {w_u}")
            del moved
        say(line)
        del params, cpu_params, grads_g, grads_c
        torch.cuda.empty_cache()

    # (b) the gate: a step lowers the loss on any draw of the weights
    arch, seq, _ = TRAIN_CHECK[0]
    cfg = get_arch(arch).with_overrides(n_layers=2)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", seq, 1, "train"),
                    mesh=MeshConfig((1, 1), ("data", "model")),
                    param_dtype="float32", activation_dtype="float32",
                    remat="none")
    host = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size), cfg,
                         run.shape).batch_at(0)
    dbatch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    for seed in TRAIN_DESCENT_SEEDS:
        params = M.init_params(cfg, dataclasses.replace(run, seed=seed), dev)
        r = descent_check(params, dbatch, cfg, run)
        say(f"[train] {gpu} | {arch} at full width, 2 layers, f32, weight "
            f"seed {seed}: a step of lr {r['lr']:.4g} (= {DESCENT_DROP} / "
            f"the gradient's L1 norm {r['grad_l1']:.6g}) changes the loss "
            f"{r['loss0']:.7f} -> {r['loss']:.7f} ({r['change']:+.7f}) "
            f"against {r['first_order']:+.7f} to first order")
        require(r["ok"], f"{arch} seed {seed}: the step did not lower the "
                f"loss by its first-order change within {DESCENT_RTOL}: {r}")
        report["qwen_train"]["descent"].append(r)
        del params
    del dbatch
    torch.cuda.empty_cache()
    say(f"[time] phase 10 (b): {time.perf_counter() - t1:.1f} s")

    # (c) resume after an injected failure, on the card
    ckdir = tempfile.mkdtemp(prefix="train_resume_")
    try:
        h_fail = train.main(RESUME + ["--ckpt-dir", f"{ckdir}/a",
                                      "--inject-failure-at", "12"])
        h_ok = train.main(RESUME + ["--ckpt-dir", f"{ckdir}/b"])
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    say(f"[train] resume on the card (SMOKE, a failure at step 12, a "
        f"checkpoint every 5): last loss {h_fail[-1][1]:.7f} against the "
        f"clean run's {h_ok[-1][1]:.7f} (steps {h_fail[-1][0]} / "
        f"{h_ok[-1][0]}, {len(h_fail) - len(h_ok)} replayed)")
    require(h_fail[-1][0] == h_ok[-1][0] and math.isclose(
        h_fail[-1][1], h_ok[-1][1], rel_tol=1e-4),
        "the resumed run's last loss is not the clean run's")

    # (d) the gradient combiner on 8 stacked shards
    record = []
    card = combiner_battery(dev)
    cpu = combiner_battery("cpu", record=record)
    replay = combiner_replay(dev, record)
    diff = float(np.abs(card["table"] - cpu["table"]).max())
    say(f"[train] grad_channel_combiner_int8 on 8 stacked shards: err_final "
        f"{card['err_final']:.6f} on the card, {cpu['err_final']:.6f} on the "
        f"CPU; the CPU's 60 steps replayed on the card from their inputs: "
        f"worst output {replay:.2e} of its largest magnitude; the two "
        f"60-step runs' final tables differ by {diff:.2e}")
    require(card["err_final"] < 0.05, f"err_final {card['err_final']}")
    require(replay < COMBINER_TOL and diff < COMBINER_TOL,
            f"the card's combiner against the CPU's: the replay {replay}, "
            f"the final tables {diff}")
    say(f"[time] phase 10: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 11: the rest of the model zoo that fits one card, at full width
# ---------------------------------------------------------------------------

# every architecture of the JAX registry that fits one card and no earlier
# phase drives, at full width and depth, random weights from seed 0 drawn
# on the card (every stacked leaf a layer at a time): prefill_step at B 4
# x 2048, serve.main
# over 4 requests x (32 prompt + 32 generated), 4 stacked trustees
ZOO = ("qwen3-4b", "gemma-7b", "qwen1.5-32b", "qwen2-vl-2b",
       "seamless-m4t-large-v2")
ZOO_PREFILL = dict(batch=4, seq=2048)
ZOO_SERVE = dict(batch=4, prompt_len=32, gen=32, mesh_model=4)
ZOO_TIMED_RUNS = 2
ENCDEC_TGT = 512                # seamless forward_loss: S_src 2048, S_tgt 512


def zoo_serve_argv(arch, gen):
    z = ZOO_SERVE
    return ["--arch", arch, "--batch", str(z["batch"]), "--prompt-len",
            str(z["prompt_len"]), "--gen", str(gen), "--mesh-model",
            str(z["mesh_model"])]


def zoo_batch(torch, M, cfg, run, b, s, dev, seed):
    """A prefill batch of ``cfg`` at B x S, by ``model.input_specs``:
    token ids; embeddings N(0, 0.02^2) in the activation dtype (the
    serve's prompt's scale); M-RoPE's three position streams equal (plain
    RoPE, so the prefill compares with the decode)."""
    from repro_torch.configs.base import ShapeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {}
    for name, (shape, dtype) in M.input_specs(
            cfg, ShapeConfig("p", s, b, "prefill"), run).items():
        if name == "positions":
            batch[name] = torch.arange(s, dtype=dtype, device=dev)[
                None, None].expand(shape)
        elif dtype.is_floating_point:
            batch[name] = (torch.randn(shape, generator=gen, device=dev)
                           * 0.02).to(dtype)
        else:
            batch[name] = torch.randint(0, cfg.vocab_size, shape,
                                        generator=gen, device=dev,
                                        dtype=dtype)
    return batch


def zoo_checked(torch, kops, fn, want, label):
    """``fn()`` inside a FlashCheck, counters zeroed just before it:
    ``want`` flash launches, every one within the tolerance of its plain
    version.  Returns (fn's result, the check's summary, its first call's
    inputs)."""
    from repro_torch.testing.model import FlashCheck
    kops.reset_launch_counts()
    with FlashCheck() as chk:
        out = fn()
        torch.cuda.synchronize()
    n = kops.launch_counts()["flash_attention"]
    c = chk.summary()
    require(n == want and c["flash_calls"] == want,
            f"{label}: {n} flash launches, {c['flash_calls']} checked, "
            f"want {want}")
    require(c["flash_calls_out_of_tolerance"] == 0,
            f"{label}: {c['flash_calls_out_of_tolerance']} flash calls "
            f"beyond the tolerance (max abs err {c['flash_max_abs_err']})")
    return out, c, chk.first


def phase_zoo_arch(torch, dev, gpu, report, errs, arch):
    """One architecture of phase 11: (a) serve.main, 4 x (32 + 32)
    tokens over 4 trustees (qwen2-vl-2b: an embeddings prompt of 32 and
    --gen 1, all JAX's loop defines), the decode logits at the last
    prompt position kept; (b) the serve's weights drawn again (seed 0) and
    prefill_step at B 4 x 2048 — a check run holding every flash launch
    against its plain version, then timed runs, counters zeroed just
    before each and the layers' launches read just after; (c) the
    prefill's last-position logits on the serve's prompt against the
    decode's there (qwen2-vl-2b's three position streams equal).  For
    seamless-m4t-large-v2 the prefill is the encoder (non-causal, D 64)
    and (c) is (c') the encoder through the kernel against its plain path
    and forward_loss under no_grad through the kernel (causal
    self-attention, non-causal cross-attention over the memory; S_src
    2048, S_tgt 512) against the plain path.  Returns (one prefill's
    flash launches, and forward_loss's for seamless; one prefill's; the
    first check call's inputs)."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.testing.model import (ENCDEC_RTOL, DecodeLogits,
                                           FinalHidden, logits_agreement,
                                           relative_agreement)
    cfg = get_arch(arch)
    encdec = M.is_encdec(cfg)
    embeds = cfg.input_mode == "embeds" and not encdec
    b, s = ZOO_PREFILL["batch"], ZOO_PREFILL["seq"]
    pl, nb = ZOO_SERVE["prompt_len"], ZOO_SERVE["batch"]
    gen = 1 if embeds else ZOO_SERVE["gen"]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # (a) the serve, its own weights drawn inside it.  The cached blocks
    # go back to the driver before each of qwen1.5-32b's three draws of
    # 70.4 GB: what the earlier phases leave cached is cut up, and a
    # stacked w_down alone is 17.9 GB in one piece
    stats = {}
    torch.cuda.empty_cache()
    kops.reset_launch_counts()
    with DecodeLogits(pos=pl - 1) as rec:
        out = serve.main(zoo_serve_argv(arch, gen), stats=stats)
    counts = kops.launch_counts()
    require(out.shape == (nb, gen) and int(out.min()) >= 0
            and int(out.max()) < cfg.vocab_size,
            f"{arch} serve tokens: shape {out.shape}, range "
            f"{out.min()}..{out.max()}")
    require(rec.logits is not None and bool(torch.isfinite(rec.logits)
                                            .all()),
            f"{arch} serve: no finite decode logits at position {pl - 1}")
    torch.cuda.empty_cache()
    again = serve.main(zoo_serve_argv(arch, gen))
    require(np.array_equal(out, again), f"{arch} serve: two runs' tokens "
            f"differ")
    report[f"{arch}_serve"] = stats
    say(f"[zoo {arch}] {gpu} | serve {nb} x ({pl} + {gen}) over "
        f"{ZOO_SERVE['mesh_model']} trustees: {stats['steps']} steps in "
        f"{stats['seconds']:.3f} s, {stats['ms_per_step']:.3f} ms/step, "
        f"{stats['tokens_per_s']:.1f} tokens/s; tokens equal run to run; "
        f"launches {json.dumps(counts)} (the decode's attention is the "
        f"plain trustee island, as in JAX)")
    if embeds:
        say(f"[zoo {arch}] --gen {gen}: JAX's serve loop defines only the "
            f"first token generated after an embeddings prompt")

    # (b) the prefill on the serve's weights
    mesh = MeshConfig((1, ZOO_SERVE["mesh_model"]), ("data", "model"))
    run = RunConfig(model=cfg, shape=ShapeConfig("prefill", s, b, "prefill"),
                    mesh=mesh, remat="none", use_pallas=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, run, dev)
    torch.cuda.synchronize()
    n_params = M.count_params(params)
    say(f"[zoo {arch}] {n_params / 1e9:.3f} B parameters drawn on the card "
        f"in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated)")
    plan = build_cell(cfg, run.shape, run)
    batch = zoo_batch(torch, M, cfg, run, b, s, dev, seed=17)
    n_layers = M.encdec.n_encoder_layers(cfg) if encdec else cfg.n_layers
    res, c, first = zoo_checked(torch, kops,
                                lambda: plan.step_fn(params, batch),
                                n_layers, f"{arch} prefill check run")
    want = (b, s, cfg.d_model) if encdec else (b, cfg.vocab_size)
    require(tuple(res.shape) == want and bool(torch.isfinite(res).all()),
            f"{arch} prefill: {tuple(res.shape)}, want {want}, finite "
            f"{bool(torch.isfinite(res).all())}")
    errs["flash_attention"] = max(errs.get("flash_attention", 0.0),
                                  c["flash_max_abs_err"])
    say(f"[zoo {arch} check] prefill B {b} x {s}: {n_layers} flash "
        f"launches at {c['flash_shapes'][0]}, every one == plain (max abs "
        f"err {c['flash_max_abs_err']:.3g}); "
        + ("the encoder memory" if encdec else "the last position's logits")
        + f" {want}, finite")
    ref = res.cpu()
    capture_first(torch, f"{arch} prefill", plan, params, batch)
    secs = []
    for _ in range(ZOO_TIMED_RUNS):
        kops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = plan.step_fn(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = kops.launch_counts()
        require(counts["flash_attention"] == n_layers
                and bool(torch.isfinite(timed).all()),
                f"{arch} prefill timed run: {counts['flash_attention']} "
                f"flash launches, want {n_layers}")
        same_as_check(torch, f"{arch} prefill", timed, ref)
    say(f"[main path] {arch} prefill launches (each of {ZOO_TIMED_RUNS} "
        f"timed runs): {json.dumps(counts)}")
    med = sorted(secs)[len(secs) // 2]
    report[f"{arch}_prefill"] = dict(seconds=secs, tokens_per_s=b * s / med)
    plan.release()
    del timed
    launches = n_layers

    if not encdec:
        # (c) prefill on the serve's prompt against the decode
        prompt = np.random.default_rng(0)
        if embeds:
            emb = torch.as_tensor(prompt.normal(size=(pl, nb, cfg.d_model))
                                  * 0.02).to(device=dev,
                                             dtype=torch.bfloat16)
            pos = torch.arange(pl, dtype=torch.int32, device=dev)
            pbatch = {"embeds": emb.transpose(0, 1),
                      "positions": pos[None, None].expand(3, nb, pl)}
        else:
            ids = prompt.integers(0, cfg.vocab_size, size=(pl, nb)).T
            pbatch = {"tokens": torch.as_tensor(ids, device=dev)}
        pre = build_cell(cfg, ShapeConfig("prompt", pl, nb, "prefill"),
                         run).step_fn(params, pbatch)
        agree = logits_agreement(pre, rec.logits, torch.bfloat16, cfg)
        require(agree["ok"], f"{arch} prefill vs serve decode logits at "
                f"position {pl - 1}: {agree}")
        say(f"[zoo {arch} check] prefill logits at position {pl - 1} == "
            f"the serve's decode logits there: relative RMS "
            f"{agree['rel_rms']:.4g} <= {agree['rtol']}, max abs "
            f"{agree['max_abs']:.4g}, argmax agrees on "
            f"{agree['argmax_agree'] * 100:.1f}% of rows")
        report[f"{arch}_agreement"] = agree
    else:
        # (c') the encoder and forward_loss, the kernel against the plain
        # path on the card
        prun = dataclasses.replace(run, use_pallas=False)
        with torch.no_grad():
            plain = M.prefill(params, batch, cfg, prun)
        mem = relative_agreement(res, plain, ENCDEC_RTOL["memory"])
        require(mem["ok"], f"{arch} encoder memory, kernel vs plain: {mem}")
        gl = torch.Generator(device=dev).manual_seed(19)
        lbatch = {"src_embeds": batch["src_embeds"],
                  "tokens": torch.randint(0, cfg.vocab_size,
                                          (b, ENCDEC_TGT), generator=gl,
                                          device=dev)}
        lbatch["labels"] = torch.roll(lbatch["tokens"], -1, dims=1)
        n_loss = 3 * cfg.n_layers
        with torch.no_grad(), FinalHidden() as kh:
            (loss, _), lc, _ = zoo_checked(
                torch, kops, lambda: M.forward_loss(params, lbatch, cfg,
                                                    run),
                n_loss, f"{arch} forward_loss check run")
        with torch.no_grad(), FinalHidden() as ph:
            ploss, _ = M.forward_loss(params, lbatch, cfg, prun)
        errs["flash_attention"] = max(errs["flash_attention"],
                                      lc["flash_max_abs_err"])
        hid = relative_agreement(kh.hidden, ph.hidden, ENCDEC_RTOL["hidden"])
        require(hid["ok"], f"{arch} forward_loss's final decoder hidden "
                f"state, kernel vs plain: {hid}")
        lrel = abs(float(loss) - float(ploss)) / abs(float(ploss))
        require(bool(torch.isfinite(loss)) and lrel <= ENCDEC_RTOL["loss"],
                f"{arch} forward_loss, kernel {float(loss)} vs plain "
                f"{float(ploss)}: relative {lrel}")
        launches += n_loss
        say(f"[zoo {arch} check] encoder memory through the kernel == the "
            f"plain path: relative RMS {mem['rel_rms']:.4g} <= "
            f"{mem['rtol']}, max abs {mem['max_abs']:.4g}; forward_loss "
            f"(S_src {s}, S_tgt {ENCDEC_TGT}, no_grad) through the kernel: "
            f"its final decoder hidden state relative RMS "
            f"{hid['rel_rms']:.4g} <= {hid['rtol']}, max abs "
            f"{hid['max_abs']:.4g}; its loss "
            f"{float(loss):.6f} vs plain {float(ploss):.6f}: relative "
            f"{lrel:.3g} <= {ENCDEC_RTOL['loss']}; its {n_loss} flash "
            f"launches at {lc['flash_shapes']} each == plain (max abs err "
            f"{lc['flash_max_abs_err']:.3g})")
        report[f"{arch}_agreement"] = dict(memory=mem, hidden=hid,
                                           loss=float(loss),
                                           plain_loss=float(ploss),
                                           loss_rel=lrel)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    report[f"{arch}_peak_gb"] = peak
    say(f"[zoo {arch}] {gpu} | prefill B {b} x {s}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in secs)
        + f" ms; median {b * s / med:.1f} tokens/s; serve "
        f"{stats['tokens_per_s']:.1f} tokens/s; peak allocated {peak:.2f} "
        f"GB above the {base / 1e9:.2f} GB allocated at the start "
        f"({n_params / 1e9:.3f} B parameters)")
    del params, batch, res
    torch.cuda.empty_cache()
    return launches, n_layers, first


def phase_zoo(torch, dev, gpu, report, errs):
    """Phase 11: every architecture of ``ZOO`` in turn (``phase_zoo_arch``),
    each model's weights freed before the next is drawn, then the flash
    kernel timed at each one's prefill shape as phase 9 times it.
    Returns the flash launches of one prefill call each (and seamless's
    forward_loss)."""
    launches, runs = 0, {}
    for arch in ZOO:
        t0 = time.perf_counter()
        n, *runs[arch] = phase_zoo_arch(torch, dev, gpu, report, errs, arch)
        launches += n
        say(f"[time] phase 11 {arch}: {time.perf_counter() - t0:.1f} s")
    for arch, (per_prefill, first) in runs.items():
        phase_flash_times(torch, dev, gpu, first, per_prefill,
                          label=f"{arch} prefill")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the data axis — a sub-axis trustee group, the deepseek MoE
# delegating per data row, serve and train on the (2, 4) stacked mesh
# ---------------------------------------------------------------------------

# (a) kv_subaxis: kv_paper's table over the 4 "model" trustees of the 2x4
# mesh, one replica a data row; kv_paper's 8192 requests a round (4096 a
# data row, each row its own Zipf(1) stream, 5% PUT), then one kv_mixed
# round (65,536 rows, 32,768 a data row)
KVSUB_ROUNDS = 20
# (b) deepseek-v2-lite-16b on the (2, 4) mesh at full width and depth
DP_MESH = (2, 4)
DP_PREFILL = dict(batch=4, seq=2048)
DP_SERVE = dict(batch=8, prompt_len=64, gen=64)
# (c) its trainer at full width, 2 layers, f32
DP_TRAIN = dict(batch=4, seq=256, steps=3, n_layers=2)


def dp_serve_argv():
    q = DP_SERVE
    return ["--arch", DS_ARCH, "--batch", str(q["batch"]), "--prompt-len",
            str(q["prompt_len"]), "--gen", str(q["gen"]), "--mesh-data",
            str(DP_MESH[0]), "--mesh-model", str(DP_MESH[1])]


def kvsub_paper_round(rng, rows):
    """One kv_paper round of one data row: ``rows`` Zipf(1) requests, 5%
    PUT, as a GET batch and a PUT batch (inactive rows keyed -1)."""
    from repro_torch.core.routing import sample_keys
    keys = sample_keys(rng, N_KEYS, rows, "zipf").astype(np.int32)
    is_put = rng.random(rows) < 0.05
    vals = rng.integers(0, 8, (rows, VW)).astype(np.float32)
    return [("get", np.where(is_put, -1, keys).astype(np.int32), vals, None),
            ("put", np.where(is_put, keys, -1).astype(np.int32), vals, None)]


def kvsub_mixed_round(rng, ref, rows):
    """One kv_mixed round of one data row: ``rows`` rows split
    GET/PUT/ADD/CAS 40/20/20/20, Zipf(1); CAS expects hit the row's table
    half the time."""
    from repro_torch.core.routing import sample_keys
    out, left = [], rows
    for i, (op, share) in enumerate(MIXED_SHARES):
        n = left if i == len(MIXED_SHARES) - 1 else int(rows * share)
        left -= n
        keys = sample_keys(rng, N_KEYS, n, "zipf").astype(np.int32)
        vals = rng.integers(0, 8, (n, VW)).astype(np.float32)
        expect = np.where(rng.random(n)[:, None] < 0.5, ref.table[keys],
                          rng.integers(0, 8, (n, VW))).astype(np.float32)
        out.append((op, keys, vals, expect))
    return out


def phase_kv_subaxis(torch, dev, gpu, report):
    """(a) A DelegatedKVStore over the "model" axis of the 2x4 stacked mesh
    (4 trustees, the 1,000,000 x 4 f32 table in 2 replicas of 16 MB), the
    local shortcut on, capacity the rows of a kv_mixed client shard: 20
    kv_paper rounds and one kv_mixed round, each data row's batches its
    own stream.  Gates: the kernel path (every pack launch held exactly
    against its plain version) == the ref path == a sequential oracle fed
    that data row's requests, every response and each replica bit for
    bit; the read-back (dump) == replica 0.  ops/s of the kernel path
    beside a whole-mesh store's (8 trustees, kv_paper's layout) on the
    same rows (a reading)."""
    from repro_torch.core import (DelegatedKVStore, SequentialKVReference,
                                  StackedMesh, TrustSession)
    from repro_torch.testing import dataaxis as da
    from repro_torch.testing.model import PackCheck
    rng = np.random.default_rng(2612)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    n_rows, t = DP_MESH
    rows = 8192 // n_rows
    paper = [[kvsub_paper_round(rng, rows) for _ in range(n_rows)]
             for _ in range(KVSUB_ROUNDS)]
    refs = [SequentialKVReference(N_KEYS, VW) for _ in range(n_rows)]
    for ref in refs:
        ref.prefill(init)
    mesh = StackedMesh(DP_MESH, device=dev)

    def store(label, axis, impl, cap):
        sess = TrustSession()
        st = DelegatedKVStore(mesh, N_KEYS, VW, axis=axis, capacity=cap,
                              pack_impl=impl, serve_impl=impl, session=sess,
                              name=f"kv_subaxis_{label}")
        st.prefill(init)
        return st, sess
    # the gated stores: a client shard's rows a pair (kv_mixed's, the
    # larger), no overflow
    stores = {impl: store(impl, "model", impl,
                          max(MIXED_ROWS, 16384) // (n_rows * t))
              for impl in ("kernel", "ref")}
    require(stores["kernel"][0].trust.state()["table"].shape[0] == 8
            and stores["kernel"][0].t == t,
            "kv_subaxis: the table is not 4 trustees x 2 replicas")

    def round_(label, batches, check=None):
        st, sess = stores[label]
        futs = da.submit(torch, dev, st, batches)
        stats = sess.step()
        check_stats(stats, st.trust.name)
        require(stats[st.trust.name]["dropped"] == 0,
                f"kv_subaxis {label}: rows overflowed")
        return da.responses(futs, batches)

    with PackCheck() as pchk:
        for i, row_batches in enumerate(paper):
            batches = da.fused_round(row_batches, t)
            got = round_("kernel", batches)
            plain = round_("ref", batches)
            want = [r for ref, rb in zip(refs, row_batches)
                    for r in da.row_oracle(ref, rb, True, t)]
            for a, b, w in zip(got, plain, want):
                require(da.same(a, b) and da.same(a, w),
                        f"kv_subaxis paper round {i}: a response differs "
                        f"(kernel / ref / the data row's oracle)")
        row_batches = [kvsub_mixed_round(rng, ref, MIXED_ROWS // n_rows)
                       for ref in refs]
        batches = da.fused_round(row_batches, t)
        got = round_("kernel", batches)
        plain = round_("ref", batches)
        want = [r for ref, rb in zip(refs, row_batches)
                for r in da.row_oracle(ref, rb, True, t)]
        for a, b, w in zip(got, plain, want):
            require(da.same(a, b) and da.same(a, w),
                    "kv_subaxis mixed round: a response differs (kernel / "
                    "ref / the data row's oracle)")
    pk = pchk.summary()
    require(pk["pack_calls"] > 0 and pk["pack_calls_out_of_tolerance"] == 0,
            f"kv_subaxis: pack launches against the plain version: {pk}")
    for label in ("kernel", "ref"):
        st = stores[label][0]
        reps = da.replica_tables(st)
        for r, (rep, ref) in enumerate(zip(reps, refs)):
            require(np.array_equal(rep, ref.dump()), f"kv_subaxis {label}: "
                    f"replica {r} differs from data row {r}'s oracle")
        require(np.array_equal(st.dump(), reps[0]), f"kv_subaxis {label}: "
                f"the read-back is not replica 0")
        require(not np.array_equal(reps[0], reps[1]),
                "kv_subaxis: the two replicas are equal (the rows' streams "
                "did not reach their own replicas)")
    say(f"[kv_subaxis] 4 trustees x 2 replicas of {N_KEYS} x {VW} f32: "
        f"{KVSUB_ROUNDS} kv_paper rounds and a kv_mixed round of "
        f"{MIXED_ROWS} rows, each data row its own stream: kernel == ref == "
        f"each data row's oracle bit for bit (every response, each "
        f"replica), dump == replica 0; {pk['pack_calls']} pack launches at "
        f"{pk['pack_shapes']} == plain (exact)")

    # the same kv_paper rows on a sub-axis store and on a whole-mesh one,
    # capacity a kv_paper client shard's rows, as phase 3 (b) sizes it
    cap = 2 * rows // t
    stores = {"sub": store("sub", "model", "kernel", cap),
              "whole": store("whole", ("data", "model"), "kernel", cap)}
    for label in ("sub", "whole", "whole", "sub"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for row_batches in paper:
            round_(label, da.fused_round(row_batches, t))
        torch.cuda.synchronize()
        report.setdefault(f"kv_subaxis_{label}_ops_s", []).append(
            8192 * KVSUB_ROUNDS / (time.perf_counter() - t0))
    sub, whole = (report[f"kv_subaxis_{k}_ops_s"] for k in ("sub",
                                                           "whole"))
    say(f"[kv_subaxis] {gpu} | kv_paper rows ({KVSUB_ROUNDS} rounds of "
        f"8192, shortcut, capacity {cap}): 4 trustees x 2 replicas "
        f"{', '.join(f'{x:.1f}' for x in sub)} ops/s; the whole mesh (8 "
        f"trustees) {', '.join(f'{x:.1f}' for x in whole)} ops/s (a reading)")


def phase_dp_serve(torch, dev, gpu, report, errs):
    """(b) deepseek-v2-lite-16b at full width and depth on the (2, 4)
    mesh, each data row's tokens delegated to its 4 trustees: a
    prefill_step check run at B 4 x 2048 (2 sequences a data row; every
    flash, pack and grouped-matmul launch held against the plain version),
    serve.main --mesh-data 2 --mesh-model 4 over 8 x (64 + 64) (the pack
    and grouped-matmul kernels launched), again with --session (the tokens
    equal run to run, the ledger 64 a request, the meter's 8 keys summing
    to 8 x 64), and the prefill's last-position logits on the serve's
    prompt against the serve's decode logits there (the MoE bound).
    Returns the launches of the check run and the serves."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.testing.model import (DecodeLogits, FlashCheck,
                                           GmmCheck, MoEStats, PackCheck,
                                           logits_agreement)
    cfg = get_arch(DS_ARCH)
    n_moe = cfg.n_layers - 1
    b, s = DP_PREFILL["batch"], DP_PREFILL["seq"]
    smesh = make_local_mesh(*DP_MESH, device=dev)
    run = RunConfig(model=cfg, shape=ShapeConfig("prefill", s, b, "prefill"),
                    mesh=MeshConfig(DP_MESH, ("data", "model")),
                    remat="none", use_pallas=True)
    launches = {k: 0 for k in SOURCES}
    params = M.init_params(cfg, run, dev)
    plan = build_cell(cfg, run.shape, run, smesh)
    gen = torch.Generator(device=dev).manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    kops.reset_launch_counts()
    with FlashCheck() as fchk, GmmCheck() as gchk, PackCheck() as pchk, \
            MoEStats() as moe:
        logits = plan.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
    counts = kops.launch_counts()
    f, g, pk, m = fchk.summary(), gchk.summary(), pchk.summary(), \
        moe.summary()
    for k, want, checked in (("flash_attention", cfg.n_layers,
                              f["flash_calls"]),
                             ("grouped_matmul", 3 * n_moe, g["gmm_calls"]),
                             ("delegation_pack", 2 * n_moe,
                              pk["pack_calls"])):
        require(counts[k] == want and checked == want,
                f"deepseek_dp prefill check run: {counts[k]} {k} launches, "
                f"{checked} checked, want {want}")
    require(f["flash_calls_out_of_tolerance"] == 0
            and g["gmm_calls_out_of_tolerance"] == 0
            and pk["pack_calls_out_of_tolerance"] == 0,
            f"deepseek_dp prefill: kernel calls beyond the tolerance: "
            f"{f} {g} {pk}")
    require(tuple(logits.shape) == (b, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            "deepseek_dp prefill: logits not finite")
    errs["flash_attention"] = max(errs.get("flash_attention", 0.0),
                                  f["flash_max_abs_err"])
    errs["grouped_matmul"] = max(errs.get("grouped_matmul", 0.0),
                                 g["gmm_max_abs_err"])
    for k, v in counts.items():
        launches[k] += v
    say(f"[deepseek_dp check] prefill B {b} x {s} on the {DP_MESH} mesh "
        f"({b // DP_MESH[0]} sequences a data row): {f['flash_calls']} "
        f"flash (D 192), {g['gmm_calls']} grouped-matmul launches at "
        f"{g['gmm_shapes']} and {pk['pack_calls']} packs at "
        f"{pk['pack_shapes']}, every call == plain (max abs err flash "
        f"{f['flash_max_abs_err']:.3g}, gmm {g['gmm_max_abs_err']:.3g}, "
        f"pack exact); MoE dropped fraction mean "
        f"{m['moe_dropped_frac_mean']:.6f}, max load {m['moe_max_load']:.0f}"
        f" rows; launches {json.dumps(counts)}")
    del params, logits, plan
    torch.cuda.empty_cache()

    q = DP_SERVE
    pl, g_len, bs = q["prompt_len"], q["gen"], q["batch"]
    stats = {}
    kops.reset_launch_counts()
    with DecodeLogits(pos=pl - 1) as rec, MoEStats() as dm:
        out = serve.main(dp_serve_argv(), stats=stats)
    counts = kops.launch_counts()
    steps = stats["steps"]
    require(counts["grouped_matmul"] == 3 * n_moe * steps
            and counts["delegation_pack"] > 0,
            f"deepseek_dp serve: launches {counts}, want "
            f"{3 * n_moe * steps} grouped-matmul")
    require(out.shape == (bs, g_len) and int(out.min()) >= 0
            and int(out.max()) < cfg.vocab_size,
            f"deepseek_dp serve tokens: {out.shape}")
    for k, v in counts.items():
        launches[k] += v
    report["deepseek_dp_serve"] = stats
    dms = dm.summary()
    say(f"[deepseek_dp] {gpu} | serve --mesh-data {DP_MESH[0]} "
        f"--mesh-model {DP_MESH[1]}, {bs} x ({pl} + {g_len}): {steps} steps "
        f"in {stats['seconds']:.3f} s, {stats['ms_per_step']:.3f} ms/step, "
        f"{stats['tokens_per_s']:.1f} tokens/s; MoE dropped fraction mean "
        f"{dms['moe_dropped_frac_mean']:.6f}; launches {json.dumps(counts)}")
    sstats = {}
    kops.reset_launch_counts()
    sout = serve.main(dp_serve_argv() + ["--session"], stats=sstats)
    counts = kops.launch_counts()
    require(np.array_equal(sout, out), "deepseek_dp: the --session serve's "
            "tokens differ from the serve's (run to run)")
    require(sstats["ledger"].tolist() == [g_len] * bs,
            f"deepseek_dp session: ledger {sstats['ledger'].tolist()}")
    require(sstats["meter"].shape == (DP_MESH[0] * DP_MESH[1],)
            and int(sstats["meter"].sum()) == bs * g_len,
            f"deepseek_dp session: meter {sstats['meter'].tolist()}")
    for k, v in counts.items():
        launches[k] += v
    report["deepseek_dp_session_serve"] = sstats
    say(f"[deepseek_dp] {gpu} | serve --session: tokens == the serve's, "
        f"ledger {g_len} for each of {bs} requests, meter over "
        f"{DP_MESH[0] * DP_MESH[1]} shards {sstats['meter'].tolist()}; "
        f"{sstats['tokens_per_s']:.1f} tokens/s")

    params = M.init_params(cfg, run, dev)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(pl, bs)).T
    pplan = build_cell(cfg, ShapeConfig("prompt", pl, bs, "prefill"), run,
                       smesh)
    pre = pplan.step_fn(params, {"tokens": torch.as_tensor(prompt,
                                                           device=dev)})
    agree = logits_agreement(pre, rec.logits, torch.bfloat16, cfg)
    require(agree["ok"], f"deepseek_dp prefill vs serve decode logits at "
            f"position {pl - 1}: {agree}")
    report["deepseek_dp_agreement"] = agree
    say(f"[deepseek_dp check] prefill logits at position {pl - 1} on the "
        f"{DP_MESH} mesh vs the serve's decode logits there: relative RMS "
        f"{agree['rel_rms']:.4g} (<= {agree['rtol']}), argmax agrees on "
        f"{agree['argmax_agree'] * 100:.1f}% of rows")
    del params, pre
    torch.cuda.empty_cache()
    return launches


def phase_dp_train(torch, dev, gpu, report):
    """(c) deepseek-v2-lite-16b's train cell on the (2, 4) mesh at full
    width and 2 layers in f32, B 4 x 256: value and grad on the card
    against the port's CPU path (loss 1e-5 relative, each gradient leaf
    1e-4 relative RMS, the MoE's drops equal), 3 steps of the cell with
    finite losses, then launch.train --mesh-data 2 --mesh-model 4
    --n-layers 2 for 3 steps (bf16, finite losses).  Returns the launches
    (none expected)."""
    import math
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_cell, value_and_grad
    from repro_torch.models import model as M
    from repro_torch.optim import init_adamw
    from repro_torch.optim.optimizer import tree_leaves, tree_map
    from repro_torch.testing.train import worst_leaf
    q = DP_TRAIN
    cfg = get_arch(DS_ARCH).with_overrides(n_layers=q["n_layers"])
    run = RunConfig(model=cfg, shape=ShapeConfig("t", q["seq"], q["batch"],
                                                 "train"),
                    mesh=MeshConfig(DP_MESH, ("data", "model")),
                    param_dtype="float32", activation_dtype="float32",
                    remat="none", zero_sharding=True)
    kops.reset_launch_counts()
    plan = build_cell(cfg, run.shape, run, make_local_mesh(*DP_MESH, dev))
    params = M.init_params(cfg, run, dev)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size), cfg,
                         run.shape)
    host = pipe.batch_at(0)
    tc = time.perf_counter()
    loss_g, met_g, grads_g = value_and_grad(
        params, {k: torch.as_tensor(v, device=dev) for k, v in host.items()},
        cfg, run)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - tc
    tc = time.perf_counter()
    cpu_params = tree_map(lambda p: p.detach().cpu(), params)
    loss_c, met_c, grads_c = value_and_grad(
        cpu_params, {k: torch.as_tensor(v) for k, v in host.items()}, cfg,
        run)
    t_cpu = time.perf_counter() - tc
    rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    worst, i = worst_leaf(grads_g, tree_leaves(grads_c))
    drops = (float(met_g["moe_dropped_frac"]),
             float(met_c["moe_dropped_frac"]))
    line = (f"[deepseek_dp train] {gpu} | full width, {q['n_layers']} "
            f"layers, f32, B {q['batch']} x {q['seq']} on the {DP_MESH} mesh:"
            f" loss card {loss_g.item():.7f} CPU {loss_c.item():.7f} "
            f"(relative {rel:.2e}), worst gradient leaf {worst:.2e} "
            f"relative RMS (leaf {i}), MoE dropped fraction card / CPU "
            f"{drops[0]:.6f} / {drops[1]:.6f}; value and grad {t_card:.1f} s"
            f" on the card, {t_cpu:.1f} s on the CPU")
    require(rel < TRAIN_LOSS_RTOL and worst < TRAIN_GRAD_RMS
            and drops[0] == drops[1],
            f"deepseek_dp train: the card disagrees with the CPU: {line}")
    say(line)
    del cpu_params, grads_c, grads_g
    opt = init_adamw(params)
    losses = []
    for step in range(q["steps"]):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.batch_at(step).items()}
        params, opt, m = plan.step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
    require(all(math.isfinite(x) for x in losses),
            f"deepseek_dp train: losses {losses}")
    del params, opt
    torch.cuda.empty_cache()
    stats = {}
    hist = train.main(["--arch", DS_ARCH, "--mesh-data", str(DP_MESH[0]),
                       "--mesh-model", str(DP_MESH[1]), "--n-layers",
                       str(q["n_layers"]), "--steps", str(q["steps"]),
                       "--batch", str(q["batch"]), "--seq", str(q["seq"]),
                       "--log-every", "1"], stats=stats)
    require(len(hist) == q["steps"]
            and all(math.isfinite(l) for _, l in hist),
            f"deepseek_dp launch.train: history {hist}")
    counts = kops.launch_counts()
    report["deepseek_dp_train"] = dict(
        f32_losses=losses, bf16_losses=[l for _, l in hist],
        step_s=stats["step_s"])
    say(f"[deepseek_dp train] {gpu} | the cell's {q['steps']} f32 steps: "
        f"losses {[round(x, 5) for x in losses]}; launch.train --mesh-data "
        f"{DP_MESH[0]} --mesh-model {DP_MESH[1]} --n-layers {q['n_layers']}"
        f" (bf16): losses {[round(l, 5) for _, l in hist]}, steps "
        f"{[round(x * 1e3, 1) for x in stats['step_s']]} ms")
    del stats
    torch.cuda.empty_cache()
    return counts


def phase_data_axis(torch, dev, gpu, report, errs):
    """Phase 12, each path with the counters zeroed just before it and
    read just after: (a) kv_subaxis, (b) deepseek_dp_serve, (c)
    deepseek_dp_train.  Returns the launches of (a) and (b)."""
    from repro_torch.core import meshctx
    from repro_torch.kernels import ops as kops
    launches = {k: 0 for k in SOURCES}
    with meshctx.kept_context():
        t0 = time.perf_counter()
        kops.reset_launch_counts()
        phase_kv_subaxis(torch, dev, gpu, report)
        counts = kops.launch_counts()
        say(f"[main path] kv_subaxis launches: {json.dumps(counts)} "
            f"({time.perf_counter() - t0:.1f} s)")
        for k in KV_KERNELS:
            require(counts[k] > 0, f"kernel {k} was not launched on the "
                    f"kv_subaxis main path")
        for k, v in counts.items():
            launches[k] += v
        t0 = time.perf_counter()
        counts = phase_dp_serve(torch, dev, gpu, report, errs)
        say(f"[main path] deepseek_dp_serve launches: {json.dumps(counts)} "
            f"({time.perf_counter() - t0:.1f} s)")
        for k in ("delegation_pack", "grouped_matmul", "flash_attention"):
            require(counts[k] > 0, f"kernel {k} was not launched on the "
                    f"deepseek_dp_serve main path")
        for k, v in counts.items():
            launches[k] += v
        t0 = time.perf_counter()
        counts = phase_dp_train(torch, dev, gpu, report)
        say(f"[main path] deepseek_dp_train launches: {json.dumps(counts)} "
            f"({time.perf_counter() - t0:.1f} s)")
        require(not any(counts.values()), "the data-axis training path "
                "launched a kernel: no kernel has a backward")
    return launches


# ---------------------------------------------------------------------------
# phase 13: jamba-v0.1-52b and arctic-480b at full width, at the depth one
# card holds
# ---------------------------------------------------------------------------

# (arch, the depth served): jamba two of its four 8-layer groups (26.05 B
# parameters, 52.1 GB of bf16), arctic 2 of its 35 layers (27.68 B, 55.4
# GB); every width as published
HYBRID = (("jamba-v0.1-52b", 16), ("arctic-480b", 2))
HY_PREFILL = dict(batch=4, seq=2048, mesh_model=4)
HY_SERVE = dict(batch=4, prompt_len=32, gen=32, mesh_model=4)
HY_TIMED_RUNS = 2
# the f32 prefill-vs-decode check: the depth whose f32 weights one card
# holds (jamba one 8-layer group, 53.3 GB; arctic one layer, 55.3 GB)
HY_F32_LAYERS = {"jamba-v0.1-52b": 8, "arctic-480b": 1}
HY_CHECK_LABELS = {"flash_attention": "flash", "grouped_matmul": "gmm",
                   "delegation_pack": "pack", "selective_scan": "scan"}


def hy_serve_argv():
    q = HY_SERVE
    return ["--batch", str(q["batch"]), "--prompt-len", str(q["prompt_len"]),
            "--gen", str(q["gen"]), "--mesh-model", str(q["mesh_model"])]


def hy_layers(cfg):
    """(attention, Mamba, MoE) layers of ``cfg``'s stack."""
    from repro_torch.models.transformer import layer_descs
    descs, prefix, n_groups = layer_descs(cfg)
    assert prefix == 0
    return tuple(n_groups * sum(pred(d) for d in descs) for pred in (
        lambda d: d.block == "attn", lambda d: d.block == "mamba",
        lambda d: d.ffn in ("moe", "moe+dense")))


def hy_refusal(torch, arch):
    """serve.main at ``arch``'s published depth: it must raise the fit
    check's ValueError before anything is allocated.  Returns the
    message."""
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        serve.main(["--arch", arch] + hy_serve_argv())
    except ValueError as e:
        msg = str(e)
    else:
        require(False, f"{arch} at its published depth was served: the fit "
                f"check did not refuse it")
    peak = torch.cuda.max_memory_allocated()
    require("does not fit" in msg and peak <= before,
            f"{arch} refusal: {msg!r}; {before} bytes allocated before the "
            f"call, at most {peak} during it")
    return msg


def phase_hybrid_arch(torch, dev, gpu, report, errs, arch, n_layers):
    """One architecture of phase 13 at ``n_layers`` layers, full width,
    bf16, random weights drawn on the card (seed 0, the serve's own):
    (a) serve.main at the published depth raises the fit check's refusal
    before allocating; (b) prefill_step at B 4 x 2048 over 4 trustees —
    a check run holding every flash, grouped-matmul and pack launch (and
    jamba's selective scans) against its plain version, then timed runs,
    counters zeroed just before each and read just after — and the
    prefill's last-position logits on the serve's prompt, held to the
    plain path's on the same weights within the model's bf16 bound; (c) the
    weights freed, flash and the grouped matmul timed at the check run's
    first inputs as phase 9 times them; (d) serve.main(cfg=...) over 4 x
    (32 + 32), twice (the tokens equal), its decode logits at the last
    prompt position against (b)'s prefill logits (and the plain path's)
    in bf16 — a reading beside the 10% MoE bound, not a gate: at random weights a bf16
    rounding flips a MoE layer's top-2 choice or Mamba's state carries
    it (jamba), and the prompt prefill's trustees drop expert rows past
    their ``cap2`` slots that the decode keeps (arctic), PERF.md §6 —
    and (e) the same comparison in f32 at ``HY_F32_LAYERS`` (weights drawn
    in f32 from the same seed, the prefill's plain path, a teacher-forced
    decode), held to the f32 bound (1e-4): the two paths compute one
    function.  Returns the launches of one prefill call and of the
    serves."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.testing.model import (ChunkedPlainGmm, DecodeLogits,
                                           FlashCheck, GmmCheck, MoEStats,
                                           PackCheck, ScanCheck,
                                           TrusteeDrops, logits_agreement,
                                           prefill_decode_rtol,
                                           relative_agreement)
    cfg = get_arch(arch).with_overrides(n_layers=n_layers)
    n_attn, n_mamba, n_moe = hy_layers(cfg)
    # the earlier phases' weights and inputs, some held by reference
    # cycles until a collection, leave the card first
    gc.collect()
    want = {"flash_attention": n_attn, "selective_scan": n_mamba,
            "grouped_matmul": 3 * n_moe, "delegation_pack": 2 * n_moe}
    b, s = HY_PREFILL["batch"], HY_PREFILL["seq"]
    pl, nb, g_len = HY_SERVE["prompt_len"], HY_SERVE["batch"], HY_SERVE["gen"]
    launches = {k: 0 for k in SOURCES}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # (a) the published depth is refused before any weight is drawn
    msg = hy_refusal(torch, arch)
    say(f"[hybrid {arch}] serve.main --arch {arch} ({get_arch(arch).n_layers}"
        f" layers) refused before allocating: {msg}")

    # (b) the prefill
    mesh = MeshConfig((1, HY_PREFILL["mesh_model"]), ("data", "model"))
    run = RunConfig(model=cfg, shape=ShapeConfig("prefill", s, b, "prefill"),
                    mesh=mesh, remat="none", use_pallas=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, run, dev)
    torch.cuda.synchronize()
    n_params = M.count_params(params)
    say(f"[hybrid {arch}] {n_layers} of {get_arch(arch).n_layers} layers "
        f"({n_attn} attention, {n_mamba} Mamba, {n_moe} MoE): "
        f"{n_params / 1e9:.3f} B parameters "
        f"({M.active_param_count(cfg, n_params) / 1e9:.3f} B active a "
        f"token) drawn on the card in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated)")
    plan = build_cell(cfg, run.shape, run)
    gen = torch.Generator(device=dev).manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    kops.reset_launch_counts()
    with FlashCheck() as fchk, GmmCheck() as gchk, PackCheck() as pchk, \
            ScanCheck() as schk, MoEStats() as moe:
        logits = plan.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
    counts = kops.launch_counts()
    checks = {"flash_attention": fchk.summary(),
              "grouped_matmul": gchk.summary(),
              "delegation_pack": pchk.summary(),
              "selective_scan": schk.summary()}
    for k, n in want.items():
        c = checks[k]
        p = HY_CHECK_LABELS[k]
        require(counts[k] == n and c[f"{p}_calls"] == n
                and c[f"{p}_calls_out_of_tolerance"] == 0,
                f"{arch} prefill check run: {counts[k]} {k} launches, "
                f"{c[f'{p}_calls']} checked, "
                f"{c[f'{p}_calls_out_of_tolerance']} beyond the tolerance; "
                f"want {n}, all within")
        if n:
            errs[k] = max(errs.get(k, 0.0), c[f"{p}_max_abs_err"])
    require(tuple(logits.shape) == (b, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            f"{arch} prefill logits: {tuple(logits.shape)}, finite "
            f"{bool(torch.isfinite(logits).all())}")
    for k, v in counts.items():
        launches[k] += v
    m = moe.summary()
    f, g, pk, sc = (checks[k] for k in ("flash_attention", "grouped_matmul",
                                        "delegation_pack", "selective_scan"))
    say(f"[hybrid {arch} check] prefill B {b} x {s} over "
        f"{HY_PREFILL['mesh_model']} trustees: {f['flash_calls']} flash at "
        f"{f['flash_shapes']}, {g['gmm_calls']} grouped-matmul at "
        f"{g['gmm_shapes']} ({g['gmm_filled_tiles']} of {g['gmm_tiles']} "
        f"128-row tiles filled), {pk['pack_calls']} packs at "
        f"{pk['pack_shapes']}"
        + (f", {sc['scan_calls']} scans at {sc['scan_shapes']}"
           if n_mamba else "")
        + f": every call == plain (max abs err flash "
        f"{f['flash_max_abs_err']:.3g}, gmm {g['gmm_max_abs_err']:.3g}"
        + (f", scan {sc['scan_max_abs_err']:.3g}" if n_mamba else "")
        + f", pack exact); logits ({b}, {cfg.vocab_size}), finite; MoE "
        f"dropped fraction mean {m['moe_dropped_frac_mean']:.6f}, max "
        f"{m['moe_dropped_frac_max']:.6f}, max load {m['moe_max_load']:.0f} "
        f"rows; launches {json.dumps(counts)}")
    # the first call of each timed kernel, on the host until (c): the
    # prefill's program is captured with nothing of the check run on the
    # card (arctic's first gmm weights alone are 8.9 GB, and what the
    # check run leaves on the card pins the segments the capture needs)
    fa_first, gmm_first = park(torch, (fchk.first, gchk.first), "cpu")
    ref = logits.cpu()
    del logits, fchk, gchk, pchk, schk, moe
    torch.cuda.empty_cache()
    capture_first(torch, f"{arch} prefill", plan, params, {"tokens": tokens})
    secs = []
    for _ in range(HY_TIMED_RUNS):
        kops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = plan.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = kops.launch_counts()
        require(all(counts[k] == n for k, n in want.items())
                and bool(torch.isfinite(timed).all()),
                f"{arch} prefill timed run: launches {counts}, want {want}")
        same_as_check(torch, f"{arch} prefill", timed, ref)
    say(f"[main path] {arch} prefill launches (each of {HY_TIMED_RUNS} "
        f"timed runs): {json.dumps(counts)}")
    med = sorted(secs)[len(secs) // 2]
    report[f"{arch}_prefill"] = dict(seconds=secs, tokens_per_s=b * s / med)
    plan.release()
    del timed
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(pl, nb)).T, device=dev)
    pshape = ShapeConfig("prompt", pl, nb, "prefill")
    with TrusteeDrops() as pdrops:
        pre = build_cell(cfg, pshape, run).step_fn(params,
                                                   {"tokens": prompt})
    # the kernel path held to the plain path end to end (the same
    # weights and prompt): in bf16 the two round at other places, so a
    # near-tie token may take another expert or a Mamba state carry the
    # difference — the model's bf16 bound (``prefill_decode_rtol``); the
    # plain grouped matmul a chunk of experts at a time (arctic's f32
    # expert leaf, 17.8 GB, does not fit beside its weights)
    with ChunkedPlainGmm():
        plain = build_cell(cfg, pshape, dataclasses.replace(
            run, use_pallas=False)).step_fn(params, {"tokens": prompt})
    kvp = relative_agreement(pre, plain,
                             prefill_decode_rtol(cfg, torch.bfloat16))
    require(kvp["ok"] and bool(torch.isfinite(plain).all()),
            f"{arch} bf16 prompt prefill, kernel path vs plain path: {kvp}")
    say(f"[hybrid {arch} check] bf16 prefill logits at position {pl - 1} "
        f"through the kernels == through the plain path: relative RMS "
        f"{kvp['rel_rms']:.4g} <= {kvp['rtol']}, max abs "
        f"{kvp['max_abs']:.4g}")
    del params, plan
    torch.cuda.empty_cache()

    # (c) the kernels at the new shapes, nothing else on the card
    fa_first, gmm_first = park(torch, (fa_first, gmm_first), dev)
    phase_flash_times(torch, dev, gpu, fa_first, n_attn,
                      label=f"{arch} prefill")
    phase_gmm_times(torch, dev, gpu, gmm_first, 3 * n_moe,
                    f"{arch} prefill")
    del fa_first, gmm_first
    torch.cuda.empty_cache()

    # (d) the serve, its own weights drawn inside it
    stats = {}
    kops.reset_launch_counts()
    with DecodeLogits(pos=pl - 1) as rec, TrusteeDrops() as sdrops:
        out = serve.main(hy_serve_argv(), stats=stats, cfg=cfg)
    counts = kops.launch_counts()
    steps = stats["steps"]
    require(counts["grouped_matmul"] == 3 * n_moe * steps
            and counts["delegation_pack"] > 0,
            f"{arch} serve: launches {counts}, want "
            f"{3 * n_moe * steps} grouped-matmul and packs")
    require(out.shape == (nb, g_len) and int(out.min()) >= 0
            and int(out.max()) < cfg.vocab_size,
            f"{arch} serve tokens: shape {out.shape}, range "
            f"{out.min()}..{out.max()}")
    require(rec.logits is not None
            and bool(torch.isfinite(rec.logits).all()),
            f"{arch} serve: no finite decode logits at position {pl - 1}")
    for k, v in counts.items():
        launches[k] += v
    torch.cuda.empty_cache()
    kops.reset_launch_counts()
    again = serve.main(hy_serve_argv(), cfg=cfg)
    for k, v in kops.launch_counts().items():
        launches[k] += v
    require(np.array_equal(out, again), f"{arch} serve: two runs' tokens "
            f"differ")
    report[f"{arch}_serve"] = stats
    say(f"[hybrid {arch}] {gpu} | serve {nb} x ({pl} + {g_len}) over "
        f"{HY_SERVE['mesh_model']} trustees: {steps} steps in "
        f"{stats['seconds']:.3f} s, {stats['ms_per_step']:.3f} ms/step, "
        f"{stats['tokens_per_s']:.1f} tokens/s; tokens equal run to run; "
        f"launches {json.dumps(counts)}")
    agree = logits_agreement(pre, rec.logits, torch.bfloat16, cfg)
    pagree = logits_agreement(plain, rec.logits, torch.bfloat16, cfg)
    (pd, pn), (sd, sn) = pdrops.total(), sdrops.total()
    say(f"[hybrid {arch}] bf16 prefill logits at position {pl - 1} vs the "
        f"serve's decode logits there (a reading): relative RMS "
        f"{agree['rel_rms']:.4g} ({'within' if agree['ok'] else 'beyond'} "
        f"the {agree['rtol']} MoE bound; the plain path's prefill "
        f"{pagree['rel_rms']:.4g}), max abs {agree['max_abs']:.4g}, "
        f"argmax agrees on {agree['argmax_agree'] * 100:.1f}% of rows; the "
        f"trustees' packs by expert dropped {pd} of {pn} expert rows in "
        f"the prompt prefill and {sd} of {sn} in the serve's "
        f"{steps} decode steps")
    del pre, plain
    torch.cuda.empty_cache()

    # (e) the same comparison in f32, at the depth whose f32 weights fit
    fcfg = cfg.with_overrides(n_layers=HY_F32_LAYERS[arch])
    frun = RunConfig(model=fcfg, shape=ShapeConfig("prompt", pl, nb,
                                                   "prefill"),
                     mesh=mesh, remat="none", param_dtype="float32",
                     activation_dtype="float32")
    fparams = M.init_params(fcfg, frun, dev)
    pre32 = build_cell(fcfg, frun.shape, frun).step_fn(fparams,
                                                       {"tokens": prompt})
    dec32 = fm_decode_logits(torch, M, fcfg, fparams, frun, prompt, dev)
    agree32 = logits_agreement(pre32, dec32, torch.float32, fcfg)
    require(agree32["ok"], f"{arch} at {fcfg.n_layers} layers in f32: "
            f"prefill vs teacher-forced decode logits at position "
            f"{pl - 1}: {agree32}")
    report[f"{arch}_agreement"] = dict(bf16=agree, bf16_plain=pagree,
                                       kernel_vs_plain=kvp, f32=agree32,
                                       f32_layers=fcfg.n_layers,
                                       prefill_trustee_drops=(pd, pn))
    say(f"[hybrid {arch} check] in f32 at {fcfg.n_layers} "
        f"layer{'s' * (fcfg.n_layers > 1)} (weights "
        f"drawn in f32 from the same seed, "
        f"{M.count_params(fparams) / 1e9:.3f} B parameters; the prefill's "
        f"plain path): prefill logits at position {pl - 1} == the "
        f"teacher-forced decode's: relative RMS {agree32['rel_rms']:.4g} "
        f"<= {agree32['rtol']}, argmax agrees on "
        f"{agree32['argmax_agree'] * 100:.1f}% of rows")
    del fparams, pre32, dec32
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    report[f"{arch}_peak_gb"] = peak
    say(f"[hybrid {arch}] {gpu} | prefill B {b} x {s}: "
        + ", ".join(f"{x * 1e3:.3f}" for x in secs)
        + f" ms; median {b * s / med:.1f} tokens/s; serve "
        f"{stats['tokens_per_s']:.1f} tokens/s; peak allocated {peak:.2f} "
        f"GB above the {base / 1e9:.2f} GB allocated at the start "
        f"({n_params / 1e9:.3f} B parameters)")
    torch.cuda.empty_cache()
    return launches


def phase_hybrid(torch, dev, gpu, report, errs):
    """Phase 13: each of ``HYBRID`` in turn (``phase_hybrid_arch``), each
    model's weights freed before the next is drawn.  Returns the
    launches of its main paths."""
    launches = {k: 0 for k in SOURCES}
    for arch, n_layers in HYBRID:
        t0 = time.perf_counter()
        for k, v in phase_hybrid_arch(torch, dev, gpu, report, errs, arch,
                                      n_layers).items():
            launches[k] += v
        say(f"[time] phase 13 {arch}: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the examples, the dry run on the meta device, mfu readings
# ---------------------------------------------------------------------------

# serve_kv's check: the example's table and zipf traffic (5% writes)
EX_SERVE_KV = dict(n_keys=100_000, requests=4096, rounds=2, write_pct=5)
# delegated_moe's check: the JAX package's tests/test_delegated_moe.py case
EX_MOE = dict(n_experts=8, n_tokens=32, n_waves=6, seed=3)
EX_TRAIN_STEPS = 20
# what quickstart prints, as the JAX package's example prints it
EX_QUICKSTART = dict(counter=19.0, then_value=19.0, get=[3, 5],
                     fetch_adds=[3, 4, 5], fused_get=[6, 5],
                     fused_counters=[1, 1, 1, 1], dedicated_get=[3, 5])
# the dry run held to allocate nothing and launch nothing on the card
DRY_CELL = ("qwen1.5-32b", "decode_32k")
# the cells phases 6, 7, 8 and 10 time, each with its phase's mesh and
# run: (report key, arch, kind, seq, batch, (data, model), run overrides)
MFU_CELLS = (
    ("qwen_prefill", "qwen2.5-3b", "prefill", QWEN_PREFILL["seq"],
     QWEN_PREFILL["batch"], (1, QWEN_SERVE["mesh_model"]), {}),
    ("deepseek_prefill", "deepseek-v2-lite-16b", "prefill", DS_PREFILL["seq"],
     DS_PREFILL["batch"], (1, DS_PREFILL["mesh_model"]), {}),
    ("falcon_prefill", "falcon-mamba-7b", "prefill", FM_PREFILL["seq"],
     FM_PREFILL["batch"], (1, 1), {}),
    ("qwen_train", "qwen2.5-3b", "train", TRAIN["seq"], TRAIN["batch"],
     (1, 1), {"grad_accum": 1, "remat": TRAIN["remat"]}),
)


def ex_quickstart(torch, dev):
    """quickstart on the card and on the CPU (the plain paths): every
    printed value equals the JAX package's and the CPU run's, and the
    engine stats equal the CPU run's."""
    import numpy as np
    from repro_torch.core import use_session
    from repro_torch.examples import quickstart
    runs = {}
    for where in (dev, "cpu"):
        with use_session():
            runs[str(where)] = quickstart.run(where)
    card, cpu = runs[str(dev)], runs["cpu"]
    for k, v in EX_QUICKSTART.items():
        require(np.array_equal(np.asarray(card[k], np.float32),
                               np.asarray(v, np.float32))
                and np.array_equal(np.asarray(card[k]), np.asarray(cpu[k])),
                f"quickstart {k}: card {card[k]}, CPU {cpu[k]}, want {v}")
    require(card["stats"] == cpu["stats"], f"quickstart engine stats: card "
            f"{card['stats']}, CPU {cpu['stats']}")
    require(card["schema_error"] == cpu["schema_error"],
            "quickstart: the SchemaError differs")
    return card


def ex_serve_kv(torch, dev, gpu):
    """serve_kv's service round on both backends over one table and the
    same traffic: the GET responses of the rows that read, bit for bit
    with each other and with SequentialKVReference; both tables after
    the rounds == the oracle's.  Host ms a round (readings)."""
    import numpy as np
    from repro_torch.core import (DelegatedKVStore, FetchRMWStore,
                                  SequentialKVReference, StackedMesh,
                                  use_session)
    from repro_torch.core.routing import sample_keys
    from repro_torch.examples import serve_kv
    p = EX_SERVE_KV
    w = serve_kv.W
    rng = np.random.default_rng(0)
    table = rng.normal(size=(p["n_keys"], w)).astype(np.float32)
    rounds = [(sample_keys(rng, p["n_keys"], p["requests"], "zipf"),
               rng.random(p["requests"]) < p["write_pct"] / 100)
              for _ in range(p["rounds"])]
    mesh = StackedMesh((1, serve_kv.N_SHARDS), device=dev)
    got, ms, tables = {}, {}, {}
    with use_session():
        stores = {"trust": DelegatedKVStore(mesh, p["n_keys"], w),
                  "rw-lock": FetchRMWStore(mesh, p["n_keys"], w,
                                           rw_lock=True)}
        for backend, st in stores.items():
            st.prefill(table)
            got[backend], ms[backend] = [], []
            for keys, wr in rounds:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = serve_kv.service_round(st, keys, wr, backend)
                torch.cuda.synchronize()
                ms[backend].append((time.perf_counter() - t0) * 1e3)
                got[backend].append(out.cpu().numpy())
            tables[backend] = st.dump()
    ref = SequentialKVReference(p["n_keys"], w)
    ref.prefill(table)
    for i, (keys, wr) in enumerate(rounds):
        want = ref.get(keys)
        ref.put(keys[wr], np.ones((int(wr.sum()), w), np.float32))
        for backend in got:
            require(np.array_equal(got[backend][i][~wr], want[~wr]),
                    f"serve_kv {backend} round {i}: GET responses differ "
                    f"from the oracle")
    for backend, t in tables.items():
        require(np.array_equal(t, ref.dump()),
                f"serve_kv {backend}: the table differs from the oracle's")
    say(f"[example] {gpu} | serve_kv ({p['n_keys']} keys, "
        f"{p['requests']} requests a round, zipf, {p['write_pct']}% "
        f"writes): " + "; ".join(
            f"{b} " + ", ".join(f"{x:.3f}" for x in v) + " ms a round"
            for b, v in ms.items()) + " (host wall, first round cold); "
        "every GET == the oracle, both tables == the oracle's")


def ex_moe(torch, dev):
    """delegated_moe's routing on the card and on the CPU: assignments,
    delegated counts, host tally and live counts bit for bit, the
    delegated counts == the tally of the routed tokens."""
    import numpy as np
    from repro_torch.core import StackedMesh, use_session
    from repro_torch.examples import delegated_moe as dm
    runs = {}
    for where in (dev, "cpu"):
        with use_session():
            res = dm.run_routing(StackedMesh((1, dm.N_SHARDS),
                                             device=where), **EX_MOE)
            res["live"] = res["counters"].get(
                np.arange(EX_MOE["n_experts"], dtype=np.int32))
        runs[str(where)] = res
    card, cpu = runs[str(dev)], runs["cpu"]
    for k in ("assignments", "delegated", "host_tally", "live"):
        require(np.array_equal(card[k], cpu[k]),
                f"delegated_moe {k}: card {card[k]}, CPU {cpu[k]}")
    tally = np.bincount(card["assignments"], minlength=EX_MOE["n_experts"])
    require(np.array_equal(card["delegated"], tally)
            and int(tally.sum()) == EX_MOE["n_tokens"] * EX_MOE["n_waves"],
            f"delegated_moe: delegated {card['delegated']} != tally {tally}")
    return card


def dry_cell(arch, shape_name, art, shape=None, mesh=None, over=None,
             probes=True):
    """One dry-run cell (``launch.dryrun.run_cell``) into ``art``."""
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch import dryrun
    r = dryrun.run_cell(
        arch, shape_name, "single", shape=shape, art_dir=art, force=True,
        verbose=False, run_overrides=over, skip_extrapolation=not probes,
        mesh_config=None if mesh is None
        else MeshConfig(mesh, ("data", "model")))
    require(r["status"] == "ok", f"dry run {arch} x {shape_name}: "
            f"{r.get('error')}\n{r.get('trace', '')}")
    # nothing on the card (a CPU scalar an op wraps is not the card's)
    require("cuda" not in r["devices"], f"dry run {arch} x {shape_name} "
            f"saw tensors on {r['devices']}: {r['off_meta']}")
    if r["off_meta"]:
        say(f"[dryrun] {arch} x {shape_name}: ops that saw a tensor off the "
            f"meta device: {r['off_meta']}")
    return r


def dry_terms(r):
    t = r["roofline"]
    return (f"compute {t['compute_s'] * 1e3:.3f} ms, memory "
            f"{t['memory_s'] * 1e3:.3f} ms, transposes "
            f"{t['collective_s'] * 1e3:.3f} ms ({t['bottleneck']}), useful "
            f"{t['useful_ratio']:.3f}, arguments "
            f"{r['memory']['argument_size_in_bytes'] / 1e9:.2f} GB + peak "
            f"{r['memory']['temp_size_in_bytes'] / 1e9:.2f} GB, fits "
            f"{r['fits_hbm']}, counted in {r['count_s']} s")


def phase_examples(torch, dev, gpu, report):
    """(a) quickstart, serve_kv and delegated_moe on the card, each path's
    counters zeroed just before it and read just after (quickstart's and
    serve_kv's KV kernels and delegated_moe's pack must launch), each
    held as its test holds it (JAX's printed values, the oracle, the CPU
    run); (b) train_lm, 20 steps, losses finite, no kernel; (c) the dry
    run of DRY_CELL at its production shape: memory allocated on the
    card and every launch counter unchanged across it; (d) the dry-run
    cells of the shapes phases 6, 7, 8 and 10 time (their mfu is read
    after phase 10).  Returns the launches of (a) and (b)."""
    import math
    import tempfile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.examples import train_lm
    from repro_torch.kernels import ops as kops
    launches = {k: 0 for k in SOURCES}

    def path(label, fn, must):
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = kops.launch_counts()
        say(f"[main path] {label} launches: {json.dumps(counts)} "
            f"({time.perf_counter() - t0:.1f} s)")
        for k in must:
            require(counts[k] > 0, f"kernel {k} was not launched on the "
                    f"{label} path")
        for k, v in counts.items():
            launches[k] += v
        return out, counts

    qs, _ = path("example quickstart (card, then CPU)",
                 lambda: ex_quickstart(torch, dev), KV_KERNELS)
    say(f"[example] quickstart: counter {qs['counter']}, then-callback "
        f"{qs['then_value']}, GET {qs['get']}, fetch-and-adds "
        f"{qs['fetch_adds']}, fused {qs['fused_get']} / "
        f"{qs['fused_counters']}, dedicated {qs['dedicated_get']} (== JAX's "
        f"and the CPU run's)")
    path("example serve_kv", lambda: ex_serve_kv(torch, dev, gpu),
         ("delegation_pack", "gather", "scatter_last"))
    moe, _ = path("example delegated_moe (card, then CPU)",
                  lambda: ex_moe(torch, dev), ("delegation_pack",))
    say(f"[example] delegated_moe: counts {moe['delegated'].tolist()} == the "
        f"host tally == the CPU run's; imbalance "
        f"{moe['imbalance_unbiased']:.3f} -> {moe['imbalance_biased']:.3f}")
    ck = tempfile.mkdtemp()
    stats = {}
    hist, counts = path("example train_lm", lambda: train_lm.main(
        ["--steps", str(EX_TRAIN_STEPS), "--ckpt-dir", ck, "--device",
         dev.type], stats=stats), ())
    require(not any(counts.values()), "train_lm launched a kernel")
    require(len(hist) == EX_TRAIN_STEPS and all(
        math.isfinite(l) for _, l in hist) and all(
        math.isfinite(m["grad_norm"]) for m in stats["metrics"]),
        f"train_lm: losses {hist}")
    say(f"[example] {gpu} | train_lm 10m preset ({stats['n_params'] / 1e6:.2f}"
        f" M params), {EX_TRAIN_STEPS} steps: loss {hist[0][1]:.4f} -> "
        f"{hist[-1][1]:.4f}, median step "
        f"{sorted(stats['step_s'])[EX_TRAIN_STEPS // 2] * 1e3:.1f} ms")

    # (c) the dry run on the card's machine: nothing allocated, nothing
    # launched
    # (the earlier phases' garbage collected first: the dry run's own
    # collections would free it and move the reading)
    art = tempfile.mkdtemp()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    r = dry_cell(*DRY_CELL, art)
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    counts = kops.launch_counts()
    require(peak == mem0 and mem1 <= mem0, f"the dry run allocated on the "
            f"card: {mem0} bytes before, peak {peak}, {mem1} after")
    require(not any(counts.values()), f"the dry run launched kernels: "
            f"{counts}")
    say(f"[dryrun] {DRY_CELL[0]} x {DRY_CELL[1]} (B 128, 32,768 positions, "
        f"the (16, 16) mesh stacked on the meta device), "
        f"{time.perf_counter() - t0:.1f} s: {dry_terms(r)}; card memory "
        f"allocated {mem0} -> {mem1} bytes (peak {peak}), launches "
        f"{json.dumps(counts)}")
    # (d) the timed phases' cells
    report["mfu_cells"] = {}
    for key, arch, kind, s, b, mesh, over in MFU_CELLS:
        report["mfu_cells"][key] = dry_cell(
            arch, f"{kind}_{b}x{s}", art, ShapeConfig(key, s, b, kind), mesh,
            over, probes=False)
    return launches


# ---------------------------------------------------------------------------
# phase 15: the compiled step — every path twice, eager and captured
# ---------------------------------------------------------------------------

# the paths: the serves at full width and depth over 4 trustees, and the
# KV rounds at kv_paper's, kv_mux's, kv_drain's and kv_failover's sizes
CP_SERVE = dict(batch=8, prompt_len=32, gen=32, mesh_model=4)
CP_ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b")
CP_PAPER_ROUNDS = 20
CP_MUX_STEPS = 8
CP_DRAIN_STEPS = 8
CP_FO = dict(waves=8, snap_every=4, kill=(6, 3))
# the serves' busy share: 5 decode steps (10 until the script reached
# 1208.4 s on a slow host)
CP_BUSY_STEPS = 5


def cp_serve_argv(arch):
    q = CP_SERVE
    return ["--arch", arch, "--batch", str(q["batch"]), "--prompt-len",
            str(q["prompt_len"]), "--gen", str(q["gen"]), "--mesh-model",
            str(q["mesh_model"])]


def cp_both(torch, run):
    """``run(eager)`` under ``compiled.disable()`` and captured (the
    default), the launch counters zeroed before each and the captures
    listed: {"eager" | "captured": (out, counts, captures)}."""
    from repro_torch.core import compiled
    from repro_torch.kernels import ops as kops
    got = {}
    for mode in ("eager", "captured"):
        compiled.reset_captures()
        kops.reset_launch_counts()
        if mode == "eager":
            with compiled.disable():
                out = run(True)
        else:
            out = run(False)
        torch.cuda.synchronize()
        got[mode] = (out, kops.launch_counts(), compiled.captures())
    return got


def cp_gates(label, got, same):
    (a, ca, _), (b, cb, caps) = got["eager"], got["captured"]
    require(same(a, b), f"compiled {label}: the captured path differs from "
            f"the eager path")
    require(ca == cb, f"compiled {label}: launch counts eager {ca}, "
            f"captured {cb}")
    require(caps, f"compiled {label}: nothing was captured")
    return ca, caps


def caps_text(caps):
    by = {}
    for c in caps:
        by.setdefault(c["site"], []).append(c)
    return "; ".join(
        f"{site}: {len(cs)} program(s), capture "
        + ", ".join(f"{c['capture_ms']:.1f}" for c in cs) + " ms, pool "
        + ", ".join(f"{c['pool_bytes'] / 2 ** 20:.1f}" for c in cs) + " MiB"
        for site, cs in by.items())


def cp_serve(torch, dev, gpu, arch, report):
    """serve.main twice on the same weights (seed 0) and prompt: the
    tokens and the last step's logits bit for bit, the launch counts; ms a
    step and the host's issue time a step both ways; then the busy share
    of CP_BUSY_STEPS decode steps of the serve's shape both ways."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import compiled
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.testing.model import DecodeLogits
    q = CP_SERVE
    last = q["prompt_len"] + q["gen"] - 2

    def run(_eager):
        stats = {}
        with DecodeLogits(pos=last) as rec:
            out = serve.main(cp_serve_argv(arch), stats=stats)
        torch.cuda.synchronize()
        logits = rec.logits
        torch.cuda.empty_cache()
        return out, logits, stats
    got = cp_both(torch, run)

    def same(a, b):
        return np.array_equal(a[0], b[0]) and a[1] is not None \
            and b[1] is not None and torch.equal(a[1], b[1])
    counts, caps = cp_gates(f"{arch} serve", got, same)
    se, sc = got["eager"][0][2], got["captured"][0][2]
    # the busy share of the decode steps, the serve's weights drawn again
    cfg = get_arch(arch)
    t = q["mesh_model"]
    max_len = -(-(q["prompt_len"] + q["gen"]) // t) * t
    shape = ShapeConfig("cp", max_len, q["batch"], "decode")
    run_cfg = RunConfig(model=cfg, shape=shape,
                        mesh=MeshConfig((1, t), ("data", "model")),
                        remat="none", use_pallas=True)
    plan = build_cell(cfg, shape, run_cfg)
    params = M.init_params(cfg, run_cfg, dev)
    busy = {}
    for mode in ("eager", "captured"):
        cache = M.init_cache(cfg, q["batch"], max_len, run_cfg, dev)
        tok = torch.zeros((q["batch"],), dtype=torch.int32, device=dev)
        pos = [torch.full((q["batch"],), q["prompt_len"] + i,
                          dtype=torch.int32, device=dev)
               for i in range(CP_BUSY_STEPS)]

        def steps():
            nonlocal tok
            for p in pos:
                tok, _ = plan.step_fn(params, cache, tok, p)
        if mode == "eager":
            with compiled.disable():
                busy[mode] = busy_share(torch, steps, 1)
        else:
            busy[mode] = busy_share(torch, steps, 1)
        del cache
    del params, plan
    torch.cuda.empty_cache()
    report[f"compiled_{arch}"] = dict(
        ms_per_step={"eager": se["ms_per_step"],
                     "captured": sc["ms_per_step"]},
        issue_ms_per_step={"eager": se["issue_ms_per_step"],
                           "captured": sc["issue_ms_per_step"]},
        busy={m: list(b) for m, b in busy.items()}, captures=caps)
    say(f"[compiled {arch}] {gpu} | serve {q['batch']} x ({q['prompt_len']}"
        f" + {q['gen']}) over {t} trustees, eager and captured on the same "
        f"weights: tokens and the last step's logits equal bit for bit, "
        f"launches equal ({json.dumps({k: v for k, v in counts.items() if v})}"
        f"); ms a step eager {se['ms_per_step']:.3f}, captured "
        f"{sc['ms_per_step']:.3f}; host issue a step (median, no "
        f"synchronize) eager {se['issue_ms_per_step']:.3f} ms, captured "
        f"{sc['issue_ms_per_step']:.3f} ms; busy over {CP_BUSY_STEPS} steps "
        f"eager {busy_text(busy['eager'])}, captured "
        f"{busy_text(busy['captured'])}; {caps_text(caps)}")
    return counts


def cp_rounds(torch, dev, gpu, label, make, trace, report, busy_batch):
    """A KV path twice: ``make(sess)`` builds its stores (each with its own
    session), every round submits each store's batches of ``trace`` and
    issues ``session.step(sync=False)`` (its host time is the issue time),
    then reads the stats.  Gates: every answer, stat and table bit for
    bit, the launch counts.  Readings: ops/s, issue ms a round, the busy
    share of 10 more rounds of ``busy_batch``, captures, cache entries."""
    from repro_torch.core import TrustSession

    def run(_eager):
        sess = TrustSession()
        stores = make(sess)
        futs, stats, issue, rounds = [], [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batches in trace:
            t2 = time.perf_counter()
            futs.append([submit_batches(torch, dev, st, b)
                         for st, b in zip(stores, batches)])
            t1 = time.perf_counter()
            sess.step(sync=False)
            issue.append(time.perf_counter() - t1)
            stats.append(sess.last_stats())
            rounds.append(time.perf_counter() - t2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        answers = [[results(f, b) for f, b in zip(fs, batches)]
                   for fs, batches in zip(futs, trace)]
        tables = [st.dump() for st in stores]

        def one_round():
            for st, b in zip(stores, busy_batch):
                submit_batches(torch, dev, st, b)
            sess.step(sync=False)
        busy = busy_share(torch, one_round, 10)
        return dict(answers=answers, stats=stats, tables=tables, wall=wall,
                    issue=issue, rounds=rounds, busy=busy,
                    entries=len(sess._cache))
    got = cp_both(torch, run)

    def same(a, b):
        return (all(same_answers(x, y) for ra, rb in zip(a["answers"],
                                                          b["answers"])
                    for sa, sb in zip(ra, rb) for x, y in zip(sa, sb))
                and a["stats"] == b["stats"]
                and all(np.array_equal(x, y)
                        for x, y in zip(a["tables"], b["tables"])))
    counts, caps = cp_gates(label, got, same)
    e, c = got["eager"][0], got["captured"][0]
    ops = sum(int((b[1] >= 0).sum()) for batches in trace
              for bs in batches for b in bs)

    def median_ms(r, key):
        later = sorted(r[key][1:]) or r[key]
        return 1e3 * later[len(later) // 2]

    def issue_ms(r):
        return median_ms(r, "issue")
    report[f"compiled_{label}"] = dict(
        ops_s={"eager": ops / e["wall"], "captured": ops / c["wall"]},
        round_ms={"eager": median_ms(e, "rounds"),
                  "captured": median_ms(c, "rounds")},
        issue_ms={"eager": issue_ms(e), "captured": issue_ms(c)},
        busy={"eager": list(e["busy"]), "captured": list(c["busy"])},
        captures=caps, entries=c["entries"])
    say(f"[compiled {label}] {gpu} | {len(trace)} rounds, {ops} ops, eager "
        f"and captured: every answer, stat and table equal bit for bit, "
        f"launches equal ({json.dumps({k: v for k, v in counts.items() if v})}"
        f"); eager {ops / e['wall']:.1f} ops/s, captured "
        f"{ops / c['wall']:.1f} ops/s (stats read each round; the first "
        f"round's capture included); a round after the first (median, "
        f"submit to stats) eager {median_ms(e, 'rounds'):.3f} ms, captured "
        f"{median_ms(c, 'rounds'):.3f} ms; host issue a "
        f"round (median of session.step(sync=False)) eager "
        f"{issue_ms(e):.3f} ms, captured {issue_ms(c):.3f} ms; busy over 10 "
        f"rounds eager {busy_text(e['busy'])}, captured "
        f"{busy_text(c['busy'])}; {caps_text(caps)}; {c['entries']} "
        f"_cache entries at the end")
    return counts


def cp_failover(torch, dev, gpu, report):
    """kv_failover's store (shared, shortcut off, capacity 2,058), 8 waves
    of 8,232 rows: a snapshot at wave 0 and 4, shard 3 killed at wave 6,
    restore and re-entrust onto 7 shards, waves 4-5 replayed.  Gates: the
    acked history, the table and the stats bit for bit, the launches; and
    the captured run evicts every compiled round at the re-entrust and
    replays none on the old addresses (every entry left is keyed by the
    state's own addresses)."""
    import shutil
    import tempfile
    from repro_torch.core import TrustSession, compiled
    from repro_torch.testing import failover as fo
    init, waves = fo.mixed_waves(29, N_KEYS, VW, FO_ROWS, CP_FO["waves"])

    def run(_eager):
        ckdir = tempfile.mkdtemp(prefix="cp_failover_")
        try:
            sess = TrustSession()
            st = fo_store(dev, "kernel", init, sess)
            left = []
            real = sess.re_entrust

            def re_entrust(*a, **kw):
                real(*a, **kw)
                left.append(len(sess._cache))
            sess.re_entrust = re_entrust
            t0 = time.perf_counter()
            out = fo.run_kv_chaos(
                st, sess, waves, ckdir, dev,
                schedule={CP_FO["kill"][0]: ("kill", CP_FO["kill"][1])},
                snap_every=CP_FO["snap_every"],
                sync=lambda: device_sync(torch, dev))
            wall = time.perf_counter() - t0
            stale = [k for k in sess._cache
                     if k[-2] != compiled.addresses(st.trust._state)]
            stats = sess.last_stats()
            rec = stats.pop("recovery")
            # the recovery's host milliseconds are a reading, not a result
            stats["recovery"] = {k: v for k, v in rec.items()
                                 if k != "recovery_ms"}
            return dict(acked=out["acked"], failures=out["failures"],
                        table=st.dump(), stats=stats,
                        left=left, stale=len(stale), wall=wall,
                        entries=len(sess._cache),
                        replay_equal=out["replay_equal"])
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
    got = cp_both(torch, run)

    def same(a, b):
        return (sorted(a["acked"]) == sorted(b["acked"])
                and all(fo.same_acks(a["acked"][w][0], b["acked"][w][0])
                        and a["acked"][w][1] == b["acked"][w][1]
                        for w in a["acked"])
                and np.array_equal(a["table"], b["table"])
                and a["stats"] == b["stats"]
                and a["failures"] == b["failures"])
    counts, caps = cp_gates("kv_failover", got, same)
    c = got["captured"][0]
    require(c["failures"] and c["left"] == [0] and c["stale"] == 0
            and c["replay_equal"],
            f"compiled kv_failover: failures {c['failures']}, entries left "
            f"at the re-entrust {c['left']}, {c['stale']} entries on old "
            f"addresses, replays equal {c['replay_equal']}")
    e = got["eager"][0]
    report["compiled_kv_failover"] = dict(
        seconds={"eager": e["wall"], "captured": c["wall"]},
        captures=caps, entries=c["entries"])
    say(f"[compiled kv_failover] {gpu} | {CP_FO['waves']} waves x {FO_ROWS} "
        f"rows, snapshots at waves 0 and {CP_FO['snap_every']}, shard "
        f"{CP_FO['kill'][1]} killed at wave {CP_FO['kill'][0]}, re-entrusted "
        f"onto 7 and waves {CP_FO['snap_every']}-{CP_FO['kill'][0] - 1} "
        f"replayed: acks, table and stats equal eager and captured bit for "
        f"bit, launches equal; the re-entrust left {c['left'][0]} compiled "
        f"rounds, none keyed on an old address at the end "
        f"({c['entries']} entries); wall eager {e['wall']:.3f} s, captured "
        f"{c['wall']:.3f} s (a synchronize each wave, the checkpoints "
        f"included); {caps_text(caps)}")
    return counts


# (e) the train step: qwen2.5-3b at full width and depth, phase 10's cell
CP_TRAIN = dict(batch=4, seq=1024, steps=4, remat="full", busy_steps=2)
# (f) the prefills at B 4 x 2048 (deepseek's experts over 4 trustees):
# one eager call's logits against three captured calls'
CP_PREFILL = dict(batch=4, seq=2048, calls=3)
CP_PREFILL_ARCHS = (("qwen2.5-3b", 1), ("deepseek-v2-lite-16b", 4),
                    ("falcon-mamba-7b", 1))
# (g) the busy share's run, both ways: the profiler's records of a paged
# run's many small host ops are slow to read back (phase 9 reads a
# 32-request run's, captured); at 16 requests the two readings took most
# of (g)'s 170.7-239.0 s, and the whole script 1208.4 s on a slow host
CP_PAGED_BUSY_REQUESTS = 4
_INT_OF = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def leaf_checksums(torch, leaves, block=1 << 26):
    """Each leaf's bits as integers, summed weighted by position mod 8191
    (int64, wrapping): equal tensors give equal sums, a change of one
    element or an exchange of two changes it.  In blocks, so the
    temporaries stay small beside a full-width model's state."""
    sums = []
    for x in leaves:
        bits = x.detach().reshape(-1).view(
            getattr(torch, _INT_OF[x.element_size()]))
        total = torch.zeros((), dtype=torch.int64, device=x.device)
        for i in range(0, bits.numel(), block):
            part = bits[i:i + block].long()
            w = torch.arange(i, i + part.numel(), device=x.device) % 8191 + 1
            total += (part * w).sum()
        sums.append(total)
    return torch.stack(sums).tolist()


def ms_median(xs):
    xs = sorted(xs)
    return 1e3 * xs[len(xs) // 2]


def cp_train(torch, dev, gpu, report):
    """(e) qwen2.5-3b's train cell at full width and depth (bf16 weights,
    f32 moments, remat "full", B 4 x 1024), CP_TRAIN["steps"] steps
    under compiled.disable(), the initial state restored IN PLACE (the
    weights from a host copy, the moments and the step count zeroed, as
    init_adamw made them: the addresses kept), the same steps captured
    (one program: the first call runs eagerly and captures, the rest
    replay).  Gates: every step's metrics (loss, nll, accuracy,
    grad_norm, lr) and every leaf's checksum after the steps equal bit
    for bit, launches equal (none).  Readings: ms a step and host issue
    ms a step (median of steps 2-4), the busy share of CP_TRAIN
    ["busy_steps"] more steps, capture ms, pool bytes, peak GB."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    from repro_torch.models.layers import dtype_of
    from repro_torch.optim import init_adamw
    from repro_torch.optim.optimizer import tree_leaves
    q = CP_TRAIN
    cfg = get_arch("qwen2.5-3b")
    shape = ShapeConfig("cp", q["seq"], q["batch"], "train")
    run = RunConfig(model=cfg, shape=shape,
                    mesh=MeshConfig((1, 1), ("data", "model")),
                    learning_rate=3e-3, remat=q["remat"])
    torch.cuda.empty_cache()
    plan = build_cell(cfg, shape, run)
    params = M.init_params(cfg, run, dev)
    opt = init_adamw(params, dtype_of(run.opt_dtype))
    host = [p.detach().to("cpu", copy=True) for p in tree_leaves(params)]
    pipe = TokenPipeline(DataConfig(seed=run.seed,
                                    vocab_size=cfg.vocab_size), cfg, shape)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in pipe.model_batch_at(i).items()}
               for i in range(q["steps"])]
    state = {"opt": opt}

    def one_step(batch):
        _p, state["opt"], m = plan.step_fn(params, state["opt"], batch)
        return m

    def run_steps(eager):
        for p, h in zip(tree_leaves(params), host):
            p.detach().copy_(h)
        for x in tree_leaves(tuple(opt)):
            x.zero_()
        state["opt"] = opt
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, issue, step = [], [], []
        for batch in batches:
            t0 = time.perf_counter()
            m = one_step(batch)
            issue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            step.append(time.perf_counter() - t0)
            metrics.append({k: v.clone() for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated() / 1e9
        sums = leaf_checksums(torch, tree_leaves(params)
                              + tree_leaves(tuple(state["opt"])))
        busy = busy_share(torch, lambda: float(one_step(batches[0])["loss"]),
                          q["busy_steps"])
        progs = list(plan.step_fn.__wrapped__.programs.values())
        return dict(metrics=metrics, sums=sums, issue=issue, step=step,
                    peak=peak, busy=busy, programs=len(progs),
                    replays=[p.replays for p in progs])
    got = cp_both(torch, run_steps)

    def same(a, b):
        return (a["sums"] == b["sums"]
                and all(sorted(x) == sorted(y) and all(
                    torch.equal(x[k], y[k]) for k in x)
                    for x, y in zip(a["metrics"], b["metrics"])))
    counts, caps = cp_gates("qwen2.5-3b train", got, same)
    e, c = got["eager"][0], got["captured"][0]
    require(e["programs"] == 0 and c["programs"] == 1
            and c["replays"][0] >= q["steps"] - 1,
            f"compiled train: programs eager {e['programs']}, captured "
            f"{c['programs']} replayed {c['replays']} times")
    require(not any(counts.values()), f"compiled train: the training path "
            f"launched a kernel: {counts}")
    (cap,) = [x for x in caps if x["site"] == "train_step"]
    plan.release()
    del params, opt, state, host, batches
    torch.cuda.empty_cache()

    def later(xs):
        return ms_median(xs[1:])
    report["compiled_qwen_train"] = dict(
        ms_per_step={"eager": later(e["step"]), "captured": later(c["step"])},
        issue_ms_per_step={"eager": later(e["issue"]),
                           "captured": later(c["issue"])},
        first_step_ms={"eager": 1e3 * e["step"][0],
                       "captured": 1e3 * c["step"][0]},
        busy={"eager": list(e["busy"]), "captured": list(c["busy"])},
        peak_gb={"eager": e["peak"], "captured": c["peak"]},
        capture_ms=cap["capture_ms"], pool_bytes=cap["pool_bytes"])
    say(f"[compiled qwen2.5-3b train] {gpu} | B {q['batch']} x {q['seq']}, "
        f"remat {q['remat']}, bf16 weights, f32 moments, {q['steps']} steps "
        f"eager, the initial state restored in place, {q['steps']} steps "
        f"captured: every step's metrics (losses "
        f"{[round(float(m['loss']), 6) for m in c['metrics']]}, grad norms "
        f"{[round(float(m['grad_norm']), 4) for m in c['metrics']]}, lr "
        f"{[float(m['lr']) for m in c['metrics']]}) and all "
        f"{len(c['sums'])} leaves' checksums equal bit for bit, no kernel "
        f"launched; ms a step (median of steps 2-{q['steps']}) eager "
        f"{later(e['step']):.3f}, captured {later(c['step']):.3f}; host "
        f"issue a step (no synchronize) eager {later(e['issue']):.3f} ms, "
        f"captured {later(c['issue']):.3f} ms; the first step eager "
        f"{1e3 * e['step'][0]:.3f} ms, captured {1e3 * c['step'][0]:.3f} ms "
        f"(its eager run and the capture: {cap['capture_ms']:.1f} ms, pool "
        f"{cap['pool_bytes'] / 1e9:.3f} GB); busy over {q['busy_steps']} "
        f"steps eager {busy_text(e['busy'])}, captured "
        f"{busy_text(c['busy'])}; peak allocated eager {e['peak']:.2f} GB, "
        f"captured {c['peak']:.2f} GB (the first call's warm-up, then its "
        f"pool)")
    return counts


def cp_prefill(torch, dev, gpu, arch, t, report):
    """(f) ``build_cell``'s prefill at B 4 x 2048 through the kernels
    (use_pallas), the serve's weights (seed 0): CP_PREFILL["calls"] calls
    eager and as many captured (the first runs eagerly and captures, the
    rest replay), call i on batch i of as many distinct token batches.
    Gates: each captured call's logits equal the eager call's on the same
    batch bit for bit (so a replay recomputes from its own inputs: the
    batches' logits differ), launches equal.  Readings: ms a call
    (median), the busy share of one call, capture ms, pool bytes."""
    from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import model as M
    q = CP_PREFILL
    cfg = get_arch(arch)
    run = RunConfig(model=cfg, shape=ShapeConfig("cp", q["seq"], q["batch"],
                                                 "prefill"),
                    mesh=MeshConfig((1, t), ("data", "model")),
                    remat="none", use_pallas=True)
    torch.cuda.empty_cache()
    params = M.init_params(cfg, run, dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size,
                                        (q["batch"], q["seq"]),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)}
               for _ in range(q["calls"])]

    def calls(_eager):
        plan = build_cell(cfg, run.shape, run)
        outs, secs = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(plan.step_fn(params, batch))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        busy = busy_share(torch, lambda: plan.step_fn(params, batches[0]), 1)
        plan.release()
        return outs, secs, busy
    got = cp_both(torch, calls)
    want = got["eager"][0][0]
    require(not any(torch.equal(want[i], want[j])
                    for i in range(len(want)) for j in range(i)),
            f"compiled {arch} prefill: two distinct batches gave the same "
            f"logits, so the gate could not tell a stale replay")

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a[0], b[0])) \
            and len(a[0]) == len(b[0]) == len(batches)
    counts, caps = cp_gates(f"{arch} prefill", got, same)
    (cap,) = [x for x in caps if x["site"] == "prefill_step"]
    (_, se, be), (_, sc, bc) = got["eager"][0], got["captured"][0]
    del params, got, want, batches
    torch.cuda.empty_cache()
    report[f"compiled_{arch}_prefill"] = dict(
        ms={"eager": ms_median(se), "captured": ms_median(sc[1:])},
        first_ms={"eager": 1e3 * se[0], "captured": 1e3 * sc[0]},
        busy={"eager": list(be), "captured": list(bc)},
        capture_ms=cap["capture_ms"], pool_bytes=cap["pool_bytes"])
    say(f"[compiled {arch} prefill] {gpu} | B {q['batch']} x {q['seq']} over "
        f"{t} trustee(s), {q['calls']} calls each way on {q['calls']} "
        f"distinct batches: each call's logits equal the eager call's on "
        f"its batch bit for bit, launches equal "
        f"({json.dumps({k: v for k, v in counts.items() if v})}); ms a call "
        f"eager {ms_median(se):.3f} (median), captured "
        f"{ms_median(sc[1:]):.3f} (median of the replays; the first "
        f"{1e3 * sc[0]:.3f}: its eager run and the capture, "
        f"{cap['capture_ms']:.1f} ms); busy eager {busy_text(be)}, captured "
        f"{busy_text(bc)}; pool {cap['pool_bytes'] / 2 ** 20:.1f} MiB")
    return counts


def cp_paged(torch, dev, gpu, report):
    """(g) phase 5's paged decode (128 requests over 8 trustees at
    qwen2.5-3b attention width, bf16), its model callback eager and
    captured (one program a shape of its inputs), keeping every decode
    output (``record``).  Gates: every decode output, the final KV pool
    and the final page table bit for bit, no leaked page, every request
    served, launches equal.  Readings: tokens/s,
    the busy share of a CP_PAGED_BUSY_REQUESTS-request run, the
    programs' count, their total capture ms and pool bytes."""
    inputs = paged_inputs(torch, dev)

    def run(_eager):
        stats = paged_run(torch, dev, inputs, record=True)
        busy = busy_share(torch, lambda: paged_run(
            torch, dev, inputs, n_requests=CP_PAGED_BUSY_REQUESTS), 1)
        return stats, busy
    got = cp_both(torch, run)

    def same(a, b):
        a, b = a[0], b[0]
        return (len(a["ys"]) == len(b["ys"])
                and all(np.array_equal(x, y) for x, y in zip(a["ys"], b["ys"]))
                and all(torch.equal(a["pool"][k], b["pool"][k])
                        for k in b["pool"])
                and all(np.array_equal(a["dump"][k], b["dump"][k])
                        for k in b["dump"])
                and a["tokens"] == b["tokens"])
    counts, caps = cp_gates("paged_decode", got, same)
    (e, be), (c, bc) = got["eager"][0], got["captured"][0]
    for st in (e, c):
        a = st["audit"]
        require(st["completed"] == N_REQUESTS and st["failed"] == 0
                and a["consistent"] and a["leaked"] == 0
                and a["allocated"] == 0,
                f"compiled paged_decode: {st['completed']} completed, "
                f"{st['failed']} failed, audit {a}")
    pr = c["programs"]
    require(e["programs"]["count"] == 0 and pr["count"] > 0,
            f"compiled paged_decode: programs eager {e['programs']}, "
            f"captured {pr}")
    del inputs, got
    torch.cuda.empty_cache()
    report["compiled_paged_decode"] = dict(
        tokens_per_s={"eager": e["tokens_per_s"],
                      "captured": c["tokens_per_s"]},
        busy={"eager": list(be), "captured": list(bc)}, programs=pr)
    say(f"[compiled paged_decode] {gpu} | {N_REQUESTS} requests, "
        f"{c['tokens']} tokens, eager and captured (keeping the outputs): "
        f"every decode output ({len(c['ys'])} calls), the final KV pool and "
        f"page table equal bit for bit, no leaked page, launches equal "
        f"({json.dumps({k: v for k, v in counts.items() if v})}); "
        f"{e['tokens_per_s']:.1f} tokens/s eager, {c['tokens_per_s']:.1f} "
        f"captured (its captures included); host time in the callbacks "
        f"eager {e['host']['prefill_s'] + e['host']['decode_s']:.3f} s, "
        f"captured {c['host']['prefill_s'] + c['host']['decode_s']:.3f} s; "
        f"busy over a {CP_PAGED_BUSY_REQUESTS}-request run eager "
        f"{busy_text(be)}, captured "
        f"{busy_text(bc)}; {pr['count']} programs (one a shape), capture "
        f"{pr['capture_ms']:.1f} ms and pool "
        f"{pr['pool_bytes'] / 2 ** 20:.1f} MiB in all")
    return counts


def phase_compiled(torch, dev, gpu, report):
    """Phase 15: each path eager (``compiled.disable()``) and captured on
    the same weights and traffic: the serves, the KV rounds, the train
    step, the prefills and the paged decode.  Each model's weights and
    programs are freed before the next is drawn.  Returns the launches
    of both ways."""
    total = {k: 0 for k in SOURCES}
    t0 = [time.perf_counter()]

    def add(counts):
        for k, v in counts.items():
            total[k] += 2 * v
        say(f"[time] phase 15 path: {time.perf_counter() - t0[0]:.1f} s")
        t0[0] = time.perf_counter()
    for arch in CP_ARCHS:
        add(cp_serve(torch, dev, gpu, arch, report))
    rng = np.random.default_rng(1515)
    init = rng.integers(0, 8, (N_KEYS, VW)).astype(np.float32)
    paper = [[paper_batches(*rd)] for rd in
             paper_trace(rng, rounds=CP_PAPER_ROUNDS)]
    cap = 2 * len(paper[0][0][0][1]) // (MESH[0] * MESH[1])
    add(cp_rounds(torch, dev, gpu, "kv_paper",
                  lambda sess: [make_store(dev, "kernel", "kernel", cap,
                                           init, sess, "cp_paper")],
                  paper, report, paper[0]))
    (ikv, io), mux = mux_traces("strided", rounds=CP_MUX_STEPS)
    add(cp_rounds(torch, dev, gpu, "kv_mux",
                  lambda sess: list(mux_pair(dev, "strided", "kernel", sess,
                                             (ikv, io))),
                  mux, report, mux[0]))
    drain = [[b] for b in mixed_trace(rng, init, rounds=CP_DRAIN_STEPS,
                                      r=MIXED_ROWS)]
    add(cp_rounds(torch, dev, gpu, "kv_drain",
                  lambda sess: [make_store(
                      dev, "kernel", "kernel", DRAIN_CAPACITY, init, sess,
                      "cp_drain", max_rounds=DRAIN_ROUNDS,
                      overflow="defer", local_shortcut=False)],
                  drain, report, drain[0]))
    add(cp_failover(torch, dev, gpu, report))
    add(cp_train(torch, dev, gpu, report))
    for arch, t in CP_PREFILL_ARCHS:
        add(cp_prefill(torch, dev, gpu, arch, t, report))
    add(cp_paged(torch, dev, gpu, report))
    return total


def mfu_readings(gpu, report):
    """The dry-run terms of the cells phases 6, 7, 8 and 10 time, beside
    those phases' measured medians from this run: mfu = model FLOPs /
    989 TFLOP/s / the measured step (readings, no gate)."""
    for key, arch, kind, s, b, mesh, _ in MFU_CELLS:
        r = report["mfu_cells"].get(key)
        if r is None or key not in report:
            continue
        measured = b * s / report[key]["tokens_per_s"]
        mf = rooflines.model_flops(kind, r["n_active_params"], b * s)
        t = r["roofline"]
        bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
        say(f"[mfu] {gpu} | {key} ({arch}, {kind} B {b} x {s}, mesh "
            f"{mesh}): measured {measured * 1e3:.3f} ms (this run's "
            f"median), model FLOPs {mf:.4e} ({r['n_active_params']} active "
            f"params), mfu {mf / rooflines.PEAK_FLOPS / measured * 100:.2f}%;"
            f" dry run: {dry_terms(r)}; measured / the dry run's binding "
            f"term {measured / bound:.2f}")


def main_shapes(n_dev):
    """The pack and serve kernels' shapes on the main paths' rounds:
    kv_paper (a fused GET + PUT batch a client) and kv_mixed."""
    k_local = N_KEYS // n_dev
    r_paper = 2 * 8192 // n_dev          # fused GET + PUT batch per client
    c_paper = max(4, 2 * (r_paper // n_dev))
    r_mixed = 65536 // n_dev
    return {
        "pack_paper": dict(d=n_dev, r=r_paper, t=n_dev, c=c_paper,
                           c2=c_paper, w=6),
        "pack_mixed": dict(d=n_dev, r=r_mixed, t=n_dev, c=r_mixed,
                           c2=r_mixed, w=10),
        "serve_paper": dict(t=n_dev, n=n_dev * 2 * c_paper + r_paper,
                            k=k_local, w=VW, mix=(0.95, 0.05, 0.0, 0.0)),
        "serve_mixed": dict(t=n_dev, n=n_dev * 2 * r_mixed + r_mixed,
                            k=k_local, w=VW, mix=(0.4, 0.2, 0.2, 0.2)),
    }


def kernel_info(torch, n_dev):
    """Registers, spills and shared memory of the flash-attention kernel
    at each head dim it takes (D 256 new, gemma-7b's); registers, spills,
    shared memory and resident warps of the
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
    from repro_torch.kernels import flash_attention as kfa
    for d in kfa.HEAD_DIMS:
        i = kfa.kernel_info(d)
        say(f"[build] flash_attention D {d} ({i['kernel']} kernel): "
            f"{i['registers']} registers, {i['local_bytes']} bytes local "
            f"(spills), {i['smem']} bytes of shared memory a block")
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
    ap.add_argument("--phases",
                    default="1,2,3,4,4a,4b,4c,4d,4e,4f,5,6,7,8,11,12,13,14,"
                            "15,9,10",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    started = time.perf_counter()

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
    shapes = main_shapes(n_dev)
    report = {}

    errs = {}
    if "2" in phases:
        errs = phase_kernels(torch, dev, shapes)
        phase_paged_kernels(torch, dev, errs)
        phase_flash_kernels(torch, dev, errs)
        phase_gmm_kernels(torch, dev, errs)
        phase_scan_kernels(torch, dev, errs)
        phase_mux_kernels(torch, dev)

    # the main paths, each with the counters zeroed just before it and read
    # just after: kv_paper (a) and (b), 40 kernel-path rounds each (the (a)
    # ref path launches none); kv_mixed, 8 rounds with the shortcut and 8
    # without; the paged decode's timed run
    launches = {k: 0 for k in SOURCES}
    per_round = {"kv_paper": {}, "kv_mixed": {}, "gather_lanes": {}}
    for phase, label, rounds, run in (
            ("3", "kv_paper", 80, lambda: phase_paper(torch, dev, report)),
            ("4", "kv_mixed", 16, lambda: phase_mixed(torch, dev, report))):
        if phase not in phases:
            continue
        kops.reset_launch_counts()
        run()
        counts = kops.launch_counts()
        lanes = list(kops.KERNELS["gather"].lane_launches)
        per_round[label] = {k: v / rounds for k, v in counts.items()}
        per_round["gather_lanes"][label] = [v / rounds for v in lanes]
        say(f"[main path] {label} launches over {rounds} kernel-path "
            f"rounds: {json.dumps(counts)}; gather by lane: "
            + ", ".join(f"{GATHER_LANES.get(i, 'PUT')} {v}"
                        for i, v in enumerate(lanes)))
        require(sum(lanes) == counts["gather"],
                "gather's launches by lane do not sum to its count")
        for k in (("delegation_pack", "gather", "scatter_last")
                  if label == "kv_paper" else KV_KERNELS):
            require(counts[k] > 0, f"kernel {k} was not launched on the "
                    f"{label} main path")
        for k, v in counts.items():
            launches[k] += v
    for k, v in report.items():
        say(f"[ops/s] {gpu} | {k}: {v:.1f}")
    say(f"[time] phases 1-4: {time.perf_counter() - started:.1f} s")
    # the multiplexed session round, the lock lanes, dedicated mode, the
    # defer drain and combining, counters zeroed just before each and read
    # just after (their ref paths launch none)
    for phase, label, run in (
            ("4a", "kv_mux", lambda: phase_mux(torch, dev, gpu)),
            ("4b", "kv_locks", lambda: phase_locks(torch, dev, gpu)),
            ("4c", "kv_dedicated",
             lambda: phase_dedicated(torch, dev, gpu, report)),
            ("4d", "kv_drain", lambda: phase_drain(torch, dev, gpu, report)),
            ("4e", "kv_combine",
             lambda: phase_combine(torch, dev, gpu, report))):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        kops.reset_launch_counts()
        run()
        counts = kops.launch_counts()
        say(f"[main path] {label} launches: {json.dumps(counts)} "
            f"({time.perf_counter() - t0:.1f} s)")
        for k in KV_KERNELS:
            require(counts[k] > 0, f"kernel {k} was not launched on the "
                    f"{label} main path")
        for k, v in counts.items():
            launches[k] += v
    if "4f" in phases:
        t0 = time.perf_counter()
        counts = phase_failover(torch, dev, gpu, report)
        say(f"[main path] kv_failover launches ((a)-(d), the ref paths "
            f"launch none): {json.dumps(counts)} "
            f"({time.perf_counter() - t0:.1f} s)")
        for k, v in counts.items():
            launches[k] += v
        say(f"[time] through phase 4f: {time.perf_counter() - started:.1f} s")
    paged = None
    if "5" in phases:
        paged = phase_paged(torch, dev, gpu, report, errs)
        for k, v in paged[0].items():
            launches[k] += v
        say(f"[time] through phase 5: {time.perf_counter() - started:.1f} s")
    qwen = None
    if "6" in phases:
        qwen = phase_qwen(torch, dev, gpu, report, errs)
        launches["flash_attention"] += qwen[0]
        for k, v in qwen[3].items():
            launches[k] += v
        say(f"[time] through phase 6: {time.perf_counter() - started:.1f} s")
    deep = None
    if "7" in phases:
        deep = phase_deepseek(torch, dev, gpu, report, errs)
        for k, v in deep[0].items():
            launches[k] += v
        if "9" in phases:
            # the deepseek prefill's busy share now: its weights leave the
            # card before phase 8 draws falcon-mamba-7b's
            phase_deepseek_busy(torch, dev, gpu, deep[5], deep[6])
        deep = deep[:5] + (deep[6],)
        torch.cuda.empty_cache()
        say(f"[time] through phase 7: {time.perf_counter() - started:.1f} s")
    falcon = None
    if "8" in phases:
        falcon = phase_falcon(torch, dev, gpu, report, errs,
                              busy="9" in phases)
        for k, v in falcon[0].items():
            launches[k] += v
        say(f"[time] through phase 8: {time.perf_counter() - started:.1f} s")
    # phase 9's kernel inputs wait on the host (moved back below)
    qwen, deep, falcon = park(torch, (qwen, deep, falcon), "cpu")
    torch.cuda.empty_cache()
    if "11" in phases:
        t0 = time.perf_counter()
        n_zoo = phase_zoo(torch, dev, gpu, report, errs)
        launches["flash_attention"] += n_zoo
        say(f"[main path] phase 11 flash launches (one prefill call of each "
            f"architecture, and seamless's forward_loss): {n_zoo} "
            f"({time.perf_counter() - t0:.1f} s)")
        for arch in ZOO:
            say(f"[tokens/s] {gpu} | {arch}: prefill "
                f"{report[arch + '_prefill']['tokens_per_s']:.1f}, serve "
                f"{report[arch + '_serve']['tokens_per_s']:.1f}; peak "
                f"allocated {report[arch + '_peak_gb']:.2f} GB")
        say(f"[time] through phase 11: {time.perf_counter() - started:.1f} s")
    if "12" in phases:
        t0 = time.perf_counter()
        for k, v in phase_data_axis(torch, dev, gpu, report, errs).items():
            launches[k] += v
        say(f"[time] phase 12: {time.perf_counter() - t0:.1f} s; through "
            f"phase 12: {time.perf_counter() - started:.1f} s")
    if "13" in phases:
        t0 = time.perf_counter()
        counts = phase_hybrid(torch, dev, gpu, report, errs)
        say(f"[main path] phase 13 launches (the check run's prefill and "
            f"the two serves of each architecture): {json.dumps(counts)} "
            f"({time.perf_counter() - t0:.1f} s)")
        for k in ("delegation_pack", "grouped_matmul", "flash_attention",
                  "selective_scan"):
            require(counts[k] > 0, f"kernel {k} was not launched on the "
                    f"phase 13 main paths")
        for k, v in counts.items():
            launches[k] += v
        for arch, _ in HYBRID:
            say(f"[tokens/s] {gpu} | {arch}: prefill "
                f"{report[arch + '_prefill']['tokens_per_s']:.1f}, serve "
                f"{report[arch + '_serve']['tokens_per_s']:.1f}; peak "
                f"allocated {report[arch + '_peak_gb']:.2f} GB")
        say(f"[time] through phase 13: {time.perf_counter() - started:.1f} s")
    if "14" in phases:
        t0 = time.perf_counter()
        counts = phase_examples(torch, dev, gpu, report)
        for k, v in counts.items():
            launches[k] += v
        say(f"[time] phase 14: {time.perf_counter() - t0:.1f} s; through "
            f"phase 14: {time.perf_counter() - started:.1f} s")
    if "15" in phases:
        t0 = time.perf_counter()
        counts = phase_compiled(torch, dev, gpu, report)
        say(f"[main path] phase 15 launches (every path eager and "
            f"captured): {json.dumps(counts)}")
        for k in ("delegation_pack", "gather", "scatter_last",
                  "segmented_add", "grouped_matmul", "flash_attention",
                  "selective_scan", "paged_attention", "pagetable_serve"):
            require(counts[k] > 0, f"kernel {k} was not launched on the "
                    f"phase 15 paths")
        for k, v in counts.items():
            launches[k] += v
        say(f"[time] phase 15: {time.perf_counter() - t0:.1f} s; through "
            f"phase 15: {time.perf_counter() - started:.1f} s")
    per_round["launches"] = launches
    say(f"[main path] kernel launches over phases 3-8 and 11-15 (one "
        f"prefill call in phases 6, 7, 8 and each of 11's; 4a, 4b and the "
        f"session serve included): {json.dumps(launches)}")

    qwen, deep, falcon = park(torch, (qwen, deep, falcon), dev)
    if "9" in phases:
        require(phases >= set("2345678"),
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
        for k in ("qwen_prefill", "qwen_serve", "qwen_session_serve",
                  "qwen_session_dedicated_serve", "qwen_session_drain_serve",
                  "qwen_session_chaos_serve",
                  "deepseek_prefill",
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
        say(f"[time] through phase 9: {time.perf_counter() - started:.1f} s")
    if "10" in phases:
        # counters zeroed just before the trainer and read just after: the
        # training path runs the plain versions and launches none
        counts = phase_train(torch, dev, gpu, report)
        say(f"[main path] qwen train launches: {json.dumps(counts)}")
        require(not any(counts.values()), "the training path launched a "
                "kernel: no kernel has a backward")
        say(f"[tokens/s] {gpu} | qwen_train: "
            f"{report['qwen_train']['tokens_per_s']:.1f}")
        say(f"[time] through phase 10: "
            f"{time.perf_counter() - started:.1f} s")
    if "14" in phases:
        mfu_readings(gpu, report)
    if "9" in phases:
        say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
