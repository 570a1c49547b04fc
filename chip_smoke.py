#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # every phase, one card

Phases (any failure raises and exits non-zero; nothing is caught):

  1. device and build — the card's name and power limit, then the four
     CUDA kernels built from csrc/ with nvcc (in parallel);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at adversarial ones (a hot segment spanning
     many scan blocks, all-distinct keys, ragged row counts, capacity 1,
     int32 words above 2^24), exact on integer-exact payloads;
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
  5. times — each kernel with CUDA events at the main path's shapes,
     beside its bound (bytes over 3.35 TB/s), its plain version and a
     library call where one PyTorch call computes the same function; and
     each phase's ops/s on a host clock.

Launch counters are zeroed just before phases 3-4 (the main path) and
read just after; every kernel must have launched there.  The line before
the last is {"kernels": [...]}; the last is the device line.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
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
}


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
        flag = (case["lane"] == 1).to(torch.int32)
        kops.scatter_last(table, case["keys"], case["order"], case["sid"],
                          flag, case["value"], impl=impl)
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
        ("hot segment over 32 scan blocks",
         dict(t=8, n=8192, k=4096, w=4, mix=(0.0, 0.0, 1.0, 0.0), seed=13,
              hot=0.98, inactive=0.0), False, True),
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
                tol = f"max abs err {err:.3g} <= 2e-3"
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
# phase 5: times
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=50, warmup=5):
    """CUDA-event time per call over back-to-back calls: the card's time
    when the host issues faster than the card runs, else the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fn, iters=20):
    """Device time per call: the sum of the CUDA kernels, memsets and
    copies the call puts on the card, from torch.profiler (CUPTI).  0.0
    when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3


def kernel_ms(torch, fn, iters=20):
    """(ms, how): device time per call from the profiler, or — where the
    profiler saw no device activity — the CUDA-event time."""
    ms = device_ms(torch, fn, iters)
    if ms > 0:
        return ms, "profiler device time"
    return time_ms(torch, fn, iters), "CUDA events"


def pack_bytes(args):
    """dst and the payload words in; both slot blocks, request_slot and
    the counts, counts2 and totals out — all 32-bit."""
    dst, words, t, c, c2 = args
    d, r, w = words.shape
    return 4 * (dst.numel() + words.numel() + d * t * (c + c2) * w
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
    if name == "scatter_last":   # order, sid, flag; a row in, a line out
        heads = int(((sid == pos) & (lane_s == 1)).sum())
        return 3 * idx + 2 * 4 * heads * w + 4 * heads
    adds = int((lane_s == 2).sum())
    segs = int(((sid == pos) & (lane_s == 2)).sum())
    # order, sid, seg_end, lane; deltas in; responses in and out; a table
    # line in and out per segment
    return 4 * idx + 3 * 4 * adds * w + 2 * 4 * segs * w


def busy_share(torch, run_round, rounds):
    """Device busy share of whole rounds: device time (profiler) over the
    host wall time of ``rounds`` rounds ending in a synchronize."""
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
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
    return busy, wall


def phase_times(torch, dev, shapes, errs, per_round, gpu):
    """Each kernel's time at the main path's shapes beside its bound, its
    plain version and a library yardstick; the busy share of a round."""
    from repro_torch.kernels import ops as kops
    measured = {}

    def emit(name, label, fn_kernel, fn_plain, fn_lib, nbytes):
        ms, how = kernel_ms(torch, fn_kernel)
        plain, _ = kernel_ms(torch, fn_plain, iters=5)
        lib = kernel_ms(torch, fn_lib)[0] if fn_lib is not None else None
        ev = time_ms(torch, fn_kernel)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        say(f"[times] {gpu} | {name} @ {label}: {ms:.6f} ms/call "
            f"({how}; {ev:.6f} ms/call by CUDA events over back-to-back "
            f"calls), plain {plain:.6f} ms, bound {bound:.6f} ms "
            f"({nbytes} bytes), library "
            f"{'n/a' if lib is None else f'{lib:.6f} ms'}, "
            f"{per_round[label][name]:.3f} calls/round on the main path")
        measured[(name, label)] = (ms, plain, bound, lib)

    for label, key in (("kv_paper", "pack_paper"), ("kv_mixed", "pack_mixed")):
        args = pack_case(torch, dev, **shapes[key], seed=21, hot=0.07)
        emit("delegation_pack", label,
             lambda: kops.delegation_pack(*args),
             lambda: kops.delegation_pack(*args, impl="ref"), None,
             pack_bytes(args))

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
                table, case["keys"], case["order"], case["sid"], flag_put,
                case["value"], impl=impl),
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
        for name, call in calls.items():
            emit(name, label, lambda: call("kernel"), lambda: call("ref"),
                 library[name], serve_bytes(torch, name, case))

    rows = []
    for name in SOURCES:
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5",
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
    say(f"[build] nvcc (sm_90a, 4 sources in parallel): {built:.2f} s "
        f"compiling, {time.perf_counter() - t0:.2f} s in all")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    n_dev = MESH[0] * MESH[1]
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

    errs = phase_kernels(torch, dev, shapes) if 2 in phases else None

    # the main path: counters zeroed just before, read just after; the
    # kernel-path rounds are kv_paper (a) and (b), 40 each (the (a) ref
    # path launches none), and kv_mixed, 8 with the shortcut, 8 without
    kops.reset_launch_counts()
    per_round = {"kv_paper": {}, "kv_mixed": {}}
    if 3 in phases:
        phase_paper(torch, dev, report)
        per_round["kv_paper"] = {k: v / 80 for k, v
                                 in kops.launch_counts().items()}
        say(f"[main path] kv_paper launches over 80 kernel-path rounds: "
            f"{json.dumps(kops.launch_counts())}")
    paper_counts = kops.launch_counts()
    if 4 in phases:
        phase_mixed(torch, dev, report)
        mixed_counts = {k: v - paper_counts[k]
                        for k, v in kops.launch_counts().items()}
        per_round["kv_mixed"] = {k: v / 16 for k, v in mixed_counts.items()}
        say(f"[main path] kv_mixed launches over 16 rounds: "
            f"{json.dumps(mixed_counts)}")
    per_round["launches"] = kops.launch_counts()
    say(f"[main path] kernel launches over phases 3-4: "
        f"{json.dumps(per_round['launches'])}")
    if 3 in phases and 4 in phases:
        for k, v in per_round["launches"].items():
            require(v > 0, f"kernel {k} was not launched on the main path")
    for k, v in report.items():
        say(f"[ops/s] {gpu} | {k}: {v:.1f}")

    if 5 in phases:
        require(phases >= {2, 3, 4},
                "phase 5 reports the main path's launches and the kernels' "
                "errors against their plain versions: run phases 2-4")
        rows = phase_times(torch, dev, shapes, errs, per_round, gpu)
        phase_busy(torch, dev, gpu)
        say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
