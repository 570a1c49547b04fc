"""Count the PyTorch ops the host issues for one kv_mux round: the fused
``session.step()`` of chip_smoke.py's phase 4a against the same batches
flushed one trust at a time.

What it counts: the top-level ``aten::`` ops (an op called by no other
aten op) that ``torch.profiler`` records around one round of each
layout, the submissions of the batches included, and the fused step's
ops alone by name.  An eager round issues each of these ops from the
host, so their number is what a host-bound round pays whatever the card
does.  The counts do not depend on the device; the round's shapes are
chip_smoke.py's, cut to ``--keys`` keys and ``--rows`` rows a batch:

    python3 tools/round_ops.py                    # the CPU, small tables
    python3 tools/round_ops.py --device cuda --keys 1000000 --rows 8192

Prints one JSON line.
"""
import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top_level(events, within=None):
    out = []
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        parent = e.cpu_parent
        if parent is not None and parent.name.startswith("aten::"):
            continue
        if within is not None and not (
                e.time_range.start >= within.time_range.start
                and e.time_range.end <= within.time_range.end):
            continue
        out.append(e)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--keys", type=int, default=4096)
    ap.add_argument("--rows", type=int, default=512)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs            # puts this checkout's src on the path
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import TrustSession
    cs.N_KEYS, cs.MUX_ROWS = args.keys, args.rows
    dev = torch.device(args.device)
    res = {"device": args.device, "keys": args.keys, "rows": args.rows}
    for layout in ("strided", "masked"):
        init, trace = cs.mux_traces(layout, rounds=2)
        for fused in (True, False):
            sess = TrustSession()
            stores = cs.mux_pair(dev, layout, "kernel", sess, init)

            def one_round(batches):
                for st, b in zip(stores, batches):
                    cs.submit_batches(torch, dev, st, b)
                with torch.profiler.record_function("round"):
                    if fused:
                        sess.step()
                    else:
                        for st in stores:
                            st.flush()
            one_round(trace[0])          # first calls build the kernels
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                one_round(trace[1])
            events = list(prof.events())
            rnd = next(e for e in events if e.name == "round")
            label = f"{layout}_{'fused' if fused else 'solo'}"
            res[label] = len(top_level(events))
            inside = top_level(events, rnd)
            res[f"{label}_round"] = len(inside)
            if fused:
                res[f"{label}_round_by_op"] = dict(collections.Counter(
                    e.name for e in inside).most_common(10))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
