"""Time the KV serve's response gather lane by lane on one CUDA card, for
one tree of the port or for several side by side.

What it times: the GET lane at kv_paper's serve shape, and the GET, ADD
base and CAS current (with ``expect`` and ``flag``) lanes at kv_mixed's,
on chip_smoke.py's serve data (``main_shapes``, ``serve_case``, seed 31),
by CUDA events with the host ahead of the card (``ahead_ms``, the median
of five readings of 50 calls).  It calls only
``repro_torch.kernels.ops.gather``, whose contract every tree of the port
shares, so another tree's kernel can be weighed against this one's on one
card:

    python3 tools/gather_lanes.py                      # this checkout
    python3 tools/gather_lanes.py --src old/src src old/src src

Each ``--src`` (a tree's ``src`` directory, built from its own sources)
runs in its own process, in the order given; each prints one line.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = {0: "GET", 2: "ADD", 3: "CAS"}


def one(src):
    """Time the tree at ``src``; returns {"kv_paper GET": ms, ...}."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs            # puts this checkout's src on the path
    sys.path.insert(0, os.path.abspath(src))    # ... behind the tree's own
    import torch
    from repro_torch.kernels import ops as kops
    assert os.path.abspath(kops.__file__).startswith(os.path.abspath(src))
    dev = torch.device("cuda")
    shapes = cs.main_shapes(cs.MESH[0] * cs.MESH[1])
    got = {}
    for label, key, lanes in (("kv_paper", "serve_paper", (0,)),
                              ("kv_mixed", "serve_mixed", (0, 2, 3))):
        case = cs.serve_case(torch, dev, **shapes[key], seed=31)
        t, n = case["keys"].shape
        out = torch.zeros((t, n, case["table"].shape[-1]), device=dev)
        flag = torch.zeros((t, n), dtype=torch.int32, device=dev)
        for which in lanes:
            kw = dict(expect=case["expect"], flag=flag) if which == 3 else {}
            call = lambda: kops.gather(case["table"], case["keys"],
                                       case["lane"], which, out, **kw)
            runs = [cs.ahead_ms(torch, call) for _ in range(5)]
            if not all(ahead for _, _, ahead in runs):
                raise RuntimeError("the host did not get ahead of the card")
            got[f"{label} {LANES[which]}"] = statistics.median(
                ms for ms, _, _ in runs)
    return got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", nargs="+", default=[os.path.join(ROOT, "src")],
                    help="the trees' src directories, timed in this order")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[gather_lanes] {smi.splitlines()[0]}; ms a call, CUDA events "
          f"with the host ahead, median of 5 readings of 50 calls")
    for src in args.src:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", src], capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr)
            return res.returncode
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"[gather_lanes] {src}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
