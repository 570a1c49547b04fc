"""End-to-end driver: train a language model with the delegation framework.

The torch counterpart of the JAX package's ``examples/train_lm.py``: a thin
wrapper over ``repro_torch.launch.train.main`` with JAX's presets.  The
default trains a ~10M-parameter qwen2.5-family model for 300 steps with
checkpointing and fault-tolerant resume; ``--preset 100m`` scales it to
~100M parameters.  Checkpoints go under the checkout's ignored
``artifacts/train_lm`` unless ``--ckpt-dir`` says otherwise.

Run:  python -m repro_torch.examples.train_lm [--steps 300] [--preset 100m]
      [--device cpu]   (on the card by default)
"""
from __future__ import annotations

import argparse
import os

from repro_torch.launch.train import main as train_main

CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "..", "artifacts", "train_lm")
PRESETS = {
    "10m": ["--d-model", "192", "--n-layers", "4", "--seq", "128",
            "--batch", "8"],
    "100m": ["--d-model", "512", "--n-layers", "8", "--seq", "256",
             "--batch", "8"],
}


def train_argv(preset: str = "10m", steps: int = 300,
               ckpt_dir: str = CKPT_DIR, inject_failure_at: int = -1,
               device=None):
    """The ``launch.train`` argv of a preset (JAX's flags and values)."""
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--steps", str(steps),
            "--lr", "3e-3", "--ckpt-dir", ckpt_dir, "--ckpt-every", "50",
            "--log-every", "20", "--inject-failure-at",
            str(inject_failure_at)] + PRESETS[preset]
    if device is not None:
        argv += ["--device", device]
    return argv


def main(argv=None, stats=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain paths")
    args = ap.parse_args(argv)
    return train_main(train_argv(args.preset, args.steps, args.ckpt_dir,
                                 args.inject_failure_at, args.device),
                      stats=stats)


if __name__ == "__main__":
    main()
