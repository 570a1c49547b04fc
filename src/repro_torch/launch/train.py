"""Training driver (the torch counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1 \\
        [--device cpu]

Builds the requested arch (full or smoke config) with random weights
drawn on the device, the train cell (``launch.steps.build_cell``: value
and grad of ``forward_loss`` through the plain versions, then AdamW, one
captured program: a CUDA graph on the card from the second step on;
``core.compiled.disable()`` runs it eagerly), the
deterministic token pipeline, and with ``--ckpt-dir`` the fault-tolerant
``TrainLoop`` (a checkpoint every ``--ckpt-every`` steps, resume on
restart, ``--inject-failure-at`` a simulated failure).  ``--mesh-model
T`` is the number of trustee shards stacked on the card: a MoE model's
experts and the cross-entropy's vocab shards.  ``--mesh-data N`` adds
JAX's data axis: the cell runs on the (N, T) mesh, the batch split over
the N data rows when N divides it (each row's sequences delegating to
its own T expert trustees, their capacities sized per row), with
``zero_sharding=N > 1`` carried as JAX carries it (a layout with no
counterpart on one card).  ``--remat`` sets ``RunConfig.remat`` (JAX's
trainer fixes it at "none", the default here).  Runs on ``cuda`` unless
given ``--device cpu``.  An embeds-input
or encoder-decoder model trains on the pipeline's stub-frontend batches
(``TokenPipeline.model_batch_at``), their embeddings moved to the card in
``run.activation_dtype``, the dtype JAX's ``input_specs`` declares for
them.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data rows of the mesh: the batch split over "
                         "them, stacked on the card")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="trustee shards stacked on the card: the MoE's "
                         "experts and the cross-entropy's vocab")
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M preset)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap


def main(argv=None, stats: Optional[dict] = None):
    """Train; returns the history [(step, loss)], a replayed step
    appearing again after a restart, as JAX's does.  ``stats``, when
    given, receives ``n_params``, ``step_s`` and ``metrics`` (each step's
    host seconds, ending in the metrics' read back, and its metrics), the
    final ``state`` (params, opt_state), the ``plan`` and the
    ``pipeline``."""
    args = _parser().parse_args(argv)
    from ..core import meshctx
    with meshctx.kept_context():
        return _train(args, stats)


def _train(args, stats: Optional[dict]):
    from ..configs.base import MeshConfig, RunConfig, ShapeConfig
    from ..configs.registry import get_arch, get_smoke_arch
    from ..core.meshctx import resolve_device
    from ..data import DataConfig, TokenPipeline
    from ..models import model as M
    from ..models.layers import dtype_of
    from ..optim import init_adamw
    from ..runtime import FailureInjector, TrainLoop, TrainLoopConfig
    from .mesh import make_local_mesh
    from .steps import build_cell

    dev = resolve_device(args.device)
    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    if args.d_model:
        cfg = cfg.with_overrides(d_model=args.d_model)
    if args.n_layers:
        cfg = cfg.with_overrides(n_layers=args.n_layers)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    mcfg = MeshConfig((args.mesh_data, args.mesh_model), ("data", "model"))
    run = RunConfig(model=cfg, shape=shape, mesh=mcfg,
                    learning_rate=args.lr, remat=args.remat,
                    zero_sharding=args.mesh_data > 1)
    plan = build_cell(cfg, shape, run,
                      make_local_mesh(args.mesh_data, args.mesh_model, dev))
    params = M.init_params(cfg, run, dev)
    opt_state = init_adamw(params, dtype_of(run.opt_dtype))
    n_params = M.count_params(params)
    print(f"[train] {cfg.name}: {n_params/1e6:.2f}M params, "
          f"mesh {mcfg.shape}, batch {args.batch} x seq {args.seq}, "
          f"remat {args.remat}, {dev}", flush=True)

    pipe = TokenPipeline(DataConfig(seed=run.seed, kind=args.data,
                                    path=args.data_path,
                                    vocab_size=cfg.vocab_size),
                         cfg, shape)
    step_s, step_metrics = [], []

    adt = dtype_of(run.activation_dtype)

    def step_fn(state, step):
        params, opt_state = state
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 pipe.model_batch_at(step).items()}
        batch = {k: v.to(adt) if v.is_floating_point() else v
                 for k, v in batch.items()}
        params, opt_state, metrics = plan.step_fn(params, opt_state, batch)
        return (params, opt_state), {k: float(v) for k, v in
                                     metrics.items()}

    history = []

    def on_metrics(step, metrics, dt, straggler):
        history.append((step, metrics["loss"]))
        step_s.append(dt)
        step_metrics.append(metrics)
        if step % args.log_every == 0:
            print(f"  step {step:5d} loss {metrics['loss']:.4f} "
                  f"acc {metrics['accuracy']:.3f} "
                  f"gnorm {metrics['grad_norm']:.2f} {dt*1e3:.0f} ms"
                  + (" [straggler]" if straggler else ""), flush=True)

    state = (params, opt_state)
    if args.ckpt_dir:
        injector = FailureInjector((args.inject_failure_at,)) \
            if args.inject_failure_at >= 0 else None
        loop = TrainLoop(TrainLoopConfig(args.ckpt_dir, args.ckpt_every),
                         step_fn, state, injector=injector,
                         on_metrics=on_metrics)
        summary = loop.run(args.steps)
        state = loop.state
        print(f"[train] done at step {summary['final_step']}, "
              f"restarts={summary['restarts']}", flush=True)
    else:
        for step in range(args.steps):
            t0 = time.monotonic()
            state, metrics = step_fn(state, step)
            on_metrics(step, metrics, time.monotonic() - t0, False)
        print("[train] done", flush=True)
    if history:
        first = np.mean([l for _, l in history[:5]])
        last = np.mean([l for _, l in history[-5:]])
        print(f"[train] loss {first:.4f} -> {last:.4f}", flush=True)
    if stats is not None:
        stats.update(n_params=n_params, step_s=step_s,
                     metrics=step_metrics, state=state, plan=plan,
                     pipeline=pipe)
    return history


if __name__ == "__main__":
    main()
