"""Checks of the training path that ``chip_smoke.py`` and the tests
share: gradients compared leaf by leaf, the experts a MoE dispatch fed,
and the gradient-combine battery (``tests/_md_battery.py``'s
``grad_channel_combiner_int8`` case) on T stacked data shards."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..models import moe as moe_mod
from ..optim import AdamWConfig, GradChannelCombiner
from ..optim.optimizer import tree_leaves


def rel_rms(got, want) -> float:
    """RMS of (got - want) over the RMS of want (0 when both are 0)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    den = np.sqrt(np.mean(want * want))
    num = np.sqrt(np.mean((got - want) ** 2))
    return float(num / den) if den > 0 else float(num)


def worst_leaf(got_tree, want_leaves) -> tuple:
    """(the largest ``rel_rms`` over the leaves in JAX's tree order, its
    leaf index) of a tree of tensors against a list of arrays or tensors;
    computed in f64 on the device of ``got_tree``'s leaves."""
    got = tree_leaves(got_tree)
    if len(got) != len(want_leaves):
        raise ValueError(f"{len(got)} leaves against {len(want_leaves)}")
    errs = []
    for g, w in zip(got, want_leaves):
        g = g.detach().double()
        w = torch.as_tensor(w).to(g.device, torch.float64)
        den = torch.sqrt(torch.mean(w * w))
        num = torch.sqrt(torch.mean((g - w) ** 2))
        errs.append(float(num / den) if den > 0 else float(num))
    i = int(np.argmax(errs))
    return errs[i], i


class ExpertRows:
    """Inside the context, each trustee-side expert FFN call of the MoE
    keeps its per-expert filled slots ``counts`` (T * E/T,) on the host,
    in call order: the first calls of a forward are its MoE layers in
    order (a rematerialised backward adds its own after them)."""

    def __init__(self):
        self.counts: List[np.ndarray] = []

    def __enter__(self):
        self._ffn = moe_mod._expert_ffn
        moe_mod._expert_ffn = self._call
        return self

    def __exit__(self, *exc):
        moe_mod._expert_ffn = self._ffn

    def _call(self, x_e, weights, act, use_kernel, counts):
        self.counts.append(counts.detach().cpu().numpy().copy())
        return self._ffn(x_e, weights, act, use_kernel, counts)


def expert_grads_follow_rows(grad_w: torch.Tensor,
                             counts: List[np.ndarray]) -> Dict:
    """An expert leaf's gradient (n_groups, E, ...) against the rows each
    group's experts received: every expert that received a row has a
    non-zero gradient and every other a zero one."""
    g = grad_w.detach().float().abs().flatten(2).amax(-1).cpu().numpy()
    fed = np.stack(counts[:g.shape[0]]) > 0
    return {"experts_fed": int(fed.sum()),
            "fed_without_grad": int((fed & (g == 0)).sum()),
            "grad_without_rows": int((~fed & (g > 0)).sum())}


COMBINER = dict(shards=8, chunk=64, steps=60, lr=0.05, n=128, d=64, k=32)


def combiner_battery(device, steps: int = COMBINER["steps"],
                     record: list = None) -> Dict:
    """The battery's compressed combine: least squares toward a N(0, 1)
    target (64 x 32) from 8 clients' own 128 rows (numpy seed 0, f32),
    every client's gradient taken at the table's current parameters (in
    f64, rounded to f32), int8 over
    the channel with error feedback, AdamW (lr 0.05, no decay) at the
    owners.  Returns the final table (numpy), ``err_final`` (the mean
    absolute distance of the parameters to the target) and the
    combiner's last error carry.  ``record``, when given, receives each
    step's inputs (opt, err, gradients) and outputs (opt, err) on the
    host, for a replay of the steps elsewhere (``combiner_replay``)."""
    c = COMBINER
    rng = np.random.default_rng(0)
    target = torch.as_tensor(rng.normal(size=(c["d"], c["k"])),
                             dtype=torch.float32, device=device)
    xs = torch.as_tensor(rng.normal(size=(c["shards"], c["n"], c["d"])),
                         dtype=torch.float32, device=device)
    comb = GradChannelCombiner(c["shards"], AdamWConfig(
        learning_rate=c["lr"], weight_decay=0.0), chunk=c["chunk"])
    opt, err = comb.init({"w": torch.zeros((c["d"], c["k"]),
                                           device=device)})
    update = comb.step_fn()
    n_flat = comb._rows * comb.chunk
    xs64, target64 = xs.double(), target.double()
    for _ in range(steps):
        # each client's own gradient, in f64 and rounded once, so the CPU
        # and the card (whose matmuls sum in other orders) feed the
        # combiner the same f32 rows
        w = comb.params_of(opt)["w"].double()
        res = xs64 @ w - xs64 @ target64
        g = (xs64.transpose(1, 2) @ res / c["n"]).float()
        flat = torch.zeros((c["shards"], n_flat), device=device)
        flat[:, :g[0].numel()] = g.reshape(c["shards"], -1)
        grads = comb.owner_major(flat).reshape(c["shards"], n_flat)
        if record is not None:
            host = lambda tree: {k: v.cpu() for k, v in tree.items()}
            record.append({"opt": host(opt), "err": err.cpu(),
                           "grads": grads.cpu()})
        opt, err = update(opt, err, grads)
        if record is not None:
            record[-1].update(opt_out=host(opt), err_out=err.cpu())
    w = comb.params_of(opt)["w"]
    return {"table": opt["p"].cpu().numpy(), "err": err.cpu().numpy(),
            "err_final": float((w - target).abs().mean())}


def combiner_replay(device, record: list) -> float:
    """Every recorded step of ``combiner_battery`` run again on
    ``device`` from its recorded inputs: the largest difference of the
    outputs (p, m, v and the carries) from the recorded ones, relative to
    each tensor's largest magnitude."""
    c = COMBINER
    comb = GradChannelCombiner(c["shards"], AdamWConfig(
        learning_rate=c["lr"], weight_decay=0.0), chunk=c["chunk"])
    comb.init({"w": torch.zeros((c["d"], c["k"]))}, device=device)
    update = comb.step_fn()
    worst = 0.0
    for r in record:
        opt, err = update({k: v.to(device) for k, v in r["opt"].items()},
                          r["err"].to(device), r["grads"].to(device))
        for got, want in [(opt[k], r["opt_out"][k]) for k in ("p", "m", "v")
                          ] + [(err, r["err_out"])]:
            scale = float(want.abs().max()) or 1.0
            worst = max(worst, float((got.cpu() - want).abs().max())
                        / scale)
    return worst
