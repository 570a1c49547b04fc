"""Checks of the training path that ``chip_smoke.py`` and the tests
share: gradients compared leaf by leaf, the experts a MoE dispatch fed,
one AdamW step held to the change its gradient predicts
(``first_adamw_step``, ``descent_check``), and the gradient-combine
battery (``tests/_md_battery.py``'s ``grad_channel_combiner_int8`` case)
on T stacked data shards."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..models import model as M
from ..models import moe as moe_mod
from ..models.layers import dtype_of
from ..optim import AdamWConfig, GradChannelCombiner, adamw_update, init_adamw
from ..optim.optimizer import _blocks, tree_leaves


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


# ``descent_check``: the step is sized so that its first-order change of
# the loss is about -DESCENT_DROP, far above an f32 loss's rounding
# (~1e-6 of ~12) and small enough that the second-order term, which
# grows as the step squared, stays within DESCENT_RTOL of it
DESCENT_DROP, DESCENT_RTOL = 1e-2, 0.1


def constant_lr(run, lr: float) -> AdamWConfig:
    """``run``'s AdamW (weight decay, clip) at a constant ``lr``: no
    warmup, and the cosine is 1 - 5e-8 at step 1."""
    from ..launch.steps import adamw_config
    return dataclasses.replace(adamw_config(run), learning_rate=lr,
                               warmup_steps=0)


@torch.no_grad()
def first_adamw_step(params, grads, batch, cfg, run, lr: float,
                     restore: bool = False) -> Dict:
    """One AdamW step from zero moments at the constant ``lr`` on
    ``grads`` (``params`` updated in place, and put back after it with
    ``restore``).  Each weight moves by about ``lr`` against its
    gradient's sign.  Returns ``loss``, ``forward_loss`` on ``batch``
    after the step, and ``first_order``, sum(g * (p_after - p_before))
    in f64: the change of the loss that the gradient predicts for the
    step."""
    leaves = tree_leaves(params)
    before = [p.detach().clone() for p in leaves]
    adamw_update(constant_lr(run, lr),
                 init_adamw(params, dtype_of(run.opt_dtype)), params, grads)
    first = torch.zeros((), dtype=torch.float64, device=leaves[0].device)
    for p, b, g in zip(leaves, before, tree_leaves(grads)):
        for pb, bb, gb in _blocks(p.detach(), b, g):
            first += torch.sum((pb.double() - bb.double()) * gb.double())
    loss, _ = M.forward_loss(params, batch, cfg, run)
    out = {"loss": float(loss), "first_order": float(first), "lr": lr}
    if restore:
        for p, b in zip(leaves, before):
            p.detach().copy_(b)
    return out


def descent_check(params, batch, cfg, run, drop: float = DESCENT_DROP,
                  rtol: float = DESCENT_RTOL) -> Dict:
    """A step at a size where the loss must fall, on any draw of the
    weights: the gradient g at ``params`` sets lr = drop / ||g||_1, so
    the first AdamW step from zero moments changes the loss by about
    -drop to first order; the loss after it must be lower, and its
    change within ``rtol`` of ``first_adamw_step``'s ``first_order``
    (a wrong sign, a wrong gradient or an update that is not the one
    applied shows as a rise or a change the gradient does not
    predict).  ``params`` are updated in place."""
    from ..launch.steps import value_and_grad
    loss0, _, grads = value_and_grad(params, batch, cfg, run)
    l1 = sum(float(g.double().abs().sum()) for g in tree_leaves(grads))
    r = first_adamw_step(params, grads, batch, cfg, run, drop / l1)
    change = r["loss"] - float(loss0)
    ok = change < 0 and abs(change - r["first_order"]) \
        <= rtol * abs(r["first_order"])
    return dict(r, loss0=float(loss0), change=change, grad_l1=l1, ok=ok)


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
