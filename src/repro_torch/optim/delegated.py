"""Channel-based compressed gradient combining (the torch counterpart of
``repro.optim.delegated``'s ``GradChannelCombiner``), over T data shards
stacked on one device.

The flattened parameters are cut into rows of ``chunk`` values, and row r
is entrusted to owner ``r % T``.  Every step, each client quantizes its
gradient rows plus its carried error to int8 (a per-row f32 scale), ships
them over the delegation channel to their owners — the all_to_all is a
block transpose of the stacked (client, owner) blocks — and each owner
dequantizes and sums the rows it received, then applies AdamW to its own
block, summing the clients' rows in client order (so a step gives the
same table on the CPU and on the card).  Error feedback keeps the
quantization unbiased over time.  The wire rows are validated against ``combine_op_spec`` before they move, as
the typed Trust handles check a submit.

The table is held stacked, ``(T, rows / T, chunk)``: owner k's block is
row ``k`` of the stacked dimension, which is JAX's owner-major table
``(rows, chunk)`` sharded over the data axis.  ``params_of`` unpermutes
it back into the parameter tree.

JAX's ``fsdp_specs`` / ``opt_state_specs`` have no counterpart: they are
GSPMD layouts of the parameters and AdamW moments over a data axis of
several chips, and the port's one card has none (ROADMAP, settled
divergences).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..core.opspec import Field, OpSpec
from .optimizer import AdamWConfig, tree_leaves, tree_unflatten

Pytree = Any


def combine_op_spec(chunk: int) -> OpSpec:
    """The delegated gradient-combine op: a request row carries ``q`` (the
    int8 chunk) and ``scale`` (f32); the response row is ``p`` (the
    updated f32 chunk)."""
    return OpSpec(
        "grad_combine",
        payload=(Field("q", (chunk,), torch.int8),
                 Field("scale", (1,), torch.float32)),
        response=(Field("p", (chunk,), torch.float32),),
        writes=("p",))


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: x (..., W) f32 -> (q int8,
    scale (..., 1) f32)."""
    # a divisor on the device: CUDA turns a Python divisor into a multiply
    # by its reciprocal, one rounding more than the CPU's (and XLA's)
    # true division
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True)
                        / torch.full((), 127.0, device=x.device), min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _client_sum(rows_in: torch.Tensor) -> torch.Tensor:
    """Each owner's received rows (owner, client, ...) summed in client
    order, one elementwise add at a time: a reduction kernel's order
    differs between the CPU and the card, and late in training the
    clients' gradients cancel, so its last bits would move the update."""
    total = rows_in[:, 0]
    for c in range(1, rows_in.shape[1]):
        total = total + rows_in[:, c]
    return total


@dataclass
class GradChannelCombiner:
    """Delegated gradient combine + owner-side AdamW over ``n_shards`` = T
    stacked data shards.  ``cfg.learning_rate`` is applied as it is (no
    schedule, no clipping), as in JAX."""
    n_shards: int
    cfg: AdamWConfig
    chunk: int = 1024
    compress: str = "int8"     # "int8" | "none"

    def init(self, params: Pytree, device=None
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(opt, err): opt {"p", "m", "v"} (T, rows / T, chunk) f32 and
        "step" () int32; err (T, rows, chunk) f32, each client's carried
        quantization error."""
        if self.compress not in ("int8", "none"):
            raise ValueError(f"unknown compress {self.compress!r} (want "
                             f"'int8' or 'none')")
        self.spec = combine_op_spec(self.chunk)
        leaves = tree_leaves(params)
        dev = device if device is not None else leaves[0].device
        self._like = params
        self._offsets, n = [], 0
        for leaf in leaves:
            self._offsets.append((n, n + leaf.numel()))
            n += leaf.numel()
        t = self.n_shards
        rows = -(-n // self.chunk)
        rows = -(-rows // t) * t          # a multiple of the owners
        self._n, self._rows, self._t = n, rows, t
        flat = torch.zeros(rows * self.chunk, dtype=torch.float32,
                           device=dev)
        flat[:n] = torch.cat([leaf.detach().reshape(-1).float().to(dev)
                              for leaf in leaves])
        p = self.owner_major(flat)
        opt = {"p": p, "m": torch.zeros_like(p), "v": torch.zeros_like(p),
               "step": torch.zeros((), dtype=torch.int32, device=dev)}
        return opt, torch.zeros((t, rows, self.chunk), dtype=torch.float32,
                                device=dev)

    def owner_major(self, flat: torch.Tensor) -> torch.Tensor:
        """A flat (rows * chunk,) vector (or (..., rows * chunk)) -> owner
        blocks (..., T, rows / T, chunk): row r lands in owner r % T's
        block at ``r // T``."""
        t, rows = self._t, self._rows
        lead = tuple(flat.shape[:-1])
        return flat.reshape(lead + (rows // t, t, self.chunk)) \
            .transpose(-3, -2).contiguous()

    def params_of(self, opt) -> Pytree:
        """The parameter tree of the table (the owner-major layout
        unpermuted, the padding dropped, each leaf in its dtype)."""
        flat = opt["p"].transpose(0, 1).reshape(-1)
        return tree_unflatten(self._like, [
            flat[lo:hi].reshape(leaf.shape).to(leaf.dtype)
            for (lo, hi), leaf in zip(self._offsets,
                                      tree_leaves(self._like))])

    def step_fn(self) -> Callable:
        """update(opt, err, grads) -> (opt, err): ``grads`` (T, rows *
        chunk) is every client's own (unreduced) gradient in owner-major
        order (``owner_major`` of the flat gradient, flattened)."""
        cfg, chunk, t, rows = self.cfg, self.chunk, self._t, self._rows
        compress = self.compress
        spec = getattr(self, "spec", None) or combine_op_spec(chunk)
        q_field, scale_field = spec.payload

        def update(opt, err, grads):
            if tuple(grads.shape) != (t, rows * chunk):
                raise ValueError(
                    f"op {spec.name!r}: expected ({t}, {rows * chunk}) "
                    f"owner-major flat gradients, one a client, got "
                    f"{list(grads.shape)}")
            g = grads.reshape(t, rows, chunk)
            if compress == "int8":
                target = g + err
                q, scale = int8_quantize(target)
                # the wire rows against the declared OpSpec: a dtype-kind
                # or row-shape drift raises before the transpose
                q = q_field.bind(q.reshape(t * rows, chunk), spec.name)
                scale = scale_field.bind(scale.reshape(t * rows, 1),
                                         spec.name)
                q, scale = q.reshape(t, rows, chunk), scale.reshape(t, rows,
                                                                    1)
                new_err = target - int8_dequantize(q, scale)
                # the all_to_all: client c's block for owner k moves to
                # owner k's slot c
                qs = q.reshape(t, t, rows // t, chunk).transpose(0, 1)
                ss = scale.reshape(t, t, rows // t, 1).transpose(0, 1)
                rows_in = int8_dequantize(qs, ss)     # (owner, client, ...)
            else:
                new_err = err
                rows_in = g.reshape(t, t, rows // t, chunk).transpose(0, 1)
            g_sum = _client_sum(rows_in) / t
            # owner-local AdamW on its block
            step = opt["step"] + 1
            lr, b1, b2 = cfg.learning_rate, cfg.b1, cfg.b2
            m = b1 * opt["m"] + (1 - b1) * g_sum
            v = b2 * opt["v"] + (1 - b2) * g_sum * g_sum
            # b ** step and the square root in f64, rounded once: the
            # correctly rounded f32 on every device (the card's f32 sqrt
            # is off by an ulp on ~0.7% of inputs)
            bc1 = 1 - (b1 ** step.double()).float()
            bc2 = 1 - (b2 ** step.double()).float()
            root = torch.sqrt((v / bc2).double()).float()
            delta = (m / bc1) / (root + cfg.eps) \
                + cfg.weight_decay * opt["p"]
            p = opt["p"] - lr * delta
            return {"p": p, "m": m, "v": v, "step": step}, new_err

        return update


__all__ = ["GradChannelCombiner", "combine_op_spec", "int8_quantize",
           "int8_dequantize"]
