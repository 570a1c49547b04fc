"""Mixture-of-Experts through the Trust<T> delegation channel (the torch
counterpart of ``repro.models.moe``).

The routed experts are entrusted to the T trustees of the model axis,
stacked on one device: trustee t holds experts ``t * E/T .. (t+1) * E/T
- 1``, which is the JAX ``P("model")`` split of ``w_gate`` / ``w_up`` /
``w_down``.  Each (token, chosen expert) pair is a delegation request on
``core.channel`` — the same channel that carries the KV store — whose
payload is the token's hidden row and the expert's local index; the
channel capacity is the MoE capacity factor and its second_round block the
overflow round.  The trustee's serve packs the rows it received by local
expert and runs the gated expert FFN over all E experts at once as three
grouped matmuls.  Responses return to the requesting client, which
combines them with its router weights.

Under ``run.use_pallas`` (the serve) both packs are the pack kernel
(``ops.delegation_pack``, on the rows' 32-bit words) and the grouped
matmuls the grouped-matmul kernel; otherwise every step is plain PyTorch
on the rows themselves — the channel's "ref" pack, as JAX's MoE always
packs, the block transpose, the trustees' pack by expert
(``ref.delegation_pack``), the expert FFN and the unpack — so the
dispatch carries gradients to the experts' inputs and the router's
weights (the kernels are called through ``ctypes`` and refuse inputs that
require grad).

Clients: with S a multiple of T, client shard j owns the sequence slice
``[j S/T, (j+1) S/T)`` of every row (seq mode, the prefill); otherwise
(decode, S = 1) every client sees all tokens and token i belongs to client
``i % T``, the per-client results summed over the stacked dimension (the
JAX ``psum``).  The capacities (``cap``, ``over_cap``, ``cap2``) are
JAX's, to the row, so the same rows are dropped.  With ``overflow=
"defer"`` the round is ONE ``delegate``, as in JAX: the rows past the
capacity are deferred, get no second block, and count as dropped.

The data axis (``layers.dp_size``: ``run.mesh``'s size over the batch
axes, ``launch.steps.build_cell``'s rule): each of the n_dp data rows
takes its own ``b_loc = B / n_dp`` sequences and delegates them to the T
model-axis trustees, so the round runs over n_dp * T stacked client
shards, replica-major (the channel transposes within each data row),
and every capacity comes from ``b_loc``: a (2, 4) run drops other rows
than a (1, 4) run of the same batch.  The trustees of every data row
hold the same experts; their received slots meet in one grouped matmul
per projection, each expert's slots of the n_dp rows side by side.  With
the batch axes ``()`` (a batch that does not split over the data size)
the batch is replicated and every data row computes the (1, T) round.

Routing is f32: softmax, top-k (ties to the lower expert index, as
``lax.top_k``: a stable descending sort), renormalisation, and the
switch-style load-balance loss.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..core import channel as ch
from ..kernels import ops as kops
from ..kernels import ref as kref
from .layers import _normal_stacked, dp_size, init_mlp, mlp


def _round8(x: int) -> int:
    return max(8, ((x + 7) // 8) * 8)


def init_moe(cfg: ModelConfig, dtype, device, gen: torch.Generator,
             lead: tuple = ()) -> Dict[str, torch.Tensor]:
    """Random router (f32) and expert weights ``w_gate`` / ``w_up``
    (E, D, F), ``w_down`` (E, F, D), plus the shared experts' MLP, drawn
    from ``gen`` (not JAX's numbers; tests carry JAX weights through
    ``convert``).  ``lead`` prefixes a stacked layer dimension; every
    leaf is drawn one layer at a time."""
    m = cfg.moe
    e, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
    s_in, s_ff = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": _normal_stacked(gen, lead, (d, e), s_in, torch.float32,
                                   device),
         "w_gate": _normal_stacked(gen, lead, (e, d, f), s_in, dtype,
                                   device),
         "w_up": _normal_stacked(gen, lead, (e, d, f), s_in, dtype, device),
         "w_down": _normal_stacked(gen, lead, (e, f, d), s_ff, dtype,
                                   device)}
    if m.num_shared > 0:
        p["shared"] = init_mlp(gen, d, m.num_shared * f, dtype, device,
                               lead=lead)
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last dimension,
    largest first, a tie going to the lower index (``lax.top_k``'s rule;
    ``torch.topk`` promises no order on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn(x_e, weights, act: str, use_kernel: bool, counts):
    """(E, C, D) slots -> (E, C, D): ``ref.moe_ffn``'s gated FFN, its
    three grouped matmuls the kernel's under ``use_kernel``; ``counts``
    (E,) int32, each expert's filled slots (the rest are zero)."""
    gmm = kops.grouped_matmul if use_kernel else kref.grouped_matmul
    return kref.moe_ffn(x_e, weights["w_gate"], weights["w_up"],
                        weights["w_down"], act, gmm=gmm, counts=counts)


def _expert_serve(weights, e_local: int, cap2: int, act: str,
                  use_kernel: bool, n_dp: int = 1):
    """Trustee side, every trustee of every data row at once: pack the
    received rows by local expert into ``cap2`` slots each (a
    second-level slot pack; rows past it answer zeros) and run the expert
    FFN over the E = T * e_local experts, each expert's slots of the
    ``n_dp`` data rows side by side (E, n_dp * cap2, D), the pack's
    per-expert counts telling the grouped matmul which slots are filled
    (they stay on the device)."""

    def serve(state, received: ch.Received):
        h = received.rows["h"]                           # (n_dp * T, N, D)
        n_sh, n, d = h.shape
        e = (n_sh // n_dp) * e_local
        el = torch.where(received.valid, received.rows["el"],
                         torch.full_like(received.rows["el"], -1))
        if use_kernel:
            # the rows ride as 32-bit words, bit for bit (d_model is even)
            words = h.contiguous().view(torch.int32)
            slots, _, counts, _, req_slot, _ = kops.delegation_pack(
                el.to(torch.int32).contiguous(), words, e_local, cap2, 0)
            slots = slots.view(h.dtype)
        else:
            slots, counts, req_slot = kref.delegation_pack(el, h, e_local,
                                                           cap2)
        x_e = slots.reshape(n_dp, e, cap2, d).transpose(0, 1) \
            .reshape(e, n_dp * cap2, d)
        # an expert's filled rows end in its last data row's filled slots
        base = torch.arange(n_dp, dtype=counts.dtype,
                            device=counts.device)[:, None] * cap2
        counts = counts.reshape(n_dp, e)
        counts = torch.where(counts > 0, base + counts,
                             torch.zeros_like(counts)).amax(0)
        y_e = _expert_ffn(x_e, weights, act, use_kernel, counts)
        flat = y_e.reshape(e, n_dp, cap2, d).transpose(0, 1) \
            .reshape(n_sh, e_local * cap2, d)
        y = kref.take_rows(flat, torch.clamp(req_slot, min=0))
        y = torch.where((req_slot >= 0)[..., None], y, torch.zeros_like(y))
        return state, {"y": y}

    return serve


def moe_block(params, x: torch.Tensor, cfg: ModelConfig, run=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D), aux metrics: ``moe_aux_loss``,
    ``moe_dropped_frac``, ``moe_max_load``)."""
    m = cfg.moe
    t = run.mesh.model_size if run is not None else 1
    e, k = m.num_experts, m.top_k
    if e % t:
        raise ValueError(f"{t} trustees do not split {e} experts")
    if m.overflow not in ("drop", "second_round", "defer"):
        raise ValueError(f"unknown MoE overflow {m.overflow!r}")
    e_local = e // t
    b, s, d = x.shape
    n_dp = dp_size(run)
    if b % n_dp:
        raise ValueError(
            f"batch {b} does not split over the {n_dp} data rows; give "
            f"the batch axes () (meshctx.set_batch_axes) to replicate it")
    b_loc = b // n_dp
    n_sh = n_dp * t                  # client shards, replica-major

    # ---- routing (f32) ----------------------------------------------------
    probs = torch.softmax(torch.matmul(x.float(), params["router"].float()),
                          dim=-1)
    top_w, top_e = top_k(probs, k)                      # (B, S, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    ohot = torch.nn.functional.one_hot(top_e, e).float().sum(2)
    f_e = ohot.mean((0, 1)) / k
    aux_loss = e * torch.sum(f_e * probs.mean((0, 1))) * m.aux_loss_weight

    seq_mode = (s % t == 0) and s >= t
    r_local = b_loc * (s // t) * k if seq_mode \
        else max(1, -(-b_loc * s * k // t))
    cap = _round8(math.ceil(m.capacity_factor * max(1, r_local) / t))
    over_cap = _round8(math.ceil(m.overflow_factor * max(1, r_local) / t)) \
        if m.overflow == "second_round" else 0
    use_kernel = bool(run is not None and run.use_pallas)
    cfg_ch = ch.ChannelConfig(
        axis="model", capacity=cap, overflow=m.overflow,
        overflow_capacity=over_cap,
        local_shortcut=bool(run is None or run.local_shortcut),
        pack_impl="kernel" if use_kernel else "ref", n_replicas=n_dp)
    cap2 = _round8(math.ceil(4.0 * max(1, r_local) / e_local))
    weights = {n: params[n] for n in ("w_gate", "w_up", "w_down")}
    serve = _expert_serve(weights, e_local, cap2, cfg.act, use_kernel, n_dp)
    w_tok = top_w.to(x.dtype)

    def dispatch(x_l, w_l, e_l, pmask=None):
        """Every client's round at once: x_l (n_dp * T, R_tok, D), w_l /
        e_l (n_dp * T, R_tok, K), pmask (n_dp * T, R_tok) the tokens each
        client owns."""
        r_tok = x_l.shape[1]
        h_rows = torch.repeat_interleave(x_l, k, dim=1)  # (.., R_tok*K, D)
        e_flat = e_l.reshape(n_sh, r_tok * k)
        dst = torch.div(e_flat, e_local, rounding_mode="floor").to(
            torch.int32)
        el = (e_flat % e_local).to(torch.int32)
        if pmask is not None:
            pm = torch.repeat_interleave(pmask, k, dim=1)
            dst = torch.where(pm, dst, torch.full_like(dst, -1))
        _, resp, info = ch.delegate(None, dst, {"h": h_rows, "el": el},
                                    serve, t, cfg_ch)
        y_rows = resp["y"].reshape(n_sh, r_tok, k, d)
        y_tok = (y_rows * w_l[..., None].to(y_rows.dtype)).sum(2)
        dropped = info.dropped.reshape(n_sh, r_tok, k).any(-1)
        return y_tok, info.group_sizes, dropped

    if seq_mode:
        sl = s // t

        def shard(a):  # (B, S, ...) -> (n_dp * T, b_loc * S/T, ...)
            trail = tuple(a.shape[2:])
            a = a.reshape((n_dp, b_loc, t, sl) + trail)
            return a.transpose(1, 2).reshape((n_sh, b_loc * sl) + trail)

        def unshard(a):        # the inverse
            trail = tuple(a.shape[2:])
            a = a.reshape((n_dp, t, b_loc, sl) + trail)
            return a.transpose(1, 2).reshape((b, s) + trail)
        y, gs, dropped = dispatch(shard(x), shard(w_tok), shard(top_e))
        y, dropped = unshard(y), unshard(dropped)
    else:
        n_tok = b_loc * s

        def every(a):  # (B, S, ...) -> (n_dp * T, b_loc * S, ...): each
            # data row's tokens, seen by its T clients
            trail = tuple(a.shape[2:])
            return a.reshape((n_dp, 1, n_tok) + trail).expand(
                (n_dp, t, n_tok) + trail).reshape((n_sh, n_tok) + trail)
        my = torch.arange(n_sh, device=x.device)[:, None] % t
        pmask = torch.arange(n_tok, device=x.device)[None, :] % t == my
        y, gs, dropped = dispatch(every(x), every(w_tok), every(top_e),
                                  pmask)
        y = torch.where(pmask[..., None], y, torch.zeros_like(y)) \
            .reshape(n_dp, t, n_tok, d).sum(1)
        dropped = (dropped & pmask).reshape(n_dp, t, n_tok).any(1)
        y, dropped = y.reshape(b, s, d), dropped.reshape(b, s)

    if m.num_shared > 0:
        y = y + mlp(params["shared"], x, cfg.act)
    aux = {"moe_aux_loss": aux_loss,
           "moe_dropped_frac": dropped.float().mean(),
           "moe_max_load": gs.max().float()}
    return y, aux
