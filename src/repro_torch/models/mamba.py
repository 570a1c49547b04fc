"""Mamba-1 selective-SSM mixer (falcon-mamba, jamba's hybrid layers): the
torch counterpart of ``repro.models.mamba``.

Parameters keep the JAX layout and names — ``w_in`` (D, 2 DI), ``conv_w``
(d_conv, DI), ``conv_b`` (DI,), ``w_x`` (DI, dt_rank + 2N), ``w_dt``
(dt_rank, DI), ``w_out`` (DI, D) in the parameter dtype; ``b_dt`` (DI,),
``log_a`` (DI, N) and ``d_skip`` (DI,) in f32 whatever it is — so
``convert`` carries JAX weights across as they are.  The four projections
are plain ``torch.matmul`` (the JAX package leaves them to XLA).

``mamba_block`` is the prefill and training forward: the causal
depthwise conv, SiLU, the input-dependent dt / B / C, and the selective
scan over the whole sequence — the CUDA kernel under ``run.use_pallas``,
else the sequential plain scan, which training differentiates (the kernel
has no backward, as JAX's Pallas scan has none).  JAX's plain path is the associative form of the same
function, and its ``run.mamba_chunked`` option chunks that form to bound
its (B, S, DI, N) memory; the sequential scan holds one (B, DI, N) state,
so the port has no such option.
``mamba_decode`` is one token against the (conv, ssm) state cache with
the plain one-step recurrence, as in JAX; the cache is updated in place.
JAX shards d_inner over the model axis, so each trustee owns its slice of
the state and no channel is needed; on the port's one card the state is
whole.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from ..kernels import ref as kref
from .layers import _normal_stacked


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.resolved_dt_rank(cfg.d_model)
    return d_inner, dt_rank, m.d_state, m.d_conv


def init_mamba(cfg: ModelConfig, dtype, device, gen: torch.Generator,
               lead: tuple = ()) -> Dict[str, torch.Tensor]:
    """Random projections from ``gen`` (drawn on its device one layer at a
    time; not JAX's numbers, tests carry JAX weights through
    ``convert``) at JAX's scales; ``b_dt``, ``log_a`` and ``d_skip`` as
    JAX sets them (dt near 0.01, S4D-real A = -(1 .. N), D = 1), f32.
    ``lead`` prefixes a stacked layer dimension."""
    d = cfg.d_model
    d_inner, dt_rank, n, d_conv = _dims(cfg)

    def w(shape, scale):
        return _normal_stacked(gen, lead, shape, scale, dtype, device)

    f32 = dict(dtype=torch.float32, device=device)
    log_a = torch.log(torch.arange(1, n + 1, **f32))
    return {
        "w_in": w((d, 2 * d_inner), 1.0 / math.sqrt(d)),
        "conv_w": w((d_conv, d_inner), 1.0 / math.sqrt(d_conv)),
        "conv_b": torch.zeros(lead + (d_inner,), dtype=dtype,
                              device=device),
        "w_x": w((d_inner, dt_rank + 2 * n), 1.0 / math.sqrt(d_inner)),
        "w_dt": w((dt_rank, d_inner), 1.0 / math.sqrt(dt_rank)),
        "b_dt": torch.full(lead + (d_inner,), math.log(math.expm1(0.01)),
                           **f32),
        "log_a": log_a.expand(lead + (d_inner, n)).contiguous(),
        "d_skip": torch.ones(lead + (d_inner,), **f32),
        "w_out": w((d_inner, d), 1.0 / math.sqrt(d_inner)),
    }


def _ssm_params(params, x: torch.Tensor, cfg: ModelConfig):
    """x (..., DI) after the conv and SiLU -> (dt in x's dtype, a, b, c
    f32): the input-dependent projections, dt through softplus in f32."""
    _, dt_rank, n, _ = _dims(cfg)
    proj = torch.matmul(x, params["w_x"])                # contracts DI
    dt_r, bb, cc = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = torch.matmul(dt_r, params["w_dt"])
    dt = F.softplus(dt.float() + params["b_dt"])
    a = -torch.exp(params["log_a"])                      # (DI, N)
    return dt.to(x.dtype), a, bb.float(), cc.float()


def mamba_block(params, x_in: torch.Tensor, cfg: ModelConfig, run=None
                ) -> torch.Tensor:
    """Prefill path: x_in (B, S, D) -> (B, S, D)."""
    _, _, _, d_conv = _dims(cfg)
    s = x_in.shape[1]
    xz = torch.matmul(x_in, params["w_in"])
    x, z = torch.chunk(xz, 2, dim=-1)                    # (B, S, DI)

    # causal depthwise conv over time, one op that sums the d_conv
    # products in f32 and rounds once, as the decode step's einsum does
    # (JAX's prefill sums them in the activation dtype, rounding after
    # each add: in bf16 its prefill and decode are two functions, a
    # settled divergence, ROADMAP); the bias added after the rounding, as
    # in the decode
    w = params["conv_w"].t().unsqueeze(1)                # (DI, 1, d_conv)
    conv = F.conv1d(x.transpose(1, 2), w, padding=d_conv - 1,
                    groups=w.shape[0])[..., :s]
    conv = conv.transpose(1, 2).contiguous() + params["conv_b"]
    x = F.silu(conv.float()).to(x.dtype)

    dt, a, bb, cc = _ssm_params(params, x, cfg)
    impl = "kernel" if run is not None and run.use_pallas else "ref"
    y, _h = kops.selective_scan(x, dt, a, bb, cc, params["d_skip"],
                                impl=impl)
    y = y * F.silu(z.float()).to(y.dtype)
    return torch.matmul(y, params["w_out"])


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device=None,
                     lead: tuple = ()) -> Dict[str, torch.Tensor]:
    """Zero decode state: ``conv`` (B, d_conv - 1, DI) in ``dtype`` (the
    last inputs of the conv), ``ssm`` (B, DI, N) f32; ``lead`` prefixes a
    stacked layer dimension."""
    d_inner, _, n, d_conv = _dims(cfg)
    return {"conv": torch.zeros(lead + (batch, d_conv - 1, d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros(lead + (batch, d_inner, n),
                               dtype=torch.float32, device=device)}


def mamba_decode(params, x_in: torch.Tensor, cache: Dict, cfg: ModelConfig,
                 run=None) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: x_in (B, D), cache {conv (B, d_conv - 1, DI), ssm
    (B, DI, N)} -> (y (B, D), cache) — the cache updated in place."""
    xz = torch.matmul(x_in, params["w_in"])
    x, z = torch.chunk(xz, 2, dim=-1)                    # (B, DI)

    hist = torch.cat([cache["conv"], x[:, None]], dim=1)    # (B, dc, DI)
    # JAX's einsum: the products summed in f32 (exact products of the
    # activation-dtype operands), rounded once
    conv = (hist.float() * params["conv_w"].float()).sum(1).to(x.dtype) \
        + params["conv_b"]
    cache["conv"].copy_(hist[:, 1:])
    x = F.silu(conv.float()).to(x.dtype)

    dt, a, bb, cc = _ssm_params(params, x, cfg)
    y, h = kref.selective_scan_step(x, dt, a, bb, cc, params["d_skip"],
                                    cache["ssm"])
    cache["ssm"].copy_(h)
    y = y * F.silu(z.float()).to(y.dtype)
    return torch.matmul(y, params["w_out"]), cache
