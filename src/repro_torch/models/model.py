"""Model facade (the torch counterpart of ``repro.models.model``): the
uniform entry points ``launch/`` calls.  Decoder-only stacks go to
``transformer``; the encoder-decoder model is not ported yet."""
from __future__ import annotations

from ..configs.base import ModelConfig
from . import transformer


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.is_encoder_decoder


def _decoder_only(cfg: ModelConfig):
    if is_encdec(cfg):
        raise NotImplementedError("the encoder-decoder model is not ported "
                                  "yet (ROADMAP queue A 13)")
    return transformer


def init_params(cfg: ModelConfig, run=None, device=None, gen=None):
    return _decoder_only(cfg).init_params(cfg, run, device, gen)


def forward_loss(params, batch, cfg: ModelConfig, run=None):
    return _decoder_only(cfg).forward_loss(params, batch, cfg, run)


def prefill(params, batch, cfg: ModelConfig, run=None):
    return _decoder_only(cfg).prefill(params, batch, cfg, run)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, run=None,
               device=None):
    return _decoder_only(cfg).init_cache(cfg, batch, max_len, run, device)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, run=None):
    return _decoder_only(cfg).decode_step(params, cache, tokens, pos, cfg,
                                          run)


def count_params(params) -> int:
    return transformer.count_params(params)


def active_param_count(cfg: ModelConfig, total: int) -> int:
    """Parameters a token passes through (``model.active_param_count``):
    the total less the routed experts a token is not sent to."""
    if cfg.ffn_kind == "dense" or cfg.moe.num_experts == 0:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    n_moe = sum(1 for i in range(cfg.n_layers)
                if cfg.layer_ffn_kind(i) in ("moe", "moe+dense"))
    return total - per_expert * (m.num_experts - m.top_k) * n_moe
