"""Model facade (the torch counterpart of ``repro.models.model``): the
uniform entry points ``launch/`` calls.  Decoder-only stacks go to
``transformer``, the encoder-decoder model to ``encdec``;
``input_specs`` names every model input of a cell.

The data axis (``layers.dp_axes``): JAX shards the batch of every input,
cache and decode island over it (``batch_specs_sharding``,
``cache_specs``); each of those computes a sequence on its own, so on one
card, where the whole batch is one tensor, it is the identity and has no
layout.  Only the MoE's delegation changes with it (``moe.moe_block``:
each data row delegates its own sequences)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from . import encdec, transformer
from .layers import dtype_of


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.is_encoder_decoder


def _mod(cfg: ModelConfig):
    return encdec if is_encdec(cfg) else transformer


def init_params(cfg: ModelConfig, run=None, device=None, gen=None):
    return _mod(cfg).init_params(cfg, run, device, gen)


def forward_loss(params, batch, cfg: ModelConfig, run=None):
    return _mod(cfg).forward_loss(params, batch, cfg, run)


def prefill(params, batch, cfg: ModelConfig, run=None) -> torch.Tensor:
    """Last-position logits (B, V) f32 of a decoder-only model; an
    encoder-decoder model's encoder memory (B, S_src, D), as JAX's
    ``prefill`` returns it."""
    if is_encdec(cfg):
        return encdec.encode(params, batch["src_embeds"], cfg, run)
    return transformer.prefill(params, batch, cfg, run)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, run=None,
               device=None):
    return _mod(cfg).init_cache(cfg, batch, max_len, run, device)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, run=None):
    return _mod(cfg).decode_step(params, cache, tokens, pos, cfg, run)


def count_params(params) -> int:
    return transformer.count_params(params)


def param_nbytes(cfg: ModelConfig, run=None) -> int:
    """Bytes of ``cfg``'s parameters under ``run`` (its dtypes, its
    padded heads and vocabulary), from the shapes alone: the tree is
    built on the meta device, nothing allocated or drawn (JAX's
    ``jax.eval_shape`` of ``init_params``)."""
    return _nbytes(init_params(cfg, run, "meta"))


def cache_nbytes(cfg: ModelConfig, batch: int, max_len: int,
                 run=None) -> int:
    """Bytes of the decode cache ``init_cache`` would allocate, from the
    shapes alone (the meta device)."""
    return _nbytes(init_cache(cfg, batch, max_len, run, "meta"))


def _nbytes(tree) -> int:
    return int(sum(leaf.numel() * leaf.element_size()
                   for leaf in transformer._leaves(tree)))


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


def input_specs(cfg: ModelConfig, shape: ShapeConfig, run=None
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Every model input of the cell, name -> (shape, dtype) (JAX's
    ``input_specs``, with torch dtypes in place of ShapeDtypeStructs):
    train and prefill cells take ``tokens`` (B, S), or for an
    embeds-input model ``embeds`` (B, S, D) and, with M-RoPE,
    ``positions`` (3, B, S), or for an encoder-decoder model
    ``src_embeds`` (B, S, D) and ``tokens``; a train cell also
    ``labels``.  A decode cell takes ``tokens`` (B,) int32 — (B, D)
    embeddings for an embeds-input decoder-only model; an encoder-decoder
    model decodes text tokens — and ``pos`` (B,)."""
    b, s = shape.global_batch, shape.seq_len
    adt = dtype_of(run.activation_dtype) if run is not None \
        else torch.bfloat16
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if is_encdec(cfg):
            specs = {"src_embeds": ((b, s, cfg.d_model), adt),
                     "tokens": ((b, s), i32)}
        elif cfg.input_mode == "embeds":
            specs = {"embeds": ((b, s, cfg.d_model), adt)}
            if cfg.mrope_sections:
                specs["positions"] = ((3, b, s), i32)
        else:
            specs = {"tokens": ((b, s), i32)}
        if shape.kind == "train":
            specs["labels"] = ((b, s), i32)
        return specs
    if cfg.input_mode == "embeds" and not is_encdec(cfg):
        tok = ((b, cfg.d_model), adt)
    else:
        tok = ((b,), i32)
    return {"tokens": tok, "pos": ((b,), i32)}
