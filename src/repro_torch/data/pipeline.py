"""Deterministic, resumable token pipeline (the port's copy of
``repro.data.pipeline``, numpy only, so every batch equals JAX's bit for
bit).

Batch b of step s is a pure function of (seed, step): a restarted job
resumes mid-epoch with no drift, and its state is just the step counter
(stored in checkpoints).  The global batch is made on the host as numpy;
the trainer moves it to the card.

Sources: the synthetic LM stream (a noisy successor cycle, so losses
move), or a memory-mapped int32 token file.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclass
class DataConfig:
    seed: int = 0
    vocab_size: int = 32_000
    kind: str = "synthetic"        # "synthetic" | "memmap"
    path: Optional[str] = None     # for memmap
    markov_period: int = 16        # JAX's field; its stream never reads it


class TokenPipeline:
    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig,
                 shape: ShapeConfig):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.shape = shape
        self.vocab = min(cfg.vocab_size, model_cfg.vocab_size)
        if cfg.kind == "memmap":
            if not cfg.path:
                raise ValueError("the memmap pipeline needs a path")
            self._tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        elif cfg.kind != "synthetic":
            raise ValueError(f"unknown data kind {cfg.kind!r} (want "
                             f"'synthetic' or 'memmap')")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step) -> {"tokens", "labels"} (B, S)
        int32, the labels the tokens shifted by one."""
        b, s = self.shape.global_batch, self.shape.seq_len
        rng = np.random.default_rng((self.cfg.seed, step))
        if self.cfg.kind == "memmap":
            n = self._tokens.shape[0] - (s + 1)
            starts = rng.integers(0, n, size=b)
            toks = np.stack([self._tokens[i:i + s + 1] for i in starts])
        else:
            # noisy successor cycle: the next token is the current one
            # plus one up to 10% noise, which a small model learns within
            # tens of steps while the noise keeps the loss honest
            base = rng.integers(0, self.vocab, size=(b, 1))
            phase = np.arange(s + 1)[None, :]
            pattern = (base + phase) % self.vocab
            noise_mask = rng.random((b, s + 1)) < 0.1
            noise = rng.integers(0, self.vocab, size=(b, s + 1))
            toks = np.where(noise_mask, noise, pattern).astype(np.int32)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def embeds_batch_at(self, step: int, d_model: int
                        ) -> Dict[str, np.ndarray]:
        """Stub-frontend batch of the vlm / audio archs: precomputed
        embeddings (B, S, D) f32 and text labels; an encoder-decoder's as
        ``src_embeds`` / ``tokens`` / ``labels``, M-RoPE's with
        ``positions`` (3, B, S)."""
        b, s = self.shape.global_batch, self.shape.seq_len
        rng = np.random.default_rng((self.cfg.seed, step, 7))
        emb = rng.normal(size=(b, s, d_model)).astype(np.float32) * 0.02
        labels = rng.integers(0, self.vocab, size=(b, s)).astype(np.int32)
        out = {"embeds": emb, "labels": labels}
        if self.model_cfg.is_encoder_decoder:
            out = {"src_embeds": emb, "tokens": labels, "labels": labels}
        if self.model_cfg.mrope_sections:
            pos = np.broadcast_to(np.arange(s)[None, None], (3, b, s))
            out["positions"] = np.ascontiguousarray(pos).astype(np.int32)
        return out

    def model_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        if self.model_cfg.input_mode == "embeds" \
                or self.model_cfg.is_encoder_decoder:
            return self.embeds_batch_at(step, self.model_cfg.d_model)
        return self.batch_at(step)
