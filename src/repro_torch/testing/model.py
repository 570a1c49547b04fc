"""Checks of the model path that ``chip_smoke.py`` and the tests share:

  * ``FlashCheck`` holds every flash-attention kernel call against its
    plain version on the same inputs (the prefill's check run);
  * ``DecodeLogits`` keeps the decode step's logits at one position while
    the serve loop runs unchanged;
  * ``logits_agreement`` holds the prefill's last-position logits against
    the serve's decode logits at that position.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..kernels.flash_attention import tolerance as flash_tolerance
from ..models import model as M

# prefill against decode at the same position, on the relative RMS of the
# logit difference, ||a - b|| / ||b||.  f32: the same math in another
# order (one blocked softmax against per-shard partials), ~1e-6.  bf16:
# the two paths round activations to bf16 at different places (matmuls
# of (B*S, D) rows against (B, D) rows, P rounded in the flash kernel,
# the decode's f32 partials), 2^-9 relative a rounding, compounding over
# 36 residual layers and two sublayers each — a few percent at most.
PREFILL_DECODE_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def flash_within(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor):
    """(within the tolerance, max abs err) of a flash-attention kernel
    output against its plain version (``flash_attention.tolerance``)."""
    rtol, atol = flash_tolerance(v)
    err = (got.float() - want.float()).abs()
    return (bool((err <= atol + rtol * want.float().abs()).all()),
            float(err.max()) if err.numel() else 0.0)


class FlashCheck:
    """Inside the context, every ``kops.flash_attention`` kernel call is
    also run through the plain version on the same inputs and compared:
    ``calls``, ``max_err`` and ``bad`` (calls beyond the tolerance)
    accumulate, and ``first`` keeps the first call's arguments.  The
    caller's code runs unchanged; only the module attribute is wrapped."""

    def __init__(self):
        self.calls, self.bad, self.max_err = 0, 0, 0.0
        self.first = None

    def __enter__(self):
        self._fa = kops.flash_attention
        kops.flash_attention = self._call
        return self

    def __exit__(self, *exc):
        kops.flash_attention = self._fa

    def _call(self, q, k, v, q_offset=None, causal=True, scale=None,
              impl="kernel"):
        out = self._fa(q, k, v, q_offset, causal, scale, impl=impl)
        if impl == "kernel":
            if self.first is None:
                self.first = (q, k, v, q_offset, causal, scale)
            want = self._fa(q, k, v, q_offset, causal, scale, impl="ref")
            ok, err = flash_within(out, want, v)
            self.calls += 1
            self.bad += int(not ok)
            self.max_err = max(self.max_err, err)
        return out

    def summary(self):
        return {"flash_calls": self.calls, "flash_max_abs_err": self.max_err,
                "flash_calls_out_of_tolerance": self.bad}


class DecodeLogits:
    """Inside the context, the logits of the decode step at position
    ``pos`` (every row of the batch at that position) are kept in
    ``logits``; the serve loop runs unchanged (``M.decode_step`` is
    wrapped)."""

    def __init__(self, pos: int):
        self.pos, self.logits = pos, None

    def __enter__(self):
        self._step = M.decode_step
        M.decode_step = self._call
        return self

    def __exit__(self, *exc):
        M.decode_step = self._step

    def _call(self, params, cache, tokens, pos, cfg, run=None):
        logits, cache = self._step(params, cache, tokens, pos, cfg, run)
        if int(pos[0]) == self.pos:
            self.logits = logits.clone()
        return logits, cache


def logits_agreement(prefill: torch.Tensor, decode: torch.Tensor,
                     dtype: torch.dtype) -> dict:
    """The prefill's last-position logits against the decode's at the same
    position: relative RMS difference (held to ``PREFILL_DECODE_RTOL``),
    max abs difference, and the share of rows whose argmax agrees."""
    a, b = prefill.float(), decode.float()
    rel = float((a - b).norm() / b.norm())
    return {"rel_rms": rel, "max_abs": float((a - b).abs().max()),
            "argmax_agree": float((a.argmax(-1) == b.argmax(-1))
                                  .float().mean()),
            "rtol": PREFILL_DECODE_RTOL[dtype],
            "ok": rel <= PREFILL_DECODE_RTOL[dtype]}
