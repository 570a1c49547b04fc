"""Hold every paged-attention kernel call against its plain version."""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..kernels.paged_attention import TOLERANCE


class AttentionCheck:
    """Inside the context, every ``kops.paged_attention`` kernel call is
    also run through the plain version on the same inputs and compared
    on the device (no host sync): ``calls``, ``max_err`` and ``bad`` (the
    elements beyond ``TOLERANCE``) accumulate in device tensors, in
    place, so a captured call (``core.compiled``) keeps checking in its
    replays.  The caller's code runs unchanged; only the module attribute
    is wrapped."""

    def __init__(self, dtype: torch.dtype, device: torch.device):
        self.rtol, self.atol = TOLERANCE[dtype]
        self.calls = torch.zeros((), dtype=torch.int64, device=device)
        self.max_err = torch.zeros((), device=device)
        self.bad = torch.zeros((), dtype=torch.int64, device=device)

    def __enter__(self):
        self._pa = kops.paged_attention
        kops.paged_attention = self._call
        return self

    def __exit__(self, *exc):
        kops.paged_attention = self._pa

    def _call(self, q, k_pages, v_pages, page_table, lengths, scale=None,
              impl="kernel"):
        out = self._pa(q, k_pages, v_pages, page_table, lengths, scale,
                       impl=impl)
        if impl == "kernel":
            want = self._pa(q, k_pages, v_pages, page_table, lengths, scale,
                            impl="ref").float()
            err = (out.float() - want).abs()
            self.max_err.copy_(torch.maximum(self.max_err, err.max()))
            self.bad.add_((err > self.atol + self.rtol * want.abs()).sum())
            self.calls.add_(1)
        return out

    def summary(self):
        return {"attention_calls": int(self.calls),
                "attention_max_abs_err": float(self.max_err),
                "attention_out_of_tolerance": int(self.bad),
                "tolerance": {"rtol": self.rtol, "atol": self.atol}}
