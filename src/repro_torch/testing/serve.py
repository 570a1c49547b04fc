"""Cases of the KV serve kernels that chip_smoke.py and the GPU tests
share."""
from __future__ import annotations

import torch


def far_winner_flags(order: torch.Tensor, tile: int) -> torch.Tensor:
    """Request-order int32 flags for a grouping whose shards each hold one
    segment of every row, flagged at sorted positions chosen so that the
    winner lies tiles before its segment's end (``tile`` sorted rows a
    kernel block).  Shard s takes pattern s % 4:
      0: rows 3, tile + tile // 2, 2 * tile + 52 — the last of them wins
         and its block reads forward to the end of the shard;
      1: rows tile - 1 (a tile's last row) and 5 * tile — the first reads
         forward four tiles to the second, which wins;
      2: nothing flagged — no row wins;
      3: the shard's last row alone."""
    t, n = order.shape
    if n < 6 * tile:
        raise ValueError(f"far_winner_flags: N {n} < 6 tiles of {tile}")
    patterns = ([3, tile + tile // 2, 2 * tile + 52], [tile - 1, 5 * tile], [],
                [n - 1])
    flag = torch.zeros((t, n), dtype=torch.int32, device=order.device)
    for s in range(t):
        pos = torch.tensor(patterns[s % 4], dtype=torch.long,
                           device=order.device)
        flag[s, order[s, pos].long()] = 1
    return flag
