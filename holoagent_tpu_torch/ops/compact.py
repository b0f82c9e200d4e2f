"""Sort-based grouping/compaction (counterpart of holoagent_tpu/ops/compact.py).

The reference sorts (group, value) lexicographically with ``lax.sort(...,
num_keys=2)``.  Here the pair packs into one int64 key, group in the high
32 bits and the value (offset to unsigned) in the low 32, so one sort gives
the same order.
"""

from __future__ import annotations

from typing import Tuple

import torch

I32_MAX = 2**31 - 1


def group_unique(
    groups: torch.Tensor,  # (N,) int group ids in [0, num_groups)
    values: torch.Tensor,  # (N,) int32 values (< I32_MAX)
    valid: torch.Tensor,  # (N,) bool
    num_groups: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per group, its sorted unique values compacted into a fixed-capacity
    row (the `capacity` smallest kept), padded with I32_MAX.

    Returns (out (num_groups, capacity) int32, counts (num_groups,) int32
    clipped to capacity)."""
    dev = values.device
    g = torch.where(valid, groups.to(torch.int64), torch.full_like(groups, num_groups, dtype=torch.int64))
    v = torch.where(valid, values.to(torch.int64), torch.full_like(values, I32_MAX, dtype=torch.int64))
    packed, _ = torch.sort((g << 32) | (v + 2**31))
    g_s = packed >> 32
    v_s = (packed & 0xFFFFFFFF) - 2**31
    one = torch.ones(1, dtype=torch.bool, device=dev)
    new_group = torch.cat([one, g_s[1:] != g_s[:-1]])
    new_val = torch.cat([one, v_s[1:] != v_s[:-1]])
    uniq = (new_group | new_val) & (g_s < num_groups) & (v_s < I32_MAX)
    u = uniq.to(torch.int64)
    cum = torch.cumsum(u, 0)
    group_start_cum = torch.where(new_group, cum - u, torch.zeros_like(cum))
    group_base = torch.cummax(group_start_cum, 0).values
    rank = cum - group_base - 1
    trash = num_groups * capacity
    slot = torch.where(uniq & (rank < capacity), g_s * capacity + rank, torch.full_like(rank, trash))
    out = torch.full((trash + 1,), I32_MAX, dtype=torch.int32, device=dev)
    out[slot] = torch.where(uniq, v_s, torch.full_like(v_s, I32_MAX)).to(torch.int32)
    counts = torch.zeros(num_groups + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, torch.where(uniq, g_s, torch.full_like(g_s, num_groups)), u)
    return (
        out[:trash].reshape(num_groups, capacity),
        counts[:num_groups].clamp(max=capacity).to(torch.int32),
    )


def unique_compact(
    values: torch.Tensor, valid: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted unique values of one set, padded with I32_MAX; plus count."""
    out, cnt = group_unique(torch.zeros_like(values), values, valid, num_groups=1, capacity=capacity)
    return out[0], cnt[0]
