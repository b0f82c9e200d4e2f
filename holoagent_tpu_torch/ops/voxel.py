"""Voxel-key engine (counterpart of holoagent_tpu/ops/voxel.py).

Points bin into a 2048 x 2048 x 512 grid and the three cell coordinates pack
into one int32 key (11/11/9 bits, z = gravity axis).  Downsampling is a
stable sort of the keys plus a segment mean; lookups are ``searchsorted``
into a sorted key array.  Invalid lanes carry ``SENTINEL`` and sort last.
``snap_to_voxels`` finds each point's nearest occupied voxel among the 27
cells around it (the pose solvers' correspondence search).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

BITS_X = 11
BITS_Y = 11
BITS_Z = 9
NX = 1 << BITS_X
NY = 1 << BITS_Y
NZ = 1 << BITS_Z
SENTINEL = 2**31 - 1  # int32 key of invalid/padded lanes


class GridSpec(NamedTuple):
    """Voxel grid: float32 cell size + world origin of cell (0, 0, 0)'s corner."""

    voxel_size: float
    origin: Tuple[float, float, float]

    @staticmethod
    def make(voxel_size: float, origin=(0.0, 0.0, 0.0)) -> "GridSpec":
        o = np.asarray(origin, np.float32)
        return GridSpec(float(np.float32(voxel_size)), tuple(float(c) for c in o))

    @staticmethod
    def centered(voxel_size: float) -> "GridSpec":
        """Grid centred on the world origin (float32 arithmetic, as the
        reference computes it)."""
        vs = np.float32(voxel_size)
        half = np.asarray([NX // 2, NY // 2, NZ // 2], np.float32) * vs
        return GridSpec(float(vs), tuple(float(c) for c in -half))

    def origin_tensor(self, device) -> torch.Tensor:
        return _const(self.origin, torch.float32, torch.device(device))


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor, made once a device: no host copy at each
    use, so a CUDA graph can capture its users (``ops.solvers``' ICP)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _hi(device) -> torch.Tensor:
    return _const((NX - 2, NY - 2, NZ - 2), torch.int32, torch.device(device))


def coords(points: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """Integer cell coords (N, 3) int32, clipped into the grid."""
    c = torch.floor((points - grid.origin_tensor(points.device)) / grid.voxel_size)
    c = c.to(torch.int32)
    return torch.minimum(c.clamp(min=0), _hi(points.device))


def pack(c: torch.Tensor) -> torch.Tensor:
    """Pack int32 cell coords (..., 3) into one int32 key (...)."""
    return (c[..., 0] << (BITS_Y + BITS_Z)) | (c[..., 1] << BITS_Z) | c[..., 2]


def unpack(key: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack`: (N,) -> (N, 3) int32."""
    x = key >> (BITS_Y + BITS_Z)
    y = (key >> BITS_Z) & (NY - 1)
    z = key & (NZ - 1)
    return torch.stack([x, y, z], dim=-1)


def keys_of(points: torch.Tensor, valid: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """Voxel keys with SENTINEL on invalid lanes."""
    k = pack(coords(points, grid))
    return torch.where(valid, k, torch.full_like(k, SENTINEL))


def cell_center(key: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """World-space center of each cell key: (N,) -> (N, 3)."""
    c = unpack(key).to(torch.float32)
    return grid.origin_tensor(key.device) + (c + 0.5) * grid.voxel_size


def voxel_downsample(
    points: torch.Tensor,  # (N, 3)
    attrs: torch.Tensor,  # (N, A)
    valid: torch.Tensor,  # (N,) bool
    grid: GridSpec,
    capacity: int,
    return_segments: bool = False,
) -> Dict[str, torch.Tensor]:
    """Average points (and attrs) per occupied voxel; same outputs as the
    reference (points, attrs, count, key, valid, num[, segments])."""
    n = points.shape[0]
    dev = points.device
    key = keys_of(points, valid, grid)
    key_s, idx_s = torch.sort(key, stable=True)
    pts_s = points[idx_s]
    attrs_s = attrs[idx_s]
    valid_s = key_s != SENTINEL
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), key_s[1:] != key_s[:-1]])
    first = first & valid_s
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    seg_c = torch.where(valid_s & (seg >= 0) & (seg < capacity), seg, torch.full_like(seg, capacity))

    sum_pts = torch.zeros((capacity + 1, 3), dtype=points.dtype, device=dev).index_add_(0, seg_c, pts_s)
    sum_attrs = torch.zeros((capacity + 1, attrs.shape[1]), dtype=attrs.dtype, device=dev)
    sum_attrs.index_add_(0, seg_c, attrs_s)
    cnt = torch.zeros(capacity + 1, dtype=torch.float32, device=dev)
    cnt.index_add_(0, seg_c, valid_s.to(torch.float32))
    out_key = torch.full((capacity + 1,), SENTINEL, dtype=torch.int32, device=dev)
    out_key = out_key.scatter_reduce(0, seg_c, key_s, "amin", include_self=True)

    cnt = cnt[:capacity]
    denom = torch.clamp(cnt, min=1.0)[:, None]
    out = {
        "points": sum_pts[:capacity] / denom,
        "attrs": sum_attrs[:capacity] / denom.to(attrs.dtype),
        "count": cnt,
        "key": out_key[:capacity],
        "valid": cnt > 0,
        "num": (cnt > 0).sum().to(torch.int32),
    }
    if return_segments:
        seg_of_input = torch.full((n,), -1, dtype=torch.int32, device=dev)
        seg_of_input[idx_s] = torch.where(seg_c < capacity, seg_c, -1).to(torch.int32)
        out["segments"] = seg_of_input
    return out


def lookup(sorted_keys: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """Row of each query key in the sorted keys, or -1 when absent (int64)."""
    pos = torch.searchsorted(sorted_keys, query_keys)
    pos = pos.clamp(0, sorted_keys.shape[0] - 1)
    hit = (sorted_keys[pos] == query_keys) & (query_keys != SENTINEL)
    return torch.where(hit, pos, torch.full_like(pos, -1))


def intersect_count(sorted_a: torch.Tensor, sorted_b: torch.Tensor) -> torch.Tensor:
    """|A ∩ B| for two sorted unique key arrays (SENTINEL padded), 0-dim
    int32."""
    return (lookup(sorted_b, sorted_a) >= 0).sum().to(torch.int32)


# (27, 3) cell offsets of the neighbourhood; row 13 is (0, 0, 0)
_NEIGHBOR_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)], dtype=np.int32
)


def snap_to_voxels(
    query_points: torch.Tensor,  # (M, 3)
    query_valid: torch.Tensor,  # (M,) bool
    sorted_keys: torch.Tensor,  # (C,) sorted, SENTINEL padded
    voxel_points: torch.Tensor,  # (C, 3) representative point per voxel
    grid: GridSpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Snap each query point to the nearest occupied voxel's representative,
    probing the 27-cell neighbourhood (ties to the first probe, as
    ``jnp.argmin``).  Returns (row (M,) int64 into the voxel rows or -1,
    distance (M,) float32, inf where no probe hits)."""
    dev = query_points.device
    c = coords(query_points, grid)  # (M, 3)
    offsets = _const(tuple(map(tuple, _NEIGHBOR_OFFSETS.tolist())), torch.int32, dev)
    nbr = c[:, None, :] + offsets[None]  # (M, 27, 3)
    nbr = torch.minimum(nbr.clamp(min=0), _hi(dev))
    rows = lookup(sorted_keys, pack(nbr).reshape(-1)).reshape(nbr.shape[:2])  # (M, 27)
    cand = voxel_points[rows.clamp(min=0)]  # (M, 27, 3)
    d2 = torch.sum((cand - query_points[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(rows >= 0, d2, float("inf"))
    best = torch.argmin(d2, dim=-1, keepdim=True)  # the first minimum
    take = torch.gather(rows, 1, best)[:, 0]
    bestd = torch.sqrt(torch.gather(d2, 1, best)[:, 0])
    ok = query_valid & (take >= 0) & torch.isfinite(bestd)
    return torch.where(ok, take, -1), torch.where(ok, bestd, float("inf"))
