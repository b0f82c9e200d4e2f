"""Coarse-grid density filtering (counterpart of holoagent_tpu/ops/density.py):
points are counted on a grid of cell size radius/2 and each point's
neighbour count is the sum over its 5x5x5 block of coarse cells."""

from __future__ import annotations

import numpy as np
import torch

from . import voxel


def radius_density_keep(
    points: torch.Tensor,  # (N, 3)
    valid: torch.Tensor,  # (N,)
    weights: torch.Tensor,  # (N,) point multiplicity (voxel hit counts)
    radius: float = 1.0,
    min_neighbors: float = 1000.0,
) -> torch.Tensor:
    """Keep mask: points whose weighted neighbour count within ~radius is at
    least min_neighbors."""
    dev = points.device
    cell = float(np.float32(radius) / np.float32(2.0))
    grid = voxel.GridSpec.centered(cell)
    c = voxel.coords(points, grid)
    n = points.shape[0]
    down = voxel.voxel_downsample(points, weights[:, None], valid, grid, capacity=n)
    cell_count = down["attrs"][:, 0] * down["count"]  # sum of weights per cell
    offs = torch.arange(-2, 3, dtype=torch.int32, device=dev)
    oz, oy, ox = torch.meshgrid(offs, offs, offs, indexing="ij")
    nbr = torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], dim=-1)  # (125, 3)
    hi = torch.tensor([voxel.NX - 2, voxel.NY - 2, voxel.NZ - 2], dtype=torch.int32, device=dev)
    cells = torch.minimum((c[:, None, :] + nbr[None]).clamp(min=0), hi)
    rows = voxel.lookup(down["key"], voxel.pack(cells).reshape(-1)).reshape(n, -1)
    counts = torch.where(rows >= 0, cell_count[rows.clamp(min=0)], torch.zeros((), device=dev))
    return valid & (counts.sum(dim=1) >= min_neighbors)
