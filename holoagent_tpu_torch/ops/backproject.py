"""RGB-D backprojection (counterpart of holoagent_tpu/ops/backproject.py)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.camera import Pinhole


def backproject(
    depth: torch.Tensor,  # (H, W) float32 metres
    rgb: torch.Tensor,  # (H, W, 3) float32 in [0, 1]
    cam: Pinhole,
    pose_c2w: torch.Tensor,  # (4, 4) camera-to-world
    depth_min: float = 1e-3,
    depth_max: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backproject one posed RGB-D frame to world-frame points.

    Returns (points (H*W, 3), colors (H*W, 3), valid (H*W,) bool); invalid
    points are zeros.  The pose product runs in full float32 (TF32 is off,
    see device.py), as the reference's ``Precision.HIGHEST``."""
    h, w = depth.shape
    dev = depth.device
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    z = depth
    valid = (z > depth_min) & (z < depth_max) & torch.isfinite(z)
    x = (u - cam.cx) * z / cam.fx
    y = (v - cam.cy) * z / cam.fy
    pts_cam = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    r = pose_c2w[:3, :3]
    t = pose_c2w[:3, 3]
    pts_w = pts_cam @ r.T + t
    valid = valid.reshape(-1)
    pts_w = torch.where(valid[:, None], pts_w, torch.zeros_like(pts_w))
    colors = torch.where(valid[:, None], rgb.reshape(-1, 3), torch.zeros_like(pts_w))
    return pts_w, colors, valid


def backproject_batch(
    depth: torch.Tensor,  # (B, H, W)
    rgb: torch.Tensor,  # (B, H, W, 3)
    cam: Pinhole,
    pose_c2w: torch.Tensor,  # (B, 4, 4)
    depth_min: float = 1e-3,
    depth_max: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``backproject`` over a batch of frames sharing one camera (the
    reference vmaps it): (B, H*W, 3) points and colors, (B, H*W) valid."""
    outs = [backproject(d, c, cam, p, depth_min, depth_max) for d, c, p in zip(depth, rgb, pose_c2w)]
    return tuple(torch.stack(z) for z in zip(*outs))


def mean_depth_gate(depth: torch.Tensor, valid: torch.Tensor, filter_distance: float) -> torch.Tensor:
    """Frame rejection gate: a mean valid depth beyond ``filter_distance``
    drops the frame (reference generic.py:125-127 returns an empty cloud).
    Returns a 0-dim bool 'keep'."""
    s = torch.where(valid, depth.reshape(-1), torch.zeros((), device=depth.device)).sum()
    n = torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    return (s / n) <= filter_distance
