"""Pinhole camera model (counterpart of holoagent_tpu/utils/camera.py).

Intrinsics are plain float32-rounded Python floats, so the same camera works
with tensors on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve


def _f32(x) -> float:
    return float(np.float32(x))


class Pinhole(NamedTuple):
    """Intrinsics for a pinhole camera (float32 values)."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_matrix(k: np.ndarray) -> "Pinhole":
        k = np.asarray(k, dtype=np.float32)
        return Pinhole(_f32(k[0, 0]), _f32(k[1, 1]), _f32(k[0, 2]), _f32(k[1, 2]))

    @staticmethod
    def make(fx: float, fy: float, cx: float, cy: float) -> "Pinhole":
        return Pinhole(_f32(fx), _f32(fy), _f32(cx), _f32(cy))

    def matrix(self, device: DeviceLike = None) -> torch.Tensor:
        """The 3x3 intrinsics matrix, float32, on `device` (the card unless "cpu")."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
                            dtype=torch.float32, device=resolve(device))

    def scaled(self, sx: float, sy: float) -> "Pinhole":
        """Intrinsics after resizing the image by (sx, sy), each product in float32."""
        x, y = np.float32(sx), np.float32(sy)
        return Pinhole(*(float(np.float32(v) * s) for v, s in zip(self, (x, y, x, y))))


def project(points_cam: torch.Tensor, cam: Pinhole) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project camera-frame points (N, 3) to pixel coords (N, 2) and depth (N,)."""
    z = points_cam[:, 2]
    safe_z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = points_cam[:, 0] / safe_z * cam.fx + cam.cx
    v = points_cam[:, 1] / safe_z * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1), z
