"""Shared file-format helpers for the dataset loaders (the port's own copy
of holoagent_tpu/dataloader/formats.py; numpy, PIL imported where an image
is read)."""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

# Habitat / open_clip style y-up world -> this framework's z-up convention
Y_UP_TO_Z_UP = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64
)


def quat_to_matrix(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    """Rotation matrix from a (x, y, z, w) quaternion (scipy convention)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def load_tum_poses(
    path: str | Path, quat_order: str = "xyzw", invert: bool = False
) -> Tuple[np.ndarray, List[float]]:
    """TUM trajectory: rows `ts tx ty tz q...`, sorted by timestamp.

    quat_order: "xyzw" (standard TUM, a Horizon poses.txt, which `invert`
    turns from world-to-camera into camera-to-world) or "wxyz" (a Horizon
    CameraTrajectory.txt).  Returns (poses (N,4,4) cam-to-world, timestamps)."""
    raw = np.loadtxt(path)
    if raw.ndim == 1:
        raw = raw[None]
    raw = raw[raw[:, 0].argsort()]
    poses, ts = [], []
    for row in raw:
        if quat_order == "xyzw":
            t, tx, ty, tz, qx, qy, qz, qw = row[:8]
        else:
            t, tx, ty, tz, qw, qx, qy, qz = row[:8]
        m = np.eye(4)
        m[:3, :3] = quat_to_matrix(qx, qy, qz, qw)
        m[:3, 3] = (tx, ty, tz)
        if invert:
            m = np.linalg.inv(m)
        poses.append(m)
        ts.append(float(t))
    return np.stack(poses), ts


def load_matrix_pose(path: str | Path) -> np.ndarray:
    """4x4 pose from a whitespace text file (ScanNet / HM3D walk format)."""
    return np.loadtxt(path).reshape(4, 4)


def load_image01(path: str | Path) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def load_depth_m(path: str | Path, scale: float = 1000.0, depth_cut: float = np.inf) -> np.ndarray:
    """(H, W) float32 metres; values beyond depth_cut zeroed (invalid)."""
    from PIL import Image

    d = np.asarray(Image.open(path), np.float32) / scale
    d[d > depth_cut] = 0.0
    return d


def sorted_files(directory: str | Path, exts=(".png", ".jpg", ".jpeg")) -> List[Path]:
    p = Path(directory)
    if not p.exists():
        return []
    return sorted(f for f in p.iterdir() if f.suffix.lower() in exts)
