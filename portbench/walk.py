"""The mapping cells' frames: a posed RGB-D walk through a procedural
three-room building, ray-cast on the host.

Frozen copy of the port's ``dataloader/synthetic.py`` (``three_room``,
``render``, ``look_at`` and the orbit walk) at commit
b62fedabdce77346f1a976bf9b6f57fc0f42ce1b, kept here so that a change to
the program cannot change the benchmark's inputs.  The walk is fixed: the
run's seed only orders it (``order``).  Rendering takes about a quarter of
a second a 640x480 frame, so the frames are kept in a cache file inside
the checkout (``load``), rendered by the first run that needs them.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import List, Tuple

import numpy as np

CACHE_DIR = Path(__file__).resolve().parent / "_cache" / "walks"
WALL_COLOR = (0.85, 0.82, 0.78)
FLOOR_COLOR = (0.55, 0.5, 0.45)
EXTENT = (12.0, 6.0)
WALL_HEIGHT = 2.5
WALL_T = 0.08
# (label, size, color, (cx, cy)): the fixture's seven pieces of furniture
FURNITURE = (
    ("bed", (1.6, 2.0, 0.5), (0.8, 0.15, 0.15), (1.4, 1.8)),
    ("chair", (0.5, 0.5, 0.9), (0.15, 0.35, 0.85), (2.8, 4.6)),
    ("table", (1.2, 0.8, 0.75), (0.6, 0.4, 0.1), (6.0, 1.6)),
    ("sofa", (1.8, 0.8, 0.8), (0.15, 0.7, 0.25), (6.2, 4.8)),
    ("refrigerator", (0.7, 0.7, 1.8), (1.0, 1.0, 1.0), (11.2, 5.0)),
    ("toilet", (0.5, 0.6, 0.8), (0.1, 0.8, 0.8), (9.2, 5.0)),
    ("bathtub", (1.5, 0.7, 0.6), (0.85, 0.4, 0.75), (10.6, 1.0)),
)
# two dividing walls with offset door gaps
INNER_WALLS = ((4.0, 0.0, 4.0, 2.0), (4.0, 3.2, 4.0, 6.0), (8.0, 0.0, 8.0, 3.0), (8.0, 4.2, 8.0, 6.0))


def boxes() -> List[Tuple[np.ndarray, np.ndarray, Tuple[float, float, float]]]:
    """Every box of the building as (lo, hi, color): furniture, outer and
    inner walls, the floor slab."""
    out = []
    for _, size, color, (cx, cy) in FURNITURE:
        c, s = np.array([cx, cy, size[2] / 2]), np.asarray(size)
        out.append((c - s / 2, c + s / 2, color))
    w, h = EXTENT
    t, zc = WALL_T, WALL_HEIGHT / 2
    walls = [(w / 2, -t / 2, w + 2 * t, t), (w / 2, h + t / 2, w + 2 * t, t),
             (-t / 2, h / 2, t, h + 2 * t), (w + t / 2, h / 2, t, h + 2 * t)]
    for x0, y0, x1, y1 in INNER_WALLS:
        walls.append(((x0 + x1) / 2, (y0 + y1) / 2, max(abs(x1 - x0), t), max(abs(y1 - y0), t)))
    for cx, cy, sx, sy in walls:
        c, s = np.array([cx, cy, zc]), np.array([sx, sy, WALL_HEIGHT])
        out.append((c - s / 2, c + s / 2, WALL_COLOR))
    c, s = np.array([w / 2, h / 2, -0.05]), np.array([w + 2 * t, h + 2 * t, 0.1])
    out.append((c - s / 2, c + s / 2, FLOOR_COLOR))
    return out


def look_at(eye, target, up=(0, 0, 1.0)) -> np.ndarray:
    """Camera-to-world pose of an OpenCV camera (x right, y down, z
    forward) at `eye` looking at `target`."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, np.cross(fwd, right), fwd, eye
    return pose.astype(np.float32)


def intrinsics(hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw
    f = 0.9 * w
    return np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]], np.float32)


def poses(num: int) -> List[np.ndarray]:
    """`num` poses (a multiple of 3): one orbit loop per room, each looking
    inward from 1.3 m off the room's centre at 1.5 m height."""
    w, h = EXTENT
    per = num // 3
    out = []
    for i_loop in range(3):
        cx, cy = (i_loop + 0.5) * w / 3, h * 0.5
        for i in range(per):
            a = 2 * np.pi * i / per
            out.append(look_at((cx + 1.3 * np.cos(a), cy + 1.3 * np.sin(a), 1.5), (cx, cy, 0.8)))
    return out


def render(pose_c2w: np.ndarray, k: np.ndarray, hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast one frame: (rgb (H, W, 3) float32 in [0, 1], z-depth (H, W)
    float32 metres, 0 where no box is hit)."""
    hh, ww = hw
    pose_c2w = pose_c2w.astype(np.float64)
    u, v = np.meshgrid(np.arange(ww), np.arange(hh))
    dirs_cam = np.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1], np.ones_like(u, np.float64)], axis=-1)
    o = pose_c2w[:3, 3]
    dirs = dirs_cam @ pose_c2w[:3, :3].T
    tbest = np.full((hh, ww), np.inf)
    rgb = np.zeros((hh, ww, 3), np.float32)
    inv = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
    inv_axes = [np.ascontiguousarray(inv[..., i]) for i in range(3)]
    for lo, hi, color in boxes():
        lo, hi = lo - o, hi - o
        t0, t1 = lo[0] * inv_axes[0], hi[0] * inv_axes[0]
        tmin, tmax = np.minimum(t0, t1), np.maximum(t0, t1)
        for i in (1, 2):
            t0, t1 = lo[i] * inv_axes[i], hi[i] * inv_axes[i]
            tmin = np.maximum(tmin, np.minimum(t0, t1))
            tmax = np.minimum(tmax, np.maximum(t0, t1))
        hit = (tmax > np.maximum(tmin, 1e-4)) & (tmin > 1e-4) & (tmin < tbest)
        tbest = np.where(hit, tmin, tbest)
        rgb[hit] = color
    depth = np.where(np.isfinite(tbest), tbest, 0.0)
    shade = 0.75 + 0.25 * np.cos(depth * 3.0)
    return np.clip(rgb * shade[..., None], 0, 1).astype(np.float32), depth.astype(np.float32)


def load(num: int, hw: Tuple[int, int]):
    """The walk's `num` frames at `hw`: (rgb (N, H, W, 3) float32, depth
    (N, H, W) float32, poses (N, 4, 4) float32, k (3, 3)), from the cache
    file, or rendered and cached."""
    k = intrinsics(hw)
    ps = poses(num)
    tag = hashlib.sha256(json.dumps([num, list(hw), Path(__file__).read_text()]).encode()).hexdigest()[:16]
    path = CACHE_DIR / f"three_room_{num}_{hw[0]}x{hw[1]}_{tag}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["rgb"], z["depth"], z["poses"], z["k"]
    frames = [render(p, k, hw) for p in ps]
    rgb = np.stack([f[0] for f in frames])
    depth = np.stack([f[1] for f in frames])
    pose_arr = np.stack(ps)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + ".partial.npz")
    np.savez(tmp, rgb=rgb, depth=depth, poses=pose_arr, k=k)
    os.replace(tmp, path)
    return rgb, depth, pose_arr, k


def order(seed: int, num: int) -> np.ndarray:
    """The run's keyframe order over the walk: the seed picks the starting
    frame and the direction, so every seed maps the same frames."""
    rng = np.random.default_rng(seed)
    idx = np.roll(np.arange(num), -int(rng.integers(num)))
    return idx[::-1].copy() if rng.integers(2) else idx
