"""Write a posed RGB-D sequence in a dataset loader's on-disk layout.

No dataset ships with the repository, so the loaders are driven on files
this module writes from rendered frames (``SyntheticScene.render``), in the
layouts of ``hm3dsem``, ``replica``, ``horizon``, ``scannet`` and
``iphone``.  Frames are quantized as the formats store them: rgb as uint8
(``round(255 x rgb)``), depth as uint16 at the layout's scale.  Each writer
returns the frames as the layout's loader reads them back (uint8 / 255,
uint16 / scale with depth beyond `depth_cut` zeroed, the loader's K and
camera-to-world pose), the in-memory side of a loader check.

Pose files: matrix layouts store the pose exactly (float64 text); the TUM
and odometry layouts store a quaternion, which reads back within float
rounding.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Sequence

import numpy as np

from .formats import Y_UP_TO_Z_UP
from .generic import RGBDFrame

HM3DSEM_SCALE = 1000.0
REPLICA_SCALE = 6553.5
MM_SCALE = 1000.0  # horizon, scannet, iphone
# the Replica loader's intrinsics without cam_params.json (1200x680 frames)
REPLICA_DEFAULT_K = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]], np.float32)


def hm3dsem_k(h: int, w: int) -> np.ndarray:
    """The HM3DSem loader's K for an h x w image (90-degree HFOV)."""
    f = w / 2.0
    return np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]], np.float32)


def matrix_to_quat(r: np.ndarray) -> np.ndarray:
    """(x, y, z, w) unit quaternion of a rotation matrix (Shepperd's method),
    the inverse of ``formats.quat_to_matrix``."""
    tr = np.trace(r)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s, 0.25 * s]
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = 2.0 * np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2])
        q = [0.25 * s, (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s, (r[2, 1] - r[1, 2]) / s]
    elif r[1, 1] > r[2, 2]:
        s = 2.0 * np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2])
        q = [(r[0, 1] + r[1, 0]) / s, 0.25 * s, (r[1, 2] + r[2, 1]) / s, (r[0, 2] - r[2, 0]) / s]
    else:
        s = 2.0 * np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1])
        q = [(r[0, 2] + r[2, 0]) / s, (r[1, 2] + r[2, 1]) / s, 0.25 * s, (r[1, 0] - r[0, 1]) / s]
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def _save_image(path: Path, a: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(a).save(path)


def _rgb_u8(rgb: np.ndarray) -> np.ndarray:
    return np.round(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


def _depth_u16(depth: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(np.round(depth.astype(np.float64) * scale), 0, 65535).astype(np.uint16)


def _read_back(rgb_u8, depth_u16, scale, depth_cut, pose, k) -> RGBDFrame:
    d = depth_u16.astype(np.float32) / scale
    d[d > depth_cut] = 0.0
    return RGBDFrame(rgb=rgb_u8.astype(np.float32) / 255.0, depth=d, pose=np.asarray(pose, np.float32),
                     k=np.asarray(k, np.float32))


def _dirs(root: Path, *names: str) -> List[Path]:
    out = []
    for n in names:
        (root / n).mkdir(parents=True, exist_ok=True)
        out.append(root / n)
    return out


def write_hm3dsem(root, frames: Sequence[RGBDFrame], depth_cut: float = 10.0, semantic=None) -> List[RGBDFrame]:
    """rgb/, depth/ (mm), pose/ (the y-up pose inv(Y_UP_TO_Z_UP) @ pose) and,
    given `semantic` (a list of (H, W) non-negative ids), semantic/ as
    uint16.  The frames' K must be ``hm3dsem_k`` of their size."""
    root = Path(root)
    rgb_d, dep_d, pose_d = _dirs(root, "rgb", "depth", "pose")
    out = []
    for i, f in enumerate(frames):
        h, w = f.depth.shape
        if not np.array_equal(np.asarray(f.k, np.float32), hm3dsem_k(h, w)):
            raise ValueError("HM3DSem frames must be rendered with the loader's K (f = W/2)")
        c, d = _rgb_u8(f.rgb), _depth_u16(f.depth, HM3DSEM_SCALE)
        _save_image(rgb_d / f"{i:06d}.png", c)
        _save_image(dep_d / f"{i:06d}.png", d)
        np.savetxt(pose_d / f"{i:06d}.txt", Y_UP_TO_Z_UP.T @ np.asarray(f.pose, np.float64))
        out.append(_read_back(c, d, HM3DSEM_SCALE, depth_cut, f.pose, f.k))
    if semantic is not None:
        (sem_d,) = _dirs(root, "semantic")
        for i, s in enumerate(semantic):
            _save_image(sem_d / f"{i:06d}.png", np.asarray(s).astype(np.uint16))
    return out


def write_replica(root, frames: Sequence[RGBDFrame], depth_cut: float = 10.0,
                  cam_params: bool = True) -> List[RGBDFrame]:
    """traj.txt, results/frame<i>.png and results/depth<i>.png at 6553.5 a
    metre, and (with `cam_params`) cam_params.json; without it the frames'
    K must be the loader's 1200x680 default."""
    root = Path(root)
    (res,) = _dirs(root, "results")
    k = np.asarray(frames[0].k, np.float32)
    if not cam_params and not np.array_equal(k, REPLICA_DEFAULT_K):
        raise ValueError("without cam_params.json the frames' K must be the loader's default")
    if cam_params:
        cam = {"fx": float(k[0, 0]), "fy": float(k[1, 1]), "cx": float(k[0, 2]), "cy": float(k[1, 2]),
               "scale": REPLICA_SCALE}
        (root / "cam_params.json").write_text(json.dumps({"camera": cam}))
    np.savetxt(root / "traj.txt", np.stack([np.asarray(f.pose, np.float64).reshape(-1) for f in frames]))
    out = []
    for i, f in enumerate(frames):
        c, d = _rgb_u8(f.rgb), _depth_u16(f.depth, REPLICA_SCALE)
        _save_image(res / f"frame{i:06d}.png", c)
        _save_image(res / f"depth{i:06d}.png", d)
        out.append(_read_back(c, d, REPLICA_SCALE, depth_cut, f.pose, k))
    return out


def write_horizon(root, frames: Sequence[RGBDFrame], depth_cut: float = 10.0, t0: float = 1.5, dt: float = 0.1,
                  trajectory: str = "poses") -> List[RGBDFrame]:
    """d435i.yaml (Camera1.*), depth/ (mm), and either poses.txt (TUM xyzw
    rows of the world-to-camera pose) with float-timestamp images/{t:.4f}.png,
    or (`trajectory` "CameraTrajectory") CameraTrajectory.txt (wxyz rows of
    the camera-to-world pose) with integer-timestamp color/{t:05d}.png."""
    root = Path(root)
    float_ts = trajectory == "poses"
    img_d, dep_d = _dirs(root, "images" if float_ts else "color", "depth")
    k = np.asarray(frames[0].k, np.float32)
    (root / "d435i.yaml").write_text(
        "%YAML 1.1\n---\n# camera intrinsics\n"
        f"Camera1.fx: {float(k[0, 0])!r}\nCamera1.fy: {float(k[1, 1])!r}\n"
        f"Camera1.cx: {float(k[0, 2])!r}\nCamera1.cy: {float(k[1, 2])!r}\n"
        f"Camera.width: {frames[0].depth.shape[1]}\nCamera.height: {frames[0].depth.shape[0]}\nCamera.fps: 30\n")
    rows, out = [], []
    for i, f in enumerate(frames):
        pose = np.asarray(f.pose, np.float64)
        if float_ts:
            t = f"{t0 + dt * i:.4f}"
            w2c = np.linalg.inv(pose)
            q = matrix_to_quat(w2c[:3, :3])
            rows.append(" ".join([t] + [repr(float(x)) for x in (*w2c[:3, 3], *q)]))
            name = f"{t}.png"
        else:
            t = str(i)
            q = matrix_to_quat(pose[:3, :3])
            rows.append(" ".join([t] + [repr(float(x)) for x in (*pose[:3, 3], q[3], q[0], q[1], q[2])]))
            name = f"{i:05d}.png"
        c, d = _rgb_u8(f.rgb), _depth_u16(f.depth, MM_SCALE)
        _save_image(img_d / name, c)
        _save_image(dep_d / name, d)
        out.append(_read_back(c, d, MM_SCALE, depth_cut, f.pose, k))
    (root / ("poses.txt" if float_ts else "CameraTrajectory.txt")).write_text("\n".join(rows) + "\n")
    return out


def write_scannet(root, frames: Sequence[RGBDFrame], depth_cut: float = 3.0, ext: str = "png") -> List[RGBDFrame]:
    """intrinsic/intrinsic_depth.txt (4x4), color/<i>.<ext>, depth/<i>.png
    (mm) and pose/<i>.txt (4x4 camera-to-world)."""
    root = Path(root)
    intr_d, col_d, dep_d, pose_d = _dirs(root, "intrinsic", "color", "depth", "pose")
    k4 = np.eye(4)
    k4[:3, :3] = np.asarray(frames[0].k, np.float64)
    np.savetxt(intr_d / "intrinsic_depth.txt", k4)
    out = []
    for i, f in enumerate(frames):
        c, d = _rgb_u8(f.rgb), _depth_u16(f.depth, MM_SCALE)
        _save_image(dep_d / f"{i:06d}.png", d)
        np.savetxt(pose_d / f"{i:06d}.txt", np.asarray(f.pose, np.float64))
        _save_image(col_d / f"{i:06d}.{ext}", c)
        if ext != "png":  # lossy: read back what was stored
            from PIL import Image

            c = np.asarray(Image.open(col_d / f"{i:06d}.{ext}").convert("RGB"))
        out.append(_read_back(c, d, MM_SCALE, depth_cut, f.pose, f.k))
    return out


def write_iphone(root, frames: Sequence[RGBDFrame], depth_cut: float = 5.0) -> List[RGBDFrame]:
    """camera_matrix.csv, odometry.csv (header, then ts, frame, x, y, z, qx,
    qy, qz, qw of the camera-to-world pose), rgb/ and depth/ (mm)."""
    root = Path(root)
    rgb_d, dep_d = _dirs(root, "rgb", "depth")
    k = np.asarray(frames[0].k, np.float32)
    np.savetxt(root / "camera_matrix.csv", k.astype(np.float64), delimiter=",")
    rows, out = ["timestamp, frame, x, y, z, qx, qy, qz, qw"], []
    for i, f in enumerate(frames):
        pose = np.asarray(f.pose, np.float64)
        q = matrix_to_quat(pose[:3, :3])
        rows.append(", ".join([repr(0.1 * i), str(i)] + [repr(float(x)) for x in (*pose[:3, 3], *q)]))
        c, d = _rgb_u8(f.rgb), _depth_u16(f.depth, MM_SCALE)
        _save_image(rgb_d / f"{i:06d}.png", c)
        _save_image(dep_d / f"{i:06d}.png", d)
        out.append(_read_back(c, d, MM_SCALE, depth_cut, f.pose, k))
    (root / "odometry.csv").write_text("\n".join(rows) + "\n")
    return out
