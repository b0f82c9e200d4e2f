"""Horizon robot dataset: FAST-LIVO2 keyframes recorded by the real robot
(the port's own copy of holoagent_tpu/dataloader/horizon.py).

Layout:
  <root>/<scene>/
    d435i.yaml                camera intrinsics (Camera1.fx/fy/cx/cy or Camera.*)
    poses.txt                 TUM rows (xyzw), world-to-camera (inverted on load)
      (or CameraTrajectory.txt with wxyz quaternions, already cam-to-world)
    images/<ts>.png | color/<id>.png     RGB (float timestamps name
                                         images/{t:.4f}.png, integer ones
                                         color/{int(t):05d}.png)
    depth/<ts>.png                       depth in millimetres

The FAST-LIVO world is already z-up, so poses pass through unchanged.

The intrinsics file is read by ``read_flat_yaml``, not PyYAML (absent on
some hosts): these files hold flat ``key: value`` scalar lines.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Union

import numpy as np

from .formats import load_depth_m, load_image01, load_tum_poses
from .generic import RGBDFrame

Scalar = Union[int, float, bool, str, None]

# YAML 1.1 scalar forms, as PyYAML's safe loader resolves them
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True, "on": True,
         "On": True, "ON": True, "no": False, "No": False, "NO": False, "false": False, "False": False,
         "FALSE": False, "off": False, "Off": False, "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}


def _scalar(text: str) -> Scalar:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def read_flat_yaml(text: str) -> Dict[str, Scalar]:
    """The top-level ``key: value`` scalar lines of a YAML document, typed
    as ``yaml.safe_load`` types them (int, float, bool, null, quoted or
    plain string).  Skips ``%`` directives, ``---`` / ``...`` markers,
    comments, blank lines and indented (nested) lines."""
    out: Dict[str, Scalar] = {}
    for line in text.splitlines():
        if not line.strip() or line[0] in " \t#%" or line.startswith(("---", "...")):
            continue
        key, sep, value = line.partition(":")
        if not sep:
            raise ValueError(f"not a flat key: value line: {line!r}")
        value = re.sub(r"\s+#.*$", "", value).strip()
        out[key.strip()] = _scalar(value)
    return out


class HorizonDataset:
    def __init__(self, root_dir: str, scene_id: str = "", depth_cut: float = 10.0):
        root = Path(root_dir)
        if scene_id and (root / scene_id).exists():
            root = root / scene_id
        self.root = root
        self.depth_cut = depth_cut
        self.scale = 1000.0
        self.k = self._load_intrinsics(root / "d435i.yaml")
        if (root / "poses.txt").exists():
            poses, ts = load_tum_poses(root / "poses.txt", "xyzw", invert=True)
        elif (root / "CameraTrajectory.txt").exists():
            poses, ts = load_tum_poses(root / "CameraTrajectory.txt", "wxyz")
        else:
            raise FileNotFoundError(f"no pose file under {root}")
        self.poses = poses.astype(np.float32)
        if ts and float(int(ts[0])) != ts[0]:
            names = [f"{t:.4f}.png" for t in ts]
            img_dir, dep_dir = root / "images", root / "depth"
        else:
            names = [f"{int(t):05d}.png" for t in ts]
            img_dir, dep_dir = root / "color", root / "depth"
        self.image_paths = [img_dir / n for n in names]
        self.depth_paths = [dep_dir / n for n in names]
        self.frameId2imgPath = [str(p) for p in self.image_paths]

    @staticmethod
    def _load_intrinsics(path: Path) -> np.ndarray:
        cfg = read_flat_yaml(path.read_text())
        k = np.eye(3, dtype=np.float32)
        pre = "Camera1" if "Camera1.fx" in cfg else "Camera"
        k[0, 0] = float(cfg[f"{pre}.fx"])
        k[1, 1] = float(cfg[f"{pre}.fy"])
        k[0, 2] = float(cfg[f"{pre}.cx"])
        k[1, 2] = float(cfg[f"{pre}.cy"])
        return k

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, idx: int) -> RGBDFrame:
        return RGBDFrame(
            rgb=load_image01(self.image_paths[idx]),
            depth=load_depth_m(self.depth_paths[idx], self.scale, self.depth_cut),
            pose=self.poses[idx],
            k=self.k,
        )
