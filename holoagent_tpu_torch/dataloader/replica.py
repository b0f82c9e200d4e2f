"""Replica (nice-slam export) loader (the port's own copy of
holoagent_tpu/dataloader/replica.py).

Layout:
  <root>/<scene>/
    traj.txt                     one flattened 4x4 cam-to-world per line
    results/frame<i>.jpg|png     RGB
    results/depth<i>.png         depth at scale 6553.5/m
    cam_params.json              {"camera": {fx, fy, cx, cy, scale}} (optional;
                                 looked up under the scene, then its parent;
                                 without it the 1200x680 defaults hold)
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .formats import load_depth_m, load_image01
from .generic import RGBDFrame


class ReplicaDataset:
    def __init__(self, root_dir: str, scene_id: str = "", depth_cut: float = 10.0):
        root = Path(root_dir)
        if scene_id and (root / scene_id).exists():
            root = root / scene_id
        self.root = root
        self.depth_cut = depth_cut
        params_file = root / "cam_params.json"
        if not params_file.exists():
            params_file = root.parent / "cam_params.json"
        if params_file.exists():
            cam = json.loads(params_file.read_text())["camera"]
            self.scale = float(cam.get("scale", 6553.5))
            self.k = np.array(
                [[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]],
                np.float32,
            )
        else:  # standard Replica 1200x680 intrinsics
            self.scale = 6553.5
            self.k = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]], np.float32)
        self.poses = np.loadtxt(root / "traj.txt").reshape(-1, 4, 4).astype(np.float32)
        res = root / "results"
        self.image_paths = sorted(res.glob("frame*.jpg")) or sorted(res.glob("frame*.png"))
        self.depth_paths = sorted(res.glob("depth*.png"))
        n = min(len(self.poses), len(self.image_paths), len(self.depth_paths))
        self.poses = self.poses[:n]
        self.image_paths, self.depth_paths = self.image_paths[:n], self.depth_paths[:n]
        self.frameId2imgPath = [str(p) for p in self.image_paths]

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, idx: int) -> RGBDFrame:
        return RGBDFrame(
            rgb=load_image01(self.image_paths[idx]),
            depth=load_depth_m(self.depth_paths[idx], self.scale, self.depth_cut),
            pose=self.poses[idx],
            k=self.k,
        )
