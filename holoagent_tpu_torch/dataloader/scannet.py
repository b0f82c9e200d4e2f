"""ScanNet v2 scene loader (the port's own copy of
holoagent_tpu/dataloader/scannet.py).

Layout:
  <root>/<scene>/
    intrinsic/intrinsic_depth.txt   4x4 (top-left 3x3 used)
    color/<i>.jpg|png  depth/<i>.png  pose/<i>.txt (4x4 cam-to-world)
ScanNet's world frame is z-up already.  The three lists are cut to the
shortest of them."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .formats import load_depth_m, load_image01, load_matrix_pose, sorted_files
from .generic import RGBDFrame


class ScannetDataset:
    def __init__(self, root_dir: str, scene_id: str = "", depth_cut: float = 3.0):
        root = Path(root_dir)
        if scene_id and (root / scene_id).exists():
            root = root / scene_id
        self.root = root
        self.depth_cut = depth_cut
        self.scale = 1000.0
        self.k = np.loadtxt(root / "intrinsic" / "intrinsic_depth.txt").reshape(4, 4)[
            :3, :3
        ].astype(np.float32)
        self.image_paths = sorted_files(root / "color")
        self.depth_paths = sorted_files(root / "depth")
        self.pose_paths = sorted((root / "pose").iterdir()) if (root / "pose").exists() else []
        n = min(len(self.image_paths), len(self.depth_paths), len(self.pose_paths))
        self.image_paths, self.depth_paths, self.pose_paths = (
            self.image_paths[:n], self.depth_paths[:n], self.pose_paths[:n],
        )
        self.frameId2imgPath = [str(p) for p in self.image_paths]

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> RGBDFrame:
        return RGBDFrame(
            rgb=load_image01(self.image_paths[idx]),
            depth=load_depth_m(self.depth_paths[idx], self.scale, self.depth_cut),
            pose=load_matrix_pose(self.pose_paths[idx]).astype(np.float32),
            k=self.k,
        )
