"""HM3DSem walk loader: frames emitted by the Habitat walk generator (the
port's own copy of holoagent_tpu/dataloader/hm3dsem.py).

Layout:
  <root>/<scene>/
    rgb/<i>.png  depth/<i>.png  pose/<i>.txt  [semantic/<i>.png]
Intrinsics derive from the 90-degree HFOV pinhole Habitat renders with
(f = W / 2).  Habitat's world is y-up; poses are rotated into this
framework's z-up (``Y_UP_TO_Z_UP @ pose``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .formats import Y_UP_TO_Z_UP, load_depth_m, load_image01, load_matrix_pose, sorted_files
from .generic import RGBDFrame


class HM3DSemDataset:
    def __init__(self, root_dir: str, scene_id: str = "", depth_cut: float = 10.0):
        root = Path(root_dir)
        if scene_id and (root / scene_id).exists():
            root = root / scene_id
        self.root = root
        self.depth_cut = depth_cut
        self.scale = 1000.0
        self.image_paths = sorted_files(root / "rgb")
        self.depth_paths = sorted_files(root / "depth")
        self.pose_paths = sorted((root / "pose").iterdir())
        self.semantic_paths = sorted_files(root / "semantic") or None
        probe = load_image01(self.image_paths[0])
        h, w = probe.shape[:2]
        f = w / 2.0  # 90-degree horizontal FOV
        self.k = np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]], np.float32)
        self.frameId2imgPath = [str(p) for p in self.image_paths]

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> RGBDFrame:
        pose = Y_UP_TO_Z_UP @ load_matrix_pose(self.pose_paths[idx])
        return RGBDFrame(
            rgb=load_image01(self.image_paths[idx]),
            depth=load_depth_m(self.depth_paths[idx], self.scale, self.depth_cut),
            pose=pose.astype(np.float32),
            k=self.k,
        )

    def semantic(self, idx: int) -> np.ndarray:
        """(H, W) int32 semantic instance ids (for GT graph generation)."""
        from PIL import Image

        return np.asarray(Image.open(self.semantic_paths[idx]), np.int32)
