"""iPhone (Record3D-style) capture loader (the port's own copy of
holoagent_tpu/dataloader/iphone.py).

Layout:
  <root>/<scene>/
    rgb/<i>.png (or .jpg)     RGB frames
    depth/<i>.png             depth in millimetres
    odometry.csv              header, then rows: ts, frame, x, y, z, qx, qy, qz, qw
      (or poses.txt TUM cam-to-world)
    camera_matrix.csv         3x3 intrinsics
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .formats import load_depth_m, load_image01, load_tum_poses, quat_to_matrix, sorted_files
from .generic import RGBDFrame


class IPhoneDataset:
    def __init__(self, root_dir: str, scene_id: str = "", depth_cut: float = 5.0):
        root = Path(root_dir)
        if scene_id and (root / scene_id).exists():
            root = root / scene_id
        self.root = root
        self.depth_cut = depth_cut
        self.scale = 1000.0
        self.k = np.loadtxt(root / "camera_matrix.csv", delimiter=",").reshape(3, 3).astype(np.float32)
        if (root / "odometry.csv").exists():
            rows = np.loadtxt(root / "odometry.csv", delimiter=",", skiprows=1)
            poses = []
            for r in rows:
                _, _, x, y, z, qx, qy, qz, qw = r[:9]
                m = np.eye(4)
                m[:3, :3] = quat_to_matrix(qx, qy, qz, qw)
                m[:3, 3] = (x, y, z)
                poses.append(m)
            self.poses = np.stack(poses).astype(np.float32)
        else:
            self.poses = load_tum_poses(root / "poses.txt", "xyzw")[0].astype(np.float32)
        self.image_paths = sorted_files(root / "rgb")
        self.depth_paths = sorted_files(root / "depth")
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
