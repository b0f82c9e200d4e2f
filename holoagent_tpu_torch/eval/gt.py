"""Ground-truth scene graphs for evaluation.

The reference's evaluator imports a module that builds the GT graph, which
is missing from its repo (reference fsr_vln/memory/hmsg/eval/hm3dsem_evaluator.py:15 imports
`hmsg.data.hm3dsem.create_hm3dsem_walks_gt` — missing upstream, SURVEY.md §4).
This module supplies the capability: a typed GT graph (levels -> regions ->
objects, the schema of hm3dsem_evaluator.py:108-188), loadable from the same
scene_info JSON layout, and constructible directly from the procedural
synthetic scene so evaluation runs hermetically.

The port's own copy of holoagent_tpu/eval/gt.py (numpy; PLY through the
port's utils/ply.py, which writes the same bytes).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


@dataclass
class GTFloor:
    id: int
    lower: float
    upper: float


@dataclass
class GTRoom:
    id: int
    floor_id: int
    category: str
    bev_points: np.ndarray  # (N, 2) footprint points
    min_height: float
    max_height: float

    @property
    def mean_height(self) -> float:
        return (self.min_height + self.max_height) / 2


@dataclass
class GTObject:
    id: int
    region_id: int
    floor_id: int
    category: str
    points: np.ndarray  # (N, 3)
    center: np.ndarray  # (3,)
    dims: np.ndarray  # (3,)


@dataclass
class GTGraph:
    floors: List[GTFloor] = field(default_factory=list)
    rooms: List[GTRoom] = field(default_factory=list)
    objects: List[GTObject] = field(default_factory=list)

    @staticmethod
    def from_json(path: str | Path) -> "GTGraph":
        """Load the reference scene_info layout (levels/regions/objects)."""
        info = json.loads(Path(path).read_text())
        g = GTGraph()
        for lv in info["levels"]:
            g.floors.append(GTFloor(int(lv["id"]), lv["lower"], lv["upper"]))
        for r in info["regions"]:
            g.rooms.append(
                GTRoom(
                    int(r["id"]),
                    int(r["floor_id"]),
                    r.get("voted_category") or r.get("category", "room"),
                    np.asarray(r["bev_region_points"], np.float64)[:, :2],
                    r["min_height"],
                    r["max_height"],
                )
            )
        base = Path(path).parent
        for o in info["objects"]:
            pts = np.zeros((0, 3))
            ply = base / "objects" / f"{o['id']}.ply"
            if ply.exists():
                from ..utils.ply import read_ply

                pts, _ = read_ply(ply)
            g.objects.append(
                GTObject(
                    int(o["id"]),
                    int(o["region_id"]),
                    int(o["floor_id"]),
                    o["category"],
                    pts,
                    np.asarray(o["aabb_center"], np.float64),
                    np.asarray(o["aabb_dims"], np.float64),
                )
            )
        return g

    def to_json(self, path: str | Path, save_object_plys: bool = True) -> None:
        """Write the scene_info layout (round-trips with from_json)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        info = {
            "levels": [
                {
                    "id": f.id,
                    "lower": f.lower,
                    "upper": f.upper,
                    "regions": [r.id for r in self.rooms if r.floor_id == f.id],
                    "objects": [o.id for o in self.objects if o.floor_id == f.id],
                }
                for f in self.floors
            ],
            "regions": [
                {
                    "id": r.id,
                    "floor_id": r.floor_id,
                    "category": r.category,
                    "voted_category": r.category,
                    "min_height": r.min_height,
                    "max_height": r.max_height,
                    "mean_height": r.mean_height,
                    "bev_region_points": np.c_[
                        r.bev_points, np.zeros(len(r.bev_points))
                    ].tolist(),
                    "objects": [o.id for o in self.objects if o.region_id == r.id],
                }
                for r in self.rooms
            ],
            "objects": [
                {
                    "id": o.id,
                    "region_id": o.region_id,
                    "floor_id": o.floor_id,
                    "category": o.category,
                    "hex": "",
                    "aabb_center": np.asarray(o.center).tolist(),
                    "aabb_dims": np.asarray(o.dims).tolist(),
                    "obb_center": np.asarray(o.center).tolist(),
                    "obb_dims": np.asarray(o.dims).tolist(),
                    "obb_rotation": np.eye(3).tolist(),
                    "obb_local_to_world": np.eye(4).tolist(),
                    "obb_world_to_local": np.eye(4).tolist(),
                    "obb_volume": float(np.prod(o.dims)),
                    "obb_half_extents": (np.asarray(o.dims) / 2).tolist(),
                }
                for o in self.objects
            ],
        }
        Path(path).write_text(json.dumps(info))
        if save_object_plys:
            from ..utils.ply import write_ply

            objdir = path.parent / "objects"
            objdir.mkdir(exist_ok=True)
            for o in self.objects:
                if len(o.points):
                    write_ply(objdir / f"{o.id}.ply", o.points)


def _box_surface_points(lo: np.ndarray, hi: np.ndarray, step: float = 0.04) -> np.ndarray:
    """Sample points on the 6 faces of an AABB."""
    pts = []
    xs = np.arange(lo[0], hi[0] + 1e-9, step)
    ys = np.arange(lo[1], hi[1] + 1e-9, step)
    zs = np.arange(lo[2], hi[2] + 1e-9, step)
    gy, gz = np.meshgrid(ys, zs, indexing="ij")
    for x in (lo[0], hi[0]):
        pts.append(np.c_[np.full(gy.size, x), gy.ravel(), gz.ravel()])
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    for y in (lo[1], hi[1]):
        pts.append(np.c_[gx.ravel(), np.full(gx.size, y), gz.ravel()])
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    for z in (lo[2], hi[2]):
        pts.append(np.c_[gx.ravel(), gy.ravel(), np.full(gx.size, z)])
    return np.concatenate(pts)


def gt_from_synthetic(scene, room_rects: Optional[List] = None) -> GTGraph:
    """GT graph for a SyntheticScene. ``room_rects`` optionally overrides room
    footprints as (x0, y0, x1, y1, category) tuples — with an optional 6th
    element naming the floor_id for multi-storey scenes (default floor 0);
    default = the two-room fixture split at the dividing wall."""
    g = GTGraph()
    w, h = scene.extent
    level_zs = scene.level_zs() if hasattr(scene, "level_zs") else [scene.floor_z]
    for fi, z0 in enumerate(level_zs):
        g.floors.append(GTFloor(fi, z0 - 0.1, z0 + scene.wall_height))
    if room_rects is None:
        room_rects = [
            (0.0, 0.0, w / 2, h, "bedroom"),
            (w / 2, 0.0, w, h, "kitchen"),
        ]
    step = 0.1
    for i, rect in enumerate(room_rects):
        x0, y0, x1, y1, cat = rect[:5]
        floor_id = int(rect[5]) if len(rect) > 5 else 0
        xs = np.arange(x0 + step / 2, x1, step)
        ys = np.arange(y0 + step / 2, y1, step)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        g.rooms.append(
            GTRoom(
                i,
                floor_id,
                cat,
                np.c_[gx.ravel(), gy.ravel()],
                level_zs[floor_id],
                level_zs[floor_id] + scene.wall_height,
            )
        )
    for b in scene.boxes:
        lo, hi = b.lo, b.hi
        center = (lo + hi) / 2
        # floor = highest level whose base sits below the object's center
        floor_id = int(
            max((fi for fi, z0 in enumerate(level_zs) if z0 <= center[2] + 1e-6),
                default=0)
        )
        region = next(
            (
                i
                for i, rect in enumerate(room_rects)
                if rect[0] <= center[0] < rect[2]
                and rect[1] <= center[1] < rect[3]
                and (int(rect[5]) if len(rect) > 5 else 0) == floor_id
            ),
            0,
        )
        g.objects.append(
            GTObject(
                b.instance_id,
                region,
                floor_id,
                b.label,
                _box_surface_points(lo, hi),
                center,
                hi - lo,
            )
        )
    return g
