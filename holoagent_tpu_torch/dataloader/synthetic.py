"""Procedural posed-RGBD scene renderer (the port's own copy of
holoagent_tpu/dataloader/synthetic.py; jax-free, numpy only).

The reference regenerates datasets by replaying stored poses through
Habitat-Sim (reference env/sim/habitat_sim/hm3dsem/gen_hm3dsem_walks_from_poses.py:15-100).
We go one step further: a fully procedural multi-room scene (floor slabs,
walls, axis-aligned furniture boxes with labels) ray-cast into exact RGB-D
frames, so mapping/graph/eval tests run with pixel-perfect ground truth and
zero external data.

Conventions: world z-up; camera x-right / y-down / z-forward (OpenCV), pose =
camera-to-world.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .generic import RGBDFrame


@dataclass
class Box:
    """Axis-aligned labelled box (a piece of 'furniture')."""

    center: Tuple[float, float, float]
    size: Tuple[float, float, float]
    color: Tuple[float, float, float]
    label: str
    instance_id: int = -1

    @property
    def lo(self):
        return np.asarray(self.center) - np.asarray(self.size) / 2

    @property
    def hi(self):
        return np.asarray(self.center) + np.asarray(self.size) / 2


@dataclass
class SyntheticScene:
    """A rectangular multi-room building with labelled boxes.

    rooms: list of (x0, y0, x1, y1) rectangles on the floor plane; walls are
    erected on room boundaries with door gaps.  Multi-storey scenes list the
    extra storeys' base heights in ``upper_levels`` (each gets its own floor
    slab, outer walls, and ``wall_segments_by_level`` partitions); level 0 is
    the (floor_z, wall_segments) pair, matching the single-storey default.
    """

    extent: Tuple[float, float] = (8.0, 6.0)  # total footprint (x, y)
    wall_height: float = 2.5
    floor_z: float = 0.0
    boxes: List[Box] = field(default_factory=list)
    wall_segments: List[Tuple[float, float, float, float]] = field(default_factory=list)
    wall_thickness: float = 0.08
    upper_levels: List[float] = field(default_factory=list)  # base z per extra storey
    wall_segments_by_level: List[List[Tuple[float, float, float, float]]] = field(
        default_factory=list
    )  # inner partitions per extra storey (parallel to upper_levels)

    def level_zs(self) -> List[float]:
        """Base height of every storey, ascending (level 0 first)."""
        return [self.floor_z, *self.upper_levels]

    @staticmethod
    def two_room(seed: int = 0) -> "SyntheticScene":
        """Standard fixture: two rooms divided by a wall with a door, six
        labelled furniture boxes."""
        rng = np.random.default_rng(seed)
        sc = SyntheticScene()
        w, h = sc.extent
        # dividing wall at x=4 with a door gap y in [2.4, 3.6]
        sc.wall_segments = [
            (w / 2, 0.0, w / 2, 2.4),
            (w / 2, 3.6, w / 2, h),
        ]
        defs = [
            ("bed", (1.6, 2.0, 0.5), (0.8, 0.15, 0.15), (1.2, 1.6)),
            ("chair", (0.5, 0.5, 0.9), (0.15, 0.35, 0.85), (2.8, 4.6)),
            ("table", (1.2, 0.8, 0.75), (0.6, 0.4, 0.1), (2.2, 3.0)),
            ("sofa", (1.8, 0.8, 0.8), (0.15, 0.7, 0.25), (6.0, 1.2)),
            ("refrigerator", (0.7, 0.7, 1.8), (1.0, 1.0, 1.0), (7.4, 5.2)),
            ("toilet", (0.5, 0.6, 0.8), (0.1, 0.8, 0.8), (5.0, 5.2)),
        ]
        for i, (label, size, color, (cx, cy)) in enumerate(defs):
            sc.boxes.append(
                Box(
                    center=(cx, cy, sc.floor_z + size[2] / 2),
                    size=size,
                    color=color,
                    label=label,
                    instance_id=i,
                )
            )
        return sc

    @staticmethod
    def three_room(seed: int = 0) -> "SyntheticScene":
        """Harder fixture: 12x6 m, three rooms in a row (two dividing walls
        with offset door gaps), seven labelled furniture boxes."""
        sc = SyntheticScene()
        sc.extent = (12.0, 6.0)
        w, h = sc.extent
        sc.wall_segments = [
            (4.0, 0.0, 4.0, 2.0), (4.0, 3.2, 4.0, h),      # door y in [2.0, 3.2]
            (8.0, 0.0, 8.0, 3.0), (8.0, 4.2, 8.0, h),      # door y in [3.0, 4.2]
        ]
        defs = [
            ("bed", (1.6, 2.0, 0.5), (0.8, 0.15, 0.15), (1.4, 1.8)),
            ("chair", (0.5, 0.5, 0.9), (0.15, 0.35, 0.85), (2.8, 4.6)),
            ("table", (1.2, 0.8, 0.75), (0.6, 0.4, 0.1), (6.0, 1.6)),
            ("sofa", (1.8, 0.8, 0.8), (0.15, 0.7, 0.25), (6.2, 4.8)),
            ("refrigerator", (0.7, 0.7, 1.8), (1.0, 1.0, 1.0), (11.2, 5.0)),
            ("toilet", (0.5, 0.6, 0.8), (0.1, 0.8, 0.8), (9.2, 5.0)),
            ("bathtub", (1.5, 0.7, 0.6), (0.85, 0.4, 0.75), (10.6, 1.0)),
        ]
        for i, (label, size, color, (cx, cy)) in enumerate(defs):
            sc.boxes.append(
                Box(
                    center=(cx, cy, sc.floor_z + size[2] / 2),
                    size=size,
                    color=color,
                    label=label,
                    instance_id=i,
                )
            )
        return sc

    # two_floor furniture vocabulary: distinct colors so the fixture-trained
    # CLIP tower can separate categories; footprints capped so the greedy
    # strip placer below fits 3 items per 4 m strip with clearance
    _TWO_FLOOR_SIZES = {
        "bed": (1.4, 1.4, 0.5), "chair": (0.5, 0.5, 0.9),
        "table": (1.1, 0.8, 0.75), "sofa": (1.3, 0.8, 0.8),
        "refrigerator": (0.7, 0.7, 1.8), "toilet": (0.5, 0.6, 0.8),
        "bathtub": (1.3, 0.7, 0.6), "lamp": (0.3, 0.3, 1.5),
        "plant": (0.4, 0.4, 1.0), "tv": (1.1, 0.2, 0.7),
        "desk": (1.2, 0.7, 0.75), "bookshelf": (1.0, 0.35, 1.9),
        "mirror": (0.9, 0.12, 1.2), "bench": (1.0, 0.4, 0.45),
        "wardrobe": (1.0, 0.55, 1.9), "piano": (1.2, 0.6, 1.1),
        "sink": (0.5, 0.45, 0.85), "oven": (0.6, 0.6, 0.9),
    }
    # palette contract: every pairwise color distance (incl. vs the wall
    # 0.85,0.82,0.78 and floor 0.55,0.50,0.45) is >= 0.26 in RGB — the
    # fixture towers separate categories by color, and the original palette's
    # white cluster (refrigerator/toilet/bathtub/mirror/sink within 0.11-0.19
    # of each other AND of the walls) capped zero-shot top-1 at ~0.65
    # (measured round 4; tests/test_synthetic.py guards the invariant)
    _TWO_FLOOR_COLORS = {
        "bed": (0.80, 0.15, 0.15), "chair": (0.15, 0.35, 0.85),
        "table": (0.60, 0.40, 0.10), "sofa": (0.15, 0.70, 0.25),
        "refrigerator": (1.00, 1.00, 1.00), "toilet": (0.10, 0.80, 0.80),
        "bathtub": (0.85, 0.40, 0.75), "lamp": (1.00, 0.85, 0.15),
        "plant": (0.05, 0.45, 0.05), "tv": (0.03, 0.03, 0.08),
        "desk": (0.35, 0.18, 0.03), "bookshelf": (0.65, 0.10, 0.60),
        "mirror": (0.55, 0.85, 0.95), "bench": (0.78, 0.62, 0.38),
        "wardrobe": (0.28, 0.08, 0.45), "piano": (0.95, 0.50, 0.05),
        "sink": (0.25, 0.62, 0.55), "oven": (0.50, 0.05, 0.30),
    }
    # room categories and their 9 object categories per (floor, bay):
    # 6 rooms x 9 objects = 54 unique (object, room, floor) long-query keys
    # (>= 50, the 2-floor long-query benchmark scene)
    _TWO_FLOOR_ROOMS = (
        (0, 0, "bedroom", ("bed", "chair", "wardrobe", "lamp", "plant",
                           "mirror", "bench", "table", "tv")),
        (0, 1, "living room", ("sofa", "tv", "table", "plant", "lamp",
                               "piano", "bookshelf", "chair", "bench")),
        (0, 2, "kitchen", ("refrigerator", "sink", "oven", "table", "chair",
                           "plant", "lamp", "bench", "mirror")),
        (1, 0, "office", ("desk", "chair", "bookshelf", "lamp", "tv",
                          "plant", "sofa", "mirror", "wardrobe")),
        (1, 1, "library", ("bookshelf", "desk", "chair", "sofa", "lamp",
                           "plant", "piano", "bench", "tv")),
        (1, 2, "bathroom", ("toilet", "bathtub", "sink", "mirror", "wardrobe",
                            "lamp", "plant", "bench", "chair")),
    )

    @staticmethod
    def two_floor(seed: int = 0) -> "SyntheticScene":
        """Two-storey fixture: 12 x 6 m, 3 rooms per storey (6 room
        categories), 9 labelled furniture boxes per room over an 18-category
        vocabulary — the >= 2-floor, >= 50-long-query benchmark scene
        (reference long-query generation walks exactly these GT tree leaves,
        reference fsr_vln/memory/hmsg/utils/long_query_eval_utils.py:72-147).

        Placement keeps the orbit-camera band (room-bay center +- 1.3 m at
        eye height) clear: the 3 shallowest items per room sit in side bands
        along the bay's x-edges; the other 6 fill two wall strips (y = 0.75 /
        5.25) via a greedy left-to-right placer, widest first, alternating
        strips — non-overlap by construction."""
        sc = SyntheticScene()
        sc.extent = (12.0, 6.0)
        h = sc.extent[1]
        sc.upper_levels = [3.0]
        # storey 0 partitions (door gaps offset per wall)
        sc.wall_segments = [
            (4.0, 0.0, 4.0, 2.0), (4.0, 3.2, 4.0, h),
            (8.0, 0.0, 8.0, 3.0), (8.0, 4.2, 8.0, h),
        ]
        # storey 1 partitions (gaps at different y)
        sc.wall_segments_by_level = [[
            (4.0, 0.0, 4.0, 2.6), (4.0, 3.8, 4.0, h),
            (8.0, 0.0, 8.0, 1.6), (8.0, 2.8, 8.0, h),
        ]]
        sizes, colors = SyntheticScene._TWO_FLOOR_SIZES, SyntheticScene._TWO_FLOOR_COLORS
        iid = 0
        for floor_id, bay, _room_cat, objs in SyntheticScene._TWO_FLOOR_ROOMS:
            z0 = sc.level_zs()[floor_id]
            x_off = bay * 4.0
            # side bands: the 3 shallowest (depth <= 0.5) items, long axis
            # along the wall, at x = 0.4 / 3.6
            shallow = sorted(objs, key=lambda o: sizes[o][1])[:3]
            strip_items = [o for o in objs if o not in shallow]
            side_slots = ((0.4, 2.0), (0.4, 4.0), (3.6, 3.0))
            for (sx0, sy0), label in zip(side_slots, shallow):
                w_, d_, hz = sizes[label]
                sc.boxes.append(Box(
                    center=(x_off + sx0, sy0, z0 + hz / 2),
                    size=(d_, w_, hz),  # long axis along the wall (y)
                    color=colors[label], label=label, instance_id=iid,
                ))
                iid += 1
            # two strips, widest-first alternating, left-to-right cursor
            order = sorted(strip_items, key=lambda o: -sizes[o][0])
            cursors = [0.2, 0.2]
            ys = (0.75, 5.25)
            for j, label in enumerate(order):
                s = j % 2
                w_, d_, hz = sizes[label]
                cx = cursors[s] + w_ / 2
                cursors[s] += w_ + 0.12
                sc.boxes.append(Box(
                    center=(x_off + cx, ys[s], z0 + hz / 2),
                    size=(w_, d_, hz),
                    color=colors[label], label=label, instance_id=iid,
                ))
                iid += 1
        return sc

    @staticmethod
    def two_floor_room_rects():
        """GT room footprints for ``two_floor`` as
        (x0, y0, x1, y1, category, floor_id) tuples (eval.gt_from_synthetic)."""
        return [
            (bay * 4.0, 0.0, bay * 4.0 + 4.0, 6.0, cat, floor_id)
            for floor_id, bay, cat, _ in SyntheticScene._TWO_FLOOR_ROOMS
        ]

    # -- ray casting --------------------------------------------------------

    def _all_boxes(self) -> List[Box]:
        """Scene geometry as boxes: furniture + per-storey outer walls, inner
        walls and floor slabs (each storey stays ceiling-less for top-down
        debug friendliness; an upper storey's slab doubles as the storey
        below's ceiling)."""
        w, h = self.extent
        t = self.wall_thickness
        geo: List[Box] = list(self.boxes)
        wall_color = (0.85, 0.82, 0.78)
        segs_by_level = [list(self.wall_segments), *self.wall_segments_by_level]
        for li, z0 in enumerate(self.level_zs()):
            z = self.wall_height
            zc = z0 + z / 2
            # outer walls
            for (cx, cy, sx, sy) in [
                (w / 2, -t / 2, w + 2 * t, t),
                (w / 2, h + t / 2, w + 2 * t, t),
                (-t / 2, h / 2, t, h + 2 * t),
                (w + t / 2, h / 2, t, h + 2 * t),
            ]:
                geo.append(Box((cx, cy, zc), (sx, sy, z), wall_color, "wall"))
            # inner wall segments for this storey
            for (x0, y0, x1, y1) in (segs_by_level[li] if li < len(segs_by_level) else []):
                cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
                sx = max(abs(x1 - x0), t)
                sy = max(abs(y1 - y0), t)
                geo.append(Box((cx, cy, zc), (sx, sy, z), wall_color, "wall"))
            # floor slab
            geo.append(
                Box(
                    (w / 2, h / 2, z0 - 0.05),
                    (w + 2 * t, h + 2 * t, 0.1),
                    (0.55, 0.5, 0.45),
                    "floor",
                )
            )
        return geo

    def render(
        self, pose_c2w: np.ndarray, k: np.ndarray, hw: Tuple[int, int] = (120, 160)
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Ray-cast one frame. Returns (rgb (H,W,3) f32, depth (H,W) f32,
        instance (H,W) int32 [-1 = background/structure], label_img (H,W) int32
        index into `self.labels()`)."""
        H, W = hw
        fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        dirs_cam = np.stack(
            [(u - cx) / fx, (v - cy) / fy, np.ones_like(u, np.float64)], axis=-1
        )
        r = pose_c2w[:3, :3]
        o = pose_c2w[:3, 3]
        dirs = dirs_cam @ r.T  # (H, W, 3)
        geo = self._all_boxes()
        labels = self.labels()
        tbest = np.full((H, W), np.inf)
        rgb = np.zeros((H, W, 3), np.float32)
        inst = np.full((H, W), -1, np.int32)
        labimg = np.full((H, W), -1, np.int32)
        eps = 1e-12
        inv = 1.0 / np.where(np.abs(dirs) < eps, eps, dirs)
        # the slab test one axis at a time: the same float64 products and an
        # exact max/min as a reduction over the size-3 last axis, which
        # numpy runs about 4x slower
        inv_axes = [np.ascontiguousarray(inv[..., i]) for i in range(3)]
        for b in geo:
            lo, hi = b.lo - o, b.hi - o
            t0, t1 = lo[0] * inv_axes[0], hi[0] * inv_axes[0]
            tmin, tmax = np.minimum(t0, t1), np.maximum(t0, t1)
            for i in (1, 2):
                t0, t1 = lo[i] * inv_axes[i], hi[i] * inv_axes[i]
                tmin = np.maximum(tmin, np.minimum(t0, t1))
                tmax = np.minimum(tmax, np.maximum(t0, t1))
            hit = (tmax > np.maximum(tmin, 1e-4)) & (tmin > 1e-4) & (tmin < tbest)
            tbest = np.where(hit, tmin, tbest)
            rgb[hit] = b.color
            inst[hit] = b.instance_id
            labimg[hit] = labels.index(b.label)
        # z-depth (not ray length): project hit point into camera z
        zdir = dirs_cam[..., 2] / np.linalg.norm(dirs_cam, axis=-1)
        depth = np.where(np.isfinite(tbest), tbest, 0.0)  # dirs_cam z==1 -> t is z-depth
        # simple shading so CLIP sees texture: modulate by height + noise-free grid
        shade = 0.75 + 0.25 * np.cos(depth * 3.0)
        rgb = np.clip(rgb * shade[..., None], 0, 1).astype(np.float32)
        return rgb, depth.astype(np.float32), inst, labimg

    def labels(self) -> List[str]:
        seen: List[str] = []
        for b in self.boxes:
            if b.label not in seen:
                seen.append(b.label)
        for s in ("wall", "floor"):
            if s not in seen:
                seen.append(s)
        return seen


def look_at(eye, target, up=(0, 0, 1.0)) -> np.ndarray:
    """Camera-to-world pose for an OpenCV camera looking from eye to target."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose.astype(np.float32)


class SyntheticDataset:
    """Orbit trajectory through a SyntheticScene; RGBDDataset-compatible.

    Keeps per-frame GT (instance/label images) for the evaluator."""

    def __init__(
        self,
        scene: Optional[SyntheticScene] = None,
        num_frames: int = 24,
        hw: Tuple[int, int] = (120, 160),
        seed: int = 0,
        gaze_heights: Tuple[float, ...] = (0.8,),
    ):
        self.scene = scene or SyntheticScene.two_room(seed)
        self.hw = hw
        H, W = hw
        f = 0.9 * W
        self.k = np.array([[f, 0, W / 2 - 0.5], [0, f, H / 2 - 0.5], [0, 0, 1]], np.float32)
        w, h = self.scene.extent
        self.poses = []
        # two loops, one per room, looking inward from near the walls.
        # gaze_heights cycles the target z per frame ((0.8, 2.0) sweeps the
        # upper walls into view — full-scan coverage like the reference's
        # Habitat walks); seed phase-shifts the orbit so trajectories differ.
        # one orbit loop per ~4 m of footprint width (two_room keeps its
        # original two centers; wider scenes get a loop per room bay);
        # multi-storey scenes repeat the loop set per storey at that storey's
        # eye height (the reference's per-floor Habitat walks)
        n_loops = max(2, round(w / 4.0))
        centers = [((i + 0.5) * w / n_loops, h * 0.5) for i in range(n_loops)]
        level_zs = self.scene.level_zs()
        per = max(1, num_frames // (len(centers) * len(level_zs)))
        for z0 in level_zs:
            for cx0, cy0 in centers:
                for i in range(per):
                    a = 2 * np.pi * i / per + 0.37 * seed
                    eye = (cx0 + 1.3 * np.cos(a), cy0 + 1.3 * np.sin(a), z0 + 1.5)
                    target = (cx0, cy0, z0 + gaze_heights[i % len(gaze_heights)])
                    self.poses.append(look_at(eye, target))
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self.poses)

    def __getitem__(self, idx: int) -> RGBDFrame:
        rgb, depth, _, _ = self._render(idx)
        return RGBDFrame(rgb=rgb, depth=depth, pose=self.poses[idx], k=self.k)

    def _render(self, idx: int):
        if idx not in self._cache:
            self._cache[idx] = self.scene.render(
                self.poses[idx].astype(np.float64), self.k, self.hw
            )
        return self._cache[idx]

    def gt(self, idx: int):
        """(instance (H,W) int32, label (H,W) int32) ground truth."""
        _, _, inst, lab = self._render(idx)
        return inst, lab

    def save_poses(self, path) -> None:
        """Persist the trajectory as one flattened 4x4 per line — the stored
        walk format the reference replays through Habitat
        (reference env/sim/habitat_sim/hm3dsem/gen_hm3dsem_walks_from_poses.py
        + metadata/poses/*.txt)."""
        np.savetxt(path, np.stack([p.reshape(-1) for p in self.poses]))

    @staticmethod
    def from_pose_file(
        path, scene: Optional[SyntheticScene] = None, hw: Tuple[int, int] = (120, 160)
    ) -> "SyntheticDataset":
        """Deterministic walk replay: re-render a stored trajectory (the
        multi-run regeneration strategy of SURVEY.md §4.3, hermetic)."""
        ds = SyntheticDataset(scene=scene, num_frames=2, hw=hw)
        ds.poses = [p.reshape(4, 4).astype(np.float32) for p in np.loadtxt(path)]
        ds._cache = {}
        return ds
