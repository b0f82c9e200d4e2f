"""Hierarchical Multi-modal Scene Graph: build, name, persist, traverse
(counterpart of holoagent_tpu/memory/hmsg.py).

The port runs the raster and k-means math as tensor programs on the mapped
scene's device (``ops.image2d``, ``ops.kmeans``); floors, frame assignment,
object association and naming stay host numpy, as in the reference.  The
node lists are the graph: the port builds no networkx graph (the card
machine has no networkx, and no caller reads one).

The stages follow the reference system's Graph construction path
(reference fsr_vln/memory/hmsg/graph/graph.py:493-2076):

  floors  - up-axis histogram -> smoothed peaks -> clustered boundaries
            (graph.py:624-787 `segment_floors_manually` semantics)
  rooms   - per-floor 2-D occupancy raster -> walls/outside maps -> jump-flood
            distance transform -> Otsu seeds -> watershed (graph.py:920-1189,
            utils/graph_utils.py:391-487) with every raster stage a tensor
            program (ops.image2d)
  views   - keyframes assigned to rooms by footprint proximity; k-means over
            view embeddings picks representatives (graph_utils.py:192-356)
  objects - merged instances gated to floor slabs, associated to rooms by
            footprint overlap, named by label-vocabulary argmax, linked to
            views by projection visibility (graph.py:1582-1736)

This stage is cold (runs once per scene after mapping), so the orchestration
is host python over numpy payloads.  World convention here: z is up
(datasets whose up-axis differs are rotated by their loaders).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import DeviceLike, resolve
from ..ops import image2d
from ..ops.compact import I32_MAX
from ..ops.kmeans import kmeans
from ..utils.labels import OBJECT_ROOM_AFFINITY
from ..utils.timing import stage
from .mapping import MappedScene
from .nodes import Floor, Object, Room, View

RASTER_PAD = 10  # border padding cells (reference graph.py:1001-1003)


# ---------------------------------------------------------------------------
# Floors
# ---------------------------------------------------------------------------


def _save_floor_histogram_debug(debug_dir, z_coords: np.ndarray, bounds) -> None:
    """Floor z-histogram + detected slab boundaries (reference's debug plot
    at graph.py:530-568): png when matplotlib is available, npy always."""
    hist, edges = np.histogram(z_coords, bins=max(int(np.ptp(z_coords) / 0.01), 8))
    np.save(debug_dir / "floor_z_histogram.npy", np.stack([edges[:-1], hist]))
    (debug_dir / "floor_bounds.json").write_text(
        json.dumps([[float(lo), float(hi)] for lo, hi in bounds])
    )
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 3))
        ax.plot(edges[:-1], hist, lw=0.8)
        for lo, hi in bounds:
            ax.axvline(lo, color="g", ls="--", lw=0.8)
            ax.axvline(hi, color="r", ls="--", lw=0.8)
        ax.set_xlabel("z (m)")
        ax.set_ylabel("points")
        fig.tight_layout()
        fig.savefig(debug_dir / "floor_z_histogram.png", dpi=100)
        plt.close(fig)
    except Exception:
        pass  # png is best-effort; the npy artifact is the contract


def _save_room_raster_debug(debug_dir, floor_id: str, labels: np.ndarray) -> None:
    """Per-floor room-segmentation raster (reference's room map images at
    graph.py:975-1066)."""
    np.save(debug_dir / f"room_labels_floor{floor_id}.npy", labels)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(labels, interpolation="nearest", cmap="tab20")
        ax.set_title(f"floor {floor_id} rooms")
        fig.tight_layout()
        fig.savefig(debug_dir / f"room_labels_floor{floor_id}.png", dpi=100)
        plt.close(fig)
    except Exception:
        pass


def detect_floor_boundaries(
    up_coords: np.ndarray,
    resolution: float = 0.01,
    peak_distance_m: float = 0.2,
    cluster_eps_m: float = 1.0,
    virtual_gap_m: float = 2.5,
    max_peaks: int = 64,
    device: DeviceLike = None,
) -> List[Tuple[float, float]]:
    """Floor slab [lo, hi) boundaries from the up-coordinate histogram
    (reference graph.py:646-763).  The peak finder runs on `device`, the
    card unless the caller asks for the CPU."""
    device = resolve(device)
    lo, hi = float(up_coords.min()), float(up_coords.max())
    bins = max(int((hi - lo) / resolution), 8)
    hist, edges = np.histogram(up_coords, bins=bins)
    # gaussian smooth sigma=2 bins
    r = 8
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / 2.0) ** 2)
    k /= k.sum()
    smooth = np.convolve(hist.astype(np.float64), k, mode="same")
    # floor slabs are horizontal surfaces: their z-bins tower over the uniform
    # wall plateau.  A pure percentile threshold sits just under that plateau
    # and admits spurious mid-wall peaks, which chain adjacent stories into
    # one cluster (peaks < cluster_eps apart); the relative term keeps only
    # slab-scale peaks (reference graph.py:646-763 absolute-height role).
    min_h = max(np.percentile(smooth, 90), 0.15 * smooth.max())
    idx, cnt = image2d.find_peaks_1d(
        torch.as_tensor(smooth.astype(np.float32), device=device),
        float(np.float32(min_h)),
        max(int(peak_distance_m / resolution), 1),
        max_peaks,
    )
    idx = idx.cpu().numpy()[:cnt]
    locs = edges[idx] if len(idx) else np.array([lo])
    # cluster peaks within eps (1-D DBSCAN eps=1, min_samples=1 == gap split)
    order = np.sort(locs)
    clusters: List[List[float]] = [[order[0]]]
    # peak height = the peak's OWN bin (smooth[i]).  A searchsorted(edges)-1
    # lookup is off by one and, for a peak in bin 0 (a ground slab at exactly
    # z=0 after voxel snapping), wraps to smooth[-1] ~ 0 — the ground peak
    # then loses the tallest-per-cluster vote, the surviving boundaries sit
    # < virtual_gap apart, and a two-storey scene collapses into ONE floor
    # (measured round 5: the two_floor fixture's long-query battery).
    heights = {float(edges[i]): float(smooth[i]) for i in idx}
    if not heights:
        heights = {float(locs[0]): 1.0}
    for l in order[1:]:
        if l - clusters[-1][-1] <= cluster_eps_m:
            clusters[-1].append(l)
        else:
            clusters.append([l])
    boundaries: List[float] = []
    for ci, cluster in enumerate(clusters):
        top_n = 1 if ci in (0, len(clusters) - 1) else 2
        best = sorted(cluster, key=lambda l: heights[l])[-top_n:]
        boundaries.extend(best)
    boundaries = np.sort(np.asarray(boundaries))
    adjusted: List[float] = []
    for i in range(len(boundaries) - 1):
        adjusted.append(boundaries[i])
        if boundaries[i + 1] - boundaries[i] >= virtual_gap_m:
            adjusted.append(boundaries[i + 1] - 0.2)
    adjusted.append(boundaries[-1])
    floors = [[adjusted[i], adjusted[i + 1]] for i in range(len(adjusted) - 1)]
    if not floors:
        floors = [[lo, hi]]
    floors[0][0] = (floors[0][0] + lo) / 2
    floors[-1][1] = hi
    return [(float(a), float(b)) for a, b in floors]


# ---------------------------------------------------------------------------
# Rooms (raster pipeline)
# ---------------------------------------------------------------------------


@dataclass
class RoomRaster:
    labels: np.ndarray  # (H, W) int32 room id or -1
    origin: np.ndarray  # (2,) world xy of cell (0,0) corner (incl. padding)
    resolution: float

    def cell_of(self, xy: np.ndarray) -> np.ndarray:
        return np.floor((xy - self.origin) / self.resolution).astype(np.int64)

    def room_of_points(self, xy: np.ndarray) -> np.ndarray:
        c = self.cell_of(xy)
        h, w = self.labels.shape
        inb = (c[:, 0] >= 0) & (c[:, 0] < w) & (c[:, 1] >= 0) & (c[:, 1] < h)
        out = np.full(len(xy), -1, np.int64)
        out[inb] = self.labels[c[inb, 1], c[inb, 0]]
        return out


def segment_room_raster(
    floor_points: np.ndarray,  # (N, 3) z-up
    zero_level: float,
    height: float,
    resolution: float = 0.05,
    max_rooms: int = 64,
    device: DeviceLike = None,
) -> RoomRaster:
    """Walls-skeleton + outside-boundary + watershed room raster
    (reference graph.py:940-1069 + distance_transform graph_utils.py:391-487).
    The raster programs run on `device`, the card unless the caller asks for
    the CPU."""
    device = resolve(device)
    z = floor_points[:, 2]
    mid = floor_points[(z >= zero_level + 0.3) & (z < zero_level + height - 0.3)]
    full = floor_points[z < zero_level + height - 0.2]
    xy_min = floor_points[:, :2].min(axis=0)
    origin = xy_min - RASTER_PAD * resolution

    def raster(pts2d):
        c = np.floor((pts2d - origin) / resolution).astype(np.int64)
        w = int((floor_points[:, 0].max() - origin[0]) / resolution) + RASTER_PAD + 2
        h = int((floor_points[:, 1].max() - origin[1]) / resolution) + RASTER_PAD + 2
        img = np.zeros((h, w), np.float32)
        np.add.at(img, (np.clip(c[:, 1], 0, h - 1), np.clip(c[:, 0], 0, w - 1)), 1.0)
        return img

    hist_mid = raster(mid[:, :2]) if len(mid) else raster(full[:, :2])
    hist_full = raster(full[:, :2])
    # walls skeleton: normalize -> blur(5x5, sigma 1) -> > 0.25 max -> close
    hm = torch.as_tensor(hist_mid, device=device)
    hm = hm / torch.clamp(hm.max(), min=1e-9) * 255.0
    hm = image2d.gaussian_blur(hm, sigma=1.0, radius=2)
    walls = hm > 0.25 * hm.max()
    walls = image2d.morph_close(walls, 3, 1)
    # outside boundary: big blur of the full histogram -> >0 -> close -> fill
    hf = torch.as_tensor(hist_full, device=device)
    hf = hf / torch.clamp(hf.max(), min=1e-9) * 255.0
    hf = image2d.gaussian_blur(hf, sigma=2.0, radius=10)
    inside = hf > 1e-3
    inside = image2d.morph_close(inside, 5, 3)
    inside = image2d.fill_holes(inside)
    full_map = walls | ~inside
    full_map = image2d.morph_close(full_map, 3, 2)
    # distance transform on free space, blur, otsu -> seeds
    dist = image2d.distance_transform(full_map)
    distn = dist / torch.clamp(dist.max(), min=1e-9) * 255.0
    blur = image2d.gaussian_blur(distn, sigma=10.0, radius=5)
    t = image2d.otsu_threshold(blur)
    seeds_mask = blur > t
    seed_labels = image2d.connected_components_2d(seeds_mask)
    comp, sizes = image2d.relabel_compact(seed_labels, max_rooms)
    min_area = (0.5 / resolution) ** 2
    comp_np = comp.cpu().numpy()
    sizes_np = sizes.cpu().numpy()
    keep = sizes_np > min_area
    # drop small seeds, re-rank ids
    remap = np.full(max_rooms, -1, np.int64)
    remap[keep] = np.arange(keep.sum())
    seeds = np.where(comp_np >= 0, remap[np.clip(comp_np, 0, max_rooms - 1)], -1)
    if keep.sum() == 0:
        # single-room fallback: everything inside is one room
        labels = np.where((inside & ~full_map).cpu().numpy(), 0, -1)
        return RoomRaster(labels.astype(np.int32), origin, resolution)
    lab = image2d.watershed_expand(
        torch.as_tensor(seeds.astype(np.int32), device=device),
        ~full_map,
        dist,
        iters=max(full_map.shape),
    )
    return RoomRaster(lab.cpu().numpy(), origin, resolution)


# ---------------------------------------------------------------------------
# Graph container
# ---------------------------------------------------------------------------


@dataclass
class HMSGraph:
    """The scene graph (reference class Graph; query side in
    ``query.engine``): floors hold rooms, rooms hold views and objects."""

    floors: List[Floor] = field(default_factory=list)
    rooms: List[Room] = field(default_factory=list)
    objects: List[Object] = field(default_factory=list)
    views: List[View] = field(default_factory=list)

    # ------------------------------------------------------------------ build

    @staticmethod
    def build(
        mapped: MappedScene,
        cfg: Config,
        label_feats: np.ndarray,  # (C, D) label-vocabulary text features
        classes: Sequence[str],
        num_room_views: int = 24,
        max_object_extent: float = 4.0,  # metres, horizontal (see object gate)
        timer=None,  # utils.timing.StageTimer: build.floors, .rooms, .views, .objects
    ) -> "HMSGraph":
        """The graph of a mapped scene.  The raster and k-means programs run
        on the scene's device."""
        g = HMSGraph()
        scene = mapped.scene
        device = scene.sum_pts.device
        n = int(scene.num)
        pts_all = scene.points()[:n].cpu().numpy()  # row-indexed by instances
        cols_all = scene.colors()[:n].cpu().numpy()
        pts, cols = pts_all, cols_all
        if mapped.density_keep is not None:
            # prune low-density outliers before floor/room segmentation
            # (reference graph.py:348-358 radius_outlier_removal on the full
            # pcd); without this, stray blobs leak into floor slabs, room
            # rasters, and the nav graph.  Instance rows keep indexing the
            # unfiltered scene buffer (pts_all).
            keep = mapped.density_keep[:n].cpu().numpy()
            if keep.any():
                pts, cols = pts_all[keep], cols_all[keep]
        debug_dir = None
        if cfg.pipeline.save_intermediate_results:
            # debug artifact set (reference §5.5: floor z-histograms
            # graph.py:530-568, room maps :975-1066 — they document the
            # algorithm's intermediate contracts)
            debug_dir = Path(cfg.main.save_path) / cfg.main.scene_id / "debug"
            debug_dir.mkdir(parents=True, exist_ok=True)

        # ---- floors
        with stage(timer, "build.floors"):
            g._add_floors(pts, cols, debug_dir, device)
        # ---- rooms + views per floor
        with stage(timer, "build.rooms"):
            rasters = [
                segment_room_raster(
                    fl.pcd_points,
                    fl.floor_zero_level,
                    fl.floor_height,
                    resolution=cfg.pipeline.grid_resolution,
                    device=device,
                )
                for fl in g.floors
            ]
        with stage(timer, "build.views"):
            g._add_rooms_and_views(mapped, cfg, rasters, debug_dir, num_room_views, device)
        # ---- objects (graph.py:1582-1736)
        with stage(timer, "build.objects"):
            g._add_objects(mapped, cfg, pts_all, cols_all, label_feats, classes, max_object_extent)
        return g

    def _add_floors(self, pts, cols, debug_dir, device) -> None:
        bounds = detect_floor_boundaries(pts[:, 2], device=device)
        if debug_dir is not None:
            _save_floor_histogram_debug(debug_dir, pts[:, 2], bounds)
        for fi, (lo, hi) in enumerate(bounds):
            sel = (pts[:, 2] >= lo) & (pts[:, 2] < hi)
            if sel.sum() < 50 and len(bounds) > 1:
                continue
            fl = Floor(str(len(self.floors)), name=f"floor_{len(self.floors)}")
            fp = pts[sel]
            fl.pcd_points, fl.pcd_colors = fp, cols[sel]
            zero = float(fp[:, 2].min()) if len(fp) else lo
            fl.floor_zero_level = zero
            fl.floor_height = float(hi - zero)
            bmin, bmax = fp.min(0), fp.max(0)
            fl.vertices = np.array(
                [[x, y, z] for x in (bmin[0], bmax[0]) for y in (bmin[1], bmax[1]) for z in (bmin[2], bmax[2])]
            )
            self.floors.append(fl)

    def _add_rooms_and_views(self, mapped, cfg, rasters, debug_dir, num_room_views, device) -> None:
        # keyframe metadata
        kf = mapped.keyframes
        kf_embs = mapped.keyframe_feats.float().cpu().numpy()
        kf_pos = np.array([f.pose[:3, 3] for f in kf]) if kf else np.zeros((0, 3))
        skip = cfg.pipeline.skip_frames

        view_counter = 0
        for fl, raster in zip(self.floors, rasters):
            room_ids = raster.room_of_points(fl.pcd_points[:, :2])
            if debug_dir is not None:
                _save_room_raster_debug(debug_dir, fl.floor_id, raster.labels)
            n_rooms = int(raster.labels.max()) + 1
            if n_rooms <= 0:
                n_rooms = 1
                room_ids = np.zeros(len(fl.pcd_points), np.int64)
            # frames on this floor: a camera belongs to the floor whose zero
            # level is below it, bounded by the NEXT storey's zero level —
            # not by the observed point-slab height (ceiling-less scans put
            # the camera ABOVE the slab: at 1.5 m eye height over a 1.2 m
            # furniture slab the old gate matched zero frames and every room
            # fell back to a single nearest keyframe, so room naming voted on
            # one noisy view; measured round 4: 5 views for 48 keyframes)
            zeros = sorted(f.floor_zero_level for f in self.floors)
            zlo = fl.floor_zero_level
            above = [z for z in zeros if z > zlo + 0.5]
            zhi = min(above) if above else np.inf
            frame_ok = (
                (kf_pos[:, 2] >= zlo) & (kf_pos[:, 2] < zhi)
                if len(kf_pos)
                else np.zeros((0,), bool)
            )
            rooms_local: List[Room] = []
            room_members: List[np.ndarray] = []
            for ri in range(n_rooms):
                sel = room_ids == ri
                if sel.sum() < 10:
                    continue
                room = Room(
                    f"{fl.floor_id}_{len(rooms_local)}",
                    fl.floor_id,
                    name=f"room_{len(rooms_local)}",
                )
                room.pcd_points = fl.pcd_points[sel]
                room.pcd_colors = fl.pcd_colors[sel]
                room.vertices = room.pcd_points[:, :2]
                room.room_zero_level = fl.floor_zero_level
                room.room_height = fl.floor_height
                rooms_local.append(room)
                room_members.append(sel)
            if not rooms_local:
                room = Room(f"{fl.floor_id}_0", fl.floor_id, name="room_0")
                room.pcd_points, room.pcd_colors = fl.pcd_points, fl.pcd_colors
                room.vertices = fl.pcd_points[:, :2]
                room.room_zero_level = fl.floor_zero_level
                room.room_height = fl.floor_height
                rooms_local = [room]

            # assign frames to rooms by 2-D proximity (graph_utils.py:244-268)
            room_frames: Dict[int, List[int]] = {i: [] for i in range(len(rooms_local))}
            for gi in np.where(frame_ok)[0]:
                pos = kf_pos[gi, :2]
                dists = [
                    float(np.min(np.linalg.norm(r.vertices - pos, axis=1)))
                    for r in rooms_local
                ]
                room_frames[int(np.argmin(dists))].append(int(gi))
            # room with no frame: closest frame overall
            for ri, r in enumerate(rooms_local):
                if not room_frames[ri] and len(kf_pos):
                    dists = [
                        float(np.min(np.linalg.norm(r.vertices - kf_pos[gi, :2], axis=1)))
                        if frame_ok[gi] or True
                        else np.inf
                        for gi in range(len(kf_pos))
                    ]
                    room_frames[ri].append(int(np.argmin(dists)))

            # representative embeddings (k-means, graph_utils.py:306-355)
            for ri, room in enumerate(rooms_local):
                ids = room_frames[ri]
                embs = kf_embs[ids] if ids else np.zeros((0, kf_embs.shape[-1] if kf_embs.size else 1))
                room.sample_images = [int(i * skip) for i in ids]
                room.clip_embeddings = [e for e in embs]
                if len(ids) == 0:
                    room.embeddings, room.represent_images = [], []
                elif len(ids) < num_room_views:
                    room.embeddings = [e for e in embs]
                    room.represent_images = [int(i * skip) for i in ids]
                else:
                    centers, labels_k = kmeans(
                        torch.as_tensor(embs, device=device),
                        torch.ones(len(embs), dtype=torch.bool, device=device),
                        num_room_views,
                    )
                    centers, labels_k = centers.cpu().numpy(), labels_k.cpu().numpy()
                    reps, rep_ids = [], []
                    for u in np.unique(labels_k):
                        members = np.where(labels_k == u)[0]
                        sim = embs[members] @ centers[u]
                        b = members[int(np.argmax(sim))]
                        reps.append(embs[b])
                        rep_ids.append(int(ids[b] * skip))
                    room.embeddings, room.represent_images = reps, rep_ids
                # views: one per assigned frame (graph.py:1176-1189)
                for gi in ids:
                    view = View(
                        f"{fl.floor_id}_{ri}_{view_counter}",
                        room.room_id,
                        img_id=int(gi * skip),
                    )
                    view.embedding = kf_embs[gi]
                    room.views.append(view)
                    self.views.append(view)
                    view_counter += 1
                fl.add_room(room)
                self.rooms.append(room)

    def _add_objects(self, mapped, cfg, pts_all, cols_all, label_feats, classes, max_object_extent) -> None:
        n = len(pts_all)
        kf = mapped.keyframes
        skip = cfg.pipeline.skip_frames
        inst = mapped.instances
        valid = inst.valid.cpu().numpy()
        rows = inst.rows.cpu().numpy()
        feats_i = mapped.instance_feats.float().cpu().numpy()
        margin = 0.2
        for ii in np.where(valid)[0]:
            r = rows[ii]
            r = r[r != int(I32_MAX)]
            if len(r) < 10:
                continue
            opts = pts_all[r[r < n]]
            ocols = cols_all[r[r < n]]
            if len(opts) < 10:
                continue
            # building-scale instances are merged STRUCTURE (walls/floor
            # chained through shared corners), not furniture: the reference's
            # object list never carries them because its per-mask DBSCAN
            # clouds stay local (graph_utils.py:918-1038) — gate on the
            # horizontal extent (objects span rooms, never buildings)
            xy_extent = opts[:, :2].max(0) - opts[:, :2].min(0)
            if float(max(xy_extent)) > max_object_extent:
                continue
            zmin, zmax = opts[:, 2].min(), opts[:, 2].max()
            floor = None
            for fl in self.floors:
                if zmin > fl.floor_zero_level - margin and zmax < (
                    fl.floor_zero_level + fl.floor_height + margin
                ):
                    floor = fl
                    break
            if floor is None or not floor.rooms:
                continue
            # room association: overlap share, fallback nearest center
            xy = opts[:, :2]
            shares = []
            for room in floor.rooms:
                rv = room.vertices
                step = max(len(rv) // 2048, 1)
                rv = rv[::step]
                dmin = np.min(
                    np.linalg.norm(xy[:, None, :] - rv[None, : min(len(rv), 4096)], axis=-1),
                    axis=1,
                )
                shares.append(float((dmin < 0.2).mean()))
            if sum(shares) == 0:
                shares = [
                    -float(
                        np.linalg.norm(np.mean(room.vertices, 0) - xy.mean(0))
                    )
                    for room in floor.rooms
                ]
            parent = floor.rooms[int(np.argmax(shares))]
            emb = feats_i[ii]
            name = classes[int(np.argmax(label_feats @ emb))]
            obj = Object(f"{parent.room_id}_{parent.object_counter}", parent.room_id)
            parent.object_counter += 1
            obj.name = name
            obj.pcd_points, obj.pcd_colors = opts, ocols
            obj.vertices = xy
            obj.embedding = emb
            # view linkage by projection visibility
            best_depth, best_view = np.inf, None
            for view in parent.views:
                gi = view.img_id // skip if view.img_id is not None else None
                if gi is None or gi >= len(kf):
                    continue
                frame = kf[gi]
                vis, mean_depth = check_object_in_view(
                    frame.rgb.shape[1],
                    frame.rgb.shape[0],
                    frame.k,
                    np.linalg.inv(frame.pose),
                    opts,
                )
                if vis:
                    obj.view_ids.append(view.view_id)
                    view.object_ids.append(obj.object_id)
                    view.text_discription.append(obj.name)
                    if mean_depth < best_depth:
                        best_depth, best_view = mean_depth, view.view_id
            if best_view is None:
                # fallback: highest-visibility view anywhere on the floor
                # (an object sampled away from its room's chosen views must
                # still anchor the slow path's object-in-image check)
                best_ratio = 0.0
                for room2 in floor.rooms:
                    for view in room2.views:
                        gi = view.img_id // skip if view.img_id is not None else None
                        if gi is None or gi >= len(kf):
                            continue
                        frame = kf[gi]
                        ratio = _visible_ratio(
                            frame.rgb.shape[1], frame.rgb.shape[0],
                            frame.k, np.linalg.inv(frame.pose), opts,
                        )
                        if ratio > best_ratio:
                            best_ratio, best_view = ratio, view.view_id
            obj.best_view_id = best_view
            parent.add_object(obj)
            self.objects.append(obj)

    # ------------------------------------------------------------- room names

    def generate_room_names(
        self,
        room_type_feats: np.ndarray,
        room_types: Sequence[str],
        method: str = "view_embedding",
        llm=None,  # callable(system, prompt) -> str, used by method="llm"
    ) -> None:
        """Name rooms (reference graph.py:2146-2187):
        'view_embedding' — dominant view embedding vs room-type text features
        (room.py:131-172); 'objects' — majority-informed vote over contained
        object names embedded as text (room.py:237-307
        `infer_room_type_from_objects` semantics); 'llm' — ask an LLM to pick
        the type from the contained object list (utils/llm_utils.py:52-126
        `infer_room_type_from_object_list_chat`), falling back to the object
        vote when the reply isn't a known type; 'hybrid' — the view vote,
        overridden by the object-name room-affinity prior
        (utils.labels.OBJECT_ROOM_AFFINITY, the offline stand-in for the
        LLM mode's world knowledge) when the named objects give >= 2 votes
        for a type and the view vote has no absolute majority."""
        if method == "llm" and llm is not None:
            fallback = []
            for room in self.rooms:
                names = sorted({o.name for o in room.objects if o.name})
                try:
                    reply = llm(
                        "You classify rooms. Answer with exactly one room type "
                        f"from this list: {', '.join(room_types)}.",
                        f"A room contains: {', '.join(names) or 'nothing'}. "
                        "What type of room is it?",
                    ).strip().lower()
                except Exception:
                    reply = ""
                # accept the reply only when it names exactly ONE known type
                # ("it is not a kitchen, more likely an office" must not pick
                # kitchen); anything ambiguous falls back to the object vote
                mentioned = [t for t in room_types if t in reply]
                if len(mentioned) == 1:
                    room.name = mentioned[0]
                else:
                    fallback.append(room)
            if not fallback:
                return
            # un-named rooms fall through to the object vote below
            rooms_subset = fallback
        else:
            rooms_subset = self.rooms
        if method in ("objects", "llm"):
            # structure classes never vote (reference room.py:273-285 filters
            # wall/floor/ceiling/railing/roof/void/unlabeled/misc from the
            # object list before inferring the type)
            structure = {"wall", "floor", "ceiling", "railing", "roof",
                         "void", "unlabeled", "misc", "background"}
            for room in rooms_subset:
                voters = [o for o in room.objects
                          if o.name and o.name.lower() not in structure]
                if not voters:
                    room.name = "room"
                    continue
                embs = np.stack(
                    [np.asarray(o.embedding, np.float32) for o in voters]
                )
                votes = np.argmax(embs @ room_type_feats.T, axis=1)
                room.name = room_types[int(np.bincount(votes).argmax())]
            return
        for room in self.rooms:
            embs = [np.asarray(e, np.float32) for e in room.embeddings]
            view_name, view_frac = None, 0.0
            if embs:
                # per-view argmax MAJORITY vote (reference room.py:159-169:
                # argmax each stored view embedding against the type features,
                # then the most-voted type wins).  A dominant-feature reduction
                # before the argmax is NOT equivalent: one off-cluster rep can
                # flip the room (measured: the fixture bathroom named 'library'
                # from a 12/16-bathroom vote, round 5).
                e = np.stack(embs)
                e = e / np.clip(
                    np.linalg.norm(e, axis=1, keepdims=True), 1e-9, None
                )
                votes = np.argmax(e @ room_type_feats.T, axis=1)
                counts = np.bincount(votes, minlength=len(room_types))
                view_name = room_types[int(counts.argmax())]
                view_frac = float(counts.max()) / float(len(embs))
            if method == "hybrid":
                # object-name affinity score: each named object casts 1/k of
                # a vote for its k affine types (utils.labels docstring — the
                # LLM world-knowledge stand-in).  Override the view vote only
                # when the object evidence is strong (>= 2 votes) and the
                # view vote lacks an absolute majority: the per-view
                # classifier stays authoritative when it is confident.
                scores = {t: 0.0 for t in room_types}
                for o in room.objects:
                    types = OBJECT_ROOM_AFFINITY.get((o.name or "").lower(), ())
                    hits = [t for t in types if t in scores]
                    for t in hits:
                        scores[t] += 1.0 / len(types)
                kn_name, kn_score = None, 0.0
                if scores:
                    kn_name = max(scores, key=scores.get)
                    kn_score = scores[kn_name]
                # "absolute majority" = strictly more than half the views;
                # a tie at exactly half is contestable evidence
                if kn_name is not None and kn_score >= 2.0 and (
                    view_name is None or view_frac <= 0.5
                ):
                    room.name = kn_name
                    continue
                if view_name is None and kn_name is not None and kn_score >= 1.0:
                    room.name = kn_name
                    continue
            room.name = view_name if view_name is not None else "room"

    # ------------------------------------------------------------ persistence

    def save(self, path: str | Path) -> None:
        """Reference save_hmsg_graph layout (graph.py:1801-1824)."""
        path = Path(path)
        for sub in ("floors", "rooms", "objects", "views"):
            (path / sub).mkdir(parents=True, exist_ok=True)
        for fl in self.floors:
            fl.save(path / "floors")
        for room in self.rooms:
            room.save(path / "rooms")
        for obj in self.objects:
            obj.save(path / "objects")
        for view in self.views:
            view.save(path / "views")

    @staticmethod
    def load(path: str | Path) -> "HMSGraph":
        """Reference load_hmsg_graph (graph.py:1892-1987)."""
        path = Path(path)
        g = HMSGraph()
        for f in sorted(os.listdir(path / "floors")):
            if not f.endswith(".ply"):
                continue
            fid = f.split(".")[0]
            fl = Floor(fid, name=f"floor_{fid}")
            fl.load(path / "floors")
            fl.rooms = []
            g.floors.append(fl)
        floor_by_id = {fl.floor_id: fl for fl in g.floors}
        for f in sorted(os.listdir(path / "rooms")):
            if not f.endswith(".ply"):
                continue
            rid = f.split(".")[0]
            room = Room(rid, rid.split("_")[0])
            room.load(path / "rooms")
            g.rooms.append(room)
            floor_by_id[str(room.floor_id)].rooms.append(room)
        room_by_id = {r.room_id: r for r in g.rooms}
        if (path / "objects").exists():
            for f in sorted(os.listdir(path / "objects")):
                if not f.endswith(".ply"):
                    continue
                oid = f.split(".")[0]
                room_id = "_".join(oid.split("_")[:2])
                obj = Object(oid, room_id)
                obj.load(path / "objects")
                obj.room_id = room_id
                g.objects.append(obj)
                room_by_id[room_id].add_object(obj)
        if (path / "views").exists():
            for f in sorted(os.listdir(path / "views")):
                if not f.endswith(".json"):
                    continue
                vid = f.split(".")[0]
                room_id = "_".join(vid.split("_")[:2])
                view = View(vid, room_id)
                view.load(path / "views")
                view.room_id = room_id
                g.views.append(view)
                room_by_id[room_id].views.append(view)
        return g


def _visible_ratio(
    img_w: int, img_h: int, camera_matrix: np.ndarray,
    cam_pose_inv: np.ndarray, obj_points: np.ndarray,
) -> float:
    """Fraction of object points projecting inside the image."""
    if obj_points.shape[0] == 0:
        return 0.0
    cam = obj_points @ cam_pose_inv[:3, :3].T + cam_pose_inv[:3, 3]
    front = cam[cam[:, 2] > 0]
    if front.shape[0] == 0:
        return 0.0
    pix = front @ camera_matrix.T
    pix = pix[:, :2] / pix[:, 2:3]
    inside = (
        (pix[:, 0] >= 0) & (pix[:, 0] < img_w) & (pix[:, 1] >= 0) & (pix[:, 1] < img_h)
    )
    return float(inside.sum() / obj_points.shape[0])


def check_object_in_view(
    img_w: int,
    img_h: int,
    camera_matrix: np.ndarray,
    cam_pose_inv: np.ndarray,
    obj_points: np.ndarray,
    min_visible_ratio: float = 0.5,
    max_depth: float = 10.0,
) -> Tuple[bool, float]:
    """Projection visibility test (reference graph_utils.py:95-157)."""
    if obj_points.shape[0] == 0:
        return False, np.inf
    cam = obj_points @ cam_pose_inv[:3, :3].T + cam_pose_inv[:3, 3]
    front = cam[cam[:, 2] > 0]
    if front.shape[0] == 0:
        return False, np.inf
    pix = front @ camera_matrix.T
    pix = pix[:, :2] / pix[:, 2:3]
    inside = (
        (pix[:, 0] >= 0) & (pix[:, 0] < img_w) & (pix[:, 1] >= 0) & (pix[:, 1] < img_h)
    )
    if not inside.any():
        return False, np.inf
    ratio = inside.sum() / obj_points.shape[0]
    if ratio < min_visible_ratio:
        return False, np.inf
    mean_depth = float(front[inside, 2].mean())
    if mean_depth > max_depth:
        return False, mean_depth
    return True, mean_depth
