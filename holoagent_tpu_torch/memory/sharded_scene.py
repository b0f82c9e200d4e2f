"""Sharded voxel scene: insert and fuse split over the mesh's data axis
(counterpart of holoagent_tpu/memory/sharded_scene.py).

* **Ownership**: every voxel key belongs to one shard, chosen by a
  multiplicative (Knuth) hash of the packed key (``_owner_of``), so one room
  spreads over every rank.
* **Exchange unit = frame-voxel aggregates, not pixels.** Each rank
  voxel-downsamples its block of the frame's pixels, then ships the
  per-voxel sums ``(key, Σp·w, Σc·w, w)`` to their owners in one
  ``all_to_all_single`` (one int32 buffer, the sums bit-cast into it);
  the owners merge them into their rows and ship the assigned rows back in
  one more.
* **Stable global rows**: shard s appends into its own rows; global row =
  s * C_local + local row, so ``insert_points_sharded`` returns per-pixel
  global rows as the single-device ``insert_points`` returns rows.
* **Feature fusion** computes the per-pixel ConceptFusion features of the
  rank's pixel block, sums them per global row (one sort + segment sum) and
  ships the per-row sums to the owners in one ``all_to_all_single``
  (nothing comes back).

Each rank holds its own shard (``ShardedScene``'s arrays are that rank's
C_local rows and ``num`` its count); ``to_scene`` gathers the shards and
compacts the used rows to the front on the host, as the reference does.
Integer results (keys, rows, counts of rows) equal the reference's at the
same world size bit for bit; float sums agree within float rounding.

``ShardedMapper`` maps with DP extraction (``extract_frames_dp``) into the
sharded scene.  Its instance fold runs on mesh rank 0 only and reaches the
other ranks by broadcast at ``finalize``: CUDA's float scatter-adds sum in
a run-dependent order, so replicated folds could drift apart.
"""

from __future__ import annotations

import math
import warnings
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops import voxel
from ..ops.backproject import backproject
from ..ops.compact import I32_MAX
from ..ops.density import radius_density_keep
from ..ops.voxel import SENTINEL, GridSpec
from ..parallel import comm
from ..parallel.mesh import mesh_device
from ..perception import extractor
from ..utils.camera import Pinhole
from ..utils.timing import stage
from . import instances as inst_mod
from .instances import InstanceSet
from .mapping import MappedScene, refine_instance_features
from .scene import SceneState, _with_trash

_HASH_MUL = 2654435761  # Knuth hash, as uint32 arithmetic in int64


def _owner_of(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Shard owning each voxel key (int32 in [0, n); undefined on SENTINEL)."""
    h = ((keys.to(torch.int64) & 0xFFFFFFFF) * _HASH_MUL) & 0xFFFFFFFF
    return ((h >> 17) % n).to(torch.int32)


class ShardedScene(NamedTuple):
    """This rank's shard of the scene: ``SceneState``'s arrays over its
    C_local rows (``sorted_key``/``sorted_row`` index within the shard),
    ``num`` its used-row count (0-dim int32), ``dropped`` the aggregates
    this rank's exchanges sent to the trash slot because their owner's
    bucket was full (0-dim int64; the reference drops them uncounted),
    ``n_shards`` the data axis' size."""

    grid: GridSpec
    key: torch.Tensor
    sorted_key: torch.Tensor
    sorted_row: torch.Tensor  # local row ids within the shard
    sum_pts: torch.Tensor
    sum_col: torch.Tensor
    count: torch.Tensor
    sum_feat: torch.Tensor
    feat_count: torch.Tensor
    num: torch.Tensor
    dropped: torch.Tensor
    n_shards: int

    @property
    def capacity_per_shard(self) -> int:
        return self.key.shape[0]


def init_sharded_scene(grid: GridSpec, capacity_per_shard: int, feat_dim: int, mesh: DeviceMesh) -> ShardedScene:
    dev = mesh_device(mesh)
    c = capacity_per_shard
    f32 = dict(dtype=torch.float32, device=dev)
    return ShardedScene(
        grid=grid,
        key=torch.full((c,), SENTINEL, dtype=torch.int32, device=dev),
        sorted_key=torch.full((c,), SENTINEL, dtype=torch.int32, device=dev),
        sorted_row=torch.zeros(c, dtype=torch.int32, device=dev),
        sum_pts=torch.zeros((c, 3), **f32),
        sum_col=torch.zeros((c, 3), **f32),
        count=torch.zeros(c, **f32),
        sum_feat=torch.zeros((c, feat_dim), **f32),
        feat_count=torch.zeros(c, **f32),
        num=torch.zeros((), dtype=torch.int32, device=dev),
        dropped=torch.zeros((), dtype=torch.int64, device=dev),
        n_shards=comm.size(mesh, "data"),
    )


def _first_of_runs(s: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones(1, dtype=torch.bool, device=s.device), s[1:] != s[:-1]])


def _bucket_slots(owner: torch.Tensor, valid: torch.Tensor, n: int, bcap: int) -> torch.Tensor:
    """Slot of each element in a fixed (n, bcap) send buffer laid out by
    owner: owner * bcap + rank within the owner (in input order).
    Overflow and invalid lanes get n * bcap (the trash slot).  One stable
    sort plus a running max, no loop over owners."""
    m = owner.shape[0]
    g = torch.where(valid, owner.to(torch.int64), n)
    g_s, idx_s = torch.sort(g, stable=True)
    ar = torch.arange(m, device=owner.device)
    base = torch.cummax(torch.where(_first_of_runs(g_s), ar, 0), dim=0).values
    rank = ar - base
    slot_sorted = torch.where((g_s < n) & (rank < bcap), g_s * bcap + rank, n * bcap)
    out = torch.empty(m, dtype=torch.int64, device=owner.device)
    out[idx_s] = slot_sorted
    return out


def bucket_capacity(fcap: int, n: int) -> int:
    """Per-owner bucket for at most `fcap` aggregates a rank over `n`
    owners: the mean share fcap / n plus eight standard deviations of a
    uniform hash's spread (sqrt(fcap / n)), in whole 128-lane steps, and
    never more than `fcap` (one owner takes everything).  Lanes past it drop
    to the trash slot and are counted (``ShardedScene.dropped``)."""
    mean = fcap / n
    return min(fcap, -(-math.ceil(mean + 8.0 * math.sqrt(mean)) // 128) * 128)


def _scatter_to_buckets(slot: torch.Tensor, n: int, bcap: int, fill, a: torch.Tensor) -> torch.Tensor:
    """Scatter an (m, ...) array into its (n * bcap, ...) send buffer, the
    other slots `fill` (the trash slot's lane dropped)."""
    buf = torch.full((n * bcap + 1,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
    buf[slot] = a
    return buf[: n * bcap]


def _merge_aggregates(sh: ShardedScene, in_key, in_spts, in_scol, in_cnt):
    """Merge summed voxel aggregates (keys may repeat) into this shard's
    rows: ``scene.insert_points`` over sums instead of raw points.  Returns
    the updated arrays and the local row of every input slot (-1 where
    invalid or overflowing)."""
    c = sh.capacity_per_shard
    m = in_key.shape[0]
    dev = in_key.device
    valid_in = in_key != SENTINEL
    # dedupe the incoming keys: stable sort + segment sum
    k_s, i_s = torch.sort(torch.where(valid_in, in_key, SENTINEL), stable=True)
    v_s = k_s != SENTINEL
    first = _first_of_runs(k_s) & v_s
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    seg_c = torch.where(v_s & (seg >= 0), seg, m)
    uspts = torch.zeros((m + 1, 3), dtype=torch.float32, device=dev).index_add_(0, seg_c, in_spts[i_s])
    uscol = torch.zeros((m + 1, 3), dtype=torch.float32, device=dev).index_add_(0, seg_c, in_scol[i_s])
    ucnt = torch.zeros(m + 1, dtype=torch.float32, device=dev).index_add_(
        0, seg_c, torch.where(v_s, in_cnt[i_s], torch.zeros((), device=dev)))
    ukey = torch.full((m + 1,), SENTINEL, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg_c, k_s, "amin", include_self=True)
    ukey, uspts, uscol, ucnt = ukey[:m], uspts[:m], uscol[:m], ucnt[:m]
    uvalid = ukey != SENTINEL

    found = voxel.lookup(sh.sorted_key, ukey)
    row_existing = torch.where(found >= 0, sh.sorted_row[found.clamp(min=0)].to(torch.int64), -1)
    is_new = uvalid & (row_existing < 0)
    new_row = sh.num.to(torch.int64) + torch.cumsum(is_new.to(torch.int64), 0) - 1
    placed = is_new & (new_row < c)
    row_of_u = torch.where(placed, new_row, torch.where(uvalid, row_existing, -1))
    key2 = _with_trash(sh.key)
    key2[torch.where(placed, new_row, c)] = torch.where(is_new, ukey, 0)
    key2 = key2[:c]
    num2 = torch.clamp(sh.num + placed.sum().to(torch.int32), max=c)
    skey, srow = torch.sort(key2, stable=True)
    tgt = torch.where(row_of_u >= 0, row_of_u, c)
    sum_pts = _with_trash(sh.sum_pts).index_add_(0, tgt, uspts)[:c]
    sum_col = _with_trash(sh.sum_col).index_add_(0, tgt, uscol)[:c]
    count = _with_trash(sh.count).index_add_(0, tgt, ucnt)[:c]
    # every input slot's local row: its segment's
    row_per_sorted = torch.where(seg_c < m, row_of_u[seg_c.clamp(0, m - 1)], -1)
    row_per_input = torch.empty(m, dtype=torch.int64, device=dev)
    row_per_input[i_s] = row_per_sorted
    row_per_input = torch.where(valid_in, row_per_input, -1)
    sh2 = sh._replace(key=key2, sorted_key=skey, sorted_row=srow.to(torch.int32), sum_pts=sum_pts,
                      sum_col=sum_col, count=count, num=num2)
    return sh2, row_per_input


def insert_points_sharded(
    scene: ShardedScene,
    points: torch.Tensor,  # (P, 3) world, the same on every rank; P divisible by the data axis
    colors: torch.Tensor,  # (P, 3)
    valid: torch.Tensor,  # (P,)
    mesh: DeviceMesh,
    fcap: int = 1 << 14,  # per-rank frame-voxel capacity
    bcap: int = 1 << 12,  # per-owner bucket capacity
) -> Tuple[ShardedScene, torch.Tensor]:
    """Sharded ``insert_points``: each rank inserts its contiguous block of
    the pixels.  Returns (this rank's updated shard, per-pixel GLOBAL rows
    (P,) int32 on every rank, -1 for invalid or overflow)."""
    n = scene.n_shards
    c_local = scene.capacity_per_shard
    pts, cols, val = (comm.block(t, mesh, "data") for t in (points, colors, valid))
    down = voxel.voxel_downsample(pts, cols, val, scene.grid, capacity=fcap, return_segments=True)
    fkeys = down["key"]
    slot = _bucket_slots(_owner_of(fkeys, n), down["valid"], n, bcap)
    dropped = scene.dropped + (down["valid"] & (slot == n * bcap)).sum()
    w = down["count"][:, None]
    # one int32 buffer a slot: key (SENTINEL on empty slots), then Σp·w,
    # Σc·w and w bit-cast
    sums = torch.cat([down["points"] * w, down["attrs"] * w, w], dim=1)
    send = torch.cat([_scatter_to_buckets(slot, n, bcap, SENTINEL, fkeys[:, None]),
                      _scatter_to_buckets(slot, n, bcap, 0.0, sums).view(torch.int32)], dim=1)
    recv = comm.all_to_all(send, mesh, "data")
    in_key, in_sums = recv[:, 0], recv[:, 1:].contiguous().view(torch.float32)
    scene2, rows_in = _merge_aggregates(scene, in_key, in_sums[:, 0:3], in_sums[:, 3:6], in_sums[:, 6])
    # the assigned local rows back to the producers: [o * bcap + p] = the row
    # at owner o of my bucket slot p
    rows_back = comm.all_to_all(rows_in.to(torch.int32), mesh, "data").to(torch.int64)
    owner_of_slot = torch.clamp(slot // bcap, 0, n - 1)
    local_row = rows_back[owner_of_slot * bcap + slot % bcap]
    grow = torch.where((slot < n * bcap) & (local_row >= 0), owner_of_slot * c_local + local_row, -1)
    seg = down["segments"].to(torch.int64)
    pix_row = torch.where(seg >= 0, grow[seg.clamp(min=0)], -1).to(torch.int32)
    return scene2._replace(dropped=dropped), comm.all_gather(pix_row, mesh, "data")


def fuse_pixel_features_sharded(
    scene: ShardedScene,
    pix_rows: torch.Tensor,  # (P,) global rows from insert_points_sharded
    masks: torch.Tensor,  # (M, P) bool
    mask_valid: torch.Tensor,  # (M,)
    f_masks: torch.Tensor,  # (M, D)
    mesh: DeviceMesh,
    rcap: int = 1 << 14,  # per-rank touched-row capacity
    bcap: int = 1 << 12,
) -> ShardedScene:
    """Sharded ConceptFusion fusion (``scene.fuse_pixel_features``'s
    function): per-pixel features of this rank's pixel block, summed per
    global row, shipped to the rows' owners and added there.  Returns this
    rank's updated shard."""
    n = scene.n_shards
    c_local = scene.capacity_per_shard
    d = f_masks.shape[1]
    dev = f_masks.device
    rows = comm.block(pix_rows, mesh, "data").to(torch.int64)
    mk = comm.block(masks, mesh, "data", dim=1)
    fm0 = torch.where(mask_valid[:, None], f_masks.float(), torch.zeros((), device=dev))
    f = mk.to(torch.float32).T @ fm0  # (p, D)
    norm = torch.linalg.norm(f, dim=-1, keepdim=True)
    covered = (norm[:, 0] > 1e-9) & (rows >= 0)
    f = torch.where(covered[:, None], f / torch.clamp(norm, min=1e-9), torch.zeros((), device=dev))
    # sum by global row: stable sort + segment sum
    r_s, i_s = torch.sort(torch.where(covered, rows, I32_MAX), stable=True)
    v_s = r_s != I32_MAX
    seg = torch.cumsum((_first_of_runs(r_s) & v_s).to(torch.int64), 0) - 1
    seg_c = torch.where(v_s & (seg >= 0) & (seg < rcap), seg, rcap)
    usum = torch.zeros((rcap + 1, d), dtype=torch.float32, device=dev).index_add_(0, seg_c, f[i_s])
    ucnt = torch.zeros(rcap + 1, dtype=torch.float32, device=dev).index_add_(0, seg_c, v_s.to(torch.float32))
    urow = torch.full((rcap + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg_c, r_s, "amax", include_self=True)
    usum, ucnt, urow = usum[:rcap], ucnt[:rcap], urow[:rcap]
    uvalid = urow >= 0
    owner = torch.where(uvalid, torch.clamp(urow // c_local, 0, n - 1), n)
    slot = _bucket_slots(owner, uvalid, n, bcap)
    dropped = scene.dropped + (uvalid & (slot == n * bcap)).sum()
    # one int32 buffer a slot: local row (-1 on empty slots), then the D
    # feature sums and the weight bit-cast
    local = torch.where(uvalid, urow % c_local, -1).to(torch.int32)
    sums = torch.cat([usum, ucnt[:, None]], dim=1)
    send = torch.cat([_scatter_to_buckets(slot, n, bcap, -1, local[:, None]),
                      _scatter_to_buckets(slot, n, bcap, 0.0, sums).view(torch.int32)], dim=1)
    recv = comm.all_to_all(send, mesh, "data")
    recv_row = recv[:, 0].to(torch.int64)
    recv_f = recv[:, 1:].contiguous().view(torch.float32)
    tgt = torch.where(recv_row >= 0, recv_row, c_local)
    sum_feat = _with_trash(scene.sum_feat).index_add_(0, tgt, recv_f[:, :d])[:c_local]
    feat_count = _with_trash(scene.feat_count).index_add_(0, tgt, recv_f[:, d])[:c_local]
    return scene._replace(sum_feat=sum_feat, feat_count=feat_count, dropped=dropped)


def wire_bytes_per_frame(mesh: DeviceMesh, d: int, fcap: int = 1 << 14, bcap: int = 1 << 12) -> dict:
    """Per-rank ``all_to_all`` bytes one frame's insert + fuse moves: the
    whole fixed-shape buffers, whatever their fill.

      insert: key i32 + Σp 3×f32 + Σc 3×f32 + w f32 forward, rows i32 back
              → n·bcap·36 B
      fuse:   row i32 + feature sum d×f32 + weight f32 forward → n·bcap·(8+4d) B
    """
    n = comm.size(mesh, "data")
    return {
        "data_axis": n,
        "insert_bytes": n * bcap * 36,
        "fuse_bytes": n * bcap * (8 + 4 * d),
        "total_bytes": n * bcap * (44 + 4 * d),
    }


def to_scene(sharded: ShardedScene, mesh: DeviceMesh) -> Tuple[SceneState, torch.Tensor]:
    """Gather the shards (every rank) into a plain SceneState with the used
    rows COMPACTED to the front, on the host as the reference does
    (downstream slices ``[:num]``).  Returns (scene, row_map (n * C_local,)
    int32): row_map[global row] = compact row, -1 for unused lanes."""
    dev = sharded.key.device
    full = {name: comm.all_gather(getattr(sharded, name), mesh, "data").cpu().numpy()
            for name in ("key", "sum_pts", "sum_col", "count", "sum_feat", "feat_count")}
    c = full["key"].shape[0]
    used = np.nonzero(full["count"] > 0)[0]
    n = len(used)
    row_map = np.full((c,), -1, np.int32)
    row_map[used] = np.arange(n, dtype=np.int32)

    def compact(name, fill=0.0):
        a = full[name]
        out = np.full(a.shape, fill, a.dtype)
        out[:n] = a[used]
        return torch.from_numpy(out).to(dev)

    key = compact("key", fill=SENTINEL)
    skey, srow = torch.sort(key, stable=True)
    scene = SceneState(
        grid=sharded.grid, key=key, sorted_key=skey, sorted_row=srow.to(torch.int32),
        sum_pts=compact("sum_pts"), sum_col=compact("sum_col"), count=compact("count"),
        sum_feat=compact("sum_feat"), feat_count=compact("feat_count"),
        num=torch.tensor(n, dtype=torch.int32, device=dev),
    )
    return scene, torch.from_numpy(row_map).to(dev)


# ---------------------------------------------------------------------------
# End-to-end multi-device mapping
# ---------------------------------------------------------------------------


class ShardedMapper:
    """Multi-device streaming mapper: DP-over-frames extraction + the
    sharded scene (the reference's ``ShardedMapper``).

    Frame batches extract data-parallel (``extract_frames_dp``, with the
    config's ``extract_impl`` and ``extract_clip_impl``: K1 and K2 on the
    card, where the reference extracts at its default "xla", the same
    function); every frame's points and features then fuse into the
    row-sharded scene.  The instance fold (frame instances + ``seq_merge_step``
    over global rows) runs on mesh rank 0; ``finalize`` gathers and compacts
    the scene, remaps the instance rows, finishes the fold there and
    broadcasts the result, so every rank returns the same MappedScene.

    The per-owner bucket is sized from the per-rank frame-voxel capacity
    (``bucket_capacity``: its share of one owner with room for the hash's
    spread; the whole capacity at one rank), where the reference keeps a
    fixed 4096 that drops most of a full-resolution frame at W = 1.  What a
    full bucket drops is counted (``dropped``, summed over the ranks at
    ``finalize``, with a warning when it is not 0)."""

    def __init__(self, cfg, clip, sam, mesh: DeviceMesh, clip_variant=None, timer=None):
        self.cfg = cfg
        self.mesh = mesh
        self.clip, self.sam = clip, sam
        self.device = mesh_device(mesh)
        self.timer = timer
        self.cv = clip_variant or clip.variant
        p = cfg.pipeline
        self.grid = GridSpec.centered(p.voxel_size)
        n = comm.size(mesh, "data")
        self.fcap = -(-p.frame_voxel_capacity // n)  # the knob splits per shard (ceil)
        self.bcap = bucket_capacity(self.fcap, n)
        self.dropped = 0
        self.scene = init_sharded_scene(self.grid, -(-p.point_capacity // n), self.cv.embed_dim, mesh)
        self.lead = int(mesh.mesh.flatten()[0]) == torch.distributed.get_rank()
        self.instances = self._empty_instances()
        self.keyframes: List = []
        self._kf_feats: List[torch.Tensor] = []

    def _empty_instances(self) -> InstanceSet:
        p = self.cfg.pipeline
        return inst_mod.empty_instances(p.instance_capacity, p.mask_point_capacity, self.cv.embed_dim, self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def process_batch(self, frames) -> None:
        """Integrate a batch of frames.  Extraction pads the batch to the
        data axis' multiple (repeating the last frame); only the real frames
        enter the scene."""
        cfg, p, t = self.cfg, self.cfg.pipeline, self.timer
        nd = comm.size(self.mesh, "data")
        n_real = len(frames)
        padded = list(frames) + [frames[-1]] * ((-n_real) % nd)
        sc = cfg.models.sam
        with stage(t, "extract"):
            ff = extractor.extract_frames_dp(
                self.clip, self.sam, torch.stack([self._tensor(f.rgb) for f in padded]), self.mesh,
                points_per_side=sc.points_per_side, pred_iou_thresh=sc.pred_iou_thresh,
                stability_thresh=sc.stability_score_thresh, min_area=float(sc.min_mask_region_area),
                max_masks=sc.max_masks, masked_weight=p.clip_masked_weight, bbox_margin=float(p.clip_bbox_margin),
                impl=p.extract_impl, clip_impl=p.extract_clip_impl,
            )
        for j, frame in enumerate(frames[:n_real]):
            with stage(t, "backproject"):
                pts, cols, valid = backproject(
                    self._tensor(frame.depth), self._tensor(frame.rgb), Pinhole.from_matrix(frame.k),
                    self._tensor(frame.pose), 1e-3, cfg.main.depth_cut,
                )
            with stage(t, "insert"):
                self.scene, rows = insert_points_sharded(self.scene, pts, cols, valid, self.mesh,
                                                         fcap=self.fcap, bcap=self.bcap)
            masks_flat = ff.masks[j].reshape(ff.masks.shape[1], -1)
            with stage(t, "fuse"):
                self.scene = fuse_pixel_features_sharded(self.scene, rows, masks_flat, ff.valid[j], ff.f_masks[j],
                                                         self.mesh, rcap=self.fcap, bcap=self.bcap)
            if self.lead:
                with stage(t, "instances"):
                    stride = p.instance_pixel_stride or max(1, masks_flat.shape[1] // 32768)
                    finst = inst_mod.frame_instances(
                        masks_flat, ff.valid[j], ff.f_masks[j], rows, pts, min_rows=3,
                        k_cap=p.mask_point_capacity, stride=stride, grid=self.grid,
                        max_area_frac=p.instance_max_area_frac, max_extent=p.instance_max_extent_m,
                    )
                    self.instances = inst_mod.seq_merge_step(
                        self.instances, finst, p.init_overlap_thresh, p.iou_thresh,
                        bbox_pad=0.5 * p.voxel_size, coarse_only=True, max_extent=p.instance_max_extent_m,
                    )
            self.keyframes.append(frame)
            self._kf_feats.append(ff.f_global[j].float())

    def wire_bytes(self) -> dict:
        """``wire_bytes_per_frame`` at this mapper's capacities and bucket."""
        return wire_bytes_per_frame(self.mesh, self.cv.embed_dim, self.fcap, self.bcap)

    def finalize(self):
        """Gather and compact the shards, remap the instance rows into the
        compact numbering, finish the fold (merge round, the < 10-row drop,
        refinement, density) on mesh rank 0 and broadcast it."""
        p, t = self.cfg.pipeline, self.timer
        with stage(t, "finalize"):
            self.dropped = int(comm.all_reduce(self.scene.dropped, self.mesh, "data"))
            if self.dropped:
                warnings.warn(f"ShardedMapper: {self.dropped} voxel aggregates dropped in the exchange "
                              f"(bucket {self.bcap} a destination rank)")
            scene, row_map = to_scene(self.scene, self.mesh)
            inst = template = self._empty_instances()
            feats = torch.zeros((inst.rows.shape[0], self.cv.embed_dim), dtype=torch.float32, device=self.device)
            density = torch.zeros(scene.capacity, dtype=torch.bool, device=self.device)
            if self.lead:
                # signatures and merges treat rows as sets: no re-sort needed
                rows = self.instances.rows.to(torch.int64)
                remapped = torch.where(rows != I32_MAX, row_map[rows.clamp(0, row_map.shape[0] - 1)].to(torch.int64), -1)
                inst = self.instances._replace(rows=torch.where(remapped >= 0, remapped, I32_MAX).to(torch.int32))
                inst = inst_mod.merge_round(
                    inst, p.init_overlap_thresh, p.iou_thresh, out_cap=inst.rows.shape[0],
                    bbox_pad=0.5 * p.voxel_size, coarse_only=True, max_extent=p.instance_max_extent_m,
                )
                inst = inst._replace(valid=inst.valid & (inst.count >= 10))
                inst = InstanceSet(*(a.to(b.dtype) for a, b in zip(inst, template)))
                feats = refine_instance_features(scene, inst, eps=p.feature_dbscan_eps).float()
                density = radius_density_keep(scene.points(), scene.valid(), scene.count, radius=1.0,
                                              min_neighbors=1000.0)
            comm.broadcast(list(inst) + [feats, density], self.mesh)
            self.instances = inst
            kf = (torch.stack(self._kf_feats) if self._kf_feats
                  else torch.zeros((0, self.cv.embed_dim), device=self.device))
        return MappedScene(scene=scene, instances=inst, instance_feats=feats, keyframes=list(self.keyframes),
                           keyframe_feats=kf, density_keep=density)
