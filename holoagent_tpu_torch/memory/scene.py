"""Device-resident voxel scene with stable rows (counterpart of
holoagent_tpu/memory/scene.py).

A voxel cell is a scene point (mean position/color of its hits).  Rows are
append-only and never move, so instance row sets and feature accumulators
stay valid across frames; only the sorted (key, row) index is rebuilt per
insert.  Per-pixel CLIP features fuse by scatter-add into their pixel's row.

The float sums use ``index_add_``, which on CUDA adds in a run-dependent
order: compare them with a tolerance.  Counts are sums of small integers in
float32 and stay exact.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import voxel
from ..ops.voxel import GridSpec, SENTINEL


class SceneState(NamedTuple):
    grid: GridSpec
    key: torch.Tensor  # (C,) int32 voxel key per stable row (SENTINEL unused)
    sorted_key: torch.Tensor  # (C,) int32 sorted copy for lookups
    sorted_row: torch.Tensor  # (C,) int32 row of each sorted key
    sum_pts: torch.Tensor  # (C, 3) f32
    sum_col: torch.Tensor  # (C, 3) f32
    count: torch.Tensor  # (C,) f32 hits
    sum_feat: torch.Tensor  # (C, D) f32
    feat_count: torch.Tensor  # (C,) f32
    num: torch.Tensor  # () int32 rows used

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    def points(self) -> torch.Tensor:
        return self.sum_pts / torch.clamp(self.count, min=1.0)[:, None]

    def colors(self) -> torch.Tensor:
        return self.sum_col / torch.clamp(self.count, min=1.0)[:, None]

    def feats(self, normalize: bool = True) -> torch.Tensor:
        f = self.sum_feat / torch.clamp(self.feat_count, min=1e-5)[:, None]
        if normalize:
            f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True), min=1e-9)
        return f

    def valid(self) -> torch.Tensor:
        return self.count > 0


def init_scene(grid: GridSpec, capacity: int, feat_dim: int, device) -> SceneState:
    f32 = dict(dtype=torch.float32, device=device)
    return SceneState(
        grid=grid,
        key=torch.full((capacity,), SENTINEL, dtype=torch.int32, device=device),
        sorted_key=torch.full((capacity,), SENTINEL, dtype=torch.int32, device=device),
        sorted_row=torch.zeros(capacity, dtype=torch.int32, device=device),
        sum_pts=torch.zeros((capacity, 3), **f32),
        sum_col=torch.zeros((capacity, 3), **f32),
        count=torch.zeros(capacity, **f32),
        sum_feat=torch.zeros((capacity, feat_dim), **f32),
        feat_count=torch.zeros(capacity, **f32),
        num=torch.zeros((), dtype=torch.int32, device=device),
    )


def _with_trash(t: torch.Tensor) -> torch.Tensor:
    """Append one zero row: scatters route dropped lanes there."""
    return torch.cat([t, torch.zeros((1,) + t.shape[1:], dtype=t.dtype, device=t.device)])


def insert_points(
    scene: SceneState,
    points: torch.Tensor,  # (P, 3) world
    colors: torch.Tensor,  # (P, 3)
    valid: torch.Tensor,  # (P,)
    fcap: int = 0,  # per-call unique-voxel capacity; 0 = min(P, 64k)
) -> Tuple[SceneState, torch.Tensor]:
    """Fuse one frame's points.  Returns (scene, rows (P,) int32 per-pixel
    stable row id, -1 for invalid/overflow).  Voxels past ``fcap`` drop to
    the trash row for this call only."""
    c = scene.capacity
    fcap = fcap or min(points.shape[0], 1 << 16)
    down = voxel.voxel_downsample(
        points, colors, valid, scene.grid, capacity=fcap, return_segments=True
    )
    fkeys, fvalid = down["key"], down["valid"]
    found = voxel.lookup(scene.sorted_key, fkeys)
    row_existing = torch.where(
        found >= 0, scene.sorted_row[found.clamp(min=0)].to(torch.int64), torch.full_like(found, -1)
    )
    is_new = fvalid & (row_existing < 0)
    new_rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    new_row = scene.num.to(torch.int64) + new_rank
    overflow = new_row >= c
    placed = is_new & ~overflow
    minus1 = torch.full_like(new_row, -1)
    row_of_fvoxel = torch.where(placed, new_row, torch.where(fvalid, row_existing, minus1))
    safe_rows = torch.where(placed, new_row, torch.full_like(new_row, c))
    key2 = _with_trash(scene.key)
    key2[safe_rows] = torch.where(is_new, fkeys, torch.zeros_like(fkeys))
    key2 = key2[:c]
    num2 = torch.clamp(scene.num + placed.sum().to(torch.int32), max=c)
    skey, srow = torch.sort(key2, stable=True)
    tgt = torch.where(row_of_fvoxel >= 0, row_of_fvoxel, torch.full_like(row_of_fvoxel, c))
    cnt_f = down["count"]
    sum_pts = _with_trash(scene.sum_pts).index_add_(0, tgt, down["points"] * cnt_f[:, None])[:c]
    sum_col = _with_trash(scene.sum_col).index_add_(0, tgt, down["attrs"] * cnt_f[:, None])[:c]
    count = _with_trash(scene.count).index_add_(0, tgt, cnt_f)[:c]
    seg = down["segments"].to(torch.int64)
    pix_row = torch.where(seg >= 0, row_of_fvoxel[seg.clamp(min=0)], torch.full_like(seg, -1))
    scene2 = scene._replace(
        key=key2,
        sorted_key=skey,
        sorted_row=srow.to(torch.int32),
        sum_pts=sum_pts,
        sum_col=sum_col,
        count=count,
        num=num2,
    )
    return scene2, pix_row.to(torch.int32)


def _fuse_chunk(sum_feat, feat_count, rows, masks, fm, c):
    f = masks.to(torch.float32).T @ fm  # (p, D)
    norm = torch.linalg.norm(f, dim=-1, keepdim=True)
    covered = norm[:, 0] > 1e-9
    f = torch.where(covered[:, None], f / torch.clamp(norm, min=1e-9), torch.zeros_like(f))
    rows = rows.to(torch.int64)
    tgt = torch.where((rows >= 0) & covered, rows, torch.full_like(rows, c))
    sum_feat.index_add_(0, tgt, f)
    feat_count.index_add_(0, tgt, covered.to(torch.float32))


def fuse_pixel_features(
    scene: SceneState,
    pix_rows: torch.Tensor,  # (P,) stable rows from insert_points
    masks: torch.Tensor,  # (M, P) bool flattened mask coverage
    mask_valid: torch.Tensor,  # (M,)
    f_masks: torch.Tensor,  # (M, D) fused per-mask features
    chunk: int = 1 << 20,  # >= P runs single-shot
) -> SceneState:
    """Scatter per-pixel ConceptFusion features into the scene: per pixel the
    normalized sum of its covering masks' features, summed per scene row.
    Pixels are processed ``chunk`` at a time, bounding the transient (chunk,
    D) tensor."""
    p = pix_rows.shape[0]
    c = scene.capacity
    fm = torch.where(mask_valid[:, None], f_masks, torch.zeros_like(f_masks))
    sum_feat = _with_trash(scene.sum_feat)
    feat_count = _with_trash(scene.feat_count)
    for s in range(0, p, chunk):
        _fuse_chunk(sum_feat, feat_count, pix_rows[s : s + chunk], masks[:, s : s + chunk], fm, c)
    return scene._replace(sum_feat=sum_feat[:c], feat_count=feat_count[:c])
