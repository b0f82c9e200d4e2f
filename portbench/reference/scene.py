"""Plain voxel scene of a walk: the hits and fused per-pixel features
every occupied voxel collects.

Each frame is backprojected (pinhole, camera-to-world pose, depth in
(1e-3, depth_cut)); a point falls in the voxel floor((p - origin) /
voxel) of a 2048 x 2048 x 512 grid centred on the world origin, keyed as
x << 20 | y << 9 | z.  Per frame only the `frame_cap` smallest keys are
kept (the program's per-frame voxel capacity).  A pixel's feature is the
normalized sum of the per-mask features of the masks that cover it; a
voxel sums the features of its covered pixels and counts them.  Written
for the benchmark from that description; it imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

GRID = (2048, 2048, 512)
SENTINEL = 2**31 - 1


def _origin(voxel: float) -> torch.Tensor:
    vs = np.float32(voxel)
    return torch.from_numpy(-(np.asarray([g // 2 for g in GRID], np.float32) * vs))


def frame_points(depth, pose, k, voxel: float, depth_cut: float):
    """One frame's world points (P, 3) and their int64 voxel keys (P,),
    SENTINEL where the depth is invalid."""
    h, w = depth.shape
    dev = depth.device
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    ok = (depth > 1e-3) & (depth < depth_cut) & torch.isfinite(depth)
    # the intrinsics and the cell size as float32 values in Python floats
    kk = np.asarray(k.cpu() if torch.is_tensor(k) else k, np.float32)
    fx, fy, cx, cy = (float(kk[i, j]) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    pts = torch.stack([x, y, depth], dim=-1).reshape(-1, 3) @ pose[:3, :3].T + pose[:3, 3]
    c = torch.floor((pts - _origin(voxel).to(dev)) / float(np.float32(voxel))).to(torch.int32)
    c = torch.minimum(c.clamp(min=0), torch.tensor([g - 2 for g in GRID], dtype=torch.int32, device=dev))
    key = (c[:, 0].long() << 20) | (c[:, 1].long() << 9) | c[:, 2].long()
    return pts, torch.where(ok.reshape(-1), key, torch.full_like(key, SENTINEL))


def kept_keys(key, frame_cap: int):
    """The frame's keys with only its `frame_cap` smallest voxels kept (the
    program's per-frame voxel capacity), SENTINEL elsewhere."""
    kept = torch.unique(key[key != SENTINEL])[:frame_cap]
    pos = torch.searchsorted(kept, key).clamp(max=max(kept.numel() - 1, 0))
    keep = (key != SENTINEL) & (kept.numel() > 0) & (kept[pos] == key)
    return torch.where(keep, key, torch.full_like(key, SENTINEL))


def frame_keys(depth, pose, k, voxel: float, depth_cut: float, frame_cap: int):
    """(P,) int64 keys of one frame's pixels that the scene keeps, SENTINEL
    elsewhere."""
    return kept_keys(frame_points(depth, pose, k, voxel, depth_cut)[1], frame_cap)


def fold(frames: Sequence[dict], voxel: float, depth_cut: float, frame_cap: int) -> Dict[str, torch.Tensor]:
    """`frames`: dicts of depth (H, W), pose (4, 4), k (3, 3), masks (M, H,
    W) bool, valid (M,), f_masks (M, D).  Returns the occupied voxels'
    sorted keys and their hit counts, feature sums (float64) and feature
    counts."""
    kept = [frame_keys(f["depth"], f["pose"], f["k"], voxel, depth_cut, frame_cap) for f in frames]
    all_keys = torch.unique(torch.cat(kept))
    all_keys = all_keys[all_keys != SENTINEL]
    dev, d = all_keys.device, frames[0]["f_masks"].shape[-1]
    count = torch.zeros(all_keys.numel(), dtype=torch.float64, device=dev)
    feat = torch.zeros((all_keys.numel(), d), dtype=torch.float64, device=dev)
    feat_count = torch.zeros_like(count)
    for f, key in zip(frames, kept):
        hit = key != SENTINEL
        idx = torch.searchsorted(all_keys, key[hit])
        count.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float64))
        m = f["masks"].reshape(f["masks"].shape[0], -1) & f["valid"][:, None]
        fm = torch.where(f["valid"][:, None], f["f_masks"].double(), torch.zeros((), dtype=torch.float64, device=dev))
        pf = m[:, hit].double().T @ fm
        norm = torch.linalg.norm(pf, dim=-1)
        covered = norm > 1e-9
        feat.index_add_(0, idx[covered], pf[covered] / norm[covered][:, None])
        feat_count.index_add_(0, idx[covered], torch.ones_like(norm[covered]))
    return {"key": all_keys, "count": count, "feat": feat, "feat_count": feat_count}


def compare(ref: Dict[str, torch.Tensor], key, count, feat, feat_count) -> Dict[str, float]:
    """The program's scene rows (int32 keys, hit counts, feature sums and
    counts of its occupied rows) against `ref`: the number of voxels whose
    presence, hit count or feature count differs, and, over the voxels
    that agree in both counts, the largest |sum_prog - sum_ref| / n, where
    the sums add n unit vectors."""
    if key.numel() == 0:
        return {"scene_rows_differing": float(ref["key"].numel()), "scene_feat_gap": 1.0}
    order = torch.argsort(key.long())
    key, count, feat, feat_count = key.long()[order], count[order], feat[order], feat_count[order]
    rk = ref["key"]
    both = torch.isin(rk, key)
    pos = torch.searchsorted(key, rk).clamp(max=max(key.numel() - 1, 0))
    n_missing = int((~both).sum()) + int((~torch.isin(key, rk)).sum())
    c_p, fc_p = count[pos].double(), feat_count[pos].double()
    differ = both & ((c_p != ref["count"]) | (fc_p != ref["feat_count"]))
    has = both & ~differ & (ref["feat_count"] > 0)
    gap = 0.0
    if bool(has.any()):
        d = torch.linalg.norm(feat[pos][has].double() - ref["feat"][has], dim=-1)
        gap = float((d / ref["feat_count"][has]).max())
    return {"scene_rows_differing": float(n_missing + int(differ.sum())), "scene_feat_gap": gap}
