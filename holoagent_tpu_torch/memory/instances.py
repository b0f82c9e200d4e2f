"""Fixed-capacity 3-D instance sets and overlap merging (counterpart of
holoagent_tpu/memory/instances.py).

An instance is a sorted set of stable scene rows plus its voxel-resolution
"coarse" key set and the hashed occupancy signature of that set dilated by
one cell.  Pairwise overlap for all instance pairs is one matmul of the
signatures; connected components run as min-label propagation with pointer
jumping.  Integer outputs (rows, counts, keys, lane order) match the
reference bit for bit on identical inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import voxel as vox
from ..ops.compact import I32_MAX, group_unique
from ..ops.voxel import BITS_Y, BITS_Z

SIG_BUCKETS = 4096
COARSE_FACTOR = 1.0
_HASH = 2654435761
_SHIFT = 32 - int(SIG_BUCKETS).bit_length() + 1

# key offsets of the 26-neighbourhood (+ centre) on the packed layout
_NEIGHBOR_OFFSETS = [
    (dx << (BITS_Y + BITS_Z)) + (dy << BITS_Z) + dz
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]


def _bucket(keys: torch.Tensor) -> torch.Tensor:
    """High bits of the uint32 Knuth multiplicative hash, in int64."""
    u = keys.to(torch.int64) & 0xFFFFFFFF
    return ((u * _HASH) & 0xFFFFFFFF) >> _SHIFT


def _occupancy(bucket: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(I, L) buckets (valid lanes) -> (I, SIG_BUCKETS) f32 0/1 occupancy."""
    i = bucket.shape[0]
    b = torch.where(valid, bucket, torch.full_like(bucket, SIG_BUCKETS)).reshape(i, -1)
    sig = torch.zeros((i, SIG_BUCKETS + 1), dtype=torch.float32, device=bucket.device)
    sig.scatter_reduce_(1, b, valid.reshape(i, -1).to(torch.float32), "amax", include_self=True)
    return sig[:, :SIG_BUCKETS]


def _dilated_signature(ckeys: torch.Tensor) -> torch.Tensor:
    """(I, Kc) coarse key sets -> (I, SIG_BUCKETS) occupancy of the sets
    dilated by one cell (26-neighbourhood).  Border wraps leak into the
    adjacent packed field, as in the reference."""
    valid = ckeys != I32_MAX
    offs = torch.tensor(_NEIGHBOR_OFFSETS, dtype=torch.int64, device=ckeys.device)
    nk = ckeys.to(torch.int64)[:, :, None] + offs  # (I, Kc, 27); _bucket wraps mod 2^32
    return _occupancy(_bucket(nk), valid[:, :, None].expand_as(nk))


def _signatures(rows: torch.Tensor, valid_rows: torch.Tensor) -> torch.Tensor:
    """(I, K) row/key sets -> (I, SIG_BUCKETS) binary occupancy signatures."""
    return _occupancy(_bucket(rows), valid_rows)


class InstanceSet(NamedTuple):
    rows: torch.Tensor  # (I, K) int32 sorted unique scene rows, I32_MAX pad
    count: torch.Tensor  # (I,) int32
    feat_sum: torch.Tensor  # (I, D) f32
    weight: torch.Tensor  # (I,) f32
    bbox_min: torch.Tensor  # (I, 3) f32
    bbox_max: torch.Tensor  # (I, 3) f32
    valid: torch.Tensor  # (I,) bool
    ckeys: torch.Tensor  # (I, K) int32 sorted unique coarse keys, I32_MAX pad
    ccount: torch.Tensor  # (I,) int32
    dsig: torch.Tensor  # (I, SIG_BUCKETS) f32 0/1 dilated signature

    @property
    def capacity(self) -> Tuple[int, int]:
        return tuple(self.rows.shape)

    def feats(self, normalize: bool = True) -> torch.Tensor:
        f = self.feat_sum / torch.clamp(self.weight, min=1e-9)[:, None]
        if normalize:
            f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True), min=1e-9)
        return f

    def num(self) -> torch.Tensor:
        return self.valid.sum().to(torch.int32)


def empty_instances(i_cap: int, k_cap: int, d: int, device) -> InstanceSet:
    kw = dict(device=device)
    inf = float("inf")
    return InstanceSet(
        rows=torch.full((i_cap, k_cap), I32_MAX, dtype=torch.int32, **kw),
        count=torch.zeros(i_cap, dtype=torch.int32, **kw),
        feat_sum=torch.zeros((i_cap, d), dtype=torch.float32, **kw),
        weight=torch.zeros(i_cap, dtype=torch.float32, **kw),
        bbox_min=torch.full((i_cap, 3), inf, dtype=torch.float32, **kw),
        bbox_max=torch.full((i_cap, 3), -inf, dtype=torch.float32, **kw),
        valid=torch.zeros(i_cap, dtype=torch.bool, **kw),
        ckeys=torch.full((i_cap, k_cap), I32_MAX, dtype=torch.int32, **kw),
        ccount=torch.zeros(i_cap, dtype=torch.int32, **kw),
        dsig=torch.zeros((i_cap, SIG_BUCKETS), dtype=torch.float32, **kw),
    )


def concat(a: InstanceSet, b: InstanceSet) -> InstanceSet:
    """Stack two sets (row capacities must match)."""
    return InstanceSet(*(torch.cat([x, y], dim=0) for x, y in zip(a, b)))


def _where_rows(ok: torch.Tensor, x: torch.Tensor, fill) -> torch.Tensor:
    okb = ok.reshape(ok.shape + (1,) * (x.dim() - 1))
    return torch.where(okb, x, torch.full_like(x, fill))


# ---------------------------------------------------------------------------
# Per-frame instance extraction
# ---------------------------------------------------------------------------


def frame_instances(
    masks: torch.Tensor,  # (M, P) bool flattened mask coverage (pixel-disjoint)
    mask_valid: torch.Tensor,  # (M,)
    f_masks: torch.Tensor,  # (M, D)
    pix_rows: torch.Tensor,  # (P,) stable scene rows (-1 invalid)
    points: torch.Tensor,  # (P, 3) world points per pixel
    min_rows: int = 3,
    k_cap: int = 2048,
    stride: int = 1,
    grid=None,  # GridSpec: enables the coarse key sets
    max_area_frac: float = 1.0,
    max_extent: float = float("inf"),
) -> InstanceSet:
    """Lift the frame's 2-D masks to scene-row instance sets.  `stride`
    decimates pixels; masks over `max_area_frac` of the frame or with a
    world bbox side over `max_extent` are dropped from the table."""
    m, _ = masks.shape
    dev = masks.device
    masks_d = masks[:, ::stride]
    rows_d = pix_rows[::stride]
    pts_d = points[::stride]
    # each pixel has at most one owning mask (the set is pixel-disjoint)
    mvalid_d = masks_d & mask_valid[:, None]
    owner = torch.argmax(mvalid_d.to(torch.int8), dim=0)
    covered = mvalid_d.any(dim=0)
    valid_px = covered & (rows_d >= 0)
    rows, counts = group_unique(owner, rows_d, valid_px, num_groups=m, capacity=k_cap)
    area_frac = masks.to(torch.float32).mean(dim=1)
    sel_px = masks & (pix_rows >= 0)[None, :]
    inf = float("inf")
    bmin = torch.where(sel_px[:, :, None], points[None], torch.full((), inf, device=dev)).amin(dim=1)
    bmax = torch.where(sel_px[:, :, None], points[None], torch.full((), -inf, device=dev)).amax(dim=1)
    extent = (bmax - bmin).amax(dim=-1)  # -inf for empty masks
    ok = mask_valid & (counts >= min_rows) & (area_frac <= max_area_frac) & (extent <= max_extent)
    if grid is not None:
        cgrid = vox.GridSpec(grid.voxel_size * COARSE_FACTOR, grid.origin)
        ck_pix = vox.keys_of(pts_d, rows_d >= 0, cgrid)
        ckeys, ccounts = group_unique(owner, ck_pix, valid_px, num_groups=m, capacity=k_cap)
        ckeys = _where_rows(ok, ckeys, I32_MAX)
        ccounts = torch.where(ok, ccounts, torch.zeros_like(ccounts))
        dsig = _dilated_signature(ckeys)
    else:
        ckeys = torch.full((m, k_cap), I32_MAX, dtype=torch.int32, device=dev)
        ccounts = torch.zeros(m, dtype=torch.int32, device=dev)
        dsig = torch.zeros((m, SIG_BUCKETS), dtype=torch.float32, device=dev)
    return InstanceSet(
        rows=_where_rows(ok, rows, I32_MAX),
        count=torch.where(ok, counts, torch.zeros_like(counts)),
        feat_sum=_where_rows(ok, f_masks.float(), 0.0),
        weight=ok.to(torch.float32),
        bbox_min=_where_rows(ok, bmin, inf),
        bbox_max=_where_rows(ok, bmax, -inf),
        valid=ok,
        ckeys=ckeys,
        ccount=ccounts,
        dsig=dsig,
    )


def recompute_coarse_keys(scene, inst: InstanceSet) -> InstanceSet:
    """Rebuild each instance's coarse key set, its count and its dilated
    signature from the scene's voxel positions (the reference's
    ``recompute_coarse_keys``).  The production fold runs
    ``coarse_only=True``, under which an instance without coarse keys never
    merges; a mapper state saved without them (or with the stale widths)
    reloads through this (``memory/checkpoint.py``).  Rows are scene rows,
    and a row's coarse key depends only on its mean position, so the sets
    equal those a fresh run holds."""
    i_cap, k_cap = inst.rows.shape
    vrows = inst.rows != I32_MAX
    safe = inst.rows.clamp(0, scene.key.shape[0] - 1).to(torch.int64)
    pts = scene.points()[safe]  # (I, K, 3)
    cgrid = vox.GridSpec(scene.grid.voxel_size * COARSE_FACTOR, scene.grid.origin)
    ck = vox.keys_of(pts.reshape(-1, 3), vrows.reshape(-1), cgrid)
    groups = torch.arange(i_cap, dtype=torch.int32, device=inst.rows.device)[:, None].expand(i_cap, k_cap).reshape(-1)
    valid = (vrows & inst.valid[:, None]).reshape(-1)
    ckeys, ccounts = group_unique(groups, ck, valid, num_groups=i_cap, capacity=k_cap)
    ckeys = _where_rows(inst.valid, ckeys, I32_MAX)
    return inst._replace(
        ckeys=ckeys,
        ccount=torch.where(inst.valid, ccounts, torch.zeros_like(ccounts)),
        dsig=_dilated_signature(ckeys),
    )


# ---------------------------------------------------------------------------
# Merge round
# ---------------------------------------------------------------------------


def _corrected(hits, probes, occupancy):
    """Hash-collision-corrected hit fraction: t/n = (h/n - p) / (1 - p)."""
    p = torch.clamp(occupancy, 0.0, 0.98)
    return torch.clamp((hits / probes - p) / (1.0 - p), 0.0, 1.0)


def _box_gates(bmin_a, bmax_a, bmin_b, bmax_b, pad: float):
    """(A, B) bbox IoU, containment over the smaller box, volume ratio."""
    bmin_a, bmax_a = bmin_a - pad, bmax_a + pad
    bmin_b, bmax_b = bmin_b - pad, bmax_b + pad
    lo = torch.maximum(bmin_a[:, None], bmin_b[None, :])
    hi = torch.minimum(bmax_a[:, None], bmax_b[None, :])
    inter = torch.clamp(hi - lo, min=0.0).prod(dim=-1)
    vol_a = torch.clamp(bmax_a - bmin_a, min=0.0).prod(dim=-1)
    vol_b = torch.clamp(bmax_b - bmin_b, min=0.0).prod(dim=-1)
    union = vol_a[:, None] + vol_b[None, :] - inter
    iou = inter / torch.clamp(union, min=1e-10)
    vmin = torch.minimum(vol_a[:, None], vol_b[None, :])
    cont = inter / torch.clamp(vmin, min=1e-10)
    vol_ratio = torch.maximum(vol_a[:, None], vol_b[None, :]) / torch.clamp(vmin, min=1e-10)
    return iou, cont, vol_ratio


def _union_extent(bmin_a, bmax_a, bmin_b, bmax_b) -> torch.Tensor:
    umin = torch.minimum(bmin_a[:, None], bmin_b[None, :])
    umax = torch.maximum(bmax_a[:, None], bmax_b[None, :])
    return (umax - umin).amax(dim=-1)


def _connected_components(adj: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """Min-label propagation with pointer jumping (adj symmetric, true
    diagonal on valid entries).  Returns the root label per node."""
    n = adj.shape[0]
    lab = torch.arange(n, dtype=torch.int64, device=adj.device)
    big = torch.full((), n, dtype=torch.int64, device=adj.device)
    for _ in range(iters):
        nbr = torch.where(adj, lab[None, :], big).amin(dim=1)
        lab = torch.minimum(lab, nbr)
        lab = torch.minimum(lab, lab[lab])
    return lab


def _scatter_rows(n: int, idx: torch.Tensor, src: torch.Tensor, reduce: str, fill: float) -> torch.Tensor:
    """out[(n+1, ...)] = fill, reduce src rows into out[idx]; returns out[:n]."""
    out = torch.full((n + 1,) + src.shape[1:], fill, dtype=src.dtype, device=src.device)
    index = idx.reshape((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
    return out.scatter_reduce(0, index, src, reduce, include_self=True)[:n]


def merge_round(
    inst: InstanceSet,
    overlap_thresh: float,
    iou_thresh: float,
    out_cap: int,
    bbox_pad: float = 0.0,
    coarse_only: bool = False,
    max_extent: float = float("inf"),
) -> InstanceSet:
    """One full merge pass over the whole set: gate by bbox IoU (or
    comparable-volume containment), estimate overlap from the signatures,
    merge connected components, compact the survivors (largest first) into
    `out_cap` lanes."""
    i_cap, k_cap = inst.rows.shape
    dev = inst.rows.device
    vrows = inst.rows != I32_MAX
    vck = inst.ckeys != I32_MAX
    csig = _signatures(inst.ckeys, vck)
    cinter = csig @ csig.T
    ccnt = torch.clamp(csig.sum(-1), min=1.0)
    has_any = vck.any(-1)
    has_c = has_any[:, None] & has_any[None, :]
    occ_c = csig.sum(-1) / float(SIG_BUCKETS)
    a_c = _corrected(cinter, ccnt[:, None], occ_c[None, :])
    zero = torch.zeros((), device=dev)
    cratio = torch.where(has_c, torch.maximum(a_c, a_c.T), zero)
    dinter = csig @ inst.dsig.T
    occ_d = inst.dsig.sum(-1) / float(SIG_BUCKETS)
    a_d = _corrected(dinter, ccnt[:, None], occ_d[None, :])
    cratio = torch.where(has_c, torch.maximum(cratio, torch.maximum(a_d, a_d.T)), zero)
    if coarse_only:
        ratio = cratio
    else:
        sig = _signatures(inst.rows, vrows)
        inter = sig @ sig.T
        cnt = torch.clamp(sig.sum(-1), min=1.0)
        ratio = torch.maximum(inter / torch.minimum(cnt[:, None], cnt[None, :]), cratio)
    iou, cont, vol_ratio = _box_gates(inst.bbox_min, inst.bbox_max, inst.bbox_min, inst.bbox_max, bbox_pad)
    vv = inst.valid[:, None] & inst.valid[None, :]
    adj = vv & ((iou > iou_thresh) | ((cont > 0.5) & (vol_ratio < 64.0))) & (ratio > overlap_thresh)
    adj = adj & (_union_extent(inst.bbox_min, inst.bbox_max, inst.bbox_min, inst.bbox_max) <= max_extent)
    adj = adj | (torch.eye(i_cap, dtype=torch.bool, device=dev) & inst.valid[:, None])
    root = _connected_components(adj)

    # union row + coarse-key sets per root
    groups = root[:, None].expand(i_cap, k_cap).reshape(-1)
    valid = (vrows & inst.valid[:, None]).reshape(-1)
    rows_u, counts_u = group_unique(groups, inst.rows.reshape(-1), valid, num_groups=i_cap, capacity=k_cap)
    ck_cap = inst.ckeys.shape[1]
    cgroups = root[:, None].expand(i_cap, ck_cap).reshape(-1)
    cvalid = (vck & inst.valid[:, None]).reshape(-1)
    ckeys_u, ccounts_u = group_unique(cgroups, inst.ckeys.reshape(-1), cvalid, num_groups=i_cap, capacity=ck_cap)

    # reduce per root (dropped lanes go to the trash row i_cap)
    safe_root = torch.where(inst.valid, root, torch.full_like(root, i_cap))
    feat_sum = _scatter_rows(i_cap, safe_root, inst.feat_sum, "sum", 0.0)
    weight = _scatter_rows(i_cap, safe_root, inst.weight, "sum", 0.0)
    bbox_min = _scatter_rows(i_cap, safe_root, inst.bbox_min, "amin", float("inf"))
    bbox_max = _scatter_rows(i_cap, safe_root, inst.bbox_max, "amax", float("-inf"))
    dsig_u = _scatter_rows(i_cap, safe_root, inst.dsig, "amax", 0.0)
    is_root = inst.valid & (root == torch.arange(i_cap, device=dev))

    # compact: biggest instances first into out_cap lanes (ties: lower lane)
    order_key = torch.where(is_root, counts_u, torch.full_like(counts_u, -1))
    order = torch.sort(order_key, descending=True, stable=True).indices[:out_cap]
    keep = order_key[order] > 0
    return InstanceSet(
        rows=_where_rows(keep, rows_u[order], I32_MAX),
        count=torch.where(keep, counts_u[order], 0),
        feat_sum=_where_rows(keep, feat_sum[order], 0.0),
        weight=torch.where(keep, weight[order], 0.0),
        bbox_min=_where_rows(keep, bbox_min[order], float("inf")),
        bbox_max=_where_rows(keep, bbox_max[order], float("-inf")),
        valid=keep,
        ckeys=_where_rows(keep, ckeys_u[order], I32_MAX),
        ccount=torch.where(keep, ccounts_u[order], 0),
        dsig=_where_rows(keep, dsig_u[order], 0.0),
    )


def seq_merge_step(
    global_inst: InstanceSet,
    frame_inst: InstanceSet,
    overlap_thresh: float,
    iou_thresh: float,
    bbox_pad: float = 0.0,
    coarse_only: bool = False,
    max_extent: float = float("inf"),
) -> InstanceSet:
    """Fold one frame into the global set with a full merge round."""
    return merge_round(
        concat(global_inst, frame_inst), overlap_thresh, iou_thresh, global_inst.rows.shape[0],
        bbox_pad=bbox_pad, coarse_only=coarse_only, max_extent=max_extent,
    )


# ---------------------------------------------------------------------------
# Paired per-frame fold
# ---------------------------------------------------------------------------


def _union_lanes(
    table: torch.Tensor,  # (G, K) sorted unique, I32_MAX pad
    counts: torch.Tensor,  # (G,)
    sel_idx: torch.Tensor,  # (M,) distinct target lanes
    sel_valid: torch.Tensor,  # (M,)
    other: torch.Tensor,  # (M, K)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Set-union other[j] into lane sel_idx[j] (where sel_valid), keeping the
    K smallest unique values; untouched lanes are unchanged."""
    g, k = table.shape
    m = other.shape[0]
    safe = torch.where(sel_valid, sel_idx, torch.full_like(sel_idx, g))
    wide = torch.cat([table, torch.full((1, k), I32_MAX, dtype=table.dtype, device=table.device)])
    a = wide[safe]
    u = torch.sort(torch.cat([a, other], dim=1), dim=1).values
    prev = torch.cat([torch.full((m, 1), -1, dtype=u.dtype, device=u.device), u[:, :-1]], dim=1)
    keep = (u != I32_MAX) & (u != prev)
    uniq = torch.sort(torch.where(keep, u, torch.full_like(u, I32_MAX)), dim=1).values[:, :k]
    wide[safe] = uniq
    cnt = torch.clamp(keep.sum(dim=1), max=k).to(counts.dtype)
    wcnt = torch.cat([counts, torch.zeros(1, dtype=counts.dtype, device=counts.device)])
    wcnt[safe] = cnt
    return wide[:g], wcnt[:g]


def paired_merge_step(
    global_inst: InstanceSet,
    frame_inst: InstanceSet,
    overlap_thresh: float,
    iou_thresh: float,
    bbox_pad: float = 0.0,
    coarse_only: bool = False,
    max_extent: float = float("inf"),
) -> InstanceSet:
    """Windowed per-frame fold: each frame instance merges into at most one
    existing global instance (one winner per lane); the rest append into
    free lanes.  Unmerged frame instances with no free lane are dropped, as
    in the reference; the periodic full round recompacts."""
    gcap = global_inst.rows.shape[0]
    fcap = frame_inst.rows.shape[0]
    dev = global_inst.rows.device
    zero = torch.zeros((), device=dev)

    # cross overlap ratio (coarse cells, both directions, corrected)
    vck_g = global_inst.ckeys != I32_MAX
    vck_f = frame_inst.ckeys != I32_MAX
    csig_g = _signatures(global_inst.ckeys, vck_g)
    csig_f = _signatures(frame_inst.ckeys, vck_f)
    cnt_g = torch.clamp(csig_g.sum(-1), min=1.0)
    cnt_f = torch.clamp(csig_f.sum(-1), min=1.0)
    occ_g = csig_g.sum(-1) / float(SIG_BUCKETS)
    occ_f = csig_f.sum(-1) / float(SIG_BUCKETS)
    occ_dg = global_inst.dsig.sum(-1) / float(SIG_BUCKETS)
    occ_df = frame_inst.dsig.sum(-1) / float(SIG_BUCKETS)
    inter = csig_f @ csig_g.T
    a_fg = _corrected(inter, cnt_f[:, None], occ_g[None, :])
    a_gf = _corrected(inter, cnt_g[None, :], occ_f[:, None])
    d_fg = _corrected(csig_f @ global_inst.dsig.T, cnt_f[:, None], occ_dg[None, :])
    d_gf = _corrected(frame_inst.dsig @ csig_g.T, cnt_g[None, :], occ_df[:, None])
    has_c = vck_f.any(-1)[:, None] & vck_g.any(-1)[None, :]
    ratio = torch.where(has_c, torch.maximum(torch.maximum(a_fg, a_gf), torch.maximum(d_fg, d_gf)), zero)
    if not coarse_only:
        sig_f = _signatures(frame_inst.rows, frame_inst.rows != I32_MAX)
        sig_g = _signatures(global_inst.rows, global_inst.rows != I32_MAX)
        rint = sig_f @ sig_g.T
        rcnt_f = torch.clamp(sig_f.sum(-1), min=1.0)
        rcnt_g = torch.clamp(sig_g.sum(-1), min=1.0)
        ratio = torch.maximum(ratio, rint / torch.minimum(rcnt_f[:, None], rcnt_g[None, :]))

    # bbox gates (frame x global rectangle)
    iou, cont, vol_ratio = _box_gates(
        frame_inst.bbox_min, frame_inst.bbox_max, global_inst.bbox_min, global_inst.bbox_max, bbox_pad
    )
    vv = frame_inst.valid[:, None] & global_inst.valid[None, :]
    adj = vv & ((iou > iou_thresh) | ((cont > 0.5) & (vol_ratio < 64.0))) & (ratio > overlap_thresh)
    uext = _union_extent(frame_inst.bbox_min, frame_inst.bbox_max, global_inst.bbox_min, global_inst.bbox_max)
    adj = adj & (uext <= max_extent)

    # one target per frame instance; one winner per lane (argmax: first max)
    score = torch.where(adj, ratio, torch.full_like(ratio, -1.0))
    best_r = score.amax(dim=1)
    best_g = torch.argmax(score, dim=1)
    merged_f = best_r > 0.0
    lanes = torch.arange(gcap, device=dev)
    mm = torch.where(merged_f[:, None] & (best_g[:, None] == lanes[None, :]), best_r[:, None], torch.full_like(score, -1.0))
    win_f = torch.argmax(mm, dim=0)
    has_w = mm.amax(dim=0) > 0.0
    winner_used = merged_f & (win_f[best_g] == torch.arange(fcap, device=dev)) & has_w[best_g]

    # union winner rows/keys into their lanes
    rows_u, count_u = _union_lanes(global_inst.rows, global_inst.count, best_g, winner_used, frame_inst.rows)
    ckeys_u, ccount_u = _union_lanes(global_inst.ckeys, global_inst.ccount, best_g, winner_used, frame_inst.ckeys)
    wsel = has_w.to(torch.float32)
    feat_sum = global_inst.feat_sum + wsel[:, None] * frame_inst.feat_sum[win_f]
    weight = global_inst.weight + wsel * frame_inst.weight[win_f]
    hw = has_w[:, None]
    bbox_min = torch.where(hw, torch.minimum(global_inst.bbox_min, frame_inst.bbox_min[win_f]), global_inst.bbox_min)
    bbox_max = torch.where(hw, torch.maximum(global_inst.bbox_max, frame_inst.bbox_max[win_f]), global_inst.bbox_max)
    dsig = torch.where(hw, torch.maximum(global_inst.dsig, frame_inst.dsig[win_f]), global_inst.dsig)
    valid = global_inst.valid

    # append unmerged frame instances into free lanes (overflow drops)
    unmerged = frame_inst.valid & ~winner_used
    free = ~valid
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    n_free = free.sum()
    lane_of_rank = torch.full((gcap + 1,), gcap, dtype=torch.int64, device=dev)
    lane_of_rank[torch.where(free, free_rank, torch.full_like(free_rank, gcap))] = lanes
    unm_rank = torch.cumsum(unmerged.to(torch.int64), 0) - 1
    dest = torch.where(
        unmerged & (unm_rank < n_free),
        lane_of_rank[torch.clamp(unm_rank, 0, gcap)],
        torch.full_like(unm_rank, gcap),
    )

    def put(tab, vals):
        wide = torch.cat([tab, tab[-1:]], dim=0)
        wide[dest] = vals
        return wide[:gcap]

    placed = put(torch.zeros(gcap, dtype=torch.bool, device=dev), unmerged)
    return InstanceSet(
        rows=put(rows_u, frame_inst.rows),
        count=put(count_u, frame_inst.count),
        feat_sum=put(feat_sum, frame_inst.feat_sum),
        weight=put(weight, frame_inst.weight),
        bbox_min=put(bbox_min, frame_inst.bbox_min),
        bbox_max=put(bbox_max, frame_inst.bbox_max),
        valid=valid | placed,
        ckeys=put(ckeys_u, frame_inst.ckeys),
        ccount=put(ccount_u, frame_inst.ccount),
        dsig=put(dsig, frame_inst.dsig),
    )
