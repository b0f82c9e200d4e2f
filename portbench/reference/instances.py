"""Plain instance table of a walk: the paired fold of per-frame instances
and finalize's last merge round.

A frame's instances are its valid masks lifted to the scene: each mask
owns the pixels it covers (the first valid mask where several do), and
on every `stride`-th pixel with a scene row it collects the sorted
unique rows and the sorted unique voxel keys (the `k_cap` smallest of
each, with their counts clipped to `k_cap`).  Its box spans every pixel
of the mask with a scene row; its feature is the mask's feature, its
weight 1.  A mask with fewer than `min_rows` rows, more than
`max_area_frac` of the frame or a box side over `max_extent` is not an
instance.  Each instance also carries its keys' dilated signature: the
hash buckets of every key and its 26 neighbours on the packed key layout.

Two instances overlap by the hashed share of one's keys among the
other's keys or their dilation, corrected for the chance hits of a
bucket occupancy, both ways: with the box gates (IoU, or containment at
comparable volume) and the extent of their union they decide a merge.
The paired fold merges each frame instance into at most one table lane
(its best overlap; one winner a lane, the lowest frame lane on ties) and
appends the rest into free lanes in order; every `full_round_every`
frames, and in finalize, a full round merges the connected components of
the whole table and compacts them, largest first.  Finalize then drops
instances of fewer than 10 rows.

The gates are float32 arithmetic on integer counts and on the boxes,
taken as the program states them, so the same inputs give the same
decisions; the sets, components and order are worked out by plain means
(unique, union-find, a stable sort).  Written for the benchmark from that
description; it imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

PAD = 2**31 - 1  # pads a lane's rows and keys
BUCKETS = 4096
HASH = 2654435761
SHIFT = 32 - BUCKETS.bit_length() + 1
# the 26 neighbours and the centre of a key packed as x << 20 | y << 9 | z
NEIGHBOURS = [(dx << 20) + (dy << 9) + dz for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
FIELDS = ("rows", "count", "ckeys", "ccount", "feat", "weight", "bmin", "bmax", "dsig", "valid")


def buckets(keys: torch.Tensor) -> torch.Tensor:
    """The hash bucket of each int64 key (its low 32 bits)."""
    return (((keys & 0xFFFFFFFF) * HASH) & 0xFFFFFFFF) >> SHIFT


def occupancy(keys: torch.Tensor, valid=None) -> torch.Tensor:
    """(L, K) key sets (the `valid` entries, by default those that are not
    PAD) -> (L, BUCKETS) float32 0/1 bucket occupancy."""
    valid = keys != PAD if valid is None else valid
    out = torch.zeros((keys.shape[0], BUCKETS + 1), dtype=torch.float32, device=keys.device)
    out.scatter_(1, torch.where(valid, buckets(keys), torch.full_like(keys, BUCKETS)), 1.0)
    return out[:, :BUCKETS]


def dilated(keys: torch.Tensor) -> torch.Tensor:
    """(L, K) padded key sets -> (L, BUCKETS) occupancy of each set with
    every key's 26 neighbours."""
    offs = torch.tensor(NEIGHBOURS, dtype=torch.int64, device=keys.device)
    nk = (keys[:, :, None] + offs).reshape(keys.shape[0], -1)
    return occupancy(nk, (keys != PAD)[:, :, None].expand(-1, -1, len(NEIGHBOURS)).reshape(keys.shape[0], -1))


def empty(cap: int, k_cap: int, d: int, device) -> Dict[str, torch.Tensor]:
    inf = float("inf")
    return {"rows": torch.full((cap, k_cap), PAD, dtype=torch.int64, device=device),
            "count": torch.zeros(cap, dtype=torch.int64, device=device),
            "ckeys": torch.full((cap, k_cap), PAD, dtype=torch.int64, device=device),
            "ccount": torch.zeros(cap, dtype=torch.int64, device=device),
            "feat": torch.zeros((cap, d), dtype=torch.float64, device=device),
            "weight": torch.zeros(cap, dtype=torch.float64, device=device),
            "bmin": torch.full((cap, 3), inf, dtype=torch.float32, device=device),
            "bmax": torch.full((cap, 3), -inf, dtype=torch.float32, device=device),
            "dsig": torch.zeros((cap, BUCKETS), dtype=torch.float32, device=device),
            "valid": torch.zeros(cap, dtype=torch.bool, device=device)}


def _capped(values: torch.Tensor, k_cap: int):
    """Sorted unique values padded to k_cap (the smallest kept), and their
    count clipped to k_cap."""
    u = torch.unique(values)[:k_cap]
    out = torch.full((k_cap,), PAD, dtype=torch.int64, device=values.device)
    out[: u.numel()] = u
    return out, u.numel()


def frame_set(masks, valid, f_masks, rows, keys, pts, stride: int, k_cap: int, min_rows: int = 3,
              max_area_frac: float = 1.0, max_extent: float = float("inf")) -> Dict[str, torch.Tensor]:
    """One frame's instances, a lane a mask.  masks (M, P) bool, valid
    (M,), f_masks (M, D), rows (P,) the pixels' scene rows (-1 none), keys
    (P,) their voxel keys, pts (P, 3) their world points."""
    m = masks.shape[0]
    t = empty(m, k_cap, f_masks.shape[-1], masks.device)
    md = masks[:, ::stride] & valid[:, None]
    rd, kd = rows[::stride].long(), keys[::stride].long()
    first = md & (md.cumsum(0) == 1)  # each pixel's first valid mask
    has_row = rows >= 0
    area = masks.to(torch.float32).mean(dim=1)
    for j in range(m):
        sel = first[j] & (rd >= 0)
        r, n = _capped(rd[sel], k_cap)
        px = masks[j] & has_row
        if bool(px.any()):
            t["bmin"][j], t["bmax"][j] = pts[px].amin(0), pts[px].amax(0)
        extent = float((t["bmax"][j] - t["bmin"][j]).amax())
        if not (bool(valid[j]) and n >= min_rows and bool(area[j] <= max_area_frac) and extent <= max_extent):
            t["bmin"][j], t["bmax"][j] = float("inf"), float("-inf")
            continue
        ck, nc = _capped(kd[sel], k_cap)
        t["rows"][j], t["count"][j], t["ckeys"][j], t["ccount"][j] = r, n, ck, nc
        t["feat"][j], t["weight"][j], t["valid"][j] = f_masks[j].double(), 1.0, True
    t["dsig"] = dilated(t["ckeys"])
    return t


def _corrected(hits, probes, occ):
    p = torch.clamp(occ, 0.0, 0.98)
    return torch.clamp((hits / probes - p) / (1.0 - p), 0.0, 1.0)


def _gates(a, b, pad: float, iou_thresh: float, max_extent: float):
    """(A, B): the box gates and the extent of the union."""
    amin, amax, bmin, bmax = a["bmin"] - pad, a["bmax"] + pad, b["bmin"] - pad, b["bmax"] + pad
    lo = torch.maximum(amin[:, None], bmin[None, :])
    hi = torch.minimum(amax[:, None], bmax[None, :])
    inter = torch.clamp(hi - lo, min=0.0).prod(dim=-1)
    va = torch.clamp(amax - amin, min=0.0).prod(dim=-1)
    vb = torch.clamp(bmax - bmin, min=0.0).prod(dim=-1)
    iou = inter / torch.clamp(va[:, None] + vb[None, :] - inter, min=1e-10)
    vmin = torch.minimum(va[:, None], vb[None, :])
    cont = inter / torch.clamp(vmin, min=1e-10)
    vol_ratio = torch.maximum(va[:, None], vb[None, :]) / torch.clamp(vmin, min=1e-10)
    ext = (torch.maximum(a["bmax"][:, None], b["bmax"][None, :])
           - torch.minimum(a["bmin"][:, None], b["bmin"][None, :])).amax(dim=-1)
    return ((iou > iou_thresh) | ((cont > 0.5) & (vol_ratio < 64.0))) & (ext <= max_extent)


def _union(a: torch.Tensor, b: torch.Tensor, k_cap: int):
    both = torch.cat([a, b])
    return _capped(both[both != PAD], k_cap)


def paired(table, frame, overlap_thresh: float, iou_thresh: float, pad: float, max_extent: float):
    """Fold one frame's instances into the table."""
    cap, k_cap = table["rows"].shape
    cs_t, cs_f = occupancy(table["ckeys"]), occupancy(frame["ckeys"])
    n_t, n_f = cs_t.sum(-1), cs_f.sum(-1)
    cnt_t, cnt_f = torch.clamp(n_t, min=1.0), torch.clamp(n_f, min=1.0)
    occ_t, occ_f = n_t / float(BUCKETS), n_f / float(BUCKETS)
    docc_t, docc_f = table["dsig"].sum(-1) / float(BUCKETS), frame["dsig"].sum(-1) / float(BUCKETS)
    inter = cs_f @ cs_t.T
    ratio = torch.maximum(torch.maximum(_corrected(inter, cnt_f[:, None], occ_t[None, :]),
                                        _corrected(inter, cnt_t[None, :], occ_f[:, None])),
                          torch.maximum(_corrected(cs_f @ table["dsig"].T, cnt_f[:, None], docc_t[None, :]),
                                        _corrected(frame["dsig"] @ cs_t.T, cnt_t[None, :], docc_f[:, None])))
    has = (frame["ckeys"] != PAD).any(-1)[:, None] & (table["ckeys"] != PAD).any(-1)[None, :]
    ratio = torch.where(has, ratio, torch.zeros((), device=ratio.device))
    adj = (frame["valid"][:, None] & table["valid"][None, :] & _gates(frame, table, pad, iou_thresh, max_extent)
           & (ratio > overlap_thresh))
    score = torch.where(adj, ratio, torch.full_like(ratio, -1.0)).cpu()
    winner: Dict[int, int] = {}
    best = {}
    for f in range(score.shape[0]):
        r, g = float(score[f].max()), int(torch.argmax(score[f]))
        if r > 0.0:
            best[f] = r
            if g not in winner or r > best[winner[g]]:
                winner[g] = f
    out = {k: v.clone() for k, v in table.items()}
    for g, f in winner.items():
        out["rows"][g], out["count"][g] = _union(table["rows"][g], frame["rows"][f], k_cap)
        out["ckeys"][g], out["ccount"][g] = _union(table["ckeys"][g], frame["ckeys"][f], k_cap)
        out["feat"][g] += frame["feat"][f]
        out["weight"][g] += frame["weight"][f]
        out["bmin"][g] = torch.minimum(table["bmin"][g], frame["bmin"][f])
        out["bmax"][g] = torch.maximum(table["bmax"][g], frame["bmax"][f])
        out["dsig"][g] = torch.maximum(table["dsig"][g], frame["dsig"][f])
    merged = set(winner.values())
    free = [g for g in range(cap) if not bool(table["valid"][g])]
    new = [f for f in range(score.shape[0]) if bool(frame["valid"][f]) and f not in merged]
    for g, f in zip(free, new):
        for k in FIELDS:
            out[k][g] = frame[k][f]
    return out


def _components(adj: torch.Tensor) -> List[int]:
    """Union-find over a symmetric adjacency: each node's root is the
    lowest node of its component."""
    n = adj.shape[0]
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in torch.nonzero(adj).tolist():
        a, b = find(i), find(j)
        if a != b:
            parent[max(a, b)] = min(a, b)
    return [find(i) for i in range(n)]


def merge_round(table, overlap_thresh: float, iou_thresh: float, pad: float, max_extent: float):
    """A full round: merge the connected components of the whole table and
    compact them, largest first (ties: the lower lane), into as many lanes."""
    cap, k_cap = table["rows"].shape
    cs = occupancy(table["ckeys"])
    n = cs.sum(-1)
    cnt, occ = torch.clamp(n, min=1.0), n / float(BUCKETS)
    docc = table["dsig"].sum(-1) / float(BUCKETS)
    has = (table["ckeys"] != PAD).any(-1)
    has = has[:, None] & has[None, :]
    zero = torch.zeros((), device=cs.device)
    a_c = _corrected(cs @ cs.T, cnt[:, None], occ[None, :])
    ratio = torch.where(has, torch.maximum(a_c, a_c.T), zero)
    a_d = _corrected(cs @ table["dsig"].T, cnt[:, None], docc[None, :])
    ratio = torch.where(has, torch.maximum(ratio, torch.maximum(a_d, a_d.T)), zero)
    valid = table["valid"]
    adj = valid[:, None] & valid[None, :] & _gates(table, table, pad, iou_thresh, max_extent) & (ratio > overlap_thresh)
    root = _components(adj.cpu())
    members: Dict[int, List[int]] = {}
    for i in range(cap):
        if bool(valid[i]):
            members.setdefault(root[i], []).append(i)
    merged = {}
    for r, lanes in members.items():
        idx = torch.tensor(lanes, device=cs.device)
        rows, c = _capped(table["rows"][idx][table["rows"][idx] != PAD], k_cap)
        ckeys, cc = _capped(table["ckeys"][idx][table["ckeys"][idx] != PAD], k_cap)
        merged[r] = {"rows": rows, "count": c, "ckeys": ckeys, "ccount": cc, "feat": table["feat"][idx].sum(0),
                     "weight": table["weight"][idx].sum(0), "bmin": table["bmin"][idx].amin(0),
                     "bmax": table["bmax"][idx].amax(0), "dsig": table["dsig"][idx].amax(0), "valid": True}
    order = sorted(range(cap), key=lambda i: -(merged[i]["count"] if i in merged else -1))
    out = empty(cap, k_cap, table["feat"].shape[-1], cs.device)
    for lane, i in enumerate(order):
        if i in merged and merged[i]["count"] > 0:
            for k in FIELDS:
                out[k][lane] = merged[i][k]
    return out


def fold(frames: Sequence[dict], cfg: dict) -> Dict[str, torch.Tensor]:
    """The instance table after finalize's merge round and filter.
    `frames`: dicts of masks (M, P), valid, f_masks, rows, keys, pts (as
    ``frame_set``), in order.  `cfg`: capacity, k_cap, d, stride,
    overlap_thresh, iou_thresh, pad, max_extent, max_area_frac,
    full_round_every."""
    c = cfg
    table = empty(c["capacity"], c["k_cap"], c["d"], frames[0]["masks"].device)
    since = 0
    gate = dict(pad=c["pad"], max_extent=c["max_extent"])
    for f in frames:
        fs = frame_set(f["masks"], f["valid"], f["f_masks"], f["rows"], f["keys"], f["pts"], c["stride"], c["k_cap"],
                       max_area_frac=c["max_area_frac"], max_extent=c["max_extent"])
        table = paired(table, fs, c["overlap_thresh"], c["iou_thresh"], **gate)
        since += 1
        if since >= c["full_round_every"]:
            table = merge_round(table, c["overlap_thresh"], c["iou_thresh"], **gate)
            since = 0
    table = merge_round(table, c["overlap_thresh"], c["iou_thresh"], **gate)
    table["valid"] = table["valid"] & (table["count"] >= 10)
    return table


def compare(ref: Dict[str, torch.Tensor], prog: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The program's table (the same fields, lane by lane) against `ref`:
    the lanes whose validity, rows, keys, counts or weight differ, and,
    over the valid lanes that agree, the largest gap of the feature sums
    over their weight and of the boxes (metres); both gaps read 1 when no
    valid lane agrees."""
    valid_r, valid_p = ref["valid"], prog["valid"].bool()
    both = valid_r & valid_p
    same = both.clone()
    for k in ("rows", "ckeys"):
        same &= (prog[k].long() == ref[k]).all(-1)
    for k in ("count", "ccount"):
        same &= prog[k].long() == ref[k]
    same &= prog["weight"].double() == ref["weight"]
    differing = int((valid_r != valid_p).sum()) + int((both & ~same).sum())
    if not bool(same.any()):
        return {"instances_differing": float(differing), "instance_feat_gap": 1.0, "instance_box_gap": 1.0}
    fgap = torch.linalg.norm(prog["feat"][same].double() - ref["feat"][same], dim=-1) / ref["weight"][same]
    bgap = torch.cat([(prog[k][same] - ref[k][same]).abs().reshape(-1) for k in ("bmin", "bmax")])
    return {"instances_differing": float(differing), "instance_feat_gap": float(fgap.max()),
            "instance_box_gap": float(bgap.max())}
