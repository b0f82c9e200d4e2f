"""Fixed-capacity mask-set ops (counterpart of holoagent_tpu/ops/masks.py):
stability scores, boxes, greedy NMS, the disjoint carve."""

from __future__ import annotations

import torch


def mask_areas(masks: torch.Tensor) -> torch.Tensor:
    """(M, H, W) bool -> (M,) float areas."""
    return masks.to(torch.float32).sum(dim=(1, 2))


def stability_scores(logits: torch.Tensor, offset: float = 1.0) -> torch.Tensor:
    """SAM stability: IoU between the mask thresholded at +offset and -offset."""
    hi = (logits > offset).to(torch.float32).sum(dim=(1, 2))
    lo = (logits > -offset).to(torch.float32).sum(dim=(1, 2))
    return hi / torch.clamp(lo, min=1.0)


def boxes_from_masks(masks: torch.Tensor) -> torch.Tensor:
    """(M, H, W) bool -> (M, 4) [y0, x0, y1, x1] pixel boxes (y1/x1
    exclusive).  Empty masks give zero-area boxes at the origin."""
    _, h, w = masks.shape
    dev = masks.device
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    big = torch.tensor(1 << 30, dtype=torch.int32, device=dev)
    neg = torch.tensor(-1, dtype=torch.int32, device=dev)
    y0 = torch.where(masks, ys, big).amin(dim=(1, 2))
    x0 = torch.where(masks, xs, big).amin(dim=(1, 2))
    y1 = torch.where(masks, ys, neg).amax(dim=(1, 2)) + 1
    x1 = torch.where(masks, xs, neg).amax(dim=(1, 2)) + 1
    box = torch.stack([y0, x0, y1, x1], dim=-1)
    empty = (y1 <= 0)[:, None]
    return torch.where(empty, torch.zeros_like(box), box).to(torch.float32)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, 4) x (N, 4) -> (M, N) IoU."""
    y0 = torch.maximum(a[:, None, 0], b[None, :, 0])
    x0 = torch.maximum(a[:, None, 1], b[None, :, 1])
    y1 = torch.minimum(a[:, None, 2], b[None, :, 2])
    x1 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(y1 - y0, min=0) * torch.clamp(x1 - x0, min=0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms(
    boxes: torch.Tensor,  # (M, 4)
    scores: torch.Tensor,  # (M,)
    valid: torch.Tensor,  # (M,)
    iou_thresh: float = 0.7,
) -> torch.Tensor:
    """Greedy box NMS over a fixed candidate set; returns the keep mask (M,).

    Candidates go in score order (stable); one is kept iff no higher-scoring
    kept candidate overlaps it above the threshold.  This is the reference's
    sequential ``fori_loop`` as a Python loop of small device ops: at SAM's
    3 * 12^2 = 432 candidates it issues a few hundred tiny launches."""
    m = boxes.shape[0]
    neg_inf = torch.full_like(scores, float("-inf"))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), stable=True)
    v = valid[order]
    iou = box_iou(boxes[order], boxes[order])
    keep_sorted = torch.zeros(m, dtype=torch.bool, device=boxes.device)
    for i in range(m):
        sup = (iou[i, :i] > iou_thresh) & keep_sorted[:i]
        keep_sorted[i] = v[i] & ~sup.any()
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep


def to_disjoint(masks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Make the mask set pixel-disjoint: every covered pixel goes to its
    smallest covering valid mask (ties to the lower index)."""
    m = masks.shape[0]
    flat = masks.reshape(m, -1)
    inf = torch.tensor(float("inf"), device=masks.device)
    area = torch.where(valid, flat.sum(-1).to(torch.float32), inf)
    key = torch.where(flat & valid[:, None], area[:, None], inf)  # (M, P)
    owner = torch.argmin(key, dim=0)  # (P,)
    owned = key.gather(0, owner[None])[0] < inf
    lane = torch.arange(m, device=masks.device)[:, None]
    out = flat & owned[None, :] & (lane == owner[None, :])
    return out.reshape(masks.shape)
