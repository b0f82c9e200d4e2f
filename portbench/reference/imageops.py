"""Plain image and mask operations of the reference, in float32 PyTorch.

Frozen copy of the port's ``ops/resize.py`` (``jax.image.resize``'s
antialiased linear and Keys cubic weights), ``ops/crop_resize.py`` and the
parts of ``ops/masks.py`` and ``models/sam.py`` that select a frame's
masks, taken at commit b62fedabdce77346f1a976bf9b6f57fc0f42ce1b.  The
benchmark's reference computes with these; it imports nothing of the
program.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def weight_matrix(in_size: int, out_size: int, method: str, device=None) -> torch.Tensor:
    """(in_size, out_size) float32 resampling weights, antialiased when
    downsampling."""
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample_f[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """Resample every dimension of `x` whose size changes."""
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            w = weight_matrix(n_in, n_out, method, x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


def _interp_weights(start, end, out_size: int, in_size: int) -> torch.Tensor:
    dev = start.device
    t = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / out_size
    pos = start[:, None] + t[None, :] * (end - start)[:, None] - 0.5
    pos = torch.clamp(pos, 0.0, in_size - 1.0)
    i0 = torch.floor(pos).to(torch.int64)
    f = pos - i0
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    cols = torch.arange(in_size, device=dev)
    zero = torch.zeros((), device=dev)
    w0 = torch.where(cols[None, None, :] == i0[:, :, None], (1.0 - f)[:, :, None], zero)
    w1 = torch.where(cols[None, None, :] == i1[:, :, None], f[:, :, None], zero)
    return w0 + w1


def crop_and_resize(image, boxes, out_size: int, masks=None) -> torch.Tensor:
    """Bilinear crops of (H, W, C) `image` at (M, 4) [y0, x0, y1, x1] boxes;
    `masks` (M, H, W) blanks each crop's background."""
    h, w, _ = image.shape
    wy = _interp_weights(boxes[:, 0], boxes[:, 2], out_size, h)
    wx = _interp_weights(boxes[:, 1], boxes[:, 3], out_size, w)
    tmp = torch.einsum("msh,hwc->mswc", wy, image.float())
    out = torch.einsum("mtw,mswc->mstc", wx, tmp).to(image.dtype)
    if masks is not None:
        tmpm = torch.einsum("msh,mhw->msw", wy, masks.to(torch.float32))
        mv = torch.einsum("mtw,msw->mst", wx, tmpm)
        out = out * (mv > 0.5)[..., None].to(image.dtype)
    return out


def expand_boxes(boxes, margin: float, h: int, w: int) -> torch.Tensor:
    y0 = torch.clamp(boxes[:, 0] - margin, 0, h)
    x0 = torch.clamp(boxes[:, 1] - margin, 0, w)
    y1 = torch.clamp(boxes[:, 2] + margin, 0, h)
    x1 = torch.clamp(boxes[:, 3] + margin, 0, w)
    return torch.stack([y0, x0, y1, x1], dim=-1)


def stability_scores(logits, offset: float = 1.0):
    hi = (logits > offset).to(torch.float32).sum(dim=(1, 2))
    lo = (logits > -offset).to(torch.float32).sum(dim=(1, 2))
    return hi / torch.clamp(lo, min=1.0)


def boxes_from_masks(masks) -> torch.Tensor:
    """(M, H, W) bool -> (M, 4) [y0, x0, y1, x1] (exclusive ends); an empty
    mask gives the zero box."""
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
    return torch.where((y1 <= 0)[:, None], torch.zeros_like(box), box).to(torch.float32)


def box_iou(a, b):
    y0 = torch.maximum(a[:, None, 0], b[None, :, 0])
    x0 = torch.maximum(a[:, None, 1], b[None, :, 1])
    y1 = torch.minimum(a[:, None, 2], b[None, :, 2])
    x1 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(y1 - y0, min=0) * torch.clamp(x1 - x0, min=0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter, min=1e-9)


def nms(boxes, scores, valid, iou_thresh: float) -> torch.Tensor:
    """Greedy NMS in score order (stable): a candidate is kept iff no kept
    higher-scoring candidate overlaps it above the threshold.  Runs on the
    host, one candidate at a time."""
    order = torch.argsort(-torch.where(valid, scores, torch.full_like(scores, float("-inf"))), stable=True)
    v = valid[order].cpu().numpy()
    over = (box_iou(boxes[order], boxes[order]) > iou_thresh).cpu().numpy()
    keep_sorted = np.zeros(len(v), bool)
    for i in range(len(v)):
        keep_sorted[i] = v[i] and not (over[i, :i] & keep_sorted[:i]).any()
    keep = torch.zeros(len(v), dtype=torch.bool, device=boxes.device)
    keep[order] = torch.from_numpy(keep_sorted).to(boxes.device)
    return keep


def to_disjoint(masks, valid) -> torch.Tensor:
    """Each covered pixel to its smallest covering valid mask (ties to the
    lower index)."""
    m = masks.shape[0]
    flat = masks.reshape(m, -1)
    inf = torch.tensor(float("inf"), device=masks.device)
    area = torch.where(valid, flat.sum(-1).to(torch.float32), inf)
    key = torch.where(flat & valid[:, None], area[:, None], inf)
    owner = torch.argmin(key, dim=0)
    owned = key.gather(0, owner[None])[0] < inf
    lane = torch.arange(m, device=masks.device)[:, None]
    return (flat & owned[None, :] & (lane == owner[None, :])).reshape(masks.shape)


def select_masks(logits, iou_pred, hw, pred_iou_thresh, stability_thresh, min_area, max_masks, nms_iou=0.7):
    """SAM's automatic mask selection from one frame's decoder output
    (logits (P, 4, h, w), iou_pred (P, 4)): the multimask tokens 1..3,
    score, stability and area gates, NMS, the top `max_masks`, upsampling
    to `hw`, then the pixel-disjoint carve.  Returns (masks (M, H, W) bool,
    valid (M,), boxes (M, 4))."""
    logits = logits[:, 1:].reshape(-1, logits.shape[-2], logits.shape[-1])
    scores = iou_pred[:, 1:].reshape(-1)
    lh, lw = logits.shape[-2:]
    area_scale = (hw[0] * hw[1]) / float(lh * lw)
    stab = stability_scores(logits)
    bin_lo = logits > 0.0
    areas = bin_lo.to(torch.float32).sum(dim=(1, 2)) * area_scale
    ok = (scores > pred_iou_thresh) & (stab > stability_thresh) & (areas > min_area)
    boxes_lo = boxes_from_masks(bin_lo)
    keep = nms(boxes_lo, scores, ok, nms_iou)
    sel = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top_s, top_i = torch.sort(sel, descending=True, stable=True)
    top_s, top_i = top_s[:max_masks], top_i[:max_masks]
    valid = torch.isfinite(top_s)
    binm = resize(logits[top_i], (max_masks, hw[0], hw[1]), "linear") > 0.0
    masks = to_disjoint(binm & valid[:, None, None], valid)
    valid = valid & masks.any(dim=2).any(dim=1)
    return masks, valid, boxes_from_masks(masks)
