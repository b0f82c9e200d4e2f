"""Greedy NMS inputs that probe each rule of ops/masks.py::nms: the order
(stable ties, NaN and signed-zero scores), the strict threshold, invalid
candidates, empty boxes, and the candidate counts of points_per_side 4, 12
and 32; and plain versions with one rule broken each, which a check of the
kernel must reject.  No JAX: the CPU tests hold the plain version to the
JAX package on these cases, and chip_smoke.py holds the CUDA kernel to the
plain version on them."""

from __future__ import annotations

import numpy as np
import torch

from holoagent_tpu_torch.ops.masks import box_iou

NMS_FAULTS = ("unstable_ties", "at_threshold_suppresses", "invalid_suppress")

NMS_CASE_NAMES = ("all_invalid", "one_valid", "ties_across_words", "iou_at_threshold", "zero_area",
                  "nan_and_signed_zero", "m48", "m432", "m3072")


def clustered_boxes(rng, m: int, side: int = 256, clusters: int = 12) -> np.ndarray:
    """(m, 4) float32 integer-valued [y0, x0, y1, x1] boxes inside a side x
    side grid (SAM's low-resolution masks), drawn around a few centres so
    that many pairs overlap above 0.7."""
    centre = rng.integers(16, side - 16, (clusters, 2))[rng.integers(0, clusters, m)]
    half = rng.integers(4, 40, (m, 2))
    jitter = rng.integers(-3, 4, (m, 2))
    lo = np.clip(centre - half + jitter, 0, side - 1)
    hi = np.clip(centre + half + jitter, lo + 1, side)
    return np.concatenate([lo, hi], axis=1).astype(np.float32)


def nms_case(name: str, seed: int = 0):
    """(boxes (M, 4) float32, scores (M,) float32, valid (M,) bool, iou_thresh)."""
    rng = np.random.default_rng([seed, NMS_CASE_NAMES.index(name)])
    if name.startswith("m"):  # 3 * points_per_side^2 candidates, scores rounded to one decimal: many ties
        m = int(name[1:])
        boxes = clustered_boxes(rng, m)
        scores = np.round(rng.uniform(0, 1, m), 1).astype(np.float32)
        return boxes, scores, rng.uniform(size=m) < 0.8, 0.7
    if name == "all_invalid":
        boxes = clustered_boxes(rng, 48)
        return boxes, rng.uniform(0, 1, 48).astype(np.float32), np.zeros(48, bool), 0.7
    if name == "one_valid":
        boxes = clustered_boxes(rng, 48)
        valid = np.zeros(48, bool)
        valid[rng.integers(0, 48)] = True
        return boxes, rng.uniform(0, 1, 48).astype(np.float32), valid, 0.7
    if name == "ties_across_words":
        # one score throughout, so the order is the index order, and runs
        # of one box over the 64- and 128-candidate word edges: the lowest
        # valid index of a run is kept, the rest suppressed
        boxes = clustered_boxes(rng, 200)
        for lo, hi in ((58, 70), (120, 136), (190, 200)):
            boxes[lo:hi] = boxes[lo]
        scores = np.full(200, 0.5, np.float32)
        valid = np.ones(200, bool)
        valid[[59, 125]] = False
        return boxes, scores, valid, 0.7
    if name == "iou_at_threshold":
        # pairs at IoU 7/10 exactly (f32(0.7), not above the threshold) and
        # at 8/10 (above), each pair well apart from the others
        boxes, scores = [], []
        for k in range(40):
            y = 12.0 * k
            inner = 7.0 if k % 2 == 0 else 8.0
            boxes += [[y, 0.0, y + 1.0, 10.0], [y, 0.0, y + 1.0, inner]]
            scores += [0.9, 0.8]
        return np.asarray(boxes, np.float32), np.asarray(scores, np.float32), np.ones(80, bool), 0.7
    if name == "zero_area":
        # empty masks' zero boxes, lines and points among ordinary boxes
        boxes = clustered_boxes(rng, 96)
        boxes[::4] = 0.0
        boxes[1::8, 2] = boxes[1::8, 0]  # y1 = y0
        boxes[3::8, 3] = boxes[3::8, 1]  # x1 = x0
        scores = np.round(rng.uniform(0, 1, 96), 1).astype(np.float32)
        return boxes, scores, rng.uniform(size=96) < 0.9, 0.7
    if name == "nan_and_signed_zero":
        # valid NaN scores sort after every number (after the invalid ones
        # too), in index order; -0 and +0 tie
        boxes = clustered_boxes(rng, 96)
        scores = np.round(rng.uniform(-1, 1, 96), 1).astype(np.float32)
        scores[::7] = np.nan
        scores[1::5] = 0.0
        scores[2::5] = -0.0
        scores[3::11] = -np.inf
        return boxes, scores, rng.uniform(size=96) < 0.85, 0.7
    raise KeyError(name)


def nms_with_fault(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                   fault: str) -> torch.Tensor:
    """ops/masks.py::nms_ref with one rule broken: "unstable_ties" (equal
    scores to the higher index first), "at_threshold_suppresses" (``>=``
    for ``>``), "invalid_suppress" (invalid candidates keep their score's
    place in the order and suppress as kept ones do, though never kept)."""
    m = boxes.shape[0]
    key = scores if fault == "invalid_suppress" else torch.where(valid, scores, torch.full_like(scores, -np.inf))
    if fault == "unstable_ties":
        order = torch.from_numpy(np.lexsort((-np.arange(m), (-key).numpy())).copy())
    else:
        order = torch.argsort(-key, stable=True)
    iou = box_iou(boxes[order], boxes[order])
    over = iou >= iou_thresh if fault == "at_threshold_suppresses" else iou > iou_thresh
    v = valid[order]
    keep_sorted = torch.zeros(m, dtype=torch.bool)
    suppressor = torch.zeros(m, dtype=torch.bool)
    for i in range(m):
        free = not bool((over[i, :i] & suppressor[:i]).any())
        keep_sorted[i] = bool(v[i]) and free
        suppressor[i] = free if fault == "invalid_suppress" else keep_sorted[i]
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep
