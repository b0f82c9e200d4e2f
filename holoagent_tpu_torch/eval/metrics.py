"""Semantic-segmentation metrics (mIoU / mAcc / fwIoU).

Capability parity with reference fsr_vln/memory/hmsg/utils/metric.py:5-185:
confusion-matrix based intersection-over-union and accuracy over label maps.

The port's own copy of holoagent_tpu/eval/metrics.py (numpy).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) confusion counts; gt<0 pixels ignored."""
    mask = gt >= 0
    idx = gt[mask].astype(np.int64) * num_classes + np.clip(
        pred[mask].astype(np.int64), 0, num_classes - 1
    )
    return np.bincount(idx, minlength=num_classes**2).reshape(num_classes, num_classes)


def segmentation_metrics(conf: np.ndarray) -> Dict[str, float]:
    tp = np.diag(conf).astype(np.float64)
    gt_count = conf.sum(axis=1).astype(np.float64)
    pred_count = conf.sum(axis=0).astype(np.float64)
    union = gt_count + pred_count - tp
    present = gt_count > 0
    iou = np.where(union > 0, tp / np.maximum(union, 1), 0.0)
    acc = np.where(gt_count > 0, tp / np.maximum(gt_count, 1), 0.0)
    freq = gt_count / max(gt_count.sum(), 1)
    return {
        "mIoU": float(iou[present].mean()) if present.any() else 0.0,
        "mAcc": float(acc[present].mean()) if present.any() else 0.0,
        "fwIoU": float((freq * iou).sum()),
        "pAcc": float(tp.sum() / max(conf.sum(), 1)),
    }
