"""Oracle perception: GT-mask FrameFeatures for the accuracy protocol
(counterpart of holoagent_tpu/perception/oracle.py).

GT instance masks stand in for SAM and one-hot label embeddings for CLIP;
everything downstream (voxel fusion, instance merging, floor/room
segmentation, object association, evaluation) is the real production code
path, so the protocol measures the pipeline without any tower weights.
The masks and features are built in numpy, as in the reference, and become
tensors on the caller's device in the last step.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve
from .extractor import FrameFeatures


def onehot_label_feats(labels: Sequence[str], dim: int) -> np.ndarray:
    """(C, dim) unit one-hot 'text features' for an oracle vocabulary."""
    tf = np.zeros((len(labels), dim), np.float32)
    for i in range(len(labels)):
        tf[i, i % dim] = 1.0
    return tf


def oracle_frame_features(
    instance_img: np.ndarray,  # (H, W) int32 instance ids, -1 background
    label_img: np.ndarray,  # (H, W) int32 label ids into `labels`
    labels: Sequence[str],
    dim: int,
    max_masks: int = 16,
    min_area: int = 20,
    device: DeviceLike = None,
) -> FrameFeatures:
    """FrameFeatures from ground truth: one mask per visible instance, feature
    = the instance's one-hot label embedding; tensors on `device` (the card
    unless the caller asks for the CPU)."""
    dev = resolve(device)
    h, w = instance_img.shape
    tf = onehot_label_feats(labels, dim)
    masks = np.zeros((max_masks, h, w), bool)
    valid = np.zeros((max_masks,), bool)
    boxes = np.zeros((max_masks, 4), np.float32)
    f_masks = np.zeros((max_masks, dim), np.float32)
    ids = [i for i in np.unique(instance_img) if i >= 0]
    slot = 0
    for iid in ids:
        if slot >= max_masks:
            break
        m = instance_img == iid
        if m.sum() < min_area:
            continue
        ys, xs = np.nonzero(m)
        lab = int(np.bincount(label_img[m].ravel()).argmax())
        masks[slot] = m
        valid[slot] = True
        boxes[slot] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
        f_masks[slot] = tf[lab % len(labels)]
        slot += 1
    # global feature: mean of visible instance features (unit-normalized)
    f_g = f_masks[valid].mean(axis=0) if valid.any() else np.zeros(dim, np.float32)
    n = np.linalg.norm(f_g)
    f_g = f_g / n if n > 1e-9 else f_g
    return FrameFeatures(*(torch.from_numpy(a).to(dev) for a in (masks, valid, boxes, f_masks,
                                                                   f_g.astype(np.float32))))
