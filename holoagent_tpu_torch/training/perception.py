"""Fixture-trained tiny perception towers for the neural accuracy row
(counterpart of holoagent_tpu/training/perception.py).

  * ``train_tiny_clip``: symmetric InfoNCE (``training.contrastive``) over
    GT object crops, structure windows and in-room frames paired with the
    retrieval prompt templates, on the extractor's plain/masked blend;
  * ``train_tiny_sam``: promptable-mask supervision: point prompts inside
    GT instances and structure regions, min-over-mask-tokens BCE + dice at
    the decoder's 4g x 4g grid, and IoU-head regression.

Everything runs in float32 on the caller's device (the card unless
``device="cpu"``), with attention on the plain version (``impl="xla"``), as
the reference's training runs it.  Batches are drawn from the same
``np.random.default_rng(seed)`` calls in the same order as the reference,
so both trainers see the same batches; the crops and ground-truth grids go
through ``ops/resize.py`` (``jax.image.resize``'s antialiased linear).  The
initial weights are the port's own seeded init, or the towers passed as
``params`` (e.g. a bridged JAX init).  On the card each step after the
first three is one CUDA graph replay (``contrastive.GraphedStep``): the
eager steps are host-bound, 10-15x slower.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve
from ..models import clip as clip_mod
from ..models import sam as sam_mod
from ..models import transformer as tfm
from ..models.tokenizer import SimpleTokenizer
from ..ops.resize import resize
from . import contrastive

def _resize(a: np.ndarray, shape) -> np.ndarray:
    """``np.asarray(jax.image.resize(a, shape, "linear"))`` on the host."""
    return resize(torch.from_numpy(np.ascontiguousarray(a, np.float32)), shape, "linear").numpy()


def _step(step):
    """A trainer's step callable: one CUDA graph replay a call on the card."""
    return contrastive.GraphedStep(step)


# ---------------------------------------------------------------------------
# Data: GT object crops from the synthetic fixtures
# ---------------------------------------------------------------------------


def collect_crops(datasets, labels: Sequence[str], size: int, margin: int = 4,
                  masked: bool = False, structure: bool = False,
                  structure_per_frame: int = 3):
    """All GT instance crops across the datasets' frames, resized to `size`.

    masked=True also returns background-zeroed variants (the extractor
    encodes plain and masked crops and blends them).  structure=True also
    samples random non-object windows per frame: a window dominated by one
    structure label (wall/floor) carries it, a mixed one "background".
    GT label ids are per scene; they are mapped through their names into
    `labels`.

    Returns (crops (N, size, size, 3) float01, label_ids (N,)) or
    (crops, crops_masked, label_ids)."""
    crops, crops_m, ids = [], [], []
    labels = list(labels)
    for ds in datasets:
        local = list(ds.scene.labels()) if hasattr(ds, "scene") else labels
        for i in range(len(ds)):
            frame = ds[i]
            inst, lab = ds.gt(i)
            for iid in np.unique(inst):
                if iid < 0:
                    continue
                m = inst == iid
                if m.sum() < 30:
                    continue
                raw = lab[m].ravel()
                raw = raw[raw >= 0]
                if not len(raw):
                    continue
                name = local[int(np.bincount(raw).argmax()) % len(local)]
                if name not in labels:
                    continue
                ys, xs = np.nonzero(m)
                y0, y1 = max(ys.min() - margin, 0), min(ys.max() + margin, m.shape[0])
                x0, x1 = max(xs.min() - margin, 0), min(xs.max() + margin, m.shape[1])
                crop = frame.rgb[y0:y1, x0:x1]
                crops.append(_resize(crop, (size, size, 3)))
                if masked:
                    crops_m.append(_resize(crop * m[y0:y1, x0:x1, None], (size, size, 3)))
                ids.append(labels.index(name))
            if structure:
                h, w = inst.shape
                srng = np.random.default_rng(1000 + i)
                picked = 0
                for _ in range(8 * structure_per_frame):
                    if picked >= structure_per_frame:
                        break
                    s = int(srng.integers(max(8, h // 8), max(12, h // 2)))
                    y0 = int(srng.integers(0, h - s))
                    x0 = int(srng.integers(0, w - s))
                    wi = inst[y0:y0 + s, x0:x0 + s]
                    wl = lab[y0:y0 + s, x0:x0 + s]
                    if (wi >= 0).mean() > 0.25:
                        continue  # object-containing: not background
                    struct = wl[(wi < 0) & (wl >= 0)]
                    if len(struct) == 0:
                        continue
                    counts = np.bincount(struct.ravel())
                    if counts.max() > 0.7 * len(struct):
                        name = local[int(counts.argmax()) % len(local)]
                        if name not in labels:
                            name = "background"
                    else:
                        name = "background"
                    if name not in labels:
                        continue
                    cr = _resize(frame.rgb[y0:y0 + s, x0:x0 + s], (size, size, 3))
                    crops.append(cr)
                    if masked:
                        crops_m.append(cr)  # structure windows are their own mask
                    ids.append(labels.index(name))
                    picked += 1
    out_ids = np.asarray(ids, np.int32)
    if masked:
        return (np.stack(crops).astype(np.float32),
                np.stack(crops_m).astype(np.float32), out_ids)
    return np.stack(crops).astype(np.float32), out_ids


def collect_room_frames(datasets, room_rects_by_ds, size: int, jitter: int = 0,
                        seed: int = 0) -> Tuple[np.ndarray, List[str]]:
    """Full frames labelled by the room TYPE the camera stands in (the
    supervision for room naming), each with `jitter` random-window variants
    (70-100% scale, random offset).  room_rects_by_ds[i]: (x0, y0, x1, y1,
    category[, floor_id]) tuples for datasets[i] (None skips it).

    Returns (frames (N, size, size, 3) float01, categories)."""
    rng = np.random.default_rng(seed)
    frames, cats = [], []
    for ds, rects in zip(datasets, room_rects_by_ds):
        if rects is None:
            continue
        level_zs = ds.scene.level_zs() if hasattr(ds.scene, "level_zs") else [0.0]
        for i in range(len(ds)):
            eye = ds.poses[i][:3, 3]
            floor = max(
                (fi for fi, z in enumerate(level_zs) if z <= eye[2] + 1e-6),
                default=0,
            )
            for rect in rects:
                x0, y0, x1, y1, cat = rect[:5]
                fid = int(rect[5]) if len(rect) > 5 else 0
                if fid == floor and x0 <= eye[0] < x1 and y0 <= eye[1] < y1:
                    rgb = np.asarray(ds[i].rgb)
                    frames.append(_resize(rgb, (size, size, 3)))
                    cats.append(cat)
                    h, w = rgb.shape[:2]
                    for _ in range(jitter):
                        s = rng.uniform(0.7, 1.0)
                        ch, cw = int(h * s), int(w * s)
                        r0 = rng.integers(0, h - ch + 1)
                        c0 = rng.integers(0, w - cw + 1)
                        frames.append(_resize(rgb[r0:r0 + ch, c0:c0 + cw], (size, size, 3)))
                        cats.append(cat)
                    break
    if not frames:
        return np.zeros((0, size, size, 3), np.float32), []
    return np.stack(frames).astype(np.float32), cats


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def train_tiny_clip(
    datasets,
    labels: Sequence[str],
    steps: int = 400,
    seed: int = 0,
    variant_name: str = "test-tiny",
    lr: float = 3e-3,
    room_rects_by_ds=None,  # adds room-type classes (collect_room_frames)
    room_frame_jitter: int = 0,  # random-window variants per room frame
    params: Optional[contrastive.CLIPParams] = None,  # initial towers (default: the seeded init)
    device: DeviceLike = None,
) -> Tuple[contrastive.CLIPParams, List[float]]:
    """Contrastive training of the tiny towers on fixture crops, one crop
    per distinct label a batch (a duplicate label would be a false negative
    in the symmetric InfoNCE), on the extractor's plain/masked blend.  With
    ``room_rects_by_ds`` the room types join the labels, supervised by
    in-room frames.  The towers are built for ``impl="xla"``.  Returns
    (params, losses)."""
    dev = resolve(device)
    cv = clip_mod.VARIANTS[variant_name]
    tok = SimpleTokenizer()
    rng = np.random.default_rng(seed)
    # margin 16 px: the deployed crop geometry (pipeline.clip_bbox_margin at 240x320)
    crops, crops_masked, ids = collect_crops(
        datasets, labels, cv.image_size, margin=16, masked=True, structure=True
    )
    labels = list(labels)
    if room_rects_by_ds is not None:
        rframes, rcats = collect_room_frames(
            datasets, room_rects_by_ds, cv.image_size,
            jitter=room_frame_jitter, seed=seed,
        )
        if len(rframes):
            rids = []
            for c in rcats:
                if c not in labels:
                    labels.append(c)
                rids.append(labels.index(c))
            crops = np.concatenate([crops, rframes])
            crops_masked = np.concatenate([crops_masked, rframes])
            ids = np.concatenate([ids, np.asarray(rids, np.int32)])
    by_label = [np.nonzero(ids == c)[0] for c in range(len(labels))]
    present = [c for c in range(len(labels)) if len(by_label[c])]
    mean = np.asarray(clip_mod.IMAGE_MEAN, np.float32)
    std = np.asarray(clip_mod.IMAGE_STD, np.float32)

    if params is None:
        params = contrastive.clip_params(*clip_mod.init_clip(cv, seed=seed, dtype=torch.float32, device=dev,
                                                             impl="xla"))
    tx = contrastive.init_train_state(params, lr=lr)
    blend = contrastive.make_blend_train_step(cv, tx, dtype=torch.float32)
    step = _step(lambda ip, im, tk: blend(params, ip, im, tk))

    templates = clip_mod.TEMPLATES
    tokens_by = {
        (c, t): tok([templates[t].format(labels[c])])[0]
        for c in present
        for t in range(len(templates))
    }
    # the normalized crops live on the device; a batch is a gather
    plain = torch.from_numpy((crops - mean) / std).to(dev)
    masked = torch.from_numpy((crops_masked - mean) / std).to(dev)
    losses = []
    for _ in range(steps):
        batch_c = rng.permutation(present)
        pick = torch.as_tensor(np.asarray([rng.choice(by_label[c]) for c in batch_c]), device=dev)
        ti = rng.integers(0, len(templates))
        toks = torch.from_numpy(np.stack([tokens_by[(c, ti)] for c in batch_c])).to(dev)
        losses.append(step(plain[pick], masked[pick], toks))
    return params, torch.stack(losses).tolist() if losses else []


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------


def _sam_loss(sam: sam_mod.SAM, img: torch.Tensor, points01: torch.Tensor, gt16: torch.Tensor) -> torch.Tensor:
    """img (S, S, 3) normalized; points01 (P, 2); gt16 (P, 4g, 4g) float.
    min-over-tokens (BCE + dice) + IoU-head regression (SAM's loss shape)."""
    v = sam.variant
    emb = sam_mod.forward_image(sam.encoder, img[None], v)[0]
    g = emb.shape[0]
    pe = sam_mod.image_pe(sam.prompt, g).to(emb.dtype)
    p = points01.shape[0]
    pts = torch.stack([points01, torch.zeros_like(points01)], dim=1)
    labs = torch.stack([torch.ones(p, dtype=torch.int32, device=img.device),
                        -torch.ones(p, dtype=torch.int32, device=img.device)], dim=1)
    sparse = sam_mod.encode_points(sam.prompt, pts, labs).to(emb.dtype)
    logits, iou_pred = sam_mod.decode_masks(sam.decoder, emb, pe, sparse, sam.prompt.no_mask.to(emb.dtype), v)
    logits = logits[:, 1:]  # the multimask tokens generate_masks consumes
    iou_pred = iou_pred[:, 1:]
    tgt = gt16[:, None]  # (P, 1, 4g, 4g)
    bce = F.binary_cross_entropy_with_logits(logits, tgt.expand_as(logits), reduction="none")
    bce = bce.mean(dim=(-1, -2))  # (P, nm-1)
    prob = torch.sigmoid(logits)
    inter = (prob * tgt).sum(dim=(-1, -2))
    dice = 1.0 - (2 * inter + 1.0) / (prob.sum(dim=(-1, -2)) + tgt.sum(dim=(-1, -2)) + 1.0)
    tok_loss = bce + dice  # (P, nm-1)
    best = torch.argmin(tok_loss, dim=1)
    mask_loss = torch.gather(tok_loss, 1, best[:, None]).mean()
    # IoU regression against the achieved overlap of each token's binarization
    binm = logits > 0.0
    on = tgt > 0.5
    bi = (binm & on).sum(dim=(-1, -2)).to(logits.dtype)
    bu = (binm | on).sum(dim=(-1, -2)).to(logits.dtype)
    iou_t = (bi / torch.clamp(bu, min=1.0)).detach()
    iou_loss = ((iou_pred - iou_t) ** 2).mean()
    return mask_loss + iou_loss


def train_tiny_sam(
    datasets,
    steps: int = 400,
    prompts_per_step: int = 8,
    seed: int = 0,
    variant_name: str = "test-tiny",
    lr: float = 1e-3,
    params: Optional[sam_mod.SAM] = None,  # initial model (default: the seeded init)
    device: DeviceLike = None,
) -> Tuple[sam_mod.SAM, List[float]]:
    """Supervised promptable-mask training on fixture GT instances and
    background structure regions (a grid prompt on a wall must yield the
    wall's mask).  Returns (sam, losses)."""
    dev = resolve(device)
    v = sam_mod.VARIANTS[variant_name]
    rng = np.random.default_rng(seed)
    sam = params if params is not None else sam_mod.init_sam(v, seed=seed, dtype=torch.float32, device=dev)
    tfm.trainable(sam)
    dtype = sam.dtype  # the inputs follow the model (float32; float64 for a precision study)
    tx = contrastive.adamw(sam.parameters(), lr, weight_decay=0.01)
    g4 = 4 * (v.img_size // v.patch)

    def loss_step(img, points01, gt16):
        tx.zero_grad(set_to_none=True)
        loss = _sam_loss(sam, img, points01, gt16)
        loss.backward()
        tx.step()
        return loss.detach()

    step = _step(loss_step)
    # pre-extract once, on the device: the preprocessed image and, per GT
    # instance or structure region, its pixel coordinates (host) and its
    # 4g-resolution mask; the loop is then pure indexing
    frames = []
    for ds in datasets:
        for i in range(len(ds)):
            frame = ds[i]
            inst, lab = ds.gt(i)
            h, w = inst.shape
            entries = []
            targets = [inst == iid for iid in np.unique(inst) if iid >= 0]
            targets += [
                (lab == li) & (inst < 0)
                for li in np.unique(lab[inst < 0])
                if li >= 0
            ]
            for m in targets:
                if m.sum() < 30:
                    continue
                ys, xs = np.nonzero(m)
                gt16 = _resize(m.astype(np.float32), (g4, g4)) > 0.5
                entries.append((
                    np.stack([xs / w, ys / h], -1).astype(np.float32),
                    torch.from_numpy(gt16.astype(np.float32)).to(dev, dtype),
                ))
            if entries:
                x = sam_mod.preprocess(torch.from_numpy(np.asarray(frame.rgb, np.float32))[None], v.img_size)[0]
                frames.append((x.to(dev, dtype), entries))
    losses = []
    for _ in range(steps):
        x, entries = frames[rng.integers(0, len(frames))]
        pts, gts = [], []
        for _ in range(prompts_per_step):
            coords, gt16 = entries[rng.integers(0, len(entries))]
            pts.append(coords[rng.integers(0, len(coords))])
            gts.append(gt16)
        losses.append(step(x, torch.from_numpy(np.asarray(pts, np.float32)).to(dev, dtype), torch.stack(gts)))
    return sam, torch.stack(losses).tolist() if losses else []
