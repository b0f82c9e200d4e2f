"""ConceptFusion-style per-frame feature extraction (counterpart of
holoagent_tpu/perception/extractor.py).

generate_masks (fixed M) -> disjoint carve -> batched crop_and_resize (plain
+ masked) -> one CLIP encode over the crop stack plus the full frame -> the
masked/plain blend and the local-vs-global softmax fusion.
``extract_frames_batched`` does the same for F frames with one SAM encoder
pass and one CLIP encode over all F frames' crops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..models import clip as clip_mod
from ..models import sam as sam_mod
from ..ops import masks as mask_ops
from ..ops.crop_resize import crop_and_resize, expand_boxes
from ..ops.resize import resize
from ..utils.timing import StageTimer, stage


class FrameFeatures(NamedTuple):
    """Fixed-budget per-frame extraction result.

    masks:   (M, H, W) bool
    valid:   (M,) bool
    boxes:   (M, 4) pixel boxes
    f_masks: (M, D) fused per-mask CLIP features (F_p)
    f_global:(D,) whole-frame CLIP feature (F_g)
    """

    masks: torch.Tensor
    valid: torch.Tensor
    boxes: torch.Tensor
    f_masks: torch.Tensor
    f_global: torch.Tensor


def _l2(x, dim=-1, eps=1e-9):
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True), min=eps)


def _mask_stage(
    sam: sam_mod.SAM, image01, points_per_side, pred_iou_thresh, stability_thresh,
    min_area, max_masks, impl, timer=None,
):
    gen = sam_mod.generate_masks(
        sam, image01, points_per_side=points_per_side, pred_iou_thresh=pred_iou_thresh,
        stability_thresh=stability_thresh, min_area=min_area, max_masks=max_masks, impl=impl,
        timer=timer,
    )
    return _carve(gen, timer)


def _carve(gen: dict, timer=None):
    """A frame's generated masks -> pixel-disjoint masks, their validity,
    tight boxes and valid count."""
    with stage(timer, "mask.carve"):
        masks = mask_ops.to_disjoint(gen["masks"], gen["valid"])
        valid = gen["valid"] & masks.any(dim=2).any(dim=1)
        # tight post-carve boxes: crops are taken at the surviving mask's bbox
        return masks, valid, mask_ops.boxes_from_masks(masks), valid.sum()


def _clip_crops(clip: clip_mod.CLIPVisual, image01, masks, valid, boxes, tier: int, bbox_margin: float):
    """A frame's (2 * tier + 1, S, S, 3) normalized CLIP input (plain crops,
    masked crops, the whole frame) and the selection it was cut for."""
    h, w, _ = image01.shape
    # stable valid-first permutation: the first `tier` slots hold every
    # valid mask whenever valid_count <= tier
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    sel = order[:tier]
    masks_t, boxes_t, valid_t = masks[sel], boxes[sel], valid[sel]
    eboxes = expand_boxes(boxes_t, bbox_margin, h, w)
    size = clip.variant.image_size
    crops_plain = crop_and_resize(image01, eboxes, size)
    crops_masked = crop_and_resize(image01, eboxes, size, masks=masks_t)
    frame = resize(image01[None], (1, size, size, 3), "cubic")
    stack = torch.cat([crops_plain, crops_masked, frame], dim=0)
    mean = torch.tensor(clip_mod.IMAGE_MEAN, dtype=stack.dtype, device=stack.device)
    std = torch.tensor(clip_mod.IMAGE_STD, dtype=stack.dtype, device=stack.device)
    return (stack - mean) / std, sel, valid_t


@torch.no_grad()
def _clip_stage(
    clip: clip_mod.CLIPVisual, image01, masks, valid, boxes, tier: int,
    masked_weight: float, bbox_margin: float, clip_impl: str, timer=None, clip_qmm: str = "xla",
) -> Tuple[torch.Tensor, torch.Tensor]:
    with stage(timer, "clip.crops"):
        stack, sel, valid_t = _clip_crops(clip, image01, masks, valid, boxes, tier, bbox_margin)
    with stage(timer, "clip.encoder"):
        feats = clip_mod.encode_image(clip, stack, impl=clip_impl, qmm=clip_qmm).float()
    return _fuse(feats, sel, valid_t, masks.shape[0], masked_weight)


def _fuse(feats, sel, valid_t, m: int, masked_weight: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's (2 * tier + 1, D) crop features -> its (M, D) fused mask
    features F_p (zeros outside the selection) and F_g."""
    tier = sel.shape[0]
    f_plain, f_masked, f_g = feats[:tier], feats[tier : 2 * tier], feats[2 * tier]
    # blend masked/plain crop features, then softmax-weight local vs global
    f_l = _l2(masked_weight * f_masked + (1.0 - masked_weight) * f_plain)
    phi = f_l @ f_g
    w_i = torch.softmax(torch.where(valid_t, phi, torch.full_like(phi, float("-inf"))), dim=0)[:, None]
    w_i = torch.where(valid_t[:, None], w_i, torch.zeros_like(w_i))
    f_p = _l2(w_i * f_g[None, :] + (1.0 - w_i) * f_l)
    f_p = torch.where(valid_t[:, None], f_p, torch.zeros_like(f_p))
    f_full = torch.zeros((m, f_p.shape[-1]), dtype=f_p.dtype, device=f_p.device)
    f_full[sel] = f_p
    return f_full, f_g


def pick_tier(n_valid: int, max_masks: int, tiers: Sequence[int]) -> int:
    """Smallest capacity tier that holds every valid mask (else max_masks)."""
    for t in sorted(tiers):
        if n_valid <= t <= max_masks:
            return t
    return max_masks


def extract_frame_features(
    clip: clip_mod.CLIPVisual,
    sam: sam_mod.SAM,
    image01: torch.Tensor,  # (H, W, 3) float [0,1]
    points_per_side: int = 12,
    pred_iou_thresh: float = 0.88,
    stability_thresh: float = 0.95,
    min_area: float = 100.0,
    max_masks: int = 64,
    masked_weight: float = 0.4418,
    bbox_margin: float = 50.0,
    impl: str = "xla",  # SAM attention: "flash" = kernel K1
    clip_impl: str = "xla",  # CLIP attention: "flash" = kernel K2
    timer: Optional[StageTimer] = None,
    clip_qmm: str = "xla",  # int8 CLIP tower: "pallas" = the fused K3 contract; no-op for float towers
) -> FrameFeatures:
    """Single-pass extraction: always encodes 2 * max_masks + 1 CLIP crops."""
    with stage(timer, "mask"):
        masks, valid, boxes, _ = _mask_stage(
            sam, image01, points_per_side, pred_iou_thresh, stability_thresh, min_area,
            max_masks, impl, timer,
        )
    with stage(timer, "clip"):
        f_masks, f_g = _clip_stage(
            clip, image01, masks, valid, boxes, max_masks, masked_weight, bbox_margin, clip_impl, timer,
            clip_qmm,
        )
    return FrameFeatures(masks=masks, valid=valid, boxes=boxes, f_masks=f_masks, f_global=f_g)


def extract_frame_features_tiered(
    clip: clip_mod.CLIPVisual,
    sam: sam_mod.SAM,
    image01: torch.Tensor,
    points_per_side: int = 12,
    pred_iou_thresh: float = 0.88,
    stability_thresh: float = 0.95,
    min_area: float = 100.0,
    max_masks: int = 64,
    masked_weight: float = 0.4418,
    bbox_margin: float = 50.0,
    impl: str = "xla",
    clip_impl: str = "xla",
    tiers: Tuple[int, ...] = (16, 32),
    timer: Optional[StageTimer] = None,
    clip_qmm: str = "xla",
) -> FrameFeatures:
    """Two-stage extraction with the crop batch sized to the frame: the mask
    stage runs, the host reads the valid count (one synchronising scalar),
    and the CLIP stage runs at the smallest tier that fits.  Same results
    as the single-pass path."""
    with stage(timer, "mask"):
        masks, valid, boxes, nv = _mask_stage(
            sam, image01, points_per_side, pred_iou_thresh, stability_thresh, min_area,
            max_masks, impl, timer,
        )
        tier = pick_tier(int(nv), max_masks, tiers)
    if timer is not None:
        timer.note("tier", tier)
    with stage(timer, "clip"):
        f_masks, f_g = _clip_stage(
            clip, image01, masks, valid, boxes, tier, masked_weight, bbox_margin, clip_impl, timer,
            clip_qmm,
        )
    return FrameFeatures(masks=masks, valid=valid, boxes=boxes, f_masks=f_masks, f_global=f_g)


def per_pixel_features(ff: FrameFeatures, dtype=torch.float16) -> torch.Tensor:
    """Materialize the (H, W, D) per-pixel feature image (the reference's
    `outfeat`, sam_clip_feats_extractor.py:178-190): at each pixel, the
    L2-normalized sum of F_p over masks covering it, summed in float32."""
    m, h, w = ff.masks.shape
    mk = ff.masks.reshape(m, h * w).float()
    acc = _l2(mk.t() @ ff.f_masks.float())
    return acc.reshape(h, w, -1).to(dtype)


@torch.no_grad()
def extract_frames_batched(
    clip: clip_mod.CLIPVisual,
    sam: sam_mod.SAM,
    images01: torch.Tensor,  # (F, H, W, 3) float [0,1]
    points_per_side: int = 12,
    pred_iou_thresh: float = 0.88,
    stability_thresh: float = 0.95,
    min_area: float = 100.0,
    max_masks: int = 64,
    masked_weight: float = 0.4418,
    bbox_margin: float = 50.0,
    impl: str = "xla",
    clip_impl: str = "xla",
    timer: Optional[StageTimer] = None,
    clip_qmm: str = "xla",
) -> FrameFeatures:
    """F frames' extraction with the towers run once over the batch
    (counterpart of the reference's ``extract_frames_batched``, a vmap of
    ``extract_frame_features``): the SAM image encoder over the F images,
    then one CLIP encode over the F * (2 * max_masks + 1) crops, untiered as
    the single-pass path.  The decoder, NMS, selection, carve and crop
    cutting run frame by frame.  Returns FrameFeatures with a leading frame
    axis; frame by frame they equal ``extract_frame_features``'s."""
    f = images01.shape[0]
    with stage(timer, "mask"):
        gens = sam_mod.generate_masks_batched(
            sam, images01, points_per_side=points_per_side, pred_iou_thresh=pred_iou_thresh,
            stability_thresh=stability_thresh, min_area=min_area, max_masks=max_masks, impl=impl, timer=timer,
        )
        carved = [_carve(g, timer)[:3] for g in gens]
    with stage(timer, "clip"):
        with stage(timer, "clip.crops"):
            cut = [_clip_crops(clip, images01[i], *carved[i], max_masks, bbox_margin) for i in range(f)]
        with stage(timer, "clip.encoder"):
            feats = clip_mod.encode_image(clip, torch.cat([c[0] for c in cut]), impl=clip_impl, qmm=clip_qmm).float()
        fused = [_fuse(fr, sel, valid_t, max_masks, masked_weight)
                 for fr, (_, sel, valid_t) in zip(feats.chunk(f), cut)]
    return FrameFeatures(
        masks=torch.stack([c[0] for c in carved]),
        valid=torch.stack([c[1] for c in carved]),
        boxes=torch.stack([c[2] for c in carved]),
        f_masks=torch.stack([x[0] for x in fused]),
        f_global=torch.stack([x[1] for x in fused]),
    )
