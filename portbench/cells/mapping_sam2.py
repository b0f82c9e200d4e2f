"""The SAM 2 mapping cell's driver: ``cells/mapping.py``'s offline mapping
of the walk with SAM 2.1 (Hiera) as the segmenter.

Everything but the segmenter is ``mapping.py``'s, by import: the walk, the
scenes and their window, the capture of what the timed path produced, the
faults, the profiled stretch and the selection, CLIP, scene and instance
checks.  This module replaces the segmenter's seeded weights (``reference/
sam2.py``'s spec), its loading (``models/sam2.py::SAM2`` by the
configuration's ``models.sam.type``), the model operations of a frame
(``yardstick/hiera.py``) and the SAM numbers of the check:
- ``sam_linear_rel_rms``: the four linears (qkv, proj, lin1, lin2) of one
  trunk block drawn from the seed (a pooling block where the seed draws
  one), as ``mapping.py`` reads SAM's;
- ``sam_logit_rel_rms``, ``sam_iou_gap``: the decoder's mask logits and
  IoU predictions over every prompt of the grid at the sampled keyframes,
  against the plain float32 SAM 2 on the same frame.
The traced line adds ``launches["hiera"]``: Hiera's K2 launches (head dim
72) with their kernels' device time, kept apart from CLIP's K2 launches
(``launches["k2"]``).
The program's SAM 2 is looked for before anything runs: a program without
it refuses the cell.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from .. import weights
from ..harness import Outcome, Refused, Run
from ..reference import clip as ref_clip
from ..reference import imageops, precision
from ..reference import sam2 as ref_sam2
from ..yardstick import flops, hiera
from ..yardstick.trace import Events
from . import mapping

SAM2_F32 = ("prompt.",)  # parameters SAM 2 serves in float32 whatever its dtype


def sizes(r: Run) -> ref_sam2.SAM2Sizes:
    return ref_sam2.SAM2Sizes.of(r.config["sam2"]["sizes"])


def sam2_weights(r: Run, device) -> Dict[str, torch.Tensor]:
    """The seeded weights of SAM 2, each in the dtype it is served in."""
    dt = mapping._dtype(r.config["dtype"])
    return weights.make(ref_sam2.spec(sizes(r)), mapping._seed(r.seed, 1),
                        lambda n: torch.float32 if n.startswith(SAM2_F32) else dt, device)


def _program_sam2():
    try:
        from holoagent_tpu_torch.models import sam2 as sam2_mod
    except ImportError as e:
        raise Refused(f"the program has no SAM 2 model: {e}") from e
    return sam2_mod


def program_towers(r: Run, cfg, device):
    """The program's SAM 2 (chosen by ``models.sam.type``) and CLIP visual
    tower, loaded with the seeded weights."""
    from holoagent_tpu_torch.models import clip as clip_mod

    sam2_mod = _program_sam2()
    sv = sam2_mod.VARIANTS.get(cfg.models.sam.type)
    if sv is None:
        raise Refused(f"the program has no SAM 2 variant {cfg.models.sam.type!r}")
    cv = clip_mod.VARIANTS[cfg.models.clip.type]
    for name, want, got in (("sam2", r.config["sam2"]["sizes"], sv), ("clip", r.config["clip"]["sizes"], cv)):
        for k, v in want.items():
            if getattr(got, k) != (tuple(v) if isinstance(v, list) else v):
                raise ValueError(f"the program's {name} variant has {k}={getattr(got, k)}, the configuration {v}")
    dt = mapping._dtype(r.config["dtype"])
    sam = sam2_mod.SAM2(sv, dtype=dt, device=device)
    weights.load_into(sam, sam2_weights(r, device))
    clip = clip_mod.CLIPVisual(cv, dtype=dt, device=device, impl=cfg.pipeline.extract_clip_impl)
    weights.load_into(clip, mapping.tower_weights(r, device, "clip"))
    return clip, sam


@contextlib.contextmanager
def _segmenter():
    """``mapping.py``'s run with this module's loading, trace reading and
    check in place of SAM's."""
    mine = {"program_towers": program_towers, "traced": traced, "check": check}
    saved = {n: getattr(mapping, n) for n in mine}
    for n, f in mine.items():
        setattr(mapping, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(mapping, n, f)


def run(r: Run) -> Outcome:
    _program_sam2()
    with _segmenter():
        return mapping.run(r)


def traced(r: Run, cfg, timer, prof, n_kf: int, batched: bool) -> dict:
    """``mapping.traced``'s readings with SAM 2's operations a frame, and
    Hiera's K2 launches apart from CLIP's."""
    cv = ref_clip.CLIPSizes.of(r.config["clip"]["sizes"])
    sc = cfg.models.sam
    sam_ops = hiera.sam2_frame_ops(sizes(r), sc.points_per_side)
    crop_ops = flops.clip_crop_ops(cv)
    tiers = timer.notes.get("tier", [])
    ideal = 0.0
    for j in range(prof.start, prof.stop):
        tier = sc.max_masks if batched else tiers[j]
        ideal += flops.ideal_seconds(sam_ops, False) + (2 * tier + 1) * flops.ideal_seconds(crop_ops, False)
    ev = Events.from_profiler(prof.prof) if prof.prof is not None else None
    device_s = ev.device_seconds(hiera.kernel_of) if ev and ev.window else {}
    keys = dict(prof.keys)
    k2 = keys.pop("k2", [])
    keys["k2"] = [k for k in k2 if not hiera.is_hiera(k)]
    keys["hiera"] = [k for k in k2 if hiera.is_hiera(k)]
    launches = {}
    for k, ks in keys.items():
        if ks and r.device.type == "cuda":
            if device_s.get(k, 0.0) <= 0.0:
                raise RuntimeError(f"{len(ks)} {k} launches in the profiled stretch, none of its kernels in the trace")
            launches[k] = {"keys": ks, "device_s": device_s[k]}
    return {
        "keyframes": n_kf,
        "stage_ms": dict(timer.ms),
        "stage_calls": dict(timer.calls),
        "launches": launches,
        "stretch": {"keyframes": prof.keyframes, "wall_s": prof.wall_s, "ideal_s": ideal},
        "busy_s": ev.busy_s() if ev and ev.window else 0.0,
        "window_s": ev.window_s() if ev and ev.window else prof.wall_s,
        "breakdown": {"device_ops": ev.top_device_ops(), "idle_gaps": ev.idle_gaps()} if ev and ev.window else {},
    }


def _f32_off():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return prev


def check(r: Run, cfg, cap, first, keyframes, dev) -> Dict[str, float]:
    """``mapping.check`` with SAM 2's numbers (module docstring)."""
    prev = _f32_off()
    try:
        with torch.no_grad():
            return _check(r, cfg, cap, first, keyframes, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _reference_sam2(p_sam, v, rgb, sc):
    """The float32 SAM 2's logits and IoU over the prompt grid on one frame."""
    feats = tuple(x[0] for x in ref_sam2.image_features(p_sam, v, ref_sam2.preprocess(rgb[None], v.img_size)))
    return ref_sam2.decode_grid(p_sam, v, feats, sc.points_per_side)


def _check(r: Run, cfg, cap, first, keyframes, dev) -> Dict[str, float]:
    v = sizes(r)
    cv = ref_clip.CLIPSizes.of(r.config["clip"]["sizes"])
    sc, p = cfg.models.sam, cfg.pipeline
    p_sam = weights.as_float32(sam2_weights(r, dev))
    out = {"sam_linear_rel_rms": mapping._linears(cap, p_sam), "sam_logit_rel_rms": 0.0, "sam_iou_gap": 0.0,
           "mask_select_differing": 0.0, "clip_feat_gap": 0.0}
    if len(cap.ffs) != len(keyframes) or len(cap.pix_rows) != len(keyframes) or sorted(cap.decode) != sorted(cap.want):
        raise RuntimeError(f"captured {len(cap.ffs)} keyframes' features, {len(cap.pix_rows)} instance folds and "
                           f"decoder calls {sorted(cap.decode)} of the first scene's {len(keyframes)} and "
                           f"{sorted(cap.want)}")
    p_clip = weights.as_float32(mapping.tower_weights(r, dev, "clip"))
    for j in cap.want:
        rgb = torch.as_tensor(keyframes[j].rgb, dtype=torch.float32).to(dev)
        hw = tuple(rgb.shape[:2])
        logits, iou = _reference_sam2(p_sam, v, rgb, sc)
        lp, ip = cap.decode[j]
        out["sam_logit_rel_rms"] = max(out["sam_logit_rel_rms"], mapping._rms(lp.float() - logits) / mapping._rms(logits))
        out["sam_iou_gap"] = max(out["sam_iou_gap"], float((ip.float() - iou).abs().max()))
        del logits, iou
        ff = cap.ffs[j]
        masks, valid, boxes = imageops.select_masks(lp.float(), ip.float(), hw, sc.pred_iou_thresh,
                                                    sc.stability_score_thresh, float(sc.min_mask_region_area),
                                                    sc.max_masks)
        out["mask_select_differing"] += float((masks != ff.masks).sum() + (valid != ff.valid).sum()
                                              + (boxes != ff.boxes).any(dim=-1).sum())
        n_valid = int(ff.valid.sum())
        stack, sel, vt = ref_clip.crop_stack(cv, rgb, ff.masks, ff.valid, ff.boxes, sc.max_masks,
                                             float(p.clip_bbox_margin))
        f_p, f_g = ref_clip.fuse(ref_clip.encode_image(p_clip, cv, stack), sel, vt, sc.max_masks,
                                 p.clip_masked_weight)
        cos = (ff.f_masks.float() * f_p).sum(-1)[ff.valid]
        gap = max([float((1.0 - cos).max())] if n_valid else [0.0])
        out["clip_feat_gap"] = max(out["clip_feat_gap"], gap, 1.0 - float(ff.f_global.float() @ f_g))
    del p_sam, p_clip
    out.update(_scene_and_instances(cfg, cap, first, keyframes, dev))
    return out


def _scene_and_instances(cfg, cap, first, keyframes, dev) -> Dict[str, float]:
    """``mapping._check``'s scene, pixel-row and instance numbers."""
    from ..reference import scene as ref_scene

    p = cfg.pipeline
    cap_c = p.frame_voxel_capacity
    pts_keys = [ref_scene.frame_points(torch.as_tensor(kf.depth).to(dev), torch.as_tensor(kf.pose).to(dev),
                                       torch.as_tensor(kf.k).to(dev), p.voxel_size, cfg.main.depth_cut)
                for kf in keyframes]
    frames = [dict(depth=torch.as_tensor(kf.depth).to(dev), pose=torch.as_tensor(kf.pose).to(dev),
                   k=torch.as_tensor(kf.k).to(dev), masks=ff.masks, valid=ff.valid, f_masks=ff.f_masks.float())
              for kf, ff in zip(keyframes, cap.ffs)]
    ref = ref_scene.fold(frames, p.voxel_size, cfg.main.depth_cut, cap_c)
    s = first.scene
    occ = s.count > 0
    out = dict(ref_scene.compare(ref, s.key[occ], s.count[occ], s.sum_feat[occ], s.feat_count[occ]))
    del frames, ref
    differing = 0
    for (_, key), rows in zip(pts_keys, cap.pix_rows):
        kept = ref_scene.kept_keys(key, cap_c)
        has = rows >= 0
        differing += int((has != (kept != ref_scene.SENTINEL)).sum())
        differing += int((has & (s.key[rows.clamp(min=0).long()].long() != kept)).sum())
    out["pixel_rows_differing"] = float(differing)
    out.update(mapping._instances(cfg, cap, pts_keys, first.instances))
    return out


def control_readings(r: Run, mode: str) -> Dict[str, float]:
    """``mapping.control_readings`` for SAM 2: the reference with every
    product in `mode` in the program's place, against the float32
    reference, at the sampled keyframes, by the check's own measures."""
    dev = r.device
    cfg = mapping.program_config(r)
    v = sizes(r)
    cv = ref_clip.CLIPSizes.of(r.config["clip"]["sizes"])
    sc, p = cfg.models.sam, cfg.pipeline
    keyframes = mapping._frames(r)
    rng = np.random.default_rng(mapping._seed(r.seed, 3))
    want = sorted(rng.choice(len(keyframes), size=r.traffic["check_keyframes"], replace=False).tolist())
    block = f"encoder.blocks.{int(rng.integers(sum(v.stages)))}."
    out = {"sam_linear_rel_rms": 0.0, "sam_logit_rel_rms": 0.0, "sam_iou_gap": 0.0, "clip_feat_gap": 0.0}
    inputs: Dict[str, torch.Tensor] = {}
    lin_orig = ref_sam2._lin

    def lin(x, params, name):
        if name.startswith(block) and name[len(block):] in mapping.LINEARS and not inputs.get("done"):
            inputs[name] = x
        return lin_orig(x, params, name)

    prev = _f32_off()
    try:
        with torch.no_grad():
            p_sam = weights.as_float32(sam2_weights(r, dev))
            p_clip = weights.as_float32(mapping.tower_weights(r, dev, "clip"))
            for j in want:
                rgb = torch.as_tensor(keyframes[j].rgb, dtype=torch.float32).to(dev)
                ref_sam2._lin = lin
                try:
                    logits, iou = _reference_sam2(p_sam, v, rgb, sc)
                finally:
                    ref_sam2._lin = lin_orig
                if not inputs.get("done"):
                    gaps = []
                    for n in mapping.LINEARS:
                        xi = inputs.pop(block + n)
                        with precision.lowered(mode):
                            yi = ref_sam2._lin(xi, p_sam, block + n)
                        gaps.append(mapping._linear_gap(p_sam, block + n, xi, yi))
                    out["sam_linear_rel_rms"], inputs["done"] = max(gaps), True
                with precision.lowered(mode):
                    lc, ic = _reference_sam2(p_sam, v, rgb, sc)
                out["sam_logit_rel_rms"] = max(out["sam_logit_rel_rms"], mapping._rms(lc - logits) / mapping._rms(logits))
                out["sam_iou_gap"] = max(out["sam_iou_gap"], float((ic - iou).abs().max()))
                del logits, iou
                masks, valid, boxes = imageops.select_masks(lc, ic, tuple(rgb.shape[:2]), sc.pred_iou_thresh,
                                                            sc.stability_score_thresh, float(sc.min_mask_region_area),
                                                            sc.max_masks)
                stack, sel, vt = ref_clip.crop_stack(cv, rgb, masks, valid, boxes, sc.max_masks,
                                                     float(p.clip_bbox_margin))
                f_p, f_g = ref_clip.fuse(ref_clip.encode_image(p_clip, cv, stack), sel, vt, sc.max_masks,
                                         p.clip_masked_weight)
                with precision.lowered(mode):
                    c_p, c_g = ref_clip.fuse(ref_clip.encode_image(p_clip, cv, stack), sel, vt, sc.max_masks,
                                             p.clip_masked_weight)
                cos = (c_p * f_p).sum(-1)[valid]
                gap = float((1.0 - cos).max()) if bool(valid.any()) else 0.0
                out["clip_feat_gap"] = max(out["clip_feat_gap"], gap, 1.0 - float(c_g @ f_g))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return out
