"""Mapping pipeline: posed RGB-D frames -> fused scene + merged instances
(counterpart of holoagent_tpu/memory/mapping.py).

Per frame: backproject -> scene insert -> SAM masks (mask stage) -> CLIP
crop features (clip stage) -> per-pixel feature fusion -> per-frame
instances -> instance fold (paired, sequential or hierarchical).
``finalize`` drains the hierarchical fold, then runs the final merge round,
the per-instance feature refinement and the density filter.  Scene and
instance state stay on the device.  With ``extract_frames_per_dispatch`` >
1, ``run`` extracts the keyframes in groups (``extract_frames_batched``:
one SAM encoder pass and one CLIP encode a group) and integrates them one
by one in frame order.

The reference's fused single-program frame step (``fused_frame_step``)
gives the same results as its staged path, which is the one the port runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from ..config import Config
from ..dataloader.generic import RGBDDataset, RGBDFrame
from ..device import DeviceLike, dtype_of, resolve
from ..models import clip as clip_mod
from ..models import sam as sam_mod
from ..ops.backproject import backproject
from ..ops.compact import I32_MAX
from ..ops.density import radius_density_keep
from ..ops.features import dominant_feature
from ..ops.voxel import GridSpec
from ..perception.extractor import (
    FrameFeatures,
    extract_frame_features,
    extract_frame_features_tiered,
    extract_frames_batched,
)
from ..utils.camera import Pinhole
from ..utils.timing import StageTimer, stage
from . import instances as inst_mod
from . import scene as scene_mod
from .instances import InstanceSet
from .scene import SceneState


@dataclass
class MappedScene:
    """Finalized mapping result."""

    scene: SceneState
    instances: InstanceSet
    instance_feats: torch.Tensor  # (I, D) denoised per-instance features
    keyframes: List[RGBDFrame] = field(default_factory=list)
    keyframe_feats: Optional[torch.Tensor] = None  # (F, D) global CLIP per frame
    density_keep: Optional[torch.Tensor] = None  # (C,) survived radius filter


class Mapper:
    """Streaming mapper over the port's towers.

    ``clip`` and ``sam`` must be in the config's working dtype
    (``models.clip.dtype``) and on ``device`` (default: the card).  Both
    may be None when every frame comes with its FrameFeatures (the oracle
    protocol); the feature width is then ``clip_variant``'s (default: the
    configured CLIP type's).  A ``timer`` (utils.timing.StageTimer) records
    synchronised per-stage ms."""

    def __init__(
        self,
        cfg: Config,
        clip: Optional[clip_mod.CLIPVisual] = None,
        sam: Optional[sam_mod.SAM] = None,
        device: DeviceLike = None,
        timer: Optional[StageTimer] = None,
        clip_variant: Optional[clip_mod.CLIPVariant] = None,
    ):
        p = cfg.pipeline
        self.device = resolve(device)
        dtype = dtype_of(cfg.models.clip.dtype)
        for name, model in (("clip", clip), ("sam", sam)):
            if model is None:
                continue
            w = next(model.parameters())
            if w.device.type != self.device.type:
                raise ValueError(f"{name} tower is on {w.device}, the mapper on {self.device}")
        if (clip is not None and clip.patch_w.dtype != dtype) or (sam is not None and sam.dtype != dtype):
            raise ValueError(f"towers must be in the config dtype {dtype}")
        self.cfg = cfg
        self.clip = clip
        self.sam = sam
        self.clip_variant = clip_variant or (clip.variant if clip is not None
                                             else clip_mod.VARIANTS[cfg.models.clip.type])
        self.timer = timer
        self.grid = GridSpec.centered(p.voxel_size)
        d = self.clip_variant.embed_dim
        self.scene = scene_mod.init_scene(self.grid, p.point_capacity, d, self.device)
        self.instances = inst_mod.empty_instances(p.instance_capacity, p.mask_point_capacity, d, self.device)
        self.keyframes: List[RGBDFrame] = []
        self._kf_feats: List[torch.Tensor] = []
        self._frames_since_full = 0  # paired fold: frames since the last full round
        self._hier_slots: Dict[int, InstanceSet] = {}  # hierarchical fold: one partial set a tree height

    def _pixel_stride(self, frame: RGBDFrame) -> int:
        s = self.cfg.pipeline.instance_pixel_stride
        if s > 0:
            return s
        return max(1, frame.rgb.shape[0] * frame.rgb.shape[1] // 32768)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def process_frame(self, frame: RGBDFrame, ff: Optional[FrameFeatures] = None) -> None:
        """Integrate one frame.  ff: optional precomputed FrameFeatures (on
        the mapper's device), which skips the mask and clip stages."""
        self.scene, self.instances, f_g = self._staged_step(frame, ff)
        self.keyframes.append(frame)
        self._kf_feats.append(f_g.float())

    def _extract_kw(self) -> dict:
        """The extraction settings of the config (SAM's and the crop stage's)."""
        sc, p = self.cfg.models.sam, self.cfg.pipeline
        return dict(
            points_per_side=sc.points_per_side,
            pred_iou_thresh=sc.pred_iou_thresh,
            stability_thresh=sc.stability_score_thresh,
            min_area=float(sc.min_mask_region_area),
            max_masks=sc.max_masks,
            masked_weight=p.clip_masked_weight,
            bbox_margin=float(p.clip_bbox_margin),
            impl=p.extract_impl,
            clip_impl=p.extract_clip_impl,
            timer=self.timer,
        )

    def _staged_step(self, frame: RGBDFrame, ff: Optional[FrameFeatures] = None):
        cfg, p, t = self.cfg, self.cfg.pipeline, self.timer
        with stage(t, "backproject"):
            rgb = self._tensor(frame.rgb)
            pts, cols, valid = backproject(
                self._tensor(frame.depth), rgb, Pinhole.from_matrix(frame.k),
                self._tensor(frame.pose), 1e-3, cfg.main.depth_cut,
            )
        with stage(t, "insert"):
            scene, pix_rows = scene_mod.insert_points(
                self.scene, pts, cols, valid, fcap=p.frame_voxel_capacity
            )
        if ff is None:
            if self.clip is None or self.sam is None:
                raise ValueError("a Mapper without towers needs the frame's FrameFeatures (ff)")
            extract_fn = extract_frame_features_tiered if p.extract_tiering else extract_frame_features
            ff = extract_fn(self.clip, self.sam, rgb, **self._extract_kw())
        masks_flat = ff.masks.reshape(ff.masks.shape[0], -1)
        with stage(t, "fuse"):
            scene = scene_mod.fuse_pixel_features(scene, pix_rows, masks_flat, ff.valid, ff.f_masks)
        with stage(t, "instances"):
            finst = inst_mod.frame_instances(
                masks_flat, ff.valid, ff.f_masks, pix_rows, pts,
                min_rows=3, k_cap=p.mask_point_capacity,
                stride=self._pixel_stride(frame), grid=self.grid,
                max_area_frac=p.instance_max_area_frac,
                max_extent=p.instance_max_extent_m,
            )
        merge_kw = dict(bbox_pad=0.5 * p.voxel_size, coarse_only=True, max_extent=p.instance_max_extent_m)
        with stage(t, "merge"):
            if p.merge_type == "hierarchical":
                # binary-counter fold: the frame's set enters at height 0;
                # two sets of one height merge and carry to the next, so
                # O(log F) partial sets stay resident (finalize drains them)
                self._hier_push(finst, height=0)
                instances = self.instances
            elif p.merge_type == "paired":
                instances = inst_mod.paired_merge_step(
                    self.instances, finst, p.init_overlap_thresh, p.iou_thresh, **merge_kw
                )
                self._frames_since_full += 1
                if self._frames_since_full >= p.paired_full_round_every:
                    instances = inst_mod.merge_round(
                        instances, p.init_overlap_thresh, p.iou_thresh,
                        out_cap=instances.rows.shape[0], **merge_kw,
                    )
                    self._frames_since_full = 0
            else:
                instances = inst_mod.seq_merge_step(
                    self.instances, finst, p.init_overlap_thresh, p.iou_thresh, **merge_kw
                )
        return scene, instances, ff.f_global

    def run(self, dataset: RGBDDataset) -> MappedScene:
        """Integrate every ``skip_frames``-th frame, then finalize.  With
        ``extract_frames_per_dispatch`` = bsz > 1, the keyframes are taken
        in groups of bsz: a group of two or more is extracted at once
        (``extract_frames_batched``, untiered), a last single frame by
        ``process_frame`` (tiered when ``extract_tiering`` is set), as the
        reference does; the frames are then integrated in their order."""
        p = self.cfg.pipeline
        idxs = list(range(0, len(dataset), p.skip_frames))
        bsz = max(1, p.extract_frames_per_dispatch)
        for s in range(0, len(idxs), bsz):
            frames = [dataset[i] for i in idxs[s : s + bsz]]
            if len(frames) == 1:
                self.process_frame(frames[0])
                continue
            if self.clip is None or self.sam is None:
                raise ValueError("batched extraction needs the towers")
            images = torch.stack([self._tensor(f.rgb) for f in frames])
            ffb = extract_frames_batched(self.clip, self.sam, images, **self._extract_kw())
            for j, frame in enumerate(frames):
                self.process_frame(frame, ff=FrameFeatures(*(a[j] for a in ffb)))
        return self.finalize()

    def _hier_th(self, height: int) -> float:
        """The hierarchical fold's overlap threshold at a tree height: it
        decays with the height (the reference's per-level decay)."""
        p = self.cfg.pipeline
        return p.init_overlap_thresh - p.overlap_thresh_factor * height

    def _hier_push(self, inst: InstanceSet, height: int) -> None:
        """Binary-counter carry: merge equal-height partial sets upward."""
        p = self.cfg.pipeline
        out_cap = self.instances.rows.shape[0]
        while height in self._hier_slots:
            cat = inst_mod.concat(self._hier_slots.pop(height), inst)
            inst = inst_mod.merge_round(
                cat, self._hier_th(height), p.iou_thresh, min(out_cap, cat.rows.shape[0]),
                bbox_pad=0.5 * p.voxel_size, coarse_only=True, max_extent=p.instance_max_extent_m,
            )
            height += 1
        self._hier_slots[height] = inst

    def _hier_drain(self) -> None:
        """Fold the hierarchical fold's partial sets, lowest height first,
        then the result into the instance table at the top height's
        threshold."""
        p = self.cfg.pipeline
        kw = dict(bbox_pad=0.5 * p.voxel_size, coarse_only=True, max_extent=p.instance_max_extent_m)
        out_cap = self.instances.rows.shape[0]
        acc, h_max = None, 0
        for h in sorted(self._hier_slots):
            s = self._hier_slots[h]
            h_max = max(h_max, h)
            if acc is None:
                acc = s
            else:
                cat = inst_mod.concat(acc, s)
                acc = inst_mod.merge_round(cat, self._hier_th(h), p.iou_thresh, min(out_cap, cat.rows.shape[0]), **kw)
        self._hier_slots = {}
        self.instances = inst_mod.seq_merge_step(self.instances, acc, self._hier_th(h_max), p.iou_thresh, **kw)

    def finalize(self) -> MappedScene:
        p = self.cfg.pipeline
        t = self.timer
        with stage(t, "finalize"):
            with stage(t, "finalize.merge"):
                if self._hier_slots:
                    self._hier_drain()
                # final merge pass, then drop tiny instances (< 10 rows)
                inst = inst_mod.merge_round(
                    self.instances, p.init_overlap_thresh, p.iou_thresh,
                    out_cap=self.instances.rows.shape[0], bbox_pad=0.5 * p.voxel_size,
                    coarse_only=True, max_extent=p.instance_max_extent_m,
                )
                self.instances = inst._replace(valid=inst.valid & (inst.count >= 10))
            with stage(t, "finalize.refine"):
                inst_feats = refine_instance_features(self.scene, self.instances, eps=p.feature_dbscan_eps)
            with stage(t, "finalize.density"):
                density = radius_density_keep(
                    self.scene.points(), self.scene.valid(), self.scene.count,
                    radius=1.0, min_neighbors=1000.0,
                )
            d = self.clip_variant.embed_dim
            kf = (
                torch.stack(self._kf_feats)
                if self._kf_feats
                else torch.zeros((0, d), device=self.device)
            )
        return MappedScene(
            scene=self.scene,
            instances=self.instances,
            instance_feats=inst_feats,
            keyframes=self.keyframes,
            keyframe_feats=kf,
            density_keep=density,
        )


def refine_instance_features(
    scene: SceneState, inst: InstanceSet, eps: float = 0.01, chunk: int = 32
) -> torch.Tensor:
    """Per-instance feature = dominant-cluster mean of its member scene
    points' fused features; falls back to the accumulated mask-feature mean
    for instances whose members carry none."""
    sfeats = scene.feats()
    c = sfeats.shape[0]
    outs = []
    for s in range(0, inst.rows.shape[0], chunk):
        rows = inst.rows[s : s + chunk]
        vr = (rows != I32_MAX) & inst.valid[s : s + chunk, None]
        feats = sfeats[rows.clamp(0, c - 1).to(torch.int64)]  # (B, K, D); pads masked below
        feats = torch.where(vr[..., None], feats, torch.zeros((), device=feats.device))
        outs.append(dominant_feature(feats, vr, eps=eps, min_points=100.0))
    refined = torch.cat(outs, dim=0)
    use_ref = torch.linalg.norm(refined, dim=-1) > 1e-6
    return torch.where(use_ref[:, None], refined, inst.feats())
