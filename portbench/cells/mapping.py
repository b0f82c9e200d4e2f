"""The mapping cells' driver: offline mapping of the walk, scene after
scene, through the program's ``Mapper.run``, and the check of what it
produced.

Traffic parameters (``portbench/traffic/<name>.json``):
- ``walk_frames``, ``frame_hw``: the walk (``portbench/walk.py``), every
  frame a keyframe, in the seed's order; each scene maps all of them;
- ``frames_per_dispatch``: 1 for the per-keyframe tiered path, F > 1 for
  ``extract_frames_batched`` over F frames;
- ``warmup_keyframes``: the keyframes of the warm-up scene (one finalize);
- ``profile_skip``, ``profile_keyframes``: the profiled stretch of the
  traced run, in keyframes from the window's start;
- ``check_keyframes``: how many keyframes of the first scene, drawn from
  the seed, the reference recomputes through both towers.

The window maps whole scenes, each by a fresh ``Mapper`` and ending in its
``finalize``, until ``--seconds`` have passed, then synchronises:
``keyframes_per_s`` is the keyframes of all its scenes over its length.

The check (all after the window, on the card, in float32 with TF32 off):
- ``sam_linear_rel_rms``: the four linears (qkv, proj, lin1, lin2) of
  one block of SAM's image encoder, drawn from the seed, in the encoder
  pass of the first sampled keyframe: each output against the float32
  product of the program's own input with the seeded weights, rms gap /
  rms, the largest of the four (the step where W8A8 departs from bf16);
- ``sam_logit_rel_rms``, ``sam_iou_gap``: the SAM decoder's mask logits
  and IoU predictions at the sampled keyframes against the plain float32
  SAM on the same frame (the image encoder on K1, the prompt encoder, the
  decoder);
- ``mask_select_differing``: the reference's selection (gates, NMS, top
  64, upsampling, the disjoint carve) over the program's own decoder
  output, against the program's masks, validity and boxes: pixels and
  entries that differ (exact);
- ``clip_feat_gap``: 1 - cosine of each valid per-mask feature and the
  frame's feature against the plain float32 CLIP over the crops of the
  program's masks (the crop stage, the tower on K2, the fusion);
- ``scene_rows_differing``, ``scene_feat_gap``: the first scene's voxel
  scene (keys, hit and feature counts exact; fused feature sums) against
  the plain fold of its frames with the program's per-frame masks and
  features (``reference/scene.py``);
- ``pixel_rows_differing``: the pixels whose scene row, which the
  program's instance fold reads, does not hold the pixel's voxel (exact);
- ``instances_differing``, ``instance_feat_gap``, ``instance_box_gap``:
  the first scene's instance table after ``finalize`` (lane by lane:
  validity, rows, voxel keys and counts exact; feature sums over their
  weight; boxes in metres) against the plain paired fold of its frames'
  masks and features over those rows (``reference/instances.py``).  The
  reference takes the pixel stride by the program's rule: the configured
  one, else one pixel in (H W // 32768).

The traced line also carries ``load``: the valid masks a keyframe over
the first scene, and the CLIP crop tier of every keyframe of the window.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from .. import walk, weights
from ..harness import Outcome, Run
from ..reference import clip as ref_clip
from ..reference import imageops, precision
from ..reference import instances as ref_inst
from ..reference import sam as ref_sam
from ..reference import scene as ref_scene
from ..yardstick import flops, roofline
from ..yardstick.trace import WINDOW, Events

SAM_F32 = ("prompt.", "encoder.neck_conv2")  # parameters SAM serves in float32 whatever its dtype


def _seed(seed: int, k: int) -> int:
    return (seed * 8 + k) & (2**63 - 1)


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def tower_weights(r: Run, device, tower: str) -> Dict[str, torch.Tensor]:
    """The seeded weights of one tower ("sam" or "clip"), each in the dtype
    it is served in."""
    dt = _dtype(r.config["dtype"])
    if tower == "sam":
        spec = ref_sam.spec(ref_sam.SAMSizes.of(r.config["sam"]["sizes"]))
        return weights.make(spec, _seed(r.seed, 1), lambda n: torch.float32 if n.startswith(SAM_F32) else dt,
                            device)
    spec = ref_clip.visual_spec(ref_clip.CLIPSizes.of(r.config["clip"]["sizes"]))
    return weights.make(spec, _seed(r.seed, 2), lambda n: dt, device)


def program_config(r: Run):
    from holoagent_tpu_torch.config import from_dict

    cfg = from_dict(r.config["program"])
    p = cfg.pipeline
    p.skip_frames = 1
    p.extract_frames_per_dispatch = r.traffic["frames_per_dispatch"]
    if r.control == "w8a8":
        cfg.models.clip.quant = cfg.models.sam.quant = True
    return cfg


def program_towers(r: Run, cfg, device):
    """The program's SAM and CLIP visual tower, loaded with the seeded
    weights, then quantized by the program where the configuration says
    W8A8."""
    from holoagent_tpu_torch.models import clip as clip_mod
    from holoagent_tpu_torch.models import sam as sam_mod

    dt = _dtype(r.config["dtype"])
    sv, cv = sam_mod.VARIANTS[cfg.models.sam.type], clip_mod.VARIANTS[cfg.models.clip.type]
    for name, want, got in (("sam", r.config["sam"]["sizes"], sv), ("clip", r.config["clip"]["sizes"], cv)):
        for k, v in want.items():
            if getattr(got, k) != (tuple(v) if isinstance(v, list) else v):
                raise ValueError(f"the program's {name} variant has {k}={getattr(got, k)}, the configuration {v}")
    sam = sam_mod.SAM(sv, dtype=dt, device=device)
    weights.load_into(sam, tower_weights(r, device, "sam"))
    clip = clip_mod.CLIPVisual(cv, dtype=dt, device=device, impl=cfg.pipeline.extract_clip_impl)
    weights.load_into(clip, tower_weights(r, device, "clip"))
    if cfg.models.sam.quant:
        sam = sam_mod.quantize_sam(sam)
    if cfg.models.clip.quant:
        clip = clip_mod.quantize_clip(clip)
    return clip, sam


class Scene:
    """The keyframes of one scene as the program's dataset; in a traced run
    it starts and stops the profiler as the program fetches keyframes."""

    def __init__(self, frames, on_fetch=None):
        self.frames = frames
        self.on_fetch = on_fetch

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        if self.on_fetch is not None:
            self.on_fetch(i)
        return self.frames[i]


LINEARS = ("qkv", "proj", "lin1", "lin2")  # an encoder block's linears


class Capture:
    """Keeps what the timed path produced for the check: the first scene's
    per-keyframe FrameFeatures and the scene row of each pixel (the
    program's state that its instance fold reads); the SAM decoder's output
    at the sampled keyframes (by the decoder's call order, one call a
    keyframe); and the input and output of each linear of encoder block
    `block` in the encoder pass `encoder_pass` (one pass a dispatch)."""

    def __init__(self, want_decode, block: int, encoder_pass: int):
        self.want = set(want_decode)
        self.decode: Dict[int, tuple] = {}
        self.ffs: List = []
        self.pix_rows: List[torch.Tensor] = []
        self.block, self.encoder_pass = block, encoder_pass
        self.linears: Dict[str, tuple] = {}
        self.n_linear: Dict[str, int] = dict.fromkeys(LINEARS, 0)
        self.on = False
        self.n_decode = 0

    def _linear_hook(self, name):
        def hook(module, args, out):
            if self.on:
                if self.n_linear[name] == self.encoder_pass:
                    self.linears[name] = (args[0], out)
                self.n_linear[name] += 1
        return hook

    @contextlib.contextmanager
    def installed(self, batched: bool, sam):
        from holoagent_tpu_torch.memory import instances as inst_mod
        from holoagent_tpu_torch.memory import mapping as mapping_mod
        from holoagent_tpu_torch.models import sam as sam_mod
        from holoagent_tpu_torch.perception.extractor import FrameFeatures

        dec_orig = sam_mod._decode_grid
        fi_orig = inst_mod.frame_instances
        name = "extract_frames_batched" if batched else "extract_frame_features_tiered"
        ext_orig = getattr(mapping_mod, name)

        def decode(*a, **kw):
            out = dec_orig(*a, **kw)
            if self.on:
                if self.n_decode in self.want:
                    self.decode[self.n_decode] = out
                self.n_decode += 1
            return out

        def extract(*a, **kw):
            ff = ext_orig(*a, **kw)
            if self.on and batched:
                self.ffs.extend(FrameFeatures(*(x[j] for x in ff)) for j in range(ff.masks.shape[0]))
            elif self.on:
                self.ffs.append(ff)
            return ff

        def frame_instances(masks, mask_valid, f_masks, pix_rows, *a, **kw):
            if self.on:
                self.pix_rows.append(pix_rows)
            return fi_orig(masks, mask_valid, f_masks, pix_rows, *a, **kw)

        sam_mod._decode_grid = decode
        setattr(mapping_mod, name, extract)
        inst_mod.frame_instances = frame_instances
        blk = sam.encoder.blocks[self.block]
        hooks = [getattr(blk, n).register_forward_hook(self._linear_hook(n)) for n in LINEARS]
        try:
            yield self
        finally:
            for h in hooks:
                h.remove()
            sam_mod._decode_grid = dec_orig
            setattr(mapping_mod, name, ext_orig)
            inst_mod.frame_instances = fi_orig


@contextlib.contextmanager
def planted(fault):
    """A fault under the timed path, for the harness's own tests:
    "state_unchanged" (each step leaves the scene and instances as they
    were), "half_batch" (the SAM decoder's prompts and the CLIP tower's
    crops: the first half of each batch is kept, the rest get its mean),
    "answer_altered" (one mask's feature is negated where the extractor
    produces it), "merge_skipped" (the instance fold merges nothing: each
    frame's instances are appended; the full rounds still compact)."""
    if fault is None:
        yield
        return
    from holoagent_tpu_torch.memory import instances as inst_mod
    from holoagent_tpu_torch.memory.mapping import Mapper
    from holoagent_tpu_torch.models import clip as clip_mod
    from holoagent_tpu_torch.models import sam as sam_mod
    from holoagent_tpu_torch.perception import extractor

    def halved(x):
        h = (x.shape[0] + 1) // 2
        return torch.cat([x[:h], x[:h].mean(dim=0, keepdim=True).expand(x.shape[0] - h, *x.shape[1:])])

    patches = {}
    if fault == "state_unchanged":
        orig = Mapper._staged_step
        patches[Mapper, "_staged_step"] = lambda self, frame, ff=None: (
            self.scene, self.instances, orig(self, frame, ff)[2])
    elif fault == "half_batch":
        enc, dec = clip_mod.encode_image, sam_mod._decode_grid

        def encode(visual, images, **kw):
            n = images.shape[0]
            head = enc(visual, images[: (n + 1) // 2], **kw)
            mean = head.mean(dim=0, keepdim=True)
            mean = mean / torch.linalg.norm(mean, dim=-1, keepdim=True)
            return torch.cat([head, mean.expand(n - head.shape[0], -1)])

        patches[clip_mod, "encode_image"] = encode
        patches[sam_mod, "_decode_grid"] = lambda *a, **kw: tuple(halved(x) for x in dec(*a, **kw))
    elif fault == "answer_altered":
        fuse = extractor._fuse

        def bad_fuse(feats, sel, valid_t, m, masked_weight):
            f_full, f_g = fuse(feats, sel, valid_t, m, masked_weight)
            f_full = f_full.clone()
            f_full[sel[0]] = -f_full[sel[0]]
            return f_full, f_g

        patches[extractor, "_fuse"] = bad_fuse
    elif fault == "merge_skipped":
        # an overlap share never exceeds 1
        merge, paired = inst_mod.merge_round, inst_mod.paired_merge_step
        patches[inst_mod, "merge_round"] = lambda inst, overlap_thresh, *a, **kw: merge(inst, 2.0, *a, **kw)
        patches[inst_mod, "paired_merge_step"] = lambda g, f, overlap_thresh, *a, **kw: paired(g, f, 2.0, *a, **kw)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    saved = {k: getattr(*k) for k in patches}
    for (owner, name), bad in patches.items():
        setattr(owner, name, bad)
    try:
        yield
    finally:
        for (owner, name), f in saved.items():
            setattr(owner, name, f)


@contextlib.contextmanager
def kernel_wrappers():
    """The kernel wrappers, K1, K2 and K3, with their launch records
    (``<wrapper>.trace``) switched off again on the way out."""
    from holoagent_tpu_torch.ops import flash_attention as fa
    from holoagent_tpu_torch.ops import quant_matmul as qm

    wrappers = {"k1": fa.flash_attention_2d, "k2": fa.flash_attention, "k3": qm.quant_matmul}
    try:
        yield wrappers
    finally:
        for w in wrappers.values():
            w.trace = None


class Profiled:
    """Starts the profiler at the fetch of keyframe `start` of the window's
    first scene and stops it at keyframe `stop`, synchronising at both
    ends; records the stretch's wall time and the shape key of every
    kernel launch in it (``<wrapper>.trace``, on only in the stretch)."""

    def __init__(self, start: int, stop: int, device, wrappers):
        self.start, self.stop, self.device, self.wrappers = start, stop, device, wrappers
        self.prof = None
        self.region = None
        self.wall_s = 0.0
        self.keyframes = stop - start
        self.keys: Dict[str, list] = {}

    def __call__(self, i: int) -> None:
        if i == self.start and self.prof is None:
            self._sync()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.region = torch.profiler.record_function(WINDOW)
            self.region.__enter__()
            for w in self.wrappers.values():
                w.trace = []
            self.t = time.perf_counter()
        elif i == self.stop and self.region is not None:
            self._sync()
            self.wall_s = time.perf_counter() - self.t
            for k, w in self.wrappers.items():
                self.keys[k] = [key for key, _, _ in w.trace]
                w.trace = None
            self.region.__exit__(None, None, None)
            self.region = None
            self.prof.stop()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _frames(r: Run):
    from holoagent_tpu_torch.dataloader.generic import RGBDFrame

    t = r.traffic
    rgb, depth, poses, k = walk.load(t["walk_frames"], tuple(t["frame_hw"]))
    order = walk.order(r.seed, t["walk_frames"])
    return [RGBDFrame(rgb=rgb[i], depth=depth[i], pose=poses[i], k=k) for i in order]


def run(r: Run) -> Outcome:
    from holoagent_tpu_torch.memory.mapping import Mapper
    from holoagent_tpu_torch.utils.timing import StageTimer

    dev, t = r.device, r.traffic
    cuda = dev.type == "cuda"
    cfg = program_config(r)
    clip, sam = program_towers(r, cfg, dev)
    keyframes = _frames(r)
    batched = t["frames_per_dispatch"] > 1
    rng = np.random.default_rng(_seed(r.seed, 3))
    want = sorted(rng.choice(len(keyframes), size=t["check_keyframes"], replace=False).tolist())
    block = int(rng.integers(len(sam.encoder.blocks)))
    cap = Capture(want, block, want[0] // t["frames_per_dispatch"])

    # the fault goes under the capture: what the capture keeps is what the
    # timed path produced
    with planted(r.fault), cap.installed(batched, sam), torch.no_grad():
        Mapper(cfg, clip, sam, dev).run(Scene(keyframes[: t["warmup_keyframes"]]))
        if cuda:
            torch.cuda.synchronize(dev)
        timer = StageTimer(dev) if r.trace else None
        scenes, first = 0, None
        with kernel_wrappers() as wrappers:
            prof = (Profiled(t["profile_skip"], t["profile_skip"] + t["profile_keyframes"], dev, wrappers)
                    if r.trace else None)
            cap.on = True
            t_start = time.perf_counter()
            while True:
                mapped = Mapper(cfg, clip, sam, dev, timer=timer).run(Scene(keyframes, prof if scenes == 0 else None))
                if scenes == 0:
                    first, cap.on = mapped, False
                scenes += 1
                if time.perf_counter() - t_start >= r.seconds:
                    break
            if cuda:
                torch.cuda.synchronize(dev)
            t_end = time.perf_counter()
    n_kf = scenes * len(keyframes)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace_data, load = {}, {}
    if r.trace:
        trace_data = traced(r, cfg, timer, prof, n_kf, batched)
        nv = sorted(int(ff.valid.sum()) for ff in cap.ffs)
        tiers = timer.notes.get("tier") or [cfg.models.sam.max_masks] * n_kf  # batched: untiered
        load = {"valid_masks_a_keyframe": {"min": nv[0], "median": nv[len(nv) // 2], "max": nv[-1],
                                           "mean": sum(nv) / len(nv)},
                "crop_tier_keyframes": {str(k): tiers.count(k) for k in sorted(set(tiers))}}
    del clip, sam, mapped
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(r, cfg, cap, first, keyframes, dev)
    print(f"portbench: the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr, flush=True)
    return Outcome(
        attempted=n_kf, failed=0,
        end_to_end={"keyframes_per_s": n_kf / (t_end - t_start), "setup_s": t_start - r.t0},
        trace_data=trace_data, checks=checks, memory_peak_bytes=int(peak), load=load,
        device_kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        device_count=1,
    )


def traced(r: Run, cfg, timer, prof: Profiled, n_kf: int, batched: bool) -> dict:
    """What the per-layer readers read: the stage timer's ms, the profiled
    stretch's kernel launches with their kernels' device seconds, busy
    time and breakdown, and its model operations' least time."""
    sv = ref_sam.SAMSizes.of(r.config["sam"]["sizes"])
    cv = ref_clip.CLIPSizes.of(r.config["clip"]["sizes"])
    sam_ops = flops.sam_frame_ops(sv, cfg.models.sam.points_per_side)
    crop_ops = flops.clip_crop_ops(cv)
    m = cfg.models.sam.max_masks
    tiers = timer.notes.get("tier", [])
    stretch = range(prof.start, prof.stop)
    ideal = 0.0
    for j in stretch:
        tier = m if batched else tiers[j]
        ideal += flops.ideal_seconds(sam_ops, cfg.models.sam.quant)
        ideal += (2 * tier + 1) * flops.ideal_seconds(crop_ops, cfg.models.clip.quant)
    ev = Events.from_profiler(prof.prof) if prof.prof is not None else None
    device_s = ev.device_seconds(roofline.kernel_of) if ev and ev.window else {}
    launches = {}
    for k, keys in prof.keys.items():
        if keys and r.device.type == "cuda":
            if device_s.get(k, 0.0) <= 0.0:
                raise RuntimeError(f"{len(keys)} {k} launches in the profiled stretch, none of its kernels in the trace")
            launches[k] = {"keys": keys, "device_s": device_s[k]}
    data = {
        "keyframes": n_kf,
        "stage_ms": dict(timer.ms),
        "stage_calls": dict(timer.calls),
        "launches": launches,
        "stretch": {"keyframes": prof.keyframes, "wall_s": prof.wall_s, "ideal_s": ideal},
        "busy_s": ev.busy_s() if ev and ev.window else 0.0,
        "window_s": ev.window_s() if ev and ev.window else prof.wall_s,
        "breakdown": {"device_ops": ev.top_device_ops(), "idle_gaps": ev.idle_gaps()} if ev and ev.window else {},
    }
    return data


def _rms(x) -> float:
    return float(x.double().pow(2).mean().sqrt())


def _linear_gap(p, name: str, x, y) -> float:
    """rms(y - (x W + b)) / rms(x W + b), with the float32 weights `p`."""
    w, b = p[name + ".w"], p[name + ".b"]
    ref = precision.mm(x.float().reshape(-1, w.shape[0]), w) + b
    return _rms(y.float().reshape(ref.shape) - ref) / _rms(ref)


def _linears(cap: Capture, p_sam) -> float:
    """sam_linear_rel_rms: the largest gap of the captured block's linears."""
    if sorted(cap.linears) != sorted(LINEARS):
        raise RuntimeError(f"captured the linears {sorted(cap.linears)} of encoder block {cap.block}")
    return max(_linear_gap(p_sam, f"encoder.blocks.{cap.block}.{n}", *cap.linears[n]) for n in LINEARS)


def check(r: Run, cfg, cap: Capture, first, keyframes, dev) -> Dict[str, float]:
    """The numbers compared with their limits (module docstring)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _check(r, cfg, cap, first, keyframes, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _check(r: Run, cfg, cap: Capture, first, keyframes, dev) -> Dict[str, float]:
    sv = ref_sam.SAMSizes.of(r.config["sam"]["sizes"])
    cv = ref_clip.CLIPSizes.of(r.config["clip"]["sizes"])
    sc, p = cfg.models.sam, cfg.pipeline
    p_sam = weights.as_float32(tower_weights(r, dev, "sam"))
    out = {"sam_linear_rel_rms": _linears(cap, p_sam), "sam_logit_rel_rms": 0.0, "sam_iou_gap": 0.0,
           "mask_select_differing": 0.0, "clip_feat_gap": 0.0}
    if len(cap.ffs) != len(keyframes) or len(cap.pix_rows) != len(keyframes) or sorted(cap.decode) != sorted(cap.want):
        raise RuntimeError(f"captured {len(cap.ffs)} keyframes' features, {len(cap.pix_rows)} instance folds and "
                           f"decoder calls {sorted(cap.decode)} of the first scene's {len(keyframes)} and "
                           f"{sorted(cap.want)}")
    p_clip = weights.as_float32(tower_weights(r, dev, "clip"))
    for j in cap.want:
        rgb = torch.as_tensor(keyframes[j].rgb, dtype=torch.float32).to(dev)
        hw = tuple(rgb.shape[:2])
        emb = ref_sam.encode_image(p_sam, sv, ref_sam.preprocess(rgb[None], sv.img_size))[0]
        logits, iou = ref_sam.decode_grid(p_sam, sv, emb, sc.points_per_side)
        lp, ip = cap.decode[j]
        out["sam_logit_rel_rms"] = max(out["sam_logit_rel_rms"], _rms(lp.float() - logits) / _rms(logits))
        out["sam_iou_gap"] = max(out["sam_iou_gap"], float((ip.float() - iou).abs().max()))
        del emb, logits, iou
        ff = cap.ffs[j]
        masks, valid, boxes = imageops.select_masks(lp.float(), ip.float(), hw, sc.pred_iou_thresh,
                                                    sc.stability_score_thresh, float(sc.min_mask_region_area),
                                                    sc.max_masks)
        out["mask_select_differing"] += float((masks != ff.masks).sum() + (valid != ff.valid).sum()
                                              + (boxes != ff.boxes).any(dim=-1).sum())
        # a mask's fused feature does not depend on the crop tier, which
        # always holds every valid mask: the reference cuts all max_masks
        n_valid = int(ff.valid.sum())
        stack, sel, vt = ref_clip.crop_stack(cv, rgb, ff.masks, ff.valid, ff.boxes, sc.max_masks,
                                             float(p.clip_bbox_margin))
        f_p, f_g = ref_clip.fuse(ref_clip.encode_image(p_clip, cv, stack), sel, vt, sc.max_masks,
                                 p.clip_masked_weight)
        cos = (ff.f_masks.float() * f_p).sum(-1)[ff.valid]
        gap = max([float((1.0 - cos).max())] if n_valid else [0.0])
        out["clip_feat_gap"] = max(out["clip_feat_gap"], gap, 1.0 - float(ff.f_global.float() @ f_g))
    del p_sam, p_clip
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
    out.update(ref_scene.compare(ref, s.key[occ], s.count[occ], s.sum_feat[occ], s.feat_count[occ]))
    del frames, ref
    # the instance fold reads the program's scene row of each pixel: check
    # that each row holds the pixel's voxel, then fold the instances
    differing = 0
    for (_, key), rows in zip(pts_keys, cap.pix_rows):
        kept = ref_scene.kept_keys(key, cap_c)
        has = rows >= 0
        differing += int((has != (kept != ref_scene.SENTINEL)).sum())
        differing += int((has & (s.key[rows.clamp(min=0).long()].long() != kept)).sum())
    out["pixel_rows_differing"] = float(differing)
    out.update(_instances(cfg, cap, pts_keys, first.instances))
    return out


def _instances(cfg, cap: Capture, pts_keys, inst) -> Dict[str, float]:
    """The first scene's instance table after finalize against the plain
    paired fold of its frames' masks and features (``reference/
    instances.py``)."""
    p, (h, w) = cfg.pipeline, cap.ffs[0].masks.shape[1:]
    if p.merge_type != "paired":
        raise ValueError(f"the instance reference folds paired, the configuration {p.merge_type!r}")
    stride = p.instance_pixel_stride if p.instance_pixel_stride > 0 else max(1, h * w // 32768)
    frames = [dict(masks=ff.masks.reshape(ff.masks.shape[0], -1), valid=ff.valid, f_masks=ff.f_masks.float(),
                   rows=rows, keys=key, pts=pts)
              for ff, rows, (pts, key) in zip(cap.ffs, cap.pix_rows, pts_keys)]
    ref = ref_inst.fold(frames, dict(
        capacity=p.instance_capacity, k_cap=p.mask_point_capacity, d=cap.ffs[0].f_masks.shape[-1], stride=stride,
        overlap_thresh=p.init_overlap_thresh, iou_thresh=p.iou_thresh, pad=0.5 * p.voxel_size,
        max_extent=p.instance_max_extent_m, max_area_frac=p.instance_max_area_frac,
        full_round_every=p.paired_full_round_every))
    prog = {"rows": inst.rows, "count": inst.count, "ckeys": inst.ckeys, "ccount": inst.ccount, "feat": inst.feat_sum,
            "weight": inst.weight, "bmin": inst.bbox_min, "bmax": inst.bbox_max, "valid": inst.valid}
    return ref_inst.compare(ref, prog)


def control_readings(r: Run, mode: str) -> Dict[str, float]:
    """The control in the program's place: the reference towers with every
    product in `mode` (``reference/precision.py``) against the float32
    reference, at the keyframes the check samples, by the check's own
    measures (the sampled encoder block's linears on the float32 encoder's
    inputs to them at the first sampled keyframe; the decoder's logits and
    IoU predictions; each valid mask's fused feature over the crops of the
    control's own masks)."""
    dev = r.device
    cfg = program_config(r)
    sv = ref_sam.SAMSizes.of(r.config["sam"]["sizes"])
    cv = ref_clip.CLIPSizes.of(r.config["clip"]["sizes"])
    sc, p = cfg.models.sam, cfg.pipeline
    keyframes = _frames(r)
    rng = np.random.default_rng(_seed(r.seed, 3))
    want = sorted(rng.choice(len(keyframes), size=r.traffic["check_keyframes"], replace=False).tolist())
    block = f"encoder.blocks.{int(rng.integers(sv.depth))}."
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {"sam_linear_rel_rms": 0.0, "sam_logit_rel_rms": 0.0, "sam_iou_gap": 0.0, "clip_feat_gap": 0.0}
    inputs: Dict[str, torch.Tensor] = {}
    lin_orig = ref_sam._lin

    def lin(x, p, name):
        if name.startswith(block) and not inputs.get("done"):
            inputs[name] = x
        return lin_orig(x, p, name)

    try:
        with torch.no_grad():
            p_sam = weights.as_float32(tower_weights(r, dev, "sam"))
            p_clip = weights.as_float32(tower_weights(r, dev, "clip"))
            for j in want:
                rgb = torch.as_tensor(keyframes[j].rgb, dtype=torch.float32).to(dev)
                x = ref_sam.preprocess(rgb[None], sv.img_size)
                ref_sam._lin = lin
                try:
                    emb = ref_sam.encode_image(p_sam, sv, x)[0]
                finally:
                    ref_sam._lin = lin_orig
                if not inputs.get("done"):
                    gaps = []
                    for n in LINEARS:
                        xi = inputs.pop(block + n)
                        with precision.lowered(mode):
                            yi = ref_sam._lin(xi, p_sam, block + n)
                        gaps.append(_linear_gap(p_sam, block + n, xi, yi))
                    out["sam_linear_rel_rms"], inputs["done"] = max(gaps), True
                logits, iou = ref_sam.decode_grid(p_sam, sv, emb, sc.points_per_side)
                with precision.lowered(mode):
                    lc, ic = ref_sam.decode_grid(p_sam, sv, ref_sam.encode_image(p_sam, sv, x)[0],
                                                 sc.points_per_side)
                out["sam_logit_rel_rms"] = max(out["sam_logit_rel_rms"], _rms(lc - logits) / _rms(logits))
                out["sam_iou_gap"] = max(out["sam_iou_gap"], float((ic - iou).abs().max()))
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
