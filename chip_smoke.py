"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the hand-written attention kernels (nvcc, sm_90a) from
     holoagent_tpu_torch/csrc into holoagent_tpu_torch/_build;
  3. kernels: hold each kernel against its plain PyTorch version at the
     mapping path's shapes, to a limit set by each case's own output scale
     that a plain version with a dropped key tile fails; time kernel, plain
     version and the one PyTorch library call computing the same function
     (a yardstick only);
  4. towers: at full width, hold the SAM and CLIP encoders through the
     kernels against the same encoders through the plain versions;
  5. main path: Mapper.run + finalize over posed 640x480 frames of the
     synthetic three-room scene, SAM vit_b + CLIP ViT-L/14 in bf16 from a
     seeded generator, at the settings of config/synthetic_tpu_3room.yaml;
     per-stage ms, frames/s, peak memory; the kernels' launch counts and
     their device time inside the run.
Prints one JSON line of kernels, then the nvidia-smi line, then as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from holoagent_tpu_torch.config import from_dict  # noqa: E402
from holoagent_tpu_torch.dataloader import SyntheticDataset, SyntheticScene  # noqa: E402
from holoagent_tpu_torch.memory.mapping import Mapper  # noqa: E402
from holoagent_tpu_torch.models import clip as clip_mod  # noqa: E402
from holoagent_tpu_torch.models import sam as sam_mod  # noqa: E402
from holoagent_tpu_torch.ops import flash_attention as fa  # noqa: E402
from holoagent_tpu_torch.utils.timing import StageTimer  # noqa: E402

# H100 SXM published peaks (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version.  Both take bf16 inputs, accumulate in f32 and
# round the output to bf16; they differ by where the probabilities are
# rounded (the kernel rounds them unnormalised, the plain version
# normalised).  bf16 keeps 8 significant bits, so one ulp is at most 2^-7 of
# a value.  Each case is held to its own output scale:
#   max|out - ref| <= 2^-6 * max|ref|        (two ulps of the largest output)
#   rms(out - ref) <= 2^-7 * rms(ref)        (one ulp, relative)
# and the same test must reject the plain version with one key tile dropped
# (and, for K1, with bias_w dropped on one 64-query tile of one head), so a
# kernel that skips a tile or part of the bias cannot pass.
MAX_ERR_OF_MAX = 2.0**-6
REL_RMS_TOL = 2.0**-7
FRAMES = 12  # rendered poses; every 2nd is a keyframe (skip_frames 2) -> 6
SEED = 0

# config/synthetic_tpu_3room.yaml, field for field (no YAML on the card)
CONFIG = {
    "main": {
        "dataset": "synthetic", "scene_id": "synthetic_tpu_3room", "layout": "three_room",
        "save_path": "/tmp/holoagent_tpu/scene_graphs", "depth_cut": 10.0,
        "frame_h": 480, "frame_w": 640, "num_frames": 24,
    },
    "models": {
        "clip": {"type": "ViT-L-14", "dtype": "bfloat16"},
        "sam": {
            "type": "vit_b", "dtype": "bfloat16", "points_per_side": 12,
            "pred_iou_thresh": -10.0, "stability_score_thresh": 0.0,
            "min_mask_region_area": 100, "max_masks": 64,
        },
    },
    "pipeline": {
        "merge_type": "paired", "extract_clip_impl": "flash", "extract_tiering": True,
        "voxel_size": 0.05, "skip_frames": 2, "extract_impl": "flash",
        "point_capacity": 524288, "mask_point_capacity": 2048, "instance_capacity": 256,
        "instance_max_area_frac": 1.0, "instance_max_extent_m": 1.0e9, "obj_labels": "SCANNET20",
    },
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, samples: int = 10, reps: int = 10) -> float:
    """Median over `samples` of the mean device time of `reps` back-to-back
    calls, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def agreement(out, ref) -> dict:
    d, r = out.float() - ref.float(), ref.float()
    ref_max, ref_rms = r.abs().max().item(), r.pow(2).mean().sqrt().item()
    return dict(max_abs_err=d.abs().max().item(), tol=MAX_ERR_OF_MAX * ref_max, ref_max=ref_max,
                ref_rms=ref_rms, rel_rms_err=d.pow(2).mean().sqrt().item() / ref_rms)


def agrees(a: dict) -> bool:
    return a["max_abs_err"] <= a["tol"] and a["rel_rms_err"] <= REL_RMS_TOL


def hold(name: str, out, ref, mutants) -> dict:
    """Hold a kernel's output against its plain version; the test must also
    reject each mutant (a plain version computed with a deliberate fault)."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    a = agreement(out, ref)
    check(agrees(a), f"{name}: {a} exceeds max_abs_err <= tol, rel_rms_err <= {REL_RMS_TOL}")
    for what, bad in mutants:
        m = agreement(bad, ref)
        check(not agrees(m), f"{name}: the test would pass a plain version with {what}: {m}")
        log(f"[kernel] {name}: rejects a plain version with {what}: err {m['max_abs_err']:.3e} "
            f"(tol {m['tol']:.3e}), rel rms err {m['rel_rms_err']:.3e}")
    return a


def k1_case(name, bh, g, gen):
    n, d = g * g, 64
    q, k, v = (torch.randn(bh, n, d, generator=gen).to("cuda", torch.bfloat16) for _ in range(3))
    bias_h = (0.5 * torch.randn(bh, n, g, generator=gen)).cuda()
    bias_w = (0.5 * torch.randn(bh, n, g, generator=gen)).cuda()
    out = fa.flash_attention_2d(q, k, v, bias_h, bias_w, (g, g))
    ref = fa.flash_attention_2d_ref(q, k, v, bias_h, bias_w, (g, g))
    no_row0, no_bias_w = bias_h.clone(), bias_w.clone()
    no_row0[..., 0] = fa.NEG_INF  # the keys of grid row 0: one 64-key tile at g=64
    no_bias_w[0, :64] = 0.0
    res = hold(name, out, ref, [
        ("the keys of grid row 0 dropped", fa.flash_attention_2d_ref(q, k, v, no_row0, bias_w, (g, g))),
        ("bias_w dropped on one query tile", fa.flash_attention_2d_ref(q, k, v, bias_h, no_bias_w, (g, g))),
    ])
    mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(bh, n, n).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res.update(
        kernel="flash_attention_2d", key=(bh, g, g), name=name, shape=f"BH={bh} N={n} h=w={g} D={d} bf16",
        ms=time_ms(lambda: fa.flash_attention_2d(q, k, v, bias_h, bias_w, (g, g))),
        plain_ms=time_ms(lambda: fa.flash_attention_2d_ref(q, k, v, bias_h, bias_w, (g, g)), samples=5, reps=2),
        library_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
    )
    flops = 4.0 * n * n * d * bh
    nbytes = 4 * bh * n * d * 2 + bh * n * 2 * g * 4
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
    del mask
    return res


def k2_case(name, b, h, t, causal, gen):
    d = 64
    q, k, v = (torch.randn(b, h, t, d, generator=gen).to("cuda", torch.bfloat16) for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=causal)
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    v_bad = v.clone()
    v_bad[:, :, :64] = 0
    res = hold(name, out, ref, [
        ("the values of the first 64-key tile dropped", fa.flash_attention_ref(q, k, v_bad, causal=causal)),
    ])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res.update(
        kernel="flash_attention", key=(b, h, t, causal), name=name,
        shape=f"B={b} H={h} T={t} D={d} causal={causal} bf16",
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
        plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v, causal=causal), samples=5, reps=2),
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=causal)),
    )
    pairs = t * (t + 1) / 2 if causal else t * t  # key/query pairs this input needs
    res["bound_ms"], res["bound_by"] = bound(4.0 * pairs * d * b * h, 4 * b * h * t * d * 2)
    return res


def kernel_phases():
    gen = torch.Generator().manual_seed(SEED)
    cases = [
        k1_case("k1_global", 12, 64, gen),  # vit_b global layers: 64x64 grid, 12 heads
        k1_case("k1_window", 300, 14, gen),  # vit_b windows: 25 windows x 12 heads, 14x14
    ]
    for tier in (16, 32, 64):  # CLIP ViT-L/14 crop stack: B = 2*tier + 1
        cases.append(k2_case(f"k2_clip_tier{tier}", 2 * tier + 1, 16, 257, False, gen))
    cases.append(k2_case("k2_causal_t384", 4, 16, 384, True, gen))
    cases.append(k2_case("k2_t200", 4, 16, 200, False, gen))
    for c in cases:
        log(f"[kernel] {c['name']:18s} {c['shape']:38s} err {c['max_abs_err']:.3e} (tol {c['tol']:.3e}, "
            f"max|ref| {c['ref_max']:.3e}, rms(ref) {c['ref_rms']:.3e}, rel rms err {c['rel_rms_err']:.3e} "
            f"tol {REL_RMS_TOL:.3e}) "
            f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  library {c['library_ms']:.4f} ms  "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    return {c["name"]: c for c in cases}


# ---------------------------------------------------------------------------
# towers and main path
# ---------------------------------------------------------------------------


def tower_checks(clip, sam, frame):
    """Full-width encoders through the kernels vs through the plain versions."""
    img = torch.as_tensor(frame.rgb, device="cuda")
    x = sam_mod.preprocess(img[None], sam.variant.img_size)
    e_k = sam_mod.encode_image(sam.encoder, x, sam.variant, impl="flash").float()
    e_p = sam_mod.encode_image(sam.encoder, x, sam.variant, impl="xla").float()
    cos_sam = torch.nn.functional.cosine_similarity(e_k.flatten(), e_p.flatten(), dim=0).item()
    rel_sam = ((e_k - e_p).norm() / e_p.norm()).item()
    gen = torch.Generator().manual_seed(SEED + 1)
    crops = torch.randn(9, 224, 224, 3, generator=gen).cuda()
    f_k = clip_mod.encode_image(clip, crops, impl="flash")
    f_p = clip_mod.encode_image(clip, crops, impl="xla")
    cos_clip = (f_k * f_p).sum(-1).min().item()
    log(f"[towers] SAM vit_b embedding flash vs plain: cosine {cos_sam:.6f}, rel err {rel_sam:.3e}; "
        f"CLIP ViT-L/14 features flash vs plain: min cosine {cos_clip:.6f}")
    # about 3x the differences read on an H100 (SAM rel err 1.0e-2; 1 - cosine 5e-5 for both)
    check(cos_sam > 0.9998 and rel_sam < 0.03, "SAM encoder through K1 disagrees with the plain version")
    check(cos_clip > 0.9998, "CLIP encoder through K2 disagrees with the plain version")


def main_path(clip, sam, ds, cfg):
    keyframes = list(range(0, len(ds), cfg.pipeline.skip_frames))
    # warm-up on one frame (library handles, allocator), outside the counted run
    Mapper(cfg, clip, sam).process_frame(ds[keyframes[0]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = StageTimer("cuda")
    wrappers = {"flash_attention_2d": fa.flash_attention_2d, "flash_attention": fa.flash_attention}
    for w in wrappers.values():
        w.launches, w.trace = 0, []  # trace: CUDA events around each launch, read after the run
    t0 = time.perf_counter()
    ms = Mapper(cfg, clip, sam, timer=timer).run(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    in_path = {}  # kernel -> {shape key: [launches, device ms summed]}
    for name, w in wrappers.items():
        check(len(w.trace) == w.launches, f"{name}: {len(w.trace)} traced launches, counter {w.launches}")
        runs = in_path[name] = {}
        for key, a, b in w.trace:
            r = runs.setdefault(key, [0, 0.0])
            r[0] += 1
            r[1] += a.elapsed_time(b)
        w.trace = None
    nf = len(keyframes)
    log(f"[main] {nf} keyframes in {wall:.3f} s: {nf / wall:.3f} frames/s (finalize included)")
    for name, v in sorted(timer.ms.items()):  # a sub-stage "a.b" sorts after its stage "a"
        log(f"[main] stage {name:18s} {v:10.3f} ms total  {v / timer.calls[name]:9.3f} ms/call")
    log(f"[main] clip tiers per frame: {timer.notes['tier']}")
    log(f"[main] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[main] launches {launches}")
    for name, runs in in_path.items():
        for key, (n, t) in runs.items():
            log(f"[main] {name} {key}: {n} launches, {t:.4f} ms in the run ({t / n:.4f} ms/launch)")
    check(launches["flash_attention_2d"] == 12 * nf, f"K1 launches {launches['flash_attention_2d']} != 12 x {nf}")
    check(launches["flash_attention"] == 24 * nf, f"K2 launches {launches['flash_attention']} != 24 x {nf}")
    n_pts = int(ms.scene.num)
    n_inst = int(ms.instances.num())
    valid_rows = ms.scene.valid()
    log(f"[main] scene points {n_pts}, valid instances {n_inst}, keyframe feats {tuple(ms.keyframe_feats.shape)}")
    check(n_pts > 0, "empty scene")
    check(n_inst >= 1, "no valid instance")
    check(tuple(ms.keyframe_feats.shape) == (nf, clip.variant.embed_dim), "keyframe feature shape")
    check(bool(torch.isfinite(ms.keyframe_feats).all()), "non-finite keyframe features")
    check(bool(torch.isfinite(ms.instance_feats).all()), "non-finite instance features")
    check(bool(torch.isfinite(ms.scene.feats()[valid_rows]).all()), "non-finite scene features")
    check(bool(torch.isfinite(ms.scene.points()[valid_rows]).all()), "non-finite scene points")
    return launches, in_path, timer, nf


def kernels_line(cases, launches, in_path, nf):
    """One entry per kernel, for the counted main-path run.  `ms` is the
    kernel's device time inside that run (CUDA events around each launch).
    `isolated_ms`, `plain_ms`, `library_ms` and `bound_ms` are the kernel
    phase's per-launch numbers at each launch's shape, summed over the
    run's launches.  `cases` holds the per-launch numbers themselves."""
    by_key = {c["key"]: c for c in cases.values()}
    line = []
    for name, replaces in (("flash_attention_2d", "holoagent_tpu/ops/flash_attention.py:157"),
                           ("flash_attention", "holoagent_tpu/ops/flash_attention.py:217")):
        runs = in_path[name]
        unchecked = [k for k in runs if k not in by_key]
        check(not unchecked, f"{name}: the main path launched shapes {unchecked} that no kernel phase held")

        def summed(field):
            return sum(n * by_key[k][field] for k, (n, _) in runs.items())

        dominant = max(runs, key=lambda k: runs[k][0] * by_key[k]["bound_ms"])
        mine = [{f: v for f, v in c.items() if f not in ("key", "kernel")}
                for c in cases.values() if c["kernel"] == name]
        line.append({
            "name": name, "route": "cuda", "source": "holoagent_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": sum(t for _, t in runs.values()), "plain_ms": summed("plain_ms"),
            "bound_ms": summed("bound_ms"), "bound_by": by_key[dominant]["bound_by"],
            "library_ms": summed("library_ms"), "isolated_ms": summed("ms"),
            "per": f"the counted main-path run: {launches[name]} launches over {nf} keyframes",
            "cases": mine,
        })
    return {"kernels": line}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = fa.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    cases = kernel_phases()

    cfg = from_dict(CONFIG)
    t0 = time.perf_counter()
    clip = clip_mod.init_clip_visual(clip_mod.VARIANTS[cfg.models.clip.type], seed=SEED, dtype=torch.bfloat16)
    sam = sam_mod.init_sam(sam_mod.VARIANTS[cfg.models.sam.type], seed=SEED + 1, dtype=torch.bfloat16)
    ds = SyntheticDataset(SyntheticScene.three_room(SEED), num_frames=FRAMES, hw=(480, 640), seed=SEED)
    for i in range(0, len(ds), cfg.pipeline.skip_frames):
        ds[i]  # render up front: data set-up is not mapping time
    log(f"[setup] towers + {len(ds)} rendered frames in {time.perf_counter() - t0:.2f} s")

    tower_checks(clip, sam, ds[0])
    launches, in_path, timer, nf = main_path(clip, sam, ds, cfg)
    print(json.dumps(kernels_line(cases, launches, in_path, nf)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
