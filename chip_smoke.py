"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the hand-written kernels (nvcc, sm_90a), one nvcc per
     source under holoagent_tpu_torch/csrc, all started together, into
     holoagent_tpu_torch/_build;
  3. kernels: hold each kernel against its plain PyTorch version at the
     mapping path's shapes and show that the check rejects plain versions
     with a deliberate fault; time kernel, plain version and the one PyTorch
     library call computing the same function (a yardstick only), and print
     the kernel's ratio to it.  K1/K2 (attention) are held to a limit set by
     each case's own output scale; K3 (W8A8 linear) to one ulp of its output
     dtype.  K1's cases take q, k, v as views of one (B, N, 3C) projection,
     as SAM's _attention_2d splits it, and K2's packed cases as views of one
     (B, T, 3W) projection, as the towers' _attend splits it; each packed K2
     case shows that the wrapper allocates nothing but its output (no copy
     of q, k, v).  Each case prints its kernel's plan (N or T > T_MAX: the
     TMA + wgmma global kernel; else the resident kernel; blocks per SM,
     waves, and for K2's resident route what limits the blocks per SM).
     K2's text case is the CLIP text tower's launch (256 prompts, 12 heads,
     77 tokens, causal, the resident route); its prefill case a vlm-base
     prefill layer (4 prompts, 16 heads, 1024 tokens, causal, the long
     route);
  4. towers: at full width, hold the SAM and CLIP encoders through the
     kernels against the same encoders through the plain versions, in bf16
     and as W8A8 towers (CLIP in both qmm modes), the CLIP ViT-L/14 text
     tower (features of the SCANNET20 prompts), and SAM vit_h's encoder in
     bf16 and W8A8;
  5. main paths, each with every launch count set to 0 just before it and
     read just after: Mapper.run + finalize over posed 640x480 frames of the
     synthetic three-room scene, SAM vit_b + CLIP ViT-L/14 from a seeded
     generator at the settings of config/synthetic_tpu_3room.yaml, (a) in
     bf16, (b) with W8A8 towers from apps.common.load_models (the
     reference Mapper's int8 path, qmm="xla"); then (c) the W8A8 tiered
     extraction with clip_qmm="pallas" on each keyframe; (d) the graph
     path in bf16: apps.build_map.run (the Mapper, label features,
     HMSGraph.build, room names, save), HMSGraph.load of the saved
     directory (checked equal to the built graph), then
     FSRQueryEngine.query_hierarchy over fixed instructions; (e) the
     accuracy protocol's oracle row (apps.eval_protocol.run: GT masks and
     one-hot features through the Mapper, the graph build and the
     evaluator, two_room and three_room at seed 0, 240x320, no towers),
     its metrics held to the reference's; (f) the FSR slow path:
     apps.query_bench.run --slow --vlm clip over (d)'s graph, keyframes
     resident on the card, the gallery padded to 512 objects with crops
     encoded by the visual tower (K2), every visual and text batch counted
     against K2's launches, the stage latencies printed; (g) the fast
     oracle row of apps.query_bench over (e)'s three_room graph with the
     70 bilingual instructions, top-1 and recall@5 held at 1.0; (h) the
     generative VLM served: first vlm-small's prefill of one admission wave
     (8 text prompts, T = 128) through K2 held against the plain path, then
     apps.serving_bench.run at vlm-small (8 slots, 16 requests of 32
     tokens, chunks of 8, the 5-call slow chain), K2 held to one launch a
     gpt layer a prefill call; (i) the generative slow path:
     apps.query_bench.run --slow --vlm generative over (d)'s graph (vlm-small
     over the ViT-L/14 visual tower, keyframes resident, the gallery padded
     to 512, device-derived rates from (h)), K2 held to 24 launches a visual
     batch, 12 a text batch, 8 a prefill; (j) apps.serving_bench.run at
     llava-tinyllama (TinyLlama-1.1B's geometry: GQA, RoPE, SwiGLU; 8 slots,
     8 requests of 16 tokens), K2 held at 0 (the arch has no kernel);
     (k) the reference's operating point: Mapper.run + finalize as (b) with
     SAM vit_h (head dim 80: K1's second instantiation) and both towers
     W8A8, launches derived from the towers' depths and held; (l) batched
     extraction: the bf16 Mapper untiered at extract_frames_per_dispatch 1,
     2, 2 and 1 in turns (the same scene; each frame's batched
     FrameFeatures held against its per-frame ones), then the W8A8 towers'
     extract_frames_batched over the keyframes in pairs; (m) (e)'s
     three_room oracle frames through a Mapper with the hierarchical fold,
     its state saved and loaded on the card (every tensor equal), and a
     state saved without coarse keys reloaded with them recomputed (equal
     to recompute_coarse_keys; to the live sets off the cell faces);
     (n) the deployment configs through their loaders, from dicts that
     mirror config/{hm3dsem_benchmark,replica_office,horizon_ic4f}.yaml
     (random weights; accept-all gates; flash, tiered extraction): two
     synthetic scenes written in HM3DSem layout (rendered with the loader's
     K, poses stored y-up, a GT scene_info JSON each) through
     apps.batch_map.run_batch with SAM vit_h, each evaluated; a Replica
     scene at 1200x680 (cam_params.json, depth at 6553.5) and a Horizon
     scene (d435i.yaml, w2c TUM poses.txt, float-timestamp images/) through
     apps.build_map.run; every loaded frame held to the written one, the
     first HM3DSem scene's loader run held to an in-memory run of the same
     frames, K1 and K2 launches held to the keyframes' and the label text
     batches' counts; (o) apps.retrieval_bench at its defaults, its rows
     held to the float64 exact top-k; (p) LLMParser over a CachedLLMClient
     on the ContinuousBatcher with vlm-small, K2 held to its prefill calls,
     a second pass answered from the cache; (q) the pose solvers (PnP at
     4096 points, pnp_batch at B = 64, a 64-pose graph loop, icp_multiscale
     of a 20k-point scan), each against its known pose and the port's CPU
     run, timed as CUDA graphs against the eager solves, one PnP solve of
     each under torch.profiler.  A [time] line after each phase says when
     it ended.  Per-stage ms, frames/s or ms/keyframe, peak memory; the kernels' launch
     counts and their device time inside each run.  Every K1, K2 and K3
     shape a path launched that no case of phase 3 held gets its own case
     before the kernels line.
Prints one JSON line of kernels, then the nvidia-smi line, then as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from holoagent_tpu_torch.apps import batch_map, build_map, eval_protocol, query_bench, retrieval_bench, serving_bench  # noqa: E402,E501
from holoagent_tpu_torch.apps.common import load_dataset, load_models, tokenizer  # noqa: E402
from holoagent_tpu_torch.config import from_dict  # noqa: E402
from holoagent_tpu_torch.dataloader import RGBDFrame, SyntheticDataset, SyntheticScene  # noqa: E402
from holoagent_tpu_torch.dataloader.export import hm3dsem_k, write_hm3dsem, write_horizon, write_replica  # noqa: E402
from holoagent_tpu_torch.dataloader.hm3dsem import HM3DSemDataset  # noqa: E402
from holoagent_tpu_torch.dataloader.horizon import HorizonDataset  # noqa: E402
from holoagent_tpu_torch.dataloader.replica import ReplicaDataset  # noqa: E402
from holoagent_tpu_torch.eval import gt_from_synthetic  # noqa: E402
from holoagent_tpu_torch.eval.instruction_sets import three_room_instructions  # noqa: E402
from holoagent_tpu_torch.memory import checkpoint as ckpt_mod  # noqa: E402
from holoagent_tpu_torch.memory import instances as inst_mod  # noqa: E402
from holoagent_tpu_torch.memory import mapping as mapping_mod  # noqa: E402
from holoagent_tpu_torch.memory.hmsg import HMSGraph  # noqa: E402
from holoagent_tpu_torch.memory.mapping import Mapper  # noqa: E402
from holoagent_tpu_torch.models import clip as clip_mod  # noqa: E402
from holoagent_tpu_torch.models import sam as sam_mod  # noqa: E402
from holoagent_tpu_torch.models import transformer as tfm  # noqa: E402
from holoagent_tpu_torch.models import vlm as vlm_mod  # noqa: E402
from holoagent_tpu_torch.ops import flash_attention as fa  # noqa: E402
from holoagent_tpu_torch.ops import solvers  # noqa: E402
from holoagent_tpu_torch.ops.backproject import backproject  # noqa: E402
from holoagent_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from holoagent_tpu_torch.ops import voxel as voxel_mod  # noqa: E402
from holoagent_tpu_torch.ops.compact import I32_MAX  # noqa: E402
from holoagent_tpu_torch.perception.extractor import FrameFeatures, extract_frame_features_tiered  # noqa: E402
from holoagent_tpu_torch.perception.oracle import oracle_frame_features  # noqa: E402
from holoagent_tpu_torch.query import ClipVLM, FSRQueryEngine, LLMParser, ParsedQuery, llm_client  # noqa: E402
from holoagent_tpu_torch.serving import ContinuousBatcher  # noqa: E402
from holoagent_tpu_torch.utils.camera import Pinhole, project  # noqa: E402
from holoagent_tpu_torch.utils.geometry import exp_se3, invert_pose, log_se3, transform_points  # noqa: E402
from holoagent_tpu_torch.utils.labels import DEFAULT_ROOM_TYPES, SCANNET_LABELS_20, load_vocabulary  # noqa: E402
from holoagent_tpu_torch.utils.timing import StageTimer  # noqa: E402

# H100 SXM published peaks (dense tensor cores: bf16, int8; HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version.  Both take bf16 inputs, accumulate in f32 and
# round the output to bf16; they differ by where the probabilities are
# rounded (the kernel rounds them unnormalised, the plain version
# normalised).  bf16 keeps 8 significant bits, so one ulp is at most 2^-7 of
# a value.  Each case is held to its own output scale:
#   max|out - ref| <= 2^-6 * max|ref|        (two ulps of the largest output)
#   rms(out - ref) <= 2^-7 * rms(ref)        (one ulp, relative)
# and the same test must reject the plain version with one key tile dropped
# (and, for K1, with bias_h or bias_w dropped on one 64-query tile of one
# head; for K2, with its key mask shifted by one: the causal diagonal, or
# without causal the ragged key edge), so a kernel that skips a tile, part
# of the bias or a key at the mask's edge cannot pass.
MAX_ERR_OF_MAX = 2.0**-6
REL_RMS_TOL = 2.0**-7
# K3 vs plain version: the kernel does the plain version's arithmetic
# operation for operation (the same f32 row scale, IEEE division, rounding
# half to even, an exact integer sum, and the epilogue's three roundings with
# no FMA contraction), so bit equality is expected.  The limit is one ulp of
# the output dtype: the least that admits one rounding taken the other way
# in the epilogue.  Any fault in the quantization or a dropped K slice moves
# outputs by many ulps, and the same check must reject two such plain
# versions: x's last 32-wide K slice zeroed, and one per-tensor activation
# scale in place of the per-row scales.
K3_MAX_ULPS = 1
TYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}
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


START = time.perf_counter()


def stamp(what: str) -> None:
    """When a phase ended, in seconds since the script started (the run's
    time budget, by phase)."""
    log(f"[time] {what} ended {time.perf_counter() - START:.1f} s after the start")


HOLD_CYCLES = 5_000_000  # about 2.5 ms of the card's clock: longer than the host takes to enqueue a sample


def time_ms(fn, samples: int = 10, reps: int = 10, hold: int = HOLD_CYCLES) -> float:
    """Median over `samples` of the mean device time of `reps` back-to-back
    calls, by CUDA events, after a warm-up.  A device-side sleep holds the
    stream while each sample's calls are enqueued, so the events time the
    device's work alone and not the host's launch overhead (a call whose
    kernel is shorter than its wrapper's host time would otherwise read as
    the host time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def bound(ops: float, nbytes: float, peak_ops: float):
    """The least time in ms: the larger of ops at `peak_ops` and bytes at
    the memory rate."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
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


def k1_case(name, b, heads, g, gen, d=64):
    """One K1 shape: q, k, v as the (B, heads, N, D) views of one (B, N, 3C)
    projection that _attention_2d makes, bias (B*heads, N, g) f32."""
    n = g * g
    bh = b * heads
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen).to("cuda", torch.bfloat16)
    q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    bias_h = (0.5 * torch.randn(bh, n, g, generator=gen)).cuda()
    bias_w = (0.5 * torch.randn(bh, n, g, generator=gen)).cuda()
    out = fa.flash_attention_2d(q, k, v, bias_h, bias_w, (g, g))
    ref = fa.flash_attention_2d_ref(q, k, v, bias_h, bias_w, (g, g))
    no_row0, no_bias_h, no_bias_w = bias_h.clone(), bias_h.clone(), bias_w.clone()
    no_row0[..., 0] = fa.NEG_INF  # the keys of grid row 0: half a 128-key tile at g=64
    no_bias_h[0, :64] = 0.0
    no_bias_w[0, :64] = 0.0
    res = hold(name, out, ref, [
        ("the keys of grid row 0 dropped", fa.flash_attention_2d_ref(q, k, v, no_row0, bias_w, (g, g))),
        ("bias_h dropped on one query tile", fa.flash_attention_2d_ref(q, k, v, no_bias_h, bias_w, (g, g))),
        ("bias_w dropped on one query tile", fa.flash_attention_2d_ref(q, k, v, bias_h, no_bias_w, (g, g))),
    ])
    if fa.k1_route(g, g, d) == "resident":
        res["plan"] = resident_plan_report(fa.resident_plan(bh, n, 2 * g, d=d), bh)
    else:
        p = fa.global_plan(bh, n, d=d)
        res["plan"] = dict(p, kernel="global (TMA + wgmma)", waves=p["grid"] / (p["blocks_per_sm"] * p["sms"]))
    mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, heads, n, n).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res.update(
        kernel="flash_attention_2d", key=(b, heads, g, g, d), name=name,
        shape=f"B={b} H={heads} N={n} h=w={g} D={d} packed qkv bf16",
        ms=time_ms(lambda: fa.flash_attention_2d(q, k, v, bias_h, bias_w, (g, g))),
        plain_ms=time_ms(lambda: fa.flash_attention_2d_ref(q, k, v, bias_h, bias_w, (g, g)), samples=5, reps=2),
        library_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
    )
    flops = 4.0 * n * n * d * bh
    nbytes = 4 * bh * n * d * 2 + bh * n * 2 * g * 4
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes, PEAK_BF16_FLOPS)
    res["ratio_to_library"] = res["ms"] / res["library_ms"]
    del mask
    return res


def k2_case(name, b, h, t, causal, gen, packed=False):
    """One K2 shape.  packed: q, k, v are the (B, H, T, D) views of one
    (B, T, 3*H*D) projection that _attend makes (token stride 3*H*D, head
    stride D), the layout the towers launch, and the call must allocate
    nothing but its output; else contiguous tensors."""
    d = 64
    if packed:
        qkv = torch.randn(b, t, 3 * h * d, generator=gen).to("cuda", torch.bfloat16)
        q, k, v = (z.reshape(b, t, h, d).transpose(1, 2) for z in qkv.split(h * d, dim=-1))
    else:
        q, k, v = (torch.randn(b, h, t, d, generator=gen).to("cuda", torch.bfloat16) for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=causal)
    ref = fa.flash_attention_ref(q, k, v, causal=causal)
    v_bad = v.clone()
    v_bad[:, :, :64] = 0
    mutants = [("the values of the first 64-key tile dropped", fa.flash_attention_ref(q, k, v_bad, causal=causal))]
    if causal:
        mutants.append(("the causal mask shifted by one (each query sees one future key)", causal_ref_shifted(q, k, v)))
    else:
        mutants.append(("the key mask shifted by one (key T - 1 dropped)", fa.flash_attention_ref(q, k[:, :, :-1],
                                                                                                 v[:, :, :-1])))
    res = hold(name, out, ref, mutants)
    if packed:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_stats()["requested_bytes.all.current"]
        again = fa.flash_attention(q, k, v, causal=causal)
        res["alloc_bytes"] = torch.cuda.memory_stats()["requested_bytes.all.peak"] - start
        res["out_bytes"] = again.numel() * again.element_size()
        del again
        check(res["alloc_bytes"] == res["out_bytes"], f"{name}: the call allocated {res['alloc_bytes']} bytes at its "
              f"peak, its output is {res['out_bytes']}: the wrapper copied q, k or v")
    route = fa.k2_route(t, causal)
    if route == "resident":
        res["plan"] = resident_plan_report(fa.resident_plan(b * h, t, causal=causal), b * h)
    else:
        p = fa.global_plan(b * h, t, rel_pos=False)
        res["plan"] = dict(p, kernel="global (TMA + wgmma, no bias)", waves=p["grid"] / (p["blocks_per_sm"] * p["sms"]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res.update(
        kernel="flash_attention", key=(b, h, t, causal), name=name, route=route,
        shape=f"B={b} H={h} T={t} D={d} causal={causal} {'packed qkv' if packed else 'contiguous'} bf16",
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
        plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v, causal=causal), samples=5, reps=2),
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=causal)),
    )
    pairs = t * (t + 1) / 2 if causal else t * t  # key/query pairs this input needs
    res["bound_ms"], res["bound_by"] = bound(4.0 * pairs * d * b * h, 4 * b * h * t * d * 2, PEAK_BF16_FLOPS)
    res["ratio_to_library"] = res["ms"] / res["library_ms"]
    return res


def resident_plan_report(p, bh) -> dict:
    """The resident kernel's plan for `bh` heads with its grid, waves and
    what limits its blocks an SM."""
    grid = p["blocks_per_head"] * bh
    regs, smem = p["blocks_by_regs"], p["blocks_by_smem"]
    limit = "registers and shared memory alike" if regs == smem else "registers" if regs < smem else "shared memory"
    return dict(p, kernel="resident", grid=grid, waves=grid / (p["blocks_per_sm"] * p["sms"]), limit=limit)


def causal_ref_shifted(q, k, v):
    """K2's plain causal version with the mask shifted by one: query i also
    sees key i + 1 (a mutant the causal cases must reject)."""
    t, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    idx = torch.arange(t, device=q.device)
    p = torch.softmax(s.masked_fill(idx[None, :] > idx[:, None] + 1, fa.NEG_INF), dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two tensors of
    one float dtype (bf16 or f32): bit patterns mapped onto a monotone
    integer line, so +0 and -0 coincide and neighbours differ by 1."""
    bits, mag = (torch.int16, 0x7FFF) if a.dtype == torch.bfloat16 else (torch.int32, 0x7FFFFFFF)

    def line(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & mag), i)

    return int((line(a) - line(b)).abs().max())


def k3_case(name, m, k, n, x_dtype, out_dtype, gen):
    """One K3 shape: x like a tower's activations, weights quantized from a
    1/sqrt(K)-scaled normal matrix by the port's quantize_weight_int8,
    biases in the input's dtype as the towers keep them."""
    x = torch.randn(m, k, generator=gen, device="cuda").to(x_dtype)
    w_q, w_s = tfm.quantize_weight_int8(torch.randn(k, n, generator=gen, device="cuda") * k**-0.5)
    w_q = w_q.t().contiguous()
    bias = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(x_dtype)
    out = qm.quant_matmul(x, w_q, w_s, bias, out_dtype=out_dtype)
    ref = qm.quant_matmul_ref(x, w_q, w_s, bias, out_dtype)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    err = ulps(out, ref)
    mismatched = int((out != ref).sum())
    max_abs = (out.float() - ref.float()).abs().max().item()
    check(err <= K3_MAX_ULPS, f"{name}: {err} ulps from the plain version ({mismatched} outputs differ), "
          f"limit {K3_MAX_ULPS}")
    x_cut = x.clone()
    x_cut[:, -32:] = 0
    xf = x.float()
    a_t = torch.clamp(xf.abs().amax() * qm.INV_127, min=qm.SCALE_FLOOR).reshape(1, 1)
    per_tensor = qm.dequantize(torch.clamp(torch.round(xf / a_t), -127.0, 127.0), a_t, w_q, w_s, bias, out_dtype)
    mutants = {}
    for what, bad in (("x's last 32-wide K slice zeroed", qm.quant_matmul_ref(x_cut, w_q, w_s, bias, out_dtype)),
                      ("one per-tensor activation scale", per_tensor)):
        mutants[what] = ulps(bad, ref)
        check(mutants[what] > K3_MAX_ULPS, f"{name}: the check would pass a plain version with {what}")
    x_q8 = qm.quantize_rows(x)[0].to(torch.int8)
    w_t = w_q.t()
    res = dict(
        kernel="quant_matmul", key=(m, k, n, TYPE_NAMES[x_dtype], TYPE_NAMES[out_dtype]), name=name,
        shape=f"M={m} K={k} N={n} {TYPE_NAMES[x_dtype]}->{TYPE_NAMES[out_dtype]}",
        max_abs_err=max_abs, max_ulps=err, outputs_differing=mismatched, mutant_ulps=mutants,
        ms=time_ms(lambda: qm.quant_matmul(x, w_q, w_s, bias, out_dtype=out_dtype)),
        plain_ms=time_ms(lambda: qm.quant_matmul_ref(x, w_q, w_s, bias, out_dtype), samples=5, reps=2),
        library_ms=time_ms(lambda: torch._int_mm(x_q8, w_t)),
    )
    nbytes = m * k * x.element_size() + n * k + 2 * n * 4 + m * n * out.element_size()
    res["bound_ms"], res["bound_by"] = bound(2.0 * m * n * k, nbytes, PEAK_INT8_OPS)
    res["ratio_to_library"] = res["ms"] / res["library_ms"]
    return res


def k3_phase():
    """Every shape the W8A8 paths give K3, both output dtypes, and a ragged
    M.  CLIP ViT-L/14: M = 257 * (2 * tier + 1); qkv, out proj, fc1, fc2;
    fc1 also with f32 output (the qmm="xla" path keeps it f32 into the
    GELU).  SAM vit_b: M = 4096 (global) and 4900 (25 windows); qkv, proj,
    lin1, lin2; lin1 also with f32 output.  SAM vit_h: qkv and proj at M =
    4900 and 4096, lin1 (f32 output) and lin2 at M = 4096."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for tier in (16, 32, 64):
        m = 257 * (2 * tier + 1)
        for k, n in ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)):
            cases.append(k3_case(f"k3_clip_t{tier}_{k}x{n}", m, k, n, bf, bf, gen))
        cases.append(k3_case(f"k3_clip_t{tier}_1024x4096_f32", m, 1024, 4096, bf, f32, gen))
    for m, where in ((4096, "global"), (4900, "windows")):
        for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
            cases.append(k3_case(f"k3_sam_{where}_{k}x{n}", m, k, n, bf, bf, gen))
        cases.append(k3_case(f"k3_sam_{where}_768x3072_f32", m, 768, 3072, bf, f32, gen))
    # SAM vit_h (width 1280): qkv and proj on the windows (M = 4900) and the
    # global layers (M = 4096); the MLP on the whole grid (M = 4096), lin1
    # kept f32 into the GELU
    for m, where in ((4900, "windows"), (4096, "global")):
        for k, n in ((1280, 3840), (1280, 1280)):
            cases.append(k3_case(f"k3_vit_h_{where}_{k}x{n}", m, k, n, bf, bf, gen))
    cases.append(k3_case("k3_vit_h_mlp_1280x5120_f32", 4096, 1280, 5120, bf, f32, gen))
    cases.append(k3_case("k3_vit_h_mlp_5120x1280", 4096, 5120, 1280, bf, bf, gen))
    cases.append(k3_case("k3_ragged_m77", 77, 1024, 1024, bf, bf, gen))
    cases.append(k3_case("k3_ragged_m77_f32in", 77, 1024, 1024, f32, f32, gen))
    for c in cases:
        log_k3_case(c)
    return cases


def log_k3_case(c) -> None:
    log(f"[kernel] {c['name']:28s} {c['shape']:32s} {c['max_ulps']} ulps ({c['outputs_differing']} outputs "
        f"differ, max abs err {c['max_abs_err']:.3e}); mutants rejected at "
        f"{', '.join(f'{v} ulps' for v in c['mutant_ulps'].values())}; "
        f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  _int_mm {c['library_ms']:.4f} ms  "
        f"({c['ratio_to_library']:.2f}x)  bound {c['bound_ms']:.4f} ms ({c['bound_by']})")


def kernel_phases():
    gen = torch.Generator().manual_seed(SEED)
    cases = [
        k1_case("k1_global", 1, 12, 64, gen),  # vit_b global layers: 64x64 grid, 12 heads
        k1_case("k1_window", 25, 12, 14, gen),  # vit_b windows: 25 windows x 12 heads, 14x14
        # vit_h (width 1280, 16 heads): head dim 80, the same grids
        k1_case("k1_vit_h_global", 1, 16, 64, gen, d=80),
        k1_case("k1_vit_h_window", 25, 16, 14, gen, d=80),
    ]
    for tier in (16, 32, 64):  # CLIP ViT-L/14 crop stack: B = 2*tier + 1
        cases.append(k2_case(f"k2_clip_tier{tier}", 2 * tier + 1, 16, 257, False, gen, packed=True))
    cases.append(k2_case("k2_causal_t384", 4, 16, 384, True, gen))  # the long route
    cases.append(k2_case("k2_t200", 4, 16, 200, False, gen))
    # the CLIP ViT-L/14 text tower: a padded batch of 256 prompts, 12 heads, 77 tokens, causal
    cases.append(k2_case("k2_text_causal_t77", 256, 12, 77, True, gen, packed=True))
    # the resident route's causal limit: T = T_MAX, a head's tiles split over blocks
    cases.append(k2_case("k2_causal_t320", 4, 16, 320, True, gen, packed=True))
    # a vlm-base prefill layer (width 1024, 16 heads): the long route, causal
    cases.append(k2_case("k2_prefill_causal_t1024", 4, 16, 1024, True, gen, packed=True))
    cases.append(k2_case("k2_t600", 4, 16, 600, False, gen, packed=True))  # the long route, a ragged key tile
    for c in cases:
        log_attention_case(c)
    cases += k3_phase()
    return {c["name"]: c for c in cases}


def log_attention_case(c) -> None:
    log(f"[kernel] {c['name']:23s} {c['shape']:49s} err {c['max_abs_err']:.3e} (tol {c['tol']:.3e}, "
        f"max|ref| {c['ref_max']:.3e}, rms(ref) {c['ref_rms']:.3e}, rel rms err {c['rel_rms_err']:.3e} "
        f"tol {REL_RMS_TOL:.3e}) "
        f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  library {c['library_ms']:.4f} ms  "
        f"({c['ratio_to_library']:.2f}x)  bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    if "alloc_bytes" in c:
        log(f"[kernel] {c['name']}: one call's peak allocation {c['alloc_bytes']} bytes = its output's "
            f"{c['out_bytes']}: no copy of q, k, v")
    p = c["plan"]
    tiles = f"{p['tiles_per_block']} query tiles a block, " if "tiles_per_block" in p else ""
    limit = (f"; {p['regs']} registers a thread, {p['smem']} bytes of shared memory a block: the registers "
             f"allow {p['blocks_by_regs']} blocks an SM, shared memory {p['blocks_by_smem']}, so "
             f"{p['limit']} set the limit" if "limit" in p else "")
    log(f"[kernel] {c['name']}: {p['kernel']} kernel, {tiles}"
        f"{p['blocks_per_head']} blocks a head, {p['grid']} blocks, {p['blocks_per_sm']} blocks per SM "
        f"on {p['sms']} SMs: {p['waves']:.2f} waves{limit}")


# ---------------------------------------------------------------------------
# towers and main paths
# ---------------------------------------------------------------------------

WRAPPERS = {"flash_attention_2d": fa.flash_attention_2d, "flash_attention": fa.flash_attention,
            "quant_matmul": qm.quant_matmul}


@contextlib.contextmanager
def k3_plain():
    """Send every int8 product through K3's plain version on the card, for
    the reference side of the W8A8 tower checks.  The port's wrapper never
    does that itself: on a CUDA tensor it launches the kernel."""
    kernel = qm.quant_matmul

    def plain(x, w_q, w_s, bias, act="none", out_dtype=torch.bfloat16):
        out = qm.quant_matmul_ref(x, w_q, w_s, bias, out_dtype)
        return F.gelu(out.float(), approximate="tanh").to(out_dtype) if act == "gelu" else out

    qm.quant_matmul = plain  # batched_quant_matmul, and so every caller, looks it up here
    try:
        yield
    finally:
        qm.quant_matmul = kernel


def tower_inputs(sam, frame):
    img = torch.as_tensor(frame.rgb, device="cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    return sam_mod.preprocess(img[None], sam.variant.img_size), torch.randn(9, 224, 224, 3, generator=gen).cuda()


def cosine(a, b) -> float:
    return F.cosine_similarity(a.float().flatten(), b.float().flatten(), dim=0).item()


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def tower_checks(clip, sam, frame):
    """Full-width encoders through the kernels vs through the plain versions."""
    x, crops = tower_inputs(sam, frame)
    e_k = sam_mod.encode_image(sam.encoder, x, sam.variant, impl="flash").float()
    e_p = sam_mod.encode_image(sam.encoder, x, sam.variant, impl="xla").float()
    cos_sam, rel_sam = cosine(e_k, e_p), rel_err(e_k, e_p)
    f_k = clip_mod.encode_image(clip, crops, impl="flash")
    f_p = clip_mod.encode_image(clip, crops, impl="xla")
    cos_clip = (f_k * f_p).sum(-1).min().item()
    log(f"[towers] SAM vit_b embedding flash vs plain: cosine {cos_sam:.6f}, rel err {rel_sam:.3e}; "
        f"CLIP ViT-L/14 features flash vs plain: min cosine {cos_clip:.6f}")
    # about 3x the differences read on an H100 (SAM rel err 1.0e-2; 1 - cosine 5e-5 for both)
    check(cos_sam > 0.9998 and rel_sam < 0.03, "SAM encoder through K1 disagrees with the plain version")
    check(cos_clip > 0.9998, "CLIP encoder through K2 disagrees with the plain version")
    return e_k, f_k


def q8_tower_checks(qclip, qsam, frame, e_bf16, f_bf16):
    """The W8A8 towers through K1/K2/K3 vs the same towers through the three
    plain versions (CLIP in both qmm modes).  K3 is bit-exact with its plain
    version; the towers still differ because the int8 rounding of each next
    layer turns the attention kernels' last-bit differences into whole
    quantization steps.  The cosine to the bf16 towers is for information."""
    x, crops = tower_inputs(qsam, frame)
    n0 = qm.quant_matmul.launches
    e_k = sam_mod.encode_image(qsam.encoder, x, qsam.variant, impl="flash").float()
    check(qm.quant_matmul.launches - n0 == 4 * qsam.variant.depth, "W8A8 SAM encoder: K3 launches")
    with k3_plain():
        e_p = sam_mod.encode_image(qsam.encoder, x, qsam.variant, impl="xla").float()
    cos_sam, rel_sam = cosine(e_k, e_p), rel_err(e_k, e_p)
    log(f"[towers] W8A8 SAM vit_b embedding through kernels vs plain: cosine {cos_sam:.6f}, rel err "
        f"{rel_sam:.3e}; vs the bf16 encoder: cosine {cosine(e_k, e_bf16):.6f}, rel err {rel_err(e_k, e_bf16):.3e}")
    cos_clip = {}
    for qmm in ("xla", "pallas"):
        n0 = qm.quant_matmul.launches
        f_k = clip_mod.encode_image(qclip, crops, impl="flash", qmm=qmm)
        check(qm.quant_matmul.launches - n0 == 4 * qclip.variant.v_layers, f"W8A8 CLIP qmm={qmm}: K3 launches")
        with k3_plain():
            f_p = clip_mod.encode_image(qclip, crops, impl="xla", qmm=qmm)
        cos_clip[qmm] = (f_k * f_p).sum(-1).min().item()
        log(f"[towers] W8A8 CLIP ViT-L/14 qmm={qmm} features through kernels vs plain: min cosine "
            f"{cos_clip[qmm]:.6f}; vs the bf16 tower: min cosine {(f_k * f_bf16).sum(-1).min().item():.6f}")
    check(qm.quant_matmul.launches == n0 + 4 * qclip.variant.v_layers, "k3_plain launched K3")
    # about 3x the differences read on an H100 (SAM: 1 - cosine 2.1e-4, rel err 2.0e-2; CLIP: 1 - cosine
    # 1.7e-4 in either mode)
    check(cos_sam > 0.9994 and rel_sam < 0.06, "W8A8 SAM encoder through the kernels disagrees with the plain versions")
    for qmm, c in cos_clip.items():
        check(c > 0.9995, f"W8A8 CLIP qmm={qmm} through the kernels disagrees with the plain versions")


def vit_h_tower_checks(sam_h, qsam_h, frame):
    """SAM vit_h's encoder at full width (32 layers, width 1280, 16 heads:
    head dim 80), bf16 and W8A8, through the kernels (K1 at D = 80 on both
    routes; K3 at vit_h's widths) against the same encoder through the
    plain versions, held at vit_b's limits."""
    x, _ = tower_inputs(sam_h, frame)
    v = sam_h.variant
    n1 = fa.flash_attention_2d.launches
    e_k = sam_mod.encode_image(sam_h.encoder, x, v, impl="flash").float()
    check(fa.flash_attention_2d.launches - n1 == v.depth, "vit_h encoder: K1 launches")
    e_p = sam_mod.encode_image(sam_h.encoder, x, v, impl="xla").float()
    cos_b, rel_b = cosine(e_k, e_p), rel_err(e_k, e_p)
    n1, n3 = fa.flash_attention_2d.launches, qm.quant_matmul.launches
    q_k = sam_mod.encode_image(qsam_h.encoder, x, v, impl="flash").float()
    check(fa.flash_attention_2d.launches - n1 == v.depth and qm.quant_matmul.launches - n3 == 4 * v.depth,
          "W8A8 vit_h encoder: K1 and K3 launches")
    with k3_plain():
        q_p = sam_mod.encode_image(qsam_h.encoder, x, v, impl="xla").float()
    cos_q, rel_q = cosine(q_k, q_p), rel_err(q_k, q_p)
    log(f"[towers] SAM vit_h embedding (head dim {v.width // v.heads}) flash vs plain: cosine {cos_b:.6f}, rel err "
        f"{rel_b:.3e}; W8A8 through kernels vs plain: cosine {cos_q:.6f}, rel err {rel_q:.3e}; W8A8 vs bf16: cosine "
        f"{cosine(q_k, e_k):.6f}")
    # vit_b's limits (tower_checks, q8_tower_checks)
    check(cos_b > 0.9998 and rel_b < 0.03, "SAM vit_h encoder through K1 disagrees with the plain version")
    check(cos_q > 0.9994 and rel_q < 0.06, "W8A8 SAM vit_h encoder through the kernels disagrees with the plain versions")


# about 3x the difference read on an H100 (1 - cosine 4.9e-5)
TEXT_COS_MIN = 0.99985


def text_tower_check(text):
    """The full-width CLIP text tower through K2's causal mode vs through
    its plain version: the multi-template features of the SCANNET20 prompts
    (42 prompts, one padded batch of 256); and the time of one batch."""
    tok = tokenizer()
    labels = list(SCANNET_LABELS_20)
    n0 = fa.flash_attention.launches
    f_k = clip_mod.text_features_multi_template(text, tok, labels)
    check(fa.flash_attention.launches - n0 == text.variant.t_layers, "text tower: K2 launches")
    f_p = clip_mod.text_features_multi_template(text, tok, labels, impl="xla")
    check(fa.flash_attention.launches - n0 == text.variant.t_layers, "the plain text tower launched K2")
    check(bool(torch.isfinite(f_k).all()), "text tower: non-finite features")
    cos = F.cosine_similarity(f_k, f_p, dim=-1).min().item()
    prompts = [t.format(lb) for lb in labels for t in clip_mod.TEMPLATES]
    tokens = F.pad(torch.from_numpy(tok(prompts)), (0, 0, 0, 256 - len(prompts))).cuda()
    # a batch is about 200 launches: hold the stream 40x longer than for one kernel
    batch_ms = time_ms(lambda: clip_mod.encode_text(text, tokens), samples=5, reps=3, hold=40 * HOLD_CYCLES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clip_mod.encode_text(text, tokens)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    log(f"[towers] CLIP ViT-L/14 text tower (12 layers, width 768) flash vs plain on the SCANNET20 prompts: "
        f"min cosine {cos:.6f}; a batch of 256 prompts through the kernels: {batch_ms:.3f} ms of device time, "
        f"{wall_ms:.3f} ms of wall time (synchronised)")
    check(cos > TEXT_COS_MIN, "CLIP text tower through K2 disagrees with the plain version")


def counted(run):
    """Set every launch count to 0 and start tracing, call `run`, then read
    the counts and each launch's device time (CUDA events)."""
    for w in WRAPPERS.values():
        w.launches, w.trace = 0, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    in_path = {}  # kernel -> {shape key: [launches, device ms summed]}
    for name, w in WRAPPERS.items():
        check(len(w.trace) == w.launches, f"{name}: {len(w.trace)} traced launches, counter {w.launches}")
        runs = in_path[name] = {}
        for key, a, b in w.trace:
            r = runs.setdefault(key, [0, 0.0])
            r[0] += 1
            r[1] += a.elapsed_time(b)
        w.trace = None
    return out, wall, launches, in_path, torch.cuda.max_memory_allocated()


def report(tag, nf, wall, timer, launches, in_path, peak, expect):
    """Print a path's stages and kernel launches; check the counts per
    keyframe against `expect`."""
    for name, v in sorted(timer.ms.items()):  # a sub-stage "a.b" sorts after its stage "a"
        log(f"[{tag}] stage {name:18s} {v:10.3f} ms total  {v / timer.calls[name]:9.3f} ms/call")
    log(f"[{tag}] clip tiers per frame: {timer.notes['tier']}")
    log(f"[{tag}] max_memory_allocated {peak / 2**30:.3f} GiB")
    log(f"[{tag}] launches {launches}")
    for name, runs in in_path.items():
        for key, (n, t) in runs.items():
            log(f"[{tag}] {name} {key}: {n} launches, {t:.4f} ms in the run ({t / n:.4f} ms/launch)")
    for name, per in expect.items():
        check(launches[name] == per * nf, f"{tag}: {name} launches {launches[name]} != {per} x {nf}")


def main_path(clip, sam, ds, cfg, tag, expect):
    """Mapper.run + finalize over the keyframes, counted."""
    keyframes = list(range(0, len(ds), cfg.pipeline.skip_frames))
    # warm-up on one frame (library handles, allocator), outside the counted run
    Mapper(cfg, clip, sam).process_frame(ds[keyframes[0]])
    timer = StageTimer("cuda")
    ms, wall, launches, in_path, peak = counted(lambda: Mapper(cfg, clip, sam, timer=timer).run(ds))
    nf = len(keyframes)
    log(f"[{tag}] {nf} keyframes in {wall:.3f} s: {nf / wall:.3f} frames/s (finalize included)")
    report(tag, nf, wall, timer, launches, in_path, peak, expect)
    n_pts = int(ms.scene.num)
    n_inst = int(ms.instances.num())
    valid_rows = ms.scene.valid()
    log(f"[{tag}] scene points {n_pts}, valid instances {n_inst}, keyframe feats {tuple(ms.keyframe_feats.shape)}")
    check(n_pts > 0, "empty scene")
    check(n_inst >= 1, "no valid instance")
    check(tuple(ms.keyframe_feats.shape) == (nf, clip.variant.embed_dim), "keyframe feature shape")
    check(bool(torch.isfinite(ms.keyframe_feats).all()), "non-finite keyframe features")
    check(bool(torch.isfinite(ms.instance_feats).all()), "non-finite instance features")
    check(bool(torch.isfinite(ms.scene.feats()[valid_rows]).all()), "non-finite scene features")
    check(bool(torch.isfinite(ms.scene.points()[valid_rows]).all()), "non-finite scene points")
    return dict(launches=launches, in_path=in_path, nf=nf, ms=ms)


def extraction_path(qclip, qsam, ds, cfg, tag, expect, mapper_feats):
    """The W8A8 tiered extraction with clip_qmm="pallas" on each keyframe,
    counted; its global features against the W8A8 Mapper's (qmm="xla")."""
    sc, p = cfg.models.sam, cfg.pipeline
    kw = dict(points_per_side=sc.points_per_side, pred_iou_thresh=sc.pred_iou_thresh,
              stability_thresh=sc.stability_score_thresh, min_area=float(sc.min_mask_region_area),
              max_masks=sc.max_masks, masked_weight=p.clip_masked_weight, bbox_margin=float(p.clip_bbox_margin),
              impl=p.extract_impl, clip_impl=p.extract_clip_impl, clip_qmm="pallas")
    frames = [torch.as_tensor(ds[i].rgb, dtype=torch.float32).cuda() for i in range(0, len(ds), p.skip_frames)]
    extract_frame_features_tiered(qclip, qsam, frames[0], **kw)  # warm-up
    timer = StageTimer("cuda")
    ffs, wall, launches, in_path, peak = counted(
        lambda: [extract_frame_features_tiered(qclip, qsam, f, timer=timer, **kw) for f in frames])
    nf = len(frames)
    log(f"[{tag}] {nf} keyframes in {wall:.3f} s: {1e3 * wall / nf:.3f} ms/keyframe")
    report(tag, nf, wall, timer, launches, in_path, peak, expect)
    d = qclip.variant.embed_dim
    for i, ff in enumerate(ffs):
        check(ff.f_masks.shape == (sc.max_masks, d) and ff.f_global.shape == (d,), "extraction feature shapes")
        check(bool(torch.isfinite(ff.f_masks).all() and torch.isfinite(ff.f_global).all()), "non-finite features")
        check(int(ff.valid.sum()) >= 1, f"keyframe {i}: no valid mask")
    cos = [F.cosine_similarity(ff.f_global, mapper_feats[i], dim=0).item() for i, ff in enumerate(ffs)]
    log(f"[{tag}] f_global, clip_qmm=pallas vs the W8A8 Mapper's qmm=xla: min cosine {min(cos):.6f}")
    return dict(launches=launches, in_path=in_path, nf=nf)


QUERIES = (
    "the chair in the kitchen", "find a table on floor 1", "go to the bathroom",
    "bring me the sofa in the living room", "the bed in the bedroom on the first floor", "find the toilet",
    "the desk in the office", "去一楼的厨房找椅子",
)


def same_graph(built, loaded) -> None:
    """The graph loaded from the saved directory against the built one:
    ids, names, counts, point arrays."""
    for what in ("floors", "rooms", "objects", "views"):
        check(len(getattr(built, what)) == len(getattr(loaded, what)), f"loaded graph: {what} count")
    for a, b in zip(sorted(built.floors, key=lambda f: f.floor_id), loaded.floors):
        check((a.floor_id, a.name) == (b.floor_id, b.name), "loaded graph: floor ids")
        check(bool((a.pcd_points == b.pcd_points).all()), "loaded graph: floor points")
    for a, b in zip(sorted(built.rooms, key=lambda r: r.room_id), loaded.rooms):
        check((a.room_id, a.name, a.floor_id) == (b.room_id, b.name, b.floor_id), "loaded graph: room ids, names")
        check(bool((a.pcd_points == b.pcd_points).all()), f"loaded graph: room {a.room_id} points")
        check(a.represent_images == b.represent_images, "loaded graph: representative images")
    for a, b in zip(sorted(built.objects, key=lambda o: o.object_id), loaded.objects):
        check((a.object_id, a.name, a.view_ids, a.best_view_id) == (b.object_id, b.name, b.view_ids, b.best_view_id),
              "loaded graph: object ids, names, views")
        check(bool((a.pcd_points == b.pcd_points).all()), f"loaded graph: object {a.object_id} points")
    for a, b in zip(sorted(built.views, key=lambda v: v.view_id), loaded.views):
        check((a.view_id, a.img_id, a.object_ids) == (b.view_id, b.img_id, b.object_ids), "loaded graph: views")


def graph_path(clip, sam, text, ds, cfg, tag, save_path):
    """apps.build_map.run (the Mapper, label features, HMSGraph.build, room
    names, save) into `save_path`, HMSGraph.load of the saved graph, then
    the fast queries, counted as one run.  K1: 12 launches a keyframe; K2:
    24 a keyframe and 12 a padded text batch (SCANNET20's prompts,
    ROOM_TYPES', and each engine call that encodes new texts)."""
    skip = cfg.pipeline.skip_frames
    nf = len(range(0, len(ds), skip))
    Mapper(cfg, clip, sam).process_frame(ds[0])  # warm-up, outside the counted run
    tok = tokenizer()
    timer = StageTimer("cuda")
    engine_batches = []
    gcfg = from_dict({**CONFIG, "main": {**CONFIG["main"], "save_path": save_path}})

    def run():
        graph_dir, built = build_map.run(gcfg, dataset=ds, models=(clip, sam, clip.variant, sam.variant, text),
                                         timer=timer)
        with timer.stage("load"):
            loaded = HMSGraph.load(graph_dir)
        eng = FSRQueryEngine(loaded, text, tok)
        encode, seen = eng.text_feats, set()

        def text_feats(texts):  # count the padded text batches the engine encodes
            missing = [t for t in texts if t not in seen]
            if missing:
                engine_batches.append(math.ceil(len(missing) * len(clip_mod.TEMPLATES) / 256))
            seen.update(texts)
            return encode(texts)

        eng.text_feats = text_feats
        return graph_dir, built, loaded, [(q, eng.query_hierarchy(q)) for q in QUERIES]

    (graph_dir, built, loaded, answers), wall, launches, in_path, peak = counted(run)
    log(f"[{tag}] build_map.run + load + {len(QUERIES)} queries over {nf} keyframes in {wall:.3f} s")
    report(tag, nf, wall, timer, launches, in_path, peak, {})
    label_batches = sum(math.ceil(len(v) * len(clip_mod.TEMPLATES) / 256) for v in (SCANNET_LABELS_20, DEFAULT_ROOM_TYPES))
    batches = label_batches + sum(engine_batches)
    expect = {"flash_attention_2d": 12 * nf, "flash_attention": 24 * nf + text.variant.t_layers * batches,
              "quant_matmul": 0}
    log(f"[{tag}] text batches of 256 prompts: {label_batches} for the label features, {engine_batches} for the "
        f"engine's calls; expected launches {expect}")
    for name, n in expect.items():
        check(launches[name] == n, f"{tag}: {name} launches {launches[name]} != {n}")
    log(f"[{tag}] graph: {len(built.floors)} floors, {len(built.rooms)} rooms "
        f"{[(r.room_id, r.name) for r in built.rooms]}, {len(built.views)} views, {len(built.objects)} objects "
        f"{sorted(o.name for o in built.objects)}")
    check(len(built.floors) >= 1 and len(built.rooms) >= 1, "graph: no floor or no room")
    check({v.img_id for v in built.views} == {i * skip for i in range(nf)} and len(built.views) >= nf,
          "graph: not one view per assigned keyframe")
    for what, embs in (("object", [o.embedding for o in built.objects]),
                       ("room", [e for r in built.rooms for e in r.embeddings]),
                       ("view", [v.embedding for v in built.views])):
        check(all(bool(torch.isfinite(torch.as_tensor(e)).all()) for e in embs), f"graph: non-finite {what} features")
    same_graph(built, loaded)
    fast = []
    for q, (floor, rooms, objs, res) in answers:
        check("FastMatching" in res and "Total_Time" in res, f"query {q!r}: no timing in res")
        fast.append(1e3 * res["FastMatching"])
        log(f"[{tag}] query {q!r}: floor {floor.floor_id if floor else None}, rooms {[r.room_id for r in rooms]}, "
            f"objects {[(o.object_id, o.name) for o in objs]}, FastMatching {fast[-1]:.3f} ms")
    log(f"[{tag}] FastMatching per query: median {statistics.median(fast):.3f} ms, max {max(fast):.3f} ms")
    return dict(launches=launches, in_path=in_path, nf=nf, graph_dir=graph_dir)


# ---------------------------------------------------------------------------
# (e)-(g): the oracle row, the slow path, the fast oracle row
# ---------------------------------------------------------------------------

# The reference's published oracle row: the JAX package on the CPU, per seed
# (layouts two_room then three_room, seeds 0..seeds-1).
ORACLE_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "eval_protocol.json")
# Held to the record's value for the same layout and seed, exactly: the
# metrics it records at 1.0 or 0.95.
ORACLE_HELD = {
    "room precision": ("rooms", "precision"), "room recall": ("rooms", "recall"),
    "object precision@50": ("objects", "prec_at_50"), "object recall@50": ("objects", "rec_at_50"),
    "object AUC": ("objects", "auc"), "semantic top-1": ("objects", "semantic_top_k", "1"),
    "semantic top-3": ("objects", "semantic_top_k", "3"), "segmentation mIoU": ("segmentation", "mIoU"),
}
# The floor bound error of the JAX package's eval_protocol.run_one at seed 0,
# on the CPU, in both layouts (the port's CPU run equals it to 1e-6,
# tests/test_torch_eval.py).  The record's seed-0 value, 0.1005 m, is 0.0074
# m from it: the record predates the package's present mapping code.
REF_BOUND_ERROR = 0.1079265832901001
BOUND_TOL = 0.005  # metres


def _dig(m, path):
    for k in path:
        m = m[k]
    return m


def oracle_protocol(save_dir, tag):
    """(e) eval_protocol.run at seed 0 over both layouts on the card, no
    towers; each run's metrics held to the record, its graph and GT saved
    under `save_dir`."""
    with open(ORACLE_RECORD) as f:
        record = json.load(f)
    timers = {}
    summary, wall, launches, in_path, peak = counted(
        lambda: eval_protocol.run(seeds=1, neural=False, out_md=None, save_dir=save_dir, timers=timers))
    log(f"[{tag}] eval_protocol.run, seed 0, {', '.join(eval_protocol.LAYOUTS)}: {wall:.3f} s, "
        f"max_memory_allocated {peak / 2**30:.3f} GiB, launches {launches}")
    for li, (layout, m) in enumerate(zip(eval_protocol.LAYOUTS, summary["per_seed"])):
        timer = timers[(layout, 0)]
        n_frames = eval_protocol.LAYOUTS[layout][2]
        log(f"[{tag}] {layout}: {n_frames} frames at 240x320 in {timer.ms['run']:.3f} ms")
        for name, v in sorted(timer.ms.items()):
            log(f"[{tag}] {layout} stage {name:18s} {v:10.3f} ms total  {v / timer.calls[name]:9.3f} ms/call")
        want = record["per_seed"][li * record["seeds"]]
        log(f"[{tag}] {layout}: floors {m['floors']['num_pred']}, rooms {m['rooms']['num_pred']} "
            f"(GT {m['rooms']['num_gt']}), objects {m['objects']['num_pred']} (GT {m['objects']['num_gt']})")
        for name, path in ORACLE_HELD.items():
            got, ref = _dig(m, path), _dig(want, path)
            log(f"[{tag}] {layout} {name}: {got} (record {ref})")
            check(got == ref, f"{tag} {layout}: {name} {got} != the record's {ref}")
        err = m["floors"]["mean_bound_error"]
        log(f"[{tag}] {layout} floor bound error: {err:.6f} m (the JAX package on the CPU {REF_BOUND_ERROR:.6f}, "
            f"the record {want['floors']['mean_bound_error']:.6f})")
        check(abs(err - REF_BOUND_ERROR) <= BOUND_TOL, f"{tag} {layout}: floor bound error {err} m")
    return dict(launches=launches, in_path=in_path)


@contextlib.contextmanager
def counting(calls):
    """Count the calls the callers make to the visual tower, the padded text
    batches and the VLM's prefill (module attributes, looked up at each
    call): `calls` gets "image" (batch sizes), "text" (padded batches of 256
    prompts) and "prefill" ((B, T) shapes)."""
    encode_image, text_features, prefill = (clip_mod.encode_image, clip_mod.text_features_multi_template,
                                            vlm_mod.prefill)

    def counting_encode_image(visual, images, **kw):
        calls["image"].append(int(images.shape[0]))
        return encode_image(visual, images, **kw)

    def counting_text_features(t, tok, labels, templates=clip_mod.TEMPLATES, **kw):
        calls["text"].append(math.ceil(len(labels) * len(templates) / 256))
        return text_features(t, tok, labels, templates, **kw)

    def counting_prefill(vlm, embeddings, *a, **kw):
        calls["prefill"].append(tuple(embeddings.shape[:2]))
        return prefill(vlm, embeddings, *a, **kw)

    clip_mod.encode_image, clip_mod.text_features_multi_template = counting_encode_image, counting_text_features
    vlm_mod.prefill = counting_prefill
    try:
        yield calls
    finally:
        clip_mod.encode_image, clip_mod.text_features_multi_template, vlm_mod.prefill = (
            encode_image, text_features, prefill)


def slow_path(clip, sam, text, ds, cfg, graph_dir, tag):
    """(f) query_bench.run --slow --vlm clip over the graph path's graph:
    keyframes resident on the card, the gallery padded to 512 objects, the
    fixed queries.  Every visual-tower batch (24 K2 launches) and padded
    text batch (12) is counted where the callers ask for it, and K2's
    launches are held to that count."""
    calls = collections.defaultdict(list)
    with counting(calls):
        summary, wall, launches, in_path, peak = counted(lambda: query_bench.run(
            str(graph_dir), list(QUERIES), cfg, use_slow=True, vlm_kind="clip", dataset=ds, pad_gallery=512,
            models=(clip, sam, clip.variant, sam.variant, text), out_path=os.path.join(graph_dir, "slow.json")))
    image_batches, text_batches = calls["image"], calls["text"]
    pad_batches = math.ceil(512 / query_bench.ENCODE_CHUNK)
    log(f"[{tag}] query_bench --slow --vlm clip, {len(QUERIES)} queries + 1 warm-up, gallery "
        f"{summary['gallery_size']} objects: {wall:.3f} s, max_memory_allocated {peak / 2**30:.3f} GiB")
    log(f"[{tag}] visual batches {len(image_batches)} (B: {dict(sorted(collections.Counter(image_batches).items()))}; "
        f"{pad_batches} of them the gallery's crops), padded text batches {sum(text_batches)}")
    for k in query_bench.STAGES:
        log(f"[{tag}] average {k:18s} {1e3 * summary[f'average_{k.lower()}']:10.3f} ms")
    log(f"[{tag}] Total_Time p50 {1e3 * summary['p50_total_time']:.3f} ms, p95 {1e3 * summary['p95_total_time']:.3f} ms")
    for r in summary["results"]:
        log(f"[{tag}] {r['instruction']!r}: objects {r['objects']}, " + ", ".join(
            f"{k} {1e3 * r[k]:.3f}" for k in query_bench.STAGES) + " ms")
    expect = {"flash_attention_2d": 0, "quant_matmul": 0,
              "flash_attention": clip.variant.v_layers * len(image_batches) + text.variant.t_layers * sum(text_batches)}
    log(f"[{tag}] launches {launches}, expected {expect}")
    for name, n in expect.items():
        check(launches[name] == n, f"{tag}: {name} launches {launches[name]} != {n}")
    for key, (n, t) in in_path["flash_attention"].items():
        log(f"[{tag}] flash_attention {key}: {n} launches, {t:.4f} ms in the run ({t / n:.4f} ms/launch)")
    check(summary["gallery_size"] >= 512, f"{tag}: gallery of {summary['gallery_size']} objects")
    check(len(image_batches) > pad_batches, f"{tag}: the slow path encoded no image")
    check(all(r["Total_Time"] > 0 and r["objects"] for r in summary["results"]), f"{tag}: a query came back empty")
    # ClipVLM's features at one gallery batch (every keyframe) against the plain tower
    imgs = [torch.as_tensor(ds[i].rgb, device="cuda") for i in range(0, len(ds), cfg.pipeline.skip_frames)]
    f_k = torch.from_numpy(ClipVLM(clip, text, tokenizer())._img_feats(imgs))
    f_p = clip_mod.encode_image(clip, clip_mod.preprocess(torch.stack(imgs), clip.variant.image_size), impl="xla")
    cos = (f_k * f_p.cpu()).sum(-1).min().item()
    log(f"[{tag}] ClipVLM features of {len(imgs)} keyframes through K2 vs the plain tower: min cosine {cos:.6f}")
    check(cos > 0.9998, f"{tag}: ClipVLM's features disagree with the plain tower")
    return dict(launches=launches, in_path=in_path)


def oracle_query_path(clip, sam, text, cfg, run_dir, tag):
    """(g) query_bench.run --oracle over (e)'s three_room graph with the 70
    bilingual instructions: top-1 and recall@5 held at 1.0."""
    graph_dir, gt_path = os.path.join(run_dir, "graph"), os.path.join(run_dir, "gt", "scene_info.json")
    g = HMSGraph.load(graph_dir)
    instructions = three_room_instructions()
    summary, wall, launches, in_path, peak = counted(lambda: query_bench.run(
        graph_dir, instructions, cfg, oracle=True, gt_path=gt_path,
        models=(clip, sam, clip.variant, sam.variant, text), out_path=os.path.join(run_dir, "oracle_query.json")))
    log(f"[{tag}] graph: {len(g.floors)} floors, {len(g.rooms)} rooms, {len(g.objects)} objects, {len(g.views)} "
        f"views; {len(instructions)} instructions, {summary['correctness']['n_scored']} scored: top-1 "
        f"{summary['top1_acc']}, recall@5 {summary['recall_at_5']}; {wall:.3f} s, FastMatching average "
        f"{1e3 * summary['average_fastmatching']:.3f} ms, launches {launches}")
    check(summary["correctness"]["n_scored"] == len(instructions), f"{tag}: not every instruction was scored")
    check(summary["top1_acc"] == 1.0 and summary["recall_at_5"] == 1.0, f"{tag}: {summary['correctness']}")
    return dict(launches=launches, in_path=in_path)


# ---------------------------------------------------------------------------
# (h)-(j): the generative VLM served, and the generative slow path
# ---------------------------------------------------------------------------

# vlm-small's prefill through K2 vs through its plain version, bf16: the
# first-token logits per row within the towers' cosine limit, and the K/V
# cache within two bf16 ulps, relative
PREFILL_COS_MIN = 0.9998
PREFILL_KV_REL = 2.0**-6


def prefill_check(tag):
    """vlm-small's prefill of one admission wave through K2 vs the plain
    path at full width, bf16, with serving_bench's seeded weights: 8 prompts
    of 65-128 random token ids at T = 128."""
    vv = vlm_mod.VARIANTS["vlm-small"]
    vlm = vlm_mod.init_vlm(vv, seed=0, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    ns = torch.randint(65, 129, (8,), generator=gen)
    ns[0] = 128
    ids = torch.randint(0, vv.vocab, (8, 128), generator=gen)
    emb = vlm_mod.text_prompt_embeddings(vlm, ids.cuda(), ns.cuda())
    out = {}
    for impl in ("flash", "xla"):
        n0 = fa.flash_attention.launches
        cache = vlm_mod.init_cache(vv, 8, torch.bfloat16, "cuda")
        logits, cache = vlm_mod.prefill(vlm, emb, ns, cache, impl=impl)
        torch.cuda.synchronize()
        out[impl] = (logits, cache, fa.flash_attention.launches - n0)
    (lk, ck, nk), (lp, cp, npl) = out["flash"], out["xla"]
    check(nk == vv.layers and npl == 0, f"{tag}: K2 launches {nk} through the kernel, {npl} through the plain path")
    check(bool(torch.isfinite(lk).all()) and lk.shape == (8, vv.vocab), f"{tag}: prefill logits")
    cos = F.cosine_similarity(lk, lp, dim=-1).min().item()
    rel_k, rel_v = rel_err(ck.k[:, :, :128], cp.k[:, :, :128]), rel_err(ck.v[:, :, :128], cp.v[:, :, :128])
    same = (lk.argmax(-1) == lp.argmax(-1)).sum().item()
    log(f"[{tag}] vlm-small prefill, 8 prompts at T=128, K2 vs plain: first-token logits min cosine {cos:.6f}, "
        f"K cache rel err {rel_k:.3e}, V {rel_v:.3e}; the same first token in {same} of 8 rows")
    check(cos > PREFILL_COS_MIN, f"{tag}: prefill logits through K2 disagree with the plain path")
    check(rel_k < PREFILL_KV_REL and rel_v < PREFILL_KV_REL, f"{tag}: the KV cache through K2 disagrees")
    del vlm, out


def serving_path(tag, variant, out_path, **kw):
    """(h) / (j): apps.serving_bench.run, counted; K2 held to one launch a
    gpt layer a prefill call (0 for the llama arch)."""
    calls = collections.defaultdict(list)
    with counting(calls):
        res, wall, launches, in_path, peak = counted(lambda: serving_bench.run(variant=variant, out_path=out_path,
                                                                              **kw))
    vv = vlm_mod.VARIANTS[variant]
    log(f"[{tag}] serving_bench.run({variant}, {kw}): {wall:.3f} s, max_memory_allocated {peak / 2**30:.3f} GiB")
    for k, v in res.items():
        log(f"[{tag}] {k}: {v}")
    shapes = dict(sorted(collections.Counter(calls["prefill"]).items()))
    per_call = vv.layers if vv.arch == "gpt" else 0
    expect = {"flash_attention_2d": 0, "quant_matmul": 0, "flash_attention": per_call * len(calls["prefill"])}
    log(f"[{tag}] prefill calls {len(calls['prefill'])} (B, T: {shapes}); launches {launches}, expected {expect}")
    for name, n in expect.items():
        check(launches[name] == n, f"{tag}: {name} launches {launches[name]} != {n}")
    for key, (n, t) in in_path["flash_attention"].items():
        log(f"[{tag}] flash_attention {key}: {n} launches, {t:.4f} ms in the run ({t / n:.4f} ms/launch)")
    for k in ("decode_step_ms", "scan_decode_chunk_ms", "prefill_128_ms", "wall_tok_s"):
        check(math.isfinite(res[k]) and res[k] > 0, f"{tag}: {k} = {res[k]}")
    check(res["batcher_steps"] > 0 and res["device"] == torch.cuda.get_device_name(0), f"{tag}: batcher steps, device")
    return dict(launches=launches, in_path=in_path, result=res, peak=peak)


def generative_path(clip, sam, text, ds, cfg, graph_dir, rates, tag):
    """(i) query_bench.run --slow --vlm generative over the graph path's
    graph: vlm-small over the ViT-L/14 visual tower, keyframes resident, the
    gallery padded to 512 objects, device-derived rates from (h).  K2 held
    to 24 launches a visual batch, 12 a padded text batch and 8 a prefill."""
    calls = collections.defaultdict(list)
    with counting(calls):
        summary, wall, launches, in_path, peak = counted(lambda: query_bench.run(
            str(graph_dir), list(QUERIES), cfg, use_slow=True, vlm_kind="generative", dataset=ds, pad_gallery=512,
            models=(clip, sam, clip.variant, sam.variant, text), rates_path=rates,
            out_path=os.path.join(graph_dir, "slow_generative.json")))
    vv = vlm_mod.VARIANTS["vlm-small"]
    log(f"[{tag}] query_bench --slow --vlm generative, {len(QUERIES)} queries + 1 warm-up, gallery "
        f"{summary['gallery_size']} objects: {wall:.3f} s (vlm-small's init included), max_memory_allocated "
        f"{peak / 2**30:.3f} GiB")
    log(f"[{tag}] visual batches {len(calls['image'])} (B: {dict(sorted(collections.Counter(calls['image']).items()))}"
        f"), padded text batches {sum(calls['text'])}, prefill calls {len(calls['prefill'])} "
        f"(B, T: {dict(sorted(collections.Counter(calls['prefill']).items()))})")
    for k in query_bench.STAGES:
        log(f"[{tag}] average {k:18s} {1e3 * summary[f'average_{k.lower()}']:10.3f} ms")
    log(f"[{tag}] Total_Time p50 {1e3 * summary['p50_total_time']:.3f} ms, p95 {1e3 * summary['p95_total_time']:.3f} ms; "
        f"device-derived p50 {1e3 * summary['p50_device_derived']:.3f} ms, p95 "
        f"{1e3 * summary['p95_device_derived']:.3f} ms ({summary['device_derivation']})")
    work = {k: sum(r["vlm_work"][k] for r in summary["results"]) for k in summary["results"][0]["vlm_work"]}
    log(f"[{tag}] vlm_work totals over the queries: {work}")
    for r in summary["results"]:
        log(f"[{tag}] {r['instruction']!r}: objects {r['objects']}, vlm_work {r['vlm_work']}, " + ", ".join(
            f"{k} {1e3 * r[k]:.3f}" for k in query_bench.STAGES) + " ms")
    expect = {"flash_attention_2d": 0, "quant_matmul": 0,
              "flash_attention": clip.variant.v_layers * len(calls["image"])
              + text.variant.t_layers * sum(calls["text"]) + vv.layers * len(calls["prefill"])}
    log(f"[{tag}] launches {launches}, expected {expect}")
    for name, n in expect.items():
        check(launches[name] == n, f"{tag}: {name} launches {launches[name]} != {n}")
    for key, (n, t) in in_path["flash_attention"].items():
        log(f"[{tag}] flash_attention {key}: {n} launches, {t:.4f} ms in the run ({t / n:.4f} ms/launch)")
    check(summary["gallery_size"] >= 512, f"{tag}: gallery of {summary['gallery_size']} objects")
    check(work["waves"] > 0 and len(calls["prefill"]) > 0, f"{tag}: the slow path asked the VLM nothing")
    check(all(r["Total_Time"] > 0 and r["objects"] for r in summary["results"]), f"{tag}: a query came back empty")
    return dict(launches=launches, in_path=in_path)


# ---------------------------------------------------------------------------
# (k)-(m): vit_h at the reference's operating point, batched extraction, the
# hierarchical fold and mapper-state checkpoints
# ---------------------------------------------------------------------------


def launches_a_keyframe(clip, sam) -> dict:
    """K1, K2 and K3 launches one keyframe's extraction makes: one K1 a SAM
    layer (all windows of a windowed layer in one launch), one K2 a CLIP
    layer, and with int8 towers one K3 for each of a layer's four linears."""
    depth, layers = sam.variant.depth, clip.variant.v_layers
    return {"flash_attention_2d": depth, "flash_attention": layers,
            "quant_matmul": 4 * (depth if sam.quant else 0) + 4 * (layers if clip.quant else 0)}


def operating_point_path(qclip, qsam_h, ds, cfg, tag):
    """(k) The reference's own operating point, SAM vit_h W8A8 (bench.py's
    "extract full64 vit_h" and vit_h_fps): Mapper.run + finalize at
    config/synthetic_tpu_3room.yaml's settings with sam.type vit_h and both
    towers int8."""
    expect = launches_a_keyframe(qclip, qsam_h)
    log(f"[{tag}] SAM {qsam_h.variant.name} ({qsam_h.variant.depth} layers, {len(qsam_h.variant.global_idx)} global, "
        f"width {qsam_h.variant.width}, head dim {qsam_h.variant.width // qsam_h.variant.heads}), CLIP "
        f"{qclip.variant.name}, both W8A8: expected launches a keyframe {expect}")
    return main_path(qclip, qsam_h, ds, cfg, tag, expect)


@contextlib.contextmanager
def recording(out):
    """Record every FrameFeatures the Mapper's extraction returns, frame by
    frame, into `out` (the mapping module's names, looked up at each call)."""
    single, batched = mapping_mod.extract_frame_features, mapping_mod.extract_frames_batched

    def rec_single(*a, **kw):
        out.append(single(*a, **kw))
        return out[-1]

    def rec_batched(*a, **kw):
        ffb = batched(*a, **kw)
        out.extend(FrameFeatures(*(x[j] for x in ffb)) for j in range(ffb.valid.shape[0]))
        return ffb

    mapping_mod.extract_frame_features, mapping_mod.extract_frames_batched = rec_single, rec_batched
    try:
        yield out
    finally:
        mapping_mod.extract_frame_features, mapping_mod.extract_frames_batched = single, batched


ALLOC_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def batched_path(clip, sam, ds, cfg_dict, tag):
    """(l) Batched extraction: Mapper.run + finalize in bf16 with
    extract_tiering off, at extract_frames_per_dispatch 1, 2, 2 and 1 (turns,
    so the host's drift does not read as the batch size's effect), each
    counted, with the caching allocator's device allocations and frees in
    the run.  The scene is the same; each frame's batched FrameFeatures are
    held against its per-frame ones: masks and validity equal (the encoders'
    rows do not depend on the batch: read equal on the H100), features at
    the towers' cosine gate."""
    out, ffs, mss = {}, {}, {}
    for turn, bsz in enumerate((1, 2, 2, 1)):
        d = copy.deepcopy(cfg_dict)
        d["pipeline"].update(extract_tiering=False, extract_frames_per_dispatch=bsz)
        lcfg = from_dict(d)
        keyframes = list(range(0, len(ds), lcfg.pipeline.skip_frames))
        kw = Mapper(lcfg, clip, sam)._extract_kw()
        first = [torch.as_tensor(ds[i].rgb, dtype=torch.float32).cuda() for i in keyframes[:bsz]]
        if bsz == 1:  # warm-up at this batch size, outside the counted run
            mapping_mod.extract_frame_features(clip, sam, first[0], **kw)
        else:
            mapping_mod.extract_frames_batched(clip, sam, torch.stack(first), **kw)
        timer = StageTimer("cuda")
        recorded = []
        a0 = torch.cuda.memory_stats()
        with recording(recorded):
            ms, wall, launches, in_path, peak = counted(lambda: Mapper(lcfg, clip, sam, timer=timer).run(ds))
        alloc = {k: torch.cuda.memory_stats().get(k, 0) - a0.get(k, 0) for k in ALLOC_STATS}
        nf = len(keyframes)
        calls = math.ceil(nf / bsz)
        run = f"{tag}-{bsz}, turn {turn + 1}"
        extract_ms = timer.ms["mask"] + timer.ms["clip"]
        log(f"[{run}] {nf} keyframes in {wall:.3f} s: {nf / wall:.3f} frames/s (finalize included); extraction "
            f"{extract_ms / nf:.3f} ms/keyframe in {calls} calls; allocator in the run {alloc}")
        report(run, nf, wall, timer, launches, in_path, peak, {})
        per_call = launches_a_keyframe(clip, sam)
        for k, n in per_call.items():
            check(launches[k] == n * calls, f"{run}: {k} launches {launches[k]} != {n} x {calls} calls")
        check(len(recorded) == nf, f"{run}: {len(recorded)} extracted frames")
        mss.setdefault(bsz, ms)
        ffs.setdefault(bsz, recorded)
        out[f"(l) batched extraction, bf16 untiered, extract_frames_per_dispatch {bsz}, turn {turn + 1}"] = dict(
            launches=launches, in_path=in_path, nf=nf)
    check(int(mss[1].scene.num) == int(mss[2].scene.num), f"{tag}: scene rows {int(mss[1].scene.num)} at bsz 1, "
          f"{int(mss[2].scene.num)} at bsz 2")
    for j, (a, b) in enumerate(zip(ffs[1], ffs[2])):
        flipped = int((a.masks != b.masks).sum())
        both = a.valid & b.valid
        cos_m = F.cosine_similarity(a.f_masks[both], b.f_masks[both], dim=-1).min().item()
        cos_g = F.cosine_similarity(a.f_global, b.f_global, dim=0).item()
        diff = (a.f_masks - b.f_masks).abs().max().item()
        log(f"[{tag}] keyframe {j}: batched vs per-frame: valid masks {int(a.valid.sum())} / {int(b.valid.sum())}, "
            f"{flipped} of {a.masks.numel()} mask pixels differ, f_masks min cosine {cos_m:.6f} (max abs diff "
            f"{diff:.3e}), f_global cosine {cos_g:.6f}")
        check(torch.equal(a.valid, b.valid) and flipped == 0, f"{tag}: keyframe {j}: masks or validity differ")
        check(cos_m > 0.9998 and cos_g > 0.9998, f"{tag}: keyframe {j}: batched features disagree")
    log(f"[{tag}] scene rows {int(mss[1].scene.num)} at both batch sizes; valid instances "
        f"{int(mss[1].instances.num())} / {int(mss[2].instances.num())}")
    return out


def batched_w8a8_extraction(qclip, qsam, ds, cfg, mapper_feats, tag):
    """(l) W8A8 batched extraction: extract_frames_batched over the
    keyframes in pairs with the int8 towers (K3 at twice the rows of every
    tower linear), counted; f_global held against the W8A8 Mapper's."""
    kw = Mapper(cfg, qclip, qsam)._extract_kw()
    frames = [torch.as_tensor(ds[i].rgb, dtype=torch.float32).cuda() for i in range(0, len(ds), cfg.pipeline.skip_frames)]
    pairs = [torch.stack(frames[i : i + 2]) for i in range(0, len(frames), 2)]
    mapping_mod.extract_frames_batched(qclip, qsam, pairs[0], **kw)  # warm-up
    ffs, wall, launches, in_path, peak = counted(
        lambda: [mapping_mod.extract_frames_batched(qclip, qsam, p, **kw) for p in pairs])
    nf = len(frames)
    log(f"[{tag}] {nf} keyframes in {len(pairs)} pairs in {wall:.3f} s: {1e3 * wall / nf:.3f} ms/keyframe, "
        f"max_memory_allocated {peak / 2**30:.3f} GiB, launches {launches}")
    for name, runs in in_path.items():
        for key, (n, t) in runs.items():
            log(f"[{tag}] {name} {key}: {n} launches, {t:.4f} ms in the run ({t / n:.4f} ms/launch)")
    for k, n in launches_a_keyframe(qclip, qsam).items():
        check(launches[k] == n * len(pairs), f"{tag}: {k} launches {launches[k]} != {n} x {len(pairs)} calls")
    f_g = torch.cat([ff.f_global for ff in ffs])
    check(bool(torch.isfinite(f_g).all()) and f_g.shape == mapper_feats.shape, f"{tag}: f_global")
    cos = F.cosine_similarity(f_g, mapper_feats.float(), dim=-1).min().item()
    log(f"[{tag}] f_global, batched W8A8 vs the W8A8 Mapper's: min cosine {cos:.6f}")
    check(cos > 0.9994, f"{tag}: batched W8A8 f_global disagrees with the Mapper's")
    return dict(launches=launches, in_path=in_path, nf=nf)


# (e)'s configuration (eval_protocol.run_one's), with the hierarchical fold
HIER_CONFIG = {
    "main": {"dataset": "synthetic"},
    "pipeline": {"voxel_size": 0.08, "grid_resolution": 0.08, "point_capacity": 1 << 16, "mask_point_capacity": 4096,
                 "instance_capacity": 64, "skip_frames": 1, "merge_type": "hierarchical"},
}


def hierarchical_path(state_dir, tag):
    """(m) (e)'s three_room oracle frames (GT masks, one-hot features, no
    towers) through a Mapper with merge_type "hierarchical", counted; then
    its state saved, loaded on the card and held equal tensor for tensor;
    then the same state saved without the coarse keys and signatures,
    reloaded with them recomputed from the scene (held equal to
    recompute_coarse_keys on the live state, and to the live sets wherever
    a row's mean lies inside its own cell).

    The live sets hold each pixel's cell; the recomputed ones each row's
    mean's cell.  Where a surface lies on a cell face (a wall on a grid
    plane), the mean of points that floor() put in one cell can round into
    its neighbour, and that instance's recomputed set differs from its live
    one by those rows; the reference recomputes the same way."""
    make_scene, _, n_frames = eval_protocol.LAYOUTS["three_room"]
    scene = make_scene(SyntheticScene)
    ds = SyntheticDataset(scene=scene, num_frames=n_frames, hw=(240, 320), seed=0, gaze_heights=(0.8, 2.2))
    labels = scene.labels()
    cv = clip_mod.VARIANTS["test-tiny"]
    t0 = time.perf_counter()
    frames = [(ds[i], ds.gt(i)) for i in range(len(ds))]
    log(f"[{tag}] {len(frames)} three_room frames at 240x320 rendered in {time.perf_counter() - t0:.3f} s (set-up)")
    cfg = from_dict(HIER_CONFIG)
    timer = StageTimer("cuda")

    def run():
        m = Mapper(cfg, timer=timer, clip_variant=cv)
        for frame, (inst, lab) in frames:
            with timer.stage("oracle"):
                ff = oracle_frame_features(inst, lab, labels, cv.embed_dim, max_masks=16)
            m.process_frame(frame, ff=ff)
            heights.append(len(m._hier_slots))
        return m.finalize()

    heights = []
    ms, wall, launches, in_path, peak = counted(run)
    log(f"[{tag}] hierarchical fold over {len(frames)} frames + finalize: {wall:.3f} s, max_memory_allocated "
        f"{peak / 2**30:.3f} GiB, launches {launches}; partial sets resident at most {max(heights)}")
    report(tag, len(frames), wall, timer, launches, in_path, peak, {name: 0 for name in WRAPPERS})
    n_inst = int(ms.instances.num())
    log(f"[{tag}] scene rows {int(ms.scene.num)}, valid instances {n_inst}")
    check(n_inst >= 1 and bool(torch.isfinite(ms.instance_feats).all()), f"{tag}: {n_inst} valid instances")
    path = os.path.join(state_dir, "mapper_state.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt_mod.save_mapper_state(path, ms.scene, ms.instances)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene_l, inst_l = ckpt_mod.load_mapper_state(path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(scene_l.grid == ms.scene.grid, f"{tag}: reloaded grid")
    for live, back in ((ms.scene, scene_l), (ms.instances, inst_l)):
        for name, x in back._asdict().items():
            if name != "grid":
                y = getattr(live, name)
                check(x.is_cuda and x.dtype == y.dtype and torch.equal(x, y), f"{tag}: reloaded {name} differs")
    stale = torch.load(path, weights_only=True)
    for name in ("ckeys", "ccount", "dsig"):
        del stale["instances"][name]
    stale_path = os.path.join(state_dir, "mapper_state_no_coarse_keys.pt")
    torch.save(stale, stale_path)
    t0 = time.perf_counter()
    _, inst_b = ckpt_mod.load_mapper_state(stale_path)
    torch.cuda.synchronize()
    t_backfill = time.perf_counter() - t0
    live = ms.instances
    recomputed = inst_mod.recompute_coarse_keys(ms.scene, live)
    for name in ("ckeys", "ccount", "dsig"):
        check(torch.equal(getattr(inst_b, name), getattr(recomputed, name)), f"{tag}: backfilled {name} differs")
    # rows whose mean lies outside the cell of their key: each must sit on a cell face
    rows = live.rows[live.valid]
    rows = rows[rows != I32_MAX].long()
    means = ms.scene.points()[rows]
    own = ms.scene.key[rows]
    moved = voxel_mod.keys_of(means, torch.ones_like(own, dtype=torch.bool), ms.scene.grid) != own
    off = (means[moved] - voxel_mod.cell_center(own[moved], ms.scene.grid)).abs().amax(dim=-1)
    half = 0.5 * ms.scene.grid.voxel_size
    check(bool((off >= half - 1e-4).all()), f"{tag}: a row's mean left its cell by more than a face's rounding")
    differ = (recomputed.ckeys != live.ckeys).any(dim=1) & live.valid
    on_face = torch.zeros_like(live.valid)
    if bool(moved.any()):
        bad_rows = rows[moved]
        on_face = torch.isin(live.rows, bad_rows.to(live.rows.dtype)).any(dim=1) & live.valid
    check(bool((differ <= on_face).all()), f"{tag}: a recomputed key set differs from the live one off the cell faces")
    log(f"[{tag}] mapper state {os.path.getsize(path) / 2**20:.1f} MiB: save {1e3 * t_save:.1f} ms, load onto the "
        f"card {1e3 * t_load:.1f} ms, every tensor equal; a state without ckeys/dsig reloads with them recomputed in "
        f"{1e3 * t_backfill:.1f} ms, equal to recompute_coarse_keys; {int(live.valid.sum()) - int(differ.sum())} of "
        f"{int(live.valid.sum())} instances' key sets equal the live ones, {int(differ.sum())} differ by rows whose "
        f"mean lies on a cell face ({int(moved.sum())} of {len(rows)} rows)")
    return dict(launches=launches, in_path=in_path, nf=len(frames))


# ---------------------------------------------------------------------------
# (n)-(q): the deployment configs through their loaders, retrieval_bench,
# LLMParser served by the batcher, the pose solvers
# ---------------------------------------------------------------------------

_DEPLOY_SAM = {"checkpoint": "", "points_per_side": 12, "pred_iou_thresh": 0.88, "stability_score_thresh": 0.95,
               "min_mask_region_area": 100, "max_masks": 64}
_DEPLOY_PIPELINE = {
    "voxel_size": 0.05, "init_overlap_thresh": 0.75, "overlap_thresh_factor": 0.025, "iou_thresh": 0.05,
    "clip_masked_weight": 0.4418, "clip_bbox_margin": 50, "feature_dbscan_eps": 0.01, "min_pcd_points": 100,
    "grid_resolution": 0.05, "merge_type": "paired", "point_capacity": 1048576, "mask_point_capacity": 4096,
    "instance_capacity": 512,
}


def _deployment(main, sam_type, skip_frames, obj_labels):
    return {"main": main,
            "models": {"clip": {"type": "ViT-L-14", "checkpoint": "", "dtype": "bfloat16"},
                       "sam": {"type": sam_type, **_DEPLOY_SAM}},
            "pipeline": {**_DEPLOY_PIPELINE, "skip_frames": skip_frames, "obj_labels": obj_labels},
            "mesh": {"data": -1, "model": 1}}


# config/{hm3dsem_benchmark,replica_office,horizon_ic4f}.yaml, field for field
# (no YAML on the card), checkpoints left empty: random weights from main.seed
HM3DSEM_YAML = _deployment({"dataset": "hm3dsem", "scene_id": "hm3d_val", "dataset_path": "/data/hm3dsem/walks",
                            "depth_cut": 10.0, "save_path": "/data/scene_graphs/hm3d"}, "vit_h", 10, "HM3D")
REPLICA_YAML = _deployment({"dataset": "replica", "scene_id": "office0", "dataset_path": "/data/replica",
                            "depth_cut": 8.0, "save_path": "/data/scene_graphs/replica"}, "vit_b", 4, "SCANNET20")
HORIZON_YAML = _deployment({"dataset": "horizon", "scene_id": "icra_ic4f", "dataset_path": "/data/rgbd_datasets",
                            "depth_cut": 10.0, "save_path": "/data/scene_graphs"}, "vit_h", 8, "SCANNET200")
# What every deployment run sets beyond its yaml, as config/synthetic_tpu_3room.yaml
# does for random weights: accept-all mask and instance gates (a random-init
# SAM's scores pass none of the yamls' 0.88 / 0.95, and its frame-scale blobs
# none of the 0.5 area / 4 m extent gates), and the production extraction,
# which the yamls leave at their defaults (plain attention, untiered)
RANDOM_WEIGHTS = {"sam": {"pred_iou_thresh": -10.0, "stability_score_thresh": 0.0},
                  "pipeline": {"instance_max_area_frac": 1.0, "instance_max_extent_m": 1.0e9,
                               "extract_impl": "flash", "extract_clip_impl": "flash", "extract_tiering": True}}
# (layout, frames in the walk, skip_frames) of the HM3DSem scenes list; the
# benchmark's own walks hold hundreds of frames at skip_frames 10-30.  The
# walks give 12 and 8 keyframes, Replica's and Horizon's 12 each at their
# yamls' skip_frames (4 and 8; the orbit drops a few poses of 96), so the
# one-time finalize at the yamls' capacities (1M points, 512 instances)
# does not make most of a scene's map time
HM3D_SCENES = (("three_room", 24, 2), ("two_room", 16, 2))
REPLICA_FRAMES, HORIZON_FRAMES = 45, 96
HM3D_HW, REPLICA_HW, HORIZON_HW = (480, 640), (680, 1200), (480, 640)
QUAT_POSE_ATOL = 2e-6  # a pose through a float64 quaternion and back to float32


def deployment_config(yaml, root):
    """`yaml`'s dict with its data and graphs under `root`, and RANDOM_WEIGHTS."""
    d = copy.deepcopy(yaml)
    d["main"].update(dataset_path=os.path.join(root, "data"), save_path=os.path.join(root, "graphs"))
    d["models"]["sam"].update(RANDOM_WEIGHTS["sam"])
    d["pipeline"].update(RANDOM_WEIGHTS["pipeline"])
    return d


def render_walk(scene, n_frames, hw, k, seed=SEED):
    """`n_frames` frames of SyntheticDataset's orbit through `scene`, rendered
    with the loader's own K (host threads: set-up, not mapping time).
    Returns (frames, instance images)."""
    poses = SyntheticDataset(scene=scene, num_frames=n_frames, hw=hw, seed=seed).poses
    with ThreadPoolExecutor(8) as ex:
        out = list(ex.map(lambda p: scene.render(p.astype(np.float64), k, hw), poses))
    return [RGBDFrame(rgb, depth, p, k) for (rgb, depth, _, _), p in zip(out, poses)], [o[2] for o in out]


def loader_frames_equal(tag, ds, back, pose_atol=0.0):
    """Every frame the loader reads against the writer's quantized frames:
    rgb, depth and K bit for bit, the pose within `pose_atol` (0: exact)."""
    check(len(ds) == len(back), f"{tag}: the loader reads {len(ds)} frames, {len(back)} written")
    worst = 0.0
    for i, b in enumerate(back):
        f = ds[i]
        for name in ("rgb", "depth", "k"):
            a, e = getattr(f, name), getattr(b, name)
            check(a.dtype == e.dtype and np.array_equal(a, e), f"{tag}: frame {i}: {name} differs from the written")
        check(f.pose.dtype == np.float32, f"{tag}: frame {i}: pose dtype")
        worst = max(worst, float(np.abs(f.pose - b.pose).max()))
    check(worst <= pose_atol, f"{tag}: pose off by {worst:.3e} > {pose_atol:.1e}")
    log(f"[{tag}] {len(ds)} frames through {type(ds).__name__}: rgb, depth, K equal to the written bit for bit; "
        f"poses within {worst:.3e} (limit {pose_atol:.1e})")


def label_batches(*vocabs) -> int:
    """Padded text batches of 256 prompts the label features of `vocabs` take."""
    return sum(math.ceil(len(load_vocabulary(v)) * len(clip_mod.TEMPLATES) / 256) for v in vocabs)


@contextlib.contextmanager
def recording_mapping(models, mapped, feats, finals=None):
    """Record the models batch_map loads, every (config, MappedScene) of a
    Mapper.run and every tiered extraction's FrameFeatures, in order, and
    into `finals` the seconds of each Mapper.finalize (synchronised)."""
    load, run, tiered, fin = (batch_map.load_models, Mapper.run, mapping_mod.extract_frame_features_tiered,
                              Mapper.finalize)

    def rec_load(*a, **kw):
        models.append(load(*a, **kw))
        return models[-1]

    def rec_run(self, ds):
        mapped.append((self.cfg, run(self, ds)))
        return mapped[-1][1]

    def rec_tiered(*a, **kw):
        feats.append(tiered(*a, **kw))
        return feats[-1]

    def rec_fin(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fin(self)
        torch.cuda.synchronize()
        if finals is not None:
            finals.append(time.perf_counter() - t0)
        return out

    batch_map.load_models, Mapper.run, mapping_mod.extract_frame_features_tiered, Mapper.finalize = (
        rec_load, rec_run, rec_tiered, rec_fin)
    try:
        yield
    finally:
        batch_map.load_models, Mapper.run, mapping_mod.extract_frame_features_tiered, Mapper.finalize = (
            load, run, tiered, fin)


def same_mapping(tag, cfg, models, loader_ms, loader_ffs, back):
    """The loader run's MappedScene against an in-memory run of the same
    quantized frames: scene keys and row count exact, masks and validity
    pixel for pixel, features at the towers' cosine gate (CUDA's index_add_
    sums in no fixed order, ROADMAP.md section 3)."""
    clip, sam = models[0], models[1]
    ffs = []
    with recording_mapping([], [], ffs):
        ms = Mapper(cfg, clip, sam).run(back)
    n = int(ms.scene.num)
    check(n == int(loader_ms.scene.num), f"{tag}: scene rows {int(loader_ms.scene.num)} vs in-memory {n}")
    check(torch.equal(ms.scene.key[:n], loader_ms.scene.key[:n]), f"{tag}: scene voxel keys differ")
    check(len(ffs) == len(loader_ffs), f"{tag}: {len(loader_ffs)} extracted frames vs {len(ffs)}")
    cos_m, cos_g = 1.0, 1.0
    for j, (a, b) in enumerate(zip(loader_ffs, ffs)):
        check(torch.equal(a.valid, b.valid) and torch.equal(a.masks, b.masks), f"{tag}: keyframe {j}: masks differ")
        both = a.valid & b.valid
        if bool(both.any()):
            cos_m = min(cos_m, F.cosine_similarity(a.f_masks[both].float(), b.f_masks[both].float(), dim=-1).min().item())
        cos_g = min(cos_g, F.cosine_similarity(a.f_global.float(), b.f_global.float(), dim=0).item())
    rows = ms.scene.valid()
    fa, fb = loader_ms.scene.feats()[rows].float(), ms.scene.feats()[rows].float()
    live = (fa.norm(dim=-1) > 0) & (fb.norm(dim=-1) > 0)
    cos_s = F.cosine_similarity(fa[live], fb[live], dim=-1).min().item() if bool(live.any()) else 1.0
    log(f"[{tag}] loader run vs in-memory run of the same quantized frames: {n} scene rows, keys equal; {len(ffs)} "
        f"keyframes' masks and validity equal; f_masks min cosine {cos_m:.6f}, f_global {cos_g:.6f}, fused scene "
        f"features min cosine {cos_s:.6f} over {int(live.sum())} rows; instances {int(loader_ms.instances.num())} / "
        f"{int(ms.instances.num())}")
    check(cos_m > 0.9998 and cos_g > 0.9998 and cos_s > 0.9998, f"{tag}: features disagree")


def hm3dsem_path(root, tag):
    """(n) batch_map.run_batch over two scenes written in HM3DSem layout
    (rendered with the loader's K, f = W/2; poses stored y-up), with a GT
    scene_info JSON each, at config/hm3dsem_benchmark.yaml's settings."""
    d = deployment_config(HM3DSEM_YAML, root)
    cfg = from_dict(d)
    walks, gt_dir = d["main"]["dataset_path"], os.path.join(root, "gt")
    hw = HM3D_HW
    k = hm3dsem_k(*hw)
    t0 = time.perf_counter()
    scenes, back = [], {}
    for layout, n, skip in HM3D_SCENES:
        make_scene, rects, _ = eval_protocol.LAYOUTS[layout]
        scene = make_scene(SyntheticScene)
        frames, inst = render_walk(scene, n, hw, k)
        back[layout] = write_hm3dsem(os.path.join(walks, layout), frames, cfg.main.depth_cut,
                                     semantic=[i + 1 for i in inst])
        gt_from_synthetic(scene, room_rects=rects).to_json(os.path.join(gt_dir, f"{layout}.json"),
                                                          save_object_plys=False)
        scenes.append({"scene_id": layout, "dataset_path": walks, "skip_frames": skip})
    log(f"[{tag}] reduced: {len(scenes)} scenes, " + ", ".join(f"{s} {len(back[s])} frames at skip_frames {k_}"
                                                              for s, _, k_ in HM3D_SCENES)
        + " (the benchmark's walks: hundreds of frames at 10-30); random weights from main.seed (no checkpoint); "
        f"{RANDOM_WEIGHTS}")
    log(f"[{tag}] {sum(len(b) for b in back.values())} frames at {hw[1]}x{hw[0]} rendered and written in HM3DSem "
        f"layout in {time.perf_counter() - t0:.3f} s (set-up)")
    for layout, _, _ in HM3D_SCENES:
        ds = HM3DSemDataset(walks, layout, cfg.main.depth_cut)
        loader_frames_equal(f"{tag}-{layout}", ds, back[layout])
        sem = ds.semantic(len(ds) - 1)
        check(sem.shape == hw and int(sem.max()) > 0, f"{tag}: semantic image")
    models, mapped, feats, finals = [], [], [], []
    with recording_mapping(models, mapped, feats, finals):
        summary, wall, launches, in_path, peak = counted(
            lambda: batch_map.run_batch(cfg, scenes, gt_dir=gt_dir))
    clip, sam = models[0][0], models[0][1]
    per = launches_a_keyframe(clip, sam)
    nfs = [summary[s["scene_id"]]["frames"] for s in scenes]
    batches = label_batches(cfg.pipeline.obj_labels, "ROOM_TYPES")  # the first scene fills save_path's label cache
    expect = {"flash_attention_2d": per["flash_attention_2d"] * sum(nfs), "quant_matmul": 0,
              "flash_attention": per["flash_attention"] * sum(nfs) + models[0][4].variant.t_layers * batches}
    log(f"[{tag}] batch_map.run_batch over {len(scenes)} scenes ({sum(nfs)} keyframes, SAM {sam.variant.name} "
        f"bf16, CLIP {clip.variant.name} bf16) in {wall:.3f} s (the towers' init included), max_memory_allocated "
        f"{peak / 2**30:.3f} GiB; launches {launches}, expected {expect} ({batches} label text batches)")
    for name, n in expect.items():
        check(launches[name] == n, f"{tag}: {name} launches {launches[name]} != {n}")
    check(len(finals) == len(scenes), f"{tag}: {len(finals)} finalize calls for {len(scenes)} scenes")
    for s, nf, fin_s in zip(scenes, nfs, finals):
        st = summary[s["scene_id"]]
        check(nf == math.ceil(len(back[s["scene_id"]]) / s["skip_frames"]), f"{tag}: keyframes of {s['scene_id']}")
        ev = st.pop("eval")
        log(f"[{tag}] {s['scene_id']}: {json.dumps(st)}")
        log(f"[{tag}] {s['scene_id']}: mapping {st['mapping_fps']:.3f} keyframes/s over {nf} keyframes (finalize "
            f"included: {1e3 * fin_s:.3f} ms of {1e3 * st['mapping_seconds']:.3f}); "
            f"{1e3 * (st['mapping_seconds'] - fin_s) / nf:.3f} ms a keyframe without finalize; eval {json.dumps(ev)}")
        check(st["scene_points"] > 0 and st["instances"] >= 1 and st["floors"] >= 1 and st["rooms"] >= 1,
              f"{tag}: {s['scene_id']}: an empty graph")
        check(all(math.isfinite(v) for v in _leaves(ev) if isinstance(v, float)), f"{tag}: non-finite metric")
    for name, runs in in_path.items():
        for key, (n, t) in runs.items():
            log(f"[{tag}] {name} {key}: {n} launches, {t:.4f} ms in the run ({t / n:.4f} ms/launch)")
    (cfg1, ms1), s1 = mapped[0], scenes[0]
    same_mapping(f"{tag}-{s1['scene_id']}", cfg1, models[0], ms1, feats[:nfs[0]], back[s1["scene_id"]])
    return dict(launches=launches, in_path=in_path, nf=sum(nfs))


def _leaves(m):
    if isinstance(m, dict):
        return [x for v in m.values() for x in _leaves(v)]
    if isinstance(m, (list, tuple)):
        return [x for v in m for x in _leaves(v)]
    return [m]


def build_path(tag, cfg, models, ds_check, expect_batches):
    """build_map.run (its loader from the config), counted; stage times,
    keyframes/s and the launches a keyframe held."""
    clip, sam = models[0], models[1]
    timer = StageTimer("cuda")
    (graph_dir, graph), wall, launches, in_path, peak = counted(lambda: build_map.run(cfg, models=models, timer=timer))
    stats = json.loads((Path(graph_dir).parent / "build_stats.json").read_text())
    nf = stats["frames"]
    per = launches_a_keyframe(clip, sam)
    expect = {"flash_attention_2d": per["flash_attention_2d"] * nf, "quant_matmul": 0,
              "flash_attention": per["flash_attention"] * nf + models[4].variant.t_layers * expect_batches}
    log(f"[{tag}] build_map.run, {nf} keyframes (SAM {sam.variant.name}, CLIP {clip.variant.name}, bf16): {wall:.3f} "
        f"s, mapping {stats['mapping_fps']:.3f} keyframes/s (finalize included), "
        f"{(timer.ms['map'] - timer.ms['finalize']) / nf:.3f} ms a keyframe without finalize (stage timer: map "
        f"{timer.ms['map']:.3f} ms, finalize {timer.ms['finalize']:.3f}), max_memory_allocated "
        f"{peak / 2**30:.3f} GiB; stats {json.dumps(stats)}")
    report(tag, nf, wall, timer, launches, in_path, peak, {})
    log(f"[{tag}] expected launches {expect} ({expect_batches} label text batches)")
    for name, n in expect.items():
        check(launches[name] == n, f"{tag}: {name} launches {launches[name]} != {n}")
    check(stats["scene_points"] > 0 and stats["instances"] >= 1 and len(graph.rooms) >= 1, f"{tag}: an empty graph")
    check(nf == len(range(0, len(ds_check), cfg.pipeline.skip_frames)), f"{tag}: keyframes")
    return dict(launches=launches, in_path=in_path, nf=nf)


def replica_path(clip, sam, text, root, tag):
    """(n) a Replica scene at 1200x680 (cam_params.json with the standard
    Replica intrinsics, depth PNGs at 6553.5 a metre) through build_map.run
    at config/replica_office.yaml's settings: SAM vit_b, depth_cut 8.0,
    SCANNET20."""
    d = deployment_config(REPLICA_YAML, root)
    cfg = from_dict(d)
    hw = REPLICA_HW
    # f = W/2, c = (W-1)/2, (H-1)/2: Replica's standard 600, 599.5, 339.5 at 1200x680
    k = hm3dsem_k(*hw)
    scene = SyntheticScene.three_room(SEED)
    t0 = time.perf_counter()
    frames, _ = render_walk(scene, REPLICA_FRAMES, hw, k)
    back = write_replica(os.path.join(cfg.main.dataset_path, cfg.main.scene_id), frames, cfg.main.depth_cut)
    log(f"[{tag}] reduced: {len(frames)} frames at skip_frames {cfg.pipeline.skip_frames}; random weights from "
        f"main.seed (no checkpoint); {RANDOM_WEIGHTS}")
    log(f"[{tag}] {len(frames)} frames at {hw[1]}x{hw[0]} rendered and written in Replica layout in "
        f"{time.perf_counter() - t0:.3f} s (set-up)")
    ds = load_dataset(cfg)
    check(isinstance(ds, ReplicaDataset) and ds.scale == 6553.5, f"{tag}: load_dataset gave {type(ds).__name__}")
    loader_frames_equal(tag, ds, back)
    return build_path(tag, cfg, (clip, sam, clip.variant, sam.variant, text), ds,
                      label_batches(cfg.pipeline.obj_labels, "ROOM_TYPES"))


def horizon_path(root, tag):
    """(n) a Horizon scene (d435i.yaml, float-timestamp images/, poses.txt of
    world-to-camera TUM rows) through build_map.run at
    config/horizon_ic4f.yaml's settings: SAM vit_h, SCANNET200."""
    d = deployment_config(HORIZON_YAML, root)
    cfg = from_dict(d)
    hw = HORIZON_HW
    f = 0.6 * hw[1]  # a D435i depth camera's focal length (383 px at 640x480)
    k = np.array([[f, 0, hw[1] / 2 - 0.5], [0, f, hw[0] / 2 - 0.5], [0, 0, 1]], np.float32)
    scene = SyntheticScene.three_room(SEED + 1)
    t0 = time.perf_counter()
    frames, _ = render_walk(scene, HORIZON_FRAMES, hw, k)
    back = write_horizon(os.path.join(cfg.main.dataset_path, cfg.main.scene_id), frames, cfg.main.depth_cut)
    log(f"[{tag}] reduced: {len(frames)} frames at skip_frames {cfg.pipeline.skip_frames}; random weights from "
        f"main.seed (no checkpoint); {RANDOM_WEIGHTS}")
    log(f"[{tag}] {len(frames)} frames at {hw[1]}x{hw[0]} rendered and written in Horizon layout in "
        f"{time.perf_counter() - t0:.3f} s (set-up)")
    ds = load_dataset(cfg)
    check(isinstance(ds, HorizonDataset), f"{tag}: load_dataset gave {type(ds).__name__}")
    loader_frames_equal(tag, ds, back, QUAT_POSE_ATOL)
    t0 = time.perf_counter()
    models = load_models(cfg)
    log(f"[{tag}] load_models ({models[2].name} + SAM {models[3].name}, seeded) in {time.perf_counter() - t0:.3f} s")
    return build_path(tag, cfg, models, ds, label_batches(cfg.pipeline.obj_labels, "ROOM_TYPES"))


# float32 dot products of two unit vectors of dim D are exact to D * 2^-24
# whatever the summation order; a ranking or a class argmax compares two of
# them, so two candidates within twice that may swap against float64
def retrieval_tie(dim: int) -> float:
    return 2 * dim * 2.0**-24


def retrieval_path(tag):
    """(o) apps.retrieval_bench at its defaults on the card, counted (it
    launches none of the three kernels); every row's indices against the
    float64 exact top-k under the same filter, equal except at near-ties."""
    res, wall, launches, in_path, peak = counted(lambda: retrieval_bench.run())
    line = {k: v for k, v in res.items() if k not in ("device_idx", "inputs")}
    log(f"[{tag}] {json.dumps(line)}")
    check(all(n == 0 for n in launches.values()), f"{tag}: launches {launches}")
    g, q, neg, planted = res["inputs"]
    idx = res["device_idx"]
    tie = retrieval_tie(g.shape[1])
    exact_rows, tie_rows = 0, []
    for i in range(len(q)):
        exact, _ = retrieval_bench.exact_topk(q[i], g, neg, idx.shape[1])
        if np.array_equal(idx[i], exact):
            exact_rows += 1
            continue
        s = g.astype(np.float64) @ q[i].astype(np.float64)
        margin = s - (neg.astype(np.float64) @ g.T.astype(np.float64)).max(0)  # >= 0: the query's class wins
        for a, b in zip(idx[i], exact):
            check(a == b or abs(s[a] - s[b]) <= tie or abs(margin[a]) <= tie or abs(margin[b]) <= tie,
                  f"{tag}: row {i}: {idx[i]} vs the exact {exact}, not a near-tie")
        tie_rows.append(i)
    log(f"[{tag}] {exact_rows} of {len(q)} rows equal the float64 exact top-k; rows differing at near-ties "
        f"(within {tie:.2e}): {tie_rows}; {wall:.3f} s, launches {launches}")
    check(line["planted_recall_at_1"] == 1.0, f"{tag}: planted_recall_at_1 {line['planted_recall_at_1']}")
    check(line["device"] == torch.cuda.get_device_name(0) and line["timing"] == "device", f"{tag}: {line}")
    return dict(launches=launches, in_path=in_path, result=line)


def llm_parser_path(root, tag):
    """(p) LLMParser over CachedLLMClient(batcher_backend(...)) on the port's
    ContinuousBatcher with vlm-small (seeded random weights: the text is
    arbitrary), over the graph path's 8 instructions: every call returns a
    ParsedQuery, K2 launches one per gpt layer a prefill call; a second pass
    is answered from the cache with no new batcher step."""
    vv = vlm_mod.VARIANTS["vlm-small"]
    t0 = time.perf_counter()
    vlm = vlm_mod.init_vlm(vv, seed=0, dtype=torch.bfloat16, device="cuda")
    visual = clip_mod.init_clip_visual(clip_mod.VARIANTS[vv.clip_variant], seed=1, dtype=torch.bfloat16)
    batcher = ContinuousBatcher(vlm, visual)
    cache = os.path.join(root, "llm_cache.jsonl")
    client = llm_client.CachedLLMClient(llm_client.batcher_backend(batcher), cache_path=cache)

    def chat(system, prompt):
        return client.send_query(llm_client.Conversation().system(system).user(prompt))

    parser = LLMParser(chat)
    log(f"[{tag}] reduced: vlm-small with seeded random weights, {len(QUERIES)} instructions; init "
        f"{time.perf_counter() - t0:.3f} s")
    passes = []
    for turn in ("served", "cached"):
        calls = collections.defaultdict(list)
        steps0 = batcher.steps
        with counting(calls):
            parsed, wall, launches, in_path, peak = counted(lambda: [parser(ins) for ins in QUERIES])
        passes.append((parsed, launches, calls, batcher.steps - steps0, in_path))
        log(f"[{tag}] {turn}: {len(QUERIES)} parses in {wall:.3f} s ({1e3 * wall / len(QUERIES):.3f} ms a parse), "
            f"batcher steps {batcher.steps - steps0}, prefill calls {len(calls['prefill'])} (B, T: "
            f"{dict(sorted(collections.Counter(calls['prefill']).items()))}), launches {launches}")
        for ins, p in zip(QUERIES, parsed):
            check(isinstance(p, ParsedQuery), f"{tag}: {ins!r} gave {p!r}")
    (p1, l1, c1, s1, in_path), (p2, l2, c2, s2, _) = passes
    for ins, p in zip(QUERIES, p1):
        log(f"[{tag}] {ins!r} -> {tuple(x if x is None or len(x) <= 40 else x[:37] + '...' for x in p.astuple())}")
    check(l1["flash_attention"] == vv.layers * len(c1["prefill"]) and len(c1["prefill"]) >= 1 and s1 > 0,
          f"{tag}: K2 launches {l1['flash_attention']} for {len(c1['prefill'])} prefill calls")
    check(l1["flash_attention_2d"] == 0 and l1["quant_matmul"] == 0, f"{tag}: launches {l1}")
    check(s2 == 0 and not c2["prefill"] and all(n == 0 for n in l2.values()), f"{tag}: the cached pass served")
    check([p.astuple() for p in p1] == [p.astuple() for p in p2], f"{tag}: the cached pass parsed otherwise")
    with open(cache) as f:
        check(sum(1 for line in f if line.strip()) == len(set(QUERIES)), f"{tag}: cache file lines")
    del vlm, visual, batcher
    return dict(launches=l1, in_path=in_path, nf=len(QUERIES))


def timed_calls(fn, calls):
    """`calls` calls of fn, each timed by CUDA events; returns the last
    output and the times (ms)."""
    times = []
    for _ in range(calls):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return out, times


@contextlib.contextmanager
def eager_solvers():
    """The solvers without their CUDA graphs (each solve called as on the
    CPU), for the eager side of (q)'s comparison."""
    run = solvers._run
    solvers._run = lambda fn, tensors, **settings: tuple(fn(*tensors, **settings))
    try:
        yield
    finally:
        solvers._run = run


def profile_solve(tag, name, fn):
    """One call of fn under torch.profiler: its CUDA kernels, their device
    time, the host's self time and the host ops that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    dev = [e for e in ka if str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total if hasattr(e, "self_device_time_total") else e.self_cuda_time_total
                 for e in dev)
    host = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)
    log(f"[{tag}] profile, {name}: {sum(e.count for e in dev)} CUDA kernels, {dev_us / 1e3:.3f} ms of device time; "
        f"host self time {sum(e.self_cpu_time_total for e in ka) / 1e3:.3f} ms, most in "
        + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms ({e.count} calls)" for e in host[:6]))


def pose_err(a, b) -> float:
    """max |log(a^-1 b)| over a batch of poses."""
    a, b = torch.as_tensor(a, dtype=torch.float32).cpu(), torch.as_tensor(b, dtype=torch.float32).cpu()
    return float(log_se3(invert_pose(a) @ b).abs().max())


# Card vs the port's own CPU run of the same solve: float32 Gauss-Newton in
# another summation order converges to the same fixed point within a few
# hundred ulps of its poses; ICP's voxel-snap correspondences may flip at a
# cell face, which moves the fixed point within the snap's own resolution
SOLVER_CPU_ATOL = 1e-4
ICP_CPU_ATOL = 1e-3
GRAPH_CALLS, EAGER_CALLS = 7, 3


def solver_path(tag):
    """(q) the pose solvers on the card: PnP on 4096 points, pnp_batch at
    B = 64, a pose-graph loop of 64 poses, icp_multiscale of a 20k-point
    scan against a backprojected scene; each recovers its known pose within
    tests/test_solvers.py's tolerance and agrees with the port's CPU run,
    timed as a CUDA graph and eagerly (eager_solvers); one PnP solve of
    each kind under torch.profiler."""
    rng = np.random.default_rng(SEED)
    cam = Pinhole.make(200.0, 200.0, 64.0, 48.0)
    out = {}

    def case_pnp(n):
        pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        pts[:, 2] += 4.0
        xi = (rng.normal(0, 1, 6) * [0.05, 0.05, 0.08, 0.04, 0.03, 0.03]).astype(np.float32)
        pose = exp_se3(torch.from_numpy(xi))
        uv = project(transform_points(pose, torch.from_numpy(pts)), cam)[0].numpy()
        return pts, uv, pose.numpy()

    def run(name, solve, truth, err_max, cpu_atol):
        """solve(device): the CUDA graph's first call (capture included)
        and the median of GRAPH_CALLS replays, against the eager solve's
        median of EAGER_CALLS after a warm-up; both held to the known pose
        and to the CPU run."""
        _, (first,) = timed_calls(lambda: solve(None), 1)
        res, times = timed_calls(lambda: solve(None), GRAPH_CALLS)
        with eager_solvers():
            solve(None)
            eager, eager_times = timed_calls(lambda: solve(None), EAGER_CALLS)
        t0 = time.perf_counter()
        ref = solve("cpu")
        cpu_s = time.perf_counter() - t0
        pose, eager_pose, ref_pose = (r.pose if isinstance(r, solvers.ICPResult) else r[0] for r in (res, eager, ref))
        err, diff = pose_err(truth, pose), float((pose.cpu() - ref_pose).abs().max())
        diff_eager = float((pose - eager_pose).abs().max())
        ms, eager_ms = statistics.median(times), statistics.median(eager_times)
        log(f"[{tag}] {name}: CUDA graph {ms:.3f} ms a solve (median of {GRAPH_CALLS}: "
            f"{', '.join(f'{t:.3f}' for t in times)}; first call, capture included, {first:.3f}); eager {eager_ms:.3f} "
            f"ms (median of {EAGER_CALLS}: {', '.join(f'{t:.3f}' for t in eager_times)}), {eager_ms / ms:.1f}x; "
            f"CUDA events. max |log(truth^-1 pose)| {err:.3e} (limit {err_max}); card vs CPU max |pose difference| "
            f"{diff:.3e} (limit {cpu_atol}); graph vs eager {diff_eager:.3e}; CPU {cpu_s * 1e3:.3f} ms")
        check(err_max is None or err < err_max, f"{tag}: {name} missed the known pose")
        check(diff <= cpu_atol and diff_eager <= cpu_atol, f"{tag}: {name}: the graph, the eager solve and the CPU "
                                                           "disagree")
        out[name] = dict(graph_ms=ms, first_ms=first, eager_ms=eager_ms, cpu_ms=cpu_s * 1e3)
        return res

    pts, uv, truth = case_pnp(4096)
    valid = np.ones(len(pts), bool)
    def pnp(device):
        return solvers.pnp_gauss_newton(pts, uv, valid, cam, np.eye(4), device=device)

    res = run("pnp_gauss_newton, 4096 points", pnp, truth, 1e-3, SOLVER_CPU_ATOL)
    check(float(res[1]) < 1e-2, f"{tag}: PnP rms {float(res[1])}")
    with eager_solvers():
        profile_solve(tag, "PnP eager", lambda: pnp(None))
    profile_solve(tag, "PnP, CUDA graph replay", lambda: pnp(None))
    cases = [case_pnp(4096) for _ in range(64)]
    P, U, T = (np.stack([c[i] for c in cases]) for i in range(3))
    V, I = np.ones(P.shape[:2], bool), np.stack([np.eye(4, dtype=np.float32)] * 64)
    res = run("pnp_batch, B = 64 x 4096 points",
              lambda device: solvers.pnp_batch(P, U, V, cam, I, device=device), T, 1e-3, SOLVER_CPU_ATOL)
    check(float(res[1].max()) < 1e-2, f"{tag}: pnp_batch rms {float(res[1].max())}")
    # a loop of 64 poses around a circle, odometry + loop closure + chords
    m = 64
    step = exp_se3(torch.tensor([0.3, 0, 0, 0, 0, 2 * math.pi / m]))
    true = [torch.eye(4)]
    for _ in range(1, m):
        true.append(true[-1] @ step)
    true = torch.stack(true)
    edges = [(i, i + 1) for i in range(m - 1)] + [(m - 1, 0)] + [(i, i + 8) for i in range(0, m - 8, 8)]
    noise = exp_se3(torch.from_numpy(rng.normal(0, 0.02, (len(edges), 6)).astype(np.float32)))
    rels = torch.stack([invert_pose(true[i]) @ true[j] @ noise[e] for e, (i, j) in enumerate(edges)])
    init = [true[0]]
    for e in range(m - 1):
        init.append(init[-1] @ rels[e])
    init = torch.stack(init).numpy()
    E, ev = np.array(edges), np.ones(len(edges), bool)

    def mean_err(ps):
        return float(log_se3(invert_pose(true) @ torch.as_tensor(ps).cpu()).abs().mean())

    res = run(f"pose_graph_gauss_newton, {m} poses, {len(edges)} edges, 20 iterations",
              lambda device: solvers.pose_graph_gauss_newton(init, E, rels.numpy(), ev, device=device),
              true, None, SOLVER_CPU_ATOL)
    log(f"[{tag}] pose graph mean |error| {mean_err(res[0]):.4f} (odometry init {mean_err(init):.4f}; limit 0.05)")
    check(mean_err(res[0]) < mean_err(init) and mean_err(res[0]) < 0.05, f"{tag}: the pose graph did not close")
    # ICP: a 20k-point scan of a backprojected scene, displaced
    ds = SyntheticDataset(SyntheticScene.three_room(SEED), num_frames=6, hw=(240, 320), seed=SEED)
    pts = []
    for i in range(len(ds)):
        f = ds[i]
        p, _, v = backproject(torch.from_numpy(f.depth), torch.from_numpy(f.rgb), Pinhole.from_matrix(f.k),
                              torch.from_numpy(f.pose), 1e-3, 20.0)
        pts.append(p[v])
    mappts = torch.cat(pts).numpy()
    scan = mappts[rng.choice(len(mappts), 20000, replace=False)]
    t_true = exp_se3(torch.tensor([0.08, -0.05, 0.02, 0.03, -0.02, 0.05]))
    scan_p = transform_points(invert_pose(t_true), torch.from_numpy(scan)).numpy()
    kw = dict(scales=(0.3, 0.1, 0.05, 0.03), iters_per_scale=15)
    sv, mv = np.ones(len(scan_p), bool), np.ones(len(mappts), bool)
    res = run(f"icp_multiscale, a {len(scan_p)}-point scan against {len(mappts)} map points, 4 scales x 15",
              lambda device: solvers.icp_multiscale(scan_p, sv, mappts, mv, np.eye(4), device=device, **kw),
              t_true, 0.05, ICP_CPU_ATOL)
    log(f"[{tag}] icp_multiscale rms {float(res.rms):.4f} m, inlier fraction {float(res.inlier_frac):.4f}")
    check(float(res.inlier_frac) > 0.9, f"{tag}: ICP inlier fraction {float(res.inlier_frac)}")
    return out


def hold_new_shapes(cases, paths):
    """A case for every K1, K2 and K3 shape a path launched that no case
    held: K1 and K2 as views of one packed projection, as _attention_2d and
    _attend launch them; K3 as the towers' linears (k3_case)."""
    held = {c["key"] for c in cases.values()}
    gen = torch.Generator().manual_seed(SEED + 3)
    k3_gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    dtypes = {v: k for k, v in TYPE_NAMES.items()}
    for kernel in WRAPPERS:
        for key in sorted({k for path in paths.values() for k in path["in_path"][kernel] if k not in held}):
            if kernel == "flash_attention":
                b, h, t, causal = key
                c = k2_case(f"k2_b{b}_h{h}_t{t}{'_causal' if causal else ''}", b, h, t, causal, gen, packed=True)
                log_attention_case(c)
            elif kernel == "flash_attention_2d":
                b, heads, gh, gw, d = key
                check(gh == gw, f"K1 launched on a {gh}x{gw} grid: no case builds it")
                c = k1_case(f"k1_b{b}_h{heads}_g{gh}_d{d}", b, heads, gh, gen, d=d)
                log_attention_case(c)
            else:
                m, k, n, x_name, out_name = key
                c = k3_case(f"k3_m{m}_{k}x{n}_{x_name}_{out_name}", m, k, n, dtypes[x_name], dtypes[out_name], k3_gen)
                log_k3_case(c)
            cases[c["name"]] = c


def path_sums(cases, paths) -> None:
    """For every path and kernel it launched: its launches, their device
    time in the run, and the kernel phase's per-launch kernel, plain,
    library and bound times summed over those launches."""
    by_key = {c["key"]: c for c in cases.values()}
    for tag, path in paths.items():
        for name, runs in path["in_path"].items():
            if not runs:
                continue
            n = sum(r[0] for r in runs.values())
            sums = {f: sum(r[0] * by_key[k][f] for k, r in runs.items())
                    for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"[paths] {tag}: {name} {n} launches, {sum(r[1] for r in runs.values()):.4f} ms in the run; summed "
                f"phase {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f}, library {sums['library_ms']:.4f} "
                f"({sums['ms'] / sums['library_ms']:.2f}x), bound {sums['bound_ms']:.4f} ms")


KERNELS = (
    ("flash_attention_2d", "holoagent_tpu_torch/csrc/flash_attention.cu", "holoagent_tpu/ops/flash_attention.py:157",
     "bf16"),
    ("flash_attention", "holoagent_tpu_torch/csrc/flash_attention.cu", "holoagent_tpu/ops/flash_attention.py:217",
     "bf16"),
    ("quant_matmul", "holoagent_tpu_torch/csrc/quant_matmul.cu", "holoagent_tpu/ops/quant_matmul.py:70", "w8a8"),
)


def kernels_line(cases, paths):
    """One entry per kernel, for its main-path run: the bf16 Mapper run for
    K1 and K2, the W8A8 Mapper run for K3.  `ms` is the kernel's device time
    inside that run (CUDA events around each launch).  `isolated_ms`,
    `plain_ms`, `library_ms` and `bound_ms` are the kernel phase's
    per-launch numbers at each launch's shape, summed over the run's
    launches; `ratio_to_library` is `isolated_ms` over `library_ms`, both
    device time with the stream held, so host work inside the in-run
    events does not count against the kernel.
    `launches_by_path` has every counted path's launches.  `cases` holds
    the per-launch numbers themselves."""
    by_key = {c["key"]: c for c in cases.values()}
    line = []
    for name, source, replaces, main in KERNELS:
        for tag, path in paths.items():
            unchecked = [k for k in path["in_path"][name] if k not in by_key]
            check(not unchecked, f"{name}: the {tag} path launched shapes {unchecked} that no kernel phase held")
        runs, nf, launches = paths[main]["in_path"][name], paths[main]["nf"], paths[main]["launches"][name]
        check(launches > 0, f"{name}: not launched on its main path")

        def summed(field):
            return sum(n * by_key[k][field] for k, (n, _) in runs.items())

        dominant = max(runs, key=lambda k: runs[k][0] * by_key[k]["bound_ms"])
        mine = [{f: v for f, v in c.items() if f not in ("key", "kernel")}
                for c in cases.values() if c["kernel"] == name]
        in_run = sum(t for _, t in runs.values())
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": in_run, "plain_ms": summed("plain_ms"),
            "bound_ms": summed("bound_ms"), "bound_by": by_key[dominant]["bound_by"],
            "library_ms": summed("library_ms"), "isolated_ms": summed("ms"),
            "ratio_to_library": summed("ms") / summed("library_ms"),
            "per": f"the counted {main} Mapper run: {launches} launches over {nf} keyframes",
            "launches_by_path": {tag: path["launches"][name] for tag, path in paths.items()},
            "cases": mine,
        })
    return {"kernels": line}


def build_all():
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    libs = {"flash_attention": fa.LIB, "quant_matmul": qm.LIB}
    with ThreadPoolExecutor(len(libs)) as ex:
        built = {name: ex.submit(lib.build) for name, lib in libs.items()}
        built = {name: f.result() for name, f in built.items()}
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {', '.join(p.name for p in built.values())}")
    for name, lib in built.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


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

    build_all()
    stamp("build")
    cases = kernel_phases()
    stamp("kernel phases")

    cfg = from_dict(CONFIG)
    qcfg_dict = copy.deepcopy(CONFIG)
    for tower in ("clip", "sam"):
        qcfg_dict["models"][tower]["quant"] = True
    qcfg = from_dict(qcfg_dict)
    t0 = time.perf_counter()
    clip, text = clip_mod.init_clip(clip_mod.VARIANTS[cfg.models.clip.type], seed=SEED, dtype=torch.bfloat16)
    sam = sam_mod.init_sam(sam_mod.VARIANTS[cfg.models.sam.type], seed=SEED + 1, dtype=torch.bfloat16)
    qclip, qsam, _, _, _ = load_models(qcfg)  # the same seeds: the int8 towers of the bf16 ones
    # (k)'s configuration: SAM vit_h, both towers W8A8; its towers are the
    # seeded bf16 vit_h and its quantization, as load_models makes them
    hcfg_dict = copy.deepcopy(qcfg_dict)
    hcfg_dict["models"]["sam"]["type"] = "vit_h"
    hcfg = from_dict(hcfg_dict)
    sam_h = sam_mod.init_sam(sam_mod.VARIANTS["vit_h"], seed=SEED + 1, dtype=torch.bfloat16)
    qsam_h = sam_mod.quantize_sam(sam_h)
    ds = SyntheticDataset(SyntheticScene.three_room(SEED), num_frames=FRAMES, hw=(480, 640), seed=SEED)
    for i in range(0, len(ds), cfg.pipeline.skip_frames):
        ds[i]  # render up front: data set-up is not mapping time
    log(f"[setup] bf16 and W8A8 towers (SAM vit_b and vit_h) + {len(ds)} rendered frames in "
        f"{time.perf_counter() - t0:.2f} s")

    e_bf16, f_bf16 = tower_checks(clip, sam, ds[0])
    q8_tower_checks(qclip, qsam, ds[0], e_bf16, f_bf16)
    text_tower_check(text)
    vit_h_tower_checks(sam_h, qsam_h, ds[0])
    del sam_h
    stamp("set-up and tower checks")
    paths = {"bf16": main_path(clip, sam, ds, cfg, "main", {"flash_attention_2d": 12, "flash_attention": 24,
                                                             "quant_matmul": 0})}
    q8_expect = {"flash_attention_2d": 12, "flash_attention": 24, "quant_matmul": 144}
    paths["w8a8"] = main_path(qclip, qsam, ds, qcfg, "w8a8", q8_expect)
    paths["w8a8 extraction, clip_qmm=pallas"] = extraction_path(
        qclip, qsam, ds, qcfg, "w8a8-pallas", q8_expect, paths["w8a8"]["ms"].keyframe_feats)
    paths["(k) vit_h W8A8: Mapper.run"] = operating_point_path(qclip, qsam_h, ds, hcfg, "vit_h-w8a8")
    del qsam_h
    paths.update(batched_path(clip, sam, ds, CONFIG, "batched"))
    paths["(l) batched extraction, W8A8, pairs"] = batched_w8a8_extraction(
        qclip, qsam, ds, qcfg, paths["w8a8"]["ms"].keyframe_feats, "batched-w8a8")
    stamp("(a)-(d), (k), (l)")
    for path in paths.values():
        path.pop("ms", None)  # the mapped scenes are checked: free their device state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        graph = paths["graph: build_map.run, load, queries"] = graph_path(clip, sam, text, ds, cfg, "graph", tmp)
        stamp("graph: build_map.run, load, queries")
        oracle_dir = os.path.join(tmp, "oracle")
        paths["(e) oracle protocol: eval_protocol.run"] = oracle_protocol(oracle_dir, "oracle")
        stamp("(e) oracle protocol: eval_protocol.run")
        paths["(f) slow path: query_bench --slow --vlm clip"] = slow_path(
            clip, sam, text, ds, cfg, graph["graph_dir"], "slow")
        stamp("(f) slow path: query_bench --slow --vlm clip")
        paths["(g) oracle retrieval: query_bench --oracle"] = oracle_query_path(
            clip, sam, text, cfg, os.path.join(oracle_dir, "three_room_seed0"), "oracle-query")
        stamp("(g) oracle retrieval: query_bench --oracle")
        prefill_check("serving")
        rates = os.path.join(tmp, "serving_bench.json")
        paths["(h) serving: serving_bench vlm-small"] = serving_path(
            "serving", "vlm-small", rates, batch=8, requests=16, new_tokens=32, chunk=8, chain_calls=5)
        stamp("(h) serving: serving_bench vlm-small")
        paths["(i) slow path: query_bench --slow --vlm generative"] = generative_path(
            clip, sam, text, ds, cfg, graph["graph_dir"], rates, "generative")
        stamp("(i) slow path: query_bench --slow --vlm generative")
        paths["(j) serving: serving_bench llava-tinyllama"] = serving_path(
            "serving-llama", "llava-tinyllama", None, batch=8, requests=8, new_tokens=16, chain_calls=1)
        stamp("(j) serving: serving_bench llava-tinyllama")
        paths["(m) hierarchical fold + mapper-state checkpoint"] = hierarchical_path(os.path.join(tmp, "state"), "hier")
        stamp("(m) hierarchical fold + mapper-state checkpoint")
        torch.cuda.empty_cache()
        paths["(n) hm3dsem: batch_map.run_batch, 2 scenes"] = hm3dsem_path(os.path.join(tmp, "hm3dsem"), "hm3dsem")
        stamp("(n) hm3dsem: batch_map.run_batch, 2 scenes")
        torch.cuda.empty_cache()
        paths["(n) replica: build_map.run, 1200x680"] = replica_path(clip, sam, text, os.path.join(tmp, "replica"),
                                                                    "replica")
        stamp("(n) replica: build_map.run, 1200x680")
        paths["(n) horizon: build_map.run"] = horizon_path(os.path.join(tmp, "horizon"), "horizon")
        stamp("(n) horizon: build_map.run")
        torch.cuda.empty_cache()
        paths["(o) retrieval_bench"] = retrieval_path("retrieval")
        stamp("(o) retrieval_bench")
        paths["(p) LLMParser served by vlm-small"] = llm_parser_path(tmp, "llm-parser")
        stamp("(p) LLMParser served by vlm-small")
        solver_ms, wall, launches, in_path, peak = counted(lambda: solver_path("solvers"))
        log(f"[solvers] {wall:.3f} s (the CPU runs included), launches {launches}")
        check(all(n == 0 for n in launches.values()), f"solvers: launches {launches}")
        paths["(q) pose solvers"] = dict(launches=launches, in_path=in_path)
        stamp("(q) pose solvers")
    hold_new_shapes(cases, paths)
    stamp("cases of the paths' new shapes")
    path_sums(cases, paths)
    print(json.dumps(kernels_line(cases, paths)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
