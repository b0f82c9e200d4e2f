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
     as SAM's _attention_2d splits it, and K2's CLIP cases as views of one
     (B, T, 3W) projection, as the towers' _attend splits it; each prints
     its kernel's plan (K1 global: the TMA + wgmma kernel; the windows and
     K2: the resident kernel; blocks per SM, waves).  K2's text case is the
     CLIP text tower's launch: 256 prompts, 12 heads, 77 tokens, causal,
     through the streamed kernel;
  4. towers: at full width, hold the SAM and CLIP encoders through the
     kernels against the same encoders through the plain versions, in bf16
     and as W8A8 towers (CLIP in both qmm modes), and the CLIP ViT-L/14 text
     tower (features of the SCANNET20 prompts);
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
     FSRQueryEngine.query_hierarchy over fixed instructions.  Per-stage ms,
     frames/s or ms/keyframe, peak memory; the kernels' launch counts and
     their device time inside each run.
Prints one JSON line of kernels, then the nvidia-smi line, then as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from holoagent_tpu_torch.apps import build_map  # noqa: E402
from holoagent_tpu_torch.apps.common import load_models, tokenizer  # noqa: E402
from holoagent_tpu_torch.config import from_dict  # noqa: E402
from holoagent_tpu_torch.dataloader import SyntheticDataset, SyntheticScene  # noqa: E402
from holoagent_tpu_torch.memory.hmsg import HMSGraph  # noqa: E402
from holoagent_tpu_torch.memory.mapping import Mapper  # noqa: E402
from holoagent_tpu_torch.models import clip as clip_mod  # noqa: E402
from holoagent_tpu_torch.models import sam as sam_mod  # noqa: E402
from holoagent_tpu_torch.models import transformer as tfm  # noqa: E402
from holoagent_tpu_torch.ops import flash_attention as fa  # noqa: E402
from holoagent_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from holoagent_tpu_torch.ops._cuda_build import aligned_contiguous  # noqa: E402
from holoagent_tpu_torch.perception.extractor import extract_frame_features_tiered  # noqa: E402
from holoagent_tpu_torch.query import FSRQueryEngine  # noqa: E402
from holoagent_tpu_torch.utils.labels import DEFAULT_ROOM_TYPES, SCANNET_LABELS_20  # noqa: E402
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
# head), so a kernel that skips a tile or part of the bias cannot pass.
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


def k1_case(name, b, heads, g, gen):
    """One K1 shape: q, k, v as the (B, heads, N, D) views of one (B, N, 3C)
    projection that _attention_2d makes, bias (B*heads, N, g) f32."""
    n, d = g * g, 64
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
    if fa.k1_route(g, g) == "resident":
        p = fa.resident_plan(bh, n, 2 * g)
        grid = p["blocks_per_head"] * bh
        res["plan"] = dict(p, kernel="resident", grid=grid, waves=grid / (p["blocks_per_sm"] * p["sms"]))
    else:
        p = fa.global_plan(bh, n)
        res["plan"] = dict(p, kernel="global (TMA + wgmma)", waves=p["grid"] / (p["blocks_per_sm"] * p["sms"]))
    mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, heads, n, n).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res.update(
        kernel="flash_attention_2d", key=(bh, g, g), name=name,
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
    stride D), the layout the towers launch; else contiguous tensors."""
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
    res = hold(name, out, ref, mutants)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not causal and t <= fa.T_MAX:
        p = fa.resident_plan(b * h, t)
        grid = p["blocks_per_head"] * b * h
        res["plan"] = dict(p, kernel="resident", grid=grid, waves=grid / (p["blocks_per_sm"] * p["sms"]))
    res.update(
        kernel="flash_attention", key=(b, h, t, causal), name=name,
        shape=f"B={b} H={h} T={t} D={d} causal={causal} {'packed qkv' if packed else 'contiguous'} bf16",
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
        plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v, causal=causal), samples=5, reps=2),
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=causal)),
    )
    if (causal or t > fa.T_MAX) and packed:  # the streamed kernel: the wrapper copies the strided q, k, v
        res["copy_ms"] = time_ms(lambda: [aligned_contiguous(x) for x in (q, k, v)])
    pairs = t * (t + 1) / 2 if causal else t * t  # key/query pairs this input needs
    res["bound_ms"], res["bound_by"] = bound(4.0 * pairs * d * b * h, 4 * b * h * t * d * 2, PEAK_BF16_FLOPS)
    res["ratio_to_library"] = res["ms"] / res["library_ms"]
    return res


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
    lin1, lin2; lin1 also with f32 output."""
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
    cases.append(k3_case("k3_ragged_m77", 77, 1024, 1024, bf, bf, gen))
    cases.append(k3_case("k3_ragged_m77_f32in", 77, 1024, 1024, f32, f32, gen))
    for c in cases:
        log(f"[kernel] {c['name']:28s} {c['shape']:32s} {c['max_ulps']} ulps ({c['outputs_differing']} outputs "
            f"differ, max abs err {c['max_abs_err']:.3e}); mutants rejected at "
            f"{', '.join(f'{v} ulps' for v in c['mutant_ulps'].values())}; "
            f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  _int_mm {c['library_ms']:.4f} ms  "
            f"({c['ratio_to_library']:.2f}x)  bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    return cases


def kernel_phases():
    gen = torch.Generator().manual_seed(SEED)
    cases = [
        k1_case("k1_global", 1, 12, 64, gen),  # vit_b global layers: 64x64 grid, 12 heads
        k1_case("k1_window", 25, 12, 14, gen),  # vit_b windows: 25 windows x 12 heads, 14x14
    ]
    for tier in (16, 32, 64):  # CLIP ViT-L/14 crop stack: B = 2*tier + 1
        cases.append(k2_case(f"k2_clip_tier{tier}", 2 * tier + 1, 16, 257, False, gen, packed=True))
    cases.append(k2_case("k2_causal_t384", 4, 16, 384, True, gen))  # the streamed kernel
    cases.append(k2_case("k2_t200", 4, 16, 200, False, gen))
    # the CLIP ViT-L/14 text tower: a padded batch of 256 prompts, 12 heads, 77 tokens, causal
    cases.append(k2_case("k2_text_causal_t77", 256, 12, 77, True, gen, packed=True))
    for c in cases:
        log(f"[kernel] {c['name']:18s} {c['shape']:49s} err {c['max_abs_err']:.3e} (tol {c['tol']:.3e}, "
            f"max|ref| {c['ref_max']:.3e}, rms(ref) {c['ref_rms']:.3e}, rel rms err {c['rel_rms_err']:.3e} "
            f"tol {REL_RMS_TOL:.3e}) "
            f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  library {c['library_ms']:.4f} ms  "
            f"({c['ratio_to_library']:.2f}x)  bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
        if "copy_ms" in c:
            log(f"[kernel] {c['name']}: the streamed kernel's copies of the strided q, k, v: {c['copy_ms']:.4f} ms")
        if "plan" in c:
            p = c["plan"]
            tiles = f"{p['tiles_per_block']} query tiles a block, " if "tiles_per_block" in p else ""
            log(f"[kernel] {c['name']}: {p['kernel']} kernel, {tiles}"
                f"{p['blocks_per_head']} blocks a head, {p['grid']} blocks, {p['blocks_per_sm']} blocks per SM "
                f"on {p['sms']} SMs: {p['waves']:.2f} waves")
    cases += k3_phase()
    return {c["name"]: c for c in cases}


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


def graph_path(clip, sam, text, ds, cfg, tag):
    """apps.build_map.run (the Mapper, label features, HMSGraph.build, room
    names, save) into a temporary directory, HMSGraph.load of the saved
    graph, then the fast queries, counted as one run.  K1: 12 launches a
    keyframe; K2: 24 a keyframe and 12 a padded text batch (SCANNET20's
    prompts, ROOM_TYPES', and each engine call that encodes new texts)."""
    skip = cfg.pipeline.skip_frames
    nf = len(range(0, len(ds), skip))
    Mapper(cfg, clip, sam).process_frame(ds[0])  # warm-up, outside the counted run
    tok = tokenizer()
    timer = StageTimer("cuda")
    engine_batches = []
    with tempfile.TemporaryDirectory() as tmp:
        gcfg = from_dict({**CONFIG, "main": {**CONFIG["main"], "save_path": tmp}})

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
            return built, loaded, [(q, eng.query_hierarchy(q)) for q in QUERIES]

        (built, loaded, answers), wall, launches, in_path, peak = counted(run)
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
    return dict(launches=launches, in_path=in_path, nf=nf)


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
    cases = kernel_phases()

    cfg = from_dict(CONFIG)
    qcfg_dict = copy.deepcopy(CONFIG)
    for tower in ("clip", "sam"):
        qcfg_dict["models"][tower]["quant"] = True
    qcfg = from_dict(qcfg_dict)
    t0 = time.perf_counter()
    clip, text = clip_mod.init_clip(clip_mod.VARIANTS[cfg.models.clip.type], seed=SEED, dtype=torch.bfloat16)
    sam = sam_mod.init_sam(sam_mod.VARIANTS[cfg.models.sam.type], seed=SEED + 1, dtype=torch.bfloat16)
    qclip, qsam, _, _, _ = load_models(qcfg)  # the same seeds: the int8 towers of the bf16 ones
    ds = SyntheticDataset(SyntheticScene.three_room(SEED), num_frames=FRAMES, hw=(480, 640), seed=SEED)
    for i in range(0, len(ds), cfg.pipeline.skip_frames):
        ds[i]  # render up front: data set-up is not mapping time
    log(f"[setup] bf16 and W8A8 towers + {len(ds)} rendered frames in {time.perf_counter() - t0:.2f} s")

    e_bf16, f_bf16 = tower_checks(clip, sam, ds[0])
    q8_tower_checks(qclip, qsam, ds[0], e_bf16, f_bf16)
    text_tower_check(text)
    paths = {"bf16": main_path(clip, sam, ds, cfg, "main", {"flash_attention_2d": 12, "flash_attention": 24,
                                                             "quant_matmul": 0})}
    q8_expect = {"flash_attention_2d": 12, "flash_attention": 24, "quant_matmul": 144}
    paths["w8a8"] = main_path(qclip, qsam, ds, qcfg, "w8a8", q8_expect)
    paths["w8a8 extraction, clip_qmm=pallas"] = extraction_path(
        qclip, qsam, ds, qcfg, "w8a8-pallas", q8_expect, paths["w8a8"]["ms"].keyframe_feats)
    paths["graph: build_map.run, load, queries"] = graph_path(clip, sam, text, ds, cfg, "graph")
    print(json.dumps(kernels_line(cases, paths)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
