"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the hand-written kernels (nvcc, sm_90a), one nvcc per
     source under holoagent_tpu_torch/csrc, and the native host runtime
     (native/src, the host C++ compiler at native/Makefile's flags), all
     started together, into holoagent_tpu_torch/_build;
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
     route); its head-dim-80 cases CLIP ViT-H-14's crop stack (resident)
     and a long one.  The general route's cases (GENERAL_CASES: G1 in bf16
     at head dims no tensor-core kernel is built for, 40-byte rows among
     them; G2 in float32 at head dims 16, 18, 32 and 64, K1 at 32 on the
     reference's 16 x 16 and 32 x 32 grids and SAM vit_b's float32 global
     layer and windows) are held in float32 within 2e-3 absolute plus 2e-3
     relative and within 1e-5 of max|ref|, each rejecting the same mutants
     and a plain version with single TF32 products, and in bf16 as the
     tensor-core kernels are;
  4. towers: at full width, hold the SAM and CLIP encoders through the
     kernels against the same encoders through the plain versions, in bf16
     and as W8A8 towers (CLIP in both qmm modes), the CLIP ViT-L/14 text
     tower (features of the SCANNET20 prompts), and SAM vit_h's encoder in
     bf16 and W8A8; then the NMS kernel (csrc/masks.cu) against the plain
     loop, bit for bit, on the edge cases of tests/_nms_cases.py and on the
     decoder output of SAM vit_h (bf16) and W8A8 vit_b at points_per_side
     12 and of bf16 vit_b at 4 and 32, rejecting each faulty plain version
     there (ties to the higher index, >= for >, invalid candidates that
     suppress), with the kernel, the plain loop and the host's time to
     issue each timed; then SAM 2.1 Hiera-L's attention shapes (HIERA_ROWS:
     K2 at head dim 72 on the general route, the pooling blocks with fewer
     queries than keys) held and timed as K2's cases, with the whole frame's
     total, and NMS's grid route on SAM 2.1's decoder output at
     points_per_side 32; then SAM 2's mask head (csrc/mask_head.cu) on
     SAM 2.1 Hiera-L's own decoder output, 64 prompts and a ragged 17, in
     bf16 and float32, against its plain version (MASK_HEAD_FAULTS below
     says how it is held), timed beside its bound
     (``python3 chip_smoke.py --hiera`` runs the build and this phase
     alone);
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
     extract_frames_batched over the keyframes in pairs; (sp) the stage
     spans on one traced dispatch of the tiered and of the batched path:
     no span synchronises, the spans' blocking-wait counts equal the
     trace's cudaStreamSynchronize calls inside them, no device event bears
     a span's name; (m) (e)'s
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
     each under torch.profiler; (r) the robot's online mission over (e)'s
     three_room oracle graph: memory.navgraph.build_nav_graph on the card at
     0.05 m (held equal, node order included, to the CPU build and through
     a save/load round trip), agent.GoalService over FSRQueryEngine with
     the text tower on the card (K2 held to its padded text batches) for
     (g)'s English instructions, first on the tower's own text features,
     then on (g)'s oracle ones (each goal the engine's top-1, with a
     waypoint chain), nav.Costmap.from_occupancy of the floor raster on
     the card (bit for bit the CPU's), nav.ParticleLocalizer (beam model,
     n_global 4000) converging from global initialisation along the plan,
     nav.bt_xml.XMLNavigator with DEFAULT_TREE_XML and each of the dwb, rpp
     and mppi controllers driving a unicycle through the native
     VelocityBridge FIFO while an ObstacleLayer marks an obstacle dropped
     on the plan, and the voice chain over a loopback WebSocket; (s) two
     24-keyframe sessions of the three_room walk (20k points a scan,
     backprojected on the card, B's world frame offset by a known drift)
     merged by memory.multisession.merge_sessions on the card (held to the
     drift and to the CPU merge), then agent.Relocalizer's global
     relocalization and periodic updates over B's scans; (t)
     apps.lio_bench at its defaults on the port's own build of the native
     runtime; (u) training: the first 20 steps of each fixture tower on
     the card and on the host CPU from one seeded init (losses within
     1e-3), an eager step and a CUDA graph replay of each traced with
     utils.tracing.device_trace, training.zoo.fixture_towers(retrain=True)
     at the recipe's 3000 CLIP and 6000 SAM steps in float32 (one graph
     replay a step), each held to the reference tests' learning
     thresholds; then on those towers the accuracy protocol's neural row
     (eval_protocol.run(neural=True), both layouts) and
     correctness_suite.run_suite's three_room battery and two_floor long
     queries, held to bands around the JAX package's runs and records
     (scripts/neural_reference.py); (v) every kernel wrapper refusing a
     CUDA input that requires grad, make_train_step at ViT-L/14 (bf16
     compute on float32 masters, remat, B = 32 at 224 px: at init on B =
     8 the bf16 gradients against the float32 ones leaf by leaf, with a
     control that must fail, and remat's against none; then the loss
     falls, its first value against a float32 forward) and distill_step
     on vlm-small; (w) the ViT-L/14 text
     tower at W8A8 (quantize_clip: K3 and K2's causal route) against the
     bf16 tower over 256 prompts; (x) the multi-device entry points at
     W = torch.cuda.device_count() ranks through parallel/launch.py (one
     NCCL rank a card; on a one-card machine W = 1, a real NCCL group whose
     collectives are one-rank calls, every local program at full width):
     (x1) apps.build_map.run with pipeline.sharded_mapping on (the
     ShardedMapper: DP extraction through K1 and K2, the row-sharded
     scene), its scene held bit for bit (keys, counts) to the single-device
     insert + fuse over the same FrameFeatures, the extraction's features
     to the plain path's; (x2) topk_cosine_sharded at retrieval_bench's
     gallery; (x3) prefill_sp at vlm-small and llava-tinyllama over a
     1024-token prompt against the float32 and the bf16 prefill, then the
     ContinuousBatcher with a mesh against one without; (x4)
     pipeline_apply and moe_apply against the sequential stack and the
     dense reference; (x5) make_train_step(mesh=...) at ViT-L/14, B = 32,
     against the single-device step; (y) the configurations whose
     attention the tensor-core kernels did not take, or that the card had
     not run, each through its entry points: (y1) CLIP ViT-H-14 (visual head
     dim 80) at the 3-room yaml's settings, its towers from load_models
     held against the plain ones in bf16 and W8A8, Mapper.run + finalize in
     both (K2 on the resident route at D = 80 only), build_map.run with the
     fast queries, and query_bench --slow --vlm clip over that graph; (y2)
     config/synthetic.yaml as it stands (float32 test-tiny towers: K2's
     general route), build_map.run, HMSGraph.load and the fast queries held
     to the port's CPU run of the same config, then its Mapper with the
     kernel extraction (K1 and K2 on the general route) against the plain
     extraction; (y3) CLIP ViT-B-32 and SAM vit_l, each in the Mapper; (y4)
     apps.serving_bench.run at vlm-base as (h); (y5) the ScanNet and iPhone
     layouts written by dataloader/export.py, read back through the port's
     loaders into build_map.run; (z) the float32 production Mapper:
     config/synthetic_tpu_3room.yaml with models.clip.dtype float32 (SAM
     vit_b and CLIP ViT-L/14 in float32 from load_models), Mapper.run +
     finalize with every K1 and K2 launch on the general route (G2), its
     keyframe features against the plain extraction's on the card.  A
     [time] line after each phase says when it ended.  Per-stage ms (spans timed by events on the stream,
     no synchronise) and blocking waits, frames/s or ms/keyframe, peak memory; the
     kernels' launch counts (NMS one a frame), by route for the attention
     kernels and NMS, and their device time inside each run.  Every K1, K2,
     K3 and NMS shape a path launched that no case of phase 3 or 4 held gets
     its own case before the kernels line.
Prints one JSON line of kernels, then the nvidia-smi line, then as the last
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import importlib.util
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from holoagent_tpu_torch import native, nav  # noqa: E402
from holoagent_tpu_torch.agent import GoalService, VoiceClient, WaypointNavigator  # noqa: E402
from holoagent_tpu_torch.agent.relocalizer import Relocalizer  # noqa: E402
from holoagent_tpu_torch.agent.voice_client import LoopbackVoiceServer  # noqa: E402
from holoagent_tpu_torch.apps import batch_map, build_map, eval_protocol, query_bench, retrieval_bench, serving_bench  # noqa: E402,E501
from holoagent_tpu_torch.apps import correctness_suite, lio_bench, visualize_graph  # noqa: E402
from holoagent_tpu_torch.apps.common import load_dataset, load_models, tokenizer  # noqa: E402
from holoagent_tpu_torch.config import MeshConfig, from_dict  # noqa: E402
from holoagent_tpu_torch.dataloader import RGBDFrame, SyntheticDataset, SyntheticScene  # noqa: E402
from holoagent_tpu_torch.dataloader.export import (hm3dsem_k, write_hm3dsem, write_horizon, write_iphone,  # noqa: E402
                                                   write_replica, write_scannet)
from holoagent_tpu_torch.dataloader.hm3dsem import HM3DSemDataset  # noqa: E402
from holoagent_tpu_torch.dataloader.horizon import HorizonDataset  # noqa: E402
from holoagent_tpu_torch.dataloader.iphone import IPhoneDataset  # noqa: E402
from holoagent_tpu_torch.dataloader.replica import ReplicaDataset  # noqa: E402
from holoagent_tpu_torch.dataloader.scannet import ScannetDataset  # noqa: E402
from holoagent_tpu_torch.eval import GTGraph, gt_from_synthetic  # noqa: E402
from holoagent_tpu_torch.eval.instruction_sets import three_room_instructions  # noqa: E402
from holoagent_tpu_torch.memory import checkpoint as ckpt_mod  # noqa: E402
from holoagent_tpu_torch.memory import instances as inst_mod  # noqa: E402
from holoagent_tpu_torch.memory import mapping as mapping_mod  # noqa: E402
from holoagent_tpu_torch.memory import multisession, navgraph  # noqa: E402
from holoagent_tpu_torch.memory import scene as scene_mod, sharded_scene  # noqa: E402
from holoagent_tpu_torch.memory.hmsg import HMSGraph  # noqa: E402
from holoagent_tpu_torch.memory.mapping import Mapper  # noqa: E402
from holoagent_tpu_torch.models import clip as clip_mod  # noqa: E402
from holoagent_tpu_torch.models import sam as sam_mod  # noqa: E402
from holoagent_tpu_torch.models import sam2 as sam2_mod  # noqa: E402
from holoagent_tpu_torch.models import transformer as tfm  # noqa: E402
from holoagent_tpu_torch.models import vlm as vlm_mod  # noqa: E402
from holoagent_tpu_torch.nav import bt_xml  # noqa: E402
from holoagent_tpu_torch.ops import flash_attention as fa  # noqa: E402
from holoagent_tpu_torch.ops import mask_head as mh_mod  # noqa: E402
from holoagent_tpu_torch.ops import masks as masks_mod  # noqa: E402
from holoagent_tpu_torch.ops import retrieval as retrieval_ops, solvers  # noqa: E402
from holoagent_tpu_torch.ops.backproject import backproject  # noqa: E402
from holoagent_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from holoagent_tpu_torch.ops import voxel as voxel_mod  # noqa: E402
from holoagent_tpu_torch.ops.compact import I32_MAX  # noqa: E402
from holoagent_tpu_torch.ops.voxel import GridSpec  # noqa: E402
from holoagent_tpu_torch.parallel import launch, make_mesh, moe as moe_mod, pipeline as pipeline_mod  # noqa: E402
from holoagent_tpu_torch.perception import extractor as extractor_mod  # noqa: E402
from holoagent_tpu_torch.perception.extractor import FrameFeatures, extract_frame_features_tiered  # noqa: E402
from holoagent_tpu_torch.perception.oracle import oracle_frame_features  # noqa: E402
from holoagent_tpu_torch.query import ClipVLM, FSRQueryEngine, LLMParser, ParsedQuery, RuleParser, llm_client  # noqa: E402,E501
from holoagent_tpu_torch.serving import ContinuousBatcher  # noqa: E402
from holoagent_tpu_torch.training import contrastive, distill, perception, zoo  # noqa: E402
from holoagent_tpu_torch.utils.camera import Pinhole, project  # noqa: E402
from holoagent_tpu_torch.utils.geometry import exp_se3, invert_pose, log_se3, transform_points  # noqa: E402
from holoagent_tpu_torch.utils.labels import DEFAULT_ROOM_TYPES, SCANNET_LABELS_20, load_vocabulary  # noqa: E402
from holoagent_tpu_torch.utils import timing, tracing  # noqa: E402
from holoagent_tpu_torch.utils.timing import StageTimer  # noqa: E402

# the NMS edge cases and faults the CPU tests use (by path: a machine may
# have another top-level package named "tests")
_spec = importlib.util.spec_from_file_location(
    "nms_cases", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "_nms_cases.py"))
_nms_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_nms_cases)
NMS_CASE_NAMES, NMS_FAULTS = _nms_cases.NMS_CASE_NAMES, _nms_cases.NMS_FAULTS
clustered_boxes, nms_case, nms_with_fault = _nms_cases.clustered_boxes, _nms_cases.nms_case, _nms_cases.nms_with_fault
# SAM 2's mask head: inputs at its widths and faulty plain versions, as the CPU tests use them
_spec = importlib.util.spec_from_file_location(
    "mask_head_cases", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "_mask_head_cases.py"))
_mask_head_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mask_head_cases)

# H100 SXM published peaks (dense tensor cores: bf16, int8, TF32; HBM3).
# The general route's float32 kernel (G2) takes each product as three TF32
# products (3xTF32), so its bound is a float32 operation at a third of the
# TF32 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
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
# The general route in float32 (float scores, sums and output on both
# sides): every output within 2e-3 absolute plus 2e-3 relative of the plain
# version, the reference's own float32 attention tolerance
# (tests/test_flash_attention.py), and the same mutants rejected.  In bf16
# it is held as the tensor-core kernels are (the output's own rounding is
# 2^-8 relative).
F32_ATOL = F32_RTOL = 2e-3
# and to float32's own precision: max|out - ref| <= 1e-5 max|ref|.  The
# float32 kernel takes its products as 3xTF32 (relative error about 2^-21 a
# product, float32 sums); a kernel that took them as one TF32 product (about
# 2^-11) fails it by more than an order of magnitude, and each float32 case
# must reject such a plain version (q, k, v and P rounded to TF32).
F32_PREC = 1e-5
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
TYPE_NAMES = fa.TYPE_NAMES  # the dtype's name in a launch's trace key
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


DEFERRED = []  # accuracy gates of (u) that failed: raised once (u)-(w) have run, so one run shows them all


def check_accuracy(cond: bool, msg: str) -> None:
    """An accuracy gate: a miss is printed at once and fails the script
    after the training phases, which still run and report."""
    if not cond:
        log(f"[gate] MISSED: {msg}")
        DEFERRED.append(msg)


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


def agreement(out, ref, f32: bool = False) -> dict:
    """The bf16 gate's numbers; with `f32` the float32 gate's: `tol` is
    F32_ATOL and `close` the largest |out - ref| / (F32_ATOL + F32_RTOL
    |ref|), at most 1 to pass."""
    d, r = out.float() - ref.float(), ref.float()
    ref_max, ref_rms = r.abs().max().item(), r.pow(2).mean().sqrt().item()
    a = dict(max_abs_err=d.abs().max().item(), tol=MAX_ERR_OF_MAX * ref_max, ref_max=ref_max,
             ref_rms=ref_rms, rel_rms_err=d.pow(2).mean().sqrt().item() / ref_rms)
    if f32:
        a.update(tol=F32_ATOL, close=(d.abs() / (F32_ATOL + F32_RTOL * r.abs())).max().item(),
                 prec=a["max_abs_err"] / ref_max)
    return a


def agrees(a: dict) -> bool:
    if "close" in a:
        return a["close"] <= 1.0 and a["prec"] <= F32_PREC
    return a["max_abs_err"] <= a["tol"] and a["rel_rms_err"] <= REL_RMS_TOL


def hold(name: str, out, ref, mutants, f32: bool = False) -> dict:
    """Hold a kernel's output against its plain version, at the bf16 gate or
    (`f32`) the float32 one; the test must also reject each mutant (a plain
    version computed with a deliberate fault)."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    a = agreement(out, ref, f32)
    gate = (f"|err| <= {F32_ATOL} + {F32_RTOL} |ref| and max|err| <= {F32_PREC} max|ref|" if f32
            else f"max_abs_err <= tol, rel_rms_err <= {REL_RMS_TOL}")
    check(agrees(a), f"{name}: {a} exceeds {gate}")
    for what, bad in mutants:
        m = agreement(bad, ref, f32)
        check(not agrees(m), f"{name}: the test would pass a plain version with {what}: {m}")
        log(f"[kernel] {name}: rejects a plain version with {what}: err {m['max_abs_err']:.3e} "
            f"(tol {m['tol']:.3e}), rel rms err {m['rel_rms_err']:.3e}"
            + (f", err / (atol + rtol |ref|) {m['close']:.3e}, max|err| / max|ref| {m['prec']:.3e}" if f32 else ""))
    return a


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero: cvt.rna.tf32.f32) by bit mask."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_ref(q, k, v, bias=None, causal=False):
    """The plain float32 attention with q, k, v and P rounded to TF32: what a
    kernel taking each product as a single TF32 product computes (a mutant
    the float32 precision gate must reject).  `bias`: K1's (bias_h, bias_w,
    (h, w))."""
    t, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(tf32(q), tf32(k).transpose(-1, -2)) * d**-0.5
    if bias is not None:
        bias_h, bias_w, (h, w) = bias
        s = (s.reshape(-1, t, h, w) + bias_h[..., :, None] + bias_w[..., None, :]).reshape(s.shape)
    if causal:
        idx = torch.arange(t, device=q.device)
        s = s.masked_fill(idx[None, :] > idx[:, None], fa.NEG_INF)
    return torch.matmul(tf32(torch.softmax(s, dim=-1)), tf32(v))


def attention_plan(kernel: str, route: str, bh: int, n: int, grid_hw=None, causal: bool = False, d: int = 64,
                   dtype=torch.bfloat16) -> dict:
    """The launch plan of an attention route: the resident kernel's or the
    general kernels' (with the blocks per SM and what limits them), or the
    global kernel's.  `grid_hw`: K1's grid."""
    if route == "resident":
        return resident_plan_report(fa.resident_plan(bh, n, sum(grid_hw or (0,)), causal=causal, d=d), bh)
    if route == "general":
        p = fa.general_plan(bh, n, d, dtype, grid_hw=grid_hw, causal=causal)
        grid = fa.general_grid(bh, n, d, dtype)
        check(all(p[f] == v for f, v in grid.items()), f"general_plan {p} against general_grid {grid}")
        name = "G1 (bf16, mma.sync)" if dtype == torch.bfloat16 else "G2 (float32, 3xTF32 mma.sync)"
        return resident_plan_report(p, bh, name)
    p = fa.global_plan(bh, n, rel_pos=kernel == "flash_attention_2d", d=d)
    bias = "" if kernel == "flash_attention_2d" else ", no bias"
    return dict(p, kernel=f"global (TMA + wgmma{bias})", waves=p["grid"] / (p["blocks_per_sm"] * p["sms"]))


def k1_inputs(b, heads, g, gen, d=64, dtype=torch.bfloat16):
    """K1's inputs on a g x g grid: q, k, v as the (B, heads, N, D) views of
    one (B, N, 3C) projection that _attention_2d makes, bias (B*heads, N, g)
    f32."""
    n = g * g
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen).to("cuda", dtype)
    q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    bias_h = (0.5 * torch.randn(b * heads, n, g, generator=gen)).cuda()
    bias_w = (0.5 * torch.randn(b * heads, n, g, generator=gen)).cuda()
    return q, k, v, bias_h, bias_w


def k1_case(name, b, heads, g, gen, d=64, dtype=torch.bfloat16):
    """One K1 shape (k1_inputs)."""
    n = g * g
    bh = b * heads
    f32 = dtype == torch.float32
    q, k, v, bias_h, bias_w = k1_inputs(b, heads, g, gen, d, dtype)
    route = fa.k1_route(g, g, d, dtype)
    out = fa.flash_attention_2d(q, k, v, bias_h, bias_w, (g, g))
    ref = fa.flash_attention_2d_ref(q, k, v, bias_h, bias_w, (g, g))
    no_row0, no_bias_h, no_bias_w = bias_h.clone(), bias_h.clone(), bias_w.clone()
    no_row0[..., 0] = fa.NEG_INF  # the keys of grid row 0: half a 128-key tile at g=64
    no_bias_h[0, :64] = 0.0
    no_bias_w[0, :64] = 0.0
    mutants = [
        ("the keys of grid row 0 dropped", fa.flash_attention_2d_ref(q, k, v, no_row0, bias_w, (g, g))),
        ("bias_h dropped on one query tile", fa.flash_attention_2d_ref(q, k, v, no_bias_h, bias_w, (g, g))),
        ("bias_w dropped on one query tile", fa.flash_attention_2d_ref(q, k, v, bias_h, no_bias_w, (g, g))),
    ]
    if f32:
        mutants.append(("single TF32 products", tf32_ref(q, k, v, (bias_h, bias_w, (g, g)))))
    res = hold(name, out, ref, mutants, f32=f32)
    res["plan"] = attention_plan("flash_attention_2d", route, bh, n, (g, g), d=d, dtype=dtype)
    mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, heads, n, n).to(dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res.update(
        kernel="flash_attention_2d", key=(b, heads, g, g, d, TYPE_NAMES[dtype]), name=name, route=route,
        shape=f"B={b} H={heads} N={n} h=w={g} D={d} packed qkv {TYPE_NAMES[dtype]}",
        ms=time_ms(lambda: fa.flash_attention_2d(q, k, v, bias_h, bias_w, (g, g))),
        plain_ms=time_ms(lambda: fa.flash_attention_2d_ref(q, k, v, bias_h, bias_w, (g, g)), samples=5, reps=2),
        library_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
    )
    flops = 4.0 * n * n * d * bh
    nbytes = 4 * bh * n * d * q.element_size() + bh * n * 2 * g * 4
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes, PEAK_F32_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS)
    res["ratio_to_library"] = res["ms"] / res["library_ms"]
    del mask
    return res


def k2_inputs(b, h, t, gen, packed=False, d=64, dtype=torch.bfloat16):
    """K2's q, k, v (B, H, T, D): with `packed` the views of one (B, T,
    3*H*D) projection that _attend makes, else contiguous tensors."""
    if packed:
        qkv = torch.randn(b, t, 3 * h * d, generator=gen).to("cuda", dtype)
        return tuple(z.reshape(b, t, h, d).transpose(1, 2) for z in qkv.split(h * d, dim=-1))
    return tuple(torch.randn(b, h, t, d, generator=gen).to("cuda", dtype) for _ in range(3))


def k2_case(name, b, h, t, causal, gen, packed=False, d=64, dtype=torch.bfloat16):
    """One K2 shape at head dim `d` in `dtype`.  packed: q, k, v are the (B,
    H, T, D) views of one (B, T, 3*H*D) projection that _attend makes (token
    stride 3*H*D, head stride D), the layout the towers launch, and the call
    must allocate nothing but its output; else contiguous tensors."""
    f32 = dtype == torch.float32
    q, k, v = k2_inputs(b, h, t, gen, packed, d, dtype)
    route = fa.k2_route(t, causal, d, dtype)
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
    if f32:
        mutants.append(("single TF32 products", tf32_ref(q, k, v, causal=causal)))
    res = hold(name, out, ref, mutants, f32=f32)
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
    res["plan"] = attention_plan("flash_attention", route, b * h, t, causal=causal, d=d, dtype=dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res.update(
        kernel="flash_attention", key=(b, h, t, d, causal, TYPE_NAMES[dtype]), name=name, route=route,
        shape=f"B={b} H={h} T={t} D={d} causal={causal} {'packed qkv' if packed else 'contiguous'} "
              f"{TYPE_NAMES[dtype]}",
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=causal)),
        plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v, causal=causal), samples=5, reps=2),
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=causal)),
    )
    pairs = t * (t + 1) / 2 if causal else t * t  # key/query pairs this input needs
    res["bound_ms"], res["bound_by"] = bound(4.0 * pairs * d * b * h, 4 * b * h * t * d * q.element_size(),
                                             PEAK_F32_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS)
    res["ratio_to_library"] = res["ms"] / res["library_ms"]
    return res


def resident_plan_report(p, bh, kernel="resident") -> dict:
    """A resident or general kernel's plan for `bh` heads with its grid,
    waves and what limits its blocks an SM."""
    grid = p["blocks_per_head"] * bh
    regs, smem = p["blocks_by_regs"], p["blocks_by_smem"]
    limit = "registers and shared memory alike" if regs == smem else "registers" if regs < smem else "shared memory"
    return dict(p, kernel=kernel, grid=grid, waves=grid / (p["blocks_per_sm"] * p["sms"]), limit=limit)


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
    # head dim 80 (CLIP ViT-H-14's visual tower: width 1280, 16 heads): its
    # tier-16 crop stack on the resident route, and the long route
    cases.append(k2_case("k2_vit_h14_tier16", 33, 16, 257, False, gen, packed=True, d=80))
    cases.append(k2_case("k2_d80_t600", 4, 16, 600, False, gen, packed=True, d=80))
    cases += [general_case(row, gen) for row in GENERAL_CASES]
    for c in cases:
        log_attention_case(c)
    cases += k3_phase()
    return {c["name"]: c for c in cases}


# The general route's cases: (name, kernel, B, heads, T or the grid's side,
# head dim, causal, dtype, packed).  bf16 (G1) where no tensor-core kernel
# is instantiated: head dim 16 (config/synthetic.yaml's text batch, 256
# prompts, 4 heads, the text tower computing in bf16 as the reference's
# does), 32, 80 with causal, K1 at 32, and head dim 20 (40-byte rows: the
# staging without 16-byte copies).  float32 (G2) at head dims 16, 32 and 64,
# causal or not (a float32 ViT-L/14 crop stack among them), 18 (72-byte
# rows), the reference's K1 test shapes (head dim 32, 16 x 16 and 32 x 32
# grids) and SAM vit_b's float32 global layer and windows.
BF16, F32 = torch.bfloat16, torch.float32
GENERAL_CASES = (
    ("k2_text_tiny_causal_t77", "k2", 256, 4, 77, 16, True, BF16, True),
    ("k2_bf16_d32_t257", "k2", 8, 2, 257, 32, False, BF16, True),
    ("k2_bf16_d80_causal_t257", "k2", 4, 16, 257, 80, True, BF16, True),
    ("k2_bf16_d20_causal_t77", "k2", 64, 4, 77, 20, True, BF16, True),
    ("k1_bf16_d32_g16", "k1", 1, 3, 16, 32, False, BF16, True),
    ("k2_f32_d16_causal_t77", "k2", 64, 4, 77, 16, True, F32, True),
    ("k2_f32_d16_t257", "k2", 8, 4, 257, 16, False, F32, True),
    ("k2_f32_d32_causal_t384", "k2", 4, 16, 384, 32, True, F32, False),
    ("k2_f32_d32_t600", "k2", 4, 16, 600, 32, False, F32, True),
    ("k2_f32_d64_tier16", "k2", 33, 16, 257, 64, False, F32, True),
    ("k2_f32_d64_causal_t600", "k2", 4, 16, 600, 64, True, F32, True),
    ("k2_f32_d18_causal_t77", "k2", 64, 4, 77, 18, True, F32, True),
    ("k1_f32_d32_g16", "k1", 1, 3, 16, 32, False, F32, True),
    ("k1_f32_d32_g32", "k1", 1, 3, 32, 32, False, F32, True),
    ("k1_f32_sam_global", "k1", 1, 12, 64, 64, False, F32, True),
    ("k1_f32_sam_window", "k1", 25, 12, 14, 64, False, F32, True),
)


def general_case(row, gen):
    """One GENERAL_CASES row through k1_case or k2_case."""
    name, kernel, b, h, t, d, causal, dtype, packed = row
    if kernel == "k1":
        return k1_case(name, b, h, t, gen, d=d, dtype=dtype)
    return k2_case(name, b, h, t, causal, gen, packed=packed, d=d, dtype=dtype)


def log_attention_case(c) -> None:
    gate = (f"err / (atol + rtol |ref|) {c['close']:.3e}, limit 1; max|err| / max|ref| {c['prec']:.3e}, limit "
            f"{F32_PREC:.0e}" if "close" in c else
            f"rel rms err {c['rel_rms_err']:.3e} tol {REL_RMS_TOL:.3e}")
    log(f"[kernel] {c['name']:23s} {c['shape']:49s} err {c['max_abs_err']:.3e} (tol {c['tol']:.3e}, "
        f"max|ref| {c['ref_max']:.3e}, rms(ref) {c['ref_rms']:.3e}, {gate}) route {c['route']} "
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
    occupancy = (f", {p['blocks_per_sm']} blocks per SM on {p['sms']} SMs: {p['waves']:.2f} waves"
                 if "blocks_per_sm" in p else "")
    log(f"[kernel] {c['name']}: {p['kernel']} kernel, {tiles}"
        f"{p['blocks_per_head']} blocks a head, {p['grid']} blocks{occupancy}{limit}")


# ---------------------------------------------------------------------------
# NMS: ops/masks.py::nms -> csrc/masks.cu
# ---------------------------------------------------------------------------

# The kernel computes the plain loop's keep mask operation for operation
# (the stable order, box_iou's float32 arithmetic with IEEE division, the
# strict threshold), so a case passes only with no keep flag differing from
# the plain loop on the CPU (the function the CPU tests hold to the JAX
# package) and on the card.  The check must reject each faulty plain version
# of tests/_nms_cases.py: ties to the higher index, >= for >, and invalid
# candidates that suppress.  Its bound is latency, not bytes or operations:
# a launch and the greedy scan's chain (`bound_ms` is the larger of the
# IoUs' float32 operations at PEAK_F32_FLOPS and the bytes, for the table).
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
IOU_FLOPS = 19  # ops/masks.py::box_iou for one pair


def host_ms(fn, n: int = 20) -> float:
    """The host's time to issue one call (no synchronise inside the count)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return 1e3 * t


def nms_case_run(name, boxes, scores, valid, thresh, held):
    """Hold the kernel against the plain loop, bit for bit, and time it;
    the inputs and the keep mask go into `held` for the faults' check."""
    boxes, scores, valid = boxes.cpu(), scores.cpu(), valid.cpu()
    m = boxes.shape[0]
    route = masks_mod.nms_route(m)
    args = (boxes.cuda(), scores.cuda(), valid.cuda(), thresh)
    n0, r0 = masks_mod.nms.launches, masks_mod.nms.routes[route]
    keep = masks_mod.nms(*args)
    torch.cuda.synchronize()
    check((masks_mod.nms.launches, masks_mod.nms.routes[route]) == (n0 + 1, r0 + 1), f"{name}: not one {route} launch")
    ref = masks_mod.nms_ref(boxes, scores, valid, thresh)
    differing = int((keep.cpu() != ref).sum())
    card_differing = int((masks_mod.nms_ref(*args).cpu() != ref).sum())
    check(keep.dtype == torch.bool and differing == 0, f"{name}: {differing} of {m} keep flags differ")
    check(card_differing == 0, f"{name}: the plain loop on the card differs from the CPU's in {card_differing} flags")
    held[name] = ((boxes, scores, valid, thresh), ref)
    res = dict(kernel="nms", key=(m,), name=name, shape=f"M={m}", route=route, valid=int(valid.sum()),
               kept=int(ref.sum()), outputs_differing=differing, max_abs_err=0.0,
               ms=time_ms(lambda: masks_mod.nms(*args)),
               plain_ms=time_ms(lambda: masks_mod.nms_ref(*args), samples=3, reps=1),
               host_ms=host_ms(lambda: masks_mod.nms(*args)),
               plain_host_ms=host_ms(lambda: masks_mod.nms_ref(*args), n=3), library_ms=None)
    res["bound_ms"], res["bound_by"] = bound(IOU_FLOPS * m * (m - 1) / 2, 22.0 * m, PEAK_F32_FLOPS)
    log(f"[kernel] {name:28s} M={m:<5d} {route:5s}: {res['valid']} valid, {res['kept']} kept, {differing} flags "
        f"differ (the card's plain loop: {card_differing}); kernel {res['ms']:.4f} ms  plain {res['plain_ms']:.4f} "
        f"ms; host {1e3 * res['host_ms']:.1f} us a call (plain {res['plain_host_ms']:.3f} ms)  bound "
        f"{res['bound_ms']:.2e} ms ({res['bound_by']})")
    return res


def decoder_nms_inputs(sam, frame, pps: int):
    """The arguments generate_masks gives NMS on one frame at
    `points_per_side` (the benchmark's accept-all gates: random towers fail
    trained ones)."""
    seen = []

    def rec(boxes, scores, valid, iou_thresh=0.7):
        seen.append((boxes.clone(), scores.clone(), valid.clone(), iou_thresh))
        return masks_mod.nms(boxes, scores, valid, iou_thresh)

    # SAM's view of ops/masks.py with NMS recorded (the wrapper itself stays)
    sam_mod.mask_ops = types.SimpleNamespace(**{**vars(masks_mod), "nms": rec})
    try:
        sam_mod.generate_masks(sam, torch.as_tensor(frame.rgb, dtype=torch.float32).cuda(), points_per_side=pps,
                               pred_iou_thresh=-10.0, stability_thresh=0.0, max_masks=16, impl="flash")
    finally:
        sam_mod.mask_ops = masks_mod
    check(len(seen) == 1 and seen[0][0].shape == (3 * pps * pps, 4), f"{sam.variant.name} pps {pps}: NMS inputs")
    return seen[0]


def nms_phase(towers, frame) -> dict:
    """The NMS kernel against the plain loop on tests/_nms_cases.py's edge
    cases and on the decoder output of each (name, sam, points_per_side) of
    `towers`; every fault rejected on some case."""
    held, cases = {}, []
    for name in NMS_CASE_NAMES:
        boxes, scores, valid, thresh = nms_case(name, seed=SEED)
        cases.append(nms_case_run(f"nms_{name}", torch.from_numpy(boxes), torch.from_numpy(scores),
                                  torch.from_numpy(valid), thresh, held))
    for name, sam, pps in towers:
        cases.append(nms_case_run(f"nms_{name}_pps{pps}", *decoder_nms_inputs(sam, frame, pps), held))
    for fault in NMS_FAULTS:
        rejected = [name for name, (inputs, keep) in held.items() if not torch.equal(nms_with_fault(*inputs, fault),
                                                                                     keep)]
        check(bool(rejected), f"NMS: the check would pass a plain version with {fault}")
        log(f"[kernel] NMS: rejects a plain version with {fault} on {len(rejected)} of {len(held)} cases "
            f"({', '.join(rejected)})")
    return {c["name"]: c for c in cases}


# ---------------------------------------------------------------------------
# SAM 2.1 Hiera-L's attention: K2 at head dim 72, pooled queries
# ---------------------------------------------------------------------------

# Every attention shape of the Hiera-L trunk over a 1024 x 1024 frame:
# (name, windows, heads, Tq, Tk, blocks a frame).  The pooling blocks' queries
# are pooled 2x2 inside the window (Tq = Tk / 4); the global blocks attend
# over the 64 x 64 grid.  All take K2's general route, G1 at DM = 80.
HIERA_ROWS = (
    ("hiera_s1_w8", 1024, 2, 64, 64, 2),  # blocks 0-1
    ("hiera_pool_b2", 1024, 4, 16, 64, 1),  # block 2: 256^2 -> 128^2
    ("hiera_s2_w4", 1024, 4, 16, 16, 5),  # blocks 3-7
    ("hiera_pool_b8", 1024, 8, 4, 16, 1),  # block 8: 128^2 -> 64^2
    ("hiera_s3_w16", 16, 8, 256, 256, 32),  # blocks 9-43 but the global ones
    ("hiera_s3_global", 1, 8, 4096, 4096, 3),  # blocks 23, 33, 43
    ("hiera_pool_b44", 16, 16, 64, 256, 1),  # block 44: 64^2 -> 32^2
    ("hiera_s4_w8", 16, 16, 64, 64, 3),  # blocks 45-47
)
HIERA_D = 72


def hiera_case(name, b, h, tq, tk, gen):
    """One Hiera attention shape in the layout models/sam2.py launches: k
    and v the (B, H, Tk, D) views of the block's (B, Tk, 3 H D) qkv
    projection, q the same view or (pooling blocks) the (B, H, Tq, D) view of
    the pooled (B, Tq, H D) queries.  Held as K2's other bf16 cases are."""
    d = HIERA_D
    qkv = torch.randn(b, tk, 3 * h * d, generator=gen).to("cuda", torch.bfloat16)
    q, k, v = (z.reshape(b, tk, h, d).transpose(1, 2) for z in qkv.split(h * d, dim=-1))
    if tq != tk:
        side = int(round(tk ** 0.5))
        q = sam2_mod.pool2x2(qkv[..., : h * d].reshape(b, side, side, h * d)).reshape(b, tq, h, d).transpose(1, 2)
    n0 = fa.flash_attention.pooled
    out = fa.flash_attention(q, k, v)
    check(fa.flash_attention.pooled == n0 + (tq != tk), f"{name}: not counted as a pooled-query launch")
    ref = fa.flash_attention_ref(q, k, v)
    v_bad = v.clone()
    v_bad[:, :, :64] = 0
    res = hold(name, out, ref, [
        ("the values of the first 64-key tile dropped", fa.flash_attention_ref(q, k, v_bad)),
        ("the key mask shifted by one (key Tk - 1 dropped)", fa.flash_attention_ref(q, k[:, :, :-1], v[:, :, :-1]))])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res.update(
        kernel="flash_attention", key=(b, h, tq, d, False, "bf16") + ((tk,) if tk != tq else ()), name=name,
        route="general", shape=f"B={b} H={h} Tq={tq} Tk={tk} D={d} qkv views bf16",
        plan=attention_plan("flash_attention", "general", b * h, tq, d=d),
        ms=time_ms(lambda: fa.flash_attention(q, k, v)),
        plain_ms=time_ms(lambda: fa.flash_attention_ref(q, k, v), samples=5, reps=2),
        library_ms=time_ms(lambda: sdpa(q, k, v)),
    )
    res["bound_ms"], res["bound_by"] = bound(4.0 * tq * tk * d * b * h, 2 * b * h * (tq + tk) * d * 2,
                                             PEAK_BF16_FLOPS)
    res["ratio_to_library"] = res["ms"] / res["library_ms"]
    return res


def hiera_in_run(sam2, frames) -> dict:
    """Mean ms a launch, by wrapper and shape key, of K2, NMS and the mask head inside
    ``generate_masks`` with SAM 2.1 over `frames` at points_per_side 32 (CUDA
    events around each launch: the in-run time, the wrapper's host time in
    it for short kernels)."""
    runs = collections.defaultdict(list)
    traced = (fa.flash_attention, masks_mod.nms, mh_mod.mask_head)
    for w in traced:
        w.trace = []
    try:
        for f in frames:
            sam_mod.generate_masks(sam2, torch.as_tensor(f.rgb, dtype=torch.float32).cuda(), points_per_side=32,
                                   pred_iou_thresh=-10.0, stability_thresh=0.0, impl="flash")
        torch.cuda.synchronize()
        for w in traced:
            for key, a, b in w.trace:
                runs[(w.__name__,) + tuple(key)].append(a.elapsed_time(b))
    finally:
        for w in traced:
            w.trace = None
    return {k: statistics.mean(v) for k, v in runs.items()}


def hiera_phase(sam2, frame, frames=()) -> dict:
    """Hiera-L's attention rows (HIERA_ROWS), the whole frame's total
    (each row's time times its blocks; kept under the kernel name "hiera",
    which no wrapper has), and the NMS grid route on `sam2`'s (SAM 2.1
    Hiera-L's) decoder output at points_per_side 32 (3,072 candidates), the
    mask head's cases (``mask_head_phase``); with `frames`, each row's
    in-run time over SAM 2.1's mask generation on them."""
    gen = torch.Generator().manual_seed(SEED)
    cases = {}
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, launches=0)
    for name, b, h, tq, tk, blocks in HIERA_ROWS:
        c = hiera_case(name, b, h, tq, tk, gen)
        c["launches_a_frame"] = blocks
        log_attention_case(c)
        cases[name] = c
        for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
            total[f] += blocks * c[f]
        total["launches"] += blocks
    log(f"[kernel] hiera whole frame: {total['launches']} launches, kernel {total['ms']:.4f} ms  plain "
        f"{total['plain_ms']:.4f} ms  library {total['library_ms']:.4f} ms ({total['ms'] / total['library_ms']:.2f}x)"
        f"  bound {total['bound_ms']:.4f} ms: {100 * total['bound_ms'] / total['ms']:.1f}% of bound")
    cases["hiera_whole_frame"] = dict(kernel="hiera", name="hiera_whole_frame", key=("hiera_whole_frame",), **total)
    cases.update({c["name"]: c for c in [nms_case_run("nms_sam2_hiera_l_pps32", *decoder_nms_inputs(sam2, frame, 32),
                                                      {})]})
    check(cases["nms_sam2_hiera_l_pps32"]["route"] == "grid", "SAM 2's 3,072 candidates take NMS's grid route")
    cases.update(mask_head_phase(sam2, frame))
    if frames:
        in_run = hiera_in_run(sam2, frames)
        for c in cases.values():
            ms = in_run.get((c["kernel"],) + tuple(c["key"]))
            if ms is not None:
                c["in_run_ms"] = ms
                log(f"[kernel] {c['name']}: {ms:.4f} ms a launch in SAM 2.1's mask generation over {len(frames)} frames")
        check(all("in_run_ms" in cases[name] for name, *_ in HIERA_ROWS), "a Hiera row not launched in the run")
        check("in_run_ms" in cases["mask_head_p64_bf16"], "the mask head's 64-prompt pass not launched in the run")
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# SAM 2's mask head (csrc/mask_head.cu)
# ---------------------------------------------------------------------------

# The kernel against its plain version (ops/mask_head.py::mask_head_ref) on
# SAM 2.1 Hiera-L's own decoder output.  In bf16 at K1/K2's rule
# (MAX_ERR_OF_MAX, REL_RMS_TOL), for the same reason: both take bf16 tokens,
# features and weights and sum in float32, and the plain version rounds each
# of its steps to bf16 (8 significant bits: one ulp is at most 2^-7 of a
# value) where the kernel rounds only after each GELU, so they part by the
# plain version's own roundings, under one ulp rms.  That rule rejects
# LayerNorm skipped on one sub-pixel and feat_s0 dropped.  The tanh GELU in
# place of the erf one moves a value by less than bf16's rounding and passes
# it (printed); the float32 cases hold it: there both sum in float32 and the
# kernel is held to float32's precision (F32_PREC of max|ref|), which
# rejects all three.
MASK_HEAD_FAULTS = _mask_head_cases.MASK_HEAD_FAULTS


def mask_head_cost(p: int, g: int, dtype):
    """(operations, bytes) of one launch: the two upscaling products and the
    hypernetwork product; the tokens, features, weights and hypernetwork
    vectors read once and the float32 logits written once."""
    ops = 2.0 * p * g * g * (256 * 256 + 4 * 64 * 128 + 16 * 32 * 4)
    elems = p * g * g * 256 + 16 * g * g * 32 + 4 * g * g * 64 + 4 * 256 * 64 + 4 * 64 * 32 + 3 * 64 + 32 + p * 4 * 32
    return ops, elems * dtype.itemsize + p * 4 * 16 * g * g * 4


def mask_head_case(name, a, f32: bool) -> dict:
    """Hold one launch against the plain version (the faults as
    MASK_HEAD_FAULTS says), and time kernel and plain version."""
    eps, args = sam2_mod.LN_EPS, [a[k] for k in _mask_head_cases.ARGS]
    p, g, dt = a["src"].shape[0], a["src"].shape[1], a["src"].dtype
    n0 = mh_mod.mask_head.launches
    out = mh_mod.mask_head(*args, eps)
    check(mh_mod.mask_head.launches == n0 + 1, f"{name}: not one launch")
    ref = mh_mod.mask_head_ref(*args, eps)
    faults = [f for f in MASK_HEAD_FAULTS if f32 or f != "tanh_gelu"]
    res = hold(name, out, ref, [(f.replace("_", " "), _mask_head_cases.faulty_head(a, eps, f)) for f in faults], f32)
    if not f32:
        m = agreement(_mask_head_cases.faulty_head(a, eps, "tanh_gelu"), ref)
        log(f"[kernel] {name}: the tanh GELU moves the logits by {m['max_abs_err']:.3e} (tol {m['tol']:.3e}), rel "
            f"rms {m['rel_rms_err']:.3e}: under bf16's rounding, held by the float32 cases")
    ops, nbytes = mask_head_cost(p, g, dt)
    res.update(kernel="mask_head", key=(p, g, TYPE_NAMES[dt]), name=name, shape=f"P={p} g={g} {TYPE_NAMES[dt]}",
               ms=time_ms(lambda: mh_mod.mask_head(*args, eps, out)),
               plain_ms=time_ms(lambda: mh_mod.mask_head_ref(*args, eps), samples=5, reps=2), library_ms=None)
    res["bound_ms"], res["bound_by"] = bound(ops, nbytes, PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
    log(f"[kernel] {name:22s} P={p:<3d} g={g} {TYPE_NAMES[dt]:4s}: kernel {res['ms']:.4f} ms  plain "
        f"{res['plain_ms']:.4f} ms ({res['plain_ms'] / res['ms']:.1f}x)  bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}): {100 * res['bound_ms'] / res['ms']:.1f}% of bound; max err {res['max_abs_err']:.3e} "
        f"(tol {res['tol']:.3e}), rel rms {res['rel_rms_err']:.3e}")
    return res


def decoder_head_inputs(sam2, frame) -> dict:
    """The arguments SAM 2.1's decoder gives the mask head in its first pass
    (64 prompts) over `frame` at points_per_side 32."""
    seen = []

    def rec(*a):
        if not seen:
            seen.append([t.clone() for t in a[:len(_mask_head_cases.ARGS)]])
        return mh_mod.mask_head(*a)

    sam2_mod.mask_head = rec
    try:
        with torch.no_grad():
            feats = sam2.image_features(torch.as_tensor(frame.rgb, dtype=torch.float32).cuda()[None], "flash")[0]
            sam2.decode_grid(feats, 32)
    finally:
        sam2_mod.mask_head = mh_mod.mask_head
    return dict(zip(_mask_head_cases.ARGS, seen[0]))


def mask_head_phase(sam2, frame) -> dict:
    """The mask head on SAM 2.1 Hiera-L's first decoder pass over `frame`:
    its 64 prompts and the first 17 (a ragged pass), each in bf16 and with
    every input cast to float32."""
    a = decoder_head_inputs(sam2, frame)
    cases = {}
    for p in (64, 17):
        for dt in (torch.bfloat16, torch.float32):
            name = f"mask_head_p{p}_{TYPE_NAMES[dt]}"
            cases[name] = mask_head_case(name, {k: (v[:p] if k in ("src", "hyper") else v).to(dt).contiguous()
                                                for k, v in a.items()}, dt == torch.float32)
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# towers and main paths
# ---------------------------------------------------------------------------

WRAPPERS = {"flash_attention_2d": fa.flash_attention_2d, "flash_attention": fa.flash_attention,
            "quant_matmul": qm.quant_matmul, "nms": masks_mod.nms, "mask_head": mh_mod.mask_head}


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
    v = text.variant
    log(f"[towers] CLIP {v.name} text tower ({v.t_layers} layers, width {v.t_width}, {v.t_heads} heads) flash vs "
        f"plain on the SCANNET20 prompts: "
        f"min cosine {cos:.6f}; a batch of 256 prompts through the kernels: {batch_ms:.3f} ms of device time, "
        f"{wall_ms:.3f} ms of wall time (synchronised)")
    check(cos > TEXT_COS_MIN, "CLIP text tower through K2 disagrees with the plain version")


def counted(run):
    """Set every launch count to 0 and start tracing, call `run`, then read
    the counts (the attention kernels' by route too) and each launch's
    device time (CUDA events)."""
    for w in WRAPPERS.values():
        w.launches, w.trace = 0, []
        for r in getattr(w, "routes", {}):
            w.routes[r] = 0
    fa.flash_attention.pooled = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    # and the attention kernels' launches by route, as "<wrapper>.<route>"
    launches.update({f"{name}.{r}": n for name, w in WRAPPERS.items() for r, n in getattr(w, "routes", {}).items()})
    launches["flash_attention.pooled"] = fa.flash_attention.pooled  # K2's launches with fewer queries than keys
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
        log(f"[{tag}] stage {name:18s} {v:10.3f} ms total  {v / timer.calls[name]:9.3f} ms/call (event-timed)  "
            f"{timer.calls[name + timing.SYNC]} blocking waits")
    log(f"[{tag}] clip tiers per frame: {timer.notes['tier']}")
    log(f"[{tag}] max_memory_allocated {peak / 2**30:.3f} GiB")
    log(f"[{tag}] launches {launches}")
    for name, runs in in_path.items():
        for key, (n, t) in runs.items():
            log(f"[{tag}] {name} {key}: {n} launches, {t:.4f} ms in the run ({t / n:.4f} ms/launch)")
    for name, per in expect.items():
        check(launches[name] == per * nf, f"{tag}: {name} launches {launches[name]} != {per} x {nf}")


def mapping_frames():
    """The main paths' walk: FRAMES posed 640x480 frames of the three-room
    scene, the keyframes rendered up front (data set-up is not mapping
    time)."""
    ds = SyntheticDataset(SyntheticScene.three_room(SEED), num_frames=FRAMES, hw=(480, 640), seed=SEED)
    for i in range(0, len(ds), CONFIG["pipeline"]["skip_frames"]):
        ds[i]
    return ds


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
    return dict(launches=launches, in_path=in_path, nf=nf, ms=ms, wall=wall, stages=dict(timer.ms), peak=peak)


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


def graph_path(clip, sam, text, ds, cfg, tag, save_path, cfg_dict=CONFIG):
    """apps.build_map.run (the Mapper, label features, HMSGraph.build, room
    names, save) at `cfg_dict`'s settings into `save_path`, HMSGraph.load of
    the saved graph, then the fast queries, counted as one run.  K1 and K2:
    `launches_a_keyframe` (12 and 24 at the 3-room yaml's towers); K2 also a
    text-tower depth for each padded text batch (SCANNET20's prompts,
    ROOM_TYPES', and each engine call that encodes new texts)."""
    skip = cfg.pipeline.skip_frames
    nf = len(range(0, len(ds), skip))
    Mapper(cfg, clip, sam).process_frame(ds[0])  # warm-up, outside the counted run
    tok = tokenizer()
    timer = StageTimer("cuda")
    engine_batches = []
    gcfg = from_dict({**cfg_dict, "main": {**cfg_dict["main"], "save_path": save_path}})

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
    per = launches_a_keyframe(clip, sam, cfg)
    expect = {"flash_attention_2d": per["flash_attention_2d"] * nf, "quant_matmul": per["quant_matmul"] * nf,
              "flash_attention": per["flash_attention"] * nf + text.variant.t_layers * batches, "nms": per["nms"] * nf}
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
    return dict(launches=launches, in_path=in_path, nf=nf, graph_dir=graph_dir, graph=loaded, answers=answers)


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


def launches_a_keyframe(clip, sam, cfg=None) -> dict:
    """K1, K2, K3 and NMS launches one keyframe's extraction makes: one K1 a
    SAM layer (all windows of a windowed layer in one launch), one K2 a CLIP
    layer, with int8 towers one K3 for each of a layer's four linears, and
    one NMS a frame whatever the configuration; with a `cfg`, no K1 unless
    ``pipeline.extract_impl`` is "flash" and no K2 unless
    ``extract_clip_impl`` is (the towers' attention then runs plain, and an
    untiered extraction encodes a keyframe's crops in one batch either
    way).  A batched dispatch makes the towers' launches once for its
    frames and NMS once a frame.  A SAM 2 segmenter launches no K1: one K2
    a Hiera block on the general route, the pooling blocks' counted as
    pooled-query launches, and one mask head a decoder pass (64 prompts, 16
    at its 32 points a side); SAM's decoder launches none."""
    layers = clip.variant.v_layers
    sam_k, clip_k = (True, True) if cfg is None else (cfg.pipeline.extract_impl == "flash",
                                                      cfg.pipeline.extract_clip_impl == "flash")
    if isinstance(sam, sam2_mod.SAM2):
        plan = sam.encoder.plan
        pps = (cfg.models.sam.points_per_side if cfg is not None else CONFIG["models"]["sam"]["points_per_side"])
        return {"flash_attention_2d": 0, "flash_attention": len(plan) * sam_k + layers * clip_k,
                "flash_attention.general": len(plan) * sam_k,
                "flash_attention.pooled": sum(b.pool for b in plan) * sam_k,
                "quant_matmul": 4 * (layers if clip.quant else 0), "nms": 1,
                "mask_head": -(-pps * pps // sam2_mod.POINTS_PER_BATCH)}
    depth = sam.variant.depth
    return {"flash_attention_2d": depth * sam_k, "flash_attention": layers * clip_k,
            "quant_matmul": 4 * (depth if sam.quant else 0) + 4 * (layers if clip.quant else 0), "nms": 1,
            "mask_head": 0}


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


def span_path(clip, sam, ds, cfg_dict, tag):
    """(sp) The stage spans on one traced dispatch of each mapping path,
    tiered (one keyframe) and batched (two keyframes untiered), each with
    its finalize, under the profiler: no span synchronises
    (``torch.cuda.synchronize`` counted while a span is open, and the
    trace's cudaDeviceSynchronize inside spans), the spans' "#sync" total
    equals the trace's cudaStreamSynchronize calls inside spans, no device
    event bears a span's name, and the sync-debug mode is off again after.
    Prints each span's ms, calls and blocking waits, and the waits by call
    site."""
    cuda_dev = torch.autograd.DeviceType.CUDA
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sites = collections.Counter()
    show, sync = timing._SyncCounter._show, torch.cuda.synchronize

    def show_site(self, message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(timing.SYNC_WARNING):
            sites[self.timer._open[-1], f"{os.path.relpath(filename)}:{lineno}"] += 1
        return show(self, message, category, filename, lineno, file, line)

    for path, bsz, tiering in (("tiered", 1, True), ("batched", 2, False)):
        d = copy.deepcopy(cfg_dict)
        d["pipeline"].update(extract_tiering=tiering, extract_frames_per_dispatch=bsz, skip_frames=1)
        pcfg = from_dict(d)
        frames = [ds[i] for i in range(0, len(ds), cfg_dict["pipeline"]["skip_frames"])][:bsz]  # keyframes
        Mapper(pcfg, clip, sam).run(frames)  # warm-up at this path's shapes, untraced
        timer = StageTimer("cuda")
        in_span_syncs = [0]

        def counting_sync(*a, **kw):
            in_span_syncs[0] += bool(timer._open)
            return sync(*a, **kw)

        sites.clear()
        torch.cuda.synchronize()
        timing._SyncCounter._show, torch.cuda.synchronize = show_site, counting_sync
        try:
            with torch.profiler.profile(activities=acts) as prof:
                Mapper(pcfg, clip, sam, timer=timer).run(frames)
                sync()
        finally:
            timing._SyncCounter._show, torch.cuda.synchronize = show, sync
        ms = timer.ms
        names = {k for k in timer.calls if not k.endswith(timing.SYNC)}
        events = prof.events()
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name in names and e.device_type != cuda_dev]
        runtime = collections.Counter(
            e.name for e in events if e.device_type != cuda_dev and e.name.endswith("Synchronize")
            and any(s <= e.time_range.start < t for s, t in spans))
        on_device = sorted({e.name for e in events if e.device_type == cuda_dev and e.name in names})
        n_sync = sum(n for k, n in timer.calls.items() if k.endswith(timing.SYNC))
        run = f"{tag}-{path}"
        for name in sorted(names):
            log(f"[{run}] span {name:18s} parent {str(timer.parent[name]):12s} {ms[name]:10.3f} ms (event-timed) "
                f"{timer.calls[name]:3d} calls  {timer.calls[name + timing.SYNC]:3d} blocking waits")
        for (name, where), n in sorted(sites.items()):
            log(f"[{run}] blocking waits in {name:18s} at {where}: {n}")
        log(f"[{run}] {len(spans)} span ranges in the trace; runtime waits inside them {dict(runtime)}; "
            f"torch.cuda.synchronize inside spans {in_span_syncs[0]}; #sync total {n_sync}; "
            f"device events named as spans {on_device}")
        check(timer.calls["dispatch"] == 1 and timer.calls["backproject"] == bsz,
              f"{run}: {timer.calls['dispatch']} dispatch spans, {timer.calls['backproject']} frames")
        check(len(spans) == sum(timer.calls[n] for n in names), f"{run}: {len(spans)} span ranges in the trace")
        check(in_span_syncs[0] == 0 and runtime["cudaDeviceSynchronize"] == 0,
              f"{run}: a span synchronised ({in_span_syncs[0]} calls, {runtime['cudaDeviceSynchronize']} in the trace)")
        check(n_sync == runtime["cudaStreamSynchronize"],
              f"{run}: #sync total {n_sync}, cudaStreamSynchronize inside spans {runtime['cudaStreamSynchronize']}")
        check(not on_device, f"{run}: device events named as spans: {on_device}")
        check(torch.cuda.get_sync_debug_mode() == 0, f"{run}: the sync-debug mode left on")


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
            times = nf if k == "nms" else calls
            check(launches[k] == n * times, f"{run}: {k} launches {launches[k]} != {n} x {times}")
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
        times = nf if k == "nms" else len(pairs)
        check(launches[k] == n * times, f"{tag}: {k} launches {launches[k]} != {n} x {times}")
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
              "flash_attention": per["flash_attention"] * sum(nfs) + models[0][4].variant.t_layers * batches,
              "nms": per["nms"] * sum(nfs)}
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


def build_path(tag, cfg, models, ds_check, expect_batches, dataset=None):
    """build_map.run (its loader from the config, or `dataset`), counted;
    stage times, keyframes/s and the launches a keyframe held."""
    clip, sam = models[0], models[1]
    timer = StageTimer("cuda")
    (graph_dir, graph), wall, launches, in_path, peak = counted(
        lambda: build_map.run(cfg, dataset=dataset, models=models, timer=timer))
    stats = json.loads((Path(graph_dir).parent / "build_stats.json").read_text())
    nf = stats["frames"]
    per = launches_a_keyframe(clip, sam)
    expect = {"flash_attention_2d": per["flash_attention_2d"] * nf, "quant_matmul": 0,
              "flash_attention": per["flash_attention"] * nf + models[4].variant.t_layers * expect_batches,
              "nms": per["nms"] * nf}
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


# ---------------------------------------------------------------------------
# (r)-(t): the robot's online mission, relocalization, the native runtime
# ---------------------------------------------------------------------------

NAV_CELL = 0.05  # build_nav_graph's cell size (the reference's)
ROBOT = dict(robot_radius=0.15, inflation_radius=0.4)  # tests/test_mission.py's footprint
MISSION_START = np.array([2.9, 2.4, 0.0])  # the bedroom, between the bed and the first door
MISSION_GOAL, VOICE_GOAL = "go to the table", "take me to the sofa in the living room"
# the localizer's map: the bedroom and the living room (the second wall
# stands at x = 8 m), a cut of the area for the beam model's range table
LOCALIZER_X_MAX = 8.3
SCAN_ANGLES = np.linspace(-np.pi, np.pi, 36, endpoint=False)  # tests/test_localizer.py's beams
GOAL_REACHED_M = 0.4


def same_nav_graph(a, b) -> bool:
    """Node lists in order with their attributes, edge lists with theirs."""
    return (list(a.nodes(data=True)) == list(b.nodes(data=True))
            and list(a.edges(data=True)) == list(b.edges(data=True)))


def approach_point(cm, center) -> np.ndarray:
    """The free cell (cost 0) nearest an object's center: where a robot
    stands to reach it (the center itself lies inside the object)."""
    free = np.argwhere(cm.cost == 0)
    xy = cm.to_world(free)
    return xy[int(np.argmin(np.linalg.norm(xy - np.asarray(center)[:2], axis=1)))]


def resampled(plan, step=0.1) -> np.ndarray:
    """(N, 3) poses every `step` metres along a plan, heading along it."""
    p = np.asarray(plan)[:, :2]
    cum = np.r_[0.0, np.cumsum(np.linalg.norm(np.diff(p, axis=0), axis=1))]
    s = np.arange(0.0, cum[-1], step)
    xy = np.stack([np.interp(s, cum, p[:, 0]), np.interp(s, cum, p[:, 1])], -1)
    return np.c_[xy, np.arctan2(np.gradient(xy[:, 1]), np.gradient(xy[:, 0]))]


def odom_delta(prev, cur) -> np.ndarray:
    """Exact odometry increment in the robot frame (tests/test_localizer.py)."""
    d = cur[:2] - prev[:2]
    c, s = np.cos(-prev[2]), np.sin(-prev[2])
    return np.array([c * d[0] - s * d[1], s * d[0] + c * d[1], np.arctan2(np.sin(cur[2] - prev[2]),
                                                                            np.cos(cur[2] - prev[2]))])


class FifoRobot:
    """A unicycle whose commands pass through the port's VelocityBridge
    FIFO (written by the controller side, read and shaped by the actuator
    side, as the robot's pubvel does)."""

    def __init__(self, fifo, state):
        self.vb, self.state, self.cmd = native.VelocityBridge(fifo), np.asarray(state, np.float64), (0.0, 0.0)

    def send_velocity(self, x, y, r):
        check(self.vb.write(x, y, r), "velocity bridge: write failed")
        out = self.vb.read_shaped(vmax=0.6, vmin=0.01)
        self.cmd = (0.0, 0.0) if out is None else (float(out[0]), float(out[2]))

    def step(self, dt=0.1):
        (v, w), (x, y, yaw) = self.cmd, self.state
        self.state = np.array([x + v * np.cos(yaw) * dt, y + v * np.sin(yaw) * dt, yaw + w * dt])

    def pose4(self):
        x, y, yaw = self.state
        p = np.eye(4)
        p[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        p[:2, 3] = (x, y)
        return p

    def send_pose4(self, x, y, r):
        self.send_velocity(x, y, r)
        self.step()


def goal_pass(tag, svc, engine, instructions, parsed_objects=False):
    """Every instruction through the goal service: a found goal's object is
    the engine's top-1, its score passes the gate, and its waypoint chain
    is not empty.  Returns (results, ms a query)."""
    results, ms = {}, []
    for ins in instructions:
        t0 = time.perf_counter()
        res = svc.query(ins)
        ms.append(1e3 * (time.perf_counter() - t0))
        _, _, objs, r = engine.query_hierarchy(ins, top_k=1)
        score = float(r["scores"][0]) if r.get("scores") else 0.0
        check(res.found == (bool(objs) and score >= svc.score_threshold), f"{tag}: {ins!r}: the score gate ({res.found}, {len(objs)} objects, score {score}, {res.score})")
        if res.found:
            check(res.object_id == objs[0].object_id and abs(res.score - score) <= 1e-6,
                  f"{tag}: {ins!r}: goal {res.object_id} is not the top-1 {objs[0].object_id}")
            check(len(res.waypoints) > 0, f"{tag}: {ins!r}: empty waypoint chain")
            if parsed_objects:
                check(res.object_name == RuleParser()(ins).object, f"{tag}: {ins!r} -> {res.object_name}")
        results[ins] = res
    return results, ms


def drive(tag, family, cm, occupied, goal_xy, fifo):
    """XMLNavigator (DEFAULT_TREE_XML) with `family` as its FollowPath
    controller drives the FIFO robot from MISSION_START to `goal_xy`; an
    ObstacleLayer integrates a 72-beam scan each tick, and at tick 15 an
    obstacle appears on the plan (true world only).  The robot must reach
    the goal and never enter a true lethal cell."""
    cm = nav.Costmap(cm.origin, cm.resolution, cm.cost.copy())
    layer = nav.ObstacleLayer(cm, occupied, obstacle_max_range=4.0, raytrace_max_range=5.0, **ROBOT)
    ctrl = {"dwb": nav.DWAController, "rpp": nav.RPPController, "mppi": nav.MPPIController}[family](cm)
    robot = FifoRobot(fifo, MISSION_START)
    navigator = bt_xml.XMLNavigator(cm, robot.send_velocity, lambda: tuple(robot.state), nav.DEFAULT_TREE_XML,
                                    goal_radius=0.3, controllers={"FollowPath": ctrl})
    plan = nav.astar_plan(cm, MISSION_START[:2], goal_xy)
    check(len(plan) > 0, f"{tag}: no plan from {MISSION_START[:2]} to {goal_xy}")
    r, c = cm.to_grid(np.asarray(plan[int(0.7 * len(plan))])[:2])
    world, dropped = occupied.copy(), np.zeros_like(occupied)
    dropped[r - 2:r + 2, c - 2:c + 2] = True
    navigator.set_goal(goal_xy)
    update_ms, tick_ms, status = [], [], nav.Status.RUNNING
    try:
        for t in range(600):
            if t == 15:
                world |= dropped
            scan = nav.simulate_scan_2d(world, cm.origin, cm.resolution, robot.state[:2], n_beams=72,
                                        max_range=4.0)
            t0 = time.perf_counter()
            layer.update(robot.state[:2], scan)
            t1 = time.perf_counter()
            status = navigator.tick()
            t2 = time.perf_counter()
            update_ms.append(1e3 * (t1 - t0))
            tick_ms.append(1e3 * (t2 - t1))
            robot.step()
            rr, cc = cm.to_grid(robot.state[:2])
            check(not world[rr, cc], f"{tag}: {family} drove into an obstacle at tick {t}")
            if status != nav.Status.RUNNING:
                break
        rebuild_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            layer._rebuild()
            rebuild_ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        robot.vb.close()
    err = float(np.linalg.norm(robot.state[:2] - goal_xy))
    marked = int((layer.live & dropped).sum())
    log(f"[{tag}] {family}: {status.name} after {t + 1} ticks, {err:.3f} m from the goal (limit {GOAL_REACHED_M}); "
        f"plan {len(plan)} cells, obstacle marked on {marked} cells; control tick median "
        f"{statistics.median(tick_ms):.3f} ms (max {max(tick_ms):.3f}); ObstacleLayer update median "
        f"{statistics.median(update_ms):.3f} ms, rebuild median {statistics.median(rebuild_ms):.3f} ms")
    check(status == nav.Status.SUCCESS and err < GOAL_REACHED_M, f"{tag}: {family} did not reach the goal")
    check(marked > 0, f"{tag}: {family}: the dropped obstacle was never marked")
    return dict(ticks=t + 1, tick_ms=statistics.median(tick_ms), update_ms=statistics.median(update_ms),
                rebuild_ms=statistics.median(rebuild_ms))


def mission_path(text, run_dir, tmp, tag):
    """(r) the robot's online mission over (e)'s three_room oracle graph
    (the graph (g) queries): the navigation graph on the card (held equal to
    the CPU build and through a save/load round trip); the goal service
    over FSRQueryEngine with the text tower on the card (K2), first on the
    tower's own features, then on (g)'s oracle features; the costmap of the
    floor raster on the card (bit for bit the CPU's); the particle
    localizer from global initialisation along the plan; XMLNavigator with
    each controller family through the FIFO with a dropped obstacle; the
    voice chain once."""
    graph_dir, gt_path = os.path.join(run_dir, "graph"), os.path.join(run_dir, "gt", "scene_info.json")
    g = HMSGraph.load(graph_dir)
    floor = g.floors[0]
    pts = np.asarray(floor.pcd_points)
    out = {}
    t0 = time.perf_counter()
    raster = navgraph.build_floor_raster(pts, floor.floor_zero_level, NAV_CELL)
    out["raster_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ng = navgraph.build_nav_graph(g, cell_size=NAV_CELL)
    out["nav_graph_ms"] = 1e3 * (time.perf_counter() - t0)
    raster_cpu = navgraph.build_floor_raster(pts, floor.floor_zero_level, NAV_CELL, device="cpu")
    for name in ("free", "occupied", "sdf"):
        check(np.array_equal(getattr(raster, name), getattr(raster_cpu, name)), f"{tag}: raster {name}: card != CPU")
    check(same_nav_graph(ng, navgraph.build_nav_graph(g, cell_size=NAV_CELL, device="cpu")),
          f"{tag}: the navigation graph differs between the card and the CPU")
    navgraph.save_graph(ng, os.path.join(tmp, "nav_graph.json"))
    check(same_nav_graph(ng, navgraph.load_graph(os.path.join(tmp, "nav_graph.json"))), f"{tag}: save/load")
    check(ng.number_of_nodes() > 0, f"{tag}: empty navigation graph")
    log(f"[{tag}] floor raster {raster.free.shape[0]}x{raster.free.shape[1]} at {NAV_CELL} m "
        f"({out['raster_ms']:.3f} ms), navigation graph {ng.number_of_nodes()} nodes, {ng.number_of_edges()} edges "
        f"({out['nav_graph_ms']:.3f} ms, rasters included); equal to the CPU build, node order included, and "
        "through a save/load round trip")

    # goals over (g)'s gallery (each object's GT one-hot label feature at
    # the text tower's width): first with the tower's own text features
    # (random weights: most scores fall under the gate), then with (g)'s
    # oracle text features (every goal found)
    tok = tokenizer()
    english = [s for s in three_room_instructions() if s.isascii()]
    start3 = np.array([*MISSION_START[:2], floor.floor_zero_level])
    override = query_bench._apply_oracle_embeddings(g, GTGraph.from_json(gt_path), text.variant.embed_dim)
    engine = FSRQueryEngine(g, text, tok)
    svc = GoalService(engine, nav_graph=ng, robot_position=start3)
    tower, ms_tower = goal_pass(tag, svc, engine, english)
    engine2 = FSRQueryEngine(g, text, tok)
    engine2._text_cache.update(override)
    svc2 = GoalService(engine2, nav_graph=ng, robot_position=start3)
    oracle, ms_oracle = goal_pass(tag, svc2, engine2, english, parsed_objects=True)
    check(all(r.found for r in oracle.values()), f"{tag}: an oracle goal was not found")
    out["goal_ms"] = statistics.median(ms_tower + ms_oracle)
    log(f"[{tag}] goal service: {len(english)} English instructions twice; the tower's features found "
        f"{sum(r.found for r in tower.values())} goals over the 0.15 gate, the oracle features "
        f"{sum(r.found for r in oracle.values())}; every goal the engine's top-1 with a waypoint chain "
        f"({', '.join(str(len(r.waypoints)) for r in list(oracle.values())[:7])} waypoints ...); ms a goal query "
        f"p50 {statistics.median(ms_tower):.3f} (tower), {statistics.median(ms_oracle):.3f} (oracle)")

    # the costmap of the floor raster, on the card and on the CPU
    t0 = time.perf_counter()
    cm = nav.Costmap.from_occupancy(raster.occupied, raster.origin, NAV_CELL, **ROBOT)
    out["costmap_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    cm_cpu = nav.Costmap.from_occupancy(raster.occupied, raster.origin, NAV_CELL, **ROBOT, device="cpu")
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    check(cm.cost.dtype == np.uint8 and np.array_equal(cm.cost, cm_cpu.cost), f"{tag}: costmap card != CPU")
    goal_xy = approach_point(cm, oracle[MISSION_GOAL].goal_pose[:3, 3])
    log(f"[{tag}] costmap {cm.cost.shape[0]}x{cm.cost.shape[1]}: {out['costmap_ms']:.3f} ms on the card, "
        f"{cpu_ms:.3f} ms on the CPU, equal bit for bit; {MISSION_GOAL!r} -> {oracle[MISSION_GOAL].object_id} "
        f"at {np.round(oracle[MISSION_GOAL].goal_pose[:3, 3], 3).tolist()}, approach {np.round(goal_xy, 3).tolist()}")

    # the particle localizer (beam model, n_global 4000) from global
    # initialisation, scans simulated along the plan
    cols = int((LOCALIZER_X_MAX - raster.origin[0]) / NAV_CELL)
    occ_loc = raster.occupied[:, :cols].copy()
    occ_loc[:, -1] = True
    log(f"[{tag}] reduced: the localizer's map is the bedroom and the living room, {occ_loc.shape[0]}x{cols} of "
        f"{raster.occupied.shape[0]}x{raster.occupied.shape[1]} cells (x < {LOCALIZER_X_MAX} m), resolution kept "
        f"at {NAV_CELL} m: the beam model's range table grows with the free cells")
    cm_loc = nav.Costmap.from_occupancy(occ_loc, raster.origin, NAV_CELL, **ROBOT)
    t0 = time.perf_counter()
    loc = nav.ParticleLocalizer(cm_loc, occ_loc, seed=SEED)
    out["range_table_ms"] = 1e3 * (time.perf_counter() - t0)
    traj = resampled(nav.astar_plan(cm_loc, MISSION_START[:2], goal_xy))
    upd = []
    for prev, cur in zip(traj[:-1], traj[1:]):
        ranges = nav.simulate_scan(occ_loc, raster.origin, NAV_CELL, cur, SCAN_ANGLES, max_range=loc.max_range)
        t0 = time.perf_counter()
        est = loc.update(odom_delta(prev, cur), ranges, SCAN_ANGLES)
        upd.append(1e3 * (time.perf_counter() - t0))
    err, spread = float(np.linalg.norm(est[:2] - traj[-1][:2])), loc.spread()
    out["localizer_update_ms"] = statistics.median(upd)
    log(f"[{tag}] ParticleLocalizer ({loc.model}, {len(loc._free_cells)} free cells x {loc.n_yaw_bins} bins): "
        f"range table and likelihood field {out['range_table_ms']:.3f} ms; {len(upd)} updates, median "
        f"{out['localizer_update_ms']:.3f} ms; final error {err:.3f} m (limit 0.35), spread {spread:.3f} (limit 0.6)")
    check(err < 0.35 and spread < 0.6, f"{tag}: the localizer did not converge")

    for family in ("dwb", "rpp", "mppi"):
        out[family] = drive(tag, family, cm, raster.occupied, goal_xy, os.path.join(tmp, f"vel_fifo_{family}"))

    # the voice chain: transcript -> goal -> waypoint navigation through the FIFO
    server = LoopbackVoiceServer(transcript=VOICE_GOAL, min_samples=2000)
    got, goal = threading.Event(), {}

    def on_text(t):
        goal["res"] = svc2.query(t)
        got.set()

    client = VoiceClient("127.0.0.1", server.port, on_text=on_text, heartbeat_s=5.0)
    robot = FifoRobot(os.path.join(tmp, "vel_fifo_voice"), [*goal_xy, 0.0])
    try:
        chunk = np.random.default_rng(SEED).uniform(-0.4, 0.4, 4800).astype(np.float32)
        for _ in range(3):
            client.send_audio(chunk)
        check(got.wait(10.0), f"{tag}: no goal from the voice transcript")
        res = goal["res"]
        check(res.found and res.object_name == "sofa", f"{tag}: voice goal {res.object_name}")
        target = np.r_[approach_point(cm, res.goal_pose[:3, 3]), 0.0]
        reached = []
        wn = WaypointNavigator(robot.send_pose4, robot.pose4, waypoint_radius=0.3,
                               on_waypoint_reached=lambda i: (reached.append(i),
                                                              client.notify_waypoint_reached(str(i))))
        wn.set_goal([target])
        for _ in range(800):
            if not wn.step():
                break
        for _ in range(50):
            if server.waypoint_msgs:
                break
            time.sleep(0.1)
        err = float(np.linalg.norm(robot.state[:2] - target[:2]))
        log(f"[{tag}] voice: {VOICE_GOAL!r} over the loopback WebSocket -> {res.object_id}, "
            f"{err:.3f} m from its approach point, feedback {server.waypoint_msgs}")
        check(wn.done and reached == [0] and err < GOAL_REACHED_M and server.waypoint_msgs == ["0"],
              f"{tag}: the voice mission did not finish")
    finally:
        client.close()
        robot.vb.close()
    return out


def session_from_frames(frames, world_offset, rng, n_points):
    """A mapping session from rendered frames: each frame backprojected on
    the card, `n_points` of its points kept (a MID-360 sweep's count), in
    the sensor frame; the session's world frame is offset by `world_offset`."""
    s, inv = multisession.Session(), np.linalg.inv(world_offset)
    for f in frames:
        p, _, v = backproject(torch.from_numpy(f.depth).cuda(), torch.from_numpy(f.rgb).cuda(),
                              Pinhole.from_matrix(f.k), torch.from_numpy(f.pose).cuda(), 1e-3, 20.0)
        p = p[v]
        idx = torch.from_numpy(rng.choice(p.shape[0], n_points, replace=False)).cuda()
        scan = p[idx].double().cpu().numpy()
        s.add_keyframe(inv @ f.pose.astype(np.float64), (scan - f.pose[:3, 3]) @ f.pose[:3, :3].astype(np.float64))
    return s


RELO_FRAMES, RELO_POINTS = 36, 20000  # three orbits of 12 keyframes; about a MID-360 sweep a scan
MERGE_CPU_ATOL = 1e-3


def relocalization_path(tag):
    """(s) two sessions of 24 keyframes (the three_room walk's first two
    orbits, and its last two with the world frame offset by a known SE(2)
    drift, as tests/test_multisession.py), merged on the card (held to the
    drift and to the port's CPU merge), then global relocalization and
    periodic updates of session B's scans against session A."""
    scene = SyntheticScene.three_room(SEED)
    hw = (240, 320)
    k = SyntheticDataset(scene, num_frames=1, hw=hw).k
    t0 = time.perf_counter()
    frames, _ = render_walk(scene, RELO_FRAMES, hw, k)
    drift = np.eye(4)
    drift[:2, :2] = [[np.cos(0.1), -np.sin(0.1)], [np.sin(0.1), np.cos(0.1)]]
    drift[:2, 3] = [0.4, -0.3]
    rng = np.random.default_rng(SEED)
    a = session_from_frames(frames[:24], np.eye(4), rng, RELO_POINTS)
    b = session_from_frames(frames[12:], drift, rng, RELO_POINTS)
    log(f"[{tag}] set-up: {len(frames)} frames at {hw[1]}x{hw[0]} rendered and backprojected on the card, "
        f"{RELO_POINTS} points a scan, in {time.perf_counter() - t0:.2f} s")
    captures = len(solvers._GRAPHS)
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    merged, t_ab = multisession.merge_sessions(a, b, stats=stats)
    merge_s = time.perf_counter() - t0
    captures = len(solvers._GRAPHS) - captures
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    merged_cpu, t_ab_cpu = multisession.merge_sessions(a, b, device="cpu")
    cpu_s = time.perf_counter() - t0
    err = t_ab @ np.linalg.inv(drift)
    ang, trans = abs(float(np.arctan2(err[1, 0], err[0, 0]))), float(np.linalg.norm(err[:2, 3]))
    diff = max(float(np.abs(t_ab - t_ab_cpu).max()),
               max(float(np.abs(p - q).max()) for p, q in zip(merged.poses, merged_cpu.poses)))
    log(f"[{tag}] merge_sessions: {merge_s:.3f} s on the card ({captures} CUDA graph captures, peak "
        f"{peak / 2**30:.3f} GiB), {cpu_s:.3f} s on the CPU; {stats}; drift error {ang:.5f} rad (limit 0.08), "
        f"{trans:.5f} m (limit 0.35); card vs CPU max |difference| {diff:.3e} (limit {MERGE_CPU_ATOL})")
    check(ang < 0.08 and trans < 0.35, f"{tag}: the merge did not recover the drift")
    check(diff <= MERGE_CPU_ATOL, f"{tag}: the card's merge differs from the CPU's")
    relo = Relocalizer(a)
    check(relo.global_relocalize(b.scans[0]), f"{tag}: global relocalization failed")
    upd, refined, errs = [], 0, []
    for i in range(len(b.scans)):
        t0 = time.perf_counter()
        pose, ref = relo.update(b.scans[i], np.linalg.inv(b.poses[0]) @ b.poses[i])
        upd.append(1e3 * (time.perf_counter() - t0))
        refined += ref
        errs.append(float(np.linalg.norm(pose[:3, 3] - (drift @ b.poses[i])[:3, 3])))
    shared = errs[:12]  # B's frames in A's rooms
    log(f"[{tag}] Relocalizer: global relocalization from B's first scan; {len(upd)} updates, median "
        f"{statistics.median(upd):.3f} ms, {refined} of them re-registered against the map (every "
        f"{relo.cfg.relo_interval}th; max {max(upd):.3f} ms); position error over B's keyframes in A's map max "
        f"{max(shared):.3f} m (limit 0.3)")
    check(max(shared) < 0.3, f"{tag}: the relocalized poses are off")
    return dict(merge_s=merge_s, captures=captures, update_ms=statistics.median(upd))


def host_cpu() -> str:
    """The host's CPU as lscpu names it (vendor, model name, family and
    model numbers) and its core count."""
    r = subprocess.run(["lscpu"], capture_output=True, text=True)
    fields = dict(line.split(":", 1) for line in r.stdout.splitlines() if ":" in line)
    return ", ".join(f"{k} {fields[k].strip()}" for k in ("Vendor ID", "Model name", "CPU family", "Model")
                     if k in fields) + f", {os.cpu_count()} cores"


def lio_path(tag):
    """(t) apps.lio_bench at its defaults through the port's native binding
    (host work: the LIO pipeline's sweeps and the VIO frames)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = lio_bench.run()
    log(f"[{tag}] {json.dumps(res)} on {host_cpu()}")
    check(res["lio_sweeps_per_s"] > 0 and res["vio_frames_per_s"] > 0 and res["points_per_sweep"] > 1e4,
          f"{tag}: {res}")
    return res


# ---------------------------------------------------------------------------
# (u)-(w): training on the card, the neural row and the correctness battery
# on card-trained towers, the W8A8 text tower
# ---------------------------------------------------------------------------

# the JAX tests' learning thresholds (tests/test_perception_training.py:23, :67)
CLIP_LEARNS = 0.5  # mean of the last 5 losses < 0.5 x the first
SAM_LEARNS = 0.6  # mean of the last 10 < 0.6 x the mean of the first 5
CPU_STEPS = 20
CPU_RTOL = 1e-3
# The neural row's bands.  The record (results/eval_protocol.json
# per_seed_neural: prec@50 0.667-1.0, rec@50 0.5-0.714, mIoU 0.225-0.495)
# predates the JAX package's present code: its own row today, on towers its
# own trainer made at the same recipe, reads prec@50 0.19-0.27 (18-31
# objects predicted for 6 and 7), rec@50 0.67-1.0, mIoU 0.47-0.68 at seeds
# 0-2, and the port's row on the same towers is equal.  A trained tower is
# one sample of the recipe (Adam's first steps amplify float noise, so no
# two trainings agree), so each band is the range of the JAX package's
# runs (scripts/neural_reference.py on the CPU: seeds 0, 1 and 2, both
# layouts) widened by NEURAL_WIDEN and clamped to [0, 1].
NEURAL_WIDEN = 0.15
NEURAL_RANGES = {
    "object precision@50": (("objects", "prec_at_50"), 0.19230769230769232, 0.2692307692307692),
    "object recall@50": (("objects", "rec_at_50"), 0.6666666666666666, 1.0),
    "segmentation mIoU": (("segmentation", "mIoU"), 0.4699350438558866, 0.6821417019828333),
}
NEURAL_BOUND_TOL = 0.01  # metres from the JAX package's floor bound error today (REF_BOUND_ERROR)
# The battery's bands: the range of the record (results/all_results_{fast,
# slow_clip}_tpu.json, long_query_tpu.json) and of the JAX package's towers
# (scripts/neural_reference.py on the CPU: the recipe at seeds 0, 1 and 2;
# and scripts/tower_spread.py on the card: the JAX seed-0 CLIP tower with
# the JAX SAM towers of seeds 0-5, the two trained apart as the recipe
# trains them, scored by the port's suite, which scores a tower set as the
# JAX package does), widened by SUITE_WIDEN: (top-1 low, high, recall@5
# low, high).  `fast_oracle` scores the graph the SAM tower built: JAX SAM
# towers give 0.857 or 1.0.
SUITE_RANGES = {
    "fast_oracle": (0.8571428571428571, 1.0, 0.8571428571428571, 1.0),
    "fast": (0.7142857142857143, 1.0, 0.7857142857142857, 1.0),
    "slow_clip": (0.6428571428571429, 0.9571428571428572, 0.8571428571428571, 1.0),
}
LONG_QUERY_RANGES = {"floor_acc": (1.0, 1.0), "room_acc": (0.5370370370370371, 0.9444444444444444)}
SUITE_WIDEN = 0.15


@contextlib.contextmanager
def step_events(out):
    """Record CUDA events around every training step call of the fixture
    trainers (``perception._step``'s callable): `out` gets one list of
    (start, end) a trainer run, and the step callables themselves."""
    make = perception._step

    def timed_step(step):
        inner = make(step)
        events = []
        out.append(dict(events=events, step=inner))

        def call(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            loss = inner(*args)
            b.record()
            events.append((a, b))
            return loss

        return call

    perception._step = timed_step
    try:
        yield out
    finally:
        perception._step = make


def step_ms(run) -> float:
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in run["events"])


@contextlib.contextmanager
def traced_calls(which, log_dir, out):
    """Trace the `which`-th call (1-based) of each trainer run's step under
    tracing.device_trace: `out` gets its kernel count, device ms and idle
    share."""
    make = perception._step

    def traced_step(step):
        inner = make(step)
        calls = [0]

        def call(*args):
            calls[0] += 1
            if calls[0] not in which:
                return inner(*args)
            torch.cuda.synchronize()
            with tracing.device_trace(os.path.join(log_dir, f"run{len(out)}_call{calls[0]}")) as prof:
                t0 = time.perf_counter()
                with tracing.annotate(f"fixture_step_{calls[0]}"):
                    loss = inner(*args)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
            out.append(dict(call=calls[0], **tracing.device_idle_share(prof, wall)))
            return loss

        return call

    perception._step = traced_step
    try:
        yield out
    finally:
        perception._step = make


def fixture_training_path(datasets, cache_dir, trace_dir, tag):
    """(u), first half: the fixture recipe on the card.  The first
    CPU_STEPS steps of each tower from its seeded init on the card and on
    the host CPU, loss by loss; one eager step (the 2nd call, a warm-up) and
    one graph replay (the last call) of each traced; then
    training.zoo.fixture_towers(retrain=True) at the recipe's 3000 CLIP and
    6000 SAM steps, float32, each step after the warm-up one CUDA graph
    replay."""
    labels = zoo.fixture_labels()
    rects = [zoo.ROOM_RECTS["two_room"], zoo.ROOM_RECTS["three_room"], SyntheticScene.two_floor_room_rects()]
    clip_kw = dict(room_rects_by_ds=rects, room_frame_jitter=2, seed=0)
    sam_kw = dict(variant_name=zoo.SAM_VARIANT, lr=2e-3, seed=0)
    first = {}
    traces = []
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        with traced_calls({2, CPU_STEPS} if dev == "cuda" else set(), trace_dir, traces):
            _, first[("clip", dev)] = perception.train_tiny_clip(datasets, labels, steps=CPU_STEPS, device=dev,
                                                                 **clip_kw)
            _, first[("sam", dev)] = perception.train_tiny_sam(datasets, steps=CPU_STEPS, device=dev, **sam_kw)
        log(f"[{tag}] {CPU_STEPS} steps of each tower on {dev}: {time.perf_counter() - t0:.3f} s (set-up included)")
    for tower in ("clip", "sam"):
        cpu, card = np.asarray(first[(tower, "cpu")]), np.asarray(first[(tower, "cuda")])
        rel = np.abs(card - cpu) / np.abs(cpu)
        log(f"[{tag}] {tower}: the first {CPU_STEPS} losses, card vs CPU: max rel diff {rel.max():.3e} "
            f"(step {int(rel.argmax()) + 1}); per step {', '.join(f'{r:.1e}' for r in rel)}")
        check(bool(np.isfinite(card).all()) and rel.max() <= CPU_RTOL,
              f"{tag} {tower}: card losses {card.tolist()} vs CPU {cpu.tolist()}")
    for tower, (eager, graph) in zip(("clip", "sam"), (traces[0:2], traces[2:4])):
        for what, t in (("eager step (warm-up call 2)", eager), (f"graph replay (call {CPU_STEPS})", graph)):
            log(f"[{tag}] {tower} traced {what}: {t['kernels']} kernels, device {t['device_ms']:.3f} ms, "
                f"wall {t['wall_ms']:.3f} ms (profiler on), idle share {t['idle_share']:.3f}")
    runs = []
    t0 = time.perf_counter()
    with step_events(runs):
        clip, sam = zoo.fixture_towers(retrain=True, device="cuda", cache_dir=cache_dir, datasets=datasets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    meta = json.loads(next(Path(cache_dir).glob("meta_*.json")).read_text())
    for (tower, key, n), run in zip((("clip", "clip_losses", meta["steps_clip"]),
                                     ("sam", "sam_losses", meta["steps_sam"])), runs):
        losses = meta[key]
        check(len(losses) == n == len(run["events"]), f"{tag} {tower}: {len(losses)} steps, {len(run['events'])} timed")
        ms = step_ms(run)
        log(f"[{tag}] {tower}: {n} steps, median {ms:.4f} ms a step (CUDA events), first loss {losses[0]:.4f}, "
            f"mean of the last 50 {np.mean(losses[-50:]):.4f}")
        check(bool(np.isfinite(losses).all()), f"{tag} {tower}: non-finite loss")
    cl, sl = meta["clip_losses"], meta["sam_losses"]
    check(np.mean(cl[-5:]) < CLIP_LEARNS * cl[0], f"{tag}: CLIP did not learn ({cl[0]} -> {np.mean(cl[-5:])})")
    check(np.mean(sl[-10:]) < SAM_LEARNS * np.mean(sl[:5]), f"{tag}: SAM did not learn")
    ls = clip.logit_scale.item()
    log(f"[{tag}] fixture_towers(retrain=True): {wall:.3f} s (crops, ground-truth grids and both recipes); "
        f"trained logit_scale {ls:.4f} (init {clip_mod.INIT_LOGIT_SCALE:.4f}, clipped at "
        f"{contrastive.LOGIT_SCALE_MAX:.4f}: {'reached' if ls >= contrastive.LOGIT_SCALE_MAX else 'not reached'})")
    return clip, sam


def _band(lo, hi):
    return max(0.0, lo - NEURAL_WIDEN), min(1.0, hi + NEURAL_WIDEN)


def neural_row_path(towers, tag):
    """(u): the accuracy protocol's neural row on the card-trained towers,
    both layouts at seed 0, held to the JAX package's runs' bands
    (NEURAL_RANGES)."""
    timers = {}
    summary = eval_protocol.run(seeds=0, neural=True, neural_seeds=1, towers=towers, out_md=None, timers=timers)
    check(len(summary["per_seed_neural"]) == len(eval_protocol.LAYOUTS), f"{tag}: neural runs")
    for layout, m in zip(eval_protocol.LAYOUTS, summary["per_seed_neural"]):
        timer = timers[(layout, 0, "neural")]
        log(f"[{tag}] {layout}: {eval_protocol.LAYOUTS[layout][2]} frames in {timer.ms['run']:.3f} ms; "
            f"extract {timer.ms['extract']:.3f} ms ({timer.ms['extract'] / timer.calls['extract']:.3f} ms/frame)")
        err = m["floors"]["mean_bound_error"]
        log(f"[{tag}] {layout} floor bound error {err:.6f} m (the JAX package {REF_BOUND_ERROR:.6f}); rooms "
            f"P {m['rooms']['precision']} R {m['rooms']['recall']}; objects {m['objects']['num_pred']} "
            f"(GT {m['objects']['num_gt']}), AUC {m['objects']['auc']:.4f}")
        check_accuracy(abs(err - REF_BOUND_ERROR) <= NEURAL_BOUND_TOL, f"{tag} {layout}: floor bound error {err}")
        check_accuracy(m["rooms"]["precision"] == 1.0 and m["rooms"]["recall"] == 1.0, f"{tag} {layout}: rooms {m['rooms']}")
        for name, (path, lo, hi) in NEURAL_RANGES.items():
            got, (blo, bhi) = float(_dig(m, path)), _band(lo, hi)
            log(f"[{tag}] {layout} {name}: {got:.4f} (band [{blo:.3f}, {bhi:.3f}], the JAX package's runs {lo:.4f}-{hi:.4f})")
            check_accuracy(blo <= got <= bhi, f"{tag} {layout}: {name} {got} outside [{blo}, {bhi}]")


def correctness_path(towers, work_dir, tag):
    """(u): correctness_suite.run_suite's three_room battery (the four engine
    modes over the 512-padded gallery) and the two_floor long-query row, on
    the card-trained towers, held to the bands of the records and the
    JAX package's towers (SUITE_RANGES, LONG_QUERY_RANGES)."""
    report = correctness_suite.run_suite("three_room", 512, out_dir=work_dir, towers=towers)
    for name in ("fast_oracle", "fast", "slow_clip", "slow_generative"):
        log(f"[{tag}] {name}: {report[name]}")
    for name, (t_lo, t_hi, r_lo, r_hi) in SUITE_RANGES.items():
        got = report[name]
        check(got["n_scored"] == len(three_room_instructions()), f"{tag} {name}: scored {got['n_scored']}")
        for what, v, lo, hi in (("top-1", got["top1_acc"], t_lo, t_hi), ("recall@5", got["recall_at_5"], r_lo, r_hi)):
            blo, bhi = max(0.0, lo - SUITE_WIDEN), min(1.0, hi + SUITE_WIDEN)
            log(f"[{tag}] {name} {what}: {v:.4f} (band [{blo:.3f}, {bhi:.3f}])")
            check_accuracy(blo <= v <= bhi, f"{tag} {name} {what} {v} outside [{blo}, {bhi}]")
    lq = report["long_query"]
    log(f"[{tag}] long query: {lq}; wall {report['wall_seconds']} s")
    for k, (lo, hi) in LONG_QUERY_RANGES.items():
        blo, bhi = max(0.0, lo - SUITE_WIDEN), min(1.0, hi + SUITE_WIDEN)
        check_accuracy(blo <= lq[k] <= bhi, f"{tag} long query {k}: {lq[k]} outside [{blo}, {bhi}]")


def refuse_autograd_check(tag):
    """The kernel wrappers raise on a CUDA input that requires grad while
    grad mode is on (their outputs would carry no grad_fn)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    q = torch.randn(1, 2, 77, 64, device="cuda", generator=g).bfloat16().requires_grad_()
    bias = torch.zeros(2, 196, 14, device="cuda", requires_grad=True)
    q2 = torch.randn(2, 196, 64, device="cuda", generator=g).bfloat16().requires_grad_()
    x = torch.randn(77, 64, device="cuda", generator=g).bfloat16().requires_grad_()
    w_q, w_s = tfm.quantize_weight_int8(torch.randn(64, 32, device="cuda", generator=g))
    calls = {"flash_attention": lambda: fa.flash_attention(q, q, q, causal=True),
             "flash_attention_2d": lambda: fa.flash_attention_2d(q2, q2, q2, bias, bias, (14, 14)),
             "quant_matmul": lambda: qm.quant_matmul(x, w_q.t().contiguous(), w_s, torch.zeros(32, device="cuda"))}
    for name, call in calls.items():
        n0 = WRAPPERS[name].launches
        try:
            call()
        except RuntimeError as e:
            check('impl="xla"' in str(e), f"{tag} {name}: {e}")
        else:
            raise RuntimeError(f"check failed: {tag} {name} took an input that requires grad")
        check(WRAPPERS[name].launches == n0, f"{tag} {name}: launched")
        with torch.no_grad():
            check(call().grad_fn is None, f"{tag} {name} under no_grad")
    log(f"[{tag}] flash_attention, flash_attention_2d and quant_matmul refuse CUDA inputs that require grad")


VITL_BATCH = 32
VITL_STEPS = 4
VITL_LOSS_RTOL = 2e-2
REMAT_COS_MIN = 0.999
GRAD_BATCH = 8
# At init, the B = GRAD_BATCH gradients of the bf16 loss against the
# float32 loss's on the same batch, leaf by leaf: every leaf at cosine
# GRAD_COS_MIN or more (bf16 keeps 8 bits: the worst leaf read 0.976 on the
# card, H100 80GB HBM3 700 W), and the whole bf16 gradient at least
# BF16_DIFF_MIN (relative L2) away from the float32 one, so that a step
# which silently computed in float32 fails.  The control, the float32
# gradients of the same images against the tokens rolled by one, must fail
# GRAD_COS_MIN (its worst leaf read -0.19).
GRAD_COS_MIN = 0.95
BF16_DIFF_MIN = 1e-4


def _named_grads(params, imgs, toks, dtype, remat=True):
    """{leaf: float32 gradient} of clip_loss on (imgs, toks)."""
    for q in params.parameters():
        q.grad = None
    contrastive.clip_loss(params, imgs, toks, dtype=dtype, remat=remat).backward()
    named = [(f"visual.{n}", q) for n, q in params.visual.named_parameters()]
    named += [(f"text.{n}", q) for n, q in params.text.named_parameters()] + [("logit_scale", params.logit_scale)]
    out = {n: q.grad.detach().float().flatten().clone() for n, q in named}
    for q in params.parameters():
        q.grad = None
    return out


def _leaf_cosines(got, want):
    """(worst leaf cosine, its name, leaves compared): leaves whose `want`
    gradient is zero are left out."""
    cos = [(F.cosine_similarity(got[n], w, dim=0).item(), n) for n, w in want.items() if bool(w.any())]
    worst = min(cos)
    return worst[0], worst[1], len(cos)


def vit_l_gradient_checks(params, imgs, toks, tag):
    """(v) at init, on B = GRAD_BATCH: the bf16 gradients against the
    float32 ones leaf by leaf, the control, and the visual tower's
    gradients with and without remat."""
    im8, tk8 = imgs[:GRAD_BATCH], toks[:GRAD_BATCH]
    f32 = _named_grads(params, im8, tk8, torch.float32)
    bf16 = _named_grads(params, im8, tk8, torch.bfloat16)
    cos, leaf, n = _leaf_cosines(bf16, f32)
    flat = [torch.cat(list(d.values())) for d in (bf16, f32)]
    diff = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
    log(f"[{tag}] B = {GRAD_BATCH} bf16 vs float32 gradients at init, {n} leaves: worst leaf cosine {cos:.6f} "
        f"({leaf}), relative L2 difference {diff:.3e}")
    check(cos >= GRAD_COS_MIN, f"{tag}: bf16 gradient of {leaf} at cosine {cos} to the float32 one")
    check(diff >= BF16_DIFF_MIN, f"{tag}: the bf16 gradients equal the float32 ones (relative difference {diff})")
    rolled = _named_grads(params, im8, tk8.roll(1, 0), torch.float32)
    c_cos, c_leaf, _ = _leaf_cosines(rolled, f32)
    log(f"[{tag}] control, float32 gradients with the tokens rolled by one: worst leaf cosine {c_cos:.6f} ({c_leaf})")
    check(c_cos < GRAD_COS_MIN, f"{tag}: the control passes the gradient gate (cosine {c_cos})")
    del f32, rolled, flat
    no_remat = _named_grads(params, im8, tk8, torch.bfloat16, remat=False)
    vis = [torch.cat([d[k] for k in d if k.startswith("visual.")]) for d in (bf16, no_remat)]
    cos = F.cosine_similarity(vis[0], vis[1], dim=0).item()
    log(f"[{tag}] B = {GRAD_BATCH} visual-tower gradients with vs without remat: cosine {cos:.6f}")
    check(cos > REMAT_COS_MIN, f"{tag}: remat gradients disagree (cosine {cos})")


def vit_l_training_path(tag):
    """(v): make_train_step at ViT-L/14 (config/synthetic_tpu_3room.yaml's
    CLIP), bf16 compute on float32 master weights, remat, B = 32 at 224 px:
    the gradient checks at init (vit_l_gradient_checks), then VITL_STEPS
    AdamW steps at init_train_state's rate on one repeated batch, the
    first step's loss against a float32 forward."""
    cv = clip_mod.VARIANTS[CONFIG["models"]["clip"]["type"]]
    params = contrastive.clip_params(*clip_mod.init_clip(cv, seed=SEED, dtype=torch.float32))
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    imgs = torch.randn(VITL_BATCH, cv.image_size, cv.image_size, 3, device="cuda", generator=g)
    toks = torch.from_numpy(tokenizer()([f"a photo of object {i} in the scene." for i in range(VITL_BATCH)])).cuda()
    vit_l_gradient_checks(params, imgs, toks, tag)
    with torch.no_grad():
        ref = contrastive.clip_loss(params, imgs, toks, dtype=torch.float32).item()
    tx = contrastive.init_train_state(params)
    lr = tx.param_groups[0]["lr"]
    step = contrastive.make_train_step(cv, tx, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(VITL_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(step(params, imgs, toks))
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = statistics.median(ms[1:])
    log(f"[{tag}] ViT-L/14 bf16 on float32 masters, remat, B = {VITL_BATCH}, AdamW lr {lr}: losses {losses} "
        f"(last - first {losses[-1] - losses[0]:.6e}; ln {VITL_BATCH} = {math.log(VITL_BATCH):.6f}); float32 forward "
        f"{ref:.6f} (step 1 rel diff {abs(losses[0] - ref) / abs(ref):.3e}); {steady:.3f} ms a step (median of "
        f"steps 2-{VITL_STEPS}; step 1 {ms[0]:.3f} ms), {1e3 * VITL_BATCH / steady:.1f} images/s, peak {peak:.3f} GiB")
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0], f"{tag}: losses {losses}")
    check(abs(losses[0] - ref) <= VITL_LOSS_RTOL * abs(ref), f"{tag}: step 1 loss {losses[0]} vs float32 {ref}")
    del params, tx
    torch.cuda.empty_cache()


DISTILL_STEPS = 5


def distill_path(tag):
    """(v): distill_step on vlm-small (the served VLM of (h)), float32, on
    random prompt embeddings, DISTILL_STEPS SGD steps; the loss falls."""
    vv = vlm_mod.VARIANTS["vlm-small"]
    vlm = vlm_mod.init_vlm(vv, seed=SEED, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    embs = 0.02 * torch.randn(8, 128, vv.width, device="cuda", generator=g)
    lens = torch.randint(32, 129, (8,), device="cuda", generator=g)
    tgts = torch.randint(0, vv.vocab, (8,), device="cuda", generator=g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(distill.distill_step(vlm, embs, lens, tgts, lr=1e-2)) for _ in range(DISTILL_STEPS)]
    wall = 1e3 * (time.perf_counter() - t0) / DISTILL_STEPS
    log(f"[{tag}] distill_step on vlm-small, float32, B = 8, T = 128: losses {losses}, {wall:.3f} ms a step "
        f"(wall, synchronised by each loss read)")
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0], f"{tag}: losses {losses}")
    del vlm
    torch.cuda.empty_cache()


Q8_TEXT_COS_MIN = 0.999


def text_q8_path(text, graph_dir, tag):
    """(w): the ViT-L/14 text tower of the graph phase at W8A8
    (quantize_clip(text)): a 256-prompt batch, its features against the
    bf16 tower's; K2 (causal) and K3 launches of the batch."""
    qtext = clip_mod.quantize_clip(text)
    tok = tokenizer()
    prompts = [t.format(lb) for lb in load_vocabulary("SCANNET200") for t in clip_mod.TEMPLATES][:256]
    tokens = torch.from_numpy(tok(prompts)).cuda()
    f_bf16 = clip_mod.encode_text(text, tokens)
    n2, n3 = fa.flash_attention.launches, qm.quant_matmul.launches
    f_q8 = clip_mod.encode_text(qtext, tokens)
    k2, k3 = fa.flash_attention.launches - n2, qm.quant_matmul.launches - n3
    cos = (f_q8 * f_bf16).sum(-1).min().item()
    log(f"[{tag}] W8A8 text tower, 256 prompts: min cosine to the bf16 tower {cos:.6f}; launches K2 {k2}, K3 {k3}")
    check(bool(torch.isfinite(f_q8).all()), f"{tag}: non-finite features")
    check(k2 == text.variant.t_layers and k3 == 4 * text.variant.t_layers, f"{tag}: launches K2 {k2}, K3 {k3}")
    check(cos >= Q8_TEXT_COS_MIN, f"{tag}: min cosine {cos}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        log(f"[{tag}] no matplotlib on this machine: render_top_down and render_hierarchy not drawn")
        return
    graph = HMSGraph.load(graph_dir)
    for name, draw in (("top_down", visualize_graph.render_top_down), ("hierarchy", visualize_graph.render_hierarchy)):
        t0 = time.perf_counter()
        draw(graph, os.path.join(graph_dir, f"{name}.png"))
        log(f"[{tag}] {name}: {1e3 * (time.perf_counter() - t0):.3f} ms")



# ---------------------------------------------------------------------------
# (x): the multi-device entry points, at W = torch.cuda.device_count() ranks
# through parallel/launch.py (one NCCL rank a card; W = 1 on a one-card
# machine: a real NCCL group whose collectives are one-rank calls)
# ---------------------------------------------------------------------------

X_SHARED = {}  # the main process's towers and frames, for its in-process rank (W = 1)
X_PROMPT_SENTENCES = 30  # (x3): one prompt of about 960 tokens, above the batcher's sp_threshold (512)
X_NEW_TOKENS = 8
X_TRAIN_STEPS = 2
X_LR = 1e-4


def x_inputs():
    """The bf16 ViT-L/14 + SAM vit_b towers and the rendered frames of the
    main paths (made again in a spawned rank)."""
    if not X_SHARED:
        cv = clip_mod.VARIANTS[CONFIG["models"]["clip"]["type"]]
        clip, text = clip_mod.init_clip(cv, seed=SEED, dtype=torch.bfloat16)
        sam = sam_mod.init_sam(sam_mod.VARIANTS[CONFIG["models"]["sam"]["type"]], seed=SEED + 1, dtype=torch.bfloat16)
        X_SHARED.update(clip=clip, sam=sam, text=text,
                        ds=SyntheticDataset(SyntheticScene.three_room(SEED), num_frames=FRAMES, hw=(480, 640),
                                            seed=SEED))
    return X_SHARED["clip"], X_SHARED["sam"], X_SHARED["text"], X_SHARED["ds"]


def event_ms(fn, calls: int = 5) -> float:
    """Median wall of `calls` synchronised calls after one warm-up, in ms by
    CUDA events around each call (host overhead included)."""
    fn()
    out = []
    for _ in range(calls):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def sorted_scene(scene) -> dict:
    """A scene's used rows in key order (numpy)."""
    n = int(scene.num)
    order = torch.argsort(scene.key[:n])
    return {f: getattr(scene, f)[:n][order].cpu().numpy()
            for f in ("key", "count", "sum_pts", "sum_col", "sum_feat", "feat_count")}


def x_sharded_mapping(mesh, world, lead, save_path, say):
    """(x1) apps.build_map.run with pipeline.sharded_mapping: on over
    (a)'s 6 keyframes at 640x480 and config/synthetic_tpu_3room.yaml's
    settings: the ShardedMapper extracts through K1 and K2 (flash), counted;
    its finalized scene's keys, counts and feature counts equal bit for bit
    to the port's single-device insert_points + fuse_pixel_features driven
    by the same FrameFeatures over the same frames, its sums within float
    tolerance; nothing dropped in the exchange, and at W = 2, 4 and 8 the
    fullest bucket these frames would fill within bucket_capacity's; the
    graph saved and loaded."""
    clip, sam, text, ds = x_inputs()
    cfg = from_dict({**CONFIG, "main": {**CONFIG["main"], "save_path": save_path},
                     "pipeline": {**CONFIG["pipeline"], "sharded_mapping": "on"}})
    p = cfg.pipeline
    keyframes = list(range(0, len(ds), p.skip_frames))
    feats, mapped, mappers = [], [], []
    real_extract, real_finalize = extractor_mod.extract_frames_dp, sharded_scene.ShardedMapper.finalize

    def recorded(*a, **kw):
        feats.append(real_extract(*a, **kw))
        return feats[-1]

    def finalize(self):
        mapped.append(real_finalize(self))
        mappers.append(self)
        return mapped[-1]

    extractor_mod.extract_frames_dp, sharded_scene.ShardedMapper.finalize = recorded, finalize
    timer = StageTimer("cuda")
    try:
        (graph_dir, built), wall, launches, in_path, peak = counted(lambda: build_map.run(
            cfg, dataset=ds, models=(clip, sam, clip.variant, sam.variant, text), timer=timer))
    finally:
        extractor_mod.extract_frames_dp, sharded_scene.ShardedMapper.finalize = real_extract, real_finalize
    nf = len(keyframes)
    mine = -(-nf // world)  # frames this rank extracts (the last batch padded)
    label_batches = sum(math.ceil(len(v) * len(clip_mod.TEMPLATES) / 256)
                        for v in (SCANNET_LABELS_20, DEFAULT_ROOM_TYPES)) if lead else 0
    expect = {"flash_attention_2d": 12 * mine, "flash_attention": 24 * mine + text.variant.t_layers * label_batches,
              "quant_matmul": 0}
    if lead:
        say(f"[x1] build_map.run, sharded_mapping on, W = {world}: {nf} keyframes in {1e3 * wall:.3f} ms "
            f"({nf / wall:.3f} keyframes/s, labels, graph build and save included), peak {peak / 2**30:.3f} GiB")
        report("x1", nf, wall, timer, launches, in_path, peak, {})
    for name, n in expect.items():
        check(launches[name] == n, f"x1: {name} launches {launches[name]} != {n}")
    ms = mapped[0]
    ff = FrameFeatures(*(torch.cat([f[i] for f in feats]) for i in range(5)))
    grid = GridSpec.centered(p.voxel_size)
    scene = scene_mod.init_scene(grid, p.point_capacity, clip.variant.embed_dim, "cuda")
    fill = {n: 0 for n in (2, 4, 8)}  # the fullest bucket a W = n exchange of these frames would fill
    for j, i in enumerate(keyframes):
        frame = ds[i]
        t = lambda a: torch.as_tensor(a, dtype=torch.float32).cuda()  # noqa: E731
        pts, cols, valid = backproject(t(frame.depth), t(frame.rgb), Pinhole.from_matrix(frame.k), t(frame.pose),
                                       1e-3, cfg.main.depth_cut)
        keys = voxel_mod.keys_of(pts, valid, grid)
        for n in fill:
            for blk, ok in zip(keys.chunk(n), valid.chunk(n)):
                u = torch.unique(blk[ok])
                fill[n] = max(fill[n], int(torch.bincount(sharded_scene._owner_of(u, n), minlength=n).max()))
        scene, rows = scene_mod.insert_points(scene, pts, cols, valid, fcap=p.frame_voxel_capacity)
        scene = scene_mod.fuse_pixel_features(scene, rows, ff.masks[j].reshape(ff.masks.shape[1], -1), ff.valid[j],
                                              ff.f_masks[j])
    got, want = sorted_scene(ms.scene), sorted_scene(scene)
    check(int(ms.scene.num) == int(scene.num), f"x1: scene rows {int(ms.scene.num)} != {int(scene.num)}")
    for f in ("key", "count", "feat_count"):
        check(np.array_equal(got[f], want[f]), f"x1: scene {f} differs from the single-device insert + fuse")
    errs = {f: float(np.abs(got[f] - want[f]).max() / max(np.abs(want[f]).max(), 1e-30))
            for f in ("sum_pts", "sum_col", "sum_feat")}
    check(all(e <= 1e-5 for e in errs.values()), f"x1: sums against the single-device scene {errs}")
    sm = mappers[0]
    check(sm.dropped == 0, f"x1: {sm.dropped} aggregates dropped in the exchange")
    buckets = {n: sharded_scene.bucket_capacity(-(-p.frame_voxel_capacity // n), n) for n in fill}
    d = clip.variant.embed_dim
    wire = {n: (n * buckets[n] * (44 + 4 * d), n * 4096 * (44 + 4 * d)) for n in fill}
    n_inst = int(ms.instances.num())
    check(n_inst >= 1 and bool(torch.isfinite(ms.instance_feats).all()), f"x1: {n_inst} instances")
    # the attention route: the reference's ShardedMapper extracts at "xla";
    # the port's at the config's (flash: K1, K2).  The same function: the
    # first batch's features through the plain versions
    sc = cfg.models.sam
    kw = dict(points_per_side=sc.points_per_side, pred_iou_thresh=sc.pred_iou_thresh,
              stability_thresh=sc.stability_score_thresh, min_area=float(sc.min_mask_region_area),
              max_masks=sc.max_masks, masked_weight=p.clip_masked_weight, bbox_margin=float(p.clip_bbox_margin))
    imgs = torch.stack([torch.as_tensor(ds[i].rgb, dtype=torch.float32).cuda() for i in keyframes[:world]])
    plain = extractor_mod.extract_frames_dp(clip, sam, imgs, mesh, impl="xla", clip_impl="xla", **kw)
    g_cos = F.cosine_similarity(ff.f_global[:world].float(), plain.f_global.float(), dim=-1).min().item()
    same_masks = float((ff.masks[:world] == plain.masks).float().mean())
    check(g_cos > 0.999, f"x1: frame features through K1/K2 against the plain path: min cosine {g_cos}")
    if lead:
        same_graph(built, HMSGraph.load(graph_dir))
        say(f"[x1] scene {int(ms.scene.num)} rows: keys, counts and feature counts equal to the single-device "
            f"insert_points + fuse_pixel_features over the same FrameFeatures; sums' max error relative to their "
            f"max {errs}; {n_inst} instances; graph {len(built.rooms)} rooms, {len(built.objects)} objects, "
            f"saved and loaded equal")
        say(f"[x1] exchange: bucket {sm.bcap} a destination rank at W = {world}, wire bytes a frame a rank "
            f"{sm.wire_bytes()}, dropped {sm.dropped}; at W = 2 / 4 / 8 the bucket would be "
            f"{' / '.join(str(buckets[n]) for n in fill)} and these frames fill at most "
            f"{' / '.join(str(fill[n]) for n in fill)} of it (the insert's distinct keys a rank and owner); "
            f"insert + fuse bytes a frame a rank {' / '.join(str(wire[n][0]) for n in fill)} against the "
            f"reference's fixed 4096-lane bucket's {' / '.join(str(wire[n][1]) for n in fill)}")
        say(f"[x1] extraction through K1/K2 (flash) against the plain path (the reference's \"xla\"), first "
            f"batch: whole-frame feature min cosine {g_cos:.6f}, mask pixels equal {same_masks:.6f}")
    check(all(fill[n] <= buckets[n] for n in fill), f"x1: bucket fills {fill} against buckets {buckets}")
    return dict(launches=launches, in_path=in_path, ms=1e3 * wall, peak=peak)


def x_topk(mesh, world, lead, say):
    """(x2) topk_cosine_sharded at retrieval_bench's gallery (4096 x 768,
    64 queries, top-5) against topk_cosine."""
    g, q, _, _ = retrieval_bench.make_inputs(4096, 64, 768, 20)
    g, q = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    valid = torch.ones(g.shape[0], dtype=torch.bool, device="cuda")
    ds_, di = retrieval_ops.topk_cosine(g, valid, q, 5)
    ss, si = retrieval_ops.topk_cosine_sharded(g, valid, q, 5, mesh)
    parity = float(np.mean([len(set(a) & set(b)) / 5 for a, b in zip(di.tolist(), si.tolist())]))
    same = bool(torch.equal(di, si)) and bool(torch.equal(ds_, ss))
    dense_ms = event_ms(lambda: retrieval_ops.topk_cosine(g, valid, q, 5))
    sharded_ms = event_ms(lambda: retrieval_ops.topk_cosine_sharded(g, valid, q, 5, mesh))
    if lead:
        say(f"[x2] topk_cosine_sharded, W = {world}, gallery 4096 x 768, 64 queries, top-5: parity {parity} "
            f"(indices and scores equal: {same}); {sharded_ms:.4f} ms a call against topk_cosine's {dense_ms:.4f} ms "
            f"(CUDA events, host included)")
    check(parity == 1.0, f"x2: parity {parity}")
    return dict(ms=sharded_ms, dense_ms=dense_ms)


def random_vlm(vv, seed):
    """A bf16 VLM with seeded random weights drawn on the card (init_vlm
    draws on the host, which takes long at TinyLlama's size): matmul weights
    normal at fan_in^-0.5, embeddings and the head at 0.02, norms 1."""
    vlm = vlm_mod.VLM(vv, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, prm in vlm.named_parameters():
            if prm.dim() == 2:
                std = 0.02 if name in ("tok_emb", "lm_head", "pos") else prm.shape[0] ** -0.5
                prm.copy_(torch.randn(prm.shape, generator=g, device="cuda") * std)
    return vlm


def x_prefill_sp(mesh, world, lead, say):
    """(x3) prefill_sp over one prompt of 1024 tokens at vlm-small and
    llava-tinyllama: its last-position logits and K/V cache within 2^-6 of
    max|ref| of the float32 prefill of the same weights, and (vlm-small)
    of prefill through K2; the bf16 prefill's own error to float32 beside
    it.  (llama's bf16 prefill rounds the normalised probabilities to bf16,
    as the reference's does; prefill_sp keeps them float32, so against
    float32 it is the closer of the two.)  Then ContinuousBatcher(mesh=...)
    over a prompt above sp_threshold: after admission its first logits and
    the slot's K/V rows within 2^-6 of max|ref| of the float32 prefill of
    the same inputs and (vlm-small) of the batcher's without a mesh, and the
    same generated tokens."""
    out = {}
    tok = tokenizer()
    words = " ".join(f"object {i} lies in room {i % 7} near the window" for i in range(X_PROMPT_SENTENCES))
    for name in ("vlm-small", "llava-tinyllama"):
        vv = vlm_mod.VARIANTS[name]
        vlm = vlm_mod.init_vlm(vv, seed=SEED, dtype=torch.bfloat16) if name == "vlm-small" else random_vlm(vv, SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
        t = 1024
        ids = torch.randint(0, min(vv.vocab, 49406), (1, t), device="cuda", generator=gen)
        ns = torch.tensor([t], device="cuda")
        emb = vlm_mod.text_prompt_embeddings(vlm, ids, ns)
        n0 = fa.flash_attention.launches
        ref_logits, ref_cache = vlm_mod.prefill(vlm, emb, ns, vlm_mod.init_cache(vv, 1, torch.bfloat16, "cuda"))
        k2 = fa.flash_attention.launches - n0
        n0 = fa.flash_attention.launches
        sp_logits, sp_cache = vlm_mod.prefill_sp(vlm, emb, ns, mesh)
        check(fa.flash_attention.launches == n0, f"x3 {name}: prefill_sp launched K2")
        check(k2 == (vv.layers if vv.arch == "gpt" else 0), f"x3 {name}: K2 launches of prefill {k2}")
        vlm32 = copy.deepcopy(vlm).float()
        f32_logits, f32_cache = vlm_mod.prefill(vlm32, emb.float(), ns, vlm_mod.init_cache(vv, 1, torch.float32, "cuda"),
                                                impl="xla")
        errs = {}
        for ref_tag, logits, cache in (("f32", f32_logits, f32_cache), ("bf16", ref_logits, ref_cache)):
            for what, a, b in (("logits", sp_logits, logits), ("k", sp_cache.k[:, :, :t], cache.k[:, :, :t]),
                               ("v", sp_cache.v[:, :, :t], cache.v[:, :, :t])):
                errs[f"{what} vs {ref_tag}"] = float((a.float() - b.float()).abs().max() / b.float().abs().max())
            errs["bf16 prefill logits vs f32"] = float((ref_logits - f32_logits).abs().max() / f32_logits.abs().max())
        held = [k for k in errs if k.endswith("vs f32") and not k.startswith("bf16")]
        if vv.arch == "gpt":
            held += [k for k in errs if k.endswith("vs bf16")]
        for k in held:
            check(errs[k] <= 2.0**-6, f"x3 {name}: {k} max error {errs[k]} of max|ref| > 2^-6")
        check(bool(torch.isfinite(sp_logits).all()), f"x3 {name}: logits")
        prefill_ms = event_ms(lambda: vlm_mod.prefill(vlm, emb, ns, vlm_mod.init_cache(vv, 1, torch.bfloat16, "cuda")),
                              calls=3)
        sp_ms = event_ms(lambda: vlm_mod.prefill_sp(vlm, emb, ns, mesh), calls=3)
        visual = clip_mod.init_clip_visual(clip_mod.VARIANTS[vv.clip_variant], seed=1, dtype=torch.bfloat16)
        texts, admitted = {}, {}
        n_prompt = len(tok.encode(words)) + 1
        check(n_prompt >= 512, f"x3: the prompt has {n_prompt} tokens, under sp_threshold")
        real_prefill, real_sp = vlm_mod.prefill, vlm_mod.prefill_sp
        for tag, kw in (("no mesh", {}), ("mesh", dict(mesh=mesh))):
            first = []  # the admission's (inputs, prompt logits): the wave's prefill (slot 0) or prefill_sp

            def rec(fn):
                def wrapped(*a, **k):
                    logits, cache = fn(*a, **k)
                    first.append((a[1][:1], a[2], logits[0].float().clone()))
                    return logits, cache
                return wrapped

            vlm_mod.prefill, vlm_mod.prefill_sp = rec(real_prefill), rec(real_sp)
            try:
                b = ContinuousBatcher(vlm, visual, max_batch=2, **kw)
                t0 = time.perf_counter()
                texts[tag] = b.generate(words, max_new_tokens=X_NEW_TOKENS)
                texts[tag + " ms"] = 1e3 * (time.perf_counter() - t0)
            finally:
                vlm_mod.prefill, vlm_mod.prefill_sp = real_prefill, real_sp
            # decode writes positions n_prompt on: the prompt's K/V rows are the admission's
            admitted[tag] = dict(logits=first[0][2], k=b.cache.k[:, 0, :n_prompt].float(),
                                 v=b.cache.v[:, 0, :n_prompt].float(),
                                 length=int(torch.as_tensor(first[0][1]).reshape(-1)[0]))
        # the float32 prefill of the mesh batcher's own prefill_sp inputs
        sp_emb, sp_len, _ = first[0]
        a_logits, a_cache = vlm_mod.prefill(vlm32, sp_emb.float(), torch.as_tensor(sp_len, device="cuda"),
                                            vlm_mod.init_cache(vv, 1, torch.float32, "cuda"), impl="xla")
        admitted["f32"] = dict(logits=a_logits[0], k=a_cache.k[:, 0, :n_prompt], v=a_cache.v[:, 0, :n_prompt])
        del vlm32, a_cache
        adm = {f"{what} vs {ref}": float((admitted["mesh"][what] - admitted[ref][what]).abs().max()
                                         / admitted[ref][what].abs().max())
               for ref in ("f32", "no mesh") for what in ("logits", "k", "v")}
        adm_held = [k for k in adm if k.endswith("f32") or vv.arch == "gpt"]
        if lead:
            say(f"[x3] {name}, W = {world}, one prompt of {t} tokens, bf16: prefill_sp's max errors relative to "
                f"max|ref| against the float32 prefill and the bf16 prefill ({'K2' if k2 else 'dense'}): {errs} "
                f"(held: {held}); prefill {prefill_ms:.3f} ms, prefill_sp {sp_ms:.3f} ms (CUDA events, host included)")
            say(f"[x3] {name}: ContinuousBatcher over a {n_prompt}-token prompt, {X_NEW_TOKENS} new tokens: "
                f"without a mesh {texts['no mesh']!r} ({texts['no mesh ms']:.1f} ms), with the mesh "
                f"{texts['mesh']!r} ({texts['mesh ms']:.1f} ms); after admission, the mesh batcher's first "
                f"logits and slot K/V rows, max error of max|ref| against the float32 prefill of its inputs and "
                f"against the batcher without a mesh: {adm} (held: {adm_held})")
        check(admitted["mesh"]["length"] == admitted["no mesh"]["length"] == n_prompt,
              f"x3 {name}: admitted lengths {admitted['mesh']['length']}, {admitted['no mesh']['length']}")
        for k in adm_held:
            check(adm[k] <= 2.0**-6,
                  f"x3 {name}: the mesh batcher's admitted {k} max error {adm[k]} of max|ref| > 2^-6")
        check(texts["mesh"] == texts["no mesh"], f"x3 {name}: the batcher with a mesh generates other tokens")
        out[name] = dict(errs=errs, admitted=adm, prefill_ms=prefill_ms, sp_ms=sp_ms)
        del vlm, visual, ref_cache, sp_cache, f32_cache
        torch.cuda.empty_cache()
    return out


def x_pipeline_moe(world, lead, say):
    """(x4) pipeline_apply over W stages (8 microbatches of (16, 256)) against
    the sequential stack, bit for bit, and moe_apply (4 experts a rank, 256
    tokens of width 256, top-2) against moe_dense_reference, under capacity
    and with drops."""
    from torch.distributed.device_mesh import DeviceMesh

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    smesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("stage",))
    stages = [{"w": torch.randn(256, 256, device="cuda", generator=gen) * 256**-0.5,
               "b": torch.zeros(256, device="cuda")} for _ in range(world)]
    x = torch.randn(8, 16, 256, device="cuda", generator=gen)
    fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])  # noqa: E731
    got = pipeline_mod.pipeline_apply(fn, pipeline_mod.stack_stages(stages), x, smesh)
    seq = torch.stack([functools.reduce(lambda h, p: fn(p, h), stages, mb) for mb in x])
    check(torch.equal(got, seq), "x4: pipeline_apply differs from the sequential stack")
    pipe_ms = event_ms(lambda: pipeline_mod.pipeline_apply(fn, pipeline_mod.stack_stages(stages), x, smesh))
    emesh = DeviceMesh("cuda", torch.arange(world), mesh_dim_names=("expert",))
    e = 4 * world
    params = {k: v.cuda() for k, v in moe_mod.init_moe_mlp(e, 256, 512, scale=0.05, seed=SEED, device="cpu").items()}
    gate_w = torch.randn(256, e, device="cuda", generator=gen) * 0.1
    toks = torch.randn(256, 256, device="cuda", generator=gen)
    dense = moe_mod.moe_dense_reference(params, gate_w, toks)
    routed = moe_mod.moe_apply(params, gate_w, toks, emesh, capacity_factor=float(e))
    err = float((routed - dense).abs().max())
    check(err <= 1e-4, f"x4: moe_apply against the dense reference {err}")
    dropped = moe_mod.moe_apply(params, gate_w, toks, emesh, capacity_factor=0.25)
    check(bool(torch.isfinite(dropped).all()), "x4: moe_apply with drops is not finite")
    moe_ms = event_ms(lambda: moe_mod.moe_apply(params, gate_w, toks, emesh, capacity_factor=float(e)))
    if lead:
        say(f"[x4] pipeline_apply, {world} stage(s) x 8 microbatches: equal to the sequential stack bit for bit, "
            f"{pipe_ms:.3f} ms; moe_apply, {e} experts: max error to the dense reference {err:.3e}, "
            f"{moe_ms:.3f} ms; with capacity factor 0.25 finite (CUDA events, host included)")
    return dict(pipeline_ms=pipe_ms, moe_ms=moe_ms, moe_err=err)


def x_train_step(mesh, world, lead, say):
    """(x5) make_train_step(mesh=...) at ViT-L/14, bf16 on float32 masters,
    B = 32, X_TRAIN_STEPS steps from (v)'s init and batch, against the
    single-device make_train_step from the same init: the first loss
    equal, the next within (v)'s relative tolerance, and the first step's
    gradients (what the optimizer steps on) within 2^-6 of the leaf's
    max|g| (floored at 1e-3 of the largest leaf's, as the CPU tests floor
    the analytically-zero key biases); the weights' difference printed."""
    cv = clip_mod.VARIANTS[CONFIG["models"]["clip"]["type"]]
    base = contrastive.clip_params(*clip_mod.init_clip(cv, seed=SEED, dtype=torch.float32))
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    imgs = torch.randn(VITL_BATCH, cv.image_size, cv.image_size, 3, device="cuda", generator=g)
    toks = torch.from_numpy(tokenizer()([f"a photo of object {i} in the scene." for i in range(VITL_BATCH)])).cuda()
    runs = {}
    for tag, m in (("single", None), ("mesh", mesh)):
        params = copy.deepcopy(base)
        step = contrastive.make_train_step(cv, contrastive.init_train_state(params, lr=X_LR), mesh=m)
        torch.cuda.reset_peak_memory_stats()
        losses, ms, grads = [], [], None
        for _ in range(X_TRAIN_STEPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            losses.append(float(step(params, imgs, toks)))
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            if grads is None:  # the gradients stay on the parameters after the update
                grads = [q.grad.float().clone() for q in params.parameters()]
        runs[tag] = (losses, ms, params, torch.cuda.max_memory_allocated() / 2**30, grads)
    (l1, ms1, p1, peak1, g1), (l2, ms2, p2, peak2, g2) = runs["single"], runs["mesh"]
    worst = max(float((a - b).detach().abs().max()) for a, b in zip(p1.parameters(), p2.parameters()))
    top = max(float(g.abs().max()) for g in g1)
    g_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3 * top) for a, b in zip(g2, g1))
    ls_err = abs(float(p2.logit_scale.grad) - float(p1.logit_scale.grad)) / max(abs(float(p1.logit_scale.grad)),
                                                                                  1e-3 * top)
    if lead:
        say(f"[x5] ViT-L/14 make_train_step, B = {VITL_BATCH}, {X_TRAIN_STEPS} steps: mesh (W = {world}) losses {l2} "
            f"({ms2} ms, peak {peak2:.3f} GiB) against single-device {l1} ({ms1} ms, peak {peak1:.3f} GiB); "
            f"first step's gradients: worst leaf's max error {g_err:.3e} of its max|g| (logit_scale "
            f"{ls_err:.3e}); weights max |diff| after the steps {worst:.3e}")
    check(abs(l2[0] - l1[0]) <= 1e-5 * abs(l1[0]), f"x5: first loss {l2[0]} != {l1[0]}")
    check(all(abs(a - b) <= VITL_LOSS_RTOL * abs(b) for a, b in zip(l2, l1)), f"x5: losses {l2} vs {l1}")
    check(g_err <= 2.0**-6, f"x5: the mesh step's gradients differ from the single-device step's by {g_err}")
    del base, runs, p1, p2, g1, g2
    torch.cuda.empty_cache()
    return dict(ms=ms2, single_ms=ms1, losses=l2)


def x_rank(rank, world, save_root):
    """Phase (x) on one rank: every item, each counted; returns the paths'
    launch counts (for the kernels line) and the numbers printed."""
    lead = rank == 0
    say = log if lead else (lambda *a: None)
    mesh = make_mesh(MeshConfig(), "cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(f"[x] W = {world} rank(s), mesh {tuple(mesh.mesh.shape)} over NCCL ({torch.distributed.get_backend()}); "
        f"card: {smi}")
    paths, numbers = {}, {}
    for tag, fn in (("(x1) ShardedMapper: build_map.run, sharded_mapping on",
                     lambda: x_sharded_mapping(mesh, world, lead, os.path.join(save_root, "x1"), say)),
                    ("(x2) topk_cosine_sharded", lambda: x_topk(mesh, world, lead, say)),
                    ("(x3) prefill_sp + ContinuousBatcher(mesh)", lambda: x_prefill_sp(mesh, world, lead, say)),
                    ("(x4) pipeline_apply, moe_apply", lambda: x_pipeline_moe(world, lead, say)),
                    ("(x5) make_train_step(mesh)", lambda: x_train_step(mesh, world, lead, say))):
        torch.cuda.reset_peak_memory_stats()
        if tag.startswith("(x1)"):
            res = fn()
            paths[tag] = dict(launches=res.pop("launches"), in_path=res.pop("in_path"))
        else:
            res, wall, launches, in_path, peak = counted(fn)
            paths[tag] = dict(launches=launches, in_path=in_path)
            res = dict(res, wall_ms=1e3 * wall, peak=peak)
        numbers[tag] = res
        say(f"[x] {tag}: {numbers[tag].get('wall_ms', numbers[tag].get('ms'))} ms, peak "
            f"{numbers[tag]['peak'] / 2**30:.3f} GiB; launches {paths[tag]['launches']}; card: {smi}")
        if lead:
            stamp(tag)
    return dict(paths=paths, numbers=numbers)


# ---------------------------------------------------------------------------
# (y): the configurations whose attention the tensor-core kernels did not
# take, and those the card had not run
# ---------------------------------------------------------------------------

# config/synthetic.yaml, field for field (the hermetic demo: test-tiny CLIP at
# float32, test-tiny SAM; the yaml leaves the extraction at its defaults,
# plain attention, untiered)
SYNTHETIC_YAML = {
    "main": {"dataset": "synthetic", "scene_id": "synthetic_demo", "save_path": "/tmp/holoagent_tpu/scene_graphs",
             "depth_cut": 20.0},
    "models": {
        "clip": {"type": "test-tiny", "dtype": "float32"},
        "sam": {"type": "test-tiny", "points_per_side": 4, "pred_iou_thresh": -10.0, "stability_score_thresh": 0.0,
                "min_mask_region_area": 20, "max_masks": 8},
    },
    "pipeline": {
        "voxel_size": 0.08, "skip_frames": 2, "grid_resolution": 0.08, "point_capacity": 32768,
        "mask_point_capacity": 512, "instance_capacity": 64, "instance_max_area_frac": 1.0,
        "instance_max_extent_m": 1.0e9, "obj_labels": "SCANNET20",
    },
}
SYNTHETIC_FEATURE_ATOL = 1e-4  # the card's float32 features against the CPU's (tests/test_torch_attention_routes.py)


def with_clip(cfg_dict, clip_type, sam_type=None, quant=False):
    """A copy of `cfg_dict` with another CLIP (and SAM) type, W8A8 towers where `quant`."""
    d = copy.deepcopy(cfg_dict)
    d["models"]["clip"]["type"] = clip_type
    if sam_type:
        d["models"]["sam"]["type"] = sam_type
    for tower in ("clip", "sam"):
        d["models"][tower]["quant"] = quant
    return d


def routes_of(launches, name) -> dict:
    return {r: n for k, n in launches.items() if k.startswith(f"{name}.") for r in [k.split(".", 1)[1]]}


def y1_vit_h14(ds, tmp, tag):
    """(y1) CLIP ViT-H-14 (visual width 1280 over 16 heads: head dim 80; its
    text tower 16 heads of 64) at config/synthetic_tpu_3room.yaml's
    settings otherwise, the towers from apps.common.load_models: the visual
    tower through K2 (resident route, D = 80) and as W8A8 against the plain
    tower; Mapper.run + finalize in bf16 and W8A8 (every K2 launch on the
    resident route, none on the general one); build_map.run, load and the
    fast queries; then query_bench --slow --vlm clip over that graph, with
    ClipVLM's features against the plain tower."""
    d, qd = with_clip(CONFIG, "ViT-H-14"), with_clip(CONFIG, "ViT-H-14", quant=True)
    cfg, qcfg = from_dict(d), from_dict(qd)
    t0 = time.perf_counter()
    clip, sam, cv, _, text = load_models(cfg)
    qclip, qsam, _, _, _ = load_models(qcfg)
    log(f"[{tag}] load_models: {cv.name} (visual {cv.v_layers} layers, width {cv.v_width}, head dim "
        f"{cv.v_width // cv.v_heads}; text {cv.t_layers} layers, head dim {cv.t_width // cv.t_heads}) + SAM "
        f"{sam.variant.name}, bf16 and W8A8, in {time.perf_counter() - t0:.3f} s")
    _, crops = tower_inputs(sam, ds[0])
    n0 = fa.flash_attention.routes["resident"]
    f_k = clip_mod.encode_image(clip, crops, impl="flash")
    check(fa.flash_attention.routes["resident"] - n0 == cv.v_layers, f"{tag}: the visual tower's K2 route")
    f_p = clip_mod.encode_image(clip, crops, impl="xla")
    q_k = clip_mod.encode_image(qclip, crops, impl="flash")
    with k3_plain():
        q_p = clip_mod.encode_image(qclip, crops, impl="xla")
    cos, qcos = (f_k * f_p).sum(-1).min().item(), (q_k * q_p).sum(-1).min().item()
    log(f"[{tag}] {cv.name} features through K2 (D = 80, resident route) vs plain: min cosine {cos:.6f}; W8A8 "
        f"through K2 and K3 vs plain: min cosine {qcos:.6f}; W8A8 vs bf16 {(q_k * f_k).sum(-1).min().item():.6f}")
    check(cos > 0.9998, f"{tag}: {cv.name} through K2 disagrees with the plain tower")
    check(qcos > 0.9994, f"{tag}: W8A8 {cv.name} through the kernels disagrees with the plain versions")
    paths = {}
    for kind, c, sm, cf in (("bf16", clip, sam, cfg), ("W8A8", qclip, qsam, qcfg)):
        path = main_path(c, sm, ds, cf, f"{tag}-{kind.lower()}", launches_a_keyframe(c, sm))
        path.pop("ms")
        routes = routes_of(path["launches"], "flash_attention")
        log(f"[{tag}-{kind.lower()}] K2 launches by route {routes}")
        check(routes["resident"] == cv.v_layers * path["nf"] and routes["general"] == 0 and routes["long"] == 0,
              f"{tag}: {kind} K2 routes {routes}")
        check({k[3] for k in path["in_path"]["flash_attention"]} == {80}, f"{tag}: K2 at a head dim other than 80")
        paths[f"(y1) ViT-H-14 {kind}: Mapper.run"] = path
    del qclip, qsam
    torch.cuda.empty_cache()
    graph = graph_path(clip, sam, text, ds, cfg, f"{tag}-graph", os.path.join(tmp, "graph"), cfg_dict=d)
    paths["(y1) ViT-H-14: build_map.run, load, queries"] = dict(graph, graph=None, answers=None)
    paths["(y1) ViT-H-14: query_bench --slow --vlm clip"] = slow_path(
        clip, sam, text, ds, cfg, graph["graph_dir"], f"{tag}-slow")
    return paths


TIE_M = 1e-5  # two keyframes this close in distance to a room tie (float32 point sums differ in the last bits)


def room_distance(room, frame) -> float:
    """A keyframe's distance to a room as HMSGraph.build assigns frames: the
    nearest of the room's points in the floor plane."""
    return float(np.min(np.linalg.norm(room.pcd_points[:, :2] - frame.pose[:2, 3], axis=1)))


def same_synthetic_graph(tag, card, cpu, ds) -> None:
    """The card's config/synthetic.yaml graph and answers against the CPU
    run's: labels, objects, rooms and views equal, features within
    SYNTHETIC_FEATURE_ATOL, the same answers to every query.  A room no
    keyframe falls in takes the nearest keyframe overall; where two
    keyframes tie for it (within TIE_M: the scene's points are float32 sums,
    whose order CUDA does not fix) either is the reference's answer, and
    that room's view and features are held to the CPU's features of the
    keyframe the card chose."""
    a, b = card["graph"], cpu["graph"]
    check([(r.room_id, r.name) for r in a.rooms] == [(r.room_id, r.name) for r in b.rooms], f"{tag}: rooms differ")
    check([(o.object_id, o.name, o.view_ids) for o in a.objects] == [(o.object_id, o.name, o.view_ids)
                                                                    for o in b.objects], f"{tag}: objects differ")
    check([v.view_id for v in a.views] == [v.view_id for v in b.views], f"{tag}: view ids differ")
    keyframe_feats = {v.img_id: v.embedding for v in b.views}  # the CPU run's, by image id
    pairs, ties = [(o.embedding, p.embedding) for o, p in zip(a.objects, b.objects)], []
    for ra, rb in zip(a.rooms, b.rooms):
        ia, ib = [v.img_id for v in ra.views], [v.img_id for v in rb.views]
        if ia == ib:
            pairs += [(ra.embeddings, rb.embeddings)]
        else:
            gap = abs(room_distance(rb, ds[ia[0]]) - room_distance(rb, ds[ib[0]])) if len(ia) == len(ib) == 1 else 1.0
            check(gap <= TIE_M, f"{tag}: room {ra.room_id}'s views {ia} on the card, {ib} on the CPU (no tie: {gap})")
            ties.append(f"room {ra.room_id}: keyframe {ia[0]} on the card, {ib[0]} on the CPU, {gap:.2e} m apart")
            pairs += [(ra.embeddings, [keyframe_feats[ia[0]]])]
        pairs += [(v.embedding, keyframe_feats[v.img_id]) for v in ra.views]
    worst = 0.0
    for x, y in pairs:
        worst = max(worst, float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max()))
    for (q, ra), (_, rb) in zip(card["answers"], cpu["answers"]):
        same = ((ra[0] and ra[0].floor_id) == (rb[0] and rb[0].floor_id)
                and [r.room_id for r in ra[1]] == [r.room_id for r in rb[1]]
                and [o.object_id for o in ra[2]] == [o.object_id for o in rb[2]])
        check(same, f"{tag}: query {q!r} answered otherwise on the CPU")
    log(f"[{tag}] the card's graph against the CPU run's: {len(a.rooms)} rooms, {len(a.objects)} objects "
        f"{sorted(o.name for o in a.objects)}, {len(a.views)} views equal (ties: {ties or 'none'}); object, room and "
        f"view features within {worst:.3e} (limit {SYNTHETIC_FEATURE_ATOL:.0e}); {len(card['answers'])} queries "
        f"answered alike")
    check(worst <= SYNTHETIC_FEATURE_ATOL, f"{tag}: features differ by {worst:.3e}")


def y2_synthetic(tmp, tag):
    """(y2) config/synthetic.yaml as it stands, the towers from load_models
    (float32 test-tiny: the text tower's K2 on the general route, head dim
    16): build_map.run, HMSGraph.load and FSRQueryEngine.query_hierarchy
    over QUERIES on the card, counted, against the same run on the CPU.
    Then the same config with the kernel extraction (extract_impl and
    extract_clip_impl "flash": test-tiny SAM's K1, head dim 32 on its 4 x 4
    grid and 2 x 2 windows, and the visual tower's K2, head dim 16, both on
    the general route), Mapper.run against the plain extraction's."""
    cfg = from_dict(SYNTHETIC_YAML)
    ds = load_dataset(cfg)
    models = load_models(cfg)
    clip, sam, text = models[0], models[1], models[4]
    check(clip.patch_w.dtype == sam.dtype == torch.float32, f"{tag}: the towers are not in the CLIP dtype")
    log(f"[{tag}] config/synthetic.yaml: {len(ds)} frames at {ds[0].rgb.shape[1]}x{ds[0].rgb.shape[0]}, CLIP "
        f"{clip.variant.name} and SAM {sam.variant.name} float32 (load_models), extraction "
        f"{cfg.pipeline.extract_impl}/{cfg.pipeline.extract_clip_impl}")
    paths = {}
    card = graph_path(clip, sam, text, ds, cfg, tag, os.path.join(tmp, "card"), cfg_dict=SYNTHETIC_YAML)
    routes = routes_of(card["launches"], "flash_attention")
    log(f"[{tag}] K2 launches by route {routes}")
    check(routes["general"] == card["launches"]["flash_attention"] > 0, f"{tag}: K2 routes {routes}")
    paths["(y2) synthetic.yaml: build_map.run, load, queries"] = dict(card, graph=None, answers=None)
    t0 = time.perf_counter()
    cpu_models = load_models(cfg, device="cpu")
    cpu_cfg = from_dict({**SYNTHETIC_YAML, "main": {**SYNTHETIC_YAML["main"], "save_path": os.path.join(tmp, "cpu")}})
    graph_dir, _ = build_map.run(cpu_cfg, dataset=ds, models=cpu_models, device="cpu")
    eng = FSRQueryEngine(HMSGraph.load(graph_dir), cpu_models[4], tokenizer(), device="cpu")
    cpu = dict(graph=HMSGraph.load(graph_dir), answers=[(q, eng.query_hierarchy(q)) for q in QUERIES])
    log(f"[{tag}] the same config on the CPU: {time.perf_counter() - t0:.3f} s")
    same_synthetic_graph(tag, card, cpu, ds)
    # the kernel extraction: K1 and K2 on the general route, against the plain extraction
    fd = copy.deepcopy(SYNTHETIC_YAML)
    fd["pipeline"].update(extract_impl="flash", extract_clip_impl="flash")
    fcfg = from_dict(fd)
    Mapper(fcfg, clip, sam).process_frame(ds[0])  # warm-up
    ms, wall, launches, in_path, peak = counted(lambda: Mapper(fcfg, clip, sam).run(ds))
    plain = Mapper(cfg, clip, sam).run(ds)
    nf = len(ms.keyframes)
    per = launches_a_keyframe(clip, sam, fcfg)
    k1r, k2r = routes_of(launches, "flash_attention_2d"), routes_of(launches, "flash_attention")
    diff = (ms.keyframe_feats - plain.keyframe_feats).abs().max().item()
    log(f"[{tag}-flash] Mapper.run with extract_impl and extract_clip_impl flash: {nf} keyframes in {wall:.3f} s; "
        f"launches {launches}; keyframe features against the plain extraction's within {diff:.3e}; scene rows "
        f"{int(ms.scene.num)} / {int(plain.scene.num)}, instances {int(ms.instances.num())} / "
        f"{int(plain.instances.num())}")
    for name, n in per.items():
        check(launches[name] == n * nf, f"{tag}-flash: {name} launches {launches[name]} != {n} x {nf}")
    check(k1r["general"] == launches["flash_attention_2d"] > 0 and k2r["general"] == launches["flash_attention"] > 0,
          f"{tag}-flash: routes K1 {k1r} K2 {k2r}")
    check(diff <= SYNTHETIC_FEATURE_ATOL and int(ms.scene.num) == int(plain.scene.num),
          f"{tag}-flash: the kernel extraction's map differs from the plain one's")
    paths["(y2) synthetic.yaml, extraction flash: Mapper.run"] = dict(launches=launches, in_path=in_path, nf=nf)
    return paths


def y3_widths(ds, tag):
    """(y3) CLIP ViT-B-32 (the config's default: T = 50, head dim 64; its
    text tower 8 heads of 64) and SAM vit_l (16 heads of 64, global layers
    5, 11, 17, 23), each in Mapper.run + finalize at the 3-room yaml's
    settings otherwise (towers from load_models, bf16); the ViT-B-32 text
    tower against its plain version."""
    paths = {}
    for name, d in (("ViT-B-32", with_clip(CONFIG, "ViT-B-32")), ("vit_l", with_clip(CONFIG, "ViT-L-14", "vit_l"))):
        cfg = from_dict(d)
        clip, sam, cv, sv, text = load_models(cfg)
        log(f"[{tag}] {name}: CLIP {cv.name} (T = {(cv.image_size // cv.patch) ** 2 + 1}, head dim "
            f"{cv.v_width // cv.v_heads}), SAM {sv.name} ({sv.depth} layers, head dim {sv.width // sv.heads}, global "
            f"layers {sv.global_idx})")
        path = main_path(clip, sam, ds, cfg, f"{tag}-{name}", launches_a_keyframe(clip, sam))
        path.pop("ms")
        paths[f"(y3) {name}: Mapper.run"] = path
        if name == "ViT-B-32":
            text_tower_check(text)
        del clip, sam, text
        torch.cuda.empty_cache()
    return paths


def y5_layouts(clip, sam, text, root, tag):
    """(y5) the ScanNet and iPhone layouts: 12 frames of the three-room walk
    at 640x480 written by dataloader/export.py, read back through the
    port's loaders (every frame held to the written one) into build_map.run
    at the 3-room yaml's settings."""
    paths = {}
    k = hm3dsem_k(480, 640)
    frames, _ = render_walk(SyntheticScene.three_room(SEED + 2), FRAMES, (480, 640), k)
    for layout in ("scannet", "iphone"):
        d = copy.deepcopy(CONFIG)
        d["main"].update(dataset=layout, dataset_path=os.path.join(root, layout), scene_id="scene0000_00",
                         save_path=os.path.join(root, f"{layout}-graphs"))
        cfg = from_dict(d)
        scene_dir = os.path.join(cfg.main.dataset_path, cfg.main.scene_id)
        if layout == "scannet":
            back = write_scannet(scene_dir, frames, cfg.main.depth_cut)
            ds = load_dataset(cfg)
            check(isinstance(ds, ScannetDataset), f"{tag}: load_dataset gave {type(ds).__name__}")
            loader_frames_equal(f"{tag}-{layout}", ds, back)
        else:  # apps.common.load_dataset has no iphone entry, as the reference's: the loader directly
            back = write_iphone(scene_dir, frames, cfg.main.depth_cut)
            ds = IPhoneDataset(cfg.main.dataset_path, cfg.main.scene_id, cfg.main.depth_cut)
            loader_frames_equal(f"{tag}-{layout}", ds, back, QUAT_POSE_ATOL)
        paths[f"(y5) {layout} layout: build_map.run"] = build_path(
            f"{tag}-{layout}", cfg, (clip, sam, clip.variant, sam.variant, text), ds,
            label_batches(cfg.pipeline.obj_labels, "ROOM_TYPES"), dataset=ds)
    return paths


# (z): config/synthetic_tpu_3room.yaml with models.clip.dtype float32 (the
# towers in float32; load_models builds SAM in the CLIP dtype)
Z_CONFIG = copy.deepcopy(CONFIG)
for _tower in ("clip", "sam"):
    Z_CONFIG["models"][_tower]["dtype"] = "float32"


def z_plain(models, ds):
    """(z)'s reference: the same Mapper with the plain extraction
    (extract_impl and extract_clip_impl "xla") on the card."""
    d = copy.deepcopy(Z_CONFIG)
    d["pipeline"].update(extract_impl="xla", extract_clip_impl="xla")
    return Mapper(from_dict(d), models[0], models[1]).run(ds)


def z_f32_mapper(ds, tag, models=None, plain=None):
    """(z) the float32 production Mapper: config/synthetic_tpu_3room.yaml
    field for field with models.clip.dtype float32 (SAM vit_b and CLIP
    ViT-L/14 in float32 from load_models, random weights, tiered
    extraction, the paired fold, 640x480, 6 keyframes): Mapper.run +
    finalize, counted; every K1 and K2 launch on the general route (G2);
    its keyframe features against the plain extraction's (`plain`, else
    z_plain) within SYNTHETIC_FEATURE_ATOL, scene rows and instances equal.
    `models`: load_models' five values, else loaded here."""
    cfg = from_dict(Z_CONFIG)
    models = models or load_models(cfg)
    clip, sam = models[0], models[1]
    check(clip.patch_w.dtype == sam.dtype == torch.float32, f"{tag}: the towers are not float32")
    path = main_path(clip, sam, ds, cfg, tag, launches_a_keyframe(clip, sam))
    k1r, k2r = routes_of(path["launches"], "flash_attention_2d"), routes_of(path["launches"], "flash_attention")
    check(k1r["general"] == path["launches"]["flash_attention_2d"] > 0
          and k2r["general"] == path["launches"]["flash_attention"] > 0, f"{tag}: routes K1 {k1r} K2 {k2r}")
    plain = plain if plain is not None else z_plain(models, ds)
    ms = path.pop("ms")
    diff = (ms.keyframe_feats - plain.keyframe_feats).abs().max().item()
    nf = path["nf"]
    attn = sum(t for name in ("flash_attention_2d", "flash_attention") for _, t in path["in_path"][name].values())
    path.update(kf_s=nf / path["wall"], attention_ms_a_keyframe=attn / nf, feature_err=diff,
                mask_encoder_ms=path["stages"].get("mask.encoder", 0.0) / nf,
                clip_encoder_ms=path["stages"].get("clip.encoder", 0.0) / nf)
    log(f"[{tag}] float32 Mapper: {path['kf_s']:.3f} kf/s, attention {path['attention_ms_a_keyframe']:.4f} ms a "
        f"keyframe in the run (K1 {k1r}, K2 {k2r}), mask.encoder {path['mask_encoder_ms']:.3f} ms and clip.encoder "
        f"{path['clip_encoder_ms']:.3f} ms a keyframe, peak {path['peak'] / 2**30:.3f} GiB; keyframe features "
        f"against the plain extraction's within {diff:.3e} (limit {SYNTHETIC_FEATURE_ATOL:.0e}); scene rows "
        f"{int(ms.scene.num)} / {int(plain.scene.num)}, instances {int(ms.instances.num())} / "
        f"{int(plain.instances.num())}")
    check(diff <= SYNTHETIC_FEATURE_ATOL, f"{tag}: keyframe features differ from the plain extraction's by {diff:.3e}")
    check(int(ms.scene.num) == int(plain.scene.num) and int(ms.instances.num()) == int(plain.instances.num()),
          f"{tag}: scene rows or instances differ from the plain extraction's")
    return path


def y_phase(clip, sam, text, ds, tmp):
    """(y1)-(y5), each path counted; returns the paths."""
    paths = y1_vit_h14(ds, os.path.join(tmp, "y1"), "y1")
    torch.cuda.empty_cache()
    stamp("(y1) ViT-H-14")
    paths.update(y2_synthetic(os.path.join(tmp, "y2"), "y2"))
    stamp("(y2) config/synthetic.yaml")
    paths.update(y3_widths(ds, "y3"))
    stamp("(y3) ViT-B-32, vit_l")
    paths["(y4) serving: serving_bench vlm-base"] = serving_path(
        "y4", "vlm-base", None, batch=8, requests=16, new_tokens=32, chunk=8, chain_calls=5)
    torch.cuda.empty_cache()
    stamp("(y4) serving: serving_bench vlm-base")
    paths.update(y5_layouts(clip, sam, text, os.path.join(tmp, "y5"), "y5"))
    stamp("(y5) ScanNet and iPhone layouts")
    return paths


def hold_new_shapes(cases, paths):
    """A case for every K1, K2, K3, NMS and mask-head shape a path launched
    that no case held: K1 and K2 as views of one packed projection, as
    _attention_2d and _attend launch them; K3 as the towers' linears
    (k3_case); NMS as a clustered draw of that many candidates; the mask
    head on random inputs at its widths."""
    held = {c["key"] for c in cases.values()}
    gen = torch.Generator().manual_seed(SEED + 3)
    nms_rng = np.random.default_rng(SEED + 6)
    k3_gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    dtypes = {v: k for k, v in TYPE_NAMES.items()}
    for kernel in WRAPPERS:
        for key in sorted({k for path in paths.values() for k in path["in_path"][kernel] if k not in held}):
            if kernel == "flash_attention":
                check(len(key) == 6, f"K2 launched with fewer queries than keys at {key}: no Hiera row holds it")
                b, h, t, d, causal, dt = key
                c = k2_case(f"k2_b{b}_h{h}_t{t}_d{d}{'_causal' if causal else ''}_{dt}", b, h, t, causal, gen,
                            packed=True, d=d, dtype=dtypes[dt])
                log_attention_case(c)
            elif kernel == "flash_attention_2d":
                b, heads, gh, gw, d, dt = key
                check(gh == gw, f"K1 launched on a {gh}x{gw} grid: no case builds it")
                c = k1_case(f"k1_b{b}_h{heads}_g{gh}_d{d}_{dt}", b, heads, gh, gen, d=d, dtype=dtypes[dt])
                log_attention_case(c)
            elif kernel == "mask_head":
                p, g, dt = key
                c = mask_head_case(f"mask_head_p{p}_g{g}_{dt}", _mask_head_cases.head_inputs(
                    p, g, dtypes[dt], seed=SEED + 7, device="cuda"), dt == "f32")
            elif kernel == "nms":
                m, = key
                scores = np.round(nms_rng.uniform(0, 1, m), 1).astype(np.float32)
                c = nms_case_run(f"nms_m{m}", torch.from_numpy(clustered_boxes(nms_rng, m)), torch.from_numpy(scores),
                                 torch.from_numpy(nms_rng.uniform(size=m) < 0.8), 0.7, {})
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
            if name == "nms":  # no library call computes it
                sums = {f: sum(r[0] * by_key[k][f] for k, r in runs.items()) for f in ("ms", "plain_ms", "host_ms")}
                log(f"[paths] {tag}: nms {n} launches, {sum(r[1] for r in runs.values()):.4f} ms in the run; summed "
                    f"phase {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f}, host {sums['host_ms']:.4f} ms")
                continue
            if name == "mask_head":  # no library call computes it
                sums = {f: sum(r[0] * by_key[k][f] for k, r in runs.items()) for f in ("ms", "plain_ms", "bound_ms")}
                log(f"[paths] {tag}: mask_head {n} launches, {sum(r[1] for r in runs.values()):.4f} ms in the run; "
                    f"summed phase {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f}, bound {sums['bound_ms']:.4f} ms")
                continue
            sums = {f: sum(r[0] * by_key[k][f] for k, r in runs.items())
                    for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"[paths] {tag}: {name} {n} launches, {sum(r[1] for r in runs.values()):.4f} ms in the run; summed "
                f"phase {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f}, library {sums['library_ms']:.4f} "
                f"({sums['ms'] / sums['library_ms']:.2f}x), bound {sums['bound_ms']:.4f} ms")


SOURCE_FA = "holoagent_tpu_torch/csrc/flash_attention.cu"
SAM2_PATH = "(k2) SAM 2.1 Hiera-L: Mapper.run"
Z_PATH = "(z) float32 Mapper.run"
# (wrapper, route ("tensor" for every route but "general", None for K3's
# one), the dtype's trace name or None for any, the kernel, source, the TPU
# kernel, main path): the tensor-core routes on the bf16 Mapper; the
# general route's G2 (float32, 3xTF32) on (z) for both wrappers, its G1
# (bf16) on (y2)'s graph path (the text batches: no path sends K1 to G1,
# which the kernel phase holds)
KERNELS = (
    ("flash_attention_2d", "tensor", None, "tensor cores", SOURCE_FA, "holoagent_tpu/ops/flash_attention.py:157",
     "bf16"),
    ("flash_attention", "tensor", None, "tensor cores", SOURCE_FA, "holoagent_tpu/ops/flash_attention.py:217", "bf16"),
    ("flash_attention_2d", "general", "f32", "G2 g2_tf32x3_kernel", SOURCE_FA,
     "holoagent_tpu/ops/flash_attention.py:157", Z_PATH),
    ("flash_attention", "general", "f32", "G2 g2_tf32x3_kernel", SOURCE_FA,
     "holoagent_tpu/ops/flash_attention.py:217", Z_PATH),
    ("flash_attention", "general", "bf16", "G1 g1_bf16_kernel", SOURCE_FA, "holoagent_tpu/ops/flash_attention.py:217",
     "(y2) synthetic.yaml: build_map.run, load, queries"),
    ("quant_matmul", None, None, "W8A8 GEMM", "holoagent_tpu_torch/csrc/quant_matmul.cu",
     "holoagent_tpu/ops/quant_matmul.py:70", "w8a8"),
)


def key_route(kernel, key):
    """The route an attention launch of trace key `key` took (None for K3)."""
    dtypes = {v: k for k, v in TYPE_NAMES.items()}
    if kernel == "flash_attention":
        b, h, t, d, causal, dt = key[:6]
        return fa.k2_route(t, causal, d, dtypes[dt]) if len(key) == 6 else "general"  # Tk appended: pooled queries
    if kernel == "flash_attention_2d":
        b, heads, gh, gw, d, dt = key
        return fa.k1_route(gh, gw, d, dtypes[dt])
    return None


def kernels_line(cases, paths):
    """One entry per kernel, for its main-path run: the bf16 Mapper run for
    K1 and K2 (the tensor-core routes), (z) for the general route's G2
    (both wrappers, float32), (y2)'s graph path for its G1 (the bf16 text
    batches), the W8A8 Mapper run for K3.
    `ms` is the kernel's device time inside that run (CUDA events around
    each launch).  `isolated_ms`, `plain_ms`, `library_ms` and `bound_ms`
    are the kernel phase's per-launch numbers at each launch's shape,
    summed over the run's launches; `ratio_to_library` is `isolated_ms`
    over `library_ms`, both device time with the stream held, so host work
    inside the in-run events does not count against the kernel.
    `launches_by_path` has every counted path's launches (of the route, for
    a route's entry).  `cases` holds the per-launch numbers themselves."""
    by_key = {c["key"]: c for c in cases.values()}
    line = []
    for name, route, dtype, kernel, source, replaces, main in KERNELS:
        for tag, path in paths.items():
            unchecked = [k for k in path["in_path"][name] if k not in by_key]
            check(not unchecked, f"{name}: the {tag} path launched shapes {unchecked} that no kernel phase held")
        count = name if route in (None, "tensor") else f"{name}.{route}"

        def ours(key):
            r = key_route(name, key)
            return (route in (None, r) or (route == "tensor" and r != "general")) and dtype in (None, key[-1])

        runs = {k: r for k, r in paths[main]["in_path"][name].items() if ours(k)}
        nf, launches, counter = paths[main]["nf"], sum(n for n, _ in runs.values()), paths[main]["launches"]
        # the wrappers' own counts where they separate the entry's launches
        counted_here = {None: counter[name], "tensor": counter[name] - counter.get(f"{name}.general", 0)}
        check(launches > 0 and (dtype is not None or launches == counted_here[route]),
              f"{count} ({kernel}): not launched on its main path")

        def summed(field):
            return sum(n * by_key[k][field] for k, (n, _) in runs.items())

        dominant = max(runs, key=lambda k: runs[k][0] * by_key[k]["bound_ms"])
        mine = [{f: v for f, v in c.items() if f not in ("key", "kernel")}
                for c in cases.values() if c["kernel"] == name and ours(c["key"])]
        in_run = sum(t for _, t in runs.values())
        line.append({
            "name": f"{count} ({kernel})", "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": in_run, "plain_ms": summed("plain_ms"),
            "bound_ms": summed("bound_ms"), "bound_by": by_key[dominant]["bound_by"],
            "library_ms": summed("library_ms"), "isolated_ms": summed("ms"),
            "ratio_to_library": summed("ms") / summed("library_ms"),
            "per": f"the counted {main} run: {launches} launches over {nf} keyframes",
            "launches_by_path": {tag: sum(n for k, (n, _) in path["in_path"][name].items() if ours(k))
                                 for tag, path in paths.items()},
            "cases": mine,
        })
    line.append(nms_line(by_key, cases, paths))
    line.append(mask_head_line(by_key, cases, paths))
    return {"kernels": line}


def nms_line(by_key, cases, paths) -> dict:
    """The kernels line's NMS entry, for the bf16 Mapper run: one launch a
    keyframe; no library call computes the function."""
    for tag, path in paths.items():
        unchecked = [k for k in path["in_path"]["nms"] if k not in by_key]
        check(not unchecked, f"nms: the {tag} path launched shapes {unchecked} that no kernel phase held")
    runs, nf = paths["bf16"]["in_path"]["nms"], paths["bf16"]["nf"]
    launches = sum(n for n, _ in runs.values())
    check(launches == nf == paths["bf16"]["launches"]["nms"], f"nms: {launches} launches over {nf} keyframes")

    def summed(field):
        return sum(n * by_key[k][field] for k, (n, _) in runs.items())

    return {
        "name": "nms (greedy NMS, one block)", "route": "cuda", "source": "holoagent_tpu_torch/csrc/masks.cu",
        "replaces": "holoagent_tpu/ops/masks.py:69-93 (fori_loop; no pallas_call)", "launches": launches,
        "max_abs_err": 0.0, "ms": sum(t for _, t in runs.values()), "plain_ms": summed("plain_ms"),
        "bound_ms": summed("bound_ms"), "bound_by": "latency: a launch and the greedy scan's chain",
        "library_ms": None, "isolated_ms": summed("ms"), "host_ms": summed("host_ms"),
        "plain_host_ms": summed("plain_host_ms"), "ratio_to_library": None,
        "per": f"the counted bf16 run: {launches} launches over {nf} keyframes",
        "launches_by_path": {tag: sum(n for n, _ in path["in_path"]["nms"].values()) for tag, path in paths.items()},
        "cases": [{f: v for f, v in c.items() if f not in ("key", "kernel")} for c in cases.values()
                  if c["kernel"] == "nms"],
    }


def mask_head_line(by_key, cases, paths) -> dict:
    """The kernels line's mask-head entry, for SAM 2.1's Mapper run (k2): one
    launch a decoder pass; no library call computes the function."""
    for tag, path in paths.items():
        unchecked = [k for k in path["in_path"].get("mask_head", {}) if k not in by_key]
        check(not unchecked, f"mask_head: the {tag} path launched shapes {unchecked} that no kernel phase held")
    runs, nf = paths[SAM2_PATH]["in_path"]["mask_head"], paths[SAM2_PATH]["nf"]
    launches = sum(n for n, _ in runs.values())
    check(launches == paths[SAM2_PATH]["launches"]["mask_head"] > 0, f"mask_head: {launches} launches over {nf} keyframes")

    def summed(field):
        return sum(n * by_key[k][field] for k, (n, _) in runs.items())

    mine = [c for c in cases.values() if c["kernel"] == "mask_head"]
    return {
        "name": "mask_head (SAM 2's mask head)", "route": "cuda", "source": "holoagent_tpu_torch/csrc/mask_head.cu",
        "replaces": "models/sam2.py's plain head (no pallas_call: the JAX package has no SAM 2)",
        "launches": launches, "max_abs_err": max(c["max_abs_err"] for c in mine),
        "ms": sum(t for _, t in runs.values()), "plain_ms": summed("plain_ms"), "bound_ms": summed("bound_ms"),
        "bound_by": "bytes", "library_ms": None, "isolated_ms": summed("ms"), "ratio_to_library": None,
        "per": f"the counted {SAM2_PATH} run: {launches} launches over {nf} keyframes",
        "launches_by_path": {tag: sum(n for n, _ in path["in_path"].get("mask_head", {}).values())
                             for tag, path in paths.items()},
        "cases": [{f: v for f, v in c.items() if f not in ("key", "kernel")} for c in mine],
    }


def build_all():
    """One nvcc per kernel source and the native runtime's build (one host
    compiler a source), all started together."""
    t0 = time.perf_counter()
    builds = {"flash_attention": fa.LIB.build, "quant_matmul": qm.LIB.build, "masks": masks_mod.LIB.build,
              "mask_head": mh_mod.LIB.build, "native": native.build}
    with ThreadPoolExecutor(len(builds)) as ex:
        built = {name: ex.submit(build) for name, build in builds.items()}
        built = {name: f.result() for name, f in built.items()}
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {', '.join(p.name for p in built.values())}")
    for name, lib in built.items():
        if name == "native":
            continue
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def init_hiera_l():
    """The seeded bf16 SAM 2.1 Hiera-L (the seed of the main paths' SAM)."""
    return sam2_mod.init_sam2(sam2_mod.VARIANTS["sam2.1_hiera_l"], seed=SEED + 1, dtype=torch.bfloat16)


def sam2_path(clip, sam2, ds, tag):
    """Mapper.run + finalize with SAM 2.1 Hiera-L as the segmenter
    (``models.sam.type`` sam2.1_hiera_l) at its generator's 32 x 32 prompts
    (3,072 candidates: NMS's grid route), the main paths' other settings;
    every Hiera block's attention counted on K2's general route, the
    pooling blocks' as pooled-query launches."""
    cfg_dict = copy.deepcopy(CONFIG)
    cfg_dict["models"]["sam"].update(type="sam2.1_hiera_l", points_per_side=32)
    cfg = from_dict(cfg_dict)
    expect = launches_a_keyframe(clip, sam2, cfg)
    log(f"[{tag}] SAM 2.1 {sam2.variant.name} ({len(sam2.encoder.plan)} blocks, head dim {HIERA_D}), CLIP "
        f"{clip.variant.name}, bf16: expected launches a keyframe {expect}")
    path = main_path(clip, sam2, ds, cfg, tag, expect)
    check(set(path["in_path"]["nms"]) == {(3 * 32 * 32,)}, f"{tag}: NMS shapes {set(path['in_path']['nms'])}")
    return path


def hiera_only() -> int:
    """``python3 chip_smoke.py --hiera``: the build and the SAM 2 Hiera-L
    attention phase alone, then its cases as one JSON line."""
    build_all()
    ds = mapping_frames()
    cases = hiera_phase(init_hiera_l(), ds[0], [ds[i] for i in range(0, len(ds), CONFIG["pipeline"]["skip_frames"])])
    print(json.dumps({k: {f: v for f, v in c.items() if isinstance(v, (int, float, str, tuple))}
                      for k, c in cases.items()}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--hiera"]:
        return hiera_only()
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
    ds = mapping_frames()
    log(f"[setup] bf16 and W8A8 towers (SAM vit_b and vit_h) + {len(ds)} rendered frames in "
        f"{time.perf_counter() - t0:.2f} s")

    e_bf16, f_bf16 = tower_checks(clip, sam, ds[0])
    q8_tower_checks(qclip, qsam, ds[0], e_bf16, f_bf16)
    text_tower_check(text)
    vit_h_tower_checks(sam_h, qsam_h, ds[0])
    cases.update(nms_phase((("vit_h_bf16", sam_h, 12), ("vit_b_w8a8", qsam, 12), ("vit_b_bf16", sam, 4),
                            ("vit_b_bf16", sam, 32)), ds[0]))
    stamp("NMS kernel phase")
    del sam_h
    stamp("set-up and tower checks")
    torch.cuda.empty_cache()
    sam2 = init_hiera_l()
    cases.update(hiera_phase(sam2, ds[0]))
    stamp("SAM 2 Hiera-L attention phase")
    paths = {"bf16": main_path(clip, sam, ds, cfg, "main", {"flash_attention_2d": 12, "flash_attention": 24,
                                                             "quant_matmul": 0, "nms": 1, "mask_head": 0})}
    q8_expect = {"flash_attention_2d": 12, "flash_attention": 24, "quant_matmul": 144, "nms": 1, "mask_head": 0}
    paths["w8a8"] = main_path(qclip, qsam, ds, qcfg, "w8a8", q8_expect)
    paths["w8a8 extraction, clip_qmm=pallas"] = extraction_path(
        qclip, qsam, ds, qcfg, "w8a8-pallas", q8_expect, paths["w8a8"]["ms"].keyframe_feats)
    paths["(k) vit_h W8A8: Mapper.run"] = operating_point_path(qclip, qsam_h, ds, hcfg, "vit_h-w8a8")
    del qsam_h
    paths[SAM2_PATH] = sam2_path(clip, sam2, ds, "sam2")
    del sam2
    paths[SAM2_PATH].pop("ms")
    torch.cuda.empty_cache()
    paths.update(batched_path(clip, sam, ds, CONFIG, "batched"))
    paths["(l) batched extraction, W8A8, pairs"] = batched_w8a8_extraction(
        qclip, qsam, ds, qcfg, paths["w8a8"]["ms"].keyframe_feats, "batched-w8a8")
    stamp("(a)-(d), (k), (l)")
    span_path(clip, sam, ds, CONFIG, "spans")
    stamp("(sp) stage spans")
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
        calls = collections.defaultdict(list)
        with counting(calls):
            mission, wall, launches, in_path, peak = counted(lambda: mission_path(
                text, os.path.join(oracle_dir, "three_room_seed0"), tmp, "mission"))
        log(f"[mission] {wall:.3f} s, peak {peak / 2**30:.3f} GiB, launches {launches}; padded text batches "
            f"{len(calls['text'])}")
        check(launches["flash_attention"] == text.variant.t_layers * sum(calls["text"]) > 0
              and launches["flash_attention_2d"] == 0 and launches["quant_matmul"] == 0,
              f"mission: launches {launches} for {sum(calls['text'])} text batches")
        paths["(r) mission: goal service, navigation graph, costmap, localizer, navigators"] = dict(
            launches=launches, in_path=in_path)
        stamp("(r) mission")
        relo, wall, launches, in_path, peak = counted(lambda: relocalization_path("relocalization"))
        check(all(n == 0 for n in launches.values()), f"relocalization: launches {launches}")
        paths["(s) relocalization: merge_sessions, Relocalizer"] = dict(launches=launches, in_path=in_path)
        stamp("(s) relocalization")
        lio, wall, launches, in_path, peak = counted(lambda: lio_path("lio"))
        check(all(n == 0 for n in launches.values()), f"lio: launches {launches}")
        paths["(t) lio_bench"] = dict(launches=launches, in_path=in_path)
        stamp("(t) lio_bench")
        t0 = time.perf_counter()
        fixture_ds = zoo._fixture_datasets()
        for d in fixture_ds:
            for i in range(len(d)):
                d[i]  # render up front: data set-up is not training time
        log(f"[training] {sum(len(d) for d in fixture_ds)} fixture frames at 240x320 rendered in "
            f"{time.perf_counter() - t0:.3f} s (set-up)")
        towers, wall, launches, in_path, peak = counted(lambda: fixture_training_path(
            fixture_ds, os.path.join(tmp, "towers"), os.path.join(tmp, "fixture_trace"), "training"))
        log(f"[training] {wall:.3f} s, peak {peak / 2**30:.3f} GiB, launches {launches}")
        check(all(n == 0 for n in launches.values()), f"training: launches {launches}")
        paths["(u) fixture training"] = dict(launches=launches, in_path=in_path)
        stamp("(u) fixture training")
        _, wall, launches, in_path, peak = counted(lambda: neural_row_path(towers, "neural"))
        log(f"[neural] {wall:.3f} s, peak {peak / 2**30:.3f} GiB, launches {launches}")
        check(all(n == 0 for k, n in launches.items() if not k.startswith("nms")),
              f"neural row: launches {launches} (impl=\"xla\" everywhere; NMS is the kernel on any CUDA tensor)")
        paths["(u) neural row: eval_protocol.run(neural=True)"] = dict(launches=launches, in_path=in_path)
        stamp("(u) neural row")
        _, wall, launches, in_path, peak = counted(lambda: correctness_path(towers, os.path.join(tmp, "suite"), "suite"))
        log(f"[suite] {wall:.3f} s, peak {peak / 2**30:.3f} GiB, launches {launches}")
        check(launches["flash_attention_2d"] == 0 and launches["quant_matmul"] == 0,
              f"correctness suite: launches {launches} (the tiny towers run impl=\"xla\"; K2 only in the served VLM)")
        paths["(u) correctness_suite.run_suite"] = dict(launches=launches, in_path=in_path)
        stamp("(u) correctness suite")
        del towers, fixture_ds
        refuse_autograd_check("autograd")
        _, wall, launches, in_path, peak = counted(lambda: vit_l_training_path("vit-l-train"))
        check(all(n == 0 for n in launches.values()), f"ViT-L/14 training: launches {launches}")
        paths["(v) ViT-L/14 make_train_step"] = dict(launches=launches, in_path=in_path)
        _, wall, launches, in_path, peak = counted(lambda: distill_path("distill"))
        check(all(n == 0 for n in launches.values()), f"distill: launches {launches}")
        paths["(v) distill_step vlm-small"] = dict(launches=launches, in_path=in_path)
        stamp("(v) training steps at full width")
        _, wall, launches, in_path, peak = counted(lambda: text_q8_path(
            text, os.path.join(oracle_dir, "three_room_seed0", "graph"), "text-w8a8"))
        paths["(w) W8A8 text tower"] = dict(launches=launches, in_path=in_path)
        stamp("(w) W8A8 text tower")
        torch.cuda.empty_cache()
        paths.update(y_phase(clip, sam, text, ds, os.path.join(tmp, "y")))
        paths[Z_PATH] = z_f32_mapper(ds, "z")
        torch.cuda.empty_cache()
        stamp("(z) float32 Mapper")
        X_SHARED.update(clip=clip, sam=sam, text=text, ds=ds)
        torch.cuda.empty_cache()
        x = launch.spawn(x_rank, torch.cuda.device_count(), "cuda", args=(os.path.join(tmp, "x"),))[0]
        paths.update(x["paths"])
        X_SHARED.clear()
        stamp("(x) multi-device")
        check(not DEFERRED, f"accuracy gates missed in (u): {DEFERRED}")
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
