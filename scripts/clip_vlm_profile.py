"""Where the time of the slow path's CLIP calls goes on one GPU: wall clock
against device time.

    python3 scripts/clip_vlm_profile.py [--reps 10]

Runs ``ClipVLM._img_feats`` (preprocess + the ViT-L/14 visual tower in
bf16, attention through K2, features back on the host) on 480x640 frames
resident on the card, at the batch sizes the slow path encodes (1, 2, 6,
24, 64), and one multi-template text batch (256 padded prompts through the
text tower, causal attention through K2), each `reps` times after a
warm-up, under ``torch.profiler`` (random weights from seed 0).  Prints per
call: the synchronised wall time, the device time summed over the traced
kernels, the device's idle share (one stream: 1 - device / wall), the
kernels launched, and the kernels with the most device time.  Exits
non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from holoagent_tpu_torch.models import clip as clip_mod  # noqa: E402
from holoagent_tpu_torch.models.tokenizer import SimpleTokenizer  # noqa: E402
from holoagent_tpu_torch.query import ClipVLM  # noqa: E402

BATCHES = (1, 2, 6, 24, 64)


def profile_call(tag: str, fn, reps: int) -> None:
    for i in range(2):
        fn(-1 - i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] wall {wall:.3f} ms a call; the profiler recorded no device activity")
        return
    device = sum(e.device_time for e in kernels) / 1e3 / reps  # us -> ms
    print(f"[{tag}] wall {wall:.3f} ms a call, device {device:.3f} ms, idle share {1 - device / wall:.3f}, "
          f"{len(kernels) / reps:.0f} kernels a call")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time / 1e3)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]:
        print(f"[{tag}]   {t / reps:8.3f} ms  {n / reps:5.0f} launches  {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("clip_vlm_profile: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}")
    visual, text = clip_mod.init_clip(clip_mod.VARIANTS["ViT-L-14"], seed=0, dtype=torch.bfloat16)
    vlm = ClipVLM(visual, text, SimpleTokenizer())
    gen = torch.Generator().manual_seed(0)
    frames = torch.rand(max(BATCHES), 480, 640, 3, generator=gen).cuda()
    imgs = list(frames)  # resident keyframes, as the slow path's image provider hands them over
    for b in BATCHES:
        profile_call(f"visual B={b}", lambda i, b=b: vlm._img_feats(imgs[:b]), args.reps)
    profile_call("text batch", lambda i: vlm._txt_feats([f"object number {i}"]), args.reps)  # a new label each call
    return 0


if __name__ == "__main__":
    sys.exit(main())
