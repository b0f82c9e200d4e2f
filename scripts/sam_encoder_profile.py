"""Where the time of SAM's image encoder goes on one GPU: wall clock
against device time.

    python3 scripts/sam_encoder_profile.py [--reps 10]

Runs ``encode_image(impl="flash")`` of the SAM vit_b encoder (random
weights from seed 1) on one 1024x1024 input, in bf16 and as the W8A8
encoder of ``quantize_sam``, `reps` times each after a warm-up, under
``torch.profiler``.  Prints per call: the synchronised wall time, the
device time summed over the traced kernels, the device's idle share (one
stream: 1 - device / wall), the kernels launched, and the kernels with the
most device time.  Exits non-zero without a CUDA card.
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

from holoagent_tpu_torch.models import sam as sam_mod  # noqa: E402


def profile_encoder(sam, x, reps: int) -> None:
    enc, v = sam.encoder, sam.variant
    for _ in range(2):
        sam_mod.encode_image(enc, x, v, impl="flash")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            sam_mod.encode_image(enc, x, v, impl="flash")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.device_time for e in kernels) / 1e3 / reps  # us -> ms
    kind = "W8A8" if sam.quant else "bf16"
    if not kernels:
        print(f"[{kind}] wall {wall:.3f} ms a call; the profiler recorded no device activity")
        return
    print(f"[{kind}] wall {wall:.3f} ms a call, device {device:.3f} ms, idle share {1 - device / wall:.3f}, "
          f"{len(kernels) / reps:.0f} kernels a call")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time / 1e3)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[{kind}]   {t / reps:8.3f} ms  {n / reps:5.0f} launches  {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sam_encoder_profile: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}")
    sam = sam_mod.init_sam(sam_mod.VARIANTS["vit_b"], seed=1, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 1024, 1024, 3, generator=gen).cuda()
    profile_encoder(sam, x, args.reps)
    profile_encoder(sam_mod.quantize_sam(sam), x, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
