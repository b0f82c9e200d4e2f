"""Where the time of the generative VLM's serving calls goes on one GPU:
wall clock against device time.

    python3 scripts/vlm_serving_profile.py [--reps 10] [--variants vlm-small,llava-tinyllama]

For each variant (random bf16 weights from seed 0, 8 cache slots at length
64), under ``torch.profiler``: one ``decode_step`` of the 8 slots, one
8-step ``decode_chunk_tracked`` (the batcher's chunk), one admission-wave
prefill (8 prompts, T = 128) and one 128-token prefill of one prompt, each
`reps` times after a warm-up.  Prints per call the synchronised wall time,
the device time summed over the traced kernels, the device's idle share
(one stream: 1 - device / wall), the kernels launched and the kernels with
the most device time (``clip_vlm_profile.profile_call``).  Exits non-zero
without a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from clip_vlm_profile import profile_call  # noqa: E402

from holoagent_tpu_torch.models import vlm as vlm_mod  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", default="vlm-small,llava-tinyllama")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vlm_serving_profile: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}")
    for name in args.variants.split(","):
        vv = vlm_mod.VARIANTS[name]
        vlm = vlm_mod.init_vlm(vv, seed=0, dtype=torch.bfloat16)
        cache = vlm_mod.init_cache(vv, 8, torch.bfloat16, "cuda")
        tokens = torch.zeros(8, dtype=torch.long, device="cuda")
        active = torch.ones(8, dtype=torch.bool, device="cuda")
        remaining = torch.full((8,), 1 << 20, dtype=torch.long, device="cuda")

        def step(i):
            cache.length.fill_(64)
            vlm_mod.decode_step(vlm, tokens, cache, active)

        def chunk(i):
            cache.length.fill_(64)
            vlm_mod.decode_chunk_tracked(vlm, tokens, cache, active, remaining, -1, steps=8)

        wave = torch.zeros(8, 128, vv.width, dtype=torch.bfloat16, device="cuda")
        one = vlm_mod.init_cache(vv, 1, torch.bfloat16, "cuda")
        profile_call(f"{name} decode_step, 8 slots", step, args.reps)
        profile_call(f"{name} decode_chunk_tracked, 8 steps", chunk, args.reps)
        profile_call(f"{name} prefill, wave of 8 at T=128", lambda i: vlm_mod.prefill(vlm, wave, [128] * 8, cache),
                     args.reps)
        profile_call(f"{name} prefill, one prompt of 128", lambda i: vlm_mod.prefill(vlm, wave[:1], [128], one),
                     args.reps)
        del vlm, cache, one
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
