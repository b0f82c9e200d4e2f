"""Time builds of the attention source (holoagent_tpu_torch/csrc/flash_attention.cu)
against each other on one CUDA card, in turns, at K2's shapes.

    python3 scripts/k2_ab.py [name=path.cu ...]

Builds the source as it stands ("source") and each `name=path.cu` given;
each must keep the source's C entry points.  Each build goes through the
port's wrapper (`flash_attention`, with its library swapped), is held
against the plain version within chip_smoke.py's limits, and is timed with
chip_smoke.py's `time_ms` (device time, the stream held while the calls are
enqueued), the builds in the order A, B, ..., B, A; each build keeps its
faster turn (scripts/kernel_ab.py).  SDPA is timed beside them as a
yardstick.  Needs nvcc and one card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402
from holoagent_tpu_torch.ops import flash_attention as fa  # noqa: E402
from holoagent_tpu_torch.ops._cuda_build import BUILD_DIR, CudaLibrary  # noqa: E402

# (name, B, H, T, causal): the text tower, the resident route's causal limit,
# the long route causal (a vlm-base prefill) and not, and CLIP crop stacks at
# tiers 16 and 64
SHAPES = (("text_t77", 256, 12, 77, True), ("causal_t320", 4, 16, 320, True),
          ("prefill_t1024", 4, 16, 1024, True), ("t600", 4, 16, 600, False), ("clip_tier16", 33, 16, 257, False),
          ("clip_tier64", 129, 16, 257, False))


def library(name, text, out_dir):
    """A CudaLibrary of `text`, built with the port's flags; its registers."""
    cu = out_dir / f"{name}.cu"
    cu.write_text(text)
    lib = CudaLibrary("flash_attention.cu", fa.LIB.signatures)
    lib.source = cu
    log = lib.build().with_suffix(".log").read_text()
    return lib, [ln.split(":")[-1].strip() for ln in log.splitlines() if "registers" in ln]


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_ab: CUDA is not available", file=sys.stderr)
        return 1
    out_dir = BUILD_DIR / "k2_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, text in kernel_ab.variants(fa.LIB.source, sys.argv[1:]).items():
        libs[name], regs = library(name, text, out_dir)
        print(f"{name}: {regs}")
    gen = torch.Generator().manual_seed(cs.SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    names = list(libs)
    for shape, b, h, t, causal in SHAPES:
        qkv = torch.randn(b, t, 3 * h * 64, generator=gen).to("cuda", torch.bfloat16)
        q, k, v = (z.reshape(b, t, h, 64).transpose(1, 2) for z in qkv.split(h * 64, dim=-1))
        ref = fa.flash_attention_ref(q, k, v, causal=causal)

        def measure(name):
            fa.LIB = libs[name]
            agreement = cs.agreement(fa.flash_attention(q, k, v, causal=causal), ref)
            if not cs.agrees(agreement):
                raise SystemExit(f"{name} {shape}: disagrees with the plain version: {agreement}")
            return cs.time_ms(lambda: fa.flash_attention(q, k, v, causal=causal))

        ms = kernel_ab.best_of_turns(names, measure)
        cells = "  ".join(f"{nm} {ms[nm]:.4f}" for nm in names)
        lib_ms = cs.time_ms(lambda: sdpa(q, k, v, is_causal=causal))
        print(f"{shape} B={b} H={h} T={t} causal={causal} ms: {cells}  SDPA {lib_ms:.4f}", flush=True)
    print(kernel_ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
