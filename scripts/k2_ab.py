"""Time builds of the attention source (holoagent_tpu_torch/csrc/flash_attention.cu)
against each other on one CUDA card, in turns, at K1's and K2's shapes.

    python3 scripts/k2_ab.py [--mapper] [name=path.cu ...]

Builds the source as it stands ("source") and each `name=path.cu` given;
each must keep the source's launch entry points (entries the source adds
since, such as a plan entry, may be missing from a variant).  Each build
goes through the port's wrappers (`flash_attention`,
`flash_attention_2d`, with the library swapped), is held against the plain
version within chip_smoke.py's limits (a disagreement is printed, the
run goes on and exits 1 at its end), and is timed with chip_smoke.py's
`time_ms` (device time, the stream held while the calls are enqueued), the
builds in the order A, B, ..., B, A; each build keeps its faster turn
(scripts/kernel_ab.py).  SDPA is timed beside them as a yardstick (K1 with
a dense bias mask).  The shapes are K2's tensor-core cases and every case
of the general route (chip_smoke.GENERAL_CASES), each at its head dim and
dtype.  With --mapper, chip_smoke.py's path (z), the float32 production
Mapper, runs with each build in the same turns (towers and the plain
extraction made once).  Needs nvcc and one card.
"""

from __future__ import annotations

import re
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402
from holoagent_tpu_torch.apps.common import load_models  # noqa: E402
from holoagent_tpu_torch.config import from_dict  # noqa: E402
from holoagent_tpu_torch.ops import flash_attention as fa  # noqa: E402
from holoagent_tpu_torch.ops._cuda_build import BUILD_DIR, CudaLibrary  # noqa: E402

BF16 = torch.bfloat16
# (name, kernel, B, H, T or the grid's side, D, causal, dtype, packed): K2's
# tensor-core cases (the text tower, the resident route's causal limit, the
# long route causal (a vlm-base prefill) and not, CLIP crop stacks at tiers
# 16 and 64), then the general route's
SHAPES = (("text_t77", "k2", 256, 12, 77, 64, True, BF16, True),
          ("causal_t320", "k2", 4, 16, 320, 64, True, BF16, True),
          ("prefill_t1024", "k2", 4, 16, 1024, 64, True, BF16, True),
          ("t600", "k2", 4, 16, 600, 64, False, BF16, True),
          ("clip_tier16", "k2", 33, 16, 257, 64, False, BF16, True),
          ("clip_tier64", "k2", 129, 16, 257, 64, False, BF16, True)) + cs.GENERAL_CASES


def library(name, text, out_dir):
    """A CudaLibrary of `text`, built with the port's flags, binding the
    entries `text` defines; its registers."""
    cu = out_dir / f"{name}.cu"
    cu.write_text(text)
    defined = set(re.findall(r'extern "C" int (\w+)\(', text))
    lib = CudaLibrary("flash_attention.cu", {k: v for k, v in fa.LIB.signatures.items() if k in defined})
    lib.source = cu
    t0 = time.perf_counter()
    log = lib.build().with_suffix(".log").read_text()
    print(f"{name}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    return lib, resources(log)


def resources(log):
    """(kernel, ptxas's resource line) of each entry function in a build's
    -Xptxas -v output."""
    out, entry = [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            entry = m.group(1)
        elif "registers" in ln or "spill stores" in ln:
            out.append((entry, ln.split(":")[-1].strip()))
    return out


def case(row, gen):
    """(call, plain call, SDPA call) of one shape's inputs."""
    name, kernel, b, h, t, d, causal, dtype, packed = row
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kernel == "k1":
        q, k, v, bias_h, bias_w = cs.k1_inputs(b, h, t, gen, d, dtype)
        mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, h, t * t, t * t).to(dtype)
        return (lambda: fa.flash_attention_2d(q, k, v, bias_h, bias_w, (t, t)),
                lambda: fa.flash_attention_2d_ref(q, k, v, bias_h, bias_w, (t, t)),
                lambda: sdpa(q, k, v, attn_mask=mask))
    q, k, v = cs.k2_inputs(b, h, t, gen, packed, d, dtype)
    return (lambda: fa.flash_attention(q, k, v, causal=causal), lambda: fa.flash_attention_ref(q, k, v, causal=causal),
            lambda: sdpa(q, k, v, is_causal=causal))


def mapper_turns(libs):
    """chip_smoke's (z) with each build, in turns A, B, ..., B, A."""
    names = list(libs)
    models = load_models(from_dict(cs.Z_CONFIG))
    ds = cs.mapping_frames()
    plain = cs.z_plain(models, ds)
    for name in names + names[::-1]:
        fa.LIB = libs[name]
        z = cs.z_f32_mapper(ds, f"z-{name}", models, plain)
        print(f"(z) {name}: {z['kf_s']:.3f} kf/s, attention {z['attention_ms_a_keyframe']:.4f} ms a keyframe in "
              f"the run, mask.encoder {z['mask_encoder_ms']:.3f} ms, clip.encoder {z['clip_encoder_ms']:.3f} ms a "
              f"keyframe, peak {z['peak'] / 2**30:.3f} GiB, launches {z['launches']}, features within "
              f"{z['feature_err']:.3e}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_ab: CUDA is not available", file=sys.stderr)
        return 1
    argv = [a for a in sys.argv[1:] if a != "--mapper"]
    out_dir = BUILD_DIR / "k2_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, text in kernel_ab.variants(fa.LIB.source, argv).items():
        libs[name], regs = library(name, text, out_dir)
        for entry, line in regs:
            print(f"{name}: {entry}: {line}")
    gen = torch.Generator().manual_seed(cs.SEED)
    names = list(libs)
    failed = []
    for row in SHAPES:
        shape, kernel, b, h, t, d, causal, dtype = row[:8]
        call, plain, sdpa = case(row, gen)
        ref = plain()
        f32 = dtype == torch.float32

        def measure(name):
            fa.LIB = libs[name]
            agreement = cs.agreement(call(), ref, f32)
            if not cs.agrees(agreement):
                failed.append(f"{name} {shape}: disagrees with the plain version: {agreement}")
                print(failed[-1], flush=True)
            return cs.time_ms(call)

        ms = kernel_ab.best_of_turns(names, measure)
        cells = "  ".join(f"{nm} {ms[nm]:.4f}" for nm in names)
        lib_ms = cs.time_ms(sdpa)
        plain_ms = cs.time_ms(plain, samples=5, reps=2)
        n = t * t if kernel == "k1" else t
        pairs = n * (n + 1) / 2 if causal else n * n
        nbytes = 4 * b * h * n * d * ref.element_size() + (b * h * n * 2 * t * 4 if kernel == "k1" else 0)
        bound_ms, by = cs.bound(4.0 * pairs * d * b * h, nbytes,
                                cs.PEAK_F32_3XTF32_FLOPS if f32 else cs.PEAK_BF16_FLOPS)
        ratios = "  ".join(f"{nm} {ms[nm] / lib_ms:.2f}x" for nm in names)
        agreement = cs.agreement(call(), ref, f32)  # the last build timed
        gate = f"prec {agreement['prec']:.3e}" if f32 else f"err/tol {agreement['max_abs_err'] / agreement['tol']:.3f}"
        print(f"{shape} {kernel} B={b} H={h} {'grid ' if kernel == 'k1' else 'T='}{t} D={d} causal={causal} "
              f"{fa.TYPE_NAMES[dtype]} ms: {cells}  SDPA {lib_ms:.4f} ({ratios})  plain {plain_ms:.4f}  bound "
              f"{bound_ms:.4f} ({by})  {gate}", flush=True)
        del call, plain, sdpa, ref
        torch.cuda.empty_cache()
    if "--mapper" in sys.argv[1:] and not failed:
        mapper_turns(libs)
    print(kernel_ab.card())
    if failed:
        print(f"k2_ab: {len(failed)} disagreements", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
