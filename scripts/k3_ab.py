"""Time builds of the K3 source (holoagent_tpu_torch/csrc/quant_matmul.cu)
against each other on one CUDA card, in turns, at the W8A8 towers' shapes.

    python3 scripts/k3_ab.py [--diag] [name=path.cu ...]

Builds the source as it stands ("source") and each `name=path.cu` given.
--diag adds "gemm_only", the source with stage A (the quantization of x)
left out: it reads the int8 x and row scales the other builds left in the
shared scratch, so it serves only to time stage B and, by difference, stage
A.  Each build is compiled with the port's nvcc flags, called through its C
entry point, checked for bit equality with the plain version
(quant_matmul_ref), and timed with chip_smoke.py's `time_ms` (median of 5
samples of 20 calls, enqueued while a device-side sleep holds the stream,
so host overhead does not count), the builds in the order A, B, ..., B, A.
torch._int_mm on the pre-quantized operands is timed beside them as a
yardstick.  Each build keeps its faster turn (scripts/kernel_ab.py).  Needs
nvcc and one card; writes the builds under holoagent_tpu_torch/_build/k3_ab.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel_ab  # noqa: E402
from holoagent_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from holoagent_tpu_torch.ops._cuda_build import BUILD_DIR, NVCC_FLAGS, nvcc  # noqa: E402

SHAPES = ((8481, 1024, 3072), (8481, 1024, 4096), (8481, 4096, 1024), (8481, 1024, 1024),
          (4096, 3072, 768), (4900, 768, 2304), (33153, 1024, 4096))
FLAGS = {"--diag": {
    "gemm_only": ("  int err = x_f32 ? quantize<float>(x, x_q, a_s, m, k, s) : quantize<__nv_bfloat16>(x, x_q, a_s, m, k, s);",
                  "  int err = 0;"),
}}


def build(name, text, out_dir):
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(text)
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.ha_quant_matmul
    fn.argtypes, fn.restype = qm.LIB.signatures["ha_quant_matmul"], ctypes.c_int
    regs = [ln.strip() for ln in (r.stdout + r.stderr).splitlines() if "registers" in ln]
    return fn, regs[0] if regs else ""


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_ab: CUDA is not available", file=sys.stderr)
        return 1
    out_dir = BUILD_DIR / "k3_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = kernel_ab.variants(qm.LIB.source, sys.argv[1:], FLAGS)
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(lambda kv: build(*kv, out_dir), texts.items())))
    for name, (_, regs) in built.items():
        print(f"{name}: {regs}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in SHAPES:
        names = list(built)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        w_s = torch.rand(n, generator=gen, device="cuda") * 1e-3
        bias = 0.1 * torch.randn(n, generator=gen, device="cuda")
        ref = qm.quant_matmul_ref(x, w_q, w_s, bias, torch.bfloat16)
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        x_q = torch.empty(m, k, dtype=torch.int8, device="cuda")  # scratch shared by every build
        a_s = torch.empty(m, dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        same = {}

        def measure(name):
            fn = built[name][0]

            def call():
                return fn(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), bias.data_ptr(), out.data_ptr(),
                          x_q.data_ptr(), a_s.data_ptr(), m, n, k, 0, 0, stream)

            out.zero_()
            if call() != 0:
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            same[name] = bool(torch.equal(out, ref))
            return cs.time_ms(call, samples=5, reps=20)

        ms = kernel_ab.best_of_turns(names, measure)
        x_q8 = qm.quantize_rows(x)[0].to(torch.int8)
        lib_ms = cs.time_ms(lambda: torch._int_mm(x_q8, w_q.t()), samples=5, reps=20)
        cells = "  ".join(f"{nm} {ms[nm]:.4f}{'' if same[nm] else ' (differs)'}" for nm in names)
        print(f"M={m} K={k} N={n} bf16->bf16 ms: {cells}  _int_mm {lib_ms:.4f}", flush=True)
    print(kernel_ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
