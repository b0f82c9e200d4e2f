"""Fused W8A8 linear layer, kernel K3 (``quant_matmul``).

Counterpart of holoagent_tpu/ops/quant_matmul.py.  The Pallas kernel there
becomes hand-written CUDA C++ for Hopper (``csrc/quant_matmul.cu``, built
for ``sm_90a`` with ``nvcc`` at first use into ``_build/`` and loaded with
``ctypes`` by ``ops/_cuda_build.py``): one C entry that launches two stages
on the caller's stream, a row-wise quantization of x into int8 scratch
(once per element) and an int8 GEMM fed by TMA into ``wgmma`` with the
dequantizing epilogue.  It also serves the unfused int8 path of the
reference (``models/transformer.py::matmul_int8`` plus its bias): on a CUDA
tensor every int8 product of the port goes through it.

Per row of x, a dynamic scale ``a_s = max(amax|x| * f32(1/127), 1e-12)``;
x quantized to int8 by ``clamp(round(x / a_s), -127, 127)`` (half to even);
an int8 x int8 product accumulated exactly; then ``acc * a_s * w_s + bias``
in float32, rounded once to ``out_dtype``.  The reference's row scale is a
reciprocal product: XLA folds ``/ 127.0`` into ``* (1/127)`` inside a
compiled function, so the plain version and the kernel multiply by the f32
reciprocal explicitly.  The quantizing division is a true division (by a
tensor) in both.

Weights are int8 **(N, K)**: each output channel K-contiguous, the layout
an 8-bit ``wgmma`` takes for its B operand.  The port transposes once, when it
quantizes or carries over a quantized tree (``models/transformer.py``,
``bridge.py``).  ``w_s`` is (N,) or (1, N) float32.

The plain version forms the product in float64, which is exact (|sum| <=
127^2 * K < 2^53 for any K the towers have) and runs on the CPU and on CUDA
alike.  A wrapper takes it only for a tensor on the CPU; a CUDA tensor goes
through the kernel or the wrapper raises.  ``quant_matmul.launches`` counts
kernel launches; while ``quant_matmul.trace`` is a list it also collects
CUDA events around each launch (``_cuda_build.launch``).  GELU, where asked
for, runs outside the kernel on the rounded output, as in the reference.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ._cuda_build import CudaLibrary, kernel_input, launch

INV_127 = float.fromhex("0x1.020408p-7")  # float32(1/127), exactly
SCALE_FLOOR = 1e-12

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("quant_matmul.cu", {"ha_quant_matmul": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p]})


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float -> (integer-valued float32 (M, K) in [-127, 127], row
    scales (M, 1) float32), as the reference quantizes activations."""
    xf = x.float()
    a_s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * INV_127, min=SCALE_FLOOR)
    return torch.clamp(torch.round(xf / a_s), -127.0, 127.0), a_s


def dequantize(
    x_q: torch.Tensor,  # (M, K) integer-valued
    a_s: torch.Tensor,  # (M, 1) or (1, 1) f32
    w_q: torch.Tensor,  # (N, K) int8
    w_s: torch.Tensor,  # (N,) or (1, N) f32
    bias: torch.Tensor,  # (N,)
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """The exact integer product (float64) and the f32 epilogue
    ``(acc * a_s) * w_s + bias``, rounded once to `out_dtype`."""
    acc = torch.mm(x_q.double(), w_q.double().t()).float()
    out = acc * a_s * w_s.reshape(1, -1).float() + bias.reshape(1, -1).float()
    return out.to(out_dtype)


def quant_matmul_ref(
    x: torch.Tensor,  # (M, K) bf16 / f32
    w_q: torch.Tensor,  # (N, K) int8
    w_s: torch.Tensor,  # (N,) or (1, N) f32
    bias: torch.Tensor,  # (N,)
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The kernel's function, in plain PyTorch: (M, N) `out_dtype`."""
    x_q, a_s = quantize_rows(x)
    return dequantize(x_q, a_s, w_q, w_s, bias, out_dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_TYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}  # the kernel's input and output types


def quant_matmul(
    x: torch.Tensor,  # (M, K) bf16 / f32
    w_q: torch.Tensor,  # (N, K) int8
    w_s: torch.Tensor,  # (N,) or (1, N) f32
    bias: torch.Tensor,  # (N,)
    act: str = "none",  # "none" | "gelu" (tanh GELU on the rounded output)
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K3: fused dynamic-quant W8A8 linear, (M, N) `out_dtype` (JAX
    reference: holoagent_tpu/ops/quant_matmul.py::quant_matmul).  Any M:
    the kernel masks the ragged row edge itself."""
    if act not in ("none", "gelu"):
        raise ValueError(f"act must be 'none' or 'gelu', got {act!r}")
    m, k = x.shape
    n = w_q.shape[0]
    if w_q.dtype != torch.int8 or w_q.shape != (n, k):
        raise ValueError(f"w_q must be int8 (N, K={k}), got {w_q.dtype} {tuple(w_q.shape)}")
    if w_s.numel() != n or bias.numel() != n:
        raise ValueError(f"w_s {tuple(w_s.shape)} / bias {tuple(bias.shape)} do not match N={n}")
    if x.dtype not in _TYPE_NAMES or out_dtype not in _TYPE_NAMES:
        raise TypeError(f"x and out_dtype must be bf16 or f32, got {x.dtype} -> {out_dtype}")
    if x.device.type == "cpu":
        out = quant_matmul_ref(x, w_q, w_s, bias, out_dtype)
    else:
        if n % 8 or k % 16:
            raise ValueError(f"the kernel takes N % 8 == 0 and K % 16 == 0, got N={n} K={k}")
        xk = kernel_input(x, "x", x.dtype)
        wk = kernel_input(w_q, "w_q", torch.int8)
        sk = kernel_input(w_s.reshape(n).float(), "w_s", torch.float32)
        bk = kernel_input(bias.reshape(n).float(), "bias", torch.float32)
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
        x_q = torch.empty((m, k), dtype=torch.int8, device=x.device)  # stage A's output, stage B's input
        a_s = torch.empty((m,), dtype=torch.float32, device=x.device)
        launch(
            quant_matmul, (m, k, n, _TYPE_NAMES[x.dtype], _TYPE_NAMES[out_dtype]), torch.cuda.current_stream(x.device),
            LIB.load().ha_quant_matmul,
            xk.data_ptr(), wk.data_ptr(), sk.data_ptr(), bk.data_ptr(), out.data_ptr(), x_q.data_ptr(), a_s.data_ptr(),
            m, n, k, int(x.dtype == torch.float32), int(out_dtype == torch.float32),
        )
    if act == "gelu":
        out = F.gelu(out.float(), approximate="tanh").to(out_dtype)
    return out


quant_matmul.launches = 0
quant_matmul.trace = None


def batched_quant_matmul(
    x: torch.Tensor,  # (..., K)
    w_q: torch.Tensor,
    w_s: torch.Tensor,
    bias: torch.Tensor,
    act: str = "none",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(..., K) x (N, K) -> (..., N): flattens the leading axes into M."""
    y = quant_matmul(x.reshape(-1, x.shape[-1]), w_q, w_s, bias, act=act, out_dtype=out_dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])
