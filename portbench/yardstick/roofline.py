"""Peaks of one NVIDIA H100 SXM and the least time of each kernel launch.

Frozen copy of ``chip_smoke.py``'s arithmetic at commit
b62fedabdce77346f1a976bf9b6f57fc0f42ce1b: the published dense peaks
(``chip_smoke.py:261-265``), ``bound`` (``:386``), and the operations and
bytes of K1 (``:521-523``), K2 (``:579-581``) and K3 (``:656``).  A
launch's least time is the larger of its operations at the peak of its
dtype and its bytes at the memory rate; inputs are counted once and the
output once, whatever the kernel reads again.

A launch is described by the key the program's kernel wrapper records
with it (``<wrapper>.trace``), and timed by its kernels' device time in a
profiler trace, which ``kernel_of`` finds by name:
- K1 ``flash_attention_2d``: (B, heads, h, w, D, dtype);
- K2 ``flash_attention``: (B, heads, T, D, causal, dtype);
- K3 ``quant_matmul``: (M, K, N, x dtype, out dtype).
"""

from __future__ import annotations

import re
from typing import Iterable, Optional, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3  # the float32 attention route takes each product as three TF32 ones
PEAK_BYTES = 3.35e12
ELEMENT_BYTES = {"bf16": 2, "f32": 4}
ATTENTION_PEAK = {"bf16": PEAK_BF16_FLOPS, "f32": PEAK_F32_3XTF32_FLOPS}


def bound_s(ops: float, nbytes: float, peak_ops: float) -> float:
    """The least time in seconds: ops at `peak_ops` or bytes at the memory
    rate, whichever is longer."""
    return max(ops / peak_ops, nbytes / PEAK_BYTES)


def k1_cost(key: tuple) -> Tuple[float, float, float]:
    """(ops, bytes, peak) of one K1 launch: q k^T and p v over the h x w
    grid, q, k, v and the output once, the float32 bias_h and bias_w."""
    b, heads, h, w, d, dt = key
    n, bh = h * w, b * heads
    return 4.0 * n * n * d * bh, 4 * bh * n * d * ELEMENT_BYTES[dt] + bh * n * (h + w) * 4, ATTENTION_PEAK[dt]


def k2_cost(key: tuple) -> Tuple[float, float, float]:
    """(ops, bytes, peak) of one K2 launch: the key/query pairs the causal
    mask leaves, q, k, v and the output once."""
    b, h, t, d, causal, dt = key
    pairs = t * (t + 1) / 2 if causal else t * t
    return 4.0 * pairs * d * b * h, 4 * b * h * t * d * ELEMENT_BYTES[dt], ATTENTION_PEAK[dt]


def k3_cost(key: tuple) -> Tuple[float, float, float]:
    """(ops, bytes, peak) of one K3 launch: an M x K by K x N int8 product;
    x in its dtype, the int8 weights, two float32 vectors of N (scales,
    bias) and the output."""
    m, k, n, x_dt, out_dt = key
    nbytes = m * k * ELEMENT_BYTES[x_dt] + n * k + 2 * n * 4 + m * n * ELEMENT_BYTES[out_dt]
    return 2.0 * m * n * k, nbytes, PEAK_INT8_OPS


COSTS = {"k1": k1_cost, "k2": k2_cost, "k3": k3_cost}

# The program's kernels as a profiler names them (csrc/flash_attention.cu,
# csrc/quant_matmul.cu): an attention kernel's first template argument is
# REL_POS, true for K1 and false for K2; a K3 launch runs two kernels, the
# rows' quantization and the GEMM.
_ATTENTION = re.compile(r"(?:^|[\s:])(?:resident_kernel|global_kernel|g1_bf16_kernel|g2_tf32x3_kernel)<(true|false)\b")
_K3 = re.compile(r"(?:^|[\s:])(?:quantize_kernel|gemm_kernel)<")


def kernel_of(name: str) -> Optional[str]:
    """"k1", "k2" or "k3" for a device operation of that kernel, else None."""
    m = _ATTENTION.search(name)
    if m:
        return "k1" if m.group(1) == "true" else "k2"
    return "k3" if _K3.search(name) else None


def roofline_percent(kernel: str, keys: Iterable[tuple], device_s: float) -> Optional[float]:
    """Σ least time of the launches `keys` ÷ `device_s`, the device time of
    the kernel's operations over the same stretch, in percent; None when
    there is no launch."""
    cost = COSTS[kernel]
    least = sum(bound_s(*cost(key)) for key in keys)
    if least <= 0.0 or device_s <= 0.0:
        return None
    return 100.0 * least / device_s
