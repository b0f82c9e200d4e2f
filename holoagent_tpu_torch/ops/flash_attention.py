"""Attention kernels K1 (``flash_attention_2d``) and K2 (``flash_attention``).

Counterpart of holoagent_tpu/ops/flash_attention.py.  Both Pallas kernels
there become one hand-written CUDA C++ kernel for Hopper
(``csrc/flash_attention.cu``, built for ``sm_90a`` with ``nvcc`` at first
use into ``_build/`` and loaded with ``ctypes``).

Beside each wrapper sits its plain PyTorch version (``*_ref``): dense float32
scores from inputs in the working dtype, bias and masks, softmax, the
probabilities cast to the input dtype, then P.V with float32 accumulation.
A wrapper takes the plain version only for a tensor on the CPU; a CUDA
tensor goes through the kernel or the wrapper raises.  Each wrapper counts
its kernel launches in ``<wrapper>.launches``; while ``<wrapper>.trace`` is a
list, it also appends CUDA events around each launch (see ``_launch``).

The kernel takes contiguous bf16 (BH, N, D) tensors with D = 64;
the wrappers make q, k and v contiguous (a copy when the caller passes a
transposed view) and allocate the output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
HEAD_DIM = 64  # the kernel's head dim (SAM vit_b and CLIP ViT-L/14 both use 64)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "flash_attention.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Dense attention over (B, H, T, D) with the kernel's semantics."""
    t, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    if causal:
        idx = torch.arange(t, device=q.device)
        s = s.masked_fill(idx[None, :] > idx[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention_2d_ref(
    q: torch.Tensor,  # (BH, N, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias_h: torch.Tensor,  # (BH, N, h) f32
    bias_w: torch.Tensor,  # (BH, N, w) f32
    grid_hw: Tuple[int, int],
) -> torch.Tensor:
    """Dense rel-pos attention over an h x w token grid:
    s[q, k] = q.k * d^-1/2 + bias_h[q, row(k)] + bias_w[q, col(k)]."""
    bh, n, d = q.shape
    h, w = grid_hw
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    s = s.view(bh, n, h, w) + bias_h.float()[..., :, None] + bias_w.float()[..., None, :]
    p = torch.softmax(s.view(bh, n, n), dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the attention kernels cannot be built")
    return found


def library_path() -> Path:
    """Build output, keyed by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libflash_attention_{h}.so"


def build() -> Path:
    """Compile the kernel source with nvcc unless this exact source is
    already built.  Writes the compiler's resource report (``-Xptxas -v``)
    beside the library.  Returns the library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    out.with_suffix(".log").write_text(r.stdout + r.stderr)
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ha_flash_attention_2d.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, p]
            lib.ha_flash_attention_2d.restype = ctypes.c_int
            lib.ha_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
            lib.ha_flash_attention.restype = ctypes.c_int
            _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _kernel_input(x: torch.Tensor, name: str, dtype: torch.dtype) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}; all inputs must share the CUDA device")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def _launch(wrapper, key: tuple, stream: torch.cuda.Stream, entry, *args) -> None:
    """Launch one C entry point on ``stream``, raise if it reports an error,
    and count the launch.  While ``wrapper.trace`` is a list, append
    ``(key, start, end)``: CUDA events around the launch, so a caller can
    time the kernel inside a larger run without synchronising."""
    trace = wrapper.trace
    if trace is not None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
    err = entry(*args, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: cudaError {err}")
    wrapper.launches += 1
    if trace is not None:
        end.record(stream)
        trace.append((key, start, end))


def flash_attention_2d(
    q: torch.Tensor,  # (BH, N, D), N = h*w row-major over the grid
    k: torch.Tensor,
    v: torch.Tensor,
    bias_h: torch.Tensor,  # (BH, N, h) f32
    bias_w: torch.Tensor,  # (BH, N, w) f32
    grid_hw: Tuple[int, int],
) -> torch.Tensor:
    """K1: SAM rel-pos attention (JAX reference:
    holoagent_tpu/ops/flash_attention.py::flash_attention_2d)."""
    bh, n, d = q.shape
    h, w = grid_hw
    if n != h * w:
        raise ValueError(f"N={n} does not match grid {grid_hw}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if bias_h.shape != (bh, n, h) or bias_w.shape != (bh, n, w):
        raise ValueError(f"bias shapes {bias_h.shape} {bias_w.shape} for q {q.shape}")
    if q.device.type == "cpu":
        return flash_attention_2d_ref(q, k, v, bias_h, bias_w, grid_hw)
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIM}")
    q, k, v = (_kernel_input(x, nm, torch.bfloat16) for x, nm in ((q, "q"), (k, "k"), (v, "v")))
    bias_h = _kernel_input(bias_h, "bias_h", torch.float32)
    bias_w = _kernel_input(bias_w, "bias_w", torch.float32)
    o = torch.empty_like(q)
    _launch(
        flash_attention_2d, (bh, h, w), torch.cuda.current_stream(q.device), _load().ha_flash_attention_2d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(), bias_w.data_ptr(),
        o.data_ptr(), bh, n, d, h, w, d**-0.5,
    )
    return o


flash_attention_2d.launches = 0
flash_attention_2d.trace = None


def flash_attention(
    q: torch.Tensor,  # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
) -> torch.Tensor:
    """K2: blockwise attention, optional causal mask (JAX reference:
    holoagent_tpu/ops/flash_attention.py::flash_attention).  Any T: the
    kernel masks the ragged key edge itself."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    b, h, t, d = q.shape
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIM}")
    q, k, v = (_kernel_input(x, nm, torch.bfloat16) for x, nm in ((q, "q"), (k, "k"), (v, "v")))
    o = torch.empty_like(q)
    _launch(
        flash_attention, (b, h, t, causal), torch.cuda.current_stream(q.device), _load().ha_flash_attention,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, t, d, int(causal), t, d**-0.5,
    )
    return o


flash_attention.launches = 0
flash_attention.trace = None
