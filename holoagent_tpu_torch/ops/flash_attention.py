"""Attention kernels K1 (``flash_attention_2d``) and K2 (``flash_attention``).

Counterpart of holoagent_tpu/ops/flash_attention.py.  Both Pallas kernels
there become one hand-written CUDA C++ kernel for Hopper
(``csrc/flash_attention.cu``, built for ``sm_90a`` with ``nvcc`` at first
use into ``_build/`` and loaded with ``ctypes``, by ``ops/_cuda_build.py``).

Beside each wrapper sits its plain PyTorch version (``*_ref``): dense float32
scores from inputs in the working dtype, bias and masks, softmax, the
probabilities cast to the input dtype, then P.V with float32 accumulation.
A wrapper takes the plain version only for a tensor on the CPU; a CUDA
tensor goes through the kernel or the wrapper raises.  Each wrapper counts
its kernel launches in ``<wrapper>.launches``; while ``<wrapper>.trace`` is a
list, it also appends CUDA events around each launch (see ``_cuda_build.launch``).

The kernel takes contiguous bf16 (BH, N, D) tensors with D = 64;
the wrappers make q, k and v contiguous (a copy when the caller passes a
transposed view) and allocate the output.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ._cuda_build import CudaLibrary, kernel_input, launch

NEG_INF = -1e30
HEAD_DIM = 64  # the kernel's head dim (SAM vit_b and CLIP ViT-L/14 both use 64)


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


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary("flash_attention.cu", {
    "ha_flash_attention_2d": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _p],
    "ha_flash_attention": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _p],
})


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


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
    q, k, v = (kernel_input(x, nm, torch.bfloat16) for x, nm in ((q, "q"), (k, "k"), (v, "v")))
    bias_h = kernel_input(bias_h, "bias_h", torch.float32)
    bias_w = kernel_input(bias_w, "bias_w", torch.float32)
    o = torch.empty_like(q)
    launch(
        flash_attention_2d, (bh, h, w), torch.cuda.current_stream(q.device), LIB.load().ha_flash_attention_2d,
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
    q, k, v = (kernel_input(x, nm, torch.bfloat16) for x, nm in ((q, "q"), (k, "k"), (v, "v")))
    o = torch.empty_like(q)
    launch(
        flash_attention, (b, h, t, causal), torch.cuda.current_stream(q.device), LIB.load().ha_flash_attention,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, t, d, int(causal), t, d**-0.5,
    )
    return o


flash_attention.launches = 0
flash_attention.trace = None
