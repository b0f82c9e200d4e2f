"""SAM 2's mask head: the decoder's two upscaling steps, their LayerNorm and
GELUs and the hypernetwork product (``sam/mask_decoder.py``'s
``predict_masks`` after the two-way transformer), from the image tokens to
the mask logits.

The JAX package has no SAM 2, so no Pallas kernel stands behind this one.
On CUDA tensors it is one hand-written CUDA C++ kernel (``csrc/mask_head.cu``,
built for ``sm_90a`` with ``nvcc`` at first use and loaded with ``ctypes`` by
``ops/_cuda_build.py``), launched on the current stream: the plain version
makes about 20 launches a pass and writes each intermediate to device memory
(the head is bound by bytes), the kernel reads the tokens once and writes
the logits once.  In bf16 it rounds to bf16 only where the plain version
does (after each GELU); float32 inputs take a float32 kernel (FFMA).  CPU
tensors take ``mask_head_ref``.  ``mask_head.launches`` counts the kernel's
launches; while ``mask_head.trace`` is a list it also collects CUDA events
around each launch (``_cuda_build.launch``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.sam import _upscale
from ..models.transformer import gelu_erf, layer_norm
from ._cuda_build import CudaLibrary, check_input, launch
from .flash_attention import TYPE_NAMES

# The widths the kernel is built for: SAM 2's decoder (d_model 256), its
# upscaled channels (256 / 4, 256 / 8) and mask tokens; token rows in items of 16.
KERNEL_DIMS = (256, 64, 32, 4)
TOKENS_AN_ITEM = 16
ARG_NAMES = ("src", "feat_s0", "feat_s1", "up1_w", "up1_b", "ln_g", "ln_b", "up2_w", "up2_b", "hyper")

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("mask_head.cu", {"ha_mask_head": [_p] * 11 + [ctypes.c_float, _i, _i, _i, _p]})


def mask_head_ref(src, feat_s0, feat_s1, up1_w, up1_b, ln_g, ln_b, up2_w, up2_b, hyper, eps: float):
    """The kernel's function in plain PyTorch, as models/sam2.py ran it:
    ``act1(ln1(dc1(src) + feat_s1))``, ``act2(dc2(.) + feat_s0)`` (each
    step rounded to the working dtype), then the float32 product with the
    hypernetwork vectors.  (P, g, g, D) tokens -> (P, nm, 4g, 4g) float32."""
    u = _upscale(src, up1_w, up1_b) + feat_s1
    u = gelu_erf(layer_norm(u, ln_g, ln_b, eps))
    u = gelu_erf(_upscale(u, up2_w, up2_b) + feat_s0)  # (P, 4g, 4g, D / 8)
    return torch.einsum("pnc,phwc->pnhw", hyper.float(), u.float())


def _check(args, out):
    """Shapes and devices any route needs; returns (P, g, nm)."""
    got = dict(zip(ARG_NAMES, args))
    p, g, _, d = got["src"].shape
    c1, c2, nm = got["up1_w"].shape[-1], got["up2_w"].shape[-1], got["hyper"].shape[1]
    want = dict(src=(p, g, g, d), feat_s0=(4 * g, 4 * g, c2), feat_s1=(2 * g, 2 * g, c1), up1_w=(2, 2, d, c1),
                up1_b=(c1,), ln_g=(c1,), ln_b=(c1,), up2_w=(2, 2, c1, c2), up2_b=(c2,), hyper=(p, nm, c2))
    bad = {n: tuple(got[n].shape) for n, s in want.items() if tuple(got[n].shape) != s}
    if bad:
        raise ValueError(f"mask_head: shapes {bad} do not fit src {(p, g, g, d)} (want {want})")
    if out is not None and (tuple(out.shape) != (p, nm, 4 * g, 4 * g) or out.dtype != torch.float32):
        raise ValueError(f"mask_head: out must be float32 {(p, nm, 4 * g, 4 * g)}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    devices = {t.device for t in (*got.values(), *(() if out is None else (out,)))}
    if len(devices) != 1:
        raise ValueError(f"mask_head: inputs on {sorted(map(str, devices))}: they must share a device")
    return p, g, nm


def mask_head(
    src: torch.Tensor,  # (P, g, g, D) image tokens after the two-way transformer
    feat_s0: torch.Tensor,  # (4g, 4g, D / 8)
    feat_s1: torch.Tensor,  # (2g, 2g, D / 4)
    up1_w: torch.Tensor,  # (2, 2, D, D / 4) HWIO
    up1_b: torch.Tensor,
    ln_g: torch.Tensor,
    ln_b: torch.Tensor,
    up2_w: torch.Tensor,  # (2, 2, D / 4, D / 8)
    up2_b: torch.Tensor,
    hyper: torch.Tensor,  # (P, nm, D / 8)
    eps: float,
    out: Optional[torch.Tensor] = None,  # (P, nm, 4g, 4g) float32, written in place
) -> torch.Tensor:
    """SAM 2's mask logits (P, nm, 4g, 4g) float32, into `out` when given.
    A CUDA tensor goes through the kernel of ``csrc/mask_head.cu``, one launch
    a call, which takes SAM 2's widths (``KERNEL_DIMS``), g a multiple of 16,
    every input in bf16 or every input in float32, each contiguous and
    16-byte aligned (it raises on anything else); a CPU tensor through
    ``mask_head_ref``."""
    args = (src, feat_s0, feat_s1, up1_w, up1_b, ln_g, ln_b, up2_w, up2_b, hyper)
    p, g, nm = _check(args, out)
    if src.device.type == "cpu":
        logits = mask_head_ref(*args, eps)
        return logits if out is None else out.copy_(logits)
    dims = (src.shape[-1], up1_w.shape[-1], up2_w.shape[-1], nm)
    if dims != KERNEL_DIMS or g % TOKENS_AN_ITEM:
        raise ValueError(f"mask_head: the kernel takes (D, D / 4, D / 8, masks) = {KERNEL_DIMS} and g a multiple "
                         f"of {TOKENS_AN_ITEM}, got {dims} and g = {g}")
    if src.dtype not in TYPE_NAMES:
        raise TypeError(f"mask_head: the kernel takes bf16 or float32, got {src.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("mask_head: an input requires grad, and the CUDA kernel has no backward; SAM 2's decoder "
                           "runs under no_grad (mask_head_ref differentiates)")
    if out is None:
        out = torch.empty((p, nm, 4 * g, 4 * g), dtype=torch.float32, device=src.device)
    for name, t in (*zip(ARG_NAMES, args), ("out", out)):
        check_input(t, name, torch.float32 if name == "out" else src.dtype)
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"mask_head: {name} must be contiguous and 16-byte aligned")
    launch(mask_head, (p, g, TYPE_NAMES[src.dtype]), torch.cuda.current_stream(src.device), LIB.load().ha_mask_head,
           *(t.data_ptr() for t in args), out.data_ptr(), eps, p, g, int(src.dtype == torch.float32))
    return out


mask_head.launches = 0
mask_head.trace = None
