"""Image resize with ``jax.image.resize`` semantics.

The reference resizes with ``jax.image.resize`` (``linear`` and ``cubic``),
which antialiases when it downsamples (the kernel widens by the scale) and
whose ``cubic`` is the Keys kernel with a = -0.5; PyTorch's ``interpolate``
does neither (its bicubic uses a = -0.75).  So the port builds JAX's
interpolation weight matrices explicitly and contracts each resized
dimension with one matmul, as JAX's own ``scale_and_translate`` does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def weight_matrix(in_size: int, out_size: int, method: str, device=None) -> torch.Tensor:
    """(in_size, out_size) float32 resampling weights, antialiased when
    downsampling (jax._src.image.scale.compute_weight_mat, translation 0)."""
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample_f[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(
        total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w)
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for float tensors: every
    dimension whose size changes is resampled."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match rank {x.ndim}")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            w = weight_matrix(n_in, n_out, method, x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
