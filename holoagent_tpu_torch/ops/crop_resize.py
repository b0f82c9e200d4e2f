"""Batched crop-and-resize (counterpart of holoagent_tpu/ops/crop_resize.py).

Bilinear resampling is separable, so each crop is two small matmuls with
per-crop interpolation-weight matrices (out = Wy @ image @ Wx^T).
"""

from __future__ import annotations

from typing import Optional

import torch


def _interp_weights(
    start: torch.Tensor,  # (M,) box start in pixels
    end: torch.Tensor,  # (M,) box end in pixels (exclusive)
    out_size: int,
    in_size: int,
) -> torch.Tensor:
    """(M, out_size, in_size) bilinear weight rows."""
    dev = start.device
    t = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / out_size
    pos = start[:, None] + t[None, :] * (end - start)[:, None] - 0.5
    pos = torch.clamp(pos, 0.0, in_size - 1.0)
    i0 = torch.floor(pos).to(torch.int64)
    f = pos - i0
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    cols = torch.arange(in_size, device=dev)
    zero = torch.zeros((), device=dev)
    w0 = torch.where(cols[None, None, :] == i0[:, :, None], (1.0 - f)[:, :, None], zero)
    w1 = torch.where(cols[None, None, :] == i1[:, :, None], f[:, :, None], zero)
    return w0 + w1


def crop_and_resize(
    image: torch.Tensor,  # (H, W, C) float
    boxes: torch.Tensor,  # (M, 4) [y0, x0, y1, x1] pixels
    out_size: int,
    masks: Optional[torch.Tensor] = None,  # (M, H, W) bool: blank the background
) -> torch.Tensor:
    """Bilinearly resample each box to (out_size, out_size): (M, S, S, C)."""
    h, w, _ = image.shape
    wy = _interp_weights(boxes[:, 0], boxes[:, 2], out_size, h)  # (M, S, H)
    wx = _interp_weights(boxes[:, 1], boxes[:, 3], out_size, w)  # (M, S, W)
    tmp = torch.einsum("msh,hwc->mswc", wy, image.float())
    out = torch.einsum("mtw,mswc->mstc", wx, tmp).to(image.dtype)
    if masks is not None:
        tmpm = torch.einsum("msh,mhw->msw", wy, masks.to(torch.float32))
        mv = torch.einsum("mtw,msw->mst", wx, tmpm)
        out = out * (mv > 0.5)[..., None].to(image.dtype)
    return out


def expand_boxes(boxes: torch.Tensor, margin: float, h: int, w: int) -> torch.Tensor:
    """Grow boxes by `margin` pixels on every side, clipped to the image."""
    y0 = torch.clamp(boxes[:, 0] - margin, 0, h)
    x0 = torch.clamp(boxes[:, 1] - margin, 0, w)
    y1 = torch.clamp(boxes[:, 2] + margin, 0, h)
    x1 = torch.clamp(boxes[:, 3] + margin, 0, w)
    return torch.stack([y0, x0, y1, x1], dim=-1)
