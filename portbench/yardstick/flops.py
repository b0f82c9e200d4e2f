"""The towers' model operations, counted from shapes.

The plain reference towers run once on the meta device (no data, no
time) under ``torch.utils.flop_counter.FlopCounterMode``, which counts
the operations of every matrix product and convolution from its shapes
(2 per multiply-add).  Elementwise work, norms and softmax are not
counted.  ``int8`` parts are the block linears that a W8A8 tower runs on
the int8 tensor cores: 24 T W^2 a block of width W over T tokens (qkv,
the output projection, and the 4x MLP).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import clip as ref_clip
from ..reference import sam as ref_sam
from .roofline import PEAK_BF16_FLOPS, PEAK_INT8_OPS


def _meta_params(spec) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(shape, device="meta") for k, (shape, _, _) in spec.items()}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def sam_frame_ops(v: ref_sam.SAMSizes, points_per_side: int) -> Dict[str, float]:
    """One frame through SAM's image encoder and the decoder over the
    points_per_side^2 grid: {"total", "int8"} operations."""
    p = _meta_params(ref_sam.spec(v))
    s, g = v.img_size, v.img_size // v.patch
    enc = _count(lambda: ref_sam.encode_image(p, v, torch.empty((1, s, s, 3), device="meta")))
    dec = _count(lambda: ref_sam.decode_grid(p, v, torch.empty((g, g, v.decoder_dim), device="meta"),
                                             points_per_side))
    win = v.window
    padded = -(-g // win) * win
    tokens = sum(g * g if i in v.global_idx else padded * padded for i in range(v.depth))
    return {"total": float(enc + dec), "int8": 24.0 * tokens * v.width**2}


def clip_crop_ops(v: ref_clip.CLIPSizes) -> Dict[str, float]:
    """One crop through CLIP's visual tower: {"total", "int8"}."""
    p = _meta_params(ref_clip.visual_spec(v))
    s = v.image_size
    total = _count(lambda: ref_clip.encode_image(p, v, torch.empty((1, s, s, 3), device="meta")))
    tokens = (s // v.patch) ** 2 + 1
    return {"total": float(total), "int8": 24.0 * tokens * v.v_width**2 * v.v_layers}


def ideal_seconds(ops: Dict[str, float], int8: bool) -> float:
    """The least time of `ops` at the card's peaks: the int8 part at the int8
    rate where the tower is W8A8, everything else at the bf16 rate."""
    if not int8:
        return ops["total"] / PEAK_BF16_FLOPS
    return ops["int8"] / PEAK_INT8_OPS + (ops["total"] - ops["int8"]) / PEAK_BF16_FLOPS
