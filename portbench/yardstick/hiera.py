"""The SAM 2 cell's yardstick: SAM 2.1's model operations a frame, and the
least time of Hiera's attention launches.

Operations are counted as ``flops.py`` counts SAM's: the plain reference
(``reference/sam2.py``) on the meta device under ``FlopCounterMode``
(matrix products and convolutions, 2 per multiply-add; elementwise work,
norms, softmax and pooling not counted): the trunk, the neck and the
decoder's high-resolution projections once a frame, the decoder over the
prompt grid.

Hiera's attention launches are K2's (``ops/flash_attention.py::
flash_attention``) at head dim 72, whose trace key is (B, H, Tq, D,
causal, dtype) with Tk appended where the keys outnumber the queries (the
pooled-query blocks).  A launch's least time is ``roofline.bound_s`` of its
operations (q k^T and p v over Tq x Tk pairs at the true head dim, 4 Tq Tk
D a head) at the dtype's peak and its bytes (q and the output at Tq, k and
v at Tk, once each) at the memory rate.  In the device trace their kernels
are told from CLIP's K2 launches by the template arguments: the general
route's kernel without the bias and the causal mask at the padded head dim
80 (``g1_bf16_kernel<false, false, 80, ...>``, or G2's), which no other
attention of the cell instantiates (CLIP ViT-L/14 runs
``resident_kernel<false, false, 64>``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..reference import sam2 as ref_sam2
from . import roofline
from .flops import _count, _meta_params

HEAD_DIM = 72  # Hiera-L's, at every stage
_HIERA = re.compile(r"(?:^|[\s:])(?:g1_bf16_kernel|g2_tf32x3_kernel)<false, false, 80\b")


def sam2_frame_ops(v: ref_sam2.SAM2Sizes, points_per_side: int) -> Dict[str, float]:
    """One frame through SAM 2's image encoder and its decoder over the
    points_per_side^2 grid, 64 prompts a pass (the generator's, and the
    reference's default): {"total", "int8"} operations (no part runs in
    int8)."""
    p = _meta_params(ref_sam2.spec(v))
    s = v.img_size
    enc = _count(lambda: ref_sam2.image_features(p, v, torch.empty((1, s, s, 3), device="meta")))
    g = (s + 2 * v.patch_padding - v.patch_kernel) // v.patch_stride + 1
    g2 = g // 2 ** (len(v.stages) - 1 - v.scalp)
    d = v.decoder_dim
    feats = (torch.empty((g2, g2, d), device="meta"), torch.empty((4 * g2, 4 * g2, d // 8), device="meta"),
             torch.empty((2 * g2, 2 * g2, d // 4), device="meta"))
    dec = _count(lambda: ref_sam2.decode_grid(p, v, feats, points_per_side))
    return {"total": float(enc + dec), "int8": 0.0}


def is_hiera(key: tuple) -> bool:
    """Whether a K2 trace key is one of Hiera's launches (head dim 72)."""
    return key[3] == HEAD_DIM


def attention_cost(key: tuple) -> Tuple[float, float, float]:
    """(ops, bytes, peak) of one K2 launch whose key may carry Tk after the
    dtype: 4 Tq Tk D a head, q, k, v and the output once."""
    b, h, tq, d, causal, dt = key[:6]
    tk = key[6] if len(key) > 6 else tq
    pairs = tq * (tq + 1) / 2 if causal else tq * tk
    nbytes = 2 * b * h * (tq + tk) * d * roofline.ELEMENT_BYTES[dt]
    return 4.0 * pairs * d * b * h, nbytes, roofline.ATTENTION_PEAK[dt]


def kernel_of(name: str) -> Optional[str]:
    """"hiera" for a device operation of Hiera's attention (above), else
    ``roofline.kernel_of``'s family."""
    return "hiera" if _HIERA.search(name) else roofline.kernel_of(name)


def roofline_percent(keys: Iterable[tuple], device_s: float) -> Optional[float]:
    """Σ least time of Hiera's launches ÷ the device time of their kernels,
    in percent; None when there is none."""
    least = sum(roofline.bound_s(*attention_cost(k)) for k in keys)
    if least <= 0.0 or device_s <= 0.0:
        return None
    return 100.0 * least / device_s
