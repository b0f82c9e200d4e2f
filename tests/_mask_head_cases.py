"""SAM 2's mask head (holoagent_tpu_torch/ops/mask_head.py): inputs at the
kernel's widths, the kernel's arithmetic in plain PyTorch, and faulty
plain versions that a check of the kernel must reject.

Shared by the CPU tests (tests/test_torch_mask_head.py) and chip_smoke.py's
mask-head phase, which loads this file by path.  torch only, no JAX.
"""

import torch
import torch.nn.functional as F

from holoagent_tpu_torch.models.sam import _upscale
from holoagent_tpu_torch.ops.mask_head import ARG_NAMES as ARGS, mask_head_ref

# LayerNorm skipped on sub-pixel (0, 0) of the first upscaling (a quarter of
# u1's pixels); the feat_s0 skip dropped; the tanh GELU in place of the erf
# one in both activations.
MASK_HEAD_FAULTS = ("layernorm_skipped_on_one_subpixel", "feat_s0_dropped", "tanh_gelu")


def head_inputs(p: int, g: int, dtype=torch.bfloat16, seed: int = 0, device="cpu") -> dict:
    """Random inputs at SAM 2's decoder widths (256 tokens' channels, 64 and
    32 after the upscalings, 4 masks) with the scales of its init: unit
    tokens and features, weights at fan-in^-1/2, small biases."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=gen)).to(device, dtype)

    return dict(src=draw(p, g, g, 256), feat_s0=draw(4 * g, 4 * g, 32, std=0.5),
                feat_s1=draw(2 * g, 2 * g, 64, std=0.5), up1_w=draw(2, 2, 256, 64, std=256**-0.5),
                up1_b=draw(64, std=0.1), ln_g=draw(64, std=0.1, mean=1.0), ln_b=draw(64, std=0.1),
                up2_w=draw(2, 2, 64, 32, std=64**-0.5), up2_b=draw(32, std=0.1), hyper=draw(p, 4, 32, std=0.3))


def kernel_arithmetic(a: dict, eps: float, acc=torch.float32) -> torch.Tensor:
    """csrc/mask_head.cu's arithmetic in plain PyTorch: every sum, the
    LayerNorm and the GELUs in `acc` on the inputs' exact values, rounded to
    the inputs' dtype only after each GELU (where the plain version rounds
    too).  (P, 4, 4g, 4g) float32."""
    dt = a["src"].dtype
    f = {k: v.to(acc) for k, v in a.items()}
    u = _upscale(f["src"], f["up1_w"], f["up1_b"]) + f["feat_s1"]
    u = F.gelu(F.layer_norm(u, (u.shape[-1],), f["ln_g"], f["ln_b"], eps)).to(dt).to(acc)
    u = F.gelu(_upscale(u, f["up2_w"], f["up2_b"]) + f["feat_s0"]).to(dt).to(acc)
    return torch.einsum("pnc,phwc->pnhw", f["hyper"], u).float()


def faulty_head(a: dict, eps: float, fault: str) -> torch.Tensor:
    """``mask_head_ref`` with one deliberate fault (MASK_HEAD_FAULTS)."""
    if fault not in MASK_HEAD_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "feat_s0_dropped":
        return mask_head_ref(*(torch.zeros_like(a[k]) if k == "feat_s0" else a[k] for k in ARGS), eps)
    approx = "tanh" if fault == "tanh_gelu" else "none"

    def gelu(x):
        return F.gelu(x.float(), approximate=approx).to(x.dtype)

    u = _upscale(a["src"], a["up1_w"], a["up1_b"]) + a["feat_s1"]
    v = F.layer_norm(u.float(), (u.shape[-1],), a["ln_g"].float(), a["ln_b"].float(), eps).to(u.dtype)
    if fault == "layernorm_skipped_on_one_subpixel":
        v[:, 0::2, 0::2] = u[:, 0::2, 0::2]
    u = gelu(_upscale(gelu(v), a["up2_w"], a["up2_b"]) + a["feat_s0"])
    return torch.einsum("pnc,phwc->pnhw", a["hyper"].float(), u.float())
