"""CLIP image tower (counterpart of holoagent_tpu/models/clip.py, visual
side): patchify -> pre-LN ViT -> cls token -> projection.

``quantize_clip`` gives the int8 (W8A8) tower: its blocks become
``blocks_q8`` (``transformer.QBlock``) and every block matmul runs through
kernel K3.  The text tower and checkpoint conversion are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from ..device import DeviceLike, generator, resolve
from . import transformer as tfm

# open_clip / CLIP normalization constants
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPVariant:
    name: str
    image_size: int
    patch: int
    v_width: int
    v_layers: int
    v_heads: int
    t_width: int
    t_layers: int
    t_heads: int
    embed_dim: int
    vocab: int = 49408
    ctx: int = 77


VARIANTS = {
    "ViT-B-32": CLIPVariant("ViT-B-32", 224, 32, 768, 12, 12, 512, 12, 8, 512),
    "ViT-L-14": CLIPVariant("ViT-L-14", 224, 14, 1024, 24, 16, 768, 12, 12, 768),
    "ViT-H-14": CLIPVariant("ViT-H-14", 224, 14, 1280, 32, 16, 1024, 24, 16, 1024),
    "test-tiny": CLIPVariant("test-tiny", 32, 8, 64, 2, 4, 64, 2, 4, 32),
}


class CLIPVisual(nn.Module):
    """Visual tower parameters, named and laid out as the reference's
    ``params["visual"]``.  Parameters live in the working dtype.  With
    ``quant`` the blocks are ``blocks_q8`` (int8, see ``quantize_clip``)."""

    def __init__(self, variant: CLIPVariant, dtype=torch.float32, device: DeviceLike = None, quant: bool = False):
        super().__init__()
        dev = resolve(device)
        kw = dict(dtype=dtype, device=dev)
        w = variant.v_width
        n_patches = (variant.image_size // variant.patch) ** 2
        self.variant = variant
        self.quant = quant
        self.patch_w = tfm.frozen(torch.empty(variant.patch * variant.patch * 3, w, **kw))
        self.cls = tfm.frozen(torch.empty(w, **kw))
        self.pos = tfm.frozen(torch.empty(n_patches + 1, w, **kw))
        self.ln_pre_g = tfm.frozen(torch.ones(w, **kw))
        self.ln_pre_b = tfm.frozen(torch.zeros(w, **kw))
        blocks = nn.ModuleList(
            (tfm.QBlock if quant else tfm.Block)(w, 4 * w, dtype=dtype, device=dev) for _ in range(variant.v_layers)
        )
        setattr(self, "blocks_q8" if quant else "blocks", blocks)
        self.ln_post_g = tfm.frozen(torch.ones(w, **kw))
        self.ln_post_b = tfm.frozen(torch.zeros(w, **kw))
        self.proj = tfm.frozen(torch.empty(w, variant.embed_dim, **kw))


def init_clip_visual(
    variant: CLIPVariant, seed: int = 0, dtype=torch.float32, device: DeviceLike = None
) -> CLIPVisual:
    """Random visual tower from a seeded torch.Generator, with the
    reference's ``init_clip`` shapes and scales (values differ from JAX's)."""
    gen = generator(seed)
    model = CLIPVisual(variant, dtype=dtype, device=device)
    scale = variant.v_width**-0.5
    for p in (model.patch_w, model.cls, model.pos, model.proj):
        tfm._normal_(p, scale, gen)
    for blk in model.blocks:
        tfm.init_block_(blk, gen, variant.v_layers)
    return model


@torch.no_grad()
def quantize_clip(visual: CLIPVisual) -> CLIPVisual:
    """Per-output-channel int8 quantization of the tower's blocks (W8A8,
    ``transformer.quantize_block_``): a new tower with ``blocks_q8`` in place
    of ``blocks``.  The block norms and biases and everything outside the
    blocks stay float, in the tower's dtype (the scales of a bf16 tower are
    computed in bf16, as the reference's on bf16 params)."""
    out = CLIPVisual(visual.variant, dtype=visual.patch_w.dtype, device=visual.patch_w.device, quant=True)
    for name, p in visual.named_parameters(recurse=False):
        getattr(out, name).copy_(p)
    for q, blk in zip(out.blocks_q8, visual.blocks):
        tfm.quantize_block_(q, blk)
    return out


@torch.no_grad()
def encode_image(
    visual: CLIPVisual,
    images: torch.Tensor,  # (B, S, S, 3) already normalized, channel-last
    impl: str = "xla",  # "flash": attention through kernel K2
    normalize: bool = True,
    qmm: str = "xla",  # int8 tower: "pallas" = the fused kernel's contract (see transformer._q8_mm)
) -> torch.Tensor:
    """(B, S, S, 3) -> (B, embed_dim) float32 image features.  An int8
    tower runs its blocks through K3 in either `qmm` mode; a float tower
    ignores `qmm`, as the reference does."""
    variant = visual.variant
    dtype = visual.patch_w.dtype
    p = variant.patch
    b, s, _, _ = images.shape
    g = s // p
    x = images.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
    x = tfm.linear(x.to(dtype), visual.patch_w)
    cls = visual.cls.expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + visual.pos
    x = tfm.layer_norm(x, visual.ln_pre_g, visual.ln_pre_b)
    if visual.quant:
        x = tfm.run_stack_q8(x, visual.blocks_q8, variant.v_heads, impl=impl, qmm=qmm)
    else:
        x = tfm.run_stack(x, visual.blocks, variant.v_heads, impl=impl)
    x = tfm.layer_norm(x[:, 0], visual.ln_post_g, visual.ln_post_b)
    feats = x.float() @ visual.proj.float()
    if normalize:
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
    return feats
