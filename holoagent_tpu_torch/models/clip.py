"""CLIP towers (counterpart of holoagent_tpu/models/clip.py).

Image tower: patchify -> pre-LN ViT -> cls token -> projection.  Text
tower: token + position embeddings -> causal pre-LN transformer ->
features at the <eot> position -> projection; its attention runs through
kernel K2's causal mode on the card.

``preprocess`` crops, resizes (``ops/resize.py``'s cubic, as
``jax.image.resize``) and normalizes frames for the image tower.
``quantize_clip`` gives the int8 (W8A8) image tower: its blocks become
``blocks_q8`` (``transformer.QBlock``) and every block matmul runs through
kernel K3.  The text tower stays float, as the reference's ``quantize_clip``
quantizes ``("visual",)`` only.  ``convert_open_clip`` / ``load_checkpoint``
map an open_clip state dict onto the port's two towers, with the
reference's key map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, generator, resolve
from ..ops.resize import resize
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


class CLIPText(nn.Module):
    """Text tower parameters, named and laid out as the reference's
    ``params["text"]``, in the working dtype."""

    def __init__(self, variant: CLIPVariant, dtype=torch.float32, device: DeviceLike = None):
        super().__init__()
        dev = resolve(device)
        kw = dict(dtype=dtype, device=dev)
        w = variant.t_width
        self.variant = variant
        self.tok_emb = tfm.frozen(torch.empty(variant.vocab, w, **kw))
        self.pos = tfm.frozen(torch.empty(variant.ctx, w, **kw))
        self.blocks = nn.ModuleList(tfm.Block(w, 4 * w, dtype=dtype, device=dev) for _ in range(variant.t_layers))
        self.ln_final_g = tfm.frozen(torch.ones(w, **kw))
        self.ln_final_b = tfm.frozen(torch.zeros(w, **kw))
        self.proj = tfm.frozen(torch.empty(w, variant.embed_dim, **kw))


def preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Resize (B, H, W, 3) float [0,1] to (B, size, size, 3) and normalize:
    the center square crop, ``jax.image.resize``'s antialiased Keys cubic
    (``ops/resize.py``), then the CLIP mean and std, in the images' dtype."""
    b, h, w, _ = images.shape
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    out = resize(images[:, y0 : y0 + s, x0 : x0 + s], (b, size, size, 3), "cubic")
    mean = torch.tensor(IMAGE_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGE_STD, dtype=images.dtype, device=images.device)
    return (out - mean) / std


def _init_visual_(model: CLIPVisual, gen: torch.Generator) -> None:
    variant = model.variant
    scale = variant.v_width**-0.5
    for p in (model.patch_w, model.cls, model.pos, model.proj):
        tfm._normal_(p, scale, gen)
    for blk in model.blocks:
        tfm.init_block_(blk, gen, variant.v_layers)


def init_clip_visual(
    variant: CLIPVariant, seed: int = 0, dtype=torch.float32, device: DeviceLike = None
) -> CLIPVisual:
    """Random visual tower from a seeded torch.Generator, with the
    reference's ``init_clip`` shapes and scales (values differ from JAX's)."""
    model = CLIPVisual(variant, dtype=dtype, device=device)
    _init_visual_(model, generator(seed))
    return model


def init_clip(
    variant: CLIPVariant, seed: int = 0, dtype=torch.float32, device: DeviceLike = None
) -> Tuple[CLIPVisual, CLIPText]:
    """Both towers from one seeded generator: the visual tower first (equal
    to ``init_clip_visual(variant, seed)``), then the text tower, with the
    reference's ``init_clip`` shapes and scales."""
    gen = generator(seed)
    visual = CLIPVisual(variant, dtype=dtype, device=device)
    _init_visual_(visual, gen)
    text = CLIPText(variant, dtype=dtype, device=device)
    tfm._normal_(text.tok_emb, 0.02, gen)
    tfm._normal_(text.pos, 0.01, gen)
    tfm._normal_(text.proj, variant.t_width**-0.5, gen)
    for blk in text.blocks:
        tfm.init_block_(blk, gen, variant.t_layers)
    return visual, text


@torch.no_grad()
def quantize_clip(visual: CLIPVisual, dtype: Optional[torch.dtype] = None) -> CLIPVisual:
    """Per-output-channel int8 quantization of the tower's blocks (W8A8,
    ``transformer.quantize_block_``): a new tower with ``blocks_q8`` in place
    of ``blocks``.  The block norms and biases and everything outside the
    blocks stay float, in `dtype` (default: the tower's).  The scales are
    computed from the tower's own values: a bf16 tower's in bf16, as the
    reference's on bf16 params; a converted checkpoint's in float32 (quantize
    the float32 tower with `dtype` the working dtype), as the reference's."""
    out = CLIPVisual(visual.variant, dtype=dtype or visual.patch_w.dtype, device=visual.patch_w.device, quant=True)
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


@torch.no_grad()
def encode_text(
    text: CLIPText,
    tokens: torch.Tensor,  # (B, ctx) integer token ids
    impl: str = "flash",  # "flash": causal attention through kernel K2 | "xla": its plain version
    normalize: bool = True,
    dtype: torch.dtype | None = None,  # compute dtype (default: the tower's)
) -> torch.Tensor:
    """(B, ctx) tokens -> (B, embed_dim) float32 text features, read at the
    <eot> position (the largest token id).  Weights are cast to `dtype` where
    they are used, as the reference casts its tower to its compute dtype."""
    variant = text.variant
    dtype = dtype or text.tok_emb.dtype
    tokens = torch.as_tensor(tokens, device=text.tok_emb.device).long()
    x = text.tok_emb[tokens].to(dtype) + text.pos.to(dtype)
    x = tfm.run_stack(x, text.blocks, variant.t_heads, impl=impl, causal=True)
    x = tfm.layer_norm(x, text.ln_final_g, text.ln_final_b)
    x = x[torch.arange(tokens.shape[0], device=x.device), tokens.argmax(dim=-1)]
    feats = x.float() @ text.proj.to(dtype).float()
    if normalize:
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
    return feats


# active template set (reference utils/clip_utils.py:271-335 keeps two)
TEMPLATES = ("{}", "a photo of {} in the scene.")

# extended prompt-ensemble bank (role of the reference's large multi-template
# variant, utils/clip_utils.py:165-254; standard CLIP prompt-engineering set)
EXTENDED_TEMPLATES = (
    "{}",
    "a photo of a {}.",
    "a photo of the {}.",
    "a photo of one {}.",
    "a photo of a {} in the scene.",
    "a photo of the {} in the scene.",
    "a bad photo of a {}.",
    "a bad photo of the {}.",
    "a good photo of a {}.",
    "a good photo of the {}.",
    "a cropped photo of a {}.",
    "a cropped photo of the {}.",
    "a close-up photo of a {}.",
    "a close-up photo of the {}.",
    "a bright photo of a {}.",
    "a bright photo of the {}.",
    "a dark photo of a {}.",
    "a dark photo of the {}.",
    "a blurry photo of a {}.",
    "a blurry photo of the {}.",
    "a photo of a small {}.",
    "a photo of the small {}.",
    "a photo of a large {}.",
    "a photo of the large {}.",
    "a photo of a clean {}.",
    "a photo of the clean {}.",
    "a photo of a dirty {}.",
    "a photo of the dirty {}.",
    "a low resolution photo of a {}.",
    "a low resolution photo of the {}.",
    "a pixelated photo of a {}.",
    "a pixelated photo of the {}.",
    "a jpeg corrupted photo of a {}.",
    "a jpeg corrupted photo of the {}.",
    "a photo of a {} in a room.",
    "a photo of the {} in a room.",
    "a photo of a {} in a house.",
    "a photo of the {} in a house.",
    "there is a {} in the scene.",
    "there is the {} in the scene.",
    "this is a {} in the scene.",
    "this is the {} in the scene.",
    "this is one {} in the scene.",
    "an indoor photo of a {}.",
    "an indoor photo of the {}.",
    "a rendering of a {}.",
    "a rendering of the {}.",
    "a picture of a {}.",
    "a picture of the {}.",
    "an image of a {}.",
    "an image of the {}.",
    "a photo of a {} on a floor.",
    "a photo of the {} on a floor.",
    "a photo of a nice {}.",
    "a photo of the nice {}.",
    "a photo of a weird {}.",
    "a photo of the weird {}.",
    "a photo of my {}.",
    "i took a picture of a {}.",
    "a photograph of a {}.",
    "a photograph of the {}.",
)


@torch.no_grad()
def text_features_multi_template(
    text: CLIPText,
    tokenizer,
    labels: Sequence[str],
    templates: Sequence[str] = TEMPLATES,
    dtype: torch.dtype = torch.bfloat16,
    batch_size: int = 256,
    impl: str = "flash",
) -> torch.Tensor:
    """Mean text embedding over prompt templates per label (reference
    utils/clip_utils.py:257-349): (len(labels), D) float32 on the tower's
    device, each prompt's features L2-normalized, then averaged.  As the
    reference, the tower computes in bf16 whatever its stored dtype, and
    every chunk of prompts is padded to `batch_size`, so every launch has one
    shape."""
    prompts = [t.format(lb) for lb in labels for t in templates]
    tokens = torch.from_numpy(tokenizer(prompts))
    feats = []
    for i in range(0, len(prompts), batch_size):
        chunk = tokens[i : i + batch_size]
        n = chunk.shape[0]
        chunk = F.pad(chunk, (0, 0, 0, batch_size - n))
        feats.append(encode_text(text, chunk, impl=impl, dtype=dtype)[:n])
    f = torch.cat(feats)
    return f.reshape(len(labels), len(templates), -1).mean(dim=1)


# ---------------------------------------------------------------------------
# Checkpoint conversion (torch / open_clip state dict)
# ---------------------------------------------------------------------------


def _open_clip_tree(state: Dict[str, torch.Tensor], variant: CLIPVariant) -> dict:
    """The reference's CLIP parameter tree, numpy float32 with the blocks
    stacked on a leading layer axis, from an open_clip state dict (the
    reference's ``convert_open_clip`` key map: torch Linear weights (out,
    in) transposed)."""
    import numpy as np

    def g(name):
        t = state[name]
        if hasattr(t, "detach"):
            t = t.detach().float().cpu().numpy()
        return np.asarray(t, np.float32)

    def blocks(prefix, layers):
        per = {
            "ln1_g": "ln_1.weight", "ln1_b": "ln_1.bias", "wqkv": "attn.in_proj_weight", "bqkv": "attn.in_proj_bias",
            "wo": "attn.out_proj.weight", "bo": "attn.out_proj.bias", "ln2_g": "ln_2.weight", "ln2_b": "ln_2.bias",
            "w1": "mlp.c_fc.weight", "b1": "mlp.c_fc.bias", "w2": "mlp.c_proj.weight", "b2": "mlp.c_proj.bias",
        }
        transposed = ("wqkv", "wo", "w1", "w2")
        return {
            k: np.stack([g(f"{prefix}.{i}.{name}").T if k in transposed else g(f"{prefix}.{i}.{name}")
                         for i in range(layers)])
            for k, name in per.items()
        }

    conv = g("visual.conv1.weight")  # (W, 3, P, P)
    return {
        "visual": {
            "patch_w": conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0]),  # (P*P*3, W)
            "cls": g("visual.class_embedding"),
            "pos": g("visual.positional_embedding"),
            "ln_pre_g": g("visual.ln_pre.weight"), "ln_pre_b": g("visual.ln_pre.bias"),
            "blocks": blocks("visual.transformer.resblocks", variant.v_layers),
            "ln_post_g": g("visual.ln_post.weight"), "ln_post_b": g("visual.ln_post.bias"),
            "proj": g("visual.proj"),
        },
        "text": {
            "tok_emb": g("token_embedding.weight"),
            "pos": g("positional_embedding"),
            "blocks": blocks("transformer.resblocks", variant.t_layers),
            "ln_final_g": g("ln_final.weight"), "ln_final_b": g("ln_final.bias"),
            "proj": g("text_projection"),
        },
    }


def convert_open_clip(state: Dict[str, torch.Tensor], variant: CLIPVariant, dtype=torch.float32,
                      device: DeviceLike = None) -> Tuple[CLIPVisual, CLIPText]:
    """Map an open_clip CLIP state dict (torch tensors or numpy arrays) onto
    the port's visual and text towers, in `dtype` on `device` (the card
    unless the caller asks for the CPU), through ``bridge.py``.  The
    reference's tree also carries ``logit_scale``, which no tower of the
    port uses."""
    from ..bridge import clip_from_jax, clip_text_from_jax

    device = resolve(device)
    tree = _open_clip_tree(state, variant)
    return (clip_from_jax(tree, variant, device=device, dtype=dtype),
            clip_text_from_jax(tree, variant, device=device, dtype=dtype))


def load_checkpoint(path: str, variant: CLIPVariant, dtype=torch.float32,
                    device: DeviceLike = None) -> Tuple[CLIPVisual, CLIPText]:
    """Load an open_clip ``.bin`` / ``.pt`` torch checkpoint (a bare state
    dict or one under ``state_dict``, keys with or without a ``module.``
    prefix, as the reference unwraps them) and convert it."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    state = {k.removeprefix("module."): v for k, v in state.items()}
    return convert_open_clip(state, variant, dtype=dtype, device=device)
