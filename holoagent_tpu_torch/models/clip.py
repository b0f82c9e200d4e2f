"""CLIP towers (counterpart of holoagent_tpu/models/clip.py).

Image tower: patchify -> pre-LN ViT -> cls token -> projection.  Text
tower: token + position embeddings -> causal pre-LN transformer ->
features at the <eot> position -> projection; its attention runs through
kernel K2's causal mode on the card.

``preprocess`` crops, resizes (``ops/resize.py``'s cubic, as
``jax.image.resize``) and normalizes frames for the image tower.
``quantize_clip`` gives an int8 (W8A8) tower, the image or the text one
(the reference's ``quantize_clip(params, towers=("visual", "text"))``): its
blocks become ``blocks_q8`` (``transformer.QBlock``) and every block matmul
runs through kernel K3; the text tower's attention stays causal, through
K2's causal mode on the card.  ``convert_open_clip`` / ``load_checkpoint``
map an open_clip state dict onto the port's two towers, with the
reference's key map.

Each tower carries ``impl``, the attention route it was built for: "flash"
(kernel K2 on the card, at any width and dtype: its tensor-core routes for
bf16 at head dim 64, and 80 for ViT-H-14's visual tower, its general route
for float32 and the tiny towers' head dim 16) unless the code that makes
it says "xla" (the plain version: the fixture-trained tiny towers, which
the reference's training and accuracy rows run on its plain attention).
Callers that do not name a route take the tower's.  ``forward_image`` and
``forward_text`` are the towers' differentiable forwards (a compute
``dtype`` cast inside the autograd graph, ``remat``); the serving entry
points ``encode_image`` and ``encode_text`` are the same functions without
autograd.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, generator, resolve
from ..ops.resize import resize
from . import transformer as tfm

INIT_LOGIT_SCALE = math.log(1 / 0.07)  # the reference's init_clip logit_scale

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


def clip_dim(name: str) -> int:
    """Embedding dim lookup (reference utils/constants.py:3-7 CLIP_DIM)."""
    return VARIANTS[name].embed_dim


IMPLS = ("flash", "xla")


class CLIPVisual(nn.Module):
    """Visual tower parameters, named and laid out as the reference's
    ``params["visual"]``.  Parameters live in the working dtype.  With
    ``quant`` the blocks are ``blocks_q8`` (int8, see ``quantize_clip``).
    ``impl``: the attention route the tower was built for (module
    docstring)."""

    def __init__(self, variant: CLIPVariant, dtype=torch.float32, device: DeviceLike = None, quant: bool = False,
                 impl: str = "flash"):
        super().__init__()
        dev = resolve(device)
        kw = dict(dtype=dtype, device=dev)
        w = variant.v_width
        n_patches = (variant.image_size // variant.patch) ** 2
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.variant = variant
        self.quant = quant
        self.impl = impl
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
    ``params["text"]``, in the working dtype.  With ``quant`` the blocks are
    ``blocks_q8``; ``impl`` as ``CLIPVisual``'s."""

    def __init__(self, variant: CLIPVariant, dtype=torch.float32, device: DeviceLike = None, quant: bool = False,
                 impl: str = "flash"):
        super().__init__()
        dev = resolve(device)
        kw = dict(dtype=dtype, device=dev)
        w = variant.t_width
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.variant = variant
        self.quant = quant
        self.impl = impl
        self.tok_emb = tfm.frozen(torch.empty(variant.vocab, w, **kw))
        self.pos = tfm.frozen(torch.empty(variant.ctx, w, **kw))
        blocks = nn.ModuleList(
            (tfm.QBlock if quant else tfm.Block)(w, 4 * w, dtype=dtype, device=dev) for _ in range(variant.t_layers)
        )
        setattr(self, "blocks_q8" if quant else "blocks", blocks)
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
    tfm.init_block_stack(model.blocks, gen)


def init_clip_visual(
    variant: CLIPVariant, seed: int = 0, dtype=torch.float32, device: DeviceLike = None, impl: str = "flash"
) -> CLIPVisual:
    """Random visual tower from a seeded torch.Generator, with the
    reference's ``init_clip`` shapes and scales (values differ from JAX's)."""
    model = CLIPVisual(variant, dtype=dtype, device=device, impl=impl)
    _init_visual_(model, generator(seed))
    return model


def init_clip(
    variant: CLIPVariant, seed: int = 0, dtype=torch.float32, device: DeviceLike = None, impl: str = "flash"
) -> Tuple[CLIPVisual, CLIPText]:
    """Both towers from one seeded generator: the visual tower first (equal
    to ``init_clip_visual(variant, seed)``), then the text tower, with the
    reference's ``init_clip`` shapes and scales.  The reference's tree also
    holds ``logit_scale`` (log 1/0.07), which the contrastive trainer owns
    (``INIT_LOGIT_SCALE``)."""
    gen = generator(seed)
    visual = CLIPVisual(variant, dtype=dtype, device=device, impl=impl)
    _init_visual_(visual, gen)
    text = CLIPText(variant, dtype=dtype, device=device, impl=impl)
    tfm._normal_(text.tok_emb, 0.02, gen)
    tfm._normal_(text.pos, 0.01, gen)
    tfm._normal_(text.proj, variant.t_width**-0.5, gen)
    tfm.init_block_stack(text.blocks, gen)
    return visual, text


@torch.no_grad()
def quantize_clip(tower, dtype: Optional[torch.dtype] = None):
    """Per-output-channel int8 quantization of a tower's blocks (W8A8,
    ``transformer.quantize_block_stack``): a new ``CLIPVisual`` or ``CLIPText``
    with ``blocks_q8`` in place of ``blocks`` and the same ``impl``.  The
    block norms and biases and everything outside the blocks stay float, in
    `dtype` (default: the tower's).  The scales are computed from the
    tower's own values: a bf16 tower's in bf16, as the reference's on bf16
    params; a converted checkpoint's in float32 (quantize the float32 tower
    with `dtype` the working dtype), as the reference's."""
    like = next(tower.parameters())
    out = type(tower)(tower.variant, dtype=dtype or like.dtype, device=like.device, quant=True, impl=tower.impl)
    for name, p in tower.named_parameters(recurse=False):
        getattr(out, name).copy_(p)
    tfm.quantize_block_stack(out.blocks_q8, tower.blocks)
    return out


def forward_image(
    visual: CLIPVisual,
    images: torch.Tensor,  # (B, S, S, 3) already normalized, channel-last
    impl: str = "xla",  # "flash": attention through kernel K2
    normalize: bool = True,
    qmm: str = "xla",  # int8 tower: "pallas" = the fused kernel's contract (see transformer._q8_mm)
    dtype: Optional[torch.dtype] = None,  # compute dtype (default: the tower's)
    remat: bool = False,  # recompute each block in the backward pass
    tp=None,  # (mesh, axis): the blocks tensor-parallel over that axis (transformer.block)
) -> torch.Tensor:
    """(B, S, S, 3) -> (B, embed_dim) float32 image features, differentiable
    (the reference's ``encode_image``).  An int8 tower runs its blocks
    through K3 in either `qmm` mode; a float tower ignores `qmm`, as the
    reference does.  A float tower's weights are cast to `dtype` where they
    are used, as the reference casts them (the pre/post norms stay in their
    own dtype)."""
    variant = visual.variant
    dtype = dtype or visual.patch_w.dtype
    p = variant.patch
    b, s, _, _ = images.shape
    g = s // p
    x = images.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
    x = tfm.linear(x.to(dtype), visual.patch_w)
    cls = visual.cls.to(dtype).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + visual.pos.to(dtype)
    x = tfm.layer_norm(x, visual.ln_pre_g, visual.ln_pre_b)
    if visual.quant:
        x = tfm.run_stack_q8(x, visual.blocks_q8, variant.v_heads, impl=impl, qmm=qmm)
    else:
        x = tfm.run_stack(x, tfm.cast_blocks(visual.blocks, dtype), variant.v_heads, impl=impl, remat=remat, tp=tp)
    x = tfm.layer_norm(x[:, 0], visual.ln_post_g, visual.ln_post_b)
    feats = x.float() @ visual.proj.to(dtype).float()
    if normalize:
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
    return feats


@torch.no_grad()
def encode_image(
    visual: CLIPVisual,
    images: torch.Tensor,
    impl: str = "xla",
    normalize: bool = True,
    qmm: str = "xla",
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``forward_image`` without autograd: the serving entry point."""
    return forward_image(visual, images, impl=impl, normalize=normalize, qmm=qmm, dtype=dtype)


def forward_text(
    text: CLIPText,
    tokens: torch.Tensor,  # (B, ctx) integer token ids
    impl: Optional[str] = None,  # "flash": causal attention through kernel K2 | "xla": its plain version
    normalize: bool = True,
    dtype: torch.dtype | None = None,  # compute dtype (default: the tower's)
    tp=None,  # (mesh, axis): as forward_image's
) -> torch.Tensor:
    """(B, ctx) tokens -> (B, embed_dim) float32 text features, read at the
    <eot> position (the largest token id), differentiable (the reference's
    ``encode_text``).  `impl` defaults to the tower's.  Float weights are
    cast to `dtype` where they are used, as the reference casts its tower
    to its compute dtype; an int8 tower runs its blocks through K3."""
    variant = text.variant
    impl = impl or text.impl
    dtype = dtype or text.tok_emb.dtype
    tokens = torch.as_tensor(tokens, device=text.tok_emb.device).long()
    x = text.tok_emb[tokens].to(dtype) + text.pos.to(dtype)
    if text.quant:
        x = tfm.run_stack_q8(x, text.blocks_q8, variant.t_heads, impl=impl, causal=True)
    else:
        x = tfm.run_stack(x, tfm.cast_blocks(text.blocks, dtype), variant.t_heads, impl=impl, causal=True, tp=tp)
    x = tfm.layer_norm(x, text.ln_final_g, text.ln_final_b)
    x = x[torch.arange(tokens.shape[0], device=x.device), tokens.argmax(dim=-1)]
    feats = x.float() @ text.proj.to(dtype).float()
    if normalize:
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
    return feats


@torch.no_grad()
def encode_text(
    text: CLIPText,
    tokens: torch.Tensor,
    impl: Optional[str] = None,
    normalize: bool = True,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``forward_text`` without autograd: the serving entry point."""
    return forward_text(text, tokens, impl=impl, normalize=normalize, dtype=dtype)


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
    impl: Optional[str] = None,  # default: the tower's
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
    reference's tree also carries ``logit_scale``, which only the
    contrastive trainer uses (``bridge.logit_scale_from_jax``)."""
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
