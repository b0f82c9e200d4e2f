"""Plain float32 CLIP visual tower over a flat parameter dict, and
ConceptFusion's crops and per-mask fusion.

The architecture is OpenCLIP's ViT (Radford et al., "Learning Transferable
Visual Models From Natural Language Supervision", 2021): patch embedding,
class token, pre-LN transformer blocks with tanh GELU, the class token's
projection.  The parameter names and layouts are those of the program's towers
(``blocks.<i>.wqkv`` is (in, out)), so one seeded set of weights serves
both.  Written from the port's ``models/clip.py`` and
``models/transformer.py`` at commit
b62fedabdce77346f1a976bf9b6f57fc0f42ce1b, in float32 with dense softmax
attention: nothing here calls a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .imageops import crop_and_resize, expand_boxes, resize
from .precision import mm

IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-5


@dataclass(frozen=True)
class CLIPSizes:
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

    @staticmethod
    def of(d: dict) -> "CLIPSizes":
        return CLIPSizes(**d)


def _block_spec(s, prefix: str, width: int, layers: int) -> None:
    proj = (2 * layers) ** -0.5
    for i in range(layers):
        p = f"{prefix}blocks.{i}."
        s[p + "ln1_g"] = ((width,), "const", 1.0)
        s[p + "ln1_b"] = ((width,), "const", 0.0)
        s[p + "wqkv"] = ((width, 3 * width), "normal", width**-0.5)
        s[p + "bqkv"] = ((3 * width,), "const", 0.0)
        s[p + "wo"] = ((width, width), "normal", width**-0.5 * proj)
        s[p + "bo"] = ((width,), "const", 0.0)
        s[p + "ln2_g"] = ((width,), "const", 1.0)
        s[p + "ln2_b"] = ((width,), "const", 0.0)
        s[p + "w1"] = ((width, 4 * width), "normal", (2 * width) ** -0.5)
        s[p + "b1"] = ((4 * width,), "const", 0.0)
        s[p + "w2"] = ((4 * width, width), "normal", width**-0.5 * proj)
        s[p + "b2"] = ((width,), "const", 0.0)


def visual_spec(v: CLIPSizes) -> Dict[str, Tuple[tuple, str, float]]:
    """name -> (shape, kind, scale), the published init's scales (the
    port's ``init_clip``)."""
    w = v.v_width
    n = (v.image_size // v.patch) ** 2
    s: Dict[str, Tuple[tuple, str, float]] = {
        "patch_w": ((v.patch * v.patch * 3, w), "normal", w**-0.5),
        "cls": ((w,), "normal", w**-0.5),
        "pos": ((n + 1, w), "normal", w**-0.5),
        "ln_pre_g": ((w,), "const", 1.0),
        "ln_pre_b": ((w,), "const", 0.0),
        "ln_post_g": ((w,), "const", 1.0),
        "ln_post_b": ((w,), "const", 0.0),
        "proj": ((w, v.embed_dim), "normal", w**-0.5),
    }
    _block_spec(s, "", w, v.v_layers)
    return s


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g, b, LN_EPS)


def _stack(x, p, layers: int, heads: int):
    b, t, w = x.shape
    hd = w // heads
    for i in range(layers):
        blk = f"blocks.{i}."
        qkv = mm(_ln(x, p[blk + "ln1_g"], p[blk + "ln1_b"]), p[blk + "wqkv"]) + p[blk + "bqkv"]
        q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2) for z in qkv.split(w, dim=-1))
        s = mm(q, k.transpose(-1, -2)) * hd**-0.5
        a = mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, t, w)
        x = x + mm(a, p[blk + "wo"]) + p[blk + "bo"]
        h = mm(_ln(x, p[blk + "ln2_g"], p[blk + "ln2_b"]), p[blk + "w1"]) + p[blk + "b1"]
        x = x + mm(F.gelu(h, approximate="tanh"), p[blk + "w2"]) + p[blk + "b2"]
    return x


def encode_image(p, v: CLIPSizes, images, chunk: int = 64):
    """(B, S, S, 3) normalized -> (B, embed_dim) unit image features, in
    chunks of `chunk` images."""
    outs = []
    g = v.image_size // v.patch
    for s in range(0, images.shape[0], chunk):
        im = images[s : s + chunk]
        b = im.shape[0]
        x = im.reshape(b, g, v.patch, g, v.patch, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, -1)
        x = torch.cat([p["cls"].expand(b, 1, -1), mm(x, p["patch_w"])], dim=1) + p["pos"]
        x = _stack(_ln(x, p["ln_pre_g"], p["ln_pre_b"]), p, v.v_layers, v.v_heads)
        f = mm(_ln(x[:, 0], p["ln_post_g"], p["ln_post_b"]), p["proj"])
        outs.append(f / torch.linalg.norm(f, dim=-1, keepdim=True))
    return torch.cat(outs)


def _l2(x, eps=1e-9):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def crop_stack(v: CLIPSizes, image01, masks, valid, boxes, tier: int, bbox_margin: float):
    """ConceptFusion's crops of one frame: the first `tier` masks in
    valid-first order, each as a plain and a background-blanked crop of its
    box grown by `bbox_margin`, then the whole frame; normalized for the
    tower.  Returns (stack (2 tier + 1, S, S, 3), selection, its validity)."""
    h, w, _ = image01.shape
    sel = torch.argsort((~valid).to(torch.int8), stable=True)[:tier]
    eboxes = expand_boxes(boxes[sel], bbox_margin, h, w)
    size = v.image_size
    plain = crop_and_resize(image01, eboxes, size)
    masked = crop_and_resize(image01, eboxes, size, masks=masks[sel])
    frame = resize(image01[None], (1, size, size, 3), "cubic")
    stack = torch.cat([plain, masked, frame], dim=0)
    mean = torch.tensor(IMAGE_MEAN, device=stack.device)
    std = torch.tensor(IMAGE_STD, device=stack.device)
    return (stack - mean) / std, sel, valid[sel]


def fuse(feats, sel, valid_t, m: int, masked_weight: float):
    """(2 tier + 1, D) crop features -> (M, D) per-mask features (the
    masked/plain blend, then the softmax weighting against the whole
    frame) and the frame's feature."""
    tier = sel.shape[0]
    f_plain, f_masked, f_g = feats[:tier], feats[tier : 2 * tier], feats[2 * tier]
    f_l = _l2(masked_weight * f_masked + (1.0 - masked_weight) * f_plain)
    phi = f_l @ f_g
    w_i = torch.softmax(torch.where(valid_t, phi, torch.full_like(phi, float("-inf"))), dim=0)[:, None]
    w_i = torch.where(valid_t[:, None], w_i, torch.zeros_like(w_i))
    f_p = _l2(w_i * f_g[None, :] + (1.0 - w_i) * f_l)
    f_p = torch.where(valid_t[:, None], f_p, torch.zeros_like(f_p))
    out = torch.zeros((m, f_p.shape[-1]), device=f_p.device)
    out[sel] = f_p
    return out, f_g
