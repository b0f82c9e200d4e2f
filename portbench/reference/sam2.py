"""Plain float32 SAM 2.1 image model (Hiera trunk, FPN neck, SAM 2's mask
decoder) over a flat parameter dict.

Written from the published description: Ravi et al., "SAM 2: Segment
Anything in Images and Videos" (2024, arXiv:2408.00714), Ryali et al.,
"Hiera" (2023, arXiv:2306.00989), and facebookresearch/sam2's
``sam2/configs/sam2.1/sam2.1_hiera_l.yaml`` with the modules it names
(``backbones/hieradet.py``, ``backbones/image_encoder.py``,
``sam/mask_decoder.py``, ``automatic_mask_generator.py``).  Every matrix
product goes through ``precision.mm`` (so a lowered precision applies to
it), attention is a dense softmax, and nothing here calls a kernel or
imports the program.  The parameter names and layouts are the program's
(``encoder.blocks.<i>.qkv.w`` an (in, out) matrix, convolution kernels
HWIO), so one seeded set of weights serves both.

Departures from the source, each the program's too:
- the frame is resized with ``imageops.resize``'s linear weights
  (``jax.image.resize``'s); on the mapping cells' upscalings (640x480 to
  1024x1024) they equal torchvision's bilinear ``Resize``;
- the prompt grid's points are fractions of each axis, without the source's
  half-pixel shift of 0.5 / 1024 in the prompt encoder (SAM's reference in
  this directory omits it too), and each point carries SAM's padding point;
- the SAM-style parameters use the repository's init scales (normal, (in)^-1/2
  for a matrix; 0.02 for embeddings and tokens), not the source's trained
  values.
The decoder's two-way transformer, prompt encoder and hypernetwork MLPs
are SAM's (``reference/sam.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import sam as ref_sam
from .imageops import resize
from .precision import mm

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6


@dataclass(frozen=True)
class SAM2Sizes:
    img_size: int
    patch_kernel: int
    patch_stride: int
    patch_padding: int
    embed_dim: int
    num_heads: int
    stages: Tuple[int, ...]
    dim_mul: float
    head_mul: float
    q_pool: int
    q_stride: int
    window_spec: Tuple[int, ...]
    global_att_blocks: Tuple[int, ...]
    pos_bkg: Tuple[int, ...]
    mlp_ratio: float
    d_model: int
    fpn_top_down_levels: Tuple[int, ...]
    scalp: int
    decoder_dim: int
    decoder_heads: int
    decoder_depth: int
    decoder_mlp: int
    num_mask_tokens: int

    @staticmethod
    def of(d: dict) -> "SAM2Sizes":
        return SAM2Sizes(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def blocks(v: SAM2Sizes) -> List[dict]:
    """The trunk's blocks (dim, dim_out, heads, window, pool): a block's
    window is the current stage's before the stage advances; the block after
    a stage's last one widens by dim_mul, its heads by head_mul, and pools
    its queries (the first q_pool of them); global blocks take window 0."""
    ends = [sum(v.stages[: i + 1]) - 1 for i in range(len(v.stages))]
    dim, heads, cur, out = v.embed_dim, v.num_heads, 0, []
    for i in range(sum(v.stages)):
        window = v.window_spec[cur]
        if i in v.global_att_blocks:
            window = 0
        dim_out = dim
        if i - 1 in ends:
            dim_out, heads, cur = int(dim * v.dim_mul), int(heads * v.head_mul), cur + 1
        out.append(dict(dim=dim, dim_out=dim_out, heads=heads, window=window, pool=i - 1 in ends[:-1][: v.q_pool]))
        dim = dim_out
    return out


def spec(v: SAM2Sizes) -> Dict[str, Tuple[tuple, str, float]]:
    """name -> (shape, kind, scale): kind "normal" draws N(0, scale^2),
    "const" fills `scale`."""
    s: Dict[str, Tuple[tuple, str, float]] = {}

    def lin(name, din, dout):
        s[name + ".w"] = ((din, dout), "normal", din**-0.5)
        s[name + ".b"] = ((dout,), "const", 0.0)

    def norm(name, n):
        s[name + "_g"] = ((n,), "const", 1.0)
        s[name + "_b"] = ((n,), "const", 0.0)

    c, k = v.embed_dim, v.patch_kernel
    s["encoder.patch_w"] = ((k, k, 3, c), "normal", (k * k * 3) ** -0.5)
    s["encoder.patch_b"] = ((c,), "const", 0.0)
    s["encoder.pos_bkg"] = ((*v.pos_bkg, c), "normal", 0.02)
    s["encoder.pos_window"] = ((v.window_spec[0], v.window_spec[0], c), "normal", 0.02)
    bl = blocks(v)
    for i, b in enumerate(bl):
        p = f"encoder.blocks.{i}."
        norm(p + "norm1", b["dim"])
        lin(p + "qkv", b["dim"], 3 * b["dim_out"])
        lin(p + "proj", b["dim_out"], b["dim_out"])
        norm(p + "norm2", b["dim_out"])
        hidden = int(b["dim_out"] * v.mlp_ratio)
        lin(p + "lin1", b["dim_out"], hidden)
        lin(p + "lin2", hidden, b["dim_out"])
        if b["dim"] != b["dim_out"]:
            lin(p + "skip", b["dim"], b["dim_out"])
    ends = [sum(v.stages[: i + 1]) - 1 for i in range(len(v.stages))]
    for j, e in enumerate(ends):
        lin(f"encoder.neck.{j}", bl[e]["dim_out"], v.d_model)
    d = v.decoder_dim
    s["prompt.gauss"] = ((2, d // 2), "normal", 1.0)
    for name in ("point_pos", "point_neg", "not_a_point", "no_mask"):
        s["prompt." + name] = ((d,), "normal", 0.02)
    s["decoder.obj_score_token"] = ((d,), "normal", 0.02)
    s["decoder.iou_token"] = ((d,), "normal", 0.02)
    s["decoder.mask_tokens"] = ((v.num_mask_tokens, d), "normal", 0.02)

    def attn(name, dint):
        for x in ("q", "k", "v"):
            lin(f"{name}.{x}", d, dint)
        lin(name + ".o", dint, d)

    for i in range(v.decoder_depth):
        p = f"decoder.layers.{i}."
        attn(p + "self_attn", d)
        norm(p + "norm1", d)
        attn(p + "cross_t2i", d // 2)
        norm(p + "norm2", d)
        lin(p + "mlp1", d, v.decoder_mlp)
        lin(p + "mlp2", v.decoder_mlp, d)
        norm(p + "norm3", d)
        attn(p + "cross_i2t", d // 2)
        norm(p + "norm4", d)
    attn("decoder.final_t2i", d // 2)
    norm("decoder.norm_final", d)
    s["decoder.up1_w"] = ((2, 2, d, d // 4), "normal", d**-0.5)
    s["decoder.up1_b"] = ((d // 4,), "const", 0.0)
    norm("decoder.up_ln", d // 4)
    s["decoder.up2_w"] = ((2, 2, d // 4, d // 8), "normal", (d // 4) ** -0.5)
    s["decoder.up2_b"] = ((d // 8,), "const", 0.0)
    lin("decoder.conv_s0", d, d // 8)
    lin("decoder.conv_s1", d, d // 4)
    for i in range(v.num_mask_tokens):
        lin(f"decoder.hyper.{i}.l1", d, d)
        lin(f"decoder.hyper.{i}.l2", d, d)
        lin(f"decoder.hyper.{i}.l3", d, d // 8)
    lin("decoder.iou_head.l1", d, d)  # the IoU head's hidden width: 256, the decoder's
    lin("decoder.iou_head.l2", d, d)
    lin("decoder.iou_head.l3", d, v.num_mask_tokens)
    lin("decoder.obj_head.l1", d, d)
    lin("decoder.obj_head.l2", d, d)
    lin("decoder.obj_head.l3", d, 1)
    s["no_mem_embed"] = ((d,), "normal", 0.02)
    return s


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[name + "_g"], p[name + "_b"], LN_EPS)


def _lin(x, p, name):
    return mm(x, p[name + ".w"]) + p[name + ".b"]


def preprocess(images01, img_size: int):
    """(B, H, W, 3) in [0, 1] -> (B, S, S, 3): a square linear resize, then
    ImageNet's mean and std."""
    x = resize(images01.float(), (images01.shape[0], img_size, img_size, 3), "linear")
    mean = torch.tensor(IMAGE_MEAN, device=x.device)
    std = torch.tensor(IMAGE_STD, device=x.device)
    return (x - mean) / std


def _maxpool(x):
    """MaxPool2d(2, 2) over channel-last (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _partition(x, win: int):
    b, h, w, c = x.shape
    ph, pw = (-h) % win, (-w) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c)
    return x, (hp, wp)


def _unpartition(x, win: int, padded, hw):
    hp, wp = padded
    b = x.shape[0] // ((hp // win) * (wp // win))
    x = x.reshape(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, : hw[0], : hw[1]]


def _attention(x, p, blk: str, heads: int, pool: bool):
    """Multi-scale attention over (B, h, w, dim): dense softmax at scale
    hd^-1/2, q max-pooled 2x2 where the block pools."""
    b, h, w, _ = x.shape
    qkv = _lin(x, p, blk + "qkv")
    c = qkv.shape[-1] // 3
    hd = c // heads
    q, k, val = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    if pool:
        q = _maxpool(q)
    hq, wq = q.shape[1:3]
    q = q.reshape(b, hq * wq, heads, hd).transpose(1, 2)
    k = k.reshape(b, h * w, heads, hd).transpose(1, 2)
    val = val.reshape(b, h * w, heads, hd).transpose(1, 2)
    a = torch.softmax(mm(q, k.transpose(-1, -2)) * hd**-0.5, dim=-1)
    o = mm(a, val).transpose(1, 2).reshape(b, hq, wq, c)
    return _lin(o, p, blk + "proj")


def _block(x, p, i: int, b: dict):
    blk = f"encoder.blocks.{i}."
    xn = _ln(x, p, blk + "norm1")
    shortcut = x
    if b["dim"] != b["dim_out"]:
        shortcut = _lin(xn, p, blk + "skip")
        if b["pool"]:
            shortcut = _maxpool(shortcut)
    win = b["window"]
    if win:
        xw, padded = _partition(xn, win)
        y = _attention(xw, p, blk, b["heads"], b["pool"])
        out_win = win // 2 if b["pool"] else win
        hh, ww = shortcut.shape[1:3]
        y = _unpartition(y, out_win, (hh + (-hh) % out_win, ww + (-ww) % out_win), (hh, ww))
    else:
        y = _attention(xn, p, blk, b["heads"], b["pool"])
    x = shortcut + y
    h = F.gelu(_lin(_ln(x, p, blk + "norm2"), p, blk + "lin1"))
    return x + _lin(h, p, blk + "lin2")


def trunk(p, v: SAM2Sizes, images) -> List[torch.Tensor]:
    """(B, S, S, 3) normalized -> the stage outputs (B, h, w, C), finest first."""
    b, s = images.shape[:2]
    k = v.patch_kernel
    cols = F.unfold(images.permute(0, 3, 1, 2), k, padding=v.patch_padding, stride=v.patch_stride)
    g = (s + 2 * v.patch_padding - k) // v.patch_stride + 1
    w = p["encoder.patch_w"].permute(2, 0, 1, 3).reshape(3 * k * k, -1)  # unfold's (C, kh, kw) order
    x = (mm(cols.transpose(1, 2), w) + p["encoder.patch_b"]).reshape(b, g, g, -1)
    pos = F.interpolate(p["encoder.pos_bkg"].permute(2, 0, 1)[None], size=(g, g), mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0)
    win = p["encoder.pos_window"]
    x = x + pos + win.repeat(g // win.shape[0], g // win.shape[1], 1)
    ends = [sum(v.stages[: i + 1]) - 1 for i in range(len(v.stages))]
    outs = []
    for i, blk in enumerate(blocks(v)):
        x = _block(x, p, i, blk)
        if i in ends:
            outs.append(x)
    return outs


def neck(p, v: SAM2Sizes, levels) -> List[torch.Tensor]:
    """The FPN: lateral 1x1 projections, the coarser output nearest-upsampled
    and added on the top-down levels, the `scalp` coarsest dropped."""
    out = [None] * len(levels)
    prev = None
    for i in reversed(range(len(levels))):
        lat = _lin(levels[i], p, f"encoder.neck.{i}")
        if i in v.fpn_top_down_levels and prev is not None:
            up = F.interpolate(prev.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest").permute(0, 2, 3, 1)
            prev = lat + up
        else:
            prev = lat
        out[i] = prev
    return out[: len(out) - v.scalp]


def image_features(p, v: SAM2Sizes, images):
    """(B, S, S, 3) normalized -> (embedding (B, g, g, D) with no_mem_embed,
    feat_s0 (B, 4g, 4g, D/8), feat_s1 (B, 2g, 2g, D/4))."""
    feats = neck(p, v, trunk(p, v, images))
    return (feats[-1] + p["no_mem_embed"], _lin(feats[0], p, "decoder.conv_s0"),
            _lin(feats[1], p, "decoder.conv_s1"))


def decode(p, v: SAM2Sizes, emb, s0, s1, sparse):
    """SAM 2's decoder for P prompts (P, K, D) on one image's (g, g, D)
    embedding: (logits (P, nm, 4g, 4g), IoU (P, nm) after the sigmoid,
    object-score logits (P, 1))."""
    dev = emb.device
    g, d, nm = emb.shape[0], v.decoder_dim, v.num_mask_tokens
    n = sparse.shape[0]
    t = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    pe = ref_sam._fourier(torch.stack([gx, gy], dim=-1), p["prompt.gauss"]).reshape(1, g * g, d).expand(n, g * g, d)
    out_tokens = torch.cat([p["decoder.obj_score_token"][None], p["decoder.iou_token"][None],
                            p["decoder.mask_tokens"]], dim=0)
    tokens = torch.cat([out_tokens.expand(n, nm + 2, d), sparse], dim=1)
    src = (emb + p["prompt.no_mask"]).reshape(1, g * g, d).expand(n, g * g, d)
    q, h = tokens, v.decoder_heads
    for i in range(v.decoder_depth):
        lp = f"decoder.layers.{i}."
        qp = q if i == 0 else q + tokens
        q = ref_sam._ln(q + ref_sam._mha(qp, qp, q, p, lp + "self_attn", h), p, lp + "norm1")
        q = ref_sam._ln(q + ref_sam._mha(q + tokens, src + pe, src, p, lp + "cross_t2i", h), p, lp + "norm2")
        q = ref_sam._ln(q + _lin(torch.relu(_lin(q, p, lp + "mlp1")), p, lp + "mlp2"), p, lp + "norm3")
        src = ref_sam._ln(src + ref_sam._mha(src + pe, q + tokens, q, p, lp + "cross_i2t", h), p, lp + "norm4")
    q = ref_sam._ln(q + ref_sam._mha(q + tokens, src + pe, src, p, "decoder.final_t2i", h), p,
                    "decoder.norm_final")
    u = ref_sam._upscale(src.reshape(n, g, g, d), p["decoder.up1_w"], p["decoder.up1_b"]) + s1
    u = F.gelu(_ln(u, p, "decoder.up_ln"))
    u = F.gelu(ref_sam._upscale(u, p["decoder.up2_w"], p["decoder.up2_b"]) + s0)
    hyper = torch.stack([ref_sam._mlp3(q[:, 2 + i], p, f"decoder.hyper.{i}") for i in range(nm)], dim=1)
    logits = mm(hyper, u.reshape(n, -1, u.shape[-1]).transpose(1, 2)).reshape(n, nm, 4 * g, 4 * g)
    iou = torch.sigmoid(ref_sam._mlp3(q[:, 1], p, "decoder.iou_head"))
    return logits, iou, ref_sam._mlp3(q[:, 0], p, "decoder.obj_head")


def grid_tokens(p, v: SAM2Sizes, points_per_side: int, device):
    """The (P, 2, D) tokens of the points_per_side^2 grid of one-point
    prompts (label 1), each with a padding point (label -1)."""
    t = (torch.arange(points_per_side, dtype=torch.float32, device=device) + 0.5) / points_per_side
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    n = pts.shape[0]
    return torch.stack([ref_sam._fourier(pts, p["prompt.gauss"]) + p["prompt.point_pos"],
                        p["prompt.not_a_point"].expand(n, v.decoder_dim)], dim=1)


def decode_grid(p, v: SAM2Sizes, feats, points_per_side: int, batch: int = 64):
    """One image's (emb, s0, s1) against the prompt grid, `batch` prompts a
    pass (prompts are independent): (logits (P, nm, 4g, 4g), IoU (P, nm))."""
    emb, s0, s1 = feats
    sparse = grid_tokens(p, v, points_per_side, emb.device)
    outs = [decode(p, v, emb, s0, s1, c)[:2] for c in sparse.split(batch)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
