"""Plain float32 SAM (image encoder, point prompt encoder, two-way mask
decoder) over a flat parameter dict.

The architecture is SAM's (Kirillov et al., "Segment Anything", 2023):
a ViT image encoder with windowed and global attention and decomposed
relative-position biases, a conv neck, random-Fourier point prompts and a
two-way transformer decoder with four mask tokens.  The parameter names and
layouts are those of the program's SAM (``encoder.blocks.<i>.qkv.w`` is an
(in, out) matrix), so one seeded set of weights serves both.  Written from
the port's ``models/sam.py`` at commit
b62fedabdce77346f1a976bf9b6f57fc0f42ce1b, with every product in float32
and attention as a dense softmax: nothing here calls a kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .imageops import resize
from .precision import mm

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
LN_EPS = 1e-6


@dataclass(frozen=True)
class SAMSizes:
    img_size: int
    patch: int
    width: int
    depth: int
    heads: int
    global_idx: Tuple[int, ...]
    window: int
    out_chans: int
    decoder_dim: int
    decoder_heads: int
    decoder_depth: int
    decoder_mlp: int
    num_mask_tokens: int

    @staticmethod
    def of(d: dict) -> "SAMSizes":
        return SAMSizes(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def spec(v: SAMSizes) -> Dict[str, Tuple[tuple, str, float]]:
    """name -> (shape, kind, scale): kind "normal" draws N(0, scale^2),
    "const" fills `scale`.  The scales are the published init's (the
    port's ``init_sam``)."""
    s: Dict[str, Tuple[tuple, str, float]] = {}
    g = v.img_size // v.patch
    w, hd = v.width, v.width // v.heads

    def lin(name, din, dout):
        s[name + ".w"] = ((din, dout), "normal", din**-0.5)
        s[name + ".b"] = ((dout,), "const", 0.0)

    def norm(name, n):
        s[name + "_g"] = ((n,), "const", 1.0)
        s[name + "_b"] = ((n,), "const", 0.0)

    s["encoder.patch_w"] = ((v.patch * v.patch * 3, w), "normal", w**-0.5)
    s["encoder.patch_b"] = ((w,), "const", 0.0)
    s["encoder.pos"] = ((g, g, w), "normal", 0.02)
    for i in range(v.depth):
        n = g if i in v.global_idx else v.window
        p = f"encoder.blocks.{i}."
        norm(p + "norm1", w)
        lin(p + "qkv", w, 3 * w)
        lin(p + "proj", w, w)
        s[p + "rel_h"] = ((2 * n - 1, hd), "normal", 0.02)
        s[p + "rel_w"] = ((2 * n - 1, hd), "normal", 0.02)
        norm(p + "norm2", w)
        lin(p + "lin1", w, 4 * w)
        lin(p + "lin2", 4 * w, w)
    s["encoder.neck_conv1"] = ((1, 1, w, v.out_chans), "normal", w**-0.5)
    norm("encoder.neck_ln1", v.out_chans)
    s["encoder.neck_conv2"] = ((3, 3, v.out_chans, v.out_chans), "normal", (9 * v.out_chans) ** -0.5)
    norm("encoder.neck_ln2", v.out_chans)
    d = v.decoder_dim
    s["prompt.gauss"] = ((2, d // 2), "normal", 1.0)
    for name in ("point_pos", "point_neg", "not_a_point", "no_mask"):
        s["prompt." + name] = ((d,), "normal", 0.02)
    s["decoder.iou_token"] = ((d,), "normal", 0.02)
    s["decoder.mask_tokens"] = ((v.num_mask_tokens, d), "normal", 0.02)

    def attn(name, dint):
        lin(name + ".q", d, dint)
        lin(name + ".k", d, dint)
        lin(name + ".v", d, dint)
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
    for i in range(v.num_mask_tokens):
        lin(f"decoder.hyper.{i}.l1", d, d)
        lin(f"decoder.hyper.{i}.l2", d, d)
        lin(f"decoder.hyper.{i}.l3", d, d // 8)
    lin("decoder.iou_head.l1", d, d)
    lin("decoder.iou_head.l2", d, d)
    lin("decoder.iou_head.l3", d, v.num_mask_tokens)
    return s


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[name + "_g"], p[name + "_b"], LN_EPS)


def _lin(x, p, name):
    return mm(x, p[name + ".w"]) + p[name + ".b"]


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _rel(q_hw: int, table):
    c = torch.arange(q_hw, device=table.device)
    return table[c[:, None] - c[None, :] + (q_hw - 1)]


def _attention_2d(x, p, blk: str, heads: int):
    """Dense attention over (B, h, w, C) tiles with the decomposed rel-pos
    bias s[q, k] += q . rel_h[y(q) - y(k)] + q . rel_w[x(q) - x(k)]."""
    b, h, w, c = x.shape
    hd = c // heads
    n = h * w
    qkv = _lin(x, p, blk + "qkv").reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    qg = q.reshape(b, heads, h, w, hd)
    bias_h = torch.einsum("bhywd,ykd->bhywk", qg, _rel(h, p[blk + "rel_h"]))
    bias_w = torch.einsum("bhywd,wkd->bhywk", qg, _rel(w, p[blk + "rel_w"]))
    s = mm(q, k.transpose(-1, -2)) * hd**-0.5
    s = s.reshape(b, heads, h, w, h, w) + bias_h[..., :, None] + bias_w[..., None, :]
    a = mm(torch.softmax(s.reshape(b, heads, n, n), dim=-1), v)
    return _lin(a.transpose(1, 2).reshape(b, h, w, c), p, blk + "proj")


def _windows(x, win: int):
    b, h, w, c = x.shape
    ph, pw = (win - h % win) % win, (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def _unwindows(x, win: int, padded, orig):
    hp, wp = padded
    b = x.shape[0] // ((hp // win) * (wp // win))
    x = x.reshape(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, : orig[0], : orig[1]]


def preprocess(images01, img_size: int):
    """(B, H, W, 3) in [0, 1] -> (B, S, S, 3) normalized (a square linear
    resize, then SAM's pixel statistics)."""
    x = resize(images01.float(), (images01.shape[0], img_size, img_size, 3), "linear")
    mean = torch.tensor(PIXEL_MEAN, device=x.device) / 255.0
    std = torch.tensor(PIXEL_STD, device=x.device) / 255.0
    return (x - mean) / std


def encode_image(p, v: SAMSizes, images):
    """(B, S, S, 3) normalized -> (B, g, g, out_chans) image embeddings."""
    b, s = images.shape[:2]
    g = s // v.patch
    x = images.reshape(b, g, v.patch, g, v.patch, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g, g, -1)
    x = mm(x, p["encoder.patch_w"]) + p["encoder.patch_b"] + p["encoder.pos"]
    for i in range(v.depth):
        blk = f"encoder.blocks.{i}."
        xn = _ln(x, p, blk + "norm1")
        if i in v.global_idx:
            att = _attention_2d(xn, p, blk, v.heads)
        else:
            xw, padded = _windows(xn, v.window)
            att = _unwindows(_attention_2d(xw, p, blk, v.heads), v.window, padded, (g, g))
        x = x + att
        x = x + _lin(_gelu(_lin(_ln(x, p, blk + "norm2"), p, blk + "lin1")), p, blk + "lin2")
    c1 = p["encoder.neck_conv1"]
    x = _ln(mm(x, c1.reshape(c1.shape[2], -1)), p, "encoder.neck_ln1")
    x = F.conv2d(x.permute(0, 3, 1, 2), p["encoder.neck_conv2"].permute(3, 2, 0, 1), padding=1)
    return _ln(x.permute(0, 2, 3, 1), p, "encoder.neck_ln2")


def _fourier(coords01, gauss):
    proj = (2 * math.pi) * ((coords01 * 2.0 - 1.0) @ gauss)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def _mha(x_q, x_k, x_v, p, name: str, heads: int):
    dint = p[name + ".q.w"].shape[1]
    hd = dint // heads
    q = _lin(x_q, p, name + ".q").reshape(*x_q.shape[:2], heads, hd)
    k = _lin(x_k, p, name + ".k").reshape(*x_k.shape[:2], heads, hd)
    val = _lin(x_v, p, name + ".v").reshape(*x_v.shape[:2], heads, hd)
    a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, val).reshape(*x_q.shape[:2], dint)
    return _lin(o, p, name + ".o")


def _mlp3(x, p, name: str):
    x = torch.relu(_lin(x, p, name + ".l1"))
    x = torch.relu(_lin(x, p, name + ".l2"))
    return _lin(x, p, name + ".l3")


def _upscale(x, w, b):
    """Stride-2, kernel-2 transposed convolution: out[2i + di, 2j + dj] =
    x[i, j] @ w[1 - di, 1 - dj] + b."""
    n, gh, gw, cin = x.shape
    co = w.shape[-1]
    wm = w.flip(0, 1).permute(2, 0, 1, 3).reshape(cin, 4 * co)
    y = mm(x, wm).reshape(n, gh, gw, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * gh, 2 * gw, co) + b


def decode_grid(p, v: SAMSizes, emb, points_per_side: int):
    """One (g, g, D) embedding against the points_per_side^2 grid of
    one-point prompts (each with SAM's padding point): (logits (P, 4, 4g,
    4g), iou_pred (P, 4))."""
    dev = emb.device
    g, d = emb.shape[0], v.decoder_dim
    t = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    pe = _fourier(torch.stack([gx, gy], dim=-1), p["prompt.gauss"])
    t = (torch.arange(points_per_side, dtype=torch.float32, device=dev) + 0.5) / points_per_side
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    n = pts.shape[0]
    # the point (label 1) and the padding point (label -1, no positional part)
    sparse = torch.stack([_fourier(pts, p["prompt.gauss"]) + p["prompt.point_pos"],
                          p["prompt.not_a_point"].expand(n, d)], dim=1)
    nm = v.num_mask_tokens
    out_tokens = torch.cat([p["decoder.iou_token"][None], p["decoder.mask_tokens"]], dim=0)
    tokens = torch.cat([out_tokens.expand(n, nm + 1, d), sparse], dim=1)
    src = (emb + p["prompt.no_mask"]).reshape(1, g * g, d).expand(n, g * g, d)
    pos = pe.reshape(1, g * g, d).expand(n, g * g, d)
    q, h = tokens, v.decoder_heads
    for i in range(v.decoder_depth):
        lp = f"decoder.layers.{i}."
        qp = q if i == 0 else q + tokens
        q = _ln(q + _mha(qp, qp, q, p, lp + "self_attn", h), p, lp + "norm1")
        q = _ln(q + _mha(q + tokens, src + pos, src, p, lp + "cross_t2i", h), p, lp + "norm2")
        q = _ln(q + _lin(torch.relu(_lin(q, p, lp + "mlp1")), p, lp + "mlp2"), p, lp + "norm3")
        src = _ln(src + _mha(src + pos, q + tokens, q, p, lp + "cross_i2t", h), p, lp + "norm4")
    q = _ln(q + _mha(q + tokens, src + pos, src, p, "decoder.final_t2i", h), p, "decoder.norm_final")
    u = _gelu(_ln(_upscale(src.reshape(n, g, g, d), p["decoder.up1_w"], p["decoder.up1_b"]), p, "decoder.up_ln"))
    u = _gelu(_upscale(u, p["decoder.up2_w"], p["decoder.up2_b"]))
    hyper = torch.stack([_mlp3(q[:, 1 + i], p, f"decoder.hyper.{i}") for i in range(nm)], dim=1)
    return torch.einsum("pnc,phwc->pnhw", hyper, u), _mlp3(q[:, 0], p, "decoder.iou_head")
