"""SAM-style promptable segmentation (counterpart of
holoagent_tpu/models/sam.py): ViT image encoder with windowed attention,
decomposed relative-position bias and a conv neck; random-Fourier point
prompt encoder; two-way transformer mask decoder; fixed-budget automatic
mask generation.

Module and parameter names follow the reference's parameter tree, so a
state-dict key such as ``encoder.blocks.2.qkv.w`` names the reference's
``params["encoder"]["blocks"][2]["qkv"]["w"]``.  Matmul weights are
(in, out).  Parameters live in the working dtype, except the ones the
reference computes with in float32: the neck's 3x3 convolution and the
prompt encoder.

``quantize_sam`` gives the int8 (W8A8) encoder: each block's qkv, proj,
lin1 and lin2 become ``QLin`` (int8 weights, float32 scales) and run through
kernel K3.  ``convert_sam`` / ``load_checkpoint`` map an official
``sam_vit_*.pth`` state dict onto the port's SAM, with the reference's key
map.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, generator, resolve
from ..ops import masks as mask_ops
from ..ops.flash_attention import flash_attention_2d, flash_attention_2d_ref
from ..ops.resize import resize
from ..utils.timing import StageTimer, stage
from .transformer import frozen, gelu, layer_norm, linear, matmul_int8, quantize_weight_int8


@dataclass(frozen=True)
class SAMVariant:
    name: str
    img_size: int = 1024
    patch: int = 16
    width: int = 768
    depth: int = 12
    heads: int = 12
    global_idx: Tuple[int, ...] = (2, 5, 8, 11)
    window: int = 14
    out_chans: int = 256
    decoder_dim: int = 256
    decoder_heads: int = 8
    decoder_depth: int = 2
    decoder_mlp: int = 2048
    num_mask_tokens: int = 4


VARIANTS = {
    "vit_b": SAMVariant("vit_b", width=768, depth=12, heads=12, global_idx=(2, 5, 8, 11)),
    "vit_l": SAMVariant("vit_l", width=1024, depth=24, heads=16, global_idx=(5, 11, 17, 23)),
    "vit_h": SAMVariant("vit_h", width=1280, depth=32, heads=16, global_idx=(7, 15, 23, 31)),
    "test-tiny": SAMVariant(
        "test-tiny", img_size=64, patch=16, width=64, depth=2, heads=2,
        global_idx=(1,), window=2, out_chans=32, decoder_dim=32,
        decoder_heads=2, decoder_mlp=64,
    ),
    "fixture-tiny": SAMVariant(
        "fixture-tiny", img_size=128, patch=8, width=64, depth=3, heads=2,
        global_idx=(2,), window=4, out_chans=32, decoder_dim=32,
        decoder_heads=2, decoder_mlp=128,
    ),
}

# SAM pixel normalization (ImageNet stats, applied to [0,255])
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def _ln(x, g, b, eps: float = 1e-6):
    return layer_norm(x, g, b, eps)


def _param(shape, kw) -> nn.Parameter:
    return frozen(torch.zeros(shape, **kw))


class Lin(nn.Module):
    """A linear layer as the reference stores it: w (din, dout), b (dout,)."""

    def __init__(self, din: int, dout: int, kw):
        super().__init__()
        self.w = _param((din, dout), kw)
        self.b = _param((dout,), kw)

    def forward(self, x):
        return linear(x, self.w, self.b)


class QLin(nn.Module):
    """An int8 linear layer as ``quantize_sam`` leaves it: b (dout,) in the
    working dtype, w_q8 int8 (dout, din) (the port's layout; the reference
    keeps (din, dout)), w_s (1, dout) float32."""

    def __init__(self, din: int, dout: int, kw):
        super().__init__()
        self.b = _param((dout,), kw)
        self.w_q8 = frozen(torch.zeros((dout, din), dtype=torch.int8, device=kw["device"]))
        self.w_s = _param((1, dout), dict(kw, dtype=torch.float32))

    def forward(self, x, out_dtype: Optional[torch.dtype] = None):
        """(matmul_int8(x) + b) in float32, rounded once to `out_dtype`
        (default x's dtype): kernel K3 with the bias fused."""
        return matmul_int8(x, self.w_q8, self.w_s, self.b, out_dtype=out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# Image encoder
# ---------------------------------------------------------------------------


class EncoderBlock(nn.Module):
    def __init__(self, v: SAMVariant, n: int, kw, quant: bool = False):
        super().__init__()
        hd = v.width // v.heads
        lin = QLin if quant else Lin
        self.norm1_g = _param((v.width,), kw)
        self.norm1_b = _param((v.width,), kw)
        self.qkv = lin(v.width, 3 * v.width, kw)
        self.proj = lin(v.width, v.width, kw)
        self.rel_h = _param((2 * n - 1, hd), kw)
        self.rel_w = _param((2 * n - 1, hd), kw)
        self.norm2_g = _param((v.width,), kw)
        self.norm2_b = _param((v.width,), kw)
        self.lin1 = lin(v.width, 4 * v.width, kw)
        self.lin2 = lin(4 * v.width, v.width, kw)


class ImageEncoder(nn.Module):
    def __init__(self, v: SAMVariant, kw, quant: bool = False):
        super().__init__()
        g = v.img_size // v.patch
        self.patch_w = _param((v.patch * v.patch * 3, v.width), kw)
        self.patch_b = _param((v.width,), kw)
        self.pos = _param((g, g, v.width), kw)
        self.blocks = nn.ModuleList(
            EncoderBlock(v, g if i in v.global_idx else v.window, kw, quant) for i in range(v.depth)
        )
        self.neck_conv1 = _param((1, 1, v.width, v.out_chans), kw)
        self.neck_ln1_g = _param((v.out_chans,), kw)
        self.neck_ln1_b = _param((v.out_chans,), kw)
        f32 = dict(kw, dtype=torch.float32)
        self.neck_conv2 = _param((3, 3, v.out_chans, v.out_chans), f32)
        self.neck_ln2_g = _param((v.out_chans,), kw)
        self.neck_ln2_b = _param((v.out_chans,), kw)


def _rel_pos_bias(q_hw: int, rel_table: torch.Tensor) -> torch.Tensor:
    """(2n-1, hd) table -> (q, q, hd) relative embeddings for square attn."""
    coords = torch.arange(q_hw, device=rel_table.device)
    return rel_table[coords[:, None] - coords[None, :] + (q_hw - 1)]


def _attention_2d(x: torch.Tensor, blk: EncoderBlock, heads: int, impl: str = "xla") -> torch.Tensor:
    """Attention over a (B, H, W, C) tile with decomposed rel-pos.
    impl="flash": kernel K1; "xla": its plain version (the same math).
    q, k and v go to K1 as (B, heads, N, hd) views of the qkv projection,
    and on the card K1's output is the (B, heads, N, hd) view of a (B, N,
    heads, hd) buffer: no copy of either around the kernel."""
    b, h, w, c = x.shape
    hd = c // heads
    n = h * w
    qkv = blk.qkv(x).reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, val = qkv[0], qkv[1], qkv[2]  # (B, heads, N, hd)
    # bias[n, m] = q_n . rel_h[y(n) - y(m)] + q_n . rel_w[x(n) - x(m)], in f32
    rh = _rel_pos_bias(h, blk.rel_h).float()
    rw = _rel_pos_bias(w, blk.rel_w).float()
    qg = q.reshape(b, heads, h, w, hd).float()
    bias_h = torch.einsum("bhywd,ykd->bhywk", qg, rh).reshape(b * heads, n, h)
    bias_w = torch.einsum("bhywd,wkd->bhywk", qg, rw).reshape(b * heads, n, w)
    attend = {"flash": flash_attention_2d, "xla": flash_attention_2d_ref}.get(impl)
    if attend is None:
        raise ValueError(f"impl must be 'flash' or 'xla', got {impl!r}")
    out = attend(q, k, val, bias_h, bias_w, grid_hw=(h, w))  # (B, heads, N, hd)
    return blk.proj(out.transpose(1, 2).reshape(b, h, w, c))


def _window_partition(x: torch.Tensor, win: int):
    b, h, w, c = x.shape
    ph = (win - h % win) % win
    pw = (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win, win, c), (hp, wp)


def _window_unpartition(x: torch.Tensor, win: int, padded, orig):
    hp, wp = padded
    h, w = orig
    b = x.shape[0] // ((hp // win) * (wp // win))
    x = x.reshape(b, hp // win, wp // win, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


@torch.no_grad()
def encode_image(enc: ImageEncoder, images: torch.Tensor, v: SAMVariant, impl: str = "xla") -> torch.Tensor:
    """(B, S, S, 3) normalized image -> (B, g, g, out_chans) embedding, in
    the encoder's dtype.  impl="flash" runs every attention layer, windowed
    and global, through kernel K1.  An int8 encoder (``quantize_sam``) runs
    its block matmuls through K3: qkv, proj and lin2 round once to the
    working dtype, lin1 stays float32 into the GELU."""
    dtype = enc.patch_w.dtype
    b, s, _, _ = images.shape
    p = v.patch
    g = s // p
    x = images.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g, g, -1)
    x = linear(x.to(dtype), enc.patch_w, enc.patch_b) + enc.pos
    for i, blk in enumerate(enc.blocks):
        shortcut = x
        xn = _ln(x, blk.norm1_g, blk.norm1_b)
        if i in v.global_idx:
            att = _attention_2d(xn, blk, v.heads, impl=impl)
        else:
            xw, padded = _window_partition(xn, v.window)
            aw = _attention_2d(xw, blk, v.heads, impl=impl)
            att = _window_unpartition(aw, v.window, padded, (g, g))
        x = shortcut + att
        xn = _ln(x, blk.norm2_g, blk.norm2_b)
        if isinstance(blk.lin1, QLin):
            hmid = gelu(blk.lin1(xn, torch.float32)).to(dtype)
        else:
            hmid = gelu(blk.lin1(xn).float()).to(dtype)
        x = x + blk.lin2(hmid)
    # neck: 1x1 conv -> LN -> 3x3 conv (float32) -> LN, channel-last
    x = linear(x, enc.neck_conv1.reshape(enc.neck_conv1.shape[2], -1))
    x = _ln(x, enc.neck_ln1_g, enc.neck_ln1_b)
    w2 = enc.neck_conv2.permute(3, 2, 0, 1)  # HWIO -> OIHW
    x = F.conv2d(x.float().permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1).to(dtype)
    return _ln(x, enc.neck_ln2_g, enc.neck_ln2_b)


# ---------------------------------------------------------------------------
# Prompt encoder
# ---------------------------------------------------------------------------


class PromptEncoder(nn.Module):
    """Float32 throughout, as the reference computes it."""

    def __init__(self, v: SAMVariant, kw):
        super().__init__()
        d = v.decoder_dim
        f32 = dict(kw, dtype=torch.float32)
        self.gauss = _param((2, d // 2), f32)
        self.point_pos = _param((d,), f32)
        self.point_neg = _param((d,), f32)
        self.not_a_point = _param((d,), f32)
        self.no_mask = _param((d,), f32)


def _fourier_pe(coords01: torch.Tensor, gauss: torch.Tensor) -> torch.Tensor:
    """(..., 2) in [0,1] -> (..., D) random Fourier features."""
    c = coords01 * 2.0 - 1.0
    proj = (2 * math.pi) * (c @ gauss)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def image_pe(prompt: PromptEncoder, g: int) -> torch.Tensor:
    """Dense positional encoding of the (g, g) embedding grid -> (g, g, D)."""
    t = (torch.arange(g, dtype=torch.float32, device=prompt.gauss.device) + 0.5) / g
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    return _fourier_pe(torch.stack([gx, gy], dim=-1), prompt.gauss)


def encode_points(prompt: PromptEncoder, points01: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """points01 (P, K, 2) xy in [0,1], labels (P, K) in {-1, 0, 1} ->
    (P, K, D) sparse prompt tokens."""
    pe = _fourier_pe(points01, prompt.gauss)
    pe = torch.where((labels == -1)[..., None], torch.zeros_like(pe), pe)
    emb = torch.where(
        (labels == 1)[..., None],
        prompt.point_pos,
        torch.where((labels == 0)[..., None], prompt.point_neg, prompt.not_a_point),
    )
    return pe + emb


# ---------------------------------------------------------------------------
# Mask decoder (two-way transformer)
# ---------------------------------------------------------------------------


class Attn(nn.Module):
    def __init__(self, dq: int, dkv: int, dint: int, kw):
        super().__init__()
        self.q = Lin(dq, dint, kw)
        self.k = Lin(dkv, dint, kw)
        self.v = Lin(dkv, dint, kw)
        self.o = Lin(dint, dq, kw)


class MLP3(nn.Module):
    def __init__(self, d: int, dout: int, kw):
        super().__init__()
        self.l1 = Lin(d, d, kw)
        self.l2 = Lin(d, d, kw)
        self.l3 = Lin(d, dout, kw)


class DecoderLayer(nn.Module):
    def __init__(self, v: SAMVariant, kw):
        super().__init__()
        d = v.decoder_dim
        di = d // 2
        self.self_attn = Attn(d, d, d, kw)
        self.norm1_g = _param((d,), kw)
        self.norm1_b = _param((d,), kw)
        self.cross_t2i = Attn(d, d, di, kw)
        self.norm2_g = _param((d,), kw)
        self.norm2_b = _param((d,), kw)
        self.mlp1 = Lin(d, v.decoder_mlp, kw)
        self.mlp2 = Lin(v.decoder_mlp, d, kw)
        self.norm3_g = _param((d,), kw)
        self.norm3_b = _param((d,), kw)
        self.cross_i2t = Attn(d, d, di, kw)
        self.norm4_g = _param((d,), kw)
        self.norm4_b = _param((d,), kw)


class MaskDecoder(nn.Module):
    def __init__(self, v: SAMVariant, kw):
        super().__init__()
        d = v.decoder_dim
        up1, up2 = d // 4, d // 8
        nm = v.num_mask_tokens
        self.iou_token = _param((d,), kw)
        self.mask_tokens = _param((nm, d), kw)
        self.layers = nn.ModuleList(DecoderLayer(v, kw) for _ in range(v.decoder_depth))
        self.final_t2i = Attn(d, d, d // 2, kw)
        self.norm_final_g = _param((d,), kw)
        self.norm_final_b = _param((d,), kw)
        self.up1_w = _param((2, 2, d, up1), kw)
        self.up1_b = _param((up1,), kw)
        self.up_ln_g = _param((up1,), kw)
        self.up_ln_b = _param((up1,), kw)
        self.up2_w = _param((2, 2, up1, up2), kw)
        self.up2_b = _param((up2,), kw)
        self.hyper = nn.ModuleList(MLP3(d, up2, kw) for _ in range(nm))
        self.iou_head = MLP3(d, nm, kw)


def _attn(p: Attn, q, k, v, heads: int):
    """Multi-head attention over token sequences (B, N, D), float32 scores."""
    dint = p.q.w.shape[1]
    hd = dint // heads
    qh = p.q(q).reshape(*q.shape[:2], heads, hd)
    kh = p.k(k).reshape(*k.shape[:2], heads, hd)
    vh = p.v(v).reshape(*v.shape[:2], heads, hd)
    a = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * hd**-0.5
    pr = torch.softmax(a, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", pr.float(), vh.float()).to(q.dtype)
    return p.o(o.reshape(*q.shape[:2], dint))


def _mlp3(p: MLP3, x, act=torch.relu):
    for lin in (p.l1, p.l2):
        x = act(lin(x).float()).to(x.dtype)
    return p.l3(x)


def _upscale(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel-2 stride-2 transposed conv as one matmul: out[2i+di, 2j+dj] =
    x[i, j] @ w[1-di, 1-dj] (the transposed conv flips its kernel)."""
    n, gh, gw, cin = x.shape
    co = w.shape[-1]
    wm = w.flip(0, 1).permute(2, 0, 1, 3).reshape(cin, 4 * co)
    y = linear(x, wm).reshape(n, gh, gw, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * gh, 2 * gw, co) + b.to(x.dtype)


def decode_masks(
    dec: MaskDecoder,
    image_emb: torch.Tensor,  # (g, g, D) single image
    img_pe: torch.Tensor,  # (g, g, D)
    prompt_tokens: torch.Tensor,  # (P, K, D)
    no_mask_emb: torch.Tensor,  # (D,)
    v: SAMVariant,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched over P prompts sharing one image embedding.  Returns
    (mask_logits (P, nm, 4g, 4g) f32, iou_pred (P, nm) f32)."""
    g = image_emb.shape[0]
    d = v.decoder_dim
    pcount = prompt_tokens.shape[0]
    dtype = image_emb.dtype
    nm = v.num_mask_tokens
    out_tokens = torch.cat([dec.iou_token[None], dec.mask_tokens], dim=0).to(dtype)
    tokens = torch.cat([out_tokens.expand(pcount, nm + 1, d), prompt_tokens.to(dtype)], dim=1)
    src = (image_emb + no_mask_emb).reshape(1, g * g, d).expand(pcount, g * g, d).to(dtype)
    pos = img_pe.reshape(1, g * g, d).expand(pcount, g * g, d).to(dtype)
    q = tokens
    heads = v.decoder_heads
    for i, lp in enumerate(dec.layers):
        if i == 0:
            q = q + _attn(lp.self_attn, q, q, q, heads)
        else:
            qp = q + tokens
            q = q + _attn(lp.self_attn, qp, qp, q, heads)
        q = _ln(q, lp.norm1_g, lp.norm1_b)
        q = q + _attn(lp.cross_t2i, q + tokens, src + pos, src, heads)
        q = _ln(q, lp.norm2_g, lp.norm2_b)
        h = torch.relu(lp.mlp1(q).float()).to(dtype)
        q = q + lp.mlp2(h)
        q = _ln(q, lp.norm3_g, lp.norm3_b)
        src = src + _attn(lp.cross_i2t, src + pos, q + tokens, q, heads)
        src = _ln(src, lp.norm4_g, lp.norm4_b)
    q = q + _attn(dec.final_t2i, q + tokens, src + pos, src, heads)
    q = _ln(q, dec.norm_final_g, dec.norm_final_b)

    iou_out = q[:, 0]
    mask_toks = q[:, 1 : nm + 1]
    srcg = src.reshape(pcount, g, g, d)
    u = _upscale(srcg, dec.up1_w, dec.up1_b)
    u = gelu(_ln(u, dec.up_ln_g, dec.up_ln_b))
    u = gelu(_upscale(u, dec.up2_w, dec.up2_b))  # (P, 4g, 4g, up2)
    hyper = torch.stack([_mlp3(hp, mask_toks[:, i]) for i, hp in enumerate(dec.hyper)], dim=1)
    logits = torch.einsum("pnc,phwc->pnhw", hyper.float(), u.float())
    iou_pred = _mlp3(dec.iou_head, iou_out).float()
    return logits, iou_pred


# ---------------------------------------------------------------------------
# Full model + automatic mask generation
# ---------------------------------------------------------------------------


class SAM(nn.Module):
    """Image encoder + prompt encoder + mask decoder, in the working dtype
    (see the module docstring for the float32 exceptions).  With ``quant``
    the encoder blocks' linears are ``QLin`` (see ``quantize_sam``)."""

    def __init__(self, v: SAMVariant, dtype=torch.float32, device: DeviceLike = None, quant: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve(device))
        self.variant = v
        self.quant = quant
        self.encoder = ImageEncoder(v, kw, quant)
        self.prompt = PromptEncoder(v, kw)
        self.decoder = MaskDecoder(v, kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.patch_w.dtype


def _fill(p: torch.Tensor, gen: torch.Generator, std: Optional[float] = None, value: float = 0.0):
    with torch.no_grad():
        if std is None:
            p.fill_(value)
        else:
            p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float32) * std)


def _init_lin(lin: Lin, gen: torch.Generator) -> None:
    _fill(lin.w, gen, std=lin.w.shape[0] ** -0.5)
    _fill(lin.b, gen)


def init_sam(v: SAMVariant, seed: int = 0, dtype=torch.float32, device: DeviceLike = None) -> SAM:
    """Random SAM from a seeded torch.Generator, with the reference's
    ``init_sam`` shapes and scales (values differ from JAX's)."""
    gen = generator(seed)
    m = SAM(v, dtype=dtype, device=device)
    for name, p in m.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("_g"):
            _fill(p, gen, value=1.0)
        elif leaf.endswith("_b") or leaf in ("b", "patch_b"):
            _fill(p, gen)
    enc, dec, pr = m.encoder, m.decoder, m.prompt
    for blk in enc.blocks:
        for lin in (blk.qkv, blk.proj, blk.lin1, blk.lin2):
            _init_lin(lin, gen)
        _fill(blk.rel_h, gen, std=0.02)
        _fill(blk.rel_w, gen, std=0.02)
    _fill(enc.patch_w, gen, std=v.width**-0.5)
    _fill(enc.pos, gen, std=0.02)
    _fill(enc.neck_conv1, gen, std=v.width**-0.5)
    _fill(enc.neck_conv2, gen, std=(9 * v.out_chans) ** -0.5)
    _fill(pr.gauss, gen, std=1.0)
    for p in (pr.point_pos, pr.point_neg, pr.not_a_point, pr.no_mask, dec.iou_token, dec.mask_tokens):
        _fill(p, gen, std=0.02)
    for mod in dec.modules():
        if isinstance(mod, Lin):
            _init_lin(mod, gen)
    d = v.decoder_dim
    _fill(dec.up1_w, gen, std=d**-0.5)
    _fill(dec.up2_w, gen, std=(d // 4) ** -0.5)
    return m


ENCODER_Q8 = ("qkv", "proj", "lin1", "lin2")  # the linears quantize_sam quantizes


@torch.no_grad()
def quantize_sam(sam: SAM, dtype: Optional[torch.dtype] = None) -> SAM:
    """Per-output-channel W8A8 quantization of the image encoder's block
    linears (qkv, proj, lin1, lin2): a new SAM whose other parameters (patch
    embed, rel-pos tables, neck, prompt encoder, decoder) are copies, in
    `dtype` (default: `sam`'s).  As the reference, the weights are quantized
    from their float32 values (a converted checkpoint's: quantize a float32
    SAM with `dtype` the working dtype); biases stay in the working dtype."""
    out = SAM(sam.variant, dtype=dtype or sam.dtype, device=sam.encoder.patch_w.device, quant=True)
    src = dict(sam.named_parameters())
    for name, p in out.named_parameters():
        if name in src:
            p.copy_(src[name])
    for q, blk in zip(out.encoder.blocks, sam.encoder.blocks):
        for name in ENCODER_Q8:
            w_q, w_s = quantize_weight_int8(getattr(blk, name).w.float())
            getattr(q, name).w_q8.copy_(w_q.t())
            getattr(q, name).w_s.copy_(w_s)
    return out


def preprocess(images01: torch.Tensor, img_size: int) -> torch.Tensor:
    """(B, H, W, 3) in [0,1] -> (B, img_size, img_size, 3) normalized."""
    x = resize(images01, (images01.shape[0], img_size, img_size, 3), "linear")
    mean = torch.tensor(PIXEL_MEAN, dtype=x.dtype, device=x.device) / 255.0
    std = torch.tensor(PIXEL_STD, dtype=x.dtype, device=x.device) / 255.0
    return (x - mean) / std


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` order: descending, ties to the lower index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


@torch.no_grad()
def generate_masks(
    sam: SAM,
    image01: torch.Tensor,  # (H, W, 3) float in [0,1]
    points_per_side: int = 12,
    pred_iou_thresh: float = 0.88,
    stability_thresh: float = 0.95,
    min_area: float = 100.0,
    nms_iou: float = 0.7,
    max_masks: int = 64,
    mask_hw: Optional[Tuple[int, int]] = None,
    impl: str = "xla",
    timer: Optional[StageTimer] = None,
):
    """Automatic mask generation, fixed budget.  Returns a dict: masks
    (max_masks, H', W') bool, logits, scores, boxes (max_masks, 4), valid,
    num.  H'xW' = `mask_hw` or the input resolution.  A `timer` records the
    sub-stages mask.encoder, mask.decoder, mask.nms and mask.select."""
    with stage(timer, "mask.encoder"):
        x = preprocess(image01[None], sam.variant.img_size)
        emb = encode_image(sam.encoder, x, sam.variant, impl=impl)[0]  # (g, g, D)
    return _masks_from_embedding(sam, emb, image01.shape[:2], points_per_side, pred_iou_thresh, stability_thresh,
                                 min_area, nms_iou, max_masks, mask_hw, timer)


@torch.no_grad()
def generate_masks_batched(
    sam: SAM,
    images01: torch.Tensor,  # (F, H, W, 3) float in [0,1]
    points_per_side: int = 12,
    pred_iou_thresh: float = 0.88,
    stability_thresh: float = 0.95,
    min_area: float = 100.0,
    nms_iou: float = 0.7,
    max_masks: int = 64,
    mask_hw: Optional[Tuple[int, int]] = None,
    impl: str = "xla",
    timer: Optional[StageTimer] = None,
):
    """``generate_masks`` over F frames: the image encoder runs once over
    the F images (its matmuls and attention at F times the batch), then the
    decoder, NMS and selection run frame by frame.  Returns one dict a
    frame, each equal to ``generate_masks`` on that frame."""
    with stage(timer, "mask.encoder"):
        x = preprocess(images01, sam.variant.img_size)
        embs = encode_image(sam.encoder, x, sam.variant, impl=impl)  # (F, g, g, D)
    return [
        _masks_from_embedding(sam, emb, images01.shape[1:3], points_per_side, pred_iou_thresh, stability_thresh,
                              min_area, nms_iou, max_masks, mask_hw, timer)
        for emb in embs
    ]


def _masks_from_embedding(sam: SAM, emb: torch.Tensor, hw: Tuple[int, int], points_per_side: int,
                          pred_iou_thresh: float, stability_thresh: float, min_area: float, nms_iou: float,
                          max_masks: int, mask_hw: Optional[Tuple[int, int]], timer: Optional[StageTimer]):
    """``generate_masks`` after the encoder: one image's (g, g, D) embedding
    -> its fixed-budget masks (decoder, NMS, selection)."""
    dev = emb.device
    mask_hw = mask_hw or tuple(hw)
    with stage(timer, "mask.decoder"):
        logits, iou_pred = _decode_grid(sam, emb, points_per_side)
    with stage(timer, "mask.nms"):
        # multimask: drop token 0 (single-mask head), keep 1..3
        logits = logits[:, 1:].reshape(-1, logits.shape[-2], logits.shape[-1])
        scores = iou_pred[:, 1:].reshape(-1)
        lh, lw = logits.shape[-2], logits.shape[-1]
        area_scale = (mask_hw[0] * mask_hw[1]) / float(lh * lw)
        stab = mask_ops.stability_scores(logits)
        bin_lo = logits > 0.0
        areas = mask_ops.mask_areas(bin_lo) * area_scale
        ok = (scores > pred_iou_thresh) & (stab > stability_thresh) & (areas > min_area)
        boxes_lo = mask_ops.boxes_from_masks(bin_lo)
        keep = mask_ops.nms(boxes_lo, scores, ok, nms_iou)
    with stage(timer, "mask.select"):
        sel_scores = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
        top_s, top_i = top_k(sel_scores, max_masks)
        out_valid = torch.isfinite(top_s)
        logits_k = resize(logits[top_i], (max_masks, mask_hw[0], mask_hw[1]), "linear")
        binm = logits_k > 0.0
        sx = mask_hw[1] / float(lw)
        sy = mask_hw[0] / float(lh)
        boxes = boxes_lo[top_i] * torch.tensor([sx, sy, sx, sy], dtype=boxes_lo.dtype, device=dev)
    return {
        "masks": binm & out_valid[:, None, None],
        "logits": logits_k,
        "scores": torch.where(out_valid, top_s, torch.zeros_like(top_s)),
        "boxes": boxes,
        "valid": out_valid,
        "num": out_valid.sum().to(torch.int32),
    }


def _decode_grid(sam: SAM, emb: torch.Tensor, points_per_side: int):
    """Decode the points_per_side^2 grid of one-point prompts (plus a padding
    point each, the SAM convention) against one image embedding."""
    v = sam.variant
    dev = emb.device
    g = emb.shape[0]
    pe = image_pe(sam.prompt, g).to(emb.dtype)

    pps = points_per_side
    t = (torch.arange(pps, dtype=torch.float32, device=dev) + 0.5) / pps
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (P, 2) xy
    pcount = pps * pps
    points = torch.stack([pts, torch.zeros_like(pts)], dim=1)  # (P, 2, 2)
    labels = torch.stack(
        [torch.ones(pcount, dtype=torch.int32, device=dev), -torch.ones(pcount, dtype=torch.int32, device=dev)],
        dim=1,
    )
    sparse = encode_points(sam.prompt, points, labels).to(emb.dtype)
    return decode_masks(sam.decoder, emb, pe, sparse, sam.prompt.no_mask.to(emb.dtype), v)


# ---------------------------------------------------------------------------
# Checkpoint conversion (official SAM torch state dict)
# ---------------------------------------------------------------------------


def _sam_tree(state: Dict[str, torch.Tensor], v: SAMVariant) -> dict:
    """The reference's SAM parameter tree, numpy float32, from an official
    state dict (the reference's ``convert_sam`` key map: torch Linear
    weights (out, in) transposed, convolutions to HWIO)."""
    import numpy as np

    def g(name):
        t = state[name]
        if hasattr(t, "detach"):
            t = t.detach().float().cpu().numpy()
        return np.asarray(t, np.float32)

    def lin(prefix):
        return {"w": g(prefix + ".weight").T, "b": g(prefix + ".bias")}

    def attn4(prefix):
        return {"q": lin(prefix + ".q_proj"), "k": lin(prefix + ".k_proj"), "v": lin(prefix + ".v_proj"),
                "o": lin(prefix + ".out_proj")}

    blocks = []
    for i in range(v.depth):
        pre = f"image_encoder.blocks.{i}"
        blocks.append({
            "norm1_g": g(pre + ".norm1.weight"), "norm1_b": g(pre + ".norm1.bias"),
            "qkv": lin(pre + ".attn.qkv"), "proj": lin(pre + ".attn.proj"),
            "rel_h": g(pre + ".attn.rel_pos_h"), "rel_w": g(pre + ".attn.rel_pos_w"),
            "norm2_g": g(pre + ".norm2.weight"), "norm2_b": g(pre + ".norm2.bias"),
            "lin1": lin(pre + ".mlp.lin1"), "lin2": lin(pre + ".mlp.lin2"),
        })
    conv = g("image_encoder.patch_embed.proj.weight")  # (W, 3, p, p)
    layer = "mask_decoder.transformer.layers"
    return {
        "encoder": {
            "patch_w": conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0]),
            "patch_b": g("image_encoder.patch_embed.proj.bias"),
            "pos": g("image_encoder.pos_embed")[0],
            "blocks": blocks,
            "neck_conv1": g("image_encoder.neck.0.weight").transpose(2, 3, 1, 0),
            "neck_ln1_g": g("image_encoder.neck.1.weight"), "neck_ln1_b": g("image_encoder.neck.1.bias"),
            "neck_conv2": g("image_encoder.neck.2.weight").transpose(2, 3, 1, 0),
            "neck_ln2_g": g("image_encoder.neck.3.weight"), "neck_ln2_b": g("image_encoder.neck.3.bias"),
        },
        "prompt": {
            "gauss": g("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix").T,
            "point_neg": g("prompt_encoder.point_embeddings.0.weight")[0],
            "point_pos": g("prompt_encoder.point_embeddings.1.weight")[0],
            "not_a_point": g("prompt_encoder.not_a_point_embed.weight")[0],
            "no_mask": g("prompt_encoder.no_mask_embed.weight")[0],
        },
        "decoder": {
            "iou_token": g("mask_decoder.iou_token.weight")[0],
            "mask_tokens": g("mask_decoder.mask_tokens.weight"),
            "layers": [
                {
                    "self_attn": attn4(f"{layer}.{i}.self_attn"),
                    "norm1_g": g(f"{layer}.{i}.norm1.weight"), "norm1_b": g(f"{layer}.{i}.norm1.bias"),
                    "cross_t2i": attn4(f"{layer}.{i}.cross_attn_token_to_image"),
                    "norm2_g": g(f"{layer}.{i}.norm2.weight"), "norm2_b": g(f"{layer}.{i}.norm2.bias"),
                    "mlp1": lin(f"{layer}.{i}.mlp.lin1"), "mlp2": lin(f"{layer}.{i}.mlp.lin2"),
                    "norm3_g": g(f"{layer}.{i}.norm3.weight"), "norm3_b": g(f"{layer}.{i}.norm3.bias"),
                    "cross_i2t": attn4(f"{layer}.{i}.cross_attn_image_to_token"),
                    "norm4_g": g(f"{layer}.{i}.norm4.weight"), "norm4_b": g(f"{layer}.{i}.norm4.bias"),
                }
                for i in range(v.decoder_depth)
            ],
            "final_t2i": attn4("mask_decoder.transformer.final_attn_token_to_image"),
            "norm_final_g": g("mask_decoder.transformer.norm_final_attn.weight"),
            "norm_final_b": g("mask_decoder.transformer.norm_final_attn.bias"),
            "up1_w": g("mask_decoder.output_upscaling.0.weight").transpose(2, 3, 0, 1),
            "up1_b": g("mask_decoder.output_upscaling.0.bias"),
            "up_ln_g": g("mask_decoder.output_upscaling.1.weight"),
            "up_ln_b": g("mask_decoder.output_upscaling.1.bias"),
            "up2_w": g("mask_decoder.output_upscaling.3.weight").transpose(2, 3, 0, 1),
            "up2_b": g("mask_decoder.output_upscaling.3.bias"),
            "hyper": [
                {f"l{j + 1}": lin(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}") for j in range(3)}
                for i in range(v.num_mask_tokens)
            ],
            "iou_head": {f"l{j + 1}": lin(f"mask_decoder.iou_prediction_head.layers.{j}") for j in range(3)},
        },
    }


def convert_sam(state: Dict[str, torch.Tensor], v: SAMVariant, dtype=torch.float32,
                device: DeviceLike = None) -> SAM:
    """Map an official ``sam_vit_*.pth`` state dict (torch tensors or numpy
    arrays) onto a port SAM in `dtype` on `device` (the card unless the
    caller asks for the CPU), through ``bridge.load_flat``."""
    from ..bridge import flatten, load_flat

    model = SAM(v, dtype=dtype, device=device)
    return load_flat(model, flatten(_sam_tree(state, v)))


def load_checkpoint(path: str, v: SAMVariant, dtype=torch.float32, device: DeviceLike = None) -> SAM:
    """Load an official SAM torch checkpoint and convert it (``convert_sam``)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return convert_sam(state, v, dtype=dtype, device=device)
