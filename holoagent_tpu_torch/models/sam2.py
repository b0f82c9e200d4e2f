"""SAM 2.1 with a Hiera image encoder as the mapper's segmenter (Ravi et al.,
"SAM 2: Segment Anything in Images and Videos", 2024, arXiv:2408.00714;
Ryali et al., "Hiera", 2023, arXiv:2306.00989), the image path only:

- the Hiera trunk (facebookresearch/sam2 ``sam2/modeling/backbones/
  hieradet.py``): a 7x7 stride-4 patch embedding, a background position
  embedding interpolated bicubically to the token grid plus a window
  embedding tiled over it, and ``MultiScaleBlock``s in four stages of
  doubling width and heads (the head dim stays the same).  A block's window
  is taken before the stage counter advances, so the first block of a stage
  keeps the previous stage's window; that block changes the width, pools
  its queries 2x2 inside each window (the keys and values are not pooled)
  and its shortcut is a projection of the normed input, pooled the same
  way.  Some blocks attend globally.  Every attention runs through kernel
  K2 (``ops/flash_attention.py::flash_attention``; on the card the general
  route, G1 in bf16 at head dim 72 padded to 80, with its pooled-query
  entry where the queries are fewer than the keys);
- the FPN neck (``image_encoder.py::FpnNeck``): a 1x1 lateral convolution a
  level to ``d_model``, the coarser level's output nearest-upsampled and
  added on the top-down levels, the coarsest level then dropped
  (``scalp``).  Its sine position encodings feed only the video memory and
  are not computed;
- SAM 2's mask decoder (``sam/mask_decoder.py``): tokens [object score,
  IoU, mask tokens, prompts] through SAM's two-way transformer
  (``models/sam.py::two_way``), the hypernetwork MLPs, then the mask head
  (``ops/mask_head.py``, one CUDA kernel on the card): upscaling
  ``act1(ln1(dc1(src) + feat_s1))`` then ``act2(dc2(.) + feat_s0)`` with the
  high-resolution features projected by ``conv_s1`` and ``conv_s0``, and the
  product with the hypernetwork vectors; a sigmoid IoU head and the
  object-score head.  The decoder reads the
  neck's finest kept level plus ``no_mem_embed`` (``directly_add_no_mem_
  embed``);
- preprocessing as ``SAM2Transforms``: a square resize to ``img_size`` (not
  SAM's longest side plus padding) with the ImageNet mean and std on [0,
  1]; prompt coordinates are fractions of each axis.

Automatic mask generation runs through SAM's path (``models/sam.py::
generate_masks``): the prompt grid, multimask output, the stability, area
and IoU gates, NMS and the fixed budget.  The decoder takes the prompts in
batches of ``POINTS_PER_BATCH`` (``SAM2AutomaticMaskGenerator``'s 64); the
outputs are per prompt.  As SAM2ImagePredictor does, automatic mask
generation reads the logits and IoU and leaves the object score unused.

Parameters are (in, out) matrices as in ``models/sam.py``; convolution
kernels are HWIO.  The working dtype is the served one (bf16); the prompt
encoder is float32, as SAM's.  Layer norms and GELUs (erf) compute in
float32 and round to the working dtype; decoder logits and IoU come out
float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, generator, resolve
from ..ops.flash_attention import flash_attention, flash_attention_ref
from ..ops.mask_head import mask_head
from ..ops.resize import resize
from ..utils.timing import StageTimer, stage
from .sam import (MLP3, Attn, DecoderLayer, Lin, PromptEncoder, _ln, _mlp3, _param, _window_partition,
                  _window_unpartition, grid_prompts, image_pe, init_prompt_encoder, two_way)
from .transformer import gelu_erf

IMAGE_MEAN = (0.485, 0.456, 0.406)  # SAM2Transforms' ImageNet statistics, on [0, 1]
IMAGE_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6
POINTS_PER_BATCH = 64  # prompts a decoder pass: SAM2AutomaticMaskGenerator's points_per_batch


@dataclass(frozen=True)
class SAM2Variant:
    """A SAM 2 image model's sizes: the Hiera trunk (``hieradet.py``'s
    arguments), the neck and the decoder."""

    name: str
    img_size: int = 1024
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    q_pool: int = 3
    q_stride: int = 2
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    pos_bkg: Tuple[int, int] = (7, 7)
    mlp_ratio: float = 4.0
    d_model: int = 256
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    scalp: int = 1
    decoder_dim: int = 256
    decoder_heads: int = 8
    decoder_depth: int = 2
    decoder_mlp: int = 2048
    num_mask_tokens: int = 4  # the IoU head's hidden width is decoder_dim, as the published one


VARIANTS = {
    # sam2/configs/sam2.1/sam2.1_hiera_l.yaml
    "sam2.1_hiera_l": SAM2Variant("sam2.1_hiera_l"),
    "test-tiny-hiera": SAM2Variant(
        "test-tiny-hiera", img_size=128, embed_dim=16, num_heads=1, stages=(1, 2, 2, 1),
        window_spec=(4, 2, 4, 2), global_att_blocks=(4,), pos_bkg=(3, 3), d_model=32, decoder_dim=32,
        decoder_heads=2, decoder_mlp=64,
    ),
}


@dataclass(frozen=True)
class BlockPlan:
    """One trunk block: input and output width, heads, window (0: global),
    whether it pools its queries, and its stage (0-based)."""

    dim: int
    dim_out: int
    heads: int
    window: int
    pool: bool
    stage: int


def stage_ends(v: SAM2Variant) -> List[int]:
    return [sum(v.stages[: i + 1]) - 1 for i in range(len(v.stages))]


def block_plan(v: SAM2Variant) -> List[BlockPlan]:
    """The trunk's blocks as ``hieradet.Hiera.__init__`` builds them: the
    window is read before the stage counter moves, and the first block of
    each stage after the first widens the stream by ``dim_mul``, its heads
    by ``head_mul``, and pools (the first ``q_pool`` such blocks)."""
    ends = stage_ends(v)
    pool_blocks = [e + 1 for e in ends[:-1]][: v.q_pool]
    dim, heads, cur = v.embed_dim, v.num_heads, 0
    out = []
    for i in range(sum(v.stages)):
        window = 0 if i in v.global_att_blocks else v.window_spec[cur]
        dim_out = dim
        if i - 1 in ends:
            dim_out = int(dim * v.dim_mul)
            heads = int(heads * v.head_mul)
            cur += 1
        out.append(BlockPlan(dim, dim_out, heads, window, i in pool_blocks, cur))
        dim = dim_out
    return out


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class HieraBlock(nn.Module):
    """A ``MultiScaleBlock``: norm1, qkv (dim -> 3 dim_out), the attention's
    proj, norm2, the MLP (lin1, lin2); ``skip`` (dim -> dim_out) where the
    width changes."""

    def __init__(self, b: BlockPlan, mlp_ratio: float, kw):
        super().__init__()
        self.norm1_g = _param((b.dim,), kw)
        self.norm1_b = _param((b.dim,), kw)
        self.qkv = Lin(b.dim, 3 * b.dim_out, kw)
        self.proj = Lin(b.dim_out, b.dim_out, kw)
        self.norm2_g = _param((b.dim_out,), kw)
        self.norm2_b = _param((b.dim_out,), kw)
        hidden = int(b.dim_out * mlp_ratio)
        self.lin1 = Lin(b.dim_out, hidden, kw)
        self.lin2 = Lin(hidden, b.dim_out, kw)
        self.skip = Lin(b.dim, b.dim_out, kw) if b.dim != b.dim_out else None


class HieraEncoder(nn.Module):
    """The trunk and the neck.  ``neck.<level>`` is the lateral 1x1
    convolution of trunk level <level> (0: the finest, stage 1)."""

    def __init__(self, v: SAM2Variant, kw):
        super().__init__()
        c, k = v.embed_dim, v.patch_kernel
        self.plan = block_plan(v)
        self.patch_stride, self.patch_padding = v.patch_stride, v.patch_padding
        self.patch_w = _param((k, k, 3, c), kw)
        self.patch_b = _param((c,), kw)
        self.pos_bkg = _param((*v.pos_bkg, c), kw)
        self.pos_window = _param((v.window_spec[0], v.window_spec[0], c), kw)
        self.blocks = nn.ModuleList(HieraBlock(b, v.mlp_ratio, kw) for b in self.plan)
        widths = [self.plan[e].dim_out for e in stage_ends(v)]
        self.neck = nn.ModuleList(Lin(w, v.d_model, kw) for w in widths)


class SAM2Decoder(nn.Module):
    """SAM 2's mask decoder: SAM's two-way transformer (``layers``,
    ``final_t2i``, ``norm_final``) with the object-score token, the
    high-resolution projections ``conv_s0`` and ``conv_s1`` (1x1), and the
    object-score head."""

    def __init__(self, v: SAM2Variant, kw):
        super().__init__()
        d, nm = v.decoder_dim, v.num_mask_tokens
        self.obj_score_token = _param((d,), kw)
        self.iou_token = _param((d,), kw)
        self.mask_tokens = _param((nm, d), kw)
        self.layers = nn.ModuleList(DecoderLayer(v, kw) for _ in range(v.decoder_depth))
        self.final_t2i = Attn(d, d, d // 2, kw)
        self.norm_final_g = _param((d,), kw)
        self.norm_final_b = _param((d,), kw)
        self.up1_w = _param((2, 2, d, d // 4), kw)
        self.up1_b = _param((d // 4,), kw)
        self.up_ln_g = _param((d // 4,), kw)
        self.up_ln_b = _param((d // 4,), kw)
        self.up2_w = _param((2, 2, d // 4, d // 8), kw)
        self.up2_b = _param((d // 8,), kw)
        self.conv_s0 = Lin(d, d // 8, kw)
        self.conv_s1 = Lin(d, d // 4, kw)
        self.hyper = nn.ModuleList(MLP3(d, d // 8, kw) for _ in range(nm))
        self.iou_head = MLP3(d, nm, kw)
        self.obj_head = MLP3(d, 1, kw)


class SAM2(nn.Module):
    """SAM 2's image model in the working dtype (the prompt encoder float32):
    ``encoder`` (trunk and neck), ``prompt``, ``decoder`` and
    ``no_mem_embed``.  The mapper reaches it where it reaches SAM (``models/
    sam.py::generate_masks``), through ``image_features`` and
    ``decode_grid``, as ``models/sam.py::SAM``'s."""

    def __init__(self, v: SAM2Variant, dtype=torch.bfloat16, device: DeviceLike = None):
        super().__init__()
        if v.q_stride != 2:
            raise ValueError(f"the trunk pools its queries 2x2 (q_stride 2), got {v.q_stride}")
        kw = dict(dtype=dtype, device=resolve(device))
        self.variant = v
        self.encoder = HieraEncoder(v, kw)
        self.prompt = PromptEncoder(v, kw)
        self.decoder = SAM2Decoder(v, kw)
        self.no_mem_embed = _param((v.decoder_dim,), kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.patch_w.dtype

    @torch.no_grad()
    def image_features(self, images01: torch.Tensor, impl: str = "xla", timer: Optional[StageTimer] = None):
        """(F, H, W, 3) frames in [0, 1] -> one (embedding (g, g, D), feat_s0
        (4g, 4g, D / 8), feat_s1 (2g, 2g, D / 4)) tuple a frame, in the
        working dtype: the trunk, the neck (span ``mask.encoder.neck``),
        ``no_mem_embed`` added to the finest kept level's coarsest (the
        decoder's embedding), and the decoder's high-resolution projections
        of the two finer levels (as ``SAM2Base.forward_image`` precomputes
        them)."""
        v = self.variant
        levels = trunk(self.encoder, preprocess(images01, v.img_size), impl=impl, timer=timer)
        with stage(timer, "mask.encoder.neck"):
            feats = neck(self.encoder, levels, v)
            emb = feats[-1] + self.no_mem_embed
            s0 = self.decoder.conv_s0(feats[0])
            s1 = self.decoder.conv_s1(feats[1])
        return [(emb[i], s0[i], s1[i]) for i in range(emb.shape[0])]

    def decode_grid(self, feats, points_per_side: int, timer: Optional[StageTimer] = None):
        """The points_per_side^2 grid of one-point prompts (each with its
        padding point) against one image's features, ``POINTS_PER_BATCH``
        prompts a pass, each pass writing its rows of the logits in place:
        (logits (P, nm, 4g, 4g), IoU (P, nm)), float32.  A `timer` records
        each pass's mask head in ``mask.decoder.head``.  The object score
        is left unused, as SAM2ImagePredictor leaves it."""
        emb, s0, s1 = feats
        pe = image_pe(self.prompt, emb.shape[0]).to(emb.dtype)
        sparse = grid_prompts(self.prompt, points_per_side, emb.device).to(emb.dtype)
        side = 4 * emb.shape[0]
        logits = torch.empty((sparse.shape[0], self.variant.num_mask_tokens, side, side), dtype=torch.float32,
                             device=emb.device)
        ious = [decode_masks(self, emb, s0, s1, pe, chunk, logits[start:start + chunk.shape[0]], timer)[1]
                for start, chunk in zip(range(0, sparse.shape[0], POINTS_PER_BATCH), sparse.split(POINTS_PER_BATCH))]
        return logits, torch.cat(ious)


# ---------------------------------------------------------------------------
# Image encoder
# ---------------------------------------------------------------------------


def preprocess(images01: torch.Tensor, img_size: int) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, S, S, 3) normalized: a square resize
    (bilinear, half-pixel centres: torchvision's Resize on these
    upscalings) and ImageNet's mean and std."""
    x = resize(images01, (images01.shape[0], img_size, img_size, 3), "linear")
    mean = torch.tensor(IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGE_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def pool2x2(x: torch.Tensor) -> torch.Tensor:
    """``nn.MaxPool2d(2, 2)`` over (B, H, W, C), channel-last: a trailing
    odd row or column is dropped."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _attention(x: torch.Tensor, blk: HieraBlock, heads: int, pool: bool, impl: str) -> torch.Tensor:
    """``MultiScaleAttention`` over (B, h, w, dim) tiles: q, k and v as
    (B, heads, N, hd) views of the qkv projection, q max-pooled 2x2 in
    pooling blocks (Tq = N / 4), attention at scale hd^-1/2 through K2
    (impl "flash"; "xla" its plain version), then proj."""
    b, h, w, _ = x.shape
    qkv = blk.qkv(x)
    c = qkv.shape[-1] // 3
    hd = c // heads
    q, k, v = qkv.reshape(b, h * w, 3, heads, hd).unbind(2)
    if pool:
        q = pool2x2(q.reshape(b, h, w, c))
        h, w = q.shape[1:3]
        q = q.reshape(b, h * w, heads, hd)
    attend = {"flash": flash_attention, "xla": flash_attention_ref}.get(impl)
    if attend is None:
        raise ValueError(f"impl must be 'flash' or 'xla', got {impl!r}")
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))  # (B, heads, Tq, hd)
    return blk.proj(out.transpose(1, 2).reshape(b, h, w, c))


def hiera_block(x: torch.Tensor, blk: HieraBlock, b: BlockPlan, impl: str = "xla") -> torch.Tensor:
    """One ``MultiScaleBlock.forward`` over (B, H, W, dim) -> (B, H', W', dim_out)."""
    shortcut = x
    x = _ln(x, blk.norm1_g, blk.norm1_b, LN_EPS)
    if blk.skip is not None:
        shortcut = blk.skip(x)
        if b.pool:
            shortcut = pool2x2(shortcut)
    h, w = x.shape[1:3]
    win = b.window
    if win > 0:
        x, padded = _window_partition(x, win)
    x = _attention(x, blk, b.heads, b.pool, impl)
    if b.pool and win > 0:  # the windows shrank with the queries
        win //= 2
        h, w = shortcut.shape[1:3]
        padded = (h + (win - h % win) % win, w + (win - w % win) % win)
    if win > 0:
        x = _window_unpartition(x, win, padded, (h, w))
    x = shortcut + x
    xn = _ln(x, blk.norm2_g, blk.norm2_b, LN_EPS)
    return x + blk.lin2(gelu_erf(blk.lin1(xn)))


def position_embedding(enc: HieraEncoder, hw: Tuple[int, int]) -> torch.Tensor:
    """(h, w, C): the background embedding bicubically interpolated to the
    grid (``F.interpolate``, align_corners False) plus the window
    embedding tiled over it, in float32."""
    bkg = enc.pos_bkg.float().permute(2, 0, 1)[None]
    pos = F.interpolate(bkg, size=hw, mode="bicubic")[0].permute(1, 2, 0)
    win = enc.pos_window.float()
    reps = (hw[0] // win.shape[0], hw[1] // win.shape[1], 1)
    return pos + win.repeat(*reps)


def _stages(enc: HieraEncoder):
    """(stage, its block indices) in order."""
    out: List[Tuple[int, List[int]]] = []
    for i, b in enumerate(enc.plan):
        if not out or out[-1][0] != b.stage:
            out.append((b.stage, []))
        out[-1][1].append(i)
    return out


def trunk(enc: HieraEncoder, images: torch.Tensor, impl: str = "xla",
          timer: Optional[StageTimer] = None) -> List[torch.Tensor]:
    """(B, S, S, 3) normalized -> the four stage outputs, (B, h_i, w_i,
    C_i), finest first.  Each stage runs in the span ``mask.encoder.stage<i>``
    (the patch embedding and position in stage 1's)."""
    dtype = enc.patch_w.dtype
    outs: List[torch.Tensor] = []
    x = images
    for s, blocks in _stages(enc):
        with stage(timer, f"mask.encoder.stage{s + 1}"):
            if s == 0:
                w = enc.patch_w.permute(3, 2, 0, 1)  # HWIO -> OIHW
                x = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w, enc.patch_b, stride=enc.patch_stride,
                             padding=enc.patch_padding).permute(0, 2, 3, 1)
                x = (x.float() + position_embedding(enc, tuple(x.shape[1:3]))).to(dtype)
            for i in blocks:
                x = hiera_block(x, enc.blocks[i], enc.plan[i], impl)
            outs.append(x)
    return outs


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of (B, h, w, C)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def neck(enc: HieraEncoder, levels: List[torch.Tensor], v: SAM2Variant) -> List[torch.Tensor]:
    """``FpnNeck`` over the trunk's levels (finest first), coarsest first:
    each level's lateral 1x1 convolution, plus the coarser output
    nearest-upsampled where the level is a top-down one (the sum in
    float32, as the source adds its float32 interpolation), rounded to the
    working dtype; then the ``scalp`` coarsest levels are dropped."""
    dtype = levels[0].dtype
    out: List[Optional[torch.Tensor]] = [None] * len(levels)
    prev = None
    for i in range(len(levels) - 1, -1, -1):
        lateral = enc.neck[i](levels[i])
        if i in v.fpn_top_down_levels and prev is not None:
            prev = (lateral.float() + _upsample2(prev).float()).to(dtype)
        else:
            prev = lateral
        out[i] = prev
    return out[: len(out) - v.scalp] if v.scalp else out


# ---------------------------------------------------------------------------
# Mask decoder
# ---------------------------------------------------------------------------


def decode_masks(sam: SAM2, emb: torch.Tensor, feat_s0: torch.Tensor, feat_s1: torch.Tensor,
                 img_pe: torch.Tensor, prompt_tokens: torch.Tensor, out: Optional[torch.Tensor] = None,
                 timer: Optional[StageTimer] = None):
    """``MaskDecoder.predict_masks`` for P prompts (P, K, D) on one image:
    (mask logits (P, nm, 4g, 4g) f32, into `out` when given, IoU (P, nm)
    f32 after the sigmoid, object-score logits (P, 1) f32).  The mask head
    (``ops/mask_head.py``) runs in the span ``mask.decoder.head``."""
    v, dec = sam.variant, sam.decoder
    g, d = emb.shape[0], v.decoder_dim
    p, dtype, nm = prompt_tokens.shape[0], emb.dtype, v.num_mask_tokens
    out_tokens = torch.cat([dec.obj_score_token[None], dec.iou_token[None], dec.mask_tokens], dim=0).to(dtype)
    tokens = torch.cat([out_tokens.expand(p, nm + 2, d), prompt_tokens.to(dtype)], dim=1)
    src = (emb + sam.prompt.no_mask.to(dtype)).reshape(1, g * g, d).expand(p, g * g, d)
    pos = img_pe.reshape(1, g * g, d).expand(p, g * g, d).to(dtype)
    q, src = two_way(dec, tokens, src, pos, v.decoder_heads)
    hyper = torch.stack([_mlp3(hp, q[:, 2 + i]) for i, hp in enumerate(dec.hyper)], dim=1)
    with stage(timer, "mask.decoder.head"):
        logits = mask_head(src.reshape(p, g, g, d), feat_s0, feat_s1, dec.up1_w, dec.up1_b, dec.up_ln_g, dec.up_ln_b,
                           dec.up2_w, dec.up2_b, hyper, LN_EPS, out)
    iou = torch.sigmoid(_mlp3(dec.iou_head, q[:, 1]).float())
    return logits, iou, _mlp3(dec.obj_head, q[:, 0]).float()


# ---------------------------------------------------------------------------
# Seeded init
# ---------------------------------------------------------------------------


def init_std(name: str, shape: Tuple[int, ...]) -> Optional[float]:
    """A parameter's init: None for a constant (norm gains 1, biases 0),
    else the normal's std: (in)^-1/2 for a matrix or 1x1 convolution, the
    fan-in's for the patch and transposed convolutions, 0.02 for the
    position embeddings, tokens, ``no_mem_embed`` and the prompt points, 1
    for the prompt encoder's Fourier matrix."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("_g") or leaf.endswith("_b") or leaf == "b":
        return None
    if leaf == "gauss":
        return 1.0
    if leaf == "w":  # (in, out)
        return shape[0] ** -0.5
    if leaf == "patch_w":  # (k, k, 3, C)
        return (shape[0] * shape[1] * shape[2]) ** -0.5
    if leaf in ("up1_w", "up2_w"):  # (2, 2, in, out), SAM's scale
        return shape[2] ** -0.5
    return 0.02


def _init(m: nn.Module, gen: torch.Generator) -> None:
    with torch.no_grad():
        for name, p in m.named_parameters():
            std = init_std(name, tuple(p.shape))
            if std is None:
                p.fill_(1.0 if name.endswith("_g") else 0.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float32) * std)


def init_sam2(v: SAM2Variant, seed: int = 0, dtype=torch.bfloat16, device: DeviceLike = None) -> SAM2:
    """Random SAM 2 from a seeded generator: the encoder, the prompt
    encoder (``models/sam.py``'s init), the decoder, ``no_mem_embed``."""
    gen = generator(seed)
    m = SAM2(v, dtype=dtype, device=device)
    _init(m.encoder, gen)
    init_prompt_encoder(m.prompt, gen)
    _init(m.decoder, gen)
    with torch.no_grad():
        m.no_mem_embed.copy_(torch.randn(m.no_mem_embed.shape, generator=gen) * 0.02)
    return m
