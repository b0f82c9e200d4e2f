"""On-slice generative VLM for the slow reasoning path (counterpart of
holoagent_tpu/models/vlm.py).

A LLaVA-style decoder-only LM whose prompt embeds per-image token blocks
from the CLIP vision tower through a projector, in two architectures:
``gpt`` (learned positions, LayerNorm, GELU; its blocks are
``transformer.Block``) and ``llama`` (RoPE, RMSNorm, SwiGLU, grouped-query
K/V; ``LlamaBlock``).  Prefill fills a static KV cache and decode advances
every slot one token a step, so the serving layer
(``holoagent_tpu_torch.serving``) can continuously batch requests slot by
slot.

Weights keep the reference's names and (in, out) layout, so
``bridge.vlm_from_jax`` carries a JAX tree over leaf for leaf, and
``convert_hf_llava`` loads a HuggingFace LLaVA-family state dict.

Where the port departs from the reference's functional style, it says so:
the KV cache is updated **in place** (``prefill`` writes its rows' first T
positions, ``decode_step`` one position a row) and returned, where the
reference returns a new cache.  The gpt arch's prefill attends through
kernel K2's causal mode (``impl="flash"``, the default here; the
reference's default is its dense XLA path, the same function); its plain
version (``impl="xla"``) is asked for by name.  The llama arch computes its
dense grouped attention itself, as the reference does: K2 reads one head
stride and cannot read grouped K/V in place.

Numerics, as the reference: matmuls accumulate in float32; a linear with a
bias rounds once to the working dtype (``transformer.linear``); the llama
projections, RoPE (float32 cos/sin, one cast), the attention scores and the
logits stay float32; softmax in float32; probabilities in the working dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, generator, resolve, upload
from . import clip as clip_mod
from . import transformer as tfm


@dataclass(frozen=True)
class VLMVariant:
    name: str
    vocab: int = 49408  # shares the CLIP BPE space
    width: int = 512
    layers: int = 8
    heads: int = 8
    max_seq: int = 4096
    image_tokens: int = 16  # pooled vision tokens per image
    clip_variant: str = "ViT-B-32"
    arch: str = "gpt"  # "gpt" (learned pos, LN, gelu) | "llama" (RoPE, RMS, SwiGLU)
    kv_heads: int = 0  # grouped-query attention; 0 -> = heads
    mlp_hidden: int = 0  # 0 -> 4*width (gpt) / llama intermediate size
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    @property
    def n_kv(self) -> int:
        return self.kv_heads or self.heads

    @property
    def hidden(self) -> int:
        return self.mlp_hidden or 4 * self.width


VARIANTS = {
    "vlm-base": VLMVariant("vlm-base", width=1024, layers=16, heads=16),
    "vlm-small": VLMVariant("vlm-small", width=512, layers=8, heads=8),
    # TinyLlama-1.1B geometry: the smallest public LLaVA-family backbone
    # (convert_hf_llava loads its checkpoints directly)
    "llava-tinyllama": VLMVariant(
        "llava-tinyllama", vocab=32000, width=2048, layers=22, heads=32,
        kv_heads=4, mlp_hidden=5632, max_seq=2048, arch="llama",
        clip_variant="ViT-L-14",
    ),
    "test-tiny": VLMVariant(
        "test-tiny", width=64, layers=2, heads=2, max_seq=256, image_tokens=4,
        clip_variant="test-tiny",
    ),
    "test-tiny-llama": VLMVariant(
        "test-tiny-llama", vocab=256, width=64, layers=2, heads=4, kv_heads=2,
        mlp_hidden=128, max_seq=128, image_tokens=4, arch="llama",
        clip_variant="test-tiny",
    ),
}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class LlamaBlock(nn.Module):
    """One llama block, named and laid out as the reference's per-layer
    slice (matmul weights (in, out), no biases)."""

    def __init__(self, v: VLMVariant, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        dh = v.width // v.heads
        self.ln1_g = tfm.frozen(torch.ones(v.width, **kw))
        self.wq = tfm.frozen(torch.empty(v.width, v.heads * dh, **kw))
        self.wk = tfm.frozen(torch.empty(v.width, v.n_kv * dh, **kw))
        self.wv = tfm.frozen(torch.empty(v.width, v.n_kv * dh, **kw))
        self.wo = tfm.frozen(torch.empty(v.heads * dh, v.width, **kw))
        self.ln2_g = tfm.frozen(torch.ones(v.width, **kw))
        self.w_gate = tfm.frozen(torch.empty(v.width, v.hidden, **kw))
        self.w_up = tfm.frozen(torch.empty(v.width, v.hidden, **kw))
        self.w_down = tfm.frozen(torch.empty(v.hidden, v.width, **kw))


class VLM(nn.Module):
    """The LM's parameters under the reference's tree names: ``tok_emb``,
    ``pos``, ``blocks.<i>.*``, ``ln_f_g`` (+ ``ln_f_b`` for gpt,
    ``lm_head`` for llama), the projector ``proj_w`` (proj_in, width),
    ``proj_b`` and, for a two-layer projector, ``proj2_w``, ``proj2_b``.
    The parameters' dtype is the working dtype."""

    def __init__(self, v: VLMVariant, dtype=torch.float32, device: DeviceLike = None,
                 proj_in: Optional[int] = None, proj2: bool = False):
        super().__init__()
        dev = resolve(device)
        kw = dict(dtype=dtype, device=dev)
        self.variant = v
        proj_in = proj_in or clip_mod.VARIANTS[v.clip_variant].embed_dim
        self.tok_emb = tfm.frozen(torch.empty(v.vocab, v.width, **kw))
        self.pos = tfm.frozen(torch.zeros(v.max_seq, v.width, **kw))
        if v.arch == "llama":
            self.blocks = nn.ModuleList(LlamaBlock(v, dtype, dev) for _ in range(v.layers))
            self.ln_f_g = tfm.frozen(torch.ones(v.width, **kw))
            self.lm_head = tfm.frozen(torch.empty(v.vocab, v.width, **kw))
        else:
            self.blocks = nn.ModuleList(tfm.Block(v.width, v.hidden, dtype, dev) for _ in range(v.layers))
            self.ln_f_g = tfm.frozen(torch.ones(v.width, **kw))
            self.ln_f_b = tfm.frozen(torch.zeros(v.width, **kw))
        self.proj_w = tfm.frozen(torch.empty(proj_in, v.width, **kw))
        self.proj_b = tfm.frozen(torch.zeros(v.width, **kw))
        if proj2:
            self.proj2_w = tfm.frozen(torch.empty(v.width, v.width, **kw))
            self.proj2_b = tfm.frozen(torch.zeros(v.width, **kw))

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_emb.dtype


def init_vlm(v: VLMVariant, seed: int = 0, dtype=torch.float32, device: DeviceLike = None) -> VLM:
    """Random weights from a seeded generator, with the reference's
    ``init_vlm`` shapes and scales (values differ from JAX's), on the card
    unless ``device="cpu"``.  Each tensor is drawn in float32 on the CPU and
    moved on its own, so a 1.1 B-parameter model never sits whole on the
    host in float32."""
    model = VLM(v, dtype=dtype, device=device)
    gen = generator(seed)
    embed_dim = clip_mod.VARIANTS[v.clip_variant].embed_dim
    tfm._normal_(model.tok_emb, 0.02, gen)
    if v.arch == "llama":
        std = v.width**-0.5
        for blk in model.blocks:
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                tfm._normal_(getattr(blk, name), std, gen)
        tfm._normal_(model.lm_head, 0.02, gen)
        # no learned positions (RoPE): the image-block ramp stays zero
    else:
        tfm._normal_(model.pos, 0.01, gen)
        for blk in model.blocks:
            tfm.init_block_(blk, gen, v.layers)
    tfm._normal_(model.proj_w, embed_dim**-0.5, gen)
    return model


# ---------------------------------------------------------------------------
# Float32 products and the llama core (RoPE / RMSNorm, the HF convention)
# ---------------------------------------------------------------------------


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with a float32 result from x's dtype, as the
    reference's ``preferred_element_type=float32``."""
    x2 = x.reshape(-1, x.shape[-1])
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        out = torch.mm(x2, w)
    elif x.is_cuda:
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = torch.mm(x2.float(), w.float())
    return out.view(*x.shape[:-1], w.shape[-1])


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with a float32 result from a's dtype."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


def _rope_cos_sin(pos: torch.Tensor, dh: int, theta: float):
    """HF llama convention: inv_freq over even dims, emb = cat(freqs, freqs).
    pos: (...,) integer -> cos/sin (..., dh) float32."""
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=pos.device) / dh))
    freqs = pos[..., None].float() * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., dh); rotate_half as in HF, in float32, cast once to x's dtype."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# Vision -> token blocks, prompt embeddings
# ---------------------------------------------------------------------------


def _embed(vlm: VLM, ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings; an id past the table reads its last row, as the
    reference's gather clamps (the CLIP BPE ids reach 49407, past a 32000-
    or 256-token llama vocabulary)."""
    return vlm.tok_emb[ids.long().clamp(max=vlm.variant.vocab - 1)]


@torch.no_grad()
def encode_images(vlm: VLM, visual: clip_mod.CLIPVisual, images: torch.Tensor) -> torch.Tensor:
    """(N, S, S, 3) preprocessed images -> (N, image_tokens, width) vision
    token blocks in the LM's dtype: the CLIP tower's pooled, normalized
    embedding (its attention through kernel K2 on the card), the projector
    (+ GELU and ``proj2`` when present), tiled over ``image_tokens`` slots
    with the positional ramp added.  The tower runs in its own dtype."""
    dtype = vlm.dtype
    feats = clip_mod.encode_image(visual, images, impl="flash", normalize=True)  # (N, D) f32
    proj = _mm_f32(feats.to(dtype), vlm.proj_w) + vlm.proj_b.float()
    if hasattr(vlm, "proj2_w"):
        # LLaVA-style 2-layer projector: linear_1 -> gelu -> linear_2
        proj = _mm_f32(tfm.gelu(proj).to(dtype), vlm.proj2_w) + vlm.proj2_b.float()
    ramp = vlm.pos[: vlm.variant.image_tokens]
    return proj.to(dtype)[:, None, :] + ramp[None, :, :]


@torch.no_grad()
def image_text_prompt_embeddings(
    vlm: VLM,
    visual: clip_mod.CLIPVisual,
    ids: torch.Tensor,  # (T_ids,) text token ids
    n_text: int,  # valid text tokens
    images: torch.Tensor,  # (N, S, S, 3) preprocessed
    t: int,  # output length
) -> Tuple[torch.Tensor, int]:
    """[image blocks..., text tokens] -> ((t, W) embeddings, valid length);
    positions past the valid length are zero."""
    blocks = encode_images(vlm, visual, images)
    img = blocks.reshape(-1, blocks.shape[-1])
    n_img = img.shape[0]
    ids = torch.as_tensor(ids, device=vlm.device).long()
    emb = torch.zeros((t, img.shape[-1]), dtype=vlm.dtype, device=vlm.device)
    emb[: min(n_img, t)] = img[: min(n_img, t)]
    n = min(n_img + int(n_text), t)
    if n > n_img:
        emb[n_img:n] = _embed(vlm, ids[: n - n_img])
    return emb, n


@torch.no_grad()
def text_prompt_embeddings(vlm: VLM, ids: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """Batched text-only prompt embeddings: ids (B, T), valid lengths ns (B,)
    -> (B, T, W); positions >= ns are zero."""
    emb = _embed(vlm, ids)
    ok = torch.arange(ids.shape[1], device=ids.device)[None, :] < ns[:, None]
    return torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))


@torch.no_grad()
def build_prompt_embeddings(
    vlm: VLM,
    visual: clip_mod.CLIPVisual,
    token_ids,  # (T_text,) text tokens
    images: Optional[torch.Tensor],  # (N, S, S, 3) preprocessed or None
    max_len: int,
) -> Tuple[torch.Tensor, int]:
    """[image blocks..., text tokens] -> (max_len, W) padded embeddings +
    valid length."""
    parts = []
    if images is not None and images.shape[0] > 0:
        blocks = encode_images(vlm, visual, images)
        parts.append(blocks.reshape(-1, blocks.shape[-1]))
    parts.append(_embed(vlm, torch.as_tensor(np.asarray(token_ids), device=vlm.device)))
    emb = torch.cat(parts)[:max_len]
    n = emb.shape[0]
    return F.pad(emb, (0, 0, 0, max_len - n)), n


# ---------------------------------------------------------------------------
# Prefill / decode with a KV cache
# ---------------------------------------------------------------------------


class KVCache:
    """k, v: (L, B, Tmax, H_kv, Dh); length: (B,) int64 tokens filled.
    Updated in place by ``prefill``, ``decode_step`` and ``admit_wave``."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, length: torch.Tensor):
        self.k, self.v, self.length = k, v, length


def init_cache(v: VLMVariant, batch: int, dtype=torch.bfloat16, device: DeviceLike = None) -> KVCache:
    dev = resolve(device)
    shape = (v.layers, batch, v.max_seq, v.n_kv, v.width // v.heads)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        length=torch.zeros(batch, dtype=torch.long, device=dev),
    )


def _row_runs(rows, b: int) -> List[Tuple[int, int]]:
    """A host bool mask over the batch -> its runs of consecutive True rows
    as (start, stop); None -> every row."""
    if rows is None:
        return [(0, b)]
    m = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows, bool)
    runs, start = [], None
    for i, on in enumerate(list(m) + [False]):
        if on and start is None:
            start = i
        elif not on and start is not None:
            runs.append((start, i))
            start = None
    return runs


def _last(x: torch.Tensor, valid_len: torch.Tensor) -> torch.Tensor:
    return x[torch.arange(x.shape[0], device=x.device), valid_len - 1]


@torch.no_grad()
def prefill(
    vlm: VLM,
    embeddings: torch.Tensor,  # (B, T, W) already-embedded prompt (text + vision)
    valid_len,  # (B,) valid lengths
    cache: KVCache,
    impl: str = "flash",  # "flash": kernel K2's causal mode | "xla": its plain version
    rows=None,  # host bool mask: the rows whose K/V and length are written; None: all
) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt through the blocks and write each layer's K/V into the
    cache (positions :T of `rows`) and `valid_len` into its lengths.
    Returns (float32 logits at the last valid position (B, vocab), cache).

    gpt: each layer's attention takes q, k and v as views of the fused
    (B, T, 3W) projection (``transformer._attend``), causal, through K2 on
    the card; K and V go into the cache from the same views, one strided
    copy a layer and run of rows.  llama: the arch's own dense grouped
    attention (``_prefill_llama``)."""
    v = vlm.variant
    b, t, w = embeddings.shape
    valid_len = upload(valid_len, vlm.device, torch.long)
    runs = _row_runs(rows, b)
    if v.arch == "llama":
        x = _prefill_llama(vlm, embeddings, cache, runs)
        x = _rms_norm(_last(x, valid_len), vlm.ln_f_g, v.norm_eps)
        head = vlm.lm_head
    else:
        dh = w // v.heads
        x = embeddings.to(vlm.dtype) + vlm.pos[:t]
        for li, p in enumerate(vlm.blocks):
            qkv = tfm.linear(tfm.layer_norm(x, p.ln1_g, p.ln1_b), p.wqkv, p.bqkv)
            att = tfm._attend(qkv, v.heads, impl, causal=True)
            kh = qkv[..., w : 2 * w].view(b, t, v.heads, dh)
            vh = qkv[..., 2 * w :].view(b, t, v.heads, dh)
            for r0, r1 in runs:
                cache.k[li, r0:r1, :t].copy_(kh[r0:r1])
                cache.v[li, r0:r1, :t].copy_(vh[r0:r1])
            x = x + tfm.linear(att, p.wo, p.bo)
            x = x + tfm.mlp(tfm.layer_norm(x, p.ln2_g, p.ln2_b), p.w1, p.b1, p.w2, p.b2)
        x = tfm.layer_norm(_last(x, valid_len), vlm.ln_f_g, vlm.ln_f_b)
        head = vlm.tok_emb
    for r0, r1 in runs:
        cache.length[r0:r1] = valid_len[r0:r1]
    return _mm_f32(x, head.t()), cache


def _prefill_llama(vlm: VLM, embeddings: torch.Tensor, cache: KVCache, runs) -> torch.Tensor:
    """The llama blocks over the prompt, K/V (after RoPE, at n_kv heads)
    into the cache; dense causal attention with K/V repeated to the query
    heads, the scores from float32 q and k, as the reference.  Returns the
    last block's output (B, T, W)."""
    v = vlm.variant
    b, t, w = embeddings.shape
    dh = w // v.heads
    groups = v.heads // v.n_kv
    dtype = vlm.dtype
    x = embeddings.to(dtype)
    cos, sin = _rope_cos_sin(torch.arange(t, device=x.device), dh, v.rope_theta)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    future = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    for li, p in enumerate(vlm.blocks):
        xn = _rms_norm(x, p.ln1_g, v.norm_eps)
        qh = _apply_rope(_mm_f32(xn, p.wq).view(b, t, v.heads, dh), cos, sin)
        kh = _apply_rope(_mm_f32(xn, p.wk).view(b, t, v.n_kv, dh), cos, sin)
        vh = _mm_f32(xn, p.wv).view(b, t, v.n_kv, dh).to(dtype)
        for r0, r1 in runs:
            cache.k[li, r0:r1, :t].copy_(kh[r0:r1])
            cache.v[li, r0:r1, :t].copy_(vh[r0:r1])
        kg = kh.repeat_interleave(groups, dim=2)
        vg = vh.repeat_interleave(groups, dim=2)
        s = torch.einsum("bthd,bshd->bhts", qh, kg) * dh**-0.5
        pr = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1).to(dtype)
        att = torch.einsum("bhts,bshd->bthd", pr.float(), vg.float()).to(dtype).reshape(b, t, w)
        x = x + tfm.linear(att, p.wo)
        xn = _rms_norm(x, p.ln2_g, v.norm_eps)
        mid = (F.silu(_mm_f32(xn, p.w_gate)) * _mm_f32(xn, p.w_up)).to(dtype)
        x = x + tfm.linear(mid, p.w_down)
    return x


def _cached_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One query a row against a cache layer: q (B, H, Dh), kc/vc (B, Tmax,
    H_kv, Dh), mask (B, Tmax) -> (B, H, Dh) in vc's dtype.  Scores in
    float32 from q's dtype (kc is cast to it if it differs), softmax in
    float32, probabilities in vc's dtype, P.V accumulated in float32.

    K and V are read in place: a row's cache is one contiguous (Tmax*H_kv,
    Dh) slab, so each product is one batched matmul over the rows against
    the whole slab.  Query head h pairs with key head h // (H / H_kv) only,
    so the scores are the diagonal of the (H_kv, Tmax, H_kv) product, and
    P.V multiplies the probabilities placed on that diagonal (zeros
    elsewhere) into the slab.  That costs H_kv times the flops of the
    needed pairs, and no copy of the cache."""
    b, h, dh = q.shape
    tmax, hkv = kc.shape[1], kc.shape[2]
    g = h // hkv
    kf = kc.to(q.dtype).reshape(b, tmax * hkv, dh)
    s = _bmm_f32(q, kf.transpose(1, 2)).view(b, hkv, g, tmax, hkv)
    s = s.diagonal(dim1=1, dim2=4).permute(0, 3, 1, 2).reshape(b, h, tmax) * dh**-0.5
    p = torch.softmax(s.masked_fill(~mask[:, None, :], float("-inf")), dim=-1).to(vc.dtype)
    p_diag = torch.zeros((b, hkv, g, tmax, hkv), dtype=vc.dtype, device=vc.device)
    p_diag.diagonal(dim1=1, dim2=4).copy_(p.view(b, hkv, g, tmax).permute(0, 2, 3, 1))
    return torch.bmm(p_diag.view(b, h, tmax * hkv), vc.reshape(b, tmax * hkv, dh))


@torch.no_grad()
def decode_step(
    vlm: VLM,
    tokens: torch.Tensor,  # (B,) current tokens
    cache: KVCache,
    active: torch.Tensor,  # (B,) bool slots that should advance
) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step for all slots.  Returns (float32 logits (B,
    vocab), cache).  As the reference: every row's new K/V is written at its
    position and attended over all ``max_seq`` positions (masked past it);
    then the inactive rows get back their saved entries, and only the
    active rows' lengths advance.  A position past ``max_seq`` writes
    nothing (the reference's scatter drops it).  No host sync."""
    v = vlm.variant
    dtype = vlm.dtype
    if cache.k.dtype != dtype:
        raise ValueError(f"cache dtype {cache.k.dtype} != the model's {dtype}")
    b, w = tokens.shape[0], v.width
    dh = w // v.heads
    pos = cache.length
    posc = pos.clamp(0, v.max_seq - 1)
    rows = torch.arange(b, device=pos.device)
    written = (pos < v.max_seq)[:, None, None]
    mask = torch.arange(v.max_seq, device=pos.device)[None, :] <= pos[:, None]
    old_k, old_v = cache.k[:, rows, posc], cache.v[:, rows, posc]  # (L, B, H_kv, Dh)
    x = _embed(vlm, tokens)[:, None, :]
    if v.arch == "llama":
        cos, sin = _rope_cos_sin(pos, dh, v.rope_theta)
        cos, sin = cos[:, None, :], sin[:, None, :]
    else:
        x = x + vlm.pos[posc][:, None, :]
    for li, p in enumerate(vlm.blocks):
        kc, vc = cache.k[li], cache.v[li]
        if v.arch == "llama":
            xn = _rms_norm(x, p.ln1_g, v.norm_eps)
            q = _apply_rope(_mm_f32(xn, p.wq).view(b, v.heads, dh), cos, sin)
            k_new = _apply_rope(_mm_f32(xn, p.wk).view(b, v.n_kv, dh), cos, sin)
            v_new = _mm_f32(xn, p.wv).view(b, v.n_kv, dh)
        else:
            qkv = tfm.linear(tfm.layer_norm(x, p.ln1_g, p.ln1_b), p.wqkv, p.bqkv)[:, 0]
            q, k_new, v_new = (z.view(b, v.heads, dh) for z in qkv.split(w, dim=-1))
        kc[rows, posc] = torch.where(written, k_new.to(dtype), old_k[li])
        vc[rows, posc] = torch.where(written, v_new.to(dtype), old_v[li])
        att = _cached_attention(q, kc, vc, mask).reshape(b, 1, w)
        if v.arch == "llama":
            x = x + tfm.linear(att, p.wo)
            xn = _rms_norm(x, p.ln2_g, v.norm_eps)
            x = x + tfm.linear((F.silu(_mm_f32(xn, p.w_gate)) * _mm_f32(xn, p.w_up)).to(dtype), p.w_down)
        else:
            x = x + tfm.linear(att, p.wo, p.bo)
            x = x + tfm.mlp(tfm.layer_norm(x, p.ln2_g, p.ln2_b), p.w1, p.b1, p.w2, p.b2)
    keep = active[None, :, None, None]
    cache.k[:, rows, posc] = torch.where(keep, cache.k[:, rows, posc], old_k)
    cache.v[:, rows, posc] = torch.where(keep, cache.v[:, rows, posc], old_v)
    cache.length += active.to(cache.length.dtype)
    if v.arch == "llama":
        x, head = _rms_norm(x[:, 0], vlm.ln_f_g, v.norm_eps), vlm.lm_head
    else:
        x, head = tfm.layer_norm(x[:, 0], vlm.ln_f_g, vlm.ln_f_b), vlm.tok_emb
    return _mm_f32(x, head.t()), cache


@torch.no_grad()
def decode_chunk(
    vlm: VLM, tokens: torch.Tensor, cache: KVCache, active: torch.Tensor, steps: int = 8
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """`steps` greedy advances for all slots (`active` fixed), queued on the
    device with no host sync.  Slots that emit EOT mid-chunk keep advancing;
    the host discards their surplus tokens.  Returns (toks (steps, B),
    last_tokens (B,), cache)."""
    toks, cur = [], tokens
    for _ in range(steps):
        logits, cache = decode_step(vlm, cur, cache, active)
        cur = torch.argmax(logits, dim=-1)
        toks.append(cur)
    return torch.stack(toks), cur, cache


@torch.no_grad()
def decode_chunk_tracked(
    vlm: VLM,
    tokens: torch.Tensor,  # (B,) current tokens
    cache: KVCache,
    active: torch.Tensor,  # (B,) bool
    remaining: torch.Tensor,  # (B,) tokens left in each slot's budget
    eot_id: int,
    steps: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, KVCache, torch.Tensor, torch.Tensor]:
    """`decode_chunk` with the EOT / budget bookkeeping on the device: a slot
    that emits EOT or spends its budget freezes for the rest of the chunk,
    so consecutive chunks queue back to back with no host sync between them
    (serving/batcher.py ``pipeline_depth``).

    Returns (toks (steps, B), act_hist (steps, B): the slot was live
    entering the step, i.e. its token is real (the EOT itself counts),
    last_tokens, cache, active', remaining')."""
    toks, hist = [], []
    cur, act, rem = tokens, active, remaining
    for _ in range(steps):
        logits, cache = decode_step(vlm, cur, cache, act)
        cur = torch.where(act, torch.argmax(logits, dim=-1), cur)
        rem = torch.where(act, rem - 1, rem)
        hist.append(act)
        toks.append(cur)
        act = act & (cur != eot_id) & (rem > 0)
    return torch.stack(toks), torch.stack(hist), cur, cache, act, rem


@torch.no_grad()
def admit_wave(
    vlm: VLM,
    emb: torch.Tensor,  # (B, T, W) prompt embeddings; zeros on non-admitted rows
    ns,  # (B,) valid lengths (>= 1 on admitted rows)
    admit,  # (B,) host bool mask: rows being (re)admitted this wave
    cache: KVCache,
    current: torch.Tensor,  # (B,) current tokens of live slots
) -> Tuple[torch.Tensor, KVCache]:
    """Admission for the continuous batcher: prefill the whole (B, T) wave
    (non-admitted rows too, with valid length 1, so the launch shape is
    fixed), write the admitted rows' K/V (their first T positions, in
    place) and lengths, and compute their first greedy tokens.  Rows not in
    `admit` keep their cache rows, length and current token bit for bit.
    Returns (current' (B,), cache)."""
    ns = upload(ns, vlm.device, torch.long)
    logits, cache = prefill(vlm, emb, ns.clamp(min=1), cache, rows=admit)
    for r0, r1 in _row_runs(admit, emb.shape[0]):
        cache.length[r0:r1] = ns[r0:r1]
    sel = upload(np.asarray(admit, bool), vlm.device)
    return torch.where(sel, torch.argmax(logits, dim=-1), current), cache


# ---------------------------------------------------------------------------
# HuggingFace LLaVA-family weights
# ---------------------------------------------------------------------------


def convert_hf_llava(state_dict: Dict, v: VLMVariant, dtype=torch.float32, device: DeviceLike = None) -> VLM:
    """A HuggingFace LLaVA-family state dict (tensors or numpy arrays) ->
    an ``arch="llama"`` model.

    Accepts a ``LlavaForConditionalGeneration`` (``language_model.model.
    layers...`` or the newer ``model.language_model.layers...`` keys) or a
    bare ``LlamaForCausalLM`` (``model.layers...``).  HF ``nn.Linear``
    weights are (out, in) and are transposed to the (in, out) layout;
    grouped K/V and the rotate-half RoPE storage carry over unchanged.  The
    multi-modal projector (``multi_modal_projector.linear_{1,2}``) loads
    into proj / proj2 when present (its input dim is the vision features'
    width); a bare LM gets a zero (1, width) projector, text-only.  Tied
    embeddings (no ``lm_head``) reuse ``embed_tokens``."""
    from ..bridge import load_flat

    def arr(t):
        if hasattr(t, "detach"):
            t = t.detach().cpu().float().numpy()
        return np.asarray(t, np.float32)

    keys = list(state_dict.keys())

    def find(suffix, required=True, exclude=("vision_tower",)):
        hits = [k for k in keys if k.endswith(suffix) and not any(e in k for e in exclude)]
        if not hits:
            if required:
                raise KeyError(f"no key ending in {suffix!r}")
            return None
        return arr(state_dict[hits[0]])

    dh = v.width // v.heads
    flat: Dict[str, np.ndarray] = {}
    names = {"ln1_g": "input_layernorm", "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj", "ln2_g": "post_attention_layernorm",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj", "w_down": "mlp.down_proj"}
    for i in range(v.layers):
        for ours, theirs in names.items():
            a = find(f"layers.{i}.{theirs}.weight")
            flat[f"blocks.{i}.{ours}"] = a if ours.startswith("ln") else a.T
    for name, cols in (("wq", v.heads * dh), ("wk", v.n_kv * dh)):
        if flat[f"blocks.0.{name}"].shape != (v.width, cols):
            raise ValueError(f"{name}: shape {flat[f'blocks.0.{name}'].shape} does not fit variant {v.name}")

    emb = find("embed_tokens.weight")
    final_norm = next((arr(state_dict[k]) for k in keys
                       if k.endswith("norm.weight") and "layers." not in k and "vision" not in k), None)
    if final_norm is None:
        raise KeyError("final norm weight not found")
    lm_head = find("lm_head.weight", required=False)
    flat.update(tok_emb=emb, pos=np.zeros((v.max_seq, v.width), np.float32), ln_f_g=final_norm,
                lm_head=emb if lm_head is None else lm_head)
    l1 = find("multi_modal_projector.linear_1.weight", required=False, exclude=())
    l2 = None
    if l1 is not None:
        flat["proj_w"] = l1.T
        flat["proj_b"] = find("multi_modal_projector.linear_1.bias", exclude=())
        l2 = find("multi_modal_projector.linear_2.weight", required=False, exclude=())
        if l2 is not None:
            flat["proj2_w"] = l2.T
            flat["proj2_b"] = find("multi_modal_projector.linear_2.bias", exclude=())
    else:
        # bare LM checkpoint: text-only until a projector is trained or loaded
        flat["proj_w"] = np.zeros((1, v.width), np.float32)
        flat["proj_b"] = np.zeros((v.width,), np.float32)
    model = VLM(v, dtype=dtype, device=device, proj_in=flat["proj_w"].shape[0], proj2=l2 is not None)
    return load_flat(model, flat)

