"""Pre-LN transformer core (counterpart of holoagent_tpu/models/transformer.py).

Weights keep the reference's layout: matmul weights are (in, out), so a
linear layer is ``addmm(bias, x, w)``.  In bf16 the product accumulates in
float32 and rounds once with the bias added, as the reference's
``preferred_element_type=float32`` einsum plus bias, cast once.  Layer norms
and softmax run in float32.

Training: ``trainable`` turns a tower's float parameters on for autograd;
``run_stack(remat=True)`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), and
``cast_blocks`` gives a block stack in a compute dtype inside the autograd
graph (the reference casts its float32 params to the compute dtype in the
forward).

The int8 (W8A8) half: ``QBlock`` holds a block's matmul weights as int8
**(out, in)** with float32 per-output-channel scales; every int8 product
goes through ``ops/quant_matmul`` (kernel K3 on a CUDA tensor, its plain
version on the CPU).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention, flash_attention_ref
from ..ops.quant_matmul import batched_quant_matmul
from ..parallel import comm
from ..parallel.sharding import tp_columns


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ w (in, out) + b, in x's dtype."""
    x2 = x.reshape(-1, x.shape[-1])
    w = w.to(x.dtype)
    out = torch.mm(x2, w) if b is None else torch.addmm(b.to(x.dtype), x2, w)
    return out.view(*x.shape[:-1], w.shape[-1])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """``nn.GELU()`` (the erf form, SAM 2's), in float32, rounded to x's dtype."""
    return F.gelu(x.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (population variance) regardless of x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps)
    return y.to(x.dtype)


def attention(
    x: torch.Tensor,  # (B, T, W)
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    num_heads: int,
    impl: str = "xla",  # "flash": kernel K2 | "xla": its plain version
    causal: bool = False,
) -> torch.Tensor:
    """Multi-head self-attention.  The reference's text tower passes an
    additive causal mask to its dense attention; here that is
    ``causal=True``, the same function (every row keeps its diagonal),
    through K2's causal mode on a CUDA tensor."""
    return linear(_attend(linear(x, wqkv, bqkv), num_heads, impl, causal), wo, bo)


def _attend(qkv: torch.Tensor, num_heads: int, impl: str, causal: bool = False) -> torch.Tensor:
    """(B, T, 3W) fused projections -> (B, T, W) attention output."""
    b, t, w3 = qkv.shape
    w = w3 // 3
    q, k, v = (z.reshape(b, t, num_heads, w // num_heads).transpose(1, 2) for z in qkv.split(w, dim=-1))
    attend = {"flash": flash_attention, "xla": flash_attention_ref}.get(impl)
    if attend is None:
        raise ValueError(f"impl must be 'flash' or 'xla', got {impl!r}")
    return attend(q, k, v, causal=causal).transpose(1, 2).reshape(b, t, w)


def mlp(x, w1, b1, w2, b2, act=gelu):
    h = act(linear(x, w1, b1).float()).to(x.dtype)
    return linear(h, w2, b2)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """An inference-only parameter (no gradient)."""
    return nn.Parameter(t, requires_grad=False)


def trainable(module: nn.Module) -> nn.Module:
    """Turn autograd on for every floating-point parameter of `module` (int8
    weights stay frozen); returns the module."""
    for p in module.parameters():
        if p.is_floating_point():
            p.requires_grad_(True)
    return module


def cast_blocks(blocks: Sequence[nn.Module], dtype: torch.dtype) -> Sequence:
    """The blocks' parameters in `dtype`, as the reference's
    ``jax.tree.map(lambda a: a.astype(dtype), blocks)``: the blocks
    themselves when they are in `dtype` already, else one namespace a block
    whose casts stay in the autograd graph."""
    if all(p.dtype == dtype for blk in blocks for p in blk.parameters(recurse=False)):
        return blocks
    return [SimpleNamespace(**{n: p.to(dtype) for n, p in blk.named_parameters(recurse=False)}) for blk in blocks]


class Block(nn.Module):
    """Parameters of one pre-LN block, named and laid out as the reference's
    per-layer slice of ``init_block_stack``."""

    def __init__(self, width: int, hidden: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1_g = frozen(torch.ones(width, **kw))
        self.ln1_b = frozen(torch.zeros(width, **kw))
        self.wqkv = frozen(torch.empty(width, 3 * width, **kw))
        self.bqkv = frozen(torch.zeros(3 * width, **kw))
        self.wo = frozen(torch.empty(width, width, **kw))
        self.bo = frozen(torch.zeros(width, **kw))
        self.ln2_g = frozen(torch.ones(width, **kw))
        self.ln2_b = frozen(torch.zeros(width, **kw))
        self.w1 = frozen(torch.empty(width, hidden, **kw))
        self.b1 = frozen(torch.zeros(hidden, **kw))
        self.w2 = frozen(torch.empty(hidden, width, **kw))
        self.b2 = frozen(torch.zeros(width, **kw))


def _normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float32) * std)


def init_block_stack(blocks: Sequence[Block], gen: torch.Generator) -> None:
    """The reference's ``init_block_stack`` into a tower's stack, in place:
    random matmul weights at its scales for ``len(blocks)`` layers, block
    by block from `gen` (norms and biases stay 1 / 0)."""
    proj_scale = (2 * len(blocks)) ** -0.5
    for blk in blocks:
        width = blk.wo.shape[0]
        _normal_(blk.wqkv, width**-0.5, gen)
        _normal_(blk.wo, width**-0.5 * proj_scale, gen)
        _normal_(blk.w1, (2 * width) ** -0.5, gen)
        _normal_(blk.w2, width**-0.5 * proj_scale, gen)


def block(x, p: Block, num_heads: int, impl: str = "xla", causal: bool = False, tp=None):
    """One pre-LN transformer block.  ``tp = (mesh, axis)``: Megatron tensor
    parallelism over that mesh axis (``block_tp``)."""
    if tp is not None:
        return block_tp(x, p, num_heads, impl, causal, *tp)
    x = x + attention(
        layer_norm(x, p.ln1_g, p.ln1_b),
        p.wqkv, p.bqkv, p.wo, p.bo,
        num_heads, impl=impl, causal=causal,
    )
    return x + mlp(layer_norm(x, p.ln2_g, p.ln2_b), p.w1, p.b1, p.w2, p.b2)


def block_tp(x, p: Block, num_heads: int, impl: str, causal: bool, mesh, axis: str):
    """``block`` with its products split over a mesh axis of M ranks: rank m
    computes heads [m H/M, (m+1) H/M) of q, k and v (``wqkv``/``bqkv``
    columns of whole heads) and hidden columns [m F/M, (m+1) F/M) of the
    MLP (``w1``/``b1``), then the row-split ``wo`` and ``w2`` products are
    summed over the axis (one autograd all-reduce each, before their
    biases).  The input of each split product enters through ``copy_to_tp``,
    whose backward sums the partial input gradients."""
    n, m = comm.size(mesh, axis), comm.index(mesh, axis)
    w, f = p.wo.shape[0], p.w1.shape[1]
    dev = x.device
    qkv_cols = tp_columns(w, num_heads, m, n).to(dev)
    att_rows = tp_columns(w, num_heads, m, n, packed=1).to(dev)
    hid = torch.arange(m * (f // n), (m + 1) * (f // n), device=dev)
    xn = comm.copy_to_tp(layer_norm(x, p.ln1_g, p.ln1_b), mesh, axis)
    att = _attend(linear(xn, p.wqkv[:, qkv_cols], p.bqkv[qkv_cols]), num_heads // n, impl, causal)
    x = x + (comm.reduce_from_tp(linear(att, p.wo[att_rows]), mesh, axis) + p.bo.to(x.dtype)).to(x.dtype)
    h = comm.copy_to_tp(layer_norm(x, p.ln2_g, p.ln2_b), mesh, axis)
    mid = gelu(linear(h, p.w1[:, hid], p.b1[hid]).float()).to(x.dtype)
    return x + (comm.reduce_from_tp(linear(mid, p.w2[hid]), mesh, axis) + p.b2.to(x.dtype)).to(x.dtype)


def run_stack(
    x: torch.Tensor,
    blocks: Sequence[Block],
    num_heads: int,
    impl: str = "xla",
    causal: bool = False,
    remat: bool = False,
    tp=None,
) -> torch.Tensor:
    """Run the blocks in order (the reference scans its stacked params).
    With `remat` and autograd recording, each block keeps only its input
    and recomputes the rest in the backward pass.  `tp`: see ``block``."""
    remat = remat and torch.is_grad_enabled()
    for p in blocks:
        if remat:
            x = checkpoint(block, x, p, num_heads, impl, causal, tp, use_reentrant=False)
        else:
            x = block(x, p, num_heads, impl=impl, causal=causal, tp=tp)
    return x


# ---------------------------------------------------------------------------
# int8 (W8A8): per-output-channel symmetric int8 weights, per-row dynamic
# symmetric int8 activations
# ---------------------------------------------------------------------------


def quantize_weight_int8(w: torch.Tensor):
    """(..., in, out) float -> (int8 (..., in, out), (..., 1, out) float32
    per-channel scales), in the reference's layout.  The reference runs this
    outside any compiled function, where ``/ 127.0`` is a true division in
    w's dtype (a bf16 weight gets bf16 scales, then cast to float32); the
    divisors here are tensors, so no device turns them into reciprocals."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s.float()


def matmul_int8(
    x: torch.Tensor,  # (..., in) float
    w_q: torch.Tensor,  # (out, in) int8
    w_s: torch.Tensor,  # (1, out) f32
    b: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Dynamic-quant W8A8 product ``x_q w_q^T * a_s * w_s``, plus `b` when
    given (fused, added in float32), in `out_dtype`: float32 as the
    reference's, or the dtype the reference casts the biased sum to."""
    if b is None:
        b = torch.zeros(w_q.shape[0], dtype=torch.float32, device=w_q.device)
    return batched_quant_matmul(x, w_q, w_s, b, out_dtype=out_dtype)


def _q8_mm(x, q, s, b, act=None, qmm: str = "xla"):
    """One W8A8 matmul (+bias, +optional gelu), dispatched as the reference
    does.  qmm="pallas" on MXU-aligned shapes (K, N multiples of 128) is the
    fused kernel's contract: output in x's dtype, GELU on that rounded
    output.  Otherwise the reference's two-pass path: the biased sum in
    float32, the activation on it, one rounding to x's dtype.  Both run
    through K3 on a CUDA tensor."""
    if qmm not in ("xla", "pallas"):
        raise ValueError(f"qmm must be 'xla' or 'pallas', got {qmm!r}")
    n, k = q.shape
    if qmm == "pallas" and k % 128 == 0 and n % 128 == 0:
        return batched_quant_matmul(x, q, s, b, act="gelu" if act is not None else "none", out_dtype=x.dtype)
    if act is None:
        return matmul_int8(x, q, s, b, out_dtype=x.dtype)
    return act(matmul_int8(x, q, s, b)).to(x.dtype)


Q8_WEIGHTS = ("wqkv", "wo", "w1", "w2")  # a block's quantized matmuls


class QBlock(nn.Module):
    """A block quantized by ``quantize_block_stack``, under the reference's
    names (``wqkv_q8``, ``wqkv_s``, ...).  Int8
    weights are (out, in), scales (1, out) float32; norms and biases keep
    the float block's dtype."""

    def __init__(self, width: int, hidden: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln1_g = frozen(torch.ones(width, **kw))
        self.ln1_b = frozen(torch.zeros(width, **kw))
        self.bqkv = frozen(torch.zeros(3 * width, **kw))
        self.bo = frozen(torch.zeros(width, **kw))
        self.ln2_g = frozen(torch.ones(width, **kw))
        self.ln2_b = frozen(torch.zeros(width, **kw))
        self.b1 = frozen(torch.zeros(hidden, **kw))
        self.b2 = frozen(torch.zeros(width, **kw))
        outs = (3 * width, width, hidden, width)
        ins = (width, width, width, hidden)
        for name, dout, din in zip(Q8_WEIGHTS, outs, ins):
            setattr(self, f"{name}_q8", frozen(torch.zeros(dout, din, dtype=torch.int8, device=device)))
            setattr(self, f"{name}_s", frozen(torch.ones(1, dout, dtype=torch.float32, device=device)))


@torch.no_grad()
def quantize_block_stack(qblocks: Sequence[QBlock], blocks: Sequence[Block]) -> None:
    """The reference's ``quantize_block_stack`` into `qblocks`, block by
    block: int8 weights and scales; norms and biases copied as they are."""
    for q, blk in zip(qblocks, blocks, strict=True):
        for name in ("ln1_g", "ln1_b", "bqkv", "bo", "ln2_g", "ln2_b", "b1", "b2"):
            getattr(q, name).copy_(getattr(blk, name))
        for name in Q8_WEIGHTS:
            w_q, w_s = quantize_weight_int8(getattr(blk, name))
            getattr(q, f"{name}_q8").copy_(w_q.t())
            getattr(q, f"{name}_s").copy_(w_s)


def attention_q8(x: torch.Tensor, p: QBlock, num_heads: int, impl: str = "xla", qmm: str = "xla",
                 causal: bool = False):
    """Multi-head self-attention over int8 projections (the attention
    contractions stay in x's dtype, through K2 or its plain version).
    ``causal``: the text tower's mask (the reference's additive causal mask
    on its dense path), through K2's causal mode on the card."""
    qkv = _q8_mm(x, p.wqkv_q8, p.wqkv_s, p.bqkv, qmm=qmm)
    return _q8_mm(_attend(qkv, num_heads, impl, causal), p.wo_q8, p.wo_s, p.bo, qmm=qmm)


def block_q8(x, p: QBlock, num_heads: int, act=gelu, impl: str = "xla", qmm: str = "xla", causal: bool = False):
    """Pre-LN block over int8-quantized matmul weights."""
    x = x + attention_q8(layer_norm(x, p.ln1_g, p.ln1_b), p, num_heads, impl=impl, qmm=qmm, causal=causal)
    h = layer_norm(x, p.ln2_g, p.ln2_b)
    mid = _q8_mm(h, p.w1_q8, p.w1_s, p.b1, act=act, qmm=qmm)
    return x + _q8_mm(mid, p.w2_q8, p.w2_s, p.b2, qmm=qmm)


def run_stack_q8(
    x: torch.Tensor, blocks: Sequence[QBlock], num_heads: int, impl: str = "xla", qmm: str = "xla",
    causal: bool = False,
) -> torch.Tensor:
    """Run the quantized blocks in order (the reference scans them)."""
    for p in blocks:
        x = block_q8(x, p, num_heads, impl=impl, qmm=qmm, causal=causal)
    return x
