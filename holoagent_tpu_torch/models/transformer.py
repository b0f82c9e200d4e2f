"""Pre-LN transformer core (counterpart of holoagent_tpu/models/transformer.py).

Weights keep the reference's layout: matmul weights are (in, out), so a
linear layer is ``addmm(bias, x, w)``.  In bf16 the product accumulates in
float32 and rounds once with the bias added, as the reference's
``preferred_element_type=float32`` einsum plus bias, cast once.  Layer norms
and softmax run in float32.

The int8 (W8A8) half: ``QBlock`` holds a block's matmul weights as int8
**(out, in)** with float32 per-output-channel scales; every int8 product
goes through ``ops/quant_matmul`` (kernel K3 on a CUDA tensor, its plain
version on the CPU).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention, flash_attention_ref
from ..ops.quant_matmul import batched_quant_matmul


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ w (in, out) + b, in x's dtype."""
    x2 = x.reshape(-1, x.shape[-1])
    w = w.to(x.dtype)
    out = torch.mm(x2, w) if b is None else torch.addmm(b.to(x.dtype), x2, w)
    return out.view(*x.shape[:-1], w.shape[-1])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


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
    """Multi-head self-attention.  The reference's additive-mask argument
    serves only its text tower, which is not ported yet."""
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


def init_block_(blk: Block, gen: torch.Generator, layers: int) -> None:
    """Random matmul weights with the reference's ``init_block_stack``
    scales for a stack of `layers` blocks (norms and biases stay 1 / 0)."""
    width = blk.wo.shape[0]
    proj_std = (width**-0.5) * ((2 * layers) ** -0.5)
    _normal_(blk.wqkv, width**-0.5, gen)
    _normal_(blk.wo, proj_std, gen)
    _normal_(blk.w1, (2 * width) ** -0.5, gen)
    _normal_(blk.w2, proj_std, gen)


def block(x, p: Block, num_heads: int, impl: str = "xla", causal: bool = False):
    """One pre-LN transformer block."""
    x = x + attention(
        layer_norm(x, p.ln1_g, p.ln1_b),
        p.wqkv, p.bqkv, p.wo, p.bo,
        num_heads, impl=impl, causal=causal,
    )
    return x + mlp(layer_norm(x, p.ln2_g, p.ln2_b), p.w1, p.b1, p.w2, p.b2)


def run_stack(
    x: torch.Tensor,
    blocks: Sequence[Block],
    num_heads: int,
    impl: str = "xla",
    causal: bool = False,
) -> torch.Tensor:
    """Run the blocks in order (the reference scans its stacked params)."""
    for p in blocks:
        x = block(x, p, num_heads, impl=impl, causal=causal)
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
    """A block quantized by ``quantize_block_``, under the reference's
    ``quantize_block_stack`` names (``wqkv_q8``, ``wqkv_s``, ...).  Int8
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
def quantize_block_(q: QBlock, blk: Block) -> None:
    """``quantize_block_stack`` for one layer, into `q`: int8 weights and
    scales; norms and biases copied as they are."""
    for name in ("ln1_g", "ln1_b", "bqkv", "bo", "ln2_g", "ln2_b", "b1", "b2"):
        getattr(q, name).copy_(getattr(blk, name))
    for name in Q8_WEIGHTS:
        w_q, w_s = quantize_weight_int8(getattr(blk, name))
        getattr(q, f"{name}_q8").copy_(w_q.t())
        getattr(q, f"{name}_s").copy_(w_s)


def attention_q8(x: torch.Tensor, p: QBlock, num_heads: int, impl: str = "xla", qmm: str = "xla"):
    """Multi-head self-attention over int8 projections (the attention
    contractions stay in x's dtype, through K2 or its plain version)."""
    qkv = _q8_mm(x, p.wqkv_q8, p.wqkv_s, p.bqkv, qmm=qmm)
    return _q8_mm(_attend(qkv, num_heads, impl), p.wo_q8, p.wo_s, p.bo, qmm=qmm)


def block_q8(x, p: QBlock, num_heads: int, act=gelu, impl: str = "xla", qmm: str = "xla"):
    """Pre-LN block over int8-quantized matmul weights."""
    x = x + attention_q8(layer_norm(x, p.ln1_g, p.ln1_b), p, num_heads, impl=impl, qmm=qmm)
    h = layer_norm(x, p.ln2_g, p.ln2_b)
    mid = _q8_mm(h, p.w1_q8, p.w1_s, p.b1, act=act, qmm=qmm)
    return x + _q8_mm(mid, p.w2_q8, p.w2_s, p.b2, qmm=qmm)


def run_stack_q8(
    x: torch.Tensor, blocks: Sequence[QBlock], num_heads: int, impl: str = "xla", qmm: str = "xla"
) -> torch.Tensor:
    """Run the quantized blocks in order (the reference scans them)."""
    for p in blocks:
        x = block_q8(x, p, num_heads, impl=impl, qmm=qmm)
    return x
