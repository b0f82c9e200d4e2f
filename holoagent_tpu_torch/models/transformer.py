"""Pre-LN transformer core (counterpart of holoagent_tpu/models/transformer.py).

Weights keep the reference's layout: matmul weights are (in, out), so a
linear layer is ``addmm(bias, x, w)``.  In bf16 the product accumulates in
float32 and rounds once with the bias added, as the reference's
``preferred_element_type=float32`` einsum plus bias, cast once.  Layer norms
and softmax run in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention, flash_attention_ref


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
    b, t, w = x.shape
    dh = w // num_heads
    qkv = linear(x, wqkv, bqkv)
    q, k, v = (z.reshape(b, t, num_heads, dh).transpose(1, 2) for z in qkv.split(w, dim=-1))
    attend = {"flash": flash_attention, "xla": flash_attention_ref}.get(impl)
    if attend is None:
        raise ValueError(f"impl must be 'flash' or 'xla', got {impl!r}")
    out = attend(q, k, v, causal=causal).transpose(1, 2).reshape(b, t, w)
    return linear(out, wo, bo)


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
