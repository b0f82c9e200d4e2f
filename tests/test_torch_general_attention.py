"""The attention kernels' general route (G1 bf16, G2 float32) on the CPU.

The CUDA kernels run on the card only; what is held here is their
arithmetic and their layout constants.

- G2's 3xTF32 arithmetic, emulated in plain PyTorch: each operand split
  into hi = tf32(x) (rounded to nearest by bit mask, as the kernel rounds
  it) and lo = x - hi, which the tensor cores read truncated to TF32; each
  product taken as hi.hi + hi.lo + lo.hi (exact products of TF32 values,
  float32 sums), for QK^T and for P V with P kept in float32 and
  normalised at the end as the kernel does.  Against
  the JAX package's ``flash_attention`` and ``flash_attention_2d`` in
  float32 (interpret mode, inputs from a numpy seed) it meets chip_smoke's
  float32 precision gate, max|out - ref| <= 1e-5 max|ref|, at head dims 16,
  32 and 64, causal or not, and on a 16 x 16 grid.
- The same emulation with single TF32 products fails that gate by more
  than an order of magnitude, so the gate on the card has teeth.
- The layout constants of ops/flash_attention.py (the padded head dims,
  keys a tile, queries a block, the ring's stages) against their copies in
  csrc/flash_attention.cu, and ``general_grid`` against them.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.ops import flash_attention as jfa
from holoagent_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

F32_PREC = 1e-5  # chip_smoke.F32_PREC: max|out - ref| <= F32_PREC * max|ref|
NEG_INF = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (to nearest, ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` as the tensor cores read it as a TF32 operand: its low
    13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b from TF32 operands: terms 3 is 3xTF32 (hi.hi + hi.lo + lo.hi),
    1 a single TF32 product.  Each product of two TF32 values is exact in
    float32; the sums are float32."""
    ah, bh = tf32(a), tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulated(q, k, v, terms, causal=False, bias=None):
    """The general kernel's float32 attention with its products emulated:
    scores by `product`, scaled (and biased: `bias` = (bias_h, bias_w, (h,
    w))), masked, exponentiated against the row max, P V by `product` on
    the unnormalised P, then divided by the row sum."""
    t, d = q.shape[-2:]
    s = product(q, k.transpose(-1, -2), terms) * d**-0.5
    if bias is not None:
        bias_h, bias_w, (h, w) = bias
        s = (s.reshape(-1, t, h, w) + bias_h[..., :, None] + bias_w[..., None, :]).reshape(s.shape)
    if causal:
        idx = torch.arange(t)
        s = s.masked_fill(idx[None, :] > idx[:, None], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return product(p, v, terms) / p.sum(-1, keepdim=True)


def precision(out: torch.Tensor, ref: np.ndarray) -> float:
    ref = torch.from_numpy(np.array(ref, np.float32))
    return ((out - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_3xtf32_meets_the_float32_gate_k2(d, causal):
    """K2 in float32, B=2, H=2, T=77 (a ragged key tile): 3xTF32 within
    1e-5 of max|ref| of the Pallas kernel; one TF32 product misses by 10x."""
    rng = np.random.default_rng(d + causal)
    q, k, v = (rng.standard_normal((2, 2, 77, d)).astype(np.float32) for _ in range(3))
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    three = precision(emulated(tq, tk, tv, 3, causal=causal), ref)
    one = precision(emulated(tq, tk, tv, 1, causal=causal), ref)
    assert three <= F32_PREC, three
    assert one > 10 * F32_PREC, one


@pytest.mark.parametrize("d", [16, 32, 64])
def test_3xtf32_meets_the_float32_gate_k1(d):
    """K1 in float32 on a 16 x 16 grid with the decomposed bias: 3xTF32
    within 1e-5 of max|ref| of the Pallas kernel; one TF32 product misses
    by 10x."""
    g, bh = 16, 3
    n = g * g
    rng = np.random.default_rng(100 + d)
    q, k, v = (rng.standard_normal((bh, n, d)).astype(np.float32) for _ in range(3))
    bias_h, bias_w = (0.5 * rng.standard_normal((bh, n, g)).astype(np.float32) for _ in range(2))
    ref = jfa.flash_attention_2d(*(jnp.asarray(x) for x in (q, k, v, bias_h, bias_w)), grid_hw=(g, g),
                                 interpret=True)
    t = [torch.from_numpy(x) for x in (q, k, v, bias_h, bias_w)]
    bias = (t[3], t[4], (g, g))
    three = precision(emulated(*t[:3], 3, bias=bias), ref)
    one = precision(emulated(*t[:3], 1, bias=bias), ref)
    assert three <= F32_PREC, three
    assert one > 10 * F32_PREC, one


def test_tf32_rounding():
    """The bit-mask rounding keeps 10 mantissa bits, to nearest with ties
    away from zero, and is exact on TF32 values."""
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0**-10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0**-23, 1.0 + 3 * ulp], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 3 * ulp]
    assert torch.equal(tf32(tf32(x)), tf32(x)) and torch.equal(tf32(one), one)


def _source() -> str:
    return tfa.LIB.source.read_text()


def test_general_constants_match_the_source():
    """GENERAL_BQ, GENERAL_STAGES, GENERAL_D_MAX and the padded head dims
    (GENERAL_DMS: every multiple of 16 up to GENERAL_D_MAX, each with an
    instantiation) and keys a tile (general_keys) as the source has them."""
    text = _source()
    assert f"constexpr int GEN_BQ = {tfa.GENERAL_BQ};" in text
    assert f"constexpr int GEN_STAGES = {tfa.GENERAL_STAGES};" in text
    assert f"constexpr int GEN_D_MAX = {tfa.GENERAL_D_MAX};" in text
    assert "static constexpr int BK = (F32 && DM > 64) ? 32 : 64;" in text
    dms = tuple(int(x) for x in re.findall(r"HA_GEN_DM\((\d+)\)", text))
    assert dms == tfa.GENERAL_DMS == (16, 32, 48, 64, 80, 96, 112, 128)
    for dm in tfa.GENERAL_DMS:
        assert tfa.general_keys(dm, torch.bfloat16) == 64
        assert tfa.general_keys(dm, torch.float32) == (64 if dm <= 64 else 32)
    assert re.search(r"G1 .*bf16", text) and "g1_bf16_kernel" in text and "g2_tf32x3_kernel" in text
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    assert "hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in text  # tf32() above, rounded to nearest


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_general_grid(dtype):
    """general_grid: one block a GENERAL_BQ query tile of a head, the head
    dim rounded up to 16, keys a tile per dtype and padded head dim."""
    for bh, t, d in ((6, 257, 64), (1024, 77, 16), (12, 4096, 64), (64, 257, 80), (3, 1, 1), (8, 65, 20),
                     (2, 600, 128)):
        grid = tfa.general_grid(bh, t, d, dtype)
        tiles = (t + tfa.GENERAL_BQ - 1) // tfa.GENERAL_BQ
        dm = next(x for x in tfa.GENERAL_DMS if x >= d)
        assert grid == {"blocks_per_head": tiles, "grid": tiles * bh, "dm": dm,
                        "keys_per_tile": tfa.general_keys(dm, dtype)}
