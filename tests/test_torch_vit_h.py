"""Port parity of kernel K1 at head dim 80 (SAM vit_h: width 1280 over 16
heads) on the CPU.

- K1's plain version against the Pallas kernel in interpret mode at a 16 x
  16 grid, head dim 80: 2e-3 in float32 (the kernels' own tolerance).
- A SAM variant with head dim 80 (width 160, 2 heads, a 16 x 16 grid),
  built in both packages, through ``encode_image``: the JAX side with its
  Pallas K1 in interpret mode, the port through K1's wrapper (its plain
  version on CPU tensors); 2e-3 in float32, 0.05 in bf16; and the W8A8
  encoder (``quantize_sam``) against the JAX int8 encoder at the same
  tolerances (tests/test_torch_quant.py::test_sam_q8_encoder's setting).
- Routing: ``k1_route`` and the wrapper take head dims 64 and 80 and raise
  on 72; K2 stays at 64; the resident kernel's shared-memory budget per
  head dim is the source's; vit_h's qkv views are read in place.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.models import sam as jsam
from holoagent_tpu.ops import flash_attention as jfa
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3), "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}
# head dim 80 on a 16 x 16 grid (64 px / patch 4), windows of 2 x 2
SAM_HD80 = dict(name="test-hd80", img_size=64, patch=4, width=160, depth=2, heads=2, global_idx=(1,), window=2,
                out_chans=32, decoder_dim=32, decoder_heads=2, decoder_mlp=64)
JV, TV = jsam.SAMVariant(**SAM_HD80), tsam.SAMVariant(**SAM_HD80)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _relpos_inputs(rng, g, bh, d):
    n = g * g
    q, k, v = (rng.normal(0, 1, (bh, n, d)).astype(np.float32) for _ in range(3))
    rel_h = rng.normal(0, 0.5, (2 * g - 1, d)).astype(np.float32)
    rel_w = rng.normal(0, 0.5, (2 * g - 1, d)).astype(np.float32)
    idx = np.arange(g)
    rel = idx[:, None] - idx[None, :] + g - 1
    qg = q.reshape(bh, g, g, d)
    bias_h = np.einsum("byxd,ykd->byxk", qg, rel_h[rel]).reshape(bh, n, g)
    bias_w = np.einsum("byxd,xkd->byxk", qg, rel_w[rel]).reshape(bh, n, g)
    return q, k, v, bias_h.astype(np.float32), bias_w.astype(np.float32)


def test_k1_d80_ref_matches_pallas(rng):
    """K1's plain version at head dim 80 against the Pallas kernel in
    interpret mode, a 16 x 16 grid, 3 heads."""
    args = _relpos_inputs(rng, 16, bh=3, d=80)
    ref = jfa.flash_attention_2d(*(jnp.asarray(a) for a in args), grid_hw=(16, 16), block_q=128, interpret=True)
    out = tfa.flash_attention_2d_ref(*(torch.from_numpy(a) for a in args), grid_hw=(16, 16))
    assert out.shape == (3, 256, 80)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sam_hd80_encoder_matches_reference(rng, dtype):
    """The head-dim-80 variant's encoder: every attention layer through K1's
    wrapper (the plain version here), against the JAX encoder with its
    Pallas K1 in interpret mode."""
    jdt, tdt, tol = DTYPES[dtype]
    params = jsam.init_sam(jax.random.key(0), JV)
    model = bridge.sam_from_jax(_np_tree(params), TV, device="cpu", dtype=tdt)
    assert TV.width // TV.heads == 80
    img = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = jsam.encode_image(params["encoder"], jnp.asarray(img), JV, dtype=jdt, impl="flash", interpret=True)
    n0 = tfa.flash_attention_2d.launches
    out = tsam.encode_image(model.encoder, torch.from_numpy(img), TV, impl="flash")
    assert out.dtype == tdt and out.shape == (2, 16, 16, 32)
    assert tfa.flash_attention_2d.launches == n0  # CPU tensors: no kernel launch
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sam_hd80_q8_encoder_matches_reference(rng, dtype):
    """quantize_sam and the int8 encoder at head dim 80 against the JAX
    int8 encoder (eager, impl="xla": its dense attention, which is K1's
    plain version; see test_torch_quant.py::test_sam_q8_encoder)."""
    jdt, tdt, tol = DTYPES[dtype]
    params = jax.tree.map(lambda a: a.astype(jdt), jsam.init_sam(jax.random.key(1), JV))
    model = tsam.quantize_sam(bridge.sam_from_jax(_np_tree(params), TV, device="cpu", dtype=tdt))
    assert model.quant and model.encoder.blocks[0].qkv.w_q8.shape == (3 * 160, 160)
    img = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    ref = jsam.encode_image(jsam.quantize_sam(params)["encoder"], jnp.asarray(img), JV, dtype=jdt, impl="xla")
    out = tsam.encode_image(model.encoder, torch.from_numpy(img), TV, impl="flash")
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("d", [64, 80, 72])
def test_k1_route_takes_head_dims_64_and_80(d):
    """Both K1 routes take head dims 64 and 80 (the kernel's two
    instantiations); 72 raises."""
    if d == 72:
        for grid in ((64, 64), (14, 14)):
            with pytest.raises(ValueError, match="head dim 72"):
                tfa.k1_route(*grid, d)
        return
    assert tfa.k1_route(64, 64, d) == "global" and tfa.k1_route(14, 14, d) == "resident"


@pytest.mark.parametrize("d", [64, 80, 72])
def test_k1_wrapper_head_dims_off_the_cpu(d):
    """A tensor off the CPU never takes the plain version: at head dim 72
    the wrapper raises on the head dim; at 64 and 80 it passes that check
    and raises only because these (meta) tensors are not on the card.  K2
    raises at 80: its kernels take 64."""
    g, bh = 14, 2
    q, k, v = (torch.empty(bh, g * g, d, dtype=torch.bfloat16, device="meta") for _ in range(3))
    bias = torch.empty(bh, g * g, g, dtype=torch.float32, device="meta")
    match = "head dim 72" if d == 72 else "CUDA device"
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_2d(q, k, v, bias, bias, (g, g))
    if d == 80:
        with pytest.raises(ValueError, match="K2 takes 64"):
            tfa.flash_attention(q[None], k[None], v[None])


def _resident_smem(t, hw, pitch):
    """resident_smem<D> of csrc/flash_attention.cu: K and V panels of t
    rounded up to 16 rows at the head dim's pitch, plus with the bias (hw =
    grid_h + grid_w) the key table and four warps' two bias slices."""
    t16 = (t + 15) // 16 * 16
    return 2 * t16 * pitch + (t16 * 4 + 2 * 4 * 16 * hw * 4 if hw else 0)


def test_resident_budget_per_head_dim():
    """The resident kernel's shared memory per head dim: K/V rows of 128
    bytes at D = 64 and 176 at D = 80 (160 bytes and 16 of padding), plus
    the bias table and slices.  vit_b's and vit_h's windows (N = 196, h + w
    = 28) need 68416 and 88384 bytes (three and two blocks an SM, as the
    card reports them); the largest launch of either head dim (T_MAX,
    RES_HW_MAX) fits one block's 227 KB, which the source asserts."""
    text = tfa.LIB.source.read_text()
    pitch = {64: 128, 80: 176}
    assert "static constexpr int PITCH = ROW_BYTES;" in text and "static constexpr int PITCH = 176;" in text
    assert "constexpr int HEAD_DIM_WIDE = 80;" in text and tfa.K1_HEAD_DIMS == (64, 80)
    for d in tfa.K1_HEAD_DIMS:
        assert f"static_assert(resident_smem<{'64' if d == 64 else 'HEAD_DIM_WIDE'}>(T_MAX, RES_HW_MAX) <= 232448" in text
        assert _resident_smem(tfa.T_MAX, tfa.RES_HW_MAX, pitch[d]) <= 232448
    assert _resident_smem(196, 28, pitch[64]) == 68416
    assert _resident_smem(196, 28, pitch[80]) == 88384
    assert tfa.k1_route(14, 14, 80) == "resident"  # the route rule does not depend on the head dim


@pytest.mark.parametrize("b,g", [(1, 64), (25, 14)], ids=["global", "windows"])
def test_k1_reads_vit_h_views_in_place(b, g):
    """vit_h's _attention_2d views of its (B, N, 3 * 1280) projection: token
    stride 3840, head stride 80, each a multiple of 16 bytes, so both K1
    routes read them in place."""
    heads, d, n = 16, 80, g * g
    qkv = torch.zeros(b, n, 3 * heads * d, dtype=torch.bfloat16)
    views = list(qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    strides = (n * 3 * heads * d, d, 3 * heads * d)
    for i, x in enumerate(views):
        assert tfa.strided_layout(x) == strides
        y, got = tfa.kernel_layout(x)
        assert y is x and got == strides
        assert x.data_ptr() == qkv.data_ptr() + i * heads * d * qkv.element_size()
    o = tfa.attention_output(b, heads, n, d, torch.bfloat16, "cpu")
    y = o.transpose(1, 2).reshape(b, g, g, heads * d)
    assert y.data_ptr() == o.data_ptr() and y.is_contiguous()
