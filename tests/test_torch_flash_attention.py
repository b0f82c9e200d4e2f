"""Port parity: the plain versions of kernels K1/K2 against the JAX Pallas
kernels run in interpret mode, at the shapes of test_flash_attention.py.
Tolerance 2e-3 in float32 (the kernels' own test tolerance)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.ops import flash_attention as jfa
from holoagent_tpu_torch.ops import _cuda_build as cuda_build
from holoagent_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def _qkv(rng, shape):
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [256, 384, 200, 257, 77, 1024])
def test_flash_attention_ref_matches_pallas(rng, causal, t):
    q, k, v = _qkv(rng, (2, 3, t, 64))
    ref = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, block_q=128, block_k=128, interpret=True,
    )
    out = tfa.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def _relpos_inputs(rng, g, bh=3, d=32):
    n = g * g
    q, k, v = _qkv(rng, (bh, n, d))
    rel_h = rng.normal(0, 0.5, (2 * g - 1, d)).astype(np.float32)
    rel_w = rng.normal(0, 0.5, (2 * g - 1, d)).astype(np.float32)
    idx = np.arange(g)
    rel = idx[:, None] - idx[None, :] + g - 1
    qg = q.reshape(bh, g, g, d)
    bias_h = np.einsum("byxd,ykd->byxk", qg, rel_h[rel]).reshape(bh, n, g)
    bias_w = np.einsum("byxd,xkd->byxk", qg, rel_w[rel]).reshape(bh, n, g)
    return q, k, v, bias_h.astype(np.float32), bias_w.astype(np.float32)


@pytest.mark.parametrize("g", [16, 32])
def test_flash_attention_2d_ref_matches_pallas(rng, g):
    args = _relpos_inputs(rng, g)
    n = g * g
    ref = jfa.flash_attention_2d(
        *(jnp.asarray(a) for a in args), grid_hw=(g, g),
        block_q=128 if n % 128 == 0 else 64, interpret=True,
    )
    out = tfa.flash_attention_2d_ref(*(torch.from_numpy(a) for a in args), grid_hw=(g, g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    """On CPU tensors the wrappers return the plain version's result exactly
    and leave the launch counters unchanged (they count kernel launches)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, (1, 2, 200, 64)))
    args2d = [torch.from_numpy(a) for a in _relpos_inputs(rng, 14)]
    n1, n2 = tfa.flash_attention.launches, tfa.flash_attention_2d.launches
    out = tfa.flash_attention(q, k, v, causal=True)
    out2d = tfa.flash_attention_2d(*args2d, grid_hw=(14, 14))
    assert torch.equal(out, tfa.flash_attention_ref(q, k, v, causal=True))
    assert torch.equal(out2d, tfa.flash_attention_2d_ref(*args2d, grid_hw=(14, 14)))
    assert (tfa.flash_attention.launches, tfa.flash_attention_2d.launches) == (n1, n2)


def test_wrappers_check_shapes(rng):
    q, k, v, bh, bw = (torch.from_numpy(a) for a in _relpos_inputs(rng, 14))
    with pytest.raises(ValueError):
        tfa.flash_attention_2d(q, k, v, bh, bw, grid_hw=(14, 15))
    with pytest.raises(ValueError):
        tfa.flash_attention(q[None], k[None, :, :10], v[None])


def test_build_key_tracks_the_source():
    """The build output is keyed by the source, for sm_90a."""
    path = tfa.LIB.path()
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    text = tfa.LIB.source.read_text()
    assert tfa.LIB.source.exists() and "mma.sync" in text
    # K2's resident kernel: K/V staged by cp.async, V's fragments by ldmatrix.trans
    assert "cp.async.cg.shared.global" in text and "ldmatrix.sync.aligned.m8n8.x4.trans" in text


@pytest.mark.parametrize("t,causal,route", [
    (77, True, "resident"),  # the CLIP text tower
    (257, False, "resident"),  # every CLIP visual layer
    (320, True, "resident"),  # the resident kernel's limit
    (384, True, "long"),
    (600, False, "long"),
])
def test_k2_route(t, causal, route):
    """K2 routes on T alone: the resident kernel up to the source's T_MAX,
    causal or not, the TMA + wgmma kernel beyond."""
    text = tfa.LIB.source.read_text()
    assert f"constexpr int T_MAX = {tfa.T_MAX};" in text and tfa.T_MAX == 320
    assert tfa.k2_route(t, causal) == route


def test_k2_routes_on_the_kernels_length_limit():
    """The wrapper's T_MAX, on which it routes to the resident kernel, is
    the one the kernel's C entry checks."""
    text = tfa.LIB.source.read_text()
    assert f"constexpr int T_MAX = {tfa.T_MAX};" in text and 257 <= tfa.T_MAX


def _attend_views(b, t, heads, d, dtype=torch.bfloat16):
    """q, k, v as models/transformer.py::_attend cuts them from (B, T, 3W)."""
    w = heads * d
    qkv = torch.zeros(b, t, 3 * w, dtype=dtype)
    return qkv, [z.reshape(b, t, heads, d).transpose(1, 2) for z in qkv.split(w, dim=-1)]


def test_k2_reads_attend_views_in_place():
    """The strides the wrapper hands K2's resident kernel for _attend's views:
    token stride 3W, head stride D, batch stride T*3W, each view starting
    at its third of the projection, no copy."""
    b, t, heads, d = 3, 257, 16, 64
    qkv, views = _attend_views(b, t, heads, d)
    for i, x in enumerate(views):
        assert tfa.strided_layout(x) == (t * 3 * heads * d, d, 3 * heads * d)
        y, strides = tfa.kernel_layout(x)
        assert y is x and strides == (t * 3 * heads * d, d, 3 * heads * d)
        assert x.data_ptr() == qkv.data_ptr() + i * heads * d * qkv.element_size()


@pytest.mark.parametrize("b,t,heads", [(256, 77, 12), (4, 1024, 16)], ids=["text_tower", "vlm_base_prefill"])
def test_k2_reads_causal_attend_views_in_place(b, t, heads):
    """_attend's causal views pass strided_layout with the strides both K2
    routes take: the text tower's (T = 77, 12 heads, the resident route)
    and a vlm-base prefill layer's (T = 1024, 16 heads, the long route)."""
    d = 64
    qkv, views = _attend_views(b, t, heads, d)
    strides = (t * 3 * heads * d, d, 3 * heads * d)
    for i, x in enumerate(views):
        assert x.shape == (b, heads, t, d)
        assert tfa.strided_layout(x) == strides
        y, got = tfa.kernel_layout(x)
        assert y is x and got == strides
        assert x.data_ptr() == qkv.data_ptr() + i * heads * d * qkv.element_size()
    assert tfa.k2_route(t, True) == ("resident" if t <= tfa.T_MAX else "long")


def test_k2_output_transposes_back_without_a_copy():
    """The (B, H, T, D) view of the kernel's (B, T, H, D) output: _attend's
    .transpose(1, 2).reshape(b, t, w) of it is a view of the same memory."""
    b, t, heads, d = 2, 257, 16, 64
    o = tfa.attention_output(b, heads, t, d, torch.bfloat16, "cpu")
    assert o.shape == (b, heads, t, d)
    y = o.transpose(1, 2).reshape(b, t, heads * d)
    assert y.data_ptr() == o.data_ptr() and y._base is o._base and y.is_contiguous()


@pytest.mark.parametrize("layout", ["transposed", "misaligned", "odd_token_stride"])
def test_k2_copies_layouts_the_kernel_does_not_take(layout):
    """A layout no K2 kernel can read in place is copied: contiguous,
    16-byte aligned."""
    b, t, heads, d = 2, 40, 3, 64
    if layout == "transposed":  # head dim not contiguous
        x = torch.randn(b, heads, d, t).to(torch.bfloat16).transpose(-1, -2)
    elif layout == "misaligned":  # start 2 bytes past a 16-byte boundary
        x = torch.randn(b * heads * t * d + 1).to(torch.bfloat16)[1:].view(b, heads, t, d)
    else:  # token stride of 68 elements, 136 bytes
        x = torch.randn(b, heads, t, d + 4).to(torch.bfloat16)[..., :d]
    assert tfa.strided_layout(x) is None
    y, strides = tfa.kernel_layout(x)
    assert y.data_ptr() != x.data_ptr() and y.is_contiguous() and y.data_ptr() % 16 == 0
    assert strides == (heads * t * d, t * d, d) and torch.equal(y, x)


def test_flash_attention_2d_ref_matches_pallas_window(rng):
    """K1's plain version against the Pallas kernel at the window grid the
    main path launches (14 x 14, d = 64), with the JAX caller's own block_q
    rule for N = 196 (one whole query block)."""
    args = _relpos_inputs(rng, 14, bh=3, d=64)
    ref = jfa.flash_attention_2d(*(jnp.asarray(a) for a in args), grid_hw=(14, 14), block_q=196, interpret=True)
    out = tfa.flash_attention_2d_ref(*(torch.from_numpy(a) for a in args), grid_hw=(14, 14))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def _attention_2d_views(b, n, heads, d, dtype=torch.bfloat16):
    """q, k, v as models/sam.py::_attention_2d cuts them from (B, N, 3C)."""
    qkv = torch.zeros(b, n, 3 * heads * d, dtype=dtype)
    return qkv, list(qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))


@pytest.mark.parametrize("b,g", [(1, 64), (25, 14)], ids=["global", "windows"])
def test_k1_reads_attention_2d_views_in_place(b, g):
    """The strides K1's kernels get for _attention_2d's views, for the
    global tile and the window batch: token stride 3C, head stride D,
    batch stride N*3C, each view starting at its third of the projection,
    no copy."""
    heads, d, n = 12, 64, g * g
    qkv, views = _attention_2d_views(b, n, heads, d)
    strides = (n * 3 * heads * d, d, 3 * heads * d)
    for i, x in enumerate(views):
        assert x.shape == (b, heads, n, d)
        assert tfa.strided_layout(x) == strides
        y, got = tfa.kernel_layout(x)
        assert y is x and got == strides
        assert x.data_ptr() == qkv.data_ptr() + i * heads * d * qkv.element_size()


@pytest.mark.parametrize("b,g", [(1, 64), (25, 14)], ids=["global", "windows"])
def test_k1_output_permutes_back_without_a_copy(b, g):
    """K1's (B, H, N, D) output view of a (B, N, H, D) buffer: the caller's
    .transpose(1, 2).reshape(b, h, w, c) of it is a view of the same memory."""
    heads, d, n = 12, 64, g * g
    o = tfa.attention_output(b, heads, n, d, torch.bfloat16, "cpu")
    y = o.transpose(1, 2).reshape(b, g, g, heads * d)
    assert y.data_ptr() == o.data_ptr() and y._base is o._base and y.is_contiguous()


def test_k1_wrapper_takes_3d_and_4d_inputs(rng):
    """(BH, N, D) and (B, H, N, D) inputs give equal results, each in its
    own shape; the 4-D plain version equals the 3-D one head by head."""
    b, heads, g = 2, 3, 4
    q, k, v, bh, bw = (torch.from_numpy(a) for a in _relpos_inputs(rng, g, bh=b * heads, d=64))
    out3 = tfa.flash_attention_2d(q, k, v, bh, bw, grid_hw=(g, g))
    q4, k4, v4 = (x.reshape(b, heads, g * g, 64) for x in (q, k, v))
    out4 = tfa.flash_attention_2d(q4, k4, v4, bh, bw, grid_hw=(g, g))
    assert out3.shape == q.shape and out4.shape == q4.shape
    assert torch.equal(out4.reshape(out3.shape), out3)
    with pytest.raises(ValueError):
        tfa.flash_attention_2d(q4, k4, v4, bh[:-1], bw, grid_hw=(g, g))


def test_k1_routes_on_the_kernels_limits():
    """The wrapper's T_MAX, GLOBAL_W and RES_HW_MAX are the source's; the
    global kernel is TMA + wgmma and serves K1's long grids and K2's long
    route alike; the streamed mma.sync kernel is gone."""
    text = tfa.LIB.source.read_text()
    assert f"constexpr int T_MAX = {tfa.T_MAX};" in text
    assert f"constexpr int G_W = {tfa.GLOBAL_W};" in text
    assert f"constexpr int RES_HW_MAX = {tfa.RES_HW_MAX};" in text
    assert "wgmma.mma_async" in text and "cp.async.bulk.tensor" in text and "setmaxnreg" in text
    for gone in ("flash_kernel", "launch_streamed", "ha_flash_attention"):  # the Pallas _flash_kernel is named
        assert not re.search(rf"\b{gone}\b", text), gone
    assert "launch_global<true>(" in text and "launch_global<false>(" in text  # K1's and K2's long routes
    assert tfa.k1_route(14, 14) == "resident"  # vit_b windows
    assert tfa.k1_route(64, 64) == "global"  # every SAM variant's global layers at 1024 px
    assert tfa.k1_route(7, 64) == "global"  # an odd grid height: masked in the kernel


@pytest.mark.parametrize("grid", [(32, 32), (20, 20), (1, 300)], ids=["global_32_wide", "global_20_wide", "hw_sum"])
def test_k1_route_raises_for_grids_no_kernel_takes(grid):
    """No grid goes to the plain version on the card: a long grid that is
    not 64 wide, or a short one with h + w past RES_HW_MAX, which neither
    tensor-core kernel takes, goes to the general kernel, at every head
    dim up to GENERAL_D_MAX; above it the route raises."""
    for d in (64, 80, 32):
        assert tfa.k1_route(*grid, d) == "general"
    with pytest.raises(ValueError, match="head dim"):
        tfa.k1_route(*grid, tfa.GENERAL_D_MAX + 8)


@pytest.mark.parametrize("tq,tk", [(16, 64), (4, 16), (64, 256), (64, 64)], ids=["stage2", "stage3", "stage4", "same"])
def test_flash_attention_ref_takes_fewer_queries_than_keys(rng, tq, tk):
    """K2's plain version with Tq <= Tk (Hiera's pooled-query blocks, head
    dim 72) against dense attention in float64: each query attends over
    every key."""
    q = torch.from_numpy(rng.normal(0, 1, (2, 3, tq, 72)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(0, 1, (2, 3, tk, 72)).astype(np.float32)) for _ in range(2))
    out = tfa.flash_attention_ref(q, k, v)
    p = torch.softmax(q.double() @ k.double().transpose(-1, -2) * 72**-0.5, dim=-1)
    assert out.shape == (2, 3, tq, 72)
    np.testing.assert_allclose(out.numpy(), (p @ v.double()).numpy(), atol=1e-5, rtol=1e-5)


def test_k2_wrapper_cpu_path_at_pooled_queries(rng):
    """On CPU tensors the wrapper takes the plain version at Tq != Tk too,
    counting nothing; the causal mask refuses Tq != Tk; the keys and values
    must agree in shape."""
    q = torch.from_numpy(rng.normal(0, 1, (4, 2, 16, 72)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(0, 1, (4, 2, 64, 72)).astype(np.float32)) for _ in range(2))
    n, pooled = tfa.flash_attention.launches, tfa.flash_attention.pooled
    assert torch.equal(tfa.flash_attention(q, k, v), tfa.flash_attention_ref(q, k, v))
    assert (tfa.flash_attention.launches, tfa.flash_attention.pooled) == (n, pooled)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError):
        tfa.flash_attention_ref(q, k, v, causal=True)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v[:, :, :32])
    with pytest.raises(ValueError):
        tfa.flash_attention(q[..., :64], k, v)


def test_pooled_queries_take_the_general_entry():
    """The pooled-query launches go through the general route's one C entry,
    which takes a key count (tk) beside the query count (9 ints: b, h, t,
    tk, d, grid_h, grid_w, causal, bf16), and refuses tk != t with the bias
    or the causal mask; the general kernels' body takes the key count too."""
    text = tfa.LIB.source.read_text()
    assert "ha_flash_attention_pooled" not in text and "ha_flash_attention_pooled" not in tfa.LIB.signatures
    assert "int b, int h, int t, int tk,\n                                          int d, int grid_h" in text
    assert "(tk != t && (rel_pos || causal))" in text
    assert len(tfa.LIB.signatures["ha_flash_attention_general"]) == 6 + 9 + 9 + 2
    assert "int heads, int t,\n                                         int tk, int d" in text
    assert tfa.k2_route(64, False, 72) == "general"  # Hiera's head dim is on the general route, G1 at DM 80