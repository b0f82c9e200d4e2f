"""Port parity of the W8A8 operating point: kernel K3's plain version
against the JAX Pallas kernel in interpret mode, the int8 transformer half,
the int8 CLIP and SAM towers, the W8A8 tiered extraction, and the bridge of
quantized trees.  The same numpy inputs and JAX weights go through both.

Tolerances: int8 products 1e-3 in float32 (tests/test_quant_matmul.py's),
one bf16 ulp for a bf16 product (the plain version and the Pallas kernel do
the same arithmetic; they may differ in the last f32 bit of the epilogue and
in the GELU's last bits, which moves a bf16 result by at most one ulp);
towers and extraction 2e-3 in float32 and 0.05 in bf16 (ROADMAP.md).

Inside a compiled function XLA turns the row scale's ``/ 127.0`` into a
product with the reciprocal, as the reference's pipeline runs it and as the
port computes it, so the JAX int8 products here are jitted.  Outside one
(``quantize_weight_int8``, which the reference calls eagerly) it is a true
division, and so it is in the port."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import sam as jsam
from holoagent_tpu.models import transformer as jtfm
from holoagent_tpu.ops import quant_matmul as jqm
from holoagent_tpu.perception import extractor as jext
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.apps.common import load_models
from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.models import transformer as ttfm
from holoagent_tpu_torch.ops import _cuda_build as cuda_build
from holoagent_tpu_torch.ops import quant_matmul as tqm
from holoagent_tpu_torch.perception import extractor as text
from test_torch_checkpoint import _sam_state  # the official-SAM exporter; pytest puts tests/ on the path

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3), "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}
# width 128: the smallest CLIP whose matmuls take the fused path (K, N multiples of 128)
CLIP128 = dataclasses.replace(jclip.VARIANTS["test-tiny"], name="test-128", v_width=128, v_heads=2)
SAM16 = dataclasses.replace(jsam.VARIANTS["test-tiny"], img_size=64, patch=4, window=2)  # 16x16 grid


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tvariant(v):
    return tclip.CLIPVariant(**dataclasses.asdict(v))


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the reference's qmm="pallas" through the Pallas kernel in
    interpret mode (on the CPU it runs only so); the JAX package is not
    edited."""
    monkeypatch.setattr(jqm, "batched_quant_matmul", functools.partial(jqm.batched_quant_matmul, interpret=True))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in units in the last place between two bf16 arrays
    (bit patterns mapped to a monotone integer line)."""

    def line(x):
        i = np.asarray(x).view(np.int16).astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)

    return int(np.abs(line(a) - line(b)).max())


def _t2np_bf16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _qmm_inputs(rng, m, k, n):
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    wq, ws = jtfm.quantize_weight_int8(jnp.asarray(w))
    return x, w, b, np.array(wq), np.array(ws)


# ---------------------------------------------------------------------------
# K3 and the int8 transformer half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_int8_bit_exact(rng, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    w = rng.normal(0, 0.05, (3, 192, 320)).astype(np.float32)
    jq, js = jtfm.quantize_weight_int8(jnp.asarray(w, jdt))
    tq, ts = ttfm.quantize_weight_int8(torch.from_numpy(w).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 1, 320)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("act", ["none", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_ref_matches_pallas(rng, act, dtype):
    """Ragged M = 77 (the kernel's own row mask; the Pallas kernel pads)."""
    jdt, tdt, _ = DTYPES[dtype]
    x, _, b, wq, ws = _qmm_inputs(rng, 77, 256, 384)
    xj = jnp.asarray(x, jdt)
    ref = np.asarray(jqm.quant_matmul(xj, jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(b), act=act,
                                      out_dtype=jdt, interpret=True, block_m=64, block_n=128))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(tdt)
    args = (torch.from_numpy(wq.T.copy()), torch.from_numpy(ws), torch.from_numpy(b))
    outs = [tqm.quant_matmul(xt, *args, act=act, out_dtype=tdt)]
    if act == "none":
        outs.append(tqm.quant_matmul_ref(xt, *args, out_dtype=tdt))
    for out in outs:
        assert out.shape == (77, 384) and out.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=1e-3)
        else:
            assert _ulps(_t2np_bf16(out), ref) <= 1


@pytest.mark.parametrize("qmm", ["xla", "pallas"])
@pytest.mark.parametrize("kn", [(128, 256), (96, 192)])  # aligned; unaligned -> the two-pass path
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_int8_and_q8_mm(rng, pallas_interpret, qmm, kn, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    k, n = kn
    x, _, b, wq, ws = _qmm_inputs(rng, 40, k, n)
    x3 = x.reshape(2, 20, k)
    xj = jnp.asarray(x3, jdt)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(tdt)
    wqt, wst, bt = torch.from_numpy(wq.T.copy()), torch.from_numpy(ws), torch.from_numpy(b)
    ref = jax.jit(jtfm.matmul_int8)(xj, jnp.asarray(wq), jnp.asarray(ws))
    out = ttfm.matmul_int8(xt, wqt, wst)
    assert out.dtype == torch.float32 and out.shape == (2, 20, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)
    q8 = jax.jit(jtfm._q8_mm, static_argnames=("act", "qmm"))
    for act, tact in ((None, None), (jax.nn.gelu, ttfm.gelu)):
        ref = np.asarray(q8(xj, jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(b), act=act, qmm=qmm))
        out = ttfm._q8_mm(xt, wqt, wst, bt, act=tact, qmm=qmm)
        assert out.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=1e-3)
        else:
            assert _ulps(_t2np_bf16(out), ref) <= 1


def _q8_stack(dtype, width=128, layers=2):
    """The same int8 stack on both sides: JAX quantizes, the bridge carries."""
    jdt, tdt, _ = DTYPES[dtype]
    stacked = jtfm.init_block_stack(jax.random.key(3), layers, width)
    q8 = jtfm.quantize_block_stack(jax.tree.map(lambda a: a.astype(jdt), stacked))
    np_q8 = _np_tree(q8)
    blocks = torch.nn.ModuleList()
    for i in range(layers):
        blk = ttfm.QBlock(width, 4 * width, dtype=tdt)
        bridge.load_flat(blk, {k: v[i] for k, v in np_q8.items()})
        blocks.append(blk)
    return q8, blocks


@pytest.mark.parametrize("qmm", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_stack_q8_and_block_q8(rng, pallas_interpret, qmm, dtype):
    """Width 128, 2 layers, 2 heads; the port's attention both through K2's
    route and its plain version (on the CPU both are the plain version)."""
    jdt, tdt, tol = DTYPES[dtype]
    q8, blocks = _q8_stack(dtype)
    x = rng.normal(0, 1, (3, 17, 128)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    ref = jtfm.run_stack_q8(xj, q8, 2, qmm=qmm)
    ref1 = jtfm.block_q8(xj, jax.tree.map(lambda a: a[0], q8), 2, qmm=qmm)
    for impl in ("xla", "flash"):
        out = ttfm.run_stack_q8(torch.from_numpy(x).to(tdt), blocks, 2, impl=impl, qmm=qmm)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)
    one = ttfm.block_q8(torch.from_numpy(x).to(tdt), blocks[0], 2, qmm=qmm)
    np.testing.assert_allclose(one.float().numpy(), np.asarray(ref1, np.float32), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qmm", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_q8_encode_image(rng, pallas_interpret, qmm, dtype):
    """quantize_clip on the port's tower against quantize_clip on the
    reference's params (bf16 params quantize in bf16, as bench.py's)."""
    jdt, tdt, tol = DTYPES[dtype]
    params = jax.tree.map(lambda a: a.astype(jdt), jclip.init_clip(jax.random.key(0), CLIP128))
    visual = tclip.quantize_clip(bridge.clip_from_jax(_np_tree(params), _tvariant(CLIP128), device="cpu", dtype=tdt))
    assert visual.quant and not hasattr(visual, "blocks")
    img = rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    ref = jclip.encode_image(jclip.quantize_clip(params), jnp.asarray(img), CLIP128, dtype=jdt, qmm=qmm)
    n0 = tqm.quant_matmul.launches
    out = tclip.encode_image(visual, torch.from_numpy(img), impl="flash", qmm=qmm)
    assert out.dtype == torch.float32 and out.shape == (5, CLIP128.embed_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol, rtol=tol)
    assert tqm.quant_matmul.launches == n0  # CPU tensors: no kernel launch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sam_q8_encoder(rng, dtype):
    """quantize_sam + the int8 encoder on the 16x16-grid variant.  On the
    CPU the port's K1 route is its plain version, the dense attention of the
    reference's impl="xla", which is what the JAX side runs here: the int8
    rounding of the next layer turns last-bit differences of an attention
    (the reference's own Pallas K1 against its dense path: 2.4e-6 in a float
    encoder) into whole quantization steps (1.4e-2 in this int8 encoder).
    The JAX encoder runs eagerly, as tests/test_torch_models.py runs it;
    compiled, XLA contracts the dequant's last multiply and the bias add into
    one FMA, which the port's epilogue (``__fmul_rn`` / ``__fadd_rn`` in the
    kernel) does not."""
    jdt, tdt, tol = DTYPES[dtype]
    params = jax.tree.map(lambda a: a.astype(jdt), jsam.init_sam(jax.random.key(0), SAM16))
    model = tsam.quantize_sam(bridge.sam_from_jax(_np_tree(params), SAM16, device="cpu", dtype=tdt))
    assert model.quant and isinstance(model.encoder.blocks[0].lin1, tsam.QLin)
    img = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    ref = jsam.encode_image(jsam.quantize_sam(params)["encoder"], jnp.asarray(img), SAM16, dtype=jdt, impl="xla")
    out = tsam.encode_image(model.encoder, torch.from_numpy(img), SAM16, impl="flash")
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


def test_extract_tiered_w8a8_pallas(rng, pallas_interpret):
    """Both towers int8, clip_qmm="pallas" on the width-128 CLIP (so the
    fused path is really taken), float32: masks, validity and boxes exact,
    features within 2e-3."""
    sv = jsam.VARIANTS["test-tiny"]
    clip_p = jclip.quantize_clip(jclip.init_clip(jax.random.key(0), CLIP128))
    sam_p = jsam.quantize_sam(jsam.init_sam(jax.random.key(1), sv))
    clip_t = bridge.clip_from_jax(_np_tree(clip_p), _tvariant(CLIP128), device="cpu")
    sam_t = bridge.sam_from_jax(_np_tree(sam_p), tsam.VARIANTS["test-tiny"], device="cpu")
    img = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    kw = dict(points_per_side=4, pred_iou_thresh=-10.0, stability_thresh=0.0, min_area=20.0,
              max_masks=8, bbox_margin=5.0, clip_qmm="pallas")
    ref = _np_tree(jext.extract_frame_features_tiered(clip_p, sam_p, jnp.asarray(img), CLIP128, sv,
                                                      dtype=jnp.float32, **kw))
    out = text.extract_frame_features_tiered(clip_t, sam_t, torch.from_numpy(img), **kw)
    for name in ("masks", "valid", "boxes"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), getattr(ref, name), err_msg=name)
    assert ref.valid.sum() > 0
    np.testing.assert_allclose(out.f_masks.numpy(), ref.f_masks, atol=2e-3)
    np.testing.assert_allclose(out.f_global.numpy(), ref.f_global, atol=2e-3)


# ---------------------------------------------------------------------------
# Bridge, wrappers, entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tower", ["clip", "sam"])
def test_bridge_carries_quantized_trees(tower):
    """JAX's quantized tree -> the port, bit for bit (int8 weights
    transposed to (out, in)); and the port's own quantizer on the carried
    float tower gives the same tensors."""
    if tower == "clip":
        params = jclip.init_clip(jax.random.key(2), CLIP128)
        jq = _np_tree(jclip.quantize_clip(params))["visual"]["blocks_q8"]
        q = bridge.clip_from_jax(_np_tree(jclip.quantize_clip(params)), _tvariant(CLIP128), device="cpu")
        own = tclip.quantize_clip(bridge.clip_from_jax(_np_tree(params), _tvariant(CLIP128), device="cpu"))
        for i in range(CLIP128.v_layers):
            for name in ("wqkv", "wo", "w1", "w2"):
                np.testing.assert_array_equal(getattr(q.blocks_q8[i], f"{name}_q8").numpy().T, jq[f"{name}_q8"][i])
                np.testing.assert_array_equal(getattr(q.blocks_q8[i], f"{name}_s").numpy(), jq[f"{name}_s"][i])
    else:
        params = jsam.init_sam(jax.random.key(2), SAM16)
        jq = _np_tree(jsam.quantize_sam(params))
        q = bridge.sam_from_jax(jq, SAM16, device="cpu")
        own = tsam.quantize_sam(bridge.sam_from_jax(_np_tree(params), SAM16, device="cpu"))
        for i, blk in enumerate(jq["encoder"]["blocks"]):
            for name in tsam.ENCODER_Q8:
                lin = getattr(q.encoder.blocks[i], name)
                np.testing.assert_array_equal(lin.w_q8.numpy().T, blk[name]["w_q8"])
                np.testing.assert_array_equal(lin.w_s.numpy(), blk[name]["w_s"])
    mine, theirs = dict(own.named_parameters()), dict(q.named_parameters())
    assert mine.keys() == theirs.keys()
    for k, p in theirs.items():
        assert p.dtype == mine[k].dtype and torch.equal(p, mine[k]), k


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    x, _, b, wq, ws = _qmm_inputs(rng, 33, 128, 256)
    args = (torch.from_numpy(x), torch.from_numpy(wq.T.copy()), torch.from_numpy(ws), torch.from_numpy(b))
    n0 = tqm.quant_matmul.launches
    out = tqm.batched_quant_matmul(args[0].reshape(3, 11, 128), *args[1:], out_dtype=torch.float32)
    assert torch.equal(out.reshape(33, 256), tqm.quant_matmul_ref(*args, out_dtype=torch.float32))
    assert tqm.quant_matmul.launches == n0


def test_wrapper_and_dispatch_check_their_arguments(rng):
    x, _, b, wq, ws = _qmm_inputs(rng, 8, 128, 128)
    x, wq, ws, b = torch.from_numpy(x), torch.from_numpy(wq.T.copy()), torch.from_numpy(ws), torch.from_numpy(b)
    with pytest.raises(ValueError, match="act"):
        tqm.quant_matmul(x, wq, ws, b, act="relu")
    with pytest.raises(ValueError, match="w_q"):
        tqm.quant_matmul(x, wq.float(), ws, b)
    with pytest.raises(ValueError, match="w_q"):
        tqm.quant_matmul(x[:, :64], wq, ws, b)
    with pytest.raises(ValueError, match="qmm"):
        ttfm._q8_mm(x, wq, ws, b, qmm="fused")


def test_build_key_tracks_the_k3_source():
    path = tqm.LIB.path()
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so" and "quant_matmul" in path.name
    assert path != cuda_build.CudaLibrary("flash_attention.cu", {}).path()
    text = tqm.LIB.source.read_text()
    # stage B: TMA tensor loads into an mbarrier ring, wgmma s8 x s8 -> s32
    assert "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8" in text
    assert "cp.async.bulk.tensor.2d" in text and "mbarrier.try_wait.parity" in text
    # the C entry launches stage A (quantize_kernel) and then stage B (gemm_kernel)
    assert "quantize_kernel" in text and "gemm_kernel" in text
    assert len(tqm.LIB.signatures["ha_quant_matmul"]) == 13


@pytest.mark.parametrize("quant", [False, True])
def test_load_models_builds_the_configured_towers(quant, tmp_path):
    cfg = from_dict({"models": {"clip": {"type": "test-tiny", "dtype": "float32", "quant": quant},
                                "sam": {"type": "test-tiny", "dtype": "float32", "quant": quant}}})
    clip, sam, cv, sv, _ = load_models(cfg, device="cpu")
    assert (clip.quant, sam.quant) == (quant, quant) and cv.name == sv.name == "test-tiny"
    if quant:
        assert clip.blocks_q8[0].wqkv_q8.dtype == torch.int8 and sam.encoder.blocks[0].qkv.w_q8.dtype == torch.int8
        ref = tclip.quantize_clip(tclip.init_clip_visual(cv, seed=0, device="cpu"))
        assert torch.equal(clip.blocks_q8[1].w2_q8, ref.blocks_q8[1].w2_q8)
    feats = tclip.encode_image(clip, torch.zeros(2, 32, 32, 3))
    assert torch.isfinite(feats).all()
    # a checkpoint path: the SAM tower is the converted checkpoint, quantized when `quant` is set
    # (tests/test_torch_checkpoint.py holds the converters and load_models to the reference)
    state = _sam_state(_np_tree(jsam.init_sam(jax.random.key(4), jsam.VARIANTS["test-tiny"])), sv)
    torch.save(state, tmp_path / "sam.pth")
    cfg.models.sam.checkpoint = str(tmp_path / "sam.pth")
    _, sam_ck, _, _, _ = load_models(cfg, device="cpu")
    want = tsam.convert_sam(state, sv, device="cpu")
    want = tsam.quantize_sam(want) if quant else want
    assert sam_ck.quant == quant and not torch.equal(sam_ck.encoder.patch_w, sam.encoder.patch_w)
    for k, p in want.named_parameters():
        assert torch.equal(dict(sam_ck.named_parameters())[k], p), k
