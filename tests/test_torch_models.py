"""Port parity of the towers on the small variants: JAX weights carried over
by holoagent_tpu_torch.bridge, the same numpy inputs through both.
Tolerances: 2e-3 in float32, 0.05 in bf16 (the JAX tests' own)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import sam as jsam
from holoagent_tpu.models import transformer as jtfm
from holoagent_tpu.perception import extractor as jext
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.models import transformer as ttfm
from holoagent_tpu_torch.ops import flash_attention as tfa
from holoagent_tpu_torch.perception import extractor as text

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3), "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}
SAM16 = dataclasses.replace(jsam.VARIANTS["test-tiny"], img_size=64, patch=4, window=2)  # 16x16 grid


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_run_stack(rng, dtype, impl):
    jdt, tdt, tol = DTYPES[dtype]
    stacked = _np_tree(jtfm.init_block_stack(jax.random.key(3), 2, 64))
    blocks = torch.nn.ModuleList()
    for i in range(2):
        blk = ttfm.Block(64, 256, dtype=tdt)
        bridge.load_flat(blk, {k: v[i] for k, v in stacked.items()})
        blocks.append(blk)
    x = rng.normal(0, 1, (3, 17, 64)).astype(np.float32)
    ref = jtfm.run_stack(
        jnp.asarray(x, jdt), jax.tree.map(lambda a: jnp.asarray(a, jdt), stacked), 4
    )
    out = ttfm.run_stack(torch.from_numpy(x).to(tdt), blocks, 4, impl=impl)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)
    one = ttfm.block(torch.from_numpy(x).to(tdt), blocks[0], 4, impl=impl)
    ref1 = jtfm.block(jnp.asarray(x, jdt), jax.tree.map(lambda a: jnp.asarray(a[0], jdt), stacked), 4)
    np.testing.assert_allclose(one.float().numpy(), np.asarray(ref1, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_encode_image(rng, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    v = jclip.VARIANTS["test-tiny"]
    params = jclip.init_clip(jax.random.key(0), v)
    visual = bridge.clip_from_jax(_np_tree(params), tclip.VARIANTS["test-tiny"], device="cpu", dtype=tdt)
    img = rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    ref = jclip.encode_image(params, jnp.asarray(img), v, dtype=jdt)
    n0 = tfa.flash_attention.launches
    for impl in ("xla", "flash"):
        out = tclip.encode_image(visual, torch.from_numpy(img), impl=impl)
        assert out.dtype == torch.float32 and out.shape == (5, 32)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol, rtol=tol)
    assert tfa.flash_attention.launches == n0  # CPU tensors: no kernel launch


def test_clip_random_init_matches_reference_scales():
    v = tclip.VARIANTS["test-tiny"]
    a = tclip.init_clip_visual(v, seed=1, device="cpu")
    b = tclip.init_clip_visual(v, seed=1, device="cpu")
    jp = _np_tree(jclip.init_clip(jax.random.key(1), jclip.VARIANTS["test-tiny"]))["visual"]
    for name, p in a.named_parameters():
        assert torch.equal(p, dict(b.named_parameters())[name])
        parts = name.split(".")
        ref = jp["blocks"][parts[2]][int(parts[1])] if parts[0] == "blocks" else jp[name]
        assert tuple(p.shape) == ref.shape, name
        np.testing.assert_allclose(p.float().std().item(), ref.std(), rtol=0.35, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sam_encoder_flash_matches_reference(rng, dtype):
    """encode_image(impl="flash") on the 16x16-grid variant against the JAX
    encoder with the Pallas kernel in interpret mode."""
    jdt, tdt, tol = DTYPES[dtype]
    params = jsam.init_sam(jax.random.key(0), SAM16)
    model = bridge.sam_from_jax(_np_tree(params), SAM16, device="cpu", dtype=tdt)
    img = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    ref = jsam.encode_image(params["encoder"], jnp.asarray(img), SAM16, dtype=jdt, impl="flash", interpret=True)
    out = tsam.encode_image(model.encoder, torch.from_numpy(img), SAM16, impl="flash")
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("layer", ["windowed", "global"])
def test_sam_attention_2d_hands_k1_views(monkeypatch, rng, layer):
    """_attention_2d gives K1 q, k and v as views of the qkv projection and
    hands K1's output on to proj with no copy, so on the card nothing is
    copied around the kernel.  A stand-in for the kernel writes the plain
    result into the kernel's (B, N, H, D) buffer; the layer's output equals
    the plain path's."""
    v = tsam.VARIANTS["test-tiny"]
    m = tsam.init_sam(v, seed=0, device="cpu", dtype=torch.bfloat16)
    blk = m.encoder.blocks[v.global_idx[0] if layer == "global" else 0]
    g = v.img_size // v.patch if layer == "global" else v.window
    b = 1 if layer == "global" else 4
    x = torch.from_numpy(rng.normal(0, 1, (b, g, g, v.width)).astype(np.float32)).to(torch.bfloat16)
    seen = {}

    def kernel(q, k, val, bias_h, bias_w, grid_hw):
        o = tfa.attention_output(*q.shape, q.dtype, "cpu")
        o.copy_(tfa.flash_attention_2d_ref(q, k, val, bias_h, bias_w, grid_hw))
        seen.update(views=(q, k, val), out=o)
        return o

    proj = blk.proj.forward
    monkeypatch.setattr(blk.proj, "forward", lambda y: (seen.update(proj_in=y), proj(y))[1])
    monkeypatch.setattr(tsam, "flash_attention_2d", kernel)
    out = tsam._attention_2d(x, blk, v.heads, impl="flash")
    q, k, val = seen["views"]
    assert q.shape == (b, v.heads, g * g, v.width // v.heads)
    base = q.untyped_storage().data_ptr()
    for t in (q, k, val):
        assert t.untyped_storage().data_ptr() == base and tfa.strided_layout(t) == q.stride()[:3]
    assert seen["proj_in"].data_ptr() == seen["out"].data_ptr() and seen["proj_in"].is_contiguous()
    monkeypatch.undo()
    assert torch.equal(out, tsam._attention_2d(x, blk, v.heads, impl="xla"))


def test_sam_random_init_shapes():
    v = tsam.VARIANTS["test-tiny"]
    m = tsam.init_sam(v, seed=0, device="cpu")
    flat = bridge.flatten(_np_tree(jsam.init_sam(jax.random.key(0), jsam.VARIANTS["test-tiny"])))
    shapes = {k: tuple(p.shape) for k, p in m.named_parameters()}
    assert shapes == {k: a.shape for k, a in flat.items()}
    assert float(m.encoder.blocks[0].norm1_g.min()) == 1.0
    assert float(m.encoder.blocks[0].qkv.w.std()) > 0


@pytest.mark.parametrize("tower", ["clip", "sam"])
def test_unknown_attention_impl_raises(tower):
    """Only "flash" (the kernel) and "xla" (its plain version) are accepted:
    a misspelt impl fails instead of quietly taking the plain version."""
    if tower == "clip":
        v = tclip.VARIANTS["test-tiny"]
        visual = tclip.init_clip_visual(v, seed=0, device="cpu")
        with pytest.raises(ValueError, match="impl"):
            tclip.encode_image(visual, torch.zeros(1, v.image_size, v.image_size, 3), impl="pallas")
    else:
        v = tsam.VARIANTS["test-tiny"]
        m = tsam.init_sam(v, seed=0, device="cpu")
        with pytest.raises(ValueError, match="impl"):
            tsam.encode_image(m.encoder, torch.zeros(1, v.img_size, v.img_size, 3), v, impl="pallas")


def test_generate_masks(rng):
    """Automatic masks on test-tiny: the same valid set, scores and boxes of
    the valid slots within tolerance, masks agreeing on nearly every pixel."""
    v = jsam.VARIANTS["test-tiny"]
    params = jsam.init_sam(jax.random.key(1), v)
    model = bridge.sam_from_jax(_np_tree(params), tsam.VARIANTS["test-tiny"], device="cpu")
    img = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    kw = dict(points_per_side=4, pred_iou_thresh=-10.0, stability_thresh=0.0, min_area=20.0, max_masks=8)
    ref = _np_tree(jsam.generate_masks(params, jnp.asarray(img), v, dtype=jnp.float32, **kw))
    out = tsam.generate_masks(model, torch.from_numpy(img), **kw)
    valid = ref["valid"]
    np.testing.assert_array_equal(out["valid"].numpy(), valid)
    assert int(out["num"]) == int(ref["num"]) > 0
    np.testing.assert_allclose(out["scores"].numpy(), ref["scores"], atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(out["boxes"].numpy()[valid], ref["boxes"][valid], atol=1.0)
    assert (out["masks"].numpy() == ref["masks"]).mean() > 0.995
    np.testing.assert_allclose(out["logits"].numpy(), ref["logits"], atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("tiered", [False, True])
def test_extract_frame_features(rng, tiered):
    """SAM masks -> disjoint carve -> crops -> CLIP -> ConceptFusion blend,
    float32: masks, validity and boxes exact, features within 2e-3."""
    cv, sv = jclip.VARIANTS["test-tiny"], jsam.VARIANTS["test-tiny"]
    clip_p, sam_p = jclip.init_clip(jax.random.key(0), cv), jsam.init_sam(jax.random.key(1), sv)
    clip_t = bridge.clip_from_jax(_np_tree(clip_p), tclip.VARIANTS["test-tiny"], device="cpu")
    sam_t = bridge.sam_from_jax(_np_tree(sam_p), tsam.VARIANTS["test-tiny"], device="cpu")
    img = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    kw = dict(points_per_side=4, pred_iou_thresh=-10.0, stability_thresh=0.0, min_area=20.0,
              max_masks=8, bbox_margin=5.0)
    jfn, tfn = (
        (jext.extract_frame_features_tiered, text.extract_frame_features_tiered)
        if tiered else (jext.extract_frame_features, text.extract_frame_features)
    )
    ref = _np_tree(jfn(clip_p, sam_p, jnp.asarray(img), cv, sv, dtype=jnp.float32, **kw))
    out = tfn(clip_t, sam_t, torch.from_numpy(img), **kw)
    for name in ("masks", "valid", "boxes"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), getattr(ref, name), err_msg=name)
    assert ref.valid.sum() > 0
    np.testing.assert_allclose(out.f_masks.numpy(), ref.f_masks, atol=2e-3)
    np.testing.assert_allclose(out.f_global.numpy(), ref.f_global, atol=2e-3)
