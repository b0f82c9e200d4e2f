"""The attention kernels' routes for every input the reference takes, on
the CPU.

- K2's plain version at head dims 80 (CLIP ViT-H-14's visual tower) and 16
  (the tiny towers) against the Pallas K2 in interpret mode, at T = 257
  (a ragged key tile) and T = 384 causal: 2e-3 in float32 (the kernels'
  own test tolerance); in bf16 0.03, about four bf16 ulps of the outputs'
  scale (both round the probabilities and the output to bf16, at
  different points).
- K1's plain version at head dim 32 in float32 on the 32 x 32 grid (the
  reference's own test shape), which the port's tensor-core kernels do
  not take, and on 20 x 20, against the Pallas K1: 2e-3.
- ``k1_route`` and ``k2_route`` for every (head dim, dtype, grid) a
  variant of either package gives the kernels: bf16 at head dims 64 and 80
  to the tensor-core kernels (80 not causal), everything else to the
  general kernel; off the CPU (meta tensors) the wrappers pass every check
  to the launch, and raise only above GENERAL_D_MAX.
- A head-dim-80 CLIP variant (visual width 160, 2 heads, 2 layers) built
  in both packages, through ``encode_image`` in bf16 and float32 and as a
  W8A8 tower, against the JAX tower: 2e-3 in float32, 0.05 in bf16 (the
  tower tests' tolerances, tests/test_torch_models.py).
- The port's ``apps.build_map.run`` over ``config/synthetic.yaml`` as it
  stands (float32 test-tiny CLIP, SAM in the CLIP dtype as the reference's
  Mapper runs it), with the JAX package's weights carried over by
  bridge.py, against the JAX package's build: the same labels, objects,
  rooms and views, features within 1e-4.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu import config as jconfig
from holoagent_tpu.apps import build_map as jbuild_map
from holoagent_tpu.apps.common import load_models as jload_models
from holoagent_tpu.memory.hmsg import HMSGraph as JHMSGraph
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import sam as jsam
from holoagent_tpu.models import vlm as jvlm
from holoagent_tpu.ops import flash_attention as jfa
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch import config as tconfig
from holoagent_tpu_torch.apps import build_map
from holoagent_tpu_torch.memory.hmsg import HMSGraph
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.models import vlm as tvlm
from holoagent_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
F32_TOL = 2e-3
BF16_ATTN_TOL = 0.03
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3), "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}
CLIP_HD80 = dict(name="test-hd80", image_size=32, patch=8, v_width=160, v_layers=2, v_heads=2, t_width=64,
                 t_layers=2, t_heads=4, embed_dim=32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [80, 16])
@pytest.mark.parametrize("t,causal", [(257, False), (384, True)], ids=["t257", "t384_causal"])
def test_k2_ref_matches_pallas_at_other_head_dims(rng, t, causal, d, dtype):
    """K2's plain version at head dims 80 and 16 against the Pallas K2."""
    jdt, tdt, _ = DTYPES[dtype]
    q, k, v = (rng.normal(0, 1, (2, 3, t, d)).astype(np.float32) for _ in range(3))
    ref = jfa.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal, block_q=128, block_k=128,
                              interpret=True)
    out = tfa.flash_attention_ref(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=causal)
    assert out.dtype == tdt and out.shape == (2, 3, t, d)
    tol = F32_TOL if dtype == "float32" else BF16_ATTN_TOL
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


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


@pytest.mark.parametrize("g", [32, 20])
def test_k1_ref_matches_pallas_on_grids_the_tensor_core_kernels_refuse(rng, g):
    """K1's plain version, head dim 32, float32, on grids that go to the
    general kernel on the card (32 x 32 and 20 x 20: N > T_MAX and not 64
    wide), against the Pallas K1 (block_q as the reference's caller picks
    it: 128 where it divides N, else the whole grid up to 512)."""
    args = _relpos_inputs(rng, g, bh=3, d=32)
    n = g * g
    assert tfa.k1_route(g, g, 32, torch.float32) == tfa.k1_route(g, g, 64) == "general"
    ref = jfa.flash_attention_2d(*(jnp.asarray(a) for a in args), grid_hw=(g, g),
                                 block_q=128 if n % 128 == 0 else n, interpret=True)
    out = tfa.flash_attention_2d_ref(*(torch.from_numpy(a) for a in args), grid_hw=(g, g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)


def _k2_layers():
    """(name, t, d, causal) of every K2 launch a variant of either package
    makes: the CLIP towers (visual, text) and the gpt VLMs' prefill (at a
    short and a long prompt)."""
    out = []
    for variants in (jclip.VARIANTS, tclip.VARIANTS):
        for v in variants.values():
            out.append((f"clip {v.name} visual", (v.image_size // v.patch) ** 2 + 1, v.v_width // v.v_heads, False))
            out.append((f"clip {v.name} text", v.ctx, v.t_width // v.t_heads, True))
    for variants in (jvlm.VARIANTS, tvlm.VARIANTS):
        for v in variants.values():
            if v.arch == "gpt":
                out += [(f"vlm {v.name} prefill T={t}", t, v.width // v.heads, True) for t in (128, 1024)]
    return sorted(set(out))


def _k1_layers():
    """(name, grid, d) of every K1 launch a SAM variant of either package
    makes: its global layers' grid and its windows."""
    out = []
    for variants in (jsam.VARIANTS, tsam.VARIANTS):
        for v in variants.values():
            g = v.img_size // v.patch
            out.append((f"sam {v.name} global", (g, g), v.width // v.heads))
            out.append((f"sam {v.name} windows", (v.window, v.window), v.width // v.heads))
    return sorted(set(out))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_routes_for_every_variant(dtype):
    """The route of every launch a variant of either package makes: bf16 at
    head dim 64 (or 80 without causal for K2) on the tensor-core kernels,
    resident up to T_MAX and long beyond; K1's grids on the resident or
    global kernel where those take them; everything else general.  Off the
    CPU each wrapper passes every check to the launch (meta tensors are not
    on the card) and never takes the plain version."""
    k2, k1 = _k2_layers(), _k1_layers()
    assert {d for _, _, d, _ in k2} == {16, 32, 64, 80} and {d for _, _, d in k1} == {32, 64, 80}
    seen = set()
    for name, t, d, causal in k2:
        tensor_core = dtype == torch.bfloat16 and (d == 64 or (d == 80 and not causal))
        want = ("resident" if t <= tfa.T_MAX else "long") if tensor_core else "general"
        assert tfa.k2_route(t, causal, d, dtype) == want, name
        seen.add(want)
        q = torch.empty(2, 3, t, d, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="CUDA device"):
            tfa.flash_attention(q, q, q, causal=causal)
    for name, (gh, gw), d in k1:
        n = gh * gw
        if dtype != torch.bfloat16 or d not in (64, 80):
            want = "general"
        elif n <= tfa.T_MAX:
            want = "resident" if gh + gw <= tfa.RES_HW_MAX else "general"
        else:
            want = "global" if gw == tfa.GLOBAL_W else "general"
        assert tfa.k1_route(gh, gw, d, dtype) == want, name
        seen.add(want)
        q = torch.empty(2, n, d, dtype=dtype, device="meta")
        bias_h, bias_w = (torch.empty(2, n, x, device="meta") for x in (gh, gw))
        with pytest.raises(ValueError, match="CUDA device"):
            tfa.flash_attention_2d(q, q, q, bias_h, bias_w, (gh, gw))
    assert seen == ({"resident", "long", "global", "general"} if dtype == torch.bfloat16 else {"general"})


@pytest.mark.parametrize("d", [tfa.GENERAL_D_MAX, tfa.GENERAL_D_MAX + 8])
def test_wrappers_raise_only_above_the_general_head_dim(d):
    """Head dims up to GENERAL_D_MAX reach the launch off the CPU; above it
    both wrappers raise on the head dim; another dtype raises too."""
    q = torch.empty(1, 2, 77, d, dtype=torch.float32, device="meta")
    bias = torch.empty(2, 16, 4, device="meta")
    q1 = torch.empty(2, 16, d, dtype=torch.float32, device="meta")
    match = "CUDA device" if d <= tfa.GENERAL_D_MAX else f"head dim {d}"
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_2d(q1, q1, q1, bias, bias, (4, 4))
    with pytest.raises(TypeError, match="take"):
        tfa.k2_route(77, True, 16, torch.float16)


def test_general_kernel_entry_and_counts():
    """The general route's C entry in the source and its ctypes signature
    (6 pointers, 9 strides, 9 ints, the scale, the stream), behind which G1
    (bf16) and G2 (float32) launch; each wrapper counts its launches by
    route."""
    text = tfa.LIB.source.read_text()
    assert 'extern "C" int ha_flash_attention_general(' in text
    assert "g1_bf16_kernel" in text and "g2_tf32x3_kernel" in text and "general_kernel" not in text
    assert f"constexpr int GEN_D_MAX = {tfa.GENERAL_D_MAX};" in text
    assert f"constexpr int GEN_BQ = {tfa.GENERAL_BQ};" in text
    assert len(tfa.LIB.signatures["ha_flash_attention_general"]) == 6 + 9 + 9 + 2
    assert set(tfa.flash_attention.routes) == {"resident", "long", "general"}
    assert set(tfa.flash_attention_2d.routes) == {"resident", "global", "general"}
    assert tfa.general_grid(6, 257) == {"blocks_per_head": 5, "grid": 30, "dm": 64, "keys_per_tile": 64}


@pytest.mark.parametrize("q8", [False, True], ids=["float", "w8a8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_hd80_encode_image_matches_reference(rng, dtype, q8):
    """A CLIP variant with visual head dim 80 through the port's
    encode_image (K2's wrapper: its plain version on CPU tensors; on the
    card the resident route at D = 80) against the JAX tower, float and
    W8A8 (quantize_clip in both packages, qmm="xla")."""
    jdt, tdt, tol = DTYPES[dtype]
    jv, tv = jclip.CLIPVariant(**CLIP_HD80), tclip.CLIPVariant(**CLIP_HD80)
    assert tv.v_width // tv.v_heads == 80 and tfa.k2_route((32 // 8) ** 2 + 1, False, 80) == "resident"
    params = jclip.init_clip(jax.random.key(2), jv)
    if q8:
        params = jax.tree.map(lambda a: a.astype(jdt), params)
    visual = bridge.clip_from_jax(_np_tree(params), tv, device="cpu", dtype=tdt)
    if q8:
        visual, params = tclip.quantize_clip(visual), jclip.quantize_clip(params)
    img = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    ref = jclip.encode_image(params, jnp.asarray(img), jv, dtype=jdt)
    n0 = tfa.flash_attention.launches
    out = tclip.encode_image(visual, torch.from_numpy(img), impl="flash")
    assert out.dtype == torch.float32 and out.shape == (3, 32)
    assert tfa.flash_attention.launches == n0  # CPU tensors: no kernel launch
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol, rtol=tol)


FEATURE_ATOL = 1e-4


def _synthetic_yaml(save_path):
    """config/synthetic.yaml as it stands, on the single-device Mapper in
    both packages (the tests' 8 host devices would send the JAX build to its
    ShardedMapper, whose instance order differs)."""
    over = [f"main.save_path={save_path}", "pipeline.sharded_mapping=off"]
    return jconfig.load(str(ROOT / "config/synthetic.yaml"), over), tconfig.load(str(ROOT / "config/synthetic.yaml"),
                                                                                 over)


def test_build_map_synthetic_yaml_matches_reference(tmp_path):
    """config/synthetic.yaml's build in the port (float32 test-tiny towers:
    on the card the text tower's K2 takes the general route) against the
    JAX package's, from the same weights."""
    jcfg, _ = _synthetic_yaml(tmp_path / "jax")
    _, tcfg = _synthetic_yaml(tmp_path / "port")
    assert (tcfg.models.clip.dtype, tcfg.models.sam.dtype) == ("float32", "bfloat16")
    jdir = jbuild_map.run(jcfg)
    clip_p, sam_p, cv, sv = jload_models(jcfg)  # the seeded weights the JAX build drew
    np_clip = _np_tree(clip_p)
    models = (bridge.clip_from_jax(np_clip, tclip.VARIANTS[cv.name], device="cpu"),
              bridge.sam_from_jax(_np_tree(sam_p), tsam.VARIANTS[sv.name], device="cpu"),
              tclip.VARIANTS[cv.name], tsam.VARIANTS[sv.name],
              bridge.clip_text_from_jax(np_clip, tclip.VARIANTS[cv.name], device="cpu"))
    tdir, built = build_map.run(tcfg, models=models, device="cpu")
    j, t = JHMSGraph.load(jdir), HMSGraph.load(tdir)
    jstats, tstats = (json.loads((Path(d).parent / "build_stats.json").read_text()) for d in (jdir, tdir))
    for k in ("frames", "scene_points", "instances", "floors", "rooms", "objects", "views"):
        assert tstats[k] == jstats[k], k
    assert len(t.objects) == len(built.objects) > 0
    assert [(r.room_id, r.name) for r in t.rooms] == [(r.room_id, r.name) for r in j.rooms]
    assert [(o.object_id, o.name, o.view_ids) for o in t.objects] == [(o.object_id, o.name, o.view_ids)
                                                                     for o in j.objects]
    assert [(v.view_id, v.img_id) for v in t.views] == [(v.view_id, v.img_id) for v in j.views]
    for a, b in zip(t.objects, j.objects):
        np.testing.assert_allclose(np.asarray(a.embedding), np.asarray(b.embedding), atol=FEATURE_ATOL)
        np.testing.assert_array_equal(np.asarray(a.pcd_points), np.asarray(b.pcd_points))
    for a, b in zip(t.rooms, j.rooms):
        np.testing.assert_allclose(np.asarray(a.embeddings), np.asarray(b.embeddings), atol=FEATURE_ATOL)
