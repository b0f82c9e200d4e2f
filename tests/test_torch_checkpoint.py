"""Port parity of the checkpoint side of the port, against the JAX package
on the same inputs:

- the converters: synthetic official SAM and open_clip state dicts at
  test-tiny, written with ``torch.save``, loaded by both packages'
  ``load_checkpoint`` and by ``load_models`` with the paths set (float and
  W8A8).  Parameters equal exactly (both convert float32 arrays with the same
  transposes; int8 weights and their scales exactly, as
  tests/test_torch_quant.py's bridge test); encoder outputs within 2e-3 in
  float32;
- the hierarchical fold: the port's Mapper against the JAX Mapper, both fed
  the same oracle FrameFeatures (GT masks, one-hot features), so integer
  state (scene rows, instance lanes, coarse keys, signatures) is exact and
  float state within 1e-4 (tests/test_torch_mapping.py's exact-downstream
  setting);
- ``recompute_coarse_keys`` on the JAX mapper state carried by ``bridge.py``:
  exact against the JAX function and against the live keys;
- the mapper-state store: a round trip is exact; a state without
  ``ckeys``/``dsig``, or with the old 2x-coarse widths, reloads equal to the
  JAX package's own ``load_mapper_state`` backfill of the same state;
  ``save_params`` / ``load_params`` round trip exactly;
- the data vocabularies and ``FIXTURE`` equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.apps.common import load_models as jload_models
from holoagent_tpu.config import from_dict as jfrom_dict
from holoagent_tpu.dataloader import SyntheticDataset as JSyntheticDataset
from holoagent_tpu.dataloader import SyntheticScene as JSyntheticScene
from holoagent_tpu.memory import checkpoint as jckpt
from holoagent_tpu.memory import instances as jinst
from holoagent_tpu.memory.mapping import Mapper as JMapper
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import sam as jsam
from holoagent_tpu.perception.oracle import oracle_frame_features as joracle
from holoagent_tpu.utils import labels as jlabels
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.apps.common import load_models
from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.dataloader import SyntheticDataset, SyntheticScene
from holoagent_tpu_torch.memory import checkpoint as tckpt
from holoagent_tpu_torch.memory import instances as tinst
from holoagent_tpu_torch.memory.mapping import Mapper
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.perception.oracle import oracle_frame_features
from holoagent_tpu_torch.training.zoo import fixture_labels
from holoagent_tpu_torch.utils import labels as tlabels

torch.set_num_threads(1)

INT_SCENE = ("key", "sorted_key", "sorted_row", "num", "count", "feat_count")
FLOAT_SCENE = ("sum_pts", "sum_col", "sum_feat")
INT_INST = ("rows", "valid", "count", "ckeys", "ccount", "dsig")
FLOAT_INST = ("feat_sum", "weight", "bbox_min", "bbox_max")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


# ---------------------------------------------------------------------------
# Synthetic checkpoints: the JAX trees exported under the official names
# ---------------------------------------------------------------------------


def _sam_state(p, v):
    """An official ``sam_vit_*.pth`` state dict (torch tensors) holding the
    JAX tree `p`: the inverse of the reference's ``convert_sam`` key map."""
    st = {}

    def lin(prefix, q):
        st[prefix + ".weight"], st[prefix + ".bias"] = q["w"].T, q["b"]

    def attn4(prefix, q):
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            lin(f"{prefix}.{theirs}", q[ours])

    e = p["encoder"]
    for i, b in enumerate(e["blocks"]):
        pre = f"image_encoder.blocks.{i}"
        st[pre + ".norm1.weight"], st[pre + ".norm1.bias"] = b["norm1_g"], b["norm1_b"]
        st[pre + ".norm2.weight"], st[pre + ".norm2.bias"] = b["norm2_g"], b["norm2_b"]
        st[pre + ".attn.rel_pos_h"], st[pre + ".attn.rel_pos_w"] = b["rel_h"], b["rel_w"]
        lin(pre + ".attn.qkv", b["qkv"])
        lin(pre + ".attn.proj", b["proj"])
        lin(pre + ".mlp.lin1", b["lin1"])
        lin(pre + ".mlp.lin2", b["lin2"])
    st["image_encoder.patch_embed.proj.weight"] = e["patch_w"].reshape(v.patch, v.patch, 3, v.width).transpose(3, 2, 0, 1)
    st["image_encoder.patch_embed.proj.bias"] = e["patch_b"]
    st["image_encoder.pos_embed"] = e["pos"][None]
    st["image_encoder.neck.0.weight"] = e["neck_conv1"].transpose(3, 2, 0, 1)
    st["image_encoder.neck.2.weight"] = e["neck_conv2"].transpose(3, 2, 0, 1)
    for i, name in ((1, "neck_ln1"), (3, "neck_ln2")):
        st[f"image_encoder.neck.{i}.weight"], st[f"image_encoder.neck.{i}.bias"] = e[name + "_g"], e[name + "_b"]
    pr = p["prompt"]
    st["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = pr["gauss"].T
    st["prompt_encoder.point_embeddings.0.weight"] = pr["point_neg"][None]
    st["prompt_encoder.point_embeddings.1.weight"] = pr["point_pos"][None]
    st["prompt_encoder.not_a_point_embed.weight"] = pr["not_a_point"][None]
    st["prompt_encoder.no_mask_embed.weight"] = pr["no_mask"][None]
    d = p["decoder"]
    st["mask_decoder.iou_token.weight"] = d["iou_token"][None]
    st["mask_decoder.mask_tokens.weight"] = d["mask_tokens"]
    for i, ly in enumerate(d["layers"]):
        pre = f"mask_decoder.transformer.layers.{i}"
        attn4(pre + ".self_attn", ly["self_attn"])
        attn4(pre + ".cross_attn_token_to_image", ly["cross_t2i"])
        attn4(pre + ".cross_attn_image_to_token", ly["cross_i2t"])
        lin(pre + ".mlp.lin1", ly["mlp1"])
        lin(pre + ".mlp.lin2", ly["mlp2"])
        for j in range(1, 5):
            st[f"{pre}.norm{j}.weight"], st[f"{pre}.norm{j}.bias"] = ly[f"norm{j}_g"], ly[f"norm{j}_b"]
    attn4("mask_decoder.transformer.final_attn_token_to_image", d["final_t2i"])
    st["mask_decoder.transformer.norm_final_attn.weight"] = d["norm_final_g"]
    st["mask_decoder.transformer.norm_final_attn.bias"] = d["norm_final_b"]
    st["mask_decoder.output_upscaling.0.weight"] = d["up1_w"].transpose(2, 3, 0, 1)
    st["mask_decoder.output_upscaling.0.bias"] = d["up1_b"]
    st["mask_decoder.output_upscaling.1.weight"], st["mask_decoder.output_upscaling.1.bias"] = d["up_ln_g"], d["up_ln_b"]
    st["mask_decoder.output_upscaling.3.weight"] = d["up2_w"].transpose(2, 3, 0, 1)
    st["mask_decoder.output_upscaling.3.bias"] = d["up2_b"]
    for i, h in enumerate(d["hyper"]):
        for j in range(3):
            lin(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}", h[f"l{j + 1}"])
    for j in range(3):
        lin(f"mask_decoder.iou_prediction_head.layers.{j}", d["iou_head"][f"l{j + 1}"])
    return {k: torch.from_numpy(np.array(a, np.float32)) for k, a in st.items()}


def _open_clip_state(p, v):
    """An open_clip state dict (torch tensors) holding the JAX tree `p`
    (tests/test_clip.py's exporter)."""
    vis, txt = p["visual"], p["text"]
    st = {
        "visual.conv1.weight": vis["patch_w"].reshape(v.patch, v.patch, 3, v.v_width).transpose(3, 2, 0, 1),
        "visual.class_embedding": vis["cls"], "visual.positional_embedding": vis["pos"],
        "visual.ln_pre.weight": vis["ln_pre_g"], "visual.ln_pre.bias": vis["ln_pre_b"],
        "visual.ln_post.weight": vis["ln_post_g"], "visual.ln_post.bias": vis["ln_post_b"], "visual.proj": vis["proj"],
        "token_embedding.weight": txt["tok_emb"], "positional_embedding": txt["pos"],
        "ln_final.weight": txt["ln_final_g"], "ln_final.bias": txt["ln_final_b"], "text_projection": txt["proj"],
        "logit_scale": p["logit_scale"],
    }
    names = {"ln1_g": "ln_1.weight", "ln1_b": "ln_1.bias", "wqkv": "attn.in_proj_weight", "bqkv": "attn.in_proj_bias",
             "wo": "attn.out_proj.weight", "bo": "attn.out_proj.bias", "ln2_g": "ln_2.weight", "ln2_b": "ln_2.bias",
             "w1": "mlp.c_fc.weight", "b1": "mlp.c_fc.bias", "w2": "mlp.c_proj.weight", "b2": "mlp.c_proj.bias"}
    for prefix, blocks, layers in (("visual.transformer.resblocks", vis["blocks"], v.v_layers),
                                   ("transformer.resblocks", txt["blocks"], v.t_layers)):
        for i in range(layers):
            for ours, theirs in names.items():
                a = blocks[ours][i]
                st[f"{prefix}.{i}.{theirs}"] = a.T if ours in ("wqkv", "wo", "w1", "w2") else a
    return {k: torch.from_numpy(np.array(a, np.float32)) for k, a in st.items()}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """test-tiny SAM and CLIP checkpoints on disk (the CLIP one as a trainer
    saves it: under ``state_dict``, keys prefixed ``module.``), and the JAX
    trees they hold."""
    d = tmp_path_factory.mktemp("ckpt")
    sv, cv = jsam.VARIANTS["test-tiny"], jclip.VARIANTS["test-tiny"]
    sam_p, clip_p = _np_tree(jsam.init_sam(jax.random.key(5), sv)), _np_tree(jclip.init_clip(jax.random.key(6), cv))
    torch.save(_sam_state(sam_p, sv), d / "sam.pth")
    torch.save({"state_dict": {f"module.{k}": t for k, t in _open_clip_state(clip_p, cv).items()}}, d / "clip.bin")
    return d, sam_p, clip_p


def test_convert_sam_matches_reference(checkpoints, rng):
    d, sam_p, _ = checkpoints
    v = tsam.VARIANTS["test-tiny"]
    ref = _np_tree(jsam.load_checkpoint(str(d / "sam.pth"), jsam.VARIANTS["test-tiny"]))
    sam = tsam.load_checkpoint(str(d / "sam.pth"), v, device="cpu")
    flat = _flat(ref)
    mine = dict(sam.named_parameters())
    assert mine.keys() == flat.keys()
    for k, p in mine.items():
        np.testing.assert_array_equal(p.numpy(), flat[k], err_msg=k)
        np.testing.assert_array_equal(p.numpy(), _flat(sam_p)[k], err_msg=k)  # the exported tree, back
    img = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    out = tsam.encode_image(sam.encoder, torch.from_numpy(img), v)
    want = jsam.encode_image(ref["encoder"], jnp.asarray(img), jsam.VARIANTS["test-tiny"], dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


def test_convert_open_clip_matches_reference(checkpoints, rng):
    d, _, clip_p = checkpoints
    v = tclip.VARIANTS["test-tiny"]
    jv = jclip.VARIANTS["test-tiny"]
    ref = _np_tree(jclip.load_checkpoint(str(d / "clip.bin"), jv))
    visual, text = tclip.load_checkpoint(str(d / "clip.bin"), v, device="cpu")
    for tower, tree in ((visual, ref["visual"]), (text, ref["text"])):
        stacked = tree["blocks"]
        for k, p in tower.named_parameters():
            parts = k.split(".")
            want = stacked[parts[2]][int(parts[1])] if parts[0] == "blocks" else tree[k]
            np.testing.assert_array_equal(p.numpy(), want, err_msg=k)
    img = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(tclip.encode_image(visual, torch.from_numpy(img)).numpy(),
                               np.asarray(jclip.encode_image(ref, jnp.asarray(img), jv, dtype=jnp.float32)),
                               atol=2e-3, rtol=2e-3)
    tokens = rng.integers(1, 400, (2, 77)).astype(np.int32)
    tokens[:, 5] = 49407  # <eot>
    np.testing.assert_allclose(tclip.encode_text(text, torch.from_numpy(tokens)).numpy(),
                               np.asarray(jclip.encode_text(ref, jnp.asarray(tokens), jv, dtype=jnp.float32)),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("quant", [False, True])
def test_load_models_with_checkpoint_paths(checkpoints, quant):
    """load_models takes the checkpoint branches in the reference's order:
    convert, then quantize (from the float32 values) when ``quant`` is set.
    Every tower equals the JAX load_models' carried by bridge.py."""
    d = checkpoints[0]
    models = {"clip": {"type": "test-tiny", "dtype": "float32", "quant": quant, "checkpoint": str(d / "clip.bin")},
              "sam": {"type": "test-tiny", "dtype": "float32", "quant": quant, "checkpoint": str(d / "sam.pth")}}
    clip, sam, cv, sv, text = load_models(from_dict({"models": models}), device="cpu")
    jclip_p, jsam_p, _, _ = jload_models(jfrom_dict({"models": models}))
    assert (clip.quant, sam.quant) == (quant, quant) and cv.name == sv.name == "test-tiny"
    want = {"clip": bridge.clip_from_jax(_np_tree(jclip_p), cv, device="cpu"),
            "sam": bridge.sam_from_jax(_np_tree(jsam_p), sv, device="cpu"),
            "text": bridge.clip_text_from_jax(_np_tree(jclip_p), cv, device="cpu")}
    for name, got in (("clip", clip), ("sam", sam), ("text", text)):
        theirs = dict(want[name].named_parameters())
        mine = dict(got.named_parameters())
        assert mine.keys() == theirs.keys(), name
        for k, p in mine.items():
            assert p.dtype == theirs[k].dtype and torch.equal(p, theirs[k]), f"{name}.{k}"


# ---------------------------------------------------------------------------
# The hierarchical fold, recompute_coarse_keys, the mapper-state store
# ---------------------------------------------------------------------------

FOLD_CFG = {
    "main": {"depth_cut": 10.0},
    "models": {"clip": {"type": "test-tiny", "dtype": "float32"}},
    "pipeline": {"merge_type": "hierarchical", "voxel_size": 0.1, "skip_frames": 1, "point_capacity": 1 << 15,
                 "mask_point_capacity": 1024, "instance_capacity": 64},
}
FOLD_FRAMES = 7  # the first 7 of 8 poses: a binary counter left with sets at heights 0-2 for finalize to drain


@pytest.fixture(scope="module")
def fold():
    """Both Mappers with merge_type="hierarchical" over the same oracle
    FrameFeatures of the two_room scene, finalized."""
    labels = SyntheticScene.two_room().labels()
    ds = SyntheticDataset(scene=SyntheticScene.two_room(), num_frames=8, hw=(60, 80), seed=0)
    jds = JSyntheticDataset(scene=JSyntheticScene.two_room(), num_frames=8, hw=(60, 80), seed=0)
    jm = JMapper(jfrom_dict(FOLD_CFG), None, None)
    tm = Mapper(from_dict(FOLD_CFG), device="cpu")
    heights = []
    for i in range(FOLD_FRAMES):
        inst, lab = jds.gt(i)
        jm.process_frame(jds[i], ff=joracle(inst, lab, labels, 32, max_masks=8))
        tm.process_frame(ds[i], ff=oracle_frame_features(inst, lab, labels, 32, max_masks=8, device="cpu"))
        heights.append(sorted(tm._hier_slots))
    assert sorted(jm._hier_slots) == heights[-1] == [0, 1, 2]
    return jm.finalize(), tm.finalize(), heights


def _compare(ms_t, ms_j, tol):
    sj, ij = _np_tree(ms_j.scene), _np_tree(ms_j.instances)
    for name in INT_SCENE:
        np.testing.assert_array_equal(getattr(ms_t.scene, name).numpy(), getattr(sj, name), err_msg=name)
    for name in FLOAT_SCENE:
        np.testing.assert_allclose(getattr(ms_t.scene, name).numpy(), getattr(sj, name), atol=tol, err_msg=name)
    for name in INT_INST:
        np.testing.assert_array_equal(getattr(ms_t.instances, name).numpy(), getattr(ij, name), err_msg=name)
    for name in FLOAT_INST:
        np.testing.assert_allclose(getattr(ms_t.instances, name).numpy(), getattr(ij, name), atol=tol, err_msg=name)


def test_hierarchical_fold_matches_reference(fold):
    ms_j, ms_t, heights = fold
    assert heights[:4] == [[0], [1], [0, 1], [2]]  # the binary counter's carries
    assert int(ms_t.instances.num()) > 3
    _compare(ms_t, ms_j, 1e-4)
    np.testing.assert_allclose(ms_t.instance_feats.numpy(), np.asarray(ms_j.instance_feats), atol=1e-4)


def test_recompute_coarse_keys_matches_reference(fold):
    """From the JAX state with its coarse keys wiped, through bridge.py:
    the port rebuilds the JAX function's sets, which are the live ones."""
    ms_j, ms_t, _ = fold
    sj = _np_tree(ms_j.scene)
    ij = _np_tree(ms_j.instances)
    scene = bridge.scene_from_numpy(sj, "cpu")
    inst = bridge.instances_from_numpy(ij, "cpu")
    wiped = inst._replace(ckeys=torch.full_like(inst.ckeys, 2**31 - 1), ccount=torch.zeros_like(inst.ccount),
                          dsig=torch.zeros_like(inst.dsig))
    got = tinst.recompute_coarse_keys(scene, wiped)
    want = _np_tree(jinst.recompute_coarse_keys(ms_j.scene, ms_j.instances))
    for name in ("ckeys", "ccount", "dsig"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), err_msg=name)
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(ij, name), err_msg=f"live {name}")


def test_mapper_state_round_trip(fold, tmp_path):
    _, ms_t, _ = fold
    tckpt.save_mapper_state(tmp_path / "state.pt", ms_t.scene, ms_t.instances)
    scene, inst = tckpt.load_mapper_state(tmp_path / "state.pt", device="cpu")
    assert scene.grid == ms_t.scene.grid
    for a, b in ((scene, ms_t.scene), (inst, ms_t.instances)):
        for name, x in a._asdict().items():
            if name != "grid":
                assert x.dtype == getattr(b, name).dtype and torch.equal(x, getattr(b, name)), name


@pytest.mark.parametrize("stale", ["no_coarse_keys", "coarse_2x_widths"])
def test_mapper_state_backfill_matches_reference(fold, tmp_path, stale):
    """A state saved before the coarse-key upgrade (no ckeys/ccount/dsig) or
    with the 2x-coarse widths (ckeys half as wide, dsig of another width):
    the JAX package's orbax store and the port's store each reload it with
    the coarse keys recomputed, and the two agree exactly."""
    import orbax.checkpoint as ocp

    ms_j, _, _ = fold
    scene_j = ms_j.scene._asdict()
    inst_j = dict(ms_j.instances._asdict())
    k_cap = inst_j["rows"].shape[1]
    if stale == "no_coarse_keys":
        for name in ("ckeys", "ccount", "dsig"):
            del inst_j[name]
    else:
        inst_j["ckeys"] = inst_j["ckeys"][:, : k_cap // 2]
        inst_j["dsig"] = inst_j["dsig"][:, :1024]
    ckptr = ocp.StandardCheckpointer()
    ckptr.save((tmp_path / "jax").resolve(), {"scene": scene_j, "instances": inst_j}, force=True)
    ckptr.wait_until_finished()
    js, ji = jckpt.load_mapper_state(tmp_path / "jax")
    grid = scene_j["grid"]
    torch.save({
        "scene": {"grid": {"voxel_size": float(np.asarray(grid.voxel_size)),
                           "origin": [float(c) for c in np.asarray(grid.origin)]},
                  **{k: torch.from_numpy(np.array(a)) for k, a in scene_j.items() if k != "grid"}},
        "instances": {k: torch.from_numpy(np.array(a)) for k, a in inst_j.items()},
    }, tmp_path / "state.pt")
    scene, inst = tckpt.load_mapper_state(tmp_path / "state.pt", device="cpu")
    ji, live = _np_tree(ji), _np_tree(ms_j.instances)
    for name in ("rows", "count", "valid", "ckeys", "ccount", "dsig"):
        np.testing.assert_array_equal(getattr(inst, name).numpy(), getattr(ji, name), err_msg=name)
        np.testing.assert_array_equal(getattr(inst, name).numpy(), getattr(live, name), err_msg=f"live {name}")
    np.testing.assert_array_equal(scene.key.numpy(), np.asarray(js.key))


def test_params_round_trip(tmp_path):
    """A module's parameters, and a quantized one's (int8 weights, float32
    scales), come back exactly, each in its dtype."""
    sam = tsam.init_sam(tsam.VARIANTS["test-tiny"], seed=3, device="cpu")
    for name, model in (("sam", sam), ("sam_q8", tsam.quantize_sam(sam))):
        tckpt.save_params(tmp_path / f"{name}.pt", model)
        flat = tckpt.load_params(tmp_path / f"{name}.pt", device="cpu")
        mine = dict(model.named_parameters())
        assert flat.keys() == mine.keys()
        for k, p in mine.items():
            assert flat[k].dtype == p.dtype and torch.equal(flat[k], p), k


@pytest.mark.parametrize("name", ["HM3DSEM", "FIXTURE", "fixture", "MATTERPORT80", "COCO_STUFF", "HM3DSEM_ROOMS",
                                  "IMAGENET21K", "OPENVOCAB_MATTERPORT"])
def test_data_vocabularies_match_reference(name):
    got = tlabels.load_vocabulary(name)
    assert got == jlabels.load_vocabulary(name) and len(got) > 0
    if name.upper() == "FIXTURE":
        assert list(got) == fixture_labels() and got[-1] == "background"
