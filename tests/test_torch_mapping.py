"""The slice as a whole: the port's Mapper against the JAX Mapper at
test_mapping.py's tiny operating point, with the production fold settings
(merge_type="paired", extract_tiering=True) and a full merge round every
2 frames.  The JAX side extracts with impl="xla", the plain reference of its
Pallas kernels (which cannot run un-interpreted on the CPU).

(a) Exact downstream: both mappers take the JAX extractor's FrameFeatures;
    integer state must match bit for bit, float state within 1e-4.
(b) End to end: both run their own towers (the same weights, bridged).
"""

import jax
import numpy as np
import pytest
import torch

from holoagent_tpu.config import from_dict as jfrom_dict
from holoagent_tpu.dataloader import SyntheticDataset as JSyntheticDataset
from holoagent_tpu.memory.mapping import Mapper as JMapper
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import sam as jsam
from holoagent_tpu.perception.extractor import extract_frame_features_tiered
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.dataloader import SyntheticDataset
from holoagent_tpu_torch.memory.mapping import Mapper
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

CFG = {
    "main": {"depth_cut": 20.0},
    "models": {
        "clip": {"type": "test-tiny", "dtype": "float32"},
        "sam": {
            "type": "test-tiny",
            "points_per_side": 4,
            "pred_iou_thresh": -10.0,
            "stability_score_thresh": 0.0,
            "min_mask_region_area": 20,
            "max_masks": 8,
        },
    },
    "pipeline": {
        "voxel_size": 0.1,
        "skip_frames": 2,
        "point_capacity": 1 << 15,
        "mask_point_capacity": 512,
        "instance_capacity": 64,
        "instance_max_area_frac": 1.0,
        "merge_type": "paired",
        "extract_tiering": True,
        "paired_full_round_every": 2,
    },
}
INT_SCENE = ("key", "sorted_key", "sorted_row", "num", "count", "feat_count")
FLOAT_SCENE = ("sum_pts", "sum_col", "sum_feat")
INT_INST = ("rows", "valid", "count", "ckeys", "ccount", "dsig")
FLOAT_INST = ("feat_sum", "weight", "bbox_min", "bbox_max")


@pytest.fixture(scope="module")
def setup():
    clip_p = jclip.init_clip(jax.random.key(0), jclip.VARIANTS["test-tiny"])
    sam_p = jsam.init_sam(jax.random.key(1), jsam.VARIANTS["test-tiny"])
    np_clip, np_sam = jax.tree.map(np.asarray, clip_p), jax.tree.map(np.asarray, sam_p)
    clip_t = bridge.clip_from_jax(np_clip, tclip.VARIANTS["test-tiny"], device="cpu")
    sam_t = bridge.sam_from_jax(np_sam, tsam.VARIANTS["test-tiny"], device="cpu")
    ds = SyntheticDataset(num_frames=8, hw=(48, 64))
    jds = JSyntheticDataset(num_frames=8, hw=(48, 64))
    return clip_p, sam_p, clip_t, sam_t, ds, jds


def _jax_features(jm, frame):
    """The FrameFeatures the JAX Mapper's staged step extracts."""
    c = jm.cfg
    return extract_frame_features_tiered(
        jm.clip_params, jm.sam_params, jax.numpy.asarray(frame.rgb), jm.clip_variant, jm.sam_variant,
        points_per_side=c.models.sam.points_per_side, pred_iou_thresh=c.models.sam.pred_iou_thresh,
        stability_thresh=c.models.sam.stability_score_thresh,
        min_area=float(c.models.sam.min_mask_region_area), max_masks=c.models.sam.max_masks,
        masked_weight=c.pipeline.clip_masked_weight, bbox_margin=float(c.pipeline.clip_bbox_margin),
        dtype=jm._dtype, impl="xla", clip_impl="xla",
    )


def _compare(ms_t, ms_j, float_tol):
    sj = jax.tree.map(np.asarray, ms_j.scene)
    for name in INT_SCENE:
        np.testing.assert_array_equal(getattr(ms_t.scene, name).numpy(), getattr(sj, name), err_msg=name)
    for name in FLOAT_SCENE:
        np.testing.assert_allclose(getattr(ms_t.scene, name).numpy(), getattr(sj, name), atol=float_tol, err_msg=name)
    ij = jax.tree.map(np.asarray, ms_j.instances)
    for name in INT_INST:
        np.testing.assert_array_equal(getattr(ms_t.instances, name).numpy(), getattr(ij, name), err_msg=name)
    for name in FLOAT_INST:
        np.testing.assert_allclose(getattr(ms_t.instances, name).numpy(), getattr(ij, name), atol=float_tol, err_msg=name)
    np.testing.assert_allclose(ms_t.instance_feats.numpy(), np.asarray(ms_j.instance_feats), atol=float_tol)
    np.testing.assert_array_equal(ms_t.density_keep.numpy(), np.asarray(ms_j.density_keep))


@pytest.mark.parametrize("merge_type", ["paired", "sequential"])
def test_exact_downstream_given_the_same_frame_features(setup, merge_type):
    clip_p, sam_p, clip_t, sam_t, ds, jds = setup
    cfg = {**CFG, "pipeline": {**CFG["pipeline"], "merge_type": merge_type}}
    jm = JMapper(jfrom_dict(cfg), clip_p, sam_p)
    tm = Mapper(from_dict(cfg), clip_t, sam_t, device="cpu")
    for i in range(0, len(ds), CFG["pipeline"]["skip_frames"]):
        ff = _jax_features(jm, jds[i])
        jm.process_frame(jds[i], ff=ff)
        tm.process_frame(ds[i], ff=bridge.features_from_numpy(jax.tree.map(np.asarray, ff), "cpu"))
    ms_j, ms_t = jm.finalize(), tm.finalize()
    assert int(ms_t.instances.num()) > 0 and int(ms_t.scene.num) > 500
    _compare(ms_t, ms_j, 1e-4)
    np.testing.assert_allclose(ms_t.keyframe_feats.numpy(), np.asarray(ms_j.keyframe_feats), atol=1e-6)


def test_end_to_end_run(setup):
    """Both mappers run their own extraction.  The backprojection is bit
    identical and the masks threshold float logits that agree to ~1e-5 at
    this size, so the whole MappedScene agrees: integers exactly, floats
    within 2e-3 (float32 tower tolerance)."""
    clip_p, sam_p, clip_t, sam_t, ds, jds = setup
    n1, n2 = tfa.flash_attention.launches, tfa.flash_attention_2d.launches
    ms_j = JMapper(jfrom_dict(CFG), clip_p, sam_p).run(jds)
    ms_t = Mapper(from_dict(CFG), clip_t, sam_t, device="cpu").run(ds)
    assert (tfa.flash_attention.launches, tfa.flash_attention_2d.launches) == (n1, n2)
    np.testing.assert_allclose(ms_t.keyframe_feats.numpy(), np.asarray(ms_j.keyframe_feats), atol=2e-3)
    assert int(ms_t.instances.num()) == int(ms_j.instances.num()) > 0
    _compare(ms_t, ms_j, 2e-3)


def test_mapper_rules(setup):
    _, _, clip_t, sam_t, ds, _ = setup
    # the hierarchical fold and batched extraction are ported: both configure a Mapper
    # (tests/test_torch_checkpoint.py and tests/test_torch_batched.py hold them to the reference)
    hier = Mapper(from_dict({**CFG, "pipeline": {"merge_type": "hierarchical", "extract_frames_per_dispatch": 2}}),
                  clip_t, sam_t, device="cpu")
    assert hier.cfg.pipeline.merge_type == "hierarchical" and hier._hier_slots == {}
    bf16 = {**CFG, "models": {**CFG["models"], "clip": {"type": "test-tiny", "dtype": "bfloat16"}}}
    with pytest.raises(ValueError):
        Mapper(from_dict(bf16), clip_t, sam_t, device="cpu")


def test_fused_frame_step_matches_reference(setup):
    """``pipeline.fused_frame_step`` with the sequential fold: the JAX
    Mapper runs its one-program ``frame_step`` (untiered extraction), the
    port's Mapper its staged path untiered, each on its own towers (the
    same weights, bridged)."""
    clip_p, sam_p, clip_t, sam_t, ds, jds = setup
    cfg = {**CFG, "pipeline": {**CFG["pipeline"], "merge_type": "sequential", "fused_frame_step": True}}
    ms_j = JMapper(jfrom_dict(cfg), clip_p, sam_p).run(jds)
    ms_t = Mapper(from_dict(cfg), clip_t, sam_t, device="cpu").run(ds)
    assert int(ms_t.instances.num()) == int(ms_j.instances.num()) > 0
    _compare(ms_t, ms_j, 2e-3)
