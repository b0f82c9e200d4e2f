"""Port parity of batched extraction at test_mapping.py's tiny operating
point (test-tiny towers, float32, JAX weights carried by bridge.py):

- ``extract_frames_batched`` over 2 frames against the JAX package's (a
  vmap of its single-pass extraction, impl="xla": the plain references of
  its Pallas kernels): masks, validity and boxes exact, features within
  2e-3 (the float32 tower tolerance); and frame by frame against the port's
  own ``extract_frame_features`` (the same code at another batch size:
  integers exact, features within 1e-5);
- ``Mapper.run`` with ``extract_frames_per_dispatch`` = 2 over 5 keyframes
  (two batched pairs and a leftover single frame, which is extracted
  tiered): against the JAX Mapper's batched run (integer state exact, float
  state within 2e-3, as tests/test_torch_mapping.py::test_end_to_end_run),
  and against the port's own run at 1 (integer state exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.config import from_dict as jfrom_dict
from holoagent_tpu.dataloader import SyntheticDataset as JSyntheticDataset
from holoagent_tpu.memory.mapping import Mapper as JMapper
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import sam as jsam
from holoagent_tpu.perception import extractor as jext
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.dataloader import SyntheticDataset
from holoagent_tpu_torch.memory import mapping as tmapping
from holoagent_tpu_torch.memory.mapping import Mapper
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.ops import flash_attention as tfa
from holoagent_tpu_torch.perception import extractor as text

torch.set_num_threads(1)

CFG = {
    "main": {"depth_cut": 20.0},
    "models": {
        "clip": {"type": "test-tiny", "dtype": "float32"},
        "sam": {"type": "test-tiny", "points_per_side": 4, "pred_iou_thresh": -10.0, "stability_score_thresh": 0.0,
                "min_mask_region_area": 20, "max_masks": 8},
    },
    "pipeline": {"voxel_size": 0.1, "skip_frames": 2, "point_capacity": 1 << 15, "mask_point_capacity": 512,
                 "instance_capacity": 64, "instance_max_area_frac": 1.0, "merge_type": "paired",
                 "extract_tiering": True, "paired_full_round_every": 2, "extract_frames_per_dispatch": 2},
}
KW = dict(points_per_side=4, pred_iou_thresh=-10.0, stability_thresh=0.0, min_area=20.0, max_masks=8)
INT_SCENE = ("key", "sorted_key", "sorted_row", "num", "count", "feat_count")
FLOAT_SCENE = ("sum_pts", "sum_col", "sum_feat")
INT_INST = ("rows", "valid", "count", "ckeys", "ccount", "dsig")
FLOAT_INST = ("feat_sum", "weight", "bbox_min", "bbox_max")


@pytest.fixture(scope="module")
def setup():
    clip_p = jclip.init_clip(jax.random.key(0), jclip.VARIANTS["test-tiny"])
    sam_p = jsam.init_sam(jax.random.key(1), jsam.VARIANTS["test-tiny"])
    clip_t = bridge.clip_from_jax(jax.tree.map(np.asarray, clip_p), tclip.VARIANTS["test-tiny"], device="cpu")
    sam_t = bridge.sam_from_jax(jax.tree.map(np.asarray, sam_p), tsam.VARIANTS["test-tiny"], device="cpu")
    ds = SyntheticDataset(num_frames=10, hw=(48, 64))
    jds = JSyntheticDataset(num_frames=10, hw=(48, 64))
    return clip_p, sam_p, clip_t, sam_t, ds, jds


def test_extract_frames_batched_matches_reference(setup):
    clip_p, sam_p, clip_t, sam_t, ds, _ = setup
    imgs = np.stack([ds[0].rgb, ds[4].rgb]).astype(np.float32)
    ref = jax.tree.map(np.asarray, jext.extract_frames_batched(
        clip_p, sam_p, jnp.asarray(imgs), jclip.VARIANTS["test-tiny"], jsam.VARIANTS["test-tiny"],
        dtype=jnp.float32, **KW))
    n1, n2 = tfa.flash_attention.launches, tfa.flash_attention_2d.launches
    out = text.extract_frames_batched(clip_t, sam_t, torch.from_numpy(imgs), impl="flash", clip_impl="flash", **KW)
    assert (tfa.flash_attention.launches, tfa.flash_attention_2d.launches) == (n1, n2)  # CPU: no launch
    assert out.masks.shape == (2, 8, 48, 64) and out.f_masks.shape == (2, 8, 32) and out.f_global.shape == (2, 32)
    for name in ("masks", "valid", "boxes"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), getattr(ref, name), err_msg=name)
    assert ref.valid.sum(axis=1).min() >= 1  # every frame keeps a mask (one, under these random weights)
    np.testing.assert_allclose(out.f_masks.numpy(), ref.f_masks, atol=2e-3)
    np.testing.assert_allclose(out.f_global.numpy(), ref.f_global, atol=2e-3)
    for j in range(2):
        one = text.extract_frame_features(clip_t, sam_t, torch.from_numpy(imgs[j]), **KW)
        for name in ("masks", "valid", "boxes"):
            assert torch.equal(getattr(one, name), getattr(out, name)[j]), name
        np.testing.assert_allclose(out.f_masks[j].numpy(), one.f_masks.numpy(), atol=1e-5)
        np.testing.assert_allclose(out.f_global[j].numpy(), one.f_global.numpy(), atol=1e-5)


def _compare(ms_t, ms_j, float_tol):
    sj, ij = jax.tree.map(np.asarray, ms_j.scene), jax.tree.map(np.asarray, ms_j.instances)
    for name in INT_SCENE:
        np.testing.assert_array_equal(getattr(ms_t.scene, name).numpy(), getattr(sj, name), err_msg=name)
    for name in FLOAT_SCENE:
        np.testing.assert_allclose(getattr(ms_t.scene, name).numpy(), getattr(sj, name), atol=float_tol, err_msg=name)
    for name in INT_INST:
        np.testing.assert_array_equal(getattr(ms_t.instances, name).numpy(), getattr(ij, name), err_msg=name)
    for name in FLOAT_INST:
        np.testing.assert_allclose(getattr(ms_t.instances, name).numpy(), getattr(ij, name), atol=float_tol,
                                   err_msg=name)


def test_mapper_run_batched_matches_reference(setup, monkeypatch):
    """Keyframes 0, 2, 4, 6, 8 at bsz 2: (0, 2) and (4, 6) batched, 8 alone
    (tiered).  The port's batched run against the JAX package's, and
    against its own run at bsz 1."""
    clip_p, sam_p, clip_t, sam_t, ds, jds = setup
    calls = []

    def counting(clip, sam, images, **kw):
        calls.append(images.shape[0])
        return text.extract_frames_batched(clip, sam, images, **kw)

    monkeypatch.setattr(tmapping, "extract_frames_batched", counting)
    ms_t = Mapper(from_dict(CFG), clip_t, sam_t, device="cpu").run(ds)
    monkeypatch.undo()
    assert calls == [2, 2] and len(ms_t.keyframes) == 5
    ms_j = JMapper(jfrom_dict(CFG), clip_p, sam_p).run(jds)
    assert int(ms_t.instances.num()) == int(ms_j.instances.num()) > 0
    np.testing.assert_allclose(ms_t.keyframe_feats.numpy(), np.asarray(ms_j.keyframe_feats), atol=2e-3)
    _compare(ms_t, ms_j, 2e-3)
    one = {**CFG, "pipeline": {**CFG["pipeline"], "extract_frames_per_dispatch": 1}}
    ms_1 = Mapper(from_dict(one), clip_t, sam_t, device="cpu").run(ds)
    for name in INT_SCENE:
        assert torch.equal(getattr(ms_t.scene, name), getattr(ms_1.scene, name)), name
    for name in INT_INST:
        assert torch.equal(getattr(ms_t.instances, name), getattr(ms_1.instances, name)), name
    np.testing.assert_allclose(ms_t.keyframe_feats.numpy(), ms_1.keyframe_feats.numpy(), atol=1e-5)
