"""Port parity of the mapping path's ops: the same numpy inputs through the
JAX function and its holoagent_tpu_torch counterpart.  Integer outputs are
held bit for bit; float sums within 1e-5 (another summation order)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.memory import instances as jinst
from holoagent_tpu.memory import scene as jscene
from holoagent_tpu.ops import compact as jcompact
from holoagent_tpu.ops import crop_resize as jcrop
from holoagent_tpu.ops import density as jdensity
from holoagent_tpu.ops import features as jfeatures
from holoagent_tpu.ops import masks as jmasks
from holoagent_tpu.ops import voxel as jvoxel
from holoagent_tpu.ops.backproject import backproject as jbackproject
from holoagent_tpu.utils import camera as jcamera
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.ops import _cuda_build as cuda_build
from holoagent_tpu_torch.memory import instances as tinst
from holoagent_tpu_torch.memory import scene as tscene
from holoagent_tpu_torch.ops import compact as tcompact
from holoagent_tpu_torch.ops import crop_resize as tcrop
from holoagent_tpu_torch.ops import density as tdensity
from holoagent_tpu_torch.ops import features as tfeatures
from holoagent_tpu_torch.ops import masks as tmasks
from holoagent_tpu_torch.ops import voxel as tvoxel
from holoagent_tpu_torch.ops.backproject import backproject as tbackproject
from holoagent_tpu_torch.ops.resize import resize as tresize
from holoagent_tpu_torch.utils import camera as tcamera
from tests._nms_cases import NMS_CASE_NAMES, NMS_FAULTS, nms_case, nms_with_fault

torch.set_num_threads(1)
T = torch.from_numpy
K = np.array([[60.0, 0, 31.5], [0, 60.0, 23.5], [0, 0, 1]], np.float32)


def _np(x):
    return np.asarray(x)


def _pose(rng):
    a = rng.uniform(0, 2 * np.pi)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    pose[:3, 3] = rng.uniform(-2, 2, 3)
    return pose


def _frame(rng, h=48, w=64):
    depth = rng.uniform(0.5, 6.0, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.1] = 0.0
    rgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    return depth, rgb, _pose(rng)


def _points(rng, n=2000, spread=1.5):
    pts = rng.normal(0, spread, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    return pts, valid


# -- camera / backprojection -------------------------------------------------


def test_camera_project(rng):
    cam_j = jcamera.Pinhole.from_matrix(K)
    cam_t = tcamera.Pinhole.from_matrix(K)
    assert tuple(cam_t) == tuple(float(x) for x in cam_j)
    pts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    pts[:, 2] += 2.0
    uv_j, z_j = jcamera.project(jnp.asarray(pts), cam_j)
    uv_t, z_t = tcamera.project(T(pts), cam_t)
    np.testing.assert_allclose(uv_t.numpy(), _np(uv_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(z_t.numpy(), _np(z_j))


def test_backproject(rng):
    depth, rgb, pose = _frame(rng)
    pj, cj, vj = jbackproject(
        jnp.asarray(depth), jnp.asarray(rgb), jcamera.Pinhole.from_matrix(K), jnp.asarray(pose), 1e-3, 5.0
    )
    pt, ct, vt = tbackproject(T(depth), T(rgb), tcamera.Pinhole.from_matrix(K), T(pose), 1e-3, 5.0)
    np.testing.assert_array_equal(vt.numpy(), _np(vj))
    np.testing.assert_allclose(pt.numpy(), _np(pj), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ct.numpy(), _np(cj))


# -- voxel / compact ---------------------------------------------------------


def test_voxel_keys_and_cells(rng):
    pts, valid = _points(rng)
    gj = jvoxel.GridSpec.centered(0.1)
    gt = tvoxel.GridSpec.centered(0.1)
    assert gt == bridge.grid_from_numpy(jax.tree.map(np.asarray, gj))
    cj = jvoxel.coords(jnp.asarray(pts), gj)
    ct = tvoxel.coords(T(pts), gt)
    np.testing.assert_array_equal(ct.numpy(), _np(cj))
    kj = jvoxel.keys_of(jnp.asarray(pts), jnp.asarray(valid), gj)
    kt = tvoxel.keys_of(T(pts), T(valid), gt)
    np.testing.assert_array_equal(kt.numpy(), _np(kj))
    np.testing.assert_array_equal(tvoxel.unpack(tvoxel.pack(ct)).numpy(), _np(cj))
    np.testing.assert_allclose(
        tvoxel.cell_center(tvoxel.pack(ct), gt).numpy(), _np(jvoxel.cell_center(jvoxel.pack(cj), gj)), atol=1e-5
    )


def test_voxel_downsample_and_lookup(rng):
    pts, valid = _points(rng, spread=0.8)
    attrs = rng.uniform(0, 1, (pts.shape[0], 3)).astype(np.float32)
    gj, gt = jvoxel.GridSpec.make(0.2), tvoxel.GridSpec.make(0.2)
    dj = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(attrs), jnp.asarray(valid), gj, 512, True)
    dt = tvoxel.voxel_downsample(T(pts), T(attrs), T(valid), gt, 512, True)
    for name in ("key", "count", "valid", "num", "segments"):
        np.testing.assert_array_equal(dt[name].numpy(), _np(dj[name]), err_msg=name)
    for name in ("points", "attrs"):
        np.testing.assert_allclose(dt[name].numpy(), _np(dj[name]), atol=1e-5, err_msg=name)
    q = np.concatenate([_np(dj["key"])[:50], rng.integers(0, 2**30, 50).astype(np.int32)])
    np.testing.assert_array_equal(
        tvoxel.lookup(dt["key"], T(q)).numpy(), _np(jvoxel.lookup(dj["key"], jnp.asarray(q)))
    )


@pytest.mark.parametrize("capacity", [4, 64])
def test_group_unique(rng, capacity):
    n, g = 3000, 7
    groups = rng.integers(0, g, n).astype(np.int32)
    values = rng.integers(0, 200, n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.8
    oj, cj = jcompact.group_unique(jnp.asarray(groups), jnp.asarray(values), jnp.asarray(valid), g, capacity)
    ot, ct = tcompact.group_unique(T(groups), T(values), T(valid), g, capacity)
    np.testing.assert_array_equal(ot.numpy(), _np(oj))
    np.testing.assert_array_equal(ct.numpy(), _np(cj))
    uj, nj = jcompact.unique_compact(jnp.asarray(values), jnp.asarray(valid), 300)
    ut, nt = tcompact.unique_compact(T(values), T(valid), 300)
    np.testing.assert_array_equal(ut.numpy(), _np(uj))
    assert int(nt) == int(nj)


# -- scene ---------------------------------------------------------------------


def _assert_scene_equal(st, sj):
    sj = jax.tree.map(np.asarray, sj)
    for name in ("key", "sorted_key", "sorted_row", "num", "count", "feat_count"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), getattr(sj, name), err_msg=name)
    for name in ("sum_pts", "sum_col", "sum_feat"):
        np.testing.assert_allclose(getattr(st, name).numpy(), getattr(sj, name), atol=1e-5, err_msg=name)


def test_scene_insert_and_fuse(rng):
    """Two frames of identical points through insert (with a capacity that
    overflows) and both fuse branches."""
    cap, d, m = 700, 8, 5
    sj = jscene.init_scene(jvoxel.GridSpec.centered(0.15), cap, d)
    st = tscene.init_scene(tvoxel.GridSpec.centered(0.15), cap, d, "cpu")
    for frame in range(2):
        pts, valid = _points(rng, n=1200, spread=1.0)
        cols = rng.uniform(0, 1, pts.shape).astype(np.float32)
        sj, rows_j = jscene.insert_points(sj, jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), fcap=400)
        st, rows_t = tscene.insert_points(st, T(pts), T(cols), T(valid), fcap=400)
        np.testing.assert_array_equal(rows_t.numpy(), _np(rows_j))
        masks = rng.uniform(size=(m, pts.shape[0])) < 0.3
        mvalid = np.array([True, True, False, True, True])
        fm = rng.normal(0, 1, (m, d)).astype(np.float32)
        chunk = 1 << 20 if frame == 0 else 256  # single-shot, then chunked
        sj = jscene.fuse_pixel_features(sj, rows_j, jnp.asarray(masks), jnp.asarray(mvalid), jnp.asarray(fm), chunk=chunk)
        st = tscene.fuse_pixel_features(st, rows_t, T(masks), T(mvalid), T(fm), chunk=chunk)
        _assert_scene_equal(st, sj)
    assert int(st.num) == cap  # the second frame overflowed the capacity
    np.testing.assert_allclose(st.feats().numpy(), _np(sj.feats()), atol=1e-5)
    np.testing.assert_allclose(st.points().numpy(), _np(sj.points()), atol=1e-5)


# -- masks / crops / resize ----------------------------------------------------


def _blob_masks(rng, m=12, h=40, w=56):
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.uniform(0, h, m), rng.uniform(0, w, m)
    r = rng.uniform(3, 15, m)
    masks = (yy[None] - cy[:, None, None]) ** 2 + (xx[None] - cx[:, None, None]) ** 2 < r[:, None, None] ** 2
    masks[-1] = False  # one empty mask
    return masks


def test_mask_ops(rng):
    masks = _blob_masks(rng)
    valid = rng.uniform(size=masks.shape[0]) < 0.8
    logits = rng.normal(0, 2, masks.shape).astype(np.float32)
    mj, mt = jnp.asarray(masks), T(masks)
    np.testing.assert_array_equal(tmasks.mask_areas(mt).numpy(), _np(jmasks.mask_areas(mj)))
    np.testing.assert_array_equal(
        tmasks.stability_scores(T(logits)).numpy(), _np(jmasks.stability_scores(jnp.asarray(logits)))
    )
    bj = jmasks.boxes_from_masks(mj)
    bt = tmasks.boxes_from_masks(mt)
    np.testing.assert_array_equal(bt.numpy(), _np(bj))
    np.testing.assert_allclose(tmasks.box_iou(bt, bt).numpy(), _np(jmasks.box_iou(bj, bj)), atol=1e-6)
    # duplicated boxes and tied scores exercise the stable order
    boxes = np.concatenate([_np(bj), _np(bj)[:4]])
    scores = np.round(rng.uniform(0, 1, boxes.shape[0]), 1).astype(np.float32)
    ok = rng.uniform(size=boxes.shape[0]) < 0.85
    kj = jmasks.nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(ok), 0.5)
    kt = tmasks.nms(T(boxes), T(scores), T(ok), 0.5)
    np.testing.assert_array_equal(kt.numpy(), _np(kj))
    np.testing.assert_array_equal(
        tmasks.to_disjoint(mt, T(valid)).numpy(), _np(jmasks.to_disjoint(mj, jnp.asarray(valid)))
    )


def _nms_tensors(name):
    boxes, scores, valid, thresh = nms_case(name)
    return T(boxes), T(scores), T(valid), thresh


@pytest.mark.parametrize("name", NMS_CASE_NAMES)
def test_nms_edge_cases(name):
    """The plain NMS (what a CPU tensor takes, and what the CUDA kernel is
    held to) against the JAX package, bit for bit, on each edge case."""
    boxes, scores, valid, thresh = nms_case(name)
    kj = _np(jmasks.nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thresh))
    kt = tmasks.nms(T(boxes), T(scores), T(valid), thresh).numpy()
    np.testing.assert_array_equal(kt, kj)
    assert not (kt & ~valid).any()
    if name == "all_invalid":
        assert not kt.any()
    elif name == "one_valid":
        np.testing.assert_array_equal(kt, valid)
    elif name == "ties_across_words":
        for lo, hi in ((58, 70), (120, 136), (190, 200)):
            assert kt[lo:hi].sum() <= 1
        assert kt[[58, 120, 190]].any()
    elif name == "iou_at_threshold":  # the 7/10 pairs keep both boxes, the 8/10 pairs one
        np.testing.assert_array_equal(kt.reshape(40, 2)[:, 1], np.arange(40) % 2 == 0)
    else:
        assert kt.sum() < valid.sum()  # something was suppressed


@pytest.mark.parametrize("fault", NMS_FAULTS)
def test_nms_cases_reject_each_fault(fault):
    """Each broken rule changes the keep mask on some edge case, so the
    cases can tell a faulty kernel from a right one."""
    differing = []
    for name in NMS_CASE_NAMES:
        if name == "m3072":
            continue
        boxes, scores, valid, thresh = _nms_tensors(name)
        keep = tmasks.nms_ref(boxes, scores, valid, thresh)
        if not torch.equal(nms_with_fault(boxes, scores, valid, thresh, fault), keep):
            differing.append(name)
    assert differing, fault


def test_nms_cpu_takes_the_plain_version_and_counts_nothing():
    boxes, scores, valid, thresh = _nms_tensors("m432")
    n0, r0 = tmasks.nms.launches, dict(tmasks.nms.routes)
    keep = tmasks.nms(boxes, scores, valid, thresh)
    assert torch.equal(keep, tmasks.nms_ref(boxes, scores, valid, thresh)) and keep.dtype == torch.bool
    assert (tmasks.nms.launches, tmasks.nms.routes) == (n0, r0)


def test_nms_wrapper_checks_its_arguments():
    boxes, scores, valid, _ = _nms_tensors("m48")
    with pytest.raises(TypeError, match="float32"):
        tmasks.nms(boxes.double(), scores, valid)
    with pytest.raises(TypeError, match="float32"):
        tmasks.nms(boxes, scores.half(), valid)
    with pytest.raises(TypeError, match="bool"):
        tmasks.nms(boxes, scores, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="boxes"):
        tmasks.nms(boxes[:, :3], scores, valid)
    with pytest.raises(ValueError, match="boxes"):
        tmasks.nms(boxes, scores[:-1], valid)
    with pytest.raises(ValueError, match="boxes"):
        tmasks.nms(boxes, scores, valid[None])
    with pytest.raises(ValueError, match="device"):
        tmasks.nms(boxes, scores.to("meta"), valid)


def test_nms_build_key_tracks_its_source():
    """csrc/masks.cu builds into its own library, keyed by its source; the
    one-block route's limit is the source's."""
    path = tmasks.LIB.path()
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so" and "masks" in path.name
    assert path != cuda_build.CudaLibrary("quant_matmul.cu", {}).path()
    text = tmasks.LIB.source.read_text()
    assert re.search(r'extern "C" int ha_nms\(', text) and len(tmasks.LIB.signatures["ha_nms"]) == 9
    assert f"constexpr int BLOCK_MAX_M = {tmasks.ONE_BLOCK_MAX_M};" in text
    # box_iou's arithmetic: each operation rounded once, IEEE division
    assert "__fdiv_rn" in text and "__fdividef" not in text and "--use_fast_math" not in cuda_build.NVCC_FLAGS
    assert [tmasks.nms_route(m) for m in (48, 432, 1024, 1025, 3072)] == ["block"] * 3 + ["grid"] * 2


@pytest.mark.parametrize("thresh", [0.9, 0.5])
def test_containment_ops(rng, thresh):
    """subtract_contained and containment_filter (ops/masks.py), with nested
    blobs so that containment happens."""
    masks = _blob_masks(rng)
    masks[1] = masks[0] | masks[1]  # 0 inside 1
    masks[2] = masks[2] & masks[3]  # 2 inside 3
    valid = np.ones(masks.shape[0], bool)
    valid[5] = False
    mj, mt, vj, vt = jnp.asarray(masks), T(masks), jnp.asarray(valid), T(valid)
    carved = tmasks.subtract_contained(mt, vt, thresh).numpy()
    np.testing.assert_array_equal(carved, _np(jmasks.subtract_contained(mj, vj, thresh)))
    assert (carved != masks).any()
    keep = tmasks.containment_filter(mt, vt, thresh).numpy()
    np.testing.assert_array_equal(keep, _np(jmasks.containment_filter(mj, vj, thresh)))
    assert not keep.all()


def test_backproject_batch_and_depth_gate(rng):
    from holoagent_tpu.ops.backproject import backproject_batch as jbatch, mean_depth_gate as jgate
    from holoagent_tpu_torch.ops.backproject import backproject_batch as tbatch, mean_depth_gate as tgate

    depth = rng.uniform(0.2, 6.0, (3, 48, 64)).astype(np.float32)
    depth[:, :5] = 0.0
    rgb = rng.uniform(0, 1, (3, 48, 64, 3)).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[:, :3, 3] = rng.normal(size=(3, 3))
    cj, ct = jcamera.Pinhole.from_matrix(K), tcamera.Pinhole.from_matrix(K)
    want = jbatch(jnp.asarray(depth), jnp.asarray(rgb), cj, jnp.asarray(poses), 1e-3, 5.0)
    got = tbatch(T(depth), T(rgb), ct, T(poses), 1e-3, 5.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    for i in range(3):
        for dist in (2.0, 3.1, 4.0):
            assert bool(tgate(T(depth[i]), got[2][i], dist)) == bool(jgate(jnp.asarray(depth[i]), want[2][i], dist))


def test_intersect_count(rng):
    a = np.unique(rng.integers(0, 500, 200)).astype(np.int32)
    b = np.unique(rng.integers(0, 500, 150)).astype(np.int32)
    pad = lambda x: np.concatenate([x, np.full(256 - len(x), tvoxel.SENTINEL, np.int32)])  # noqa: E731
    got = tvoxel.intersect_count(T(pad(a)), T(pad(b)))
    assert int(got) == int(jvoxel.intersect_count(jnp.asarray(pad(a)), jnp.asarray(pad(b)))) == len(np.intersect1d(a, b))


def test_crop_and_resize(rng):
    img = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    masks = _blob_masks(rng)
    boxes = np.array(jmasks.boxes_from_masks(jnp.asarray(masks)))
    ej = jcrop.expand_boxes(jnp.asarray(boxes), 5.0, 40, 56)
    et = tcrop.expand_boxes(T(boxes), 5.0, 40, 56)
    np.testing.assert_array_equal(et.numpy(), _np(ej))
    np.testing.assert_allclose(
        tcrop._interp_weights(et[:, 0], et[:, 2], 16, 40).numpy(),
        _np(jcrop._interp_weights(ej[:, 0], ej[:, 2], 16, 40)), atol=1e-6,
    )
    for mk in (None, masks):
        cj = jcrop.crop_and_resize(jnp.asarray(img), ej, 16, masks=None if mk is None else jnp.asarray(mk))
        ct = tcrop.crop_and_resize(T(img), et, 16, masks=None if mk is None else T(mk))
        np.testing.assert_allclose(ct.numpy(), _np(cj), atol=1e-5)


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("out_hw", [(16, 20), (64, 96), (30, 56)])
def test_resize_matches_jax_image_resize(rng, method, out_hw):
    """Down, up and mixed resizes, antialiased as jax.image.resize is."""
    img = rng.uniform(0, 1, (2, 30, 40, 3)).astype(np.float32)
    shape = (2, out_hw[0], out_hw[1], 3)
    ref = jax.image.resize(jnp.asarray(img), shape, method=method)
    out = tresize(T(img), shape, method)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5)


# -- features / density ------------------------------------------------------


@pytest.mark.parametrize("min_points", [5.0, 500.0])
def test_dominant_feature(rng, min_points):
    base = rng.normal(0, 1, (3, 16)).astype(np.float32)
    f = base[rng.integers(0, 3, 60)] + rng.normal(0, 0.01, (60, 16)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    valid = rng.uniform(size=60) < 0.9
    f[~valid] = 0.0
    ref = jfeatures.dominant_feature(jnp.asarray(f), jnp.asarray(valid), eps=0.01, min_points=min_points)
    out = tfeatures.dominant_feature(T(f), T(valid), eps=0.01, min_points=min_points)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5)
    batched = tfeatures.dominant_feature(T(np.stack([f, f])), T(np.stack([valid, valid])), 0.01, min_points)
    np.testing.assert_allclose(batched.numpy(), np.stack([out.numpy()] * 2), atol=1e-6)


def test_radius_density_keep(rng):
    pts = np.concatenate([rng.normal(0, 0.3, (400, 3)), rng.uniform(-6, 6, (100, 3))]).astype(np.float32)
    valid = rng.uniform(size=500) < 0.95
    w = rng.integers(1, 5, 500).astype(np.float32)
    kj = jdensity.radius_density_keep(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(w), 1.0, 200.0)
    kt = tdensity.radius_density_keep(T(pts), T(valid), T(w), 1.0, 200.0)
    np.testing.assert_array_equal(kt.numpy(), _np(kj))
    assert 0 < kt.sum() < valid.sum()


# -- instances -------------------------------------------------------------


def _cluster_frame(rng, centers, n=900):
    """Points around a few object centres; one disjoint mask per centre (the
    last centre split between two masks) plus an empty, invalid slot."""
    lab = rng.integers(0, len(centers), n)
    pts = (centers[lab] + rng.normal(0, 0.12, (n, 3))).astype(np.float32)
    m = len(centers) + 2
    masks = np.zeros((m, n), bool)
    masks[lab, np.arange(n)] = True
    split = (lab == len(centers) - 1) & (rng.uniform(size=n) < 0.5)
    masks[len(centers) - 1, split] = False
    masks[len(centers), split] = True
    valid = np.ones(m, bool)
    valid[-1] = False
    feats = rng.normal(0, 1, (m, 8)).astype(np.float32)
    return pts, masks, valid, feats


def _assert_instances_equal(it, ij):
    ij = jax.tree.map(np.asarray, ij)
    for name in ("rows", "count", "valid", "ckeys", "ccount", "dsig"):
        np.testing.assert_array_equal(getattr(it, name).numpy(), getattr(ij, name), err_msg=name)
    for name in ("feat_sum", "weight", "bbox_min", "bbox_max"):
        np.testing.assert_allclose(getattr(it, name).numpy(), getattr(ij, name), atol=1e-5, err_msg=name)


def test_instances_frame_lift_and_folds(rng):
    """frame_instances, merge_round, seq_merge_step and paired_merge_step on
    identical inputs; state crosses over through the bridge."""
    centers = rng.uniform(-1.5, 1.5, (5, 3))
    gj, gt = jvoxel.GridSpec.centered(0.1), tvoxel.GridSpec.centered(0.1)
    sj = jscene.init_scene(gj, 4096, 8)
    kw = dict(min_rows=3, k_cap=128, stride=1, max_area_frac=1.0, max_extent=2.5)
    frames = []
    for _ in range(3):
        pts, masks, valid, feats = _cluster_frame(rng, centers)
        sj, rows_j = jscene.insert_points(sj, jnp.asarray(pts), jnp.asarray(pts), jnp.ones(len(pts), bool))
        fj = jinst.frame_instances(jnp.asarray(masks), jnp.asarray(valid), jnp.asarray(feats), rows_j,
                                   jnp.asarray(pts), grid=gj, **kw)
        ft = tinst.frame_instances(T(masks), T(valid), T(feats), T(np.array(rows_j)), T(pts), grid=gt, **kw)
        _assert_instances_equal(ft, fj)
        frames.append(fj)
    st = bridge.scene_from_numpy(jax.tree.map(np.asarray, sj), "cpu")
    _assert_scene_equal(st, sj)
    fold = dict(bbox_pad=0.05, coarse_only=True, max_extent=2.5)
    gj_inst = jinst.empty_instances(6, 128, 8)
    gt_inst = tinst.empty_instances(6, 128, 8, "cpu")
    for fj in frames:  # 6 lanes: the third frame saturates the paired fold
        ft = bridge.instances_from_numpy(jax.tree.map(np.asarray, fj), "cpu")
        gj_inst = jinst.paired_merge_step(gj_inst, fj, 0.3, 0.05, **fold)
        gt_inst = tinst.paired_merge_step(gt_inst, ft, 0.3, 0.05, **fold)
        _assert_instances_equal(gt_inst, gj_inst)
    cat_j = jinst.concat(frames[0], frames[1])
    cat_t = bridge.instances_from_numpy(jax.tree.map(np.asarray, cat_j), "cpu")
    for coarse_only in (True, False):
        mj = jinst.merge_round(cat_j, 0.3, 0.05, 8, bbox_pad=0.05, coarse_only=coarse_only)
        mt = tinst.merge_round(cat_t, 0.3, 0.05, 8, bbox_pad=0.05, coarse_only=coarse_only)
        _assert_instances_equal(mt, mj)
    assert int(mt.num()) < int(cat_t.num())  # the round merged something
    sq_j = jinst.seq_merge_step(frames[0], frames[2], 0.3, 0.05, **fold)
    sq_t = tinst.seq_merge_step(*(bridge.instances_from_numpy(jax.tree.map(np.asarray, f), "cpu")
                                  for f in (frames[0], frames[2])), 0.3, 0.05, **fold)
    _assert_instances_equal(sq_t, sq_j)
