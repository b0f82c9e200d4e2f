"""The port's sharded voxel scene, DP extraction, ShardedMapper and sharded
build_map against the JAX package on the CPU.

As in test_torch_parallel.py: the port runs as 4 gloo ranks spawned once for
the module (the cases are in ``_torch_dist_ranks``, jax-free), the JAX side
on ``jax.devices()[:4]``.  Integer outputs (per-pixel global rows, keys,
per-shard row counts, the row map, the ShardedMapper's scene and instance
sets) are held bit for bit; float sums to tests/test_sharded_scene.py's
tolerances."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_ranks as ranks
from holoagent_tpu.config import MeshConfig
from holoagent_tpu.config import from_dict as jfrom_dict
from holoagent_tpu.dataloader import SyntheticDataset as JSyntheticDataset
from holoagent_tpu.memory import sharded_scene as jss
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import sam as jsam
from holoagent_tpu.ops import voxel as jvoxel
from holoagent_tpu.ops.voxel import GridSpec
from holoagent_tpu.parallel import make_mesh
from holoagent_tpu.perception import extractor as jext
from holoagent_tpu_torch.parallel import launch

W = 4
D = 16
CASES = ["insert_fuse", "extract_dp", "sharded_mapper", "build_map"]
# the reference's ShardedMapper test configuration (tests/test_sharded_scene.py)
MAPPER_CFG = {
    "models": {
        "clip": {"type": "test-tiny", "dtype": "float32"},
        "sam": {"type": "test-tiny", "dtype": "float32", "points_per_side": 4, "pred_iou_thresh": -10.0,
                "stability_score_thresh": 0.0, "min_mask_region_area": 20, "max_masks": 8},
    },
    "pipeline": {"voxel_size": 0.08, "grid_resolution": 0.08, "point_capacity": 1 << 14,
                 "mask_point_capacity": 512, "instance_capacity": 64, "skip_frames": 1,
                 "instance_max_area_frac": 1.0, "instance_max_extent_m": 1e9},
}
SCENE_FIELDS = ("key", "sorted_key", "sorted_row", "count", "num")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jmesh():
    return make_mesh(MeshConfig(data=-1, model=1), jax.devices()[:W])


def _frames(rng, n_frames=2, p=1024):
    out = []
    for _ in range(n_frames):
        pts = rng.uniform(-2.0, 2.0, (p, 3)).astype(np.float32)
        cols = rng.uniform(0, 1, (p, 3)).astype(np.float32)
        valid = rng.uniform(0, 1, (p,)) > 0.1
        masks = rng.uniform(0, 1, (4, p)) > 0.6
        mvalid = np.array([True, True, True, False])
        fm = rng.normal(0, 1, (4, D)).astype(np.float32)
        fm /= np.linalg.norm(fm, axis=-1, keepdims=True)
        out.append((pts, cols, valid, masks, mvalid, fm))
    return out


@pytest.fixture(scope="module")
def towers():
    return (_np(jclip.init_clip(jax.random.key(0), jclip.VARIANTS["test-tiny"], dtype=jnp.float32)),
            _np(jsam.init_sam(jax.random.key(1), jsam.VARIANTS["test-tiny"])))


@pytest.fixture(scope="module")
def port(towers, tmp_path_factory):
    """(inputs, per-rank results) of every case, from one spawn of W ranks."""
    rng = np.random.default_rng(0)
    clip, sam = towers
    work = tmp_path_factory.mktemp("dist")
    build_cfg = {**MAPPER_CFG, "main": {"save_path": str(work / "graphs"), "scene_id": "s"},
                 "pipeline": {**MAPPER_CFG["pipeline"], "sharded_mapping": "on", "obj_labels": "FIXTURE"}}
    inp = {
        "insert_fuse": {"frames": _frames(rng), "d": D, "small_bcap": (16, 8)},
        "extract_dp": {"clip": clip, "sam": sam, "imgs": rng.uniform(0, 1, (W, 32, 48, 3)).astype(np.float32),
                       "kw": dict(points_per_side=3, pred_iou_thresh=-10.0, stability_thresh=0.0, min_area=5.0,
                                  max_masks=4)},
        "sharded_mapper": {"clip": clip, "sam": sam, "cfg": MAPPER_CFG, "frames": W, "hw": (48, 64)},
        "build_map": {"clip": clip, "sam": sam, "cfg": build_cfg, "frames": 2 * W, "hw": (48, 64)},
    }
    path = str(work / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return inp, launch.spawn(ranks.run_cases, W, "cpu", args=(path, CASES)), work


def _shards(res, step=None, key="final"):
    """The ranks' shards concatenated: the reference's global layout."""
    parts = [r["insert_fuse"]["steps"][step]["insert"] if step is not None else r["insert_fuse"][key] for r in res]
    return {f: np.stack([p[f] for p in parts]) if f == "num" else np.concatenate([p[f] for p in parts])
            for f in parts[0]}


@pytest.fixture(scope="module")
def reference(port):
    """The reference's sharded insert/fuse over the same frames on 4
    devices: per frame the global rows and the scene after the insert, then
    the final scene and to_scene."""
    inp, _, _ = port
    mesh = _jmesh()
    grid = GridSpec.make(0.25, origin=(-4.0, -4.0, -4.0))
    sh = jss.init_sharded_scene(grid, 512, D, mesh)
    steps = []
    for pts, cols, valid, masks, mvalid, fm in inp["insert_fuse"]["frames"]:
        sh, rows = jss.insert_points_sharded(sh, jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), mesh,
                                             fcap=1024, bcap=512)
        steps.append((np.asarray(rows), _np(sh)))
        sh = jss.fuse_pixel_features_sharded(sh, rows, jnp.asarray(masks), jnp.asarray(mvalid), jnp.asarray(fm),
                                             mesh, rcap=1024, bcap=512)
    scene, row_map = jss.to_scene(sh)
    return steps, _np(sh), _np(scene), np.asarray(row_map)


def test_sharded_insert_rows_and_keys_bit_for_bit(port, reference):
    _, res, _ = port
    steps, _, _, _ = reference
    for i, (rows, sh) in enumerate(steps):
        for r in res:
            np.testing.assert_array_equal(r["insert_fuse"]["steps"][i]["rows"], rows)
        got = _shards(res, step=i)
        for f in ("key", "sorted_key", "sorted_row", "num", "count"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(sh, f)), err_msg=f)
        np.testing.assert_allclose(got["sum_pts"], sh.sum_pts, atol=1e-4, rtol=1e-4)


def test_sharded_fuse_matches_reference(port, reference):
    """The final shards: integer fields bit for bit, the sums within
    tests/test_sharded_scene.py's tolerances."""
    _, res, _ = port
    _, sh, _, _ = reference
    got = _shards(res)
    for f in ("key", "num", "count", "feat_count"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(sh, f)), err_msg=f)
    for f, tol in (("sum_pts", 1e-4), ("sum_col", 1e-4), ("sum_feat", 1e-3)):
        np.testing.assert_allclose(got[f], np.asarray(getattr(sh, f)), atol=tol, rtol=1e-4, err_msg=f)


def test_to_scene_compacts_like_the_reference(port, reference):
    _, res, _ = port
    _, _, scene, row_map = reference
    for r in res:
        got = r["insert_fuse"]
        np.testing.assert_array_equal(got["row_map"], row_map)
        for f in SCENE_FIELDS + ("feat_count",):
            np.testing.assert_array_equal(got["scene"][f], np.asarray(getattr(scene, f)), err_msg=f)
        for f, tol in (("sum_pts", 1e-4), ("sum_col", 1e-4), ("sum_feat", 1e-3)):
            np.testing.assert_allclose(got["scene"][f], np.asarray(getattr(scene, f)), atol=tol, rtol=1e-4)
    n = int(res[0]["insert_fuse"]["scene"]["num"])
    assert (res[0]["insert_fuse"]["scene"]["count"][:n] > 0).all()


def test_to_scene_matches_single_device(port):
    """The gathered scene holds the single-device scene's per-voxel
    aggregates (the reference test's check, on the port)."""
    inp, res, _ = port
    from holoagent_tpu_torch.memory import scene as tscene
    from holoagent_tpu_torch.ops.voxel import GridSpec as TGrid
    import torch

    ref = tscene.init_scene(TGrid.make(0.25, origin=(-4.0, -4.0, -4.0)), 4096, D, "cpu")
    for pts, cols, valid, masks, mvalid, fm in inp["insert_fuse"]["frames"]:
        ref, rows = tscene.insert_points(ref, torch.from_numpy(pts), torch.from_numpy(cols), torch.from_numpy(valid))
        ref = tscene.fuse_pixel_features(ref, rows, torch.from_numpy(masks), torch.from_numpy(mvalid),
                                         torch.from_numpy(fm))

    def agg(key, cnt, spts, sfeat, fcnt):
        return {int(key[i]): (cnt[i], spts[i], sfeat[i], fcnt[i]) for i in np.nonzero(cnt > 0)[0]}

    s = res[0]["insert_fuse"]["scene"]
    got = agg(s["key"], s["count"], s["sum_pts"], s["sum_feat"], s["feat_count"])
    want = agg(*(getattr(ref, f).numpy() for f in ("key", "count", "sum_pts", "sum_feat", "feat_count")))
    assert set(got) == set(want)
    for k in want:
        for a, b, tol in zip(got[k], want[k], (1e-5, 1e-4, 1e-3, 1e-5)):
            np.testing.assert_allclose(a, b, atol=tol, rtol=1e-4)


def test_sharded_rows_stable_across_reinsert(port):
    inp, res, _ = port
    valid = inp["insert_fuse"]["frames"][0][2]
    for r in res:
        r1, r2, total = r["insert_fuse"]["reinsert"]
        np.testing.assert_array_equal(r1, r2)
        assert total == 2 * float(valid.sum())
        assert r["insert_fuse"]["wire"] == {"data_axis": W, "insert_bytes": W * 512 * 36,
                                             "fuse_bytes": W * 512 * (8 + 4 * D), "total_bytes": W * 512 * (44 + 4 * D)}


def test_full_bucket_drops_are_counted(port):
    """The first frame's insert through a 16-lane bucket and its fuse through
    an 8-lane one both overflow: the rows and shards equal the reference's
    at those buckets bit for bit, and the port counts what dropped, here
    recomputed from the reference's keys and rows: per rank and owner, the
    distinct voxel keys (insert) and the distinct covered rows (fuse) past
    the bucket.  At 512 lanes nothing drops."""
    inp, res, _ = port
    c = inp["insert_fuse"]
    (bi, bf), p = c["small_bcap"], c["frames"][0][0].shape[0] // W
    pts, cols, valid, masks, mvalid, fm = c["frames"][0]
    mesh = _jmesh()
    grid = GridSpec.make(0.25, origin=(-4.0, -4.0, -4.0))
    sh = jss.init_sharded_scene(grid, 512, D, mesh)
    sh, rows = jss.insert_points_sharded(sh, jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), mesh,
                                         fcap=1024, bcap=bi)
    sh = jss.fuse_pixel_features_sharded(sh, rows, jnp.asarray(masks), jnp.asarray(mvalid), jnp.asarray(fm), mesh,
                                         rcap=1024, bcap=bf)
    rows = np.asarray(rows)
    keys = np.asarray(jvoxel.keys_of(jnp.asarray(pts), jnp.asarray(valid), grid))
    covered = (rows >= 0) & masks[mvalid].any(axis=0)

    def past_bucket(owners, b):
        return int(np.maximum(np.bincount(owners, minlength=W) - b, 0).sum())

    want_insert = sum(past_bucket(np.asarray(jss._owner_of(jnp.asarray(np.unique(keys[r * p:(r + 1) * p][
        valid[r * p:(r + 1) * p]])), W)), bi) for r in range(W))
    want_fuse = sum(past_bucket(np.unique(rows[r * p:(r + 1) * p][covered[r * p:(r + 1) * p]]) // 512, bf)
                    for r in range(W))
    assert want_insert > 0 and want_fuse > 0
    got = [r["insert_fuse"]["overflow"] for r in res]
    assert [sum(g["dropped"][i] for g in got) for i in (0, 1)] == [want_insert, want_insert + want_fuse]
    for g in got:
        np.testing.assert_array_equal(g["rows"], rows)
    for f in ("key", "num", "count", "feat_count"):
        cat = np.stack if f == "num" else np.concatenate
        np.testing.assert_array_equal(cat([g["shard"][f] for g in got]), np.asarray(getattr(sh, f)), err_msg=f)
    assert [r["insert_fuse"]["dropped"] for r in res] == [0] * W


def test_extract_frames_dp(port, towers):
    """DP extraction equals the port's whole-batch extraction (every rank
    holds every frame) and the reference's DP extraction in float32."""
    inp, res, _ = port
    c = inp["extract_dp"]
    clip, sam = (jax.tree.map(jnp.asarray, t) for t in towers)
    want = jext.extract_frames_dp(clip, sam, jnp.asarray(c["imgs"]), jclip.VARIANTS["test-tiny"],
                                  jsam.VARIANTS["test-tiny"], _jmesh(), dtype=jnp.float32, **c["kw"])
    for r in res:
        dp, whole = r["extract_dp"]["dp"], r["extract_dp"]["batched"]
        for a, b in zip(dp, whole):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(dp[0], np.asarray(want.masks))
        np.testing.assert_array_equal(dp[1], np.asarray(want.valid))
        np.testing.assert_allclose(dp[3], np.asarray(want.f_masks), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(dp[4], np.asarray(want.f_global), atol=1e-4, rtol=1e-4)


def test_sharded_mapper_end_to_end(port, towers, monkeypatch):
    """The port's ShardedMapper against the reference's at 4 ranks / 4
    devices, the reference's extraction fed the port's FrameFeatures (the
    reference's ShardedMapper extracts in bf16, the port in the towers'
    dtype): the finalized scene's and instance sets' integer fields bit for
    bit, floats within the reference test's tolerances; every rank returns
    the same MappedScene."""
    inp, res, _ = port
    got = res[0]["sharded_mapper"]
    (feats,) = got["features"]
    monkeypatch.setattr(jext, "extract_frames_dp",
                        lambda *a, **kw: jext.FrameFeatures(*(jnp.asarray(x) for x in feats)))
    cfg = jfrom_dict(MAPPER_CFG)
    ds = JSyntheticDataset(num_frames=W, hw=(48, 64))
    clip, sam = (jax.tree.map(jnp.asarray, t) for t in towers)
    sm = jss.ShardedMapper(cfg, clip, sam, _jmesh())
    sm.process_batch([ds[i] for i in range(len(ds))])
    want = sm.finalize()
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(got["scene"][f], np.asarray(getattr(want.scene, f)), err_msg=f)
    np.testing.assert_allclose(got["scene"]["sum_pts"], np.asarray(want.scene.sum_pts), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got["scene"]["sum_feat"], np.asarray(want.scene.sum_feat), atol=1e-3, rtol=1e-4)
    inst = got["instances"]
    for f in ("rows", "count", "valid", "ckeys", "ccount"):
        np.testing.assert_array_equal(inst[f], np.asarray(getattr(want.instances, f)), err_msg=f)
    for f in ("feat_sum", "weight", "bbox_min", "bbox_max", "dsig"):
        np.testing.assert_allclose(inst[f], np.asarray(getattr(want.instances, f)), atol=1e-4, rtol=1e-4, err_msg=f)
    assert int(inst["valid"].sum()) >= 1  # the fold is exercised
    np.testing.assert_array_equal(got["density"], np.asarray(want.density_keep))
    np.testing.assert_allclose(got["instance_feats"], np.asarray(want.instance_feats), atol=1e-4)
    np.testing.assert_allclose(got["keyframe_feats"], np.asarray(want.keyframe_feats), atol=1e-5)
    for r in res[1:]:
        for part in ("scene", "instances"):
            for f, a in got[part].items():
                np.testing.assert_array_equal(r["sharded_mapper"][part][f], a, err_msg=f"{part}.{f}")


def test_sharded_mapper_bucket_and_wire_bytes(port):
    """The ShardedMapper's bucket is bucket_capacity's for its per-rank
    frame-voxel capacity (frame_voxel_capacity split over the ranks),
    nothing dropped at test-tiny, and wire_bytes reports the buffers it
    sends."""
    _, res, _ = port
    from holoagent_tpu_torch.memory.sharded_scene import bucket_capacity

    fcap = -(-(1 << 15) // W)
    bcap = bucket_capacity(fcap, W)
    assert (fcap, bcap) == (8192, 2432)
    for r in res:
        ex = r["sharded_mapper"]["exchange"]
        assert (ex["fcap"], ex["bcap"], ex["dropped"]) == (fcap, bcap, 0)
        assert ex["wire"] == {"data_axis": W, "insert_bytes": W * bcap * 36, "fuse_bytes": W * bcap * (8 + 4 * 32),
                              "total_bytes": W * bcap * (44 + 4 * 32)}


def test_sharded_build_map(port):
    """build_map.run with sharded_mapping on at 4 ranks: only the first rank
    writes the graph directory, every rank returns it and the same graph."""
    _, res, work = port
    out = [r["build_map"] for r in res]
    graph_dirs = sorted((work / "graphs" / "s").glob("graph_*"))
    assert [str(p) for p in graph_dirs] == [out[0]["graph_dir"]]
    for o in out[1:]:  # the first rank's built graph, the others' loaded (objects in file order)
        assert {**o, "objects": sorted(o["objects"])} == {**out[0], "objects": sorted(out[0]["objects"])}
    assert "full_pcd.ply" in os.listdir(work / "graphs" / "s") and out[0]["views"] >= W
    assert out[0]["rooms"] and any(f.endswith(".json") for f in out[0]["files"])
