"""The HMSG build against the JAX package: image2d and k-means op by op,
HMSGraph.build given the same MappedScene, room naming, the whole tiny
map -> graph path, and graphs saved by one package loaded by the other.

Tolerances: integer and bool outputs exact; float outputs within 1e-5
relative (the blur's sums may differ from XLA's in the last bit); Otsu's
threshold, the k-means labels, and every id, name and index of the graph
exact.  The JAX side runs its jitted array programs on the CPU.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.config import from_dict as jfrom_dict
from holoagent_tpu.dataloader import SyntheticDataset as JSyntheticDataset
from holoagent_tpu.dataloader.generic import RGBDFrame as JRGBDFrame
from holoagent_tpu.memory import hmsg as jhmsg
from holoagent_tpu.memory import instances as jinst
from holoagent_tpu.memory import scene as jscene
from holoagent_tpu.memory.mapping import MappedScene as JMappedScene
from holoagent_tpu.memory.mapping import Mapper as JMapper
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import sam as jsam
from holoagent_tpu.models.tokenizer import SimpleTokenizer as JTokenizer
from holoagent_tpu.ops import image2d as jimg
from holoagent_tpu.ops import kmeans as jkm
from holoagent_tpu.ops.voxel import GridSpec as JGridSpec
from holoagent_tpu.utils.labels import DEFAULT_ROOM_TYPES as JROOM_TYPES
from holoagent_tpu.utils.labels import get_label_feats as jget_label_feats
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.dataloader import SyntheticDataset
from holoagent_tpu_torch.memory import hmsg
from holoagent_tpu_torch.memory.hmsg import HMSGraph
from holoagent_tpu_torch.memory.mapping import Mapper
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.models.tokenizer import SimpleTokenizer
from holoagent_tpu_torch.ops import image2d as timg
from holoagent_tpu_torch.ops import kmeans as tkm
from holoagent_tpu_torch.utils.labels import DEFAULT_ROOM_TYPES, get_label_feats

torch.set_num_threads(1)

# test_hmsg.py's tiny operating point with the production fold settings
CFG = {
    "main": {"depth_cut": 20.0},
    "models": {
        "clip": {"type": "test-tiny", "dtype": "float32"},
        "sam": {"type": "test-tiny", "points_per_side": 4, "pred_iou_thresh": -10.0,
                "stability_score_thresh": 0.0, "min_mask_region_area": 20, "max_masks": 8},
    },
    "pipeline": {
        "voxel_size": 0.08, "skip_frames": 2, "grid_resolution": 0.08, "point_capacity": 1 << 15,
        "mask_point_capacity": 512, "instance_capacity": 64, "instance_max_area_frac": 1.0,
        "merge_type": "paired", "extract_tiering": True,
    },
}
FLOAT_RTOL = 1e-5


# ---------------------------------------------------------------------------
# image2d and k-means, op by op
# ---------------------------------------------------------------------------


def _rasters(seed):
    rng = np.random.default_rng(seed)
    img = (rng.random((37, 53)) * 255).astype(np.float32)
    img[rng.random(img.shape) < 0.4] = 0.0
    img[0, 0] = 255.0  # the closed last bin of Otsu's histogram
    mask = rng.random((37, 53)) < 0.45
    return rng, img, mask


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sigma,radius", [(1.0, 2), (2.0, 10), (10.0, 5)])
def test_gaussian_blur(seed, sigma, radius):
    _, img, _ = _rasters(seed)
    a = np.asarray(jimg.gaussian_blur(jnp.asarray(img), sigma=sigma, radius=radius))
    b = timg.gaussian_blur(torch.from_numpy(img), sigma, radius).numpy()
    np.testing.assert_allclose(b, a, rtol=FLOAT_RTOL, atol=FLOAT_RTOL * np.abs(a).max())


@pytest.mark.parametrize("fn", ["dilate", "erode", "morph_close", "morph_open"])
@pytest.mark.parametrize("size,iterations", [(3, 1), (5, 3)])
def test_morphology(fn, size, iterations):
    _, _, mask = _rasters(2)
    a = np.asarray(getattr(jimg, fn)(jnp.asarray(mask), size, iterations))
    np.testing.assert_array_equal(getattr(timg, fn)(torch.from_numpy(mask), size, iterations).numpy(), a)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_otsu_threshold_exact(seed):
    _, img, _ = _rasters(seed)
    blurred = np.array(jimg.gaussian_blur(jnp.asarray(img), sigma=10.0, radius=5))
    for x in (img, blurred):
        assert float(timg.otsu_threshold(torch.from_numpy(x))) == float(jimg.otsu_threshold(jnp.asarray(x)))


def test_cumsum_order_matches_jax():
    x = np.random.default_rng(0).random(1000).astype(np.float32)
    for n in (7, 16, 256, 1000):
        np.testing.assert_array_equal(timg._cumsum_scan(torch.from_numpy(x[:n])).numpy(),
                                      np.asarray(jnp.cumsum(jnp.asarray(x[:n]))))


@pytest.mark.parametrize("seed", [0, 1])
def test_distance_components_holes(seed):
    _, _, mask = _rasters(seed)
    m = torch.from_numpy(mask)
    np.testing.assert_array_equal(timg.distance_transform(m).numpy(), np.asarray(jimg.distance_transform(jnp.asarray(mask))))
    lab_j = np.asarray(jimg.connected_components_2d(jnp.asarray(mask)))
    np.testing.assert_array_equal(timg.connected_components_2d(m).numpy(), lab_j)
    for it in (1, 3):  # before convergence too
        np.testing.assert_array_equal(timg.connected_components_2d(m, it).numpy(),
                                      np.asarray(jimg.connected_components_2d(jnp.asarray(mask), iters=it)))
    comp_j, sizes_j = jimg.relabel_compact(jnp.asarray(lab_j), 8)
    comp_t, sizes_t = timg.relabel_compact(torch.from_numpy(lab_j), 8)
    np.testing.assert_array_equal(comp_t.numpy(), np.asarray(comp_j))
    np.testing.assert_array_equal(sizes_t.numpy(), np.asarray(sizes_j))
    np.testing.assert_array_equal(timg.fill_holes(m).numpy(), np.asarray(jimg.fill_holes(jnp.asarray(mask))))


@pytest.mark.parametrize("iters", [5, 60])
def test_watershed_expand(iters):
    rng, _, mask = _rasters(3)
    seeds = np.where(rng.random(mask.shape) < 0.01, rng.integers(0, 5, mask.shape), -1).astype(np.int32)
    pri = rng.random(mask.shape).astype(np.float32)
    a = jimg.watershed_expand(jnp.asarray(seeds), jnp.asarray(~mask), jnp.asarray(pri), iters=iters)
    b = timg.watershed_expand(torch.from_numpy(seeds), torch.from_numpy(~mask), torch.from_numpy(pri), iters)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_find_peaks_1d():
    rng = np.random.default_rng(4)
    for trial in range(3):
        y = np.round(rng.random(300) * 6).astype(np.float32)  # plateaus and ties
        for dist in (1, 7):
            i_j, n_j = jimg.find_peaks_1d(jnp.asarray(y), jnp.float32(2.0), dist, 16)
            i_t, n_t = timg.find_peaks_1d(torch.from_numpy(y), 2.0, dist, 16)
            np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
            assert n_t == int(n_j)


def test_jax_randint_reproduced():
    for seed in range(4):
        draw = jax.jit(lambda n, s=seed: jax.random.randint(jax.random.key(s), (), 0, n))
        got = [tkm.jax_randint(seed, n) for n in range(1, 513)]
        want = [int(draw(n)) for n in range(1, 513)]
        assert got == want, seed


@pytest.mark.parametrize("n,invalid", [(30, 0), (41, 5)])
def test_kmeans(n, invalid):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = np.arange(n) < n - invalid
    c_j, l_j = jkm.kmeans(jnp.asarray(x), jnp.asarray(valid), 24)
    c_t, l_t = tkm.kmeans(torch.from_numpy(x), torch.from_numpy(valid), 24)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=FLOAT_RTOL, atol=FLOAT_RTOL)


def _storey_z(rng):
    return np.concatenate([np.zeros(26000), rng.uniform(0.35, 1.15, 9000), np.full(26000, 2.98),
                           rng.uniform(3.3, 4.1, 9000)])


@pytest.mark.parametrize("case", ["single", "two_storey"])
def test_detect_floor_boundaries(case):
    rng = np.random.default_rng(0)
    if case == "single":
        z = np.concatenate([np.zeros(4000), rng.uniform(0, 2.5, 2000), np.full(800, 2.5)]) + rng.normal(0, 0.01, 6800)
    else:
        z = _storey_z(rng)
    assert hmsg.detect_floor_boundaries(z, device="cpu") == jhmsg.detect_floor_boundaries(z)


# ---------------------------------------------------------------------------
# The graph
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    cfg = jfrom_dict(CFG)
    clip_p = jclip.init_clip(jax.random.key(0), jclip.VARIANTS["test-tiny"])
    sam_p = jsam.init_sam(jax.random.key(1), jsam.VARIANTS["test-tiny"])
    mapped = JMapper(cfg, clip_p, sam_p).run(JSyntheticDataset(num_frames=12, hw=(48, 64)))
    variant, tok = jclip.VARIANTS["test-tiny"], JTokenizer()
    lf, classes = jget_label_feats(clip_p, tok, variant, "SCANNET20")
    rt, _ = jget_label_feats(clip_p, tok, variant, "ROOM_TYPES")
    lf, rt = np.asarray(lf), np.asarray(rt)
    graph = jhmsg.HMSGraph.build(mapped, cfg, lf, classes)
    graph.generate_room_names(rt, JROOM_TYPES)
    return dict(cfg=cfg, clip=clip_p, sam=sam_p, mapped=mapped, lf=lf, rt=rt, classes=classes, graph=graph)


def _port_graph(js, method="view_embedding"):
    mapped = bridge.mapped_from_numpy(js["mapped"], "cpu")
    g = HMSGraph.build(mapped, from_dict(CFG), js["lf"], js["classes"])
    g.generate_room_names(js["rt"], DEFAULT_ROOM_TYPES, method=method)
    return g


def _assert_same_graph(gt, gj, names=True):
    """Every id, name, count and index; point arrays and embeddings equal."""
    assert [f.floor_id for f in gt.floors] == [f.floor_id for f in gj.floors]
    for ft, fj in zip(gt.floors, gj.floors):
        assert (ft.floor_zero_level, ft.floor_height, ft.name) == (fj.floor_zero_level, fj.floor_height, fj.name)
        np.testing.assert_array_equal(ft.pcd_points, fj.pcd_points)
        assert [r.room_id for r in ft.rooms] == [r.room_id for r in fj.rooms]
    assert [(r.room_id, r.floor_id) for r in gt.rooms] == [(r.room_id, r.floor_id) for r in gj.rooms]
    for rt, rj in zip(gt.rooms, gj.rooms):
        if names:
            assert rt.name == rj.name
        np.testing.assert_array_equal(rt.pcd_points, rj.pcd_points)
        assert (rt.sample_images, rt.represent_images) == (rj.sample_images, rj.represent_images)
        assert [v.view_id for v in rt.views] == [v.view_id for v in rj.views]
        assert [o.object_id for o in rt.objects] == [o.object_id for o in rj.objects]
        np.testing.assert_array_equal(np.asarray(rt.embeddings), np.asarray(rj.embeddings))
    assert [(v.view_id, v.room_id, v.img_id, v.object_ids) for v in gt.views] == \
        [(v.view_id, v.room_id, v.img_id, v.object_ids) for v in gj.views]
    assert [(o.object_id, o.room_id, o.view_ids, o.best_view_id) for o in gt.objects] == \
        [(o.object_id, o.room_id, o.view_ids, o.best_view_id) for o in gj.objects]
    if names:
        assert [o.name for o in gt.objects] == [o.name for o in gj.objects]
    for ot, oj in zip(gt.objects, gj.objects):
        np.testing.assert_array_equal(ot.pcd_points, oj.pcd_points)
        np.testing.assert_allclose(ot.embedding, oj.embedding, atol=1e-6)


def test_build_exact_given_the_same_mapped_scene(jax_side):
    gj = jax_side["graph"]
    assert len(gj.floors) >= 1 and len(gj.rooms) >= 2 and len(gj.views) >= 2 and len(gj.objects) >= 1
    _assert_same_graph(_port_graph(jax_side), gj)


def test_room_rasters_exact(jax_side):
    cfg = jax_side["cfg"]
    for fl in jax_side["graph"].floors:
        args = (fl.pcd_points, fl.floor_zero_level, fl.floor_height, cfg.pipeline.grid_resolution)
        rj, rt = jhmsg.segment_room_raster(*args), hmsg.segment_room_raster(*args, device="cpu")
        np.testing.assert_array_equal(rt.labels, rj.labels)
        np.testing.assert_array_equal(rt.origin, rj.origin)
        assert rt.labels.max() >= 1


@pytest.mark.parametrize("method", ["view_embedding", "objects", "hybrid", "llm"])
def test_room_names_exact(jax_side, method):
    gt = _port_graph(jax_side)
    gj = copy.deepcopy(jax_side["graph"])  # the fixture's graph keeps its view-embedding names

    def llm(system, prompt):
        return "a kitchen" if "cabinet" in prompt else "not sure"

    kw = {"llm": llm} if method == "llm" else {}
    for g, types in ((gt, DEFAULT_ROOM_TYPES), (gj, JROOM_TYPES)):
        g.generate_room_names(jax_side["rt"], types, method=method, **kw)
    assert [r.name for r in gt.rooms] == [r.name for r in gj.rooms]


def test_hybrid_and_objects_votes_on_a_hand_built_graph():
    """The object-affinity override and the structure filter, where the
    random towers give no such rooms."""
    from holoagent_tpu.memory.nodes import Object as JObject, Room as JRoom
    from holoagent_tpu_torch.memory.nodes import Object, Room

    types = ("bathroom", "library", "kitchen")
    tf = np.eye(3, 8, dtype=np.float32)
    names = []
    for G, R, O in ((HMSGraph, Room, Object), (jhmsg.HMSGraph, JRoom, JObject)):
        g = G()
        for ri, objs in enumerate((("toilet", "sink", "floor"), ("stove", "refrigerator", "wall"), ())):
            r = R(f"0_{ri}", "0")
            r.embeddings = [np.eye(8, dtype=np.float32)[(ri + j) % 3] for j in range(3)]
            for oi, nm in enumerate(objs):
                o = O(f"0_{ri}_{oi}", r.room_id, name=nm)
                o.embedding = np.eye(8, dtype=np.float32)[oi % 3]
                r.objects.append(o)
            g.rooms.append(r)
        out = []
        for method in ("hybrid", "objects", "view_embedding"):
            g.generate_room_names(tf, types, method=method)
            out.append([r.name for r in g.rooms])
        names.append(out)
    assert names[0] == names[1]
    assert names[0][0][0] == "bathroom" and names[0][0][1] == "kitchen"


def test_build_with_kmeans_views_two_storey():
    """A two-storey scene of sampled slabs and walls with 40 keyframes in
    one room: the floors, rooms and k-means representative views
    (>= 24 frames a room) are exact."""
    rng = np.random.default_rng(0)

    def storey(z0, divide):  # test_hmsg.py's _story_points: slab, walls, a wall with a door gap
        w, h = 6.0, 4.0
        gx, gy = np.meshgrid(np.linspace(0, w, 150), np.linspace(0, h, 110))
        parts = [np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z0)], -1)]
        tt, hh = np.meshgrid(np.linspace(0, 1, 130), np.linspace(z0, z0 + 2.5, 60))
        t, zz, n = tt.ravel(), hh.ravel(), tt.size
        parts += [np.stack([t * w, np.zeros(n), zz], -1), np.stack([t * w, np.full(n, h), zz], -1),
                  np.stack([np.zeros(n), t * h, zz], -1), np.stack([np.full(n, w), t * h, zz], -1)]
        if divide:
            dy, dz = np.meshgrid(np.concatenate([np.linspace(0, 1.5, 60), np.linspace(2.5, h, 60)]),
                                 np.linspace(z0, z0 + 2.5, 60))
            parts.append(np.stack([np.full(dy.size, 3.0), dy.ravel(), dz.ravel()], -1))
        p = np.concatenate(parts).astype(np.float32)
        return p + rng.normal(0, 0.004, p.shape).astype(np.float32)

    pts = np.concatenate([storey(0.0, True), storey(2.8, False)])
    scene = jscene.init_scene(JGridSpec.centered(0.05), 1 << 17, 8)
    scene, _ = jscene.insert_points(scene, jnp.asarray(pts), jnp.full((len(pts), 3), 0.5), jnp.ones(len(pts), bool))
    k = np.array([[20.0, 0, 4], [0, 20.0, 4], [0, 0, 1]], np.float32)
    frames = []
    for i in range(46):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = (1.0 + 0.02 * i, 1.0 + 0.03 * (i % 7), 1.5 if i < 40 else 4.3)
        frames.append(JRGBDFrame(np.zeros((8, 8, 3), np.float32), np.zeros((8, 8), np.float32), pose, k))
    feats = rng.normal(size=(46, 8)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    jm = JMappedScene(scene=scene, instances=jinst.empty_instances(8, 64, 8), instance_feats=jnp.zeros((8, 8)),
                      keyframes=frames, keyframe_feats=jnp.asarray(feats))
    jcfg = jfrom_dict({"pipeline": {"voxel_size": 0.05, "grid_resolution": 0.08, "point_capacity": 1 << 17}})
    cfg = from_dict({"pipeline": {"voxel_size": 0.05, "grid_resolution": 0.08, "point_capacity": 1 << 17}})
    lf, classes = np.eye(4, 8, dtype=np.float32), ["a", "b", "c", "d"]
    gj = jhmsg.HMSGraph.build(jm, jcfg, lf, classes)
    gt = HMSGraph.build(bridge.mapped_from_numpy(jm, "cpu"), cfg, lf, classes)
    assert [len(f.rooms) for f in gj.floors] == [2, 1]
    assert max(len(r.sample_images) for r in gj.rooms) >= 24  # k-means ran
    assert any(len(r.represent_images) < len(r.sample_images) for r in gj.rooms)
    _assert_same_graph(gt, gj)


@pytest.fixture(scope="module")
def port_end_to_end(jax_side):
    """The port's own Mapper, label features and build, from the JAX
    weights carried over."""
    variant = tclip.VARIANTS["test-tiny"]
    np_clip = jax.tree.map(np.asarray, jax_side["clip"])
    clip_t = bridge.clip_from_jax(np_clip, variant, device="cpu")
    text_t = bridge.clip_text_from_jax(np_clip, variant, device="cpu")
    sam_t = bridge.sam_from_jax(jax.tree.map(np.asarray, jax_side["sam"]), tsam.VARIANTS["test-tiny"], device="cpu")
    cfg = from_dict(CFG)
    mapped = Mapper(cfg, clip_t, sam_t, device="cpu").run(SyntheticDataset(num_frames=12, hw=(48, 64)))
    tok = SimpleTokenizer()
    lf, classes = get_label_feats(text_t, tok, "SCANNET20")
    rt, _ = get_label_feats(text_t, tok, "ROOM_TYPES")
    g = HMSGraph.build(mapped, cfg, lf, classes)
    g.generate_room_names(rt, DEFAULT_ROOM_TYPES)
    return g


def test_end_to_end_graph(jax_side, port_end_to_end):
    """Both packages map with their own towers (the same weights) and
    build: floors, rooms and views exact; an object's name may differ only
    where its top two label scores (JAX) are within 1e-3."""
    gt, gj = port_end_to_end, jax_side["graph"]
    assert [(r.room_id, r.name) for r in gt.rooms] == [(r.room_id, r.name) for r in gj.rooms]
    assert [(v.view_id, v.img_id) for v in gt.views] == [(v.view_id, v.img_id) for v in gj.views]
    assert [f.floor_zero_level for f in gt.floors] == [f.floor_zero_level for f in gj.floors]
    assert [o.object_id for o in gt.objects] == [o.object_id for o in gj.objects]
    lf = jax_side["lf"]
    for ot, oj in zip(gt.objects, gj.objects):
        if ot.name != oj.name:
            top2 = np.sort(lf @ oj.embedding)[-2:]
            assert top2[1] - top2[0] < 1e-3, (ot.object_id, ot.name, oj.name, top2)


def _fields(g):
    return dict(
        floors=[(f.floor_id, f.name, f.floor_zero_level, f.floor_height, np.asarray(f.vertices).tolist(),
                 f.pcd_points.tolist(), f.pcd_colors.tolist()) for f in g.floors],
        rooms=[(r.room_id, r.floor_id, r.name, r.room_zero_level, r.room_height, r.represent_images,
                r.sample_images, [e.tolist() for e in r.embeddings], [e.tolist() for e in r.clip_embeddings],
                r.pcd_points.tolist(), [o.object_id for o in r.objects], [v.view_id for v in r.views])
               for r in g.rooms],
        objects=[(o.object_id, o.room_id, o.name, o.view_ids, o.best_view_id, o.embedding.tolist(),
                  o.pcd_points.tolist(), o.pcd_colors.tolist(), np.asarray(o.vertices).tolist()) for o in g.objects],
        views=[(v.view_id, v.room_id, v.img_id, v.object_ids, v.text_discription, v.img_path) for v in g.views],
    )


def test_persistence_across_packages(jax_side, tmp_path):
    """The same graph saved by both packages: byte-identical files; each
    package loads the other's with identical fields."""
    gj, gt = jax_side["graph"], _port_graph(jax_side)
    gj.save(tmp_path / "jax")
    gt.save(tmp_path / "port")
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    ref = _fields(jhmsg.HMSGraph.load(tmp_path / "jax"))
    assert _fields(HMSGraph.load(tmp_path / "jax")) == ref
    assert _fields(jhmsg.HMSGraph.load(tmp_path / "port")) == _fields(HMSGraph.load(tmp_path / "port")) == ref
    assert json.loads((tmp_path / "port" / "rooms" / f"{gt.rooms[0].room_id}.json").read_text())["name"]


def test_debug_artifacts(jax_side, tmp_path):
    cfg = from_dict({**CFG, "main": {"save_path": str(tmp_path), "scene_id": "s"},
                     "pipeline": {**CFG["pipeline"], "save_intermediate_results": True}})
    HMSGraph.build(bridge.mapped_from_numpy(jax_side["mapped"], "cpu"), cfg, jax_side["lf"], jax_side["classes"])
    dbg = tmp_path / "s" / "debug"
    assert (dbg / "floor_z_histogram.npy").exists() and json.loads((dbg / "floor_bounds.json").read_text())
    assert np.load(dbg / "room_labels_floor0.npy").ndim == 2


def test_check_object_in_view():
    k = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    for pts in (np.array([[0.0, 0.0, 2.0], [0.1, 0.1, 2.0]]), np.array([[0.0, 0.0, -2.0]]), np.array([[5.0, 0, 1.0]])):
        assert hmsg.check_object_in_view(64, 48, k, np.eye(4), pts) == jhmsg.check_object_in_view(64, 48, k, np.eye(4), pts)
        assert hmsg._visible_ratio(64, 48, k, np.eye(4), pts) == jhmsg._visible_ratio(64, 48, k, np.eye(4), pts)
