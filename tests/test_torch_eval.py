"""The accuracy protocol's oracle row against the JAX package: oracle
perception, per-pixel features, the GT graphs, the evaluator, long queries,
the Mapper without towers, and the whole ``eval_protocol.run_one`` on the
two-room fixture.

Tolerances: masks, counts and every metric exact; features within 1e-6;
the floor bound error within 1e-6 m.  The JAX side runs on the CPU.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.apps import eval_graph as jeval_graph
from holoagent_tpu.apps import eval_protocol as jeval_protocol
from holoagent_tpu.dataloader import SyntheticDataset as JSyntheticDataset
from holoagent_tpu.dataloader import SyntheticScene as JSyntheticScene
from holoagent_tpu.eval import gt as jgt
from holoagent_tpu.eval import instruction_sets as jinstr
from holoagent_tpu.eval import long_query as jlq
from holoagent_tpu.eval import metrics as jmetrics
from holoagent_tpu.eval.evaluator import HMSGEvaluator as JEvaluator
from holoagent_tpu.memory import hmsg as jhmsg
from holoagent_tpu.memory import nodes as jnodes
from holoagent_tpu.perception import extractor as jextractor
from holoagent_tpu.perception import oracle as joracle
from holoagent_tpu_torch.apps import eval_graph, eval_protocol
from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.dataloader import SyntheticDataset, SyntheticScene
from holoagent_tpu_torch.eval import gt as tgt
from holoagent_tpu_torch.eval import instruction_sets as tinstr
from holoagent_tpu_torch.eval import long_query as tlq
from holoagent_tpu_torch.eval import metrics as tmetrics
from holoagent_tpu_torch.eval.evaluator import HMSGEvaluator
from holoagent_tpu_torch.memory import hmsg, nodes
from holoagent_tpu_torch.memory.mapping import Mapper
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.perception import extractor, oracle

FEAT_TOL = 1e-6


def _frames(layout, n=4, hw=(60, 80)):
    """A few rendered frames of a fixture scene, in both packages."""
    ds = SyntheticDataset(getattr(SyntheticScene, layout)(), num_frames=8, hw=hw, gaze_heights=(0.8, 2.2))
    jds = JSyntheticDataset(getattr(JSyntheticScene, layout)(), num_frames=8, hw=hw, gaze_heights=(0.8, 2.2))
    out = []
    assert len(ds) == len(jds)
    for i in range(0, len(ds), max(1, len(ds) // n)):
        inst, lab = ds.gt(i)
        jinst, jlab = jds.gt(i)
        np.testing.assert_array_equal(inst, jinst)
        np.testing.assert_array_equal(lab, jlab)
        out.append((inst, lab))
    return ds.scene.labels(), out


def test_onehot_label_feats():
    for labels, dim in ((["a", "b", "c"], 32), ([str(i) for i in range(40)], 32)):
        np.testing.assert_array_equal(oracle.onehot_label_feats(labels, dim), joracle.onehot_label_feats(labels, dim))


@pytest.mark.parametrize("layout", ["two_room", "three_room"])
@pytest.mark.parametrize("max_masks,min_area", [(16, 20), (3, 200)])  # 3: more instances than slots
def test_oracle_frame_features_and_per_pixel(layout, max_masks, min_area):
    labels, frames = _frames(layout)
    for inst, lab in frames:
        ff = oracle.oracle_frame_features(inst, lab, labels, 32, max_masks=max_masks, min_area=min_area,
                                          device="cpu")
        jff = joracle.oracle_frame_features(inst, lab, labels, 32, max_masks=max_masks, min_area=min_area)
        for name in ("masks", "valid", "boxes"):
            np.testing.assert_array_equal(getattr(ff, name).numpy(), np.asarray(getattr(jff, name)), err_msg=name)
        assert ff.masks.dtype == torch.bool and ff.f_global.dtype == torch.float32
        np.testing.assert_allclose(ff.f_masks.numpy(), np.asarray(jff.f_masks), atol=FEAT_TOL)
        np.testing.assert_allclose(ff.f_global.numpy(), np.asarray(jff.f_global), atol=FEAT_TOL)
        for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float16, jnp.float16)):
            pix = extractor.per_pixel_features(ff, dtype=dtype)
            jpix = np.asarray(jextractor.per_pixel_features(jff, dtype=jdtype))
            assert pix.dtype == dtype and pix.shape == jpix.shape == inst.shape + (32,)
            np.testing.assert_allclose(pix.float().numpy(), jpix.astype(np.float32),
                                       atol=FEAT_TOL if dtype == torch.float32 else 1e-3)


def _assert_same_gt(g, jg):
    assert [(f.id, f.lower, f.upper) for f in g.floors] == [(f.id, f.lower, f.upper) for f in jg.floors]
    assert [(r.id, r.floor_id, r.category, r.min_height, r.max_height) for r in g.rooms] == \
        [(r.id, r.floor_id, r.category, r.min_height, r.max_height) for r in jg.rooms]
    for r, jr in zip(g.rooms, jg.rooms):
        np.testing.assert_array_equal(r.bev_points, jr.bev_points)
    assert [(o.id, o.region_id, o.floor_id, o.category) for o in g.objects] == \
        [(o.id, o.region_id, o.floor_id, o.category) for o in jg.objects]
    for o, jo in zip(g.objects, jg.objects):
        for name in ("points", "center", "dims"):
            np.testing.assert_array_equal(np.asarray(getattr(o, name)), np.asarray(getattr(jo, name)))


@pytest.mark.parametrize("layout", ["two_room", "three_room", "two_floor"])
def test_gt_from_synthetic_and_json_across_packages(layout, tmp_path):
    rects = jeval_protocol.LAYOUTS[layout][1] if layout in jeval_protocol.LAYOUTS else None
    if layout == "two_floor":
        rects = JSyntheticScene.two_floor_room_rects()
        assert rects == SyntheticScene.two_floor_room_rects()
    g = tgt.gt_from_synthetic(getattr(SyntheticScene, layout)(), room_rects=rects)
    jg = jgt.gt_from_synthetic(getattr(JSyntheticScene, layout)(), room_rects=rects)
    _assert_same_gt(g, jg)
    g.to_json(tmp_path / "port" / "scene_info.json")
    jg.to_json(tmp_path / "jax" / "scene_info.json")
    assert (tmp_path / "port" / "scene_info.json").read_bytes() == (tmp_path / "jax" / "scene_info.json").read_bytes()
    _assert_same_gt(tgt.GTGraph.from_json(tmp_path / "jax" / "scene_info.json"), jg)
    _assert_same_gt(jgt.GTGraph.from_json(tmp_path / "port" / "scene_info.json"), jg)


def test_instruction_sets():
    assert tinstr.three_room_instructions() == jinstr.three_room_instructions()
    assert tinstr.two_room_instructions() == jinstr.two_room_instructions()
    assert len(tinstr.three_room_instructions()) == 70


def test_segmentation_metrics():
    rng = np.random.default_rng(0)
    pred, gt = rng.integers(-1, 7, 5000), rng.integers(-1, 6, 5000)
    conf = tmetrics.confusion_matrix(pred, gt, 6)
    np.testing.assert_array_equal(conf, jmetrics.confusion_matrix(pred, gt, 6))
    assert tmetrics.segmentation_metrics(conf) == jmetrics.segmentation_metrics(conf)


def _hand_graph(mod, graph_cls, gt, seed=0):
    """A predicted graph near `gt`: one floor, a room per GT room (a
    shifted footprint), an object per GT object (a noisy subset of its
    surface, one split in two) and one spurious object."""
    rng = np.random.default_rng(seed)
    g = graph_cls()
    fl = mod.Floor("0", name="floor_0")
    fl.floor_zero_level, fl.floor_height = gt.floors[0].lower + 0.05, gt.floors[0].upper - gt.floors[0].lower - 0.1
    g.floors.append(fl)
    rooms = []
    for gr in gt.rooms:
        r = mod.Room(f"0_{gr.id}", "0", name=gr.category)
        r.vertices = gr.bev_points[rng.random(len(gr.bev_points)) < 0.7] + np.array([0.3, 0.0])
        r.room_zero_level, r.room_height = gr.min_height, gr.max_height - gr.min_height
        fl.add_room(r)
        g.rooms.append(r)
        rooms.append(r)
    labels = sorted({o.category for o in gt.objects})
    tf = np.eye(len(labels), 32, dtype=np.float32)
    for oi, go in enumerate(gt.objects):
        pts = go.points[rng.random(len(go.points)) < 0.6] + rng.normal(0, 0.02, (1, 3))
        parts = [pts[pts[:, 0] < go.center[0]], pts[pts[:, 0] >= go.center[0]]] if oi == 0 else [pts]
        for pi, part in enumerate(parts):
            o = mod.Object(f"0_{go.region_id}_{oi}_{pi}", rooms[go.region_id].room_id, name=go.category)
            o.pcd_points = part
            e = tf[labels.index(go.category)] + 0.3 * rng.normal(size=32).astype(np.float32)
            o.embedding = (e / np.linalg.norm(e)).astype(np.float32)
            rooms[go.region_id].add_object(o)
            g.objects.append(o)
    o = mod.Object("0_0_spurious", rooms[0].room_id, name="clutter")
    o.pcd_points = rng.uniform(0.2, 0.6, (50, 3))
    o.embedding = tf[0]
    g.objects.append(o)
    return g, tf, labels


@pytest.mark.parametrize("layout", ["two_room", "three_room"])
def test_evaluate_all_on_a_hand_built_graph(layout):
    rects = jeval_protocol.LAYOUTS[layout][1]
    gt = tgt.gt_from_synthetic(getattr(SyntheticScene, layout)(), room_rects=rects)
    jgt_ = jgt.gt_from_synthetic(getattr(JSyntheticScene, layout)(), room_rects=rects)
    g, tf, labels = _hand_graph(nodes, hmsg.HMSGraph, gt)
    jg, _, _ = _hand_graph(jnodes, jhmsg.HMSGraph, jgt_)
    m = HMSGEvaluator(gt).evaluate_all(g, gt_text_feats=tf, gt_classes=labels)
    jm = JEvaluator(jgt_).evaluate_all(jg, gt_text_feats=tf, gt_classes=labels)
    assert json.dumps(m, default=float, sort_keys=True) == json.dumps(jm, default=float, sort_keys=True)
    assert m["objects"]["num_pred"] == len(gt.objects) + 2 and 0.0 < m["objects"]["auc"] < 0.95


@pytest.mark.parametrize("layout", ["three_room", "two_floor"])
def test_long_queries(layout):
    rects = jeval_protocol.LAYOUTS[layout][1] if layout == "three_room" else SyntheticScene.two_floor_room_rects()
    gt = tgt.gt_from_synthetic(getattr(SyntheticScene, layout)(), room_rects=rects)
    jgt_ = jgt.gt_from_synthetic(getattr(JSyntheticScene, layout)(), room_rects=rects)
    qs, jqs = tlq.generate_long_queries(gt), jlq.generate_long_queries(jgt_)
    assert [(q.text, q.floor_id, q.room_category, q.object_category, q.answers) for q in qs] == \
        [(q.text, q.floor_id, q.room_category, q.object_category, q.answers) for q in jqs]
    rng = np.random.default_rng(1)
    objs = {o.id: o for o in gt.objects}
    preds = []
    for i, q in enumerate(qs):  # right, wrong and missing answers at each level
        a = q.answers[0]
        p = {}
        if i % 4 != 3:
            p["floor_id"] = a[0] if i % 2 == 0 else a[0] + 1
            p["room_center"] = gt.rooms[a[1]].bev_points.mean(0) + (0 if i % 3 else 5.0)
            p["object_center"] = objs[a[2]].center + rng.normal(0, 0.2 if i % 2 else 2.0, 3)
        preds.append(p)
    r, jr = tlq.score_long_queries(qs, preds, gt), jlq.score_long_queries(jqs, preds, jgt_)
    assert (r.n_queries, r.floor_acc, r.room_acc, r.object_acc, r.per_query) == \
        (jr.n_queries, jr.floor_acc, jr.room_acc, jr.object_acc, jr.per_query)
    assert 0.0 < r.object_acc < 1.0
    with pytest.raises(ValueError):
        tlq.score_long_queries(qs, preds[:-1], gt)


def test_mapper_without_towers():
    cfg = from_dict({"models": {"clip": {"type": "test-tiny", "dtype": "float32"}},
                     "pipeline": {"point_capacity": 1 << 14, "mask_point_capacity": 512, "instance_capacity": 16}})
    mapper = Mapper(cfg, device="cpu")
    assert mapper.clip_variant is tclip.VARIANTS["test-tiny"] and mapper.scene.sum_feat.shape[-1] == 32
    ds = SyntheticDataset(num_frames=2, hw=(48, 64))
    with pytest.raises(ValueError, match="FrameFeatures"):
        mapper.process_frame(ds[0])
    inst, lab = ds.gt(0)
    labels = ds.scene.labels()
    mapper.process_frame(ds[0], ff=oracle.oracle_frame_features(inst, lab, labels, 32, device="cpu"))
    assert int(mapper.scene.num) > 0 and mapper.finalize().keyframe_feats.shape == (1, 32)
    wide = Mapper(cfg, device="cpu", clip_variant=tclip.VARIANTS["ViT-B-32"])
    assert wide.scene.sum_feat.shape[-1] == 512
    visual = tclip.CLIPVisual(tclip.VARIANTS["test-tiny"], dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="config dtype"):  # a tower that is given is still checked
        Mapper(cfg, clip=visual, device="cpu")


# ---------------------------------------------------------------------------
# The oracle row on the two-room fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle_row(tmp_path_factory):
    save_dir = tmp_path_factory.mktemp("oracle") / "two_room_seed0"
    got = eval_protocol.run_one(0, layout="two_room", device="cpu", save_dir=str(save_dir))
    want = jeval_protocol.run_one(0)
    return got, want, save_dir


def _without(d, *keys):
    return {k: v for k, v in d.items() if k not in keys}


def test_oracle_row_equals_the_reference(oracle_row):
    got, want, _ = oracle_row
    assert abs(got["floors"]["mean_bound_error"] - want["floors"]["mean_bound_error"]) <= 1e-6
    assert _without(got["floors"], "mean_bound_error") == _without(want["floors"], "mean_bound_error")
    assert got["rooms"] == want["rooms"]
    assert json.dumps(got["objects"], default=float) == json.dumps(want["objects"], default=float)
    assert got["segmentation"] == want["segmentation"]


def test_oracle_row_passes_the_reference_gates(oracle_row):
    """tests/test_eval_protocol.py's asserts, on the port's run."""
    m = oracle_row[0]
    assert m["floors"]["num_pred"] == 1
    assert m["floors"]["mean_bound_error"] < 0.3
    assert m["rooms"]["precision"] == 1.0
    assert m["rooms"]["recall"] == 1.0
    assert m["objects"]["rec_at_50"] == 1.0
    assert m["objects"]["prec_at_50"] >= 0.8
    assert m["objects"]["auc"] > 0.8
    assert m["objects"]["semantic_top_k"][1] == 1.0
    assert m["segmentation"]["mIoU"] == 1.0


def test_eval_graph_on_the_saved_oracle_graph(oracle_row, tmp_path):
    _, _, save_dir = oracle_row
    graph_dir, gt_path = save_dir / "graph", save_dir / "gt" / "scene_info.json"
    got = eval_graph.main(["--graph", str(graph_dir), "--gt", str(gt_path), "--out", str(tmp_path / "p.json")])
    want = jeval_graph.run(str(graph_dir), str(gt_path), str(tmp_path / "j.json"))
    assert json.dumps(got, default=float) == json.dumps(want, default=float)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    assert got["objects"]["rec_at_50"] == 1.0


def test_run_writes_the_reference_schema(oracle_row, tmp_path, monkeypatch):
    """`run` over two layouts and two seeds, with run_one's result replaced
    by the fixture's: the summary's schema, the markdown table, the JSON;
    the neural row raises."""
    with pytest.raises(NotImplementedError, match="item 9"):
        eval_protocol.run(seeds=1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        eval_protocol.run_one(0, perception="neural", device="cpu")
    got = oracle_row[0]
    calls = []
    monkeypatch.setattr(eval_protocol, "run_one",
                        lambda s, layout, device, timer, save_dir: calls.append((layout, s, save_dir)) or got)
    timers = {}
    summary = eval_protocol.run(seeds=2, neural=False, out_md=str(tmp_path / "e.md"),
                                out_json=str(tmp_path / "e.json"), device="cpu", save_dir=str(tmp_path),
                                timers=timers)
    assert calls == [(lay, s, str(tmp_path / f"{lay}_seed{s}")) for lay in eval_protocol.LAYOUTS for s in (0, 1)]
    assert set(timers) == {(lay, s) for lay in eval_protocol.LAYOUTS for s in (0, 1)}
    assert all(t.calls["run"] == 1 for t in timers.values())
    assert set(summary) == {"seeds", "wall_seconds", "metrics", "metrics_neural", "per_seed", "per_seed_neural"}
    assert [name for name, _ in eval_protocol.ROWS] == list(summary["metrics"])
    assert summary["metrics"]["object precision@50"] == {"mean": 1.0, "std": 0.0}
    assert len(summary["per_seed"]) == 4
    assert json.loads((tmp_path / "e.json").read_text())["metrics"] == summary["metrics"]
    md = (tmp_path / "e.md").read_text()
    assert "| semantic top-1 | 1.000 | 0.000 | — | — |" in md
