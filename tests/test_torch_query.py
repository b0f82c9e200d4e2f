"""The fast query path against the JAX package: the rule parser, the
retrieval ops, and FSRQueryEngine on the same graph with the same text
features; then apps.build_map on the CPU, end to end into the engine.

Tolerances: parses, indices and ids exact; scores within 1e-5.
"""

import json
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.memory import hmsg as jhmsg
from holoagent_tpu.memory import nodes as jnodes
from holoagent_tpu.ops import retrieval as jret
from holoagent_tpu.query.engine import FSRQueryEngine as JEngine
from holoagent_tpu.query.parser import RuleParser as JRuleParser
from holoagent_tpu_torch.apps import build_map
from holoagent_tpu_torch.apps.common import load_models, tokenizer
from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.dataloader import SyntheticDataset
from holoagent_tpu_torch.memory import nodes
from holoagent_tpu_torch.memory.hmsg import HMSGraph
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.ops import retrieval as tret
from holoagent_tpu_torch.query import FSRQueryEngine, RuleParser
from holoagent_tpu_torch.training.zoo import fixture_labels
from holoagent_tpu_torch.utils.labels import DEFAULT_ROOM_TYPES, SCANNET_LABELS_20

torch.set_num_threads(1)

SCORE_TOL = 1e-5
INSTRUCTIONS = [
    "find the chair in the kitchen on floor 2", "mirror in region bathroom on floor 1", "the table",
    "go to the bathroom", "take me to the sofa in the living room", "bring me a desk on the second floor",
    "look for the door inside the office", "sink in the unknown room", "去二楼的厨房找椅子", "在卧室里找床",
    "带我去沙发", "please find the bed on the ground floor", "curtain",
]
D = 32


def test_rule_parser():
    p, jp = RuleParser(), JRuleParser()
    for spec in (("obj", "room", "floor"), ("obj", "room"), ("obj",)):
        p, jp = RuleParser(spec), JRuleParser(spec)
        for q in INSTRUCTIONS:
            assert p(q).astuple() == jp(q).astuple(), q


def _gallery(n=40, q=3, c=6, seed=0):
    rng = np.random.default_rng(seed)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    g = unit(rng.normal(size=(n, D)))
    return g, rng.random(n) < 0.8, unit(rng.normal(size=(q, D))), unit(rng.normal(size=(c, D)))


def test_topk_cosine_and_class_filtered():
    g, valid, qs, cls = _gallery()
    s_j, i_j = jret.topk_cosine(jnp.asarray(g), jnp.asarray(valid), jnp.asarray(qs), 5)
    s_t, i_t = tret.topk_cosine(torch.from_numpy(g), torch.from_numpy(valid), torch.from_numpy(qs), 5)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=SCORE_TOL)
    for qc in range(cls.shape[0]):
        s_j, i_j = jret.class_filtered_topk(jnp.asarray(g), jnp.asarray(valid), jnp.asarray(cls[qc]), jnp.asarray(cls),
                                            jnp.int32(qc), 4)
        s_t, i_t = tret.class_filtered_topk(torch.from_numpy(g), torch.from_numpy(valid), torch.from_numpy(cls[qc]),
                                            torch.from_numpy(cls), qc, 4)
        real = np.isfinite(np.asarray(s_j))
        np.testing.assert_array_equal(np.isfinite(s_t.numpy()), real)
        np.testing.assert_array_equal(i_t.numpy()[real], np.asarray(i_j)[real])
        np.testing.assert_allclose(s_t.numpy()[real], np.asarray(s_j)[real], atol=SCORE_TOL)


@pytest.mark.parametrize("k", [1, 5, 30])  # 30: more lanes than eligible objects (filler lanes)
def test_negative_prompt_topk(k):
    g, valid, _, cls = _gallery(seed=1)
    for qid in range(cls.shape[0]):
        s_j, i_j = jret.negative_prompt_topk(jnp.asarray(g), jnp.asarray(valid), jnp.asarray(cls), jnp.int32(qid), k)
        s_t, i_t = tret.negative_prompt_topk(torch.from_numpy(g), torch.from_numpy(valid), torch.from_numpy(cls), qid, k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=SCORE_TOL)
    assert (i_t.numpy() == -1).any() == (k == 30)


# ---------------------------------------------------------------------------
# The engine on one graph, in both packages
# ---------------------------------------------------------------------------

NAMES = list(SCANNET_LABELS_20[2:14])


def _feature(text: str) -> np.ndarray:
    """A fixed unit vector per text: both engines score with the same text
    features (the text towers' agreement is test_torch_text.py's)."""
    v = np.random.default_rng(zlib.crc32(text.encode())).normal(size=D)
    return (v / np.linalg.norm(v)).astype(np.float32)


def _graph(mod, graph_cls, n_objects):
    """Two floors, rooms named after room types, `n_objects` objects whose
    embeddings lean toward their name's feature."""
    rng = np.random.default_rng(7)
    g = graph_cls()
    for fi, z in enumerate((0.0, 3.0)):
        fl = mod.Floor(str(fi), name=f"floor_{fi}")
        fl.floor_zero_level, fl.floor_height = z, 2.8
        g.floors.append(fl)
        for ri in range(3):
            r = mod.Room(f"{fi}_{ri}", fl.floor_id, name=DEFAULT_ROOM_TYPES[(3 * fi + ri) % 6])
            r.embeddings = [_feature(r.name) + 0.5 * rng.normal(size=D).astype(np.float32) for _ in range(2)]
            fl.add_room(r)
            g.rooms.append(r)
    for oi in range(n_objects):
        room = g.rooms[oi % len(g.rooms)]
        o = mod.Object(f"{room.room_id}_{room.object_counter}", room.room_id, name=NAMES[oi % len(NAMES)])
        room.object_counter += 1
        e = _feature(o.name) + 0.9 * rng.normal(size=D).astype(np.float32)
        o.embedding = (e / np.linalg.norm(e)).astype(np.float32)
        room.add_object(o)
        g.objects.append(o)
    return g


class _Variant:
    embed_dim = D


def _engines(n_objects):
    tok = tokenizer()
    text = tclip.CLIPText(tclip.VARIANTS["test-tiny"], device="cpu")
    te = FSRQueryEngine(_graph(nodes, HMSGraph, n_objects), text, tok, device="cpu")
    je = JEngine(_graph(jnodes, jhmsg.HMSGraph, n_objects), None, tok, _Variant())
    for e in (te, je):
        e.text_feats = lambda texts: np.stack([_feature(t) for t in texts])
    return te, je


@pytest.mark.parametrize("n_objects", [60, 600])  # 600: the on-device negative_prompt_topk route
def test_engine_queries(n_objects):
    te, je = _engines(n_objects)
    for q in ("2", "0", "1", "second", "floor 1", None):
        assert te.query_floor(q) == je.query_floor(q), q
    for floor_id in (-1, 0, 1):
        for q in ("kitchen", "bathroom", "unknown", "", None, "living room"):
            assert te.query_room(q, floor_id) == je.query_room(q, floor_id), (q, floor_id)
        for q in NAMES[:6] + ["background", "plant"]:
            for room_ids in ((), (0,), (0, 2)):
                for neg, top_k in ((["background"], 1), (["background", "wall"], 5), ([], 3)):
                    got = te.query_object(q, floor_id, room_ids, top_k, neg)
                    want = je.query_object(q, floor_id, room_ids, top_k, neg)
                    assert got[:2] == want[:2], (q, floor_id, room_ids, neg)
                    np.testing.assert_allclose(got[2], want[2], atol=SCORE_TOL)


def test_engine_hierarchy():
    te, je = _engines(600)
    for q in INSTRUCTIONS:
        for top_k in (1, 5):
            ft, rt, ot, res_t = te.query_hierarchy(q, top_k=top_k)
            fj, rj, oj, res_j = je.query_hierarchy(q, top_k=top_k)
            assert (ft and ft.floor_id) == (fj and fj.floor_id), q
            assert [r.room_id for r in rt] == [r.room_id for r in rj], q
            assert [o.object_id for o in ot] == [o.object_id for o in oj], q
            np.testing.assert_allclose(res_t["scores"], res_j["scores"], atol=SCORE_TOL)
            assert set(res_t) == set(res_j) and res_t["Total_Time"] == res_t["FastMatching"] >= 0
    # the slow path without an image provider: the fast pick at top 5, as the reference's
    for q in INSTRUCTIONS:
        ft, rt, ot, res_t = te.query_hierarchy(q, use_slow=True)
        fj, rj, oj, res_j = je.query_hierarchy(q, use_slow=True)
        assert [o.object_id for o in ot] == [o.object_id for o in oj], q
        assert set(res_t) == set(res_j) and res_t["Total_Time"] == res_t["FastMatching"] >= 0


def test_engine_text_feats_cache(monkeypatch):
    """Texts are encoded once, only the uncached ones of a call."""
    text = tclip.CLIPText(tclip.VARIANTS["test-tiny"], device="cpu")
    for p in text.parameters():
        torch.nn.init.normal_(p, std=0.05)
    eng = FSRQueryEngine(_graph(nodes, HMSGraph, 4), text, tokenizer(), device="cpu")
    calls = []
    real = tclip.text_features_multi_template
    monkeypatch.setattr(tclip, "text_features_multi_template", lambda t, tok, labels: calls.append(list(labels))
                        or real(t, tok, labels))
    a = eng.text_feats(["chair", "table"])
    b = eng.text_feats(["table", "chair", "sofa"])
    assert calls == [["chair", "table"], ["sofa"]]
    np.testing.assert_array_equal(a[::-1], b[:2])
    assert b.shape == (3, D) and np.isfinite(b).all()


# ---------------------------------------------------------------------------
# build_map on the CPU
# ---------------------------------------------------------------------------

TINY = {
    "models": {
        "clip": {"type": "test-tiny", "dtype": "float32"},
        "sam": {"type": "test-tiny", "dtype": "float32", "points_per_side": 4, "pred_iou_thresh": -10.0,
                "stability_score_thresh": 0.0, "min_mask_region_area": 20, "max_masks": 8},
    },
    "pipeline": {"voxel_size": 0.08, "skip_frames": 2, "grid_resolution": 0.08, "point_capacity": 1 << 15,
                 "mask_point_capacity": 512, "instance_capacity": 64, "instance_max_area_frac": 1.0,
                 "merge_type": "paired", "extract_tiering": True, "obj_labels": "FIXTURE"},
}


def test_build_map_run_then_query(tmp_path):
    cfg = from_dict({**TINY, "main": {"save_path": str(tmp_path), "scene_id": "s"}})
    models = load_models(cfg, device="cpu")
    graph_dir, g = build_map.run(cfg, dataset=SyntheticDataset(num_frames=12, hw=(48, 64)), models=models,
                                 device="cpu")
    assert graph_dir.parent == tmp_path / "s" and (tmp_path / "s" / "full_pcd.ply").exists()
    stats = json.loads((tmp_path / "s" / "build_stats.json").read_text())
    assert stats["frames"] == 6 and stats["rooms"] == len(g.rooms) >= 1
    assert stats["views"] == len(g.views) >= 6  # every keyframe, and a nearest one for a room without
    assert sorted(p.name for p in (tmp_path / "label_cache").iterdir()) == ["FIXTURE_test-tiny.npy",
                                                                            "ROOM_TYPES_test-tiny.npy"]
    loaded = HMSGraph.load(graph_dir)
    assert [(r.room_id, r.name) for r in loaded.rooms] == [(r.room_id, r.name) for r in g.rooms]
    assert [(o.object_id, o.name) for o in loaded.objects] == [(o.object_id, o.name) for o in g.objects]
    assert all(r.name in DEFAULT_ROOM_TYPES for r in g.rooms)
    assert all(o.name in fixture_labels() for o in g.objects)  # obj_labels FIXTURE: the fixture vocabulary
    eng = FSRQueryEngine(loaded, models[4], tokenizer(), device="cpu")
    for q in INSTRUCTIONS[:4]:
        floor, rooms, objs, res = eng.query_hierarchy(q)
        assert "FastMatching" in res and np.isfinite(res["Total_Time"])
    # sharded_mapping on: the ShardedMapper on a one-rank process group in
    # this process (the reference's one-device mesh); at one shard its
    # scene holds the single-device Mapper's voxels
    on = {**TINY, "main": {"save_path": str(tmp_path / "on"), "scene_id": "s"},
          "pipeline": {**TINY["pipeline"], "sharded_mapping": "on"}}
    sharded_dir, sg = build_map.run(from_dict(on), dataset=SyntheticDataset(num_frames=12, hw=(48, 64)),
                                    models=models, device="cpu")
    sstats = json.loads((tmp_path / "on" / "s" / "build_stats.json").read_text())
    assert (sstats["frames"], sstats["scene_points"]) == (stats["frames"], stats["scene_points"])
    assert sharded_dir.parent == tmp_path / "on" / "s" and len(sg.views) >= 6 and sg.rooms
    assert [(r.room_id, r.name) for r in HMSGraph.load(sharded_dir).rooms] == [(r.room_id, r.name) for r in sg.rooms]


def test_build_map_main_with_a_json_config(tmp_path):
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({**TINY, "main": {"num_frames": 4, "frame_h": 48, "frame_w": 64}}))
    graph_dir, g = build_map.main(["--config", str(cfg_file), "--device", "cpu", f"main.save_path={tmp_path}",
                                   "main.scene_id=m"])
    assert graph_dir.parent == tmp_path / "m" and len(g.views) >= 2
