"""The FSR slow path against the JAX package: CLIP's preprocess, the
ClipVLM backend, the engine's slow_reasoning with the GT-backed OracleVLM,
and apps.query_bench in its fast, oracle and slow-CLIP modes.

Weights go through bridge.py at test-tiny; the towers run in float32.
Tolerances: preprocess within 1e-5 (absolute, and relative to the
normalized pixel, whose scale reaches 2.6); image features within 1e-4; bf16 text
features at cosine >= 0.999 (tests/test_torch_text.py's limit); every
decision, choice, argmax and returned id exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu import config as jconfig
from holoagent_tpu.apps import query_bench as jquery_bench
from holoagent_tpu.dataloader import SyntheticDataset as JSyntheticDataset
from holoagent_tpu.memory import hmsg as jhmsg
from holoagent_tpu.memory import nodes as jnodes
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models.tokenizer import SimpleTokenizer as JTokenizer
from holoagent_tpu.query import engine as jengine
from holoagent_tpu.query import oracle as joracle
from holoagent_tpu.query import vlm_backend as jvlm
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.apps import query_bench
from holoagent_tpu_torch.config import Config
from holoagent_tpu_torch.dataloader import SyntheticDataset
from holoagent_tpu_torch.eval import gt as tgt
from holoagent_tpu_torch.memory import hmsg, nodes
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models.tokenizer import SimpleTokenizer
from holoagent_tpu_torch.query import ClipVLM, FSRQueryEngine, OracleVLM, read_tag, tag_image

torch.set_num_threads(1)

V, JV = tclip.VARIANTS["test-tiny"], jclip.VARIANTS["test-tiny"]
FEAT_TOL = 1e-4
COS_BF16 = 0.999
D = 32


@pytest.fixture(scope="module")
def towers():
    params = jclip.init_clip(jax.random.key(0), JV)
    np_params = jax.tree.map(np.asarray, params)
    return params, bridge.clip_from_jax(np_params, V, device="cpu"), bridge.clip_text_from_jax(np_params, V, device="cpu")


@pytest.fixture(scope="module")
def frames():
    """Rendered 48x64 frames of the two-room scene, in both packages."""
    ds, jds = SyntheticDataset(num_frames=12, hw=(48, 64)), JSyntheticDataset(num_frames=12, hw=(48, 64))
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i].rgb, jds[i].rgb)
    return ds, jds


@pytest.mark.parametrize("hw", [(48, 64), (64, 48)])
@pytest.mark.parametrize("size", [32, 224])
def test_preprocess(hw, size):
    x = np.random.default_rng(0).random((3, *hw, 3)).astype(np.float32)
    got = tclip.preprocess(torch.from_numpy(x), size)
    want = np.asarray(jclip.preprocess(jnp.asarray(x), size))
    assert got.shape == want.shape == (3, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _rows_cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _f32_text(params, texts):
    return np.asarray(jclip.text_features_multi_template(params, JTokenizer(), texts, JV, dtype=jnp.float32))


def _threshold(sims):
    """The middle of the widest gap between the sorted scores: some checks
    pass and some fail, none within the gap's half-width of the limit."""
    s = np.sort(np.asarray(sims).ravel())
    i = int(np.argmax(np.diff(s)))
    return float(s[i] + s[i + 1]) / 2, float(s[i + 1] - s[i]) / 2


def test_clip_vlm_against_the_reference(towers, frames):
    params, visual, text = towers
    ds, _ = frames
    imgs = [ds[i].rgb for i in range(0, 12, 2)]
    vlm, jv = ClipVLM(visual, text, SimpleTokenizer()), jvlm.ClipVLM(params, JTokenizer(), JV)
    f, jf = vlm._img_feats(imgs), jv._img_feats([jnp.asarray(im) for im in imgs])
    assert f.shape == (6, D)
    np.testing.assert_allclose(f, jf, atol=FEAT_TOL)
    np.testing.assert_array_equal(vlm._img_feats([torch.from_numpy(im) for im in imgs]), f)  # tensors as they are
    texts = ["chair", "table", "find the chair in the kitchen"]
    assert _rows_cosine(vlm._txt_feats(texts), jv._txt_feats(texts)).min() >= COS_BF16
    # the decisions, on the same (float32) text features in both backends
    shared = _f32_text(params, texts)
    for b in (vlm, jv):
        b._txt_cache = dict(zip(texts, shared))
    thr, margin = _threshold(jf @ shared[:2].T)
    assert margin > 10 * FEAT_TOL
    vlm.detect_threshold = jv.detect_threshold = thr
    for b in (vlm, jv):
        b.imgs = imgs if b is vlm else [jnp.asarray(im) for im in imgs]
    for label in texts[:2]:
        assert [vlm.detect_object(im, label) for im in vlm.imgs] == [jv.detect_object(im, label) for im in jv.imgs]
        assert vlm.detect_and_select_best(vlm.imgs, label) == jv.detect_and_select_best(jv.imgs, label)
    assert vlm.choose_frame(vlm.imgs, texts[2]) == jv.choose_frame(jv.imgs, texts[2])
    got = vlm.rethink_wave(vlm.imgs[:4], texts[2], vlm.imgs[4:], "chair")
    assert got == jv.rethink_wave(jv.imgs[:4], texts[2], jv.imgs[4:], "chair")
    checks = [c for label in texts[:2] for c in vlm.detect_and_select_best(vlm.imgs, label)[0]]
    assert any(checks) and not all(checks)
    assert vlm.choose_frame([], "x") is None and vlm.detect_and_select_best([], "x") == ([], None)
    assert vlm.rethink_wave([], "x", [], "x") == (None, [])


# ---------------------------------------------------------------------------
# The slow path with the oracle VLM (tests/test_query.py's counterparts)
# ---------------------------------------------------------------------------

TEXT_DIRS = {"living room": 10, "bathroom": 11, "lamp": 0, "mug": 1, "plant": 2, "towel": 3, "background": 20}


def _fake_text(texts):
    """tests/test_query.py's FakeTextEngine features: a fixed axis a text."""
    out = np.zeros((len(texts), D), np.float32)
    for i, t in enumerate(texts):
        key = t.lower()
        out[i, 25 + int(key.split()[-1]) % 4 if key.startswith("floor") else TEXT_DIRS.get(key, 24)] = 1.0
    return out


def _engines(graph_fn, **kw):
    """The port's and the reference's engine over the same graph, both with
    the fixed text features."""
    g, _, extra = graph_fn(nodes, hmsg.HMSGraph)
    jg = graph_fn(jnodes, jhmsg.HMSGraph)[0]
    te = FSRQueryEngine(g, tclip.CLIPText(V, device="cpu"), None, device="cpu", **kw.get("port", {}))
    je = jengine.FSRQueryEngine(jg, None, None, JV, **kw.get("jax", {}))
    for e in (te, je):
        e.text_feats = _fake_text
    return te, je, extra


def _confusable_graph(mod, graph_cls):
    """tests/test_query.py's scene: CLIP-confusable decoys (a 'shiny cloth'
    that looks exactly like 'towel', a 'green sculpture' like 'plant') in
    the living room; the real towel and plant in the bathroom."""
    rng = np.random.default_rng(7)

    def unit(i):
        v = np.zeros(D, np.float32)
        v[i] = 1.0
        return v

    def mix(i, j, wi=0.8):
        v = wi * unit(i) + np.sqrt(1 - wi * wi) * unit(j)
        return (v / np.linalg.norm(v)).astype(np.float32)

    g = graph_cls()
    fl = mod.Floor("0", name="floor_0")
    fl.floor_zero_level, fl.floor_height = 0.0, 2.5
    fl.pcd_points = rng.uniform(0, 5, (100, 3))
    fl.pcd_colors = np.zeros((100, 3), np.float32)
    fl.vertices = np.zeros((8, 3))
    g.floors.append(fl)
    spec = {
        0: ("living room", 0, [("lamp", unit(0)), ("mug", unit(1)), ("shiny cloth", unit(3)),
                               ("green sculpture", unit(2))], unit(10)),
        1: ("bathroom", 2, [("towel", mix(3, 9)), ("plant", mix(2, 9))], (unit(3) + unit(2)) / np.sqrt(2)),
    }
    frame_contents = {}
    for ri, (name, img, objs, memb) in spec.items():
        r = mod.Room(f"0_{ri}", "0", name=name)
        r.pcd_points = rng.uniform(0, 2, (50, 3))
        r.pcd_colors = np.zeros((50, 3))
        r.vertices = r.pcd_points[:, :2]
        r.room_zero_level, r.room_height = 0.0, 2.5
        r.embeddings = [unit(10 + ri)]
        r.sample_images = [img]
        r.clip_embeddings = [memb.astype(np.float32)]
        fl.add_room(r)
        g.rooms.append(r)
        view = mod.View(f"0_{ri}_v", r.room_id, img_id=img)
        r.views.append(view)
        g.views.append(view)
        frame_contents[img] = set()
        for oi, (oname, emb) in enumerate(objs):
            o = mod.Object(f"0_{ri}_{oi}", r.room_id, name=oname)
            o.pcd_points = rng.uniform(0, 2, (20, 3))
            o.pcd_colors = np.zeros((20, 3))
            o.vertices = o.pcd_points[:, :2]
            o.embedding = emb
            o.best_view_id = view.view_id
            o.view_ids = [view.view_id]
            view.object_ids.append(o.object_id)
            r.add_object(o)
            g.objects.append(o)
            frame_contents[img].add(oname)
    return g, None, frame_contents


def test_slow_path_oracle_improves_retrieval():
    """On CLIP-confusable queries the fast path picks the decoy; the slow
    path with the oracle VLM corrects it (fast < 1.0, slow == 1.0), through
    all three call kinds, exactly as the reference's engine does."""
    contents = _confusable_graph(nodes, hmsg.HMSGraph)[2]
    oracle, jor = OracleVLM(contents), joracle.OracleVLM(contents)
    provider = lambda i: tag_image(np.zeros((8, 8, 3), np.float32), i)  # noqa: E731
    te, je, _ = _engines(_confusable_graph, port=dict(image_provider=provider, vlm=oracle),
                         jax=dict(image_provider=provider, vlm=jor))
    queries = [("find the towel", "towel"), ("find the plant", "plant"), ("find the mug", "mug")]

    def accuracy(eng, use_slow):
        hits, answers = 0, []
        for instr, want in queries:
            _, _, objs, res = eng.query_hierarchy(instr, use_slow=use_slow)
            answers.append(([o.object_id for o in objs], res.get("refined_object_id"),
                            {k for k in res if not isinstance(res[k], float)}))
            hits += bool(objs and objs[0].name == want)
        return hits / len(queries), answers

    fast, fast_ans = accuracy(te, False)
    slow, slow_ans = accuracy(te, True)
    assert fast < 1.0 and slow == 1.0
    assert {k for k, _ in oracle.calls} == {"detect_object", "choose_frame", "detect_and_select_best"}
    assert (fast, fast_ans) == accuracy(je, False)
    assert (slow, slow_ans) == accuracy(je, True)
    assert oracle.calls == jor.calls


def test_slow_path_refinement_persists_objects_update(tmp_path):
    """A VLM that rejects the fast pick and accepts the CLIP-best view
    triggers re-matching; the refined object is saved to objects_update/,
    byte for byte as the reference saves it."""

    class RefiningVLM:
        def detect_object(self, image, label):
            return False  # fast pick rejected -> rethinking engages

        def choose_frame(self, images, instruction):
            return 0

        def detect_and_select_best(self, images, label):
            return [False] + [True] * (len(images) - 1), 1

    images = {i: np.zeros((8, 8, 3), np.float32) for i in range(8)}
    kw = dict(image_provider=lambda i: images[i], vlm=RefiningVLM())
    te, je, _ = _engines(_confusable_graph, port=dict(kw, update_dir=str(tmp_path / "port")),
                         jax=dict(kw, update_dir=str(tmp_path / "jax")))
    _, _, objs, res = te.query_hierarchy("towel in region bathroom on floor 1", use_slow=True)
    _, _, jobjs, jres = je.query_hierarchy("towel in region bathroom on floor 1", use_slow=True)
    oid = res["refined_object_id"]
    assert oid == jres["refined_object_id"] and [o.object_id for o in objs] == [o.object_id for o in jobjs]
    for suffix in (".ply", ".json"):
        saved = (tmp_path / "port" / "objects_update" / f"{oid}{suffix}").read_bytes()
        assert saved == (tmp_path / "jax" / "objects_update" / f"{oid}{suffix}").read_bytes()
    assert res["Total_Time"] >= res["FastMatching"] and res["Re_Matching"] >= 0.0


def test_oracle_distill_pairs_and_tags():
    contents = {0: {"mug"}, 2: {"towel"}}
    pairs = OracleVLM(contents).distill_pairs([0, 2], ["mug", "towel"])
    assert pairs == joracle.OracleVLM(contents).distill_pairs([0, 2], ["mug", "towel"])
    ans = {(p[1][0], p[0].split(" a ")[1].split(" in")[0]): p[2] for p in pairs}
    assert ans[(0, "mug")] == "yes" and ans[(0, "towel")] == "no"
    assert ans[(2, "towel")] == "yes" and ans[(2, "mug")] == "no"
    img = np.random.default_rng(0).random((8, 8, 3)).astype(np.float32)
    tagged = tag_image(img, 37)
    np.testing.assert_array_equal(tagged, joracle.tag_image(img, 37))
    assert read_tag(tagged) == joracle.read_tag(tagged) == 37


def test_slow_path_without_an_image_provider_returns_the_fast_pick():
    te, je, _ = _engines(_confusable_graph)
    for eng in (te, je):
        _, _, objs, res = eng.query_hierarchy("find the towel", use_slow=True)
        assert objs[0].name == "shiny cloth" and res["Total_Time"] == res["FastMatching"]


# ---------------------------------------------------------------------------
# apps.query_bench
# ---------------------------------------------------------------------------


def _oracle_row_graph(mod, graph_cls, gt_mod):
    """tests/test_apps.py's oracle-row graph: mapped surface clouds offset
    from their GT boxes, garbage embeddings."""
    rng = np.random.default_rng(3)
    g = graph_cls()
    fl = mod.Floor("0", name="floor_0")
    fl.floor_zero_level, fl.floor_height = 0.0, 2.5
    fl.pcd_points = rng.uniform(0, 6, (64, 3))
    fl.pcd_colors = np.zeros((64, 3))
    fl.vertices = np.zeros((8, 3))
    g.floors.append(fl)
    gt = gt_mod.GTGraph()
    gt.floors.append(gt_mod.GTFloor(0, -0.2, 2.7))
    centers = {"bed": (1.0, 1.0, 0.4), "chair": (2.5, 1.0, 0.3), "sofa": (5.0, 4.5, 0.4)}
    room_of = {"bed": 0, "chair": 0, "sofa": 1}
    rooms = []
    for ri, (rname, rect) in enumerate((("bedroom", (0, 0, 3.5, 2.5)), ("living room", (3.6, 3.5, 6.5, 5.5)))):
        r = mod.Room(f"0_{ri}", "0", name=rname)
        x0, y0, x1, y1 = rect
        r.vertices = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float64)
        r.pcd_points = rng.uniform((x0, y0, 0), (x1, y1, 2.5), (32, 3))
        r.pcd_colors = np.zeros((32, 3))
        r.room_zero_level, r.room_height = 0.0, 2.5
        fl.add_room(r)
        g.rooms.append(r)
        rooms.append(r)
        gt.rooms.append(gt_mod.GTRoom(ri, 0, rname, np.asarray(r.vertices, np.float64), 0.0, 2.5))
    for oi, (cat, c) in enumerate(centers.items()):
        c = np.asarray(c, np.float64)
        o = mod.Object(f"0_{room_of[cat]}_{oi}", rooms[room_of[cat]].room_id, name="unlabeled")
        o.pcd_points = c[None] + rng.uniform(-0.15, 0.15, (24, 3))
        o.pcd_colors = np.zeros((24, 3))
        o.vertices = o.pcd_points[:, :2]
        o.embedding = rng.standard_normal(D).astype(np.float32)  # garbage
        rooms[room_of[cat]].add_object(o)
        g.objects.append(o)
        gt.objects.append(gt_mod.GTObject(oi, room_of[cat], 0, cat, np.zeros((0, 3)), c, np.asarray([0.8, 0.8, 0.8])))
    return g, gt


def _models(towers):
    params, visual, text = towers
    return (visual, None, V, None, text), (params, None, JV, None)


def test_query_bench_oracle_row(towers, tmp_path):
    """With GT one-hot embeddings in the gallery and the text cache, the
    pipeline alone scores top-1 1.0, as in the reference (and the same
    answers)."""
    g, gt = _oracle_row_graph(nodes, hmsg.HMSGraph, tgt)
    g.save(tmp_path / "graph")
    gt.to_json(tmp_path / "gt" / "scene_info.json")
    instructions = ["find the bed", "find the chair in the bedroom", "go to the sofa in the living room"]
    models, jmodels = _models(towers)
    kw = dict(out_path=str(tmp_path / "o.json"), gt_path=str(tmp_path / "gt" / "scene_info.json"), oracle=True)
    summary = query_bench.run(str(tmp_path / "graph"), instructions, Config(), models=models, device="cpu", **kw)
    assert summary.get("oracle_embeddings") is True
    assert summary["top1_acc"] == 1.0, summary["correctness"]
    assert summary["recall_at_5"] == 1.0
    want = jquery_bench.run(str(tmp_path / "graph"), instructions, jconfig.Config(), models=jmodels,
                            **dict(kw, out_path=str(tmp_path / "j.json")))
    assert [r["objects"] for r in summary["results"]] == [r["objects"] for r in want["results"]]
    assert summary["correctness"] == want["correctness"]
    with pytest.raises(ValueError, match="--gt"):
        query_bench.run(str(tmp_path / "graph"), instructions, Config(), models=models, device="cpu", oracle=True)


def test_pad_gallery_with_crops(towers, frames):
    """Distractor crops: the same windows, resized on the device and encoded
    in chunks of 64, as the reference's."""
    params, visual, _ = towers
    ds, jds = frames
    g, jg = hmsg.HMSGraph(), jhmsg.HMSGraph()
    query_bench._pad_gallery_with_crops(g, 70, ds, visual)
    jquery_bench._pad_gallery_with_crops(jg, 70, jds, params, JV)
    assert [o.object_id for o in g.objects] == [o.object_id for o in jg.objects] and len(g.objects) == 70
    np.testing.assert_allclose(np.stack([o.embedding for o in g.objects]),
                               np.stack([o.embedding for o in jg.objects]), atol=FEAT_TOL)
    np.testing.assert_array_equal(np.stack([o.pcd_points for o in g.objects]),
                                  np.stack([o.pcd_points for o in jg.objects]))


def _view_graph(mod, graph_cls):
    """Two rooms over the 12 rendered frames: a view a frame with two
    objects each, seeded random embeddings; every room samples its frames."""
    rng = np.random.default_rng(11)

    def unit(n):
        v = rng.normal(size=(n, D)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    g = graph_cls()
    fl = mod.Floor("0", name="floor_0")
    fl.floor_zero_level, fl.floor_height = 0.0, 2.5
    fl.pcd_points = rng.uniform(0, 5, (64, 3))
    fl.pcd_colors = np.zeros((64, 3))
    fl.vertices = np.zeros((8, 3))
    g.floors.append(fl)
    names = ["chair", "table", "bed", "sofa", "lamp", "toilet"]
    for ri, rname in enumerate(("bedroom", "kitchen")):
        r = mod.Room(f"0_{ri}", "0", name=rname)
        r.pcd_points = rng.uniform(0, 3, (32, 3))
        r.pcd_colors = np.zeros((32, 3))
        r.vertices = r.pcd_points[:, :2]
        r.room_zero_level, r.room_height = 0.0, 2.5
        r.embeddings = list(unit(2))
        r.sample_images = list(range(6 * ri, 6 * ri + 6))
        r.clip_embeddings = list(unit(6))
        fl.add_room(r)
        g.rooms.append(r)
        for img in r.sample_images:
            view = mod.View(f"0_{ri}_{img}", r.room_id, img_id=img)
            r.views.append(view)
            g.views.append(view)
            for k in range(2):
                o = mod.Object(f"0_{ri}_{r.object_counter}", r.room_id, name=names[(img + k) % 6])
                r.object_counter += 1
                o.pcd_points = rng.uniform(0, 3, (16, 3))
                o.pcd_colors = np.zeros((16, 3))
                o.vertices = o.pcd_points[:, :2]
                o.embedding = unit(1)[0]
                o.best_view_id = view.view_id
                o.view_ids = [view.view_id]
                view.object_ids.append(o.object_id)
                r.add_object(o)
                g.objects.append(o)
    return g


SLOW_INSTRUCTIONS = ["find the chair", "the table in the kitchen", "go to the bed in the bedroom", "find the sofa",
                     "lamp in region kitchen on floor 1", "find the toilet"]


def test_query_bench_slow_clip_against_the_reference(towers, frames, tmp_path, monkeypatch):
    """query_bench --slow --vlm clip at test-tiny over the same graph and
    frames in both packages: the same returned objects and stage keys.
    Text features are float32 in both (the bf16 ones agree at cosine 0.999,
    not to the last decision), and the check threshold sits in the widest
    gap of this run's image-text scores."""
    params, visual, text = towers
    ds, jds = frames
    real, jreal = tclip.text_features_multi_template, jclip.text_features_multi_template
    monkeypatch.setattr(tclip, "text_features_multi_template",
                        lambda t, tok, labels, **kw: real(t, tok, labels, dtype=torch.float32))
    monkeypatch.setattr(jclip, "text_features_multi_template",
                        lambda p, tok, labels, variant, **kw: jreal(p, tok, labels, variant, dtype=jnp.float32))
    labels = ["chair", "table", "bed", "sofa", "lamp", "toilet"]
    feats = ClipVLM(visual, text, SimpleTokenizer())._img_feats([ds[i].rgb for i in range(len(ds))])
    thr, margin = _threshold(feats @ _f32_text(params, labels).T)
    assert margin > 10 * FEAT_TOL
    monkeypatch.setattr(ClipVLM.__init__, "__defaults__", (thr,))
    monkeypatch.setattr(jvlm.ClipVLM.__init__, "__defaults__", (thr,))
    _view_graph(nodes, hmsg.HMSGraph).save(tmp_path / "graph")
    models, jmodels = _models(towers)
    got = query_bench.run(str(tmp_path / "graph"), SLOW_INSTRUCTIONS, Config(), use_slow=True, vlm_kind="clip",
                          dataset=ds, models=models, device="cpu", out_path=str(tmp_path / "p.json"))
    want = jquery_bench.run(str(tmp_path / "graph"), SLOW_INSTRUCTIONS, jconfig.Config(), use_slow=True,
                            vlm_kind="clip", dataset=jds, models=jmodels, out_path=str(tmp_path / "j.json"))
    assert [r["objects"] for r in got["results"]] == [r["objects"] for r in want["results"]]
    assert [sorted(r) for r in got["results"]] == [sorted(r) for r in want["results"]]
    assert set(want) - set(got) == set() and set(got) == set(json.loads((tmp_path / "p.json").read_text()))
    assert all(k in got["results"][0] for k in query_bench.STAGES)
    # the slow path really rethought some queries: a VLM stage was taken
    assert any(r["VLM_Rethinking"] > 0 for r in got["results"])
    assert got["p95_total_time"] >= got["p50_total_time"] > 0
