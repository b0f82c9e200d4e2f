"""The deployment configs' apps against the JAX package: batch_map over
two scenes written in HM3DSem layout (test-tiny SAM and CLIP, the JAX
weights carried over by bridge.py), retrieval_bench's retrieval program,
and llm_client + LLMParser with stub backends.

Tolerances: batch_map's integer stats (frames, scene_points, instances,
floors, rooms, objects, views) exactly equal, and every evaluation metric
within EVAL_ATOL (the graphs' point sets are exact; the metrics' float
sums may round apart in the last bits); the retrieval indices exactly
equal (no near-tie in these draws); the LLM cache keys, prompts, parsed
fields and fallbacks exactly equal.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu import config as jconfig
from holoagent_tpu.apps import batch_map as jbatch_map
from holoagent_tpu.apps import retrieval_bench as jretrieval_bench
from holoagent_tpu.apps.common import load_models as jload_models
from holoagent_tpu.ops.retrieval import class_filtered_topk as jclass_filtered_topk
from holoagent_tpu.query import llm_client as jllm
from holoagent_tpu.query.parser import LLMParser as JLLMParser
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch import config as tconfig
from holoagent_tpu_torch.apps import batch_map, build_map, retrieval_bench
from holoagent_tpu_torch.apps.eval_protocol import LAYOUTS
from holoagent_tpu_torch.dataloader import SyntheticDataset, SyntheticScene, export
from holoagent_tpu_torch.dataloader.generic import RGBDFrame
from holoagent_tpu_torch.eval import HMSGEvaluator, gt_from_synthetic
from holoagent_tpu_torch.eval.gt import GTGraph
from holoagent_tpu_torch.memory.hmsg import HMSGraph
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.ops.retrieval import class_filtered_topk
from holoagent_tpu_torch.query import llm_client
from holoagent_tpu_torch.query.parser import LLMParser, RuleParser

torch.set_num_threads(1)
EVAL_ATOL = 1e-6
INT_STATS = ("frames", "scene_points", "instances", "floors", "rooms", "objects", "views")
HW = (48, 64)

# config/hm3dsem_benchmark.yaml's settings at test-tiny towers, small
# capacities, accept-all mask gates (random weights) and a point floor for
# objects sized to 48x64 frames; the JAX side on the single-device Mapper,
# the port's only one (the tests' 8 host devices would select its
# ShardedMapper)
CFG = {
    "main": {"dataset": "hm3dsem", "scene_id": "hm3d_val", "depth_cut": 10.0},
    "models": {
        "clip": {"type": "test-tiny", "dtype": "float32"},
        "sam": {"type": "test-tiny", "dtype": "float32", "points_per_side": 4, "pred_iou_thresh": -10.0,
                "stability_score_thresh": 0.0, "min_mask_region_area": 20, "max_masks": 8},
    },
    "pipeline": {
        "voxel_size": 0.08, "skip_frames": 10, "grid_resolution": 0.08, "point_capacity": 1 << 15,
        "mask_point_capacity": 512, "instance_capacity": 64, "instance_max_area_frac": 1.0, "instance_max_extent_m": 1e9,
        "merge_type": "paired", "obj_labels": "HM3D", "min_pcd_points": 20, "sharded_mapping": "off",
    },
}
SCENES = (("two_room", 8, 2), ("three_room", 9, 3))  # (layout, frames rendered, skip_frames)


def write_hm3dsem_scene(root: Path, layout: str, n_frames: int, hw=HW, seed: int = 0):
    """Render `layout` along SyntheticDataset's orbit with the HM3DSem
    loader's K (f = W/2) and write it in HM3DSem layout; returns the
    read-back frames and the GT graph."""
    make_scene, rects, _ = LAYOUTS[layout]
    scene = make_scene(SyntheticScene)
    k = export.hm3dsem_k(*hw)
    poses = SyntheticDataset(scene=scene, num_frames=n_frames, hw=hw, seed=seed).poses
    frames, sem = [], []
    for pose in poses:
        rgb, depth, inst, _ = scene.render(pose.astype(np.float64), k, hw)
        frames.append(RGBDFrame(rgb, depth, pose, k))
        sem.append(inst + 1)
    back = export.write_hm3dsem(root, frames, semantic=sem)
    return back, gt_from_synthetic(scene, room_rects=rects)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batch_map")
    walks, gt_dir = tmp / "walks", tmp / "gt"
    scenes = []
    for layout, n, skip in SCENES:
        _, gt = write_hm3dsem_scene(walks / layout, layout, n)
        gt.to_json(gt_dir / f"{layout}.json", save_object_plys=False)
        scenes.append({"scene_id": layout, "dataset_path": str(walks), "skip_frames": skip})
    jcfg = jconfig.from_dict({**CFG, "main": {**CFG["main"], "save_path": str(tmp / "jax")}})
    j = jbatch_map.run_batch(jcfg, scenes, gt_dir=str(gt_dir))
    clip_p, sam_p, cv, sv = jload_models(jcfg)  # the same seeded weights run_batch drew
    np_clip, np_sam = jax.tree.map(np.asarray, clip_p), jax.tree.map(np.asarray, sam_p)
    models = (bridge.clip_from_jax(np_clip, tclip.VARIANTS[cv.name], device="cpu"),
              bridge.sam_from_jax(np_sam, tsam.VARIANTS[sv.name], device="cpu"),
              tclip.VARIANTS[cv.name], tsam.VARIANTS[sv.name],
              bridge.clip_text_from_jax(np_clip, tclip.VARIANTS[cv.name], device="cpu"))
    graphs = {}
    run = build_map.run

    def keep(cfg, **kw):  # the graph build_map.run returns, beside the one batch_map loads
        graph_dir, graph = run(cfg, **kw)
        graphs[cfg.main.scene_id] = graph
        return graph_dir, graph

    mp = pytest.MonkeyPatch()
    mp.setattr(batch_map, "load_models", lambda cfg, dev: models)
    mp.setattr(build_map, "run", keep)
    try:
        tcfg = tconfig.from_dict({**CFG, "main": {**CFG["main"], "save_path": str(tmp / "port")}})
        t = batch_map.run_batch(tcfg, scenes, gt_dir=str(gt_dir), device="cpu")
    finally:
        mp.undo()
    return dict(jax=j, port=t, graphs=graphs, gt_dir=gt_dir)


def test_batch_map_stats_equal_jax(batch):
    j, t = batch["jax"], batch["port"]
    assert list(t) == list(j) == [s[0] for s in SCENES]
    for scene, (_, n, skip) in zip(t, SCENES):
        assert {k: t[scene][k] for k in INT_STATS} == {k: j[scene][k] for k in INT_STATS}, scene
        assert t[scene]["frames"] == math.ceil(n / skip)
        assert Path(t[scene]["graph_dir"]).parent.name == scene
    assert sum(t[scene]["objects"] for scene in t) > 0


def _flat(m, prefix=""):
    """{path: leaf} of nested dicts and lists."""
    if isinstance(m, dict):
        items = m.items()
    elif isinstance(m, (list, tuple)):
        items = enumerate(m)
    else:
        return {prefix: m}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def test_batch_map_eval_equal_jax(batch):
    for scene in batch["port"]:
        ft, fj = _flat(batch["port"][scene]["eval"]), _flat(batch["jax"][scene]["eval"])
        assert sorted(ft) == sorted(fj) and len(ft) > 10
        for k in ft:
            if isinstance(fj[k], float) and math.isnan(fj[k]):
                assert math.isnan(ft[k]), k
            elif isinstance(fj[k], float):
                assert ft[k] == pytest.approx(fj[k], abs=EVAL_ATOL), k
            else:
                assert ft[k] == fj[k], k


def test_batch_map_returned_graph_scores_as_loaded(batch):
    """batch_map scores HMSGraph.load(graph_dir), as the reference does; the
    graph build_map.run returns scores the same."""
    for scene, graph in batch["graphs"].items():
        ev = HMSGEvaluator(GTGraph.from_json(batch["gt_dir"] / f"{scene}.json"))
        assert _flat(ev.evaluate_all(graph)) == _flat(batch["port"][scene]["eval"])
        loaded = HMSGraph.load(batch["port"][scene]["graph_dir"])
        assert len(loaded.objects) == len(graph.objects) == batch["port"][scene]["objects"]


def test_batch_map_main_and_build_stats(batch, tmp_path):
    """main() reads a JSON config and a scenes file, and writes the summary."""
    stats = json.loads((Path(batch["port"]["two_room"]["graph_dir"]).parent / "build_stats.json").read_text())
    assert {k: stats[k] for k in INT_STATS} == {k: batch["port"]["two_room"][k] for k in INT_STATS}
    cfg_path, scenes_path = tmp_path / "cfg.json", tmp_path / "scenes.json"
    cfg_path.write_text(json.dumps({**CFG, "main": {**CFG["main"], "save_path": str(tmp_path / "out")}}))
    scenes_path.write_text(json.dumps([{"scene_id": "two_room", "skip_frames": 6,
                                        "dataset_path": str(Path(batch["gt_dir"]).parent / "walks")}]))
    out = tmp_path / "summary.json"
    summary = batch_map.main(["--config", str(cfg_path), "--scenes", str(scenes_path), "--out", str(out),
                              "--device", "cpu"])
    assert json.loads(out.read_text())["two_room"]["frames"] == summary["two_room"]["frames"] == 2
    assert Path(summary["two_room"]["graph_dir"]).is_relative_to(tmp_path / "out")


# ---------------------------------------------------------------------------
# retrieval_bench
# ---------------------------------------------------------------------------


def _jax_retrieve(queries, gallery, negatives, valid, k):
    """holoagent_tpu/apps/retrieval_bench.py's retrieve, one query at a time."""

    def one(qv):
        class_feats = jnp.concatenate([qv[None], negatives], axis=0)
        return jclass_filtered_topk(gallery, valid, qv, class_feats, jnp.int32(0), k)[1]

    return jax.vmap(one)(queries)


def test_retrieval_program_equals_jax():
    g, q, neg, planted = retrieval_bench.make_inputs(256, 8, 32, 20)
    valid = np.ones(256, bool)
    valid[::17] = False
    idx = retrieval_bench.retrieve(torch.from_numpy(q), torch.from_numpy(g), torch.from_numpy(neg),
                                   torch.from_numpy(valid), 5).numpy()
    jidx = np.asarray(_jax_retrieve(jnp.asarray(q), jnp.asarray(g), jnp.asarray(neg), jnp.asarray(valid), 5))
    np.testing.assert_array_equal(idx, jidx)
    for i in range(8):  # each row of the batched program equals the one-query result
        one = class_filtered_topk(torch.from_numpy(g), torch.from_numpy(valid), torch.from_numpy(q[i]),
                                  torch.from_numpy(np.concatenate([q[i][None], neg])), 0, 5)[1].numpy()
        np.testing.assert_array_equal(idx[i], one)
        if valid[planted[i]]:
            assert idx[i][0] == planted[i]
    full = np.ones(256, bool)
    for i in range(8):
        exact, _ = retrieval_bench.exact_topk(q[i], g, neg, 5)
        row = retrieval_bench.retrieve(torch.from_numpy(q), torch.from_numpy(g), torch.from_numpy(neg),
                                       torch.from_numpy(full), 5).numpy()[i]
        np.testing.assert_array_equal(row, exact)


def test_retrieval_bench_line_has_the_reference_keys(capsys):
    argv = ["--gallery", "64", "--batch", "4", "--dim", "16", "--negatives", "3", "--iters", "1"]
    jretrieval_bench.main(argv)
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = retrieval_bench.main(argv + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(jline) <= set(line) and line["unit"] == jline["unit"] and line["metric"] == jline["metric"]
    assert line["planted_recall_at_1"] == 1.0 and line["parity_at_k"] == 1.0 and line["timing"] == "cpu"
    assert res["device_idx"].shape == (4, 5)


# ---------------------------------------------------------------------------
# llm_client and LLMParser
# ---------------------------------------------------------------------------

MESSAGES = (
    [{"role": "system", "content": "parse"}, {"role": "user", "content": "sink in the kitchen on floor 1"}],
    [{"content": "去一楼的厨房找椅子", "role": "user"}],
    [{"role": "user", "content": "hi"}, {"role": "assistant", "content": "[Floor 2, Hall, lamp]"}],
)


def test_llm_cache_is_shared_across_packages(tmp_path):
    for m in MESSAGES:
        assert llm_client.CachedLLMClient._key(m) == jllm.CachedLLMClient._key(m)
    calls = []

    def backend(messages):
        calls.append(messages)
        return f"answer {len(calls)}"

    jc = jllm.CachedLLMClient(backend, cache_path=tmp_path / "j.jsonl", backoff_s=0.0)
    tc = llm_client.CachedLLMClient(backend, cache_path=tmp_path / "t.jsonl", backoff_s=0.0)
    jout = [jc.send_query(m) for m in MESSAGES]
    tout = [tc.send_query(m) for m in MESSAGES[::-1]]
    assert len(calls) == 6
    # each package reads the other's file and answers without the backend
    tj = llm_client.CachedLLMClient(backend, cache_path=tmp_path / "j.jsonl")
    jt = jllm.CachedLLMClient(backend, cache_path=tmp_path / "t.jsonl")
    assert [tj.send_query(m) for m in MESSAGES] == jout
    assert [jt.send_query(m) for m in MESSAGES[::-1]] == tout
    assert len(calls) == 6
    conv = llm_client.Conversation().system("s").user("u").assistant("a")
    jconv = jllm.Conversation().system("s").user("u").assistant("a")
    assert conv.messages == jconv.messages and conv.render() == jconv.render()
    assert tj.send_query(conv) == jllm.CachedLLMClient(backend, cache_path=tmp_path / "j.jsonl").send_query(jconv)


def test_llm_client_retries_and_batcher_backend():
    for mod in (llm_client, jllm):
        calls = []

        def flaky(messages, calls=calls):
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("flaky")
            return "[Floor 1, Kitchen, sink]"

        assert mod.CachedLLMClient(flaky, max_retries=5, backoff_s=0.0).send_query(MESSAGES[0]) == \
            "[Floor 1, Kitchen, sink]" and len(calls) == 3

        def down(messages):
            raise ConnectionError("down")

        with pytest.raises(RuntimeError, match="after 2 retries"):
            mod.CachedLLMClient(down, max_retries=2, backoff_s=0.0).send_query(MESSAGES[1])

    class Batcher:
        def __init__(self):
            self.prompts = []

        def generate(self, prompt, max_new_tokens=32):
            self.prompts.append((prompt, max_new_tokens))
            return "ok"

    b, jb = Batcher(), Batcher()
    for m in MESSAGES:
        assert llm_client.batcher_backend(b, 16)(m) == jllm.batcher_backend(jb, 16)(m) == "ok"
    assert b.prompts == jb.prompts and b.prompts[0][1] == 16
    assert callable(llm_client.openai_http_backend("http://localhost:1", "k", "m"))  # built, never called


SPECS = (("obj", "room", "floor"), ("obj", "room"), ("obj", "floor"), ("obj",))
INSTRUCTIONS = ("the sofa in the living room on floor 1", "find a table", "去一楼的厨房找椅子",
                "bring me the mirror in region bathroom on the second floor")
REPLIES = ("[Floor 1, Living Room, sofa]", "[Kitchen, chair]", "sofa", "[ , bed, ]", "")


@pytest.mark.parametrize("spec", SPECS)
def test_llm_parser_equals_jax(spec):
    seen, jseen = [], []

    def stub(log):
        def backend(system, prompt):
            log.append((system, prompt))
            return REPLIES[len(log) % len(REPLIES)]

        return backend

    p, jp = LLMParser(stub(seen), spec), JLLMParser(stub(jseen), spec)
    for ins in INSTRUCTIONS * 2:
        assert p(ins).astuple() == jp(ins).astuple(), (spec, ins)
    assert seen == jseen and (len(seen) == 0) == (spec == ("obj",))

    def broken(system, prompt):
        raise ConnectionError("down")

    p, jp = LLMParser(broken, spec), JLLMParser(broken, spec)
    for ins in INSTRUCTIONS:
        assert p(ins).astuple() == jp(ins).astuple()
        if spec != ("obj",):
            assert p(ins).astuple() == RuleParser(spec)(ins).astuple()
