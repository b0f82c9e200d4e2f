"""Rank bodies of the port's multi-device tests (test_torch_parallel.py,
test_torch_sharded_scene.py).

This module imports torch, numpy and the port only: the ranks are spawned
processes (``parallel.launch.spawn``, gloo on the CPU), and importing JAX in
each of them would cost seconds and memory for nothing.  A test module
writes its numpy inputs, spawns its ranks once, and every case below runs in
every rank; each returns numpy results, which the test module holds against
the JAX package's.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.config import MeshConfig, from_dict
from holoagent_tpu_torch.parallel import comm, make_mesh
from holoagent_tpu_torch.parallel import sharding as tsharding


def run_cases(rank: int, world: int, inputs_path: str, cases: list) -> dict:
    """Every named case of `cases` on this rank: {name: numpy results}."""
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    torch.manual_seed(0)
    return {name: CASES[name](inputs.get(name)) for name in cases}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _mesh(data=-1, model=1):
    return make_mesh(MeshConfig(data=data, model=model), "cpu")


def _axis_mesh(name: str):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(torch.distributed.get_world_size()), mesh_dim_names=(name,))


# ---------------------------------------------------------------------------
# parallel/*
# ---------------------------------------------------------------------------


def case_mesh(_):
    out = {}
    for model in (1, 2, 4):
        m = _mesh(model=model)
        out[f"shape_{model}"] = tuple(m.mesh.shape)
        out[f"coords_{model}"] = (comm.index(m, "data"), comm.index(m, "model"))
    for data, model in ((-1, 3), (3, 1)):
        try:
            _mesh(data, model)
            out[f"error_{data}_{model}"] = None
        except ValueError as e:
            out[f"error_{data}_{model}"] = str(e)
    return out


def case_sharding(inp):
    from holoagent_tpu_torch.models import clip as tclip
    from holoagent_tpu_torch.training import contrastive as tcon

    tree, cv = inp["tree"], tclip.VARIANTS[inp["variant"]]
    params = tcon.clip_params(bridge.clip_from_jax(tree, cv, device="cpu", impl="xla"),
                              bridge.clip_text_from_jax(tree, cv, device="cpu", impl="xla"),
                              bridge.logit_scale_from_jax(tree))
    mesh = _mesh(model=2)
    local = tsharding.shard_params(params, mesh)
    rule = tsharding.clip_param_sharding(params, mesh)
    return {
        "local": {k: _np(v) for k, v in local.items()},
        "rule": {k: [repr(p) for p in v] for k, v in rule.items()},
        "data_sharding": [repr(p) for p in tsharding.data_sharding(mesh, 4)],
        "replicated": [repr(p) for p in tsharding.replicated(mesh)],
    }


def case_ring(inp):
    from holoagent_tpu_torch.parallel.ring_attention import ring_attention

    mesh = _mesh()
    q, k, v = (torch.from_numpy(inp[n]) for n in "qkv")
    return {c: _np(ring_attention(q, k, v, mesh, causal=c)) for c in (False, True)}


def mlp_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def block_stage(p, h):
    from types import SimpleNamespace

    from holoagent_tpu_torch.models import transformer as tfm

    return tfm.block(h, SimpleNamespace(**p), 4)


def case_pipeline(inp):
    from holoagent_tpu_torch.parallel.pipeline import pipeline_apply, stack_stages

    mesh = _axis_mesh("stage")
    out = {}
    for name, fn in (("mlp", mlp_stage), ("mlp_m1", mlp_stage), ("blocks", block_stage)):
        stages = [{k: torch.from_numpy(a) for k, a in s.items()} for s in inp[name]["stages"]]
        x = torch.from_numpy(inp[name]["x"])
        got = pipeline_apply(fn, stack_stages(stages), x, mesh)
        seq = []
        for mb in x:  # the sequential stack, microbatch by microbatch
            for p in stages:
                mb = fn(p, mb)
            seq.append(mb)
        out[name] = (_np(got), _np(torch.stack(seq)))
    return out


def case_moe(inp):
    from holoagent_tpu_torch.parallel.moe import moe_apply, moe_dense_reference

    mesh = _axis_mesh("expert")
    out = {}
    for name, c in inp.items():
        params = {k: torch.from_numpy(a) for k, a in c["params"].items()}
        gw, x = torch.from_numpy(c["gate_w"]), torch.from_numpy(c["x"])
        got = moe_apply(params, gw, x, mesh, top_k=2, capacity_factor=c["cf"])
        out[name] = (_np(got), _np(moe_dense_reference(params, gw, x, top_k=2)))
    return out


def case_topk(inp):
    from holoagent_tpu_torch.ops import retrieval

    mesh = _mesh()
    g, v, q = (torch.from_numpy(inp[n]) for n in ("g", "valid", "q"))
    s, i = retrieval.topk_cosine_sharded(g, v, q, inp["k"], mesh)
    ds, di = retrieval.topk_cosine(g, v, q, inp["k"])
    return {"sharded": (_np(s), _np(i)), "dense": (_np(ds), _np(di))}


def _vlm(inp, name):
    from holoagent_tpu_torch.models import vlm as tvlm

    return bridge.vlm_from_jax(inp["vlm"][name], tvlm.VARIANTS[name], device="cpu")


def case_prefill_sp(inp):
    from holoagent_tpu_torch.models import vlm as tvlm

    mesh = _mesh()
    out = {}
    for name in ("test-tiny", "test-tiny-llama"):
        m = _vlm(inp, name)
        emb, vlen = torch.from_numpy(inp["emb"][name]), torch.from_numpy(inp["vlen"][name])
        logits, cache = tvlm.prefill_sp(m, emb, vlen, mesh)
        ref_logits, ref_cache = tvlm.prefill(m, emb, vlen, tvlm.init_cache(m.variant, emb.shape[0], torch.float32,
                                                                           "cpu"), impl="xla")
        t = emb.shape[1]
        out[name] = {"logits": _np(logits), "k": _np(cache.k[:, :, :t]).copy(), "v": _np(cache.v[:, :, :t]).copy(),
                     "length": _np(cache.length).copy(), "ref_logits": _np(ref_logits),
                     "ref_k": _np(ref_cache.k[:, :, :t]).copy()}
        # decode continues from the sequence-parallel cache as from the dense one (in place: last)
        tok = torch.argmax(ref_logits, dim=-1)
        active = torch.ones(emb.shape[0], dtype=torch.bool)
        out[name]["decode"] = _np(tvlm.decode_step(m, tok, cache, active)[0])
        out[name]["ref_decode"] = _np(tvlm.decode_step(m, tok, ref_cache, active)[0])
    return out


def case_batcher(inp):
    from holoagent_tpu_torch.models import clip as tclip
    from holoagent_tpu_torch.serving import ContinuousBatcher

    mesh = _mesh()
    visual = bridge.clip_from_jax(inp["clip"], tclip.VARIANTS["test-tiny"], device="cpu")
    m = _vlm(inp, "test-tiny")
    plain = ContinuousBatcher(m, visual, max_batch=2).generate(inp["prompt"], max_new_tokens=5)
    sp = ContinuousBatcher(m, visual, max_batch=2, mesh=mesh, sp_threshold=4).generate(inp["prompt"],
                                                                                       max_new_tokens=5)
    return {"plain": plain, "sp": sp}


def _clip_params(inp):
    from holoagent_tpu_torch.models import clip as tclip
    from holoagent_tpu_torch.training import contrastive as tcon

    cv = tclip.VARIANTS[inp["variant"]]
    tree = inp["tree"]
    return cv, tcon.clip_params(bridge.clip_from_jax(tree, cv, device="cpu", impl="xla"),
                                bridge.clip_text_from_jax(tree, cv, device="cpu", impl="xla"),
                                bridge.logit_scale_from_jax(tree))


def case_train_step(inp):
    from holoagent_tpu_torch.training import contrastive as tcon

    imgs, toks = torch.from_numpy(inp["imgs"]), torch.from_numpy(inp["toks"])
    out = {}
    for name, model in (("dp", 1), ("dp_tp", 2), ("single", None), ("dp_sgd", 1), ("single_sgd", None)):
        cv, p = _clip_params(inp)
        if name.endswith("sgd"):
            tx = torch.optim.SGD(list(p.parameters()), lr=inp["sgd_lr"])
        else:
            tx = tcon.init_train_state(p, lr=inp["lr"])
        mesh = None if model is None else _mesh(model=model)
        step = tcon.make_train_step(cv, tx, mesh=mesh, dtype=torch.float32)
        losses = [float(step(p, imgs, toks)) for _ in range(inp["steps"])]
        # the last step's gradients stay on the parameters after the update
        out[name] = (losses, bridge.clip_to_numpy(p.visual, p.text, p.logit_scale),
                     bridge.clip_to_numpy(p.visual, p.text, p.logit_scale, leaf=lambda t: t.grad))
    return out


# ---------------------------------------------------------------------------
# memory/sharded_scene.py, extract_frames_dp, the ShardedMapper, build_map
# ---------------------------------------------------------------------------


def _shard_np(sh):
    return {f: _np(getattr(sh, f)) for f in ("key", "sorted_key", "sorted_row", "sum_pts", "sum_col", "count",
                                             "sum_feat", "feat_count", "num")}


def _scene_np(s):
    return {f: _np(getattr(s, f)) for f in ("key", "sorted_key", "sorted_row", "sum_pts", "sum_col", "count",
                                            "sum_feat", "feat_count", "num")}


def case_insert_fuse(inp):
    from holoagent_tpu_torch.memory import sharded_scene as ss
    from holoagent_tpu_torch.ops.voxel import GridSpec

    mesh = _mesh()
    grid = GridSpec.make(0.25, origin=(-4.0, -4.0, -4.0))
    sh = ss.init_sharded_scene(grid, 512, inp["d"], mesh)
    steps = []
    for pts, cols, valid, masks, mvalid, fm in inp["frames"]:
        sh, rows = ss.insert_points_sharded(sh, torch.from_numpy(pts), torch.from_numpy(cols),
                                            torch.from_numpy(valid), mesh, fcap=1024, bcap=512)
        after_insert = _shard_np(sh)
        sh = ss.fuse_pixel_features_sharded(sh, rows, torch.from_numpy(masks), torch.from_numpy(mvalid),
                                            torch.from_numpy(fm), mesh, rcap=1024, bcap=512)
        steps.append({"rows": _np(rows), "insert": after_insert})
    scene, row_map = ss.to_scene(sh, mesh)
    # reinsert: the first frame twice into a fresh scene
    pts, cols, valid = (torch.from_numpy(a) for a in inp["frames"][0][:3])
    fresh = ss.init_sharded_scene(grid, 512, inp["d"], mesh)
    fresh, r1 = ss.insert_points_sharded(fresh, pts, cols, valid, mesh, fcap=1024, bcap=512)
    fresh, r2 = ss.insert_points_sharded(fresh, pts, cols, valid, mesh, fcap=1024, bcap=512)
    total = comm.all_reduce(fresh.count.sum(), mesh, "data")
    # buckets too small for the frame: the overflow drops and is counted
    pts, cols, valid, masks, mvalid, fm = (torch.from_numpy(a) for a in inp["frames"][0])
    small = ss.init_sharded_scene(grid, 512, inp["d"], mesh)
    small, rows = ss.insert_points_sharded(small, pts, cols, valid, mesh, fcap=1024, bcap=inp["small_bcap"][0])
    after_insert = int(small.dropped)
    small = ss.fuse_pixel_features_sharded(small, rows, masks, mvalid, fm, mesh, rcap=1024,
                                           bcap=inp["small_bcap"][1])
    return {"steps": steps, "final": _shard_np(sh), "scene": _scene_np(scene), "row_map": _np(row_map),
            "reinsert": (_np(r1), _np(r2), float(total)), "dropped": int(sh.dropped),
            "overflow": {"rows": _np(rows), "shard": _shard_np(small), "dropped": (after_insert, int(small.dropped))},
            "wire": ss.wire_bytes_per_frame(mesh, inp["d"], 1024, 512)}


def _towers(inp):
    from holoagent_tpu_torch.models import clip as tclip
    from holoagent_tpu_torch.models import sam as tsam

    clip = bridge.clip_from_jax(inp["clip"], tclip.VARIANTS["test-tiny"], device="cpu", impl="xla")
    sam = bridge.sam_from_jax(inp["sam"], tsam.VARIANTS["test-tiny"], device="cpu")
    return clip, sam


def case_extract_dp(inp):
    from holoagent_tpu_torch.perception.extractor import extract_frames_batched, extract_frames_dp

    mesh = _mesh()
    clip, sam = _towers(inp)
    imgs = torch.from_numpy(inp["imgs"])
    dp = extract_frames_dp(clip, sam, imgs, mesh, **inp["kw"])
    whole = extract_frames_batched(clip, sam, imgs, **inp["kw"])
    return {"dp": [_np(a) for a in dp], "batched": [_np(a) for a in whole]}


def _instances_np(inst):
    return {f: _np(getattr(inst, f)) for f in inst._fields}


def _frames(inp):
    from holoagent_tpu_torch.dataloader import SyntheticDataset

    return SyntheticDataset(num_frames=inp["frames"], hw=tuple(inp["hw"]))


def case_sharded_mapper(inp):
    from holoagent_tpu_torch.memory.sharded_scene import ShardedMapper
    from holoagent_tpu_torch.perception import extractor

    cfg = from_dict(inp["cfg"])
    mesh = make_mesh(cfg.mesh, "cpu")
    clip, sam = _towers(inp)
    ds = _frames(inp)
    feats = []
    real = extractor.extract_frames_dp

    def recorded(*a, **kw):
        ff = real(*a, **kw)
        feats.append([_np(x) for x in ff])
        return ff

    extractor.extract_frames_dp = recorded
    try:
        sm = ShardedMapper(cfg, clip, sam, mesh)
        sm.process_batch([ds[i] for i in range(len(ds))])
        mapped = sm.finalize()
    finally:
        extractor.extract_frames_dp = real
    return {"features": feats, "scene": _scene_np(mapped.scene), "instances": _instances_np(mapped.instances),
            "instance_feats": _np(mapped.instance_feats), "keyframe_feats": _np(mapped.keyframe_feats),
            "density": _np(mapped.density_keep),
            "exchange": {"fcap": sm.fcap, "bcap": sm.bcap, "dropped": sm.dropped, "wire": sm.wire_bytes()}}


def case_build_map(inp):
    from holoagent_tpu_torch.apps import build_map
    from holoagent_tpu_torch.models import clip as tclip

    cfg = from_dict(inp["cfg"])
    clip, sam = _towers(inp)
    text = bridge.clip_text_from_jax(inp["clip"], tclip.VARIANTS["test-tiny"], device="cpu", impl="xla")
    models = (clip, sam, clip.variant, sam.variant, text)
    graph_dir, g = build_map.run(cfg, dataset=_frames(inp), models=models, device="cpu")
    files = sorted(str(p.relative_to(graph_dir)) for p in Path(graph_dir).rglob("*") if p.is_file())
    return {"graph_dir": str(graph_dir), "files": files,
            "rooms": [(r.room_id, r.name) for r in g.rooms], "objects": [(o.object_id, o.name) for o in g.objects],
            "views": len(g.views)}


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}
