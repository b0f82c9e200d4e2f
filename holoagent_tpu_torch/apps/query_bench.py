"""Query benchmark CLI (counterpart of holoagent_tpu/apps/query_bench.py) —
the reference's visualize_query_graph_icra_* family
(reference fsr_vln/application/visualize_query_graph/
visualize_query_graph_icra_ic4f.py:152-327): load a saved HMSG, run a fixed
instruction list through the FSR engine, dump per-query results and stage
latency averages to all_results.json in the reference's schema.

Modes: fast (default); fast with ``--oracle`` (GT one-hot gallery and text
embeddings: the pipeline alone, needs ``--gt``); slow with ``--slow --vlm
clip`` (ClipVLM over keyframes resident on the device) or ``--slow --vlm
generative`` (the on-slice generative VLM, vlm-small over the app's CLIP
visual tower, served by ``ContinuousBatcher``).  With a VLM backend that
keeps ``stats`` each query records its ``vlm_work`` (waves, prompt and new
tokens), and ``--rates`` (the port's own ``serving_bench`` output) turns
them into the reference's device-derived latency fields.

Usage:
  python -m holoagent_tpu_torch.apps.query_bench --graph <graph_dir> \
      --instructions instructions.json [--config cfg.json] [--device cpu] \
      [--slow --vlm clip|generative [--rates serving.json]] [--pad-gallery 512] \
      [--gt scene_info.json [--oracle]]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np
import torch

from .. import config as cfgmod
from ..device import DeviceLike, resolve
from ..eval import GTGraph
from ..memory.hmsg import HMSGraph
from ..memory.nodes import Object
from ..models import clip as clip_mod
from ..models import vlm as vlm_mod
from ..ops.resize import resize
from ..perception.oracle import onehot_label_feats
from ..query import ClipVLM, FSRQueryEngine, GenerativeVLM
from ..query.parser import RuleParser
from ..serving import ContinuousBatcher
from .common import load_dataset, load_models, tokenizer

STAGES = (
    "LLM_Parse_Time",
    "FastMatching",
    "ObjectInImageCheck",
    "VLM_Rethinking",
    "Re_Matching",
    "Total_Time",
)
ENCODE_CHUNK = 64  # distractor crops a visual-tower batch


def _make_vlm(kind: str, clip, text, tok, cfg):
    if kind == "clip":
        return ClipVLM(clip, text, tok)
    if kind == "generative":
        # the VLM's vision tower is the app's CLIP visual tower (shared)
        vv = vlm_mod.VARIANTS[getattr(cfg.models.vlm, "type", "") or "vlm-small"]
        vv = dataclasses.replace(vv, clip_variant=clip.variant.name)
        vlm = vlm_mod.init_vlm(vv, seed=2, dtype=torch.bfloat16, device=clip.patch_w.device)
        return GenerativeVLM(ContinuousBatcher(vlm, clip, tokenizer=tok, max_batch=cfg.serving.max_batch),
                             max_new_tokens=8)
    return None  # NullVLM default inside the engine


def _pad_gallery_with_crops(graph, n: int, dataset, clip, seed: int = 7):
    """Widen the object gallery to production scale with distractor objects
    whose embeddings are RENDERED-CROP features from the SAME image tower as
    the real objects: random windows over the scan's frames (wall/floor/
    background and partial furniture), resized on the tower's device and
    batch-encoded through CLIP on the tower's attention route (kernel K2 on
    the card for the production towers), 64 crops a batch.
    Distractor centers sit far outside the scene so a retrieved distractor
    can never earn GT credit.

    When the dataset carries GT instance masks (synthetic fixtures), windows
    containing OBJECT pixels are rejected: a window showing the queried
    object is a duplicate of the answer, not a distractor.  Structure and
    clutter windows stay in."""
    dev = clip.patch_w.device
    size = clip.variant.image_size
    max_object_frac = 0.05
    rng = np.random.default_rng(seed)
    f_ids = sorted(rng.choice(len(dataset), size=min(len(dataset), 16), replace=False))
    frames = [np.asarray(dataset[int(i)].rgb, np.float32) for i in f_ids]
    gts = [dataset.gt(int(i))[0] if hasattr(dataset, "gt") else None for i in f_ids]
    h, w = frames[0].shape[:2]
    s_lo, s_hi = max(8, h // 8), max(12, h // 2)
    crops = []
    tries = 0
    while len(crops) < n and tries < 40 * n:
        j = tries % len(frames)
        tries += 1
        f, inst = frames[j], gts[j]
        s = int(rng.integers(s_lo, s_hi))
        y0 = int(rng.integers(0, h - s))
        x0 = int(rng.integers(0, w - s))
        if inst is not None and (
            (np.asarray(inst)[y0 : y0 + s, x0 : x0 + s] >= 0).mean() > max_object_frac
        ):
            continue
        crop = torch.from_numpy(np.ascontiguousarray(f[y0 : y0 + s, x0 : x0 + s])).to(dev)
        crops.append(resize(crop, (size, size, 3), "linear"))
    n_req, n = n, len(crops)
    if n < n_req:
        # the object-fraction gate can exhaust the retry budget on dense
        # scenes; a silently shrunk gallery would overstate recall
        print(f"# pad_gallery: {n}/{n_req} distractor windows passed the "
              f"object-fraction gate (<= {max_object_frac}); gallery is smaller")
    if n == 0:
        return
    embs = []
    for i in range(0, n, ENCODE_CHUNK):
        x = clip_mod.preprocess(torch.stack(crops[i : i + ENCODE_CHUNK]), size)
        embs.append(clip_mod.encode_image(clip, x, impl=clip.impl).cpu().numpy())
    embs = np.concatenate(embs)
    base_room = graph.rooms[0].room_id if graph.rooms else "room_0"
    for i in range(n):
        graph.objects.append(Object(
            object_id=f"distractor_{i}", room_id=base_room, name="distractor",
            pcd_points=rng.uniform(100.0, 140.0, (4, 3)),
            embedding=embs[i],
        ))


def _apply_oracle_embeddings(graph, gt, dim: int, pad: float = 0.25):
    """Oracle-retrieval mode: swap every gallery embedding for the one-hot
    label feature of the GT category whose (pad-inflated) aabb contains the
    object's center, and return a text-feature override mapping each
    query/room/negative text into the same one-hot space.  Recall then
    measures the PIPELINE alone — parse, room gating, negative-prompt
    argmax, top-k, GT scoring — the retrieval analog of the eval protocol's
    oracle perception row.  Objects whose center lies in no GT box take the
    'background' vector and are gated out by the negative-prompt argmax."""
    labels = sorted({o.category for o in gt.objects})
    labels += sorted({r.category for r in gt.rooms} - set(labels))
    labels += sorted({r.name for r in graph.rooms if r.name} - set(labels))
    for extra in ("background", "wall", "floor", "distractor"):
        if extra not in labels:
            labels.append(extra)
    feats = onehot_label_feats(labels, dim)
    by_label = {lab: feats[i] for i, lab in enumerate(labels)}
    lo = np.stack([np.asarray(o.center, np.float64) - np.asarray(o.dims) / 2 - pad for o in gt.objects])
    hi = np.stack([np.asarray(o.center, np.float64) + np.asarray(o.dims) / 2 + pad for o in gt.objects])
    cats = [o.category for o in gt.objects]
    for o in graph.objects:
        c = np.asarray(o.center(), np.float64)
        inside = np.nonzero(((c >= lo) & (c <= hi)).all(-1))[0]
        if len(inside):
            # tightest containing box wins (a nightstand inside the bed's
            # inflated box must not inherit 'bed')
            vol = np.prod(hi[inside] - lo[inside], axis=-1)
            o.embedding = by_label[cats[int(inside[np.argmin(vol)])]].copy()
        else:
            o.embedding = by_label["background"].copy()
    return by_label


def _score_against_gt(results, gt, pad: float = 0.25):
    """Retrieval correctness vs the GT graph: the queried category comes
    from the engine's own parse of each instruction; credit = a predicted
    object center lying INSIDE the aabb (inflated by ``pad`` per side) of
    ANY GT object of that category (the box-level analog of the reference
    evaluator's iou>0 association: mapped clouds are observed surfaces, so a
    center-distance sphere fails perfect answers on large objects).  Adds
    per-query top1_correct / recall_at_5 fields and returns the summary."""
    parser = RuleParser()
    by_cat = {}
    for o in gt.objects:
        c = np.asarray(o.center, np.float64)
        h = np.asarray(o.dims, np.float64) / 2.0 + pad
        by_cat.setdefault(o.category, []).append((c - h, c + h))
    n_scored = top1 = rec5 = 0
    for r in results:
        cat = parser(r["instruction"]).object
        r["gt_category"] = cat
        answers = by_cat.get(cat)
        if not answers:
            continue
        pred = np.asarray(r["object_centers"], np.float64).reshape(-1, 3)
        if len(pred):
            lo = np.stack([a[0] for a in answers])  # (G, 3)
            hi = np.stack([a[1] for a in answers])
            inside = ((pred[:, None] >= lo[None]) & (pred[:, None] <= hi[None])).all(-1).any(-1)  # (P,)
            ok1, ok5 = bool(inside[0]), bool(inside[:5].any())
        else:
            ok1 = ok5 = False
        r["top1_correct"], r["recall_at_5"] = ok1, ok5
        n_scored += 1
        top1 += ok1
        rec5 += ok5
    return {
        "n_scored": n_scored,
        "top1_acc": top1 / max(n_scored, 1),
        "recall_at_5": rec5 / max(n_scored, 1),
        "match_criterion": f"pred center inside GT aabb + {pad} m pad",
    }


def _device_derived(results, rates_path: str | None):
    """Device-derived slow-path latency, the reference's formula.  Per
    query:

        t_device = FastMatching + prompt_tokens/128 * prefill_128_ms
                   + ceil(new_tokens/decode_chunk) * decode_step_ms

    with prefill_128_ms and decode_step_ms read from `rates_path`, the
    port's own serving_bench output (never a TPU record).  Returns {} when
    no VLM work was recorded or no rates file is given or exists."""
    recs = [r for r in results if r.get("vlm_work", {}).get("waves")]
    if not recs or not rates_path or not Path(rates_path).exists():
        return {}
    rates = json.loads(Path(rates_path).read_text())
    pre_ms = rates.get("prefill_128_ms")
    dec_ms = rates.get("decode_step_ms")
    chunk = rates.get("decode_chunk", 8)
    if pre_ms is None or dec_ms is None:
        return {}
    per_q = []
    for r in results:
        w = r.get("vlm_work") or {}
        dev = (w.get("prompt_tokens", 0) / 128.0 * pre_ms + -(-w.get("new_tokens", 0) // chunk) * dec_ms) / 1e3
        per_q.append(r["FastMatching"] + dev)
    return {
        "p50_device_derived": float(np.percentile(per_q, 50)),
        "p95_device_derived": float(np.percentile(per_q, 95)),
        "device_derivation": {
            "prefill_128_ms": pre_ms,
            "decode_step_ms": dec_ms,
            "decode_chunk": chunk,
            "formula": "FastMatching + prompt_tokens/128*prefill_128_ms + ceil(new_tokens/chunk)*decode_step_ms",
            "rates_source": str(rates_path),
        },
    }


def run(
    graph_dir: str,
    instructions: List[str],
    cfg: cfgmod.Config,
    use_slow: bool = False,
    out_path: str | None = None,
    dataset=None,
    vlm_kind: str = "clip",
    warmup: bool = True,
    pad_gallery: int = 0,
    gt_path: str | None = None,
    models=None,  # optional preloaded load_models tuple (clip, sam, cv, sv, text) on `device`
    oracle: bool = False,  # GT one-hot embeddings: pipeline-only retrieval row
    device: DeviceLike = None,
    vlm=None,  # optional prebuilt slow-path backend (in place of _make_vlm(vlm_kind))
    rates_path: str | None = None,  # serving_bench output for the device-derived fields
):
    """The instructions over the saved graph, on `device` (the card unless
    the caller asks for the CPU).  Returns the summary written to
    `out_path` (default ``<graph_dir>/all_results.json``)."""
    dev = resolve(device)
    graph = HMSGraph.load(graph_dir)
    clip, _, _, _, text = models if models is not None else load_models(cfg, dev)
    tok = tokenizer()
    if pad_gallery:
        dataset = dataset if dataset is not None else load_dataset(cfg, dev)
        _pad_gallery_with_crops(graph, pad_gallery, dataset, clip)
    text_override = None
    if oracle:
        if not gt_path:
            raise ValueError("--oracle needs --gt (the one-hot label space)")
        text_override = _apply_oracle_embeddings(graph, GTGraph.from_json(gt_path), clip.variant.embed_dim)
    provider = None
    if use_slow:
        dataset = dataset if dataset is not None else load_dataset(cfg, dev)
        # keyframe images stay resident on the device, as during mapping:
        # the query path never uploads them
        skip = max(1, cfg.pipeline.skip_frames)
        resident = {i: torch.as_tensor(dataset[i].rgb, device=dev) for i in range(0, len(dataset), skip)}

        def provider(img_id):
            if img_id in resident:
                return resident[img_id]
            return torch.as_tensor(dataset[img_id].rgb, device=dev)

    engine = FSRQueryEngine(
        graph, text, tok,
        vlm=(vlm if vlm is not None else _make_vlm(vlm_kind, clip, text, tok, cfg)) if use_slow else None,
        device=dev,
        image_provider=provider,
    )
    if text_override is not None:
        engine._text_cache.update(text_override)
    neg = list(getattr(cfg.pipeline, "negative_labels", ()) or ()) or None
    if warmup and instructions:
        # caches warm-up (text features, kernel builds); the reference
        # benchmarks a long-lived warm process the same way
        engine.query_hierarchy(instructions[0], top_k=5, use_slow=use_slow, negative_labels=neg)
    vlm_stats = getattr(engine.vlm, "stats", None) if use_slow else None
    results = []
    for q in instructions:
        before = dict(vlm_stats) if vlm_stats is not None else None
        floor, rooms, objs, res = engine.query_hierarchy(q, top_k=5, use_slow=use_slow, negative_labels=neg)
        results.append({
            "instruction": q,
            "floor": floor.floor_id if floor else None,
            "rooms": [r.room_id for r in rooms],
            "objects": [o.object_id for o in objs],
            "object_names": [o.name for o in objs],
            "object_centers": [o.center().tolist() for o in objs],
            **{k: res.get(k, 0.0) for k in STAGES},
            "scores": [float(s) for s in res.get("scores", [])],
        })
        if before is not None:
            results[-1]["vlm_work"] = {k: vlm_stats[k] - before[k] for k in before}
    totals = [r["Total_Time"] for r in results]
    correctness = _score_against_gt(results, GTGraph.from_json(gt_path)) if gt_path else None
    summary = {
        "num_queries": len(results),
        **{
            f"average_{k.lower()}": float(np.mean([r[k] for r in results])) if results else 0.0
            for k in STAGES
        },
        "p50_total_time": float(np.percentile(totals, 50)) if totals else 0.0,
        "p95_total_time": float(np.percentile(totals, 95)) if totals else 0.0,
        **_device_derived(results, rates_path),
        "gallery_size": len(graph.objects),
        **({"oracle_embeddings": True} if oracle else {}),
        **({"top1_acc": correctness["top1_acc"],
            "recall_at_5": correctness["recall_at_5"],
            "correctness": correctness} if correctness is not None else {}),
        "results": results,
    }
    # reference schema alias (visualize_query_graph_icra_ic4f.py:293-325)
    summary["average_total_time"] = summary.pop("average_total_time", 0.0)
    out = Path(out_path or (Path(graph_dir) / "all_results.json"))
    out.write_text(json.dumps(summary, indent=2))
    print(json.dumps({k: v for k, v in summary.items() if k != "results"}, indent=2))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", required=True)
    ap.add_argument("--instructions", required=True, help="json list of strings")
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--slow", action="store_true")
    ap.add_argument("--vlm", default="clip", choices=("clip", "generative", "null"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--rates", default=None, help="serving_bench output: adds the device-derived latency fields")
    ap.add_argument("--pad-gallery", type=int, default=0)
    ap.add_argument("--gt", default=None, help="scene_info.json GT graph: adds top1/recall@5 fields")
    ap.add_argument("--oracle", action="store_true",
                    help="GT one-hot gallery+text embeddings (pipeline-only retrieval row; requires --gt)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = cfgmod.load(args.config, args.overrides) if args.config else cfgmod.Config()
    if not args.config:
        for ov in args.overrides:
            cfg = cfgmod.apply_override(cfg, ov)
    instructions = json.loads(Path(args.instructions).read_text())
    return run(args.graph, instructions, cfg, use_slow=args.slow, out_path=args.out, vlm_kind=args.vlm,
               pad_gallery=args.pad_gallery, gt_path=args.gt, oracle=args.oracle, device=args.device,
               rates_path=args.rates)


if __name__ == "__main__":
    main()
