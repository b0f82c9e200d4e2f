"""Long-query benchmark CLI (counterpart of
holoagent_tpu/apps/long_query_bench.py): generate hierarchical queries from
the GT graph, run them through the FSR engine over a built HMSG, and score
per-level accuracy against the multi-answer sets (eval/long_query.py does
the generation and scoring; this app closes the loop through the engine).

Usage:
  python -m holoagent_tpu_torch.apps.long_query_bench --graph <graph_dir> \
      --gt scene_info.json [--config cfg.json] [--device cpu] [--out report.json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .. import config as cfgmod
from ..device import DeviceLike, resolve
from ..eval import GTGraph
from ..eval.long_query import generate_long_queries, score_long_queries
from ..memory.hmsg import HMSGraph
from ..query import FSRQueryEngine
from .common import load_models, tokenizer


def run(graph_dir: str, gt_path: str, cfg: cfgmod.Config, out_path: str | None = None, models=None,
        device: DeviceLike = None):
    """models: optional preloaded load_models tuple on `device` (the card
    unless the caller asks for the CPU)."""
    dev = resolve(device)
    graph = HMSGraph.load(graph_dir)
    gt = GTGraph.from_json(gt_path)
    queries = generate_long_queries(gt)
    text = (models if models is not None else load_models(cfg, dev))[4]
    engine = FSRQueryEngine(graph, text, tokenizer(), device=dev)

    floors_sorted = sorted(range(len(graph.floors)), key=lambda i: graph.floors[i].floor_zero_level)
    neg = list(getattr(cfg.pipeline, "negative_labels", ()) or ()) or None
    predictions = []
    for q in queries:
        floor, rooms, objs, _ = engine.query_hierarchy(q.text, top_k=1, negative_labels=neg)
        pred = {}
        if floor is not None:
            # report the floor's rank by zero level (the GT floor index space)
            fi = graph.floors.index(floor)
            pred["floor_id"] = floors_sorted.index(fi)
        if rooms:
            v = np.asarray(rooms[0].vertices, np.float64)
            pred["room_center"] = v[:, :2].mean(axis=0)
        if objs:
            pred["object_center"] = np.asarray(objs[0].center(), np.float64)
        predictions.append(pred)

    report = score_long_queries(queries, predictions, gt)
    summary = {
        "n_queries": report.n_queries,
        "floor_acc": report.floor_acc,
        "room_acc": report.room_acc,
        "object_acc": report.object_acc,
        "per_query": report.per_query,
    }
    out = Path(out_path or (Path(graph_dir) / "long_query_report.json"))
    out.write_text(json.dumps(summary, indent=2))
    print(json.dumps({k: v for k, v in summary.items() if k != "per_query"}))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cfg = cfgmod.load(args.config, []) if args.config else cfgmod.Config()
    return run(args.graph, args.gt, cfg, args.out, device=args.device)


if __name__ == "__main__":
    main()
