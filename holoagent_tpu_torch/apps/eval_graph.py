"""Graph evaluation CLI (counterpart of holoagent_tpu/apps/eval_graph.py):
a saved HMSG against a GT scene_info.json, host numpy/scipy.

Usage:
  python -m holoagent_tpu_torch.apps.eval_graph --graph <graph_dir> --gt scene_info.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..eval import GTGraph, HMSGEvaluator
from ..memory.hmsg import HMSGraph


def run(graph_dir: str, gt_path: str, out_path: str | None = None):
    pred = HMSGraph.load(graph_dir)
    gt = GTGraph.from_json(gt_path)
    ev = HMSGEvaluator(gt)
    metrics = ev.evaluate_all(pred)
    # strip bulky matrices for the printed summary
    printable = json.loads(json.dumps(metrics, default=float))
    printable.get("rooms", {}).pop("overlap_matrix", None)
    print(json.dumps(printable, indent=2))
    out = Path(out_path or (Path(graph_dir) / "eval_metrics.json"))
    out.write_text(json.dumps(metrics, default=float, indent=2))
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    return run(args.graph, args.gt, args.out)


if __name__ == "__main__":
    main()
