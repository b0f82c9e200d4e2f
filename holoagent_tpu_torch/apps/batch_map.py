"""Batch map building over a scene list (counterpart of
holoagent_tpu/apps/batch_map.py), the HM3DSem benchmark config's entry point:
the models load once, each scene gets its own ``main.scene_id``,
``main.dataset_path`` and ``pipeline.skip_frames`` overrides, is mapped,
built and saved by ``build_map.run``, and is optionally evaluated against
a GT scene_info JSON.

Usage:
  python -m holoagent_tpu_torch.apps.batch_map --config cfg.json \\
      --scenes scenes.json [--gt-dir <dir with <scene>.json>] [--device cpu]

scenes.json: [{"scene_id": "...", "dataset_path": "...", "skip_frames": 10},
              ...]   (skip_frames optional; falls back to the config value)

Runs on the card unless ``--device cpu`` is given.  A YAML config needs
PyYAML; without it, pass a JSON file.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .. import config as cfgmod
from ..device import DeviceLike, resolve
from ..eval import GTGraph, HMSGEvaluator
from ..memory.hmsg import HMSGraph
from . import build_map
from .common import load_models


def run_batch(cfg: cfgmod.Config, scenes, gt_dir=None, device: DeviceLike = None) -> dict:
    """Map, build and save every scene of `scenes` with one set of models
    on `device`; returns {scene_id: build_stats.json's stats + graph_dir
    [+ eval]}.  Label features are cached under one ``main.save_path``."""
    dev = resolve(device)
    models = load_models(cfg, dev)  # checkpoints load ONCE across all scenes
    summary = {}
    for entry in scenes:
        scene_cfg = cfgmod.apply_override(cfg, f"main.scene_id={entry['scene_id']}")
        if entry.get("dataset_path"):
            scene_cfg = cfgmod.apply_override(scene_cfg, f"main.dataset_path={entry['dataset_path']}")
        if entry.get("skip_frames") is not None:  # per-scene stride
            scene_cfg = cfgmod.apply_override(scene_cfg, f"pipeline.skip_frames={entry['skip_frames']}")
        print(f"=== scene {entry['scene_id']} (skip_frames={scene_cfg.pipeline.skip_frames}) ===")
        graph_dir, _ = build_map.run(scene_cfg, models=models, device=dev)
        stats_path = Path(scene_cfg.main.save_path) / entry["scene_id"] / "build_stats.json"
        stats = json.loads(stats_path.read_text()) if stats_path.exists() else {}
        stats["graph_dir"] = str(graph_dir)
        if gt_dir is not None:
            gt_path = Path(gt_dir) / f"{entry['scene_id']}.json"
            if gt_path.exists():
                ev = HMSGEvaluator(GTGraph.from_json(gt_path))
                stats["eval"] = ev.evaluate_all(HMSGraph.load(graph_dir))
        summary[entry["scene_id"]] = stats
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--scenes", required=True, help="JSON list of scene entries")
    ap.add_argument("--gt-dir", default=None)
    ap.add_argument("--out", default="batch_results.json")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = cfgmod.load(args.config, args.overrides)
    scenes = json.loads(Path(args.scenes).read_text())
    summary = run_batch(cfg, scenes, args.gt_dir, device=args.device)
    Path(args.out).write_text(json.dumps(summary, indent=2))
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "eval"} for k, v in summary.items()}, indent=2))
    return summary


if __name__ == "__main__":
    main()
