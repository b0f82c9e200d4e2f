"""Offline map build (counterpart of holoagent_tpu/apps/build_map.py):
dataset -> streaming Mapper -> label features -> HMSG build -> room names ->
timestamped graph_<ts>/ artifact directory.

Usage:
  python -m holoagent_tpu_torch.apps.build_map [--config cfg.json] [--device cpu] \
      [main.scene_id=... pipeline.skip_frames=4 ...]

Runs on the card unless ``--device cpu`` (``device="cpu"``) is given.  A
YAML config needs PyYAML; without it, pass a JSON file or dotted overrides.
"""

from __future__ import annotations

import argparse
import json
import time
from datetime import datetime
from pathlib import Path
from typing import Optional, Tuple

from .. import config as cfgmod
from ..device import DeviceLike, resolve
from ..memory.hmsg import HMSGraph
from ..memory.mapping import Mapper
from ..models.clip import text_features_multi_template
from ..utils.labels import DEFAULT_ROOM_TYPES, get_label_feats
from ..utils.ply import write_ply
from ..utils.timing import StageTimer, stage
from .common import load_dataset, load_models, tokenizer


def run(
    cfg: cfgmod.Config,
    dataset=None,
    models=None,
    device: DeviceLike = None,
    timer: Optional[StageTimer] = None,
) -> Tuple[Path, HMSGraph]:
    """Map the dataset, build and name the graph, and save it.  models:
    optional preloaded ``load_models`` tuple (clip, sam, clip_variant,
    sam_variant, text) on `device`.  Returns the graph directory and the
    graph.  `timer` records ``map`` (the Mapper, and its own stages),
    ``labels.objects`` and ``labels.rooms`` (the label features), ``build``
    (``build.floors``, ``.rooms``, ``.views``, ``.objects``), ``room_names``
    and ``save``.

    Only the single-device Mapper is ported: ``pipeline.sharded_mapping:
    on`` raises."""
    sm = getattr(cfg.pipeline, "sharded_mapping", "auto")
    if sm == "on":
        raise NotImplementedError("pipeline.sharded_mapping: on: the ShardedMapper is not ported (ROADMAP.md)")
    dev = resolve(device)
    clip, sam, _, _, text = models if models is not None else load_models(cfg, dev)
    dataset = dataset if dataset is not None else load_dataset(cfg)
    t0 = time.time()
    print(f"mapper: single-device Mapper (pipeline.sharded_mapping={sm}) on {dev}")
    with stage(timer, "map"):
        mapped = Mapper(cfg, clip, sam, device=dev, timer=timer).run(dataset)
    map_time = time.time() - t0
    n_frames = len(mapped.keyframes)
    print(f"mapped {n_frames} keyframes in {map_time:.1f}s "
          f"({n_frames / max(map_time, 1e-9):.2f} fps)")

    tok = tokenizer()
    cache_dir = Path(cfg.main.save_path) / "label_cache"
    with stage(timer, "labels.objects"):
        try:
            label_feats, classes = get_label_feats(
                text, tok, cfg.pipeline.obj_labels, cache_dir=cache_dir,
                labels_dir=Path(cfg.main.dataset_path) / "labels" if cfg.main.dataset_path else None,
            )
        except (KeyError, FileNotFoundError) as e:
            print(f"vocabulary {cfg.pipeline.obj_labels!r} unavailable ({e}); "
                  "falling back to SCANNET20")
            label_feats, classes = get_label_feats(text, tok, "SCANNET20", cache_dir=cache_dir)
    with stage(timer, "build"):
        graph = HMSGraph.build(mapped, cfg, label_feats, classes, timer=timer)
    room_types = tuple(getattr(cfg.pipeline, "room_types", ()) or DEFAULT_ROOM_TYPES)
    with stage(timer, "labels.rooms"):
        if room_types == DEFAULT_ROOM_TYPES:
            room_feats, _ = get_label_feats(text, tok, "ROOM_TYPES", cache_dir=cache_dir)
        else:  # scene-card room types (pipeline.room_types)
            room_feats = text_features_multi_template(text, tok, list(room_types)).cpu().numpy()
    with stage(timer, "room_names"):
        graph.generate_room_names(
            room_feats, room_types,
            method=getattr(cfg.pipeline, "room_name_method", "view_embedding"),
        )

    out = Path(cfg.main.save_path) / cfg.main.scene_id
    graph_dir = out / f"graph_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
    n = int(mapped.scene.num)
    with stage(timer, "save"):
        graph.save(graph_dir)
        # full fused cloud + stats (reference save_full_pcd)
        write_ply(
            out / "full_pcd.ply",
            mapped.scene.points()[:n].cpu().numpy(),
            mapped.scene.colors()[:n].cpu().numpy(),
        )
    stats = {
        "frames": n_frames,
        "mapping_seconds": map_time,
        "mapping_fps": n_frames / max(map_time, 1e-9),
        "scene_points": n,
        "instances": int(mapped.instances.num()),
        "floors": len(graph.floors),
        "rooms": len(graph.rooms),
        "objects": len(graph.objects),
        "views": len(graph.views),
    }
    (out / "build_stats.json").write_text(json.dumps(stats, indent=2))
    print(json.dumps(stats, indent=2))
    print(f"graph saved to {graph_dir}")
    return graph_dir, graph


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=False)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    if args.config:
        cfg = cfgmod.load(args.config, args.overrides)
    else:
        cfg = cfgmod.Config()
        for ov in args.overrides:
            cfg = cfgmod.apply_override(cfg, ov)
    return run(cfg, device=args.device)


if __name__ == "__main__":
    main()
