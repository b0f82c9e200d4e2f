"""Offline map build (counterpart of holoagent_tpu/apps/build_map.py):
dataset -> streaming Mapper -> label features -> HMSG build -> room names ->
timestamped graph_<ts>/ artifact directory.

Usage:
  python -m holoagent_tpu_torch.apps.build_map [--config cfg.json] [--device cpu] \
      [main.scene_id=... pipeline.skip_frames=4 ...]

Runs on the card unless ``--device cpu`` (``device="cpu"``) is given.  A
YAML config needs PyYAML; without it, pass a JSON file or dotted overrides.
On N cards, one rank a card: ``torchrun --nproc-per-node N -m
holoagent_tpu_torch.apps.build_map ... pipeline.sharded_mapping=on``.
"""

from __future__ import annotations

import argparse
import json
import time
from datetime import datetime
from pathlib import Path
from typing import Optional, Tuple

import torch.distributed as dist

from .. import config as cfgmod
from ..device import DeviceLike, resolve
from ..memory.hmsg import HMSGraph
from ..memory.mapping import Mapper
from ..memory.sharded_scene import ShardedMapper
from ..models.clip import text_features_multi_template
from ..parallel import comm
from ..parallel.mesh import make_mesh
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

    ``pipeline.sharded_mapping``: "on" maps with the ShardedMapper over
    ``make_mesh(cfg.mesh)`` (a one-rank group in a plain process); "auto"
    does so when the process group spans more than one rank (the
    reference's "more than one device visible") and ``mesh.model == 1``;
    "off" keeps the single-device Mapper.  On a mesh every rank maps, only
    the mesh's first rank builds and writes the graph directory, and the
    others load it from there."""
    sm = getattr(cfg.pipeline, "sharded_mapping", "auto")
    dev = resolve(device)
    clip, sam, _, _, text = models if models is not None else load_models(cfg, dev)
    dataset = dataset if dataset is not None else load_dataset(cfg, dev)
    t0 = time.time()
    world = dist.get_world_size() if dist.is_initialized() else 1
    auto_sharded = cfg.mesh.model == 1 and world > 1 and (cfg.mesh.data < 0 or cfg.mesh.data > 1)
    mesh = None
    if sm == "on" or (sm == "auto" and auto_sharded):
        mesh = make_mesh(cfg.mesh, dev)
        print(f"mapper: ShardedMapper over mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
              f"(pipeline.sharded_mapping={sm}; instance-merge order differs from the single-device "
              f"Mapper: set sharded_mapping: off for single-device-reproducible runs)")
        mapper = ShardedMapper(cfg, clip, sam, mesh, timer=timer)
        frames = [dataset[i] for i in range(0, len(dataset), cfg.pipeline.skip_frames)]
        bsz = comm.size(mesh, "data")
        with stage(timer, "map"):
            for i in range(0, len(frames), bsz):
                mapper.process_batch(frames[i : i + bsz])
            mapped = mapper.finalize()
    else:
        print(f"mapper: single-device Mapper (pipeline.sharded_mapping={sm}, {world} rank(s)) on {dev}")
        with stage(timer, "map"):
            mapped = Mapper(cfg, clip, sam, device=dev, timer=timer).run(dataset)
    map_time = time.time() - t0
    n_frames = len(mapped.keyframes)
    print(f"mapped {n_frames} keyframes in {map_time:.1f}s "
          f"({n_frames / max(map_time, 1e-9):.2f} fps)")

    if mesh is not None and not _leads(mesh):
        graph_dir = _graph_dir_of_lead(mesh, None)
        return graph_dir, HMSGraph.load(graph_dir)
    graph_dir, graph = _build_and_save(cfg, mapped, text, timer, n_frames, map_time)
    if mesh is not None:
        _graph_dir_of_lead(mesh, graph_dir)
    return graph_dir, graph


def _leads(mesh) -> bool:
    return int(mesh.mesh.flatten()[0]) == dist.get_rank()


def _graph_dir_of_lead(mesh, graph_dir: Optional[Path]) -> Path:
    """The mesh's first rank hands its graph directory to the others once it
    is written (every rank calls this)."""
    box = [str(graph_dir) if graph_dir is not None else None]
    dist.broadcast_object_list(box, src=int(mesh.mesh.flatten()[0]))
    return Path(box[0])


def _build_and_save(cfg, mapped, text, timer, n_frames: int, map_time: float) -> Tuple[Path, HMSGraph]:
    """Label features -> HMSGraph.build -> room names -> graph_<ts>/, the
    fused cloud and the stats."""
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
