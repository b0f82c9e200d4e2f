"""Accuracy parity protocol, oracle row (counterpart of
holoagent_tpu/apps/eval_protocol.py): build HMSGs over synthetic scenes
through the production mapping pipeline and score them with the
reference's metric suite (floor bounds, room precision/recall, object
instance AUC@IoU with Hungarian matching, semantic top-k, per-pixel
segmentation).  Perception is the oracle (perception/oracle.py): GT masks +
one-hot label embeddings, so the numbers measure the pipeline itself, with
no tower weights.  The mapping, the per-pixel features and the graph build
run on the caller's device (the card unless asked for the CPU); the
evaluator is host numpy/scipy.

Not ported: the neural row (``perception="neural"``), which needs the
fixture-trained towers of ``training/zoo.py`` (ROADMAP.md item 9).

Usage:
  python -m holoagent_tpu_torch.apps.eval_protocol --no-neural [--device cpu] \
      [--seeds 3] [--out eval.md] [--json eval.json] [--save-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .. import config as cfgmod
from ..dataloader.synthetic import SyntheticDataset, SyntheticScene
from ..device import DeviceLike, resolve
from ..eval import HMSGEvaluator, gt_from_synthetic
from ..eval.metrics import confusion_matrix, segmentation_metrics
from ..memory.hmsg import HMSGraph
from ..memory.mapping import Mapper
from ..models import clip as clip_mod
from ..perception.extractor import per_pixel_features
from ..perception.oracle import onehot_label_feats, oracle_frame_features
from ..utils.timing import StageTimer, stage

LAYOUTS = {
    "two_room": (
        lambda SC: SC.two_room(),
        None,  # default GT room rects (split at the dividing wall)
        32,
    ),
    "three_room": (
        lambda SC: SC.three_room(),
        [(0.0, 0.0, 4.0, 6.0, "bedroom"), (4.0, 0.0, 8.0, 6.0, "living room"),
         (8.0, 0.0, 12.0, 6.0, "bathroom")],
        48,
    ),
}

NEURAL_MISSING = ("the neural row needs the fixture-trained towers of training/zoo.py, "
                  "which are not ported (ROADMAP.md item 9); run the oracle row (neural=False, --no-neural)")


def run_one(
    seed: int,
    cfg: Optional[cfgmod.Config] = None,
    layout: str = "two_room",
    perception: str = "oracle",
    device: DeviceLike = None,
    timer: Optional[StageTimer] = None,
    save_dir: Optional[str] = None,
) -> Dict:
    """One mapping + evaluation run with oracle perception on `device`.

    `timer` records ``render`` (the synthetic frames and their GT),
    ``oracle`` (GT FrameFeatures), the Mapper's stages, ``segmentation``
    (per-pixel features and the confusion counts), ``build`` and
    ``evaluate``.  With `save_dir` the graph is saved to
    ``<save_dir>/graph`` and its GT to ``<save_dir>/gt/scene_info.json``."""
    if perception != "oracle":
        raise NotImplementedError(NEURAL_MISSING)
    dev = resolve(device)
    if cfg is None:
        cfg = cfgmod.Config()
        cfg.main.dataset = "synthetic"
        cfg.pipeline.voxel_size = 0.08
        cfg.pipeline.grid_resolution = 0.08
        cfg.pipeline.point_capacity = 1 << 16  # 240x320 frames observe more surface
        # instance row capacity must exceed the largest object's voxel count
        # (a 2 m bed at 0.08 m = ~3k surface voxels); truncation breaks the
        # overlap signatures and fragments instances
        cfg.pipeline.mask_point_capacity = 4096
        cfg.pipeline.instance_capacity = 64
        cfg.pipeline.skip_frames = 1
    make_scene, room_rects, n_frames = LAYOUTS[layout]
    scene = make_scene(SyntheticScene)
    ds = SyntheticDataset(
        # 240x320 matches the reference protocol's fixture resolution
        scene=scene, num_frames=n_frames, hw=(240, 320), seed=seed,
        gaze_heights=(0.8, 2.2),  # sweep walls into view: full-scan coverage
    )
    gt = gt_from_synthetic(scene, room_rects=room_rects)
    labels = scene.labels()
    cv = clip_mod.VARIANTS["test-tiny"]
    d = cv.embed_dim

    mapper = Mapper(cfg, device=dev, timer=timer, clip_variant=cv)
    label_feats = onehot_label_feats(labels, d)
    conf = np.zeros((len(labels), len(labels)), np.int64)
    for i in range(0, len(ds), cfg.pipeline.skip_frames):
        with stage(timer, "render"):
            frame = ds[i]
            inst_img, lab_img = ds.gt(i)
        with stage(timer, "oracle"):
            ff = oracle_frame_features(inst_img, lab_img, labels, d, max_masks=16, device=dev)
        mapper.process_frame(frame, ff=ff)
        with stage(timer, "segmentation"):
            pix = per_pixel_features(ff, dtype=torch.float32).cpu().numpy()
            pred = (pix.reshape(-1, pix.shape[-1]) @ label_feats.T).argmax(-1)
            covered = ff.masks.any(dim=0).reshape(-1).cpu().numpy()
            gt_px = np.where(covered, lab_img.reshape(-1), -1)
            conf += confusion_matrix(pred, gt_px, len(labels))
    mapped = mapper.finalize()
    seg = segmentation_metrics(conf)
    with stage(timer, "build"):
        graph = HMSGraph.build(mapped, cfg, label_feats, labels, timer=timer)
    with stage(timer, "evaluate"):
        ev = HMSGEvaluator(gt)
        m = ev.evaluate_all(graph, gt_text_feats=label_feats, gt_classes=labels)
    m["segmentation"] = seg
    if save_dir is not None:
        graph.save(Path(save_dir) / "graph")
        gt.to_json(Path(save_dir) / "gt" / "scene_info.json")
    return m


ROWS = [
    ("floor bound error (m)", ("floors", "mean_bound_error")),
    ("room precision", ("rooms", "precision")),
    ("room recall", ("rooms", "recall")),
    ("object AUC (overlap sweep)", ("objects", "auc")),
    ("object precision@50", ("objects", "prec_at_50")),
    ("object recall@50", ("objects", "rec_at_50")),
    ("objects split (per-GT diagnostic)", ("objects", "n_split")),
    ("objects merged (per-GT diagnostic)", ("objects", "n_merged")),
    ("objects missed (per-GT diagnostic)", ("objects", "n_miss")),
    ("semantic top-1", ("objects", "semantic_top_k", 1)),
    ("semantic top-3", ("objects", "semantic_top_k", 3)),
    ("semantic AUC", ("objects", "semantic_auc")),
    # per-pixel open-vocab segmentation over mask-covered pixels
    ("segmentation mIoU", ("segmentation", "mIoU")),
    ("segmentation mAcc", ("segmentation", "mAcc")),
    ("segmentation fwIoU", ("segmentation", "fwIoU")),
]


def run(
    seeds: int = 3,
    out_md: Optional[str] = None,
    out_json: Optional[str] = None,
    neural: bool = True,
    device: DeviceLike = None,
    save_dir: Optional[str] = None,
    timers: Optional[Dict] = None,
) -> dict:
    """Seeds 0..seeds-1 over every layout, oracle perception, on `device`.
    The summary has the reference's JSON schema (``metrics_neural`` and
    ``per_seed_neural`` stay empty).  `save_dir`: each run saves its graph
    and GT under ``<save_dir>/<layout>_seed<s>`` (see ``run_one``).  `timers`:
    a dict that receives one StageTimer per run, keyed (layout, seed), with
    a ``run`` stage around the whole run."""
    if neural:
        raise NotImplementedError(NEURAL_MISSING)
    dev = resolve(device)
    t0 = time.time()
    all_m = []
    for layout in LAYOUTS:
        for s in range(seeds):
            timer = StageTimer(dev) if timers is not None else None
            if timer is not None:
                timers[(layout, s)] = timer
            sdir = str(Path(save_dir) / f"{layout}_seed{s}") if save_dir else None
            with stage(timer, "run"):
                all_m.append(run_one(s, layout=layout, device=dev, timer=timer, save_dir=sdir))
    wall = time.time() - t0

    def agg(path):
        vals = []
        for m in all_m:
            v = m
            for k in path:
                v = v[k]
            vals.append(float(v))
        return float(np.mean(vals)), float(np.std(vals))

    table = {name: agg(path) for name, path in ROWS}
    summary = {
        "seeds": seeds,
        "wall_seconds": round(wall, 1),
        "metrics": {k: {"mean": m, "std": s} for k, (m, s) in table.items()},
        "metrics_neural": {},
        "per_seed": json.loads(json.dumps(all_m, default=float)),
        "per_seed_neural": [],
    }
    if out_json:
        Path(out_json).write_text(json.dumps(summary, indent=2, default=float))
    if out_md:
        lines = [
            "# HMSG accuracy protocol (synthetic scenes), PyTorch port",
            "",
            "Built by `python -m holoagent_tpu_torch.apps.eval_protocol --no-neural`:",
            "the production mapping pipeline (voxel fusion → instance merge →",
            "floor/room segmentation → object association) over procedural",
            "multi-room scenes, scored with the reference's metric suite: floor",
            "bounds, room precision/recall at 0.5 BEV overlap, object instance AUC",
            "over the overlap sweep with Hungarian matching, and semantic top-k.",
            "",
            "* **oracle** — GT masks + one-hot label embeddings",
            "  (perception/oracle.py): isolates the pipeline itself.",
            "* **neural** — not ported (it needs the fixture-trained towers).",
            "",
            f"Oracle: {seeds} trajectories (seeds 0..{seeds - 1}) x "
            f"{len(LAYOUTS)} layouts ({', '.join(LAYOUTS)}) on {dev}.  Total {wall:.1f}s.",
            "",
            "| metric | oracle mean | oracle std | neural mean | neural std |",
            "|---|---|---|---|---|",
        ]
        for name, (mean, std) in table.items():
            lines.append(f"| {name} | {mean:.3f} | {std:.3f} | — | — |")
        lines += [
            "",
            "0.95 is the AUC ceiling of the 11-point overlap sweep (accuracy is 0",
            "at threshold 1.0 by construction).",
            "",
        ]
        Path(out_md).write_text("\n".join(lines))
    print(json.dumps({k: v for k, v in summary.items() if k != "per_seed"}, indent=2))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", default=None, help="markdown table (default: none)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--no-neural", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--save-dir", default=None, help="save each run's graph and GT under this directory")
    args = ap.parse_args(argv)
    return run(args.seeds, args.out, args.json, neural=not args.no_neural, device=args.device,
               save_dir=args.save_dir)


if __name__ == "__main__":
    main()
