"""Accuracy parity protocol (counterpart of
holoagent_tpu/apps/eval_protocol.py): build HMSGs over synthetic scenes
through the production mapping pipeline and score them with the
reference's metric suite (floor bounds, room precision/recall, object
instance AUC@IoU with Hungarian matching, semantic top-k, per-pixel
segmentation).  Two perception rows:

* oracle (perception/oracle.py): GT masks + one-hot label embeddings, so
  the numbers measure the pipeline itself, with no tower weights;
* neural: the real extractor path (SAM automatic masks, ConceptFusion
  fusion, CLIP multi-template text retrieval) with the fixture-trained tiny
  towers of ``training/zoo.py``.  The tiny towers' head dims (16 and 32)
  have no kernel route, so every tower call of the row names the plain
  attention (``impl="xla"``), as the reference's row runs it.

The mapping, the towers, the per-pixel features and the graph build run on
the caller's device (the card unless asked for the CPU); the evaluator is
host numpy/scipy.

Usage:
  python -m holoagent_tpu_torch.apps.eval_protocol [--no-neural] [--device cpu] \
      [--seeds 3] [--neural-seeds 1] [--out eval.md] [--json eval.json] [--save-dir DIR]
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
from ..models.tokenizer import SimpleTokenizer
from ..perception.extractor import extract_frame_features, per_pixel_features
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



def run_one(
    seed: int,
    cfg: Optional[cfgmod.Config] = None,
    layout: str = "two_room",
    perception: str = "oracle",
    device: DeviceLike = None,
    timer: Optional[StageTimer] = None,
    save_dir: Optional[str] = None,
    towers=None,
) -> Dict:
    """One mapping + evaluation run on `device`.

    perception="oracle": GT masks + one-hot embeddings (pipeline-only).
    perception="neural": the real extractor path with the fixture-trained
    towers ``towers=(clip, sam)`` (``training.zoo.fixture_towers``: a
    ``CLIPParams`` and a fixture-tiny SAM on `device`), and label features
    from the trained text tower (multi-template, the production query
    path), all through the plain attention (``impl="xla"``).

    `timer` records ``render`` (the synthetic frames and their GT),
    ``oracle`` or ``extract`` (the FrameFeatures), the Mapper's stages,
    ``segmentation`` (per-pixel features and the confusion counts),
    ``build`` and ``evaluate``.  With `save_dir` the graph is saved to
    ``<save_dir>/graph`` and its GT to ``<save_dir>/gt/scene_info.json``."""
    if perception not in ("oracle", "neural"):
        raise ValueError(f"perception must be 'oracle' or 'neural', got {perception!r}")
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

    if perception == "neural":
        clip, sam = towers
        # tiny-backbone operating point: the 16x16 decoder grid needs
        # forgiving quality gates (the production thresholds assume ViT-H)
        cfg.models.sam.points_per_side = 12
        cfg.models.sam.pred_iou_thresh = 0.45
        cfg.models.sam.stability_score_thresh = 0.5
        cfg.models.sam.min_mask_region_area = 240  # 60 at 120x160, scaled by area
        cfg.models.sam.max_masks = 24
        cfg.models.clip.dtype = "float32"
        # the production 50 px crop margin assumes VGA frames
        cfg.pipeline.clip_bbox_margin = 16.0  # 8 px at 120x160, scaled
        # fixture objects are <= 2 m on a side; 3 m rejects room-scale shells
        cfg.pipeline.instance_max_extent_m = 3.0
        mapper = Mapper(cfg, clip.visual, sam, device=dev, timer=timer, clip_variant=cv)
        label_feats = clip_mod.text_features_multi_template(
            clip.text, SimpleTokenizer(), labels, dtype=torch.float32, impl="xla").cpu().numpy()
        sc = cfg.models.sam
        extract_kw = dict(points_per_side=sc.points_per_side, pred_iou_thresh=sc.pred_iou_thresh,
                          stability_thresh=sc.stability_score_thresh, min_area=float(sc.min_mask_region_area),
                          max_masks=sc.max_masks, bbox_margin=float(cfg.pipeline.clip_bbox_margin),
                          impl="xla", clip_impl="xla")
    else:
        mapper = Mapper(cfg, device=dev, timer=timer, clip_variant=cv)
        label_feats = onehot_label_feats(labels, d)
    conf = np.zeros((len(labels), len(labels)), np.int64)
    for i in range(0, len(ds), cfg.pipeline.skip_frames):
        with stage(timer, "render"):
            frame = ds[i]
            inst_img, lab_img = ds.gt(i)
        if perception == "neural":
            with stage(timer, "extract"):
                ff = extract_frame_features(clip.visual, sam, torch.as_tensor(frame.rgb, device=dev), **extract_kw)
        else:
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


def _train_towers(seed: int = 0, device: DeviceLike = None):
    """The fixture-trained tiny towers for the neural row, served from the
    zoo's disk cache (train once: the protocol and the correctness suite
    share one set of weights)."""
    from ..training.zoo import fixture_towers

    return fixture_towers(seed=seed, verbose=True, device=device)


def run(
    seeds: int = 3,
    out_md: Optional[str] = None,
    out_json: Optional[str] = None,
    neural: bool = True,
    device: DeviceLike = None,
    save_dir: Optional[str] = None,
    timers: Optional[Dict] = None,
    neural_seeds: int = 1,
    towers=None,
) -> dict:
    """Seeds 0..seeds-1 over every layout with oracle perception, then, with
    `neural`, seeds 0..neural_seeds-1 with the fixture-trained towers
    (`towers`, else ``training.zoo.fixture_towers`` on `device`), on
    `device`.  The summary has the reference's JSON schema.  `save_dir`:
    each oracle run saves its graph and GT under
    ``<save_dir>/<layout>_seed<s>`` and each neural run under
    ``<save_dir>/<layout>_seed<s>_neural`` (see ``run_one``).  `timers`: a
    dict that receives one StageTimer per run, keyed (layout, seed) and
    (layout, seed, "neural"), with a ``run`` stage around the whole run."""
    dev = resolve(device)
    t0 = time.time()

    def runs(perception, n, tw=None):
        out = []
        for layout in LAYOUTS:
            for s in range(n):
                key = (layout, s) if perception == "oracle" else (layout, s, perception)
                timer = StageTimer(dev) if timers is not None else None
                if timer is not None:
                    timers[key] = timer
                suffix = "" if perception == "oracle" else f"_{perception}"
                sdir = str(Path(save_dir) / f"{layout}_seed{s}{suffix}") if save_dir else None
                with stage(timer, "run"):
                    out.append(run_one(s, layout=layout, perception=perception, device=dev, timer=timer,
                                       save_dir=sdir, towers=tw))
        return out

    all_m = runs("oracle", seeds)
    neural_m = []
    if neural:
        neural_m = runs("neural", neural_seeds, towers if towers is not None else _train_towers(device=dev))
    wall = time.time() - t0

    def agg(ms, path):
        vals = []
        for m in ms:
            v = m
            try:
                for k in path:
                    v = v[k]
            except KeyError:  # e.g. no matched objects -> no semantic block
                continue
            vals.append(float(v))
        if not vals:
            return 0.0, 0.0
        return float(np.mean(vals)), float(np.std(vals))

    table = {name: agg(all_m, path) for name, path in ROWS} if all_m else {}
    ntable = {name: agg(neural_m, path) for name, path in ROWS} if neural_m else {}
    summary = {
        "seeds": seeds,
        "wall_seconds": round(wall, 1),
        "metrics": {k: {"mean": m, "std": s} for k, (m, s) in table.items()},
        "metrics_neural": {k: {"mean": m, "std": s} for k, (m, s) in ntable.items()},
        "per_seed": json.loads(json.dumps(all_m, default=float)),
        "per_seed_neural": json.loads(json.dumps(neural_m, default=float)),
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
            "* **neural** — the real extractor path (SAM automatic masks,",
            "  ConceptFusion fusion, CLIP multi-template text retrieval) with",
            "  the fixture-trained tiny towers (training/zoo.py).",
            "",
            f"Oracle: {seeds} trajectories (seeds 0..{seeds - 1}) x "
            f"{len(LAYOUTS)} layouts ({', '.join(LAYOUTS)}); neural: {len(neural_m)} runs; on {dev}.  "
            f"Total {wall:.1f}s.",
            "",
            "| metric | oracle mean | oracle std | neural mean | neural std |",
            "|---|---|---|---|---|",
        ]
        for name, (mean, std) in table.items():
            neural_cells = f"{ntable[name][0]:.3f} | {ntable[name][1]:.3f}" if ntable else "— | —"
            lines.append(f"| {name} | {mean:.3f} | {std:.3f} | {neural_cells} |")
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
    ap.add_argument("--neural-seeds", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--save-dir", default=None, help="save each run's graph and GT under this directory")
    args = ap.parse_args(argv)
    return run(args.seeds, args.out, args.json, neural=not args.no_neural, device=args.device,
               save_dir=args.save_dir, neural_seeds=args.neural_seeds)


if __name__ == "__main__":
    main()
