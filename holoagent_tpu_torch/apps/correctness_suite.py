"""Query-correctness suite (counterpart of
holoagent_tpu/apps/correctness_suite.py): recall-carrying artifacts for the
FSR benchmarks, measured with the only trained weights the repo has, the
fixture-trained tiny towers (``training.zoo``), through the same engine code
path as the production runs: neural mapping (SAM auto-masks ->
ConceptFusion -> CLIP), HMSG build, room naming, FSR fast/slow retrieval
against a crop-distractor-padded gallery, scored against the GT graph.

The tiny towers are built for the plain attention (``impl="xla"``: their
head dims have no kernel route); the engine, ``ClipVLM`` and the gallery
padding take each tower's own route.  The generative slow path serves the
configured VLM (vlm-small, production width) over the tiny visual tower.

Outputs, under the work directory (default: a machine-keyed directory,
``utils.cachekey.machine_cache_dir``):
  * ``correctness_<mode>.json`` per engine mode and ``correctness_report.json``;
  * with ``merge_into=DIR``: each mode's correctness block merged into
    ``DIR/all_results_<mode>_tpu.json`` where that file exists, and
    ``DIR/long_query_tpu.json``.  DIR is never the repo's ``results/``
    (the port does not rewrite the JAX package's records).

Usage:
  python -m holoagent_tpu_torch.apps.correctness_suite [--device cpu] \\
      [--layout three_room] [--pad-gallery 512] [--out-dir DIR] [--merge-into DIR]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

from .. import config as cfgmod
from ..dataloader.synthetic import SyntheticScene
from ..device import DeviceLike, resolve
from ..eval import gt_from_synthetic
from ..eval.instruction_sets import three_room_instructions
from ..models import clip as clip_mod
from ..models import sam as sam_mod
from ..training.zoo import RECIPE_TAG, ROOM_RECTS, fixture_towers
from ..utils.cachekey import machine_cache_dir
from . import build_map, long_query_bench, query_bench

REPO_RESULTS = Path(__file__).resolve().parents[2] / "results"

PROVENANCE = (
    "fixture-trained tiny towers (training/zoo.py), trained by the PyTorch port; "
    "same engine code path as the production runs"
)

MODES = (
    # oracle first: GT one-hot embeddings isolate the pipeline (parse, room
    # gating, negative-prompt argmax, scoring) from tower quality
    ("fast_oracle", dict(use_slow=False, oracle=True)),
    ("fast", dict(use_slow=False)),
    ("slow_clip", dict(use_slow=True, vlm_kind="clip")),
    ("slow_generative", dict(use_slow=True, vlm_kind="generative")),
)


def default_out(device: DeviceLike = None) -> str:
    """The recipe-tagged, machine-keyed work directory (label-feature caches
    under save_path key on the vocabulary and variant name only, so a new
    tower recipe gets a fresh directory)."""
    return machine_cache_dir(f"correctness_{RECIPE_TAG}", device=device)


def correctness_config(layout: str, save_path: str) -> cfgmod.Config:
    """The neural fixture operating point (the eval protocol's neural row):
    tiny-backbone quality gates, fixture frame scale."""
    cfg = cfgmod.Config()
    cfg.main.dataset = "synthetic"
    cfg.main.layout = layout
    cfg.main.scene_id = f"correctness_{layout}"
    cfg.main.save_path = save_path
    cfg.main.num_frames = 48 if layout != "two_floor" else 72
    cfg.main.frame_h, cfg.main.frame_w = 240, 320  # the towers' training resolution
    cfg.models.clip.type = "test-tiny"
    cfg.models.clip.dtype = "float32"
    cfg.models.sam.type = "fixture-tiny"
    cfg.models.sam.points_per_side = 12
    cfg.models.sam.pred_iou_thresh = 0.45
    cfg.models.sam.stability_score_thresh = 0.5
    cfg.models.sam.min_mask_region_area = 240  # 60 at 120x160, scaled by area
    cfg.models.sam.max_masks = 24
    cfg.pipeline.voxel_size = 0.08
    cfg.pipeline.grid_resolution = 0.08
    # 64k scene rows: a saturated row table silently drops geometry
    cfg.pipeline.point_capacity = 1 << 16
    cfg.pipeline.mask_point_capacity = 4096
    # two_floor carries 54 GT objects + structure shells: 64 rows saturate
    cfg.pipeline.instance_capacity = 128
    cfg.pipeline.skip_frames = 1
    # the production merge fold: the same code path as the production runs
    cfg.pipeline.merge_type = "paired"
    cfg.pipeline.clip_bbox_margin = 16  # 8 px at 120x160, scaled
    # fixture objects are <= 2 m on a side; 3 m rejects room-scale shells
    cfg.pipeline.instance_max_extent_m = 3.0
    # the merge overlap counts coarse cells within one 8 cm cell of the other
    # set; at fixture scale 0.5 compensates for the reference's wider radius
    cfg.pipeline.init_overlap_thresh = 0.5
    # the fixture world's scene card: only the room types its layouts contain
    cfg.pipeline.room_types = (
        "bedroom", "living room", "kitchen", "bathroom", "office", "library",
    )
    # structure classes the fixture towers trained join the negative-prompt gate
    cfg.pipeline.negative_labels = ("background", "wall", "floor")
    # hybrid room naming: object-name affinity recovers rooms the per-view
    # classifier confuses
    cfg.pipeline.room_name_method = "hybrid"
    cfg.pipeline.extract_tiering = False
    cfg.pipeline.obj_labels = "FIXTURE"
    return cfg


def _towers(cfg: cfgmod.Config, device: DeviceLike = None, towers=None):
    """The fixture towers as ``apps.common.load_models`` returns its towers:
    (visual, sam, clip_variant, sam_variant, text)."""
    clip, sam = towers if towers is not None else fixture_towers(device=device)
    cv = clip_mod.VARIANTS[cfg.models.clip.type]
    sv = sam_mod.VARIANTS[cfg.models.sam.type]
    return clip.visual, sam, cv, sv, clip.text


def build_graph(layout: str, save_path: Optional[str] = None, device: DeviceLike = None, towers=None):
    """Neural-path map build with the trained towers on `device`; returns
    (graph_dir, gt_json_path, cfg, models)."""
    dev = resolve(device)
    save_path = save_path or default_out(dev)
    cfg = correctness_config(layout, save_path)
    models = _towers(cfg, dev, towers)
    graph_dir, _ = build_map.run(cfg, models=models, device=dev)
    rects = (SyntheticScene.two_floor_room_rects() if layout == "two_floor"
             else ROOM_RECTS[layout])
    scene = getattr(SyntheticScene, layout)(cfg.main.seed)
    gt = gt_from_synthetic(scene, room_rects=rects)
    gt_path = Path(save_path) / f"scene_info_{layout}.json"
    gt.to_json(gt_path)
    return Path(graph_dir), gt_path, cfg, models


def _checked_merge_dir(merge_into: Optional[str]) -> Optional[Path]:
    if merge_into is None:
        return None
    d = Path(merge_into).resolve()
    if d == REPO_RESULTS.resolve():
        raise ValueError(f"{d}: the port does not rewrite the JAX package's records; name another directory")
    return d


def run_suite(
    layout: str = "three_room",
    pad_gallery: int = 512,
    merge_into: Optional[str] = None,
    out_dir: Optional[str] = None,
    long_query_layout: str = "two_floor",
    device: DeviceLike = None,
    towers=None,
) -> dict:
    """The instruction battery over the padded gallery in every engine mode
    (``MODES``), then the long-query benchmark over `long_query_layout`, on
    `device` with `towers` (default: ``fixture_towers`` there).  Returns
    the report (also written to ``<out_dir>/correctness_report.json``)."""
    dev = resolve(device)
    merge_dir = _checked_merge_dir(merge_into)
    out_dir = out_dir or default_out(dev)
    if towers is None:
        towers = fixture_towers(device=dev)
    t0 = time.time()
    report = {"provenance": PROVENANCE}

    graph_dir, gt_path, cfg, models = build_graph(layout, out_dir, dev, towers)
    instructions = three_room_instructions()
    oracle_block = None
    for name, kw in MODES:
        summary = query_bench.run(
            str(graph_dir), instructions, cfg,
            out_path=str(Path(out_dir) / f"correctness_{name}.json"),
            pad_gallery=pad_gallery, gt_path=str(gt_path), models=models, device=dev, **kw,
        )
        report[name] = {
            "top1_acc": summary.get("top1_acc"),
            "recall_at_5": summary.get("recall_at_5"),
            "n_scored": summary.get("correctness", {}).get("n_scored"),
            "gallery_size": summary.get("gallery_size"),
        }
        if name == "fast_oracle":
            # the oracle row rides the fast artifact as a sub-block
            oracle_block = dict(report[name])
            continue
        if merge_dir is not None:
            _merge(merge_dir / f"all_results_{name}_tpu.json", summary,
                   oracle=oracle_block if name == "fast" else None)

    if long_query_layout:
        lq_graph, lq_gt, lq_cfg, lq_models = build_graph(long_query_layout, out_dir, dev, towers)
        lq = long_query_bench.run(
            str(lq_graph), str(lq_gt), lq_cfg,
            out_path=str((merge_dir or Path(out_dir)) / "long_query_tpu.json"),
            models=lq_models, device=dev,
        )
        report["long_query"] = {k: lq[k] for k in ("n_queries", "floor_acc", "room_acc", "object_acc")}
    report["wall_seconds"] = round(time.time() - t0, 1)
    out = Path(out_dir) / "correctness_report.json"
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    return report


def _merge(artifact: Path, summary: dict, oracle: Optional[dict] = None) -> None:
    """Attach the correctness block to an existing latency artifact (its
    latency fields stay; the recall fields come from this run)."""
    if not artifact.exists():
        return
    data = json.loads(artifact.read_text())
    data["top1_acc"] = summary.get("top1_acc")
    data["recall_at_5"] = summary.get("recall_at_5")
    data["correctness"] = {
        **summary.get("correctness", {}),
        "towers": PROVENANCE,
        "gallery_size": summary.get("gallery_size"),
    }
    if oracle is not None:
        data["oracle"] = {
            **oracle,
            "what": "GT one-hot gallery+text embeddings: pipeline-only recall "
                    "(tower quality removed); ~1.0 certifies the retrieval "
                    "plumbing end to end",
        }
    artifact.write_text(json.dumps(data, indent=2))
    print(f"merged correctness into {artifact}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layout", default="three_room")
    ap.add_argument("--pad-gallery", type=int, default=512)
    ap.add_argument("--merge-into", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run_suite(args.layout, args.pad_gallery, args.merge_into, args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
