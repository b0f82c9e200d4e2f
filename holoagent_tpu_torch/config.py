"""Typed configuration tree for the whole framework.

The PyTorch port's own copy of ``holoagent_tpu/config.py`` (the port imports
nothing of the JAX package).  Field names and defaults are identical, so a
dict that configures one configures the other.  The port builds a config
with ``from_dict`` only: it has no file loader, and never imports PyYAML.

One dataclass tree spans pipeline thresholds, model choices and mesh/sharding
config — the replacement for the reference's Hydra YAMLs
(cf. reference fsr_vln/config/semantic_scene_reconstruction_ic4f.yaml:1-38) and
ROS parameter files.  A nested dict with the YAML's layout maps onto it
unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# Leaf sections
# ---------------------------------------------------------------------------


@dataclass
class MainConfig:
    """Top-level run settings (reference yaml `main:` section)."""

    device: str = "tpu"
    use_gpt: bool = False
    dataset: str = "synthetic"
    scene_id: str = "synthetic_0"
    dataset_path: str = ""
    depth_cut: float = 10.0
    save_path: str = "/tmp/holoagent_tpu/scene_graphs"
    seed: int = 0
    # synthetic-dataset shape knobs (hermetic fixtures at any resolution)
    frame_h: int = 120
    frame_w: int = 160
    num_frames: int = 24
    layout: str = "two_room"  # synthetic fixture layout (two_room | three_room)


@dataclass
class ClipConfig:
    """CLIP tower selection (reference `models.clip`)."""

    type: str = "ViT-B-32"  # ViT-B-32 | ViT-L-14 | ViT-H-14
    checkpoint: str = ""  # optional torch/open_clip state-dict to convert
    image_size: int = 224
    dtype: str = "bfloat16"
    quant: bool = False  # int8 (W8A8) tower matmuls (models.clip.quantize_clip)


@dataclass
class SamConfig:
    """Open-vocab mask generator (reference `models.sam`, incl. the automatic
    mask generation operating point from
    reference fsr_vln/config/semantic_scene_reconstruction_ic4f.yaml:13-21)."""

    type: str = "vit_b"  # vit_b | vit_l | vit_h
    checkpoint: str = ""
    points_per_side: int = 12
    pred_iou_thresh: float = 0.88
    points_per_batch: int = 144
    stability_score_thresh: float = 0.95
    min_mask_region_area: int = 100
    max_masks: int = 64  # fixed-capacity mask budget per frame (padded)
    image_size: int = 1024
    dtype: str = "bfloat16"
    quant: bool = False  # int8 (W8A8) encoder matmuls (models.sam.quantize_sam)


@dataclass
class VlmConfig:
    """On-slice VLM used by the slow reasoning path (replaces the reference's
    HTTPS Azure GPT-4V calls, reference fsr_vln/memory/hmsg/graph/graph.py:2292-2482)."""

    enabled: bool = False
    checkpoint: str = ""
    max_images: int = 24  # gallery budget, reference graph.py:2896-2897
    max_seq_len: int = 4096
    dtype: str = "bfloat16"


@dataclass
class ModelsConfig:
    clip: ClipConfig = field(default_factory=ClipConfig)
    sam: SamConfig = field(default_factory=SamConfig)
    vlm: VlmConfig = field(default_factory=VlmConfig)


@dataclass
class PipelineConfig:
    """Mapping-pipeline thresholds (reference yaml `pipeline:` section; defaults
    mirror reference fsr_vln/config/semantic_scene_reconstruction_ic4f.yaml:22-38)."""

    voxel_size: float = 0.05
    skip_frames: int = 8
    init_overlap_thresh: float = 0.75
    overlap_thresh_factor: float = 0.025
    iou_thresh: float = 0.05
    clip_masked_weight: float = 0.4418
    clip_bbox_margin: int = 50
    feature_dbscan_eps: float = 0.01
    max_mask_distance: float = 10000.0
    min_pcd_points: int = 100
    depth_weighting: bool = False
    grid_resolution: float = 0.05
    # sequential: all-pairs merge_round over the concat table every frame;
    # hierarchical: binary-counter tree fold; paired: windowed frame->global
    # fold (instances.paired_merge_step — per-row sort unions over only the
    # <= fcap lanes that change) with a full round every
    # `paired_full_round_every` frames; same fixed point as sequential
    # (tested), cheaper per frame because the all-pairs fold re-sorts the
    # whole (I+F)*K concat table every frame
    merge_type: str = "sequential"  # sequential | hierarchical | paired
    paired_full_round_every: int = 32
    save_intermediate_results: bool = False
    obj_labels: str = "SCANNET200"
    merge_objects_graph: bool = False
    # one fused XLA program per frame (lowest dispatch overhead) vs staged
    # programs (much faster compile; the remote compiler chokes on the giant
    # fused graph). Default staged.
    fused_frame_step: bool = False
    # attention impl for the extractor ("flash": Pallas rel-pos kernel on the
    # SAM global layers — the benchmarked TPU operating point)
    extract_impl: str = "xla"
    # CLIP tower attention impl inside the extractor ("flash": head-folded
    # whole-block kernel, fused extract 253 -> 234 ms on v5e)
    extract_clip_impl: str = "xla"
    # pixel decimation for instance-set extraction (0 = auto: ~32k pixels)
    instance_pixel_stride: int = 0
    # masks covering more than this fraction of the frame are background
    # shells: fused into per-pixel scene features but never lifted into the
    # instance table (memory/instances.frame_instances max_area_frac)
    instance_max_area_frac: float = 0.5
    # masks whose WORLD bbox exceeds this on any side are structure shells
    # (walls/floors) regardless of frame coverage — a distant room view
    # covers ~30% of the frame yet lifts a k_cap-saturating blob whose
    # signature overlaps everything and collapses the scene (the reference's
    # DBSCAN + bbox-IoU merge gate never passes a room-scale box,
    # graph_utils.py:918-1038); see instances.frame_instances max_extent
    instance_max_extent_m: float = 4.0
    # room-type card for generate_room_names (empty = the full
    # utils.labels.DEFAULT_ROOM_TYPES list).  The reference passes its scene
    # card's room categories (room.py:131-172 infer_room_type takes the
    # configured type list); voting against types the deployment never
    # contains only adds noise
    room_types: tuple = ()
    # room naming mode for generate_room_names: "view_embedding" (reference
    # room.py:131-172 per-view argmax majority, the default), "objects",
    # "llm", or "hybrid" (view vote + the OBJECT_ROOM_AFFINITY world-knowledge
    # override — the offline stand-in for the reference's GPT room typing,
    # memory/hmsg.py generate_room_names)
    room_name_method: str = "view_embedding"
    # negative-prompt labels for the query engine's class-argmax gate
    # (empty = the engine default ["background"], reference graph.py:3497).
    # Deployments whose vocabulary carries trained structure classes can list
    # them here so structure-looking gallery entries argmax away from the
    # query label
    negative_labels: tuple = ()
    # tiered extraction: size the CLIP crop batch to the frame's actual
    # valid-mask count (two dispatches: mask stage -> host reads the count ->
    # CLIP stage at the smallest capacity tier that fits).  The reference
    # encodes only the actual masks per frame; this is the fixed-shape
    # equivalent (extractor.extract_frame_features_tiered)
    extract_tiering: bool = False
    # frames per extract dispatch (Mapper.run): >1 batches SAM+CLIP
    # extraction across frames in ONE device program — the per-frame
    # program's matmuls are MXU-starved (K=1024 panels, measured ~35-90
    # TF/s on v5e) and batching multiplies their row count; the per-frame
    # fusion/merge stages are unchanged (same results, frame order kept)
    extract_frames_per_dispatch: int = 1
    # fixed-capacity budgets (TPU-native: padded buffers, no dynamic shapes)
    point_capacity: int = 1 << 20  # max fused scene points
    # unique voxels one frame's insert may touch (overflow drops to the trash
    # row for that frame).  Insert's binary-search cost scales with this
    # (64k = 10 ms, 32k = 5 ms, 16k = 2.5 ms on v5e); 32k covers deep views
    # (a 640x480 frame at the 10 m depth cut can touch ~40k 5 cm voxels, so
    # raise it for long-range outdoor scans; close-range indoor fits 16k)
    frame_voxel_capacity: int = 1 << 15
    # multi-device mapping routing: "auto" uses the ShardedMapper whenever >1
    # device is visible (and mesh.model == 1), "on" forces it, "off" keeps the
    # single-device Mapper (bit-reproducible merge order) regardless of
    # devices.  The sharded instance fold is order-different from the
    # single-device path, so reproducible runs need a visible opt-out.
    sharded_mapping: str = "auto"
    mask_point_capacity: int = 1 << 14  # max points per 3-D instance mask
    instance_capacity: int = 512  # max instances tracked during merging
    frame_point_capacity: int = 1 << 18  # max points backprojected per frame


@dataclass
class MeshConfig:
    """Device-mesh / sharding configuration — the framework's parallelism is a
    first-class config axis (no analog in the single-GPU reference; see
    SURVEY.md §2.4 for the design obligations)."""

    # axis sizes; -1 on data axis means "use all remaining devices"
    data: int = -1  # DP over frames / crops / queries
    model: int = 1  # TP over tower weights (heads / mlp shards)
    axis_names: Tuple[str, str] = ("data", "model")


@dataclass
class ServingConfig:
    """Continuous-batching VLM/CLIP service settings."""

    max_batch: int = 8
    max_queue: int = 128
    timeout_ms: float = 5.0


@dataclass
class NavConfig:
    """Local-controller configuration — the DWB critic-plugin surface of
    reference g1_navigation2/param/g1.yaml:50-136, names verbatim:
    ``controller`` selects the family (``dwb`` | ``rpp`` | ``mppi``),
    ``critics`` is the DWB critic list and ``critic_params`` carries the
    dotted per-critic keys (``PathAlign.scale`` etc.)."""

    controller: str = "dwb"
    # default = the g1 operating point (g1.yaml:108 critics list)
    critics: Tuple[str, ...] = (
        "RotateToGoal", "Oscillation", "BaseObstacle", "GoalAlign",
        "PathAlign", "PathDist", "GoalDist",
    )
    critic_params: Dict[str, float] = field(default_factory=dict)
    v_max: float = 0.42   # g1.yaml max_vel_x
    w_max: float = 0.35   # g1.yaml max_vel_theta


@dataclass
class Config:
    main: MainConfig = field(default_factory=MainConfig)
    models: ModelsConfig = field(default_factory=ModelsConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    nav: NavConfig = field(default_factory=NavConfig)


# ---------------------------------------------------------------------------
# Building from a dict
# ---------------------------------------------------------------------------


def _merge_into_dataclass(obj: Any, data: Dict[str, Any]) -> Any:
    """Recursively apply a plain dict onto a dataclass instance."""
    if not dataclasses.is_dataclass(obj):
        return data
    known = {f.name for f in dataclasses.fields(obj)}
    unknown = set(data) - known
    if unknown:
        raise KeyError(
            f"unknown config key(s) {sorted(unknown)} for {type(obj).__name__}; "
            f"known: {sorted(known)}"
        )
    kwargs = {}
    for f in dataclasses.fields(obj):
        cur = getattr(obj, f.name)
        if f.name in data:
            v = data[f.name]
            if dataclasses.is_dataclass(cur) and isinstance(v, dict):
                kwargs[f.name] = _merge_into_dataclass(cur, v)
            elif isinstance(cur, tuple) and isinstance(v, list):
                kwargs[f.name] = tuple(v)
            else:
                kwargs[f.name] = v
        else:
            kwargs[f.name] = cur
    return dataclasses.replace(obj, **kwargs)


def from_dict(data: Dict[str, Any], base: Optional[Config] = None) -> Config:
    return _merge_into_dataclass(base or Config(), data)
