"""Shared app plumbing (counterpart of holoagent_tpu/apps/common.py): the
towers, the dataset and the tokenizer per config."""

from __future__ import annotations

import torch

from ..config import Config
from ..dataloader.synthetic import SyntheticDataset, SyntheticScene
from ..device import DeviceLike, dtype_of, resolve
from ..models import clip as clip_mod
from ..models import sam as sam_mod
from ..models.tokenizer import SimpleTokenizer


def load_models(cfg: Config, device: DeviceLike = None):
    """CLIP (visual and text towers) + SAM per config, on `device` (the card
    unless the caller asks for the CPU), in the configured working dtypes:
    converted checkpoints where ``models.clip.checkpoint`` /
    ``models.sam.checkpoint`` name one (an open_clip and an official SAM
    torch state dict, ``convert_open_clip`` / ``convert_sam``), else seeded
    random weights (``main.seed`` for both CLIP towers, from one generator,
    and ``main.seed + 1``).  With ``models.clip.quant`` / ``models.sam.quant``
    the image towers are then quantized (W8A8: ``quantize_clip`` /
    ``quantize_sam``), a checkpoint from its float32 values as the
    reference quantizes its converted params; the text tower stays float,
    as the reference's.
    Returns ``(clip, sam, clip_variant, sam_variant, text)``."""
    dev = resolve(device)
    cv = clip_mod.VARIANTS[cfg.models.clip.type]
    sv = sam_mod.VARIANTS[cfg.models.sam.type]
    c, sc = cfg.models.clip, cfg.models.sam
    dtype, sam_dtype = dtype_of(c.dtype), dtype_of(sc.dtype)
    if c.checkpoint:
        clip, text = clip_mod.load_checkpoint(c.checkpoint, cv, dtype=torch.float32 if c.quant else dtype, device=dev)
        text = text.to(dtype)
    else:
        clip, text = clip_mod.init_clip(cv, seed=cfg.main.seed, dtype=dtype, device=dev)
    if c.quant:
        clip = clip_mod.quantize_clip(clip, dtype=dtype)
    if sc.checkpoint:
        sam = sam_mod.load_checkpoint(sc.checkpoint, sv, dtype=torch.float32 if sc.quant else sam_dtype, device=dev)
    else:
        sam = sam_mod.init_sam(sv, seed=cfg.main.seed + 1, dtype=sam_dtype, device=dev)
    if sc.quant:
        sam = sam_mod.quantize_sam(sam, dtype=sam_dtype)
    return clip, sam, cv, sv, text


def load_dataset(cfg: Config, device: DeviceLike = None):
    """The configured dataset: ``synthetic`` (rendered), or a file loader
    (``horizon``, ``scannet``, ``hm3dsem``, ``replica``) over
    ``main.dataset_path`` / ``main.scene_id``.  The loaders yield host numpy
    frames; `device` is the device they are mapped on (the card unless the
    caller asks for the CPU), resolved first, so a run meant for an absent
    card fails before any file is read.  An unknown name raises KeyError."""
    resolve(device)
    name, m = cfg.main.dataset, cfg.main
    if name == "synthetic":
        scene = None
        if m.layout != "two_room":
            scene = getattr(SyntheticScene, m.layout)(m.seed)
        return SyntheticDataset(scene=scene, seed=m.seed, num_frames=m.num_frames, hw=(m.frame_h, m.frame_w))
    if name == "horizon":
        from ..dataloader.horizon import HorizonDataset

        return HorizonDataset(m.dataset_path, m.scene_id, m.depth_cut)
    if name == "scannet":
        from ..dataloader.scannet import ScannetDataset

        return ScannetDataset(m.dataset_path, m.scene_id, m.depth_cut)
    if name == "hm3dsem":
        from ..dataloader.hm3dsem import HM3DSemDataset

        return HM3DSemDataset(m.dataset_path, m.scene_id, m.depth_cut)
    if name == "replica":
        from ..dataloader.replica import ReplicaDataset

        return ReplicaDataset(m.dataset_path, m.scene_id, m.depth_cut)
    raise KeyError(f"unknown dataset {name!r}")


def tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()
