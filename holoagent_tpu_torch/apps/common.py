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


def load_dataset(cfg: Config) -> SyntheticDataset:
    """The configured dataset.  Only ``synthetic`` is ported; the file
    loaders wait (ROADMAP.md)."""
    name = cfg.main.dataset
    if name != "synthetic":
        raise NotImplementedError(f"dataset {name!r}: only 'synthetic' is ported (ROADMAP.md)")
    scene = None
    if cfg.main.layout != "two_room":
        scene = getattr(SyntheticScene, cfg.main.layout)(cfg.main.seed)
    return SyntheticDataset(
        scene=scene,
        seed=cfg.main.seed,
        num_frames=cfg.main.num_frames,
        hw=(cfg.main.frame_h, cfg.main.frame_w),
    )


def tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()
