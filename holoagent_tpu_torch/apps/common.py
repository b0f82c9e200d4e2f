"""Shared app plumbing (counterpart of holoagent_tpu/apps/common.py): the
towers, the dataset and the tokenizer per config."""

from __future__ import annotations

from ..config import Config
from ..dataloader.synthetic import SyntheticDataset, SyntheticScene
from ..device import DeviceLike, dtype_of, resolve
from ..models import clip as clip_mod
from ..models import sam as sam_mod
from ..models.tokenizer import SimpleTokenizer


def load_models(cfg: Config, device: DeviceLike = None):
    """CLIP (visual and text towers) + SAM per config, on `device` (the card
    unless the caller asks for the CPU), in the configured working dtypes,
    from seeded random weights (``main.seed`` for both CLIP towers, from
    one generator, and ``main.seed + 1``).  With ``models.clip.quant`` /
    ``models.sam.quant`` the image towers are quantized from those weights
    (W8A8: ``quantize_clip`` / ``quantize_sam``); the text tower stays
    float, as the reference's.
    Returns ``(clip, sam, clip_variant, sam_variant, text)``.

    Checkpoint conversion is not ported yet: a configured checkpoint path
    raises."""
    dev = resolve(device)
    cv = clip_mod.VARIANTS[cfg.models.clip.type]
    sv = sam_mod.VARIANTS[cfg.models.sam.type]
    for name in ("clip", "sam"):
        if getattr(cfg.models, name).checkpoint:
            raise NotImplementedError(f"models.{name}.checkpoint: checkpoint conversion is not ported yet")
    clip, text = clip_mod.init_clip(cv, seed=cfg.main.seed, dtype=dtype_of(cfg.models.clip.dtype), device=dev)
    if cfg.models.clip.quant:
        clip = clip_mod.quantize_clip(clip)
    sam = sam_mod.init_sam(sv, seed=cfg.main.seed + 1, dtype=dtype_of(cfg.models.sam.dtype), device=dev)
    if cfg.models.sam.quant:
        sam = sam_mod.quantize_sam(sam)
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
