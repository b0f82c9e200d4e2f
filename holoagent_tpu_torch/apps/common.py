"""Shared app plumbing (counterpart of holoagent_tpu/apps/common.py): the
towers per config."""

from __future__ import annotations

from ..config import Config
from ..device import DeviceLike, dtype_of, resolve
from ..models import clip as clip_mod
from ..models import sam as sam_mod


def load_models(cfg: Config, device: DeviceLike = None):
    """CLIP visual tower + SAM per config, on `device` (the card unless the
    caller asks for the CPU), in the configured working dtypes, from seeded
    random weights (``main.seed`` and ``main.seed + 1``).  With
    ``models.clip.quant`` / ``models.sam.quant`` the towers are quantized
    from those weights (W8A8: ``quantize_clip`` / ``quantize_sam``).
    Returns ``(clip, sam, clip_variant, sam_variant)``.

    Checkpoint conversion is not ported yet: a configured checkpoint path
    raises."""
    dev = resolve(device)
    cv = clip_mod.VARIANTS[cfg.models.clip.type]
    sv = sam_mod.VARIANTS[cfg.models.sam.type]
    for name in ("clip", "sam"):
        if getattr(cfg.models, name).checkpoint:
            raise NotImplementedError(f"models.{name}.checkpoint: checkpoint conversion is not ported yet")
    clip = clip_mod.init_clip_visual(cv, seed=cfg.main.seed, dtype=dtype_of(cfg.models.clip.dtype), device=dev)
    if cfg.models.clip.quant:
        clip = clip_mod.quantize_clip(clip)
    sam = sam_mod.init_sam(sv, seed=cfg.main.seed + 1, dtype=dtype_of(cfg.models.sam.dtype), device=dev)
    if cfg.models.sam.quant:
        sam = sam_mod.quantize_sam(sam)
    return clip, sam, cv, sv
