"""Slow-path VLM backends (counterpart of holoagent_tpu/query/vlm_backend.py).

The backend protocol of the slow path's three VLM calls (object-in-image
verification, gallery frame choice, per-image yes/no + best pick), and:

  * ClipVLM — answers all three calls with CLIP similarities on the towers'
    device (verification by an image-text score threshold, frame choice by
    argmax); no generative model needed.  Images that are tensors on that
    device (resident keyframes) are stacked there: nothing is uploaded.
  * NullVLM — accept-everything stub for latency testing of the fast path.

The generative backend (``GenerativeVLM``) waits for the VLM's port
(ROADMAP.md item 4).
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from ..models import clip as clip_mod


class VLMBackend(Protocol):
    def detect_object(self, image: np.ndarray, label: str) -> bool:
        """Is `label` visible in `image`? (reference detect_object_in_image)"""
        ...

    def choose_frame(self, images: Sequence[np.ndarray], instruction: str) -> Optional[int]:
        """Pick the gallery frame best matching the instruction
        (reference vlm_choose, graph.py:2292-2348)."""
        ...

    def detect_and_select_best(
        self, images: Sequence[np.ndarray], label: str
    ) -> Tuple[List[bool], Optional[int]]:
        """Per-image yes/no + best index (reference detect_and_select_best_gpt,
        graph.py:2350-2438)."""
        ...


class NullVLM:
    """Always confirms the fast-path result (slow path short-circuits)."""

    def detect_object(self, image, label) -> bool:
        return True

    def choose_frame(self, images, instruction):
        return 0 if len(images) else None

    def detect_and_select_best(self, images, label):
        return [True] * len(images), 0 if len(images) else None


class ClipVLM:
    """CLIP-similarity backend: zero-shot verification and ranking on the
    towers' device.  The visual tower runs in its own working dtype (bf16 at
    the production config; the reference encodes in float32), its attention
    through kernel K2 on the card; text features are the engine's
    multi-template bf16 features (K2's causal mode on the card)."""

    def __init__(self, visual: clip_mod.CLIPVisual, text: clip_mod.CLIPText, tokenizer,
                 detect_threshold: float = 0.2):
        if visual.patch_w.device != text.tok_emb.device:
            raise ValueError(f"visual tower on {visual.patch_w.device}, text tower on {text.tok_emb.device}")
        self.visual = visual
        self.text = text
        self.tok = tokenizer
        self.variant = visual.variant
        self.device = visual.patch_w.device
        self.detect_threshold = detect_threshold
        self._txt_cache: dict = {}

    def _img_feats(self, images) -> np.ndarray:
        # a tensor already on the device (a resident keyframe) is stacked in
        # place; anything else is uploaded
        arr = torch.stack([torch.as_tensor(im, dtype=torch.float32, device=self.device) for im in images])
        pre = clip_mod.preprocess(arr, size=self.variant.image_size)
        return clip_mod.encode_image(self.visual, pre, impl="flash").cpu().numpy()

    def _txt_feats(self, texts) -> np.ndarray:
        missing = [t for t in texts if t not in self._txt_cache]
        if missing:
            f = clip_mod.text_features_multi_template(self.text, self.tok, missing).cpu().numpy()
            for t, e in zip(missing, f):
                self._txt_cache[t] = e
        return np.stack([self._txt_cache[t] for t in texts])

    def detect_object(self, image, label) -> bool:
        s = float(self._img_feats([image])[0] @ self._txt_feats([label])[0])
        return s >= self.detect_threshold

    def choose_frame(self, images, instruction):
        if not len(images):
            return None
        sims = self._img_feats(images) @ self._txt_feats([instruction])[0]
        return int(np.argmax(sims))

    def detect_and_select_best(self, images, label):
        if not len(images):
            return [], None
        sims = self._img_feats(images) @ self._txt_feats([label])[0]
        checks = [bool(s >= self.detect_threshold) for s in sims]
        return checks, int(np.argmax(sims))

    def rethink_wave(self, gallery, instruction, known_imgs, label):
        """The gallery choice and the checks of the known candidates (anchor
        view, CLIP-best frame): one encode for each.  Returns (choice |
        None, checks for known_imgs)."""
        choice = None
        if len(gallery):
            sims = self._img_feats(gallery) @ self._txt_feats([instruction])[0]
            choice = int(np.argmax(sims))
        checks: List[bool] = []
        if len(known_imgs):
            s = self._img_feats(known_imgs) @ self._txt_feats([label])[0]
            checks = [bool(x >= self.detect_threshold) for x in s]
        return choice, checks
