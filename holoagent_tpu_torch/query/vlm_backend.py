"""Slow-path VLM backends (counterpart of holoagent_tpu/query/vlm_backend.py).

The backend protocol of the slow path's three VLM calls (object-in-image
verification, gallery frame choice, per-image yes/no + best pick), and:

  * ClipVLM — answers all three calls with CLIP similarities on the towers'
    device (verification by an image-text score threshold, frame choice by
    argmax); no generative model needed.  Images that are tensors on that
    device (resident keyframes) are stacked there: nothing is uploaded.
  * GenerativeVLM — the on-slice generative model (``models/vlm.py``)
    served by ``serving.ContinuousBatcher``: the reference's GPT-4V prompts
    re-targeted at the local engine.  Resident keyframes are stacked on the
    batcher's device, as ClipVLM stacks them.
  * NullVLM — accept-everything stub for latency testing of the fast path.
"""

from __future__ import annotations

import re
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


def _first_index(text: str, n: int) -> int:
    """The first number in a generated answer if it names one of n images,
    else 0."""
    m = re.findall(r"\d+", text)
    return int(m[0]) if m and int(m[0]) < n else 0


class GenerativeVLM:
    """VLMBackend over the on-slice generative model served with continuous
    batching (``serving.ContinuousBatcher``)."""

    def __init__(self, batcher, max_new_tokens: int = 16):
        self.batcher = batcher
        self.max_new_tokens = max_new_tokens
        # cumulative device-work accounting for the device-derived latency
        # fields (apps/query_bench.py p50_device_derived): sequential wave
        # count + token totals per wave
        self.stats = {"waves": 0, "prompt_tokens": 0, "new_tokens": 0}

    def _ask_many(self, calls) -> List[str]:
        """Submit [(prompt, images | None), ...] together and drive the engine
        until all finish: a call's per-image checks ride one continuous batch.
        Images that are tensors on the batcher's device are stacked there;
        anything else is uploaded."""
        from ..serving.batcher import GenRequest

        dev = self.batcher.device
        reqs = []
        for prompt, images in calls:
            imgs = None
            if images is not None:
                imgs = torch.stack([torch.as_tensor(im, dtype=torch.float32, device=dev) for im in images])
            reqs.append(self.batcher.submit(GenRequest(prompt, imgs, self.max_new_tokens)))
        while not all(r._done.is_set() for r in reqs):
            self.batcher.step()
        self.stats["waves"] += 1
        self.stats["prompt_tokens"] += sum(r.prompt_tokens for r in reqs)
        self.stats["new_tokens"] += sum(r.generated for r in reqs)
        return [r.result().lower() for r in reqs]

    def _ask(self, prompt: str, images) -> str:
        return self._ask_many([(prompt, images)])[0]

    def detect_object(self, image, label) -> bool:
        return "yes" in self._ask(f"is there a {label} in this image? answer yes or no.", [image])

    def choose_frame(self, images, instruction):
        if not len(images):
            return None
        out = self._ask(
            f"which image best matches: {instruction}? answer with the image "
            f"number between 0 and {len(images) - 1}.",
            images,
        )
        return _first_index(out, len(images))

    def detect_and_select_best(self, images, label):
        if not len(images):
            return [], None
        calls = [(f"is there a {label} in this image? answer yes or no.", [im]) for im in images]
        calls.append((
            f"which image best matches: a clear view of the {label}? answer "
            f"with the image number between 0 and {len(images) - 1}.",
            list(images),
        ))
        outs = self._ask_many(calls)
        return ["yes" in o for o in outs[:-1]], _first_index(outs[-1], len(images))

    def rethink_wave(self, gallery, instruction, known_imgs, label):
        """One continuous-batch wave carrying the gallery frame choice and
        the object checks of the already-known candidates (anchor view,
        CLIP-best frame).  Returns (choice | None, checks for known_imgs)."""
        calls = []
        if len(gallery):
            calls.append((
                f"which image best matches: {instruction}? answer with the "
                f"image number between 0 and {len(gallery) - 1}.",
                list(gallery),
            ))
        calls += [(f"is there a {label} in this image? answer yes or no.", [im]) for im in known_imgs]
        outs = self._ask_many(calls) if calls else []
        choice = None
        if len(gallery):
            choice = _first_index(outs[0], len(gallery))
            outs = outs[1:]
        return choice, ["yes" in o for o in outs]


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
