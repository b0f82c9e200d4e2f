"""Slow-path VLM backends (counterpart of holoagent_tpu/query/vlm_backend.py).

The backend protocol of the slow path's three VLM calls (object-in-image
verification, gallery frame choice, per-image yes/no + best pick), and
``NullVLM``, the accept-everything stub the fast path runs with.  The
generative and CLIP backends wait for the slow path's port (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np


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
