"""The fixture-trained tower zoo (counterpart of
holoagent_tpu/training/zoo.py).  So far only its vocabulary,
``fixture_labels``, which ``utils.labels.load_vocabulary("FIXTURE")``
resolves; the trained towers wait for the training port (ROADMAP.md)."""

from __future__ import annotations

from typing import List

from ..dataloader.synthetic import SyntheticScene


def fixture_labels() -> List[str]:
    """The union training vocabulary: two_floor's categories (with wall and
    floor, which cover the other layouts) plus "background", the engine's
    negative-prompt anchor."""
    return SyntheticScene.two_floor().labels() + ["background"]
