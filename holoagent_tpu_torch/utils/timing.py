"""Per-stage timing of the mapping pipeline."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, Optional

import torch


class StageTimer:
    """Wall-clock milliseconds per named stage, device work included: each
    stage is bracketed by a device synchronisation, so the stages do not
    overlap and their sum is the step time.  ``notes`` keeps per-call values
    a stage reports (the CLIP crop tier)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.notes: Dict[str, List[Any]] = defaultdict(list)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            self.calls[name] += 1

    def note(self, key: str, value: Any) -> None:
        self.notes[key].append(value)


def stage(timer: Optional[StageTimer], name: str):
    """``timer.stage(name)``, or a no-op without a timer."""
    return timer.stage(name) if timer is not None else nullcontext()
