"""Stage tracing and profiler integration (counterpart of
holoagent_tpu/utils/tracing.py).

``StageTimer`` is the port's ``utils/timing.StageTimer`` (per-stage wall ms,
device work included).  ``device_trace`` wraps a region in
``torch.profiler.profile`` (CPU activities, and CUDA where the card is
present) and writes a Chrome trace into ``log_dir``; it yields the
profiler, whose ``key_averages()`` and ``events()`` give the device time.
``annotate`` names a region in that trace (``torch.profiler.record_function``)
and, on the card, as an NVTX range.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Optional

import torch

from .timing import StageTimer, stage  # noqa: F401  (re-exported: the one stage timer)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str | Path, enabled: bool = True) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the region (CPU, and CUDA when available) and write
    ``<log_dir>/trace.json`` (Chrome trace format).  Yields the profiler,
    or None when not `enabled`."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the profiler's trace, and an NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_idle_share(prof: torch.profiler.profile, wall_ms: float) -> dict:
    """The device's kernels in a profiled region of `wall_ms`: their count,
    their summed device ms, and the share of the wall time the device was
    idle (one stream: 1 - device / wall), as scripts/*_profile.py read it."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    return {"kernels": len(kernels), "device_ms": device_ms, "wall_ms": wall_ms,
            "idle_share": 1.0 - device_ms / wall_ms if wall_ms > 0 else float("nan")}
