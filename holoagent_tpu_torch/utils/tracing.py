"""Stage tracing and profiler integration (counterpart of
holoagent_tpu/utils/tracing.py).

``StageTimer`` is the port's ``utils/timing.StageTimer``: per-stage spans
timed by CUDA events on the stream (no synchronise), named in the
profiler's trace, with each span's count of the host's blocking waits.
``device_trace`` wraps a region in ``torch.profiler.profile`` (CPU
activities, and CUDA where the card is present) and writes a Chrome trace
into ``log_dir``; it yields the profiler, whose ``key_averages()`` and
``events()`` give the device time.  ``annotate`` names a region in that
trace by the record the spans use, which the profiler copies to no device
timeline.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterable, Iterator, Optional, Tuple

import torch

from .timing import StageTimer, named, stage  # noqa: F401  (re-exported: the one stage timer and its record)

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


annotate = named  # a named region in the profiler's trace, on the host's timeline only


def busy(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals: time covered by
    two overlapping ones counts once."""
    total, covered = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > covered:
            total += e - max(s, covered)
            covered = e
    return total


def device_idle_share(prof: torch.profiler.profile, wall_ms: float) -> dict:
    """The device's operations in a profiled region of `wall_ms`: their
    count, the ms the device was busy (the union of their intervals, so
    overlapping kernels count once) and the share of the wall time it was
    idle.  The profiler's device-side copies of user annotations
    (``torch.profiler.record_function`` ranges) are no device work and are
    left out."""
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    device_ms = busy((e.time_range.start, e.time_range.end) for e in ops) / 1e3
    return {"kernels": len(ops), "device_ms": device_ms, "wall_ms": wall_ms,
            "idle_share": 1.0 - device_ms / wall_ms if wall_ms > 0 else float("nan")}
