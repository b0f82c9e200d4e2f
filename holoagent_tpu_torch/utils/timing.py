"""Per-stage spans of the mapping pipeline, timed on the device's stream.

A span never synchronises: on the card it records a CUDA event on the
current stream at entry and at exit, and its milliseconds are the stream's
time between the two, read once the events have passed.  It also names
itself in any active ``torch.profiler`` trace, on the host timeline beside
the aten ops, and counts the host's blocking waits (blocking copies, scalar
reads, ``nonzero`` and the like) made while it is the innermost open span.
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict, deque
from contextlib import contextmanager, nullcontext
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

SYNC = "#sync"  # calls[name + SYNC]: the blocking waits made inside span `name`
# the warning torch's sync-debug mode raises at each blocking wait
SYNC_WARNING = "called a synchronizing CUDA operation"
PROTOTYPE_NOTICE = "Synchronization debug mode is a prototype feature"  # raised by set_sync_debug_mode


def named(name: str):
    """A range named `name` in any active ``torch.profiler`` trace, on the
    host's timeline.  Unlike ``torch.profiler.record_function`` it is no
    user annotation, so the profiler makes no device-side copy of it that
    would read as device work; without a profiler it records nothing."""
    return _RecordFunctionFast(name)


class _SyncCounter:
    """While a timer has a span open: torch's sync-debug mode at "warn",
    its warnings always raised and counted against the innermost open span
    instead of printed (and its notice that the mode is a prototype
    silenced); other warnings go to the handler that was there.  Leaving
    restores the mode, the filters and the handler."""

    def __init__(self, timer: "StageTimer"):
        self.timer = timer
        self.mode = torch.cuda.get_sync_debug_mode()
        self.caught = warnings.catch_warnings()
        self.caught.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)
        warnings.filterwarnings("ignore", message=PROTOTYPE_NOTICE, category=UserWarning)
        self.show = warnings.showwarning
        warnings.showwarning = self._show
        if self.mode == 0:
            torch.cuda.set_sync_debug_mode("warn")

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if issubclass(category, UserWarning) and str(message).startswith(SYNC_WARNING):
            self.timer.calls[self.timer._open[-1] + SYNC] += 1
        else:
            self.show(message, category, filename, lineno, file, line)

    def close(self) -> None:
        torch.cuda.set_sync_debug_mode(self.mode)
        self.caught.__exit__(None, None, None)


class StageTimer:
    """Milliseconds, calls and blocking waits per named span.

    ``ms[name]``: on the card, the current stream's time between the
    span's entry and exit events.  The stream runs in order, so sibling
    spans split its timeline between them, and a span whose work is on the
    host counts for as long as the device waited for it.  On the CPU, and
    while the stream captures a CUDA graph, the host clock.  Events are
    read once they have passed; reading ``ms`` waits for those still on
    the stream, so read it after the measured work.
    ``calls[name]``: the span's closes; ``calls[name + "#sync"]`` the
    blocking waits made while it was the innermost open span (counted on
    the card, 0 on the CPU; the key is written for every span opened).
    ``parent[name]``: the span open when `name` last opened (None at the
    top), for self times.
    ``notes``: per-call values a stage reports (the CLIP crop tier)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.calls: Dict[str, int] = defaultdict(int)
        self.notes: Dict[str, List[Any]] = defaultdict(list)
        self.parent: Dict[str, Optional[str]] = {}
        self._ms: Dict[str, float] = defaultdict(float)
        self._open: List[str] = []
        self._pending: Deque[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = deque()
        self._syncs: Optional[_SyncCounter] = None

    @property
    def ms(self) -> Dict[str, float]:
        if self._pending:  # the spans share a stream, which runs in order: the last exit passes last
            self._pending[-1][2].synchronize()
        self._resolve()
        return self._ms

    def _resolve(self) -> None:
        """Add the spans whose exit event has passed, oldest first."""
        while self._pending and self._pending[0][2].query():
            name, start, end = self._pending.popleft()
            self._ms[name] += start.elapsed_time(end)

    @contextmanager
    def stage(self, name: str):
        cuda = self.device.type == "cuda"
        on_stream = cuda and not torch.cuda.is_current_stream_capturing()
        with named(name):
            if on_stream:
                stream = torch.cuda.current_stream(self.device)
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            else:
                t0 = time.perf_counter()
            self.parent[name] = self._open[-1] if self._open else None
            self.calls[name + SYNC] += 0
            if cuda and not self._open:
                self._syncs = _SyncCounter(self)
            self._open.append(name)
            try:
                yield
            finally:
                if on_stream:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record(stream)
                    self._pending.append((name, start, end))
                    self._resolve()
                else:
                    self._ms[name] += (time.perf_counter() - t0) * 1e3
                self.calls[name] += 1
                self._open.pop()
                if self._syncs is not None and not self._open:
                    self._syncs.close()
                    self._syncs = None

    def note(self, key: str, value: Any) -> None:
        self.notes[key].append(value)


def stage(timer: Optional[StageTimer], name: str):
    """``timer.stage(name)``, or a no-op without a timer."""
    return timer.stage(name) if timer is not None else nullcontext()
