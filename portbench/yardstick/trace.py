"""Device busy time, idle share and the breakdown, from a
``torch.profiler`` trace of a stretch of the run.

The device is busy wherever at least one device operation (kernel,
memory copy or set) runs: the union of their intervals, so operations
that overlap are counted once (the port's ``utils/tracing.py::
device_idle_share`` adds their times instead).  The stretch is the span of
the host-side region named ``WINDOW`` in the trace.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

REGION = "portbench."  # the prefix of the benchmark's own host regions
WINDOW = REGION + "window"
NAME_CHARS = 160  # a device operation's name in the breakdown, cut to this length
Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle intervals of [lo, hi] between the busy ones."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


class Events:
    """The events of one profiled stretch, times in seconds: device
    operations (name, start, end) and host operations (name, start, end)."""

    def __init__(self, device: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]]):
        self.device = device
        self.host = host
        spans = [(s, e) for n, s, e in host if n == WINDOW]
        self.window: Optional[Interval] = spans[0] if spans else None

    @staticmethod
    def from_profiler(prof) -> "Events":
        import torch

        device, host = [], []
        for ev in prof.events():
            tr = ev.time_range
            row = (ev.name, tr.start * 1e-6, tr.end * 1e-6)
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if not ev.name.startswith(REGION):  # the device-side copy of a host region
                    device.append(row)
            else:
                host.append(row)
        return Events(device, host)

    def busy_s(self) -> float:
        lo, hi = self.window
        return busy(clip([(s, e) for _, s, e in self.device], lo, hi))

    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def device_seconds(self, classify: Callable[[str], Optional[str]]) -> Dict[str, float]:
        """Device time inside the stretch of the operations that `classify`
        names, summed by that name (the kernels of one family run one after
        another on one stream)."""
        lo, hi = self.window
        tot: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            fam = classify(name)
            if fam is not None and e > lo and s < hi:
                tot[fam] += min(e, hi) - max(s, lo)
        return dict(tot)

    def top_device_ops(self, n: int = 10) -> List[List]:
        lo, hi = self.window
        tot: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            if e > lo and s < hi:
                tot[name] += min(e, hi) - max(s, lo)
        return [[k[:NAME_CHARS], v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def host_at(self, t: float) -> str:
        """What the host was doing at `t`: the innermost host operation
        that spans it, after the outermost benchmark region."""
        inside = [(e - s, n) for n, s, e in self.host if s <= t < e and n != WINDOW]
        if not inside:
            return "host idle"
        inside.sort()
        outer = [n for _, n in inside if n.startswith(REGION)]
        inner = inside[0][1]
        return f"{outer[-1]}/{inner}" if outer and outer[-1] != inner else inner

    def idle_gaps(self, n: int = 10) -> List[List]:
        lo, hi = self.window
        gs = sorted(gaps([(s, e) for _, s, e in self.device], lo, hi), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_at(s), e - s] for s, e in gs]
