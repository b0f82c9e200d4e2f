"""Device-honest benchmark timing (counterpart of
holoagent_tpu/utils/benchtime.py).

On the card a call's device time is read with CUDA events around a run of
back-to-back calls.  Eager PyTorch launches every kernel from the host, so
a run whose kernels are shorter than their launches would time the host.
A device-side sleep therefore holds the stream while a sample's calls are
enqueued, and the events bracket the calls alone.  The hold is sized from
the host's measured enqueue time of the same calls (twice over), and after
each sample the event behind the sleep is queried: if it had already
passed when the last call was enqueued, the hold ran out, the sample timed
host gaps.  A sample can also outlast its hold because the launch queue
fills while the stream is held (the host then waits for the device): the
samples are taken again with half as many calls, down to one, and a time
whose hold still ran out is labelled a wall time.  On the CPU the time is
``perf_counter``'s.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, NamedTuple, Sequence

import torch

_SLEEP_PROBE = 10_000_000  # cycles of the calibration sleep (a few ms)


class Timing(NamedTuple):
    seconds: float  # per call, the median over samples
    kind: str  # "device": CUDA events with the stream held; "wall": the hold ran out; "cpu"


def _sleep_cycles_per_s() -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(_SLEEP_PROBE)
    b.record()
    b.synchronize()
    return _SLEEP_PROBE / (a.elapsed_time(b) * 1e-3)


SAMPLES = 3


def time_device_fn(fn: Callable, args: Sequence, iters: int = 10) -> Timing:
    """Seconds per `fn(*args)` call after one warm-up call: the median over
    SAMPLES of the mean of `iters` back-to-back calls (one CUDA stream runs
    them in order; on the card `iters` halves while the calls overflow the
    launch queue)."""
    fn(*args)
    first = args[0]
    if not (isinstance(first, torch.Tensor) and first.is_cuda):
        out = []
        for _ in range(SAMPLES):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            out.append((time.perf_counter() - t0) / iters)
        return Timing(statistics.median(out), "cpu")
    rate = _sleep_cycles_per_s()
    while True:
        out, held = _held_samples(fn, args, iters, rate)
        if held or iters == 1:
            return Timing(statistics.median(out), "device" if held else "wall")
        # the launch queue filled while the stream was held: fewer calls a sample
        iters = max(1, iters // 2)


def _held_samples(fn, args, iters: int, rate: float):
    """SAMPLES device times per call, each of `iters` calls queued behind
    a sleep sized from the host's enqueue time of the same calls (twice
    over, plus 2 ms); and whether every sleep outlasted its enqueue."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    hold = int(rate * (2 * (time.perf_counter() - t0) + 2e-3))
    torch.cuda.synchronize()
    out, held = [], True
    for _ in range(SAMPLES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        held = held and not start.query()  # the sleep still ran when the last call was queued
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e-3 / iters)
    return out, held
