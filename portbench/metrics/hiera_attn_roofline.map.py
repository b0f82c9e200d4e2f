"""Hiera's attention launches' share of their roofline over the profiled
stretch, in percent: the least time of every K2 launch at head dim 72 in
the stretch (``yardstick/hiera.py``, from the launch's shape: Tq and Tk
apart in the pooled-query blocks) over the device time of their kernels in
the profiler's trace of that stretch (told from CLIP's K2 kernels by their
template arguments)."""

from portbench.yardstick.hiera import roofline_percent


def read(d):
    k = d.get("launches", {}).get("hiera")
    return roofline_percent(k["keys"], k["device_s"]) if k else None
