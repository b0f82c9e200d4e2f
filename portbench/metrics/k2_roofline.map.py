"""K2's share of its roofline over the profiled stretch, in percent: the
least time of every launch in the profiled stretch (``yardstick/
roofline.py``, from the launch's shape) over the device time of the
kernel's operations in the profiler's trace of that stretch."""

from portbench.yardstick.roofline import roofline_percent


def read(d):
    k = d.get("launches", {}).get("k2")
    return roofline_percent("k2", k["keys"], k["device_s"]) if k else None
