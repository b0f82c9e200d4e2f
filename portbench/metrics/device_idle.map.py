"""The device's idle share of the profiled stretch, in percent: 100 minus
the union of device operations' intervals over the stretch's length
(``yardstick/trace.py``)."""


def read(d):
    if not d.get("window_s") or not d.get("busy_s"):
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
