"""The whole step's share of the card's peak, in percent: the least time
of the towers' model operations for the keyframes of the profiled stretch
(``yardstick/flops.py``; int8 parts at the int8 peak where the tower is
W8A8, the rest at the bf16 peak) over the stretch's wall time."""


def read(d):
    s = d.get("stretch")
    if not s or s["wall_s"] <= 0.0 or s["keyframes"] <= 0:
        return None
    return 100.0 * s["ideal_s"] / s["wall_s"]
