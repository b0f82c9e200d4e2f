"""The host's blocking waits a keyframe: the stage timer's "<span>#sync"
counts (blocking copies, scalar reads, ``nonzero`` and the like, each
counted in the innermost span open when it ran), summed over every span
and every keyframe of the traced window, finalize included.  None where
the program's spans count no waits."""

SUFFIX = "#sync"


def read(d):
    syncs = [n for k, n in d.get("stage_calls", {}).items() if k.endswith(SUFFIX)]
    if not d.get("keyframes") or not syncs:
        return None
    return sum(syncs) / d["keyframes"]
