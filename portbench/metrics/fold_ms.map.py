"""Scene and instance fold: wall ms a keyframe in the stage timer's "fuse",
"instances", "merge" and "finalize" stages, over every keyframe of the
traced window (finalize once a scene)."""

STAGES = ("fuse", "instances", "merge", "finalize")


def read(d):
    ms = d.get("stage_ms", {})
    if not d.get("keyframes") or not any(s in ms for s in STAGES):
        return None
    return sum(ms.get(s, 0.0) for s in STAGES) / d["keyframes"]
