"""CLIP stage: wall ms a keyframe in the stage timer's top-level "clip"
stage (crops, the ViT-L/14 visual tower on K2, the fusion), over every
keyframe of the traced window."""


def read(d):
    if not d.get("keyframes") or "clip" not in d.get("stage_ms", {}):
        return None
    return d["stage_ms"]["clip"] / d["keyframes"]
