"""Mask stage: wall ms a keyframe in the stage timer's top-level "mask"
stage (the SAM encoder on K1, the decoder, NMS, selection and carve),
over every keyframe of the traced window."""


def read(d):
    if not d.get("keyframes") or "mask" not in d.get("stage_ms", {}):
        return None
    return d["stage_ms"]["mask"] / d["keyframes"]
