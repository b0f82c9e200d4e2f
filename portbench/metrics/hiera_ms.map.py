"""SAM 2's image encoder: wall ms a keyframe in the stage timer's
"mask.encoder" span (the Hiera trunk, its stage spans "mask.encoder.stage1"
to "stage4", and the neck, "mask.encoder.neck"), over every keyframe of the
traced window.  None where the program's encoder has no neck span (a
segmenter that is not SAM 2)."""


def read(d):
    ms = d.get("stage_ms", {})
    if not d.get("keyframes") or "mask.encoder" not in ms or "mask.encoder.neck" not in ms:
        return None
    return ms["mask.encoder"] / d["keyframes"]
