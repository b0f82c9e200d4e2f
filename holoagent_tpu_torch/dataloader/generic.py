"""Dataset protocol for posed RGB-D sequences."""

from __future__ import annotations

from typing import Iterator, NamedTuple, Protocol, runtime_checkable

import numpy as np


class RGBDFrame(NamedTuple):
    """One posed keyframe. All host-side numpy.

    rgb:   (H, W, 3) float32 in [0, 1]
    depth: (H, W) float32 metres (0 = invalid)
    pose:  (4, 4) float32 camera-to-world
    k:     (3, 3) float32 depth-camera intrinsics
    """

    rgb: np.ndarray
    depth: np.ndarray
    pose: np.ndarray
    k: np.ndarray


@runtime_checkable
class RGBDDataset(Protocol):
    """Duck-typed dataset: len + indexed access returning RGBDFrame."""

    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> RGBDFrame: ...


def frames(ds: RGBDDataset, skip: int = 1) -> Iterator[RGBDFrame]:
    """Stride iterator (the reference's skip_frames,
    reference fsr_vln/config/semantic_scene_reconstruction_ic4f.yaml:24)."""
    for i in range(0, len(ds), skip):
        yield ds[i]
