"""Fixture-tower zoo: train-once, cache-to-disk perception towers
(counterpart of holoagent_tpu/training/zoo.py).

The neural accuracy row (``apps/eval_protocol.py``) and the query-
correctness suite (``apps/correctness_suite.py``) need the same
fixture-trained tiny towers (``training.perception``).  ``fixture_towers``
trains them once per (recipe tag, steps, seed) and caches the parameter
trees as .npz files in the reference's layout (keys '/'-joined, blocks
stacked as the reference's trees hold them; ``bridge.clip_to_numpy`` /
``sam_to_numpy``), so a JAX ``save_params`` file loads here and a tower the
port trained loads through the JAX package's ``load_params``.

Cache location: ``cache_dir``, else ``DEFAULT_CACHE`` (``towers`` under
``utils.cachekey.cache_root()``), under a ``utils.cachekey.machine_key``
subdirectory (the host's CPU flags, torch's version and the card's name):
a tower the card trained is never served to the JAX package's tests, nor to
another machine, under the same key.  The port never writes under the JAX
package's cache (``JAX_CACHE``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .. import bridge
from ..dataloader.synthetic import SyntheticDataset, SyntheticScene
from ..device import DeviceLike, resolve
from ..models import clip as clip_mod
from ..models import sam as sam_mod
from ..utils.cachekey import cache_root, machine_key
from .contrastive import CLIPParams, clip_params

# the reference's recipe tag: the same recipe (steps, fixtures, variants)
RECIPE_TAG = "r5a"

# GT room footprints per fixture layout (x0, y0, x1, y1, category[, floor])
ROOM_RECTS = {
    "two_room": [(0.0, 0.0, 4.0, 6.0, "bedroom"), (4.0, 0.0, 8.0, 6.0, "kitchen")],
    "three_room": [(0.0, 0.0, 4.0, 6.0, "bedroom"),
                   (4.0, 0.0, 8.0, 6.0, "living room"),
                   (8.0, 0.0, 12.0, 6.0, "bathroom")],
}

DEFAULT_CACHE = Path(cache_root()) / "towers"
# the JAX package's tower cache (holoagent_tpu/training/zoo.py DEFAULT_CACHE)
JAX_CACHE = Path(os.environ.get("HOLOAGENT_TOWER_CACHE", "/tmp/holoagent_tpu/towers"))

CLIP_VARIANT, SAM_VARIANT = "test-tiny", "fixture-tiny"


# ---------------------------------------------------------------------------
# Parameter tree <-> npz
# ---------------------------------------------------------------------------


def save_params(path: Path, tree) -> None:
    """Persist a nested dict/list tree of arrays as one .npz (keys '/'-joined,
    list indices as digits), as the reference's ``save_params``.  Refuses a
    path under the JAX package's cache."""
    path = Path(path).resolve()
    if path.is_relative_to(JAX_CACHE.resolve()):
        raise ValueError(f"{path}: the port does not write under the JAX package's tower cache {JAX_CACHE}")
    flat = {k.replace(".", "/"): v for k, v in bridge.flatten(tree).items()}
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_params(path: Path) -> dict:
    """Inverse of ``save_params`` (either package's file): nested dicts of
    numpy arrays, a level whose keys are all indices a list."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]

    def relist(node):
        if not isinstance(node, dict):
            return node
        node = {k: relist(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return relist(out)


def clip_from_tree(tree: dict, device: DeviceLike = None) -> CLIPParams:
    """A reference CLIP tree (``init_clip``'s, with ``logit_scale``) -> the
    fixture towers, built for ``impl="xla"`` (the plain attention the
    reference's training and accuracy rows run them on)."""
    cv = clip_mod.VARIANTS[CLIP_VARIANT]
    dev = resolve(device)
    visual = bridge.clip_from_jax(tree, cv, device=dev, impl="xla")
    text = bridge.clip_text_from_jax(tree, cv, device=dev, impl="xla")
    return clip_params(visual, text, bridge.logit_scale_from_jax(tree))


def sam_from_tree(tree: dict, device: DeviceLike = None) -> sam_mod.SAM:
    return bridge.sam_from_jax(tree, sam_mod.VARIANTS[SAM_VARIANT], device=resolve(device))


# ---------------------------------------------------------------------------
# Fixture towers
# ---------------------------------------------------------------------------


def _fixture_datasets(seed_base: int = 100):
    """Held-out training trajectories over all three fixture layouts (the
    evaluation trajectories use seeds < 100), at 240x320."""
    return [
        SyntheticDataset(scene=SyntheticScene.two_room(), num_frames=48,
                         hw=(240, 320), seed=seed_base, gaze_heights=(0.8, 2.2)),
        SyntheticDataset(scene=SyntheticScene.three_room(), num_frames=48,
                         hw=(240, 320), seed=seed_base + 1, gaze_heights=(0.8, 2.2)),
        SyntheticDataset(scene=SyntheticScene.two_floor(), num_frames=72,
                         hw=(240, 320), seed=seed_base + 2, gaze_heights=(0.8, 2.2)),
    ]


def fixture_labels() -> List[str]:
    """The union training vocabulary: two_floor's categories (with wall and
    floor, which cover the other layouts) plus "background", the engine's
    negative-prompt anchor."""
    return SyntheticScene.two_floor().labels() + ["background"]


def cache_paths(steps_clip: int, steps_sam: int, seed: int, cache_dir: Optional[Path] = None,
                device: DeviceLike = None) -> Tuple[Path, Path, Path]:
    """(clip npz, sam npz, meta json) of a recipe run: under `cache_dir` as
    given, else under ``DEFAULT_CACHE/<machine_key>``."""
    cache = Path(cache_dir) if cache_dir is not None else DEFAULT_CACHE / machine_key(device)
    key = f"{RECIPE_TAG}_c{steps_clip}_s{steps_sam}_seed{seed}"
    return cache / f"clip_{key}.npz", cache / f"sam_{key}.npz", cache / f"meta_{key}.json"


def fixture_towers(
    steps_clip: int = 3000,
    steps_sam: int = 6000,
    seed: int = 0,
    cache_dir: Optional[Path] = None,
    retrain: bool = False,
    verbose: bool = False,
    device: DeviceLike = None,
    datasets=None,
) -> Tuple[CLIPParams, sam_mod.SAM]:
    """(clip, sam) for the fixture world on `device`, cached on disk.

    CLIP: test-tiny towers, contrastive on GT crops over the union
    vocabulary plus the room types (3000 steps, room-frame jitter 2).
    SAM: fixture-tiny, promptable-mask + IoU-head supervision (6000 steps,
    lr 2e-3).  Both float32, on the 48/48/72-frame 240x320 walks
    (`datasets`: those walks already rendered, to share them)."""
    dev = resolve(device)
    clip_path, sam_path, meta_path = cache_paths(steps_clip, steps_sam, seed, cache_dir, dev)
    if not retrain and clip_path.exists() and sam_path.exists():
        return clip_from_tree(load_params(clip_path), dev), sam_from_tree(load_params(sam_path), dev)

    from .perception import train_tiny_clip, train_tiny_sam

    ds = datasets if datasets is not None else _fixture_datasets()
    labels = fixture_labels()
    rects_by_ds = [
        ROOM_RECTS["two_room"],
        ROOM_RECTS["three_room"],
        SyntheticScene.two_floor_room_rects(),
    ]
    clip, clip_losses = train_tiny_clip(
        ds, labels, steps=steps_clip, seed=seed, room_rects_by_ds=rects_by_ds,
        room_frame_jitter=2, device=dev,
    )
    if verbose:
        print(f"tiny CLIP trained: loss {clip_losses[0]:.3f} -> {np.mean(clip_losses[-50:]):.3f}")
    sam, sam_losses = train_tiny_sam(ds, steps=steps_sam, seed=seed, variant_name=SAM_VARIANT, lr=2e-3, device=dev)
    if verbose:
        print(f"tiny SAM trained: loss {sam_losses[0]:.3f} -> {np.mean(sam_losses[-50:]):.3f}")
    save_params(clip_path, bridge.clip_to_numpy(clip.visual, clip.text, clip.logit_scale))
    save_params(sam_path, bridge.sam_to_numpy(sam))
    meta_path.write_text(json.dumps({
        "recipe": RECIPE_TAG, "steps_clip": steps_clip, "steps_sam": steps_sam,
        "seed": seed, "labels": labels, "device": str(dev), "machine_key": machine_key(dev),
        "clip_losses": clip_losses, "sam_losses": sam_losses,
        "clip_final_loss": float(np.mean(clip_losses[-50:])),
        "sam_final_loss": float(np.mean(sam_losses[-50:])),
    }))
    return clip, sam
