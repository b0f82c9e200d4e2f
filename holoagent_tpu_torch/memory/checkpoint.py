"""Array-store checkpoints of the mapper's device state and of model
parameters (counterpart of holoagent_tpu/memory/checkpoint.py, which saves
through orbax; the port keeps its own store, ``torch.save`` of plain tensor
dicts, since the card has no orbax).

A mapper state file holds the SceneState and the InstanceSet as dicts of CPU
tensors (the grid as floats), so it loads with ``weights_only=True``.  It is
restored onto a given device, the card unless the caller asks for the CPU.
As the reference, a state saved without the instances' coarse keys and
dilated signatures, or with the stale widths of an older format, reloads
with them recomputed from the scene (``instances.recompute_coarse_keys``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple, Union

import torch
import torch.nn as nn

from ..device import DeviceLike, resolve
from ..ops.compact import I32_MAX
from ..ops.voxel import GridSpec
from .instances import SIG_BUCKETS, InstanceSet, recompute_coarse_keys
from .scene import SceneState

def _cpu(d: dict) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in d.items()}


def save_mapper_state(path: Union[str, Path], scene: SceneState, instances: InstanceSet) -> None:
    """Write the scene and instance state to the file `path` (its directory
    is made)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fields = scene._asdict()
    grid = fields.pop("grid")
    torch.save({
        "scene": {"grid": {"voxel_size": float(grid.voxel_size), "origin": [float(c) for c in grid.origin]},
                  **_cpu(fields)},
        "instances": _cpu(instances._asdict()),
    }, path)


def load_mapper_state(path: Union[str, Path], device: DeviceLike = None) -> Tuple[SceneState, InstanceSet]:
    """The (SceneState, InstanceSet) saved at `path`, on `device`.  A state
    without ``ckeys``/``dsig``, or whose key sets are not as wide as the row
    sets (the 2x-coarse format) or whose signatures are not SIG_BUCKETS wide,
    gets its coarse keys and signatures recomputed from the scene."""
    dev = resolve(device)
    state = torch.load(Path(path), map_location="cpu", weights_only=True)
    scene_d = dict(state["scene"])
    grid = scene_d.pop("grid")
    scene = SceneState(grid=GridSpec(float(grid["voxel_size"]), tuple(float(c) for c in grid["origin"])),
                       **{k: v.to(dev) for k, v in scene_d.items()})
    inst_d = {k: v.to(dev) for k, v in state["instances"].items()}
    i_cap, k_cap = inst_d["rows"].shape
    backfill = (
        "ckeys" not in inst_d
        or "dsig" not in inst_d
        or inst_d["ckeys"].shape[1] != k_cap
        or inst_d["dsig"].shape[1] != SIG_BUCKETS
    )
    if backfill:
        inst_d["ckeys"] = torch.full((i_cap, k_cap), I32_MAX, dtype=torch.int32, device=dev)
        inst_d["ccount"] = torch.zeros(i_cap, dtype=torch.int32, device=dev)
        inst_d["dsig"] = torch.zeros((i_cap, SIG_BUCKETS), dtype=torch.float32, device=dev)
    inst = InstanceSet(**inst_d)
    return scene, recompute_coarse_keys(scene, inst) if backfill else inst


def save_params(path: Union[str, Path], params: Union[nn.Module, Dict[str, torch.Tensor]]) -> None:
    """Write a model's parameters (a module's named parameters, or a dict of
    tensors keyed by dotted names) to the file `path`."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_cpu(params), path)


def load_params(path: Union[str, Path], device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The parameters saved at `path` by ``save_params``, a dict of tensors
    keyed by dotted names, on `device`."""
    dev = resolve(device)
    return {k: v.to(dev) for k, v in torch.load(Path(path), map_location="cpu", weights_only=True).items()}
