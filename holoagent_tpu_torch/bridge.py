"""Carry the JAX package's weights and state into the port.

Inputs are plain numpy trees, as ``jax.tree.map(np.asarray, tree)`` gives
them, so this module (and the port) never imports JAX.  The port's module
and parameter names follow the reference's parameter trees: the dotted path
of a leaf in the reference tree is the port's state-dict key.  The one
layout change: an int8 weight (a leaf named ``*_q8``, (in, out) in the
reference) is (out, in) in the port, so it is transposed on the way in.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from .dataloader.generic import RGBDFrame
from .device import DeviceLike
from .memory.instances import InstanceSet
from .memory.mapping import MappedScene
from .memory.scene import SceneState
from .models.clip import CLIPText, CLIPVariant, CLIPVisual
from .models.sam import SAM, SAMVariant
from .models.vlm import VLM, VLMVariant
from .ops.voxel import GridSpec
from .perception.extractor import FrameFeatures


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {"a.0.b": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}."))
    return out


@torch.no_grad()
def load_flat(module: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Copy every parameter from `flat` (through float32, which is exact for
    int8, then cast to the parameter's dtype); the key sets must match
    exactly.  Int8 weights (``*_q8``) come in the reference's (in, out)
    layout and are stored (out, in)."""
    params = dict(module.named_parameters())
    flat = {k: np.swapaxes(a, -1, -2) if k.endswith("_q8") else a for k, a in flat.items()}
    missing, extra = set(params) - set(flat), set(flat) - set(params)
    if missing or extra:
        raise KeyError(f"parameter mismatch: missing {sorted(missing)}, unexpected {sorted(extra)}")
    for k, p in params.items():
        src = torch.from_numpy(np.array(flat[k], dtype=np.float32))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{k}: shape {tuple(src.shape)} != {tuple(p.shape)}")
        p.copy_(src.to(p.dtype))
    return module


def clip_from_jax(
    np_params: Dict[str, Any], variant: CLIPVariant, device: DeviceLike = None, dtype=torch.float32
) -> CLIPVisual:
    """The reference's CLIP params (``init_clip`` tree, or ``quantize_clip``'s
    with ``blocks_q8``) -> the port's visual tower.  The reference stacks its
    blocks on a leading layer axis."""
    visual = dict(np_params["visual"])
    quant = "blocks_q8" in visual
    key = "blocks_q8" if quant else "blocks"
    stacked = visual.pop(key)
    flat = flatten(visual)
    for i in range(variant.v_layers):
        for name, arr in stacked.items():
            flat[f"{key}.{i}.{name}"] = np.asarray(arr)[i]
    return load_flat(CLIPVisual(variant, dtype=dtype, device=device, quant=quant), flat)


def clip_text_from_jax(
    np_params: Dict[str, Any], variant: CLIPVariant, device: DeviceLike = None, dtype=torch.float32
) -> CLIPText:
    """The reference's CLIP params (``init_clip`` tree) -> the port's text
    tower (``params["text"]``, blocks stacked on a leading layer axis)."""
    text = dict(np_params["text"])
    stacked = text.pop("blocks")
    flat = flatten(text)
    for i in range(variant.t_layers):
        for name, arr in stacked.items():
            flat[f"blocks.{i}.{name}"] = np.asarray(arr)[i]
    return load_flat(CLIPText(variant, dtype=dtype, device=device), flat)


def sam_from_jax(
    np_params: Dict[str, Any], variant: SAMVariant, device: DeviceLike = None, dtype=torch.float32
) -> SAM:
    """The reference's SAM params (``init_sam`` tree, or ``quantize_sam``'s
    with ``{b, w_q8, w_s}`` linears) -> the port's SAM."""
    quant = "w_q8" in np_params["encoder"]["blocks"][0]["qkv"]
    return load_flat(SAM(variant, dtype=dtype, device=device, quant=quant), flatten(np_params))


def vlm_from_jax(
    np_params: Dict[str, Any], variant: VLMVariant, dtype=torch.float32, device: DeviceLike = None
) -> VLM:
    """The reference's VLM params (``init_vlm`` or ``convert_hf_llava`` tree,
    either arch, with or without ``proj2``) -> the port's model.  The
    reference stacks its blocks on a leading layer axis; every leaf keeps
    its layout."""
    params = dict(np_params)
    stacked = params.pop("blocks")
    flat = flatten(params)
    for i in range(variant.layers):
        for name, arr in stacked.items():
            flat[f"blocks.{i}.{name}"] = np.asarray(arr)[i]
    model = VLM(variant, dtype=dtype, device=device, proj_in=flat["proj_w"].shape[0], proj2="proj2_w" in flat)
    return load_flat(model, flat)


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dtype=dtype, device=device)


def grid_from_numpy(grid) -> GridSpec:
    return GridSpec(float(np.asarray(grid.voxel_size)), tuple(float(c) for c in np.asarray(grid.origin)))


def scene_from_numpy(s, device) -> SceneState:
    """A reference SceneState of numpy arrays -> the port's SceneState."""
    i32, f32 = torch.int32, torch.float32
    return SceneState(
        grid=grid_from_numpy(s.grid),
        key=_t(s.key, i32, device),
        sorted_key=_t(s.sorted_key, i32, device),
        sorted_row=_t(s.sorted_row, i32, device),
        sum_pts=_t(s.sum_pts, f32, device),
        sum_col=_t(s.sum_col, f32, device),
        count=_t(s.count, f32, device),
        sum_feat=_t(s.sum_feat, f32, device),
        feat_count=_t(s.feat_count, f32, device),
        num=_t(np.asarray(s.num), i32, device),
    )


def instances_from_numpy(inst, device) -> InstanceSet:
    """A reference InstanceSet of numpy arrays -> the port's InstanceSet."""
    i32, f32 = torch.int32, torch.float32
    return InstanceSet(
        rows=_t(inst.rows, i32, device),
        count=_t(inst.count, i32, device),
        feat_sum=_t(inst.feat_sum, f32, device),
        weight=_t(inst.weight, f32, device),
        bbox_min=_t(inst.bbox_min, f32, device),
        bbox_max=_t(inst.bbox_max, f32, device),
        valid=_t(inst.valid, torch.bool, device),
        ckeys=_t(inst.ckeys, i32, device),
        ccount=_t(inst.ccount, i32, device),
        dsig=_t(inst.dsig, f32, device),
    )


def features_from_numpy(ff, device) -> FrameFeatures:
    """Reference FrameFeatures of numpy arrays -> the port's FrameFeatures."""
    f32 = torch.float32
    return FrameFeatures(
        masks=_t(ff.masks, torch.bool, device),
        valid=_t(ff.valid, torch.bool, device),
        boxes=_t(ff.boxes, f32, device),
        f_masks=_t(ff.f_masks, f32, device),
        f_global=_t(ff.f_global, f32, device),
    )


def mapped_from_numpy(ms, device) -> MappedScene:
    """A reference MappedScene of numpy arrays (keyframes as they are) ->
    the port's MappedScene."""
    f32 = torch.float32
    return MappedScene(
        scene=scene_from_numpy(ms.scene, device),
        instances=instances_from_numpy(ms.instances, device),
        instance_feats=_t(ms.instance_feats, f32, device),
        keyframes=[RGBDFrame(*f) for f in ms.keyframes],
        keyframe_feats=_t(ms.keyframe_feats, f32, device),
        density_keep=None if ms.density_keep is None else _t(ms.density_keep, torch.bool, device),
    )
