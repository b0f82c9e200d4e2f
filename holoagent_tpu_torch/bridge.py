"""Carry weights and state between the JAX package and the port, both ways.

Inputs are plain numpy trees, as ``jax.tree.map(np.asarray, tree)`` gives
them, so this module (and the port) never imports JAX.  The port's module
and parameter names follow the reference's parameter trees: the dotted path
of a leaf in the reference tree is the port's state-dict key.  The one
layout change: an int8 weight (a leaf named ``*_q8``, (in, out) in the
reference) is (out, in) in the port, so it is transposed on the way in and
back on the way out.

``*_from_jax`` build the port's modules from a reference tree;
``clip_to_numpy``, ``sam_to_numpy`` and ``vlm_to_numpy`` give the reference's
tree of a port module (float leaves as float32 numpy, int8 as int8; CLIP and
VLM blocks stacked on a leading layer axis, SAM's blocks a list), so a tower
the port trained loads into the JAX package, and the fixture zoo's npz files
(``training/zoo.py``, keys '/'-joined) carry either package's towers.  The
CLIP tree's ``logit_scale`` belongs to the contrastive trainer
(``logit_scale_from_jax``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

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


def _unstack(tower: Dict[str, Any], layers: int):
    """A tower tree with its blocks stacked on a leading layer axis -> (the
    flat dotted dict with one entry a layer, quantized or not)."""
    tower = dict(tower)
    key = "blocks_q8" if "blocks_q8" in tower else "blocks"
    stacked = tower.pop(key)
    flat = flatten(tower)
    for i in range(layers):
        for name, arr in stacked.items():
            flat[f"{key}.{i}.{name}"] = np.asarray(arr)[i]
    return flat, key == "blocks_q8"


def clip_from_jax(
    np_params: Dict[str, Any], variant: CLIPVariant, device: DeviceLike = None, dtype=torch.float32,
    impl: str = "flash",
) -> CLIPVisual:
    """The reference's CLIP params (``init_clip`` tree, or ``quantize_clip``'s
    with ``blocks_q8``) -> the port's visual tower, built for the attention
    route `impl`.  The reference stacks its blocks on a leading layer axis."""
    flat, quant = _unstack(np_params["visual"], variant.v_layers)
    return load_flat(CLIPVisual(variant, dtype=dtype, device=device, quant=quant, impl=impl), flat)


def clip_text_from_jax(
    np_params: Dict[str, Any], variant: CLIPVariant, device: DeviceLike = None, dtype=torch.float32,
    impl: str = "flash",
) -> CLIPText:
    """The reference's CLIP params (``init_clip`` tree, or ``quantize_clip(...,
    towers=("visual", "text"))``'s with ``blocks_q8``) -> the port's text
    tower (``params["text"]``, blocks stacked on a leading layer axis),
    built for the attention route `impl`."""
    flat, quant = _unstack(np_params["text"], variant.t_layers)
    return load_flat(CLIPText(variant, dtype=dtype, device=device, quant=quant, impl=impl), flat)


def logit_scale_from_jax(np_params: Dict[str, Any]) -> float:
    """The CLIP tree's ``logit_scale`` (the contrastive trainer's scalar)."""
    return float(np.asarray(np_params["logit_scale"], np.float32))


def sam_from_jax(
    np_params: Dict[str, Any], variant: SAMVariant, device: DeviceLike = None, dtype=torch.float32
) -> SAM:
    """The reference's SAM params (``init_sam`` tree, or ``quantize_sam``'s
    with ``{b, w_q8, w_s}`` linears) -> the port's SAM."""
    quant = "w_q8" in np_params["encoder"]["blocks"][0]["qkv"]
    return load_flat(SAM(variant, dtype=dtype, device=device, quant=quant), flatten(np_params))


Leaf = Optional[Callable[[torch.Tensor], Optional[torch.Tensor]]]


def _numpy_leaf(t: torch.Tensor, key: str) -> np.ndarray:
    a = t.detach().cpu()
    a = a.numpy() if a.dtype == torch.int8 else a.float().numpy()
    return np.swapaxes(a, -1, -2) if key.endswith("_q8") else a


def module_tree(module: nn.Module, leaf: Leaf = None) -> dict:
    """A module's parameters as the reference's nested tree (dicts; a level
    whose keys are all indices becomes a list), in the reference's layouts.
    `leaf` maps each parameter to the tensor to read (default: the
    parameter; e.g. ``lambda p: p.grad`` for the gradients)."""
    out: dict = {}
    for key, p in module.named_parameters():
        t = p if leaf is None else leaf(p)
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _numpy_leaf(t, key)

    def relist(node):
        if not isinstance(node, dict):
            return node
        node = {k: relist(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return relist(out)


def _stacked(tower: dict) -> dict:
    """A tower tree's block list stacked on a leading layer axis."""
    tower = dict(tower)
    for key in ("blocks", "blocks_q8"):
        if key in tower:
            blocks = tower[key]
            tower[key] = {name: np.stack([b[name] for b in blocks]) for name in blocks[0]}
    return tower


def clip_to_numpy(visual: Optional[CLIPVisual] = None, text: Optional[CLIPText] = None,
                  logit_scale=None, leaf: Leaf = None) -> dict:
    """The port's CLIP towers -> the reference's ``init_clip`` tree (either
    tower may be absent; ``blocks_q8`` for a quantized one) with
    ``logit_scale`` when given (a float or a 0-dim tensor)."""
    tree = {}
    if visual is not None:
        tree["visual"] = _stacked(module_tree(visual, leaf))
    if text is not None:
        tree["text"] = _stacked(module_tree(text, leaf))
    if logit_scale is not None:
        if isinstance(logit_scale, torch.Tensor):
            logit_scale = _numpy_leaf(logit_scale if leaf is None else leaf(logit_scale), "")
        tree["logit_scale"] = np.asarray(logit_scale, np.float32)
    return tree


def sam_to_numpy(sam: SAM, leaf: Leaf = None) -> dict:
    """The port's SAM -> the reference's ``init_sam`` tree (list-indexed
    encoder blocks and decoder layers; ``{b, w_q8, w_s}`` linears when
    quantized)."""
    return module_tree(sam, leaf)


def vlm_to_numpy(vlm: VLM, leaf: Leaf = None) -> dict:
    """The port's VLM -> the reference's ``init_vlm`` tree (blocks stacked
    on a leading layer axis)."""
    return _stacked(module_tree(vlm, leaf))


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
