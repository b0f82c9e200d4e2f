"""Sharding rules for model parameters and activations (counterpart of
holoagent_tpu/parallel/sharding.py), as DTensor placements.

The reference's Megatron split, leaf for leaf: QKV and MLP-up weights
shard their OUTPUT columns over "model", attention-out and MLP-down their
INPUT rows; everything else replicates.  ``_BLOCK_SPECS`` keeps the
reference's table for its stacked block leaves (axis 0 = layers, never
sharded); the port's towers hold one ``Block`` a layer, so a block leaf's
``Shard`` dim is the table's minus one.

The split is contiguous, as the reference's placement is: rank m of the
model axis holds columns [m * 3W/M, (m + 1) * 3W/M) of ``wqkv``.  Those are
not whole heads of each of q, k and v; the reference's GSPMD reshards
around the attention.  The explicit TP of
``training.contrastive.make_train_step(mesh=...)`` cuts q, k and v by whole
heads instead (``tp_columns``); its step equals the unsharded step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard, distribute_tensor

Spec = Sequence[Optional[str]]  # one mesh-axis name (or None) per tensor dim

_BLOCK_SPECS: Dict[str, Spec] = {
    # stacked block params: axis 0 = layers (unsharded)
    "ln1_g": (None, None),
    "ln1_b": (None, None),
    "wqkv": (None, None, "model"),  # column split -> heads sharded
    "bqkv": (None, "model"),
    "wo": (None, "model", None),  # row split -> psum after
    "bo": (None, None),
    "ln2_g": (None, None),
    "ln2_b": (None, None),
    "w1": (None, None, "model"),
    "b1": (None, "model"),
    "w2": (None, "model", None),
    "b2": (None, None),
}


def placements(mesh: DeviceMesh, spec: Spec) -> List[Placement]:
    """A PartitionSpec as DTensor placements: one per mesh dim, ``Shard(d)``
    where tensor dim d names that mesh dim, else ``Replicate()``."""
    out: List[Placement] = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec) if a == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def replicated(mesh: DeviceMesh) -> List[Placement]:
    return placements(mesh, ())


def data_sharding(mesh: DeviceMesh, rank: int = 1) -> List[Placement]:
    """Shard the leading (batch) axis over "data"."""
    return placements(mesh, ("data",) + (None,) * (rank - 1))


def clip_param_sharding(params, mesh: DeviceMesh) -> Dict[str, List[Placement]]:
    """Placements of every CLIP parameter, by its name in
    ``training.contrastive.CLIPParams`` (``visual.blocks.<i>.wqkv``,
    ``text.tok_emb``, ``logit_scale``, ...).  Tower embeddings and
    projections replicate; the blocks shard per ``_BLOCK_SPECS``."""
    out = {}
    for tower in ("visual", "text"):
        for name, _ in getattr(params, tower).named_parameters():
            parts = name.split(".")
            spec: Spec = ()
            if parts[0] == "blocks":
                spec = tuple(_BLOCK_SPECS[parts[-1]][1:])
            out[f"{tower}.{name}"] = placements(mesh, spec)
    out["logit_scale"] = replicated(mesh)
    return out


def named_parameters(params) -> Dict[str, torch.Tensor]:
    named = {f"{t}.{n}": p for t in ("visual", "text") for n, p in getattr(params, t).named_parameters()}
    named["logit_scale"] = params.logit_scale
    return named


def shard_params(params, mesh: DeviceMesh, spec_fn: Callable = clip_param_sharding) -> Dict[str, torch.Tensor]:
    """This rank's local shard of every parameter under the rule (the
    reference device-puts the tree; here each rank keeps its own shard,
    sliced from its replicated copy with no communication)."""
    rule = spec_fn(params, mesh)
    return {
        name: distribute_tensor(p.detach(), mesh, rule[name], src_data_rank=None).to_local()
        for name, p in named_parameters(params).items()
    }


def tp_columns(width: int, heads: int, m: int, n_model: int, packed: int = 3) -> torch.Tensor:
    """Columns of a packed [q|k|v] projection that hold model rank m's whole
    heads of each of q, k and v (``packed`` = 3), or of a plain (width,)
    layout (``packed`` = 1): heads [m * H/M, (m + 1) * H/M)."""
    if heads % n_model:
        raise ValueError(f"{heads} heads not divisible by the model axis ({n_model})")
    dh = width // heads
    lo, hi = m * (heads // n_model) * dh, (m + 1) * (heads // n_model) * dh
    return torch.cat([torch.arange(s * width + lo, s * width + hi) for s in range(packed)])
