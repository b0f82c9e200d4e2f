"""Mesh construction from config (counterpart of
holoagent_tpu/parallel/mesh.py).

``make_mesh`` lays the initialized world out as a (data, model)
``DeviceMesh``, rank r at (r // model, r % model), as the reference
reshapes its device list.  With no process group yet it starts one: from
``torchrun``'s environment when that names a world, else a one-rank group
(the reference's one-device mesh), so a sharded entry point also runs in a
plain single process.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import MeshConfig
from ..device import DeviceLike, resolve


def backend_for(dev: torch.device) -> str:
    """NCCL for cards (never gloo), gloo for the CPU."""
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch build lacks")
        return "nccl"
    return "gloo"


def bind_device(dev: torch.device, rank: int) -> torch.device:
    """A CUDA rank binds ``cuda:<local_rank>`` (``LOCAL_RANK`` when set, else
    the rank modulo the visible cards)."""
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def init_group(dev: torch.device) -> None:
    """Start the default process group if none runs: from ``torchrun``'s
    environment (``WORLD_SIZE`` > 1), else a one-rank group over a FileStore
    in a temporary directory, closed and removed when the process exits."""
    if dist.is_initialized():
        return
    backend = backend_for(dev)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        rank = int(os.environ["RANK"])
        bind_device(dev, rank)
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
        return
    bind_device(dev, 0)
    tmp = tempfile.mkdtemp(prefix="holoagent_pg_")
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    atexit.register(_close_group, tmp)


def _close_group(tmp: str) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(tmp, ignore_errors=True)


def check_backend(dev: torch.device) -> None:
    """The running group must serve `dev`: NCCL for cuda, gloo for the CPU."""
    have = str(dist.get_backend())
    want = backend_for(dev)
    if want not in have:
        raise RuntimeError(f"a {dev.type} mesh needs the {want} backend; the process group runs {have}")


def make_mesh(cfg: Optional[MeshConfig] = None, device: DeviceLike = None) -> DeviceMesh:
    """Build a (data, model) mesh over the initialized world (the reference
    builds it over all devices).  ``cfg.data == -1`` takes every rank the
    model axis does not claim.  The device type follows ``device.resolve``:
    cuda unless the caller asks for the CPU."""
    cfg = cfg or MeshConfig()
    dev = resolve(device)
    init_group(dev)
    check_backend(dev)
    n = dist.get_world_size()
    model = max(1, cfg.model)
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model axis {model}")
    data = cfg.data if cfg.data > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return DeviceMesh(dev.type, torch.arange(n).reshape(data, model), mesh_dim_names=tuple(cfg.axis_names))


def local_mesh(model: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """Mesh over the whole world with the given model-axis width."""
    return make_mesh(MeshConfig(data=-1, model=model), device)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on for `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
