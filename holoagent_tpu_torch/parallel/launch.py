"""Start the ranks of an SPMD program (port-only).

``spawn(fn, world, device, args)`` runs ``fn(rank, world, *args)`` on every
rank of a fresh process group and returns each rank's return value, in rank
order:

* under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) it runs `fn` in this
  process, at the environment's rank, and returns ``[result]``;
* at ``world == 1`` it runs `fn` here;
* else it starts `world` processes with ``torch.multiprocessing.spawn``
  over a FileStore in a temporary directory, and each rank's result comes
  back pickled.  `fn` must be importable by name (a module-level function
  of a module the children can import); the children use one CPU thread
  each on the CPU.

In the first two cases ``mesh.make_mesh`` starts the process group when `fn`
first asks for a mesh (from torchrun's environment, or a one-rank group) and
it lives until the process exits; spawned ranks start theirs before `fn` and
tear it down after.  NCCL serves CUDA ranks (each binds
``cuda:<rank mod cards>``), gloo the CPU; nothing needs a network.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import DeviceLike, resolve
from .mesh import backend_for, bind_device

TIMEOUT = datetime.timedelta(seconds=600)


def _start(rank: int, world: int, dev: torch.device, store_path: str) -> None:
    bind_device(dev, rank)
    dist.init_process_group(backend_for(dev), store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=TIMEOUT)


def _child(rank: int, fn: Callable, world: int, device: str, tmp: str, args: Sequence) -> None:
    dev = resolve(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    _start(rank, world, dev, os.path.join(tmp, "store"))
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world: int, device: DeviceLike = None, args: Sequence = ()) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on `world` ranks; returns the results
    (module docstring)."""
    dev = resolve(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return [fn(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), *args)]
    if world == 1:
        return [fn(0, 1, *args)]
    tmp = tempfile.mkdtemp(prefix="holoagent_spawn_")
    try:
        mp.spawn(_child, args=(fn, world, dev.type, tmp, tuple(args)), nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
