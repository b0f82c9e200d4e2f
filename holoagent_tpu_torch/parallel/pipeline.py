"""Pipeline parallelism: GPipe-style microbatched stage execution over a
mesh axis (counterpart of holoagent_tpu/parallel/pipeline.py).

Stage s's parameters live on ring position s; microbatch activations enter
at stage 0 and move to the next position each tick (``batch_isend_irecv``,
the reference's ``ppermute``).  The schedule is the reference's static GPipe
loop of S + M - 1 ticks: at tick t, position s computes microbatch t - s
when 0 <= t - s < M.  The last stage banks the finished microbatches, and
one ``all_reduce`` hands the union to every position.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch
from torch.distributed.device_mesh import DeviceMesh

from . import comm


def stack_stages(stage_params: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack per-stage parameter dicts along a new leading axis (the axis
    that splits over the stage mesh dimension)."""
    return {k: torch.stack([p[k] for p in stage_params]) for k in stage_params[0]}


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (M, B, ...) microbatches, the same on every rank
    mesh: DeviceMesh,
    axis: str = "stage",
) -> torch.Tensor:
    """Run x's M microbatches through S = the axis' size stages;
    ``stage_fn(params_s, h) -> h`` applies one stage (activation shapes must
    not change between stages).  This rank applies stage s = its axis
    position, with ``stacked_params``' slice s.  Returns the (M, B, ...)
    outputs on every rank."""
    n, s = comm.size(mesh, axis), comm.index(mesh, axis)
    m_count = x.shape[0]
    if m_count < 1:
        raise ValueError("need at least one microbatch")
    p = {k: a[s] for k, a in stacked_params.items()}
    slot = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n + m_count - 1):
        m_in = t - s  # the microbatch entering this stage at tick t
        live = 0 <= m_in < m_count
        if live:
            h_out = stage_fn(p, x[m_in] if s == 0 else slot)
            if s == n - 1:
                outs[m_in] = h_out
        else:
            h_out = torch.zeros_like(slot)
        if n > 1:
            (slot,) = comm.shift([h_out], mesh, axis, 1)
    return comm.all_reduce(outs, mesh, axis)
