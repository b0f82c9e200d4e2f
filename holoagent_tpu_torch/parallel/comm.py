"""Collectives over one mesh axis, in the reference's terms (port-only).

  ``all_gather``        jax.lax.all_gather(tiled=True) / gathering a result
  ``all_to_all``        jax.lax.all_to_all(..., 0, 0, tiled=True)
  ``all_reduce``        jax.lax.psum
  ``shift``             jax.lax.ppermute by a fixed offset (batch_isend_irecv)

and the autograd pieces of explicit DP and TP (``gather_batch``,
``reduce_from_tp``, ``copy_to_tp``).  Every collective runs on every rank of
the axis in the same order, on a one-rank axis too (as a one-rank call).
Boolean tensors travel as uint8 (NCCL has no bool).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# torch 2.13 names the tiled all-gather all_gather_single and warns on the
# old all_gather_into_tensor; earlier releases have only the old name
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

def group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position on the axis (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def block(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of `t` along `dim` (``P(axis)``'s split)."""
    n = size(mesh, axis)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} not divisible by the {axis} axis ({n})")
    step = t.shape[dim] // n
    return t.narrow(dim, index(mesh, axis) * step, step)


def _wire(t: torch.Tensor) -> torch.Tensor:
    return (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's `t` along `dim`, in axis order."""
    n = size(mesh, axis)
    w = _wire(t)
    out = torch.empty((n * w.shape[0],) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    _gather_into(out, w, group=group(mesh, axis))
    out = out.to(t.dtype)
    if dim != 0:
        out = torch.cat(out.chunk(n, dim=0), dim=dim)
    return out


def all_to_all(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(n * b, ...) send buffer -> (n * b, ...): block j goes to rank j and
    block i of the result came from rank i."""
    w = _wire(t)
    out = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    dist.all_to_all_single(out, w, group=group(mesh, axis))
    return out.to(t.dtype)


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum over the axis (a new tensor)."""
    out = t.clone()
    dist.all_reduce(out, group=group(mesh, axis))
    return out


def shift(tensors: Sequence[torch.Tensor], mesh: DeviceMesh, axis: str, offset: int) -> List[torch.Tensor]:
    """Position i sends each tensor to position (i + offset) mod n and
    receives from (i - offset) mod n (one ``batch_isend_irecv``)."""
    g = group(mesh, axis)
    n, me = size(mesh, axis), index(mesh, axis)
    if offset % n == 0:
        return [t.clone() for t in tensors]
    to = dist.get_global_rank(g, (me + offset) % n)
    frm = dist.get_global_rank(g, (me - offset) % n)
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), to, g))
        ops.append(dist.P2POp(dist.irecv, o, frm, g))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def broadcast(tensors: Sequence[torch.Tensor], mesh: DeviceMesh, src_index: int = 0) -> None:
    """In place, from the mesh rank `src_index` to every rank of the mesh
    (the whole world the mesh spans)."""
    src = int(mesh.mesh.flatten()[src_index])
    for t in tensors:
        if t.dtype == torch.bool:
            w = t.to(torch.uint8)
            dist.broadcast(w, src)
            t.copy_(w.bool())
        else:
            dist.broadcast(t, src)


class _GatherBatch(torch.autograd.Function):
    """All-gather along dim 0; the backward keeps this rank's block of the
    gradient.  Every rank computes the same loss from the gathered tensor,
    so each rank's block of the gradient is already the whole gradient of
    its own rows (a reduce-scatter would count it n times)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_gather(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return block(g, ctx.mesh, ctx.axis).contiguous(), None, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: sum the partial products over the axis; the gradient
    passes through (every rank of the axis holds the same downstream)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the partial
    input gradients of the sharded products over the axis."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axis), None, None


def gather_batch(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    return _GatherBatch.apply(t, mesh, axis)


def reduce_from_tp(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    return _ReduceFromTP.apply(t, mesh, axis)


def copy_to_tp(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    return _CopyToTP.apply(t, mesh, axis)
