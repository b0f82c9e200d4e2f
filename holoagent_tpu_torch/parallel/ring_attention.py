"""Ring attention: sequence-parallel attention over the mesh (counterpart of
holoagent_tpu/parallel/ring_attention.py).

The sequence axis is split over "data": each rank holds its Q/K/V block,
the K/V blocks rotate around the ring (position i sends to i - 1, the
reference's permutation) W - 1 times, and softmax accumulates online in
float32 (running max and sum), so no rank ever holds the (T, T) scores.
The causal mask is taken on global token indices.  The per-block products
are plain ``torch.matmul`` in float32, as the reference computes them with
``einsum`` outside any Pallas kernel.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from . import comm

NEG_INF = -1e30


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: DeviceMesh,
                         axis: str = "data", causal: bool = False, scale: float | None = None) -> torch.Tensor:
    """The per-rank body: q/k/v (B, H, Tl, D) this rank's blocks of the
    sequence -> its (B, H, Tl, D) block of the output, in q's dtype."""
    n, me = comm.size(mesh, axis), comm.index(mesh, axis)
    b, h, tl, d = q.shape
    scale = d**-0.5 if scale is None else scale
    qf = q.float() * scale
    m = torch.full((b, h, tl, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tl, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tl, d), dtype=torch.float32, device=q.device)
    if causal:
        rows = torch.arange(tl, device=q.device)[:, None]
        cols = torch.arange(tl, device=q.device)[None, :]
    k_blk, v_blk = k, v
    for step in range(n):
        src = (me + step) % n  # the shard this K/V block came from
        s = torch.matmul(qf, k_blk.float().transpose(-1, -2))
        if causal:
            s = torch.where(me * tl + rows >= src * tl + cols, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, v_blk.float())
        m = m_new
        if step < n - 1:  # receive from the right neighbour
            k_blk, v_blk = comm.shift([k_blk, v_blk], mesh, axis, -1)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: DeviceMesh, causal: bool = False,
                   axis_name: str = "data") -> torch.Tensor:
    """Sequence-parallel attention over (B, H, T, D) q/k/v, T divisible by
    the axis: each rank attends its block of T and the blocks are gathered,
    so every rank returns the whole (B, H, T, D) output."""
    blocks = [comm.block(t, mesh, axis_name, dim=2) for t in (q, k, v)]
    out = ring_attention_local(*blocks, mesh, axis=axis_name, causal=causal)
    return comm.all_gather(out, mesh, axis_name, dim=2)
