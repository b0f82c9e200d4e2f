"""Expert parallelism: top-k gated mixture of experts with the experts split
over a mesh axis and tokens routed by ``all_to_all`` (counterpart of
holoagent_tpu/parallel/moe.py).

Each rank owns E/D consecutive experts and never moves weights.  Every rank
routes the same replicated tokens: a dense top-k softmax gate picks experts,
assignments are bucketed by owner with a fixed capacity
C = ceil(T * k * capacity_factor / D) per destination (one extra trash slot
takes the overflow, so a drop never overwrites a live slot), shipped with
one ``all_to_all_single``, run through the local experts, and shipped back
with one more.  Dropped assignments lose their gate weight, and the
surviving weights renormalise per token (Switch / GShard semantics).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..device import DeviceLike, generator, resolve
from ..models.transformer import gelu
from . import comm

Params = Dict[str, torch.Tensor]


def init_moe_mlp(n_experts: int, d_model: int, d_hidden: int, scale: float = 0.2, seed: int = 0,
                 device: DeviceLike = None) -> Params:
    """Stacked expert MLPs, (E, ...) each, normal weights at `scale` from a
    seeded generator (the reference's shapes; its values are JAX's)."""
    dev = resolve(device)
    g = generator(seed)
    return {
        "w1": (torch.randn(n_experts, d_model, d_hidden, generator=g) * scale).to(dev),
        "b1": torch.zeros(n_experts, d_hidden, device=dev),
        "w2": (torch.randn(n_experts, d_hidden, d_model, generator=g) * scale).to(dev),
        "b2": torch.zeros(n_experts, d_model, device=dev),
    }


def _expert_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:  # p: one expert's params, x: (n, d)
    return gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_dense_reference(params: Params, gate_w: torch.Tensor, x: torch.Tensor, top_k: int = 2) -> torch.Tensor:
    """Unsharded reference: every expert over every token, combined by the
    top-k gate."""
    t = x.shape[0]
    e = gate_w.shape[1]
    topv, topi = _top_k(x @ gate_w, top_k)
    w = torch.softmax(topv, dim=-1)  # (T, K)
    all_out = torch.stack([_expert_mlp({k: a[i] for k, a in params.items()}, x) for i in range(e)])  # (E, T, D)
    picked = all_out[topi, torch.arange(t, device=x.device)[:, None]]  # (T, K, D)
    return (picked * w[..., None]).sum(dim=1)


def moe_apply(
    params: Params,  # (E, ...) expert params (every rank passes all E; it keeps its own)
    gate_w: torch.Tensor,  # (D, E)
    x: torch.Tensor,  # (T, D) tokens, the same on every rank
    mesh: DeviceMesh,
    axis: str = "expert",
    top_k: int = 2,
    capacity_factor: float = 2.0,
    expert_fn: Callable = _expert_mlp,
) -> torch.Tensor:
    """Expert-parallel forward; returns the combined (T, D) outputs on every
    rank.  With capacity_factor >= D (or few tokens) nothing drops and the
    result equals ``moe_dense_reference``."""
    dnum, me = comm.size(mesh, axis), comm.index(mesh, axis)
    e = gate_w.shape[1]
    if e % dnum:
        raise ValueError(f"{e} experts not divisible by {dnum} devices")
    e_loc = e // dnum
    t, dm = x.shape
    dev = x.device
    cap = int(-(-t * top_k * capacity_factor // dnum))
    capp = cap + 1  # the last slot of each bucket is the trash slot
    p_local = {k: a[me * e_loc : (me + 1) * e_loc] for k, a in params.items()}

    topv, topi = _top_k(x @ gate_w, top_k)  # (T, K)
    gate = torch.softmax(topv, dim=-1)
    flat_dest = (topi // e_loc).reshape(-1)  # owner of each assignment (T*K,)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(top_k)
    flat_exp = (topi % e_loc).reshape(-1)
    # slot of each assignment within its destination's bucket
    onehot = torch.nn.functional.one_hot(flat_dest, dnum)
    slot = ((torch.cumsum(onehot, dim=0) * onehot) - 1).amax(dim=1)
    keep = slot < cap
    idx_d = torch.where(keep, flat_dest, dnum - 1)
    idx_c = torch.where(keep, slot, cap)
    send_x = torch.zeros((dnum, capp, dm), dtype=x.dtype, device=dev)
    send_meta = torch.full((dnum, capp, 2), -1, dtype=torch.int32, device=dev)  # (token, local expert)
    send_x[idx_d, idx_c] = torch.where(keep[:, None], x[flat_tok], torch.zeros((), dtype=x.dtype, device=dev))
    meta = torch.stack([flat_tok, flat_exp], dim=-1).to(torch.int32)
    send_meta[idx_d, idx_c] = torch.where(keep[:, None], meta, torch.full_like(meta, -1))
    rx = comm.all_to_all(send_x.reshape(dnum * capp, dm), mesh, axis)
    rm = comm.all_to_all(send_meta.reshape(dnum * capp, 2), mesh, axis)
    # each local expert over its rows (a masked dense pass: fixed shapes)
    out_rows = torch.zeros_like(rx)
    for le in range(e_loc):
        y = expert_fn({k: a[le] for k, a in p_local.items()}, rx)
        out_rows = torch.where((rm[:, 1] == le)[:, None], y, out_rows)
    back = comm.all_to_all(out_rows, mesh, axis).reshape(dnum, capp, dm)
    # combine on the sender: assignment k of token t sits at (idx_d, idx_c)
    y_flat = back[idx_d, idx_c]  # (T*K, D)
    w_tok = torch.where(keep, gate.reshape(-1), torch.zeros((), device=dev)).reshape(t, top_k)
    w_tok = w_tok / torch.clamp(w_tok.sum(dim=1, keepdim=True), min=1e-9)
    return (y_flat.reshape(t, top_k, dm) * w_tok[..., None]).sum(dim=1)
