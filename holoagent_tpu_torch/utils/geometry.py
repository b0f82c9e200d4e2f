"""SE(3)/SO(3) helpers for mapping and the pose solvers (counterpart of
holoagent_tpu/utils/geometry.py).

Batched torch, float32 with TF32 off (``device.resolve`` turns it off; the
reference pins ``Precision.HIGHEST`` on each product).  Every function is
smooth at the identity, because the Gauss-Newton solvers (``ops.solvers``)
take ``torch.func.jacfwd`` of exp/log at xi = 0: every small-angle branch
uses the double-``where`` pattern, so no NaN or Inf reaches the untaken
branch's value, and so none reaches the forward-mode tangents either.  No
function branches in Python on tensor values or writes in place, so all of
them run under ``torch.func.jacfwd`` and ``torch.func.vmap``.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator, batched: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _abc(theta2: torch.Tensor):
    """Series-safe coefficients A=sin t/t, B=(1-cos t)/t^2, C=(t-sin t)/t^3."""
    small = theta2 < 1e-8
    t2s = torch.where(small, torch.ones_like(theta2), theta2)  # keep the untaken branch finite
    t = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - torch.sin(t)) / (t2s * t))
    return a, b, c


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    # made on the device (no host copy), so a CUDA graph can capture it
    row = torch.eye(4, dtype=top.dtype, device=top.device)[3:]
    return row.expand(top.shape[:-2] + (1, 4))


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exp, batched: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    a, b, _ = _abc(theta2)
    k = hat(w)
    return _eye3(k) + a * k + b * (k @ k)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp, batched: (..., 6) [rho, w] -> (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    a, b, c = _abc(theta2)
    k = hat(w)
    kk = k @ k
    eye = _eye3(k)
    r = eye + a * k + b * kk
    v = eye + b * k + c * kk
    t = torch.einsum("...ij,...j->...i", v, rho)
    top = torch.cat([r, t[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def log_so3(r: torch.Tensor) -> torch.Tensor:
    """SO(3) log, batched: (..., 3, 3) -> (..., 3); atan2 formulation, smooth
    at the identity (valid for rotations away from pi)."""
    w = torch.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        dim=-1,
    )
    # w2, c and the scale keep a trailing axis of 1: torch's forward-mode
    # rules give a 0-dim float32 tensor times a Python float a float64
    # tangent, which the next float32 product under jacfwd rejects
    w2 = torch.sum(w * w, dim=-1, keepdim=True)  # (2 sin theta)^2
    c = (r[..., 0, 0:1] + r[..., 1, 1:2] + r[..., 2, 2:3] - 1.0) / 2.0
    small = w2 < 1e-12
    # sqrt and atan2 only see safe values; the small branch is a constant
    # series so no NaN reaches either branch's tangents
    s2_safe = 0.5 * torch.sqrt(torch.where(small, torch.ones_like(w2), w2))
    theta_big = torch.atan2(s2_safe, c)
    scale = torch.where(small, 0.5 + w2 / 48.0, theta_big / (2.0 * s2_safe))
    return w * scale


def _vinv_coef(theta2: torch.Tensor) -> torch.Tensor:
    """D = (1 - A/(2B)) / t^2 = (1 - (t/2) cot(t/2)) / t^2 of
    V^-1 = I - K/2 + D K^2; its series 1/12 + t^2/720 + t^4/30240 below
    t^2 = 1e-2, where the closed form cancels (the series' next term is
    under 1e-12 there)."""
    small = theta2 < 1e-2
    t2s = torch.where(small, torch.ones_like(theta2), theta2)  # keep the untaken branch finite
    half = 0.5 * torch.sqrt(t2s)
    return torch.where(small, 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
                       (1.0 - half * torch.cos(half) / torch.sin(half)) / t2s)


def log_se3(t: torch.Tensor) -> torch.Tensor:
    """SE(3) log, batched: (..., 4, 4) -> (..., 6) [rho, w].  rho is V^-1 t
    with V^-1 in closed form (the reference solves V rho = t): a few
    elementwise ops, no solver call and so no host synchronisation under
    ``torch.func.jacfwd``."""
    w = log_so3(t[..., :3, :3])
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    k = hat(w)
    v_inv = _eye3(k) - 0.5 * k + _vinv_coef(theta2) * (k @ k)
    rho = torch.einsum("...ij,...j->...i", v_inv, t[..., :3, 3])
    return torch.cat([rho, w], dim=-1)


def transform_points(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 pose (or batch of poses) to (N, 3) points."""
    r = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return torch.einsum("...nj,...ij->...ni", points, r) + t[..., None, :]


def invert_pose(pose: torch.Tensor) -> torch.Tensor:
    """Invert 4x4 rigid transform(s)."""
    r = pose[..., :3, :3]
    t = pose[..., :3, 3]
    rt = r.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", rt, t)
    top = torch.cat([rt, ti[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)
