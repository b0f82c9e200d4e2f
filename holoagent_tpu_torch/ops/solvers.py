"""Batched nonlinear least-squares localization solvers (counterpart of
holoagent_tpu/ops/solvers.py): PnP by reprojection Gauss-Newton, pose-graph
Gauss-Newton, and point-to-point ICP against a voxel scene, single-scale
and coarse-to-fine.

Each is fixed-iteration Levenberg-damped Gauss-Newton: the residual
Jacobians are ``torch.func.jacfwd`` at the identity right-perturbation
(xi = 0), the normal equations are dense (6x6 a camera, 6Mx6M for the
graph) and solved by ``torch.linalg.solve_ex`` (no error check, so no
host synchronisation; damping keeps them nonsingular), a batch of PnP
problems is ``torch.func.vmap``, and the iterations are a Python loop of
fixed length (``lax.scan`` in the reference).  Every product is float32
with TF32 off (the reference pins ``Precision.HIGHEST`` on each).  No
function below branches in Python on tensor values, so the vmapped and
differentiated ones trace the same program for every input.

The entry points take numpy arrays or tensors and run on `device`: the
card unless the caller asks for the CPU.  On the card a solve is one CUDA
graph, captured at the first call of its shapes and settings and replayed
after (``_run``), as the reference's jit compiles once a shape: run
eagerly, the loop is host-bound (torch.func's dispatch of a few hundred
small launches an iteration).  The first call of a shape costs about two
eager solves (a warm-up and the capture).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import torch

from ..device import DeviceLike, resolve
from ..utils.camera import Pinhole, project
from ..utils.geometry import exp_se3, invert_pose, log_se3, transform_points
from . import voxel


def _f32(dev: torch.device, *arrays):
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays)


def _mask(dev: torch.device, *arrays):
    return tuple(torch.as_tensor(a, device=dev).to(torch.bool) for a in arrays)


# (function, device, input shapes and dtypes, settings) -> (graph, static
# inputs, static outputs)
_GRAPHS: dict = {}


def _run(fn, tensors: tuple, **settings) -> tuple:
    """fn(*tensors, **settings) as a tuple.  On the card the solve is
    captured once into a CUDA graph over static copies of
    `tensors` (after a warm-up call on a side stream, which creates the
    library handles and workspaces) and replayed: the inputs are copied in
    and the outputs cloned out."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return tuple(fn(*tensors, **settings))
    key = (fn.__name__, dev, tuple((t.shape, t.dtype) for t in tensors), tuple(sorted(settings.items())))
    if key not in _GRAPHS:
        static = [t.clone() for t in tensors]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*static, **settings)
        torch.cuda.current_stream(dev).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fn(*static, **settings)
        _GRAPHS[key] = (g, static, tuple(out))
    g, static, out = _GRAPHS[key]
    for s, t in zip(static, tensors):
        s.copy_(t)
    g.replay()
    return tuple(o.clone() for o in out)


def _gn_step(res_of, n: int, dtype, dev, damping: float) -> torch.Tensor:
    """One damped Gauss-Newton update dx (n,) of the residual function
    `res_of` (n,) -> (R,) at 0."""
    xi0 = torch.zeros(n, dtype=dtype, device=dev)
    r = res_of(xi0)
    j = torch.func.jacfwd(res_of)(xi0).reshape(r.shape[0], n)  # (R, n)
    h = j.T @ j + damping * torch.eye(n, dtype=dtype, device=dev)
    return -torch.linalg.solve_ex(h, j.T @ r)[0]


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------


def _reproj_residual(xi, pose_wc, points_w, pixels, cam):
    """Residual of pose_wc . exp(xi) applied to world points, vs pixels."""
    t = pose_wc @ exp_se3(xi)
    uv, z = project(transform_points(t, points_w), cam)
    return uv - pixels, z


def _pnp(points_w, pixels, valid, pose_wc_init, *, cam: Pinhole, iters: int, damping: float):
    pose = pose_wc_init
    for _ in range(iters):

        def res_of(xi, pose=pose):
            r, z = _reproj_residual(xi, pose, points_w, pixels, cam)
            w = (valid & (z > 1e-3)).to(r.dtype)[:, None]
            return (r * w).reshape(-1)

        pose = pose @ exp_se3(_gn_step(res_of, 6, points_w.dtype, points_w.device, damping))
    r, z = _reproj_residual(torch.zeros(6, dtype=points_w.dtype, device=points_w.device), pose, points_w, pixels, cam)
    w = (valid & (z > 1e-3)).to(r.dtype)
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    rms = torch.sqrt(torch.sum((r**2).sum(-1) * w, dim=-1, keepdim=True) / n)[..., 0]
    return pose, rms


def pnp_gauss_newton(
    points_w,  # (N, 3) world landmarks
    pixels,  # (N, 2) observations
    valid,  # (N,)
    cam: Pinhole,
    pose_wc_init,  # (4, 4) world-to-camera initial guess
    iters: int = 10,
    damping: float = 1e-4,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine a world-to-camera pose by reprojection Gauss-Newton on
    `device`.  Returns (pose_wc (4,4), rms reprojection error in pixels)."""
    dev = resolve(device)
    points_w, pixels, pose_wc_init = _f32(dev, points_w, pixels, pose_wc_init)
    (valid,) = _mask(dev, valid)
    return _run(_pnp, (points_w, pixels, valid, pose_wc_init), cam=cam, iters=iters, damping=damping)


def _pnp_batch(points_w, pixels, valid, pose_wc_init, *, cam: Pinhole, iters: int, damping: float):
    solve = partial(_pnp, cam=cam, iters=iters, damping=damping)
    return torch.func.vmap(solve)(points_w, pixels, valid, pose_wc_init)


def pnp_batch(
    points_w,  # (B, N, 3)
    pixels,  # (B, N, 2)
    valid,  # (B, N)
    cam: Pinhole,
    pose_wc_init,  # (B, 4, 4)
    iters: int = 10,
    damping: float = 1e-4,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pnp_gauss_newton`` over a batch of problems sharing one camera, as
    one ``torch.func.vmap`` program.  Returns (poses (B,4,4), rms (B,))."""
    dev = resolve(device)
    points_w, pixels, pose_wc_init = _f32(dev, points_w, pixels, pose_wc_init)
    (valid,) = _mask(dev, valid)
    return _run(_pnp_batch, (points_w, pixels, valid, pose_wc_init), cam=cam, iters=iters, damping=damping)


# ---------------------------------------------------------------------------
# Pose-graph Gauss-Newton
# ---------------------------------------------------------------------------


def pose_graph_gauss_newton(
    poses_init,  # (M, 4, 4) initial absolute poses
    edges,  # (E, 2) int (i, j)
    rel,  # (E, 4, 4) measured T_i^-1 T_j
    edge_valid,  # (E,)
    iters: int = 20,
    damping: float = 1e-3,
    anchor_weight: float = 1e4,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimize absolute poses over relative-pose constraints
    r_e = log(Z_e^-1 X_i^-1 X_j); pose 0 anchored by a strong prior.  The
    Jacobian, (6E + 6) x 6M, is one ``jacfwd`` over all 6M tangents.
    Returns (poses (M,4,4), final residual norm)."""
    dev = resolve(device)
    poses_init, rel = _f32(dev, poses_init, rel)
    (edge_valid,) = _mask(dev, edge_valid)
    edges = torch.as_tensor(edges, device=dev).long()
    return _run(_pose_graph, (poses_init, edges, rel, edge_valid), iters=iters, damping=damping,
                anchor_weight=anchor_weight)


def _pose_graph(poses_init, edges, rel, edge_valid, *, iters: int, damping: float, anchor_weight: float):
    dev = poses_init.device
    m = poses_init.shape[0]
    rel_inv = invert_pose(rel)
    anchor_inv = invert_pose(poses_init[0:1])

    def residuals(xis, poses):
        x = poses @ exp_se3(xis.reshape(m, 6))
        pred = invert_pose(x[edges[:, 0]]) @ x[edges[:, 1]]
        r = log_se3(rel_inv @ pred) * edge_valid[:, None]  # (E, 6)
        anchor = log_se3(anchor_inv @ x[0:1]) * anchor_weight
        return torch.cat([r.reshape(-1), anchor.reshape(-1)])

    poses = poses_init
    for _ in range(iters):
        dx = _gn_step(partial(residuals, poses=poses), 6 * m, poses.dtype, dev, damping)
        poses = poses @ exp_se3(dx.reshape(m, 6))
    final = residuals(torch.zeros(6 * m, dtype=poses.dtype, device=dev), poses)
    return poses, torch.linalg.norm(final)


# ---------------------------------------------------------------------------
# ICP against the voxel scene (relocalization)
# ---------------------------------------------------------------------------


class ICPResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) refined src->dst
    rms: torch.Tensor
    inlier_frac: torch.Tensor


def _icp(src_points, src_valid, dst_sorted_keys, dst_points, pose_init, *, grid: voxel.GridSpec, iters: int,
         max_corr_dist: float, damping: float):
    pose = pose_init
    for _ in range(iters):
        idx, dist = voxel.snap_to_voxels(transform_points(pose, src_points), src_valid, dst_sorted_keys,
                                         dst_points, grid)
        w = ((idx >= 0) & (dist < max_corr_dist) & src_valid).to(src_points.dtype)[:, None]
        q = dst_points[idx.clamp(min=0)]

        def res_of(xi, pose=pose, q=q, w=w):
            return ((transform_points(pose @ exp_se3(xi), src_points) - q) * w).reshape(-1)

        pose = pose @ exp_se3(_gn_step(res_of, 6, src_points.dtype, src_points.device, damping))
    idx, dist = voxel.snap_to_voxels(transform_points(pose, src_points), src_valid, dst_sorted_keys, dst_points, grid)
    w = (idx >= 0) & (dist < max_corr_dist) & src_valid
    nw = torch.sum(w.to(torch.float32))
    rms = torch.sqrt(torch.sum(torch.where(w, dist**2, 0.0)) / torch.clamp(nw, min=1.0))
    frac = nw / torch.clamp(torch.sum(src_valid.to(torch.float32)), min=1.0)
    return ICPResult(pose=pose, rms=rms, inlier_frac=frac)


def icp_point2point(
    src_points,  # (N, 3) e.g. current scan
    src_valid,  # (N,)
    dst_sorted_keys,  # (C,) scene voxel keys (sorted, SENTINEL padded)
    dst_points,  # (C, 3) scene points
    grid: voxel.GridSpec,
    pose_init,  # (4, 4) src->dst initial
    iters: int = 15,
    max_corr_dist: float = 0.5,
    damping: float = 1e-4,
    device: DeviceLike = None,
) -> ICPResult:
    """Point-to-point ICP with voxel-snap correspondences
    (``voxel.snap_to_voxels`` in place of a KD-tree) on `device`."""
    dev = resolve(device)
    src_points, dst_points, pose_init = _f32(dev, src_points, dst_points, pose_init)
    (src_valid,) = _mask(dev, src_valid)
    keys = torch.as_tensor(dst_sorted_keys, dtype=torch.int32, device=dev)
    return ICPResult(*_run(_icp, (src_points, src_valid, keys, dst_points, pose_init), grid=grid, iters=iters,
                           max_corr_dist=max_corr_dist, damping=damping))


def icp_multiscale(
    src_points,
    src_valid,
    map_points,  # (C, 3) map points (e.g. SceneState.points())
    map_valid,  # (C,)
    pose_init,
    scales: Tuple[float, ...] = (0.4, 0.15, 0.05),
    iters_per_scale: int = 10,
    device: DeviceLike = None,
) -> ICPResult:
    """Coarse-to-fine ICP: correspondences found by voxel snap reach one
    cell (about 1.7x the voxel size), so large initial errors need coarse
    grids first.  At each scale the map is voxel-downsampled and
    ``icp_point2point`` runs with a correspondence gate of 3 cells (one
    CUDA graph a scale on the card; the downsampling stays outside)."""
    dev = resolve(device)
    src_points, map_points, pose = _f32(dev, src_points, map_points, pose_init)
    src_valid, map_valid = _mask(dev, src_valid, map_valid)
    result = None
    n = map_points.shape[0]
    for s in scales:
        grid = voxel.GridSpec.centered(s)
        down = voxel.voxel_downsample(map_points, torch.zeros((n, 1), dtype=map_points.dtype, device=dev),
                                      map_valid, grid, capacity=n)
        result = ICPResult(*_run(_icp, (src_points, src_valid, down["key"], down["points"], pose), grid=grid,
                                 iters=iters_per_scale, max_corr_dist=3.0 * s, damping=1e-4))
        pose = result.pose
    return result
