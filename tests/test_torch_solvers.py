"""The pose solvers against the JAX package: utils/geometry (near the
identity, away from it, and the forward-mode Jacobians at xi = 0 the
solvers take), ops/voxel.py::snap_to_voxels, and ops/solvers (PnP single
and batched, the pose graph, point-to-point ICP, coarse-to-fine ICP), on
the same numpy inputs, on the CPU.

Tolerances: geometry within 1e-6 absolute for poses and 2e-6 for twists
(float32, a few roundings apart); Jacobians at 0 within 1e-6; log_se3's
closed-form V^-1 also against the reference's solve of V rho = t in float64;
snap_to_voxels' indices exact and its distances within 1e-6; solver poses
within 1e-4 absolute of the JAX package's after every iteration count used
here (float32 Gauss-Newton: each step's solve amplifies last-bit
differences by the normal equations' conditioning), and each case also
recovers its known pose within tests/test_solvers.py's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.dataloader import SyntheticDataset as JSyntheticDataset
from holoagent_tpu.ops import solvers as jsolvers
from holoagent_tpu.ops import voxel as jvoxel
from holoagent_tpu.ops.backproject import backproject as jbackproject
from holoagent_tpu.utils import geometry as jgeo
from holoagent_tpu.utils.camera import Pinhole as JPinhole
from holoagent_tpu.utils.camera import project as jproject
from holoagent_tpu_torch.ops import solvers
from holoagent_tpu_torch.ops import voxel
from holoagent_tpu_torch.utils import geometry as geo
from holoagent_tpu_torch.utils.camera import Pinhole

torch.set_num_threads(1)
POSE_ATOL = 1e-6
TWIST_ATOL = 2e-6
JAC_ATOL = 1e-6
SOLVER_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("scale", [0.0, 1e-6, 3e-4, 0.5, 1.5])
def test_geometry_equals_jax(scale):
    rng = np.random.default_rng(int(scale * 1e6) + 1)
    xi = (rng.normal(0, 1, (16, 6)) * scale).astype(np.float32)
    t = geo.exp_se3(_t(xi)).numpy()
    jt = _np(jgeo.exp_se3(jnp.asarray(xi)))
    np.testing.assert_allclose(t, jt, atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(geo.exp_so3(_t(xi[:, 3:])).numpy(), _np(jgeo.exp_so3(jnp.asarray(xi[:, 3:]))),
                               atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(geo.log_se3(_t(jt)).numpy(), _np(jgeo.log_se3(jnp.asarray(jt))), atol=TWIST_ATOL,
                               rtol=0)
    np.testing.assert_allclose(geo.log_so3(_t(jt[:, :3, :3])).numpy(), _np(jgeo.log_so3(jnp.asarray(jt[:, :3, :3]))),
                               atol=TWIST_ATOL, rtol=0)
    np.testing.assert_array_equal(geo.hat(_t(xi[:, 3:])).numpy(), _np(jgeo.hat(jnp.asarray(xi[:, 3:]))))
    np.testing.assert_allclose(geo.invert_pose(_t(jt)).numpy(), _np(jgeo.invert_pose(jnp.asarray(jt))),
                               atol=POSE_ATOL, rtol=0)
    pts = rng.normal(0, 2, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(geo.transform_points(_t(jt[0]), _t(pts)).numpy(),
                               _np(jgeo.transform_points(jnp.asarray(jt[0]), jnp.asarray(pts))), atol=4 * POSE_ATOL,
                               rtol=0)
    if scale < 1.0:  # log inverts exp away from pi
        np.testing.assert_allclose(geo.log_se3(_t(t)).numpy(), xi, atol=1e-4 if scale else 0.0, rtol=0)


@pytest.mark.parametrize("at", ["identity", "away"])
def test_jacobians_at_zero_equal_jax(at):
    """jacfwd of the residual shapes the solvers differentiate, at xi = 0:
    log(T exp(xi)) and exp(xi) applied to points; finite (no NaN from an
    untaken branch) and equal to jax.jacfwd."""
    rng = np.random.default_rng(3)
    base = np.eye(4, dtype=np.float32) if at == "identity" else _np(jgeo.exp_se3(jnp.asarray(
        rng.normal(0, 0.6, 6).astype(np.float32))))
    pts = rng.normal(0, 1, (5, 3)).astype(np.float32)

    def f(xi):
        return torch.cat([geo.log_se3(_t(base) @ geo.exp_se3(xi)), geo.transform_points(geo.exp_se3(xi), _t(pts))
                          .reshape(-1)])

    def jf(xi):
        return jnp.concatenate([jgeo.log_se3(jnp.asarray(base) @ jgeo.exp_se3(xi)),
                                jgeo.transform_points(jgeo.exp_se3(xi), jnp.asarray(pts)).reshape(-1)])

    j = torch.func.jacfwd(f)(torch.zeros(6)).numpy()
    jj = _np(jax.jacfwd(jf)(jnp.zeros(6)))
    assert np.isfinite(j).all()
    np.testing.assert_allclose(j, jj, atol=JAC_ATOL, rtol=0)


def _log_se3_by_solve(t):
    """The reference's form of log_se3: rho = solve(V, t)."""
    w = geo.log_so3(t[..., :3, :3])
    _, b, c = geo._abc(torch.sum(w * w, dim=-1)[..., None, None])
    k = geo.hat(w)
    v = geo._eye3(k) + b * k + c * (k @ k)
    return torch.cat([torch.linalg.solve(v, t[..., :3, 3][..., None])[..., 0], w], dim=-1)


@pytest.mark.parametrize("theta", [0.0999, 0.1001, 1.0, 3.0])
def test_log_se3_closed_form_against_a_float64_solve(theta):
    """log_se3's closed-form V^-1 (its series below theta^2 = 1e-2, the
    closed form above) against rho = solve(V, t) in float64 on the same
    float32 poses, either side of the switch and near pi: values within
    TWIST_ATOL; Jacobians at xi = 0 within JAC_ATOL, or near pi no farther
    than the reference's float32 solve form is (log_so3's atan2 sets both
    there: 4.2e-6 at theta = 3)."""
    rng = np.random.default_rng(7)
    axis = rng.normal(size=(8, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    xi = np.concatenate([rng.uniform(-1, 1, (8, 3)), axis * theta], axis=-1)
    t = geo.exp_se3(torch.from_numpy(xi)).float()
    np.testing.assert_allclose(geo.log_se3(t).numpy(), _log_se3_by_solve(t.double()).numpy(), atol=TWIST_ATOL, rtol=0)
    zero = torch.zeros(6)
    for base in t:
        jref = torch.func.jacfwd(lambda x: _log_se3_by_solve(base.double() @ geo.exp_se3(x)))(zero.double())
        j = torch.func.jacfwd(lambda x: geo.log_se3(base @ geo.exp_se3(x)))(zero)
        j_solve = torch.func.jacfwd(lambda x: _log_se3_by_solve(base @ geo.exp_se3(x)))(zero)
        err, err_solve = float((j - jref).abs().max()), float((j_solve - jref).abs().max())
        assert err <= max(JAC_ATOL, err_solve), (err, err_solve)


def _scene_voxels(n=4000, vs=0.1, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    grid, jgrid = voxel.GridSpec.centered(vs), jvoxel.GridSpec.centered(vs)
    d = voxel.voxel_downsample(_t(pts), torch.zeros(n, 1), torch.ones(n, dtype=torch.bool), grid, 1 << 13)
    jd = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.zeros((n, 1)), jnp.ones(n, bool), jgrid, 1 << 13)
    return rng, grid, jgrid, d, jd


def test_snap_to_voxels_equals_jax():
    rng, grid, jgrid, d, jd = _scene_voxels()
    np.testing.assert_array_equal(d["key"].numpy(), _np(jd["key"]))
    q = rng.uniform(-1.3, 1.3, (700, 3)).astype(np.float32)
    q[:50] = _np(jd["points"])[:50]  # exactly on a representative: distance 0
    q[50:60] = q[60:70]  # duplicates
    qv = rng.random(700) < 0.9
    idx, dist = voxel.snap_to_voxels(_t(q), torch.from_numpy(qv), d["key"], d["points"], grid)
    jidx, jdist = jvoxel.snap_to_voxels(jnp.asarray(q), jnp.asarray(qv), jd["key"], jd["points"], jgrid)
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    hit = _np(jidx) >= 0
    assert 100 < hit.sum() < 650 and not (hit & ~qv).any()
    np.testing.assert_allclose(dist.numpy()[hit], _np(jdist)[hit], atol=1e-6, rtol=0)
    assert np.isinf(dist.numpy()[~hit]).all() and np.isinf(_np(jdist)[~hit]).all()
    assert (dist.numpy()[:50][qv[:50]] == 0).all()


def test_snap_to_voxels_ties_to_the_first_probe():
    """Two representatives at the same distance from a query: the lower
    probe (cell offset order) wins in both packages."""
    grid, jgrid = voxel.GridSpec.centered(1.0), jvoxel.GridSpec.centered(1.0)
    pts = np.array([[0.5, 0.5, 0.5], [2.5, 0.5, 0.5], [0.5, 2.5, 0.5]], np.float32)
    keys = voxel.keys_of(_t(pts), torch.ones(3, dtype=torch.bool), grid)
    order = torch.argsort(keys)
    q = np.array([[1.5, 0.5, 0.5], [0.5, 1.5, 0.5], [1.5, 1.5, 0.5]], np.float32)
    idx, dist = voxel.snap_to_voxels(_t(q), torch.ones(3, dtype=torch.bool), keys[order], _t(pts)[order], grid)
    jidx, _ = jvoxel.snap_to_voxels(jnp.asarray(q), jnp.ones(3, bool), jnp.asarray(keys[order].numpy()),
                                    jnp.asarray(pts[order.numpy()]), jgrid)
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    np.testing.assert_allclose(dist.numpy(), [1.0, 1.0, np.sqrt(2.0)], rtol=1e-6)


def _pnp_case(rng, n=80):
    cam, jcam = Pinhole.make(200.0, 200.0, 64.0, 48.0), JPinhole.make(200.0, 200.0, 64.0, 48.0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    xi = (rng.normal(0, 1, 6) * np.array([0.05, 0.05, 0.08, 0.04, 0.03, 0.03])).astype(np.float32)
    pose_true = _np(jgeo.exp_se3(jnp.asarray(xi)))
    uv = _np(jproject(jgeo.transform_points(jnp.asarray(pose_true), jnp.asarray(pts)), jcam)[0])
    return cam, jcam, pts, uv, pose_true


def test_pnp_equals_jax():
    rng = np.random.default_rng(0)
    cam, jcam, pts, uv, pose_true = _pnp_case(rng)
    uv = uv.copy()
    uv[:8] += 300.0  # outliers, masked
    valid = np.ones(len(pts), bool)
    valid[:8] = False
    pose, rms = solvers.pnp_gauss_newton(pts, uv, valid, cam, np.eye(4), iters=10, device="cpu")
    jpose, jrms = jsolvers.pnp_gauss_newton(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), jcam, jnp.eye(4))
    np.testing.assert_allclose(pose.numpy(), _np(jpose), atol=SOLVER_ATOL, rtol=0)
    err = _np(jgeo.log_se3(jgeo.invert_pose(jnp.asarray(pose_true)) @ jnp.asarray(pose.numpy())))
    assert np.abs(err).max() < 1e-3 and float(rms) < 1e-2 and abs(float(rms) - float(jrms)) < 1e-3


def test_pnp_batch_equals_jax():
    rng = np.random.default_rng(1)
    cases = [_pnp_case(rng) for _ in range(3)]
    cam, jcam = cases[0][0], cases[0][1]
    pts = np.stack([c[2] for c in cases])
    uv = np.stack([c[3] for c in cases])
    valid = rng.random(pts.shape[:2]) < 0.95
    init = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses, rms = solvers.pnp_batch(pts, uv, valid, cam, init, device="cpu")
    jposes, jrms = jsolvers.pnp_batch(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), jcam, jnp.asarray(init))
    assert poses.shape == (3, 4, 4) and rms.shape == (3,)
    np.testing.assert_allclose(poses.numpy(), _np(jposes), atol=SOLVER_ATOL, rtol=0)
    np.testing.assert_allclose(rms.numpy(), _np(jrms), atol=1e-3, rtol=0)
    for b in range(3):  # each row equals its own single solve
        one, _ = solvers.pnp_gauss_newton(pts[b], uv[b], valid[b], cam, init[b], device="cpu")
        np.testing.assert_allclose(poses[b].numpy(), one.numpy(), atol=1e-6, rtol=0)


def test_pose_graph_equals_jax():
    rng = np.random.default_rng(2)
    m = 6
    true = [np.eye(4, dtype=np.float32)]
    for _ in range(1, m):
        true.append(true[-1] @ _np(jgeo.exp_se3(jnp.asarray(np.array([0.5, 0, 0, 0, 0, 0.3], np.float32)))))
    true = np.stack(true)
    edges = [(i, i + 1) for i in range(m - 1)] + [(m - 1, 0), (1, 4)]
    noise = rng.normal(0, 0.02, (len(edges), 6)).astype(np.float32)
    rels = np.stack([_np(jgeo.invert_pose(jnp.asarray(true[i])) @ true[j] @ jgeo.exp_se3(jnp.asarray(noise[k])))
                     for k, (i, j) in enumerate(edges)])
    init = [true[0]]
    for k in range(m - 1):
        init.append(init[-1] @ rels[k])
    init = np.stack(init).astype(np.float32)
    ev = np.ones(len(edges), bool)
    ev[-1] = False  # a masked edge
    poses, rnorm = solvers.pose_graph_gauss_newton(init, np.array(edges), rels, ev, iters=15, device="cpu")
    jposes, jrnorm = jsolvers.pose_graph_gauss_newton(jnp.asarray(init), jnp.asarray(np.array(edges, np.int32)),
                                                       jnp.asarray(rels), jnp.asarray(ev), iters=15)
    np.testing.assert_allclose(poses.numpy(), _np(jposes), atol=SOLVER_ATOL, rtol=0)
    assert abs(float(rnorm) - float(jrnorm)) < 1e-4

    def err(ps):
        return np.abs(_np(jgeo.log_se3(jgeo.invert_pose(jnp.asarray(true)) @ jnp.asarray(ps)))).mean()

    assert err(poses.numpy()) < err(init) and err(poses.numpy()) < 0.05


def test_icp_equals_jax():
    rng, grid, jgrid, d, jd = _scene_voxels(5000, 0.05, seed=4)
    scan = _np(jd["points"])[:800]
    xi = np.array([0.05, -0.04, 0.03, 0.02, 0.01, -0.02], np.float32)
    t_true = _np(jgeo.exp_se3(jnp.asarray(xi)))
    scan_t = _np(jgeo.transform_points(jnp.asarray(np.linalg.inv(t_true)), jnp.asarray(scan))).astype(np.float32)
    valid = np.ones(800, bool)
    valid[::50] = False
    res = solvers.icp_point2point(scan_t, valid, d["key"], d["points"], grid, np.eye(4), iters=20, device="cpu")
    jres = jsolvers.icp_point2point(jnp.asarray(scan_t), jnp.asarray(valid), jd["key"], jd["points"], jgrid,
                                    jnp.eye(4), iters=20)
    np.testing.assert_allclose(res.pose.numpy(), _np(jres.pose), atol=SOLVER_ATOL, rtol=0)
    assert abs(float(res.rms) - float(jres.rms)) < 1e-5 and float(res.inlier_frac) == float(jres.inlier_frac)
    err = _np(jgeo.log_se3(jgeo.invert_pose(jnp.asarray(t_true)) @ jnp.asarray(res.pose.numpy())))
    assert np.abs(err).max() < 0.03 and float(res.inlier_frac) > 0.9
    empty = solvers.icp_point2point(np.zeros((8, 3)), np.zeros(8, bool), d["key"], d["points"], grid, np.eye(4),
                                    device="cpu")
    assert float(empty.inlier_frac) == 0.0


def test_icp_multiscale_equals_jax():
    ds = JSyntheticDataset(num_frames=4, hw=(48, 64))
    pts_all = []
    for i in range(4):
        f = ds[i]
        p, _, v = jbackproject(jnp.asarray(f.depth), jnp.asarray(f.rgb), JPinhole.from_matrix(f.k),
                               jnp.asarray(f.pose), 1e-3, 20.0)
        pts_all.append(_np(p)[_np(v)])
    mappts = np.concatenate(pts_all).astype(np.float32)
    scan = mappts[::7][:1500]
    xi = np.array([0.08, -0.05, 0.02, 0.03, -0.02, 0.05], np.float32)
    t_true = _np(jgeo.exp_se3(jnp.asarray(xi)))
    scan_p = _np(jgeo.transform_points(jnp.asarray(np.linalg.inv(t_true).astype(np.float32)), jnp.asarray(scan)))
    kw = dict(scales=(0.3, 0.1, 0.05, 0.03), iters_per_scale=15)
    res = solvers.icp_multiscale(scan_p, np.ones(len(scan_p), bool), mappts, np.ones(len(mappts), bool), np.eye(4),
                                 device="cpu", **kw)
    jres = jsolvers.icp_multiscale(jnp.asarray(scan_p), jnp.ones(len(scan_p), bool), jnp.asarray(mappts),
                                   jnp.ones(len(mappts), bool), jnp.eye(4), **kw)
    np.testing.assert_allclose(res.pose.numpy(), _np(jres.pose), atol=SOLVER_ATOL, rtol=0)
    err = np.abs(_np(jgeo.log_se3(jgeo.invert_pose(jnp.asarray(t_true)) @ jnp.asarray(res.pose.numpy()))))
    assert err.max() < 0.05 and abs(float(res.inlier_frac) - float(jres.inlier_frac)) < 2e-3
