"""The port's dataset loaders against the JAX package's, on fixture files
written under tmp_path in each layout (``dataloader.export``): HM3DSem
(with semantic/), Replica (cam_params.json in the scene, beside it, or
none), Horizon
(poses.txt with float timestamps, CameraTrajectory.txt with integer ones),
ScanNet (PNG and JPEG colour), iPhone (odometry.csv and poses.txt).

Tolerances: both packages' frames (rgb, depth, pose, K), `len` and
`frameId2imgPath` exactly equal; the frames equal to the writer's
quantized read-back exactly, poses from matrix files exactly and from
quaternions within 2e-6 (float64 quaternion round trip, float32 pose).
The Horizon intrinsics reader equals ``yaml.safe_load`` on every fixture.
"""

import numpy as np
import pytest
import yaml

from holoagent_tpu import config as jconfig
from holoagent_tpu.apps.common import load_dataset as jload_dataset
from holoagent_tpu.dataloader import formats as jformats
from holoagent_tpu.dataloader.hm3dsem import HM3DSemDataset as JHM3DSem
from holoagent_tpu.dataloader.horizon import HorizonDataset as JHorizon
from holoagent_tpu.dataloader.iphone import IPhoneDataset as JIPhone
from holoagent_tpu.dataloader.replica import ReplicaDataset as JReplica
from holoagent_tpu.dataloader.scannet import ScannetDataset as JScannet
from holoagent_tpu_torch import config as tconfig
from holoagent_tpu_torch.apps.common import load_dataset
from holoagent_tpu_torch.dataloader import export, formats
from holoagent_tpu_torch.dataloader.generic import RGBDFrame
from holoagent_tpu_torch.dataloader.hm3dsem import HM3DSemDataset
from holoagent_tpu_torch.dataloader.horizon import HorizonDataset, read_flat_yaml
from holoagent_tpu_torch.dataloader.iphone import IPhoneDataset
from holoagent_tpu_torch.dataloader.replica import ReplicaDataset
from holoagent_tpu_torch.dataloader.scannet import ScannetDataset
from holoagent_tpu_torch.utils.geometry import exp_se3

QUAT_POSE_ATOL = 2e-6
H, W = 12, 16


def _frames(n=3, k=None, seed=0, depth_max=4.0):
    """Random frames: rgb in [0, 1], depth up to `depth_max` m (some past
    the loaders' cuts), camera-to-world poses exp(xi) of random twists."""
    import torch

    rng = np.random.default_rng(seed)
    k = export.hm3dsem_k(H, W) if k is None else k
    xi = rng.normal(0, 0.7, (n, 6)).astype(np.float32)
    poses = exp_se3(torch.from_numpy(xi)).numpy()
    return [RGBDFrame(rng.random((H, W, 3), np.float32), rng.uniform(0.2, depth_max, (H, W)).astype(np.float32),
                      poses[i], k) for i in range(n)]


def _assert_same(ds, jds, back, pose_atol=0.0):
    assert len(ds) == len(jds) == len(back)
    assert ds.frameId2imgPath == jds.frameId2imgPath
    for i in range(len(ds)):
        f, jf = ds[i], jds[i]
        for a, b in zip(f, jf):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(f.rgb, back[i].rgb)
        np.testing.assert_array_equal(f.depth, back[i].depth)
        np.testing.assert_array_equal(f.k, back[i].k)
        np.testing.assert_allclose(f.pose, back[i].pose, rtol=0, atol=pose_atol)
        if pose_atol == 0.0:
            np.testing.assert_array_equal(f.pose, back[i].pose)


def test_formats_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    for q in rng.normal(size=(5, 4)):
        np.testing.assert_array_equal(formats.quat_to_matrix(*q), jformats.quat_to_matrix(*q))
        r = formats.quat_to_matrix(*q)
        back = formats.quat_to_matrix(*export.matrix_to_quat(r))
        np.testing.assert_allclose(back, r, atol=1e-12)
    np.testing.assert_array_equal(formats.Y_UP_TO_Z_UP, jformats.Y_UP_TO_Z_UP)
    rows = np.c_[rng.permutation(6).astype(np.float64) * 0.5, rng.normal(size=(6, 7))]
    np.savetxt(tmp_path / "t.txt", rows)
    for order in ("xyzw", "wxyz"):
        for invert in (False, True):
            p, ts = formats.load_tum_poses(tmp_path / "t.txt", order, invert)
            jp, jts = jformats.load_tum_poses(tmp_path / "t.txt", order, invert)
            np.testing.assert_array_equal(p, jp)
            assert ts == jts == sorted(ts)
    (tmp_path / "d").mkdir()
    for n in ("b.PNG", "a.jpg", "c.txt", "0.jpeg"):
        (tmp_path / "d" / n).write_text("")
    assert formats.sorted_files(tmp_path / "d") == jformats.sorted_files(tmp_path / "d")
    assert formats.sorted_files(tmp_path / "none") == []


def _hm3dsem(root):
    frames = _frames()
    sem = [np.arange(H * W).reshape(H, W) % (7 + i) for i in range(3)]
    back = export.write_hm3dsem(root, frames, semantic=sem)
    return HM3DSemDataset(str(root.parent), root.name), JHM3DSem(str(root.parent), root.name), back, 0.0


def _replica(root):
    k = np.array([[11.0, 0, 7.5], [0, 11.5, 5.5], [0, 0, 1]], np.float32)
    back = export.write_replica(root, _frames(k=k, depth_max=12.0), depth_cut=8.0)
    return ReplicaDataset(str(root), depth_cut=8.0), JReplica(str(root), depth_cut=8.0), back, 0.0


def _replica_parent_params(root):
    """cam_params.json beside the scene directory, not in it."""
    k = np.array([[12.0, 0, 7.5], [0, 12.0, 5.5], [0, 0, 1]], np.float32)
    back = export.write_replica(root, _frames(k=k, depth_max=12.0))
    (root / "cam_params.json").rename(root.parent / "cam_params.json")
    return ReplicaDataset(str(root)), JReplica(str(root)), back, 0.0


def _replica_default_k(root):
    back = export.write_replica(root, _frames(k=export.REPLICA_DEFAULT_K, depth_max=12.0), cam_params=False)
    return ReplicaDataset(str(root)), JReplica(str(root)), back, 0.0


def _horizon_poses(root):
    k = np.array([[380.0, 0, 320.0], [0, 381.25, 240.0], [0, 0, 1]], np.float32)
    back = export.write_horizon(root, _frames(k=k, depth_max=12.0))
    return HorizonDataset(str(root)), JHorizon(str(root)), back, QUAT_POSE_ATOL


def _horizon_trajectory(root):
    k = np.array([[20.0, 0, 8.0], [0, 20.0, 6.0], [0, 0, 1]], np.float32)
    back = export.write_horizon(root, _frames(k=k), trajectory="CameraTrajectory", depth_cut=3.0)
    return HorizonDataset(str(root), depth_cut=3.0), JHorizon(str(root), depth_cut=3.0), back, QUAT_POSE_ATOL


def _scannet(root, ext):
    k = np.array([[13.0, 0, 7.0], [0, 13.0, 5.0], [0, 0, 1]], np.float32)
    back = export.write_scannet(root, _frames(k=k), ext=ext)
    (root / "pose" / "999999.txt").write_text(" ".join(["1"] * 16))  # a pose without frames: cut off
    return ScannetDataset(str(root)), JScannet(str(root)), back, 0.0


def _iphone_odometry(root):
    k = np.array([[14.0, 0, 8.0], [0, 14.0, 6.0], [0, 0, 1]], np.float32)
    back = export.write_iphone(root, _frames(k=k))
    return IPhoneDataset(str(root)), JIPhone(str(root)), back, QUAT_POSE_ATOL


def _iphone_poses(root):
    k = np.array([[14.0, 0, 8.0], [0, 14.0, 6.0], [0, 0, 1]], np.float32)
    frames = _frames(k=k)
    back = export.write_iphone(root, frames)
    (root / "odometry.csv").unlink()
    rows = [[0.1 * i, *f.pose[:3, 3].astype(np.float64), *export.matrix_to_quat(f.pose[:3, :3].astype(np.float64))]
            for i, f in enumerate(frames)]
    np.savetxt(root / "poses.txt", np.asarray(rows))
    return IPhoneDataset(str(root)), JIPhone(str(root)), back, QUAT_POSE_ATOL


LAYOUTS = {
    "hm3dsem": _hm3dsem, "replica": _replica, "replica_parent_params": _replica_parent_params,
    "replica_default_k": _replica_default_k,
    "horizon_poses": _horizon_poses, "horizon_trajectory": _horizon_trajectory,
    "scannet_png": lambda r: _scannet(r, "png"), "scannet_jpg": lambda r: _scannet(r, "jpg"),
    "iphone_odometry": _iphone_odometry, "iphone_poses": _iphone_poses,
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loader_matches_jax(layout, tmp_path):
    root = tmp_path / "scene0"
    root.mkdir()
    ds, jds, back, pose_atol = LAYOUTS[layout](root)
    _assert_same(ds, jds, back, pose_atol)
    if layout == "hm3dsem":
        for i in range(len(ds)):
            s = ds.semantic(i)
            assert s.dtype == np.int32
            np.testing.assert_array_equal(s, jds.semantic(i))
            np.testing.assert_array_equal(s, np.arange(H * W).reshape(H, W) % (7 + i))
    if layout.startswith("horizon"):
        text = (root / "d435i.yaml").read_text()
        assert read_flat_yaml(text) == yaml.safe_load(text)


YAML_FIXTURES = (
    "Camera1.fx: 380.0\nCamera1.fy: 380.0\nCamera1.cx: 320.0\nCamera1.cy: 240.0\nCamera.width: 640\n"
    "Camera.height: 480\n",
    "%YAML 1.1\n---\n# ORB-SLAM style\nCamera.type: \"PinHole\"\nCamera.fx: 615.3  # focal\nCamera.fy: 615.25\n"
    "Camera.cx: 3.2e+2\nCamera.cy: .5\nCamera.k1: -1.2e-01\nCamera.RGB: 1\nCamera.bf: 40_000\n"
    "Camera.name: 'd435i'\nCamera.fps: ~\nCamera.sync: true\nCamera.note: 1e9\n",
    "Camera.fx: -.inf\nCamera.fy: +12\nCamera.cx: 0\nCamera.cy: off\n\n",
)


@pytest.mark.parametrize("i", range(len(YAML_FIXTURES)))
def test_flat_yaml_reader_equals_safe_load(i, tmp_path):
    text = YAML_FIXTURES[i]
    assert read_flat_yaml(text) == yaml.safe_load(text)
    (tmp_path / "d435i.yaml").write_text(text)
    if "Camera.fx" in text or "Camera1.fx" in text:
        k = HorizonDataset._load_intrinsics(tmp_path / "d435i.yaml")
        if np.isfinite(k).all():
            np.testing.assert_array_equal(k, JHorizon._load_intrinsics(tmp_path / "d435i.yaml"))


@pytest.mark.parametrize("name", ["horizon", "scannet", "hm3dsem", "replica"])
def test_load_dataset_branches(name, tmp_path):
    writer = {"horizon": _horizon_poses, "scannet": lambda r: _scannet(r, "png"), "hm3dsem": _hm3dsem,
              "replica": _replica}[name]
    root = tmp_path / "scene7"
    root.mkdir()
    _, jref, _, _ = writer(root)
    main = {"dataset": name, "dataset_path": str(tmp_path), "scene_id": "scene7", "depth_cut": 3.5}
    ds = load_dataset(tconfig.from_dict({"main": main}), "cpu")
    jds = jload_dataset(jconfig.from_dict({"main": main}))
    assert type(ds).__name__ == type(jds).__name__ == type(jref).__name__
    assert len(ds) == len(jds) == 3 and ds.frameId2imgPath == jds.frameId2imgPath
    for a, b in zip(ds[2], jds[2]):
        np.testing.assert_array_equal(a, b)
    assert float(ds[2].depth.max()) <= 3.5
    bad = {"main": {"dataset": "iphone"}}
    with pytest.raises(KeyError):
        load_dataset(tconfig.from_dict(bad), "cpu")
    with pytest.raises(KeyError):
        jload_dataset(jconfig.from_dict(bad))
