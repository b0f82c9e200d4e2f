"""The fixture-tower zoo, cachekey, the neural row and the correctness
suite's configuration in the port, against the JAX package: npz towers
both ways, the port's own cache (never the JAX package's), machine_key on
torch's version, run_one(perception="neural") on one short walk with the
same towers in both packages, correctness_config field for field."""

import dataclasses
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu.apps import correctness_suite as jsuite
from holoagent_tpu.apps import eval_protocol as jeval
from holoagent_tpu.eval import metrics as jmetrics
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models import sam as jsam
from holoagent_tpu.training import zoo as jzoo
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch.apps import correctness_suite as tsuite
from holoagent_tpu_torch.apps import eval_protocol as teval
from holoagent_tpu_torch.dataloader.synthetic import SyntheticDataset, SyntheticScene
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.training import perception as tperc
from holoagent_tpu_torch.training import zoo as tzoo
from holoagent_tpu_torch.utils import cachekey

CV, SV = "test-tiny", "fixture-tiny"


def _features(visual, text, sam, seed=0):
    """Image, text and SAM features of the port's towers on seeded inputs."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 400, (3, 77)).astype(np.int32)
    x = rng.normal(size=(1, 128, 128, 3)).astype(np.float32)
    return (imgs, toks, x), (
        tclip.encode_image(visual, torch.from_numpy(imgs)).numpy(),
        tclip.encode_text(text, torch.from_numpy(toks), dtype=torch.float32).numpy(),
        tsam.encode_image(sam.encoder, torch.from_numpy(x), sam.variant).numpy(),
    )


def _jax_features(clip_params, sam_params, inputs):
    imgs, toks, x = inputs
    cv, sv = jclip.VARIANTS[CV], jsam.VARIANTS[SV]
    return (np.asarray(jclip.encode_image(clip_params, jnp.asarray(imgs), cv, dtype=jnp.float32)),
            np.asarray(jclip.encode_text(clip_params, jnp.asarray(toks), cv, dtype=jnp.float32)),
            np.asarray(jsam.encode_image(sam_params["encoder"], jnp.asarray(x), sv, dtype=jnp.float32)))


def test_jax_npz_loads_into_the_port(tmp_path, monkeypatch):
    """JAX save_params files under the zoo's names: fixture_towers(cache_dir)
    serves them without training, as towers that encode what the JAX towers
    encode."""
    clip_p = jclip.init_clip(jax.random.key(4), jclip.VARIANTS[CV], dtype=jnp.float32)
    sam_p = jsam.init_sam(jax.random.key(5), jsam.VARIANTS[SV], dtype=jnp.float32)
    clip_path, sam_path, _ = tzoo.cache_paths(3000, 6000, 0, tmp_path)
    jzoo.save_params(clip_path, clip_p)
    jzoo.save_params(sam_path, sam_p)
    monkeypatch.setattr(tperc, "train_tiny_clip", None)  # a load must not train
    clip, sam = tzoo.fixture_towers(cache_dir=tmp_path, device="cpu")
    assert clip.visual.impl == clip.text.impl == "xla"
    assert clip.logit_scale.item() == pytest.approx(float(clip_p["logit_scale"]))
    inputs, got = _features(clip.visual, clip.text, sam)
    for a, b in zip(got, _jax_features(clip_p, sam_p, inputs)):
        assert np.abs(a - b).max() <= 1e-5


def test_port_npz_loads_into_jax(tmp_path):
    """A tower the port trained (a few steps, so no init value survives),
    saved by the zoo, through the JAX package's load_params."""
    ds = [SyntheticDataset(scene=SyntheticScene.two_room(), num_frames=2, hw=(120, 160), seed=100,
                           gaze_heights=(0.8, 2.2))]
    clip, _ = tperc.train_tiny_clip(ds, ds[0].scene.labels(), steps=3, device="cpu")
    sam, _ = tperc.train_tiny_sam(ds, steps=3, variant_name=SV, device="cpu")
    tzoo.save_params(tmp_path / "clip.npz", bridge.clip_to_numpy(clip.visual, clip.text, clip.logit_scale))
    tzoo.save_params(tmp_path / "sam.npz", bridge.sam_to_numpy(sam))
    clip_p, sam_p = jzoo.load_params(tmp_path / "clip.npz"), jzoo.load_params(tmp_path / "sam.npz")
    assert isinstance(sam_p["encoder"]["blocks"], list)
    assert float(clip_p["logit_scale"]) == pytest.approx(clip.logit_scale.item())
    inputs, got = _features(clip.visual, clip.text, sam)
    for a, b in zip(got, _jax_features(clip_p, sam_p, inputs)):
        assert np.abs(a - b).max() <= 1e-5
    back = tzoo.load_params(tmp_path / "sam.npz")
    assert bridge.flatten(back).keys() == bridge.flatten(bridge.sam_to_numpy(sam)).keys()


def test_the_port_caches_apart_from_the_jax_package(tmp_path, monkeypatch):
    """The port's default cache is its own and machine-keyed; a path under
    the JAX package's cache is refused; a cached recipe loads back equal."""
    assert tzoo.DEFAULT_CACHE.resolve() != Path(jzoo.DEFAULT_CACHE).resolve()
    assert tzoo.DEFAULT_CACHE == Path(tempfile.gettempdir()) / "holoagent_tpu_torch" / "towers"
    assert tzoo.JAX_CACHE == Path(jzoo.DEFAULT_CACHE)
    assert not tzoo.DEFAULT_CACHE.resolve().is_relative_to(Path(jzoo.DEFAULT_CACHE).resolve())
    with pytest.raises(ValueError, match="JAX package"):
        tzoo.save_params(Path(jzoo.DEFAULT_CACHE) / "clip_x.npz", {"a": np.zeros(2)})
    monkeypatch.setattr(tzoo, "DEFAULT_CACHE", tmp_path / "towers")
    monkeypatch.setattr(tzoo, "_fixture_datasets", lambda: [SyntheticDataset(
        scene=SyntheticScene.three_room(), num_frames=2, hw=(120, 160), seed=101, gaze_heights=(0.8, 2.2))])
    clip, sam = tzoo.fixture_towers(steps_clip=2, steps_sam=2, device="cpu")
    key_dir = tmp_path / "towers" / cachekey.machine_key("cpu")
    assert sorted(p.name for p in key_dir.iterdir()) == [
        f"{k}_{tzoo.RECIPE_TAG}_c2_s2_seed0.{e}" for k, e in (("clip", "npz"), ("meta", "json"), ("sam", "npz"))]
    monkeypatch.setattr(tperc, "train_tiny_sam", None)
    clip2, sam2 = tzoo.fixture_towers(steps_clip=2, steps_sam=2, device="cpu")
    for a, b in ((clip.visual, clip2.visual), (clip.text, clip2.text), (sam, sam2)):
        assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_machine_key_reads_torch_not_jax(monkeypatch, tmp_path):
    key = cachekey.machine_key()
    monkeypatch.setattr(jax, "__version__", "0.0.0")
    assert cachekey.machine_key() == key
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    assert cachekey.machine_key() != key
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    d = Path(cachekey.machine_cache_dir("zoo_probe"))
    assert d.is_dir() and d.parent == tmp_path / "holoagent_tpu_torch"
    assert d.name == f"zoo_probe-{cachekey.machine_key()}"


@pytest.mark.parametrize("layout", ["three_room", "two_floor"])
def test_correctness_config_field_for_field(layout, tmp_path):
    want = jsuite.correctness_config(layout, str(tmp_path))
    got = tsuite.correctness_config(layout, str(tmp_path))
    for section in ("main", "pipeline", "serving"):
        w, g = getattr(want, section), getattr(got, section)
        for f in dataclasses.fields(w):
            assert getattr(g, f.name) == getattr(w, f.name), (section, f.name)
    for tower in ("clip", "sam", "vlm"):
        w, g = getattr(want.models, tower), getattr(got.models, tower)
        for f in dataclasses.fields(w):
            assert getattr(g, f.name) == getattr(w, f.name), (tower, f.name)
    out = tmp_path / "suite"
    with pytest.raises(ValueError, match="records"):
        tsuite.run_suite(merge_into=str(tsuite.REPO_RESULTS), out_dir=str(out), device="cpu")
    assert not out.exists()


FRAMES = 3


class _Prefix:
    """The first `n` frames of a synthetic walk, as the trainers read one."""

    def __init__(self, ds, n):
        self.ds, self.n, self.scene, self.poses = ds, n, ds.scene, ds.poses[:n]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]

    def gt(self, i):
        return self.ds.gt(i)


def test_neural_row_matches_reference(monkeypatch):
    """run_one(perception="neural") over a 3-frame two_room walk in both
    packages with the same towers (trained briefly by the port on the walk's
    own frames, so masks pass the row's gates; carried to JAX through the
    bridge's trees): the confusion matrix equal, every metric within 1e-6."""
    walk = SyntheticDataset(scene=SyntheticScene.two_room(), num_frames=teval.LAYOUTS["two_room"][2],
                            hw=(240, 320), seed=0, gaze_heights=(0.8, 2.2))
    ds = [_Prefix(walk, FRAMES)]
    clip, _ = tperc.train_tiny_clip(ds, walk.scene.labels(), steps=60, device="cpu")
    sam, _ = tperc.train_tiny_sam(ds, steps=300, variant_name=SV, lr=2e-3, device="cpu")
    clip_tree = jax.tree.map(jnp.asarray, bridge.clip_to_numpy(clip.visual, clip.text, clip.logit_scale))
    sam_tree = jax.tree.map(jnp.asarray, bridge.sam_to_numpy(sam))
    for mod in (jeval, teval):
        monkeypatch.setitem(mod.LAYOUTS, "two_room", mod.LAYOUTS["two_room"][:2] + (FRAMES,))
    confs = {}

    def recording(name, fn):
        def seg(conf):
            confs[name] = conf.copy()
            return fn(conf)
        return seg

    monkeypatch.setattr(jmetrics, "segmentation_metrics", recording("jax", jmetrics.segmentation_metrics))
    monkeypatch.setattr(teval, "segmentation_metrics", recording("port", teval.segmentation_metrics))
    want = jeval.run_one(0, layout="two_room", perception="neural", towers=(clip_tree, sam_tree))
    got = teval.run_one(0, layout="two_room", perception="neural", towers=(clip, sam), device="cpu")
    assert np.array_equal(confs["jax"], confs["port"]) and confs["port"].sum() > 0
    fw, fg = bridge.flatten(want), bridge.flatten(got)
    assert fw.keys() == fg.keys()
    for k in fw:
        if np.asarray(fw[k]).dtype.kind in "fiub":
            assert np.allclose(np.asarray(fg[k], np.float64), np.asarray(fw[k], np.float64), rtol=0, atol=1e-6), k
        else:
            assert np.array_equal(fg[k], fw[k]), k
    assert got["objects"]["num_pred"] > 0
