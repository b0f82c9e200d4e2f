"""The CLIP text side against the JAX package: the tokenizer's ids, the text
tower (weights carried over by bridge.py), the multi-template features, the
label vocabularies and their cache, the towers of apps.common, and the
config loader.

Tolerances: token ids exact; the text tower in bf16 (the reference's compute
dtype for text features) to cosine >= 0.999 per row; in float32 within 2e-5.
On the CPU the tower's causal attention takes K2's plain version, so no
kernel launches.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holoagent_tpu import config as jconfig
from holoagent_tpu.models import clip as jclip
from holoagent_tpu.models.tokenizer import SimpleTokenizer as JTokenizer
from holoagent_tpu.utils import labels as jlabels
from holoagent_tpu_torch import bridge
from holoagent_tpu_torch import config as tconfig
from holoagent_tpu_torch.apps.common import load_dataset, load_models, tokenizer
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models.tokenizer import SimpleTokenizer
from holoagent_tpu_torch.ops import flash_attention as tfa
from holoagent_tpu_torch.utils import labels as tlabels

torch.set_num_threads(1)

ASCII = ["a photo of a chair in the scene.", "find the sofa in the living room", "Mirror, 2nd floor!",
         "go to   the kitchen sink", "it's the TV's remote", "room 101 &amp; hallway", ""]
CHINESE = ["去一楼的厨房找椅子", "在卧室里找台灯", "带我去沙发", "浴室 mirror 二楼"]
COS_BF16 = 0.999  # bf16 tower: the port's linear layers round once after the bias (ROADMAP.md)


@pytest.fixture(scope="module")
def towers():
    variant = tclip.VARIANTS["test-tiny"]
    params = jclip.init_clip(jax.random.key(0), jclip.VARIANTS["test-tiny"])
    text = bridge.clip_text_from_jax(jax.tree.map(np.asarray, params), variant, device="cpu")
    return params, text


@pytest.mark.parametrize("texts", [ASCII, CHINESE], ids=["ascii", "chinese"])
def test_tokenizer_ids_exact(texts):
    tok, jtok = SimpleTokenizer(), JTokenizer()
    np.testing.assert_array_equal(tok(texts), jtok(texts))
    for t in texts:
        assert tok.encode(t) == jtok.encode(t)
        assert tok.decode(tok.encode(t)) == jtok.decode(jtok.encode(t))
    long = " ".join(["word"] * 100)  # truncated with <eot> kept
    np.testing.assert_array_equal(tok(long), jtok(long))


def _rows_cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def test_encode_text_bf16(towers):
    params, text = towers
    tokens = JTokenizer()(ASCII + CHINESE)
    n = tfa.flash_attention.launches
    got = tclip.encode_text(text, torch.from_numpy(tokens), dtype=torch.bfloat16)
    assert tfa.flash_attention.launches == n
    want = jclip.encode_text(params, jnp.asarray(tokens), jclip.VARIANTS["test-tiny"])
    assert got.dtype == torch.float32 and got.shape == (len(tokens), 32)
    assert _rows_cosine(got.numpy(), want).min() >= COS_BF16


def test_encode_text_float32(towers):
    params, text = towers
    tokens = JTokenizer()(ASCII)
    got = tclip.encode_text(text, torch.from_numpy(tokens), impl="xla")
    want = jclip.encode_text(params, jnp.asarray(tokens), jclip.VARIANTS["test-tiny"], dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(tclip.encode_text(text, torch.from_numpy(tokens)).numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("templates,batch", [("TEMPLATES", 256), ("EXTENDED_TEMPLATES", 256), ("TEMPLATES", 16)])
def test_text_features_multi_template(towers, templates, batch):
    params, text = towers
    labels = list(jlabels.SCANNET_LABELS_20[:9]) + ["厨房"]
    got = tclip.text_features_multi_template(text, SimpleTokenizer(), labels, getattr(tclip, templates),
                                             batch_size=batch)
    want = jclip.text_features_multi_template(params, JTokenizer(), labels, jclip.VARIANTS["test-tiny"],
                                              getattr(jclip, templates), batch_size=batch)
    assert got.shape == (len(labels), 32)
    assert _rows_cosine(got.numpy(), want).min() >= COS_BF16


def test_text_batches_are_padded_to_one_shape(towers, monkeypatch):
    """Every text launch has the (256, ctx) shape whatever the number of
    prompts, as the reference pads its chunks."""
    _, text = towers
    shapes = []
    real = tclip.encode_text
    monkeypatch.setattr(tclip, "encode_text", lambda t, tok, **kw: shapes.append(tuple(tok.shape)) or real(t, tok, **kw))
    tclip.text_features_multi_template(text, SimpleTokenizer(), ["chair"] * 130)  # 260 prompts
    assert shapes == [(256, 77), (256, 77)]


def test_init_clip_and_load_models():
    variant = tclip.VARIANTS["test-tiny"]
    visual, text = tclip.init_clip(variant, seed=3, device="cpu")
    ref = tclip.init_clip_visual(variant, seed=3, device="cpu")
    for (name, a), (_, b) in zip(visual.named_parameters(), ref.named_parameters()):
        assert torch.equal(a, b), name
    assert text.tok_emb.shape == (variant.vocab, variant.t_width) and len(text.blocks) == variant.t_layers
    assert 0.015 < text.tok_emb.std().item() < 0.025 and 0.007 < text.pos.std().item() < 0.013
    cfg = tconfig.from_dict({"main": {"seed": 3}, "models": {
        "clip": {"type": "test-tiny", "dtype": "float32", "quant": True}, "sam": {"type": "test-tiny", "dtype": "float32"}}})
    clip, sam, cv, sv, text2 = load_models(cfg, device="cpu")
    assert clip.quant and not hasattr(text2, "blocks_q8") and text2.tok_emb.dtype == torch.float32
    for (name, a), (_, b) in zip(text.named_parameters(), text2.named_parameters()):
        assert torch.equal(a, b), name


def test_load_dataset_and_tokenizer():
    from holoagent_tpu.apps.common import load_dataset as jload_dataset

    main = {"layout": "three_room", "num_frames": 6, "frame_h": 24, "frame_w": 32}
    ds, jds = load_dataset(tconfig.from_dict({"main": main})), jload_dataset(jconfig.from_dict({"main": main}))
    assert len(ds) == len(jds) > 0 and ds[0].rgb.shape == (24, 32, 3)
    for a, b in zip(ds[len(ds) - 1], jds[len(ds) - 1]):
        np.testing.assert_array_equal(a, b)
    assert isinstance(tokenizer(), SimpleTokenizer)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_dataset(tconfig.from_dict({"main": {"dataset": "scannet"}}))


def test_vocabularies_and_label_cache(towers, tmp_path):
    params, text = towers
    for name in ("SCANNET20", "scannet200", "MATTERPORT40", "HM3D", "ROOM_TYPES"):
        assert tlabels.load_vocabulary(name) == jlabels.load_vocabulary(name)
    assert tlabels.OBJECT_ROOM_AFFINITY == jlabels.OBJECT_ROOM_AFFINITY
    assert tlabels.DEFAULT_ROOM_TYPES == jlabels.DEFAULT_ROOM_TYPES
    for name in ("FIXTURE", "HM3DSEM"):  # the data-asset vocabularies are not ported
        with pytest.raises(KeyError):
            tlabels.load_vocabulary(name)
    (tmp_path / "mine.csv").write_text("name,id\nlamp,1\nrug,2\n")
    (tmp_path / "list.json").write_text(json.dumps(["a", "b"]))
    for name in ("mine", "list"):
        assert tlabels.load_vocabulary(name, tmp_path) == jlabels.load_vocabulary(name, tmp_path)
    with pytest.raises(FileNotFoundError):
        tlabels.load_vocabulary("absent", tmp_path)
    feats, classes = tlabels.get_label_feats(text, SimpleTokenizer(), "SCANNET20", cache_dir=tmp_path / "c")
    jfeats, _ = jlabels.get_label_feats(params, JTokenizer(), jclip.VARIANTS["test-tiny"], "SCANNET20",
                                        cache_dir=tmp_path / "j")
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert feats.shape == (21, 32) and feats.dtype == np.float32
    assert _rows_cosine(feats, jfeats).min() >= COS_BF16
    n = tfa.flash_attention.launches
    cached, _ = tlabels.get_label_feats(text, None, "SCANNET20", cache_dir=tmp_path / "j")  # the JAX cache, no tokenizing
    np.testing.assert_array_equal(cached, np.asarray(jfeats))
    assert tfa.flash_attention.launches == n


def test_config_load_and_overrides(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({"main": {"scene_id": "s1"}, "pipeline": {"room_types": ["kitchen"]}}))
    ovs = ["pipeline.skip_frames=4", "main.save_path=/x/y", "pipeline.extract_tiering=true", "models.clip.type=ViT-L-14"]
    got, want = tconfig.load(p, ovs), jconfig.load(p, ovs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pipeline.skip_frames == 4 and got.pipeline.room_types == ("kitchen",)
    yaml_cfg = "config/synthetic_tpu_3room.yaml"
    assert dataclasses.asdict(tconfig.load(yaml_cfg)) == dataclasses.asdict(jconfig.load(yaml_cfg))
