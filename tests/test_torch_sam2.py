"""SAM 2.1 (models/sam2.py) on the CPU: a tiny Hiera and its decoder held to
the benchmark's plain float32 reference (portbench/reference/sam2.py) on
seeded weights; the published Hiera-L's block table on the meta device;
the stage spans; the mapper's entry points with a SAM 2 segmenter.

Tolerances: the program and the reference compute the same float32
arithmetic in different orders (the program's attention in the wrapper's
plain version, its pooling by reshape, its patch embedding by a
convolution; the reference's by dense products through ``precision.mm``
and an unfold), so agreement is to float32 rounding carried through a few
layer norms: 2e-5 of the largest magnitude.
"""

import dataclasses

import pytest
import torch

from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.models import sam as sam_mod
from holoagent_tpu_torch.models import sam2 as sam2_mod
from holoagent_tpu_torch.utils.timing import StageTimer
from portbench import weights
from portbench.reference import sam2 as ref_sam2

torch.set_num_threads(1)
TINY = sam2_mod.VARIANTS["test-tiny-hiera"]
HIERA_L = sam2_mod.VARIANTS["sam2.1_hiera_l"]
RTOL = 2e-5  # of the largest magnitude: float32 rounding in another order (module docstring)


def _sizes(v):
    return ref_sam2.SAM2Sizes.of({f.name: getattr(v, f.name) for f in dataclasses.fields(v)
                                  if f.name != "name"})


@pytest.fixture(scope="module")
def tiny():
    """The tiny program and the reference's float32 parameters, from one
    seeded draw."""
    v = _sizes(TINY)
    vals = weights.make(ref_sam2.spec(v), 2**33 + 5, lambda n: torch.float32, torch.device("cpu"))
    m = sam2_mod.SAM2(TINY, dtype=torch.float32, device="cpu")
    weights.load_into(m, vals)
    frames = torch.rand((2, 48, 64, 3), generator=torch.Generator().manual_seed(3))
    return m, vals, v, frames


def _close(a, b):
    scale = float(b.abs().max())
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= RTOL * max(scale, 1.0), (float((a - b).abs().max()), scale)


def test_tiny_variant_shape():
    """embed 16, heads 1, stages [1, 2, 2, 1], windows [4, 2, 4, 2], one
    global block, image 128."""
    assert (TINY.embed_dim, TINY.num_heads, TINY.stages, TINY.window_spec, TINY.img_size) == (
        16, 1, (1, 2, 2, 1), (4, 2, 4, 2), 128)
    assert [b.window for b in sam2_mod.block_plan(TINY)].count(0) == 1


def test_preprocess_matches_reference(tiny):
    _, _, v, frames = tiny
    _close(sam2_mod.preprocess(frames, TINY.img_size), ref_sam2.preprocess(frames, v.img_size))


@pytest.mark.parametrize("stage", range(4))
def test_trunk_stage_outputs_match_reference(tiny, stage):
    m, vals, v, frames = tiny
    x = ref_sam2.preprocess(frames, v.img_size)
    got = sam2_mod.trunk(m.encoder, x)[stage]
    _close(got, ref_sam2.trunk(vals, v, x)[stage])


@pytest.mark.parametrize("level", range(3))
def test_neck_levels_match_reference(tiny, level):
    """The three levels the neck keeps (scalp 1), level 2 with level 3's
    top-down features."""
    m, vals, v, frames = tiny
    x = ref_sam2.preprocess(frames, v.img_size)
    got = sam2_mod.neck(m.encoder, sam2_mod.trunk(m.encoder, x), TINY)
    want = ref_sam2.neck(vals, v, ref_sam2.trunk(vals, v, x))
    assert len(got) == len(want) == 3
    _close(got[level], want[level])


@pytest.mark.parametrize("part", ["embedding", "feat_s0", "feat_s1"])
def test_image_features_match_reference(tiny, part):
    m, vals, v, frames = tiny
    i = ("embedding", "feat_s0", "feat_s1").index(part)
    got = m.image_features(frames)
    want = ref_sam2.image_features(vals, v, ref_sam2.preprocess(frames, v.img_size))
    for f in range(frames.shape[0]):
        _close(got[f][i], want[i][f])


@pytest.mark.parametrize("output", ["logits", "iou"])
def test_decoder_matches_reference(tiny, output, monkeypatch):
    """Every prompt of a 4 x 4 grid, decoded 8 a pass by the program (its
    batch of 64 scaled down to the tiny grid) and 5 a pass by the
    reference: the outputs are per prompt."""
    monkeypatch.setattr(sam2_mod, "POINTS_PER_BATCH", 8)
    m, vals, v, frames = tiny
    feats = m.image_features(frames[:1])[0]
    got = m.decode_grid(feats, 4)
    want = ref_sam2.decode_grid(vals, v, feats, 4, batch=5)
    i = ("logits", "iou").index(output)
    assert got[0].shape == (16, 4, 32, 32) and got[1].shape == (16, 4)
    _close(got[i], want[i])


def test_iou_is_a_sigmoid_and_object_score_is_computed(tiny):
    m, _, _, frames = tiny
    emb, s0, s1 = m.image_features(frames[:1])[0]
    sparse = sam_mod.grid_prompts(m.prompt, 2, emb.device)
    logits, iou, obj = sam2_mod.decode_masks(m, emb, s0, s1, sam_mod.image_pe(m.prompt, emb.shape[0]), sparse)
    assert bool(((iou > 0) & (iou < 1)).all()) and obj.shape == (4, 1) and logits.dtype == torch.float32


def test_generate_masks_end_to_end_matches_reference(tiny):
    """The extractor's mask stage (generate_masks, then the disjoint carve)
    gives what the reference's selection and carve give over the
    reference's decoder output."""
    from holoagent_tpu_torch.perception.extractor import _mask_stage
    from portbench.reference import imageops

    m, vals, v, frames = tiny
    masks_p, valid_p, boxes_p, nv = _mask_stage(m, frames[0], 4, -10.0, 0.0, 4.0, 8, "xla")
    feats = tuple(x[0] for x in ref_sam2.image_features(vals, v, ref_sam2.preprocess(frames[:1], v.img_size)))
    lo, iou = ref_sam2.decode_grid(vals, v, feats, 4)
    masks, valid, boxes = imageops.select_masks(lo, iou, (48, 64), -10.0, 0.0, 4.0, 8)
    assert int(nv) >= 1
    assert torch.equal(valid_p, valid) and torch.equal(masks_p, masks) and torch.equal(boxes_p, boxes)


# the published Hiera-L over a 1024 x 1024 frame: (window, Tq, Tk, windows x heads) per block
HIERA_L_TABLE = {0: (8, 64, 64, 1024 * 2), 1: (8, 64, 64, 1024 * 2), 2: (8, 16, 64, 1024 * 4),
                 3: (4, 16, 16, 1024 * 4), 7: (4, 16, 16, 1024 * 4), 8: (4, 4, 16, 1024 * 8),
                 9: (16, 256, 256, 16 * 8), 22: (16, 256, 256, 16 * 8), 23: (0, 4096, 4096, 8),
                 33: (0, 4096, 4096, 8), 43: (0, 4096, 4096, 8), 44: (16, 64, 256, 16 * 16),
                 45: (8, 64, 64, 16 * 16), 47: (8, 64, 64, 16 * 16)}


def test_hiera_l_block_table():
    plan = sam2_mod.block_plan(HIERA_L)
    assert len(plan) == 48 and [i for i, b in enumerate(plan) if b.pool] == [2, 8, 44]
    assert [i for i, b in enumerate(plan) if b.window == 0] == [23, 33, 43]
    assert {b.dim_out // b.heads for b in plan} == {72}
    assert [plan[e].dim_out for e in sam2_mod.stage_ends(HIERA_L)] == [144, 288, 576, 1152]
    for i, (win, _, _, _) in HIERA_L_TABLE.items():
        assert plan[i].window == win, i


@pytest.fixture(scope="module")
def hiera_l_on_meta():
    """The published Hiera-L's trunk and neck run on the meta device (shapes
    only), every attention call recorded: (q shape, k shape)."""
    calls = []

    def record(q, k, v, causal=False):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return torch.empty(q.shape, device=q.device, dtype=q.dtype)

    m = _on_meta()
    x = torch.empty((1, 1024, 1024, 3), device="meta")
    orig = sam2_mod.flash_attention_ref
    sam2_mod.flash_attention_ref = record
    try:
        levels = sam2_mod.trunk(m.encoder, x, impl="xla")
        feats = sam2_mod.neck(m.encoder, levels, HIERA_L)
    finally:
        sam2_mod.flash_attention_ref = orig
    return calls, levels, feats


def _on_meta():
    """The published SAM 2.1 Hiera-L built on the meta device (the model's
    device rule takes the card or the CPU; the meta device is for shapes)."""
    orig = sam2_mod.resolve
    sam2_mod.resolve = torch.device
    try:
        return sam2_mod.SAM2(HIERA_L, dtype=torch.bfloat16, device="meta")
    finally:
        sam2_mod.resolve = orig


@pytest.mark.parametrize("block", sorted(HIERA_L_TABLE))
def test_hiera_l_attention_shapes_on_meta(hiera_l_on_meta, block):
    calls, _, _ = hiera_l_on_meta
    assert len(calls) == 48
    win, tq, tk, wh = HIERA_L_TABLE[block]
    (b, h, q_len, d), (_, _, k_len, _) = calls[block]
    assert (q_len, k_len, b * h, d) == (tq, tk, wh, 72)


def test_hiera_l_stage_and_neck_shapes_on_meta(hiera_l_on_meta):
    _, levels, feats = hiera_l_on_meta
    assert [tuple(x.shape) for x in levels] == [(1, 256, 256, 144), (1, 128, 128, 288), (1, 64, 64, 576),
                                                (1, 32, 32, 1152)]
    assert [tuple(x.shape) for x in feats] == [(1, 256, 256, 256), (1, 128, 128, 256), (1, 64, 64, 256)]


def test_hiera_l_parameter_count():
    """About 0.22 B parameters: Hiera-L, the neck, the decoder."""
    m = _on_meta()
    n = sum(p.numel() for p in m.parameters())
    assert 2.1e8 < n < 2.3e8
    assert set(dict(m.named_parameters())) == set(ref_sam2.spec(_sizes(HIERA_L)))


def test_spans_nest_under_the_encoder(tiny):
    m, _, _, frames = tiny
    timer = StageTimer("cpu")
    sam_mod.generate_masks(m, frames[0], points_per_side=2, pred_iou_thresh=-10.0, stability_thresh=0.0,
                           max_masks=4, timer=timer)
    for name in ("mask.encoder.stage1", "mask.encoder.stage2", "mask.encoder.stage3", "mask.encoder.stage4",
                 "mask.encoder.neck"):
        assert timer.parent[name] == "mask.encoder" and timer.calls[name] == 1, name
    assert timer.parent["mask.encoder"] is None and timer.parent["mask.decoder"] is None


def _cfg(bsz=1):
    return from_dict({
        "main": {"frame_h": 48, "frame_w": 64, "depth_cut": 10.0},
        "models": {"clip": {"type": "test-tiny", "dtype": "float32"},
                   "sam": {"type": "test-tiny-hiera", "dtype": "float32", "points_per_side": 3,
                           "pred_iou_thresh": -10.0, "stability_score_thresh": 0.0,
                           "min_mask_region_area": 4, "max_masks": 6}},
        "pipeline": {"extract_impl": "flash", "extract_clip_impl": "flash", "extract_tiering": True,
                     "point_capacity": 65536, "mask_point_capacity": 512, "instance_capacity": 32,
                     "extract_frames_per_dispatch": bsz, "skip_frames": 1},
    })


def test_load_models_builds_sam2_by_type():
    from holoagent_tpu_torch.apps.common import load_models

    cfg = _cfg()
    _, sam, _, sv, _ = load_models(cfg, device="cpu")
    assert isinstance(sam, sam2_mod.SAM2) and sv is TINY
    assert sam2_mod.POINTS_PER_BATCH == 64  # SAM2AutomaticMaskGenerator's, whatever the config's points_per_batch
    cfg.models.sam.quant = True
    with pytest.raises(ValueError):
        load_models(cfg, device="cpu")


def test_mapper_runs_sam2_tiered_and_batched():
    """Mapper.run over 3 frames with SAM 2 as the segmenter, one keyframe a
    dispatch (tiered) and two (batched): the same masks and features."""
    from holoagent_tpu_torch.apps.common import load_models
    from holoagent_tpu_torch.dataloader.synthetic import SyntheticDataset
    from holoagent_tpu_torch.memory.mapping import Mapper

    ds = SyntheticDataset(seed=0, num_frames=6, hw=(48, 64))
    runs = []
    for bsz in (1, 2):
        cfg = _cfg(bsz)
        clip, sam, *_ = load_models(cfg, device="cpu")
        mapped = Mapper(cfg, clip, sam, "cpu").run([ds[i] for i in range(3)])
        runs.append(mapped)
    a, b = runs
    assert int(a.scene.count.sum()) > 0
    assert torch.equal(a.scene.key, b.scene.key) and torch.equal(a.scene.count, b.scene.count)
    torch.testing.assert_close(a.scene.sum_feat, b.scene.sum_feat, atol=1e-5, rtol=1e-5)
