"""The plain reference against the program at the test-tiny variants, on
the CPU in float32, where the program's kernels take their plain
versions: the two must compute the same functions from the same seeded
weights."""

import numpy as np
import pytest
import torch

from portbench import walk, weights
from portbench.reference import clip as ref_clip
from portbench.reference import imageops
from portbench.reference import instances as ref_inst
from portbench.reference import sam as ref_sam
from portbench.reference import scene as ref_scene

from holoagent_tpu_torch.memory import scene as scene_mod  # noqa: E402
from holoagent_tpu_torch.models import clip as clip_mod  # noqa: E402
from holoagent_tpu_torch.models import sam as sam_mod  # noqa: E402
from holoagent_tpu_torch.ops.backproject import backproject  # noqa: E402
from holoagent_tpu_torch.ops.voxel import GridSpec  # noqa: E402
from holoagent_tpu_torch.perception import extractor  # noqa: E402
from holoagent_tpu_torch.utils.camera import Pinhole  # noqa: E402

CPU = torch.device("cpu")
SV = ref_sam.SAMSizes(64, 16, 64, 2, 2, (1,), 2, 32, 32, 2, 2, 64, 4)
CV = ref_clip.CLIPSizes(32, 8, 64, 2, 4, 64, 2, 4, 32)


def _sam(seed=3):
    vals = weights.make(ref_sam.spec(SV), seed, lambda n: torch.float32, CPU)
    sam = sam_mod.SAM(sam_mod.VARIANTS["test-tiny"], dtype=torch.float32, device="cpu")
    weights.load_into(sam, vals)
    return sam, vals


def _clip(seed=4):
    vals = weights.make(ref_clip.visual_spec(CV), seed, lambda n: torch.float32, CPU)
    clip = clip_mod.CLIPVisual(clip_mod.VARIANTS["test-tiny"], dtype=torch.float32, device="cpu", impl="flash")
    weights.load_into(clip, vals)
    return clip, vals


def _image(seed=0, hw=(48, 64)):
    return torch.from_numpy(np.random.default_rng(seed).random((*hw, 3), dtype=np.float32))


def test_spec_names_match_the_program():
    _clip()
    sam, vals = _sam()
    with pytest.raises(ValueError, match="missing"):
        weights.load_into(sam, {k: v for k, v in vals.items() if k != "encoder.pos"})


def test_weights_are_seeded():
    a = weights.make(ref_sam.spec(SV), 7, lambda n: torch.float32, CPU)
    b = weights.make(ref_sam.spec(SV), 7, lambda n: torch.float32, CPU)
    c = weights.make(ref_sam.spec(SV), 8, lambda n: torch.float32, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.patch_w"], c["encoder.patch_w"])
    bf = weights.make(ref_sam.spec(SV), 7, lambda n: torch.bfloat16, CPU)
    assert torch.equal(bf["encoder.patch_w"].float(), a["encoder.patch_w"].bfloat16().float())


def test_sam_matches_the_program():
    sam, vals = _sam()
    img = _image()
    x = sam_mod.preprocess(img[None], SV.img_size)
    assert torch.allclose(ref_sam.preprocess(img[None], SV.img_size), x, atol=1e-6)
    emb = sam_mod.encode_image(sam.encoder, x, sam.variant, impl="flash")[0]
    emb_r = ref_sam.encode_image(vals, SV, x)[0]
    assert torch.allclose(emb_r, emb, atol=1e-5, rtol=1e-4)
    logits, iou = sam_mod._decode_grid(sam, emb, 4)
    logits_r, iou_r = ref_sam.decode_grid(vals, SV, emb, 4)
    assert torch.allclose(logits_r, logits, atol=1e-4, rtol=1e-4)
    assert torch.allclose(iou_r, iou, atol=1e-5, rtol=1e-4)


def test_mask_selection_matches_the_program():
    sam, _ = _sam(11)
    img = _image(1)
    emb = sam_mod.encode_image(sam.encoder, sam_mod.preprocess(img[None], 64), sam.variant)[0]
    logits, iou = sam_mod._decode_grid(sam, emb, 4)
    gen = sam_mod._masks_from_embedding(sam, emb, (48, 64), 4, -10.0, 0.0, 4.0, 0.7, 8, None, None)
    masks, valid, boxes, _ = extractor._carve(gen)
    m_r, v_r, b_r = imageops.select_masks(logits, iou, (48, 64), -10.0, 0.0, 4.0, 8)
    assert bool(valid.any())
    assert torch.equal(m_r, masks) and torch.equal(v_r, valid) and torch.equal(b_r, boxes)


def test_clip_stage_matches_the_program():
    clip, vals = _clip()
    sam, _ = _sam(12)
    img = _image(2)
    gen = sam_mod.generate_masks(sam, img, points_per_side=4, pred_iou_thresh=-10.0, stability_thresh=0.0,
                                 min_area=4.0, max_masks=8)
    masks, valid, boxes, n = extractor._carve(gen)
    for tier in (int(n), 8):
        f_p, f_g = extractor._clip_stage(clip, img, masks, valid, boxes, tier, 0.4418, 50.0, "flash")
        stack, sel, vt = ref_clip.crop_stack(CV, img, masks, valid, boxes, 8, 50.0)
        r_p, r_g = ref_clip.fuse(ref_clip.encode_image(vals, CV, stack), sel, vt, 8, 0.4418)
        assert torch.allclose(r_g, f_g, atol=1e-5)
        assert torch.allclose(r_p[valid], f_p[valid], atol=1e-5)  # the crop tier changes no valid mask's feature


def test_scene_fold_matches_the_program():
    rgb, depth, poses, k = walk.load(6, (48, 64))
    grid = GridSpec.centered(0.05)
    sc = scene_mod.init_scene(grid, 1 << 14, 8, CPU)
    gen = torch.Generator().manual_seed(0)
    frames = []
    for i in range(6):
        d, c, pose = torch.from_numpy(depth[i]), torch.from_numpy(rgb[i]), torch.from_numpy(poses[i])
        pts, cols, ok = backproject(d, c, Pinhole.from_matrix(k), pose, 1e-3, 10.0)
        sc, rows = scene_mod.insert_points(sc, pts, cols, ok, fcap=300)  # small enough to drop voxels
        masks = torch.rand(4, 48 * 64, generator=gen) > 0.6
        mv = torch.tensor([True, False, True, True])
        fm = torch.nn.functional.normalize(torch.randn(4, 8, generator=gen), dim=-1)
        sc = scene_mod.fuse_pixel_features(sc, rows, masks, mv, fm)
        frames.append(dict(depth=d, pose=pose, k=k, masks=masks.reshape(4, 48, 64), valid=mv, f_masks=fm))
    ref = ref_scene.fold(frames, 0.05, 10.0, 300)
    occ = sc.count > 0
    out = ref_scene.compare(ref, sc.key[occ], sc.count[occ], sc.sum_feat[occ], sc.feat_count[occ])
    assert out["scene_rows_differing"] == 0
    assert out["scene_feat_gap"] < 1e-5
    # a scene that stopped folding after its first frame differs
    first = ref_scene.fold(frames[:1], 0.05, 10.0, 300)
    bad = ref_scene.compare(ref, first["key"].int(), first["count"].float(), first["feat"].float(),
                            first["feat_count"].float())
    assert bad["scene_rows_differing"] > 0


@pytest.mark.parametrize("mode", ["int4"])
def test_lowered_precision_moves_the_reference(mode):
    from portbench.reference import precision

    _, vals = _clip()
    x = ref_clip.crop_stack(CV, _image(3), torch.zeros((1, 48, 64), dtype=torch.bool), torch.zeros(1, dtype=torch.bool),
                            torch.zeros((1, 4)), 1, 50.0)[0]
    f = ref_clip.encode_image(vals, CV, x)
    with precision.lowered(mode):
        g = ref_clip.encode_image(vals, CV, x)
    assert float((1 - (f * g).sum(-1)).max()) > 1e-5
    assert torch.equal(ref_clip.encode_image(vals, CV, x), f)  # the mode is restored


def _instance_walk(skip_merges=False):
    """The program's paired instance fold over six frames of the walk, with
    four masks a frame cut as slabs of the room along x, so that each
    frame's instances meet the last frames' (merges skipped on request),
    and the same frames as the reference takes them."""
    from holoagent_tpu_torch.memory import instances as inst_mod

    rgb, depth, poses, k = walk.load(6, (48, 64))
    grid = GridSpec.centered(0.05)
    sc = scene_mod.init_scene(grid, 1 << 14, 8, CPU)
    inst = inst_mod.empty_instances(32, 2048, 8, CPU)
    gen = torch.Generator().manual_seed(1)
    base = torch.nn.functional.normalize(torch.randn(4, 8, generator=gen), dim=-1)
    ot = 2.0 if skip_merges else 0.75
    kw = dict(bbox_pad=0.025, coarse_only=True, max_extent=1e9)
    frames = []
    for i in range(6):
        d, c, pose = torch.from_numpy(depth[i]), torch.from_numpy(rgb[i]), torch.from_numpy(poses[i])
        pts, cols, ok = backproject(d, c, Pinhole.from_matrix(k), pose, 1e-3, 10.0)
        sc, rows = scene_mod.insert_points(sc, pts, cols, ok, fcap=3000)
        edges = torch.tensor([-1e9, -1.0, 0.0, 1.0, 1e9])
        masks = torch.stack([ok & (pts[:, 0] >= edges[j]) & (pts[:, 0] < edges[j + 1]) for j in range(4)])
        mv = torch.tensor([True, True, False, True])
        fm = torch.nn.functional.normalize(base + 0.1 * torch.randn(4, 8, generator=gen), dim=-1)
        finst = inst_mod.frame_instances(masks, mv, fm, rows, pts, min_rows=3, k_cap=2048, stride=2, grid=grid)
        inst = inst_mod.paired_merge_step(inst, finst, ot, 0.05, **kw)
        if i % 4 == 3:
            inst = inst_mod.merge_round(inst, ot, 0.05, out_cap=32, **kw)
        r_pts, r_key = ref_scene.frame_points(d, pose, k, 0.05, 10.0)
        frames.append(dict(masks=masks, valid=mv, f_masks=fm, rows=rows, keys=r_key, pts=r_pts))
    inst = inst_mod.merge_round(inst, ot, 0.05, out_cap=32, **kw)
    inst = inst._replace(valid=inst.valid & (inst.count >= 10))
    prog = {"rows": inst.rows, "count": inst.count, "ckeys": inst.ckeys, "ccount": inst.ccount, "feat": inst.feat_sum,
            "weight": inst.weight, "bmin": inst.bbox_min, "bmax": inst.bbox_max, "valid": inst.valid}
    cfg = dict(capacity=32, k_cap=2048, d=8, stride=2, overlap_thresh=0.75, iou_thresh=0.05, pad=0.025,
               max_extent=1e9, max_area_frac=1.0, full_round_every=4)
    return prog, ref_inst.fold(frames, cfg)


def test_instance_fold_matches_the_program():
    prog, ref = _instance_walk()
    assert int(ref["valid"].sum()) >= 2 and float(ref["weight"].max()) >= 4  # instances merged across frames
    out = ref_inst.compare(ref, prog)
    assert out["instances_differing"] == 0, out
    assert out["instance_feat_gap"] < 1e-5 and out["instance_box_gap"] < 1e-5
    # the same fold with its merges skipped differs
    bad, _ = _instance_walk(skip_merges=True)
    assert ref_inst.compare(ref, bad)["instances_differing"] > 0
