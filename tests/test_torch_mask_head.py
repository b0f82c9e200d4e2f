"""SAM 2's mask head (holoagent_tpu_torch/ops/mask_head.py) on the CPU: the
plain version is the chain models/sam2.py ran before it, bit for bit; the
decoder writes each pass into its rows of one output; the wrapper's
checks, its CPU route and its span; the CUDA source's build key, C entry
and widths; and the check chip_smoke.py holds the kernel to, on the
kernel's arithmetic written in plain PyTorch.  torch only, no JAX.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from holoagent_tpu_torch.models import sam as sam_mod
from holoagent_tpu_torch.models import sam2 as sam2_mod
from holoagent_tpu_torch.ops import _cuda_build as cuda_build
from holoagent_tpu_torch.ops import mask_head as mh
from holoagent_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(1)
TINY = sam2_mod.VARIANTS["test-tiny-hiera"]
HIERA_L = sam2_mod.VARIANTS["sam2.1_hiera_l"]
_spec = importlib.util.spec_from_file_location("mask_head_cases", Path(__file__).with_name("_mask_head_cases.py"))
cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cases)

# chip_smoke.py's rules: in bf16 two ulps of the largest output and one ulp
# rms; in float32 float32's precision (max|err| <= 1e-5 max|ref|)
MAX_ERR_OF_MAX, REL_RMS_TOL, F32_PREC = 2.0**-6, 2.0**-7, 1e-5


def _old_head(dec, src, feat_s0, feat_s1, hyper):
    """models/sam2.py::decode_masks' head before the kernel, as it was."""
    gelu = lambda x: F.gelu(x.float()).to(x.dtype)  # noqa: E731
    u = sam_mod._upscale(src, dec.up1_w, dec.up1_b) + feat_s1
    u = gelu(sam_mod._ln(u, dec.up_ln_g, dec.up_ln_b, sam2_mod.LN_EPS))
    u = gelu(sam_mod._upscale(u, dec.up2_w, dec.up2_b) + feat_s0)
    return torch.einsum("pnc,phwc->pnhw", hyper.float(), u.float())


@pytest.fixture(scope="module", params=[torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def tiny(request):
    """A seeded tiny SAM 2, one frame's features, and the arguments its
    decoder gave the mask head in each pass at points_per_side 12 (144
    prompts: passes of 64, 64 and 16)."""
    m = sam2_mod.init_sam2(TINY, seed=4, dtype=request.param, device="cpu")
    feats = m.image_features(torch.rand((1, 48, 64, 3), generator=torch.Generator().manual_seed(5)))[0]
    calls = []

    def record(*a, **kw):
        calls.append(a)
        return mh.mask_head(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sam2_mod, "mask_head", record)
        logits, iou = m.decode_grid(feats, 12)
    return m, feats, calls, logits, iou


def test_plain_head_is_the_chain_it_replaced(tiny):
    m, _, calls, _, _ = tiny
    assert [c[0].shape[0] for c in calls] == [64, 64, 16]
    for src, f0, f1, *w, hyper, eps, out in calls:
        old = _old_head(m.decoder, src, f0, f1, hyper)
        assert out.shape == old.shape and torch.equal(out, old)
        assert torch.equal(mh.mask_head_ref(src, f0, f1, *w, hyper, eps), old)
        assert torch.equal(mh.mask_head(src, f0, f1, *w, hyper, eps), old)


def test_decode_grid_writes_each_pass_into_its_rows(tiny, monkeypatch):
    """The preallocated logits equal the old decoder's concatenated passes,
    bit for bit, and the IoU too."""
    m, feats, _, logits, iou = tiny

    def old(src, f0, f1, *w, hyper, eps, out):
        return out.copy_(_old_head(m.decoder, src, f0, f1, hyper))

    monkeypatch.setattr(sam2_mod, "mask_head", lambda *a: old(*a[:-3], hyper=a[-3], eps=a[-2], out=a[-1]))
    emb, s0, s1 = feats
    pe = sam_mod.image_pe(m.prompt, emb.shape[0]).to(emb.dtype)
    sparse = sam_mod.grid_prompts(m.prompt, 12, emb.device).to(emb.dtype)
    outs = []
    for chunk in sparse.split(sam2_mod.POINTS_PER_BATCH):
        out = torch.empty((chunk.shape[0], 4, 4 * emb.shape[0], 4 * emb.shape[0]))
        outs.append(sam2_mod.decode_masks(m, emb, s0, s1, pe, chunk, out))
    assert torch.equal(torch.cat([o[0] for o in outs]), logits)
    assert torch.equal(torch.cat([o[1] for o in outs]), iou)
    assert logits.shape == (144, 4, 4 * emb.shape[0], 4 * emb.shape[0]) and logits.dtype == torch.float32


def test_cpu_route_counts_no_launch_and_spans_each_pass(tiny):
    m = tiny[0]
    n0 = mh.mask_head.launches
    timer = StageTimer("cpu")
    frame = torch.rand((48, 64, 3), generator=torch.Generator().manual_seed(6))
    out = sam_mod.generate_masks(m, frame, points_per_side=12, pred_iou_thresh=-10.0, stability_thresh=0.0,
                                 max_masks=8, timer=timer)
    assert mh.mask_head.launches == n0 and mh.mask_head.trace is None
    assert timer.calls["mask.decoder.head"] == 3 and timer.parent["mask.decoder.head"] == "mask.decoder"
    assert timer.calls["mask.decoder.head#sync"] == 0 and out["masks"].shape[0] == 8


def _meta(dtype=torch.bfloat16, p=3, g=16, d=256, requires_grad=()):
    """The head's arguments on the meta device, at width `d`."""
    c1, c2 = d // 4, d // 8
    shapes = dict(src=(p, g, g, d), feat_s0=(4 * g, 4 * g, c2), feat_s1=(2 * g, 2 * g, c1), up1_w=(2, 2, d, c1),
                  up1_b=(c1,), ln_g=(c1,), ln_b=(c1,), up2_w=(2, 2, c1, c2), up2_b=(c2,), hyper=(p, 4, c2))
    return {k: torch.empty(s, dtype=dtype, device="meta", requires_grad=k in requires_grad)
            for k, s in shapes.items()}


def test_wrapper_checks_its_arguments():
    """Meta tensors reach the checks of the kernel's route without a card."""
    args = lambda a: [a[k] for k in cases.ARGS]  # noqa: E731
    n0 = mh.mask_head.launches
    good = _meta()
    bad = dict(good, feat_s0=good["feat_s0"][:-1])
    with pytest.raises(ValueError, match="feat_s0"):
        mh.mask_head(*args(bad), 1e-6)
    with pytest.raises(ValueError, match="hyper"):
        mh.mask_head(*args(dict(good, hyper=good["hyper"][:2])), 1e-6)
    with pytest.raises(ValueError, match="out must be float32"):
        mh.mask_head(*args(good), 1e-6, out=torch.empty((3, 4, 64, 64), dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="share a device"):
        mh.mask_head(*args(dict(good, hyper=torch.zeros(3, 4, 32, dtype=torch.bfloat16))), 1e-6)
    with pytest.raises(TypeError, match="bf16 or float32"):
        mh.mask_head(*args(_meta(torch.float16)), 1e-6)
    with pytest.raises(ValueError, match="the kernel takes"):
        mh.mask_head(*args(_meta(d=128)), 1e-6)
    with pytest.raises(ValueError, match="the kernel takes"):
        mh.mask_head(*args(_meta(g=8)), 1e-6)
    with pytest.raises(RuntimeError, match="requires grad"):
        mh.mask_head(*args(_meta(requires_grad=("up1_w",))), 1e-6)
    with torch.no_grad(), pytest.raises(ValueError, match="src is on meta"):  # no grad: the device check
        mh.mask_head(*args(_meta(requires_grad=("up1_w",))), 1e-6)
    with pytest.raises(ValueError, match="src is on meta"):
        mh.mask_head(*args(good), 1e-6)
    assert mh.mask_head.launches == n0  # every check raises before a launch


def test_build_key_and_c_entry():
    """csrc/mask_head.cu builds into its own library, keyed by its source;
    the C entry's arguments are the ctypes signature's, its widths and item
    size the wrapper's; erf GELUs, no fast math."""
    path = mh.LIB.path()
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so" and "mask_head" in path.name
    assert path != cuda_build.CudaLibrary("masks.cu", {}).path()
    text = mh.LIB.source.read_text()
    entry = re.search(r'extern "C" int ha_mask_head\(([^)]*)\)', text)
    params = [p.strip() for p in entry.group(1).split(",")]
    sig = mh.LIB.signatures["ha_mask_head"]
    assert len(params) == len(sig) == 16
    kinds = {"void*": cuda_build.ctypes.c_void_p, "float": cuda_build.ctypes.c_float, "int": cuda_build.ctypes.c_int}
    assert [kinds[re.sub(r"^const |\s*\w+$", "", p).replace(" ", "")] for p in params] == list(sig)
    d, c1, c2, nm = mh.KERNEL_DIMS
    for name, v in (("D", d), ("C1", c1), ("C2", c2), ("NM", nm), ("TOK", mh.TOKENS_AN_ITEM)):
        assert re.search(rf"constexpr int {name} = {v};", text), name
    assert "erff(" in text and "tanhf" not in text and "--use_fast_math" not in cuda_build.NVCC_FLAGS


def test_kernel_takes_sam2_hiera_l():
    v = HIERA_L
    g = v.img_size // (v.patch_stride * 2 ** (len(v.stages) - 1 - v.scalp))
    assert (v.decoder_dim, v.decoder_dim // 4, v.decoder_dim // 8, v.num_mask_tokens) == mh.KERNEL_DIMS
    assert g == 64 and g % mh.TOKENS_AN_ITEM == 0 and sam2_mod.POINTS_PER_BATCH == 64


def _agreement(out, ref):
    d = out - ref
    return float(d.abs().max() / ref.abs().max()), float(d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


@pytest.fixture(scope="module")
def head_case():
    """Two prompts at Hiera-L's token grid (g = 64), bf16 and float32."""
    return {dt: cases.head_inputs(2, 64, dtype=dt, seed=7) for dt in (torch.bfloat16, torch.float32)}


def test_kernel_arithmetic_passes_the_bf16_rule(head_case):
    a = head_case[torch.bfloat16]
    ref = mh.mask_head_ref(*(a[k] for k in cases.ARGS), 1e-6)
    max_of_max, rel_rms = _agreement(cases.kernel_arithmetic(a, 1e-6), ref)
    assert max_of_max <= MAX_ERR_OF_MAX and rel_rms <= REL_RMS_TOL, (max_of_max, rel_rms)


def test_kernel_arithmetic_passes_the_f32_rule(head_case):
    a = head_case[torch.float32]
    ref = mh.mask_head_ref(*(a[k] for k in cases.ARGS), 1e-6)
    assert _agreement(cases.kernel_arithmetic(a, 1e-6, acc=torch.float64), ref)[0] <= F32_PREC


@pytest.mark.parametrize("fault", cases.MASK_HEAD_FAULTS)
def test_each_fault_is_rejected(head_case, fault):
    """LayerNorm skipped and feat_s0 dropped fail the bf16 rule; the tanh
    GELU lies below bf16's rounding and fails float32's."""
    for dt, a in head_case.items():
        ref = mh.mask_head_ref(*(a[k] for k in cases.ARGS), 1e-6)
        max_of_max, rel_rms = _agreement(cases.faulty_head(a, 1e-6, fault), ref)
        if dt == torch.float32:
            assert max_of_max > F32_PREC, (fault, max_of_max)
        elif fault != "tanh_gelu":
            assert max_of_max > MAX_ERR_OF_MAX or rel_rms > REL_RMS_TOL, (fault, max_of_max, rel_rms)
