"""The yardstick's arithmetic against shapes worked by hand: the kernels'
least times, the towers' model operations, the device's busy time."""

import pytest

from portbench.reference.clip import CLIPSizes
from portbench.reference.sam import SAMSizes
from portbench.yardstick import flops, roofline, trace


def test_k1_vit_h_global_bound():
    # SAM vit_h's global layer: B = 1, 16 heads, a 64 x 64 grid, D = 80, bf16:
    # 4 N^2 D H = 85.9 GFLOP at 989 TF/s is 0.0869 ms, above its bytes' time
    ops, nbytes, peak = roofline.k1_cost((1, 16, 64, 64, 80, "bf16"))
    assert ops == 4 * 4096**2 * 80 * 16
    assert nbytes == 4 * 16 * 4096 * 80 * 2 + 16 * 4096 * 128 * 4
    assert roofline.bound_s(ops, nbytes, peak) * 1e3 == pytest.approx(0.0869, abs=5e-5)


def test_k2_causal_pairs_and_bytes():
    ops, nbytes, peak = roofline.k2_cost((256, 12, 77, 64, True, "bf16"))
    assert ops == 4 * (77 * 78 / 2) * 64 * 256 * 12
    assert nbytes == 4 * 256 * 12 * 77 * 64 * 2
    assert peak == roofline.PEAK_BF16_FLOPS
    # float32 attention runs as 3xTF32: a third of the TF32 rate
    assert roofline.k2_cost((1, 1, 8, 16, False, "f32"))[2] == pytest.approx(495e12 / 3)


def test_k3_bound_and_share():
    # CLIP ViT-L/14's fc1 at tier 16: M = 257 * 33, K = 1024, N = 4096
    key = (8481, 1024, 4096, "bf16", "bf16")
    ops, nbytes, peak = roofline.k3_cost(key)
    assert ops == 2 * 8481 * 1024 * 4096 and peak == 1979e12
    assert nbytes == 8481 * 1024 * 2 + 4096 * 1024 + 2 * 4096 * 4 + 8481 * 4096 * 2
    least = roofline.bound_s(ops, nbytes, peak)
    assert least == pytest.approx(max(ops / 1979e12, nbytes / 3.35e12))
    assert roofline.roofline_percent("k3", [key, key], 4 * least) == pytest.approx(50.0)
    assert roofline.roofline_percent("k3", [], 1.0) is None
    assert roofline.roofline_percent("k3", [key], 0.0) is None


@pytest.mark.parametrize("name, kernel", [
    ("void resident_kernel<true, false, 80>(__nv_bfloat16 const*, __nv_bfloat16 const*, int)", "k1"),
    ("void global_kernel<true, 80>(Maps<80>, float const*, float const*, __nv_bfloat16*, int, int, int)", "k1"),
    ("void g2_tf32x3_kernel<true, false, 64, true>(float const*, float const*)", "k1"),
    ("void resident_kernel<false, true, 64>(__nv_bfloat16 const*)", "k2"),
    ("void (anonymous namespace)::global_kernel<false, 64>(Maps<64>)", "k2"),
    ("void g1_bf16_kernel<false, true, 16, true>(__nv_bfloat16 const*)", "k2"),
    ("void quantize_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*, signed char*, float*, int, int)", "k3"),
    ("void gemm_kernel<float>(CUtensorMap, CUtensorMap, float const*)", "k3"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)", None),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", None),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_kernel<float>>(Params)", None),
    ("Memcpy HtoD (Pageable -> Device)", None),
])
def test_kernel_of_names_the_programs_kernels(name, kernel):
    assert roofline.kernel_of(name) == kernel


def test_device_seconds_sums_a_family_inside_the_stretch():
    ev = trace.Events(device=[("void gemm_kernel<float>()", 0.5, 1.5), ("void quantize_kernel<float, 8>()", 2.0, 2.5),
                              ("void resident_kernel<true, false, 64>()", 3.0, 4.0), ("elementwise", 4.0, 5.0),
                              ("void gemm_kernel<float>()", 9.0, 10.0)],
                      host=[(trace.WINDOW, 1.0, 8.0)])
    assert ev.device_seconds(roofline.kernel_of) == {"k3": pytest.approx(1.0), "k1": pytest.approx(1.0)}


def test_clip_crop_ops_by_hand():
    # ViT-L/14 at 224: 257 tokens, width 1024, 24 layers, 16 heads of 64
    v = CLIPSizes(224, 14, 1024, 24, 16, 768, 12, 12, 768)
    t, w = 257, 1024
    per_layer = 2 * t * w * 3 * w + 2 * t * w * w + 2 * 2 * t * w * 4 * w + 2 * 2 * t * t * w
    hand = 2 * 256 * (14 * 14 * 3) * w + 24 * per_layer + 2 * w * 768
    got = flops.clip_crop_ops(v)
    assert got["total"] == hand
    assert got["int8"] == 24 * t * w * w * 24


def test_sam_frame_ops_tiny_by_hand():
    # the test-tiny SAM: a 4 x 4 grid of width 64, windows of 2, one global
    # layer; the int8 part counts the padded window tokens
    v = SAMSizes(64, 16, 64, 2, 2, (1,), 2, 32, 32, 2, 2, 64, 4)
    got = flops.sam_frame_ops(v, points_per_side=4)
    assert got["int8"] == 24 * (16 + 16) * 64**2
    enc_linears = 2 * 16 * 768 * 64 + 2 * (2 * 16 * 64 * 3 * 64 + 2 * 16 * 64 * 64 + 2 * 2 * 16 * 64 * 256)
    assert got["total"] > enc_linears
    vh = SAMSizes(1024, 16, 1280, 32, 16, (7, 15, 23, 31), 14, 256, 256, 8, 2, 2048, 4)
    assert flops.sam_frame_ops(vh, 12)["int8"] == 24 * (4 * 4096 + 28 * 4900) * 1280**2


def test_ideal_seconds_splits_int8():
    ops = {"total": 3e12, "int8": 2e12}
    assert flops.ideal_seconds(ops, False) == pytest.approx(3e12 / 989e12)
    assert flops.ideal_seconds(ops, True) == pytest.approx(2e12 / 1979e12 + 1e12 / 989e12)


def test_busy_is_the_union_of_intervals():
    ivs = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert trace.busy(ivs) == pytest.approx(4.0)  # the overlap is counted once
    assert trace.gaps(ivs, 0.0, 7.0) == [(3.0, 5.0), (6.0, 7.0)]
    ev = trace.Events(device=[("k", 0.5, 2.0), ("k", 1.0, 3.0), ("m", 5.0, 6.0)],
                      host=[(trace.WINDOW, 0.0, 7.0), ("aten::item", 3.0, 4.5), ("aten::nonzero", 2.9, 4.6)])
    assert ev.busy_s() == pytest.approx(3.5) and ev.window_s() == pytest.approx(7.0)
    assert ev.top_device_ops()[0] == ["k", pytest.approx(3.5)]  # summed by name
    gaps = ev.idle_gaps()
    assert gaps[0] == ["aten::item", pytest.approx(2.0)]
    assert [g[0] for g in gaps] == ["aten::item", "host idle", "host idle"]
