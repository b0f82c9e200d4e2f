"""The SAM 2 cell's driver, readers and yardstick.  On the CPU: the driver at
a tiny Hiera (``tiny_sam2_config.json``) through the harness, sound and
with faults planted; the two readers on a recorded trace; the yardstick's
arithmetic at Tq != Tk and D = 72.  Marked "chip": at the cell's own sizes
on the card, the control and the faults fail the cell's limits."""

import json
import shutil
import time

import pytest
import torch

from portbench import harness
from portbench.yardstick import hiera, roofline

from conftest import HERE, REPO, TINY_LIMITS

CELL = "sam2-hiera-l-l14.map"


@pytest.fixture
def tiny_sam2_bench(tmp_path):
    """A checkout-like directory whose one cell, "tiny-sam2.map", runs the
    SAM 2 driver at the tiny Hiera and CLIP in float32 on a 6-keyframe walk
    at 48x64.  Returns (root, bench dir)."""
    bench = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True)
    shutil.copytree(harness.BENCH / "metrics", bench / "metrics")
    shutil.copy(HERE / "tiny_sam2_config.json", bench / "configs" / "tiny-sam2.json")
    traffic = json.loads((HERE / "tiny_traffic.json").read_text())
    traffic["driver"] = "mapping_sam2"
    (bench / "traffic" / "map-sam2.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tiny-sam2.map.json").write_text(json.dumps(TINY_LIMITS))
    bj = json.loads((REPO / "BENCHMARK.json").read_text())
    bj["workloads"] = [{"name": "tiny-sam2.map", "config": "tiny-sam2", "traffic": "map-sam2", "chips": 1,
                        "why": "test"}]
    for m in bj["end_to_end"] + bj["per_layer"]:  # the metrics of the SAM 2 cell, and those of every cell
        if "workloads" in m:
            m["workloads"] = ["tiny-sam2.map"] if CELL in m["workloads"] else []
    bj["end_to_end"] = [m for m in bj["end_to_end"] if m["name"] in ("keyframes_per_s", "setup_s")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bj))
    return tmp_path, bench


def _run(root, bench, workload="tiny-sam2.map", trace=False, fault=None, seed=2**31 + 11, device=None):
    bj, _, run, driver = harness.prepare(workload, seed, 0.0, trace, time.perf_counter(), bench=bench, root=root,
                                         fault=fault)
    run.device = device or torch.device("cpu")
    return harness.result(bj, workload, run, driver.run(run), bench=bench)


def test_sound_run_is_correct(tiny_sam2_bench):
    res = _run(*tiny_sam2_bench)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"keyframes_per_s", "setup_s"} and res["attempted"] == 6


def test_traced_run_reads_the_encoder_span(tiny_sam2_bench):
    """On the CPU the spans are read and no kernel runs: hiera_ms.map is
    there, the roofline readers find nothing."""
    res = _run(*tiny_sam2_bench, trace=True)
    assert res["correct"], res["checks"]
    assert {"hiera_ms.map", "mask_ms.map", "clip_ms.map", "fold_ms.map", "mfu.map"} <= set(res["metrics"])
    assert "hiera_attn_roofline.map" not in res["metrics"] and "k2_roofline.map" not in res["metrics"]
    assert 0.0 < res["metrics"]["hiera_ms.map"]["value"] < res["metrics"]["mask_ms.map"]["value"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_not_correct(tiny_sam2_bench, fault):
    """Each fault the SAM cells plant, half_batch on SAM 2's decoder prompts."""
    res = _run(*tiny_sam2_bench, fault=fault)
    assert not res["correct"], (fault, res["checks"])


def test_half_batch_moves_the_decoder_numbers(tiny_sam2_bench):
    res = _run(*tiny_sam2_bench, fault="half_batch")
    assert res["checks"]["sam_logit_rel_rms"]["value"] > 1e-2
    assert res["checks"]["sam_iou_gap"]["value"] > TINY_LIMITS["sam_iou_gap"]


def test_parent_without_sam2_refuses(tiny_sam2_bench, monkeypatch):
    """A program without models/sam2.py refuses the cell before it runs."""
    import sys

    import holoagent_tpu_torch.models

    monkeypatch.setitem(sys.modules, "holoagent_tpu_torch.models.sam2", None)
    monkeypatch.delattr(holoagent_tpu_torch.models, "sam2", raising=False)
    with pytest.raises(harness.Refused):
        _run(*tiny_sam2_bench)


# a traced run's launch keys and kernel names, as the program records them
# (K2's key: (B, H, Tq, D, causal, dtype), Tk appended for pooled queries)
RECORDED_KEYS = [(1024, 2, 64, 72, False, "bf16"), (1024, 4, 16, 72, False, "bf16", 64),
                 (1, 8, 4096, 72, False, "bf16"), (33, 16, 257, 64, False, "bf16")]
RECORDED_NAMES = [
    "void (anonymous namespace)::g1_bf16_kernel<false, false, 80, true>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
    "__nv_bfloat16 const*, __nv_bfloat16*, (anonymous namespace)::Strides, (anonymous namespace)::Strides, "
    "(anonymous namespace)::Strides, int, int, int, int, float, (anonymous namespace)::RelPos)",
    "void (anonymous namespace)::resident_kernel<false, false, 64>(...)",
    "void (anonymous namespace)::g1_bf16_kernel<false, true, 16, true>(...)",
    "void (anonymous namespace)::gemm_kernel<true>(...)",
]


def test_yardstick_tells_hiera_from_clip():
    assert [hiera.kernel_of(n) for n in RECORDED_NAMES] == ["hiera", "k2", "k2", "k3"]
    assert [hiera.is_hiera(k) for k in RECORDED_KEYS] == [True, True, True, False]


def test_yardstick_arithmetic_at_pooled_queries():
    """4 Tq Tk D a head; q and o at Tq, k and v at Tk; D = 72 as it is."""
    ops, nbytes, peak = hiera.attention_cost((1024, 4, 16, 72, False, "bf16", 64))
    assert ops == 4.0 * 16 * 64 * 72 * 1024 * 4
    assert nbytes == 2 * 1024 * 4 * (16 + 64) * 72 * 2 and peak == roofline.PEAK_BF16_FLOPS
    # without Tk the key is K2's own, and the cost is k2_cost's
    key = (1, 8, 4096, 72, False, "bf16")
    assert hiera.attention_cost(key) == roofline.k2_cost(key)


def test_readers_on_a_recorded_trace():
    from portbench.harness import metric_reader

    keys = [k for k in RECORDED_KEYS if hiera.is_hiera(k)]
    least = sum(roofline.bound_s(*hiera.attention_cost(k)) for k in keys)
    data = {"keyframes": 4, "stage_ms": {"mask": 400.0, "mask.encoder": 120.0, "mask.encoder.neck": 2.0},
            "launches": {"hiera": {"keys": keys, "device_s": 4 * least}}}
    assert metric_reader("hiera_ms.map")(data) == 30.0
    assert metric_reader("hiera_attn_roofline.map")(data) == pytest.approx(25.0)
    # a program without SAM 2's spans and launches: nothing to read
    assert metric_reader("hiera_ms.map")({"keyframes": 4, "stage_ms": {"mask.encoder": 9.0}}) is None
    assert metric_reader("hiera_attn_roofline.map")({"launches": {"k2": {}}}) is None


def test_frame_ops_count_the_published_model():
    """SAM 2.1 Hiera-L a frame at 32 x 32 prompts, on the meta device."""
    from portbench.reference import sam2 as ref_sam2

    cfg = json.loads((harness.BENCH / "configs" / "hm3d-sam2-hiera-l-l14.json").read_text())
    ops = hiera.sam2_frame_ops(ref_sam2.SAM2Sizes.of(cfg["sam2"]["sizes"]), 32)
    assert 4e12 < ops["total"] < 7e12 and ops["int8"] == 0.0


@pytest.mark.chip
@pytest.mark.parametrize("fault", ["int4", "half_batch", "state_unchanged"])
def test_control_and_faults_fail_the_limits(card, fault):
    """At the cell's own sizes: the reference in 4-bit integers in the
    program's place, and the faults, each fail the cell's limits."""
    from portbench import controls

    if fault == "int4":
        limits = json.loads(harness.find_file("limits", CELL).read_text())
        for row in controls.readings(CELL, [11, 12, 13], control="int4", device=card):
            assert not all(v["ok"] for v in harness.judge(row["checks"], limits).values()), row
        return
    res = _run(harness.REPO, harness.BENCH, CELL, fault=fault, seed=21, device=card)
    assert not res["correct"], (fault, res["checks"])
