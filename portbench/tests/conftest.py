"""Fixtures of the benchmark's tests: a card where one is visible, and a
small copy of the benchmark (one mapping cell at the tiny tower variants)
for runs of the harness on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# limits of the tiny cell on the CPU, where the program's plain paths do the
# reference's float32 arithmetic: its sound runs read 0 or float32 rounding
TINY_LIMITS = {"sam_linear_rel_rms": 1e-4, "sam_logit_rel_rms": 1e-4, "sam_iou_gap": 1e-4,
               "mask_select_differing": 0.0, "clip_feat_gap": 1e-5, "scene_rows_differing": 0.0,
               "scene_feat_gap": 1e-4, "pixel_rows_differing": 0.0, "instances_differing": 0.0,
               "instance_feat_gap": 1e-4, "instance_box_gap": 1e-4}


@pytest.fixture
def card():
    """The card, or a skip where none is visible (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_bench(tmp_path):
    """A checkout-like directory: BENCHMARK.json with one cell "tiny.map"
    (the test-tiny SAM and CLIP towers in float32, a 6-keyframe walk at
    48x64) and portbench's metric readers.  Returns (root, bench dir)."""
    bench = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    shutil.copy(HERE / "tiny_config.json", bench / "configs" / "tiny.json")
    shutil.copy(HERE / "tiny_traffic.json", bench / "traffic" / "map.json")
    (bench / "limits" / "tiny.map.json").write_text(json.dumps(TINY_LIMITS))
    bj = json.loads((REPO / "BENCHMARK.json").read_text())
    bj["workloads"] = [{"name": "tiny.map", "config": "tiny", "traffic": "map", "chips": 1, "why": "test"}]
    for m in bj["end_to_end"] + bj["per_layer"]:
        m.pop("workloads", None)
    bj["end_to_end"] = [m for m in bj["end_to_end"] if m["name"] in ("keyframes_per_s", "setup_s")]
    bj["per_layer"] = [m for m in bj["per_layer"] if m["name"].endswith(".map")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bj))
    return tmp_path, bench
