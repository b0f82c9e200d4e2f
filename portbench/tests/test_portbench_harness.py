"""The harness on the CPU at the tiny variants: it finds a cell's files by
name, a run of sound code is correct, a run with a fault planted under the
timed path is not, and nothing it runs loads JAX or the JAX package.  The
tests marked "chip" run the same at the cells' own sizes on the card: the
control in the program's place and each fault come out not correct under
the cells' limits."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "merge_skipped")
# the tiny cell's random towers leave one valid mask a keyframe, so its
# instance fold has nothing to merge: the merge fault is held at the
# cells' sizes on the card and by test_portbench_reference's instance test
TINY_FAULTS = FAULTS[:3]


def _run(root, bench, workload="tiny.map", trace=False, fault=None, seed=2**31 + 7, device=None):
    bj, _, run, driver = harness.prepare(workload, seed, 0.0, trace, time.perf_counter(), bench=bench, root=root,
                                         fault=fault)
    run.device = device or torch.device("cpu")
    return harness.result(bj, workload, run, driver.run(run), bench=bench)


def test_sound_run_is_correct(tiny_bench):
    res = _run(*tiny_bench)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"keyframes_per_s", "setup_s"}
    assert res["attempted"] == 6 and list(res)[-1] == "checks"


def test_traced_run_reads_the_per_layer_metrics(tiny_bench):
    res = _run(*tiny_bench, trace=True)
    assert res["correct"]
    # the CPU runs no kernel and no device operation: only the host-side readers find something
    assert {"mask_ms.map", "clip_ms.map", "fold_ms.map", "mfu.map"} <= set(res["metrics"])
    assert "k1_roofline.map" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res


@pytest.mark.parametrize("fault", TINY_FAULTS)
def test_fault_is_not_correct(tiny_bench, fault):
    res = _run(*tiny_bench, fault=fault)
    assert not res["correct"], (fault, res["checks"])


def test_new_files_are_found_by_name(tiny_bench):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries, with no existing file edited."""
    root, bench = tiny_bench
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg["program"]["models"]["sam"]["max_masks"] = 6
    (bench / "configs" / "tiny6.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "map.json").read_text())
    traffic["walk_frames"] = 3
    traffic["check_keyframes"] = 1
    (bench / "traffic" / "short.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "keyframes_seen.map.py").write_text("def read(d):\n    return float(d['keyframes'])\n")
    (bench / "limits" / "tiny6.short.json").write_text((bench / "limits" / "tiny.map.json").read_text())
    bj = json.loads((root / "BENCHMARK.json").read_text())
    bj["configs"].append(dict(bj["configs"][0], name="tiny6", file="portbench/configs/tiny6.json"))
    bj["workloads"].append({"name": "tiny6.short", "config": "tiny6", "traffic": "short", "chips": 1, "why": "t"})
    bj["per_layer"].append({"name": "keyframes_seen.map", "unit": "keyframes", "better": "higher",
                            "source": "program_counter", "layer": "test", "moves": "keyframes_per_s",
                            "workloads": ["tiny6.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bj))
    res = _run(root, bench, "tiny6.short", trace=True)
    assert res["correct"] and res["metrics"]["keyframes_seen.map"]["value"] == 3.0
    assert "keyframes_seen.map" not in _run(root, bench, "tiny.map", trace=True)["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("holoagent_tpu_torch", "holoagent_tpu_torch.models", "jaxtyping", "flaxen", "jax_helpers"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "holoagent_tpu.memory", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["holoagent_tpu", "jaxlib"]


def test_reference_and_yardstick_import_nothing_of_the_program():
    import ast

    for path in list((harness.BENCH / "reference").glob("*.py")) + list((harness.BENCH / "yardstick").glob("*.py")) + [
            harness.BENCH / "walk.py", harness.BENCH / "weights.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("holoagent_tpu_torch",) + harness.FORBIDDEN, (path.name, n)


def test_a_run_loads_no_jax(tiny_bench, tmp_path):
    """A whole run in a fresh process: afterwards no module of JAX, Flax or
    the JAX package is loaded."""
    root, bench = tiny_bench
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(harness.REPO)!r})\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        f"bj, _, r, d = harness.prepare('tiny.map', 3, 0.0, False, time.perf_counter(), bench=Path({str(bench)!r}), "
        f"root=Path({str(root)!r}))\n"
        "r.device = torch.device('cpu')\n"
        "res = harness.result(bj, 'tiny.map', r, d.run(r), bench=Path(" + repr(str(bench)) + "))\n"
        "print(res['correct'], harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_run_refuses_without_a_card(tmp_path):
    """Without a card the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", "vith-l14.map", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(harness.REPO))
    assert out.returncode != 0 and out.stdout.strip() == ""


CELLS = {"vith-l14.map": "w8a8", "vitb-l14-w8a8.map-batched": "int4"}


@pytest.mark.chip
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_the_limits(card, workload):
    """The cell's control on three seeds: each reading fails the cell's
    limits.  The bf16 cell's is the program's own W8A8 path; the W8A8
    cell's, which has no lower path of its own, the reference with its
    products in 4-bit integers in the program's place."""
    from portbench import controls

    limits = json.loads(harness.find_file("limits", workload).read_text())
    for row in controls.readings(workload, [11, 12, 13], control=CELLS[workload], device=card):
        assert not all(v["ok"] for v in harness.judge(row["checks"], limits).values()), row


@pytest.mark.chip
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_fault_fails_the_limits(card, workload, fault):
    res = _run(harness.REPO, harness.BENCH, workload, fault=fault, seed=21, device=card)
    assert not res["correct"], (workload, fault, res["checks"])
