"""The benchmark's harness: one cell, one run, one result line.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` finds the cell in ``BENCHMARK.json``, its configuration in
``portbench/configs/<config>.json``, its traffic mix in
``portbench/traffic/<traffic>.json``, the limits of its comparison in
``portbench/limits/<workload>.json`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``, all by name, so a new cell or metric is
new files and entries only.  The traffic mix names the driver that runs it
(``portbench/cells/<driver>.py``).

A run makes its weights and inputs from the seed, warms up, measures for
the given seconds, reads the device's peak memory, frees the program's
state, checks what the timed path produced against the plain reference,
and prints one JSON object as the last line of standard output.  With
``--trace 1`` its metrics are the per-layer ones, read from a traced run.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "holoagent_tpu")
PROGRAM = "holoagent_tpu_torch"


class Refused(Exception):
    """The run cannot give a result (no card, a missing program, JAX
    loaded): the harness exits non-zero and prints no result line."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, Flax's
    or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = REPO) -> dict:
    return _json(root / "BENCHMARK.json")


def find_file(kind: str, name: str, bench: Path = BENCH, suffixes=(".json",)) -> Path:
    """``<bench>/<kind>/<name><suffix>``: a configuration, traffic mix, limit
    set or metric reader, by name."""
    for suf in suffixes:
        p = bench / kind / f"{name}{suf}"
        if p.is_file():
            return p
    raise Refused(f"no {kind} file for {name!r} under {bench / kind}")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH) -> Callable[[dict], Optional[float]]:
    """The ``read(data)`` function of ``metrics/<name>.py``."""
    return load_module(find_file("metrics", name, bench, (".py",)), f"portbench_metric_{name}").read


@dataclass
class Run:
    """One run of one cell: what the driver is given."""

    workload: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    t0: float  # the process's start on the host clock
    device: Any = None
    control: Optional[str] = None  # a lower-precision control in the program's place (tests only)
    fault: Optional[str] = None  # a fault planted under the timed path (tests only)


@dataclass
class Outcome:
    """What a driver returns."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]  # metric name -> value (host clock)
    trace_data: Dict[str, Any]  # what the per-layer readers read (traced runs)
    checks: Dict[str, float]  # compared number -> value
    memory_peak_bytes: int
    device_kind: str
    device_count: int
    load: Dict[str, Any] = field(default_factory=dict)  # what the traffic gave each layer (traced runs)


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number without a limit, or
    not finite, fails."""
    out = {}
    for name, value in checks.items():
        lim = limits.get(name)
        ok = lim is not None and value == value and value <= lim
        out[name] = {"value": value, "limit": lim, "ok": ok}
    return out


def cell(bench_json: dict, workload: str) -> dict:
    for w in bench_json["workloads"]:
        if w["name"] == workload:
            return w
    raise Refused(f"no workload {workload!r} in BENCHMARK.json")


def prepare(workload: str, seed: int, seconds: float, trace: bool, t0: float, bench: Path = BENCH,
            root: Path = REPO, control: Optional[str] = None, fault: Optional[str] = None):
    """Read the cell's files; return (its BENCHMARK.json entry, the Run, the
    driver module)."""
    bj = load_benchmark(root)
    w = cell(bj, workload)
    config = _json(find_file("configs", w["config"], bench))
    traffic = _json(find_file("traffic", w["traffic"], bench))
    try:
        limits = _json(find_file("limits", workload, bench))
    except Refused:
        limits = {}
    run = Run(workload, config, traffic, limits, seed, seconds, trace, t0, control=control, fault=fault)
    driver = importlib.import_module(f"portbench.cells.{traffic['driver']}")
    return bj, w, run, driver


def per_layer(bj: dict, workload: str, data: dict, bench: Path = BENCH) -> Dict[str, dict]:
    """Every per-layer metric listed for this cell (or for every cell), read
    from the traced run; a reader that finds nothing is left out."""
    out = {}
    for m in bj["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = metric_reader(m["name"], bench)(data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(bj: dict, workload: str, values: Dict[str, float]) -> Dict[str, dict]:
    out = {}
    for m in bj["end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        if m["name"] not in values:
            raise RuntimeError(f"the driver gave no {m['name']}")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def result(bj: dict, workload: str, run: Run, oc: Outcome, bench: Path = BENCH) -> dict:
    verdict = judge(oc.checks, run.limits)
    device = {"platform": "gpu", "kind": oc.device_kind, "count": oc.device_count,
              "memory_peak_bytes": oc.memory_peak_bytes}
    res: Dict[str, Any] = {"correct": all(v["ok"] for v in verdict.values()) and bool(verdict),
                           "attempted": oc.attempted, "failed": oc.failed}
    if run.trace:
        res["metrics"] = per_layer(bj, workload, oc.trace_data, bench)
        device.update(busy_s=oc.trace_data["busy_s"], window_s=oc.trace_data["window_s"])
        res["breakdown"] = oc.trace_data["breakdown"]
    else:
        res["metrics"] = end_to_end(bj, workload, oc.end_to_end)
    res["device"] = device
    if run.trace and oc.load:
        res["load"] = oc.load
    res["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in verdict.items()}
    return res


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    try:
        import torch

        bj, w, run, driver = prepare(args.workload, args.seed, args.seconds, bool(args.trace), t0)
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < w["chips"]:
            raise Refused(f"the cell asks for {w['chips']} cards, {torch.cuda.device_count()} visible")
        if importlib.util.find_spec(PROGRAM) is None:
            raise Refused(f"the program ({PROGRAM}) is not in this checkout")
        run.device = torch.device("cuda", 0)
        oc = driver.run(run)
        res = result(bj, args.workload, run, oc)
        bad = forbidden_modules()
        if bad:
            raise Refused(f"JAX or the JAX package was loaded in this process: {bad}")
    except Refused as e:
        print(f"portbench: refused: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
