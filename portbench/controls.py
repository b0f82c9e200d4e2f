"""Readings for the limits of a cell's comparison: the program on many
seeds, and the control in the program's place and each fault planted
under the timed path on a few, in one process.

    python3 portbench/controls.py --workload vith-l14.map --seeds 101-112 \
        --control w8a8 --control-seeds 201-203 \
        --faults half_batch,merge_skipped --fault-seeds 301-303 --out controls.jsonl

Each program run maps one scene (the shortest window) and prints one JSON
line: the seed, "program" or the control's or fault's name, every compared
number.  The control "w8a8" is the program with its W8A8 towers; "int4"
is the reference with every product in 4-bit integers, in the program's
place.
The limits in ``portbench/limits/<workload>.json`` are set from these
readings: above the program's largest, below the control's smallest.
"""

import argparse
import gc
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(BENCH)] + [p for p in sys.path if os.path.abspath(p or ".") != BENCH]

from portbench import harness  # noqa: E402

# controls computed by the reference in a lower precision, in the program's
# place; any other control is the program's own path (w8a8)
REFERENCE_CONTROLS = ("int4",)


def seeds(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def readings(workload, seed_list, control=None, device=None, out=None, fault=None, **where):
    """One run a seed; yields (and writes to `out`) each run's numbers."""
    import torch

    for seed in seed_list:
        t0 = time.perf_counter()
        bj, _, run, driver = harness.prepare(workload, seed, 0.0, False, t0, control=control, fault=fault, **where)
        run.device = device or torch.device("cuda", 0)
        if control in REFERENCE_CONTROLS:
            row = {"workload": workload, "seed": seed, "kind": control,
                   "checks": driver.control_readings(run, control)}
        else:
            oc = driver.run(run)
            row = {"workload": workload, "seed": seed, "kind": control or fault or "program", "checks": oc.checks,
                   "attempted": oc.attempted, "e2e": oc.end_to_end}
            del oc
        if out is not None:
            out.write(json.dumps(row) + "\n")
            out.flush()
        del run
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    out = open(a.out, "a") if a.out else None
    try:
        for row in readings(a.workload, seeds(a.seeds) if a.seeds else [], out=out):
            print(json.dumps(row), flush=True)
        if a.control:
            for row in readings(a.workload, seeds(a.control_seeds), control=a.control, out=out):
                print(json.dumps(row), flush=True)
        for fault in filter(None, a.faults.split(",")):
            for row in readings(a.workload, seeds(a.fault_seeds), fault=fault, out=out):
                print(json.dumps(row), flush=True)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
