"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload vith-l14.map --seed 7 --seconds 30 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for.  The kernels' build caches stay inside the checkout: the program's
nvcc builds in ``holoagent_tpu_torch/_build/``, Triton's and PyTorch's
extension caches under ``portbench/_cache/``.  The process runs its host
work on one thread (``OMP_NUM_THREADS``) and on the last two cores it may
use, which keeps runs steadier.
"""

import os
import sys
import time

T0 = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH, "_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BENCH, "_cache", "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
# one process with few host threads, held on two cores: the mapping path is
# paced by the host, and runs that wander over the cores spread twice as wide
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
CORES = sorted(os.sched_getaffinity(0))[-2:]
os.sched_setaffinity(0, CORES)
sys.path[:] = [REPO] + [p for p in sys.path if os.path.abspath(p or ".") != BENCH]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
