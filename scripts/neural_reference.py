"""The neural accuracy row and the correctness battery on the CPU, in either
package, on fixture towers that package trained: the reference numbers
chip_smoke.py's (u) holds the card-trained towers to.

    python3 scripts/neural_reference.py --package jax|torch --towers DIR \
        --what row|suite|sam|init --out result.json [--seed S]

"row" and "suite" train the fixture towers at the recipe (3000 CLIP and
6000 SAM steps, float32, on the CPU; about 12 min for the JAX package and 8
for the port on 8 cores) at `--seed` into DIR unless DIR already holds
them, then run `eval_protocol.run_one(0, perception="neural")` over both
layouts ("row") or `correctness_suite.run_suite("three_room", 512)` with
its two_floor long-query row ("suite", its artifacts under DIR/suite), and
write the metrics as JSON.  "sam" trains the SAM tower alone at the recipe
into DIR/sam_seed<S>.npz (the recipe trains the two towers apart, so any
CLIP tower pairs with it; `scripts/tower_spread.py` scores such pairs).
"init" (JAX package) writes the JAX package's seeded initial towers,
DIR/clip_init_seed<S>.npz and DIR/sam_init_seed<S>.npz, from which
`scripts/tower_spread.py --init` starts the port's trainers.  The JAX
package runs with `jax_platforms=cpu`; its tower cache is DIR, never its
default.  Results of both packages on the same towers are equal
(tests/test_torch_zoo.py holds the row on a short walk), so the two
packages' runs differ by their towers' training alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _row(m):
    o = m["objects"]
    return {"floor_bound_error": m["floors"]["mean_bound_error"], "room_precision": m["rooms"]["precision"],
            "room_recall": m["rooms"]["recall"], "objects_pred": o["num_pred"], "objects_gt": o["num_gt"],
            "prec_at_50": o["prec_at_50"], "rec_at_50": o["rec_at_50"], "auc": o["auc"],
            "mIoU": m["segmentation"]["mIoU"]}


def _jax_towers_only(args, towers_dir, out):
    """--what sam | init in the JAX package."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from holoagent_tpu.models import clip as clip_mod
    from holoagent_tpu.models import sam as sam_mod
    from holoagent_tpu.training import perception, zoo

    if args.what == "init":
        key = jax.random.key(args.seed)
        zoo.save_params(towers_dir / f"clip_init_seed{args.seed}.npz",
                        clip_mod.init_clip(key, clip_mod.VARIANTS["test-tiny"], dtype=jnp.float32))
        zoo.save_params(towers_dir / f"sam_init_seed{args.seed}.npz",
                        sam_mod.init_sam(key, sam_mod.VARIANTS["fixture-tiny"], dtype=jnp.float32))
        return
    params, losses = perception.train_tiny_sam(zoo._fixture_datasets(), steps=6000, seed=args.seed,
                                               variant_name="fixture-tiny", lr=2e-3)
    zoo.save_params(towers_dir / f"sam_seed{args.seed}.npz", params)
    out["sam_losses"] = {"first": float(losses[0]), "mean_last_50": float(np.mean(losses[-50:]))}


def _torch_sam(args, towers_dir, out):
    """--what sam in the port, on the CPU."""
    import numpy as np

    from holoagent_tpu_torch import bridge
    from holoagent_tpu_torch.training import perception, zoo

    sam, losses = perception.train_tiny_sam(zoo._fixture_datasets(), steps=6000, seed=args.seed,
                                            variant_name=zoo.SAM_VARIANT, lr=2e-3, device="cpu")
    zoo.save_params(towers_dir / f"sam_seed{args.seed}.npz", bridge.sam_to_numpy(sam))
    out["sam_losses"] = {"first": float(losses[0]), "mean_last_50": float(np.mean(losses[-50:]))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--towers", required=True)
    ap.add_argument("--what", choices=("row", "suite", "sam", "init"), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.what == "init" and args.package != "jax":
        ap.error("--what init writes the JAX package's initial towers")
    towers_dir = Path(args.towers).resolve()
    towers_dir.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(ROOT))
    t0 = time.time()
    out = {"package": args.package, "seed": args.seed, "what": args.what, "towers": str(towers_dir)}
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.what in ("sam", "init"):
        (_jax_towers_only if args.package == "jax" else _torch_sam)(args, towers_dir, out)
    else:
        if args.package == "jax":
            from holoagent_tpu.apps import correctness_suite, eval_protocol
            from holoagent_tpu.training import zoo

            zoo.DEFAULT_CACHE = towers_dir  # fixture_towers() and the suite's _towers read it
            towers = zoo.fixture_towers(seed=args.seed, verbose=True)
            # the suite's _towers() asks zoo.fixture_towers() for the default seed
            zoo.fixture_towers = lambda: towers  # noqa: E731
            kw = {}
        else:
            from holoagent_tpu_torch.apps import correctness_suite, eval_protocol
            from holoagent_tpu_torch.training import zoo

            towers = zoo.fixture_towers(seed=args.seed, cache_dir=towers_dir, verbose=True, device="cpu")
            kw = {"device": "cpu"}
        out["train_seconds"] = round(time.time() - t0, 1)
        if args.what == "row":
            out["row"] = {layout: _row(eval_protocol.run_one(0, layout=layout, perception="neural", towers=towers,
                                                             **kw))
                          for layout in eval_protocol.LAYOUTS}
        else:
            if args.package == "torch":
                kw["towers"] = towers
            report = correctness_suite.run_suite("three_room", 512, out_dir=str(towers_dir / "suite"), **kw)
            out["suite"] = {k: v for k, v in report.items() if k != "provenance"}
    out["seconds"] = round(time.time() - t0, 1)
    Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
