"""The spread of the fixture recipe's towers, scored by the port: the
correctness battery and the neural row on the card (or `--device cpu`).

    python3 scripts/tower_spread.py --clip CLIP.npz [--sam SAM.npz ...] \
        [--train-sam-seeds 0,3] [--recipe-seeds 1,2] [--init CLIP0.npz SAM0.npz] \
        --out result.json [--device cuda]

  * each `--sam` tower (a JAX `save_params` file, e.g. from
    `scripts/neural_reference.py --what sam`) is paired with the `--clip`
    tower and scored on the three_room battery (four modes over the
    512-padded gallery, no long queries);
  * each `--train-sam-seeds` seed trains the port's SAM tower at the recipe
    (6000 steps, lr 2e-3) on the device and scores it with `--clip`;
  * each `--recipe-seeds` seed runs `training.zoo.fixture_towers` on the
    device (both towers at the recipe), then the neural row (both layouts)
    and the whole battery with its two_floor long queries; with `--init`,
    the first of them starts from those initial towers (e.g. the JAX
    package's, from `scripts/neural_reference.py --what init`) instead of
    the port's own init.

The recipe trains the two towers apart, so a CLIP tower of one seed and a
SAM tower of another are one draw of the recipe.  `fast_oracle` scores the
graph the SAM tower built (one-hot GT embeddings), so it reads the SAM
tower alone.  Writes the scores as JSON.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODES = ("fast_oracle", "fast", "slow_clip", "slow_generative")


def _battery(report):
    out = {m: {"top1_acc": report[m]["top1_acc"], "recall_at_5": report[m]["recall_at_5"]} for m in MODES}
    if "long_query" in report:
        out["long_query"] = report["long_query"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip", required=True)
    ap.add_argument("--sam", nargs="*", default=[])
    ap.add_argument("--train-sam-seeds", default="")
    ap.add_argument("--recipe-seeds", default="")
    ap.add_argument("--init", nargs=2, metavar=("CLIP", "SAM"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from holoagent_tpu_torch.apps import correctness_suite, eval_protocol
    from holoagent_tpu_torch.device import resolve
    from holoagent_tpu_torch.training import perception, zoo

    dev = resolve(args.device)
    clip = zoo.clip_from_tree(zoo.load_params(args.clip), dev)
    ds = zoo._fixture_datasets()
    out = {"device": str(dev), "clip": args.clip, "sam": {}, "port_sam": {}, "recipe": {}}

    def battery(sam, long_query_layout=""):
        with tempfile.TemporaryDirectory() as tmp:
            return correctness_suite.run_suite("three_room", 512, out_dir=tmp, towers=(clip, sam), device=dev,
                                               long_query_layout=long_query_layout)

    for path in args.sam:
        t0 = time.perf_counter()
        out["sam"][path] = _battery(battery(zoo.sam_from_tree(zoo.load_params(path), dev)))
        print(f"[spread] {path}: {json.dumps(out['sam'][path])} ({time.perf_counter() - t0:.1f} s)", flush=True)
    for seed in [int(s) for s in args.train_sam_seeds.split(",") if s]:
        t0 = time.perf_counter()
        sam, losses = perception.train_tiny_sam(ds, steps=6000, seed=seed, variant_name=zoo.SAM_VARIANT, lr=2e-3,
                                                device=dev)
        res = _battery(battery(sam))
        res["sam_losses"] = {"first": losses[0], "mean_last_50": float(np.mean(losses[-50:]))}
        out["port_sam"][seed] = res
        print(f"[spread] port SAM seed {seed}: {json.dumps(res)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    train_clip, train_sam = perception.train_tiny_clip, perception.train_tiny_sam
    for i, seed in enumerate(int(s) for s in args.recipe_seeds.split(",") if s):
        t0 = time.perf_counter()
        name = f"seed{seed}" + ("_init" if args.init and i == 0 else "")
        if args.init and i == 0:
            perception.train_tiny_clip = functools.partial(
                train_clip, params=zoo.clip_from_tree(zoo.load_params(args.init[0]), dev))
            perception.train_tiny_sam = functools.partial(
                train_sam, params=zoo.sam_from_tree(zoo.load_params(args.init[1]), dev))
        try:
            with tempfile.TemporaryDirectory() as tmp:
                towers = zoo.fixture_towers(seed=seed, retrain=True, device=dev, cache_dir=tmp, datasets=ds)
                meta = json.loads(next(Path(tmp).glob("meta_*.json")).read_text())
        finally:
            perception.train_tiny_clip, perception.train_tiny_sam = train_clip, train_sam
        summary = eval_protocol.run(seeds=0, neural=True, neural_seeds=1, towers=towers, device=dev, out_md=None)
        with tempfile.TemporaryDirectory() as tmp:
            report = correctness_suite.run_suite("three_room", 512, out_dir=tmp, towers=towers, device=dev)
        out["recipe"][name] = {
            "losses": {k: meta[k] for k in ("clip_final_loss", "sam_final_loss")},
            "row": {layout: {"prec_at_50": m["objects"]["prec_at_50"], "rec_at_50": m["objects"]["rec_at_50"],
                             "mIoU": m["segmentation"]["mIoU"], "objects_pred": m["objects"]["num_pred"],
                             "floor_bound_error": m["floors"]["mean_bound_error"],
                             "rooms": [m["rooms"]["precision"], m["rooms"]["recall"]]}
                    for layout, m in zip(eval_protocol.LAYOUTS, summary["per_seed_neural"])},
            "battery": _battery(report),
        }
        print(f"[spread] recipe {name}: {json.dumps(out['recipe'][name])} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
