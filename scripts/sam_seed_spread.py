"""The fixture SAM recipe's spread over seeds, in both packages, on the CPU:
is a port-trained SAM tower a draw from the reference's distribution?

    python3 scripts/sam_seed_spread.py --out DIR [--seeds 0-11] [--steps 6000] \
        [--runs jax,torch,torch64,torch_own] [--workers 4] [--clip-steps 3000] [--no-score] \
        [--score-device cpu|cuda]
    python3 scripts/sam_seed_spread.py --out DIR --runs torch_card,torch_own_card --no-score  # on the card

Every run trains fixture-tiny SAM at the recipe (`training.zoo`: lr 2e-3,
8 prompts a step, `steps` steps) on the 48/48/72-frame fixture walks:

  * ``jax``: the JAX package's ``train_tiny_sam`` at seed s (its init is
    ``init_sam(jax.random.key(s))``);
  * ``torch``: the port's ``train_tiny_sam`` at seed s, float32, from the
    same initial tower (written by the JAX package, carried over by
    ``bridge.py``): the same batches, the same weights;
  * ``torch64``: the same in float64 (the module cast to float64 and the
    forward's float32 casts lifted for the run), to measure how fast
    float32's own rounding parts two trainers;
  * ``torch_own``: the port's recipe as ``fixture_towers`` runs it, from
    the port's own seeded init (``models.sam.init_sam``);
  * ``torch_card``, ``torch_own_card``: ``torch`` and ``torch_own`` on the
    card (each step a CUDA graph replay), for a machine with one; the init
    and CLIP files come from a CPU run's DIR (the card machine has no JAX),
    and the towers go back to be scored there.

Each tower is then scored as ``scripts/tower_spread.py`` scores one (the
three_room battery's ``fast_oracle`` mode over the 512-padded gallery),
paired with the JAX package's seed-0 CLIP tower at its recipe
(``fast_oracle`` reads the graph the SAM tower built, with one-hot GT
embeddings), on ``--score-device`` (score every tower of a study on one
device: CUDA's sums differ from the CPU's).  The jobs run as separate
processes, `--workers` at a time, each pinned to its own CPU cores.
Writes DIR/report.json: per run and seed the losses (every step), the
last-50 mean loss, ``fast_oracle`` and recall@5; per run the medians and
ranges, and against the JAX package's seeds the Mann-Whitney and Fisher
p-values of ``_overlap``; per seed the first step at which each pair of
trainers (the reference and the port, float64 and float32,
the card and the CPU) parts by more than 1e-5 ... 1e-1 relative, and the
first step at which ``jax`` and ``torch`` part by more than ``torch64``
and ``torch`` have by then.  DIR/report_slim.json (also printed) is the
same without the loss curves.  A finished job's file is reused, so a run
can be resumed.  Each job alone: ``--job init|train|clip|score|targets|grads``
(``targets``: both trainers' supervision, held equal; see ``job_targets``;
``grads``: each trainer's first gradients against float64's, per seed).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
VARIANT = "fixture-tiny"
LR = 2e-3
RUNS = ("jax", "torch", "torch64", "torch_own", "torch_card", "torch_own_card")
LEVELS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
FLOOR = 1e-5  # relative: a loss's own float32 rounding sits well below it
LOW = 0.8  # a tower under this fast_oracle has lost at least two of the battery's objects
FLOAT32_PORT_RUNS = ("torch", "torch_own", "torch_card", "torch_own_card")


def _seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


# ---------------------------------------------------------------------------
# Jobs, one process each
# ---------------------------------------------------------------------------


def job_init(out: Path, seeds):
    """The JAX package's initial SAM towers, init_seed<s>.npz."""
    jax = _jax()
    import jax.numpy as jnp

    from holoagent_tpu.models import sam as sam_mod
    from holoagent_tpu.training import zoo

    for s in seeds:
        zoo.save_params(out / f"init_seed{s}.npz",
                        sam_mod.init_sam(jax.random.key(s), sam_mod.VARIANTS[VARIANT], dtype=jnp.float32))


@contextlib.contextmanager
def _float64_forward():
    """Lift the port's ``.float()`` casts (layer norms, attention scores,
    activations, which the reference computes in float32) off float64
    tensors, so a float64 module runs in float64 throughout."""
    import torch

    orig = torch.Tensor.float

    def keep64(self, *a, **k):
        return self if self.dtype == torch.float64 else orig(self, *a, **k)

    torch.Tensor.float = keep64
    try:
        yield
    finally:
        torch.Tensor.float = orig


def job_train(out: Path, run: str, seed: int, steps: int):
    t0 = time.perf_counter()
    if run == "jax":
        _jax()
        from holoagent_tpu.training import perception, zoo

        params, losses = perception.train_tiny_sam(zoo._fixture_datasets(), steps=steps, seed=seed,
                                                   variant_name=VARIANT, lr=LR)
        zoo.save_params(out / f"jax_seed{seed}.npz", params)
        losses = [float(v) for v in losses]
    else:
        import torch

        from holoagent_tpu_torch import bridge
        from holoagent_tpu_torch.training import perception, zoo

        torch.set_num_threads(len(os.sched_getaffinity(0)))
        dev = "cuda" if run.endswith("_card") else "cpu"
        sam = None
        if not run.startswith("torch_own"):
            sam = zoo.sam_from_tree(zoo.load_params(out / f"init_seed{seed}.npz"), dev)
            if run == "torch64":
                sam = sam.double()
        ctx = _float64_forward() if run == "torch64" else contextlib.nullcontext()
        with ctx:
            sam, losses = perception.train_tiny_sam(zoo._fixture_datasets(), steps=steps, seed=seed,
                                                    variant_name=VARIANT, lr=LR, params=sam, device=dev)
        zoo.save_params(out / f"{run}_seed{seed}.npz", bridge.sam_to_numpy(sam))
    (out / f"{run}_seed{seed}.json").write_text(json.dumps({
        "run": run, "seed": seed, "steps": steps, "losses": losses,
        "last50": float(np.mean(losses[-50:])), "seconds": time.perf_counter() - t0,
    }))


def job_clip(out: Path, steps: int):
    """The JAX package's seed-0 CLIP tower at its recipe (zoo.fixture_towers)."""
    _jax()
    from holoagent_tpu.dataloader.synthetic import SyntheticScene
    from holoagent_tpu.training import perception, zoo

    t0 = time.perf_counter()
    rects = [zoo.ROOM_RECTS["two_room"], zoo.ROOM_RECTS["three_room"], SyntheticScene.two_floor_room_rects()]
    params, losses = perception.train_tiny_clip(zoo._fixture_datasets(), zoo.fixture_labels(), steps=steps, seed=0,
                                                room_rects_by_ds=rects, room_frame_jitter=2)
    zoo.save_params(out / "clip_jax_seed0.npz", params)
    (out / "clip_jax_seed0.json").write_text(json.dumps({
        "last50": float(np.mean(losses[-50:])), "seconds": time.perf_counter() - t0}))


def job_targets(out: Path):
    """The trainers' supervision, held equal: every frame's preprocessed
    image and every GT instance or structure region's pixel coordinates and
    4g x 4g mask, as the reference's trainer builds them (jax.image.resize)
    and as the port's does (ops/resize.py).  The batch draws then depend on
    these lengths alone, so equal targets give both trainers equal batches."""
    jax = _jax()
    import jax.numpy as jnp
    import torch

    from holoagent_tpu.models import sam as jsam
    from holoagent_tpu.training import zoo as jzoo
    from holoagent_tpu_torch.models import sam as tsam
    from holoagent_tpu_torch.training import perception as tperc
    from holoagent_tpu_torch.training import zoo as tzoo

    v = jsam.VARIANTS[VARIANT]
    g4 = 4 * (v.img_size // v.patch)
    res = {"frames": 0, "targets": 0, "coords_equal": True, "mask_pixels_differing": 0, "image_max_abs_diff": 0.0}
    for jds, tds in zip(jzoo._fixture_datasets(), tzoo._fixture_datasets()):
        for i in range(len(jds)):
            inst, lab = jds.gt(i)
            tinst, tlab = tds.gt(i)
            res["coords_equal"] &= bool(np.array_equal(inst, tinst) and np.array_equal(lab, tlab))
            h, w = inst.shape
            targets = [inst == iid for iid in np.unique(inst) if iid >= 0]
            targets += [(lab == li) & (inst < 0) for li in np.unique(lab[inst < 0]) if li >= 0]
            targets = [m for m in targets if m.sum() >= 30]
            for m in targets:
                want = np.asarray(jax.image.resize(jnp.asarray(m, jnp.float32), (g4, g4), "linear")) > 0.5
                got = tperc._resize(m.astype(np.float32), (g4, g4)) > 0.5
                res["mask_pixels_differing"] += int((want != got).sum())
            if targets:
                res["frames"] += 1
                res["targets"] += len(targets)
                xj = np.asarray(jsam.preprocess(jnp.asarray(jds[i].rgb)[None], v.img_size)[0])
                xt = tsam.preprocess(torch.from_numpy(np.asarray(tds[i].rgb, np.float32))[None], v.img_size)[0]
                res["image_max_abs_diff"] = max(res["image_max_abs_diff"], float(np.abs(xj - xt.numpy()).max()))
    (out / "targets.json").write_text(json.dumps(res))


def job_grads(out: Path, seed: int):
    """The first step's gradients at seed `seed`, from the JAX init and the
    port trainer's first batch: the JAX package's (eager and jitted) and
    the port's float32 ones, each leaf's max |g - g64| over its max |g64|,
    against the port's float64 gradient (read back rounded to float32: 6e-8
    of an element at most)."""
    jax = _jax()
    import jax.numpy as jnp
    import torch

    from holoagent_tpu.models import sam as jsam
    from holoagent_tpu.training import perception as jperc
    from holoagent_tpu_torch import bridge
    from holoagent_tpu_torch.models import transformer as tfm
    from holoagent_tpu_torch.training import perception as tperc
    from holoagent_tpu_torch.training import zoo as tzoo

    v = jsam.VARIANTS[VARIANT]
    tree = tzoo.load_params(out / f"init_seed{seed}.npz")
    batch = {}
    loss_fn = tperc._sam_loss

    def first_batch(sam, img, pts, gt):
        batch.setdefault("args", tuple(t.detach().clone() for t in (img, pts, gt)))
        return loss_fn(sam, img, pts, gt)

    tperc._sam_loss = first_batch
    try:
        tperc.train_tiny_sam(tzoo._fixture_datasets(), steps=1, seed=seed, variant_name=VARIANT, lr=LR,
                             params=tzoo.sam_from_tree(tree, "cpu"), device="cpu")
    finally:
        tperc._sam_loss = loss_fn

    def port_grads(dtype):
        sam = tfm.trainable(tzoo.sam_from_tree(tree, "cpu")).to(dtype)
        with _float64_forward():
            loss_fn(sam, *(t.to(dtype) for t in batch["args"])).backward()
        return bridge.flatten(bridge.sam_to_numpy(sam, leaf=lambda t: t.grad))  # read back in float32

    jtree = jax.tree.map(jnp.asarray, tree)
    jargs = tuple(jnp.asarray(t.numpy()) for t in batch["args"])
    grad = jax.grad(jperc._sam_loss)
    got = {"jax_eager": bridge.flatten(jax.tree.map(np.asarray, grad(jtree, *jargs, v))),
           "jax_jit": bridge.flatten(jax.tree.map(np.asarray, jax.jit(grad, static_argnums=4)(jtree, *jargs, v))),
           "torch": port_grads(torch.float32)}
    ref = port_grads(torch.float64)
    top = max(float(np.abs(a).max()) for a in ref.values())
    # leaves whose gradient is zero by construction (attention key biases:
    # softmax is blind to them) are read against the whole gradient's max
    zero = sorted(k for k, a in ref.items() if np.abs(a).max() < 1e-9 * top)
    res = {"seed": seed, "zero_leaves": zero}
    for run, g in got.items():
        rel = {k: float(np.abs(g[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref if k not in zero}
        res[run] = {"max": max(rel.values()), "median": float(np.median(list(rel.values()))),
                    "worst_leaf": max(rel, key=rel.get),
                    "zero_leaves_max": max((float(np.abs(g[k]).max()) / top for k in zero), default=0.0)}
    (out / f"grads_seed{seed}.json").write_text(json.dumps(res))


def job_score(out: Path, name: str, device: str):
    """fast_oracle of tower `name` with the JAX seed-0 CLIP tower, in the port on `device`."""
    import torch

    from holoagent_tpu_torch.apps import correctness_suite, query_bench
    from holoagent_tpu_torch.eval.instruction_sets import three_room_instructions
    from holoagent_tpu_torch.training import zoo

    torch.set_num_threads(len(os.sched_getaffinity(0)))
    t0 = time.perf_counter()
    clip = zoo.clip_from_tree(zoo.load_params(out / "clip_jax_seed0.npz"), device)
    sam = zoo.sam_from_tree(zoo.load_params(out / f"{name}.npz"), device)
    with tempfile.TemporaryDirectory() as tmp:
        graph_dir, gt_path, cfg, models = correctness_suite.build_graph("three_room", tmp, device, (clip, sam))
        summary = query_bench.run(str(graph_dir), three_room_instructions(), cfg, out_path=str(Path(tmp) / "q.json"),
                                  pad_gallery=512, gt_path=str(gt_path), models=models, device=device, oracle=True)
    (out / f"score_{name}.json").write_text(json.dumps({
        "fast_oracle": summary.get("top1_acc"), "recall_at_5": summary.get("recall_at_5"),
        "n_scored": summary.get("correctness", {}).get("n_scored"), "gallery_size": summary.get("gallery_size"),
        "device": device, "seconds": time.perf_counter() - t0,
    }))


# ---------------------------------------------------------------------------
# The whole study: jobs in a pool of pinned processes, then the report
# ---------------------------------------------------------------------------


def _pool(jobs, out: Path, workers: int, cores_each: int):
    """Run (argv, done_file) jobs, `workers` at a time, each process pinned
    to its own `cores_each` cores; a job whose done_file exists is skipped."""
    cpus = sorted(os.sched_getaffinity(0))
    slots = [set(cpus[i * cores_each:(i + 1) * cores_each]) for i in range(workers)]
    pending = [j for j in jobs if not j[1].exists()]
    running = {}
    failed = []
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS=str(cores_each),
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    while pending or running:
        free = [i for i in range(workers) if i not in running]
        while pending and free:
            slot = free.pop(0)
            argv, done = pending.pop(0)
            log = open(out / "logs" / (done.stem + ".log"), "w")
            proc = subprocess.Popen([sys.executable, __file__, "--out", str(out), *argv], env=env, cwd=ROOT,
                                    stdout=log, stderr=subprocess.STDOUT,
                                    preexec_fn=lambda c=slots[slot]: os.sched_setaffinity(0, c))
            running[slot] = (proc, argv, done, log, time.perf_counter())
            print(f"[spread] start {' '.join(argv)}", flush=True)
        time.sleep(2)
        for slot, (proc, argv, done, log, t0) in list(running.items()):
            if proc.poll() is None:
                continue
            log.close()
            del running[slot]
            ok = proc.returncode == 0 and done.exists()
            print(f"[spread] {'done' if ok else 'FAILED'} {' '.join(argv)} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            if not ok:
                failed.append(argv)
    return failed


def _parting(a, b):
    """First step (1-based) at which |a - b| / |a| exceeds each level, or None."""
    rel = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / np.abs(np.asarray(a, np.float64))
    out = {}
    for lvl in LEVELS:
        hit = np.nonzero(rel > lvl)[0]
        out[f"{lvl:g}"] = int(hit[0]) + 1 if len(hit) else None
    return out, rel


def _summary(values):
    v = np.asarray([x for x in values if x is not None], np.float64)
    if not len(v):
        return None
    return {"n": int(len(v)), "median": float(np.median(v)), "min": float(v.min()), "max": float(v.max()),
            "q25": float(np.percentile(v, 25)), "q75": float(np.percentile(v, 75))}


def report(out: Path, runs, seeds):
    rep = {"runs": {}, "parting": {}, "summary": {}}
    if (out / "targets.json").exists():
        rep["targets"] = json.loads((out / "targets.json").read_text())
    for run in runs:
        per = {}
        for s in seeds:
            f = out / f"{run}_seed{s}.json"
            if not f.exists():
                continue
            tr = json.loads(f.read_text())
            sc = out / f"score_{run}_seed{s}.json"
            score = json.loads(sc.read_text()) if sc.exists() else {}
            per[s] = {"last50": tr["last50"], "first": tr["losses"][0], "train_seconds": tr["seconds"],
                      "fast_oracle": score.get("fast_oracle"), "recall_at_5": score.get("recall_at_5"),
                      "losses": tr["losses"]}
        rep["runs"][run] = per
        rep["summary"][run] = {"last50": _summary([p["last50"] for p in per.values()]),
                               "fast_oracle": _summary([p["fast_oracle"] for p in per.values()]),
                               "fast_oracle_values": sorted(p["fast_oracle"] for p in per.values()
                                                            if p["fast_oracle"] is not None)}
    pairs = [("jax", "torch"), ("torch64", "torch"), ("jax", "torch64"), ("torch_card", "torch"),
             ("jax", "torch_card")]
    for s in seeds:
        got = {r: rep["runs"].get(r, {}).get(s) for r in ("jax", "torch", "torch64", "torch_card")}
        entry = {}
        rels = {}
        for a, b in pairs:
            if got[a] and got[b]:
                entry[f"{a}_vs_{b}"], rels[(a, b)] = _parting(got[a]["losses"], got[b]["losses"])
        if ("jax", "torch") in rels and ("torch64", "torch") in rels:
            # the first step at which the reference and the port part by more
            # than float64 and float32 have parted by then (above FLOOR)
            ref, fp = rels[("jax", "torch")], np.maximum.accumulate(rels[("torch64", "torch")])
            hit = np.nonzero((ref > np.maximum(fp, FLOOR)))[0]
            entry["jax_torch_beyond_float_gap"] = int(hit[0]) + 1 if len(hit) else None
            entry["float_gap_at_that_step"] = float(fp[hit[0]]) if len(hit) else None
        rep["parting"][s] = entry
    for key in [f"{a}_vs_{b}" for a, b in pairs]:
        rep["summary"][f"parting_{key}"] = {
            lvl: _summary([rep["parting"][s].get(key, {}).get(lvl) for s in seeds]) for lvl in map("{:g}".format,
                                                                                                LEVELS)}
    rep["summary"]["vs_jax"] = _overlap(rep["runs"])
    pairs = [(p["last50"], p["fast_oracle"]) for per in rep["runs"].values() for p in per.values()
             if p["fast_oracle"] is not None]
    if len(pairs) > 2:
        from scipy.stats import spearmanr

        rep["summary"]["spearman_last50_fast_oracle"] = {"n": len(pairs), "rho": float(spearmanr(*zip(*pairs))[0])}
    grads = {s: json.loads(f.read_text()) for s in seeds if (f := out / f"grads_seed{s}.json").exists()}
    if grads:
        rep["grads"] = grads
        rep["summary"]["grads_vs_float64"] = {
            run: {"max": _summary([g[run]["max"] for g in grads.values()]),
                  "median": _summary([g[run]["median"] for g in grads.values()])}
            for run in ("jax_eager", "jax_jit", "torch")}
    (out / "report.json").write_text(json.dumps(rep, indent=1))
    slim = {"targets": rep.get("targets"), "grads": rep.get("grads"), "summary": rep["summary"],
            "parting": rep["parting"],
            "per_seed": {run: {s: {k: v for k, v in p.items() if k != "losses"} for s, p in per.items()}
                         for run, per in rep["runs"].items()}}
    (out / "report_slim.json").write_text(json.dumps(slim, indent=1))
    print(json.dumps(slim, indent=1))
    return rep


def _overlap(runs: dict) -> dict:
    """Each port run's seeds against the JAX package's: two-sided
    Mann-Whitney p on ``fast_oracle`` and on the last-50 loss, and Fisher's
    exact p on the low tail (seeds under LOW ``fast_oracle``), each run
    alone and the port's float32 runs pooled."""
    from scipy.stats import fisher_exact, mannwhitneyu

    def values(per, key):
        return [p[key] for p in per.values() if p[key] is not None]

    def low(per):
        fo = values(per, "fast_oracle")
        return sum(v < LOW for v in fo), len(fo)

    ref = runs.get("jax")
    if not ref:
        return {}
    ref_low, ref_n = low(ref)
    res = {}
    for run, per in runs.items():
        if run == "jax" or not per:
            continue
        entry = {}
        for key in ("fast_oracle", "last50"):
            a, b = values(ref, key), values(per, key)
            if a and b:
                entry[f"mannwhitney_p_{key}"] = float(mannwhitneyu(a, b, alternative="two-sided").pvalue)
        n_low, n = low(per)
        entry["low_tail"] = [n_low, n]
        if n:
            entry["fisher_p_low_tail"] = float(fisher_exact([[ref_low, ref_n - ref_low], [n_low, n - n_low]]).pvalue)
        res[run] = entry
    pooled = [low(runs[r]) for r in FLOAT32_PORT_RUNS if runs.get(r)]
    if pooled:
        n_low, n = sum(x for x, _ in pooled), sum(y for _, y in pooled)
        res["port_float32_pooled"] = {
            "runs": [r for r in FLOAT32_PORT_RUNS if runs.get(r)], "low_tail": [n_low, n],
            "fisher_p_low_tail": float(fisher_exact([[ref_low, ref_n - ref_low], [n_low, n - n_low]]).pvalue)}
    res["jax_low_tail"] = [ref_low, ref_n]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", default="0-11")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--clip-steps", type=int, default=3000)
    ap.add_argument("--no-score", action="store_true")
    ap.add_argument("--score-device", default="cpu")
    ap.add_argument("--job", choices=("init", "train", "clip", "score", "targets", "grads"))
    ap.add_argument("--run", choices=RUNS)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--tower")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    (out / "logs").mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(ROOT))
    seeds = _seeds(args.seeds)
    if args.job == "init":
        return job_init(out, seeds)
    if args.job == "train":
        return job_train(out, args.run, args.seed, args.steps)
    if args.job == "clip":
        return job_clip(out, args.clip_steps)
    if args.job == "score":
        return job_score(out, args.tower, args.score_device)
    if args.job == "targets":
        return job_targets(out)
    if args.job == "grads":
        return job_grads(out, args.seed)
    runs = [r for r in args.runs.split(",") if r]
    cores_each = max(1, len(os.sched_getaffinity(0)) // args.workers)
    t0 = time.perf_counter()
    failed = _pool([(["--job", "init", "--seeds", args.seeds], out / f"init_seed{seeds[-1]}.npz")],
                   out, 1, cores_each)
    train = [(["--job", "train", "--run", r, "--seed", str(s), "--steps", str(args.steps)],
              out / f"{r}_seed{s}.json") for r in runs for s in seeds]
    train.insert(0, (["--job", "targets"], out / "targets.json"))
    if "jax" in runs and "torch" in runs:
        train[1:1] = [(["--job", "grads", "--seed", str(s)], out / f"grads_seed{s}.json") for s in seeds]
    if not args.no_score:
        train.insert(0, (["--job", "clip", "--clip-steps", str(args.clip_steps)], out / "clip_jax_seed0.json"))
    failed += _pool(train, out, args.workers, cores_each)
    if not args.no_score:
        failed += _pool([(["--job", "score", "--tower", f"{r}_seed{s}", "--score-device", args.score_device],
                          out / f"score_{r}_seed{s}.json")
                         for r in runs for s in seeds if (out / f"{r}_seed{s}.npz").exists()],
                        out, args.workers, cores_each)
    report(out, runs, seeds)
    print(f"[spread] {time.perf_counter() - t0:.1f} s, failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
