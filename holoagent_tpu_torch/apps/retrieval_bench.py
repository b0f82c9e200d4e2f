"""VPR retrieval throughput benchmark (counterpart of
holoagent_tpu/apps/retrieval_bench.py): text features against an object
gallery with negative-prompt class-argmax filtering and top-k
(``ops.retrieval.class_filtered_topk``), all queries of a batch in one
``torch.func.vmap`` program, timed by ``utils.benchtime.time_device_fn``.
Recall parity: the float64 exact top-k under the same filter gives
``parity_at_k``; one planted nearest neighbour per query gives
``planted_recall_at_1``.

  python -m holoagent_tpu_torch.apps.retrieval_bench [--gallery 4096] [--batch 64] [--device cpu]

The gallery, queries and negatives are drawn with numpy from seed 0 (the
JAX package draws them with ``jax.random``).  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..ops.retrieval import class_filtered_topk
from ..utils.benchtime import time_device_fn


def unit_rows(a: np.ndarray) -> np.ndarray:
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def make_inputs(gallery: int, batch: int, dim: int, negatives: int, seed: int = 0):
    """(gallery (G, D), queries (B, D), negatives (N, D), planted (B,)) in
    float32, unit rows.  Query i's planted neighbour is gallery row
    planted[i] = query + 0.3 x a unit noise vector, renormalised."""
    rng = np.random.default_rng(seed)
    g = unit_rows(rng.standard_normal((gallery, dim), np.float32))
    q = unit_rows(rng.standard_normal((batch, dim), np.float32))
    neg = unit_rows(rng.standard_normal((negatives, dim), np.float32))
    planted = rng.choice(gallery, size=batch, replace=False)
    noise = unit_rows(rng.standard_normal(q.shape).astype(np.float32))
    g[planted] = unit_rows(q + 0.3 * noise)
    return g, q, neg, planted


def retrieve(queries, gallery, negatives, valid, k: int):
    """Top-k gallery indices (B, k) for every query: the query's class is row
    0 of [query ++ negatives], and must win the class argmax of an
    instance for the instance to score."""

    def one(qv):
        class_feats = torch.cat([qv[None], negatives], dim=0)
        return class_filtered_topk(gallery, valid, qv, class_feats, 0, k)[1]

    return torch.func.vmap(one)(queries)


def exact_topk(q: np.ndarray, g: np.ndarray, neg: np.ndarray, k: int):
    """The float64 reference of `retrieve` for one query: (indices (k,),
    scores over the gallery with -inf where filtered out)."""
    q, g, neg = (np.asarray(a, np.float64) for a in (q, g, neg))
    cls = np.concatenate([q[None], neg], axis=0) @ g.T  # (C+1, G)
    sims = np.where(cls.argmax(0) == 0, q @ g.T, -np.inf)
    return np.argsort(-sims, kind="stable")[:k], sims


def run(gallery: int = 4096, batch: int = 64, dim: int = 768, topk: int = 5, negatives: int = 20,
        iters: int = 50, device: DeviceLike = None) -> dict:
    """The benchmark on `device`; returns its JSON line's fields, plus
    ``device_idx`` (B, k) and the inputs for the caller's own checks."""
    dev = resolve(device)
    gn, qn, nn_, planted = make_inputs(gallery, batch, dim, negatives)
    g, q, neg = (torch.from_numpy(a).to(dev) for a in (gn, qn, nn_))
    valid = torch.ones(gallery, dtype=torch.bool, device=dev)
    timing = time_device_fn(lambda *a: retrieve(*a, k=topk), (q, g, neg, valid), iters=iters)
    sec = timing.seconds
    device_idx = retrieve(q, g, neg, valid, topk).cpu().numpy()
    parity, hit1 = [], 0
    for i in range(batch):
        exact, _ = exact_topk(qn[i], gn, nn_, topk)
        dev_i = device_idx[i][device_idx[i] >= 0]
        parity.append(len(set(exact.tolist()) & set(dev_i.tolist())) / topk)
        hit1 += int(len(dev_i) > 0 and dev_i[0] == planted[i])
    return {
        "metric": "vpr_retrieval_qps",
        "value": round(batch / sec, 1),
        "unit": f"queries/s ({gallery}-object gallery, dim {dim}, top-{topk}, {negatives} negative prompts, "
                f"batch {batch})",
        "seconds_per_batch": sec,
        "parity_at_k": round(float(np.mean(parity)), 4),
        "planted_recall_at_1": round(hit1 / batch, 4),
        "timing": timing.kind,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "device_idx": device_idx, "inputs": (gn, qn, nn_, planted),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gallery", type=int, default=4096, help="objects in the scene")
    ap.add_argument("--batch", type=int, default=64, help="queries per dispatch")
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--negatives", type=int, default=20)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.gallery, args.batch, args.dim, args.topk, args.negatives, args.iters, args.device)
    line = {k: v for k, v in res.items() if k not in ("device_idx", "inputs")}
    print(json.dumps(line))
    return res


if __name__ == "__main__":
    main()
