"""Long hierarchical query dataset generation + scoring.

Rebuild of reference fsr_vln/memory/hmsg/utils/long_query_eval_utils.py:
`generate_long_queries` (:72-103, "<object> in region <room> on floor <k>"
from the GT tree leaves), `generate_gt_object_nodes` (:104-147, a query can
have MANY correct targets — every same-category object in every same-category
room on that floor), `filter/aggregate_duplicates_long_queries` (:149-196),
and the per-level accuracy accounting of the benchmark scripts.  Works
directly on our GTGraph (eval.gt) instead of a networkx tree.

The port's own copy of holoagent_tpu/eval/long_query.py (numpy).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .gt import GTGraph


@dataclass
class LongQuery:
    text: str
    floor_id: int
    room_category: str
    object_category: str
    # every valid (floor_id, room_id, object_id) answer (reference :104-147)
    answers: List[Tuple[int, int, int]] = field(default_factory=list)


def generate_long_queries(gt: GTGraph) -> List[LongQuery]:
    """One query per unique (object category, room category, floor), with the
    full multi-answer set aggregated (reference :72-103 + :175-196)."""
    room_by_id = {r.id: r for r in gt.rooms}
    agg: Dict[Tuple[str, str, int], LongQuery] = {}
    for obj in gt.objects:
        room = room_by_id.get(obj.region_id)
        if room is None:
            continue
        key = (obj.category, room.category, obj.floor_id)
        if key not in agg:
            # floor number in the TEXT is 1-indexed: the engine's integer
            # floor parse is 1-indexed ("floor 1" = lowest storey, reference
            # graph.py:2236 `zero_level_order_ids[int(query) - 1]`), while the
            # reference's generator emits the raw 0-based floor id
            # (long_query_eval_utils.py:96) — feeding its own parser the wrong
            # storey on every multi-floor query.  We fix the mismatch; the
            # scored floor_id stays 0-based.
            agg[key] = LongQuery(
                text=f"{obj.category} in region {room.category} on floor {obj.floor_id + 1}",
                floor_id=obj.floor_id,
                room_category=room.category,
                object_category=obj.category,
            )
        agg[key].answers.append((obj.floor_id, room.id, obj.id))
    return list(agg.values())


def answer_object_ids(q: LongQuery) -> List[int]:
    return [a[2] for a in q.answers]


@dataclass
class LongQueryReport:
    n_queries: int
    floor_acc: float
    room_acc: float
    object_acc: float
    per_query: List[Dict]


def score_long_queries(
    queries: Sequence[LongQuery],
    predictions: Sequence[Dict],
    gt: GTGraph,
    object_match_radius: float = 0.5,
) -> LongQueryReport:
    """Score engine outputs against the multi-answer sets.

    predictions[i]: dict with optional keys
      "floor_id"      int   predicted floor
      "room_center"   (2,)  BEV center of the chosen room (m)
      "object_center" (3,)  center of the chosen object (m)
    Room credit: the predicted room center falls inside (within
    `object_match_radius` of) the BEV footprint of ANY answer room.  Object
    credit: predicted center within `object_match_radius` of ANY answer
    object's center (position-based, since predicted instance ids don't map
    to GT ids; mirrors the evaluator's center-distance association)."""
    if len(predictions) != len(queries):
        raise ValueError(
            f"{len(predictions)} predictions for {len(queries)} queries — "
            "pad missing predictions with {} rather than dropping them"
        )
    room_by_id = {r.id: r for r in gt.rooms}
    obj_by_id = {o.id: o for o in gt.objects}
    n = len(queries)
    fl_ok = rm_ok = ob_ok = 0
    per_query: List[Dict] = []
    for q, pred in zip(queries, predictions):
        fl = pred.get("floor_id") is not None and any(
            pred["floor_id"] == a[0] for a in q.answers
        )
        rm = False
        if pred.get("room_center") is not None:
            rc = np.asarray(pred["room_center"], np.float64)[:2]
            for a in q.answers:
                room = room_by_id[a[1]]
                d = np.linalg.norm(room.bev_points[:, :2] - rc[None], axis=1)
                if d.min() <= object_match_radius or _inside_hull(
                    room.bev_points[:, :2], rc
                ):
                    rm = True
                    break
        ob = False
        if pred.get("object_center") is not None:
            oc = np.asarray(pred["object_center"], np.float64)
            for a in q.answers:
                gt_o = obj_by_id[a[2]]
                # in-box criterion (the box-level analog of the reference
                # evaluator's iou>0 association, hm3dsem_evaluator.py:446-457):
                # mapped clouds are observed SURFACES, so a fixed-radius
                # center test fails perfect answers on any object larger than
                # the radius; credit = center inside the GT aabb inflated by
                # the tolerance per side
                half = np.asarray(gt_o.dims, np.float64) / 2.0 + object_match_radius / 2.0
                if (np.abs(np.asarray(gt_o.center, np.float64) - oc) <= half).all():
                    ob = True
                    break
        fl_ok += fl
        rm_ok += rm
        ob_ok += ob
        per_query.append(
            {"query": q.text, "floor": bool(fl), "room": bool(rm), "object": bool(ob)}
        )
    return LongQueryReport(
        n_queries=n,
        floor_acc=fl_ok / max(n, 1),
        room_acc=rm_ok / max(n, 1),
        object_acc=ob_ok / max(n, 1),
        per_query=per_query,
    )


def _inside_hull(points2d: np.ndarray, p: np.ndarray) -> bool:
    """Point-in-footprint test: inside the axis-aligned bounds AND within the
    85th-percentile radius of the footprint centroid (cheap, hull-free)."""
    if len(points2d) < 3:
        return False
    lo, hi = points2d.min(0), points2d.max(0)
    if np.any(p < lo) or np.any(p > hi):
        return False
    c = points2d.mean(0)
    r85 = np.percentile(np.linalg.norm(points2d - c[None], axis=1), 85)
    return bool(np.linalg.norm(p - c) <= r85 + 1e-9)
