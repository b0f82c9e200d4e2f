"""HMSG accuracy evaluation against a GT graph.

Metric-for-metric rebuild of the reference harness
(reference fsr_vln/memory/hmsg/eval/hm3dsem_evaluator.py): floor bound
matching (:193-263), room BEV overlap precision/recall (:265-399), object
instance association by 3-D bbox IoU + point overlap with Hungarian matching
and accuracy/precision/recall AUC over thresholds (:401-556), and semantic
top-k accuracy with normalized AUC (:557-589).

The port's own copy of holoagent_tpu/eval/evaluator.py: numpy and scipy on
the host, over the port's HMSGraph.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..memory.hmsg import HMSGraph
from .gt import GTGraph


def _bbox_iou_3d(c1, d1, c2, d2) -> float:
    lo1, hi1 = np.asarray(c1) - np.asarray(d1) / 2, np.asarray(c1) + np.asarray(d1) / 2
    lo2, hi2 = np.asarray(c2) - np.asarray(d2) / 2, np.asarray(c2) + np.asarray(d2) / 2
    inter = np.prod(np.maximum(np.minimum(hi1, hi2) - np.maximum(lo1, lo2), 0.0))
    v1, v2 = np.prod(np.maximum(hi1 - lo1, 0)), np.prod(np.maximum(hi2 - lo2, 0))
    return float(inter / max(v1 + v2 - inter, 1e-12))


_KEY_BITS = 21
_KEY_BIAS = 1 << (_KEY_BITS - 1)


def _pack_cells(cells: np.ndarray) -> np.ndarray:
    """Pack integer grid coords (N, 2|3) into int64 keys (21 bits/axis)."""
    c = cells.astype(np.int64) + _KEY_BIAS
    key = c[..., 0]
    for d in range(1, cells.shape[-1]):
        key = (key << _KEY_BITS) | c[..., d]
    return key


def _neighbor_hit_frac(a: np.ndarray, b: np.ndarray, radius: float) -> float:
    """Fraction of `a` points whose grid cell has a `b` point in the adjacent
    3^dim cell block — vectorized over packed int64 voxel keys (np.isin)
    instead of per-point Python dict probes."""
    dim = a.shape[1]
    ca = np.floor(a / radius).astype(np.int64)
    b_keys = np.unique(_pack_cells(np.floor(b / radius).astype(np.int64)))
    rng = (-1, 0, 1)
    if dim == 3:
        offs = np.array([(i, j, k) for i in rng for j in rng for k in rng], np.int64)
    else:
        offs = np.array([(i, j) for i in rng for j in rng], np.int64)
    keys = _pack_cells(ca[:, None, :] + offs[None])  # (N, 3^dim)
    hits = np.isin(keys, b_keys).any(axis=1)
    return float(hits.mean())


def _overlap_ratio(p1: np.ndarray, p2: np.ndarray, radius: float) -> float:
    """max-direction fraction of points with a neighbor within radius
    (reference graph_utils.py:620-664 semantics), computed by grid rounding."""
    if len(p1) == 0 or len(p2) == 0:
        return 0.0
    # subsample for tractability
    a = p1[:: max(len(p1) // 4000, 1)]
    b = p2[:: max(len(p2) // 4000, 1)]
    return max(_neighbor_hit_frac(a, b, radius), _neighbor_hit_frac(b, a, radius))


class HMSGEvaluator:
    def __init__(self, gt: GTGraph):
        self.gt = gt
        self.metrics: Dict = {}

    # ------------------------------------------------------------- floors

    def evaluate_floors(self, pred: HMSGraph) -> Dict:
        """Match predicted floor [zero, zero+height] bounds to GT levels."""
        res = {"num_gt": len(self.gt.floors), "num_pred": len(pred.floors)}
        errs = []
        for gt_f in self.gt.floors:
            best = None
            for pf in pred.floors:
                lo, hi = pf.floor_zero_level, pf.floor_zero_level + pf.floor_height
                e = abs(lo - gt_f.lower) + abs(hi - gt_f.upper)
                best = e if best is None or e < best else best
            if best is not None:
                errs.append(best)
        res["mean_bound_error"] = float(np.mean(errs)) if errs else float("inf")
        res["matched"] = sum(1 for e in errs if e < 1.0)
        self.metrics["floors"] = res
        return res

    # -------------------------------------------------------------- rooms

    def evaluate_rooms(self, pred: HMSGraph, overlap_thresh: float = 0.5) -> Dict:
        gt_rooms = self.gt.rooms
        pred_rooms = pred.rooms
        if not gt_rooms or not pred_rooms:
            res = {"precision": 0.0, "recall": 0.0, "num_gt": len(gt_rooms), "num_pred": len(pred_rooms)}
            self.metrics["rooms"] = res
            return res
        over_pred = np.zeros((len(pred_rooms), len(gt_rooms)))
        over_gt = np.zeros_like(over_pred)
        for gi, gr in enumerate(gt_rooms):
            for pi, pr in enumerate(pred_rooms):
                mean_h = pr.room_zero_level + pr.room_height / 2
                if not (gr.min_height - 0.5 <= mean_h <= gr.max_height + 0.5):
                    continue
                p2d = np.asarray(pr.vertices, np.float64)
                g2d = np.asarray(gr.bev_points, np.float64)
                ratio_p = _share(g2d, p2d, 0.1)  # pred points covered by gt
                ratio_g = _share(p2d, g2d, 0.1)  # gt covered by pred
                over_pred[pi, gi] = ratio_p
                over_gt[pi, gi] = ratio_g
        # a pred room is correct if it mostly lies in some gt room; a gt room
        # is found if mostly covered by some pred room
        precision = float(np.mean(over_pred.max(axis=1) > overlap_thresh))
        recall = float(np.mean(over_gt.max(axis=0) > overlap_thresh))
        res = {
            "precision": precision,
            "recall": recall,
            "num_gt": len(gt_rooms),
            "num_pred": len(pred_rooms),
            "overlap_matrix": over_pred.tolist(),
        }
        self.metrics["rooms"] = res
        return res

    # ------------------------------------------------------------ objects

    def evaluate_objects(
        self,
        pred: HMSGraph,
        gt_text_feats: np.ndarray = None,
        gt_classes: Sequence[str] = (),
        top_k_spec: Sequence[int] = (1, 3, 5, 10),
        eval_metric: str = "iou",
    ) -> Dict:
        gt_objs = self.gt.objects
        pred_objs = pred.objects
        res: Dict = {"num_gt": len(gt_objs), "num_pred": len(pred_objs)}
        if not gt_objs or not pred_objs:
            res.update({"auc": 0.0, "prec_at_50": 0.0, "rec_at_50": 0.0})
            self.metrics["objects"] = res
            return res
        iou_m = np.zeros((len(pred_objs), len(gt_objs)))
        ovl_m = np.zeros_like(iou_m)
        for gi, go in enumerate(gt_objs):
            for pi, po in enumerate(pred_objs):
                pts = np.asarray(po.pcd_points)
                c = (pts.min(0) + pts.max(0)) / 2
                d = pts.max(0) - pts.min(0)
                iou = _bbox_iou_3d(go.center, go.dims, c, d)
                iou_m[pi, gi] = iou
                if iou > 0.0 and len(go.points):
                    ovl_m[pi, gi] = _overlap_ratio(pts, go.points, 0.1)
        assoc = iou_m if eval_metric == "iou" else ovl_m
        row, col = linear_sum_assignment(assoc, maximize=True)
        matched_overlap = ovl_m[row, col]
        threshs = np.linspace(0.0, 1.0, 11, endpoint=True)
        accs, precs, recs = [], [], []
        for t in threshs:
            tp = int(np.sum(matched_overlap > t))
            fp = len(pred_objs) - tp
            fn = len(gt_objs) - tp
            precs.append(tp / max(tp + fp, 1))
            recs.append(tp / max(tp + fn, 1))
            accs.append(tp / max(tp + fp + fn, 1))
        res["auc"] = float(np.trapezoid(accs, threshs))
        res["prec_at_50"] = float(precs[5])
        res["rec_at_50"] = float(recs[5])
        res["prec_curve"] = precs
        res["rec_curve"] = recs
        # ----- per-GT split/merge diagnostic (the reference discards the
        # Hungarian assignment, hm3dsem_evaluator.py:401-556; keeping it shows
        # WHICH objects fragment or leak so the merge fold can be tuned)
        claim_thresh = 0.25
        assigned = {int(g): int(p) for p, g in zip(row, col)}
        pred_claims = (ovl_m > claim_thresh).sum(axis=1)  # GTs per pred
        diag = []
        for gi, go in enumerate(gt_objs):
            claimants = np.nonzero(ovl_m[:, gi] > claim_thresh)[0]
            pi = assigned.get(gi, -1)
            ov = float(ovl_m[pi, gi]) if pi >= 0 else 0.0
            if pi < 0 or ov <= claim_thresh:
                status = "miss"
            elif len(claimants) > 1:
                status = "split"  # extra fragments also cover this GT
            elif pred_claims[pi] > 1:
                status = "merged"  # its pred leaks onto other GTs too
            elif ov <= 0.5:
                status = "weak"
            else:
                status = "ok"
            diag.append({
                "gt": getattr(go, "category", str(gi)),
                "matched_overlap": round(ov, 3),
                "n_claimant_preds": int(len(claimants)),
                "status": status,
            })
        res["per_gt"] = diag
        res["n_split"] = sum(d["status"] == "split" for d in diag)
        res["n_merged"] = sum(d["status"] == "merged" for d in diag)
        res["n_miss"] = sum(d["status"] == "miss" for d in diag)
        # predictions claiming no GT at all (clutter fragments -> fp at every
        # threshold; these are what depress precision when recall is 1.0)
        res["n_unclaimed_pred"] = int(np.sum((ovl_m > claim_thresh).sum(axis=1) == 0))
        # semantic top-k over matched pairs (reference :557-589)
        if gt_text_feats is not None and len(gt_classes):
            success = {k: 0 for k in top_k_spec}
            for pi, gi in zip(row, col):
                emb = np.asarray(pred_objs[pi].embedding, np.float32)
                emb = emb / max(np.linalg.norm(emb), 1e-9)
                tf = gt_text_feats / np.maximum(
                    np.linalg.norm(gt_text_feats, axis=-1, keepdims=True), 1e-9
                )
                sims = tf @ emb
                order = np.argsort(-sims)
                for k in top_k_spec:
                    names = [gt_classes[i] for i in order[:k]]
                    if gt_objs[gi].category in names:
                        success[k] += 1
            top_k_acc = {k: v / len(col) for k, v in success.items()}
            norm_k = [k / len(gt_classes) for k in top_k_spec]
            res["semantic_top_k"] = top_k_acc
            res["semantic_auc"] = float(np.trapezoid(list(top_k_acc.values()), norm_k))
        self.metrics["objects"] = res
        return res

    def evaluate_all(self, pred: HMSGraph, gt_text_feats=None, gt_classes=()) -> Dict:
        self.evaluate_floors(pred)
        self.evaluate_rooms(pred)
        self.evaluate_objects(pred, gt_text_feats, gt_classes)
        return self.metrics


def _share(ref: np.ndarray, query: np.ndarray, radius: float) -> float:
    """Fraction of `query` 2-D points within `radius` of some `ref` point."""
    if len(query) == 0 or len(ref) == 0:
        return 0.0
    return _neighbor_hit_frac(query, ref, radius)
