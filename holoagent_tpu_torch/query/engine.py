"""FSR (fast-to-slow reasoning) query engine over an HMSGraph
(counterpart of holoagent_tpu/query/engine.py).

Fast path = hierarchical CLIP retrieval (floor -> room -> object) with
negative-prompt class-argmax filtering, the rebuild of
reference fsr_vln/memory/hmsg/graph/graph.py:2216-2257 (query_floor),
:3164-3272 (query_hmsg_room), :3056-3161 (query_hmsg_object) and
:3483-3591 (query_hierarchy_protected_icra).  Slow path = VLM refinement
(object-in-image check -> gallery rethinking -> re-matching), the rebuild of
:2578-3054 (query_room_obj_slow_reasoning) over a pluggable VLM backend
(query/vlm_backend.py: ClipVLM on the card, or the GT-backed OracleVLM).
Per-stage wall-clock is reported in the reference's res_dict schema
(LLM_Parse_Time / FastMatching / ObjectInImageCheck / VLM_Rethinking /
Re_Matching / Total_Time).  Text features come from the CLIP text tower,
on the tower's own attention route (``CLIPText.impl``: kernel K2's causal
mode on the card for the production towers); the object gallery lives on
the engine's device.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..memory.hmsg import HMSGraph
from ..memory.nodes import Object, Room
from ..models import clip as clip_mod
from ..ops.retrieval import negative_prompt_topk
from .parser import ParsedQuery, RuleParser
from .vlm_backend import NullVLM, VLMBackend

DEFAULT_NEGATIVE_LABELS = ["background"]
DEVICE_GALLERY_MIN = 512  # floor-wide galleries this large rank on the device
GALLERY_BUDGET = 24  # views the slow path shows the VLM (reference graph.py:2896-2897)


class FSRQueryEngine:
    """Queries over `graph` with the CLIP text tower `text`, on `device`
    (the card unless the caller asks for the CPU; `text` must be there).
    The slow path reads keyframe images through `image_provider` (img_id ->
    image; without it the slow path returns the fast pick) and saves the
    objects it refines under ``<update_dir>/objects_update``."""

    def __init__(
        self,
        graph: HMSGraph,
        text: clip_mod.CLIPText,
        tokenizer,
        vlm: Optional[VLMBackend] = None,
        parser=None,
        device: DeviceLike = None,
        image_provider: Optional[Callable[[int], object]] = None,
        update_dir: Optional[str] = None,
    ):
        self.device = resolve(device)
        if text.tok_emb.device.type != self.device.type:
            raise ValueError(f"text tower is on {text.tok_emb.device}, the engine on {self.device}")
        self.g = graph
        self.text = text
        self.tok = tokenizer
        self.variant = text.variant
        self.vlm = vlm or NullVLM()
        self.parser = parser or RuleParser()
        self.image_provider = image_provider
        self.update_dir = update_dir
        self._text_cache: Dict[str, np.ndarray] = {}
        objs = graph.objects
        if objs:
            embs = np.stack([np.asarray(o.embedding, np.float32) for o in objs])
        else:
            embs = np.zeros((0, self.variant.embed_dim), np.float32)
        self._obj_embs = torch.as_tensor(embs, device=self.device)
        self._view_by_id = {v.view_id: v for v in graph.views}
        self._obj_by_id = {o.object_id: o for o in graph.objects}

    # ------------------------------------------------------------------ text

    def text_feats(self, texts: Sequence[str]) -> np.ndarray:
        missing = [t for t in texts if t not in self._text_cache]
        if missing:
            f = clip_mod.text_features_multi_template(self.text, self.tok, missing).cpu().numpy()
            for t, e in zip(missing, f):
                self._text_cache[t] = e
        return np.stack([self._text_cache[t] for t in texts])

    # ----------------------------------------------------------------- floors

    def query_floor(self, query: Optional[str]) -> int:
        """Reference graph.py:2216-2257: integer parse first, else CLIP over
        'floor i' names; floors ranked by zero level."""
        if query is None:
            return -1
        zero = [f.floor_zero_level for f in self.g.floors]
        order = np.argsort(zero)
        try:
            q = int(str(query).strip())
            # 1-indexed ("floor 1" = lowest); a literal 0 also means the
            # lowest storey
            return int(order[max(q - 1, 0) if q >= 0 else q])
        except (ValueError, IndexError):
            pass
        names = [f"floor {i}" for i in range(len(self.g.floors))]
        tf = self.text_feats([str(query)])
        fe = self.text_feats(names)
        return int(order[int(np.argmax(tf @ fe.T))])

    # ------------------------------------------------------------------ rooms

    def _rooms_list(self, floor_id: int) -> List[Room]:
        return self.g.rooms if floor_id < 0 else self.g.floors[floor_id].rooms

    def query_room(
        self, query: Optional[str], floor_id: int = -1, method: str = "label"
    ) -> List[int]:
        """Local room indices ranked by match (reference query_hmsg_room)."""
        rooms = self._rooms_list(floor_id)
        if not rooms:
            return []
        valid_text = bool(query) and "unknown" not in str(query).lower()
        if not valid_text:
            method = "view_embedding"
            query = query or ""
        if method == "label" and valid_text:
            tf = self.text_feats([str(query)])[0]
            re_ = self.text_feats([r.name for r in rooms])
            sims = re_ @ tf
            order = np.argsort(-sims)
            top = [int(order[0])]
            for i in order[1:]:
                if abs(sims[i] - sims[order[0]]) < 1e-3:
                    top.append(int(i))
            return top
        # view-embedding: per-room max over representative view embeddings
        tf = self.text_feats([str(query)])[0] if query else np.zeros(self.variant.embed_dim)
        sims = []
        for r in rooms:
            if r.embeddings:
                sims.append(float(np.max(np.stack(r.embeddings) @ tf)))
            else:
                sims.append(-np.inf)
        order = np.argsort(-np.asarray(sims))
        k = 5 if valid_text else 10
        return [int(i) for i in order[: min(len(rooms), k)]]

    # ---------------------------------------------------------------- objects

    def query_object(
        self,
        query: Optional[str],
        floor_id: int = -1,
        room_ids: Sequence[int] = (),
        top_k: int = 1,
        negative_prompt: Sequence[str] = (),
    ) -> Tuple[List[int], List[int], List[float]]:
        """(global object indices, local room indices, scores) — reference
        query_hmsg_object semantics incl. negative-prompt class-argmax gate."""
        if not query or not self.g.objects:
            return [], [], []
        negative_prompt = list(negative_prompt)
        if query in negative_prompt:
            query_id = negative_prompt.index(query)
            cats = negative_prompt
        else:
            query_id = 0
            cats = [query, *negative_prompt]
        tf = self.text_feats(cats)  # (C, D)
        rooms = self._rooms_list(floor_id)
        if room_ids:
            objects: List[Object] = []
            obj_rooms: List[int] = []
            for ri in room_ids:
                objects.extend(rooms[ri].objects)
                obj_rooms.extend([int(ri)] * len(rooms[ri].objects))
        else:
            objects = list(self.g.objects)
            room_index = {r.room_id: i for i, r in enumerate(rooms)}
            obj_rooms = [room_index.get(o.room_id, -1) for o in objects]
        if not objects:
            return [], [], []
        if (
            not room_ids
            and negative_prompt
            and len(objects) >= DEVICE_GALLERY_MIN
            and self._obj_embs.shape[0] == len(objects)
        ):
            # large floor-wide galleries score on the device: one
            # matmul/argmax/top-k over the resident gallery
            k = min(top_k, len(objects))
            scores_d, idx_d = negative_prompt_topk(
                self._obj_embs,
                torch.ones(len(objects), dtype=torch.bool, device=self.device),
                torch.as_tensor(tf, device=self.device),
                query_id,
                k,
            )
            order, sim_q = idx_d.cpu().numpy()[:k], scores_d.cpu().numpy()[:k]
            real = order >= 0  # drop filler lanes when < k pass the gate
            order, sim_q = order[real], sim_q[real]
            out_rooms = [obj_rooms[i] for i in order]
            return [int(i) for i in order], out_rooms, [float(s) for s in sim_q]
        embs = np.stack([np.asarray(o.embedding, np.float32) for o in objects])
        sim = tf @ embs.T  # (C, O)
        order = np.argsort(-sim[query_id])[:top_k]
        if negative_prompt:
            cls = np.argmax(sim, axis=0)
            eligible = np.where(cls == query_id)[0]
            if len(eligible):
                order = eligible[np.argsort(-np.max(sim, axis=0)[eligible])][:top_k]
        gidx = {id(o): i for i, o in enumerate(self.g.objects)}
        out_idx = [gidx[id(objects[i])] for i in order]
        out_rooms = [obj_rooms[i] for i in order]
        out_scores = [float(sim[query_id][i]) for i in order]
        return out_idx, out_rooms, out_scores

    # ------------------------------------------------------------- hierarchy

    def query_hierarchy(
        self,
        instruction: str,
        top_k: int = 1,
        use_slow: bool = False,
        negative_labels: Optional[List[str]] = None,
    ):
        """Full FSR query (reference query_hierarchy_protected_icra).

        Returns (floor, rooms, objects, res_dict)."""
        negative_labels = (
            list(negative_labels) if negative_labels is not None else list(DEFAULT_NEGATIVE_LABELS)
        )
        t0 = time.perf_counter()
        parsed: ParsedQuery = self.parser(instruction)
        llm_parse_time = time.perf_counter() - t0
        floor_id = self.query_floor(parsed.floor) if parsed.floor is not None else -1

        if use_slow:
            res, object_ids, room_ids = self.slow_reasoning(
                instruction,
                parsed.room or "",
                parsed.object or "",
                negative_prompt=negative_labels,
                floor_id=floor_id,
            )
            res["LLM_Parse_Time"] = llm_parse_time
        else:
            t1 = time.perf_counter()
            room_ids = (
                self.query_room(parsed.room, floor_id=floor_id, method="label")
                if parsed.room is not None
                else []
            )
            object_ids, room_ids, scores = (
                self.query_object(
                    parsed.object,
                    floor_id=floor_id,
                    room_ids=room_ids,
                    top_k=top_k,
                    negative_prompt=negative_labels,
                )
                if parsed.object is not None
                else ([], [], [])
            )
            res = {
                "room_query": parsed.room,
                "object_query": parsed.object,
                "negative_labels": negative_labels,
                "LLM_Parse_Time": llm_parse_time,
                "FastMatching": time.perf_counter() - t1,
                "ObjectInImageCheck": 0.0,
                "VLM_Rethinking": 0.0,
                "Re_Matching": 0.0,
            }
            res["Total_Time"] = res["FastMatching"]
            res["scores"] = scores
        rooms = self._rooms_list(floor_id)
        return (
            self.g.floors[floor_id] if floor_id >= 0 else None,
            [rooms[k] for k in room_ids if 0 <= k < len(rooms)],
            [self.g.objects[i] for i in object_ids],
            res,
        )

    # -------------------------------------------------------------- slow path

    def slow_reasoning(
        self,
        instruction: str,
        room_query: str,
        object_query: str,
        negative_prompt: List[str],
        floor_id: int = -1,
        top_k: int = 5,
    ):
        """VLM-refined retrieval (reference query_room_obj_slow_reasoning):
        the fast pick, checked in its best view; if rejected (or without an
        anchor view), the VLM rethinks over the floor's view gallery, and the
        object is re-matched inside the chosen view.  Returns (res_dict,
        global object indices, local room indices)."""
        res = {
            "room_query": room_query,
            "object_query": object_query,
            "negative_labels": negative_prompt,
            "ObjectInImageCheck": 0.0,
            "VLM_Rethinking": 0.0,
            "Re_Matching": 0.0,
        }
        t_fast = time.perf_counter()
        room_ids = self.query_room(room_query, floor_id=floor_id, method="label")
        object_ids, obj_room_ids, scores = self.query_object(
            object_query,
            floor_id=floor_id,
            room_ids=room_ids,
            top_k=top_k,
            negative_prompt=negative_prompt,
        )
        res["FastMatching"] = time.perf_counter() - t_fast
        res["scores"] = scores
        if not object_ids:
            res["Total_Time"] = res["FastMatching"]
            return res, object_ids, obj_room_ids

        best_object = self.g.objects[object_ids[0]]
        best_view = self._view_by_id.get(best_object.best_view_id)
        if self.image_provider is None:
            res["Total_Time"] = res["FastMatching"]
            return res, object_ids, obj_room_ids

        label = object_query
        if best_view is not None:
            t_check = time.perf_counter()
            in_view = self.vlm.detect_object(self.image_provider(best_view.img_id), label)
            res["ObjectInImageCheck"] = time.perf_counter() - t_check
            if in_view:
                res["Total_Time"] = res["FastMatching"] + res["ObjectInImageCheck"]
                return res, object_ids, obj_room_ids
        # fast pick rejected, or unverifiable (no anchor view): rethink

        # --- VLM rethinking over the floor-wide view gallery
        t_re = time.perf_counter()
        rooms = self._rooms_list(floor_id)
        gallery_ids: List[int] = []
        gallery_embs: List[np.ndarray] = []
        for room in rooms:
            gallery_ids.extend(room.sample_images)
            gallery_embs.extend([np.asarray(e, np.float32) for e in room.clip_embeddings])
        if not gallery_ids:
            res["Total_Time"] = res["FastMatching"] + res["ObjectInImageCheck"]
            return res, object_ids, obj_room_ids
        tf = self.text_feats([label])[0]
        sims = np.stack(gallery_embs) @ tf
        clip_best = int(gallery_ids[int(np.argmax(sims))])
        k = min(GALLERY_BUDGET, len(sims))
        top_idx = np.argsort(sims)[-k:][::-1]
        gallery_imgs = [self.image_provider(gallery_ids[i]) for i in top_idx]
        anchor = [best_view.img_id] if best_view is not None else []
        rethink = getattr(self.vlm, "rethink_wave", None)
        if rethink is not None:
            # one wave: the gallery frame choice and the checks of the known
            # candidates (anchor, CLIP-best); a follow-up check only when the
            # chosen gallery frame is a new candidate
            known = anchor + [clip_best]
            choice, known_checks = rethink(
                gallery_imgs, instruction, [self.image_provider(i) for i in known], label,
            )
            gpt_best = int(gallery_ids[top_idx[choice]]) if choice is not None else None
            new_cand = gpt_best is not None and gpt_best not in known
            candidates = known + ([gpt_best] if new_cand else [])
            checks = list(known_checks)
            if new_cand:
                extra, _ = self.vlm.detect_and_select_best([self.image_provider(gpt_best)], label)
                checks += extra
            # best candidate: the instruction-chosen frame when its check
            # passes, else CLIP-best, else the anchor
            prio = []
            if gpt_best is not None:
                prio.append(candidates.index(gpt_best))
            prio.append(len(anchor))  # clip_best's slot
            if anchor:
                prio.append(0)
            best_i = next((i for i in prio if checks[i]), None)
        else:
            choice = self.vlm.choose_frame(gallery_imgs, instruction)
            gpt_best = int(gallery_ids[top_idx[choice]]) if choice is not None else None
            candidates = anchor + [clip_best] + ([gpt_best] if gpt_best is not None else [])
            checks, best_i = self.vlm.detect_and_select_best(
                [self.image_provider(i) for i in candidates], label
            )
        res["VLM_Rethinking"] = time.perf_counter() - t_re

        # --- re-matching inside the chosen view (always, when the fast pick
        # had no anchor view; otherwise only when its anchor was rejected)
        t_rm = time.perf_counter()
        anchor_rejected = (
            (not anchor and best_i is not None)
            or (bool(anchor) and checks and not checks[0] and best_i is not None and best_i != 0)
        )
        if anchor_rejected:
            best_img_id = candidates[best_i]
            chosen_view = next((v for v in self.g.views if v.img_id == best_img_id), None)
            if chosen_view is not None and chosen_view.object_ids:
                embs = np.stack(
                    [np.asarray(self._obj_by_id[oid].embedding, np.float32) for oid in chosen_view.object_ids]
                )
                oid = chosen_view.object_ids[int(np.argmax(embs @ tf))]
                refined = self._obj_by_id[oid]
                gidx = {id(o): i for i, o in enumerate(self.g.objects)}
                object_ids = [gidx[id(refined)]] + object_ids[:-1]
                res["refined_object_id"] = oid
                if self.update_dir is not None:
                    # persist the refined object (the reference re-saves
                    # refined objects to objects_update/, graph.py:2999-3006)
                    upd = Path(self.update_dir) / "objects_update"
                    upd.mkdir(parents=True, exist_ok=True)
                    refined.save(upd)
        res["Re_Matching"] = time.perf_counter() - t_rm
        res["Total_Time"] = (
            res["FastMatching"] + res["ObjectInImageCheck"] + res["VLM_Rethinking"] + res["Re_Matching"]
        )
        return res, object_ids, obj_room_ids
