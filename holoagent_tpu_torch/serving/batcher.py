"""Slot-based continuous batching for the on-slice VLM (counterpart of
holoagent_tpu/serving/batcher.py).

Each of B cache slots holds one request; an admission wave prefills the
queued requests into the free slots, and every decode chunk advances all
live slots together, so requests admitted mid-flight join the next chunk
(the standard continuous-batching discipline, sized by
``ServingConfig.max_batch``).  The model's device is the batcher's device.

On one CUDA stream, work queued after a chunk would delay a plain
``.cpu()`` of that chunk's tokens until it, too, had run.  So each chunk's
tokens (and each wave's first tokens) are copied to pinned host memory
right after the chunk is queued, with an event recorded behind the copy;
draining a chunk waits on its event alone, and the ``pipeline_depth``
overlap of the reference holds.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import upload
from ..models import clip as clip_mod
from ..models import vlm as vlm_mod
from ..models.tokenizer import SimpleTokenizer


@dataclass
class GenRequest:
    prompt: str
    images: Any = None  # (N, S, S, 3) float [0,1]: numpy, or a tensor on the batcher's device
    max_new_tokens: int = 32
    temperature: float = 0.0
    # filled by the batcher:
    _done: threading.Event = field(default_factory=threading.Event)
    _result: Optional[str] = None
    generated: int = 0  # actual tokens decoded (incl. the stopping EOT)
    prompt_tokens: int = 0  # prefilled positions (text + image tokens)

    def result(self, timeout: Optional[float] = None) -> str:
        self._done.wait(timeout)
        if self._result is None:
            raise TimeoutError("generation did not finish")
        return self._result


class _Slot:
    __slots__ = ("request", "remaining", "out_ids")

    def __init__(self):
        self.request: Optional[GenRequest] = None
        self.remaining = 0
        self.out_ids: List[int] = []

    @property
    def active(self) -> bool:
        return self.request is not None


def _to_host(*tensors: torch.Tensor) -> Tuple[List[torch.Tensor], Optional[torch.cuda.Event]]:
    """Start copying device tensors to pinned host memory behind the work
    queued so far; returns the host tensors and the event to wait on before
    reading them (None on the CPU, where they are ready)."""
    if not tensors[0].is_cuda:
        return [t.clone() for t in tensors], None
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    ev = torch.cuda.Event()
    ev.record()
    return out, ev


def _wait(pending) -> List[np.ndarray]:
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return [h.numpy() for h in host]


class ContinuousBatcher:
    """Synchronous-core batcher. `submit` is thread-safe; `step` (or the
    background `serve_forever` thread) advances the engine."""

    def __init__(
        self,
        vlm: vlm_mod.VLM,
        visual: clip_mod.CLIPVisual,
        tokenizer: Optional[SimpleTokenizer] = None,
        max_batch: int = 8,
        mesh=None,  # sequence-parallel prefill: not ported
        chunk: int = 8,  # decode steps per dispatch (vlm.decode_chunk_tracked);
        # admission granularity becomes `chunk` tokens — 1 restores the
        # classic per-token loop
        pipeline_depth: int = 2,  # decode chunks queued before the host reads
        # the oldest one's tokens: EOT/budget tracking runs on the device, so
        # chunk k+1 is queued before chunk k's tokens are read.  1 = read every
        # chunk before queuing the next (the classic loop).
    ):
        if mesh is not None:
            raise NotImplementedError("sequence-parallel prefill over a mesh needs prefill_sp, which is not "
                                      "ported yet (ROADMAP.md item 9)")
        if visual.variant.name != vlm.variant.clip_variant:
            raise ValueError(f"visual tower {visual.variant.name} != the VLM's clip_variant "
                             f"{vlm.variant.clip_variant}")
        if visual.patch_w.device != vlm.device:
            raise ValueError(f"visual tower on {visual.patch_w.device}, VLM on {vlm.device}")
        self.vlm = vlm
        self.visual = visual
        self.v = vlm.variant
        self.device = vlm.device
        self.tok = tokenizer or SimpleTokenizer()
        self.max_batch = max_batch
        self.chunk = max(1, int(chunk))
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.cache = vlm_mod.init_cache(self.v, max_batch, vlm.dtype, self.device)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.current = torch.zeros(max_batch, dtype=torch.long, device=self.device)
        # device-side slot liveness: authoritative inside the decode pipeline
        # (decode_chunk_tracked), mirrored on the host as chunks are drained
        self.d_active = torch.zeros(max_batch, dtype=torch.bool, device=self.device)
        self.d_remaining = torch.zeros(max_batch, dtype=torch.long, device=self.device)
        self._inflight: List[tuple] = []  # pending (toks, act_hist) host copies
        self.queue: "queue.Queue[GenRequest]" = queue.Queue()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.steps = 0

    # ------------------------------------------------------------------ API

    def submit(self, request: GenRequest) -> GenRequest:
        self.queue.put(request)
        return request

    def generate(self, prompt: str, images=None, max_new_tokens: int = 32) -> str:
        """Blocking single call (drives the engine inline if no thread runs)."""
        req = self.submit(GenRequest(prompt, images, max_new_tokens))
        while not req._done.is_set():
            self.step()
        return req.result()

    def serve_forever(self) -> threading.Thread:
        def loop():
            while not self._stop.is_set():
                if not self.step():
                    time.sleep(0.002)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._stop.set()

    # ----------------------------------------------------------------- core

    def _admit(self) -> bool:
        """Admit queued requests into free slots as one wave
        (vlm.admit_wave): the wave's prompts prefill at a fixed (max_batch,
        T) shape, write their cache rows, and give their first greedy tokens,
        read back once a wave."""
        wave: List[tuple] = []  # (slot index, request)
        for i, slot in enumerate(self.slots):
            if slot.active:
                continue
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                break
            wave.append((i, req))
        if not wave:
            return False

        b = self.max_batch
        ns = np.zeros((b,), np.int64)
        admit = np.zeros((b,), bool)
        wave_ids: Dict[int, np.ndarray] = {}
        wave_imgs: Dict[int, torch.Tensor] = {}  # preprocessed image stacks
        for i, req in wave:
            ids = [self.tok.sot] + self.tok.encode(req.prompt)
            max_len = self.v.max_seq - req.max_new_tokens - 1
            if req.images is not None and len(req.images) > 0:
                imgs = torch.as_tensor(req.images, dtype=torch.float32, device=self.device)
                wave_imgs[i] = clip_mod.preprocess(imgs, size=self.visual.variant.image_size)
                n_img = len(req.images) * self.v.image_tokens
                ids = ids[: max(0, max_len - n_img)]
                ns[i] = min(n_img + len(ids), max_len)
            else:
                ids = ids[:max_len]
                ns[i] = len(ids)
            wave_ids[i] = np.asarray(ids, np.int64)
            admit[i] = True

        # bucket the wave's prompt length (64-token steps) so prefill cost
        # tracks the actual prompts, not the worst-case budget
        t = max(64, int(-(-int(ns.max()) // 64) * 64))
        t = min(t, self.v.max_seq - 1)
        ns = np.minimum(ns, t)

        if wave_imgs:
            zero = torch.zeros((t, self.v.width), dtype=self.vlm.dtype, device=self.device)
            emb = torch.stack([self._row_emb(i, t, ns, wave_ids, wave_imgs) if admit[i] else zero
                               for i in range(b)])
        else:
            ids_pad = np.zeros((b, t), np.int64)
            for i, ids in wave_ids.items():
                ids_pad[i, : ns[i]] = ids[: ns[i]]
            emb = vlm_mod.text_prompt_embeddings(self.vlm, upload(ids_pad, self.device),
                                                 upload(ns, self.device))
        self.current, self.cache = vlm_mod.admit_wave(self.vlm, emb, ns, admit, self.cache, self.current)

        (first,) = _wait(_to_host(self.current))  # one read a wave
        idxs, acts, rems = [], [], []
        for i, req in wave:
            slot = self.slots[i]
            nxt = int(first[i])
            req.prompt_tokens = int(ns[i])
            slot.request = req
            slot.remaining = req.max_new_tokens - 1
            slot.out_ids = [nxt]
            live = not (nxt == self.tok.eot or slot.remaining <= 0)
            idxs.append(i)
            acts.append(live)
            rems.append(slot.remaining)
            if not live:
                self._finish(i)
        # targeted device-mask updates: slots mid-decode keep their
        # (device-authoritative) liveness untouched
        ii = upload(np.asarray(idxs, np.int64), self.device)
        self.d_active[ii] = upload(np.asarray(acts, bool), self.device)
        self.d_remaining[ii] = upload(np.asarray(rems, np.int64), self.device)
        return True

    def _row_emb(self, i, t, ns, wave_ids, wave_imgs) -> torch.Tensor:
        """One slot's (t, W) prompt embeddings."""
        n = int(ns[i])
        ids = wave_ids[i]
        if i in wave_imgs:
            emb, _ = vlm_mod.image_text_prompt_embeddings(
                self.vlm, self.visual, upload(ids, self.device), len(ids), wave_imgs[i], t)
            return emb
        pad = np.zeros((1, t), np.int64)
        pad[0, :n] = ids[:n]
        return vlm_mod.text_prompt_embeddings(self.vlm, upload(pad, self.device),
                                              upload(np.asarray([n]), self.device))[0]

    def _finish(self, i: int):
        slot = self.slots[i]
        req = slot.request
        ids = [t for t in slot.out_ids if t != self.tok.eot]
        req.generated = len(slot.out_ids)
        req._result = self.tok.decode(ids).strip()
        req._done.set()
        slot.request = None
        # no device-side cache reset: the `active` mask freezes the slot and
        # admit_wave overwrites its rows and length on readmission

    def step(self) -> bool:
        """Admit new requests and advance every live slot up to `chunk`
        tokens (vlm.decode_chunk_tracked).  Up to `pipeline_depth` chunks
        stay queued before the host reads the oldest one's tokens.  Returns
        True if any work was done."""
        with self._lock:
            admitted = self._admit()
            host_live = any(s.active for s in self.slots)
            if host_live:
                toks, act_hist, self.current, self.cache, self.d_active, self.d_remaining = \
                    vlm_mod.decode_chunk_tracked(self.vlm, self.current, self.cache, self.d_active,
                                                 self.d_remaining, self.tok.eot, steps=self.chunk)
                self._inflight.append(_to_host(toks, act_hist))
                self.steps += 1
            elif not self._inflight:
                return admitted
            # drain: read the oldest chunk(s) once the pipeline is full — or
            # everything, when no slot is live to feed further chunks
            target = self.pipeline_depth - 1 if host_live else 0
            while len(self._inflight) > target:
                toks, acts = _wait(self._inflight.pop(0))
                for i, slot in enumerate(self.slots):
                    if not slot.active:
                        continue
                    for s in range(toks.shape[0]):
                        if not acts[s, i]:
                            break
                        tok = int(toks[s, i])
                        slot.out_ids.append(tok)
                        slot.remaining -= 1
                        if tok == self.tok.eot or slot.remaining <= 0:
                            # the device mask froze this slot at the same
                            # point (decode_chunk_tracked); later positions
                            # carry act_hist False and are skipped
                            self._finish(i)
                            break
            return True
