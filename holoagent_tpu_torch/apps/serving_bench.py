"""Continuous-batching serving benchmark for the on-slice VLM (counterpart
of holoagent_tpu/apps/serving_bench.py).

Decode throughput and request rate of the local serving engine at
max_batch, on the card unless the caller asks for the CPU.  Rows:
  * ``decode_step_ms``: one ``decode_step`` (+ argmax) of all slots at
    length 64;
  * ``scan_decode_chunk_ms``: ``chunk`` greedy steps back to back;
  * ``slow_chain_device_ms``: ``chain_calls`` sequential (prefill-128 +
    8-step greedy decode) rounds, the shape of the 5-call slow path;
  * ``prefill_128_ms``: one 128-token prefill;
  * ``wall_*``: the end-to-end continuous-batching loop from the host.
The first four are timed by ``utils.benchtime.time_device_fn``: device
time with the stream held while the calls are queued; ``timing`` says for
each whether the hold covered the queueing ("device") or ran out ("wall";
the row then includes host gaps), or the run was on the CPU ("cpu").

Usage: python -m holoagent_tpu_torch.apps.serving_bench [--variant vlm-small]
       [--batch 8] [--requests 16] [--new-tokens 32] [--out results.json]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from ..device import DeviceLike, resolve
from ..models import clip as clip_mod
from ..models import vlm as vlm_mod
from ..serving import ContinuousBatcher, GenRequest
from ..utils.benchtime import time_device_fn


def run(variant: str = "vlm-small", batch: int = 8, requests: int = 16, new_tokens: int = 32,
        out_path: str | None = None, chunk: int = 8, chain_calls: int = 5, device: DeviceLike = None) -> dict:
    dev = resolve(device)
    vv = vlm_mod.VARIANTS[variant]
    cv = clip_mod.VARIANTS[vv.clip_variant]
    vlm = vlm_mod.init_vlm(vv, seed=0, dtype=torch.bfloat16, device=dev)
    visual = clip_mod.init_clip_visual(cv, seed=1, dtype=torch.bfloat16, device=dev)
    timing = {}

    # --- decode_step of all slots at length 64 (the length is put back after
    # each call, so every call does the same work)
    cache = vlm_mod.init_cache(vv, batch, torch.bfloat16, dev)
    cache.length.fill_(64)
    tokens = torch.zeros(batch, dtype=torch.long, device=dev)
    active = torch.ones(batch, dtype=torch.bool, device=dev)

    def step(tok):
        logits, _ = vlm_mod.decode_step(vlm, tok, cache, active)
        cache.length.fill_(64)
        return torch.argmax(logits, -1)

    step_t = time_device_fn(step, [tokens], iters=8)
    timing["decode_step_ms"] = step_t.kind

    # --- `chunk` greedy steps back to back: the engine's decode loop
    def chunk_decode(tok):
        toks, _, _ = vlm_mod.decode_chunk(vlm, tok, cache, active, steps=chunk)
        cache.length.fill_(64)
        return toks

    scan_t = time_device_fn(chunk_decode, [tokens], iters=4)
    timing["scan_decode_chunk_ms"] = scan_t.kind

    # --- the slow-reasoning VLM chain: `chain_calls` sequential (prefill-128
    # -> 8-token greedy decode) rounds, each on a fresh one-slot cache
    chain_t = None
    if chain_calls:
        one = torch.ones(1, dtype=torch.bool, device=dev)

        def slow_chain(e):
            total = torch.zeros((), dtype=torch.long, device=dev)
            for _ in range(chain_calls):
                c = vlm_mod.init_cache(vv, 1, torch.bfloat16, dev)
                logits, c = vlm_mod.prefill(vlm, e, [128], c)
                toks, _, _ = vlm_mod.decode_chunk(vlm, torch.argmax(logits, -1), c, one, steps=8)
                total = total + toks.sum()
            return total

        chain_t = time_device_fn(slow_chain, [torch.zeros(1, 128, vv.width, dtype=torch.bfloat16, device=dev)],
                                 iters=4)
        timing["slow_chain_device_ms"] = chain_t.kind

    # --- prefill latency (one request, a 128-token prompt)
    pre_cache = vlm_mod.init_cache(vv, 1, torch.bfloat16, dev)

    def pre(e):
        logits, _ = vlm_mod.prefill(vlm, e, [128], pre_cache)
        return logits

    prefill_t = time_device_fn(pre, [torch.zeros(1, 128, vv.width, dtype=torch.bfloat16, device=dev)], iters=4)
    timing["prefill_128_ms"] = prefill_t.kind

    # --- end-to-end continuous batching loop from the host
    b = ContinuousBatcher(vlm, visual, max_batch=batch, chunk=chunk)
    # one throwaway request first (library handles, allocator), off the clock
    warm = b.submit(GenRequest("warm up", max_new_tokens=min(8, new_tokens)))
    while not warm._done.is_set():
        b.step()
    b.steps = 0
    reqs = [b.submit(GenRequest(f"where is object number {i}?", max_new_tokens=new_tokens))
            for i in range(requests)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    while not all(r._done.is_set() for r in reqs):
        b.step()
    wall = time.perf_counter() - t0
    # actual tokens decoded per request (a slot stopping early on EOT must
    # not inflate the wall throughput)
    gen_tokens = sum(r.generated for r in reqs)

    res = {
        "variant": variant,
        "max_batch": batch,
        "decode_chunk": chunk,
        "requests": requests,
        "new_tokens_per_request": new_tokens,
        "decode_step_ms": step_t.seconds * 1e3,
        "device_decode_tok_s": batch / step_t.seconds,
        "scan_decode_chunk_ms": scan_t.seconds * 1e3,
        "device_resident_tok_s": batch * chunk / scan_t.seconds,
        **({
            "slow_chain_calls": chain_calls,
            "slow_chain_device_ms": chain_t.seconds * 1e3,
            "slow_chain_what": (
                f"{chain_calls}x (prefill-128 + 8-token greedy decode) back to back on the device; "
                "per-query slow p50 = FastMatching + this"
            ),
        } if chain_t is not None else {}),
        "prefill_128_ms": prefill_t.seconds * 1e3,
        "wall_seconds": wall,
        "wall_tok_s": gen_tokens / wall,
        "wall_requests_s": requests / wall,
        "batcher_steps": b.steps,
        "timing": timing,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    if out_path:
        Path(out_path).write_text(json.dumps(res, indent=2))
    print(json.dumps(res))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="vlm-small")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--chain-calls", type=int, default=5,
                    help="slow-chain VLM calls in the chain row (0 skips it)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.variant, args.batch, args.requests, args.new_tokens, args.out,
               chunk=args.chunk, chain_calls=args.chain_calls, device=args.device)


if __name__ == "__main__":
    main()
