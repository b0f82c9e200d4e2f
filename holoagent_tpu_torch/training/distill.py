"""VLM distillation against oracle supervision (counterpart of
holoagent_tpu/training/distill.py): train the generative VLM (gpt or llama
arch) to reproduce (prompt, images, answer) tuples from the GT-backed oracle
(``query/oracle.py``): cross-entropy on the answer token following the
[image blocks, prompt] prefix, the position the serving engine decodes
first.

The step is plain SGD through ``vlm.forward_prefill`` in float32 with the
plain attention (``impl="xla"``, the reference's default and its training
path; the kernels have no backward).  The prefill's in-place K/V cache
writes only record the K/V: the logits do not read the cache, so autograd
carries the gradient through the blocks; each step takes a fresh cache.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import clip as clip_mod
from ..models import transformer as tfm
from ..models import vlm as vlm_mod


def distill_step(
    vlm: vlm_mod.VLM,
    embs: torch.Tensor,  # (B, T, W) prompt embeddings (images + text)
    valid_len: torch.Tensor,  # (B,)
    targets: torch.Tensor,  # (B,) answer token ids
    lr: float = 1e-2,
) -> torch.Tensor:
    """One SGD step on the answer-token cross-entropy, in place on the
    VLM's parameters; returns the step's loss (0-dim).  Every parameter the
    prefill reads trains; the rest (the projector, when the embeddings are
    prebuilt) get no gradient and stay, as the reference's zero gradient
    leaves them."""
    tfm.trainable(vlm)
    for p in vlm.parameters():
        p.grad = None
    cache = vlm_mod.init_cache(vlm.variant, embs.shape[0], torch.float32, device=vlm.device)
    logits, _ = vlm_mod.forward_prefill(vlm, embs, valid_len, cache, impl="xla")
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(1, targets.long()[:, None])[:, 0].mean()
    loss.backward()
    with torch.no_grad():
        for p in vlm.parameters():
            if p.grad is not None:
                p.sub_(lr * p.grad.to(p.dtype))
                p.grad = None
    return loss.detach()


def distill_vlm(
    vlm: vlm_mod.VLM,
    visual: clip_mod.CLIPVisual,
    pairs: Sequence[Tuple[str, List[int], str]],  # oracle.distill_pairs output
    image_provider: Callable[[int], np.ndarray],
    tokenize: Callable[[str], List[int]],
    answer_id: Callable[[str], int],
    steps: int = 50,
    lr: float = 1e-2,
    max_len: int = 64,
) -> Tuple[vlm_mod.VLM, List[float]]:
    """Fine-tune on oracle pairs, on the VLM's device.  Returns (vlm,
    losses).  The prompt embeddings are built once with the initial token
    embeddings (prefix-frozen embedding distillation, as the reference)."""
    dev = vlm.device
    embs, lens, tgts = [], [], []
    for prompt, img_ids, answer in pairs:
        imgs = torch.from_numpy(np.stack([np.asarray(image_provider(i), np.float32) for i in img_ids])).to(dev)
        pre = clip_mod.preprocess(imgs, size=visual.variant.image_size)
        e, n = vlm_mod.build_prompt_embeddings(vlm, visual, np.asarray(tokenize(prompt), np.int32), pre,
                                               max_len=max_len)
        embs.append(e)
        lens.append(n)
        tgts.append(answer_id(answer))
    embs = torch.stack(embs).float()
    lens = torch.as_tensor(lens, dtype=torch.long, device=dev)
    tgts = torch.as_tensor(tgts, dtype=torch.long, device=dev)
    losses = [distill_step(vlm, embs, lens, tgts, lr=lr) for _ in range(steps)]
    return vlm, torch.stack(losses).tolist() if losses else []
