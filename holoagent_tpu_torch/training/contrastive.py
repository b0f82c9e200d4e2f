"""Symmetric InfoNCE contrastive training of the CLIP towers (counterpart of
holoagent_tpu/training/contrastive.py).

The towers' float32 master weights train under ``torch.optim.AdamW`` (the
reference's ``optax.adamw``: decoupled weight decay, the same function as
optax's ``add_decayed_weights`` then ``-lr``), with the forward in a compute
``dtype`` cast inside the autograd graph and each image block recomputed
in the backward pass (``remat``, the reference's ``jax.checkpoint``).
Attention runs the plain version (``impl="xla"``), as the reference's
training does: the CUDA kernels have no backward.  ``logit_scale`` is a
trainable scalar the trainer owns (``CLIPParams``), clipped at log 100 in
the loss.

Single device only: ``mesh`` (the reference's DP+TP sharding) raises until
the multi-device slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models import clip as clip_mod
from ..models import transformer as tfm

LOGIT_SCALE_MAX = math.log(100.0)
MASKED_WEIGHT = 0.4418  # pipeline.clip_masked_weight, the reference's operating point


@dataclass
class CLIPParams:
    """The reference's CLIP parameter tree in the port: the two towers and
    the trainer's ``logit_scale`` (a 0-dim float32 parameter)."""

    visual: clip_mod.CLIPVisual
    text: clip_mod.CLIPText
    logit_scale: nn.Parameter

    def parameters(self) -> Iterator[nn.Parameter]:
        yield from self.visual.parameters()
        yield from self.text.parameters()
        yield self.logit_scale


def clip_params(visual: clip_mod.CLIPVisual, text: clip_mod.CLIPText,
                logit_scale: float = clip_mod.INIT_LOGIT_SCALE) -> CLIPParams:
    """Trainable towers (``transformer.trainable``) and a trainable
    ``logit_scale`` on their device."""
    ls = nn.Parameter(torch.tensor(float(logit_scale), dtype=torch.float32, device=visual.patch_w.device))
    return CLIPParams(tfm.trainable(visual), tfm.trainable(text), ls)


def _info_nce(img: torch.Tensor, txt: torch.Tensor, logit_scale: torch.Tensor) -> torch.Tensor:
    scale = torch.exp(torch.clamp(logit_scale, max=LOGIT_SCALE_MAX))
    logits = scale * (img.float() @ txt.float().t())
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))


def clip_loss(params: CLIPParams, images: torch.Tensor, tokens: torch.Tensor,
              dtype: torch.dtype = torch.bfloat16, remat: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE over a batch of (B, S, S, 3) preprocessed images and
    their (B, ctx) tokens: float32 logits, the image tower rematerialized
    (as the reference's; `remat=False` keeps every activation)."""
    img = clip_mod.forward_image(params.visual, images, impl="xla", dtype=dtype, remat=remat)
    txt = clip_mod.forward_text(params.text, tokens, impl="xla", dtype=dtype)
    return _info_nce(img, txt, params.logit_scale)


def clip_blend_loss(params: CLIPParams, images_plain: torch.Tensor, images_masked: torch.Tensor,
                    tokens: torch.Tensor, masked_weight: float = MASKED_WEIGHT,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """InfoNCE on the BLENDED crop feature the extractor computes:
    l2(w * f_masked + (1 - w) * f_plain) at the reference's
    clip_masked_weight (reference sam_clip_feats_extractor.py:159-162)."""
    fp = clip_mod.forward_image(params.visual, images_plain, impl="xla", dtype=dtype, remat=True)
    fm = clip_mod.forward_image(params.visual, images_masked, impl="xla", dtype=dtype, remat=True)
    f = masked_weight * fm + (1.0 - masked_weight) * fp
    img = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True), min=1e-9)
    txt = clip_mod.forward_text(params.text, tokens, impl="xla", dtype=dtype)
    return _info_nce(img, txt, params.logit_scale)


def adamw(parameters, lr: float, weight_decay: float) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=wd)``: betas (0.9, 0.999), eps 1e-8,
    decay on every parameter.  On the card the optimizer is capturable (its
    step count lives on the device), so a whole step can be one CUDA graph."""
    params = list(parameters)
    cuda = params[0].is_cuda
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
                             foreach=True, capturable=cuda)


def init_train_state(params: CLIPParams, lr: float = 1e-4, weight_decay: float = 0.05) -> torch.optim.AdamW:
    """The optimizer over every CLIP parameter (``tx``; it holds its own
    state, the reference's ``opt_state``)."""
    return adamw(params.parameters(), lr, weight_decay)


def _checked(variant: clip_mod.CLIPVariant, params: CLIPParams) -> None:
    if params.visual.variant != variant:
        raise ValueError(f"step built for {variant.name}, towers are {params.visual.variant.name}")


def make_train_step(variant: clip_mod.CLIPVariant, tx: torch.optim.Optimizer, mesh=None,
                    dtype: torch.dtype = torch.bfloat16):
    """The (params, images, tokens) -> loss step: one AdamW update in place.
    The loss comes back as a 0-dim tensor (no host sync)."""
    if mesh is not None:
        raise NotImplementedError("make_train_step(mesh=...): DP+TP training is not ported (ROADMAP.md, "
                                  "multi-device)")

    def step(params: CLIPParams, images: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        _checked(variant, params)
        tx.zero_grad(set_to_none=True)
        loss = clip_loss(params, images, tokens, dtype=dtype)
        loss.backward()
        tx.step()
        return loss.detach()

    return step


def make_blend_train_step(variant: clip_mod.CLIPVariant, tx: torch.optim.Optimizer,
                          masked_weight: float = MASKED_WEIGHT, dtype: torch.dtype = torch.bfloat16):
    """The (params, images_plain, images_masked, tokens) -> loss step over
    ``clip_blend_loss``, one AdamW update in place."""

    def step(params: CLIPParams, images_p: torch.Tensor, images_m: torch.Tensor,
             tokens: torch.Tensor) -> torch.Tensor:
        _checked(variant, params)
        tx.zero_grad(set_to_none=True)
        loss = clip_blend_loss(params, images_p, images_m, tokens, masked_weight, dtype)
        loss.backward()
        tx.step()
        return loss.detach()

    return step


GRAPH_WARMUP = 3  # eager calls before a GraphedStep captures


class GraphedStep:
    """A training step over fixed-shape tensors, replayed as one CUDA graph.

    The first GRAPH_WARMUP calls run eagerly on a side stream (each a real step:
    its update counts), as CUDA graph capture asks; the next call captures
    the whole step (forward, backward, the capturable optimizer's update)
    into a graph over static copies of its inputs, and that call and every
    later one copy their inputs in and replay it.  Each call returns a fresh
    0-dim loss tensor.  Off the card the step runs eagerly."""

    def __init__(self, step):
        self.step, self.calls = step, 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static, self.out = None, None

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        if not args[0].is_cuda:
            return self.step(*args)
        self.calls += 1
        if self.calls <= GRAPH_WARMUP:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = self.step(*args)
            torch.cuda.current_stream().wait_stream(side)
            return out
        if self.graph is None:
            self.static = [a.clone() for a in args]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self.step(*self.static)
        for s, a in zip(self.static, args):
            s.copy_(a)
        self.graph.replay()
        return self.out.clone()
