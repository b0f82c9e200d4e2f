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

``make_train_step(mesh=...)`` is the reference's DP+TP step made explicit
on a (data, model) mesh (the reference gets it from placements alone):
each data rank takes its block of the batch and the features are
all-gathered with autograd, so the logits span the global batch; the
towers' blocks run tensor-parallel over "model" (``transformer.block_tp``:
whole heads of q, k and v, the MLP's hidden columns).  The towers'
gradients are summed over "data" (the gather's backward leaves each rank
its own rows' share), the split leaves' also over "model"; ``logit_scale``'s
is already whole on every rank, which computes the whole loss.  Every rank
then takes the same optimizer step on its replicated master weights with
the single-device step's gradients, so loss and new weights equal the
single-device step's for any optimizer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from ..models import clip as clip_mod
from ..models import transformer as tfm
from ..parallel import comm, sharding

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
    The loss comes back as a 0-dim tensor (no host sync).  With a `mesh`
    (module docstring) every rank passes the same params and the whole
    batch, and gets the same loss and the same updated params."""
    if mesh is not None:
        return _mesh_train_step(variant, tx, mesh, dtype)

    def step(params: CLIPParams, images: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        _checked(variant, params)
        tx.zero_grad(set_to_none=True)
        loss = clip_loss(params, images, tokens, dtype=dtype)
        loss.backward()
        tx.step()
        return loss.detach()

    return step


def _sum_grads(params, mesh, axis: str) -> None:
    """All-reduce the gradients over `axis` in one flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh, axis)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _mesh_train_step(variant: clip_mod.CLIPVariant, tx: torch.optim.Optimizer, mesh, dtype: torch.dtype):
    tp = (mesh, "model") if comm.size(mesh, "model") > 1 else None

    def step(params: CLIPParams, images: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        _checked(variant, params)
        tx.zero_grad(set_to_none=True)
        imgs, toks = comm.block(images, mesh, "data"), comm.block(tokens, mesh, "data")
        img = clip_mod.forward_image(params.visual, imgs, impl="xla", dtype=dtype, remat=True, tp=tp)
        txt = clip_mod.forward_text(params.text, toks, impl="xla", dtype=dtype, tp=tp)
        loss = _info_nce(comm.gather_batch(img, mesh, "data"), comm.gather_batch(txt, mesh, "data"),
                         params.logit_scale)
        loss.backward()
        named = sharding.named_parameters(params)
        _sum_grads([q for n, q in named.items() if n != "logit_scale"], mesh, "data")
        if tp is not None:  # the leaves the model axis splits (block_tp) hold a slice's gradient each
            rule = sharding.clip_param_sharding(params, mesh)
            _sum_grads([q for n, q in named.items() if any(isinstance(pl, Shard) for pl in rule[n])], mesh, "model")
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
