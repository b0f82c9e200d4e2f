"""Fused cosine-similarity retrieval, the fast-query primitive (counterpart
of holoagent_tpu/ops/retrieval.py), on the gallery's device.

Top-k keeps ``jax.lax.top_k``'s order: descending, ties to the lower index.
``topk_cosine_sharded`` splits the gallery over a mesh's data axis.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel import comm


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_cosine(
    gallery: torch.Tensor,  # (N, D) L2-normalized, padded rows allowed
    gallery_valid: torch.Tensor,  # (N,) bool
    queries: torch.Tensor,  # (Q, D) L2-normalized
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (Q, k), indices (Q, k)); invalid gallery rows score -inf."""
    scores = queries.float() @ gallery.float().T
    return _top_k(torch.where(gallery_valid[None, :], scores, float("-inf")), k)


def topk_cosine_sharded(
    gallery: torch.Tensor,  # (N, D), the same on every rank; N divisible by the data axis
    gallery_valid: torch.Tensor,  # (N,)
    queries: torch.Tensor,  # (Q, D)
    k: int,
    mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_cosine`` with the gallery split over the mesh's "data" axis:
    each rank takes the top-k of its contiguous block (global indices), the
    k candidates of every block are all-gathered (k * W a query, in block
    order) and the final top-k is taken over them, so ties still go to the
    lower index.  Every rank returns (scores (Q, k), indices (Q, k))."""
    ls, li = topk_cosine(comm.block(gallery, mesh, "data"), comm.block(gallery_valid, mesh, "data"), queries, k)
    li = li + comm.index(mesh, "data") * (gallery.shape[0] // comm.size(mesh, "data"))
    all_s = comm.all_gather(ls.contiguous(), mesh, "data", dim=1)  # (Q, k * W)
    all_i = comm.all_gather(li.contiguous(), mesh, "data", dim=1)
    gs, gpos = _top_k(all_s, k)
    return gs, torch.gather(all_i, 1, gpos)


def class_filtered_topk(
    gallery: torch.Tensor,  # (N, D) instance embeddings
    gallery_valid: torch.Tensor,  # (N,)
    query_feat: torch.Tensor,  # (D,) text feature of the queried class
    class_feats: torch.Tensor,  # (C, D) label-vocabulary text features
    query_class: int,  # row of `class_feats` equal to the query
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Negative-prompt class-argmax retrieval: an instance scores only if the
    query class wins the argmax over the whole label vocabulary."""
    g = gallery.float()
    best_class = torch.argmax(g @ class_feats.float().T, dim=-1)
    eligible = gallery_valid & (best_class == query_class)
    return _top_k(torch.where(eligible, g @ query_feat.float(), float("-inf")), k)


def negative_prompt_topk(
    gallery: torch.Tensor,  # (N, D) object embeddings (padded rows allowed)
    gallery_valid: torch.Tensor,  # (N,)
    text_feats: torch.Tensor,  # (C, D): row `query_id` is the query class
    query_id: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The query engine's fast-path object ranking: objects whose argmax
    class is the query, ranked by their max class similarity; when none is,
    every valid object ranked by its query-row similarity.  Returns (scores
    (k,): the query-row similarity of each pick, indices (k,)); filler lanes
    (fewer than k candidates) are idx -1, score -inf."""
    sim = text_feats.float() @ gallery.float().T  # (C, N)
    eligible = gallery_valid & (torch.argmax(sim, dim=0) == query_id)
    rank_elig = torch.where(eligible, sim.amax(dim=0), float("-inf"))
    rank_fallback = torch.where(gallery_valid, sim[query_id], float("-inf"))
    top_rank, idx = _top_k(torch.where(eligible.any(), rank_elig, rank_fallback), k)
    real = torch.isfinite(top_rank)
    return (
        torch.where(real, sim[query_id][idx], float("-inf")),
        torch.where(real, idx, -1),
    )
