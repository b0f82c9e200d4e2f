"""Feature-space denoising (counterpart of holoagent_tpu/ops/features.py):
one round of mode seeking stands in for the reference's cosine-DBSCAN
largest-cluster mean."""

from __future__ import annotations

import torch


def dominant_feature(
    feats: torch.Tensor,  # (..., K, D) unit-norm member features (zeros on padding)
    valid: torch.Tensor,  # (..., K)
    eps: float = 0.01,  # cosine-distance radius
    min_points: float = 100.0,
) -> torch.Tensor:
    """(..., D) denoised instance feature, unit norm (zeros if no valid
    member).  The member with the most cosine neighbours within eps anchors
    the dominant cluster; below min_points the mean of all members is used."""
    sim = feats @ feats.transpose(-1, -2)
    nbr = (sim >= 1.0 - eps) & valid[..., None, :] & valid[..., :, None]
    deg = nbr.sum(dim=-1)
    anchor = torch.argmax(torch.where(valid, deg, torch.full_like(deg, -1)), dim=-1, keepdim=True)
    use_cluster = deg.gather(-1, anchor) >= min_points
    w_cluster = nbr.gather(-2, anchor[..., None].expand(*anchor.shape, nbr.shape[-1]))[..., 0, :]
    w = torch.where(use_cluster, w_cluster.to(torch.float32), valid.to(torch.float32))
    mean = (w[..., None, :] @ feats)[..., 0, :]
    mean = mean / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    n = torch.linalg.norm(mean, dim=-1, keepdim=True)
    return torch.where(n > 1e-9, mean / torch.clamp(n, min=1e-9), torch.zeros_like(mean))
