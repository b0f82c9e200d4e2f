"""Lloyd's k-means over masked fixed-shape data (counterpart of
holoagent_tpu/ops/kmeans.py), on the tensor's device.

The first center is the reference's ``jax.random.randint(jax.random.key(seed),
(), 0, n)``: JAX's threefry2x32 generator and its ``randint``, public
algorithms, reproduced on the host in ``jax_randint`` (JAX's default
``jax_threefry_partitionable`` mode), so both packages start from the same
row.
"""

from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: Tuple[int, int], count: Tuple[int, int]) -> Tuple[int, int]:
    """The Threefry-2x32 block cipher (20 rounds) on one pair of words."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x = [(count[0] + ks[0]) & _M32, (count[1] + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def _bits32(key: Tuple[int, int]) -> int:
    """``jax.random.bits(key, (), uint32)``: one block at counter 0, its two
    words xor-ed."""
    y0, y1 = threefry2x32(key, (0, 0))
    return y0 ^ y1


def jax_randint(seed: int, n: int) -> int:
    """``int(jax.random.randint(jax.random.key(seed), (), 0, n))`` for
    0 <= seed < 2**31 and n < 2**31: split the key in two (counters 0 and
    1), draw 32 bits from each, and reduce the pair modulo n in uint32
    arithmetic as JAX does."""
    key = (0, seed & _M32)
    hi, lo = _bits32(threefry2x32(key, (0, 0))), _bits32(threefry2x32(key, (0, 1)))
    span = max(n, 1)
    mult = (((2**16 % span) ** 2) & _M32) % span
    return ((((hi % span) * mult) & _M32) + lo % span) % span


@torch.no_grad()
def kmeans(
    x: torch.Tensor,  # (N, D)
    valid: torch.Tensor,  # (N,) bool
    k: int,
    iters: int = 100,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (centers (k, D), labels (N,) int32; -1 on invalid rows).
    Initialization: greedy farthest selection from the seeded first row;
    then `iters` Lloyd steps (an empty cluster keeps its center)."""
    n, d = x.shape
    centers = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    centers[0] = x[jax_randint(seed, n)]
    slots = torch.arange(k, device=x.device)[None, :]

    def dist2(c):
        return ((x[:, None, :] - c[None]) ** 2).sum(-1)  # (N, k)

    for i in range(1, k):
        d2 = torch.where(slots < i, dist2(centers), float("inf")).amin(dim=1)
        centers[i] = x[torch.argmax(torch.where(valid, d2, -1.0))]
    for _ in range(iters):
        lab = torch.where(valid, torch.argmin(dist2(centers), dim=1), k)
        sums = torch.zeros((k + 1, d), dtype=x.dtype, device=x.device).index_add_(0, lab, x)
        cnts = torch.zeros(k + 1, dtype=x.dtype, device=x.device).index_add_(0, lab, torch.ones_like(x[:, 0]))
        new = sums[:k] / torch.clamp(cnts[:k, None], min=1.0)
        centers = torch.where(cnts[:k, None] > 0, new, centers)
    labels = torch.where(valid, torch.argmin(dist2(centers), dim=1).to(torch.int32), -1)
    return centers, labels
