"""2-D raster ops for room segmentation (counterpart of
holoagent_tpu/ops/image2d.py).

Each op is a tensor program on its input's device, the same function as
the reference's jitted array program: separable gaussian blur, box
morphology, Otsu's threshold, jump-flood distance transform,
label-propagation connected components, compact relabelling, seeded
watershed expansion and hole filling, and 1-D peak finding.

Where the reference relies on a particular order or edge rule, the port
copies it:
- ``jnp.roll`` wraps around; connected components and the watershed mask
  the wrapped-in edge by hand (``_shift``), the distance transform keeps the
  wrapped seeds (their coordinates are absolute, so they only give true
  distances);
- ``reduce_window(..., "SAME")`` pads with its init value (``_window``);
- ``jnp.histogram(bins=256, range=(0, 255))`` closes its last bin;
- Otsu's cumulative sums add in the order of ``jnp.cumsum`` on the CPU
  (``_cumsum_scan``), so the threshold is exact; the blur's sums may differ
  from the reference's in the last bit;
- the peak order is a stable argsort.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BIG = 1e9


def gaussian_kernel1d(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur_rows(x: torch.Tensor, k: torch.Tensor, radius: int) -> torch.Tensor:
    """Each row of (N, L) convolved with the symmetric kernel `k`, "valid"
    over the row padded by its edge values."""
    xp = F.pad(x[None], (radius, radius), mode="replicate")[0]
    return F.conv1d(xp[:, None], k.view(1, 1, -1))[:, 0]


def gaussian_blur(img: torch.Tensor, sigma: float = 1.0, radius: int = 2) -> torch.Tensor:
    """Separable gaussian blur on an (H, W) float image, edges replicated."""
    k = gaussian_kernel1d(sigma, radius, img.device)
    rows = _blur_rows(img.float(), k, radius)
    return _blur_rows(rows.t(), k, radius).t().contiguous()


def _window(m: torch.Tensor, op: str, size: int) -> torch.Tensor:
    """reduce_window with a size x size box, stride 1, "SAME" padding with
    the reduction's identity (max: -1e9, min: 1e9)."""
    lo, hi = (size - 1) // 2, size // 2
    if op == "min":
        return -_window(-m, "max", size)
    x = F.pad(m[None, None], (lo, hi, lo, hi), value=-1e9)
    return F.max_pool2d(x, size, stride=1)[0, 0]


def _morph(mask: torch.Tensor, ops, size: int, iterations: int) -> torch.Tensor:
    m = mask.float()
    for op in ops:
        for _ in range(iterations):
            m = _window(m, op, size)
    return m > 0.5


def dilate(mask: torch.Tensor, size: int = 3, iterations: int = 1) -> torch.Tensor:
    """Binary dilation with a size x size box."""
    return _morph(mask, ("max",), size, iterations)


def erode(mask: torch.Tensor, size: int = 3, iterations: int = 1) -> torch.Tensor:
    """Binary erosion with a size x size box."""
    return _morph(mask, ("min",), size, iterations)


def morph_close(mask: torch.Tensor, size: int = 3, iterations: int = 1) -> torch.Tensor:
    """Binary closing (dilate then erode) with a size x size box."""
    return _morph(mask, ("max", "min"), size, iterations)


def morph_open(mask: torch.Tensor, size: int = 3, iterations: int = 1) -> torch.Tensor:
    return _morph(mask, ("min", "max"), size, iterations)


SCAN_ROW = 16  # row length of XLA's CPU rewrite of a cumulative sum


def _row_scan(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along each row of (R, L), added left to right."""
    cols = [x[:, 0]]
    for j in range(1, x.shape[1]):
        cols.append(cols[-1] + x[:, j])
    return torch.stack(cols, 1)


def _cumsum_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D float tensor, added in the order of
    ``jnp.cumsum`` on the CPU (XLA rewrites its cumulative reduce_window as
    sequential sums within rows of ``SCAN_ROW``, then adds the scanned row
    totals), so the sums are bit-identical."""
    n = x.shape[0]
    if n <= SCAN_ROW:
        return _row_scan(x[None])[0]
    m = -(-n // SCAN_ROW) * SCAN_ROW
    inner = _row_scan(F.pad(x, (0, m - n)).reshape(-1, SCAN_ROW))
    totals = _cumsum_scan(inner[:, -1])
    before = torch.cat([totals.new_zeros(1), totals[:-1]])
    return (inner + before[:, None]).reshape(-1)[:n]


def otsu_threshold(img: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold over a [0, 255]-scaled float image; returns a scalar."""
    flat = img.reshape(-1).float()
    edges = torch.linspace(0.0, 255.0, 257, dtype=torch.float32, device=img.device)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], 256, idx)  # the last bin is closed
    hist = torch.bincount(idx, minlength=258)[1:257].float()  # below 0 and above 255 drop
    p = hist / torch.clamp(hist.sum(), min=1.0)
    omega = _cumsum_scan(p)
    levels = torch.arange(256, dtype=torch.float32, device=img.device)
    mu = _cumsum_scan(p * levels)
    mu_t = mu[-1]
    denom = omega * (1.0 - omega)
    sigma_b = torch.where(denom > 1e-9, (mu_t * omega - mu) ** 2 / torch.clamp(denom, min=1e-9), 0.0)
    return levels[torch.argmax(sigma_b)]


def distance_transform(occupied: torch.Tensor) -> torch.Tensor:
    """Euclidean distance (in pixels) of each pixel to the nearest occupied
    pixel, via jump flooding.  occupied: (H, W) bool."""
    h, w = occupied.shape
    ys = torch.arange(h, dtype=torch.float32, device=occupied.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=occupied.device)[None, :].expand(h, w)
    sy = torch.where(occupied, ys, BIG)
    sx = torch.where(occupied, xs, BIG)
    step = 1
    while step < max(h, w):
        step *= 2
    strides = []
    while step >= 1:
        strides.append(step)
        step //= 2
    for s in strides:
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                ny = torch.roll(sy, (dy, dx), dims=(0, 1))
                nx = torch.roll(sx, (dy, dx), dims=(0, 1))
                cd = (sy - ys) ** 2 + (sx - xs) ** 2
                nd = (ny - ys) ** 2 + (nx - xs) ** 2
                take = nd < cd
                sy, sx = torch.where(take, ny, sy), torch.where(take, nx, sx)
    d2 = (sy - ys) ** 2 + (sx - xs) ** 2
    return torch.sqrt(torch.clamp(d2, max=BIG))


_NEIGHBOURS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``jnp.roll(x, (dy, dx))`` by one pixel with the wrapped-in row or
    column set to `fill`."""
    out = torch.roll(x, (dy, dx), dims=(0, 1))
    if dy == 1:
        out[0, :] = fill
    elif dy == -1:
        out[-1, :] = fill
    if dx == 1:
        out[:, 0] = fill
    elif dx == -1:
        out[:, -1] = fill
    return out


def connected_components_2d(mask: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """4-connected components of a bool mask after `iters` rounds of label
    propagation and pointer jumping.  Returns int32 labels, -1 off-mask:
    the min flat index of the component (compact with `relabel_compact`)."""
    h, w = mask.shape
    big = h * w
    idx = torch.arange(big, dtype=torch.int32, device=mask.device).reshape(h, w)
    lab = torch.where(mask, idx, big)
    for _ in range(iters):
        best = lab
        for dy, dx in _NEIGHBOURS:
            best = torch.minimum(best, torch.where(mask, _shift(lab, dy, dx, big), big))
        flat = best.reshape(-1)
        ext = torch.cat([flat, flat.new_full((1,), big)])
        flat = torch.minimum(flat, ext[torch.clamp(flat, max=big - 1).long()])
        lab = torch.where(mask, flat.reshape(h, w), big)
    return torch.where(mask, lab, -1).to(torch.int32)


def relabel_compact(labels: torch.Tensor, max_labels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map arbitrary non-negative labels to [0, k).  Returns (labels', sizes
    (max_labels,)); labels beyond max_labels become -1."""
    h, w = labels.shape
    flat = labels.reshape(-1).long()
    valid = flat >= 0
    idx = torch.arange(h * w, device=labels.device)
    is_root = valid & (flat == idx)  # roots: pixels whose flat index is their label
    root_rank = torch.where(is_root, torch.cumsum(is_root.long(), 0) - 1, -1)
    padded = torch.cat([root_rank, root_rank.new_full((1,), -1)])
    comp = torch.where(valid, padded[torch.clamp(flat, 0, h * w)], -1)
    comp = torch.where(comp >= max_labels, -1, comp)
    sizes = torch.bincount(torch.where(comp >= 0, comp, max_labels), minlength=max_labels + 1)
    return comp.reshape(h, w).to(torch.int32), sizes[:max_labels].to(torch.int32)


def watershed_expand(
    seeds: torch.Tensor,  # (H, W) int32 >= 0 seed labels, -1 elsewhere
    free: torch.Tensor,  # (H, W) bool region to flood (walls excluded)
    priority: torch.Tensor,  # (H, W) f32: higher floods first (distance map)
    iters: int = 256,
) -> torch.Tensor:
    """Seeded watershed: each round, an unlabelled free pixel adopts the
    label of its labelled 4-neighbour of highest priority (the first of
    equals in down, up, right, left order), for `iters` rounds."""
    lab = torch.where(seeds >= 0, seeds, -1).to(torch.int32)
    for _ in range(iters):
        pri = torch.where(lab >= 0, priority, -BIG)
        best_lab, best_pri = lab, pri
        unlabelled = lab < 0
        for dy, dx in _NEIGHBOURS:
            nl = _shift(lab, dy, dx, -1)
            np_ = _shift(pri, dy, dx, -BIG)
            take = (nl >= 0) & (np_ > best_pri) & unlabelled
            best_lab = torch.where(take, nl, best_lab)
            best_pri = torch.where(take, np_, best_pri)
        lab = torch.where(free & unlabelled, best_lab, lab)
    return lab


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill interior holes: complement components not touching the border."""
    comp = connected_components_2d(~mask)
    h, w = mask.shape
    border = torch.cat([comp[0, :], comp[-1, :], comp[:, 0], comp[:, -1]]).long()
    marks = torch.zeros(h * w + 1, dtype=torch.bool, device=mask.device)
    marks[torch.where(border >= 0, border, h * w)] = True
    outside = (comp >= 0) & marks[torch.clamp(comp.long(), 0, h * w)]
    return mask | (~mask & ~outside)


def find_peaks_1d(
    y: torch.Tensor, min_height: float, min_distance: int, max_peaks: int
) -> Tuple[torch.Tensor, int]:
    """1-D peak finding with min height + min distance (greedy by height,
    ties in index order): the scipy.signal.find_peaks subset the floor
    detector uses.  Returns (indices (max_peaks,) int32 sorted ascending with
    -1 padding, count).  The greedy suppression is sequential; it runs on the
    host over the candidate peaks only (a non-peak is never kept)."""
    n = y.shape[0]
    ninf = y.new_full((1,), float("-inf"))
    left, right = torch.cat([ninf, y[:-1]]), torch.cat([y[1:], ninf])
    is_peak = (y > left) & (y >= right) & (y >= torch.tensor(min_height, dtype=y.dtype, device=y.device))
    order = torch.argsort(-torch.where(is_peak, y, float("-inf")), stable=True)
    kept = []
    for p in order[is_peak[order]].tolist():
        if all(abs(p - k) >= min_distance for k in kept):
            kept.append(p)
    kept = sorted(kept)[:max_peaks]
    out = torch.full((max_peaks,), -1, dtype=torch.int32, device=y.device)
    out[: len(kept)] = torch.tensor(kept, dtype=torch.int32)
    return out, len(kept)
