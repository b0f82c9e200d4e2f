"""Fixed-capacity mask-set ops (counterpart of holoagent_tpu/ops/masks.py):
stability scores, boxes, greedy NMS, the disjoint carve, containment.

Greedy NMS on a CUDA tensor is one hand-written CUDA C++ kernel
(``csrc/masks.cu``, built for ``sm_90a`` with ``nvcc`` at first use and
loaded with ``ctypes`` by ``ops/_cuda_build.py``), launched on the caller's
stream: up to ``ONE_BLOCK_MAX_M`` candidates in one block out of shared
memory ("block"), above it as four kernels over global scratch ("grid").
It gives the plain version's keep mask bit for bit.  ``nms.launches``
counts its launches (``nms.routes`` by route); while ``nms.trace`` is a list
it also collects CUDA events around each launch (``_cuda_build.launch``).
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda_build import CudaLibrary, kernel_input, launch

ONE_BLOCK_MAX_M = 1024  # the one-block route's limit: BLOCK_MAX_M of csrc/masks.cu (a test holds them equal)

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("masks.cu", {"ha_nms": [_p, _p, _p, ctypes.c_float, _p, _p, ctypes.c_longlong, _i, _p]})


def mask_areas(masks: torch.Tensor) -> torch.Tensor:
    """(M, H, W) bool -> (M,) float areas."""
    return masks.to(torch.float32).sum(dim=(1, 2))


def stability_scores(logits: torch.Tensor, offset: float = 1.0) -> torch.Tensor:
    """SAM stability: IoU between the mask thresholded at +offset and -offset."""
    hi = (logits > offset).to(torch.float32).sum(dim=(1, 2))
    lo = (logits > -offset).to(torch.float32).sum(dim=(1, 2))
    return hi / torch.clamp(lo, min=1.0)


def boxes_from_masks(masks: torch.Tensor) -> torch.Tensor:
    """(M, H, W) bool -> (M, 4) [y0, x0, y1, x1] pixel boxes (y1/x1
    exclusive).  Empty masks give zero-area boxes at the origin."""
    _, h, w = masks.shape
    dev = masks.device
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    big = torch.tensor(1 << 30, dtype=torch.int32, device=dev)
    neg = torch.tensor(-1, dtype=torch.int32, device=dev)
    y0 = torch.where(masks, ys, big).amin(dim=(1, 2))
    x0 = torch.where(masks, xs, big).amin(dim=(1, 2))
    y1 = torch.where(masks, ys, neg).amax(dim=(1, 2)) + 1
    x1 = torch.where(masks, xs, neg).amax(dim=(1, 2)) + 1
    box = torch.stack([y0, x0, y1, x1], dim=-1)
    empty = (y1 <= 0)[:, None]
    return torch.where(empty, torch.zeros_like(box), box).to(torch.float32)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, 4) x (N, 4) -> (M, N) IoU."""
    y0 = torch.maximum(a[:, None, 0], b[None, :, 0])
    x0 = torch.maximum(a[:, None, 1], b[None, :, 1])
    y1 = torch.minimum(a[:, None, 2], b[None, :, 2])
    x1 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(y1 - y0, min=0) * torch.clamp(x1 - x0, min=0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_ref(
    boxes: torch.Tensor,  # (M, 4)
    scores: torch.Tensor,  # (M,)
    valid: torch.Tensor,  # (M,)
    iou_thresh: float = 0.7,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the reference's sequential
    ``fori_loop`` as a Python loop of small ops, one turn a candidate.

    Candidates go in score order (stable; a valid NaN score after every
    number); one is kept iff it is valid and no earlier kept candidate
    overlaps it above the threshold (IoU in float32 against the threshold
    rounded to float32)."""
    m = boxes.shape[0]
    neg_inf = torch.full_like(scores, float("-inf"))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), stable=True)
    v = valid[order]
    iou = box_iou(boxes[order], boxes[order])
    keep_sorted = torch.zeros(m, dtype=torch.bool, device=boxes.device)
    for i in range(m):
        sup = (iou[i, :i] > iou_thresh) & keep_sorted[:i]
        keep_sorted[i] = v[i] & ~sup.any()
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep


def nms_route(m: int) -> str:
    """The kernel's route for M candidates: "block" up to ONE_BLOCK_MAX_M
    (one launch, one block), else "grid"."""
    return "block" if m <= ONE_BLOCK_MAX_M else "grid"


def nms(
    boxes: torch.Tensor,  # (M, 4) float32 [y0, x0, y1, x1]
    scores: torch.Tensor,  # (M,) float32
    valid: torch.Tensor,  # (M,) bool
    iou_thresh: float = 0.7,
) -> torch.Tensor:
    """Greedy box NMS over a fixed candidate set; returns the keep mask (M,)
    bool (JAX reference: holoagent_tpu/ops/masks.py::nms).  A CUDA tensor
    goes through the kernel of ``csrc/masks.cu``, one launch a call; a CPU
    tensor through ``nms_ref``."""
    m = boxes.shape[0]
    if boxes.shape != (m, 4) or scores.shape != (m,) or valid.shape != (m,):
        raise ValueError(f"nms takes boxes (M, 4), scores (M,) and valid (M,), got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(valid.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"nms takes float32 boxes and scores and bool valid, got {boxes.dtype}, {scores.dtype}, "
                        f"{valid.dtype}")
    if not boxes.device == scores.device == valid.device:
        raise ValueError(f"nms inputs on {boxes.device}, {scores.device}, {valid.device}: they must share a device")
    if boxes.device.type == "cpu":
        return nms_ref(boxes, scores, valid, iou_thresh)
    bk = kernel_input(boxes, "boxes", torch.float32)
    sk = kernel_input(scores, "scores", torch.float32)
    vk = kernel_input(valid, "valid", torch.bool)
    keep = torch.empty(m, dtype=torch.bool, device=boxes.device)
    route = nms_route(m)
    scratch = None
    if route == "grid":  # sorted boxes, keys, indices, validity and the bit matrix (the source's layout(m))
        words = (m + 63) // 64
        scratch = torch.empty(29 * m + 8 * m * words + 8 * words + 16, dtype=torch.uint8, device=boxes.device)
    launch(
        nms, (m,), torch.cuda.current_stream(boxes.device), LIB.load().ha_nms,
        bk.data_ptr(), sk.data_ptr(), vk.data_ptr(), iou_thresh, keep.data_ptr(),
        None if scratch is None else scratch.data_ptr(), 0 if scratch is None else scratch.numel(), m,
        route=route,
    )
    return keep


nms.launches = 0
nms.routes = {"block": 0, "grid": 0}
nms.trace = None


def to_disjoint(masks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Make the mask set pixel-disjoint: every covered pixel goes to its
    smallest covering valid mask (ties to the lower index)."""
    m = masks.shape[0]
    flat = masks.reshape(m, -1)
    inf = torch.tensor(float("inf"), device=masks.device)
    area = torch.where(valid, flat.sum(-1).to(torch.float32), inf)
    key = torch.where(flat & valid[:, None], area[:, None], inf)  # (M, P)
    owner = torch.argmin(key, dim=0)  # (P,)
    owned = key.gather(0, owner[None])[0] < inf
    lane = torch.arange(m, device=masks.device)[:, None]
    out = flat & owned[None, :] & (lane == owner[None, :])
    return out.reshape(masks.shape)


def _pair_overlaps(masks: torch.Tensor):
    """(M, H, W) bool -> (float (M, P) masks, (M, M) intersections, (M,)
    areas clamped at 1)."""
    mf = masks.reshape(masks.shape[0], -1).to(torch.float32)
    return mf, mf @ mf.T, torch.clamp(mf.sum(-1), min=1.0)


def subtract_contained(masks: torch.Tensor, valid: torch.Tensor, thresh: float = 0.9) -> torch.Tensor:
    """Carve contained masks out of their containers (reference
    sam_utils.py:10-33 ``filter_masks``): when mask i holds over `thresh`
    of a smaller valid mask j, j's pixels leave i, in one shot over all
    pairs.  Returns the carved (M, H, W) masks."""
    m = masks.shape[0]
    mf, inter, area = _pair_overlaps(masks)
    child = inter / area[None, :]  # child[i, j] = |i ∩ j| / |j|
    smaller = area[None, :] < area[:, None]
    eye = torch.eye(m, dtype=torch.bool, device=masks.device)
    is_child = (child > thresh) & smaller & ~eye & valid[None, :] & valid[:, None]
    carve = (is_child.to(torch.float32) @ mf) > 0.5
    return (masks.reshape(m, -1) & ~carve).reshape(masks.shape)


def containment_filter(masks: torch.Tensor, valid: torch.Tensor, thresh: float = 0.9) -> torch.Tensor:
    """Keep mask (M,): drop a mask whose intersection with a bigger valid
    mask is over `thresh` of its own area (reference sam_utils.py:10-33)."""
    _, inter, area = _pair_overlaps(masks)
    contain = inter / area[:, None]  # contain[i, j] = |i ∩ j| / |i|
    bigger = area[None, :] > area[:, None]
    eaten = (contain > thresh) & bigger & valid[None, :]
    eye = torch.eye(masks.shape[0], dtype=torch.bool, device=masks.device)
    return valid & ~(eaten & ~eye).any(dim=1)
