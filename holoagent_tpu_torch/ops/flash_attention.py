"""Attention kernels K1 (``flash_attention_2d``) and K2 (``flash_attention``).

Counterpart of holoagent_tpu/ops/flash_attention.py.  Both Pallas kernels
there become hand-written CUDA C++ kernels for Hopper
(``csrc/flash_attention.cu``, built for ``sm_90a`` with ``nvcc`` at first
use into ``_build/`` and loaded with ``ctypes``, by ``ops/_cuda_build.py``).

Beside each wrapper sits its plain PyTorch version (``*_ref``): dense float32
scores from inputs in the working dtype, bias and masks, softmax, the
probabilities cast to the input dtype, then P.V with float32 accumulation.
A wrapper takes the plain version only for a tensor on the CPU; a CUDA
tensor goes through a kernel or the wrapper raises.  The kernels have no
backward: under grad mode a CUDA input that requires grad raises
(``_cuda_build.refuse_autograd``); the training forwards run the plain
versions (``impl="xla"``), as the reference's training does.  Each wrapper counts
its kernel launches in ``<wrapper>.launches`` and by route in
``<wrapper>.routes``; while ``<wrapper>.trace`` is a list, it also appends
CUDA events around each launch (see ``_cuda_build.launch``).

Like the reference's, the wrappers take any float32 or bf16 input, any head
dim up to ``GENERAL_D_MAX`` and, for K1, any grid.  The route is chosen from
the shape and the dtype before the launch (``k1_route``, ``k2_route``;
``T_MAX`` is the resident kernel's own limit):
- K1, bf16, head dim 64 or 80 (``K1_HEAD_DIMS``: SAM vit_b, vit_l, vit_h),
  N <= ``T_MAX`` and h + w <= ``RES_HW_MAX`` (the SAM windows): "resident",
  the resident tensor-core kernel with the bias;
- K1, bf16, head dim 64 or 80, N > ``T_MAX`` on a grid ``GLOBAL_W`` wide
  (every SAM variant's global layers at 1024 px): "global", the TMA +
  ``wgmma`` kernel with the bias;
- K2, bf16, head dim 64 (CLIP ViT-B-32 and ViT-L/14, every text tower, the
  VLMs), causal or not, or 80 without the causal mask (ViT-H-14's visual
  tower; ``K2_HEAD_DIMS``): "resident" for T <= ``T_MAX`` (with causal each
  query tile skips the keys past its last row and masks only the chunk that
  holds its diagonal), "long" beyond (the same TMA + ``wgmma`` kernel
  without the bias, its key loop ending at the diagonal tile with causal);
- everything else, for either kernel: "general" (float32 towers, the tiny
  and fixture towers' head dims 16 and 32, a causal layer at 80, K1's other
  grids, SAM 2's Hiera trunk at head dim 72, and K2 with fewer queries than
  keys): two streaming kernels on the tensor cores behind one C entry, G1
  for bf16 (``mma.sync`` bf16, K and V staged in bf16) and G2 for float32
  (3xTF32 ``mma.sync``: float32's accuracy with TF32 off), each at the head
  dim rounded up to 16 (``GENERAL_DMS``), 64 queries a block
  (``GENERAL_BQ``), key tiles through a ``GENERAL_STAGES``-deep
  ``cp.async`` ring (``general_grid``, ``general_plan``).
The wrappers raise only for a head dim above ``GENERAL_D_MAX``, another
dtype, or more heads than a resident or K1 global launch's grid holds
(``MAX_HEADS``).
The tensor-core kernels read q, k and v where they lie: any batch, head and
token strides that are multiples of 16 bytes, last dim contiguous, such as
``_attend``'s and ``_attention_2d``'s views of a fused (B, T, 3W) projection
(``strided_inputs``; a layout they do not read in place is copied by
``kernel_layout``); the general kernels read any strides with a contiguous
last dim (by 16-byte copies where q, k, v and their strides allow, else
element by element: the C entry decides from the pointers and strides).
Each writes a (B, T, H, D) buffer and the wrapper returns its (B, H, T, D)
transpose (``attention_output``), so the caller's transpose back to (B, T,
W) is a view and no K2 call copies anything.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._cuda_build import CudaLibrary, aligned_contiguous, check_input, kernel_input, launch, refuse_autograd

NEG_INF = -1e30
HEAD_DIM = 64  # CLIP ViT-B-32 and ViT-L/14, every text tower, the VLMs; SAM vit_b and vit_l
K1_HEAD_DIMS = (64, 80)  # the tensor-core instantiations: 80 is SAM vit_h's (HEAD_DIM_WIDE of csrc/flash_attention.cu)
K2_HEAD_DIMS = (64, 80)  # 80: CLIP ViT-H-14's visual tower, without the causal mask
GENERAL_D_MAX = 128  # the general kernels' largest head dim: GEN_D_MAX of csrc/flash_attention.cu
GENERAL_BQ = 64  # queries a block of the general kernels: GEN_BQ of csrc/flash_attention.cu
GENERAL_STAGES = 2  # the general kernels' K/V ring: GEN_STAGES of csrc/flash_attention.cu
GENERAL_DMS = tuple(range(16, GENERAL_D_MAX + 1, 16))  # the instantiated head dims: d rounded up to 16
MAX_HEADS = 65535  # heads the resident and global routes' grids hold (their y dimension)
DTYPES = (torch.bfloat16, torch.float32)
TYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}  # in each launch's trace key
T_MAX = 320  # longest N of the resident kernel: T_MAX of csrc/flash_attention.cu (a test holds them equal)
GLOBAL_W = 64  # the grid width K1's global kernel takes (N > T_MAX): G_W of csrc/flash_attention.cu
RES_HW_MAX = 128  # largest h + w of K1's resident route (N <= T_MAX): RES_HW_MAX of csrc/flash_attention.cu


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Dense attention of q (B, H, Tq, D) over k and v (B, H, Tk, D) with
    the kernel's semantics; the causal mask takes Tq == Tk."""
    t, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    if causal:
        if k.shape[-2] != t:
            raise ValueError(f"the causal mask takes as many queries as keys, got {t} and {k.shape[-2]}")
        idx = torch.arange(t, device=q.device)
        s = s.masked_fill(idx[None, :] > idx[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention_2d_ref(
    q: torch.Tensor,  # (BH, N, D) or (B, H, N, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias_h: torch.Tensor,  # (BH, N, h) f32
    bias_w: torch.Tensor,  # (BH, N, w) f32
    grid_hw: Tuple[int, int],
) -> torch.Tensor:
    """Dense rel-pos attention over an h x w token grid:
    s[q, k] = q.k * d^-1/2 + bias_h[q, row(k)] + bias_w[q, col(k)].
    The output has q's leading dims."""
    n, d = q.shape[-2:]
    h, w = grid_hw
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    s = s.reshape(-1, n, h, w) + bias_h.float()[..., :, None] + bias_w.float()[..., None, :]
    p = torch.softmax(s.reshape(q.shape[:-1] + (n,)), dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


_p, _i, _f, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
LIB = CudaLibrary("flash_attention.cu", {
    "ha_flash_attention_2d": [_p, _p, _p, _p, _p, _p, *[_l] * 9, _i, _i, _i, _i, _i, _i, _f, _p],
    "ha_flash_attention_resident": [_p, _p, _p, _p, *[_l] * 9, _i, _i, _i, _i, _i, _f, _p],
    "ha_flash_attention_long": [_p, _p, _p, _p, *[_l] * 9, _i, _i, _i, _i, _i, _f, _p],
    "ha_flash_attention_general": [_p, _p, _p, _p, _p, _p, *[_l] * 9, *[_i] * 9, _f, _p],
    "ha_flash_attention_general_plan": [*[_i] * 7, ctypes.POINTER(ctypes.c_int)],
    "ha_flash_attention_plan": [_i, _i, _i, _i, _i, ctypes.POINTER(ctypes.c_int)],
    "ha_flash_attention_global_plan": [_i, _i, _i, _i, ctypes.POINTER(ctypes.c_int)],
})


# ---------------------------------------------------------------------------
# Layouts and launch plans of the resident and global kernels
# ---------------------------------------------------------------------------


def strided_layout(x: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """(batch, head, token) strides in elements of a (B, H, T, D) tensor
    the resident and global kernels read in place, or None: the last dim
    contiguous, the other strides and the start multiples of 16 bytes."""
    size = x.element_size()
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(s * size % 16 for s in x.stride()[:3]):
        return None
    return tuple(x.stride()[:3])


def kernel_layout(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """`x` and its strides if the kernels read it in place, else a
    contiguous 16-byte-aligned copy and its strides."""
    strides = strided_layout(x)
    if strides is None:
        x = aligned_contiguous(x)
        strides = tuple(x.stride()[:3])
    return x, strides


def strided_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, route: str) -> list:
    """(tensor, strides) of q, k and v: CUDA tensors of q's dtype (bf16 for
    a tensor-core route), each read in place where the route can read it:
    the 16-byte rule of `kernel_layout` for the tensor-core kernels, a
    contiguous last dim for the general kernels."""
    for x, nm in ((q, "q"), (k, "k"), (v, "v")):
        check_input(x, nm, torch.bfloat16 if route != "general" else q.dtype)
    if route != "general":
        return [kernel_layout(x) for x in (q, k, v)]
    out = [x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v)]
    return [(x, tuple(x.stride()[:3])) for x in out]


def attention_output(b: int, h: int, t: int, d: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The resident and global kernels' output: a (B, T, H, D) buffer seen as (B, H, T, D)."""
    return torch.empty((b, t, h, d), dtype=dtype, device=device).transpose(1, 2)


def resident_plan(bh: int, t: int, hw: int = 0, causal: bool = False, d: int = HEAD_DIM) -> dict:
    """The resident kernel's launch for `bh` heads of `t` tokens on the
    current card: query tiles per block, blocks per head, blocks per SM
    (CUDA's occupancy calculator), SMs, registers a thread, shared memory a
    block in bytes, and the blocks per SM that the registers alone and the
    shared memory alone allow (the card's own figures).  `hw`: grid_h +
    grid_w for K1 (the bias staged too), 0 for K2; `causal`: K2's causal
    instantiation; `d`: the head dim (64, or 80 without causal)."""
    out = (ctypes.c_int * 8)()
    err = LIB.load().ha_flash_attention_plan(bh, t, hw, int(causal), d, out)
    if err:
        raise RuntimeError(f"ha_flash_attention_plan failed: cudaError {err}")
    keys = ("tiles_per_block", "blocks_per_head", "blocks_per_sm", "sms", "regs", "smem", "blocks_by_regs",
            "blocks_by_smem")
    return dict(zip(keys, out))


def global_plan(bh: int, n: int, rel_pos: bool = True, d: int = HEAD_DIM) -> dict:
    """The global kernel's launch for `bh` heads of `n` tokens on the
    current card, K1's (`rel_pos`) or K2's long route, at head dim `d`:
    blocks per head, blocks, blocks per SM, SMs."""
    out = (ctypes.c_int * 4)()
    err = LIB.load().ha_flash_attention_global_plan(bh, n, int(rel_pos), d, out)
    if err:
        raise RuntimeError(f"ha_flash_attention_global_plan failed: cudaError {err}")
    return dict(zip(("blocks_per_head", "grid", "blocks_per_sm", "sms"), out))


def general_keys(dm: int, dtype: torch.dtype) -> int:
    """Keys a tile of the general kernels at padded head dim `dm`: 64, and
    32 for float32 above 64 (GenCfg::BK of csrc/flash_attention.cu)."""
    return 32 if dtype == torch.float32 and dm > 64 else 64


def general_grid(bh: int, t: int, d: int = HEAD_DIM, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The general kernels' grid for `bh` heads of `t` tokens at head dim
    `d`: query tiles of GENERAL_BQ a head, one block each, at the padded
    head dim `dm` (d rounded up to 16) and its keys a tile."""
    tiles = -(-t // GENERAL_BQ)
    dm = -(-d // 16) * 16
    return {"blocks_per_head": tiles, "grid": tiles * bh, "dm": dm, "keys_per_tile": general_keys(dm, dtype)}


def general_plan(bh: int, t: int, d: int = HEAD_DIM, dtype: torch.dtype = torch.bfloat16,
                 grid_hw: Optional[Tuple[int, int]] = None, causal: bool = False) -> dict:
    """A general launch's plan on the current card (its instantiation with
    16-byte staging): general_grid's figures as the source computes them,
    and as resident_plan gives them blocks per SM (CUDA's occupancy
    calculator), SMs, registers a thread, shared memory a block in bytes,
    and the blocks per SM that the registers alone and the shared memory
    alone allow.  `grid_hw`: K1's grid (the bias on), None for K2; `causal`:
    K2's causal instantiation."""
    gh, gw = grid_hw or (0, 0)
    out = (ctypes.c_int * 10)()
    err = LIB.load().ha_flash_attention_general_plan(bh, t, d, gh, gw, int(causal), int(dtype == torch.bfloat16), out)
    if err:
        raise RuntimeError(f"ha_flash_attention_general_plan failed: cudaError {err}")
    keys = ("blocks_per_head", "grid", "blocks_per_sm", "sms", "regs", "smem", "blocks_by_regs", "blocks_by_smem",
            "dm", "keys_per_tile")
    return dict(zip(keys, out))


def _takes(d: int, dtype: torch.dtype) -> None:
    if d > GENERAL_D_MAX:
        raise ValueError(f"head dim {d}: the kernels take head dims up to {GENERAL_D_MAX}")
    if dtype not in DTYPES:
        raise TypeError(f"the kernels take {DTYPES}, got {dtype}")


def k1_route(h: int, w: int, d: int = HEAD_DIM, dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel K1 launches for an h x w grid at head dim `d`: "resident"
    (bf16, d in K1_HEAD_DIMS, N = h*w <= T_MAX, h + w <= RES_HW_MAX),
    "global" (bf16, d in K1_HEAD_DIMS, N > T_MAX on a grid GLOBAL_W wide),
    else "general"; raises for a head dim above GENERAL_D_MAX or another
    dtype."""
    _takes(d, dtype)
    if dtype != torch.bfloat16 or d not in K1_HEAD_DIMS:
        return "general"
    if h * w <= T_MAX:
        return "resident" if h + w <= RES_HW_MAX else "general"
    return "global" if w == GLOBAL_W else "general"


def k2_route(t: int, causal: bool, d: int = HEAD_DIM, dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel K2 launches for T tokens at head dim `d`: for bf16 at d =
    64 (causal or not) or 80 (not causal) "resident" for T <= T_MAX and
    "long" (the TMA + wgmma kernel) beyond; else "general"; raises for a
    head dim above GENERAL_D_MAX or another dtype."""
    _takes(d, dtype)
    if dtype != torch.bfloat16 or d not in K2_HEAD_DIMS or (causal and d != HEAD_DIM):
        return "general"
    return "resident" if t <= T_MAX else "long"


def _check_heads(bh: int, route: str) -> None:
    if route in ("resident", "global") and bh > MAX_HEADS:
        raise ValueError(f"{bh} heads: the {route} route's grid holds {MAX_HEADS}")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def flash_attention_2d(
    q: torch.Tensor,  # (BH, N, D) or (B, H, N, D), N = h*w row-major over the grid
    k: torch.Tensor,
    v: torch.Tensor,
    bias_h: torch.Tensor,  # (BH, N, h) f32
    bias_w: torch.Tensor,  # (BH, N, w) f32
    grid_hw: Tuple[int, int],
) -> torch.Tensor:
    """K1: SAM rel-pos attention (JAX reference:
    holoagent_tpu/ops/flash_attention.py::flash_attention_2d).  The output
    has q's shape; on the card a 4-D output is the (B, H, N, D) view of a
    (B, N, H, D) buffer."""
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be (BH, N, D) or (B, H, N, D), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    *lead, n, d = q.shape
    bh = math.prod(lead)
    h, w = grid_hw
    if n != h * w:
        raise ValueError(f"N={n} does not match grid {grid_hw}")
    if bias_h.shape != (bh, n, h) or bias_w.shape != (bh, n, w):
        raise ValueError(f"bias shapes {bias_h.shape} {bias_w.shape} for q {q.shape}")
    if q.device.type == "cpu":
        return flash_attention_2d_ref(q, k, v, bias_h, bias_w, grid_hw)
    refuse_autograd("flash_attention_2d", q, k, v, bias_h, bias_w)
    route = k1_route(h, w, d, q.dtype)
    _check_heads(bh, route)
    flat = q.dim() == 3
    if flat:
        q, k, v = q[None], k[None], v[None]
    b, heads = q.shape[:2]
    (q, sq), (k, sk), (v, sv) = strided_inputs(q, k, v, route)
    bias_h = kernel_input(bias_h, "bias_h", torch.float32)
    bias_w = kernel_input(bias_w, "bias_w", torch.float32)
    o = attention_output(b, heads, n, d, q.dtype, q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(), bias_w.data_ptr(), o.data_ptr())
    lib, stream = LIB.load(), torch.cuda.current_stream(q.device)
    key = (b, heads, h, w, d, TYPE_NAMES[q.dtype])
    if route == "general":
        launch(flash_attention_2d, key, stream, lib.ha_flash_attention_general, *ptrs, *sq, *sk, *sv, b, heads, n, n,
               d, h, w, 0, int(q.dtype == torch.bfloat16), d**-0.5, route=route)
    else:
        launch(flash_attention_2d, key, stream, lib.ha_flash_attention_2d, *ptrs, *sq, *sk, *sv, b, heads, n, d, h, w,
               d**-0.5, route=route)
    return o[0] if flat else o


flash_attention_2d.launches = 0
flash_attention_2d.routes = dict.fromkeys(("resident", "global", "general"), 0)
flash_attention_2d.trace = None


def flash_attention(
    q: torch.Tensor,  # (B, H, Tq, D)
    k: torch.Tensor,  # (B, H, Tk, D)
    v: torch.Tensor,
    causal: bool = False,
) -> torch.Tensor:
    """K2: blockwise attention, optional causal mask (JAX reference:
    holoagent_tpu/ops/flash_attention.py::flash_attention).  Any T: the
    kernel masks the ragged key edge itself.  The queries may be fewer than
    the keys (Tq < Tk, no causal mask: Hiera's pooled-query blocks, Tq = Tk
    / 4), which the general route takes, counted in ``flash_attention.pooled``
    besides the route.  On the card the output is the (B, H, Tq, D) view of
    a (B, Tq, H, D) buffer.  A launch's trace key is (B, H, T, D, causal,
    dtype), with Tk appended where it differs from Tq."""
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3:] != q.shape[3:] or q.dim() != 4:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    b, h, t, d = q.shape
    tk = k.shape[2]
    if causal and tk != t:
        raise ValueError(f"the causal mask takes as many queries as keys, got {t} and {tk}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    refuse_autograd("flash_attention", q, k, v)
    route = k2_route(t, causal, d, q.dtype) if tk == t else "general"
    _check_heads(b * h, route)
    (q, sq), (k, sk), (v, sv) = strided_inputs(q, k, v, route)
    o = attention_output(b, h, t, d, q.dtype, q.device)
    lib, stream = LIB.load(), torch.cuda.current_stream(q.device)
    key = (b, h, t, d, causal, TYPE_NAMES[q.dtype]) + ((tk,) if tk != t else ())
    if route == "general":
        launch(flash_attention, key, stream, lib.ha_flash_attention_general, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               None, None, o.data_ptr(), *sq, *sk, *sv, b, h, t, tk, d, 0, 0, int(causal),
               int(q.dtype == torch.bfloat16), d**-0.5, route=route)
        flash_attention.pooled += int(tk != t)
    else:
        entry = lib.ha_flash_attention_resident if route == "resident" else lib.ha_flash_attention_long
        launch(flash_attention, key, stream, entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *sq, *sk,
               *sv, b, h, t, d, int(causal), d**-0.5, route=route)
    return o


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(("resident", "long", "general"), 0)
flash_attention.pooled = 0  # launches with fewer queries than keys (on the general route)
flash_attention.trace = None
