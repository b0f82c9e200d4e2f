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
its kernel launches in ``<wrapper>.launches``; while ``<wrapper>.trace`` is a
list, it also appends CUDA events around each launch (see ``_cuda_build.launch``).

The kernels take bf16.  K2 takes head dim 64 (every CLIP tower and VLM);
K1 takes 64 (SAM vit_b, vit_l) and 80 (vit_h), each route instantiated at
both (``K1_HEAD_DIMS``); any other head dim raises.  Routes (``k1_route``,
``k2_route``, and ``T_MAX``, the kernel's own limit):
- K1, N <= ``T_MAX`` (the SAM windows): the resident kernel with the bias,
  for grids with h + w <= ``RES_HW_MAX``;
- K1, N > ``T_MAX`` (the SAM global layers): the TMA + ``wgmma`` global
  kernel with the bias, for grids ``GLOBAL_W`` wide (every SAM variant at
  1024 px); any other grid raises;
- K2, T <= ``T_MAX``, causal or not ("resident": every CLIP visual layer,
  the CLIP text tower): the resident kernel without the bias; with causal
  each query tile skips the keys past its last row and masks only the
  chunk that holds its diagonal;
- K2, T > ``T_MAX``, causal or not ("long": long prefills): the same TMA +
  ``wgmma`` kernel without the bias, its key loop ending at the diagonal
  tile with causal.
Every kernel reads q, k and v where they lie: any batch, head and token
strides that are multiples of 16 bytes, last dim contiguous, such as
``_attend``'s and ``_attention_2d``'s views of a fused (B, T, 3W) projection
(``strided_inputs``; a layout no kernel reads in place is copied by
``kernel_layout``).  Each writes a (B, T, H, D) buffer and the wrapper returns
its (B, H, T, D) transpose (``attention_output``), so the caller's transpose
back to (B, T, W) is a view and no K2 call copies anything.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._cuda_build import CudaLibrary, aligned_contiguous, check_input, kernel_input, launch, refuse_autograd

NEG_INF = -1e30
HEAD_DIM = 64  # K2's head dim (CLIP ViT-L/14, the VLMs), and K1's for SAM vit_b and vit_l
K1_HEAD_DIMS = (64, 80)  # K1's instantiations: 80 is SAM vit_h's (HEAD_DIM_WIDE of csrc/flash_attention.cu)
T_MAX = 320  # longest N of the resident kernel: T_MAX of csrc/flash_attention.cu (a test holds them equal)
GLOBAL_W = 64  # the grid width K1's global kernel takes (N > T_MAX): G_W of csrc/flash_attention.cu
RES_HW_MAX = 128  # largest h + w of K1's resident route (N <= T_MAX): RES_HW_MAX of csrc/flash_attention.cu


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Dense attention over (B, H, T, D) with the kernel's semantics."""
    t, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    if causal:
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


def strided_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list:
    """(tensor, strides) of q, k and v for the resident and global kernels:
    bf16 CUDA tensors, each read in place where it can be (`kernel_layout`)."""
    for x, nm in ((q, "q"), (k, "k"), (v, "v")):
        check_input(x, nm, torch.bfloat16)
    return [kernel_layout(x) for x in (q, k, v)]


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
    instantiation; `d`: the head dim (80 for K1 only)."""
    out = (ctypes.c_int * 8)()
    err = LIB.load().ha_flash_attention_plan(bh, t, hw, int(causal), d, out)
    if err:
        raise RuntimeError(f"ha_flash_attention_plan failed: cudaError {err}")
    keys = ("tiles_per_block", "blocks_per_head", "blocks_per_sm", "sms", "regs", "smem", "blocks_by_regs",
            "blocks_by_smem")
    return dict(zip(keys, out))


def global_plan(bh: int, n: int, rel_pos: bool = True, d: int = HEAD_DIM) -> dict:
    """The global kernel's launch for `bh` heads of `n` tokens on the
    current card, K1's (`rel_pos`, head dim `d`) or K2's long route: blocks
    per head, blocks, blocks per SM, SMs."""
    out = (ctypes.c_int * 4)()
    err = LIB.load().ha_flash_attention_global_plan(bh, n, int(rel_pos), d, out)
    if err:
        raise RuntimeError(f"ha_flash_attention_global_plan failed: cudaError {err}")
    return dict(zip(("blocks_per_head", "grid", "blocks_per_sm", "sms"), out))


def k1_route(h: int, w: int, d: int = HEAD_DIM) -> str:
    """The kernel K1 launches for an h x w grid at head dim `d`: "resident"
    for N = h*w <= T_MAX and h + w <= RES_HW_MAX, "global" for N > T_MAX on
    a grid GLOBAL_W wide; raises for any other grid or a head dim not in
    K1_HEAD_DIMS."""
    if d not in K1_HEAD_DIMS:
        raise ValueError(f"head dim {d}: K1 takes {K1_HEAD_DIMS}")
    if h * w <= T_MAX:
        if h + w > RES_HW_MAX:
            raise ValueError(f"grid {h}x{w}: K1's resident kernel takes h + w <= {RES_HW_MAX}")
        return "resident"
    if w != GLOBAL_W:
        raise ValueError(f"grid {h}x{w}, N > {T_MAX}: K1's global kernel takes width {GLOBAL_W}")
    return "global"


def k2_route(t: int, causal: bool) -> str:
    """The kernel K2 launches for T tokens: "resident" for T <= T_MAX,
    "long" (the TMA + wgmma kernel) beyond; causal or not, the same."""
    return "resident" if t <= T_MAX else "long"


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
    k1_route(h, w, d)
    flat = q.dim() == 3
    if flat:
        q, k, v = q[None], k[None], v[None]
    b, heads = q.shape[:2]
    (q, sq), (k, sk), (v, sv) = strided_inputs(q, k, v)
    bias_h = kernel_input(bias_h, "bias_h", torch.float32)
    bias_w = kernel_input(bias_w, "bias_w", torch.float32)
    o = attention_output(b, heads, n, d, q.dtype, q.device)
    launch(
        flash_attention_2d, (b, heads, h, w, d), torch.cuda.current_stream(q.device), LIB.load().ha_flash_attention_2d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(), bias_w.data_ptr(), o.data_ptr(),
        *sq, *sk, *sv, b, heads, n, d, h, w, d**-0.5,
    )
    return o[0] if flat else o


flash_attention_2d.launches = 0
flash_attention_2d.trace = None


def flash_attention(
    q: torch.Tensor,  # (B, H, T, D)
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
) -> torch.Tensor:
    """K2: blockwise attention, optional causal mask (JAX reference:
    holoagent_tpu/ops/flash_attention.py::flash_attention).  Any T: the
    kernel masks the ragged key edge itself.  On the card the output is the
    (B, H, T, D) view of a (B, T, H, D) buffer."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    b, h, t, d = q.shape
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    refuse_autograd("flash_attention", q, k, v)
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d}: K2 takes {HEAD_DIM}")
    entry = {"resident": "ha_flash_attention_resident", "long": "ha_flash_attention_long"}[k2_route(t, causal)]
    (q, sq), (k, sk), (v, sv) = strided_inputs(q, k, v)
    o = attention_output(b, h, t, d, q.dtype, q.device)
    launch(
        flash_attention, (b, h, t, causal), torch.cuda.current_stream(q.device), getattr(LIB.load(), entry),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *sq, *sk, *sv, b, h, t, d, int(causal), d**-0.5,
    )
    return o


flash_attention.launches = 0
flash_attention.trace = None
