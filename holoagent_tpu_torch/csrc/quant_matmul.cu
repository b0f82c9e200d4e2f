// Fused W8A8 linear layer for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel K3 of holoagent_tpu/ops/quant_matmul.py
// (quant_matmul, kernel _kernel; batched_quant_matmul flattens into it), and
// serves the unfused int8 path too (holoagent_tpu/models/transformer.py::
// matmul_int8 plus its bias, which SAM's int8 encoder calls):
//   a_s[m]    = max(max_k |x[m, k]| * f32(1/127), 1e-12)        f32, per row
//   x_q[m, k] = clamp(rint(x[m, k] / a_s[m]), -127, 127)         int8, half to even
//   acc[m, n] = sum_k x_q[m, k] * w_q[n, k]                      int32
//   out[m, n] = (float(acc) * a_s[m]) * w_s[n] + bias[n]         f32, no FMA
// stored as bf16 (round to nearest even) or f32.  x is (M, K) bf16 or f32,
// row-major.  w_q is int8 (N, K), row-major: each output channel's weights
// are K-contiguous, the layout mma.sync takes for its B operand.  The row
// scale is the reciprocal product the reference computes (XLA folds its
// `/ 127.0` into `* (1/127)`), the quantizing division is IEEE division
// (`__fdiv_rn`), rounding is `rintf`.  With no --use_fast_math and the
// epilogue in __fmul_rn / __fadd_rn, the kernel does the plain version's
// arithmetic operation for operation.
//
// What bounds it on the H100.  At the W8A8 towers' shapes (CLIP ViT-L/14:
// M = 257 * (2 * tier + 1) rows, K x N of 1024 x 3072, 1024 x 1024,
// 1024 x 4096, 4096 x 1024; SAM vit_b: M = 4096 or 4900, K x N of 768 x
// 2304, 768 x 768, 768 x 3072, 3072 x 768) the dense int8 work (2 M N K at
// 1,979 TOP/s) and the traffic (x, w and the output once each, at 3.35 TB/s)
// are of one order: CLIP's fc1 at tier 16 is 71 GOP (36 us) against 90 MB
// (27 us).  Both bounds are far below what mma.sync without a pipeline
// reaches, so this kernel is bound by its own instruction throughput: the
// MMAs and, next to them, the quantization it repeats for every 256-column
// block.
//
// Design.  One block (8 warps, 256 threads) owns a 64 x 256 output tile.
//   Prologue: each warp reduces |x| over the whole of K for 8 of the tile's
//     rows (16-byte loads, warp shuffles) into the 64 row scales, which stay
//     in shared memory.
//   Main loop over K in steps of 64: each thread loads its part of the next
//     x tile (bf16 or f32) and of the next int8 weight tile into registers
//     before the current tile's MMAs, so the loads' latency overlaps them;
//     after the MMAs it quantizes the x part into the int8 tile in shared
//     memory and copies the weight part beside it.  Each warp owns a 32 x 64
//     sub-tile: mma.sync m16n8k32 s8 x s8 -> s32, 2 x 8 MMAs per 32-deep
//     step, 64 int32 accumulators a thread.  Shared rows are padded by 16
//     bytes, which makes the fragment loads free of bank conflicts.  Two
//     blocks share a multiprocessor, so one block's loads, quantization and
//     barriers overlap the other's MMAs.
//   Epilogue: dequantize, add the bias, round once, store; the ragged M and
//     N edges are masked here, so callers pass M = 4900 or 8481 unpadded.
// Unlike the Pallas kernel, the quantized row panel is not held whole: at
// K = 4096 a 64-row int8 panel is 256 KB, above the 227 KB a block can use.
// Each block quantizes 64 x 64 slices as it walks K instead.
//
// Left for later: wgmma and TMA, a multi-stage cp.async pipeline, and one
// quantization of each row panel shared by all the blocks of that panel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 256;
constexpr int BK = 64;  // K step, in int8 elements (bytes)
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // 32 rows per warp
constexpr int WN = BN / WARPS_N;  // 64 columns per warp
constexpr int MT = WM / 16;       // m16 tiles per warp
constexpr int NT = WN / 8;        // n8 tiles per warp
constexpr int LDS = BK + 16;      // padded shared row, bytes
constexpr int ROWS_PER_WARP = BM / (THREADS / 32);
constexpr float INV_127 = 0x1.020408p-7f;  // f32(1/127)
constexpr float SCALE_FLOOR = 1e-12f;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <typename TIn>
struct Tile {
  static constexpr int VEC = 16 / sizeof(TIn);          // x elements per 16-byte load
  static constexpr int XV = BM * BK / VEC / THREADS;    // x loads per thread per tile
  static constexpr int WV = BN * BK / 16 / THREADS;     // weight loads per thread per tile
};

// Global -> registers: this thread's part of the x and weight tiles at k0,
// zero outside the matrix (zero x quantizes to zero, zero weights add nothing).
template <typename TIn>
__device__ __forceinline__ void load_tile(const TIn* __restrict__ x, const int8_t* __restrict__ w,
                                          int m0, int n0, int k0, int M, int N, int K,
                                          uint4 (&xr)[Tile<TIn>::XV],
                                          uint4 (&wr)[Tile<TIn>::WV]) {
  constexpr int VEC = Tile<TIn>::VEC;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < Tile<TIn>::XV; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BK / VEC), c = (i % (BK / VEC)) * VEC;
    xr[j] = (m0 + r < M && k0 + c < K)
                ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * K + k0 + c)
                : zero;
  }
#pragma unroll
  for (int j = 0; j < Tile<TIn>::WV; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    wr[j] = (n0 + r < N && k0 + c < K)
                ? *reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * K + k0 + c)
                : zero;
  }
}

// Registers -> shared: quantize the x part with the row scales, copy the
// weight part as it is.
template <typename TIn>
__device__ __forceinline__ void store_tile(const uint4 (&xr)[Tile<TIn>::XV],
                                           const uint4 (&wr)[Tile<TIn>::WV], const float* as_s,
                                           int8_t* xs, int8_t* ws) {
  constexpr int VEC = Tile<TIn>::VEC;
#pragma unroll
  for (int j = 0; j < Tile<TIn>::XV; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BK / VEC), c = (i % (BK / VEC)) * VEC;
    const float a = as_s[r];
    const TIn* e = reinterpret_cast<const TIn*>(&xr[j]);
    uint32_t words[VEC / 4] = {};
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      float q = rintf(__fdiv_rn(to_float(e[t]), a));
      q = fminf(fmaxf(q, -127.f), 127.f);
      words[t / 4] |= (static_cast<uint32_t>(__float2int_rn(q)) & 0xffu) << (8 * (t % 4));
    }
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint2*>(xs + r * LDS + c) = make_uint2(words[0], words[1]);
    } else {
      *reinterpret_cast<uint32_t*>(xs + r * LDS + c) = words[0];
    }
  }
#pragma unroll
  for (int j = 0; j < Tile<TIn>::WV; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    *reinterpret_cast<uint4*>(ws + r * LDS + c) = wr[j];
  }
}

// Two blocks a multiprocessor: ptxas then fits the kernel in 128 registers
// (with a spill of about 20 bytes) where it takes 170 for one.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS, 2)
qmm_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ w_s,
           const float* __restrict__ bias, TOut* __restrict__ out, int M, int N, int K) {
  constexpr int VEC = Tile<TIn>::VEC;
  __shared__ __align__(16) int8_t xs[BM * LDS];
  __shared__ __align__(16) int8_t ws[BN * LDS];
  __shared__ float as_s[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the mma fragment
  const int tg = lane & 3;  // column group within the mma fragment
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  uint4 xr[Tile<TIn>::XV], wr[Tile<TIn>::WV];
  load_tile<TIn>(x, w, m0, n0, 0, M, N, K, xr, wr);  // in flight during the prologue

  // prologue: the row scales of the tile's 64 rows, over the whole of K
  for (int r = warp * ROWS_PER_WARP; r < (warp + 1) * ROWS_PER_WARP; ++r) {
    float amax = 0.f;
    if (m0 + r < M) {
      const TIn* row = x + static_cast<size_t>(m0 + r) * K;
      for (int c = lane * VEC; c < K; c += 32 * VEC) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + c);
        const TIn* e = reinterpret_cast<const TIn*>(&v);
#pragma unroll
        for (int t = 0; t < VEC; ++t) amax = fmaxf(amax, fabsf(to_float(e[t])));
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) as_s[r] = fmaxf(__fmul_rn(amax, INV_127), SCALE_FLOOR);
  }
  __syncthreads();
  store_tile<TIn>(xr, wr, as_s, xs, ws);
  __syncthreads();

  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  int acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

  const int num_k = (K + BK - 1) / BK;
  for (int kt = 0; kt < num_k; ++kt) {
    const bool more = kt + 1 < num_k;
    if (more) load_tile<TIn>(x, w, m0, n0, (kt + 1) * BK, M, N, K, xr, wr);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int8_t* p = xs + (wm * WM + mi * 16 + g) * LDS + ks + tg * 4;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * LDS);
        a[mi][2] = ld32(p + 16);
        a[mi][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int8_t* p = ws + (wn * WN + ni * 8 + g) * LDS + ks + tg * 4;
        const uint32_t b0 = ld32(p), b1 = ld32(p + 16);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this tile
    if (more) {
      store_tile<TIn>(xr, wr, as_s, xs, ws);
      __syncthreads();
    }
  }

  // epilogue: (acc * a_s) * w_s + bias in f32, rounded once into TOut
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int col = n0 + wn * WN + ni * 8 + tg * 2;  // N % 8 == 0: col < N implies col + 1 < N
    if (col >= N) continue;
    const float s0 = w_s[col], s1 = w_s[col + 1];
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * WM + mi * 16 + g + 8 * h;
        if (m0 + rl >= M) continue;
        const float a = as_s[rl];
        const float v0 =
            __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), a), s0), b0);
        const float v1 =
            __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), a), s1), b1);
        store2(out + static_cast<size_t>(m0 + rl) * N + col, v0, v1);
      }
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const void* w_q, const void* w_s, const void* bias, void* out, int m,
           int n, int k, cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);  // neighbouring blocks share a row panel
  qmm_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const int8_t*>(w_q), static_cast<const float*>(w_s),
      static_cast<const float*>(bias), static_cast<TOut*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) bf16 (x_f32 == 0) or f32; w_q (n, k) int8; w_s (n,) f32; bias (n,)
// f32; out (m, n) bf16 (out_f32 == 0) or f32.  All contiguous and 16-byte
// aligned; n % 8 == 0, k % 16 == 0, (m + 63) / 64 <= 65535.  Returns the
// cudaError_t of the launch.
extern "C" int ha_quant_matmul(const void* x, const void* w_q, const void* w_s, const void* bias,
                               void* out, int m, int n, int k, int x_f32, int out_f32,
                               void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 16 || (m + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    return out_f32 ? launch<float, float>(x, w_q, w_s, bias, out, m, n, k, s)
                   : launch<float, __nv_bfloat16>(x, w_q, w_s, bias, out, m, n, k, s);
  }
  return out_f32 ? launch<__nv_bfloat16, float>(x, w_q, w_s, bias, out, m, n, k, s)
                 : launch<__nv_bfloat16, __nv_bfloat16>(x, w_q, w_s, bias, out, m, n, k, s);
}
