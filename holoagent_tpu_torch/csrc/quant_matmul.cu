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
// are K-contiguous, the layout an 8-bit wgmma takes for its B operand.  The
// row scale is the reciprocal product the reference computes (XLA folds its
// `/ 127.0` into `* (1/127)`), the quantizing division is IEEE division
// (`__fdiv_rn`), rounding is `rintf`.  With no --use_fast_math and the
// epilogue in __fmul_rn / __fadd_rn, the kernel does the plain version's
// arithmetic operation for operation; the int32 sum is exact in any order.
//
// What bounds it on the H100.  At the W8A8 towers' shapes (CLIP ViT-L/14:
// M = 257 * (2 * tier + 1) rows, K x N of 1024 x 3072, 1024 x 1024,
// 1024 x 4096, 4096 x 1024; SAM vit_b: M = 4096 or 4900, K x N of 768 x
// 2304, 768 x 768, 768 x 3072, 3072 x 768) the dense int8 work (2 M N K at
// 1,979 TOP/s) and the traffic (x, w and the output once each, at 3.35 TB/s)
// are of one order: CLIP's fc1 at tier 16 is 71 GOP (36 us) against 90 MB
// (27 us).  Reaching either needs the tensor cores fed without stalls, which
// on Hopper means wgmma from shared memory filled by TMA, and x quantized
// once: the Pallas kernel keeps the quantized (bm, K) row panel in VMEM for
// the whole N sweep, but at K = 4096 a 64-row panel is 256 KB, above the
// 227 KB a block may use, so a block that quantizes its own x repeats the
// work for every column block (16 times at N = 4096).
//
// Design: two kernels launched back to back on the caller's stream.
//   Stage A (quantize_kernel): one warp per row up to 1024 bf16, else 128
//     threads per row; 16-byte loads, up to four a thread, all issued
//     together and held in registers (rows up to 4096 bf16).  It
//     reduces the row's amax, writes a_s[m], and writes the int8 row of x_q
//     (M, K) from the held loads.  Each element of x is read and quantized
//     once; x_q and a_s are scratch the wrapper allocates.
//   Stage B (gemm_kernel): one block of three warpgroups owns a 128 x 256
//     output tile.  (Narrower tiles for short grids were measured at every
//     main-path shape, SAM's N = 768 at M = 4096 included, and gained
//     nothing, so one tile width is built.)
//     - Warpgroup 0 is the producer: after `setmaxnreg` gives its registers
//       away, one thread issues TMA loads (cp.async.bulk.tensor, 128-byte
//       swizzle, a 128-byte K step) of the x_q tile (128 x 128) and the w_q
//       tile (256 x 128) into a ring of 4 stages in shared memory, each
//       guarded by a full and an empty mbarrier.  TMA fills rows past M or N
//       and columns past K with zeros, so no load is masked.
//     - Warpgroups 1 and 2 are the consumers, 64 rows each: per stage four
//       wgmma.mma_async m64n256k32 s8 x s8 -> s32 straight from the swizzled
//       tiles, one commit group per stage, at most one group in flight while
//       the next stage's group is issued; a stage goes back to the producer
//       once the group that read it has completed.
//     - Epilogue: each consumer thread dequantizes its accumulators with a_s
//       of its rows and w_s / bias of its columns in the order above and
//       rounds once; the warpgroup stages its 64 x 256 tile in the idle ring
//       and writes it out in coalesced 16-byte stores.  The ragged M and N
//       edges are masked here, so callers pass M = 4900, 8481 or 77
//       unpadded.
//
// Left for later: a persistent tile loop (one tile's epilogue overlapping the
// next tile's loads), TMA multicast across a cluster, and folding stage A
// into the producer of the first column block.

#include <cuda.h>  // CUtensorMap and its enums; the encoder itself is fetched from libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float INV_127 = 0x1.020408p-7f;  // f32(1/127)
constexpr float SCALE_FLOOR = 1e-12f;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// ---------------------------------------------------------------------------
// Stage A: row scales and int8 rows, once per element of x
// ---------------------------------------------------------------------------

constexpr int Q_BLOCK = 256;  // threads per block
constexpr int Q_HOLD = 4;     // 16-byte loads a thread holds

// Quantize the VEC elements of one 16-byte load of x into VEC bytes of x_q.
template <typename TIn>
__device__ __forceinline__ void quantize_store(const uint4& v, float a, int8_t* dst) {
  constexpr int VEC = 16 / sizeof(TIn);
  const TIn* e = reinterpret_cast<const TIn*>(&v);
  uint32_t words[VEC / 4] = {};
#pragma unroll
  for (int t = 0; t < VEC; ++t) {
    float q = rintf(__fdiv_rn(to_float(e[t]), a));
    q = fminf(fmaxf(q, -127.f), 127.f);
    words[t / 4] |= (static_cast<uint32_t>(__float2int_rn(q)) & 0xffu) << (8 * (t % 4));
  }
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(words[0], words[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = words[0];
  }
}

template <typename TIn>
__device__ __forceinline__ float abs_max(const uint4& v, float amax) {
  constexpr int VEC = 16 / sizeof(TIn);
  const TIn* e = reinterpret_cast<const TIn*>(&v);
#pragma unroll
  for (int t = 0; t < VEC; ++t) amax = fmaxf(amax, fabsf(to_float(e[t])));
  return amax;
}

// TPR threads per row (32 where a warp holds the row, else 128), each
// issuing its (up to) Q_HOLD loads together and holding them for the
// quantizing pass, so a row of the towers' widths (up to 4096 bf16) is read
// from device memory once; a longer row re-reads its tail.
template <typename TIn, int TPR>
__global__ void __launch_bounds__(Q_BLOCK)
quantize_kernel(const TIn* __restrict__ x, int8_t* __restrict__ x_q, float* __restrict__ a_s, int M,
                int K) {
  constexpr int VEC = 16 / sizeof(TIn);  // elements per 16-byte load
  constexpr int STEP = TPR * VEC;        // elements a row's threads cover per load
  constexpr int ROWS = Q_BLOCK / TPR;
  __shared__ float part[ROWS][TPR / 32];
  const int r = threadIdx.x / TPR, tid = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + r;
  const bool live = row < M;  // no early return before the block barrier
  const TIn* xr = x + static_cast<size_t>(live ? row : 0) * K;
  uint4 held[Q_HOLD];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < Q_HOLD; ++i) {
    const int c = i * STEP + tid * VEC;
    held[i] = live && c < K ? *reinterpret_cast<const uint4*>(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < Q_HOLD; ++i) amax = abs_max<TIn>(held[i], amax);
  for (int c = Q_HOLD * STEP + tid * VEC; live && c < K; c += STEP)
    amax = abs_max<TIn>(*reinterpret_cast<const uint4*>(xr + c), amax);
#pragma unroll
  for (int off = 16; off; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (tid % 32 == 0) part[r][tid / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < TPR / 32; ++w) amax = fmaxf(amax, part[r][w]);
  if (!live) return;
  const float a = fmaxf(__fmul_rn(amax, INV_127), SCALE_FLOOR);
  if (tid == 0) a_s[row] = a;
  int8_t* qr = x_q + static_cast<size_t>(row) * K;
#pragma unroll
  for (int i = 0; i < Q_HOLD; ++i) {
    const int c = i * STEP + tid * VEC;
    if (c < K) quantize_store<TIn>(held[i], a, qr + c);
  }
  for (int c = Q_HOLD * STEP + tid * VEC; c < K; c += STEP)
    quantize_store<TIn>(*reinterpret_cast<const uint4*>(xr + c), a, qr + c);
}

// ---------------------------------------------------------------------------
// Stage B: TMA + wgmma int8 GEMM with the dequantizing epilogue
// ---------------------------------------------------------------------------

constexpr int BM = 128;  // rows per block: two consumer warpgroups of 64
constexpr int BN = 256;  // columns per block
constexpr int BK = 128;  // K step in int8 elements: one 128-byte swizzle row
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BM * BK;
constexpr int STAGE_BYTES = A_BYTES + BN * BK;
constexpr int STAGES = 4;                          // 192 KB of ring
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1 KB
constexpr int ACC = BN / 2;                        // int32 accumulators per consumer thread

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One (BK x rows) box of a 2-D int8 tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int k0,
                                         int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile loaded by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the
// stride byte offset); the leading byte offset is unused for this layout.
// Stepping K by 32 bytes inside the swizzle row adds 32 to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (m64 x 256, int32, wgmma's accumulator layout) += A (64 x 32 int8) * B^T (256 x 32 int8)
__device__ __forceinline__ void wgmma_s8(int (&d)[ACC], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <typename TOut>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
            const float* __restrict__ a_s, const float* __restrict__ w_s,
            const float* __restrict__ bias, TOut* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES];
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the 128-byte swizzle wants 1 KB

  const int warpgroup = threadIdx.x / 128;
  const int n0 = blockIdx.x * BN;  // neighbouring blocks share a row panel of x_q
  const int m0 = blockIdx.y * BM;
  const int num_k = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // producer: keep the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < num_k; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(smem_u32(&empty_bar[s]), ((kt / STAGES) - 1) & 1);
        const uint32_t full = smem_u32(&full_bar[s]);
        const uint32_t tile = ring + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load(tile, &map_x, full, kt * BK, m0);
        tma_load(tile + A_BYTES, &map_w, full, kt * BK, n0);
      }
    }
  } else {
    // consumers: 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = warpgroup - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    int acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0;

    for (int kt = 0; kt < num_k; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(smem_u32(&full_bar[s]), (kt / STAGES) & 1);
      const uint32_t a = ring + s * STAGE_BYTES + c * 64 * BK;
      const uint32_t b = ring + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group is done: hand its tiles back
      if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[(kt - 1) % STAGES]));
    }
    wgmma_wait<0>();

    // epilogue: (acc * a_s) * w_s + bias in f32, rounded once into TOut,
    // staged in the (now idle) ring as this warpgroup's 64 x BN tile, rows
    // padded by 8 elements so the fragment stores are free of bank
    // conflicts, then written out in coalesced 16-byte stores
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both consumers are done reading the ring
    constexpr int PITCH = (BN + 8) * sizeof(TOut);
    static_assert(2 * 64 * PITCH <= STAGES * STAGE_BYTES, "the output tile must fit in the ring");
    unsigned char* tile = smem_raw + (ring - smem_u32(smem_raw)) + c * 64 * PITCH;
    const int g = lane >> 2, tg = lane & 3;
    const int lr = warp * 16 + g;  // this thread's local rows lr and lr + 8
    const int r0 = m0 + c * 64 + lr;
    const float as0 = r0 < M ? a_s[r0] : 0.f;
    const float as1 = r0 + 8 < M ? a_s[r0 + 8] : 0.f;
    TOut* row0 = reinterpret_cast<TOut*>(tile + lr * PITCH);
    TOut* row1 = reinterpret_cast<TOut*>(tile + (lr + 8) * PITCH);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = j * 8 + tg * 2;
      if (n0 + cl >= N) continue;  // N % 8 == 0: col < N implies col + 1 < N
      const float2 s = *reinterpret_cast<const float2*>(w_s + n0 + cl);
      const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + cl);
      store2(row0 + cl, __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j]), as0), s.x), bb.x),
             __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 1]), as0), s.y), bb.y));
      store2(row1 + cl, __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2]), as1), s.x), bb.x),
             __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 3]), as1), s.y), bb.y));
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");  // this warpgroup's tile is staged
    constexpr int ELEMS = 16 / sizeof(TOut);  // per 16-byte store; N % 8 == 0 keeps a store inside N
    constexpr int CHUNKS = BN / ELEMS;        // per row
    for (int i = threadIdx.x % 128; i < 64 * CHUNKS; i += 128) {
      const int r = i / CHUNKS, ch = i % CHUNKS;
      const int row = m0 + c * 64 + r, col = n0 + ch * ELEMS;
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * N + col) =
            *reinterpret_cast<const uint4*>(tile + r * PITCH + ch * 16);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: fetched once through the
// runtime, so the library does not link against it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// A (rows, k) row-major int8 matrix as BK x box_rows boxes with the 128-byte
// swizzle; out-of-bounds elements read as zero.
cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TIn>
int quantize(const void* x, void* x_q, void* a_s, int m, int k, cudaStream_t stream) {
  const auto xp = static_cast<const TIn*>(x);
  const auto qp = static_cast<int8_t*>(x_q);
  const auto ap = static_cast<float*>(a_s);
  if (k <= 32 * Q_HOLD * static_cast<int>(16 / sizeof(TIn)))  // a warp holds the row
    quantize_kernel<TIn, 32><<<(m + Q_BLOCK / 32 - 1) / (Q_BLOCK / 32), Q_BLOCK, 0, stream>>>(xp, qp, ap, m, k);
  else
    quantize_kernel<TIn, 128><<<(m + Q_BLOCK / 128 - 1) / (Q_BLOCK / 128), Q_BLOCK, 0, stream>>>(xp, qp, ap, m, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename TOut>
int gemm(const void* x_q, const void* w_q, const void* a_s, const void* w_s, const void* bias, void* out,
         int m, int n, int k, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  cudaError_t err = make_map(&map_x, x_q, m, k, BM);
  if (err == cudaSuccess) err = make_map(&map_w, w_q, n, k, BN);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = gemm_kernel<TOut>;
  static std::atomic<unsigned> smem_set{0};  // devices this kernel may use its shared memory on
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(smem_set.load() >> dev & 1u))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess && dev < 32) smem_set.fetch_or(1u << dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM, stream>>>(map_x, map_w, static_cast<const float*>(a_s),
                                                    static_cast<const float*>(w_s),
                                                    static_cast<const float*>(bias), static_cast<TOut*>(out),
                                                    m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) bf16 (x_f32 == 0) or f32; w_q (n, k) int8; w_s (n,) f32; bias (n,)
// f32; out (m, n) bf16 (out_f32 == 0) or f32; scratch x_q (m, k) int8 and
// a_s (m,) f32.  All contiguous and 16-byte aligned; n % 8 == 0, k % 16 == 0,
// (m + 127) / 128 <= 65535.  Launches stage A then
// stage B on `stream`.  Returns the first cudaError_t that is not success.
extern "C" int ha_quant_matmul(const void* x, const void* w_q, const void* w_s, const void* bias, void* out,
                               void* x_q, void* a_s, int m, int n, int k, int x_f32, int out_f32,
                               void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 16 || (m + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = x_f32 ? quantize<float>(x, x_q, a_s, m, k, s) : quantize<__nv_bfloat16>(x, x_q, a_s, m, k, s);
  if (err != 0) return err;
  return out_f32 ? gemm<float>(x_q, w_q, a_s, w_s, bias, out, m, n, k, s)
                 : gemm<__nv_bfloat16>(x_q, w_q, a_s, w_s, bias, out, m, n, k, s);
}
