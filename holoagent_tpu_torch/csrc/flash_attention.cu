// Online-softmax attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the two Pallas TPU kernels of holoagent_tpu/ops/flash_attention.py:
//   * K1  flash_attention_2d (_flash2d_kernel): SAM image-encoder attention
//     over an h x w token grid with the decomposed relative-position bias
//       s[q, k] = q.k * d^-1/2 + bias_h[q, k / w] + bias_w[q, k % w]
//   * K2  flash_attention (_flash_kernel): plain blockwise attention over
//     (B, H, T, D), optionally causal, keys at or past t_valid masked.
// One templated kernel serves both; REL_POS switches the bias term on.
//
// What bounds it on the H100.  At the mapping pipeline's shapes (D = 64):
//   K1 global layers  BH=12,  N=4096: 51.5 GFLOP of tensor-core work against
//                     ~50 MB of traffic -> compute-bound (~52 us at 989 TF/s);
//   K1 windows        BH=300, N=196:   ~3 GFLOP, ~37 MB  -> memory-bound;
//   K2 CLIP crops     BH=16*(2*tier+1), T=257 -> memory-bound.
// The design keeps every score in registers: no (N, N) tensor is written to
// device memory, so the traffic is q, k, v, o and the two bias panels, each
// read or written once per query tile.
//
// Design.  One block (4 warps, 128 threads) owns one (batch*head, 64-query
// tile).  Each warp owns 16 query rows.  The block walks 64-key tiles: K is
// staged row-major and V transposed in shared memory (bf16, rows padded by 8
// elements so the fragment loads are free of bank conflicts), then
//   S = Q K^T        mma.sync m16n8k16, bf16 in, f32 accumulate (registers),
//   s = S*scale (+ bias gathered from the tile's rows of bias_h / bias_w,
//       staged once per block in shared memory; no selector matmuls),
//   masking of the ragged key edge (k >= t_valid) and, if causal, k > q,
//   running max / sum / accumulator in f32 (FlashAttention-2 order: the sum
//   is reduced across the quad only once, at the end),
//   P (cast to bf16, reusing the S accumulator layout as the A operand) . V
//       with mma.sync, f32 accumulate.
// Causal blocks stop at the diagonal key tile.  The ragged key edge is masked
// here, so callers pass N = 196 windows and T = 257 CLIP tokens unpadded.
// Inputs are contiguous (BH, N, D) bf16; the wrapper makes them so.
//
// Left for later: TMA loads, wgmma and warp specialisation, cp.async double
// buffering of the K/V tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 8;  // bf16 elements per 16-byte load
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
struct Smem {
  static constexpr int LD = D + 8;         // padded row of the Q and K tiles
  static constexpr int LDV = BLOCK_K + 8;  // padded row of the transposed V tile
  static constexpr int TILE_BYTES = (BLOCK_Q * LD + BLOCK_K * LD + D * LDV) * 2;
};

template <int D, bool REL_POS>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias_h,
             const float* __restrict__ bias_w, __nv_bfloat16* __restrict__ o, int n,
             int grid_h, int grid_w, int causal, int n_valid, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = Smem<D>::LD;
  constexpr int LDV = Smem<D>::LDV;
  constexpr int ROW_VECS = D / VEC;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BLOCK_Q x LD
  __nv_bfloat16* ks = qs + BLOCK_Q * LD;                           // BLOCK_K x LD
  __nv_bfloat16* vt = ks + BLOCK_K * LD;                           // D x LDV
  float* bh_s = reinterpret_cast<float*>(smem_raw + Smem<D>::TILE_BYTES);  // BLOCK_Q x grid_h
  float* bw_s = bh_s + BLOCK_Q * grid_h;                                   // BLOCK_Q x grid_w

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the mma fragment
  const int tg = lane & 3;  // column pair within the mma fragment
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK_Q;
  const size_t head_off = static_cast<size_t>(head) * n * D;
  q += head_off;
  k += head_off;
  v += head_off;
  o += head_off;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BLOCK_Q * ROW_VECS; i += THREADS) {
    const int r = i / ROW_VECS, c = (i % ROW_VECS) * VEC;
    uint4 val = zero;
    if (q0 + r < n) val = *reinterpret_cast<const uint4*>(q + static_cast<size_t>(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(qs + r * LD + c) = val;
  }
  if (REL_POS) {
    const size_t row_base = static_cast<size_t>(head) * n + q0;
    for (int i = tid; i < BLOCK_Q * grid_h; i += THREADS) {
      const int r = i / grid_h;
      bh_s[i] = (q0 + r < n) ? bias_h[row_base * grid_h + i] : 0.f;
    }
    for (int i = tid; i < BLOCK_Q * grid_w; i += THREADS) {
      const int r = i / grid_w;
      bw_s[i] = (q0 + r < n) ? bias_w[row_base * grid_w + i] : 0.f;
    }
  }
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, kept in registers
  const int row0 = warp * 16 + g;  // local rows row0 and row0 + 8
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = qs + kk * 16 + tg * 2;
    qa[kk][0] = ld32(base + row0 * LD);
    qa[kk][1] = ld32(base + (row0 + 8) * LD);
    qa[kk][2] = ld32(base + row0 * LD + 8);
    qa[kk][3] = ld32(base + (row0 + 8) * LD + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end
  const int q_glob[2] = {q0 + row0, q0 + row0 + 8};

  int num_kt = (n + BLOCK_K - 1) / BLOCK_K;
  if (causal) num_kt = min(num_kt, (q0 + BLOCK_Q + BLOCK_K - 1) / BLOCK_K);

  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BLOCK_K * ROW_VECS; i += THREADS) {
      const int r = i / ROW_VECS, c = (i % ROW_VECS) * VEC;
      uint4 kv = zero, vv = zero;
      if (k0 + r < n) {
        const size_t off = static_cast<size_t>(k0 + r) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) vt[(c + e) * LDV + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BLOCK_K / 8][4];
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kb = ks + (j * 8 + g) * LD + tg * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_16816(s[j], qa[kk], ld32(kb + kk * 16), ld32(kb + kk * 16 + 8));
    }

    // scale, bias, masks, running max
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + j * 8 + tg * 2 + (e & 1);
        bool ok = key < n_valid;
        if (causal) ok = ok && key <= q_glob[r];
        float x = s[j][e] * scale;
        if (REL_POS && ok) {
          const int lr = row0 + 8 * r;
          x += bh_s[lr * grid_h + key / grid_w] + bw_s[lr * grid_w + key % grid_w];
        }
        x = ok ? x : NEG_INF;
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
    }

    // acc += P V: two adjacent S fragments form one A fragment (k-step of 16 keys)
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vb = vt + (j * 8 + g) * LDV + kk * 16 + tg * 2;
        mma_16816(acc[j], pa, ld32(vb), ld32(vb + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + tg * 2;
    if (q_glob[0] < n)
      *reinterpret_cast<uint32_t*>(o + static_cast<size_t>(q_glob[0]) * D + col) =
          pack_bf16x2(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    if (q_glob[1] < n)
      *reinterpret_cast<uint32_t*>(o + static_cast<size_t>(q_glob[1]) * D + col) =
          pack_bf16x2(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
}

template <int D, bool REL_POS>
int launch(const void* q, const void* k, const void* v, const void* bias_h, const void* bias_w,
           void* o, int bh, int n, int grid_h, int grid_w, int causal, int n_valid, float scale,
           cudaStream_t stream) {
  size_t smem = Smem<D>::TILE_BYTES;
  if (REL_POS) smem += static_cast<size_t>(BLOCK_Q) * (grid_h + grid_w) * sizeof(float);
  auto kernel = flash_kernel<D, REL_POS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BLOCK_Q - 1) / BLOCK_Q, bh);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias_h),
      static_cast<const float*>(bias_w), static_cast<__nv_bfloat16*>(o), n, grid_h, grid_w,
      causal, n_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

// Head dim 64 only: the dim of every attention layer on the ported path.
template <bool REL_POS>
int dispatch(const void* q, const void* k, const void* v, const void* bias_h, const void* bias_w,
             void* o, int bh, int n, int d, int grid_h, int grid_w, int causal, int n_valid,
             float scale, cudaStream_t stream) {
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch<64, REL_POS>(q, k, v, bias_h, bias_w, o, bh, n, grid_h, grid_w, causal, n_valid,
                             scale, stream);
}

}  // namespace

// K1: q, k, v, o (bh, n, d) bf16; bias_h (bh, n, grid_h) f32; bias_w (bh, n, grid_w) f32;
// n == grid_h * grid_w.  Returns the cudaError_t of the launch.
extern "C" int ha_flash_attention_2d(const void* q, const void* k, const void* v,
                                     const void* bias_h, const void* bias_w, void* o, int bh,
                                     int n, int d, int grid_h, int grid_w, float scale,
                                     void* stream) {
  return dispatch<true>(q, k, v, bias_h, bias_w, o, bh, n, d, grid_h, grid_w, 0, n, scale,
                        static_cast<cudaStream_t>(stream));
}

// K2: q, k, v, o (bh, t, d) bf16 (a contiguous (B, H, T, D) tensor); keys at or
// past t_valid are masked; causal != 0 masks k > q.  Returns the cudaError_t.
extern "C" int ha_flash_attention(const void* q, const void* k, const void* v, void* o, int bh,
                                  int t, int d, int causal, int t_valid, float scale,
                                  void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, o, bh, t, d, 1, 1, causal, t_valid, scale,
                         static_cast<cudaStream_t>(stream));
}
