// Online-softmax attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the two Pallas TPU kernels of holoagent_tpu/ops/flash_attention.py:
//   * K1  flash_attention_2d (_flash2d_kernel): SAM image-encoder attention
//     over an h x w token grid with the decomposed relative-position bias
//       s[q, k] = q.k * d^-1/2 + bias_h[q, k / w] + bias_w[q, k % w]
//   * K2  flash_attention (_flash_kernel): plain blockwise attention over
//     (B, H, T, D), optionally causal, keys at or past t_valid masked.
// Two kernels: the streamed kernel (flash_kernel; REL_POS switches the bias
// term on) serves K1, and K2 when it is causal or T > T_MAX; the resident
// kernel (resident_kernel) serves K2's non-causal T <= T_MAX, which is every
// CLIP ViT-L/14 attention layer (T = 257).
//
// What bounds it on the H100.  At the mapping pipeline's shapes (D = 64):
//   K1 global layers  BH=12,  N=4096: 51.5 GFLOP of tensor-core work against
//                     ~50 MB of traffic -> compute-bound (~52 us at 989 TF/s);
//   K1 windows        BH=300, N=196:   ~3 GFLOP, ~37 MB  -> memory-bound;
//   K2 CLIP crops     BH=16*(2*tier+1), T=257: 8.9 GFLOP against 69 MB at
//                     tier 16 -> memory-bound (21 us at 3.35 TB/s).
// Both keep every score in registers: no (N, N) tensor is written to device
// memory.
//
// The streamed kernel.  One block (4 warps, 128 threads) owns one
// (batch*head, 64-query tile).  Each warp owns 16 query rows.  The block
// walks 64-key tiles: K is staged row-major and V transposed in shared
// memory (bf16, rows padded by 8 elements so the fragment loads are free of
// bank conflicts), then
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
// Its inputs are contiguous (BH, N, D) bf16; the wrapper makes them so.
//
// The resident kernel.  At T = 257 the streamed kernel loads each 64-key
// tile synchronously between two barriers, transposes V with scalar stores
// and computes 320 x 320 slots for 257 x 257 pairs; its wrapper also copies
// q, k, v out of the fused (B, T, 3W) projection and the output back.  Here
// one block (4 warps) owns one head (or a share of its query tiles, where the
// grid would otherwise not fill the card):
//   - it stages the head's whole K and V (T16 x 64 bf16 each, T16 = T rounded
//     up to 16; 33 KB each at T = 257) in shared memory once, with 16-byte
//     cp.async in two commit groups, K then V, so QK^T starts while V lands;
//     rows are 128 bytes with their 16-byte chunks XOR-swizzled by row % 8,
//     and rows past T are zero-filled (a stale NaN in a padded V row would
//     survive p = 0);
//   - q, k and v are read where they lie: any batch, head and token strides
//     (multiples of 16 bytes), last dim contiguous, as _attend's views of the
//     (B, T, 3W) tensor; the output is written as (B, T, H, D), so the
//     caller's transpose back to (B, T, W) is free;
//   - each warp walks m16 query tiles (17 a head at T = 257; a block takes
//     at most nine of them, so a head is split over two blocks), its Q
//     fragments loaded straight from device memory into registers (the next
//     tile's while this tile's output is stored), and runs the online
//     softmax over the resident keys in 64-key chunks with no barrier
//     between chunks and no branch inside one, the tail masked at 16-key
//     granularity; K's B fragments come from ldmatrix, V's from
//     ldmatrix.trans;
//   - the softmax keeps the running max of the raw scores and forms each
//     probability as 2^(s * scale * log2(e) - max * scale * log2(e)): one
//     FFMA and one ex2.approx a score (the streamed kernel scales, then
//     takes __expf).
// About 70 KB of shared memory at T = 257 lets three blocks share an SM.
//
// Left for later: TMA loads, wgmma and warp specialisation for K1 and the
// streamed kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

constexpr int T_MAX = 320;  // longest T the resident kernel takes (80 KB of K and V); ops/flash_attention.py routes on its copy
constexpr int RES_WARPS = 4;
constexpr int RES_THREADS = RES_WARPS * 32;
constexpr int RES_MIN_BLOCKS = 3;  // blocks an SM must hold: at most 168 registers a thread
constexpr int CHUNK = 4;           // 16-key groups per step of the online softmax
constexpr int ROW_BYTES = 128;  // one 64-wide bf16 row of K or V

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `c` (0..7) of row `r` in a swizzled K or V panel
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * ROW_BYTES + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Copy rows [0, t) of a (t, 64) panel with token stride `st` into a swizzled
// shared panel of t16 rows; rows t..t16-1 become zeros.
__device__ __forceinline__ void stage_panel(uint32_t dst, unsigned char* dst_ptr,
                                            const __nv_bfloat16* __restrict__ src, long long st, int t,
                                            int t16) {
  for (int i = threadIdx.x; i < t16 * 8; i += RES_THREADS) {
    const int r = i >> 3, c = i & 7;
    if (r < t)
      cp_async16(dst + swz(r, c), src + r * st + c * 8);
    else
      *reinterpret_cast<uint4*>(dst_ptr + swz(r, c)) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

// This thread's V copies have landed; then a CTA barrier (the unaligned
// form: warps reach it from different places) makes all of them visible.
__device__ __forceinline__ void wait_for_v() {
  cp_async_wait<0>();
  asm volatile("barrier.sync 1;\n" ::: "memory");
}

struct Strides {
  long long b, h, t;  // batch, head and token strides in elements; the last dim is contiguous
};

// 2^x by the SFU (ex2.approx, flush to zero: about 2 ulps, and
// 2^(-huge) = 0 for masked scores)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One warp's 16 query rows: Q as mma A fragments, the output accumulator
// and the running max (of raw scores) and partial sum of each of its two
// rows.
struct Rows {
  uint32_t qa[4][4];
  float acc[8][4];
  float m[2], l[2];
};

// One chunk of G 16-key groups from key0 against the resident K and V:
// S = Q K^T (mma.sync m16n8k16, K's B fragments by ldmatrix), the online
// softmax in log2 units, acc += P V (V's B fragments by ldmatrix.trans).
// MASK: the chunk holds the key tail, and keys at or past t are masked.
// No branch inside, so the compiler interleaves the groups' MMAs.
template <int G, bool MASK>
__device__ __forceinline__ void attend_chunk(Rows& st, uint32_t ks, uint32_t vs, int key0, int t,
                                             float scale_log2, bool& v_ready) {
  constexpr int D = 64;
  const int lane = threadIdx.x & 31;
  const int tg = lane & 3;
  // ldmatrix row and chunk of this lane: K (x4 over 4 chunks of one 8-key group),
  // V (x4.trans over keys 0-7 / 8-15 of two chunks)
  const int k_row = lane & 7, k_chunk = lane >> 3;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_chunk = lane >> 4;

  float s[2 * G][4];
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const int key = key0 + j * 8 + k_row;
    uint32_t kb[2][4];  // chunks 0-3 and 4-7 of 8 keys: b0, b1 of head-dim steps 0-1 and 2-3
    ldmatrix_x4(kb[0], ks + swz(key, k_chunk));
    ldmatrix_x4(kb[1], ks + swz(key, 4 + k_chunk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_16816(s[j], st.qa[kk], kb[kk / 2][(kk % 2) * 2], kb[kk / 2][(kk % 2) * 2 + 1]);
  }

  // running max of the raw scores (the scale is positive), then
  // p = 2^(s * scale_log2 - max * scale_log2): one FFMA and one ex2 a score
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && key0 + j * 8 + tg * 2 + (e & 1) >= t) s[j][e] = NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float alpha[2], shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((st.m[r] - mx[r]) * scale_log2);
    st.m[r] = mx[r];
    st.l[r] *= alpha[r];
    shift[r] = -mx[r] * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    st.acc[j][0] *= alpha[0];
    st.acc[j][1] *= alpha[0];
    st.acc[j][2] *= alpha[1];
    st.acc[j][3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[j][e], scale_log2, shift[e >> 1]));
      s[j][e] = p;
      st.l[e >> 1] += p;
    }
  }

  if (!v_ready) {  // once per warp: every warp of the block reaches this barrier exactly once
    wait_for_v();
    v_ready = true;
  }
#pragma unroll
  for (int kg = 0; kg < G; ++kg) {
    uint32_t pa[4];  // two adjacent S fragments form one A fragment (16 keys)
    pa[0] = pack_bf16x2(s[2 * kg][0], s[2 * kg][1]);
    pa[1] = pack_bf16x2(s[2 * kg][2], s[2 * kg][3]);
    pa[2] = pack_bf16x2(s[2 * kg + 1][0], s[2 * kg + 1][1]);
    pa[3] = pack_bf16x2(s[2 * kg + 1][2], s[2 * kg + 1][3]);
    const int key = key0 + kg * 16 + v_row;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + swz(key, 2 * dp + v_chunk));
      mma_16816(st.acc[2 * dp], pa, vb[0], vb[1]);
      mma_16816(st.acc[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
}

// q, k, v (B, H, T, 64) bf16 at the given strides; o (B, T, H, 64) bf16,
// contiguous.  Block (x, y): head y = b * H + h, query tiles
// [x * tiles_per_block, (x + 1) * tiles_per_block) of 16 rows, one warp each
// in turn.
__global__ void __launch_bounds__(RES_THREADS, RES_MIN_BLOCKS)
resident_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Strides sq, Strides sk,
                Strides sv, int heads, int t, int tiles_per_block, float scale_log2) {
  constexpr int D = 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int t16 = (t + 15) & ~15;
  unsigned char* ks_ptr = smem_raw;
  unsigned char* vs_ptr = smem_raw + t16 * ROW_BYTES;
  const uint32_t ks = smem_u32(ks_ptr), vs = smem_u32(vs_ptr);

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  stage_panel(ks, ks_ptr, k, sk.t, t, t16);  // commit group 0: K
  stage_panel(vs, vs_ptr, v, sv.t, t, t16);  // commit group 1: V

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the mma fragment
  const int tg = lane & 3;  // column pair within the mma fragment
  const int n16 = t16 / 16;
  const int tile_end = min(n16, (blockIdx.x + 1) * tiles_per_block);
  const int full_chunks = t / (16 * CHUNK);  // chunks with no key at or past t
  const int tail = n16 - CHUNK * full_chunks;  // 16-key groups left, 0 to CHUNK, masked

  cp_async_wait<1>();
  __syncthreads();  // K is resident
  bool v_ready = false;

  // Q as mma A fragments for the 16 rows of `tile`, straight from device memory
  auto load_q = [&](uint32_t (&qa)[D / 16][4], int tile) {
    const int r0 = tile * 16 + g;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* p0 = q + r0 * sq.t + kk * 16 + tg * 2;
      const __nv_bfloat16* p1 = p0 + 8 * sq.t;
      qa[kk][0] = r0 < t ? ld32(p0) : 0u;
      qa[kk][1] = r0 + 8 < t ? ld32(p1) : 0u;
      qa[kk][2] = r0 < t ? ld32(p0 + 8) : 0u;
      qa[kk][3] = r0 + 8 < t ? ld32(p1 + 8) : 0u;
    }
  };
  Rows st;
  int tile = blockIdx.x * tiles_per_block + warp;
  if (tile < tile_end) load_q(st.qa, tile);
  for (; tile < tile_end; tile += RES_WARPS) {
    const int r0 = tile * 16 + g;  // this thread's rows r0 and r0 + 8
#pragma unroll
    for (int j = 0; j < D / 8; ++j) st.acc[j][0] = st.acc[j][1] = st.acc[j][2] = st.acc[j][3] = 0.f;
    st.m[0] = st.m[1] = NEG_INF;
    st.l[0] = st.l[1] = 0.f;  // per-thread partial sums, reduced at the end

    for (int c = 0; c < full_chunks; ++c)
      attend_chunk<CHUNK, false>(st, ks, vs, c * 16 * CHUNK, t, scale_log2, v_ready);
    const int key0 = full_chunks * 16 * CHUNK;
    switch (tail) {  // cases above CHUNK never occur
      case 4: attend_chunk<4, true>(st, ks, vs, key0, t, scale_log2, v_ready); break;
      case 3: attend_chunk<3, true>(st, ks, vs, key0, t, scale_log2, v_ready); break;
      case 2: attend_chunk<2, true>(st, ks, vs, key0, t, scale_log2, v_ready); break;
      case 1: attend_chunk<1, true>(st, ks, vs, key0, t, scale_log2, v_ready); break;
      default: break;
    }

    // the next tile's Q is in flight while this tile's output is stored
    if (tile + RES_WARPS < tile_end) load_q(st.qa, tile + RES_WARPS);
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = st.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / fmaxf(l, 1e-30f);
    }
    __nv_bfloat16* o0 = o + ((static_cast<size_t>(b) * t + r0) * heads + h) * D;
    __nv_bfloat16* o1 = o0 + static_cast<size_t>(8) * heads * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tg * 2;
      if (r0 < t)
        *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16x2(st.acc[j][0] * inv[0], st.acc[j][1] * inv[0]);
      if (r0 + 8 < t)
        *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16x2(st.acc[j][2] * inv[1], st.acc[j][3] * inv[1]);
    }
  }
  if (!v_ready) wait_for_v();  // a warp with no query tile still takes its part in the barrier
}

// The resident kernel's launch for (bh heads, t tokens): query tiles per
// block, blocks per head and blocks per SM (the occupancy calculator's).
struct Plan {
  int tiles_per_block, splits, blocks_per_sm, sms;
  size_t smem;
};

cudaError_t resident_plan(int bh, int t, Plan* plan) {
  const int t16 = (t + 15) & ~15;
  plan->smem = static_cast<size_t>(2) * t16 * ROW_BYTES;
  // per device: the shared-memory allowance (set once, for T_MAX) and the
  // blocks per SM at each t16, so a launch makes no CUDA queries after the
  // first at its length
  static std::atomic<int> blocks_per_sm[32][T_MAX / 16 + 1];
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int cached = dev < 32 ? blocks_per_sm[dev][t16 / 16].load() : 0;
  if (cached == 0) {
    err = cudaFuncSetAttribute(resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * T_MAX * ROW_BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached, resident_kernel, RES_THREADS, plan->smem);
    if (err != cudaSuccess) return err;
    if (dev < 32) blocks_per_sm[dev][t16 / 16].store(cached);
  }
  plan->blocks_per_sm = cached;
  plan->sms = sms;
  const int n16 = (t + 15) / 16;
  const int slots = plan->blocks_per_sm * sms;
  int splits = (n16 + 2 * RES_WARPS) / (2 * RES_WARPS + 1);
  while (bh * splits < slots && (n16 + splits) / (splits + 1) >= RES_WARPS) ++splits;
  plan->tiles_per_block = (n16 + splits - 1) / splits;
  plan->splits = (n16 + plan->tiles_per_block - 1) / plan->tiles_per_block;
  return cudaSuccess;
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

// K2, non-causal, t <= T_MAX: q, k, v (b, h, t, 64) bf16 at strides s*_b,
// s*_h, s*_t (elements; multiples of 8, starts 16-byte aligned); o (b, t, h,
// 64) bf16, contiguous.  Returns the cudaError_t of the launch.
extern "C" int ha_flash_attention_resident(const void* q, const void* k, const void* v, void* o,
                                           long long sq_b, long long sq_h, long long sq_t, long long sk_b,
                                           long long sk_h, long long sk_t, long long sv_b, long long sv_h,
                                           long long sv_t, int b, int h, int t, int d, float scale,
                                           void* stream) {
  if (d != 64 || t <= 0 || t > T_MAX || b <= 0 || h <= 0 || b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  cudaError_t err = resident_plan(b * h, t, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(plan.splits, b * h);
  resident_kernel<<<grid, RES_THREADS, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Strides{sq_b, sq_h, sq_t},
      Strides{sk_b, sk_h, sk_t}, Strides{sv_b, sv_h, sv_t}, h, t, plan.tiles_per_block,
      scale * 1.44269504088896341f);  // scores in log2 units: exp(x) = exp2(x * log2(e))
  return static_cast<int>(cudaGetLastError());
}

// The resident kernel's plan for (bh heads, t tokens), into out[0..3]:
// query tiles per block, blocks per head, blocks per SM, SMs.  Returns a
// cudaError_t.
extern "C" int ha_flash_attention_plan(int bh, int t, int* out) {
  if (t <= 0 || t > T_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  const cudaError_t err = resident_plan(bh, t, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = plan.tiles_per_block;
  out[1] = plan.splits;
  out[2] = plan.blocks_per_sm;
  out[3] = plan.sms;
  return 0;
}
