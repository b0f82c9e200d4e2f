// SAM 2's mask head for Hopper (sm_90a), hand-written CUDA C++: the
// decoder's two upscaling steps, their LayerNorm and GELUs and the
// hypernetwork product in one pass over the image tokens.
//
// No kernel of the JAX package stands behind this one: SAM 2 exists only in
// the port (models/sam2.py).  It was written because the head is bound by
// bytes.  Its plain version (ops/mask_head.py::mask_head_ref, the chain
// models/sam2.py ran before) makes about 20 launches a pass, each writing
// its whole tensor to device memory, float32 casts among them: some 74 times
// the bf16 image tokens at P = 64 prompts, 9.9 GB a pass.  The least traffic
// is the tokens read once (134 MB at P = 64), the high-resolution features
// (6.3 MB, shared by the prompts) and the float32 logits written once (67
// MB): 0.062 ms at 3.35 TB/s, against 0.053 ms for its 52.6 GFLOP at the
// bf16 tensor-core peak.
//
// For each prompt p, with src (P, g, g, 256), feat_s1 (2g, 2g, 64), feat_s0
// (4g, 4g, 32), the transposed convolutions' HWIO kernels w1 (2, 2, 256,
// 64) and w2 (2, 2, 64, 32) with biases b1 and b2, the LayerNorm's gain and
// bias over 64 channels and hyper (P, 4, 32), it writes logits (P, 4, 4g,
// 4g) float32:
//   u1[2i+a, 2j+b] = GELU(LN(src[i, j] @ w1[1-a, 1-b] + b1 + feat_s1[2i+a, 2j+b]))
//   u2[2y+e, 2x+f] = GELU(u1[y, x] @ w2[1-e, 1-f] + b2 + feat_s0[2y+e, 2x+f])
//   logits[p, n, Y, X] = sum_c hyper[p, n, c] u2[Y, X, c]
// GELU is nn.GELU's (erf), LayerNorm population-variance with eps.  Every
// sum, the LayerNorm and the GELUs are float32; the bf16 kernel rounds to
// bf16 only where the plain version does or later: u1 and u2 after their
// GELU (the operands of the next product), nowhere else.
//
// The bf16 kernel.  A warp's item is 16 consecutive tokens of one token row
// of one prompt (one m16 row tile); it runs the whole head for them in
// registers, with mma.sync m16n8k16 (bf16 in, float32 sums):
//   1. the item's 16 x 256 tokens straight from device memory into A
//      fragments, 16 bytes a thread a row (the K order within each 32-wide
//      slice is permuted; w1's rows are read in the same order), held for
//      the four sub-pixels and loaded for the next item while the last
//      sub-pixel's epilogue runs;
//   2. per sub-pixel (a, b): the 16 x 64 product against w1[1-a, 1-b], then
//      the bias, the feat_s1 pixels, LayerNorm over the 64 channels (each
//      row's channels lie in one lane quad: two shuffles a sum) and the
//      GELU, rounded to bf16 straight into the A fragments of the next
//      product (an m16n8 sum tile's layout is an m16k16 operand's);
//   3. per sub-sub-pixel (e, f): the 16 x 32 product against w2[1-e, 1-f],
//      the bias, the feat_s0 pixels, the GELU, rounded to bf16 into A
//      fragments again, then the 16 x 4 product with the prompt's
//      hypernetwork vectors (one more m16n8k16 pair, the masks padded to
//      8): the same float32 sum of bf16 products as the plain version's;
//   4. the item's 4 x 4 x 64 logits staged in the warp's shared memory and
//      written as 256-byte rows.
// Both kernels w1 and w2 (144 KB, swizzled against bank conflicts) stay in
// shared memory; one block a multiprocessor, WARPS warps, each taking items
// in turn.  Nothing between the tokens and the logits touches device memory.
//
// The float32 kernel (float32 models: no cell serves one) takes every sum
// in float32 FFMA, a block an item, the intermediates in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int D = 256;   // the image tokens' channels (the decoder's width)
constexpr int C1 = 64;   // after the first upscaling, D / 4
constexpr int C2 = 32;   // after the second, D / 8
constexpr int NM = 4;    // mask tokens
constexpr int TOK = 16;  // tokens an item
constexpr int WARPS = 12;
constexpr int THREADS = 32 * WARPS;

constexpr int W1_BYTES = 4 * D * C1 * 2;
constexpr int W2_BYTES = 4 * C1 * C2 * 2;
constexpr int PARAMS = 3 * C1 + C2;           // b1, the LayerNorm's gain and bias, b2 (float32)
constexpr int STAGE = NM * 4 * 4 * TOK;       // an item's logits: 4 masks x 4 rows x 64 columns
constexpr int SMEM_BF16 = W1_BYTES + W2_BYTES + 4 * PARAMS + 4 * WARPS * STAGE;

// The float32 kernel's shared memory (floats): the item's tokens, u1 (rows
// padded to 65 against bank conflicts), w2 (each kernel's block padded by 8),
// hyper, the parameters.
constexpr int F_THREADS = 256;
constexpr int U1_ROW = C1 + 1;
constexpr int W2_BLOCK = C1 * C2 + 8;
constexpr int F_SRC = 0, F_U1 = F_SRC + TOK * D, F_W2 = F_U1 + TOK * 4 * U1_ROW, F_HYPER = F_W2 + 4 * W2_BLOCK,
              F_PARAMS = F_HYPER + NM * C2, F_FLOATS = F_PARAMS + PARAMS;
constexpr int SMEM_F32 = 4 * F_FLOATS;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// nn.GELU(): x Phi(x) = x / 2 (1 + erf(x / sqrt 2)), as h + h erf with h = x / 2
__device__ __forceinline__ float gelu_erf(float x) {
  const float h = 0.5f * x;
  return fmaf(h, erff(x * 0.70710678118654752f), h);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&b)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// d += a (16 x 16, row) b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_word(const unsigned int* p) { return __ldg(p); }

// a word of two bf16 (the lower channel in the low half) as two floats
__device__ __forceinline__ float2 bf16_pair(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// u2 pixel (e / 2, e % 2) of the 2 x 2 above a sub-pixel's u1 pixels: feat_s0's channel pairs 8 nt + 2 q
// of rows r (f[nt][0]) and r + 8 (f[nt][1]), 32 pixels apart; `base` at u2 pixel (0, 0) of row r
__device__ __forceinline__ void load_s0(uint32_t (&f)[4][2], const unsigned int* base, int e, size_t width) {
  const unsigned int* p = base + ((e >> 1) * width + (e & 1)) * (C2 / 2);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    f[nt][0] = ld_word(p + 4 * nt);
    f[nt][1] = ld_word(p + 32 * C2 / 2 + 4 * nt);
  }
}

// Shared-memory swizzles (16-byte chunk index XOR a function of the row):
// w1's rows are 128 bytes and a B fragment's ldmatrix reads rows k = base +
// {0, 1, 8, 9, 16, 17, 24, 25} of one chunk column; w2's rows are 64 bytes
// and ldmatrix reads rows base + 0..7.  Each gives the eight rows eight
// distinct bank groups.
__host__ __device__ constexpr int w1_swizzle(int k) { return (k & 1) | ((k >> 2) & 6); }
__host__ __device__ constexpr int w2_swizzle(int k) { return (k >> 1) & 3; }

// The item's tokens as A fragments.  Lane (r, q) = (lane / 4, lane % 4)
// reads 16 bytes of rows r and r + 8 at channels 32 t + 8 q ... + 7; K step
// (t, h) takes channels 32 t + 8 q + 4 h + {0, 1} as its K = 2 q, 2 q + 1
// and + {2, 3} as 2 q + 8, 2 q + 9 (w1's rows are read in the same order).
__device__ __forceinline__ void load_tokens(uint32_t (&a)[8][2][4], const __nv_bfloat16* __restrict__ src, int item,
                                            int ipp, int g, int r, int q) {
  const int p = item / ipp, t0 = (item - p * ipp) * TOK;
  const uint4* ra = reinterpret_cast<const uint4*>(src + ((size_t)p * g * g + t0 + r) * D + 8 * q);
  const uint4* rb = ra + D;  // 8 rows of D bf16 further
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const uint4 x = __ldg(ra + 4 * t), y = __ldg(rb + 4 * t);
    a[t][0][0] = x.x;
    a[t][0][1] = y.x;
    a[t][0][2] = x.y;
    a[t][0][3] = y.y;
    a[t][1][0] = x.z;
    a[t][1][1] = y.z;
    a[t][1][2] = x.w;
    a[t][1][3] = y.w;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    mask_head_bf16_kernel(const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ s0,
                          const __nv_bfloat16* __restrict__ s1, const __nv_bfloat16* __restrict__ w1,
                          const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ ln_g,
                          const __nv_bfloat16* __restrict__ ln_b, const __nv_bfloat16* __restrict__ w2,
                          const __nv_bfloat16* __restrict__ b2, const __nv_bfloat16* __restrict__ hyper,
                          float* __restrict__ out, float eps, int p_count, int g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* prm = reinterpret_cast<float*>(smem + W1_BYTES + W2_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, r = lane >> 2, q = lane & 3;
  float* stage = prm + PARAMS + warp * STAGE;
  const uint32_t w1s = smem_addr(smem), w2s = w1s + W1_BYTES;

  // w1 and w2 into shared memory, sub-pixel (a, b)'s kernel w[1-a, 1-b] as block 2a + b
  for (int c = tid; c < W1_BYTES / 16; c += THREADS) {
    const int row = c >> 3, k = row & (D - 1), s = 3 - (row >> 8);
    cp_async16(w1s + ((s * D + k) * 8 + ((c & 7) ^ w1_swizzle(k))) * 16, reinterpret_cast<const uint4*>(w1) + c);
  }
  for (int c = tid; c < W2_BYTES / 16; c += THREADS) {
    const int row = c >> 2, k = row & (C1 - 1), s = 3 - (row >> 6);
    cp_async16(w2s + ((s * C1 + k) * 4 + ((c & 3) ^ w2_swizzle(k))) * 16, reinterpret_cast<const uint4*>(w2) + c);
  }
  for (int c = tid; c < PARAMS; c += THREADS)
    prm[c] = to_float(c < C1 ? b1[c] : c < 2 * C1 ? ln_g[c - C1] : c < 3 * C1 ? ln_b[c - 2 * C1] : b2[c - 3 * C1]);

  const int ipp = g * g / TOK, n_items = p_count * ipp, stride = gridDim.x * WARPS;
  int item = blockIdx.x * WARPS + warp;
  uint32_t a[8][2][4];
  if (item < n_items) load_tokens(a, src, item, ipp, g, r, q);
  cp_async_wait_all();
  __syncthreads();

  // each lane's ldmatrix row and chunk: w1's rows in the tokens' K order
  const int l8 = lane & 7, mi = lane >> 3;
  const uint32_t w1_lane = w1s + (8 * (l8 >> 1) + (l8 & 1) + 2 * (mi & 1)) * 128;
  const uint32_t w2_lane = w2s + (l8 + 8 * (mi & 1)) * 64;
  const int half = mi >> 1, w2_swz = (l8 >> 1) & 3;
  const size_t width = 4 * (size_t)g;  // the logits' rows and columns

  for (; item < n_items; item += stride) {
    const int p = item / ipp, t0 = (item - p * ipp) * TOK, i = t0 / g, j0 = t0 - i * g;
    // the prompt's hypernetwork vectors as B fragments: B[c][n] = hyper[p, n, c], masks 4-7 zero
    uint32_t hb[2][2];
    {
      const __nv_bfloat16* hp = hyper + ((size_t)p * NM + (r & 3)) * C2 + 2 * q;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        hb[kk][0] = r < NM ? ld_word(reinterpret_cast<const unsigned int*>(hp + 16 * kk)) : 0u;
        hb[kk][1] = r < NM ? ld_word(reinterpret_cast<const unsigned int*>(hp + 16 * kk + 8)) : 0u;
      }
    }
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      const int di = s >> 1, dj = s & 1;
      const int y1 = 2 * i + di, xa = 2 * (j0 + r) + dj;  // rows r and r + 8: u1 columns xa and xa + 16
      // the sub-pixel's feat_s1 pairs and its first two feat_s0 pixels, loaded under the products:
      // rows r and r + 8 lie 16 u1 pixels (32 u2 pixels) apart, a channel pair is one word
      const unsigned int* s1w = reinterpret_cast<const unsigned int*>(s1 + ((size_t)y1 * (2 * g) + xa) * C1 + 2 * q);
      const unsigned int* s0w =
          reinterpret_cast<const unsigned int*>(s0 + ((size_t)(2 * y1) * width + 2 * xa) * C2 + 2 * q);
      uint32_t f1[8][2], f0[4][4][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        f1[nt][0] = ld_word(s1w + 4 * nt);
        f1[nt][1] = ld_word(s1w + 16 * C1 / 2 + 4 * nt);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) load_s0(f0[e], s0w, e, width);

      float acc[8][4];  // the sums start at the bias b1
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 bias = *reinterpret_cast<const float2*>(prm + 8 * nt + 2 * q);
        acc[nt][0] = acc[nt][2] = bias.x;
        acc[nt][1] = acc[nt][3] = bias.y;
      }
      const uint32_t wb = w1_lane + s * D * 128;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            ldsm_x4_t(wb + (32 * t + 4 * h) * 128 + (((2 * np + half) ^ l8) << 4), b);
            mma(acc[2 * np], a[t][h], b[0], b[1]);
            mma(acc[2 * np + 1], a[t][h], b[2], b[3]);
          }
      if (s == 3 && item + stride < n_items) load_tokens(a, src, item + stride, ipp, g, r, q);

      // + feat_s1, LayerNorm over the 64 channels, GELU -> bf16 A fragments
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 fa = bf16_pair(f1[nt][0]), fb = bf16_pair(f1[nt][1]);
        acc[nt][0] += fa.x;
        acc[nt][1] += fa.y;
        acc[nt][2] += fb.x;
        acc[nt][3] += fb.y;
        sum_a += acc[nt][0] + acc[nt][1];
        sum_b += acc[nt][2] + acc[nt][3];
      }
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
      const float mean_a = sum_a * (1.0f / C1), mean_b = sum_b * (1.0f / C1);
      float var_a = 0.0f, var_b = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] -= mean_a;
        acc[nt][1] -= mean_a;
        acc[nt][2] -= mean_b;
        acc[nt][3] -= mean_b;
        var_a += acc[nt][0] * acc[nt][0] + acc[nt][1] * acc[nt][1];
        var_b += acc[nt][2] * acc[nt][2] + acc[nt][3] * acc[nt][3];
      }
      var_a += __shfl_xor_sync(0xffffffffu, var_a, 1);
      var_b += __shfl_xor_sync(0xffffffffu, var_b, 1);
      var_a += __shfl_xor_sync(0xffffffffu, var_a, 2);
      var_b += __shfl_xor_sync(0xffffffffu, var_b, 2);
      const float rstd_a = rsqrtf(var_a * (1.0f / C1) + eps), rstd_b = rsqrtf(var_b * (1.0f / C1) + eps);
      uint32_t a2[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 gg = *reinterpret_cast<const float2*>(prm + C1 + 8 * nt + 2 * q);
        const float2 bb = *reinterpret_cast<const float2*>(prm + 2 * C1 + 8 * nt + 2 * q);
        a2[nt >> 1][2 * (nt & 1)] = pack_bf16(gelu_erf(acc[nt][0] * rstd_a * gg.x + bb.x),
                                              gelu_erf(acc[nt][1] * rstd_a * gg.y + bb.y));
        a2[nt >> 1][2 * (nt & 1) + 1] = pack_bf16(gelu_erf(acc[nt][2] * rstd_b * gg.x + bb.x),
                                                  gelu_erf(acc[nt][3] * rstd_b * gg.y + bb.y));
      }

#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e + 2 < 4) load_s0(f0[e + 2], s0w, e + 2, width);
        float c2[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 bias = *reinterpret_cast<const float2*>(prm + 3 * C1 + 8 * nt + 2 * q);
          c2[nt][0] = c2[nt][2] = bias.x;
          c2[nt][1] = c2[nt][3] = bias.y;
        }
        const uint32_t wb2 = w2_lane + e * C1 * 64;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t b[4];
            ldsm_x4_t(wb2 + kk * 16 * 64 + (((2 * np + half) ^ w2_swz) << 4), b);
            mma(c2[2 * np], a2[kk], b[0], b[1]);
            mma(c2[2 * np + 1], a2[kk], b[2], b[3]);
          }
        // + feat_s0, GELU -> bf16 A fragments, then the hypernetwork product
        uint32_t a3[2][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 fa = bf16_pair(f0[e][nt][0]), fb = bf16_pair(f0[e][nt][1]);
          a3[nt >> 1][2 * (nt & 1)] = pack_bf16(gelu_erf(c2[nt][0] + fa.x), gelu_erf(c2[nt][1] + fa.y));
          a3[nt >> 1][2 * (nt & 1) + 1] = pack_bf16(gelu_erf(c2[nt][2] + fb.x), gelu_erf(c2[nt][3] + fb.y));
        }
        float lg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma(lg, a3[0], hb[0][0], hb[0][1]);
        mma(lg, a3[1], hb[1][0], hb[1][1]);
        if (q < 2) {  // lanes q = 0, 1 hold masks 2 q and 2 q + 1
          float* st = stage + (2 * q * 4 + 2 * di + (e >> 1)) * (4 * TOK) + 4 * r + 2 * dj + (e & 1);
          st[0] = lg[0];
          st[4 * 4 * TOK] = lg[1];
          st[32] = lg[2];
          st[4 * 4 * TOK + 32] = lg[3];
        }
      }
    }
    // the item's logits: masks x rows 4 i ... 4 i + 3, columns 4 j0 ... 4 j0 + 63
    __syncwarp();
#pragma unroll
    for (int it = 0; it < STAGE / 4 / 32; ++it) {
      const int idx = it * 32 + lane, row = idx >> 4, m = row >> 2, y = row & 3;
      const float4 v = reinterpret_cast<const float4*>(stage)[idx];
      *reinterpret_cast<float4*>(out + (((size_t)p * NM + m) * width + 4 * i + y) * width + 4 * j0 + 4 * (idx & 15)) = v;
    }
    __syncwarp();
  }
}

// float32: a block an item of 16 tokens; thread (s, c) takes u1's channel c
// of sub-pixel s for the 16 tokens, then thread (token, s, e) the 32
// channels of one u2 pixel and its four logits.  Every sum in float32 FFMA.
__global__ void __launch_bounds__(F_THREADS)
    mask_head_f32_kernel(const float* __restrict__ src, const float* __restrict__ s0, const float* __restrict__ s1,
                         const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ ln_g,
                         const float* __restrict__ ln_b, const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ hyper, float* __restrict__ out, float eps, int g) {
  extern __shared__ __align__(16) float fs[];
  const int tid = threadIdx.x, ipp = g * g / TOK, item = blockIdx.x;
  const int p = item / ipp, t0 = (item - p * ipp) * TOK, i = t0 / g, j0 = t0 - i * g;
  float *sx = fs + F_SRC, *u1 = fs + F_U1, *w2s = fs + F_W2, *hs = fs + F_HYPER, *prm = fs + F_PARAMS;
  for (int c = tid; c < TOK * D; c += F_THREADS) sx[c] = src[((size_t)p * g * g + t0) * D + c];
  for (int c = tid; c < 4 * C1 * C2; c += F_THREADS) w2s[(3 - c / (C1 * C2)) * W2_BLOCK + c % (C1 * C2)] = w2[c];
  for (int c = tid; c < NM * C2; c += F_THREADS) hs[c] = hyper[(size_t)p * NM * C2 + c];
  for (int c = tid; c < PARAMS; c += F_THREADS)
    prm[c] = c < C1 ? b1[c] : c < 2 * C1 ? ln_g[c - C1] : c < 3 * C1 ? ln_b[c - 2 * C1] : b2[c - 3 * C1];
  __syncthreads();

  {  // u1 before the LayerNorm: thread (s, c)
    const int s = tid >> 6, c = tid & (C1 - 1), di = s >> 1, dj = s & 1;
    const float* w = w1 + (3 - s) * D * C1 + c;
    float acc[TOK];
#pragma unroll
    for (int t = 0; t < TOK; ++t) acc[t] = 0.0f;
    for (int k = 0; k < D; ++k) {
      const float wk = __ldg(w + k * C1);
#pragma unroll
      for (int t = 0; t < TOK; ++t) acc[t] = fmaf(sx[t * D + k], wk, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      const size_t pix = (size_t)(2 * i + di) * (2 * g) + 2 * (j0 + t) + dj;
      u1[(t * 4 + s) * U1_ROW + c] = acc[t] + prm[c] + s1[pix * C1 + c];
    }
  }
  __syncthreads();
  if (tid < TOK * 4) {  // LayerNorm and GELU, a thread a (token, sub-pixel) row
    float* row = u1 + tid * U1_ROW;
    float mean = 0.0f, var = 0.0f;
    for (int c = 0; c < C1; ++c) mean += row[c];
    mean *= 1.0f / C1;
    for (int c = 0; c < C1; ++c) var += (row[c] - mean) * (row[c] - mean);
    const float rstd = rsqrtf(var * (1.0f / C1) + eps);
    for (int c = 0; c < C1; ++c) row[c] = gelu_erf((row[c] - mean) * rstd * prm[C1 + c] + prm[2 * C1 + c]);
  }
  __syncthreads();
  {  // u2 and the logits: thread (token, s, e)
    const int t = tid >> 4, s = (tid >> 2) & 3, e = tid & 3;
    const int y2 = 4 * i + 2 * (s >> 1) + (e >> 1), x2 = 4 * (j0 + t) + 2 * (s & 1) + (e & 1);
    const float* u = u1 + (t * 4 + s) * U1_ROW;
    const float* w = w2s + e * W2_BLOCK;
    float acc[C2];
#pragma unroll
    for (int c = 0; c < C2; ++c) acc[c] = 0.0f;
    for (int k = 0; k < C1; ++k) {
      const float uk = u[k];
#pragma unroll
      for (int c = 0; c < C2; ++c) acc[c] = fmaf(uk, w[k * C2 + c], acc[c]);
    }
    const float* f0 = s0 + ((size_t)y2 * (4 * g) + x2) * C2;
    float lg[NM] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < C2; ++c) {
      const float v = gelu_erf(acc[c] + prm[3 * C1 + c] + f0[c]);
#pragma unroll
      for (int n = 0; n < NM; ++n) lg[n] = fmaf(hs[n * C2 + c], v, lg[n]);
    }
    const size_t width = 4 * (size_t)g;
#pragma unroll
    for (int n = 0; n < NM; ++n) out[(((size_t)p * NM + n) * width + y2) * width + x2] = lg[n];
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, std::atomic<unsigned>& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(set.load() >> dev & 1u))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < 32) set.fetch_or(1u << dev);
  }
  return err;
}

}  // namespace

// src (P, g, g, 256), feat_s0 (4g, 4g, 32), feat_s1 (2g, 2g, 64), w1 (2, 2,
// 256, 64), b1, ln_g, ln_b (64,), w2 (2, 2, 64, 32), b2 (32,), hyper (P, 4,
// 32): contiguous, 16-byte aligned, all bf16 (f32 = 0) or all float32 (f32 =
// 1); logits (P, 4, 4g, 4g) float32.  g a multiple of 16.
extern "C" int ha_mask_head(const void* src, const void* s0, const void* s1, const void* w1, const void* b1,
                            const void* ln_g, const void* ln_b, const void* w2, const void* b2, const void* hyper,
                            void* logits, float eps, int p, int g, int f32, void* stream) {
  if (p < 0 || g < TOK || g % TOK != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long items = static_cast<long long>(p) * (g / TOK) * g;
  if (items > (1LL << 31) - 1) return static_cast<int>(cudaErrorInvalidValue);
  if (f32) {
    static std::atomic<unsigned> set{0};
    cudaError_t err = allow_smem(mask_head_f32_kernel, SMEM_F32, set);
    if (err != cudaSuccess) return static_cast<int>(err);
    mask_head_f32_kernel<<<static_cast<unsigned>(items), F_THREADS, SMEM_F32, st>>>(
        static_cast<const float*>(src), static_cast<const float*>(s0), static_cast<const float*>(s1),
        static_cast<const float*>(w1), static_cast<const float*>(b1), static_cast<const float*>(ln_g),
        static_cast<const float*>(ln_b), static_cast<const float*>(w2), static_cast<const float*>(b2),
        static_cast<const float*>(hyper), static_cast<float*>(logits), eps, g);
    return static_cast<int>(cudaGetLastError());
  }
  static std::atomic<unsigned> set{0};
  cudaError_t err = allow_smem(mask_head_bf16_kernel, SMEM_BF16, set);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = std::min<long long>(sms, (items + WARPS - 1) / WARPS);
  using bf = __nv_bfloat16;
  mask_head_bf16_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BF16, st>>>(
      static_cast<const bf*>(src), static_cast<const bf*>(s0), static_cast<const bf*>(s1), static_cast<const bf*>(w1),
      static_cast<const bf*>(b1), static_cast<const bf*>(ln_g), static_cast<const bf*>(ln_b),
      static_cast<const bf*>(w2), static_cast<const bf*>(b2), static_cast<const bf*>(hyper),
      static_cast<float*>(logits), eps, p, g);
  return static_cast<int>(cudaGetLastError());
}
