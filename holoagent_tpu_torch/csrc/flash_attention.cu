// Online-softmax attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the two Pallas TPU kernels of holoagent_tpu/ops/flash_attention.py:
//   * K1  flash_attention_2d (_flash2d_kernel): SAM image-encoder attention
//     over an h x w token grid with the decomposed relative-position bias
//       s[q, k] = q.k * d^-1/2 + bias_h[q, k / w] + bias_w[q, k % w]
//   * K2  flash_attention (_flash_kernel): plain blockwise attention over
//     (B, H, T, D), optionally causal (key <= query: every row keeps its
//     diagonal), keys at or past T masked.
// Four kernels, instantiated per route:
//   - global_kernel<REL_POS, D> (TMA + wgmma, warp-specialised): with the
//     bias, K1 for N > T_MAX (the SAM global layers, a 64 x 64 grid);
//     without it, K2 for T > T_MAX, causal or not (long prefills);
//   - resident_kernel<REL_POS, CAUSAL, D>: K1 for N <= T_MAX (the SAM
//     windows, 14 x 14) with the bias on; K2 for T <= T_MAX with it off,
//     non-causal (every CLIP visual layer, T = 257 for the /14 towers, 50
//     for ViT-B-32) or causal (the CLIP text tower, T = 77).  The bias and
//     the causal mask never meet;
//   - g1_bf16_kernel and g2_tf32x3_kernel<REL_POS, CAUSAL, DM, ALIGNED>
//     (G1, G2): everything else, bf16 and float32 (below).
// The two tensor-core kernels take bf16 and read q, k and v where they lie
// (any batch, head and token strides that are multiples of 16 bytes, last
// dim contiguous, such as the views of a fused qkv projection), write the
// output as (B, T, H, D), keep every score in registers (no (T, T) tensor in
// device memory) and mask the ragged key edge themselves.  No route copies
// its inputs or its output.  Both are instantiated at head dims 64 (SAM
// vit_b and vit_l, CLIP ViT-B-32 and ViT-L/14, every text tower, the VLMs)
// and 80 (SAM vit_h, CLIP ViT-H-14's visual tower: width 1280 over 16
// heads; without the causal mask, which no layer at 80 has).
//
// What bounds it on the H100.  At the port's shapes (D = 64 unless named):
//   K1 global layers  BH=12,  N=4096: 51.5 GFLOP of tensor-core work against
//                     ~50 MB of traffic -> compute-bound (~52 us at 989
//                     TF/s); the softmax's 201 M exponentials take about as
//                     long again on the SFUs (16 a clock per SM);
//   K1 windows        BH=300, N=196:   ~3 GFLOP, ~37 MB  -> memory-bound;
//   K1 vit_h global   BH=16, N=4096, D=80: 85.9 GFLOP -> compute-bound (87 us);
//   K1 vit_h windows  BH=400, N=196, D=80: 4.9 GFLOP, ~62 MB -> memory-bound;
//   K2 CLIP crops     BH=16*(2*tier+1), T=257: 8.9 GFLOP against 69 MB at
//                     tier 16 -> memory-bound (21 us at 3.35 TB/s);
//   K2 text tower     BH=256*12, T=77, causal: 2.4 GFLOP of causal pairs
//                     against 121 MB -> memory-bound (36 us);
//   K2 long prefill   BH=4*16, T=1024, causal: 8.6 GFLOP against 34 MB ->
//                     compute-bound on paper (9 us), latency-bound in fact:
//                     512 blocks of 1-8 key tiles each;
//   K2 ViT-H-14 crops BH=33*16, T=257, D=80: 11.2 GFLOP against 87 MB ->
//                     memory-bound (26 us).
//
// The global kernel (N > T_MAX).  A block of three warpgroups owns 128
// queries of one head.
//   - Warpgroup 0 is the producer: after `setmaxnreg` gives its registers to
//     the consumers, one thread loads the block's Q tile once and then the
//     head's K and V in 128-key tiles into a ring of three stages, by TMA
//     (cp.async.bulk.tensor, 4-D maps over (D, token, head, batch) at the
//     caller's strides, 128-byte swizzle: a 64-wide bf16 row is one swizzle
//     row), each stage guarded by a full and an empty mbarrier.  TMA
//     zero-fills rows past N.
//   - Warpgroups 1 and 2 are the consumers, 64 queries each.  Per key tile:
//     S = Q K^T by wgmma m64n128k16 bf16 -> f32 with both operands in shared
//     memory (K-major); the softmax in registers, in log2 units; then O += P V
//     by wgmma m64n64k16 with P from registers (the S accumulator's layout is
//     the A fragment's) and V from shared memory as stored, key-major with D
//     contiguous, read through wgmma's transpose-B bit.
//   - With the bias (K1) the key tile holds whole grid rows (64 wide), so the
//     key column kx of each accumulator slot is the same in every tile.  Each
//     thread loads bias_w[q, kx] for its two rows and its slots once (32
//     floats, in log2 units) and keeps them for the whole key loop.
//     bias_h[q, ky] is one value per row and grid row of the tile, loaded per
//     tile; it folds into the row's shift.  Per score: one FFMA (scale and
//     bias_w), one FMAX, one FADD (shift) and one ex2.approx.  A grid row past
//     h (an odd h) gets bias_h = -1e30, which masks its keys.  It takes grids
//     64 wide only (every SAM variant at 1024 px); the C entry returns
//     cudaErrorInvalidValue, and the wrapper raises, for any other width.
//   - Without it (K2) the running max is that of the raw scores and a
//     probability is 2^(s * scale * log2(e) - max * scale * log2(e)): one FFMA
//     and one ex2.approx a score.  Key tiles wholly inside every row's range
//     run unmasked; only the tile with the ragged key edge, or with causal the
//     diagonal tile (the last one the block loads: its key loop ends at the
//     tile holding its last query), is masked per element.  Blocks are
//     launched heaviest query tile first, so the longest causal rows do not
//     trail the wave.
//   - Each consumer waits for its S before the softmax and for its P V
//     before the next tile; the other consumer's wgmma overlaps its softmax.
//
// The resident kernel (N <= T_MAX).  One block (4 warps) owns one head, or a
// share of its query tiles where the grid would otherwise not fill the card
// and the heads alone fill at most half a wave (see resident_plan):
//   - it stages the head's K and V (T16 x 64 bf16 each, T16 = T rounded up to
//     16; 33 KB each at T = 257, 10 KB at T = 77) in shared memory once, with
//     16-byte cp.async in two commit groups, K then V, so QK^T starts while V
//     lands; rows are 128 bytes with their 16-byte chunks XOR-swizzled by
//     row % 8, and rows past T are zero-filled (a stale NaN in a padded V row
//     would survive p = 0);
//   - each warp walks m16 query tiles, its Q fragments loaded straight from
//     device memory into registers (the next tile's while this tile's output
//     is stored), and runs the online softmax over the resident keys in
//     64-key chunks (mma.sync m16n8k16) with no barrier between chunks and no
//     branch inside one; K's B fragments come from ldmatrix, V's from
//     ldmatrix.trans.  Only the last chunk a tile reads is masked per element
//     (keys past each row's last visible key: T - 1, or with causal the row
//     itself), at 16-key granularity;
//   - causal: a tile at rows [r0, r0 + 16) runs the chunks wholly below r0
//     unmasked, masks the chunk that holds the diagonal, and skips the keys
//     past r0 + 15.  The work grows with the tile, so a block's tiles are
//     dealt to its warps heaviest first in snake order, and a head's tiles to
//     its blocks in the same way; a block stages only the keys its heaviest
//     tile can see;
//   - without the bias the softmax keeps the running max of the raw scores
//     and forms each probability as 2^(s * scale * log2(e) - max * scale *
//     log2(e)): one FFMA and one ex2.approx a score;
//   - with the bias (REL_POS), each warp copies its query tile's bias_h and
//     bias_w rows (16 x h and 16 x w f32, each contiguous in device memory)
//     into its slice of shared memory with 4-byte cp.async, double-buffered:
//     the next tile's rows are in flight while this tile runs.  A per-block
//     table gives each 16-padded key its (ky, kx), computed once per block: a
//     score is s * scale + bias_h_row[ky] + bias_w_row[kx], never a division,
//     and the softmax then takes it to log2 units in its FFMA.  It takes
//     grids with h + w <= RES_HW_MAX.
// About 70 KB of shared memory at T = 257 (68 KB at the windows' T = 196,
// the bias included) lets three blocks share an SM; at T = 77 (20 KB) the
// registers set the limit, and the causal instantiation is built for four
// blocks an SM (at most 128 registers a thread).
//
// Head dim 80 (K1, and K2 without the causal mask).  An 80-wide bf16 row
// is 160 bytes: ten 16-byte chunks, which no XOR swizzle within the row
// permutes.
//   - The resident kernel keeps its panels unswizzled at a pitch of 176
//     bytes (Panel<80>): the 8 rows an ldmatrix reads at one chunk start 12
//     banks apart modulo 32, on 8 different groups of 4 banks.  QK^T takes
//     5 k16 steps (the fifth's B fragments by ldmatrix.x2), P V 10 n8 tiles.
//     The windows' K, V and bias (88 KB at N = 196) let two blocks share an
//     SM, so the instantiation is built for two (up to 255 registers).  K2's
//     (ViT-H-14's crops, T = 257) stages 94 KB of K and V a block without
//     the bias: two blocks an SM as well.
//   - The global kernel splits each Q, K and V tile into a head (columns
//     0-63, one 128-byte-swizzled TMA box as at D = 64) and a tail (columns
//     64-79, a second box with the 32-byte swizzle): 20 KB a tile, 140 KB
//     with the 3-stage ring.  QK^T is 4 k16 wgmma steps on the heads plus
//     one on the tails; P V an m64n64k16 wgmma on V's head plus an
//     m64n16k16 one on its tail, both with P from registers.  The other
//     form, two 64-column boxes with the second zero-filled past column 80,
//     would run both products at a padded 128 (1.6x the tensor-core work
//     and 64 accumulator registers a thread instead of 40) and need 225 KB
//     of shared memory for 3 stages; the split form does no wasted work.
//
// The general kernels (every other input: float32, a head dim other than
// 64 and 80, a causal layer at 80, a K1 grid neither tensor-core kernel
// takes, such as the tiny towers' and the fixture towers').  They cover both
// TPU kernels, _flash_kernel and _flash2d_kernel, for the inputs the
// reference takes and the kernels above do not: bf16 (G1) or float32 (G2),
// any head dim up to GEN_D_MAX, any T, any h x w grid, any strides with a
// contiguous last dim.  Production reaches them with float32 towers
// (config/synthetic.yaml's test-tiny towers; config/synthetic_tpu_3room.yaml
// with models.clip.dtype float32: SAM vit_b's global layers, H = 12, N =
// 4096, D = 64, 51.5 GFLOP a layer, and every CLIP ViT-L/14 layer) and with
// the tiny text tower's bf16 batches (D = 16).
//   - What bounds them.  float32 inputs keep float32's accuracy (the port
//     keeps TF32 off: a single TF32 product keeps about 3 decimal digits),
//     so G2 takes each product as three TF32 products (3xTF32: x = hi + lo,
//     hi = tf32(x), lo = x - hi, a b ~ hi.hi + hi.lo + lo.hi, about 2^-21
//     a product) on mma.sync m16n8k8: at most 495 / 3 = 165 TF/s of
//     float32 work, where FFMA on the CUDA cores gives 67.  SAM's float32
//     global layer is then bound by operations (0.31 ms); the CLIP crop
//     stacks and the windows nearly so.  G1's bf16 shapes are small (D = 16
//     to 80, T = 77 to 257) and bound by the bytes of q, k, v and o.
//   - A block of 4 warps owns 64 queries of one head (GEN_BQ), a warp an
//     m16 query tile; the head dim is padded to the next multiple of 16 (DM
//     = 16 ... 128: D = 80 runs 5 k16 steps, not 8).  Key tiles of 64 keys
//     (32 for float32 above DM = 64) stream through a two-stage cp.async
//     ring, K and V in their own dtype (bf16 for G1: half the bytes of a
//     float32 staging): tile i + 1 lands while tile i is computed, one
//     barrier a tile.  Rows sit at a padded pitch (bf16 DM + 8, an odd
//     number of 16-byte chunks; float32 DM + 4 words, 4 or 20 modulo 32), so
//     ldmatrix (G1) and the fragments' 32-bit reads (G2) hit 32 banks.
//   - G1: QK^T and P V by mma.sync m16n8k16 bf16 -> f32, K's B fragments by
//     ldmatrix, V's by ldmatrix.trans, P repacked from the S accumulators
//     into bf16 A fragments (as the tensor-core kernels round it).
//   - G2: both products in 3xTF32, each operand split as it is read; P stays
//     float32 and its n8 group's keys are taken in the order 2 tg, 2 tg + 1,
//     so the S fragment is the A fragment with no shuffle (V's rows read to
//     match).  Each tile's P V sums apart and is added to the output by one
//     IEEE add: the tensor cores' float32 sums do not round to nearest, and
//     over a 4096-key loop their error would pass float32's.  Q's halves sit
//     in registers up to DM = 64, in shared memory above (registers would
//     spill).
//   - The online softmax runs in log2 units, one FFMA and one ex2 a score;
//     only a tile holding the ragged key edge or, with causal, keys past a
//     warp's first row is masked per element.  Causal: the key loop ends at
//     the block's diagonal tile, a warp skips a tile wholly past its rows,
//     and blocks launch heaviest query tile first.
//   - K1's bias on any grid: a per-tile (ky, kx) table (one division a key
//     and block), and the block's 64 rows of bias_h and bias_w staged once
//     in shared memory (rows padded to an odd number of words) where h + w
//     <= GEN_BIAS_HW_MAX, else read through L1.
//   - Layouts: where q, k, v start on 16 bytes and every stride is a
//     multiple of 16 bytes (the fused projections' views at every
//     production head dim) tiles are staged by 16-byte cp.async, a row's
//     last chunk reading only its columns below d; otherwise (a bf16 head
//     dim of 20: 40-byte rows) element by element.  The C entry picks the
//     instantiation (ALIGNED) from the pointers and strides; nothing is
//     copied.
//   - SAM 2's Hiera trunk runs every attention here, G1 at D = 72 (DM =
//     80, the instantiation K2's other head dims already build): its windows
//     (T = 16, 64, 256), its global blocks (T = 4096) and, with a key count
//     of their own (tk), its three stage transitions, whose queries
//     are pooled 2x2 inside the window and whose keys are not (tq = tk / 4:
//     16 / 64, 4 / 16, 64 / 256).  Queries and keys have their own counts
//     in the body (t, tk); a block's rows past tq are never stored.
//
// Left for later: a persistent tile loop and intra-warpgroup overlap of the
// next tile's QK^T with this tile's softmax in the global kernel; wgmma in
// the resident kernel.

#include <cuda.h>  // CUtensorMap and its enums; the encoder itself is fetched from libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.44269504088896341f;  // scores in log2 units: exp(x) = exp2(x * log2(e))
constexpr int ROW_BYTES = 128;                 // one 64-wide bf16 row of Q, K or V
constexpr int HEAD_DIM_WIDE = 80;              // K1's second head dim (SAM vit_h: width 1280 / 16 heads)

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

// 2^x by the SFU (ex2.approx, flush to zero: about 2 ulps, and
// 2^(-huge) = 0 for masked scores)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

struct Strides {
  long long b, h, t;  // batch, head and token strides in elements; the last dim is contiguous
};

// ---------------------------------------------------------------------------
// The resident kernel: K1 and K2, N <= T_MAX
// ---------------------------------------------------------------------------

constexpr int T_MAX = 320;  // longest N the resident kernel takes (80 KB of K and V); ops/flash_attention.py routes on its copy
constexpr int RES_WARPS = 4;
constexpr int RES_THREADS = RES_WARPS * 32;
constexpr int RES_MIN_BLOCKS = 3;  // blocks an SM must hold: at most 168 registers a thread
// The causal instantiation (the text tower, T = 77: 20 KB of shared memory a
// block) must hold 4: at most 128 registers a thread, which spills 32 bytes
// and still runs the text launch about 6% faster than at 3.  Where shared
// memory allows fewer blocks anyway (T above 224) it only costs registers.
constexpr int RES_MIN_BLOCKS_CAUSAL = 4;
// At D = 80 a window batch's K and V (N = 196: 73 KB) and bias slices (14
// KB) let two blocks share an SM whatever the registers, so that
// instantiation may take up to 255 registers a thread and spills nothing.
constexpr int RES_MIN_BLOCKS_WIDE = 2;
constexpr int CHUNK = 4;           // 16-key groups per step of the online softmax
constexpr int RES_HW_MAX = 128;    // largest grid_h + grid_w the resident kernel takes with the bias; ops/flash_attention.py has a copy

// A K or V panel in shared memory: one row of D bf16 a key, in 16-byte
// chunks.  D = 64: 128-byte rows, chunk c of row r stored at chunk c ^ (r %
// 8), so the 8 rows an ldmatrix reads at one chunk hit 8 different groups of
// 4 banks.  D = 80: 10 chunks do not XOR-swizzle within a row, so a row is
// 160 bytes plus 16 of padding: at a pitch of 176 bytes (44 words, 12 modulo
// 32) the 8 rows of one chunk also start on 8 different groups of 4 banks.
template <int D>
struct Panel;
template <>
struct Panel<64> {
  static constexpr int PITCH = ROW_BYTES;
  __device__ static __forceinline__ uint32_t off(int r, int c) { return r * PITCH + ((c ^ (r & 7)) << 4); }
};
template <>
struct Panel<HEAD_DIM_WIDE> {
  static constexpr int PITCH = 176;
  __device__ static __forceinline__ uint32_t off(int r, int c) { return r * PITCH + (c << 4); }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
// 4 bytes, or zeros where !valid (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
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
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Copy rows [0, t) of a (t, D) panel with token stride `st` into a shared
// panel of t16 rows (Panel<D>); rows t..t16-1 become zeros.
template <int D>
__device__ __forceinline__ void stage_panel(uint32_t dst, unsigned char* dst_ptr,
                                            const __nv_bfloat16* __restrict__ src, long long st, int t,
                                            int t16) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < t16 * C; i += RES_THREADS) {
    const int r = i / C, c = i % C;
    if (r < t)
      cp_async16(dst + Panel<D>::off(r, c), src + r * st + c * 8);
    else
      *reinterpret_cast<uint4*>(dst_ptr + Panel<D>::off(r, c)) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
}

// This thread's V copies have landed; then a CTA barrier (the unaligned
// form: warps reach it from different places) makes all of them visible.
__device__ __forceinline__ void wait_for_v() {
  cp_async_wait<0>();
  asm volatile("barrier.sync 1;\n" ::: "memory");
}

// K1's decomposed bias: (bh, t, grid_h) and (bh, t, grid_w) f32, contiguous.
struct RelPos {
  const float* bias_h;
  const float* bias_w;
  int grid_h, grid_w;
};

// This thread's two query rows (g and g + 8 of its warp's tile) of bias_h
// and bias_w, in its warp's shared slice.
struct BiasRows {
  const float *h0, *w0, *h1, *w1;
};

// One warp's 16 query rows: Q as mma A fragments, the output accumulator
// and the running max and partial sum of each of its two rows.
template <int D>
struct Rows {
  uint32_t qa[D / 16][4];
  float acc[D / 8][4];
  float m[2], l[2];
};

// One chunk of G 16-key groups from key0 against the resident K and V:
// S = Q K^T (mma.sync m16n8k16, K's B fragments by ldmatrix), the online
// softmax in log2 units, acc += P V (V's B fragments by ldmatrix.trans).
// MASK: the chunk holds the last key some row may see.  Without CAUSAL the
// keys at or past `edge` (T) are masked; with it each of this thread's two
// rows masks the keys past itself (`edge` is its first row, the second is
// edge + 8).
// `scale`: d^-1/2 * log2(e) without the bias.  REL_POS: `scale` is d^-1/2,
// each score becomes s * scale + bias_h[ky] + bias_w[kx], with (ky, kx) from
// the key table `tab` and the rows from `br`, and the max is that of the
// biased scores.
// No branch inside, so the compiler interleaves the groups' MMAs.
template <int G, bool MASK, bool REL_POS, bool CAUSAL, int D>
__device__ __forceinline__ void attend_chunk(Rows<D>& st, uint32_t ks, uint32_t vs, int key0, int edge, float scale,
                                             bool& v_ready, const uint32_t* tab, const BiasRows& br) {
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
    ldmatrix_x4(kb[0], ks + Panel<D>::off(key, k_chunk));
    ldmatrix_x4(kb[1], ks + Panel<D>::off(key, 4 + k_chunk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_16816(s[j], st.qa[kk], kb[kk / 2][(kk % 2) * 2], kb[kk / 2][(kk % 2) * 2 + 1]);
    if constexpr (D == HEAD_DIM_WIDE) {  // chunks 8-9: head-dim step 4 (lanes 0-7 chunk 8, 8-15 chunk 9)
      uint32_t kt[2];
      ldmatrix_x2(kt, ks + Panel<D>::off(key, 8 + (k_chunk & 1)));
      mma_16816(s[j], st.qa[4], kt[0], kt[1]);
    }
  }

  if constexpr (REL_POS) {
#pragma unroll
    for (int j = 0; j < 2 * G; ++j) {
      const uint2 e = *reinterpret_cast<const uint2*>(tab + key0 + j * 8 + tg * 2);  // keys 2tg, 2tg + 1
      s[j][0] = fmaf(s[j][0], scale, br.h0[e.x & 0xffffu] + br.w0[e.x >> 16]);
      s[j][1] = fmaf(s[j][1], scale, br.h0[e.y & 0xffffu] + br.w0[e.y >> 16]);
      s[j][2] = fmaf(s[j][2], scale, br.h1[e.x & 0xffffu] + br.w1[e.x >> 16]);
      s[j][3] = fmaf(s[j][3], scale, br.h1[e.y & 0xffffu] + br.w1[e.y >> 16]);
    }
  }
  // the running max of the scores (without the bias: the raw ones, the
  // scale being positive), then p = 2^(s * sc - max * sc): one FFMA and one
  // ex2 a score
  const float sc = REL_POS ? LOG2E : scale;
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + tg * 2 + (e & 1);
      if (MASK && (CAUSAL ? key > edge + 8 * (e >> 1) : key >= edge)) s[j][e] = NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float alpha[2], shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((st.m[r] - mx[r]) * sc);
    st.m[r] = mx[r];
    st.l[r] *= alpha[r];
    shift[r] = -mx[r] * sc;
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
      const float p = ex2(fmaf(s[j][e], sc, shift[e >> 1]));
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
      ldmatrix_x4_trans(vb, vs + Panel<D>::off(key, 2 * dp + v_chunk));
      mma_16816(st.acc[2 * dp], pa, vb[0], vb[1]);
      mma_16816(st.acc[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
}

// Shared memory of the resident kernel for t tokens of head dim D; hw =
// grid_h + grid_w with the bias (the key table and four warps' two bias
// slices), 0 without.  tests/test_torch_vit_h.py holds the formula per head dim.
template <int D>
__host__ __device__ constexpr size_t resident_smem(int t, int hw) {
  return static_cast<size_t>(2) * ((t + 15) & ~15) * Panel<D>::PITCH +
         (hw ? static_cast<size_t>((t + 15) & ~15) * 4 + static_cast<size_t>(2 * RES_WARPS) * 16 * hw * 4 : 0);
}
// The largest launch of each instantiation must fit one block's shared memory.
static_assert(resident_smem<64>(T_MAX, RES_HW_MAX) <= 232448, "resident kernel, D = 64");
static_assert(resident_smem<HEAD_DIM_WIDE>(T_MAX, RES_HW_MAX) <= 232448, "resident kernel, D = 80");

// q, k, v (B, H, T, D) bf16 at the given strides; o (B, T, H, D) bf16,
// contiguous.  Block (x, y): head y = b * H + h and its x-th share of the
// head's query tiles of 16 rows, which its warps take in turn.  D = 64, or
// 80 without the causal mask.
template <bool REL_POS, bool CAUSAL, int D = 64>
__global__ void __launch_bounds__(RES_THREADS, CAUSAL ? RES_MIN_BLOCKS_CAUSAL
                                                      : D == 64 ? RES_MIN_BLOCKS : RES_MIN_BLOCKS_WIDE)
resident_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Strides sq, Strides sk,
                Strides sv, int heads, int t, int tiles_per_block, float scale, RelPos rp) {
  static_assert(!(REL_POS && CAUSAL), "the bias and the causal mask never meet");
  static_assert(D == 64 || (D == HEAD_DIM_WIDE && !CAUSAL), "D = 64, or 80 without the causal mask");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int t16 = (t + 15) & ~15;
  const int n16 = t16 / 16;
  unsigned char* ks_ptr = smem_raw;
  unsigned char* vs_ptr = smem_raw + t16 * Panel<D>::PITCH;
  const uint32_t ks = smem_u32(ks_ptr), vs = smem_u32(vs_ptr);

  // Causal: the block's j-th query tile, or -1 past its last: the head's
  // tiles heaviest (last) first, dealt to its blocks in snake order, so each
  // block gets an equal share of the triangle and its own tiles come
  // heaviest first.  A block then stages only the keys its heaviest tile
  // sees.  (Without causal a block owns the run of tiles_per_block tiles
  // from x * tiles_per_block.)
  const int splits = gridDim.x, x = blockIdx.x;
  auto causal_tile = [&](int j) -> int {
    const int rank = j * splits + ((j & 1) ? splits - 1 - x : x);
    return rank < n16 ? n16 - 1 - rank : -1;
  };
  const int t16_staged = CAUSAL ? (causal_tile(0) + 1) * 16 : t16;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  const int t_staged = CAUSAL ? min(t, t16_staged) : t;
  stage_panel<D>(ks, ks_ptr, k, sk.t, t_staged, t16_staged);  // commit group 0: K
  stage_panel<D>(vs, vs_ptr, v, sv.t, t_staged, t16_staged);  // commit group 1: V

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the mma fragment
  const int tg = lane & 3;  // column pair within the mma fragment
  const int tile_end = min(n16, (x + 1) * tiles_per_block);  // without causal
  const int full_chunks = t / (16 * CHUNK);  // chunks with no key at or past t
  const int tail = n16 - CHUNK * full_chunks;  // 16-key groups left, 0 to CHUNK, masked

  // with the bias: key k's (ky, kx), one division per key and block; then
  // this warp's two slices, each 16 rows of bias_h and 16 of bias_w
  uint32_t* tab = reinterpret_cast<uint32_t*>(vs_ptr + t16 * Panel<D>::PITCH);
  const int hw = rp.grid_h + rp.grid_w;
  float* slices = reinterpret_cast<float*>(tab + t16) + warp * 2 * 16 * hw;
  if constexpr (REL_POS) {
    for (int i = threadIdx.x; i < t16; i += RES_THREADS) {
      const int ky = i / rp.grid_w;
      tab[i] = i < t ? static_cast<uint32_t>(ky) | static_cast<uint32_t>(i - ky * rp.grid_w) << 16 : 0u;
    }
  }

  cp_async_wait<1>();
  __syncthreads();  // K (and the key table) is resident
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
  // the 16 rows of `tile` of bias_h and bias_w (each 16 consecutive rows of
  // one head: contiguous) into this warp's slice `buf`, by cp.async in one
  // commit group; rows past t are zeros
  auto load_bias = [&](int tile, int buf) {
    float* dst = slices + buf * 16 * hw;
    const size_t row0 = static_cast<size_t>(blockIdx.y) * t + tile * 16;
    const int nh = min(16, t - tile * 16) * rp.grid_h, nw = min(16, t - tile * 16) * rp.grid_w;
    const float* src_h = rp.bias_h + row0 * rp.grid_h;
    const float* src_w = rp.bias_w + row0 * rp.grid_w;
    for (int i = lane; i < 16 * rp.grid_h; i += 32) cp_async4(smem_u32(dst + i), src_h + min(i, nh - 1), i < nh);
    for (int i = lane; i < 16 * rp.grid_w; i += 32)
      cp_async4(smem_u32(dst + 16 * rp.grid_h + i), src_w + min(i, nw - 1), i < nw);
    cp_async_commit();
  };
  // next_tile(it, tile): the tile this warp takes after its it-th, `tile`,
  // or -1 past the block's last.  The warps take the block's tiles in turn,
  // with causal in snake order (0 1 2 3 3 2 1 0 ...), heaviest first.
  auto snake = [&](int it) { return causal_tile(it * RES_WARPS + ((it & 1) ? RES_WARPS - 1 - warp : warp)); };
  auto next_tile = [&](int it, int tile) -> int {
    if constexpr (CAUSAL)
      return snake(it + 1);
    else
      return tile + RES_WARPS < tile_end ? tile + RES_WARPS : -1;
  };
  Rows<D> st;
  BiasRows br{};
  int tile = CAUSAL ? snake(0) : x * tiles_per_block + warp;
  if (!CAUSAL && tile >= tile_end) tile = -1;
  if (REL_POS && tile >= 0) load_bias(tile, 0);
  if (tile >= 0) load_q(st.qa, tile);
  for (int it = 0; tile >= 0; ++it) {
    const int next = next_tile(it, tile);
    const int r0 = tile * 16 + g;  // this thread's rows r0 and r0 + 8
    if constexpr (REL_POS) {
      __syncwarp();  // every lane is done with the slice the next tile's rows go to
      if (next >= 0)
        load_bias(next, (it + 1) & 1);
      else
        cp_async_commit();  // an empty group: this tile's rows are always the second newest
      cp_async_wait<1>();
      __syncwarp();  // this tile's rows, copied by every lane, have landed
      const float* buf = slices + (it & 1) * 16 * hw;
      br = BiasRows{buf + g * rp.grid_h, buf + 16 * rp.grid_h + g * rp.grid_w, buf + (g + 8) * rp.grid_h,
                    buf + 16 * rp.grid_h + (g + 8) * rp.grid_w};
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) st.acc[j][0] = st.acc[j][1] = st.acc[j][2] = st.acc[j][3] = 0.f;
    st.m[0] = st.m[1] = NEG_INF;
    st.l[0] = st.l[1] = 0.f;  // per-thread partial sums, reduced at the end

    // The unmasked chunks, then the masked groups: without causal those that
    // hold keys at or past t; with it the chunks wholly below row tile * 16,
    // then the groups up to and including the diagonal, each row masking the
    // keys past itself, and no key past the tile's last row.
    const int below = CAUSAL ? tile / CHUNK : full_chunks;
    const int groups = CAUSAL ? tile % CHUNK + 1 : tail;
    const int edge = CAUSAL ? r0 : t;
    for (int c = 0; c < below; ++c)
      attend_chunk<CHUNK, false, REL_POS, CAUSAL, D>(st, ks, vs, c * 16 * CHUNK, edge, scale, v_ready, tab, br);
    const int key0 = below * 16 * CHUNK;
    switch (groups) {  // cases above CHUNK never occur
      case 4: attend_chunk<4, true, REL_POS, CAUSAL, D>(st, ks, vs, key0, edge, scale, v_ready, tab, br); break;
      case 3: attend_chunk<3, true, REL_POS, CAUSAL, D>(st, ks, vs, key0, edge, scale, v_ready, tab, br); break;
      case 2: attend_chunk<2, true, REL_POS, CAUSAL, D>(st, ks, vs, key0, edge, scale, v_ready, tab, br); break;
      case 1: attend_chunk<1, true, REL_POS, CAUSAL, D>(st, ks, vs, key0, edge, scale, v_ready, tab, br); break;
      default: break;
    }

    // the next tile's Q is in flight while this tile's output is stored
    if (next >= 0) load_q(st.qa, next);
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
    tile = next;
  }
  if (!v_ready) wait_for_v();  // a warp with no query tile still takes its part in the barrier
}

// The resident kernel's launch for (bh heads, t tokens): query tiles per
// block, blocks per head and blocks per SM (the occupancy calculator's).
struct Plan {
  int tiles_per_block, splits, blocks_per_sm, sms;
  size_t smem;
};

// hw: grid_h + grid_w with the bias (REL_POS), else 0.
template <bool REL_POS, bool CAUSAL, int D = 64>
cudaError_t resident_plan(int bh, int t, int hw, Plan* plan) {
  plan->smem = resident_smem<D>(t, REL_POS ? hw : 0);
  // per device: the shared-memory allowance (set once, for the largest
  // launch) and the blocks per SM at each size, so a launch makes no CUDA
  // queries after the first at its size
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> blocks_per_sm;
  auto kernel = resident_kernel<REL_POS, CAUSAL, D>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const std::pair<int, size_t> key{dev, plan->smem};
  int cached = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = blocks_per_sm.find(key);
    if (it != blocks_per_sm.end()) cached = it->second;
  }
  if (cached == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(resident_smem<D>(T_MAX, REL_POS ? RES_HW_MAX : 0)));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached, kernel, RES_THREADS, plan->smem);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    blocks_per_sm[key] = cached;
  }
  plan->blocks_per_sm = cached;
  plan->sms = sms;
  const int n16 = (t + 15) / 16;
  const int slots = plan->blocks_per_sm * sms;
  // a block's query tiles: at most 2 * RES_WARPS + 1, and more blocks while
  // the grid does not fill the card; but one head a block when the heads
  // alone fill more than half of one wave, where a split would only add a
  // second wave and stage each head's K and V twice (the SAM windows: 300
  // heads on 396 slots, faster as one block a head)
  int splits = 1;
  if (2 * bh <= slots || bh > slots) {
    splits = (n16 + 2 * RES_WARPS) / (2 * RES_WARPS + 1);
    while (bh * splits < slots && (n16 + splits) / (splits + 1) >= RES_WARPS) ++splits;
  }
  plan->tiles_per_block = (n16 + splits - 1) / splits;
  plan->splits = (n16 + plan->tiles_per_block - 1) / plan->tiles_per_block;
  return cudaSuccess;
}

template <bool REL_POS, bool CAUSAL, int D = 64>
int launch_resident(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk, Strides sv,
                    int b, int h, int t, float scale, RelPos rp, cudaStream_t stream) {
  Plan plan;
  cudaError_t err = resident_plan<REL_POS, CAUSAL, D>(b * h, t, rp.grid_h + rp.grid_w, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(plan.splits, b * h);
  resident_kernel<REL_POS, CAUSAL, D><<<grid, RES_THREADS, plan.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, sv, h, t,
      plan.tiles_per_block, REL_POS ? scale : scale * LOG2E, rp);
  return static_cast<int>(cudaGetLastError());
}

// The plan of resident_kernel<REL_POS, CAUSAL> into out[0..7]: query tiles
// per block, blocks per head, blocks per SM, SMs, registers a thread, shared
// memory a block (bytes), and the blocks per SM that its registers alone and
// its shared memory alone allow (the latter from the device's shared memory
// per SM and what it reserves for each block).
template <bool REL_POS, bool CAUSAL, int D = 64>
cudaError_t resident_report(int bh, int t, int hw, int* out) {
  Plan plan;
  cudaFuncAttributes attr;
  int by_regs = 0, dev = 0, smem_per_sm = 0, reserved = 0;
  cudaError_t err = resident_plan<REL_POS, CAUSAL, D>(bh, t, hw, &plan);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, resident_kernel<REL_POS, CAUSAL, D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&by_regs, resident_kernel<REL_POS, CAUSAL, D>, RES_THREADS, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  const int by_smem = smem_per_sm / (static_cast<int>(plan.smem) + reserved);
  const int report[8] = {plan.tiles_per_block, plan.splits, plan.blocks_per_sm, plan.sms, attr.numRegs,
                         static_cast<int>(plan.smem), by_regs, by_smem};
  for (int i = 0; i < 8; ++i) out[i] = report[i];
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The global kernel: N > T_MAX, TMA + wgmma (K1 with the bias, K2 without)
// ---------------------------------------------------------------------------

constexpr int G_W = 64;        // the grid width K1 takes: a 128-key tile is two grid rows
constexpr int G_BQ = 128;      // queries a block: two consumer warpgroups of 64
constexpr int G_BK = 128;      // keys a tile
constexpr int G_STAGES = 3;    // K/V ring
constexpr int G_THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr int G_CONSUMER_WARPS = 8;
constexpr int G_TAIL_BYTES = 32;  // a row's last 16 columns at D = 80
static_assert(G_BQ == G_BK, "one TMA box shape serves Q, K and V");
static_assert(G_BK % G_W == 0, "a key tile holds whole grid rows");

// A Q, K or V tile of 128 rows as TMA lands it.  Its head, the first 64
// columns (128 bytes a row), is one box with the 128-byte swizzle.  A
// 128-byte-swizzled box holds at most 64 bf16 columns, so at D = 80 the last
// 16 columns (32 bytes a row) are a second box, the tail, with the 32-byte
// swizzle.  QK^T then runs 4 k16 steps on the heads and one on the tails,
// and P V an n64 wgmma on V's head and an n16 wgmma on its tail.
template <int D>
struct GTile {
  static_assert(D == 64 || D == HEAD_DIM_WIDE, "the global kernel takes D = 64 or 80");
  static constexpr bool TAIL = D == HEAD_DIM_WIDE;
  static constexpr int HEAD = G_BK * ROW_BYTES;                // 16 KB
  static constexpr int TAIL_BYTES = TAIL ? G_BK * G_TAIL_BYTES : 0;  // 4 KB
  static constexpr int BYTES = HEAD + TAIL_BYTES;
  // Q, then the K/V ring; + slack to align to 1 KB (the 128-byte swizzle's period)
  static constexpr int SMEM = BYTES + G_STAGES * 2 * BYTES + 1024;
};
static_assert(GTile<64>::SMEM == 16384 + G_STAGES * 2 * 16384 + 1024, "D = 64 keeps its layout");
static_assert(GTile<HEAD_DIM_WIDE>::SMEM <= 232448, "the D = 80 ring fits one block's shared memory");

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

// One box of a 4-D (D, token, head, batch) bf16 tensor map, from column
// `col` and token `row`, into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, "
      "%6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptors of a tile loaded by TMA with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride byte
// offset).  K-major (Q, K): the leading byte offset is unused; a 16-element
// K step inside the swizzle row adds 32 bytes to the start.  MN-major (V,
// read with transpose-B): the 8-row groups step along K (16 keys: two
// groups; the next 16 keys start 2048 bytes on), and the leading byte offset
// would step along N to a second 64-wide atom, which a 64-wide head does not
// have: it is set to 1024 too.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t addr) { return sw128_desc(addr, 1024); }
// The same for a tail tile (32-byte swizzle, layout type 3): rows of 32
// bytes, 8-row groups 256 bytes apart.  K-major (Q, K: one k16 step is the
// whole row) and MN-major (V: 16 head dims, one swizzle atom wide; the
// groups step along the keys) alike; the leading byte offset, which would
// step to a second atom, is never used and is set to 256 too.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(256 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (static_cast<uint64_t>(3) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep registers that an asynchronous wgmma reads or writes in place until
// after its wait: nothing before this point may reuse or read them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (m64 x 128 keys, f32, wgmma's accumulator layout) (+)= Q (64 x 16, K-major) * K^T (128 keys x 16, K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (m64 x 64 head dims, f32) += P (64 x 16 keys, bf16 A fragments in registers) * V (16 keys x 64, MN-major)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64 x 16 head dims, f32) += P (64 x 16 keys, bf16 A fragments in registers) * V's tail (16 keys x 16, MN-major)
__device__ __forceinline__ void wgmma_pv16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The tensor maps of q, k and v (the heads' boxes), and at D = 80 of their
// tails: kernel parameters, read by TMA where they lie.
template <int D>
struct Maps {
  CUtensorMap q, k, v;
};
template <>
struct Maps<HEAD_DIM_WIDE> {
  CUtensorMap q, k, v, q_tail, k_tail, v_tail;
};

// q, k, v through their tensor maps; o (B, N, H, D) bf16, contiguous.
// REL_POS (K1): bias_h (bh, n, grid_h), bias_w (bh, n, 64) f32, contiguous;
// block (x, y) is head y = b * H + h, queries [128 x, 128 x + 128).  Without
// (K2): `causal` masks key > query; block (x, y) is head x and the query
// tile gridDim.y - 1 - y, so the heaviest causal tiles of every head launch
// first.
template <bool REL_POS, int D = 64>
__global__ void __launch_bounds__(G_THREADS, 1)
global_kernel(const __grid_constant__ Maps<D> maps, const float* __restrict__ bias_h,
              const float* __restrict__ bias_w, __nv_bfloat16* __restrict__ o, int heads, int n, int grid_h,
              int causal, float scale_log2) {
  using T = GTile<D>;
  __shared__ __align__(8) uint64_t q_bar, full_bar[G_STAGES], empty_bar[G_STAGES];
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Q's head, Q's tail, then the ring; a stage holds K's head, V's head, K's
  // tail and V's tail, each 1 KB aligned (the 128-byte swizzle wants 1 KB,
  // the 32-byte one 256 bytes)
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_smem + T::BYTES;

  const int warpgroup = threadIdx.x / 128;
  const int bh = REL_POS ? blockIdx.y : blockIdx.x, b = bh / heads, h = bh % heads;
  const int q_tile = REL_POS ? blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int q0 = q_tile * G_BQ;
  // with causal the key loop ends at the tile holding the block's last query
  // (G_BQ == G_BK: the tile q_tile)
  const int num_kt = !REL_POS && causal ? q_tile + 1 : (n + G_BK - 1) / G_BK;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&q_bar), 1);
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), G_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // producer: Q once, then keep the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(smem_u32(&q_bar), T::BYTES);
      tma_load(q_smem, &maps.q, smem_u32(&q_bar), 0, q0, h, b);
      if constexpr (T::TAIL) tma_load(q_smem + T::HEAD, &maps.q_tail, smem_u32(&q_bar), 64, q0, h, b);
      for (int kt = 0; kt < num_kt; ++kt) {
        const int s = kt % G_STAGES;
        if (kt >= G_STAGES) mbar_wait(smem_u32(&empty_bar[s]), ((kt / G_STAGES) - 1) & 1);
        const uint32_t full = smem_u32(&full_bar[s]);
        const uint32_t tile = ring + s * 2 * T::BYTES;
        mbar_expect_tx(full, 2 * T::BYTES);
        tma_load(tile, &maps.k, full, 0, kt * G_BK, h, b);
        tma_load(tile + T::HEAD, &maps.v, full, 0, kt * G_BK, h, b);
        if constexpr (T::TAIL) {
          tma_load(tile + 2 * T::HEAD, &maps.k_tail, full, 64, kt * G_BK, h, b);
          tma_load(tile + 2 * T::HEAD + T::TAIL_BYTES, &maps.v_tail, full, 64, kt * G_BK, h, b);
        }
      }
    }
  } else {
    // consumers: 64 queries each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = warpgroup - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, tg = lane & 3;
    const int row[2] = {q0 + c * 64 + warp * 16 + g, q0 + c * 64 + warp * 16 + g + 8};
    // rows past n (a ragged last block) read row n - 1's bias and are not stored
    const size_t brow[2] = {static_cast<size_t>(bh) * n + min(row[0], n - 1),
                            static_cast<size_t>(bh) * n + min(row[1], n - 1)};
    // bias_w of this thread's two rows and its key columns kx = 8 jj + 2 tg + e,
    // in log2 units: the same columns in every tile
    float bw[2][8][2];
    const float* bh_row[2] = {nullptr, nullptr};
    if constexpr (REL_POS) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 w2 = *reinterpret_cast<const float2*>(bias_w + brow[r] * G_W + jj * 8 + tg * 2);
          bw[r][jj][0] = w2.x * LOG2E;
          bw[r][jj][1] = w2.y * LOG2E;
        }
      bh_row[0] = bias_h + brow[0] * grid_h;
      bh_row[1] = bias_h + brow[1] * grid_h;
    }
    // without the bias: the last key each of this thread's rows sees, and
    // the first tile that passes it for some row of this warpgroup (from
    // there on the scores are masked per element)
    const int last[2] = {causal ? min(row[0], n - 1) : n - 1, causal ? min(row[1], n - 1) : n - 1};
    const int first_masked = ((causal ? min(q0 + c * 64, n - 1) : n - 1) + 1) / G_BK;

    // the output accumulator: head dims 0-63 in acc, at D = 80 dims 64-79 in
    // acc_t (n8 tile j of either in slots 4 j .. 4 j + 3)
    float acc[32], acc_t[T::TAIL ? 8 : 1], sacc[64];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if constexpr (T::TAIL) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc_t[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: per-thread partial sums
    const uint32_t q_sub = q_smem + c * 64 * ROW_BYTES;
    const uint32_t q_tail = q_smem + T::HEAD + c * 64 * G_TAIL_BYTES;
    mbar_wait(smem_u32(&q_bar), 0);

    for (int kt = 0; kt < num_kt; ++kt) {
      const int s = kt % G_STAGES;
      const uint32_t k_tile = ring + s * 2 * T::BYTES, v_tile = k_tile + T::HEAD;
      const uint32_t k_tail = k_tile + 2 * T::HEAD, v_tail = k_tail + T::TAIL_BYTES;
      // bias_h of the tile's two grid rows, issued before the wait; a grid
      // row past grid_h masks its keys
      float bhv[2][2];
      if constexpr (REL_POS) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ky = kt * 2 + half;
            bhv[r][half] = ky < grid_h ? bh_row[r][ky] * LOG2E : NEG_INF;
          }
      }

      mbar_wait(smem_u32(&full_bar[s]), (kt / G_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_qk(sacc, sw128_desc(q_sub + kk * 32), sw128_desc(k_tile + kk * 32), kk);
      if constexpr (T::TAIL) wgmma_qk(sacc, sw32_desc(q_tail), sw32_desc(k_tail), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      float alpha[2], shift[2][2];  // a row's shift for each half of the tile (a grid row with the bias)
      if constexpr (REL_POS) {
        // x = s * scale * log2(e) + bias_w; the max over each grid row's half
        // of the tile, then bias_h per half
        float mg[2][2] = {{NEG_INF, NEG_INF}, {NEG_INF, NEG_INF}};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = fmaf(sacc[4 * j + e], scale_log2, bw[e >> 1][j % 8][e & 1]);
            sacc[4 * j + e] = x;
            mg[e >> 1][j / 8] = fmaxf(mg[e >> 1][j / 8], x);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(m[r], fmaxf(mg[r][0] + bhv[r][0], mg[r][1] + bhv[r][1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          alpha[r] = ex2(m[r] - mx);
          m[r] = mx;
          l[r] *= alpha[r];
          shift[r][0] = bhv[r][0] - mx;
          shift[r][1] = bhv[r][1] - mx;
        }
      } else {
        // the running max of the raw scores; keys past a row's last masked
        // in the tiles that hold them
        if (kt >= first_masked) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (kt * G_BK + j * 8 + tg * 2 + (e & 1) > last[e >> 1]) sacc[4 * j + e] = NEG_INF;
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sacc[4 * j + e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = ex2((m[r] - mx[r]) * scale_log2);
          m[r] = mx[r];
          l[r] *= alpha[r];
          shift[r][0] = shift[r][1] = -mx[r] * scale_log2;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      if constexpr (T::TAIL) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc_t[4 * j] *= alpha[0];
          acc_t[4 * j + 1] *= alpha[0];
          acc_t[4 * j + 2] *= alpha[1];
          acc_t[4 * j + 3] *= alpha[1];
        }
      }
      // p = 2^(x + shift): with the bias x is already in log2 units (an FMA
      // by 1 is an add); without, x = s * scale * log2(e), one FFMA
      const float sc = REL_POS ? 1.f : scale_log2;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(sacc[4 * j + e], sc, shift[e >> 1][j / 8]));
          sacc[4 * j + e] = p;
          l[e >> 1] += p;
        }
      // P as wgmma A fragments: n8 blocks 2kk and 2kk + 1 form k-step kk (16 keys)
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16x2(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_pv(acc, pa[kk], sw128_desc_mn(v_tile + kk * 16 * ROW_BYTES));
      if constexpr (T::TAIL) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_pv16(acc_t, pa[kk], sw32_desc(v_tail + kk * 16 * G_TAIL_BYTES));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (T::TAIL) fence_regs(acc_t);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));  // this warp is done with the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      if (row[r] >= n) continue;
      __nv_bfloat16* out = o + ((static_cast<size_t>(b) * n + row[r]) * heads + h) * D;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(out + j * 8 + tg * 2) =
            pack_bf16x2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      if constexpr (T::TAIL) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<uint32_t*>(out + 64 + j * 8 + tg * 2) =
              pack_bf16x2(acc_t[4 * j + 2 * r] * inv, acc_t[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

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

// (batch, heads, n, d) bf16 at strides `s` (elements) as boxes of `box_w`
// columns x G_BK rows with the given swizzle; rows past n read as zero.
cudaError_t make_map(CUtensorMap* map, const void* base, Strides s, int batch, int heads, int n, int d, int box_w,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.t) * 2, static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_w), G_BK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The head box (64 columns, 128-byte swizzle) and at D = 80 the tail box
// (16 columns from column 64, 32-byte swizzle) of one of q, k, v.
template <int D>
cudaError_t make_maps(CUtensorMap* head, CUtensorMap* tail, const void* base, Strides s, int batch, int heads,
                      int n) {
  cudaError_t err = make_map(head, base, s, batch, heads, n, D, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess && GTile<D>::TAIL)
    err = make_map(tail, base, s, batch, heads, n, D, 16, CU_TENSOR_MAP_SWIZZLE_32B);
  return err;
}

// The shared-memory allowance of global_kernel<REL_POS, D>, set once per device.
template <bool REL_POS, int D = 64>
cudaError_t global_smem_allowance() {
  static std::atomic<unsigned> smem_set{0};  // devices it may use its shared memory on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 32 || !(smem_set.load() >> dev & 1u))) {
    err = cudaFuncSetAttribute(global_kernel<REL_POS, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GTile<D>::SMEM);
    if (err == cudaSuccess && dev < 32) smem_set.fetch_or(1u << dev);
  }
  return err;
}

// global_kernel<REL_POS, D>'s blocks per SM (the occupancy calculator's).
template <bool REL_POS, int D = 64>
cudaError_t global_blocks_per_sm(int* per_sm) {
  cudaError_t err = global_smem_allowance<REL_POS, D>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, global_kernel<REL_POS, D>, G_THREADS, GTile<D>::SMEM);
  return err;
}

template <bool REL_POS, int D = 64>
int launch_global(const void* q, const void* k, const void* v, const void* bias_h, const void* bias_w, void* o,
                  Strides sq, Strides sk, Strides sv, int b, int h, int n, int grid_h, int causal, float scale,
                  cudaStream_t stream) {
  Maps<D> maps;
  CUtensorMap tails[3];
  cudaError_t err = make_maps<D>(&maps.q, &tails[0], q, sq, b, h, n);
  if (err == cudaSuccess) err = make_maps<D>(&maps.k, &tails[1], k, sk, b, h, n);
  if (err == cudaSuccess) err = make_maps<D>(&maps.v, &tails[2], v, sv, b, h, n);
  if (err == cudaSuccess) err = global_smem_allowance<REL_POS, D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (GTile<D>::TAIL) {
    maps.q_tail = tails[0];
    maps.k_tail = tails[1];
    maps.v_tail = tails[2];
  }
  const int q_tiles = (n + G_BQ - 1) / G_BQ;
  const dim3 grid = REL_POS ? dim3(q_tiles, b * h) : dim3(b * h, q_tiles);
  global_kernel<REL_POS, D><<<grid, G_THREADS, GTile<D>::SMEM, stream>>>(
      maps, static_cast<const float*>(bias_h), static_cast<const float*>(bias_w), static_cast<__nv_bfloat16*>(o),
      h, n, grid_h, causal, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The general kernels: K1 and K2 for every input the tensor-core kernels
// above do not take (float32, head dims other than 64 and 80, a causal
// layer at 80, K1's other grids).  G1 (bf16) and G2 (float32) share one
// skeleton, gen_body, and differ in their products.
// ---------------------------------------------------------------------------

constexpr int GEN_BQ = 64;                   // queries a block: four warps of 16; ops/flash_attention.py has a copy
constexpr int GEN_WARPS = 4;
constexpr int GEN_THREADS = GEN_WARPS * 32;
constexpr int GEN_STAGES = 2;                // the K/V ring; ops/flash_attention.py has a copy
constexpr int GEN_D_MAX = 128;               // largest head dim; ops/flash_attention.py has a copy
constexpr int GEN_BIAS_HW_MAX = 128;         // largest grid_h + grid_w whose bias rows a block stages
constexpr int GEN_GRID_MAX = 65535;          // largest grid_h or grid_w (a key's (ky, kx) is two 16-bit halves)

// One instantiation's layout.  DM: the head dim rounded up to 16 (the
// padding is zeros).  Rows in shared memory are PITCH elements apart: bf16
// DM + 8 (an odd number of 16-byte chunks, so the 8 rows an ldmatrix reads
// hit 8 groups of 4 banks), float32 DM + 4 (4 or 20 words modulo 32, so a
// fragment's 32 lanes read 32 banks: rows g at column tg for K and Q, rows
// 2 tg and 2 tg + 1 at column g for V).
template <typename T, int DM>
struct GenCfg {
  static_assert(DM % 16 == 0 && DM >= 16 && DM <= GEN_D_MAX, "DM is a multiple of 16 up to GEN_D_MAX");
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte chunk
  static constexpr int BK = (F32 && DM > 64) ? 32 : 64;       // keys a tile; ops/flash_attention.py has a copy
  static constexpr int PITCH = DM + VEC;
  static constexpr bool Q_SMEM = F32 && DM > 64;  // G2 keeps Q's TF32 halves in shared memory above 64
  static constexpr int TILE = BK * PITCH * static_cast<int>(sizeof(T));  // bytes of a K or V tile
  static constexpr int STAGE = 2 * TILE + BK * 4;                       // K, V and the tile's (ky, kx) table
  static constexpr int Q_BYTES = Q_SMEM ? 2 * GEN_BQ * PITCH * 4 : 0;   // Q's hi and lo
  // without Q_SMEM, Q is staged once in the second stage before the key loop
  static_assert(Q_SMEM || BK * PITCH >= GEN_BQ * PITCH, "Q fits a stage's K tile");
};

// Shared memory of a general launch: the K/V ring, Q's halves (G2 above DM
// = 64) and, for a K1 grid (grid_h, grid_w) that the block stages (grid_h +
// grid_w <= GEN_BIAS_HW_MAX; else 0, 0), its bias rows, each padded to an
// odd number of words (`bias_pitch`) so that the 8 rows a fragment's lanes
// read at one column hit 8 banks.
__host__ __device__ constexpr int bias_pitch(int n) { return n | 1; }
template <typename T, int DM>
__host__ __device__ constexpr size_t gen_smem(int grid_h, int grid_w) {
  return static_cast<size_t>(GEN_STAGES) * GenCfg<T, DM>::STAGE + GenCfg<T, DM>::Q_BYTES +
         (grid_h + grid_w ? static_cast<size_t>(GEN_BQ) * (bias_pitch(grid_h) + bias_pitch(grid_w)) * 4 : 0);
}
// The most a launch with staged bias rows takes: two even sides summing to
// GEN_BIAS_HW_MAX pad to GEN_BIAS_HW_MAX + 2 words a row, as (GEN_BIAS_HW_MAX, 1) does.
template <typename T, int DM>
__host__ __device__ constexpr size_t gen_smem_most() {
  return gen_smem<T, DM>(GEN_BIAS_HW_MAX, 1);
}
static_assert(gen_smem_most<float, GEN_D_MAX>() <= 232448, "G2's largest launch fits a block");
static_assert(gen_smem_most<__nv_bfloat16, GEN_D_MAX>() <= 232448, "G1's largest launch fits a block");

__device__ __forceinline__ void mma_1688_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi = x rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds, but by two integer operations: a conversion
// instruction issues at a quarter of the integer rate, 16 results a clock
// an SM against 64, and with two a value bounded the kernel), lo = x - hi
// exactly, which the tensor cores read truncated to TF32.  hi.hi + hi.lo +
// lo.hi then keeps a product to about 2^-21.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// acc += A B in 3xTF32: the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_1688_tf32(d, al, bh0, bh1);
  mma_1688_tf32(d, ah, bl0, bl1);
  mma_1688_tf32(d, ah, bh0, bh1);
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
// (0: nothing is read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// Rows [r0, r0 + R) of a (t, d) panel at token stride `st` into R shared
// rows at GenCfg's pitch (DM columns): rows at or past t and columns at or
// past d become zeros.  ALIGNED (the panel's start and token stride are
// multiples of 16 bytes): 16-byte cp.async, the row's last chunk reading
// only its columns below d; else one element a load, stored at once.
template <typename T, int DM, int R, bool ALIGNED>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, long long st, int r0, int t, int d) {
  constexpr int P = GenCfg<T, DM>::PITCH;
  if constexpr (ALIGNED) {
    constexpr int E = GenCfg<T, DM>::VEC;
    constexpr int C = DM / E;  // chunks a row
    for (int i = threadIdx.x; i < R * C; i += GEN_THREADS) {
      const int r = i / C, col = (i % C) * E, row = r0 + r;
      const int bytes = row < t && col < d ? min(E, d - col) * static_cast<int>(sizeof(T)) : 0;
      cp_async16_zfill(smem_u32(dst + r * P + col), bytes ? src + row * st + col : src, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < R * DM; i += GEN_THREADS) {
      const int r = i / DM, c = i % DM, row = r0 + r;
      dst[r * P + c] = row < t && c < d ? src[row * st + c] : zero<T>();
    }
  }
}

// A warp's Q: G1's bf16 A fragments (DM / 16 k16 steps), G2's TF32 halves
// (DM / 8 k8 steps) in registers, or nothing (G2 above 64: shared memory).
template <typename T, int DM, bool SMEM = GenCfg<T, DM>::Q_SMEM>
struct GenQ;
template <int DM>
struct GenQ<__nv_bfloat16, DM, false> {
  uint32_t a[DM / 16][4];
};
template <int DM>
struct GenQ<float, DM, false> {
  uint32_t hi[DM / 8][4], lo[DM / 8][4];
};
template <int DM>
struct GenQ<float, DM, true> {};

// S = Q K^T for one key tile (BK / 8 n8 groups) from the staged K.
// G1: mma.sync m16n8k16 bf16, K's B fragments by ldmatrix (x4: two k16
// steps; x2: an odd last step).  G2: m16n8k8 in 3xTF32, K's fragments read
// as float32 and split; Q's halves from registers or shared memory (rows
// `qrow`, the warp's first, of `qh` and `ql`).
template <typename T, int DM>
__device__ __forceinline__ void gen_scores(float (&s)[GenCfg<T, DM>::BK / 8][4], const GenQ<T, DM>& qf, const T* ks,
                                           const float* qh, const float* ql, int qrow) {
  using C = GenCfg<T, DM>;
  constexpr int NG = C::BK / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < NG; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if constexpr (!C::F32) {
    const int k_row = lane & 7, k_chunk = lane >> 3;
    const uint32_t base = smem_u32(ks);
#pragma unroll
    for (int kp = 0; kp < DM / 32; ++kp) {
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        uint32_t kb[4];
        ldmatrix_x4(kb, base + ((j * 8 + k_row) * C::PITCH + (4 * kp + k_chunk) * 8) * 2);
        mma_16816(s[j], qf.a[2 * kp], kb[0], kb[1]);
        mma_16816(s[j], qf.a[2 * kp + 1], kb[2], kb[3]);
      }
    }
    if constexpr ((DM / 16) % 2) {
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        uint32_t kt[2];
        ldmatrix_x2(kt, base + ((j * 8 + k_row) * C::PITCH + (DM / 8 - 2 + (k_chunk & 1)) * 8) * 2);
        mma_16816(s[j], qf.a[DM / 16 - 1], kt[0], kt[1]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < DM / 8; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (C::Q_SMEM) {
        const int o = (qrow + g) * C::PITCH + kk * 8 + tg;
        ah[0] = __float_as_uint(qh[o]);
        ah[1] = __float_as_uint(qh[o + 8 * C::PITCH]);
        ah[2] = __float_as_uint(qh[o + 4]);
        ah[3] = __float_as_uint(qh[o + 8 * C::PITCH + 4]);
        al[0] = __float_as_uint(ql[o]);
        al[1] = __float_as_uint(ql[o + 8 * C::PITCH]);
        al[2] = __float_as_uint(ql[o + 4]);
        al[3] = __float_as_uint(ql[o + 8 * C::PITCH + 4]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qf.hi[kk][e];
          al[e] = qf.lo[kk][e];
        }
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const float* kr = reinterpret_cast<const float*>(ks) + (j * 8 + g) * C::PITCH + kk * 8 + tg;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kr[0], bh0, bl0);
        split_tf32(kr[4], bh1, bl1);
        mma_3xtf32(s[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// acc += P V for one key tile from the staged V, P in the score registers.
// G1: two adjacent S fragments are one bf16 A fragment (P rounded to bf16,
// as the tensor-core kernels round it), V's B fragments by ldmatrix.trans.
// G2: P stays float32 and is split like the other operands; the k8 step of
// n8 group j takes its keys in the order 2 tg, 2 tg + 1 (A's columns tg and
// tg + 4 are the S fragment's own two columns, so no shuffle), and V's B
// fragments read rows j * 8 + 2 tg and j * 8 + 2 tg + 1 to match.  `alpha`
// rescales each row's output before the tile's products are added.
template <typename T, int DM>
__device__ __forceinline__ void gen_pv(float (&acc)[DM / 8][4], const float (&alpha)[2],
                                       const float (&s)[GenCfg<T, DM>::BK / 8][4], const T* vs) {
  using C = GenCfg<T, DM>;
  constexpr int NG = C::BK / 8;
  const int lane = threadIdx.x & 31;
  if constexpr (!C::F32) {
#pragma unroll
    for (int j = 0; j < DM / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_chunk = lane >> 4;
    const uint32_t base = smem_u32(vs);
#pragma unroll
    for (int kg = 0; kg < NG / 2; ++kg) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kg][0], s[2 * kg][1]);
      pa[1] = pack_bf16x2(s[2 * kg][2], s[2 * kg][3]);
      pa[2] = pack_bf16x2(s[2 * kg + 1][0], s[2 * kg + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kg + 1][2], s[2 * kg + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DM / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, base + ((kg * 16 + v_row) * C::PITCH + (2 * dp + v_chunk) * 8) * 2);
        mma_16816(acc[2 * dp], pa, vb[0], vb[1]);
        mma_16816(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  } else {
    // the tile's products summed apart and added to acc by one IEEE FADD a
    // tile: the tensor cores' float32 sums do not round to nearest, and a
    // running sum over a long key loop would carry their error from tile to
    // tile
    const int g = lane >> 2, tg = lane & 3;
    float part[DM / 8][4];
#pragma unroll
    for (int nt = 0; nt < DM / 8; ++nt) part[nt][0] = part[nt][1] = part[nt][2] = part[nt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);  // (row g, key 2 tg): A's (g, tg)
      split_tf32(s[j][2], ph[1], pl[1]);  // (row g + 8, key 2 tg)
      split_tf32(s[j][1], ph[2], pl[2]);  // (row g, key 2 tg + 1): A's (g, tg + 4)
      split_tf32(s[j][3], ph[3], pl[3]);  // (row g + 8, key 2 tg + 1)
      const float* vr = reinterpret_cast<const float*>(vs) + (j * 8 + 2 * tg) * C::PITCH + g;
#pragma unroll
      for (int nt = 0; nt < DM / 8; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vr[nt * 8], bh0, bl0);
        split_tf32(vr[nt * 8 + C::PITCH], bh1, bl1);
        mma_3xtf32(part[nt], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < DM / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = fmaf(acc[nt][e], alpha[e >> 1], part[nt][e]);
  }
}

// s = s * scale + bias_h[row, ky] + bias_w[row, kx] for one key tile, (ky,
// kx) of each key from the tile's table; bh and bw this thread's first row
// of each, the second `dh` and `dw` floats on.
template <int NG>
__device__ __forceinline__ void add_bias(float (&s)[NG][4], const uint32_t* tab, float scale, const float* bh,
                                         const float* bw, long long dh, long long dw) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const uint2 e = *reinterpret_cast<const uint2*>(tab + j * 8 + tg * 2);  // keys 2 tg, 2 tg + 1
    const int y0 = e.x & 0xffffu, x0 = e.x >> 16, y1 = e.y & 0xffffu, x1 = e.y >> 16;
    s[j][0] = fmaf(s[j][0], scale, bh[y0] + bw[x0]);
    s[j][1] = fmaf(s[j][1], scale, bh[y1] + bw[x1]);
    s[j][2] = fmaf(s[j][2], scale, bh[dh + y0] + bw[dw + x0]);
    s[j][3] = fmaf(s[j][3], scale, bh[dh + y1] + bw[dw + x1]);
  }
}

// q (B, H, T, d), k and v (B, H, TK, d) of T (bf16 or float) at the given
// strides, last dim contiguous; o (B, T, H, d), contiguous.  TK == T but in
// K2's pooled-query launches (fewer queries than keys, no bias, no mask).
// Block (x, y): head x = b * H + h, query tile y of GEN_BQ rows (with causal
// the heaviest, last, tile first); warp w owns rows 16 w .. 16 w + 15 of it.  The key tiles stream
// through a GEN_STAGES-deep ring: tile i + 1 is in flight while tile i is
// computed, one barrier a tile.  REL_POS adds bias_h[q, ky] + bias_w[q, kx]
// on any grid, (ky, kx) from a per-tile table; the block's 64 bias rows sit
// in shared memory for h + w <= GEN_BIAS_HW_MAX, else they are read through
// L1.  Only a tile with the ragged key edge or (causal) keys past a warp's
// first row is masked per element; with causal the key loop ends at the
// block's diagonal, and a warp skips a tile wholly past its rows.
template <typename T, bool REL_POS, bool CAUSAL, int DM, bool ALIGNED>
__device__ __forceinline__ void gen_body(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                         T* __restrict__ o, Strides sq, Strides sk, Strides sv, int heads, int t,
                                         int tk, int d, float scale, RelPos rp) {
  static_assert(!(REL_POS && CAUSAL), "the bias and the causal mask never meet");
  using C = GenCfg<T, DM>;
  constexpr int BK = C::BK, NG = BK / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto stage_k = [&](int s) { return reinterpret_cast<T*>(smem_raw + s * C::STAGE); };
  auto stage_v = [&](int s) { return reinterpret_cast<T*>(smem_raw + s * C::STAGE + C::TILE); };
  auto stage_tab = [&](int s) { return reinterpret_cast<uint32_t*>(smem_raw + s * C::STAGE + 2 * C::TILE); };
  float* qh = reinterpret_cast<float*>(smem_raw + GEN_STAGES * C::STAGE);  // Q_SMEM: Q's hi, then lo
  float* ql = qh + GEN_BQ * C::PITCH;
  float* bias_rows = reinterpret_cast<float*>(smem_raw + GEN_STAGES * C::STAGE + C::Q_BYTES);

  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * GEN_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const int key_end = CAUSAL ? min(t, q0 + GEN_BQ) : tk;
  const int tiles = (key_end + BK - 1) / BK;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;

  const bool staged_bias = REL_POS && rp.grid_h + rp.grid_w <= GEN_BIAS_HW_MAX;
  const int ph = bias_pitch(rp.grid_h), pw = bias_pitch(rp.grid_w);
  auto stage_tile = [&](int i) {
    const int s = i % GEN_STAGES, key0 = i * BK;
    stage_rows<T, DM, BK, ALIGNED>(stage_k(s), k, sk.t, key0, tk, d);
    stage_rows<T, DM, BK, ALIGNED>(stage_v(s), v, sv.t, key0, tk, d);
    if constexpr (REL_POS) {
      if (threadIdx.x < BK) {
        const int key = key0 + threadIdx.x, ky = key / rp.grid_w;
        stage_tab(s)[threadIdx.x] =
            key < tk ? static_cast<uint32_t>(ky) | static_cast<uint32_t>(key - ky * rp.grid_w) << 16 : 0u;
      }
    }
  };

  // the prologue: key tile 0, Q (in the second stage, or its own panels),
  // and the block's bias rows, in one commit group
  stage_tile(0);
  stage_rows<T, DM, GEN_BQ, ALIGNED>(C::Q_SMEM ? reinterpret_cast<T*>(qh) : stage_k(1), q, sq.t, q0, t, d);
  if constexpr (REL_POS) {
    if (staged_bias) {  // rows past t repeat row t - 1 and are not stored
      const size_t row0 = static_cast<size_t>(bh) * t;
      for (int i = threadIdx.x; i < GEN_BQ * rp.grid_h; i += GEN_THREADS) {
        const int r = i / rp.grid_h, c = i - r * rp.grid_h;
        cp_async4(smem_u32(bias_rows + r * ph + c), rp.bias_h + (row0 + min(q0 + r, t - 1)) * rp.grid_h + c, true);
      }
      float* bw = bias_rows + GEN_BQ * ph;
      for (int i = threadIdx.x; i < GEN_BQ * rp.grid_w; i += GEN_THREADS) {
        const int r = i / rp.grid_w, c = i - r * rp.grid_w;
        cp_async4(smem_u32(bw + r * pw + c), rp.bias_w + (row0 + min(q0 + r, t - 1)) * rp.grid_w + c, true);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  GenQ<T, DM> qf;
  if constexpr (!C::F32) {  // A fragments by ldmatrix from the staged rows
    const uint32_t base = smem_u32(stage_k(1));
    const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, chunk = lane >> 4;
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) ldmatrix_x4(qf.a[kk], base + (row * C::PITCH + (2 * kk + chunk) * 8) * 2);
  } else if constexpr (!C::Q_SMEM) {
    const float* qs = reinterpret_cast<const float*>(stage_k(1)) + (warp * 16 + g) * C::PITCH + tg;
#pragma unroll
    for (int kk = 0; kk < DM / 8; ++kk) {
      split_tf32(qs[kk * 8], qf.hi[kk][0], qf.lo[kk][0]);
      split_tf32(qs[kk * 8 + 8 * C::PITCH], qf.hi[kk][1], qf.lo[kk][1]);
      split_tf32(qs[kk * 8 + 4], qf.hi[kk][2], qf.lo[kk][2]);
      split_tf32(qs[kk * 8 + 8 * C::PITCH + 4], qf.hi[kk][3], qf.lo[kk][3]);
    }
  } else {  // split in place: qh keeps the high halves, ql the low
    for (int i = threadIdx.x; i < GEN_BQ * C::PITCH; i += GEN_THREADS) {
      uint32_t hi, lo;
      split_tf32(qh[i], hi, lo);
      qh[i] = __uint_as_float(hi);
      ql[i] = __uint_as_float(lo);
    }
  }
  __syncthreads();  // Q has left the second stage (or is split) before tile 1 lands there

  // this thread's two bias rows: in the block's staged rows, or in device
  // memory (rows past t read row t - 1 and are not stored)
  const int srow = warp * 16 + g;
  const size_t grow0 = static_cast<size_t>(bh) * t + min(r0, t - 1);
  const size_t grow1 = static_cast<size_t>(bh) * t + min(r0 + 8, t - 1);

  float acc[DM / 8][4];
#pragma unroll
  for (int j = 0; j < DM / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // running max; this thread's partial sums
  const float sc = REL_POS ? LOG2E : scale * LOG2E;     // scores to log2 units
  const int warp_row = q0 + warp * 16;                  // the warp's first row

  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) stage_tile(i + 1);
    cp_async_commit();
    const int s = i % GEN_STAGES, key0 = i * BK;
    if (!CAUSAL || key0 <= warp_row + 15) {  // a tile wholly past the warp's rows adds nothing
      float sf[NG][4];
      gen_scores<T, DM>(sf, qf, stage_k(s), qh, ql, warp * 16);
      if constexpr (REL_POS) {
        // two branches, so that each reads its rows as shared or global
        // memory (a pointer that may be either costs a generic load)
        if (staged_bias) {
          const float* sbh = bias_rows + srow * ph;
          const float* sbw = bias_rows + GEN_BQ * ph + srow * pw;
          add_bias<NG>(sf, stage_tab(s), scale, sbh, sbw, 8 * ph, 8 * pw);
        } else {
          add_bias<NG>(sf, stage_tab(s), scale, rp.bias_h + grow0 * rp.grid_h, rp.bias_w + grow0 * rp.grid_w,
                       static_cast<long long>(grow1 - grow0) * rp.grid_h,
                       static_cast<long long>(grow1 - grow0) * rp.grid_w);
        }
      }
      if (key0 + BK > tk || (CAUSAL && key0 + BK - 1 > warp_row)) {  // keys past tk, or past a row
#pragma unroll
        for (int j = 0; j < NG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + j * 8 + tg * 2 + (e & 1);
            if (key >= tk || (CAUSAL && key > r0 + 8 * (e >> 1))) sf[j][e] = NEG_INF;
          }
      }
      // the online softmax in log2 units: one FFMA and one ex2 a score
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sf[j][e]);
      float alpha[2], shift[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2((m[r] - mx[r]) * sc);
        m[r] = mx[r];
        l[r] *= alpha[r];
        shift[r] = -mx[r] * sc;
      }
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(sf[j][e], sc, shift[e >> 1]));
          sf[j][e] = p;
          l[e >> 1] += p;
        }
      gen_pv<T, DM>(acc, alpha, sf, stage_v(s));
    }
    cp_async_wait<0>();
    __syncthreads();  // tile i + 1 has landed; every warp is done with stage s
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    inv[r] = 1.f / fmaxf(x, 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= t) continue;
    T* out = o + ((static_cast<size_t>(b) * t + row) * heads + h) * d;
#pragma unroll
    for (int j = 0; j < DM / 8; ++j) {
      const int col = j * 8 + tg * 2;
      const float x0 = acc[j][2 * r] * inv[r], x1 = acc[j][2 * r + 1] * inv[r];
      if (col + 1 < d && (d & 1) == 0) {  // an aligned pair
        if constexpr (C::F32)
          *reinterpret_cast<float2*>(out + col) = make_float2(x0, x1);
        else
          *reinterpret_cast<uint32_t*>(out + col) = pack_bf16x2(x0, x1);
      } else {
        if (col < d) out[col] = static_cast<T>(x0);
        if (col + 1 < d) out[col + 1] = static_cast<T>(x1);
      }
    }
  }
}

// G1 (bf16) is built for 4 blocks an SM at head dim 16 (at most 128
// registers a thread), 3 through 64 and 2 above, where fewer registers
// would spill; G2 (float32) for 2 (its shared memory allows no more with the
// bias staged).
constexpr int G2_MIN_BLOCKS = 2;

template <bool REL_POS, bool CAUSAL, int DM, bool ALIGNED>
__global__ void __launch_bounds__(GEN_THREADS, DM == 16 ? 4 : DM <= 64 ? 3 : 2)
g1_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Strides sq, Strides sk,
               Strides sv, int heads, int t, int tk, int d, float scale, RelPos rp) {
  gen_body<__nv_bfloat16, REL_POS, CAUSAL, DM, ALIGNED>(q, k, v, o, sq, sk, sv, heads, t, tk, d, scale, rp);
}

template <bool REL_POS, bool CAUSAL, int DM, bool ALIGNED>
__global__ void __launch_bounds__(GEN_THREADS, G2_MIN_BLOCKS)
g2_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, Strides sq, Strides sk, Strides sv, int heads, int t, int tk, int d,
                 float scale, RelPos rp) {
  gen_body<float, REL_POS, CAUSAL, DM, ALIGNED>(q, k, v, o, sq, sk, sv, heads, t, tk, d, scale, rp);
}

template <typename T, bool REL_POS, bool CAUSAL, int DM, bool ALIGNED>
auto gen_kernel() {
  if constexpr (sizeof(T) == 4)
    return g2_tf32x3_kernel<REL_POS, CAUSAL, DM, ALIGNED>;
  else
    return g1_bf16_kernel<REL_POS, CAUSAL, DM, ALIGNED>;
}

// The general launch's shared memory, set as the kernel's allowance once a
// device (for the instantiation's largest launch).
template <typename T, bool REL_POS, bool CAUSAL, int DM, bool ALIGNED>
cudaError_t gen_allow(size_t* smem, int grid_h, int grid_w) {
  const bool staged = REL_POS && grid_h + grid_w <= GEN_BIAS_HW_MAX;
  *smem = staged ? gen_smem<T, DM>(grid_h, grid_w) : gen_smem<T, DM>(0, 0);
  static std::atomic<unsigned> allowed{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (allowed.load() >> dev & 1u)) return err;
  const size_t most = REL_POS ? gen_smem_most<T, DM>() : gen_smem<T, DM>(0, 0);
  err = cudaFuncSetAttribute(gen_kernel<T, REL_POS, CAUSAL, DM, ALIGNED>(),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
  if (err == cudaSuccess) allowed.fetch_or(1u << dev);
  return err;
}

template <typename T, bool REL_POS, bool CAUSAL, int DM, bool ALIGNED>
int launch_gen(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk, Strides sv, int b,
               int h, int t, int tk, int d, float scale, RelPos rp, cudaStream_t stream) {
  size_t smem = 0;
  const cudaError_t err = gen_allow<T, REL_POS, CAUSAL, DM, ALIGNED>(&smem, rp.grid_h, rp.grid_w);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (t + GEN_BQ - 1) / GEN_BQ);
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k), *vt = static_cast<const T*>(v);
  if constexpr (sizeof(T) == 4)
    g2_tf32x3_kernel<REL_POS, CAUSAL, DM, ALIGNED><<<grid, GEN_THREADS, smem, stream>>>(
        qt, kt, vt, static_cast<T*>(o), sq, sk, sv, h, t, tk, d, scale, rp);
  else
    g1_bf16_kernel<REL_POS, CAUSAL, DM, ALIGNED><<<grid, GEN_THREADS, smem, stream>>>(
        qt, kt, vt, static_cast<T*>(o), sq, sk, sv, h, t, tk, d, scale, rp);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for a head dim: DM = d rounded up to 16.
template <typename T, bool REL_POS, bool CAUSAL, bool ALIGNED>
int launch_gen_d(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk, Strides sv, int b,
                 int h, int t, int tk, int d, float scale, RelPos rp, cudaStream_t stream) {
#define HA_GEN_DM(DM)                                                                                          \
  case DM:                                                                                                     \
    return launch_gen<T, REL_POS, CAUSAL, DM, ALIGNED>(q, k, v, o, sq, sk, sv, b, h, t, tk, d, scale, rp, stream);
  switch ((d + 15) & ~15) {
    HA_GEN_DM(16)
    HA_GEN_DM(32)
    HA_GEN_DM(48)
    HA_GEN_DM(64)
    HA_GEN_DM(80)
    HA_GEN_DM(96)
    HA_GEN_DM(112)
    HA_GEN_DM(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HA_GEN_DM
}

template <typename T>
int launch_gen_any(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk, Strides sv, int b,
                   int h, int t, int tk, int d, int causal, bool aligned, float scale, RelPos rp,
                   cudaStream_t stream) {
  if (rp.bias_h != nullptr)
    return aligned ? launch_gen_d<T, true, false, true>(q, k, v, o, sq, sk, sv, b, h, t, tk, d, scale, rp, stream)
                   : launch_gen_d<T, true, false, false>(q, k, v, o, sq, sk, sv, b, h, t, tk, d, scale, rp, stream);
  if (causal)
    return aligned ? launch_gen_d<T, false, true, true>(q, k, v, o, sq, sk, sv, b, h, t, tk, d, scale, rp, stream)
                   : launch_gen_d<T, false, true, false>(q, k, v, o, sq, sk, sv, b, h, t, tk, d, scale, rp, stream);
  return aligned ? launch_gen_d<T, false, false, true>(q, k, v, o, sq, sk, sv, b, h, t, tk, d, scale, rp, stream)
                 : launch_gen_d<T, false, false, false>(q, k, v, o, sq, sk, sv, b, h, t, tk, d, scale, rp, stream);
}

// Whether every panel a general launch reads may be staged by 16-byte
// copies: q, k and v start on 16 bytes and every stride is a multiple of
// 16 bytes.
bool gen_aligned(const void* q, const void* k, const void* v, Strides sq, Strides sk, Strides sv, int elem) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (const Strides& s : {sq, sk, sv})
    if ((s.b * elem) % 16 || (s.h * elem) % 16 || (s.t * elem) % 16) return false;
  return true;
}

// The plan of a general launch into out[0..9]: blocks per head, blocks,
// blocks per SM (the occupancy calculator's), SMs, registers a thread,
// shared memory a block (bytes), the blocks per SM its registers alone and
// its shared memory alone allow, DM, keys a tile.
template <typename T, bool REL_POS, bool CAUSAL, int DM>
cudaError_t gen_report(int bh, int t, int grid_h, int grid_w, int* out) {
  const auto kernel = gen_kernel<T, REL_POS, CAUSAL, DM, true>();
  size_t smem = 0;
  cudaFuncAttributes attr;
  int dev = 0, sms = 0, per_sm = 0, by_regs = 0, smem_per_sm = 0, reserved = 0;
  cudaError_t err = gen_allow<T, REL_POS, CAUSAL, DM, true>(&smem, grid_h, grid_w);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GEN_THREADS, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&by_regs, kernel, GEN_THREADS, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (t + GEN_BQ - 1) / GEN_BQ;
  const int report[10] = {tiles, tiles * bh, per_sm, sms, attr.numRegs, static_cast<int>(smem), by_regs,
                          smem_per_sm / (static_cast<int>(smem) + reserved), DM, GenCfg<T, DM>::BK};
  for (int i = 0; i < 10; ++i) out[i] = report[i];
  return cudaSuccess;
}

template <typename T, bool REL_POS, bool CAUSAL>
cudaError_t gen_report_d(int bh, int t, int d, int grid_h, int grid_w, int* out) {
  switch ((d + 15) & ~15) {
    case 16: return gen_report<T, REL_POS, CAUSAL, 16>(bh, t, grid_h, grid_w, out);
    case 32: return gen_report<T, REL_POS, CAUSAL, 32>(bh, t, grid_h, grid_w, out);
    case 48: return gen_report<T, REL_POS, CAUSAL, 48>(bh, t, grid_h, grid_w, out);
    case 64: return gen_report<T, REL_POS, CAUSAL, 64>(bh, t, grid_h, grid_w, out);
    case 80: return gen_report<T, REL_POS, CAUSAL, 80>(bh, t, grid_h, grid_w, out);
    case 96: return gen_report<T, REL_POS, CAUSAL, 96>(bh, t, grid_h, grid_w, out);
    case 112: return gen_report<T, REL_POS, CAUSAL, 112>(bh, t, grid_h, grid_w, out);
    case 128: return gen_report<T, REL_POS, CAUSAL, 128>(bh, t, grid_h, grid_w, out);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t gen_report_any(int bh, int t, int d, int grid_h, int grid_w, int causal, int* out) {
  if (grid_h + grid_w) return gen_report_d<T, true, false>(bh, t, d, grid_h, grid_w, out);
  return causal ? gen_report_d<T, false, true>(bh, t, d, 0, 0, out) : gen_report_d<T, false, false>(bh, t, d, 0, 0, out);
}

}  // namespace

// K1's tensor-core routes: q, k, v (b, h, n, d) bf16 at strides s*_b,
// s*_h, s*_t (elements; multiples of 8, starts 16-byte aligned), d = 64 or
// 80; bias_h (b*h, n, grid_h) and bias_w (b*h, n, grid_w) f32, contiguous;
// o (b, n, h, d) bf16, contiguous; n == grid_h * grid_w.  n <= T_MAX: the
// resident kernel with the bias, for grid_h + grid_w <= RES_HW_MAX; else the
// global kernel, which takes grid_w == 64 only (any other grid takes
// ha_flash_attention_general).  Returns the cudaError_t of the launch.
extern "C" int ha_flash_attention_2d(const void* q, const void* k, const void* v, const void* bias_h,
                                     const void* bias_w, void* o, long long sq_b, long long sq_h, long long sq_t,
                                     long long sk_b, long long sk_h, long long sk_t, long long sv_b,
                                     long long sv_h, long long sv_t, int b, int h, int n, int d, int grid_h,
                                     int grid_w, float scale, void* stream) {
  if ((d != 64 && d != HEAD_DIM_WIDE) || n <= 0 || b <= 0 || h <= 0 || b * h > 65535 || grid_h <= 0 ||
      grid_w <= 0 || static_cast<long long>(grid_h) * grid_w != n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, sq_h, sq_t}, sk{sk_b, sk_h, sk_t}, sv{sv_b, sv_h, sv_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= T_MAX) {
    if (grid_h + grid_w > RES_HW_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const RelPos rp{static_cast<const float*>(bias_h), static_cast<const float*>(bias_w), grid_h, grid_w};
    return d == 64 ? launch_resident<true, false>(q, k, v, o, sq, sk, sv, b, h, n, scale, rp, s)
                   : launch_resident<true, false, HEAD_DIM_WIDE>(q, k, v, o, sq, sk, sv, b, h, n, scale, rp, s);
  }
  if (grid_w != G_W) return static_cast<int>(cudaErrorInvalidValue);
  return d == 64 ? launch_global<true>(q, k, v, bias_h, bias_w, o, sq, sk, sv, b, h, n, grid_h, 0, scale, s)
                 : launch_global<true, HEAD_DIM_WIDE>(q, k, v, bias_h, bias_w, o, sq, sk, sv, b, h, n, grid_h, 0,
                                                      scale, s);
}

// K2's two tensor-core routes, each with the same arguments: q, k, v (b, h,
// t, d) bf16 at strides s*_b, s*_h, s*_t (elements; multiples of 8, starts
// 16-byte aligned), d = 64, or 80 without causal (no model of the repo has a
// causal layer at 80: ops/flash_attention.py sends one to
// ha_flash_attention_general); o (b, t, h, d) bf16, contiguous; causal != 0
// masks key > query.  Each returns the cudaError_t of the launch.
// t <= T_MAX: the resident kernel.
extern "C" int ha_flash_attention_resident(const void* q, const void* k, const void* v, void* o,
                                           long long sq_b, long long sq_h, long long sq_t, long long sk_b,
                                           long long sk_h, long long sk_t, long long sv_b, long long sv_h,
                                           long long sv_t, int b, int h, int t, int d, int causal, float scale,
                                           void* stream) {
  if (!(d == 64 || (d == HEAD_DIM_WIDE && !causal)) || t <= 0 || t > T_MAX || b <= 0 || h <= 0 || b * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, sq_h, sq_t}, sk{sk_b, sk_h, sk_t}, sv{sv_b, sv_h, sv_t};
  const RelPos none{nullptr, nullptr, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == HEAD_DIM_WIDE)
    return launch_resident<false, false, HEAD_DIM_WIDE>(q, k, v, o, sq, sk, sv, b, h, t, scale, none, s);
  return causal ? launch_resident<false, true>(q, k, v, o, sq, sk, sv, b, h, t, scale, none, s)
                : launch_resident<false, false>(q, k, v, o, sq, sk, sv, b, h, t, scale, none, s);
}

// t > T_MAX: the global kernel without the bias.
extern "C" int ha_flash_attention_long(const void* q, const void* k, const void* v, void* o, long long sq_b,
                                       long long sq_h, long long sq_t, long long sk_b, long long sk_h,
                                       long long sk_t, long long sv_b, long long sv_h, long long sv_t, int b, int h,
                                       int t, int d, int causal, float scale, void* stream) {
  if (!(d == 64 || (d == HEAD_DIM_WIDE && !causal)) || t <= T_MAX || b <= 0 || h <= 0 ||
      (t + G_BQ - 1) / G_BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, sq_h, sq_t}, sk{sk_b, sk_h, sk_t}, sv{sv_b, sv_h, sv_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_global<false>(q, k, v, nullptr, nullptr, o, sq, sk, sv, b, h, t, 0, causal != 0, scale, s)
                 : launch_global<false, HEAD_DIM_WIDE>(q, k, v, nullptr, nullptr, o, sq, sk, sv, b, h, t, 0, 0,
                                                       scale, s);
}

// K1's and K2's general route, every input the tensor-core routes do not
// take: q (b, h, t, d), k and v (b, h, tk, d), float32 (bf16 == 0: G2) or
// bf16 (bf16 != 0: G1) at element strides s*_b, s*_h, s*_t (last dim
// contiguous; any alignment: where q, k, v start on 16 bytes and every
// stride is a multiple of 16 bytes the tiles are staged by 16-byte
// cp.async, else element by element), 1 <= d <= GEN_D_MAX; o (b, t, h, d)
// of the same type, contiguous.  tk == t but in K2's pooled-query launches
// (Hiera's stage transitions: fewer queries than keys, no bias, no mask).
// With bias_h non-null (K1): bias_h (b*h, t, grid_h) and bias_w (b*h, t,
// grid_w) f32, contiguous, t == grid_h * grid_w, any grid up to
// GEN_GRID_MAX a side, causal 0.  Without (K2): causal != 0 masks key >
// query.  Returns the cudaError_t of the launch.
extern "C" int ha_flash_attention_general(const void* q, const void* k, const void* v, const void* bias_h,
                                          const void* bias_w, void* o, long long sq_b, long long sq_h,
                                          long long sq_t, long long sk_b, long long sk_h, long long sk_t,
                                          long long sv_b, long long sv_h, long long sv_t, int b, int h, int t, int tk,
                                          int d, int grid_h, int grid_w, int causal, int bf16, float scale,
                                          void* stream) {
  const bool rel_pos = bias_h != nullptr;
  if (d <= 0 || d > GEN_D_MAX || t <= 0 || tk <= 0 || b <= 0 || h <= 0 ||
      static_cast<long long>(b) * h > 0x7fffffff || (t + GEN_BQ - 1) / GEN_BQ > 65535 ||
      (tk != t && (rel_pos || causal)) ||
      (rel_pos && (causal || bias_w == nullptr || grid_h <= 0 || grid_w <= 0 || grid_h > GEN_GRID_MAX ||
                   grid_w > GEN_GRID_MAX || static_cast<long long>(grid_h) * grid_w != t)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sq_b, sq_h, sq_t}, sk{sk_b, sk_h, sk_t}, sv{sv_b, sv_h, sv_t};
  const RelPos rp = rel_pos ? RelPos{static_cast<const float*>(bias_h), static_cast<const float*>(bias_w), grid_h,
                                     grid_w}
                            : RelPos{nullptr, nullptr, 0, 0};
  const bool aligned = gen_aligned(q, k, v, sq, sk, sv, bf16 ? 2 : 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_gen_any<__nv_bfloat16>(q, k, v, o, sq, sk, sv, b, h, t, tk, d, causal, aligned, scale, rp, s)
              : launch_gen_any<float>(q, k, v, o, sq, sk, sv, b, h, t, tk, d, causal, aligned, scale, rp, s);
}

// The general route's plan for (bh heads, t tokens) at head dim d into
// out[0..9] (see gen_report), for the instantiation with 16-byte staging:
// grid_h, grid_w the K1 grid (0, 0 for K2); causal: K2's causal
// instantiation; bf16: G1, else G2.  Returns a cudaError_t.
extern "C" int ha_flash_attention_general_plan(int bh, int t, int d, int grid_h, int grid_w, int causal, int bf16,
                                               int* out) {
  if (bh <= 0 || t <= 0 || d <= 0 || d > GEN_D_MAX || grid_h < 0 || grid_w < 0 || ((grid_h + grid_w) && causal))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bf16 ? gen_report_any<__nv_bfloat16>(bh, t, d, grid_h, grid_w, causal, out)
                               : gen_report_any<float>(bh, t, d, grid_h, grid_w, causal, out));
}

// The resident kernel's plan for (bh heads, t tokens) into out[0..7] (see
// resident_report).  hw: grid_h + grid_w for K1 (the bias on), 0 for K2;
// causal: K2's causal instantiation; d: the head dim (64, or 80 without
// causal).  Returns a cudaError_t.
extern "C" int ha_flash_attention_plan(int bh, int t, int hw, int causal, int d, int* out) {
  if (t <= 0 || t > T_MAX || hw < 0 || hw > RES_HW_MAX || (hw && causal) ||
      !(d == 64 || (d == HEAD_DIM_WIDE && !causal)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = d == HEAD_DIM_WIDE;
  const cudaError_t err = hw ? (wide ? resident_report<true, false, HEAD_DIM_WIDE>(bh, t, hw, out)
                                     : resident_report<true, false>(bh, t, hw, out))
                          : wide   ? resident_report<false, false, HEAD_DIM_WIDE>(bh, t, 0, out)
                          : causal ? resident_report<false, true>(bh, t, 0, out)
                                   : resident_report<false, false>(bh, t, 0, out);
  return static_cast<int>(err);
}

// The global kernel's launch for (bh heads, n tokens), into out[0..3]:
// blocks per head, blocks, blocks per SM (the occupancy calculator's), SMs.
// rel_pos: K1's instantiation, else K2's; d: the head dim (64 or 80).
// Returns a cudaError_t.
extern "C" int ha_flash_attention_global_plan(int bh, int n, int rel_pos, int d, int* out) {
  if (n <= T_MAX || bh <= 0 || (d != 64 && d != HEAD_DIM_WIDE)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = rel_pos ? (d == 64 ? global_blocks_per_sm<true>(&per_sm) : global_blocks_per_sm<true, HEAD_DIM_WIDE>(&per_sm))
                  : (d == 64 ? global_blocks_per_sm<false>(&per_sm)
                             : global_blocks_per_sm<false, HEAD_DIM_WIDE>(&per_sm));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = (n + G_BQ - 1) / G_BQ;
  out[1] = out[0] * bh;
  out[2] = per_sm;
  out[3] = sms;
  return 0;
}
