// Greedy box NMS over a fixed candidate set for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the sequential `fori_loop` of holoagent_tpu/ops/masks.py::nms
// (no Pallas call there: XLA runs the loop on the TPU), which the port ran as
// a Python loop of a few small launches per candidate: 2,592 kernels and
// 2,176 views at SAM's 3 * 12^2 = 432 candidates a frame.  It computes, bit
// for bit, the keep mask of the plain version (ops/masks.py::nms_ref):
//   key[i]   = valid[i] ? -score[i] : +inf        the order: ascending key,
//              ties to the lower index (torch's stable argsort), every NaN
//              after every number, -0 equal to +0
//   iou(a,b) = inter / max(area_a + area_b - inter, f32(1e-9))   f32, as
//              ops/masks.py::box_iou, each operation rounded once (no FMA,
//              IEEE division)
//   keep[j]  = valid[j] and no earlier kept i has iou(i, j) > f32(thresh)
// Invalid candidates are never kept and suppress nothing.
//
// What bounds it on the H100.  Not bytes (21 a candidate in, 1 out: 9.5 KB at
// M = 432) nor arithmetic at the card's rate (M^2 / 2 IoUs: 93k at 432, 4.7M
// at 3,072), but latency: a launch, the IoUs on the SMs a launch can use, and
// the greedy scan, a chain through the candidates in order.  The design keeps
// the chain short and everything else parallel:
//   1. every candidate's sort key, as one 64-bit integer (the key's bits
//      made monotone, then the index), so ranks are unique;
//   2. each candidate's rank by counting the keys below its own (M^2
//      comparisons in parallel), and the boxes, validity and original index
//      scattered to sorted order;
//   3. the relation "sorted i suppresses sorted j > i" as a bit matrix of
//      ceil(M/64) 64-bit words a row, built in parallel (rows of invalid
//      candidates and words below the diagonal stay zero);
//   4. one warp scans the rows in order, 64 candidates a step, with the
//      removed set as words in shared memory: within a step the greedy
//      chain costs one shuffle a kept candidate (the step's diagonal words
//      sit in registers), then the kept rows are ORed into the later words
//      in parallel and the keep flags written back to the original indices.
// Up to BLOCK_MAX_M candidates (every points_per_side up to 18) all four run
// in one block of BLOCK_THREADS threads out of shared memory, one launch
// ("block").  Above it (SAM's own default, 32 points a side, is 3,072
// candidates) the same four phases run as four kernels over global scratch
// the wrapper allocates ("grid"); only the scan's removed set stays in
// shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int BLOCK_MAX_M = 1024;  // the one-block route's limit (ops/masks.py ONE_BLOCK_MAX_M)
constexpr int BLOCK_THREADS = 1024;
constexpr int GRID_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

constexpr __host__ __device__ size_t words(int m) { return (static_cast<size_t>(m) + 63) / 64; }

// Byte offsets of the sorted boxes, the keys, the bit matrix, the removed
// set, the original indices and the sorted validity: the block's shared
// memory, or (without the removed set) the grid route's scratch.
struct Layout {
  size_t box, key, mask, removed, order, valid, total;
};

constexpr __host__ __device__ Layout layout(int m) {
  const size_t n = static_cast<size_t>(m);
  const size_t box = 0, key = box + 16 * n, mask = key + 8 * n, removed = mask + 8 * n * words(m);
  const size_t order = removed + 8 * words(m), valid = order + 4 * n;
  return Layout{box, key, mask, removed, order, valid, (valid + n + 15) / 16 * 16};
}

static_assert(layout(BLOCK_MAX_M).total <= 232448, "the one-block route must fit a block's shared memory");

// torch.maximum / minimum / clamp: NaN in, NaN out (fmaxf would drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// iou(a, b) > thresh, with ops/masks.py::box_iou's operations in its order
// for one pair of [y0, x0, y1, x1] boxes.  Disjoint boxes skip the division:
// a zero intersection gives +-0 or NaN, above no threshold >= 0.
__device__ __forceinline__ bool iou_above(float4 a, float4 b, float thresh) {
  const float h = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float w = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(h, w);
  if (inter == 0.0f && thresh >= 0.0f) return false;
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  return __fdiv_rn(inter, max_nan(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f)) > thresh;
}

// Phase 1: the order of argsort(-where(valid, score, -inf), stable=True) as
// one integer a candidate.
__device__ void sort_keys(const float* score, const uint8_t* valid, uint64_t* key, int m, int first, int stride) {
  for (int i = first; i < m; i += stride) {
    const float k = valid[i] ? -score[i] : __int_as_float(0x7f800000);
    uint32_t u = __float_as_uint(k);
    if (k != k) {
      u = 0xffffffffu;  // NaN: after +inf, NaNs in index order
    } else {
      if (u == 0x80000000u) u = 0;  // -0 ties with +0
      u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    }
    key[i] = static_cast<uint64_t>(u) << 32 | static_cast<uint32_t>(i);
  }
}

// Phase 2: rank by counting, and scatter to sorted order.
__device__ void rank_scatter(const uint64_t* key, const float4* box, const uint8_t* valid, int m, float4* sbox,
                             int* order, uint8_t* svalid, int first, int stride) {
  for (int i = first; i < m; i += stride) {
    const uint64_t k = key[i];
    int r = 0;
    for (int j = 0; j < m; ++j) r += key[j] < k;
    sbox[r] = box[i];
    order[r] = i;
    svalid[r] = valid[i] != 0;
  }
}

// Phase 3: word x of sorted row r holds bit b iff j = 64 x + b > r and
// iou(r, j) > thresh; consecutive threads take consecutive rows of one word
// column, so they read the same box j together.
__device__ void build_mask(const float4* sbox, const uint8_t* svalid, uint64_t* mask, int m, float thresh,
                           size_t first, size_t stride) {
  const size_t w = words(m), n = static_cast<size_t>(m) * w;
  for (size_t item = first; item < n; item += stride) {
    const int x = static_cast<int>(item / m), r = static_cast<int>(item % m);
    uint64_t bits = 0;
    if (svalid[r] && 64 * x + 63 > r) {
      const float4 a = sbox[r];
      const int j1 = min(64 * x + 64, m);
      for (int j = max(64 * x, r + 1); j < j1; ++j)
        if (iou_above(a, sbox[j], thresh)) bits |= 1ull << (j - 64 * x);
    }
    mask[static_cast<size_t>(r) * w + x] = bits;
  }
}

// Phase 4, one warp: the greedy scan in sorted order, 64 candidates (one
// word) a step.  The warp holds the step's diagonal words, two a lane, and
// walks its candidates in lockstep: the lowest valid candidate not yet
// removed is kept, and its diagonal word (fetched by a shuffle) removes the
// ones after it in the step; then each lane ORs the kept rows' words into
// its words of the removed set, and writes the step's keep flags back to
// the original indices.  The chain is one shuffle a kept candidate.
__device__ void scan(const uint64_t* mask, const uint8_t* svalid, const int* order, uint64_t* removed,
                     uint8_t* keep, int m, int lane) {
  const int w = static_cast<int>(words(m));
  for (int x = lane; x < w; x += 32) removed[x] = 0;
  __syncwarp();
  for (int x0 = 0; x0 < w; ++x0) {
    const int base = 64 * x0, n = min(64, m - base);
    const bool in_lo = lane < n, in_hi = lane + 32 < n;
    const uint64_t d_lo = in_lo ? mask[static_cast<size_t>(base + lane) * w + x0] : 0;
    const uint64_t d_hi = in_hi ? mask[static_cast<size_t>(base + lane + 32) * w + x0] : 0;
    const unsigned v_lo = __ballot_sync(FULL, in_lo && svalid[base + lane]);
    const unsigned v_hi = __ballot_sync(FULL, in_hi && svalid[base + lane + 32]);
    uint64_t cand = (static_cast<uint64_t>(v_hi) << 32 | v_lo) & ~removed[x0], kept = 0;
    while (cand) {  // the same on every lane
      const int b = __ffsll(static_cast<long long>(cand)) - 1;
      kept |= 1ull << b;
      cand &= cand - 1;
      cand &= ~__shfl_sync(FULL, b < 32 ? d_lo : d_hi, b & 31);
    }
    for (int x = x0 + 1 + lane; x < w; x += 32) {
      uint64_t acc = removed[x];
      for (uint64_t k = kept; k; k &= k - 1)
        acc |= mask[static_cast<size_t>(base + __ffsll(static_cast<long long>(k)) - 1) * w + x];
      removed[x] = acc;
    }
    if (in_lo) keep[order[base + lane]] = kept >> lane & 1;
    if (in_hi) keep[order[base + lane + 32]] = kept >> (lane + 32) & 1;
    __syncwarp();
  }
}

template <typename T>
__device__ __forceinline__ T* at(unsigned char* base, size_t offset) {
  return reinterpret_cast<T*>(base + offset);
}

__global__ void __launch_bounds__(BLOCK_THREADS)
    nms_block_kernel(const float4* box, const float* score, const uint8_t* valid, float thresh, uint8_t* keep,
                     int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(m);
  const int t = threadIdx.x;
  sort_keys(score, valid, at<uint64_t>(smem, l.key), m, t, BLOCK_THREADS);
  __syncthreads();
  rank_scatter(at<uint64_t>(smem, l.key), box, valid, m, at<float4>(smem, l.box), at<int>(smem, l.order),
               at<uint8_t>(smem, l.valid), t, BLOCK_THREADS);
  __syncthreads();
  build_mask(at<float4>(smem, l.box), at<uint8_t>(smem, l.valid), at<uint64_t>(smem, l.mask), m, thresh, t,
             BLOCK_THREADS);
  __syncthreads();
  if (t < 32)
    scan(at<uint64_t>(smem, l.mask), at<uint8_t>(smem, l.valid), at<int>(smem, l.order),
         at<uint64_t>(smem, l.removed), keep, m, t);
}

__global__ void nms_key_kernel(const float* score, const uint8_t* valid, unsigned char* scratch, int m) {
  sort_keys(score, valid, at<uint64_t>(scratch, layout(m).key), m, blockIdx.x * blockDim.x + threadIdx.x,
            gridDim.x * blockDim.x);
}

__global__ void nms_rank_kernel(const float4* box, const uint8_t* valid, unsigned char* scratch, int m) {
  const Layout l = layout(m);
  rank_scatter(at<uint64_t>(scratch, l.key), box, valid, m, at<float4>(scratch, l.box), at<int>(scratch, l.order),
               at<uint8_t>(scratch, l.valid), blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

__global__ void nms_mask_kernel(unsigned char* scratch, int m, float thresh) {
  const Layout l = layout(m);
  build_mask(at<float4>(scratch, l.box), at<uint8_t>(scratch, l.valid), at<uint64_t>(scratch, l.mask), m, thresh,
             static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x,
             static_cast<size_t>(gridDim.x) * blockDim.x);
}

__global__ void nms_scan_kernel(unsigned char* scratch, uint8_t* keep, int m) {
  extern __shared__ uint64_t removed[];
  const Layout l = layout(m);
  scan(at<uint64_t>(scratch, l.mask), at<uint8_t>(scratch, l.valid), at<int>(scratch, l.order), removed, keep, m,
       threadIdx.x);
}

}  // namespace

// boxes (m, 4) f32 [y0, x0, y1, x1], 16-byte aligned; scores (m,) f32;
// valid and keep (m,) bool (one byte each).  Above BLOCK_MAX_M candidates
// `scratch` holds at least layout(m).total bytes of device memory.
extern "C" int ha_nms(const void* boxes, const void* scores, const void* valid, float iou_thresh, void* keep,
                      void* scratch, long long scratch_bytes, int m, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* box = static_cast<const float4*>(boxes);
  const float* score = static_cast<const float*>(scores);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* out = static_cast<uint8_t*>(keep);
  if (m <= BLOCK_MAX_M) {
    static std::atomic<unsigned> smem_set{0};  // devices this kernel may use its shared memory on
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev >= 32 || !(smem_set.load() >> dev & 1u))) {
      err = cudaFuncSetAttribute(nms_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(layout(BLOCK_MAX_M).total));
      if (err == cudaSuccess && dev < 32) smem_set.fetch_or(1u << dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    nms_block_kernel<<<1, BLOCK_THREADS, layout(m).total, s>>>(box, score, v, iou_thresh, out, m);
    return static_cast<int>(cudaGetLastError());
  }
  const Layout l = layout(m);
  if (scratch == nullptr || scratch_bytes < 0 || static_cast<size_t>(scratch_bytes) < l.total)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* buf = static_cast<unsigned char*>(scratch);
  const int blocks = (m + GRID_THREADS - 1) / GRID_THREADS;
  nms_key_kernel<<<blocks, GRID_THREADS, 0, s>>>(score, v, buf, m);
  nms_rank_kernel<<<blocks, GRID_THREADS, 0, s>>>(box, v, buf, m);
  const size_t items = static_cast<size_t>(m) * words(m);
  const int mask_blocks = static_cast<int>(std::min<size_t>((items + GRID_THREADS - 1) / GRID_THREADS, 65535));
  nms_mask_kernel<<<mask_blocks, GRID_THREADS, 0, s>>>(buf, m, iou_thresh);
  nms_scan_kernel<<<1, 32, 8 * words(m), s>>>(buf, out, m);
  return static_cast<int>(cudaGetLastError());
}
