// Greedy NMS keep mask for a batch of score-sorted, class-offset boxes.
//
// Replaces the TPU kernel `_nms_kernel` / `pallas_nms_keep`
// (cvpytorch_tpu/ops/pallas/nms_kernel.py:23-82), which kept a full f32
// K x K IoU matrix in VMEM and walked its rows one at a time.  Here the
// matrix is one bit per pair, and one call of cvt_nms_keep launches two
// kernels on the caller's stream (nms_keep counts the pair as one launch):
//
//   nms_mask_kernel, spread over the card: one 256-thread block per
//     (image, pair of 64-box tiles r <= c), B * T(T+1)/2 blocks with
//     T = ceil(K/64) (4352 at B = 32, K = 1024; 136 at B = 1).  Four
//     threads share row i = 64r + t, 16 columns j of tile c each (boxes in
//     shared memory), and write the 64-bit word "IoU(i, j) > thr, j > i"
//     to a packed upper-triangle scratch (B, T(T+1)/2, 64) u64 that the
//     wrapper allocates (2.2 MB at B = 32, K = 1024; it stays in L2).
//     Row-block r, the pairs (r, r..T-1), is contiguous in it.
//   nms_scan_kernel, one warp per image: walks the row-blocks r = 0..T-1,
//     with cp.async bringing blocks r+1 and r+2 into shared memory
//     meanwhile.  Every lane resolves the 64 rows of block r from the
//     diagonal words alone (a row whose word is zero removes nothing, so
//     a block with few nonzero words walks just those), then each word w > r
//     gains the OR of the kept rows' words through warp reductions.  The
//     dependent chain is T block steps, no longer K shuffle + load steps.
//
// What bounds it on an H100 (chip_smoke.py's device times, PERF.md):
// bytes and FLOPs are tiny (16 K bytes in, K bytes out, K(K-1)/2 IoUs).
// The mask kernel is bound by the issue of each IoU's ALU-pipe work (the
// NaN-exact min/max, compares, bit packing) at B = 32 (~20 us, growing
// with the tile pairs), by one short wave at B = 1 (~2.4 us).  No IoU divides unless it lies within 2^-16 of thr
// (see nms_mask_kernel).  The scan is bound by its T dependent block
// steps on one warp (~0.6 us a step at T = 16, ~11 us, the same at any B);
// per step, the warp reductions and the chain.  No dynamic shared memory,
// so nothing is set per launch.
//
// Bit-exactness: the IoU is the JAX arithmetic in the JAX order
// (ops/boxes.py box_iou_matrix): w = max(min(x2) - max(x1), 0), likewise h,
// inter = w * h, union = (area_i + area_j) - inter, iou = inter / (union +
// 1e-7), suppress iff iou > thr (strict).  Every step is an explicitly
// rounded intrinsic, so no FMA contraction changes a rounding (the build
// also passes -fmad=false); max and min propagate NaN as jnp.maximum and
// torch.maximum do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;               // boxes per tile, bits per word
constexpr int kMaxK = 1024;
constexpr int kMaxT = kMaxK / kTile;    // 16 tiles: one "removed" word a lane
constexpr int kParts = 4;               // mask-kernel threads per row
constexpr int kCols = kTile / kParts;   // columns per mask-kernel thread
constexpr int kSparseRows = 16;         // the scan walks up to this many rows
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int n_tiles(int K) { return (K + kTile - 1) / kTile; }
__host__ __device__ inline int n_pairs(int T) { return T * (T + 1) / 2; }

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

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.0f),
                   max_nan(__fsub_rn(b.w, b.y), 0.0f));
}

// one MUFU.RCP: within 1 ulp of 1/x (PTX ISA), subnormals flushed
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// IoU(a, b) = inter / d
__device__ __forceinline__ void overlap(float4 a, float area_a, float4 b,
                                        float area_b, float& inter, float& d) {
  const float w = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float h = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  inter = __fmul_rn(w, h);
  d = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
}

// An area above this (or NaN) sends the pair to the division: with both
// areas at most 2^98, d < 2^100, so 1/d is a normal number.
constexpr float kMaxArea = 0x1p98f;

// grid (B, T(T+1)/2), kParts * 64 threads; boxes 16-byte aligned.  Thread
// t takes row t % 64 and the 16 columns of part t / 64 (the same on a
// warp, so every lane reads the same column box), and writes 16 bits of
// the row's word.
//
// The test IoU > thr needs no division away from thr: q = inter * rcp(d)
// is within 2^-22 of inter / d (relative), so q > hi >= thr (1 + 2^-16)
// means RN(inter / d) > thr, and q < lo <= thr (1 - 2^-16) means it is
// not.  Pairs in between, NaN, or with an area above kMaxArea take the
// IEEE division.  The wrapper passes lo = -inf, hi = +inf for a threshold
// outside [2^-100, 2^100], so that every pair does.
// (tests/test_torch_nms_edges.py holds this rule to f32 division.)
__global__ void __launch_bounds__(kParts * kTile)
nms_mask_kernel(const float4* __restrict__ boxes, int K, float thr, float lo,
                float hi, u64* __restrict__ mask) {
  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];
  __shared__ unsigned s_big[kTile / 32];  // columns whose area is > kMaxArea
  const int T = n_tiles(K);
  int r = 0, q = blockIdx.y;  // packed pair index -> (r, c = r + q)
  while (q >= T - r) {
    q -= T - r;
    ++r;
  }
  const int c = r + q;
  const int t = threadIdx.x % kTile, j0 = threadIdx.x / kTile * kCols;
  const float4* bx = boxes + (size_t)blockIdx.x * K;

  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x < kTile) {  // warps 0 and 1
    const float4 v = c * kTile + t < K ? bx[c * kTile + t] : zero;
    const float area = box_area(v);
    s_box[t] = v;
    s_area[t] = area;
    const unsigned big = __ballot_sync(kFull, !(area <= kMaxArea));
    if (t % 32 == 0) s_big[t / 32] = big;
  }
  const int i = r * kTile + t;
  const float4 bi = i < K ? bx[i] : zero;
  const float ai = box_area(bi);
  __syncthreads();

  // columns j0 + k with j > i and j < K
  const int first = max((c == r ? t + 1 : 0) - j0, 0);
  const int last = i < K ? min(K - c * kTile - j0, kCols) : 0;
  const unsigned cols =
      last > first ? ((1u << last) - 1u) & ~((1u << first) - 1u) : 0u;
  unsigned bits = 0u;
  unsigned unsure = ai <= kMaxArea ? (s_big[j0 / 32] >> (j0 % 32)) & 0xffffu
                                   : 0xffffu;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    float inter, d;
    overlap(bi, ai, s_box[j0 + k], s_area[j0 + k], inter, d);
    const float iou = __fmul_rn(inter, rcp_approx(d));
    bits |= (unsigned)(iou > hi) << k;
    unsure |= (unsigned)!(iou > hi || iou < lo) << k;
  }
  unsure &= cols;
  for (; unsure; unsure &= unsure - 1u) {  // rare: the IEEE division
    const int k = __ffs(unsure) - 1;
    float inter, d;
    overlap(bi, ai, s_box[j0 + k], s_area[j0 + k], inter, d);
    bits = (bits & ~(1u << k)) | ((unsigned)(__fdiv_rn(inter, d) > thr) << k);
  }
  bits &= cols;
  // bits j0..j0+15 of the little-endian word
  const size_t word = ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * kTile + t;
  reinterpret_cast<uint16_t*>(mask)[word * kParts + j0 / kCols] = (uint16_t)bits;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_two() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// `words` (a multiple of 64) u64 from global to shared, 16 bytes a lane a step
__device__ __forceinline__ void copy_words(u64* dst, const u64* src, int words,
                                           int lane) {
  for (int k = 2 * lane; k < words; k += 64) cp_async16(dst + k, src + k);
}

// Each word w > r gains the OR of the words of block r's kept rows in
// column tile c = w - r, for c in [c0, c0 + 8): lane l reads rows l and
// l + 32 (consecutive words, no bank conflict), and the warp reduces.  No
// branch, so the loads and reductions overlap; tiles c >= T - r read stale
// words and feed only lanes w >= T, which are never read.
__device__ __forceinline__ void propagate(const u64* rows, int c0, int r,
                                          int lane, u64 keep_lo, u64 keep_hi,
                                          u64& removed) {
#pragma unroll
  for (int c = c0; c < c0 + 8; ++c) {
    if (c == 0) continue;  // the diagonal, resolved by the chain
    const u64* col = rows + c * kTile;
    const u64 v = (col[lane] & keep_lo) | (col[lane + 32] & keep_hi);
    const unsigned lo = __reduce_or_sync(kFull, (unsigned)v);
    const unsigned hi = __reduce_or_sync(kFull, (unsigned)(v >> 32));
    if (lane == r + c) removed |= ((u64)hi << 32) | lo;
  }
}

// grid (B,), one warp
__global__ void __launch_bounds__(32)
nms_scan_kernel(const u64* __restrict__ mask, int K, uint8_t* __restrict__ keep) {
  __shared__ __align__(16) u64 s_rows[3][kMaxT * kTile];  // 3 x 8 KB
  const int T = n_tiles(K);
  const int lane = threadIdx.x;
  const u64* next = mask + (size_t)blockIdx.x * n_pairs(T) * kTile;
  // row-blocks r + 1 and r + 2 are in flight while block r is resolved
  for (int r = 0; r < 2; ++r) {
    const int words = max(T - r, 0) * kTile;
    copy_words(s_rows[r], next, words, lane);
    cp_async_commit();
    next += words;
  }
  u64 removed = 0ull;  // lane w < T holds "removed" word w
  for (int r = 0; r < T; ++r) {
    const int words = max(T - r - 2, 0) * kTile;  // row-block r + 2
    copy_words(s_rows[(r + 2) % 3], next, words, lane);
    cp_async_commit();  // empty near the end: the wait stays uniform
    next += words;
    cp_async_wait_two();  // row-block r has landed
    __syncwarp();
    const u64* rows = s_rows[r % 3];  // rows[(c - r) * 64 + ii]

    // the 64 rows of block r in order, from the diagonal words: only rows
    // whose word is not zero can remove a row, so the chain walks those
    // alone when they are few, and all 64, unrolled, when they are many
    const u64 nz = __ballot_sync(kFull, rows[lane] != 0ull) |
                   (u64)__ballot_sync(kFull, rows[lane + 32] != 0ull) << 32;
    u64 rem = __shfl_sync(kFull, removed, r);
    if (__popcll(nz) <= kSparseRows) {
      u64 m = nz;
      int ii = __ffsll((long long)m) - 1;
      u64 d = rows[max(ii, 0)];
      while (m) {  // the next row's word is loaded a step ahead
        m &= m - 1ull;
        const int ii_next = __ffsll((long long)m) - 1;
        const u64 d_next = rows[max(ii_next, 0)];
        if (!((rem >> ii) & 1ull)) rem |= d;
        ii = ii_next;
        d = d_next;
      }
    } else {
      u64 diag[kTile];  // loaded (the same address on every lane) first
#pragma unroll
      for (int k = 0; k < kTile; ++k) diag[k] = rows[k];
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        if (!((rem >> k) & 1ull)) rem |= diag[k];
    }
    if (lane == r) removed = rem;
    const int n_rows = min(kTile, K - r * kTile);
    const u64 kept = ~rem & (n_rows == kTile ? ~0ull : (1ull << n_rows) - 1ull);

    const u64 keep_lo = 0ull - ((kept >> lane) & 1ull);
    const u64 keep_hi = 0ull - ((kept >> (lane + 32)) & 1ull);
    propagate(rows, 0, r, lane, keep_lo, keep_hi, removed);
    if (T - r > 8) propagate(rows, 8, r, lane, keep_lo, keep_hi, removed);
    __syncwarp();  // block r is read before a copy overwrites its buffer
  }

  uint8_t* out = keep + (size_t)blockIdx.x * K;
  for (int j0 = 0; j0 < K; j0 += 32) {
    const u64 word = __shfl_sync(kFull, removed, j0 / kTile);
    const int j = j0 + lane;
    if (j < K) out[j] = ((word >> (j % kTile)) & 1ull) ? 0 : 1;
  }
}

}  // namespace

// The kernels' C interface: launches both kernels on `stream` and returns
// cudaGetLastError() of the first launch that fails, else of the second;
// nothing synchronises.  boxes: (B, K, 4) f32 contiguous and 16-byte
// aligned; thr: the f32 threshold, (lo, hi) the band around it where the
// IEEE division decides; mask: scratch of B * T(T+1)/2 * 64 u64
// (T = ceil(K/64)); keep: (B, K) uint8.
extern "C" int cvt_nms_keep(const float* boxes, int B, int K, float thr,
                            float lo, float hi, u64* mask, uint8_t* keep,
                            void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (B < 1) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B, n_pairs(n_tiles(K)));
  nms_mask_kernel<<<grid, kParts * kTile, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), K, thr, lo, hi, mask);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<B, 32, 0, s>>>(mask, K, keep);
  return (int)cudaGetLastError();
}

extern "C" const char* cvt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
