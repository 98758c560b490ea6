// Greedy NMS keep mask for a batch of score-sorted, class-offset boxes.
//
// Replaces the TPU kernel `_nms_kernel` / `pallas_nms_keep`
// (cvpytorch_tpu/ops/pallas/nms_kernel.py:23-82), which kept a full f32
// K x K IoU matrix in VMEM (4 MB at K = 1024) and walked its rows.  That
// matrix does not fit a block's 227 KB of shared memory, so this kernel
// keeps one bit per pair instead:
//
//   one block per image, one launch for the whole batch;
//   phase 1 (all warps): boxes and areas go to shared memory, then each
//     warp builds 64-bit words of the "IoU(i, j) > thr, j > i" bitmask,
//     one ballot per 32 columns: ceil(K/64) words a row, 128 KB at K = 1024;
//   phase 2 (one warp): walk i = 0..K-1; lane l owns word l of the
//     "removed" set; if i is not removed, OR row i into the set.
//
// What bounds it on an H100: bytes and FLOPs are tiny (16 K bytes in,
// K bytes out, about K^2/2 IoUs of ~15 FLOPs).  The limits are the
// per-block IoU work of phase 1, done by one SM for each image, and the
// K-step dependent chain of phase 2.  A faster design (several blocks per
// image for phase 1, early exit, phase 2 in registers) is later work.
//
// Bit-exactness: the IoU is the JAX arithmetic in the JAX order
// (ops/boxes.py box_iou_matrix): w = max(min(x2) - max(x1), 0), likewise h,
// inter = w * h, union = (area_i + area_j) - inter, iou = inter / (union +
// 1e-7), suppress iff iou > thr (strict).  Every step is an explicitly
// rounded intrinsic, so no FMA contraction changes a rounding; the build
// also passes -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;
constexpr int kThreads = 512;
constexpr int kMaxWords = kMaxK / 64;

__host__ __device__ inline size_t area_offset(int K) { return (size_t)K * 16; }
__host__ __device__ inline size_t mask_offset(int K) {
  return area_offset(K) + (((size_t)K * 4 + 15) / 16) * 16;
}
inline size_t smem_bytes(int K) {
  return mask_offset(K) + (size_t)K * ((K + 63) / 64) * 8;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, __fadd_rn(uni, 1e-7f));
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes, int K, float thr,
                uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_removed[kMaxWords];
  float4* s_box = reinterpret_cast<float4*>(smem);
  float* s_area = reinterpret_cast<float*>(smem + area_offset(K));
  unsigned long long* s_mask =
      reinterpret_cast<unsigned long long*>(smem + mask_offset(K));
  const int W = (K + 63) / 64;
  const float* b = boxes + (size_t)blockIdx.x * K * 4;

  for (int t = threadIdx.x; t < K; t += blockDim.x) {
    const float4 v = make_float4(b[4 * t], b[4 * t + 1], b[4 * t + 2],
                                 b[4 * t + 3]);
    s_box[t] = v;
    s_area[t] = box_area(v);
  }
  __syncthreads();

  // phase 1: warp-per-word, lanes on consecutive columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int task = warp; task < K * W; task += n_warps) {
    const int i = task / W, w = task - i * W;
    unsigned long long word = 0ull;
    if (64 * w + 63 > i) {  // warp-uniform: some column of the word is > i
      const float4 bi = s_box[i];
      const float ai = s_area[i];
      const int j0 = 64 * w + lane, j1 = j0 + 32;
      const bool s0 = j0 > i && j0 < K && iou(bi, ai, s_box[j0], s_area[j0]) > thr;
      const bool s1 = j1 > i && j1 < K && iou(bi, ai, s_box[j1], s_area[j1]) > thr;
      const unsigned lo = __ballot_sync(0xffffffffu, s0);
      const unsigned hi = __ballot_sync(0xffffffffu, s1);
      word = ((unsigned long long)hi << 32) | lo;
    }
    if (lane == 0) s_mask[i * W + w] = word;
  }
  __syncthreads();

  // phase 2: the serial greedy scan, one warp
  if (warp == 0) {
    unsigned long long removed = 0ull;  // lane l holds word l
    for (int i = 0; i < K; ++i) {
      const unsigned long long wi = __shfl_sync(0xffffffffu, removed, i >> 6);
      if (!((wi >> (i & 63)) & 1ull) && lane < W) removed |= s_mask[i * W + lane];
    }
    if (lane < W) s_removed[lane] = removed;
  }
  __syncthreads();

  uint8_t* out = keep + (size_t)blockIdx.x * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    out[j] = ((s_removed[j >> 6] >> (j & 63)) & 1ull) ? 0 : 1;
}

}  // namespace

// boxes: (B, K, 4) f32 contiguous on the device; keep: (B, K) uint8.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int cvt_nms_keep(const float* boxes, int B, int K, float thr,
                            uint8_t* keep, void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (B < 1) return 0;
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_keep_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(boxes, K, thr,
                                                               keep);
  return (int)cudaGetLastError();
}

extern "C" const char* cvt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
