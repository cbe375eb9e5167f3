// Cosine cost map + 7x7 correlation embedding, one block per (class, image).
//
// Replaces catseg_tpu/kernels/corr_embed.py:fused_corr_embed (_kernel).
// img: (B, 24, 24, E) raw image features; txt: (B, T, E) L2-normalized text
// (P = 1); w: (49, 128) fp32 taps (HWIO flattened); bias: (128,) fp32;
// out: (B, T, 24, 24, 128) channels-last.
//
// Phase 1: one warp per position reads the feature row once and forms both
// x.t and |x|^2, so the cosine is (x.t) / max(|x|, 1e-12); the 24x24 map is
// rounded through T (the reference's bf16 cost volume) into a zero-bordered
// 30x30 shared plane.  Phase 2: each thread owns one output channel and
// walks positions, 49 FMAs per output against taps held in shared memory;
// consecutive threads write consecutive channels.
//
// Bound on the card: the (B, T, 576, 128) output write (~221 MB at bf16 for
// 10 tiles x 150 classes) and the 576 x E feature reads per class; the cost
// volume never reaches device memory.
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kG = 24;            // feature grid
constexpr int kHW = kG * kG;
constexpr int kPad = kG + 6;      // zero border of 3 for the 7x7 taps
constexpr int kC = 128;           // embedding width
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_embed_kernel(const T* __restrict__ img, const T* __restrict__ txt, const float* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int nT, int E) {
  extern __shared__ float sm[];
  float* ts = sm;                  // E
  float* cp = ts + E;              // kPad * kPad
  float* ws = cp + kPad * kPad;    // 49 * kC
  float* bs = ws + 49 * kC;        // kC
  const int t = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  for (int e = tid; e < E; e += blockDim.x) ts[e] = to_f(txt[((size_t)b * nT + t) * E + e]);
  for (int i = tid; i < kPad * kPad; i += blockDim.x) cp[i] = 0.f;
  for (int i = tid; i < 49 * kC; i += blockDim.x) ws[i] = w[i];
  for (int i = tid; i < kC; i += blockDim.x) bs[i] = bias[i];
  __syncthreads();

  const T* ib = img + (size_t)b * kHW * E;
  for (int p = warp; p < kHW; p += nwarps) {
    float dot = 0.f, n2 = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float x = to_f(ib[(size_t)p * E + e]);
      dot = fmaf(x, ts[e], dot);
      n2 = fmaf(x, x, n2);
    }
    dot = warp_sum(dot);
    n2 = warp_sum(n2);
    if (lane == 0) {
      const float inv = 1.f / fmaxf(sqrtf(n2), 1e-12f);
      cp[(p / kG + 3) * kPad + p % kG + 3] = rnd<T>(dot * inv);
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * nT + t) * kHW * kC;
  for (int idx = tid; idx < kHW * kC; idx += blockDim.x) {
    const int p = idx / kC, c = idx % kC, y = p / kG, x = p % kG;
    float acc = bs[c];
#pragma unroll
    for (int dy = 0; dy < 7; ++dy)
#pragma unroll
      for (int dx = 0; dx < 7; ++dx)
        acc = fmaf(cp[(y + dy) * kPad + x + dx], ws[(dy * 7 + dx) * kC + c], acc);
    ob[idx] = from_f<T>(acc);
  }
}

}  // namespace

extern "C" int catseg_corr_embed(const void* img, const void* txt, const void* w, const void* bias,
                                 void* out, int B, int nT, int H, int W, int E, int is_bf16,
                                 void* stream) {
  if (H != kG || W != kG || B <= 0 || nT <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(E + kPad * kPad + 49 * kC + kC) * sizeof(float);
  const dim3 grid(nT, B);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(corr_embed_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    corr_embed_kernel<bf16><<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(img), static_cast<const bf16*>(txt), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<bf16*>(out), nT, E);
  } else {
    e = cudaFuncSetAttribute(corr_embed_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    corr_embed_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(img), static_cast<const float*>(txt), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), nT, E);
  }
  return (int)cudaGetLastError();
}
