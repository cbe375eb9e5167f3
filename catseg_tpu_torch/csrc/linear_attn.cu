// Kernelized (elu + 1) linear attention across the class axis, per position.
//
// Replaces catseg_tpu/kernels/linear_attn.py:fused_linear_attention
// (_kernel).  q, k, v, out: (N, S, C) row-major in T, one sequence of S class
// rows per spatial position; heads of D = C / heads channels.  With
// phi(x) = x + 1 for x > 0, else e^x, Q = phi(q), K = phi(k), V = v / S, all
// fp32:  KV_h = K_h^T V_h (D x D per head), Ksum = sum_s K,
// out = (Q_h KV_h) / (Q_h . Ksum_h + eps) * S, rounded to T.
//
// One CTA per sequence.  Pass 1 streams K and V through shared memory in
// 16-row tiles; each thread accumulates 4 x 4 blocks of the per-head KV
// (C x D fp32) in registers from float4 reads of a K and a V row, and Ksum
// in shared memory; the KV lands in shared memory at the end.  Pass 2 streams Q: each
// thread owns one output channel (h, f), keeps KV_h's column f and Ksum_h in
// registers, and walks the tile's rows with float4 reads of the shared Q row,
// so the normalizer and the product share the Q reads.
//
// Bound on the card: bytes (q, k, v read once, q read again, out written:
// 1.5 GB in bf16 at 5760 sequences of 256 x 128); ~36 GFLOP of fp32 FMAs ride
// along.
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kThreads = 256;
constexpr int kTS = 16;  // rows per tile
constexpr int kMaxB = 4;  // 4 x 4 KV blocks per thread: C D <= 16 kThreads kMaxB

__device__ __forceinline__ float phi(float x) { return x > 0.f ? x + 1.f : expf(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ out, int S, int C, float eps) {
  extern __shared__ __align__(16) float sm[];
  float* kv = sm;             // (heads, D, D) = (C, D)
  float* ksum = kv + C * D;   // (C,)
  float* ta = ksum + C;       // (kTS, C): K, then Q tiles
  float* tb = ta + kTS * C;   // (kTS, C): V tiles
  const size_t base = (size_t)blockIdx.x * S * C;
  const int tid = threadIdx.x;
  const float fS = (float)S;
  // pass 1: thread tid owns the 4 x 4 blocks tid, tid + kThreads, ... of the heads' D x D KV
  constexpr int DB = D / 4;
  const int nblk = C / D * DB * DB;
  float acc[kMaxB][16];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[b][i] = 0.f;
  for (int e = tid; e < C; e += kThreads) ksum[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kTS) {
    const int ns = min(kTS, S - s0);
    __syncthreads();  // the last tile's reads are done (and the zeroing above)
    for (int e = tid; e < ns * C; e += kThreads) {
      ta[e] = phi(to_f(k[base + (size_t)s0 * C + e]));
      tb[e] = to_f(v[base + (size_t)s0 * C + e]) / fS;
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      const int blk = tid + b * kThreads;
      if (blk < nblk) {
        const int h = blk / (DB * DB), d0 = (blk / DB) % DB * 4, f0 = blk % DB * 4;
        for (int s = 0; s < ns; ++s) {
          const float4 kk = *reinterpret_cast<const float4*>(ta + s * C + h * D + d0);
          const float4 vv = *reinterpret_cast<const float4*>(tb + s * C + h * D + f0);
          const float ka[4] = {kk.x, kk.y, kk.z, kk.w}, vb[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[b][i * 4 + j] = fmaf(ka[i], vb[j], acc[b][i * 4 + j]);
        }
      }
    }
    for (int c = tid; c < C; c += kThreads) {
      float a = ksum[c];
      for (int s = 0; s < ns; ++s) a += ta[s * C + c];
      ksum[c] = a;
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    const int blk = tid + b * kThreads;
    if (blk < nblk) {
      const int h = blk / (DB * DB), d0 = (blk / DB) % DB * 4, f0 = blk % DB * 4;
#pragma unroll
      for (int i = 0; i < 16; ++i) kv[(h * D + d0 + i / 4) * D + f0 + i % 4] = acc[b][i];
    }
  }
  __syncthreads();

  for (int c = tid % C; c < C; c += kThreads) {  // kThreads % C == 0 or C > kThreads
    // a thread handles channel c on rows r0, r0 + rstep, ... of every tile
    const int h = c / D, f = c % D;
    const int r0 = tid / C, rstep = max(1, kThreads / C);
    float kvc[D], ks[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kvc[d] = kv[(h * D + d) * D + f];
      ks[d] = ksum[h * D + d];
    }
    for (int s0 = 0; s0 < S; s0 += kTS) {
      const int ns = min(kTS, S - s0);
      __syncthreads();
      for (int e = tid; e < ns * C; e += kThreads) ta[e] = phi(to_f(q[base + (size_t)s0 * C + e]));
      __syncthreads();
      for (int s = r0; s < ns; s += rstep) {
        const float* qr = ta + s * C + h * D;
        float acc = 0.f, z = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + d);
          acc = fmaf(a.x, kvc[d], acc);
          z = fmaf(a.x, ks[d], z);
          acc = fmaf(a.y, kvc[d + 1], acc);
          z = fmaf(a.y, ks[d + 1], z);
          acc = fmaf(a.z, kvc[d + 2], acc);
          z = fmaf(a.z, ks[d + 2], z);
          acc = fmaf(a.w, kvc[d + 3], acc);
          z = fmaf(a.w, ks[d + 3], z);
        }
        out[base + (size_t)(s0 + s) * C + c] = from_f<T>(acc * (1.f / (z + eps)) * fS);
      }
    }
  }
}

template <int D>
int run(const void* q, const void* k, const void* v, void* out, int N, int S, int C, float eps, int is_bf16,
        cudaStream_t st) {
  const size_t smem = (size_t)(C * D + C + 2 * kTS * C) * sizeof(float);
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(linear_attention_kernel<bf16, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    linear_attention_kernel<bf16, D><<<N, kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), S, C, eps);
  } else {
    e = cudaFuncSetAttribute(linear_attention_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    linear_attention_kernel<float, D><<<N, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), S, C, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Takes head dims 8, 16, 32 or 64, C dividing 256 or a multiple of 256 up to 512, and C D <= 16384.
extern "C" int catseg_linear_attention(const void* q, const void* k, const void* v, void* out, int N, int S,
                                       int C, int heads, float eps, int is_bf16, void* stream) {
  if (N <= 0 || S <= 0 || heads <= 0 || C % heads || C > 512 || (kThreads % C && C % kThreads) ||
      C * (C / heads) > 16 * kThreads * kMaxB)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (C / heads) {
    case 8: return run<8>(q, k, v, out, N, S, C, eps, is_bf16, st);
    case 16: return run<16>(q, k, v, out, N, S, C, eps, is_bf16, st);
    case 32: return run<32>(q, k, v, out, N, S, C, eps, is_bf16, st);
    case 64: return run<64>(q, k, v, out, N, S, C, eps, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
