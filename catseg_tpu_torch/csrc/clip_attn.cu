// Maskless multi-head softmax attention for the dense CLIP image encode.
//
// Replaces catseg_tpu/kernels/clip_attn.py:fused_dense_attention (_kernel).
// q, k, v, o: (B, S, W) row-major, heads of 64 channels.  One block per
// (query tile of 64, head, image); one thread per query row keeps its q row
// and fp32 output accumulator in registers while 32-key tiles of K and V
// stream through shared memory with an online (running-max) fp32 softmax, so
// the (S, S) logits never reach device memory.  The ragged key tail (577 is
// not a tile multiple) is masked by loading only real keys.  Logits are
// scaled after the q.k product, as the reference does.
//
// Bound on the card: FMA issue (the products run on CUDA cores, not tensor
// cores); ~10 GFLOP per ViT-B layer at 10 tiles.  Moving QK^T and PV onto
// wgmma tiles is the next step for this kernel.
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kD = 64;   // head dim
constexpr int kBQ = 64;  // queries per block, one per thread
constexpr int kBK = 32;  // keys per shared tile

template <typename T>
__global__ void __launch_bounds__(kBQ)
dense_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int S, int W, float scale) {
  __shared__ float Ks[kBK][kD];
  __shared__ float Vs[kBK][kD];
  __shared__ float P[kBQ][kBK + 1];
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * kBQ + tid;
  const bool active = qi < S;
  const size_t base = (size_t)blockIdx.z * S * W + (size_t)blockIdx.y * kD;

  float qr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = active ? to_f(q[base + (size_t)qi * W + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();
    for (int e = tid; e < kBK * kD; e += kBQ) {
      const int j = e / kD, d = e % kD, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < S) {
        kv = to_f(k[base + (size_t)kj * W + d]);
        vv = to_f(v[base + (size_t)kj * W + d]);
      }
      Ks[j][d] = kv;
      Vs[j][d] = vv;
    }
    __syncthreads();
    const int nk = min(kBK, S - k0);
    float tmax = -INFINITY;
    for (int j = 0; j < nk; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) s = fmaf(qr[d], Ks[j][d], s);
      s *= scale;
      P[tid][j] = s;
      tmax = fmaxf(tmax, s);
    }
    const float mnew = fmaxf(m, tmax);
    const float corr = expf(m - mnew);
    l *= corr;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] *= corr;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(P[tid][j] - mnew);
      l += p;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d]);
    }
    m = mnew;
  }
  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[base + (size_t)qi * W + d] = from_f<T>(acc[d] * inv);
  }
}

}  // namespace

extern "C" int catseg_dense_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int W, int heads, int head_dim, float scale,
                                      int is_bf16, void* stream) {
  if (head_dim != kD || heads * kD != W || S <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kBQ - 1) / kBQ, heads, B);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dense_attention_kernel<bf16><<<grid, kBQ, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), S, W, scale);
  } else {
    dense_attention_kernel<float><<<grid, kBQ, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), S, W, scale);
  }
  return (int)cudaGetLastError();
}
