// Shared device helpers for the catseg_tpu_torch kernels (sm_90a).
//
// Activations arrive in their storage type T (float or __nv_bfloat16);
// every kernel computes in fp32 and rounds through T exactly where the JAX
// reference casts to its compute dtype (rnd<T>), so the fp32 build is the
// oracle-parity path and the bf16 build mirrors the reference's roundings.
// Weights arrive already rounded through the compute dtype where the
// reference rounds them: as fp32 arrays for the CUDA-core (FMA) products, as
// bf16 arrays for the tensor-core products of the bf16 swin kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace catseg {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// round an fp32 value through storage type T
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// bf16 compute selects the reference's fast numerics (single-pass LN
// variance, tanh GELU, max-free clamped softmax); fp32 keeps exact forms
template <typename T> struct Fast { static constexpr bool value = false; };
template <> struct Fast<bf16> { static constexpr bool value = true; };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of one 128-wide row held by a warp (4 values per lane, column
// lane + 32*i), fp32 statistics, eps 1e-5; writes the row rounded through T
// into dst of type D (float, or bf16 for tensor-core operands).
template <typename T, typename D>
__device__ __forceinline__ void ln_row128(const float (&v)[4], const float* __restrict__ g,
                                          const float* __restrict__ b, D* dst, int lane) {
  const float mean = warp_sum(v[0] + v[1] + v[2] + v[3]) * (1.f / 128.f);
  float var;
  if (Fast<T>::value) {
    var = warp_sum(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]) * (1.f / 128.f) - mean * mean;
  } else {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) s += (v[i] - mean) * (v[i] - mean);
    var = warp_sum(s) * (1.f / 128.f);
  }
  const float r = rsqrtf(var + 1e-5f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    dst[c] = from_f<D>(rnd<T>((v[i] - mean) * r * g[c] + b[c]));
  }
}

// out[r, c] = sum_k A[r*lda + k] * Wt[k*ldw + c] for r < R, c < N, handed to
// epi(r, c, acc).  A lives in shared memory, Wt (row-major (K, N) slice of a
// weight) in global memory.  Each thread owns one column and RB rows, so one
// weight load feeds RB FMAs and a warp reads RB shared rows as broadcasts.
// The weights mostly miss L1 (shared memory takes most of it), so KU weight
// loads are issued before their FMAs to keep several L2 round trips in
// flight; each output still sums k in order.
template <int RB, typename Epi>
__device__ __forceinline__ void mm_rows(const float* A, int lda, const float* __restrict__ Wt,
                                        int ldw, int R, int N, int K, Epi epi) {
  constexpr int KU = 16;
  const int groups = (R + RB - 1) / RB;
  for (int idx = threadIdx.x; idx < groups * N; idx += blockDim.x) {
    const int c = idx % N;
    const int r0 = (idx / N) * RB;
    const int nr = min(RB, R - r0);
    float acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = 0.f;
    const float* a = A + r0 * lda;
    int k = 0;
    for (; k + KU <= K; k += KU) {
      float w[KU];
#pragma unroll
      for (int u = 0; u < KU; ++u) w[u] = __ldg(Wt + (size_t)(k + u) * ldw + c);
#pragma unroll
      for (int u = 0; u < KU; ++u)
#pragma unroll
        for (int i = 0; i < RB; ++i)
          if (i < nr) acc[i] = fmaf(a[i * lda + k + u], w[u], acc[i]);
    }
    for (; k < K; ++k) {
      const float w = __ldg(Wt + (size_t)k * ldw + c);
#pragma unroll
      for (int i = 0; i < RB; ++i)
        if (i < nr) acc[i] = fmaf(a[i * lda + k], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if (i < nr) epi(r0 + i, c, acc[i]);
  }
}

// Tensor-core form of mm_rows for bf16 operands: A (R, K) bf16 in shared
// memory (lda a multiple of 8), W (K, N) bf16 row-major in global memory;
// R, N, K multiples of 16.  Each warp takes 16x16 output tiles round-robin,
// accumulates in fp32 (wmma m16n16k16), stages the tile in its own 256-float
// slice of ``stage`` and hands every element to epi(r, c, acc).
template <typename Epi>
__device__ __forceinline__ void mm_tc(const bf16* A, int lda, const bf16* __restrict__ W, int ldw,
                                      int R, int N, int K, float* stage, Epi epi) {
  namespace wm = nvcuda::wmma;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int tn = N / 16, tiles = (R / 16) * tn;
  float* st = stage + warp * 256;
  for (int t = warp; t < tiles; t += nw) {
    const int rt = t / tn, ct = t % tn;
    wm::fragment<wm::accumulator, 16, 16, 16, float> c;
    wm::fill_fragment(c, 0.f);
    for (int k = 0; k < K; k += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
      wm::load_matrix_sync(a, A + rt * 16 * lda + k, lda);
      wm::load_matrix_sync(b, W + (size_t)k * ldw + ct * 16, ldw);
      wm::mma_sync(c, a, b, c);
    }
    wm::store_matrix_sync(st, c, 16, wm::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) epi(rt * 16 + e / 16, ct * 16 + e % 16, st[e]);
    __syncwarp();
  }
}

}  // namespace catseg
