// Transformer MLP act(x W1 + b1) W2 + b2 with the hidden activation kept on chip.
//
// Replaces catseg_tpu/kernels/mlp.py:fused_mlp (_kernel).  x (M, C) row-major
// in T, W1 (C, H) and W2 (H, Co) row-major (the reference's (in, out) layout),
// b1 / b2 fp32; out (M, Co) in T.  act 0 is GELU (tanh form in bf16, erf in
// fp32: the reference's dtype predicate), 1 is ReLU.  The hidden is rounded to
// T before the second product, as the reference rounds it to x's dtype.
//
// Each CTA takes a tile of rows and walks the hidden width in 128-wide chunks:
// a chunk is produced (x tile . W1 chunk), biased, activated, rounded, and at
// once contracted into the tile's fp32 output accumulator, so the 4x hidden
// never reaches device memory.  bf16: wmma m16n16k16 tensor-core products
// (64-row tiles, 8 warps; each chunk's W1 columns and W2 rows are copied to
// shared memory once per CTA with 16-byte loads; the output accumulators stay
// in fragments across the chunks).  fp32: CUDA-core FMAs (32-row tiles; each
// thread owns one output column and Co / 8 rows, one weight load feeding
// Co / 8 FMAs, float4 reads of the shared rows).  Co is 32, 64, 128 or 256.
//
// Bound on the card: operations (2 M C H + 2 M H Co, ~386 GFLOP for the class
// MLP at M = 1.47 M rows against 0.4-0.6 GB of x and out).  Every CTA still
// reads all the weights from L2 (256 KB in bf16 per 64 rows); TMA multicast
// across a cluster and wgmma tiles are the next step.
#include <mma.h>

#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kThreads = 256;
constexpr int kHC = 128;   // hidden chunk
constexpr int kBM16 = 64;  // rows per CTA, bf16
constexpr int kBM32 = 32;  // rows per CTA, fp32

__device__ __forceinline__ float act_fn(float v, int act, bool fast) {
  if (act == 1) return fmaxf(v, 0.f);
  if (fast) return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// ---- bf16: tensor cores -------------------------------------------------
// shared: xs (kBM16, C + 8) | w1s (C, kHC + 8) | w2s (kHC, Co + 8) | hs (kBM16, kHC + 8), all bf16;
// then one 16 x 16 fp32 staging tile per warp.  Row pitches are 16-byte multiples off the
// 32-byte wmma alignment, which spreads the fragment loads over the banks.
template <int NTH>  // output column tiles of 16 per warp: Co = 32 NTH
__global__ void __launch_bounds__(kThreads)
mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
                const bf16* __restrict__ w2, const float* __restrict__ b2, bf16* __restrict__ out, int M,
                int C, int H, int act) {
  namespace wm = nvcuda::wmma;
  constexpr int Co = 32 * NTH;
  constexpr int ldw1 = kHC + 8, ldw2 = Co + 8, ldh = kHC + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = C + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1s = xs + kBM16 * ldx;
  bf16* w2s = w1s + C * ldw1;
  bf16* hs = w2s + kHC * ldw2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stage = reinterpret_cast<float*>(hs + kBM16 * ldh) + warp * 256;
  const long row0 = (long)blockIdx.x * kBM16;

  // 16-byte copies: 8 bf16 each
  const int xv = C / 8;
  for (int e = tid; e < kBM16 * xv; e += kThreads) {
    const int r = e / xv, c = (e % xv) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < M) val = *reinterpret_cast<const uint4*>(x + (row0 + r) * C + c);
    *reinterpret_cast<uint4*>(xs + r * ldx + c) = val;
  }

  // warp w: row tile w / 2; hidden-chunk column tiles 4 (w % 2) ..+4, output column tiles NTH (w % 2) ..+NTH
  const int rt = warp >> 1, half = warp & 1;
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc_o[NTH];
#pragma unroll
  for (int j = 0; j < NTH; ++j) wm::fill_fragment(acc_o[j], 0.f);

  for (int h0 = 0; h0 < H; h0 += kHC) {
    __syncthreads();  // every warp is done with the last chunk's w1s, w2s and hs
    for (int e = tid; e < C * (kHC / 8); e += kThreads) {
      const int k = e / (kHC / 8), c = (e % (kHC / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + k * ldw1 + c) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)k * H + h0 + c);
    }
    for (int e = tid; e < kHC * (Co / 8); e += kThreads) {
      const int k = e / (Co / 8), c = (e % (Co / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + k * ldw2 + c) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)(h0 + k) * Co + c);
    }
    __syncthreads();
    wm::fragment<wm::accumulator, 16, 16, 16, float> acc_h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wm::fill_fragment(acc_h[j], 0.f);
    for (int k = 0; k < C; k += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
      wm::load_matrix_sync(a, xs + rt * 16 * ldx + k, ldx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
        wm::load_matrix_sync(b, w1s + k * ldw1 + (half * 4 + j) * 16, ldw1);
        wm::mma_sync(acc_h[j], a, b, acc_h[j]);
      }
    }
    // bias, activation and the rounding to bf16, one tile at a time through the warp's stage
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c0 = (half * 4 + j) * 16;
      wm::store_matrix_sync(stage, acc_h[j], 16, wm::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = c0 + e % 16;
        hs[(rt * 16 + r) * ldh + c] = __float2bfloat16(act_fn(stage[e] + b1[h0 + c], act, true));
      }
      __syncwarp();
    }
    __syncthreads();
    for (int k = 0; k < kHC; k += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
      wm::load_matrix_sync(a, hs + rt * 16 * ldh + k, ldh);
#pragma unroll
      for (int j = 0; j < NTH; ++j) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
        wm::load_matrix_sync(b, w2s + k * ldw2 + (half * NTH + j) * 16, ldw2);
        wm::mma_sync(acc_o[j], a, b, acc_o[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NTH; ++j) {
    const int c0 = (half * NTH + j) * 16;
    wm::store_matrix_sync(stage, acc_o[j], 16, wm::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const long r = row0 + rt * 16 + e / 16;
      const int c = c0 + e % 16;
      if (r < M) out[r * Co + c] = __float2bfloat16(stage[e] + b2[c]);
    }
    __syncwarp();
  }
}

// ---- fp32: CUDA cores -----------------------------------------------------
// shared: xs (kBM32, C) | hs (kBM32, kHC)
template <int NTH>  // Co = 32 NTH
__global__ void __launch_bounds__(kThreads)
mlp_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int M,
                int C, int H, int act) {
  constexpr int Co = 32 * NTH;
  constexpr int RB = kBM32 * Co / kThreads;  // output rows per thread (4 NTH)
  constexpr int RH = kBM32 * kHC / kThreads;  // hidden rows per thread (16)
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;
  float* hs = xs + kBM32 * C;
  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * kBM32;

  for (int e = tid; e < kBM32 * C; e += kThreads) {
    const int r = e / C;
    xs[e] = row0 + r < M ? x[row0 * C + e] : 0.f;
  }
  __syncthreads();

  const int ch = tid % kHC, rh0 = (tid / kHC) * RH;  // hidden column, first row
  const int co = tid % Co, ro0 = (tid / Co) * RB;    // output column, first row
  float acc_o[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc_o[i] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kHC) {
    float acc[RH];
#pragma unroll
    for (int i = 0; i < RH; ++i) acc[i] = 0.f;
    for (int k = 0; k < C; k += 4) {
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = __ldg(w1 + (size_t)(k + u) * H + h0 + ch);
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(xs + (rh0 + i) * C + k);
        acc[i] = fmaf(a.x, w[0], acc[i]);
        acc[i] = fmaf(a.y, w[1], acc[i]);
        acc[i] = fmaf(a.z, w[2], acc[i]);
        acc[i] = fmaf(a.w, w[3], acc[i]);
      }
    }
    __syncthreads();  // every thread is done reading hs from the last chunk
    const float bias = b1[h0 + ch];
#pragma unroll
    for (int i = 0; i < RH; ++i) hs[(rh0 + i) * kHC + ch] = act_fn(acc[i] + bias, act, false);
    __syncthreads();
    for (int k = 0; k < kHC; k += 4) {
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = __ldg(w2 + (size_t)(h0 + k + u) * Co + co);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(hs + (ro0 + i) * kHC + k);
        acc_o[i] = fmaf(a.x, w[0], acc_o[i]);
        acc_o[i] = fmaf(a.y, w[1], acc_o[i]);
        acc_o[i] = fmaf(a.z, w[2], acc_o[i]);
        acc_o[i] = fmaf(a.w, w[3], acc_o[i]);
      }
    }
  }
  const float bias = b2[co];
#pragma unroll
  for (int i = 0; i < RB; ++i)
    if (row0 + ro0 + i < M) out[(row0 + ro0 + i) * Co + co] = acc_o[i] + bias;
}

template <int NTH>
int run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out, int M, int C,
        int H, int act, int is_bf16, cudaStream_t st) {
  cudaError_t e;
  if (is_bf16) {
    const size_t smem = 2 * ((size_t)kBM16 * (C + 8) + (size_t)C * (kHC + 8) + (size_t)kHC * (32 * NTH + 8) +
                             (size_t)kBM16 * (kHC + 8)) + (size_t)(kThreads / 32) * 256 * 4;
    e = cudaFuncSetAttribute(mlp_bf16_kernel<NTH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    mlp_bf16_kernel<NTH><<<(M + kBM16 - 1) / kBM16, kThreads, smem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), M, C, H, act);
  } else {
    const size_t smem = (size_t)kBM32 * (C + kHC) * 4;
    e = cudaFuncSetAttribute(mlp_fp32_kernel<NTH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    mlp_fp32_kernel<NTH><<<(M + kBM32 - 1) / kBM32, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), M, C, H, act);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Takes C a multiple of 16 up to 256, H a multiple of 128, Co 32, 64, 128 or 256.
extern "C" int catseg_mlp(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                          int M, int C, int H, int Co, int act, int is_bf16, void* stream) {
  if (M <= 0 || C <= 0 || C % 16 || C > 256 || H <= 0 || H % kHC || (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (Co) {
    case 32: return run<1>(x, w1, b1, w2, b2, out, M, C, H, act, is_bf16, st);
    case 64: return run<2>(x, w1, b1, w2, b2, out, M, C, H, act, is_bf16, st);
    case 128: return run<4>(x, w1, b1, w2, b2, out, M, C, H, act, is_bf16, st);
    case 256: return run<8>(x, w1, b1, w2, b2, out, M, C, H, act, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
