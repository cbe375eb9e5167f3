// Building blocks of the backward kernels (swin_block_bwd.cu,
// class_layer_bwd.cu, decoder_bwd.cu), sm_90a.
//
// A backward entry point recomputes its forward into a caller-allocated fp32
// workspace and then walks the stages in reverse with four kinds of kernel:
//
// - gemm: C = A B on CUDA-core FMAs (64x64 or 128x32 tiles, 16-deep k
//   steps, a 4x4 or 8x2 micro-tile per thread), with A and B read through
//   loader functors (dense, transposed, im2col of an NHWC plane, GroupNorm +
//   ReLU applied on the fly) and each output handed to an epilogue functor,
//   so bias, rounding, activation derivatives and scatters fuse into it;
// - wgrad: a weight gradient sum_m A(m, r) B(m, c) over every row of the
//   batch as a split-K gemm into per-split partials, then sum_mid over the
//   splits in a fixed order, so results do not depend on scheduling (no
//   atomics anywhere); an optional all-ones row gives the bias gradient;
// - ln_fwd / ln_bwd: 128-wide LayerNorm rows, one warp per row, with the
//   forward kernels' exact statistics and per-block partials of the
//   gain/bias gradients;
// - sum_mid: out[o, r, c] = sum_i in[o, i, r, c] for strided inputs (split
//   partials, guidance gradients summed over classes or positions).
//
// Everything is fp32 in the workspace; values are rounded through the
// storage type T (rnd<T>) where the forward kernels round, so the bf16
// recompute sees the forward's numbers.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace catseg {
namespace bwd {

template <class X> struct Id { using type = X; };

#define CATSEG_TRY(expr)                    \
  do {                                      \
    const cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Launch k on st; dynamic shared memory above 48 KB is opted into first.
template <typename... KArgs>
inline cudaError_t launch_k(void (*k)(KArgs...), dim3 g, dim3 b, size_t smem, cudaStream_t st,
                            typename Id<KArgs>::type... args) {
  if (g.x == 0 || g.y == 0 || g.z == 0) return cudaSuccess;
  if (smem > 48 * 1024)
    CATSEG_TRY(cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  k<<<g, b, smem, st>>>(args...);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- loaders
// A loader maps (i, j) to a float; kFast2 says the second index is the
// contiguous one in memory, which picks the coalesced tile-load order.

template <class S> struct Dense {  // p[i * ld + j]
  const S* p;
  long long ld;
  static constexpr bool kFast2 = true;
  __device__ __forceinline__ float operator()(long long i, long long j) const { return to_f(p[i * ld + j]); }
};

template <class S> struct DenseT {  // p[j * ld + i]: the transposed view
  const S* p;
  long long ld;
  static constexpr bool kFast2 = false;
  __device__ __forceinline__ float operator()(long long i, long long j) const { return to_f(p[j * ld + i]); }
};

template <class L> struct AugOnes {  // rows >= R read 1 (bias gradients in wgrad)
  L l;
  int R;
  static constexpr bool kFast2 = L::kFast2;
  __device__ __forceinline__ float operator()(long long i, long long j) const { return i < R ? l(i, j) : 1.f; }
};

// --------------------------------------------------------------- epilogues

struct Store {  // C[m, n] at row stride ld
  float* p;
  long long ld;
  __device__ __forceinline__ void operator()(long long m, long long n, float v, int) const { p[m * ld + n] = v; }
};

struct Partial {  // split z's partial (rows, cols) block
  float* p;
  long long rows, cols;
  __device__ __forceinline__ void operator()(long long m, long long n, float v, int z) const {
    p[(z * rows + m) * cols + n] = v;
  }
};

// ------------------------------------------------------------------- gemm

constexpr int kGK = 16, kGT = 256;
constexpr int kWSplits = 128;  // wgrad splits of the batch-row sum

template <int BM, int BN, class LA, class LB, class Epi>
__global__ void __launch_bounds__(kGT) gemm_kernel(LA la, LB lb, Epi epi, int M, int N, int K, int kchunk) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float As[kGK][BM + 1];
  __shared__ float Bs[kGK][BN + 1];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += kGK) {
    for (int i = threadIdx.x; i < BM * kGK; i += kGT) {
      int r, c;
      if (LA::kFast2) { c = i % kGK; r = i / kGK; } else { r = i % BM; c = i / BM; }
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < ke) ? la(m, k) : 0.f;
    }
    for (int i = threadIdx.x; i < BN * kGK; i += kGT) {
      int r, c;
      if (LB::kFast2) { c = i % BN; r = i / BN; } else { r = i % kGK; c = i / kGK; }
      const int n = n0 + c, k = k0 + r;
      Bs[r][c] = (n < N && k < ke) ? lb(k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) epi(m, n, acc[i][j], (int)blockIdx.z);
    }
}

// k-chunk of a split-K gemm (a multiple of the k step) and the splits it gives
inline int split_chunk(int K, int splits) { return cdiv(cdiv(K, splits), kGK) * kGK; }
inline int split_count(int K, int splits) { return cdiv(K, split_chunk(K, splits)); }

// epi(m, n, sum_k A(m, k) B(k, n), split) for m < M, n < N; K split in `splits`
template <class LA, class LB, class Epi>
cudaError_t gemm(LA la, LB lb, Epi epi, int M, int N, int K, cudaStream_t st, int splits = 1) {
  const int kc = split_chunk(K, splits), z = split_count(K, splits);
  if (N <= 32)
    return launch_k(gemm_kernel<128, 32, LA, LB, Epi>, dim3(cdiv(M, 128), cdiv(N, 32), z), dim3(kGT), 0, st,
                    la, lb, epi, M, N, K, kc);
  return launch_k(gemm_kernel<64, 64, LA, LB, Epi>, dim3(cdiv(M, 64), cdiv(N, 64), z), dim3(kGT), 0, st, la,
                  lb, epi, M, N, K, kc);
}

// ---------------------------------------------------------------- sum_mid

// out[(o * R + r) * Cc + c] = sum_{i < n} in[((o * n + i) * R + r) * ld + off + c], i in order
static __global__ void __launch_bounds__(256) sum_mid_kernel(const float* in, float* out, long long outer, int n,
                                                      long long R, int Cc, long long ld, int off) {
  const long long total = outer * R * Cc;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long c = idx % Cc, r = (idx / Cc) % R, o = idx / (Cc * R);
    const float* p = in + ((o * n) * R + r) * ld + off + c;
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += p[(long long)i * R * ld];
    out[idx] = s;
  }
}

static inline cudaError_t sum_mid(const float* in, float* out, long long outer, int n, long long R, int Cc, long long ld,
                           int off, cudaStream_t st) {
  const long long total = outer * R * Cc;
  return launch_k(sum_mid_kernel, dim3(std::min(cdiv(total, 256), 4096)), dim3(256), 0, st, in, out, outer, n, R, Cc,
                  ld, off);
}

// out (rows, Cc), rows = R (+1 with aug) = sum_m A(r, m) B(m, c) (+ the bias
// row sum_m B(m, c)); part holds kWSplits * rows * Cc floats.
template <class LA, class LB>
cudaError_t wgrad(LA la, LB lb, int R, bool aug, int Cc, int Mred, float* out, float* part, cudaStream_t st) {
  const int rows = R + (aug ? 1 : 0);
  CATSEG_TRY(gemm(AugOnes<LA>{la, R}, lb, Partial{part, rows, Cc}, rows, Cc, Mred, st, kWSplits));
  return sum_mid(part, out, 1, split_count(Mred, kWSplits), 1, rows * Cc, (long long)rows * Cc, 0, st);
}

// --------------------------------------------------------------- LayerNorm

constexpr int kLNBlocks = 512;  // ln_bwd partials: at most this many blocks
inline int ln_blocks(long long M) { return std::min(cdiv(M, 8), kLNBlocks); }

// y = rnd<T>(LN(x)) fp32 and stats (mean, rstd) of 128-wide rows; the
// forward kernels' statistics (single-pass variance for bf16, eps 1e-5)
template <typename T, typename S>
__global__ void __launch_bounds__(256) ln_fwd_kernel(const S* x, const float* g, const float* b, float* y,
                                                     float* stats, long long M) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long r = (long long)blockIdx.x * 8 + warp; r < M; r += (long long)gridDim.x * 8) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = to_f(x[r * 128 + lane + 32 * i]);
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
    const float rs = rsqrtf(var + 1e-5f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      y[r * 128 + c] = rnd<T>((v[i] - mean) * rs * g[c] + b[c]);
    }
    if (lane == 0) {
      stats[2 * r] = mean;
      stats[2 * r + 1] = rs;
    }
  }
}

template <typename T, typename S>
cudaError_t ln_fwd(const S* x, const float* g, const float* b, float* y, float* stats, long long M,
                   cudaStream_t st) {
  return launch_k(ln_fwd_kernel<T, S>, dim3(std::min(cdiv(M, 8), 4096)), dim3(256), 0, st, x, g, b, y, stats, M);
}

// dx = res + LN'(dy) per row (res may be null); block partials of
// sum dy * xhat (gain) and sum dy (bias) -> part[block][256]
template <typename S, typename Rs, typename D>
__global__ void __launch_bounds__(256) ln_bwd_kernel(const float* dy, const S* x, const float* stats,
                                                     const float* g, const Rs* res, D* dx, float* part,
                                                     long long M) {
  __shared__ float red[8][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ag[4] = {0.f, 0.f, 0.f, 0.f}, ab[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long r = (long long)blockIdx.x * 8 + warp; r < M; r += (long long)gridDim.x * 8) {
    const float mean = stats[2 * r], rs = stats[2 * r + 1];
    float xh[4], dh[4], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      xh[i] = (to_f(x[r * 128 + c]) - mean) * rs;
      const float d = dy[r * 128 + c];
      ag[i] += d * xh[i];
      ab[i] += d;
      dh[i] = d * g[c];
      s1 += dh[i];
      s2 += dh[i] * xh[i];
    }
    s1 = warp_sum(s1) * (1.f / 128.f);
    s2 = warp_sum(s2) * (1.f / 128.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      float v = rs * (dh[i] - s1 - xh[i] * s2);
      if (res) v += to_f(res[r * 128 + c]);
      dx[r * 128 + c] = from_f<D>(v);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red[warp][lane + 32 * i] = ag[i];
    red[warp][128 + lane + 32 * i] = ab[i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 256; j += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w][j];
    part[(long long)blockIdx.x * 256 + j] = s;
  }
}

// dx and out[256] = (d gain (128), d bias (128)); part: kLNBlocks * 256 floats
template <typename S, typename Rs, typename D>
cudaError_t ln_bwd(const float* dy, const S* x, const float* stats, const float* g, const Rs* res, D* dx,
                   float* out, float* part, long long M, cudaStream_t st) {
  const int nb = ln_blocks(M);
  CATSEG_TRY(launch_k(ln_bwd_kernel<S, Rs, D>, dim3(nb), dim3(256), 0, st, dy, x, stats, g, res, dx, part, M));
  return sum_mid(part, out, 1, nb, 1, 256, 256, 0, st);
}

// consecutive fp32 regions of a workspace; with a null base it only counts
struct Carve {
  float* base;
  long long used = 0;
  float* take(long long n) {
    float* r = base ? base + used : nullptr;
    used += (n + 63) / 64 * 64;
    return r;
  }
};

}  // namespace bwd
}  // namespace catseg
