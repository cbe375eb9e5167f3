// Building blocks of the backward kernels (swin_block_bwd.cu,
// class_layer_bwd.cu, decoder_bwd.cu), sm_90a.
//
// A backward entry point recomputes its forward into a caller-allocated
// workspace and then walks the stages in reverse.  Two engines run the
// matrix products:
//
// - gemm (the fp32 paths): C = A B on CUDA-core FMAs
//   (64x64 or 128x32 tiles, 16-deep k steps, a 4x4 or 8x2 micro-tile per
//   thread), with A and B read element by element through loader functors
//   (dense, transposed, im2col of an NHWC plane, GroupNorm + ReLU applied on
//   the fly) and each output handed to an epilogue functor, so bias,
//   rounding, activation derivatives and scatters fuse into it;
// - tc::gemm (the bf16 paths of all three backward kernels): bf16
//   mma.sync m16n8k16 with fp32 accumulation.  A and B tiles land in shared
//   memory by 16-byte cp.async in a ring of 3 to 6 stages, each 16-byte chunk
//   eight consecutive elements of one row of a bf16 source (a dense row, a
//   token's channels, one tap's channel run of an NHWC plane, one phase of a
//   ConvT's output), XOR-swizzled so that ldmatrix reads them without bank
//   conflicts.  A is read as stored (m, k) rows by ldmatrix, or as stored
//   (k, m) rows by ldmatrix.trans (the transposed operand of a weight
//   gradient), or, for a 3x3 conv's recompute and input grads, from a halo
//   tile: the input rows a tile of whole output rows touches, landed once,
//   each tap read by ldmatrix at shifted rows (no 9-fold reload of the
//   im2col); B always as stored (k, n) rows by ldmatrix.trans.  An operand
//   the plain version keeps in fp32 arrives as a bf16 pair hi + lo (hi =
//   bf16(v), lo = bf16(v - hi): 16 significant bits, finer than TF32's 11),
//   its tile loaded twice and multiplied twice into the same accumulators.
//   Epilogues get two adjacent columns of the accumulator fragments;
// - wgrad / tc::wgrad: a weight gradient sum_m A(m, r) B(m, c) over every row
//   of the batch as a split-K product into per-split partials, then sum_mid
//   over the splits in a fixed order, so results do not depend on scheduling
//   (no atomics anywhere); an optional extra row gives the bias gradient
//   (the fp32 wgrad multiplies an all-ones row in; tc::wgrad sums the B
//   tiles' columns as they pass through shared memory);
// - ln_fwd / ln_bwd: 128-wide LayerNorm rows, one warp per row, with the
//   forward kernels' exact statistics and per-block partials of the
//   gain/bias gradients;
// - sum_mid: out[o, r, c] = sum_i in[o, i, r, c] for strided inputs (split
//   partials, guidance gradients summed over classes or positions).
//
// The fp32 paths keep everything fp32 in the workspace; values are rounded
// through the storage type T (rnd<T>) where the forward kernels round, so the
// bf16 recompute sees the forward's numbers, and the bf16 paths store those
// bf16-exact values as bf16.
#pragma once

#include <algorithm>
#include <type_traits>

#include "attn_common.cuh"
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
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    *reinterpret_cast<float2*>(p + m * ld + n) = make_float2(v0, v1);
  }
};

struct Partial {  // split z's partial (rows, cols) block
  float* p;
  long long rows, cols;
  __device__ __forceinline__ void operator()(long long m, long long n, float v, int z) const {
    p[(z * rows + m) * cols + n] = v;
  }
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int z) const {
    *reinterpret_cast<float2*>(p + (z * rows + m) * cols + n) = make_float2(v0, v1);
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

// element readers of sum_mid: fp32, bf16, or a bf16 pair hi + lo
// (lo lo elements after hi)
struct F32In {
  const float* p;
  __device__ __forceinline__ float operator()(long long i) const { return p[i]; }
};
struct Bf16In {
  const bf16* p;
  __device__ __forceinline__ float operator()(long long i) const { return __bfloat162float(p[i]); }
};
struct SplitIn {
  const bf16* p;
  long long lo;
  __device__ __forceinline__ float operator()(long long i) const {
    return __bfloat162float(p[i]) + __bfloat162float(p[i + lo]);
  }
};

// out[(o * R + r) * Cc + c] = sum_{i < n} in[((o * n + i) * R + r) * ld + off + c], i in order
template <class In>
__global__ void __launch_bounds__(256) sum_mid_kernel(In in, float* out, long long outer, int n, long long R, int Cc,
                                                      long long ld, int off) {
  const long long total = outer * R * Cc;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long c = idx % Cc, r = (idx / Cc) % R, o = idx / (Cc * R);
    const long long p = ((o * n) * R + r) * ld + off + c;
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += in(p + (long long)i * R * ld);
    out[idx] = s;
  }
}

template <class In>
inline cudaError_t sum_mid_in(In in, float* out, long long outer, int n, long long R, int Cc, long long ld, int off,
                           cudaStream_t st) {
  const long long total = outer * R * Cc;
  return launch_k(sum_mid_kernel<In>, dim3(std::min(cdiv(total, 256), 4096)), dim3(256), 0, st, in, out, outer, n, R,
                  Cc, ld, off);
}

static inline cudaError_t sum_mid(const float* in, float* out, long long outer, int n, long long R, int Cc, long long ld,
                                  int off, cudaStream_t st) {
  return sum_mid_in(F32In{in}, out, outer, n, R, Cc, ld, off, st);
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

// y = rnd<T>(LN(x)) (stored as Y: fp32, or bf16 for the tensor-core
// products) and stats (mean, rstd) of 128-wide rows; the forward kernels'
// statistics (single-pass variance for bf16, eps 1e-5)
template <typename T, typename S, typename Y>
__global__ void __launch_bounds__(256) ln_fwd_kernel(const S* x, const float* g, const float* b, Y* y,
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
      y[r * 128 + c] = from_f<Y>(rnd<T>((v[i] - mean) * rs * g[c] + b[c]));
    }
    if (lane == 0) {
      stats[2 * r] = mean;
      stats[2 * r + 1] = rs;
    }
  }
}

template <typename T, typename S, typename Y>
cudaError_t ln_fwd(const S* x, const float* g, const float* b, Y* y, float* stats, long long M,
                   cudaStream_t st) {
  return launch_k(ln_fwd_kernel<T, S, Y>, dim3(std::min(cdiv(M, 8), 4096)), dim3(256), 0, st, x, g, b, y, stats,
                  M);
}

// dx = res + LN'(dy) per row (res may be null); block partials of
// sum dy * xhat (gain) and sum dy (bias) -> part[block][256]
template <typename DY, typename S, typename Rs, typename D>
__global__ void __launch_bounds__(256) ln_bwd_kernel(const DY* dy, const S* x, const float* stats,
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
      const float d = to_f(dy[r * 128 + c]);
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
template <typename DY, typename S, typename Rs, typename D>
cudaError_t ln_bwd(const DY* dy, const S* x, const float* stats, const float* g, const Rs* res, D* dx,
                   float* out, float* part, long long M, cudaStream_t st) {
  const int nb = ln_blocks(M);
  CATSEG_TRY(launch_k(ln_bwd_kernel<DY, S, Rs, D>, dim3(nb), dim3(256), 0, st, dy, x, stats, g, res, dx, part, M));
  return sum_mid(part, out, 1, nb, 1, 256, 256, 0, st);
}

// ---------------------------------------------------- tensor-core engine

namespace tc {

// A source maps (i, j), j a multiple of 8, to the address of eight
// consecutive bf16 elements (i, j .. j + 7) of its storage, or null for
// zeros (padding), in two steps: row(i), what depends on i alone, and
// at(row, j); step(row, d) moves a row's state on to row i + d.  kSplit
// sources are hi + lo pairs, lo lo elements after hi.  As the A operand a
// source is read at (m, k) (rows mode) or at (k, m) (transposed mode); as
// the B operand at (k, n).  A thread lands the same (row, chunk) slots of
// a tile at every k step, so it takes row() once: in rows mode its rows
// stay, otherwise they move by one k step each time (step).  Indices are
// 32-bit.

template <bool S> struct Rows {  // p[i * ld + j]
  const bf16* p;
  long long ld, lo;
  static constexpr bool kSplit = S, kHalo = false;
  using Row = const bf16*;
  __device__ __forceinline__ Row row(int i) const { return p + i * ld; }
  __device__ __forceinline__ void step(Row& r, int d) const { r += d * ld; }
  __device__ __forceinline__ const bf16* at(Row r, int j) const { return r + j; }
};

// bf16 rows out[m * ld + n], n and n + 1
struct StoreBf16 {
  bf16* p;
  long long ld;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    store_bf16x2(p + m * ld + n, v0, v1);
  }
};

// an fp32 value as the pair hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_store(bf16* hi, long long lo, float v0, float v1) {
  const float2 h = __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
  store_bf16x2(hi, h.x, h.y);
  store_bf16x2(hi + lo, v0 - h.x, v1 - h.y);
}

struct StoreSplit {  // hi / lo planes, row stride ld
  bf16* p;
  long long ld, lo;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    split_store(p + m * ld + n, lo, v0, v1);
  }
};

constexpr int kBK = 32, kThreads = 256;
constexpr int kRingBytes = 96 * 1024;   // shared memory a CTA's tiles may take beyond a halo

// the shared-memory layout: a ring of (A, B) tiles, hi then lo of a split
// operand, as many stages (3 to 6) as kRingBytes holds beside a halo, so
// small tiles keep more loads in flight; with a halo source (AH elements a
// tile) its tiles come first, landed once, and the ring holds B alone
template <int BM, int BN, bool AT, bool SA, bool SB, int AH = 0> struct Tiles {
  static constexpr int RCA = AT ? alloc_chunks(BM / 8) : kBK / 8;            // chunks a stored row of A
  static constexpr int A = AH ? 0 : AT ? kBK * RCA * 8 : BM * kBK;           // elements of one A tile
  static constexpr int RCB = alloc_chunks(BN / 8);
  static constexpr int B = kBK * RCB * 8;
  static constexpr int STAGE = (SA ? 2 : 1) * A + (SB ? 2 : 1) * B;
  static constexpr int HALO = (SA ? 2 : 1) * AH;
  static constexpr int FIT = (kRingBytes / (int)sizeof(bf16) - HALO) / STAGE;
  static constexpr int STAGES = FIT < 3 ? 3 : FIT > 6 ? 6 : FIT;
  static constexpr size_t BYTES = ((size_t)HALO + (size_t)STAGES * STAGE) * sizeof(bf16);
};

// A halo source (kHalo) is a 3x3 conv's A operand, rows the output pixels of
// whole image rows of one slab, columns tap * C + c: the kernel lands the
// input rows a tile of BM outputs touches, with their zero padding, as one
// (BM / Wd + 2) x (Wd + 2)-pixel tile and reads every tap from it.
template <class SA, int BM, bool = SA::kHalo> struct HaloGeom {
  static constexpr int HR = 0, HW = 0, RC = 2, ELEMS = 0;
};
template <class SA, int BM> struct HaloGeom<SA, BM, true> {
  static constexpr int HR = BM / SA::kWd + 2, HW = SA::kWd + 2, RC = alloc_chunks(SA::kC / 8);
  static constexpr int ELEMS = HR * HW * RC * 8;
};

template <class S, bool Use> struct RowT { using type = int; };
template <class S> struct RowT<S, true> { using type = typename S::Row; };
struct NoMove {
  template <class S> __device__ __forceinline__ void init(const S&, int) {}
};

// one tile's chunks by cp.async: R rows of C chunks at (i0 + r, j0 + 8 c),
// zero-filled where src gives null or the chunk is out of range; a split
// source's lo tile LO elements after its hi tile
template <int LO, class Src>
__device__ __forceinline__ void land_chunk(bf16* d, const Src& src, const bf16* p, const bf16* dummy) {
  cp_async16(d, p ? p : dummy, p != nullptr);
  if constexpr (Src::kSplit) cp_async16(d + LO, p ? p + src.lo : dummy, p != nullptr);
}

// a thread's chunks (r, c) of an R x C-chunk tile whose rows move by one k
// step a load: chunk e = threadIdx.x + kThreads q, r = e / C, c = e % C
template <int R, int C, class Src> struct Moving {
  static constexpr int Q = (R * C + kThreads - 1) / kThreads;
  typename Src::Row cur[Q];

  __device__ __forceinline__ void init(const Src& src, int i0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) cur[q] = src.row(i0 + (int)(threadIdx.x + kThreads * q) / C);
  }

  // rows i0 .. i0 + R - 1 (valid below i1), columns j0 + 8 c (below j1)
  template <int RC, int LO>
  __device__ __forceinline__ void land(bf16* tile, const Src& src, int i0, int i1, int j0, int j1,
                                       const bf16* dummy) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int e = threadIdx.x + kThreads * q;
      if (e < R * C) {
        const int r = e / C, c = e % C, j = j0 + 8 * c;
        land_chunk<LO>(tile + swz<RC>(r, c), src, (i0 + r < i1 && j < j1) ? src.at(cur[q], j) : nullptr, dummy);
        src.step(cur[q], R);
      }
    }
  }
};

// C (M, N) = A (M, K) B (K, N) for the k range of split blockIdx.z, each pair
// of adjacent outputs handed to epi(m, n, c(m, n), c(m, n + 1), split).
// 8 warps in WM x (8 / WM), a warp tile (BM / WM) x (BN * WM / 8); k steps
// of 32 in a ring of L::STAGES tiles.  N and the dimension A's chunks run
// along (K in rows mode, M transposed) are multiples of 8; the batch rows
// (M in rows mode, K transposed) may be ragged: their tiles are zero-filled
// past the end.  Element offsets below 2^31.
// RN: each mma sums its 16 products into zeroed accumulators and an fp32
// add (round to nearest) takes them into the running sums, where an mma
// adding into the running sums would align them with truncation at every k
// step; for a product whose outputs are rounded to bf16 and feed a ReLU,
// as the plain version's round-to-nearest sums do.
// BIAS: the CTAs of m tile 0 also sum B's columns over their k range and
// hand each sum to epi(M, n, sum, split), row M of a weight gradient.
template <int BM, int BN, int WM, bool AT, bool RN, bool BIAS, class SA, class SB, class Epi>
__global__ void __launch_bounds__(kThreads) gemm_kernel(SA sa, SB sb, Epi epi, int M, int N, int K, int kchunk,
                                                        const bf16* dummy) {
  constexpr bool HALO = SA::kHalo;
  using H = HaloGeom<SA, BM>;
  using L = Tiles<BM, BN, AT, SA::kSplit, SB::kSplit, H::ELEMS>;
  constexpr int WN = 8 / WM, WTM = BM / WM, WTN = BN / WN, MS = WTM / 16, NT = WTN / 8;
  constexpr int HA = SA::kSplit ? 2 : 1, HB = SB::kSplit ? 2 : 1;
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "warp tiles of whole m16 strips and n16 pairs");
  static_assert(!BIAS || (kThreads % BN == 0 && kBK % (kThreads / BN) == 0), "bias rows split evenly");
  constexpr int kBR = kThreads / BN;   // row phases of the bias sums
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* sm = reinterpret_cast<bf16*>(tc_smem);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  const int nk = (ke - kb + kBK - 1) / kBK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp % WM) * WTM, wn0 = (warp / WM) * WTN;

  // rows mode: thread t lands chunk t % 4 of A rows t / 4 + 64 q, the same every k step
  constexpr bool ROWS = !AT && !HALO;
  constexpr int QA = ROWS ? BM / 64 : 1;
  static_assert(!ROWS || BM % 64 == 0, "rows-mode A tiles of whole 64-row groups");
  typename RowT<SA, ROWS>::type arow[QA];
  std::conditional_t<AT, Moving<kBK, BM / 8, SA>, NoMove> amov;   // transposed mode
  Moving<kBK, BN / 8, SB> bmov;
  bf16* ring = sm + L::HALO;
  if constexpr (AT)
    amov.init(sa, kb);
  if constexpr (ROWS)
#pragma unroll
    for (int q = 0; q < QA; ++q) arow[q] = sa.row(min(m0 + (int)threadIdx.x / 4 + 64 * q, M - 1));
  bmov.init(sb, kb);
  int hb[MS];   // halo: the tile pixel of this lane's A row in strip s at tap (0, 0)
  if constexpr (HALO) {
    constexpr int C = SA::kC, Wd = SA::kWd, P = Wd * Wd, CC = C / 8;
    static_assert(!AT && !BIAS && BM % Wd == 0 && P % BM == 0 && C % 16 == 0, "halo tiles of whole rows");
    const int y0 = (m0 % P) / Wd;
    const bf16* slab = sa.p + (long long)(m0 - m0 % P) * C;
    for (int e = threadIdx.x; e < H::HR * H::HW * CC; e += kThreads) {   // in the first commit group
      const int hp = e / CC, c = e % CC, y = y0 - 1 + hp / H::HW, x = hp % H::HW - 1;
      land_chunk<H::ELEMS>(sm + swz<H::RC>(hp, c), sa,
                           y >= 0 && y < Wd && x >= 0 && x < Wd ? slab + (y * Wd + x) * C + 8 * c : nullptr, dummy);
    }
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      const int m = wm0 + 16 * s + (lane & 7) + ((lane >> 3) & 1) * 8;
      hb[s] = m / Wd * H::HW + m % Wd;
    }
  }
  auto load = [&](int slot, int kt) {   // called for kt = 0, 1, 2, ... in turn
    bf16* As = ring + slot * L::STAGE;
    bf16* Bs = As + HA * L::A;
    const int k0 = kb + kt * kBK;
    if constexpr (AT) {
      amov.template land<L::RCA, L::A>(As, sa, k0, ke, m0, M, dummy);
    } else if constexpr (ROWS) {
      const int c = threadIdx.x % 4, k = k0 + 8 * c;
#pragma unroll
      for (int q = 0; q < QA; ++q) {
        const int r = threadIdx.x / 4 + 64 * q;
        land_chunk<L::A>(As + swz<L::RCA>(r, c), sa, (m0 + r < M && k < ke) ? sa.at(arow[q], k) : nullptr, dummy);
      }
    }
    bmov.template land<L::RCB, L::B>(Bs, sb, k0, ke, n0, N, dummy);
  };

  float acc[MS][NT][4], bsum = 0.f;
#pragma unroll
  for (int s = 0; s < MS; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[s][j][0] = acc[s][j][1] = acc[s][j][2] = acc[s][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();   // tile kt landed for every thread; slot (kt - 1) % L::STAGES is free
    if (kt + L::STAGES - 1 < nk) load((kt + L::STAGES - 1) % L::STAGES, kt + L::STAGES - 1);
    cp_async_commit();
    const bf16* As = ring + (kt % L::STAGES) * L::STAGE;
    const bf16* Bs = As + HA * L::A;
    if constexpr (BIAS) {   // thread t: column t % BN, rows t / BN + kBR i
      if (blockIdx.x == 0) {
        float v[kBK / kBR];
#pragma unroll
        for (int i = 0; i < kBK / kBR; ++i) {
          const int o = swz<L::RCB>(threadIdx.x / BN + kBR * i, (threadIdx.x % BN) >> 3) + (threadIdx.x & 7);
          v[i] = __bfloat162float(Bs[o]);
          if constexpr (HB == 2) v[i] += __bfloat162float(Bs[L::B + o]);
        }
#pragma unroll
        for (int i = 0; i < kBK / kBR; ++i) bsum += v[i];
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned a[HA][MS][4], b[HB][NT][2];
      int sh = 0, hc = 0;   // halo: the tap's pixel shift and this lane's channel chunk
      if constexpr (HALO) {
        const int k = kb + kt * kBK + 16 * kk, tap = k / SA::kC;
        if (k >= ke) continue;   // past the last tap: nothing to read
        sh = tap / 3 * H::HW + tap % 3;
        hc = (k - tap * SA::kC) / 8 + (lane >> 4);
      }
#pragma unroll
      for (int h = 0; h < HA; ++h)
#pragma unroll
        for (int s = 0; s < MS; ++s) {
          const int r0 = wm0 + 16 * s;
          if constexpr (HALO)
            ldmatrix_x4(a[h][s], sm + h * H::ELEMS + swz<H::RC>(hb[s] + sh, hc));
          else if constexpr (AT)
            ldmatrix_x4_trans(a[h][s], As + h * L::A + swz<L::RCA>(16 * kk + (lane & 7) + ((lane >> 4) & 1) * 8,
                                                                  r0 / 8 + ((lane >> 3) & 1)));
          else
            ldmatrix_x4(a[h][s], As + h * L::A + swz<L::RCA>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                            2 * kk + (lane >> 4)));
        }
#pragma unroll
      for (int h = 0; h < HB; ++h)
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          unsigned r[4];
          ldmatrix_x4_trans(r, Bs + h * L::B + swz<L::RCB>(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                           (wn0 + 16 * p) / 8 + (lane >> 4)));
          b[h][2 * p][0] = r[0];
          b[h][2 * p][1] = r[1];
          b[h][2 * p + 1][0] = r[2];
          b[h][2 * p + 1][1] = r[3];
        }
#pragma unroll
      for (int s = 0; s < MS; ++s)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (RN) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(d, a[0][s], b[0][j][0], b[0][j][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[s][j][e] += d[e];
          } else {
            mma_bf16(acc[s][j], a[0][s], b[0][j][0], b[0][j][1]);
          }
          if constexpr (HB == 2) mma_bf16(acc[s][j], a[0][s], b[1][j][0], b[1][j][1]);
          if constexpr (HA == 2) mma_bf16(acc[s][j], a[1][s], b[0][j][0], b[0][j][1]);
        }
    }
  }
  cp_async_wait<0>();
  if constexpr (BIAS) {   // the kBR row phases of each column, summed in order
    if (blockIdx.x == 0) {
      float* red = reinterpret_cast<float*>(tc_smem);
      __syncthreads();
      red[threadIdx.x] = bsum;
      __syncthreads();
      if (threadIdx.x < BN && n0 + (int)threadIdx.x < N) {
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < kBR; ++r) v += red[r * BN + threadIdx.x];
        epi((long long)M, (long long)(n0 + threadIdx.x), v, (int)blockIdx.z);
      }
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < MS; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = m0 + wm0 + 16 * s + g, n = n0 + wn0 + 8 * j + 2 * t;
      if (n < N) {
        if (m < M) epi(m, n, acc[s][j][0], acc[s][j][1], (int)blockIdx.z);
        if (m + 8 < M) epi(m + 8, n, acc[s][j][2], acc[s][j][3], (int)blockIdx.z);
      }
    }
}

// epi over C = A B (see gemm_kernel); AT: A read from stored (k, m) rows.
// K split in `splits` k ranges (multiples of the k step), blockIdx.z each.
inline int split_chunk(int K, int splits) { return cdiv(cdiv(K, splits), kBK) * kBK; }
inline int split_count(int K, int splits) { return cdiv(K, split_chunk(K, splits)); }

template <int BM, int BN, int WM, bool AT = false, bool RN = false, bool BIAS = false, class SA, class SB, class Epi>
cudaError_t gemm(SA sa, SB sb, Epi epi, int M, int N, int K, const void* dummy, cudaStream_t st, int splits = 1) {
  if (N % 8 || (AT ? M : K) % 8 || (SA::kHalo && (M % BM || splits != 1))) return cudaErrorInvalidValue;
  const int kc = split_chunk(K, splits), z = split_count(K, splits);
  return launch_k(gemm_kernel<BM, BN, WM, AT, RN, BIAS, SA, SB, Epi>, dim3(cdiv(M, BM), cdiv(N, BN), z), dim3(kThreads),
                  Tiles<BM, BN, AT, SA::kSplit, SB::kSplit, HaloGeom<SA, BM>::ELEMS>::BYTES, st, sa, sb, epi, M, N,
                  K, kc, static_cast<const bf16*>(dummy));
}

// out (M (+1 with BIAS), N) = sum_k A(k, m) B(k, n) over the K rows of the
// batch (the bias row: sum_k B(k, n)): kWSplits split-K partials (part:
// kWSplits * (M + 1) * N floats), summed in order
template <int BM, int BN, int WM, bool BIAS = false, class SA, class SB>
cudaError_t wgrad(SA sa, SB sb, int M, int N, int K, float* out, float* part, const void* dummy, cudaStream_t st) {
  const long long rows = M + (BIAS ? 1 : 0);
  CATSEG_TRY((gemm<BM, BN, WM, true, false, BIAS>(sa, sb, Partial{part, rows, N}, M, N, K, dummy, st, kWSplits)));
  return sum_mid(part, out, 1, split_count(K, kWSplits), 1, rows * N, rows * N, 0, st);
}

// a bf16 (K, N) weight from its fp32 copy (already rounded through bf16):
// mode 0 as it is; 1 transposed, (N, K); 2 a 3x3 conv's (9 Cin, Cout) taps
// flipped with channels transposed, (9 Cout, Cin): row t Cout + co, column ci
// = W[(8 - t) Cin + ci, co], the input gradient's B operand
static __global__ void __launch_bounds__(256) pack_kernel(const float* w, bf16* out, int K, int N, int mode) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < K * N; e += gridDim.x * blockDim.x) {
    int src = e;
    if (mode == 1) src = (e % K) * N + e / K;
    if (mode == 2) {
      const int cin = K / 9, r = e / cin, ci = e % cin, t = r / N, co = r % N;
      src = ((8 - t) * cin + ci) * N + co;
    }
    out[e] = __float2bfloat16(w[src]);
  }
}

static inline cudaError_t pack(const float* w, bf16* out, int K, int N, int mode, cudaStream_t st) {
  return launch_k(pack_kernel, dim3(std::min(cdiv((long long)K * N, 256), 1024)), dim3(256), 0, st, w, out, K, N,
                  mode);
}

}  // namespace tc

// consecutive fp32 regions of a workspace; with a null base it only counts
struct Carve {
  float* base;
  long long used = 0;
  float* take(long long n) {
    float* r = base ? base + used : nullptr;
    used += (n + 63) / 64 * 64;
    return r;
  }
  bf16* take16(long long n) { return reinterpret_cast<bf16*>(take((n + 1) / 2)); }
};

}  // namespace bwd
}  // namespace catseg
