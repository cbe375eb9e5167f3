// Backward of the guidance-conditioned decoder (both Up stages + head).
//
// Replaces catseg_tpu/kernels/decoder.py:_fused_bwd (_bwd_kernel: flipped-tap
// input grads, accumulated weight grads).  Shapes and layouts as the forward
// kernel (decoder.cu) takes them: x (N, 24, 24, 128) class slabs, image-major;
// hg1 (B, 48, 48, 64), hg2 (B, 96, 96, 32) the per-image guidance halves of
// conv1; dout (N, 96, 96) fp32.  Out: dx in x's type; fp32 dhg1, dhg2 (summed
// over each image's classes); weight grads in the kernel layouts — ConvT
// (Cin + 1, 4 Cout) with the per-phase bias sums as the last row and the
// bias grad (Cout) beside it, convs (9 Cin, Cout), GroupNorms (2 C: gain,
// bias), head (289: the 288 taps, then the bias).
//
// Design (bwd_common.cuh): the forward is recomputed over all slabs into an
// fp32 workspace that keeps every stage (u1, c1, c2, u2, c3, c4 and the GN
// statistics per slab and group; ReLU(GN(c)) is applied on the fly by the
// loaders), then each stage is reversed:
// - 3x3 convs: weight grads sum_p im2col(X)_p^T dY_p as split-K gemms; input
//   grads as convs of dY with flipped taps and transposed channels (implicit
//   im2col, nothing materialized); the head's single output channel gets
//   its own weight-grad kernel (one thread per tap and channel, 1024 pixel
//   splits) instead of a gemm tile 32 columns wide;
// - GN + ReLU: one CTA per (slab, group) forms sum dy xhat and sum dy, then
//   dx = rstd (dy g - mean(dy g) - xhat mean(dy g xhat)); per-slab gain and
//   bias partials are summed in a fixed order;
// - ConvT k2s2: a per-pixel gemm over the four phases (dX = dU W^T,
//   dW = X^T dU).
// bf16 recomputes the forward's roundings (ConvT outputs, pre-GN conv
// outputs, GN + ReLU outputs) and its single-pass GN statistics.
//
// Bound on the card: ~3x the forward's 0.97 GFLOP per slab, on fp32
// CUDA-core FMAs here; the workspace holds ~2.6 M fp32 values per slab.
#include "bwd_common.cuh"

using namespace catseg;
using namespace catseg::bwd;

namespace {

constexpr int kP1 = 48 * 48, kP2 = 96 * 96;
constexpr int kParts = kWSplits * 129 * 512;

// Plane geometry (channels C, width Wd) is compile-time throughout, so the
// im2col index math divides by constants.
template <class S, int C_, int Wd_> struct Plain {  // NHWC plane value
  static constexpr int C = C_, Wd = Wd_;
  const S* p;
  __device__ __forceinline__ float at(long long slab, int y, int x, int c) const {
    return to_f(p[((slab * Wd + y) * Wd + x) * C + c]);
  }
};

// rnd(ReLU(GN(c))) of a stored pre-GN plane: 16-channel groups, the forward's
// affine form (scale rstd * g, shift b - mean * scale)
template <typename T, int C_, int Wd_> struct GnRelu {
  static constexpr int C = C_, Wd = Wd_;
  const float *p, *stats, *g, *b;
  __device__ __forceinline__ float at(long long slab, int y, int x, int c) const {
    const float* s = stats + (slab * (C / 16) + c / 16) * 2;
    const float sc = s[1] * g[c], sh = b[c] - s[0] * sc;
    return rnd<T>(fmaxf(p[((slab * Wd + y) * Wd + x) * C + c] * sc + sh, 0.f));
  }
};

// A(m, k) = im2col of a zero-padded 3x3 conv: m a slab pixel, k = tap * C + c
template <class Src> __device__ __forceinline__ float im2col(const Src& s, long long m64, long long k64) {
  const int m = (int)m64, k = (int)k64;   // both below 2^31 (checked at entry)
  const int P = Src::Wd * Src::Wd, pix = m % P, tap = k / Src::C, c = k % Src::C;
  const int y = pix / Src::Wd + tap / 3 - 1, x = pix % Src::Wd + tap % 3 - 1;
  return (y >= 0 && y < Src::Wd && x >= 0 && x < Src::Wd) ? s.at(m / P, y, x, c) : 0.f;
}

template <class Src> struct Im2col {
  Src s;
  static constexpr bool kFast2 = true;
  __device__ __forceinline__ float operator()(long long i, long long j) const { return im2col(s, i, j); }
};

template <class Src> struct Im2colT {
  Src s;
  static constexpr bool kFast2 = false;
  __device__ __forceinline__ float operator()(long long i, long long j) const { return im2col(s, j, i); }
};

template <class Src> struct RowsT {  // (channel i, slab pixel j)
  Src s;
  static constexpr bool kFast2 = false;
  __device__ __forceinline__ float operator()(long long i, long long j) const {
    const int P = Src::Wd * Src::Wd, pix = (int)j % P;
    return s.at((int)j / P, pix / Src::Wd, pix % Src::Wd, (int)i);
  }
};

template <class Src> struct Rows {  // (slab pixel i, channel j)
  Src s;
  static constexpr bool kFast2 = true;
  __device__ __forceinline__ float operator()(long long i, long long j) const {
    const int P = Src::Wd * Src::Wd, pix = (int)i % P;
    return s.at((int)i / P, pix / Src::Wd, pix % Src::Wd, (int)j);
  }
};

// flipped-tap, transposed-channel weights of a conv's input grad:
// B(tap' * Cout + co, ci) = W[((8 - tap') * Cin + ci) * Cout + co]
template <int Cin, int Cout> struct FlipW {
  const float* w;
  static constexpr bool kFast2 = false;
  __device__ __forceinline__ float operator()(long long k, long long n) const {
    return w[((8 - k / Cout) * Cin + n) * Cout + k % Cout];
  }
};

// dU(p, ph * Cout + co) = du at output pixel (2y + ph / 2, 2x + ph % 2) of
// input pixel p = (slab, y, x): the ConvT k2s2 output grads by phase
template <int Win, int Cout> struct PhaseGather {
  const float* du;
  static constexpr bool kFast2 = true;
  __device__ __forceinline__ float operator()(long long m, long long k) const {
    const int P = Win * Win, pix = (int)(m % P), ph = (int)(k / Cout);
    const int y = 2 * (pix / Win) + ph / 2, x = 2 * (pix % Win) + ph % 2;
    return du[(((m / P) * 2 * Win + y) * 2 * Win + x) * Cout + k % Cout];
  }
};

// ConvT k2s2 forward: scatter phase ph of input pixel m, rnd(rnd(acc) + rnd(b))
template <typename T, int Win, int Cout> struct ConvTEpi {
  float* u;
  const float* b;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    const int P = Win * Win, pix = (int)(m % P), ph = (int)(n / Cout), co = (int)(n % Cout);
    const int y = 2 * (pix / Win) + ph / 2, x = 2 * (pix % Win) + ph % 2;
    u[(((m / P) * 2 * Win + y) * 2 * Win + x) * Cout + co] = rnd<T>(rnd<T>(acc) + rnd<T>(b[co]));
  }
};

// pre-GN conv output rnd(acc (+ the image's guidance plane))
template <typename T, int Cout, int P> struct ConvEpi {
  float* c;
  const T* hg;
  int nT;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    if (hg) acc += to_f(hg[((m / P / nT) * P + m % P) * Cout + n]);
    c[m * Cout + n] = rnd<T>(acc);
  }
};

template <typename T> struct StoreT {
  T* p;
  long long ld;
  __device__ __forceinline__ void operator()(long long m, long long n, float v, int) const {
    p[m * ld + n] = from_f<T>(v);
  }
};

__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// GN statistics (mean, rstd) of one (slab, group): the forward's single-pass
// variance of the stored values, eps 1e-5
__global__ void __launch_bounds__(256) gn_stats_kernel(const float* c, float* stats, int C, int P) {
  __shared__ float red[256];
  const long long slab = blockIdx.x;
  const int grp = blockIdx.y, G = C / 16;
  float s1 = 0.f, s2 = 0.f;
  for (int e = threadIdx.x; e < P * 16; e += blockDim.x) {
    const float v = c[(slab * P + e / 16) * C + grp * 16 + e % 16];
    s1 += v;
    s2 += v * v;
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    const float cnt = 16.f * P, mean = s1 / cnt;
    stats[(slab * G + grp) * 2] = mean;
    stats[(slab * G + grp) * 2 + 1] = rsqrtf(s2 / cnt - mean * mean + 1e-5f);
  }
}

// GN + ReLU backward of one (slab, group), in place: dh (grad of the ReLU
// output) -> grad of the pre-GN values; gain / bias partials of this slab
// to gpart[slab][2][C].  256 threads: thread t always holds channel t % 16.
__global__ void __launch_bounds__(256) gn_bwd_kernel(float* dh, const float* c, const float* stats, const float* g,
                                                     const float* b, float* gpart, int C, int P) {
  __shared__ float red[4][256];
  const long long slab = blockIdx.x;
  const int grp = blockIdx.y, tid = threadIdx.x, ch = grp * 16 + tid % 16;
  const float mean = stats[(slab * (C / 16) + grp) * 2], rs = stats[(slab * (C / 16) + grp) * 2 + 1];
  const float gam = g[ch], sc = rs * gam, sh = b[ch] - mean * sc;
  float ag = 0.f, ab = 0.f, s1 = 0.f, s2 = 0.f;
  for (int e = tid; e < P * 16; e += blockDim.x) {
    const long long i = (slab * P + e / 16) * C + ch;
    const float v = c[i], xh = (v - mean) * rs;
    const float d = v * sc + sh > 0.f ? dh[i] : 0.f;
    ag = fmaf(d, xh, ag);
    ab += d;
    s1 = fmaf(d, gam, s1);
    s2 = fmaf(d * gam, xh, s2);
  }
  red[0][tid] = ag;
  red[1][tid] = ab;
  red[2][tid] = s1;
  red[3][tid] = s2;
  __syncthreads();
  if (tid < 16) {
    float a = 0.f, bb = 0.f;
    for (int j = tid; j < 256; j += 16) {
      a += red[0][j];
      bb += red[1][j];
    }
    gpart[(slab * 2) * C + grp * 16 + tid] = a;
    gpart[(slab * 2 + 1) * C + grp * 16 + tid] = bb;
  }
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (tid < s) {
      red[2][tid] += red[2][tid + s];
      red[3][tid] += red[3][tid + s];
    }
    __syncthreads();
  }
  const float cnt = 16.f * P, m1 = red[2][0] / cnt, m2 = red[3][0] / cnt;
  for (int e = tid; e < P * 16; e += blockDim.x) {
    const long long i = (slab * P + e / 16) * C + ch;
    const float v = c[i], xh = (v - mean) * rs;
    const float d = v * sc + sh > 0.f ? dh[i] : 0.f;
    dh[i] = rs * (d * gam - m1 - xh * m2);
  }
}

// head weight and bias grads: part[split][r] = sum over the split's pixels of
// im2col(h4)(m, r) dout[m] (r < 288) or dout[m] (r = 288); one thread per r
template <class Src>
__global__ void __launch_bounds__(320) head_wgrad_kernel(Src h4, const float* dout, float* part, int M, int chunk) {
  const int r = threadIdx.x;
  const int m0 = blockIdx.x * chunk, m1 = min(M, m0 + chunk);
  if (r > 288) return;
  float acc = 0.f;
  for (int m = m0; m < m1; ++m) acc = fmaf(r < 288 ? im2col(h4, m, r) : 1.f, dout[m], acc);
  part[(long long)blockIdx.x * 289 + r] = acc;
}

constexpr int kHeadSplits = 1024;

struct Bufs {
  float *u1, *c1, *c2, *u2, *c3, *c4, *s1, *s2, *s3, *s4, *gA, *gB, *gC, *gpart, *part;
};

Bufs carve(float* ws, long long N, long long* used) {
  Carve c{ws};
  Bufs b;
  b.u1 = c.take(N * kP1 * 96);
  b.c1 = c.take(N * kP1 * 64);
  b.c2 = c.take(N * kP1 * 64);
  b.u2 = c.take(N * kP2 * 48);
  b.c3 = c.take(N * kP2 * 32);
  b.c4 = c.take(N * kP2 * 32);
  b.s1 = c.take(N * 8);
  b.s2 = c.take(N * 8);
  b.s3 = c.take(N * 4);
  b.s4 = c.take(N * 4);
  b.gA = c.take(N * kP2 * 32);   // dh4 -> dc4, then dh2 -> dc2
  b.gB = c.take(N * kP2 * 32);   // dh3 -> dc3, then dh1 -> dc1
  b.gC = c.take(N * kP2 * 48);   // du2, then du1
  b.gpart = c.take(N * 2 * 64);
  b.part = c.take(kParts);
  if (used) *used = c.used;
  return b;
}

// weights in the kernel layouts, fp32 (decoder.cu's DecW order)
struct W {
  const float *up1_w, *up1_b, *c11_w, *gn11_g, *gn11_b, *c12_w, *gn12_g, *gn12_b;
  const float *up2_w, *up2_b, *c21_w, *gn21_g, *gn21_b, *c22_w, *gn22_g, *gn22_b, *hd_w, *hd_b;
};

// GN + ReLU backward of a stage in place, gain / bias grads to out (2 C)
cudaError_t gn_bwd(float* dh, const float* c, const float* stats, const float* g, const float* b, float* out,
                   float* gpart, int N, int C, int P, cudaStream_t st) {
  CATSEG_TRY(launch_k(gn_bwd_kernel, dim3(N, C / 16), dim3(256), 0, st, dh, c, stats, g, b, gpart, C, P));
  return sum_mid(gpart, out, 1, N, 1, 2 * C, 2 * C, 0, st);
}

template <typename T>
cudaError_t run(const T* x, const T* hg1, const T* hg2, const float* dout, T* dx, float* dhg1, float* dhg2,
                float* const* g, const W& w, float* ws, int N, int nT, cudaStream_t st) {
  float *g_up1w = g[0], *g_up1b = g[1], *g_c11 = g[2], *g_gn11 = g[3], *g_c12 = g[4], *g_gn12 = g[5];
  float *g_up2w = g[6], *g_up2b = g[7], *g_c21 = g[8], *g_gn21 = g[9], *g_c22 = g[10], *g_gn22 = g[11];
  float* g_hd = g[12];
  const Bufs b = carve(ws, N, nullptr);
  const int M0 = N * 576, M1 = N * kP1, M2 = N * kP2, B = N / nT;
  const Plain<T, 128, 24> xs{x};
  const GnRelu<T, 64, 48> h1{b.c1, b.s1, w.gn11_g, w.gn11_b}, h2{b.c2, b.s2, w.gn12_g, w.gn12_b};
  const GnRelu<T, 32, 96> h3{b.c3, b.s3, w.gn21_g, w.gn21_b}, h4{b.c4, b.s4, w.gn22_g, w.gn22_b};
  using F = float;
  const T* nohg = nullptr;

  // forward recompute
  CATSEG_TRY(gemm(Rows<Plain<T, 128, 24>>{xs}, Dense<F>{w.up1_w, 384}, ConvTEpi<T, 24, 96>{b.u1, w.up1_b}, M0,
                  384, 128, st));
  CATSEG_TRY(gemm(Im2col<Plain<F, 96, 48>>{{b.u1}}, Dense<F>{w.c11_w, 64}, ConvEpi<T, 64, kP1>{b.c1, hg1, nT}, M1,
                  64, 864, st));
  CATSEG_TRY(launch_k(gn_stats_kernel, dim3(N, 4), dim3(256), 0, st, (const F*)b.c1, b.s1, 64, kP1));
  CATSEG_TRY(gemm(Im2col<GnRelu<T, 64, 48>>{h1}, Dense<F>{w.c12_w, 64}, ConvEpi<T, 64, kP1>{b.c2, nohg, nT}, M1,
                  64, 576, st));
  CATSEG_TRY(launch_k(gn_stats_kernel, dim3(N, 4), dim3(256), 0, st, (const F*)b.c2, b.s2, 64, kP1));
  CATSEG_TRY(gemm(Rows<GnRelu<T, 64, 48>>{h2}, Dense<F>{w.up2_w, 192}, ConvTEpi<T, 48, 48>{b.u2, w.up2_b}, M1,
                  192, 64, st));
  CATSEG_TRY(gemm(Im2col<Plain<F, 48, 96>>{{b.u2}}, Dense<F>{w.c21_w, 32}, ConvEpi<T, 32, kP2>{b.c3, hg2, nT},
                  M2, 32, 432, st));
  CATSEG_TRY(launch_k(gn_stats_kernel, dim3(N, 2), dim3(256), 0, st, (const F*)b.c3, b.s3, 32, kP2));
  CATSEG_TRY(gemm(Im2col<GnRelu<T, 32, 96>>{h3}, Dense<F>{w.c22_w, 32}, ConvEpi<T, 32, kP2>{b.c4, nohg, nT}, M2,
                  32, 288, st));
  CATSEG_TRY(launch_k(gn_stats_kernel, dim3(N, 2), dim3(256), 0, st, (const F*)b.c4, b.s4, 32, kP2));

  // head: taps + bias grads, dh4
  const int hchunk = cdiv(M2, kHeadSplits);
  CATSEG_TRY(launch_k(head_wgrad_kernel<GnRelu<T, 32, 96>>, dim3(cdiv(M2, hchunk)), dim3(320), 0, st, h4, dout,
                      b.part, M2, hchunk));
  CATSEG_TRY(sum_mid(b.part, g_hd, 1, cdiv(M2, hchunk), 1, 289, 289, 0, st));
  CATSEG_TRY(gemm(Im2col<Plain<F, 1, 96>>{{dout}}, FlipW<32, 1>{w.hd_w}, Store{b.gA, 32}, M2, 32, 9, st));
  // stage 2: GN4, conv4, GN3, guidance, conv3, ConvT2
  CATSEG_TRY(gn_bwd(b.gA, b.c4, b.s4, w.gn22_g, w.gn22_b, g_gn22, b.gpart, N, 32, kP2, st));
  CATSEG_TRY(wgrad(Im2colT<GnRelu<T, 32, 96>>{h3}, Dense<F>{b.gA, 32}, 288, false, 32, M2, g_c22, b.part, st));
  CATSEG_TRY(gemm(Im2col<Plain<F, 32, 96>>{{b.gA}}, FlipW<32, 32>{w.c22_w}, Store{b.gB, 32}, M2, 32, 288, st));
  CATSEG_TRY(gn_bwd(b.gB, b.c3, b.s3, w.gn21_g, w.gn21_b, g_gn21, b.gpart, N, 32, kP2, st));
  CATSEG_TRY(sum_mid(b.gB, dhg2, B, nT, 1, kP2 * 32, kP2 * 32, 0, st));
  CATSEG_TRY(wgrad(Im2colT<Plain<F, 48, 96>>{{b.u2}}, Dense<F>{b.gB, 32}, 432, false, 32, M2, g_c21, b.part, st));
  CATSEG_TRY(gemm(Im2col<Plain<F, 32, 96>>{{b.gB}}, FlipW<48, 32>{w.c21_w}, Store{b.gC, 48}, M2, 48, 288, st));
  CATSEG_TRY(wgrad(RowsT<GnRelu<T, 64, 48>>{h2}, PhaseGather<48, 48>{b.gC}, 64, true, 192, M1, g_up2w, b.part, st));
  CATSEG_TRY(sum_mid(g_up2w, g_up2b, 1, 4, 1, 48, 48, 64 * 192, st));
  CATSEG_TRY(gemm(PhaseGather<48, 48>{b.gC}, DenseT<F>{w.up2_w, 192}, Store{b.gA, 64}, M1, 64, 192, st));
  // stage 1: GN2, conv2, GN1, guidance, conv1, ConvT1
  CATSEG_TRY(gn_bwd(b.gA, b.c2, b.s2, w.gn12_g, w.gn12_b, g_gn12, b.gpart, N, 64, kP1, st));
  CATSEG_TRY(wgrad(Im2colT<GnRelu<T, 64, 48>>{h1}, Dense<F>{b.gA, 64}, 576, false, 64, M1, g_c12, b.part, st));
  CATSEG_TRY(gemm(Im2col<Plain<F, 64, 48>>{{b.gA}}, FlipW<64, 64>{w.c12_w}, Store{b.gB, 64}, M1, 64, 576, st));
  CATSEG_TRY(gn_bwd(b.gB, b.c1, b.s1, w.gn11_g, w.gn11_b, g_gn11, b.gpart, N, 64, kP1, st));
  CATSEG_TRY(sum_mid(b.gB, dhg1, B, nT, 1, kP1 * 64, kP1 * 64, 0, st));
  CATSEG_TRY(wgrad(Im2colT<Plain<F, 96, 48>>{{b.u1}}, Dense<F>{b.gB, 64}, 864, false, 64, M1, g_c11, b.part, st));
  CATSEG_TRY(gemm(Im2col<Plain<F, 64, 48>>{{b.gB}}, FlipW<96, 64>{w.c11_w}, Store{b.gC, 96}, M1, 96, 576, st));
  CATSEG_TRY(wgrad(RowsT<Plain<T, 128, 24>>{xs}, PhaseGather<24, 96>{b.gC}, 128, true, 384, M0, g_up1w, b.part, st));
  CATSEG_TRY(sum_mid(g_up1w, g_up1b, 1, 4, 1, 96, 96, 128 * 384, st));
  return gemm(PhaseGather<24, 96>{b.gC}, DenseT<F>{w.up1_w, 384}, StoreT<T>{dx, 128}, M0, 128, 384, st);
}

}  // namespace

// fp32 workspace elements the backward of N slabs needs
extern "C" long long catseg_decoder_bwd_workspace(int N) {
  long long used = 0;
  carve(nullptr, N, &used);
  return used;
}

extern "C" int catseg_decoder_bwd(const void* x, const void* hg1, const void* hg2, const void* dout, void* dx,
                                  void* dhg1, void* dhg2, void* g_up1w, void* g_up1b, void* g_c11, void* g_gn11,
                                  void* g_c12, void* g_gn12, void* g_up2w, void* g_up2b, void* g_c21, void* g_gn21,
                                  void* g_c22, void* g_gn22, void* g_hd, const void* up1_w, const void* up1_b,
                                  const void* c11_w, const void* gn11_g, const void* gn11_b, const void* c12_w,
                                  const void* gn12_g, const void* gn12_b, const void* up2_w, const void* up2_b,
                                  const void* c21_w, const void* gn21_g, const void* gn21_b, const void* c22_w,
                                  const void* gn22_g, const void* gn22_b, const void* hd_w, const void* hd_b, void* ws,
                                  int N, int nT, int is_bf16, void* stream) {
  if (N <= 0 || nT <= 0 || N % nT || (long long)N * kP2 > 2147483647ll) return (int)cudaErrorInvalidValue;
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  const W w{c(up1_w), c(up1_b), c(c11_w), c(gn11_g), c(gn11_b), c(c12_w), c(gn12_g), c(gn12_b), c(up2_w),
            c(up2_b), c(c21_w), c(gn21_g), c(gn21_b), c(c22_w), c(gn22_g), c(gn22_b), c(hd_w), c(hd_b)};
  void* gv[13] = {g_up1w, g_up1b, g_c11, g_gn11, g_c12, g_gn12, g_up2w, g_up2b, g_c21, g_gn21, g_c22, g_gn22, g_hd};
  float* g[13];
  for (int i = 0; i < 13; ++i) g[i] = static_cast<float*>(gv[i]);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(hg1), static_cast<const bf16*>(hg2),
                          c(dout), static_cast<bf16*>(dx), static_cast<float*>(dhg1), static_cast<float*>(dhg2), g,
                          w, static_cast<float*>(ws), N, nT, st);
  return (int)run<float>(static_cast<const float*>(x), static_cast<const float*>(hg1), static_cast<const float*>(hg2),
                         c(dout), static_cast<float*>(dx), static_cast<float*>(dhg1), static_cast<float*>(dhg2), g, w,
                         static_cast<float*>(ws), N, nT, st);
}
