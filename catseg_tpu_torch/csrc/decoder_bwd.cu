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
// The forward is recomputed over all slabs into a workspace that keeps
// every stage (u1, c1, c2, u2, c3, c4 and the GN statistics per slab and
// group), then each stage is reversed:
// - 3x3 convs: weight grads sum_p im2col(X)_p^T dY_p as split-K products;
//   input grads as convs of dY with flipped taps and transposed channels
//   (implicit im2col, nothing materialized);
// - GN + ReLU: one CTA per (slab, group) forms sum dy xhat and sum dy, then
//   dx = rstd (dy g - mean(dy g) - xhat mean(dy g xhat)); per-slab gain and
//   bias partials are summed in a fixed order;
// - ConvT k2s2: a per-pixel product over the four phases (dX = dU W^T,
//   dW = X^T dU).
//
// fp32 (run): the CUDA-core engine (bwd::gemm), everything fp32 in the
// workspace, ReLU(GN(c)) applied by the loaders on every read; the head's
// single output channel gets its own weight-grad kernel (one thread per tap
// and channel, 1024 pixel splits) instead of a gemm tile 32 columns wide.
// Bound on the card: ~3x the forward's 0.97 GFLOP per slab on fp32 FMAs;
// ~2.6 M fp32 values of workspace per slab.
//
// bf16 (run_tc): the tensor-core engine (bwd::tc::gemm).  The recomputed
// stages are bf16 planes (u1, c1..c4 are rnd<bf16> values, so bf16 holds them
// exactly), and each GN stage writes h = rnd(ReLU(GN(c))) once, beside c,
// where the fp32 path recomputes it on each of a conv's 9 tap reads.  Every
// product reads its operands by 16-byte cp.async: a k step of 8 is one
// tap's contiguous channel run of an NHWC plane (all channel counts are
// multiples of 8), or 8 channels of one phase of a ConvT output.  A conv's
// recompute and input grad land the input rows of 192 output pixels (2 or
// 4 image rows) once as a halo tile and read all 9 taps from it; its weight
// grad reads the im2col by 8-channel chunks.  The recompute runs on this
// engine, not on decoder.cu's band pipeline: that one keeps each stage on
// chip and stores only the logits, where the backward needs every stage in
// device memory, and one engine serves all 19 products.  Weights are
// packed once per call into bf16 (K, N) matrices: as they are for the
// recompute, transposed for the ConvT input grads, flipped with channels
// transposed for the conv input grads.  Operand precision per product, by
// the plain version (kernels/decoder.py _plain_vjp_target: bf16 values,
// fp32 cotangents):
// - recompute (ConvT 1, conv 11, conv 12, ConvT 2, conv 21, conv 22): bf16
//   activations x bf16 weights;
// - weight grads: bf16 recomputed activations (x, u1, h1, h2, u2, h3) x the
//   fp32 cotangent as hi + lo;
// - input grads: the fp32 cotangent as hi + lo x bf16 weights;
// - the head (one output channel): its weight grad h4's im2col x dout as
//   hi + lo, a product 8 columns wide of which column 0 is dout; its input
//   grad on CUDA cores in fp32, a 9-tap stencil of dout, not a product;
// - GN statistics, GN backward, guidance sums: fp32 on CUDA cores, 16-byte
//   accesses (passes over device memory that no product would shorten);
//   the GN backward writes its result as the hi + lo pair the next products
//   read, a conv's input grad into a ConvT's output likewise; bias grads are
//   summed from the weight grads' B tiles in shared memory.
// Bound on the card: 2.0 ms at the train step's 684 slabs with bf16
// operands throughout; the hi + lo products of the backward double its
// tensor-core work (~3.4 ms); ~4.6 M bf16-sized values of workspace a slab.
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

// ------------------------------------------------------------ bf16 path

// tensor-core source: an NHWC plane's zero-padded 3x3 im2col, row i a slab
// pixel, column j = tap * C + c (read as A by the input grads and the
// recompute, as transposed A by the weight grads)
template <int C, int Wd, bool S> struct Im2col16 {
  const bf16* p;
  long long lo;
  static constexpr bool kSplit = S, kHalo = false;
  struct Row {
    const bf16* slab;
    int y, x;
  };
  __device__ __forceinline__ Row row(int i) const {
    const int pix = i % (Wd * Wd);
    return {p + (long long)(i - pix) * C, pix / Wd, pix % Wd};
  }
  __device__ __forceinline__ void step(Row& r, int d) const {
    for (r.x += d; r.x >= Wd; r.x -= Wd)
      if (++r.y == Wd) {
        r.y = 0;
        r.slab += Wd * Wd * C;
      }
  }
  __device__ __forceinline__ const bf16* at(Row r, int j) const {
    const int tap = j / C, y = r.y + tap / 3 - 1, x = r.x + tap % 3 - 1;
    return (y >= 0 && y < Wd && x >= 0 && x < Wd) ? r.slab + (y * Wd + x) * C + (j - tap * C) : nullptr;
  }
};

// tensor-core halo source (bwd_common.cuh): a 3x3 conv's im2col as the A
// operand of the recompute and the input grads, landed once a tile as the
// input rows its outputs touch
template <int C, int Wd, bool S> struct Halo16 {
  const bf16* p;
  long long lo;
  static constexpr bool kSplit = S, kHalo = true;
  static constexpr int kC = C, kWd = Wd;
};

// tensor-core source: a ConvT k2s2's output gradient by input pixel i and
// column j = ph * Cout + co, at output pixel (2y + ph / 2, 2x + ph % 2)
template <int Win, int Cout, bool S> struct Phase16 {
  const bf16* p;
  long long lo;
  static constexpr bool kSplit = S, kHalo = false;
  struct Row {
    const bf16* slab;
    int y, x;
  };
  __device__ __forceinline__ Row row(int i) const {
    const int pix = i % (Win * Win);
    return {p + (long long)(i / (Win * Win)) * (4 * Win * Win * Cout), 2 * (pix / Win), 2 * (pix % Win)};
  }
  __device__ __forceinline__ void step(Row& r, int d) const {
    for (r.x += 2 * d; r.x >= 2 * Win; r.x -= 2 * Win)
      if ((r.y += 2) == 2 * Win) {
        r.y = 0;
        r.slab += 4 * Win * Win * Cout;
      }
  }
  __device__ __forceinline__ const bf16* at(Row r, int j) const {
    const int ph = j / Cout;
    return r.slab + ((r.y + ph / 2) * 2 * Win + r.x + ph % 2) * Cout + (j - ph * Cout);
  }
};

// ConvT k2s2 forward into a bf16 plane: phase ph of input pixel m,
// rnd(rnd(acc) + rnd(b)) for columns n, n + 1
template <int Win, int Cout> struct ConvTEpi16 {
  bf16* u;
  const float* b;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    constexpr int P = Win * Win;
    const int i = (int)m, pix = i % P, ph = (int)n / Cout, co = (int)n - ph * Cout;
    const int y = 2 * (pix / Win) + ph / 2, x = 2 * (pix % Win) + ph % 2;
    store_bf16x2(u + (long long)(i / P) * (4 * P * Cout) + (y * 2 * Win + x) * Cout + co,
                 rnd<bf16>(v0) + rnd<bf16>(b[co]), rnd<bf16>(v1) + rnd<bf16>(b[co + 1]));
  }
};

// pre-GN conv output rnd(acc (+ the image's guidance plane)) into a bf16 plane
template <int Cout, int P> struct ConvEpi16 {
  bf16* c;
  const bf16* hg;
  int nT;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    if (hg) {
      const int i = (int)m;
      const float2 g = unpack_bf16(hg + ((long long)(i / P / nT) * P + i % P) * Cout + n);
      v0 += g.x;
      v1 += g.y;
    }
    store_bf16x2(c + m * Cout + n, v0, v1);
  }
};

__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                                            pack_bf16(v[6], v[7]));
}

// GN statistics (mean, rstd) of one (slab, group) of a bf16 pre-GN plane (the
// forward's single-pass variance, eps 1e-5), then h = rnd(ReLU(GN(c))) written
// once for the products.  Thread t holds channels 8 (t % 2) .. + 7 of the
// group, 16-byte accesses.
template <int C, int P>
__global__ void __launch_bounds__(256) gn_apply_kernel(const bf16* c, float* stats, const float* g, const float* b,
                                                       bf16* h) {
  __shared__ float red[256];
  const long long base = (long long)blockIdx.x * P * C;
  const int grp = blockIdx.y, ch0 = grp * 16 + (threadIdx.x & 1) * 8;
  float s1 = 0.f, s2 = 0.f, v[8];
#pragma unroll 4
  for (int p = threadIdx.x >> 1; p < P; p += blockDim.x >> 1) {
    load8(v, c + base + (long long)p * C + ch0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s1 += v[k];
      s2 += v[k] * v[k];
    }
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  const float cnt = 16.f * P, mean = s1 / cnt, rs = rsqrtf(s2 / cnt - mean * mean + 1e-5f);
  if (threadIdx.x == 0) {
    stats[(blockIdx.x * (C / 16) + grp) * 2] = mean;
    stats[(blockIdx.x * (C / 16) + grp) * 2 + 1] = rs;
  }
  float sc[8], sh[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    sc[k] = rs * g[ch0 + k];
    sh[k] = b[ch0 + k] - mean * sc[k];
  }
#pragma unroll 4
  for (int p = threadIdx.x >> 1; p < P; p += blockDim.x >> 1) {
    const long long i = base + (long long)p * C + ch0;
    load8(v, c + i);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k] * sc[k] + sh[k], 0.f);
    store8(h + i, v);
  }
}

// GN + ReLU backward of one (slab, group), as gn_bwd_kernel, reading the bf16
// pre-GN plane and writing the pre-GN grad as the pair hi + lo (lo lo
// elements after); thread t holds channels 8 (t % 2) .. + 7, 16-byte
// accesses; gain / bias partials of this slab to gpart[slab][2][C]
template <int C, int P>
__global__ void __launch_bounds__(256) gn_bwd16_kernel(const float* dh, const bf16* c, const float* stats,
                                                       const float* g, const float* b, bf16* out, long long lo,
                                                       float* gpart) {
  __shared__ float red[256];
  __shared__ float part[2][8][16];
  const long long slab = blockIdx.x, base = slab * P * C;
  const int grp = blockIdx.y, tid = threadIdx.x, ch0 = grp * 16 + (tid & 1) * 8;
  const float mean = stats[(slab * (C / 16) + grp) * 2], rs = stats[(slab * (C / 16) + grp) * 2 + 1];
  float gam[8], sc[8], sh[8], ag[8], ab[8], v[8], d[8], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    gam[k] = g[ch0 + k];
    sc[k] = rs * gam[k];
    sh[k] = b[ch0 + k] - mean * sc[k];
    ag[k] = ab[k] = 0.f;
  }
  auto grads = [&](long long i) {   // v = c, d = the ReLU-masked dh at pixel offset i
    load8(v, c + i);
    const float4 d0 = *reinterpret_cast<const float4*>(dh + i), d1 = *reinterpret_cast<const float4*>(dh + i + 4);
    const float dd[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = v[k] * sc[k] + sh[k] > 0.f ? dd[k] : 0.f;
  };
#pragma unroll 4
  for (int p = tid >> 1; p < P; p += blockDim.x >> 1) {
    grads(base + (long long)p * C + ch0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float xh = (v[k] - mean) * rs;
      ag[k] = fmaf(d[k], xh, ag[k]);
      ab[k] += d[k];
      s1 = fmaf(d[k], gam[k], s1);
      s2 = fmaf(d[k] * gam[k], xh, s2);
    }
  }
  // per channel over the lanes of one parity (xor butterfly), then over the warps in order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int o = 2; o < 32; o <<= 1) {
      ag[k] += __shfl_xor_sync(0xffffffffu, ag[k], o);
      ab[k] += __shfl_xor_sync(0xffffffffu, ab[k], o);
    }
  if (lane < 2)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      part[0][warp][lane * 8 + k] = ag[k];
      part[1][warp][lane * 8 + k] = ab[k];
    }
  __syncthreads();
  if (tid < 32) {   // channel j = tid % 16 of the group, gain (tid < 16) or bias
    const int j = tid & 15, q = tid >> 4;
    float a = 0.f;
    for (int w = 0; w < 8; ++w) a += part[q][w][j];
    gpart[(slab * 2 + q) * C + grp * 16 + j] = a;
  }
  const float cnt = 16.f * P, m1 = block_sum(s1, red) / cnt, m2 = block_sum(s2, red) / cnt;
#pragma unroll 4
  for (int p = tid >> 1; p < P; p += blockDim.x >> 1) {
    const long long i = base + (long long)p * C + ch0;
    grads(i);
    float hi[8], r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float x = rs * (d[k] * gam[k] - m1 - (v[k] - mean) * rs * m2);
      hi[k] = __bfloat162float(__float2bfloat16(x));
      r[k] = x - hi[k];
    }
    store8(out + i, hi);
    store8(out + lo + i, r);
  }
}

// the head's input grad dh4 (M2, 32) fp32: its one input channel makes each
// output the 9 taps of dout around the pixel times the tap weights, a
// stencil; a thread per pixel, the 288 weights in shared memory.  Also dout
// as the head weight grad's B operand: rows of 8 bf16 (dout's hi, then
// zeros) in dp, the lo rows lo elements after.
__global__ void __launch_bounds__(256) head_dgrad_kernel(const float* dout, const float* w, float* dh, bf16* dp,
                                                         long long lo, int M2) {
  __shared__ float ws[288];
  for (int e = threadIdx.x; e < 288; e += blockDim.x) ws[e] = w[e];
  __syncthreads();
  for (int m = blockIdx.x * blockDim.x + threadIdx.x; m < M2; m += gridDim.x * blockDim.x) {
    const int pix = m % kP2, y = pix / 96, x = pix % 96;
    float d[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int yy = y + 1 - t / 3, xx = x + 1 - t % 3;
      d[t] = yy >= 0 && yy < 96 && xx >= 0 && xx < 96 ? dout[m - pix + yy * 96 + xx] : 0.f;
    }
    const bf16 h = __float2bfloat16(d[4]), l = __float2bfloat16(d[4] - __bfloat162float(h));
    *reinterpret_cast<uint4*>(dp + (long long)m * 8) = make_uint4(__bfloat16_as_ushort(h), 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dp + lo + (long long)m * 8) = make_uint4(__bfloat16_as_ushort(l), 0u, 0u, 0u);
#pragma unroll
    for (int c = 0; c < 32; c += 4) {
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[k] = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) o[k] = fmaf(d[t], ws[t * 32 + c + k], o[k]);
      }
      *reinterpret_cast<float4*>(dh + (long long)m * 32 + c) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// bf16 weights of the products, (K, N) row-major: the recompute's as the
// forward's, the ConvTs' transposed, the convs' flipped and transposed
struct Packed {
  bf16 *up1, *up1t, *c11, *c11f, *c12, *c12f, *up2, *up2t, *c21, *c21f, *c22, *c22f;
};

struct Bufs16 {
  bf16 *u1, *c1, *h1, *c2, *h2, *u2, *c3, *h3, *c4, *h4;   // recomputed stages
  float *s1, *s2, *s3, *s4;
  float* dh;       // fp32 grad of a GN + ReLU output
  bf16 *dc, *du;   // a pre-GN grad, a ConvT output's grad: hi planes, lo planes dc_lo / du_lo after
  bf16* dp;        // dout as rows of 8 (hi, zeros), lo rows M2 * 8 after
  long long dc_lo, du_lo;
  Packed w;
  float *gpart, *part;
};

Bufs16 carve16(float* ws, long long N, long long* used) {
  Carve c{ws};
  Bufs16 b;
  b.u1 = c.take16(N * kP1 * 96);
  b.c1 = c.take16(N * kP1 * 64);
  b.h1 = c.take16(N * kP1 * 64);
  b.c2 = c.take16(N * kP1 * 64);
  b.h2 = c.take16(N * kP1 * 64);
  b.u2 = c.take16(N * kP2 * 48);
  b.c3 = c.take16(N * kP2 * 32);
  b.h3 = c.take16(N * kP2 * 32);
  b.c4 = c.take16(N * kP2 * 32);
  b.h4 = c.take16(N * kP2 * 32);
  b.s1 = c.take(N * 8);
  b.s2 = c.take(N * 8);
  b.s3 = c.take(N * 4);
  b.s4 = c.take(N * 4);
  b.dh = c.take(N * kP2 * 32);
  b.dc_lo = N * kP2 * 32;   // the largest pre-GN grad: stage 2's (stage 1's is N kP1 64)
  b.dc = c.take16(2 * b.dc_lo);
  b.du_lo = N * kP2 * 48;   // du2; du1 (N kP1 96) is smaller
  b.du = c.take16(2 * b.du_lo);
  b.dp = c.take16(2 * N * kP2 * 8);
  Packed& w = b.w;
  w.up1 = c.take16(128 * 384);
  w.up1t = c.take16(384 * 128);
  w.c11 = c.take16(864 * 64);
  w.c11f = c.take16(576 * 96);
  w.c12 = c.take16(576 * 64);
  w.c12f = c.take16(576 * 64);
  w.up2 = c.take16(64 * 192);
  w.up2t = c.take16(192 * 64);
  w.c21 = c.take16(432 * 32);
  w.c21f = c.take16(288 * 48);
  w.c22 = c.take16(288 * 32);
  w.c22f = c.take16(288 * 32);
  b.gpart = c.take(N * 2 * 64);
  b.part = c.take(kParts);
  if (used) *used = c.used;
  return b;
}

cudaError_t run_tc(const bf16* x, const bf16* hg1, const bf16* hg2, const float* dout, bf16* dx, float* dhg1,
                   float* dhg2, float* const* g, const W& w, float* ws, int N, int nT, cudaStream_t st) {
  using tc::Rows;
  float *g_up1w = g[0], *g_up1b = g[1], *g_c11 = g[2], *g_gn11 = g[3], *g_c12 = g[4], *g_gn12 = g[5];
  float *g_up2w = g[6], *g_up2b = g[7], *g_c21 = g[8], *g_gn21 = g[9], *g_c22 = g[10], *g_gn22 = g[11];
  float* g_hd = g[12];
  const Bufs16 b = carve16(ws, N, nullptr);
  const Packed& pw = b.w;
  const int M0 = N * 576, M1 = N * kP1, M2 = N * kP2, B = N / nT;
  const void* dm = x;   // a mapped address for the zero-filled chunks
  const long long dl = b.dc_lo, ul = b.du_lo;
  const bf16* nohg = nullptr;

  CATSEG_TRY(tc::pack(w.up1_w, pw.up1, 128, 384, 0, st));
  CATSEG_TRY(tc::pack(w.up1_w, pw.up1t, 128, 384, 1, st));
  CATSEG_TRY(tc::pack(w.c11_w, pw.c11, 864, 64, 0, st));
  CATSEG_TRY(tc::pack(w.c11_w, pw.c11f, 864, 64, 2, st));
  CATSEG_TRY(tc::pack(w.c12_w, pw.c12, 576, 64, 0, st));
  CATSEG_TRY(tc::pack(w.c12_w, pw.c12f, 576, 64, 2, st));
  CATSEG_TRY(tc::pack(w.up2_w, pw.up2, 64, 192, 0, st));
  CATSEG_TRY(tc::pack(w.up2_w, pw.up2t, 64, 192, 1, st));
  CATSEG_TRY(tc::pack(w.c21_w, pw.c21, 432, 32, 0, st));
  CATSEG_TRY(tc::pack(w.c21_w, pw.c21f, 432, 32, 2, st));
  CATSEG_TRY(tc::pack(w.c22_w, pw.c22, 288, 32, 0, st));
  CATSEG_TRY(tc::pack(w.c22_w, pw.c22f, 288, 32, 2, st));

  // forward recompute: bf16 stages, h = rnd(ReLU(GN(c))) beside each c
  CATSEG_TRY((tc::gemm<128, 128, 2, false, true>(Rows<false>{x, 128, 0}, Rows<false>{pw.up1, 384, 0},
                                    ConvTEpi16<24, 96>{b.u1, w.up1_b}, M0, 384, 128, dm, st)));
  CATSEG_TRY((tc::gemm<192, 64, 4, false, true>(Halo16<96, 48, false>{b.u1, 0}, Rows<false>{pw.c11, 64, 0},
                                   ConvEpi16<64, kP1>{b.c1, hg1, nT}, M1, 64, 864, dm, st)));
  CATSEG_TRY(launch_k(gn_apply_kernel<64, kP1>, dim3(N, 4), dim3(256), 0, st, (const bf16*)b.c1, b.s1, w.gn11_g,
                      w.gn11_b, b.h1));
  CATSEG_TRY((tc::gemm<192, 64, 4, false, true>(Halo16<64, 48, false>{b.h1, 0}, Rows<false>{pw.c12, 64, 0},
                                   ConvEpi16<64, kP1>{b.c2, nohg, nT}, M1, 64, 576, dm, st)));
  CATSEG_TRY(launch_k(gn_apply_kernel<64, kP1>, dim3(N, 4), dim3(256), 0, st, (const bf16*)b.c2, b.s2, w.gn12_g,
                      w.gn12_b, b.h2));
  CATSEG_TRY((tc::gemm<128, 64, 4, false, true>(Rows<false>{b.h2, 64, 0}, Rows<false>{pw.up2, 192, 0},
                                   ConvTEpi16<48, 48>{b.u2, w.up2_b}, M1, 192, 64, dm, st)));
  CATSEG_TRY((tc::gemm<192, 32, 4, false, true>(Halo16<48, 96, false>{b.u2, 0}, Rows<false>{pw.c21, 32, 0},
                                   ConvEpi16<32, kP2>{b.c3, hg2, nT}, M2, 32, 432, dm, st)));
  CATSEG_TRY(launch_k(gn_apply_kernel<32, kP2>, dim3(N, 2), dim3(256), 0, st, (const bf16*)b.c3, b.s3, w.gn21_g,
                      w.gn21_b, b.h3));
  CATSEG_TRY((tc::gemm<192, 32, 4, false, true>(Halo16<32, 96, false>{b.h3, 0}, Rows<false>{pw.c22, 32, 0},
                                   ConvEpi16<32, kP2>{b.c4, nohg, nT}, M2, 32, 288, dm, st)));
  CATSEG_TRY(launch_k(gn_apply_kernel<32, kP2>, dim3(N, 2), dim3(256), 0, st, (const bf16*)b.c4, b.s4, w.gn22_g,
                      w.gn22_b, b.h4));

  // head: dh4, then taps + bias grads (column 0 of a product 8 wide)
  const long long pl = (long long)M2 * 8;
  CATSEG_TRY(launch_k(head_dgrad_kernel, dim3(std::min(cdiv(M2, 256), 8192)), dim3(256), 0, st, dout, w.hd_w, b.dh,
                      b.dp, pl, M2));
  CATSEG_TRY((tc::gemm<128, 16, 8, true, false, true>(Im2col16<32, 96, false>{b.h4, 0}, Rows<true>{b.dp, 8, pl},
                                                      Partial{b.part, 289, 8}, 288, 8, M2, dm, st, kWSplits)));
  CATSEG_TRY(sum_mid(b.part, g_hd, 1, tc::split_count(M2, kWSplits), 289, 1, 8, 0, st));
  // stage 2: GN4, conv4, GN3, guidance, conv3, ConvT2
  CATSEG_TRY(launch_k(gn_bwd16_kernel<32, kP2>, dim3(N, 2), dim3(256), 0, st, (const float*)b.dh,
                      (const bf16*)b.c4, b.s4, w.gn22_g, w.gn22_b, b.dc, dl, b.gpart));
  CATSEG_TRY(sum_mid(b.gpart, g_gn22, 1, N, 1, 64, 64, 0, st));
  CATSEG_TRY((tc::wgrad<128, 32, 4>(Im2col16<32, 96, false>{b.h3, 0}, Rows<true>{b.dc, 32, dl}, 288, 32, M2, g_c22,
                                    b.part, dm, st)));
  CATSEG_TRY((tc::gemm<192, 32, 4>(Halo16<32, 96, true>{b.dc, dl}, Rows<false>{pw.c22f, 32, 0}, Store{b.dh, 32},
                                   M2, 32, 288, dm, st)));
  CATSEG_TRY(launch_k(gn_bwd16_kernel<32, kP2>, dim3(N, 2), dim3(256), 0, st, (const float*)b.dh,
                      (const bf16*)b.c3, b.s3, w.gn21_g, w.gn21_b, b.dc, dl, b.gpart));
  CATSEG_TRY(sum_mid(b.gpart, g_gn21, 1, N, 1, 64, 64, 0, st));
  CATSEG_TRY(sum_mid_in(SplitIn{b.dc, dl}, dhg2, B, nT, 1, kP2 * 32, kP2 * 32, 0, st));
  CATSEG_TRY((tc::wgrad<128, 32, 4>(Im2col16<48, 96, false>{b.u2, 0}, Rows<true>{b.dc, 32, dl}, 432, 32, M2, g_c21,
                                    b.part, dm, st)));
  CATSEG_TRY((tc::gemm<192, 64, 4>(Halo16<32, 96, true>{b.dc, dl}, Rows<false>{pw.c21f, 48, 0},
                                   tc::StoreSplit{b.du, 48, ul}, M2, 48, 288, dm, st)));
  CATSEG_TRY((tc::wgrad<64, 64, 2, true>(Rows<false>{b.h2, 64, 0}, Phase16<48, 48, true>{b.du, ul}, 64, 192, M1,
                                         g_up2w, b.part, dm, st)));
  CATSEG_TRY(sum_mid(g_up2w, g_up2b, 1, 4, 1, 48, 48, 64 * 192, st));
  CATSEG_TRY((tc::gemm<128, 64, 4>(Phase16<48, 48, true>{b.du, ul}, Rows<false>{pw.up2t, 64, 0}, Store{b.dh, 64},
                                   M1, 64, 192, dm, st)));
  // stage 1: GN2, conv2, GN1, guidance, conv1, ConvT1
  CATSEG_TRY(launch_k(gn_bwd16_kernel<64, kP1>, dim3(N, 4), dim3(256), 0, st, (const float*)b.dh,
                      (const bf16*)b.c2, b.s2, w.gn12_g, w.gn12_b, b.dc, dl, b.gpart));
  CATSEG_TRY(sum_mid(b.gpart, g_gn12, 1, N, 1, 128, 128, 0, st));
  CATSEG_TRY((tc::wgrad<128, 64, 4>(Im2col16<64, 48, false>{b.h1, 0}, Rows<true>{b.dc, 64, dl}, 576, 64, M1, g_c12,
                                    b.part, dm, st)));
  CATSEG_TRY((tc::gemm<192, 64, 4>(Halo16<64, 48, true>{b.dc, dl}, Rows<false>{pw.c12f, 64, 0}, Store{b.dh, 64},
                                   M1, 64, 576, dm, st)));
  CATSEG_TRY(launch_k(gn_bwd16_kernel<64, kP1>, dim3(N, 4), dim3(256), 0, st, (const float*)b.dh,
                      (const bf16*)b.c1, b.s1, w.gn11_g, w.gn11_b, b.dc, dl, b.gpart));
  CATSEG_TRY(sum_mid(b.gpart, g_gn11, 1, N, 1, 128, 128, 0, st));
  CATSEG_TRY(sum_mid_in(SplitIn{b.dc, dl}, dhg1, B, nT, 1, kP1 * 64, kP1 * 64, 0, st));
  CATSEG_TRY((tc::wgrad<128, 64, 4>(Im2col16<96, 48, false>{b.u1, 0}, Rows<true>{b.dc, 64, dl}, 864, 64, M1, g_c11,
                                    b.part, dm, st)));
  CATSEG_TRY((tc::gemm<192, 96, 4>(Halo16<64, 48, true>{b.dc, dl}, Rows<false>{pw.c11f, 96, 0},
                                   tc::StoreSplit{b.du, 96, ul}, M1, 96, 576, dm, st)));
  CATSEG_TRY((tc::wgrad<128, 128, 2, true>(Rows<false>{x, 128, 0}, Phase16<24, 96, true>{b.du, ul}, 128, 384, M0,
                                           g_up1w, b.part, dm, st)));
  CATSEG_TRY(sum_mid(g_up1w, g_up1b, 1, 4, 1, 96, 96, 128 * 384, st));
  return tc::gemm<128, 128, 2>(Phase16<24, 96, true>{b.du, ul}, Rows<false>{pw.up1t, 128, 0},
                               tc::StoreBf16{dx, 128}, M0, 128, 384, dm, st);
}

}  // namespace

// workspace elements (fp32-sized) the backward of N slabs needs
extern "C" long long catseg_decoder_bwd_workspace(int N, int is_bf16) {
  long long used = 0;
  if (is_bf16)
    carve16(nullptr, N, &used);
  else
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
    return (int)run_tc(static_cast<const bf16*>(x), static_cast<const bf16*>(hg1), static_cast<const bf16*>(hg2),
                       c(dout), static_cast<bf16*>(dx), static_cast<float*>(dhg1), static_cast<float*>(dhg2), g, w,
                       static_cast<float*>(ws), N, nT, st);
  return (int)run<float>(static_cast<const float*>(x), static_cast<const float*>(hg1), static_cast<const float*>(hg2),
                         c(dout), static_cast<float*>(dx), static_cast<float*>(dhg1), static_cast<float*>(dhg2), g, w,
                         static_cast<float*>(ws), N, nT, st);
}
