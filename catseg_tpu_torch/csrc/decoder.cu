// The guidance-conditioned decoder (both Up stages + head), one CTA per
// (image, class) slab at a time; a persistent grid of one CTA per SM walks
// the slabs.
//
// Replaces catseg_tpu/kernels/decoder.py:fused_decoder (Pallas _kernel /
// _slab_forward, forward only).  Per slab x (24, 24, 128):
//   u1 = ConvT k2s2 128 -> 96 (48^2)      c1 = conv3x3 96 -> 64 + hg1[image]
//   h1 = ReLU(GN4(c1))                    c2 = conv3x3 64 -> 64
//   h2 = ReLU(GN4(c2))                    u2 = ConvT k2s2 64 -> 48 (96^2)
//   c3 = conv3x3 48 -> 32 + hg2[image]    h3 = ReLU(GN2(c3))
//   c4 = conv3x3 32 -> 32                 h4 = ReLU(GN2(c4))
//   out = conv3x3 32 -> 1 + hb, fp32 (96, 96)
// All 3x3 convs zero-pad by one at their own level.  hg1 / hg2 (the per-image
// guidance halves of conv1) come from the wrapper.
//
// Design.  A slab's activations (~3 MB in bf16) do not fit a CTA's 227 KB, so
// each CTA owns a private global scratch of three buffers (u1 -> A, c1 -> B,
// c2 -> C, u2 -> A, c3 -> B, c4 -> C), reused slab after slab and mostly
// served from L2.  Every pre-GN conv output is written once, its GroupNorm
// sums (fp32 E[x], E[x^2] of the stored values, eps 1e-5) accumulate in
// shared memory in the conv's epilogue, and the next stage applies GN + ReLU
// while it loads its input.  A 3x3 conv runs over row bands: the band plus a
// one-row halo (and zero pad columns) sits in shared memory, and the conv is
// an implicit GEMM over the 9 taps.  ConvT k2s2 is a per-pixel GEMM (Cin x
// 4*Cout) whose epilogue scatters the four phases.  GN statistics need the
// whole plane, which the CTA holds by construction: no cross-CTA reduction.
//
// bf16 (the serving dtype) runs every conv and ConvT on tensor cores (wmma
// bf16 -> fp32; conv weights staged in shared memory) and rounds where the
// reference's compiled bf16 branch does: ConvT outputs (bf16(acc) + bf16
// bias), pre-GN conv outputs, GN + ReLU outputs; the head stays fp32.  fp32
// runs CUDA-core FMAs, fp32 throughout: the oracle-parity path.
//
// Bound on the card: ~0.97 GFLOP of products per slab (ConvT 56.6 M x 2, the
// four convs 849 M, head 5.3 M), so bf16 tensor-core math bounds it (1500
// slabs = 1.45 TFLOP = 1.5 ms at 989 TFLOP/s); the scratch traffic (~6 MB per
// slab, L2 or HBM) and one CTA per SM with no load/compute overlap keep this
// first version well above that.  Shared memory allows one CTA per SM, so it
// runs 16 warps, each on one or two 16-channel output tiles, to keep more
// loads in flight.
#include <type_traits>

#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kThreads = 512, kWarps = kThreads / 32;
constexpr int kBufA = 96 * 96 * 48;  // u1 (48*48*96), then u2
constexpr int kBufB = 96 * 96 * 32;  // c1 (48*48*64), then c3
constexpr int kBufC = 96 * 96 * 32;  // c2, then c4
constexpr int kScratch = kBufA + kBufB + kBufC;
constexpr int kChunk = 96;           // ConvT pixels per GEMM chunk
constexpr size_t kSmemLimit = 232448;

// shared header: GN sums [4 convs][4 groups][2], GN scale / shift (64), head
// weights (288), tensor-core epilogue staging (256 floats per warp)
constexpr int kHeadW = 9 * 32;
constexpr int kHeaderFloats = 32 + 64 + 64 + kHeadW + kWarps * 256;
__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }
constexpr size_t kHeader = align128(kHeaderFloats * sizeof(float));

template <typename T> constexpr bool kTC = std::is_same<T, bf16>::value;

// shared-memory pixel stride of a conv's input band: tensor-core tiles need
// 32-byte aligned rows (a multiple of 16 bf16); an odd number of 32-byte
// units keeps ldmatrix at most 2-way conflicted.  FMA reads are broadcasts.
template <typename T> __host__ __device__ constexpr int band_stride(int cin) {
  return kTC<T> ? ((cin / 16) % 2 ? cin : cin + 16) : cin;
}
// head band: each lane reads 16-byte vectors at an odd 16-byte-unit stride
template <typename T> __host__ __device__ constexpr int head_stride() { return kTC<T> ? 40 : 36; }

template <typename T> constexpr size_t conv_bytes(int cin, int cout, int wd, int r) {
  return (kTC<T> ? align128((size_t)9 * cin * (cout + 8) * sizeof(T)) : 0)
         + (size_t)(r + 2) * (wd + 2) * band_stride<T>(cin) * sizeof(T);
}
template <typename T> constexpr size_t convt_bytes(int cin) {
  return (size_t)kChunk * (kTC<T> ? cin + 8 : cin) * sizeof(T);
}
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// stage geometry: (rows per band, output tiles per tensor-core job)
constexpr int kR1 = 4, kNG1 = 1, kR2 = 8, kNG2 = 2, kR3 = 4, kNG3 = 1, kR4 = 8, kNG4 = 2, kRH = 8;

template <typename T> constexpr size_t smem_bytes() {
  return kHeader + cmax(cmax(cmax(conv_bytes<T>(96, 64, 48, kR1), conv_bytes<T>(64, 64, 48, kR2)),
                             cmax(conv_bytes<T>(48, 32, 96, kR3), conv_bytes<T>(32, 32, 96, kR4))),
                        cmax((size_t)(kRH + 2) * 98 * head_stride<T>() * sizeof(T),
                             cmax(convt_bytes<T>(128), convt_bytes<T>(64))));
}
static_assert(smem_bytes<bf16>() <= kSmemLimit && smem_bytes<float>() <= kSmemLimit, "shared memory");

template <typename T> struct DecW {
  const T* up1_w; const float* up1_b;
  const T* c11_w; const float *gn11_g, *gn11_b;
  const T* c12_w; const float *gn12_g, *gn12_b;
  const T* up2_w; const float* up2_b;
  const T* c21_w; const float *gn21_g, *gn21_b;
  const T* c22_w; const float *gn22_g, *gn22_b;
  const T* hd_w; const float* hd_b;
};

// rows x cols (row-major, cols % 8 == 0) from global into shared memory at row stride ldd
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ldd, const T* __restrict__ src, int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int nv = cols / V;
  for (int i = threadIdx.x; i < rows * nv; i += blockDim.x) {
    const int r = i / nv, v = i % nv;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + v * V) =
        __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * cols + v * V));
  }
}

// ReLU(GN affine) of one 16-byte vector whose first channel is c0, in place
template <typename T>
__device__ __forceinline__ void gn_relu_vec(uint4& u, int c0, const float* sc, const float* sh) {
  constexpr int V = 16 / sizeof(T);
  T* t = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int e = 0; e < V; ++e) t[e] = from_f<T>(fmaxf(to_f(t[e]) * sc[c0 + e] + sh[c0 + e], 0.f));
}

// Input rows [y0-1, y0+R] x cols [-1, Wd] of an (Wd, Wd, CIN) plane into a band
// (R+2, Wd+2, P), zero outside the plane; GN applies ReLU(GN) to in-plane values.
// Scratch planes are written by this CTA during the launch: plain loads only.
template <typename T, int CIN, int P, int Wd, bool GN>
__device__ void load_band(T* band, const T* src, int y0, int R, const float* sc, const float* sh) {
  constexpr int V = 16 / sizeof(T), NV = CIN / V;
  const int n = (R + 2) * (Wd + 2) * NV;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = i % NV, px = i / NV;
    const int gx = px % (Wd + 2) - 1, gy = y0 - 1 + px / (Wd + 2);
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < Wd && gx >= 0 && gx < Wd) {
      u = *reinterpret_cast<const uint4*>(src + ((size_t)gy * Wd + gx) * CIN + v * V);
      if (GN) gn_relu_vec<T>(u, v * V, sc, sh);
    }
    *reinterpret_cast<uint4*>(band + (size_t)px * P + v * V) = u;
  }
}

// rows of CIN channels (contiguous pixels) into shared memory at row stride LDA
template <typename T, int CIN, int LDA, bool GN>
__device__ void load_rows(T* dst, const T* src, int rows, const float* sc, const float* sh) {
  constexpr int V = 16 / sizeof(T), NV = CIN / V;
  for (int i = threadIdx.x; i < rows * NV; i += blockDim.x) {
    const int v = i % NV, r = i / NV;
    uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)r * CIN + v * V);
    if (GN) gn_relu_vec<T>(u, v * V, sc, sh);
    *reinterpret_cast<uint4*>(dst + (size_t)r * LDA + v * V) = u;
  }
}

// add a 16-channel group's sums into the GN accumulators
__device__ __forceinline__ void add_stats(float* gs, int co, float s1, float s2) {
  atomicAdd(gs + 2 * (co >> 4), s1);
  atomicAdd(gs + 2 * (co >> 4) + 1, s2);
}

// 3x3 conv of a band on tensor cores: output R rows x Wd cols x COUT; a job is
// one 16-pixel strip of a row x NG 16-channel output tiles.  epi(r, x, co,
// acc) stores and returns the stored value, whose GN sums accumulate into gs.
template <int CIN, int COUT, int Wd, int P, int NG, typename Epi>
__device__ void conv_tc(const bf16* band, const bf16* Ws, int R, float* stage, float* gs, Epi epi) {
  namespace wm = nvcuda::wmma;
  constexpr int LDW = COUT + 8, strips = Wd / 16, groups = COUT / (16 * NG);
  static_assert(COUT % (16 * NG) == 0 && Wd % 16 == 0 && CIN % 16 == 0, "tile shape");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * 256;
  const int jobs = R * strips * groups;
  for (int j = warp; j < jobs; j += kWarps) {
    const int g = j % groups, s = (j / groups) % strips, r = j / (groups * strips);
    wm::fragment<wm::accumulator, 16, 16, 16, float> acc[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) wm::fill_fragment(acc[i], 0.f);
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* a0 = band + ((r + tap / 3) * (Wd + 2) + s * 16 + tap % 3) * P;
      const bf16* w0 = Ws + tap * CIN * LDW + g * NG * 16;
#pragma unroll
      for (int k = 0; k < CIN; k += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::load_matrix_sync(a, a0 + k, P);
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
          wm::load_matrix_sync(b, w0 + k * LDW + i * 16, LDW);
          wm::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      wm::store_matrix_sync(st, acc[i], 16, wm::mem_row_major);
      __syncwarp();
      const int co0 = (g * NG + i) * 16;
      float s1 = 0.f, s2 = 0.f;
      for (int e = lane; e < 256; e += 32) {
        const float v = epi(r, s * 16 + e / 16, co0 + e % 16, st[e]);
        s1 += v;
        s2 += v * v;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0 && gs) add_stats(gs, co0, s1, s2);
      __syncwarp();
    }
  }
}

// The same conv with CUDA-core FMAs in fp32: a thread owns one output channel
// and RB neighbouring pixels of a row; weights (9*CIN, COUT) read from global.
template <int CIN, int COUT, int Wd, int P, int RB, typename Epi>
__device__ void conv_fma(const float* band, const float* __restrict__ Wg, int R, float* gs, Epi epi) {
  constexpr int PG = Wd / RB;
  const int items = R * PG * COUT;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int co = idx % COUT, pg = idx / COUT;
    const int r = pg / PG, x0 = (pg % PG) * RB;
    float acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* a = band + ((r + tap / 3) * (Wd + 2) + x0 + tap % 3) * P;
      const float* w = Wg + (size_t)tap * CIN * COUT + co;
#pragma unroll 4
      for (int ci = 0; ci < CIN; ++ci) {
        const float wv = __ldg(w + ci * COUT);
#pragma unroll
        for (int i = 0; i < RB; ++i) acc[i] = fmaf(a[i * P + ci], wv, acc[i]);
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float v = epi(r, x0 + i, co, acc[i]);
      s1 += v;
      s2 += v * v;
    }
    if (gs) add_stats(gs, co, s1, s2);
  }
}

// One 3x3 conv stage over a (Wd, Wd, CIN) plane in bands of R rows; GN applies
// ReLU(GN) (sc, sh) to the input on load.  epi(y, x, co, acc) as in conv_tc.
template <typename T, int CIN, int COUT, int Wd, int R, int NG, bool GN, typename Epi>
__device__ void conv_stage(unsigned char* work, const T* src, const T* __restrict__ wg, const float* sc,
                           const float* sh, float* stage, float* gs, Epi epi) {
  constexpr int P = band_stride<T>(CIN);
  T* band = reinterpret_cast<T*>(work);
  if constexpr (kTC<T>) {
    copy_rows<T>(reinterpret_cast<T*>(work), COUT + 8, wg, 9 * CIN, COUT);
    band = reinterpret_cast<T*>(work + align128((size_t)9 * CIN * (COUT + 8) * sizeof(T)));
  }
  for (int y0 = 0; y0 < Wd; y0 += R) {
    __syncthreads();
    load_band<T, CIN, P, Wd, GN>(band, src, y0, R, sc, sh);
    __syncthreads();
    auto e = [&](int r, int x, int co, float a) { return epi(y0 + r, x, co, a); };
    if constexpr (kTC<T>) {
      conv_tc<CIN, COUT, Wd, P, NG>(band, reinterpret_cast<const T*>(work), R, stage, gs, e);
    } else {
      conv_fma<CIN, COUT, Wd, P, 8>(band, wg, R, gs, e);
    }
  }
  __syncthreads();
}

// ConvT k2s2 of a (Win, Win, CIN) plane into (2Win, 2Win, COUT): per-pixel
// GEMM over chunks of kChunk pixels, the four phases scattered in the epilogue.
template <typename T, int CIN, int COUT, int Win, bool GN>
__device__ void convt_stage(unsigned char* work, const T* src, T* dst, const T* __restrict__ wg,
                            const float* __restrict__ bias, const float* sc, const float* sh, float* stage) {
  constexpr int LDA = kTC<T> ? CIN + 8 : CIN;
  static_assert((Win * Win) % kChunk == 0, "chunking");
  T* A = reinterpret_cast<T*>(work);
  for (int p0 = 0; p0 < Win * Win; p0 += kChunk) {
    __syncthreads();
    load_rows<T, CIN, LDA, GN>(A, src + (size_t)p0 * CIN, kChunk, sc, sh);
    __syncthreads();
    auto epi = [&](int r, int c, float acc) {
      const int p = p0 + r, i = p / Win, j = p % Win, ph = c / COUT, co = c % COUT;
      const size_t o = ((size_t)(2 * i + (ph >> 1)) * 2 * Win + 2 * j + (ph & 1)) * COUT + co;
      dst[o] = from_f<T>(rnd<T>(acc) + rnd<T>(bias[co]));
    };
    if constexpr (kTC<T>) {
      mm_tc(A, LDA, wg, 4 * COUT, kChunk, 4 * COUT, CIN, stage, epi);
    } else {
      mm_rows<8>(A, LDA, wg, 4 * COUT, kChunk, 4 * COUT, CIN, epi);
    }
  }
  __syncthreads();
}

// GroupNorm affine (16 channels per group) from the sums gs of a plane of hw pixels
__device__ void gn_affine(const float* gs, const float* __restrict__ g, const float* __restrict__ b, int C,
                          float cnt, float* sc, float* sh) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float mean = gs[2 * (c >> 4)] / cnt;
    const float var = gs[2 * (c >> 4) + 1] / cnt - mean * mean;
    const float s = rsqrtf(var + 1e-5f) * g[c];
    sc[c] = s;
    sh[c] = b[c] - mean * s;
  }
}

// head: conv3x3 32 -> 1 of ReLU(GN(c4)) + bias, fp32 out (96, 96)
template <typename T>
__device__ void head_stage(unsigned char* work, const T* src, const float* hw, float hb, float* out,
                           const float* sc, const float* sh) {
  constexpr int P = head_stride<T>(), V = 16 / sizeof(T), Wd = 96;
  T* band = reinterpret_cast<T*>(work);
  for (int y0 = 0; y0 < Wd; y0 += kRH) {
    __syncthreads();
    load_band<T, 32, P, Wd, true>(band, src, y0, kRH, sc, sh);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRH * Wd; idx += blockDim.x) {
      const int r = idx / Wd, x = idx % Wd;
      float acc = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const T* a = band + ((r + tap / 3) * (Wd + 2) + x + tap % 3) * P;
        const float* w = hw + tap * 32;
#pragma unroll
        for (int v = 0; v < 32; v += V) {
          const uint4 u = *reinterpret_cast<const uint4*>(a + v);
          const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int e = 0; e < V; ++e) acc = fmaf(to_f(t[e]), w[v + e], acc);
        }
      }
      out[(y0 + r) * Wd + x] = acc + hb;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
decoder_kernel(const T* __restrict__ x, const T* __restrict__ hg1, const T* __restrict__ hg2, float* out,
               T* scratch, DecW<T> w, int N, int nT) {
  extern __shared__ __align__(128) unsigned char smraw[];
  float* gsum = reinterpret_cast<float*>(smraw);  // [4][4][2]
  float* sc = gsum + 32;
  float* sh = sc + 64;
  float* hw = sh + 64;
  float* stage = hw + kHeadW;
  unsigned char* work = smraw + kHeader;
  T* bufA = scratch + (size_t)blockIdx.x * kScratch;
  T* bufB = bufA + kBufA;
  T* bufC = bufB + kBufB;
  for (int i = threadIdx.x; i < kHeadW; i += blockDim.x) hw[i] = to_f(w.hd_w[i]);
  const float hb = w.hd_b[0];
  constexpr float cnt1 = 48.f * 48.f * 16.f, cnt2 = 96.f * 96.f * 16.f;

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const int img = n / nT;
    const T* hg1b = hg1 + (size_t)img * 48 * 48 * 64;
    const T* hg2b = hg2 + (size_t)img * 96 * 96 * 32;
    for (int i = threadIdx.x; i < 32; i += blockDim.x) gsum[i] = 0.f;

    // u1 = ConvT(x) -> A
    convt_stage<T, 128, 96, 24, false>(work, x + (size_t)n * 24 * 24 * 128, bufA, w.up1_w, w.up1_b,
                                       nullptr, nullptr, stage);
    // c1 = conv(u1) + hg1 -> B
    conv_stage<T, 96, 64, 48, kR1, kNG1, false>(
        work, bufA, w.c11_w, nullptr, nullptr, stage, gsum, [&](int y, int xx, int co, float a) {
          const size_t i = ((size_t)y * 48 + xx) * 64 + co;
          const T v = from_f<T>(a + to_f(hg1b[i]));
          bufB[i] = v;
          return to_f(v);
        });
    gn_affine(gsum, w.gn11_g, w.gn11_b, 64, cnt1, sc, sh);
    // c2 = conv(ReLU(GN(c1))) -> C
    conv_stage<T, 64, 64, 48, kR2, kNG2, true>(
        work, bufB, w.c12_w, sc, sh, stage, gsum + 8, [&](int y, int xx, int co, float a) {
          const size_t i = ((size_t)y * 48 + xx) * 64 + co;
          const T v = from_f<T>(a);
          bufC[i] = v;
          return to_f(v);
        });
    gn_affine(gsum + 8, w.gn12_g, w.gn12_b, 64, cnt1, sc, sh);
    // u2 = ConvT(ReLU(GN(c2))) -> A
    convt_stage<T, 64, 48, 48, true>(work, bufC, bufA, w.up2_w, w.up2_b, sc, sh, stage);
    // c3 = conv(u2) + hg2 -> B
    conv_stage<T, 48, 32, 96, kR3, kNG3, false>(
        work, bufA, w.c21_w, nullptr, nullptr, stage, gsum + 16, [&](int y, int xx, int co, float a) {
          const size_t i = ((size_t)y * 96 + xx) * 32 + co;
          const T v = from_f<T>(a + to_f(hg2b[i]));
          bufB[i] = v;
          return to_f(v);
        });
    gn_affine(gsum + 16, w.gn21_g, w.gn21_b, 32, cnt2, sc, sh);
    // c4 = conv(ReLU(GN(c3))) -> C
    conv_stage<T, 32, 32, 96, kR4, kNG4, true>(
        work, bufB, w.c22_w, sc, sh, stage, gsum + 24, [&](int y, int xx, int co, float a) {
          const size_t i = ((size_t)y * 96 + xx) * 32 + co;
          const T v = from_f<T>(a);
          bufC[i] = v;
          return to_f(v);
        });
    gn_affine(gsum + 24, w.gn22_g, w.gn22_b, 32, cnt2, sc, sh);
    // out = head(ReLU(GN(c4)))
    head_stage<T>(work, bufC, hw, hb, out + (size_t)n * 96 * 96, sc, sh);
  }
}

template <typename T> cudaError_t prepare(int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(decoder_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes<T>());
  if (e != cudaSuccess) return e;
  if (blocks) {
    int dev = 0, sms = 0, per = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, decoder_kernel<T>, kThreads, smem_bytes<T>());
    if (e != cudaSuccess) return e;
    *blocks = sms * (per > 0 ? per : 1);
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t run(const void* x, const void* hg1, const void* hg2, void* out, void* scratch, const void* const* p,
                int N, int nT, int grid, cudaStream_t st) {
  auto t = [&](int i) { return static_cast<const T*>(p[i]); };
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  const DecW<T> w{t(0),  f(1),  t(2),  f(3),  f(4),  t(5),  f(6),  f(7),  t(8),
                  f(9),  t(10), f(11), f(12), t(13), f(14), f(15), t(16), f(17)};
  cudaError_t e = prepare<T>(nullptr);
  if (e != cudaSuccess) return e;
  decoder_kernel<T><<<grid, kThreads, smem_bytes<T>(), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(hg1), static_cast<const T*>(hg2),
      static_cast<float*>(out), static_cast<T*>(scratch), w, N, nT);
  return cudaGetLastError();
}

}  // namespace

// scratch elements one CTA needs (the wrapper allocates grid times this)
extern "C" int catseg_decoder_scratch_elems() { return kScratch; }

// CTAs of the persistent grid on the current device (SMs x CTAs per SM)
extern "C" int catseg_decoder_blocks(int is_bf16) {
  int blocks = 0;
  const cudaError_t e = is_bf16 ? prepare<bf16>(&blocks) : prepare<float>(&blocks);
  return e == cudaSuccess ? blocks : -(int)e;
}

extern "C" int catseg_decoder(const void* x, const void* hg1, const void* hg2, void* out, void* scratch,
                              const void* up1_w, const void* up1_b, const void* c11_w, const void* gn11_g,
                              const void* gn11_b, const void* c12_w, const void* gn12_g, const void* gn12_b,
                              const void* up2_w, const void* up2_b, const void* c21_w, const void* gn21_g,
                              const void* gn21_b, const void* c22_w, const void* gn22_g, const void* gn22_b,
                              const void* hd_w, const void* hd_b, int N, int nT, int grid, int is_bf16,
                              void* stream) {
  if (N <= 0 || nT <= 0 || N % nT || grid <= 0) return (int)cudaErrorInvalidValue;
  const void* p[18] = {up1_w, up1_b, c11_w, gn11_g, gn11_b, c12_w, gn12_g, gn12_b, up2_w,
                       up2_b, c21_w, gn21_g, gn21_b, c22_w, gn22_g, gn22_b, hd_w,   hd_b};
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? run<bf16>(x, hg1, hg2, out, scratch, p, N, nT, grid, st)
                       : run<float>(x, hg1, hg2, out, scratch, p, N, nT, grid, st));
}
