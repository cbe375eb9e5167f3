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
// c2 -> C, u2 -> A, c3 -> B, c4 -> C), reused slab after slab.  Every pre-GN
// conv output is written once; its GroupNorm sums (fp32 E[x], E[x^2] of the
// stored values, eps 1e-5) are taken in the conv's epilogue, each warp's in
// its own slot, and summed over the warps in a fixed order after the stage:
// no atomics, so two runs are bit-equal.  The next stage applies GN + ReLU to
// its input once it has landed in shared memory.  A 3x3 conv runs over row
// bands: the band plus a one-row halo (and zero pad columns) sits in shared
// memory, and the conv is an implicit GEMM over the 9 taps.  ConvT k2s2 is a
// per-pixel GEMM (Cin x 4*Cout) whose epilogue scatters the four phases.  GN
// statistics need the whole plane, which the CTA holds by construction.
//
// bf16 (the serving dtype) runs every conv, ConvT and the head on mma.sync
// tensor cores (its note below) and rounds where the reference's compiled
// bf16 branch does: ConvT outputs (bf16(acc) + bf16 bias), pre-GN conv
// outputs, GN + ReLU outputs; the head sums its bf16 products in fp32 and
// writes fp32 logits.  fp32 runs CUDA-core FMAs with synchronous band loads,
// fp32 throughout: the oracle-parity path.
//
// Bound on the card: ~0.97 GFLOP of products per slab (ConvT 56.6 M x 2, the
// four convs 849 M, head 5.3 M), so bf16 tensor-core math bounds it (1500
// slabs = 1.45 TFLOP = 1.47 ms at 989 TFLOP/s); the bf16 kernel takes ~9.1
// ms on an H100 (80GB HBM3, 700 W), 160 TFLOP/s.  Per-stage clocks
// (tools/decoder_phases.py) spread a slab's time over its stages: each conv
// 14-19% at 4-6x its tensor-core cycles, the second ConvT 14% at 14x, the
// head 10%, the first ConvT 7%.  Below the math sit the scratch planes: a
// slab writes u1, c1, c2, u2, c3 and c4 (3.1 MB) and reads them back with
// their band halos (4.1 MB), and 132 CTAs' scratch (272 MB) does not stay in
// the 50 MB L2: ~10.8 GB at 1500 slabs, 3.2 ms at 3.35 TB/s if all of it
// went to device memory.  One 12-warp CTA an SM (217 KB of shared memory at
// the first conv), each band's tasks split evenly over the warps, two or
// three barriers a band.
#include <type_traits>

#include "attn_common.cuh"
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kBufA = 96 * 96 * 48;  // u1 (48*48*96), then u2
constexpr int kBufB = 96 * 96 * 32;  // c1 (48*48*64), then c3
constexpr int kBufC = 96 * 96 * 32;  // c2, then c4
constexpr int kScratch = kBufA + kBufB + kBufC;
constexpr int kChunk = 96;           // ConvT pixels per GEMM chunk (fp32)
constexpr size_t kSmemLimit = 232448;

template <typename T> constexpr bool kTC = std::is_same<T, bf16>::value;
// CTA size: fp32 16 warps (a thread per output channel and 8 pixels); bf16
// 12 warps (a warp per 48-pixel x 16-channel tile, 12 tiles a band)
template <typename T> constexpr int kThreadsOf = kTC<T> ? 384 : 512;
constexpr int kMaxWarps = 16;

// shared header: GN partial sums [warp][4 groups][2], GN scale / shift (64),
// head weights (288)
constexpr int kHeadW = 9 * 32;
constexpr int kHeaderFloats = kMaxWarps * 4 * 2 + 64 + 64 + kHeadW;
__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }
constexpr size_t kHeader = align128(kHeaderFloats * sizeof(float));

// fp32 head band: each lane reads 16-byte vectors at an odd 16-byte-unit stride
constexpr int kHeadStride = 36;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// fp32 stage geometry: rows per band
constexpr int kR1 = 4, kR2 = 8, kR3 = 4, kR4 = 8, kRH = 8;

constexpr size_t fma_conv_bytes(int cin, int wd, int r) { return (size_t)(r + 2) * (wd + 2) * cin * sizeof(float); }

constexpr size_t smem_bytes_fp32() {
  return kHeader + cmax(cmax(cmax(fma_conv_bytes(96, 48, kR1), fma_conv_bytes(64, 48, kR2)),
                             cmax(fma_conv_bytes(48, 96, kR3), fma_conv_bytes(32, 96, kR4))),
                        cmax((size_t)(kRH + 2) * 98 * kHeadStride * sizeof(float),
                             (size_t)kChunk * 128 * sizeof(float)));
}

// ---- bf16 stages on the tensor cores ----
//
// Every stage is an implicit GEMM on mma.sync m16n8k16 (bf16 in, fp32
// accumulators).  A stage first copies its weights, packed by the wrapper in
// mma fragment order 16 rows deep (kernels/decoder.py), into shared memory by
// cp.async; then it walks its input in bands (3x3 convs: R output rows plus a
// one-row halo and zero pad columns; ConvT: 96-pixel chunks), double-
// buffered: band i + 1 arrives by 16-byte cp.async while band i computes.  A
// landed band that feeds on a GroupNorm'd plane gets ReLU(GN) in one pass
// over its in-plane pixels (pad pixels stay 0), rounded to bf16 as before.
// Band pixels sit at a stride of Cin + 8 elements, an odd number of 16-byte
// units, so ldmatrix's 8 row addresses hit 8 distinct bank groups at any
// tap offset.  A warp's task is 3 row strips of 16 pixels (48 pixels of one
// output row) x 16 output channels; its A fragments come by ldmatrix from the
// band, B from the packed weights (8 bytes a lane, one 256-byte read a
// warp), and the epilogue runs on the fp32 accumulators in registers:
// guidance plane, rounding, bf16-pair stores and the GN partial sums of its
// channel group, which stays the warp's through the stage.
//
// Weights live in shared memory, not in registers read from L2 (as the Swin
// kernel's do): a conv's 48-pixel tasks would re-read a weight slice from L2
// once per task, ~20 MB a slab; the staged copy is 0.35 MB a slab.
constexpr int kTcWarps = kThreadsOf<bf16> / 32;
constexpr int kMS = 3;               // row strips a task
constexpr int kChunkTC = 192;        // ConvT pixels per chunk
// rows per band of the four convs and the head
constexpr int kB1 = 3, kB2 = 6, kB3 = 6, kB4 = 6, kBH = 6;

constexpr size_t tc_band_bytes(int cin, int wd, int r) { return (size_t)(r + 2) * (wd + 2) * (cin + 8) * sizeof(bf16); }
constexpr size_t tc_conv_bytes(int cin, int cout, int wd, int r) {
  return align128((size_t)9 * cin * cout * sizeof(bf16)) + 2 * tc_band_bytes(cin, wd, r);
}
constexpr size_t tc_convt_bytes(int cin, int cout) {
  return align128((size_t)cin * 4 * cout * sizeof(bf16)) + 2 * (size_t)kChunkTC * (cin + 8) * sizeof(bf16);
}
constexpr size_t smem_bytes_tc() {
  return kHeader + cmax(cmax(cmax(tc_conv_bytes(96, 64, 48, kB1), tc_conv_bytes(64, 64, 48, kB2)),
                             cmax(tc_conv_bytes(48, 32, 96, kB3), tc_conv_bytes(32, 32, 96, kB4))),
                        cmax(tc_conv_bytes(32, 8, 96, kBH), cmax(tc_convt_bytes(128, 96), tc_convt_bytes(64, 48))));
}
template <typename T> constexpr size_t smem_bytes() { return kTC<T> ? smem_bytes_tc() : smem_bytes_fp32(); }
static_assert(smem_bytes<bf16>() <= kSmemLimit && smem_bytes<float>() <= kSmemLimit, "shared memory");

// Timing build (tools/decoder_phases.py; never the library the port loads):
// CATSEG_DEC_PHASE_CLOCKS makes thread 0 of every CTA add the clock64 cycles
// of each stage (ConvT 1, conv 1, conv 2, ConvT 2, conv 3, conv 4, head;
// GN affines with the conv before them) to g_phase_cycles, summed over the
// CTA's slabs, and its slab count to the last slot.
#ifdef CATSEG_DEC_PHASE_CLOCKS
constexpr int kPhases = 7;
__device__ unsigned long long g_phase_cycles[kPhases + 1];
#define DEC_PHASE(i)                                                                      \
  do {                                                                                    \
    if (threadIdx.x == 0) {                                                               \
      const long long now = clock64();                                                    \
      atomicAdd(&g_phase_cycles[i], (unsigned long long)(now - t_phase));                 \
      t_phase = now;                                                                      \
    }                                                                                     \
  } while (0)
#else
#define DEC_PHASE(i) \
  do {               \
  } while (0)
#endif

template <typename T> struct DecW {
  const T* up1_w; const float* up1_b;
  const T* c11_w; const float *gn11_g, *gn11_b;
  const T* c12_w; const float *gn12_g, *gn12_b;
  const T* up2_w; const float* up2_b;
  const T* c21_w; const float *gn21_g, *gn21_b;
  const T* c22_w; const float *gn22_g, *gn22_b;
  const T* hd_w; const float* hd_b;
};

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

// A warp's GroupNorm partial sums of a stage into its own slot ([4 groups]
// x {sum, sum of squares}; groups it holds no channel of stay 0).  Lanes < 16
// hold group ga's sums, lanes >= 16 group gb's (ga == gb: the whole warp's).
__device__ __forceinline__ void write_slot(float* slot, int lane, float s1, float s2, int ga, int gb) {
  const int top = ga == gb ? 16 : 8;   // xor butterfly over the warp, or over each half
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o <= top) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
  }
  if (lane < 8) slot[lane] = 0.f;
  __syncwarp();
  if (lane == 0) {
    slot[2 * ga] = s1;
    slot[2 * ga + 1] = s2;
  } else if (lane == 16 && ga != gb) {
    slot[2 * gb] = s1;
    slot[2 * gb + 1] = s2;
  }
}

// GroupNorm affine (16 channels per group) of a plane of cnt values a group,
// from the warps' slots summed in warp order
__device__ void gn_affine(const float* slots, int nwarps, const float* __restrict__ g, const float* __restrict__ b,
                          int C, float cnt, float* sc, float* sh) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      s1 += slots[w * 8 + 2 * (c >> 4)];
      s2 += slots[w * 8 + 2 * (c >> 4) + 1];
    }
    const float mean = s1 / cnt;
    const float var = s2 / cnt - mean * mean;
    const float s = rsqrtf(var + 1e-5f) * g[c];
    sc[c] = s;
    sh[c] = b[c] - mean * s;
  }
}

// ---- fp32 stages: CUDA-core FMAs ----

// 3x3 conv of a band: a thread owns output channel co (fixed: blockDim is a
// multiple of COUT) and RB neighbouring pixels of a row; weights (9*CIN,
// COUT) read from global.  epi(r, x, co, acc) stores and returns the stored
// value, whose GN sums accumulate into s1, s2.
template <int CIN, int COUT, int Wd, int P, int RB, typename Epi>
__device__ void conv_fma(const float* band, const float* __restrict__ Wg, int R, float& s1, float& s2, Epi epi) {
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
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float v = epi(r, x0 + i, co, acc[i]);
      s1 += v;
      s2 += v * v;
    }
  }
}

// One 3x3 conv stage over a (Wd, Wd, CIN) plane in bands of R rows; GN applies
// ReLU(GN) (sc, sh) to the input on load.  The stage's GN partial sums go to
// this warp's slot.
template <int CIN, int COUT, int Wd, int R, bool GN, typename Epi>
__device__ void conv_stage_fma(unsigned char* work, const float* src, const float* __restrict__ wg, const float* sc,
                               const float* sh, float* slots, Epi epi) {
  static_assert(kThreadsOf<float> % COUT == 0 && COUT % 32 == 0, "a thread keeps one output channel");
  float* band = reinterpret_cast<float*>(work);
  float s1 = 0.f, s2 = 0.f;
  for (int y0 = 0; y0 < Wd; y0 += R) {
    __syncthreads();
    load_band<float, CIN, CIN, Wd, GN>(band, src, y0, R, sc, sh);
    __syncthreads();
    conv_fma<CIN, COUT, Wd, CIN, 8>(band, wg, R, s1, s2,
                                    [&](int r, int x, int co, float a) { return epi(y0 + r, x, co, a); });
  }
  const int g0 = ((threadIdx.x & ~31) % COUT) >> 4;   // lanes 0-15 hold group g0, 16-31 group g0 + 1
  write_slot(slots + (threadIdx.x >> 5) * 8, threadIdx.x & 31, s1, s2, g0, g0 + 1);
  __syncthreads();
}

// ConvT k2s2 of a (Win, Win, CIN) plane into (2Win, 2Win, COUT): per-pixel
// GEMM over chunks of kChunk pixels, the four phases scattered in the epilogue.
template <int CIN, int COUT, int Win, bool GN>
__device__ void convt_stage_fma(unsigned char* work, const float* src, float* dst, const float* __restrict__ wg,
                                const float* __restrict__ bias, const float* sc, const float* sh) {
  static_assert((Win * Win) % kChunk == 0, "chunking");
  float* A = reinterpret_cast<float*>(work);
  for (int p0 = 0; p0 < Win * Win; p0 += kChunk) {
    __syncthreads();
    load_rows<float, CIN, CIN, GN>(A, src + (size_t)p0 * CIN, kChunk, sc, sh);
    __syncthreads();
    mm_rows<8>(A, CIN, wg, 4 * COUT, kChunk, 4 * COUT, CIN, [&](int r, int c, float acc) {
      const int p = p0 + r, i = p / Win, j = p % Win, ph = c / COUT, co = c % COUT;
      dst[((size_t)(2 * i + (ph >> 1)) * 2 * Win + 2 * j + (ph & 1)) * COUT + co] = acc + bias[co];
    });
  }
  __syncthreads();
}

// ---- bf16 stages (the note above) ----

// items 0 .. n-1 through two shared-memory buffers: load(i, buf) issues item
// i's cp.async copies (the first group also takes whatever the caller issued
// before), prep(i, buf) works on the landed buffer and returns whether it
// wrote it (a barrier follows), compute(i, buf) reads it
template <typename Load, typename Prep, typename Compute>
__device__ __forceinline__ void pipelined(int n, Load load, Prep prep, Compute compute) {
  load(0, 0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (prep(i, i & 1)) __syncthreads();
    compute(i, i & 1);
    __syncthreads();
  }
}

// n16-byte vectors of packed weights into shared memory (joins the next commit group)
__device__ __forceinline__ void stage_weights(void* dst, const void* src, size_t bytes) {
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    cp_async16(static_cast<char*>(dst) + 16 * i, static_cast<const char*>(src) + 16 * i);
}

// ReLU(GN) in place over the n16 16-byte vectors of a landed buffer for
// which inplane(vector index) holds; CIN channels a pixel at stride P
template <int CIN, int P, typename In>
__device__ __forceinline__ void gn_relu_band(bf16* buf, int npx, const float* sc, const float* sh, In inplane) {
  constexpr int NV = CIN / 8;
  for (int e = threadIdx.x; e < npx * NV; e += blockDim.x) {
    const int v = e % NV, px = e / NV;
    if (!inplane(px)) continue;
    uint4* p = reinterpret_cast<uint4*>(buf + (size_t)px * P + v * 8);
    uint4 u = *p;
    gn_relu_vec<bf16>(u, v * 8, sc, sh);
    *p = u;
  }
}

// acc[i][j] += A (strips i = 0..2, CK k-steps from column 0) x B (n8 tiles
// j < NT at w[j KS 32], k-steps ks0 ..); a is this lane's ldmatrix row
// address in strip 0 (strip i 16 P further), w packed 16 deep with KS
// k-steps a tile
template <int CK, int NT>
__device__ __forceinline__ void mma_taps(float (&acc)[kMS][NT][4], const bf16* a, int P, const uint2* w, int KS,
                                         int ks0) {
#pragma unroll
  for (int kc = 0; kc < CK; ++kc) {
    uint2 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = w[(j * KS + ks0 + kc) * 32];
#pragma unroll
    for (int i = 0; i < kMS; ++i) {
      unsigned f[4];
      ldmatrix_x4(f, a + i * 16 * P + kc * 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], f, b[j].x, b[j].y);
    }
  }
}

// cp.async copies of input rows [y0-1, y0+R] x cols [-1, Wd] of a (Wd, Wd,
// CIN) plane into a band (R+2, Wd+2, CIN+8), zero-filled outside the plane
template <int CIN, int Wd, int R>
__device__ __forceinline__ void band_copy(bf16* band, const bf16* src, int y0) {
  constexpr int P = CIN + 8, NV = CIN / 8;
  for (int e = threadIdx.x; e < (R + 2) * (Wd + 2) * NV; e += blockDim.x) {
    const int v = e % NV, px = e / NV;
    const int gx = px % (Wd + 2) - 1, gy = y0 - 1 + px / (Wd + 2);
    const bool in = gy >= 0 && gy < Wd && gx >= 0 && gx < Wd;
    cp_async16(band + px * P + v * 8, src + (in ? ((size_t)gy * Wd + gx) * CIN + v * 8 : 0), in);
  }
}

// ReLU(GN) over the in-plane pixels of a landed band (band_copy's layout)
template <int CIN, int Wd, int R>
__device__ __forceinline__ void band_gn(bf16* band, int y0, const float* sc, const float* sh) {
  gn_relu_band<CIN, CIN + 8>(band, (R + 2) * (Wd + 2), sc, sh, [&](int px) {
    const int gx = px % (Wd + 2) - 1, gy = y0 - 1 + px / (Wd + 2);
    return gy >= 0 && gy < Wd && gx >= 0 && gx < Wd;
  });
}

// 3x3 conv stage over a (Wd, Wd, CIN) plane in bands of R output rows into
// dst (Wd, Wd, COUT): bf16(conv), or bf16(conv + hg) with hg the image's
// guidance plane, whose pairs a task loads before its products (loaded in
// the epilogue, each would wait behind the stores before it); the stored
// values' GN sums accumulate in the warp's channel group, warp % (COUT /
// 16) throughout.
template <int CIN, int COUT, int Wd, int R, bool GN, bool GUIDED>
__device__ void conv_stage_tc(unsigned char* work, const bf16* src, const bf16* wpk, const float* sc, const float* sh,
                              float* slots, bf16* dst, const bf16* __restrict__ hg) {
  constexpr int P = CIN + 8, CK = CIN / 16, KS = 9 * CK, CG = COUT / 16, SEG = Wd / (16 * kMS);
  constexpr int BAND = (R + 2) * (Wd + 2) * P, TASKS = R * SEG * CG;
  static_assert(Wd % (16 * kMS) == 0 && TASKS % kTcWarps == 0 && kTcWarps % CG == 0, "task shape");
  static_assert((P / 8) % 2 == 1 && (BAND * sizeof(bf16)) % 16 == 0, "band layout");
  constexpr size_t WB = (size_t)9 * CIN * COUT * sizeof(bf16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint2* Ws = reinterpret_cast<const uint2*>(work);
  bf16* bands = reinterpret_cast<bf16*>(work + align128(WB));
  stage_weights(work, wpk, WB);
  auto load = [&](int bi, int buf) { band_copy<CIN, Wd, R>(bands + buf * BAND, src, bi * R); };
  auto prep = [&](int bi, int buf) {
    if (GN) band_gn<CIN, Wd, R>(bands + buf * BAND, bi * R, sc, sh);
    return GN;
  };
  const int cg = warp % CG;
  const uint2* w0 = Ws + (size_t)(2 * cg) * KS * 32 + lane;
  float s1 = 0.f, s2 = 0.f;
  auto compute = [&](int bi, int buf) {
    const bf16* band = bands + buf * BAND;
    for (int task = warp; task < TASKS; task += kTcWarps) {
      const int pg = task / CG, r = pg / SEG, x0 = (pg % SEG) * 16 * kMS;
      const size_t o0 = ((size_t)(bi * R + r) * Wd + x0 + g) * COUT + 16 * cg + 2 * t;   // strip 0, row g, n8 tile 0
      unsigned hv[kMS][2][2];   // [strip][n8 tile][row half]
      if constexpr (GUIDED) {
#pragma unroll
        for (int i = 0; i < kMS; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              hv[i][j][h] = __ldg(reinterpret_cast<const unsigned*>(hg + o0 + (size_t)(16 * i + 8 * h) * COUT + 8 * j));
      }
      float acc[kMS][2][4];
      zero(acc);
      const bf16* a0 = band + (r * (Wd + 2) + x0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8;
      for (int tap = 0; tap < 9; ++tap)
        mma_taps<CK>(acc, a0 + ((tap / 3) * (Wd + 2) + tap % 3) * P, P, w0, KS, tap * CK);
#pragma unroll
      for (int i = 0; i < kMS; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
            if constexpr (GUIDED) {
              const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hv[i][j][h]));
              v0 += hf.x;
              v1 += hf.y;
            }
            v0 = rnd<bf16>(v0);
            v1 = rnd<bf16>(v1);
            store_bf16x2(dst + o0 + (size_t)(16 * i + 8 * h) * COUT + 8 * j, v0, v1);
            s1 += v0 + v1;
            s2 += v0 * v0 + v1 * v1;
          }
    }
  };
  pipelined(Wd / R, load, prep, compute);
  write_slot(slots + warp * 8, lane, s1, s2, cg, cg);
  __syncthreads();
}

// ConvT k2s2 of a (Win, Win, CIN) plane into (2Win, 2Win, COUT): per-pixel
// GEMM (CIN x 4 COUT) over chunks of kChunkTC pixels, output columns (phase,
// channel); the epilogue scatters channel pairs to the four phases.
template <int CIN, int COUT, int Win, bool GN>
__device__ void convt_stage_tc(unsigned char* work, const bf16* src, bf16* dst, const bf16* wpk,
                               const float* __restrict__ bias, const float* sc, const float* sh) {
  constexpr int P = CIN + 8, NV = CIN / 8, KS = CIN / 16, NB = 4 * COUT / 16, SEG = kChunkTC / (16 * kMS);
  constexpr int TASKS = SEG * NB;
  static_assert((Win * Win) % kChunkTC == 0 && kChunkTC % (16 * kMS) == 0 && TASKS % kTcWarps == 0, "chunking");
  static_assert(COUT % 16 == 0 && (P / 8) % 2 == 1, "a 16-column block lies in one phase; band layout");
  constexpr size_t WB = (size_t)CIN * 4 * COUT * sizeof(bf16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint2* Ws = reinterpret_cast<const uint2*>(work);
  bf16* bufs = reinterpret_cast<bf16*>(work + align128(WB));
  stage_weights(work, wpk, WB);
  auto load = [&](int c, int buf) {
    bf16* A = bufs + buf * kChunkTC * P;
    const bf16* s = src + (size_t)c * kChunkTC * CIN;
    for (int e = threadIdx.x; e < kChunkTC * NV; e += blockDim.x)
      cp_async16(A + (e / NV) * P + (e % NV) * 8, s + (size_t)e * 8);
  };
  auto prep = [&](int, int buf) {
    if (!GN) return false;
    gn_relu_band<CIN, P>(bufs + buf * kChunkTC * P, kChunkTC, sc, sh, [](int) { return true; });
    return true;
  };
  auto compute = [&](int c, int buf) {
    const bf16* A = bufs + buf * kChunkTC * P;
    for (int task = warp; task < TASKS; task += kTcWarps) {
      const int cb = task % NB, s0 = (task / NB) * kMS;
      float acc[kMS][2][4];
      zero(acc);
      const bf16* a0 = A + (16 * s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8;
      mma_taps<KS>(acc, a0, P, Ws + (size_t)(2 * cb) * KS * 32 + lane, KS, 0);
#pragma unroll
      for (int i = 0; i < kMS; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * cb + 8 * j + 2 * t, ph = col / COUT, co = col % COUT;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + co));
          const float b0 = rnd<bf16>(bb.x), b1 = rnd<bf16>(bb.y);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = c * kChunkTC + 16 * (s0 + i) + g + 8 * h, y = p / Win, x = p % Win;
            const size_t o = ((size_t)(2 * y + (ph >> 1)) * 2 * Win + 2 * x + (ph & 1)) * COUT + co;
            store_bf16x2(dst + o, rnd<bf16>(acc[i][j][2 * h]) + b0, rnd<bf16>(acc[i][j][2 * h + 1]) + b1);
          }
        }
    }
  };
  pipelined(Win * Win / kChunkTC, load, prep, compute);
}

// head on the tensor cores: conv3x3 32 -> 1 of ReLU(GN(c4)) + bias, fp32
// out (96, 96).  The weight column comes padded to one n8 tile (the wrapper
// packs (288, 8), columns 1-7 zero): the same bf16 products as the
// CUDA-core head, summed in fp32 in the tensor cores' order; lanes t = 0
// hold column 0.
__device__ void head_stage_tc(unsigned char* work, const bf16* src, const bf16* wpk, float hb, float* out,
                              const float* sc, const float* sh) {
  constexpr int CIN = 32, Wd = 96, R = kBH, P = CIN + 8, CK = CIN / 16, KS = 9 * CK, SEG = Wd / (16 * kMS);
  constexpr int BAND = (R + 2) * (Wd + 2) * P, TASKS = R * SEG;
  static_assert(TASKS % kTcWarps == 0 && (P / 8) % 2 == 1, "task shape; band layout");
  constexpr size_t WB = (size_t)9 * CIN * 8 * sizeof(bf16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint2* Ws = reinterpret_cast<const uint2*>(work);
  bf16* bands = reinterpret_cast<bf16*>(work + align128(WB));
  stage_weights(work, wpk, WB);
  auto load = [&](int bi, int buf) { band_copy<CIN, Wd, R>(bands + buf * BAND, src, bi * R); };
  auto prep = [&](int bi, int buf) {
    band_gn<CIN, Wd, R>(bands + buf * BAND, bi * R, sc, sh);
    return true;
  };
  auto compute = [&](int bi, int buf) {
    const bf16* band = bands + buf * BAND;
    for (int task = warp; task < TASKS; task += kTcWarps) {
      const int r = task / SEG, x0 = (task % SEG) * 16 * kMS;
      float acc[kMS][1][4];
      zero(acc);
      const bf16* a0 = band + (r * (Wd + 2) + x0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8;
      for (int tap = 0; tap < 9; ++tap)
        mma_taps<CK>(acc, a0 + ((tap / 3) * (Wd + 2) + tap % 3) * P, P, Ws + lane, KS, tap * CK);
      if (t == 0) {
        float* o = out + (size_t)(bi * R + r) * Wd + x0 + g;
#pragma unroll
        for (int i = 0; i < kMS; ++i) {
          o[16 * i] = acc[i][0][0] + hb;
          o[16 * i + 8] = acc[i][0][2] + hb;
        }
      }
    }
  };
  pipelined(Wd / R, load, prep, compute);
}

// fp32 head: conv3x3 32 -> 1 of ReLU(GN(c4)) + bias, fp32 out (96, 96)
__device__ void head_stage_fma(unsigned char* work, const float* src, const float* hw, float hb, float* out,
                               const float* sc, const float* sh) {
  using T = float;
  constexpr int P = kHeadStride, V = 4, Wd = 96;
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
__global__ void __launch_bounds__(kThreadsOf<T>, 1)
decoder_kernel(const T* __restrict__ x, const T* __restrict__ hg1, const T* __restrict__ hg2, float* out,
               T* scratch, DecW<T> w, int N, int nT) {
  extern __shared__ __align__(128) unsigned char smraw[];
  float* slots = reinterpret_cast<float*>(smraw);  // [warp][4 groups][2]
  float* sc = slots + kMaxWarps * 8;
  float* sh = sc + 64;
  float* hw = sh + 64;
  unsigned char* work = smraw + kHeader;
  T* bufA = scratch + (size_t)blockIdx.x * kScratch;
  T* bufB = bufA + kBufA;
  T* bufC = bufB + kBufB;
  const int nw = blockDim.x >> 5;
  if constexpr (!kTC<T>)
    for (int i = threadIdx.x; i < kHeadW; i += blockDim.x) hw[i] = w.hd_w[i];
  const float hb = w.hd_b[0];
  constexpr float cnt1 = 48.f * 48.f * 16.f, cnt2 = 96.f * 96.f * 16.f;

#ifdef CATSEG_DEC_PHASE_CLOCKS
  long long t_phase = clock64();
#endif
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const int img = n / nT;
    const T* hg1b = hg1 + (size_t)img * 48 * 48 * 64;
    const T* hg2b = hg2 + (size_t)img * 96 * 96 * 32;
    const T* xn = x + (size_t)n * 24 * 24 * 128;
    if constexpr (kTC<T>) {
      convt_stage_tc<128, 96, 24, false>(work, xn, bufA, w.up1_w, w.up1_b, nullptr, nullptr);
      DEC_PHASE(0);
      conv_stage_tc<96, 64, 48, kB1, false, true>(work, bufA, w.c11_w, nullptr, nullptr, slots, bufB, hg1b);
      gn_affine(slots, nw, w.gn11_g, w.gn11_b, 64, cnt1, sc, sh);
      DEC_PHASE(1);
      conv_stage_tc<64, 64, 48, kB2, true, false>(work, bufB, w.c12_w, sc, sh, slots, bufC, nullptr);
      gn_affine(slots, nw, w.gn12_g, w.gn12_b, 64, cnt1, sc, sh);
      DEC_PHASE(2);
      convt_stage_tc<64, 48, 48, true>(work, bufC, bufA, w.up2_w, w.up2_b, sc, sh);
      DEC_PHASE(3);
      conv_stage_tc<48, 32, 96, kB3, false, true>(work, bufA, w.c21_w, nullptr, nullptr, slots, bufB, hg2b);
      gn_affine(slots, nw, w.gn21_g, w.gn21_b, 32, cnt2, sc, sh);
      DEC_PHASE(4);
      conv_stage_tc<32, 32, 96, kB4, true, false>(work, bufB, w.c22_w, sc, sh, slots, bufC, nullptr);
      gn_affine(slots, nw, w.gn22_g, w.gn22_b, 32, cnt2, sc, sh);
      DEC_PHASE(5);
    } else {
      convt_stage_fma<128, 96, 24, false>(work, xn, bufA, w.up1_w, w.up1_b, nullptr, nullptr);
      conv_stage_fma<96, 64, 48, kR1, false>(work, bufA, w.c11_w, nullptr, nullptr, slots,
                                             [&](int y, int xx, int co, float a) {
                                               const size_t i = ((size_t)y * 48 + xx) * 64 + co;
                                               return bufB[i] = a + hg1b[i];
                                             });
      gn_affine(slots, nw, w.gn11_g, w.gn11_b, 64, cnt1, sc, sh);
      conv_stage_fma<64, 64, 48, kR2, true>(work, bufB, w.c12_w, sc, sh, slots, [&](int y, int xx, int co, float a) {
        return bufC[((size_t)y * 48 + xx) * 64 + co] = a;
      });
      gn_affine(slots, nw, w.gn12_g, w.gn12_b, 64, cnt1, sc, sh);
      convt_stage_fma<64, 48, 48, true>(work, bufC, bufA, w.up2_w, w.up2_b, sc, sh);
      conv_stage_fma<48, 32, 96, kR3, false>(work, bufA, w.c21_w, nullptr, nullptr, slots,
                                             [&](int y, int xx, int co, float a) {
                                               const size_t i = ((size_t)y * 96 + xx) * 32 + co;
                                               return bufB[i] = a + hg2b[i];
                                             });
      gn_affine(slots, nw, w.gn21_g, w.gn21_b, 32, cnt2, sc, sh);
      conv_stage_fma<32, 32, 96, kR4, true>(work, bufB, w.c22_w, sc, sh, slots, [&](int y, int xx, int co, float a) {
        return bufC[((size_t)y * 96 + xx) * 32 + co] = a;
      });
      gn_affine(slots, nw, w.gn22_g, w.gn22_b, 32, cnt2, sc, sh);
    }
    // out = head(ReLU(GN(c4)))
    if constexpr (kTC<T>) {
      head_stage_tc(work, bufC, w.hd_w, hb, out + (size_t)n * 96 * 96, sc, sh);
    } else {
      head_stage_fma(work, bufC, hw, hb, out + (size_t)n * 96 * 96, sc, sh);
    }
    DEC_PHASE(6);
#ifdef CATSEG_DEC_PHASE_CLOCKS
    if (threadIdx.x == 0) atomicAdd(&g_phase_cycles[kPhases], 1ull);
#endif
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, decoder_kernel<T>, kThreadsOf<T>, smem_bytes<T>());
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
  decoder_kernel<T><<<grid, kThreadsOf<T>, smem_bytes<T>(), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(hg1), static_cast<const T*>(hg2),
      static_cast<float*>(out), static_cast<T*>(scratch), w, N, nT);
  return cudaGetLastError();
}

}  // namespace

#ifdef CATSEG_DEC_PHASE_CLOCKS
// copies the timing build's per-stage cycle sums and slab count (kPhases + 1
// values) to host memory and sets them to 0
extern "C" int catseg_decoder_phase_cycles(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles));
  static const unsigned long long zeros[kPhases + 1] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_cycles, zeros, sizeof(zeros));
  return (int)e;
}
#endif

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
