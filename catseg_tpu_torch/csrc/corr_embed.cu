// Cosine cost map + 7x7 correlation embedding.
//
// Replaces catseg_tpu/kernels/corr_embed.py:fused_corr_embed (_kernel).
// img: (B, 24, 24, E) raw image features; txt: (B, T, E) L2-normalized text
// (P = 1); bias: (C,) fp32; out: (B, T, 24, 24, C) channels-last; imgn:
// (B, 576, E) scratch for the normalized image.  C a multiple of 128 (the
// embedding runs in 128-channel blocks), E a multiple of 8 (16-byte rows in
// bf16): with P = 1, the reference's own gate.
//
// Bound on the card: the (B, T, 576, C) output write, 221 MB in bf16 at
// 10 tiles x 150 classes and C = 128 (0.066 ms at 3.35 TB/s; 442 MB and
// 0.132 ms at C = 256); the 7x7 embedding is 14 GFLOP a 128 channels on the
// tensor cores at K = 64 (0.015 ms at the bf16 peak), the cost product 1.8
// GFLOP at E = 512, computed once a CTA whatever C.
//
// 1. normalize_kernel, one warp a position: imgn = x / max(|x|, 1e-12) with
//    fp32 statistics, rounded to T, once per image (the TPU kernel's imgn,
//    the spec's l2_normalize), not once per class.
// 2. bf16, corr_embed_tc: one 8-warp CTA per (8 classes, image).  The cost
//    corr (576 x 8) = imgn (576 x E) txt^T runs on mma.sync m16n8k16 with
//    fp32 accumulation, A and B fragments loaded from global memory as one
//    16-byte run of E a lane (k permuted the same way on both sides; in the
//    last 32-wide step of an E not a multiple of 32, a lane whose run lies
//    past E holds zero fragments and reads nothing), and lands rounded to bf16 in zero-bordered 31 x 32 planes in shared memory,
//    each kept twice (shifted by one element) so that two adjacent taps of
//    any position are one aligned 32-bit read.  The 7x7 conv is an implicit
//    GEMM on mma.sync: M = 576 positions, N = 128 channels a block, K = 64
//    taps (tap dy * 8 + dx; the dy = 7 and dx = 7 taps are zero), its B the
//    taps packed in fragment order (kernels/swin_block.py pack_mma_b, depth
//    16), held in registers for one channel block (a warp owns 64 of its
//    channels); the CTA walks the C / 128 blocks over the same planes, so the
//    cost is formed once.  The accumulators start at the fp32 bias, so each
//    output is rounded once.  Rows are staged per warp and stored 16 bytes a
//    lane, 128-byte lines.
// 3. fp32, corr_embed_fp32 (CUDA cores, the same CTA split): the cost map as
//    warp dot products over E, 8 classes a read of imgn; the conv with a
//    thread's channel's 49 taps in registers over 4 positions at a time,
//    plane values read as broadcasts, one 128-channel block after another.
#include "attn_common.cuh"
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kG = 24;            // feature grid
constexpr int kHW = kG * kG;
constexpr int kC = 128;           // embedding channels a block
constexpr int kTc = 8;            // classes per CTA
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// bf16 planes: rows 0..30 (24 + 2 x 3 border + the zero dy = 7 tap row), pitch 32
constexpr int kPW = 32;
constexpr int kPlane = 31 * kPW + 8;     // one copy, with slack for the shifted copy's last read
constexpr int kSP = 64 + 8;              // staging row: 64 channels + 8 (conflict-free stores)
constexpr int kMTiles = kHW / 16;        // 36 m16 tiles of positions

// imgn = x / max(|x|, 1e-12) rounded to T, one warp a row of E elements
template <typename T>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const T* __restrict__ img, T* __restrict__ imgn, int rows, int E) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte chunk
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint4* src = reinterpret_cast<const uint4*>(img + (size_t)row * E);
  uint4* dst = reinterpret_cast<uint4*>(imgn + (size_t)row * E);
  const int chunks = E / V;
  float n2 = 0.f;
  for (int q = lane; q < chunks; q += 32) {
    const uint4 u = src[q];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) n2 = fmaf(to_f(e[i]), to_f(e[i]), n2);
  }
  const float nrm = fmaxf(sqrtf(warp_sum(n2)), 1e-12f);
  for (int q = lane; q < chunks; q += 32) {
    uint4 u = src[q];
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(to_f(e[i]) / nrm);
    dst[q] = u;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
corr_embed_tc(const bf16* __restrict__ imgn, const bf16* __restrict__ txt, const uint2* __restrict__ taps,
              const float* __restrict__ bias, bf16* __restrict__ out, int nT, int C, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* planes = reinterpret_cast<bf16*>(smem);            // kTc x (copy0, copy1) x kPlane
  bf16* stage = planes + kTc * 2 * kPlane;                  // kWarps x 16 x kSP
  float* sbias = reinterpret_cast<float*>(stage + kWarps * 16 * kSP);   // C
  const int t0 = blockIdx.x * kTc, b = blockIdx.y;
  const int nc = min(kTc, nT - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;

  for (int i = tid; i < kTc * 2 * kPlane / 8; i += kThreads) reinterpret_cast<uint4*>(planes)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < C; i += kThreads) sbias[i] = bias[i];
  __syncthreads();

  // ---- cost: corr (positions x classes) = imgn (576 x E) . txt^T (E x 8).
  // Per 32-wide k step, lane (g, t) holds E elements 8t .. 8t + 7 of its rows:
  // k-step 0 takes words 0, 1 (as fragment k 2t.., 2t + 8..), k-step 1 words 2, 3;
  // A and B permute k alike, so the sum is the dot product over E.  E is a
  // multiple of 8, so a lane's run lies wholly inside E or wholly past it.
  {
    constexpr int kMT = (kMTiles + kWarps - 1) / kWarps;   // 5 m-tiles for warps 0-3, 4 for 4-7
    float acc[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    const bf16* ib = imgn + (size_t)b * kHW * E;
    const bf16* tr = txt + ((size_t)b * nT + t0 + min(g, nc - 1)) * E;
    const bool tvalid = g < nc;
#pragma unroll 2
    for (int e0 = 0; e0 < E; e0 += 32) {
      const bool kin = e0 + 8 * t < E;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      const uint4 bv = tvalid && kin ? __ldg(reinterpret_cast<const uint4*>(tr + e0 + 8 * t)) : zero;
      uint4 lo[kMT], hi[kMT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int mt = warp + i * kWarps;
        lo[i] = hi[i] = zero;
        if (mt < kMTiles && kin) {
          lo[i] = __ldg(reinterpret_cast<const uint4*>(ib + (size_t)(16 * mt + g) * E + e0 + 8 * t));
          hi[i] = __ldg(reinterpret_cast<const uint4*>(ib + (size_t)(16 * mt + g + 8) * E + e0 + 8 * t));
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (warp + i * kWarps < kMTiles) {
          const unsigned a0[4] = {lo[i].x, hi[i].x, lo[i].y, hi[i].y};
          const unsigned a1[4] = {lo[i].z, hi[i].z, lo[i].w, hi[i].w};
          mma_bf16(acc[i], a0, bv.x, bv.y);
          mma_bf16(acc[i], a1, bv.z, bv.w);
        }
      }
    }
    // c0, c1: (position g, classes 2t, 2t + 1); c2, c3: position g + 8
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int mt = warp + i * kWarps;
      if (mt >= kMTiles) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 2 * t + (q & 1), p = 16 * mt + g + 8 * (q >> 1);
        if (c >= nc) continue;
        const bf16 v = __float2bfloat16(acc[i][q]);
        const int idx = (p / kG + 3) * kPW + p % kG + 3;
        bf16* pl = planes + c * 2 * kPlane;
        pl[idx] = v;              // copy 0: plane[i]
        pl[kPlane + idx - 1] = v;  // copy 1: plane[i + 1]
      }
    }
  }
  __syncthreads();

  // ---- the 7x7 embedding, one 128-channel block cb after another: warp
  // (m-group mg, channel half h) owns m-tiles mg, mg + 4, ... and channels
  // 128 cb + 64 h .. + 63 of every class
  const int h = warp & 1, mg = warp >> 1;
  bf16* st = stage + warp * 16 * kSP;
  for (int cb = 0; cb < C / kC; ++cb) {
    uint2 bw[4][8];   // taps: k-step p (dy 2p, 2p + 1), n-tile jj of the half
    // the packed (64, C) tap matrix: n8 tile j at uint2 (j * 4 + p) * 32 + lane
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) bw[p][jj] = __ldg(taps + ((16 * cb + 8 * h + jj) * 4 + p) * 32 + lane);
    const float* bblk = sbias + kC * cb + 64 * h;
    for (int c = 0; c < nc; ++c) {
      const unsigned* cp0 = reinterpret_cast<const unsigned*>(planes + c * 2 * kPlane);
      const unsigned* cp1 = reinterpret_cast<const unsigned*>(planes + c * 2 * kPlane + kPlane);
      bf16* ob = out + ((size_t)b * nT + t0 + c) * kHW * C + kC * cb + 64 * h;
      for (int mt = mg; mt < kMTiles; mt += 4) {
        // word pointers to (y, x) of the tap (0, 0) of positions g and g + 8: two
        // adjacent taps of a row are one word of copy 0 (x even) or copy 1 (x odd)
        const unsigned* wr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = 16 * mt + g + 8 * r, y = p / kG, x = p % kG;
          wr[r] = (x & 1) ? cp1 + ((y * kPW + x - 1) >> 1) : cp0 + ((y * kPW + x) >> 1);
        }
        float acc[8][4];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 bb = *reinterpret_cast<const float2*>(bblk + 8 * jj + 2 * t);
          acc[jj][0] = acc[jj][2] = bb.x;
          acc[jj][1] = acc[jj][3] = bb.y;
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          // a0: (position g, dy 2p, dx 2t..2t+1), a1: position g + 8, a2 / a3: dy 2p + 1
          const unsigned a[4] = {wr[0][(2 * p) * (kPW / 2) + t], wr[1][(2 * p) * (kPW / 2) + t],
                                 wr[0][(2 * p + 1) * (kPW / 2) + t], wr[1][(2 * p + 1) * (kPW / 2) + t]};
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) mma_bf16(acc[jj], a, bw[p][jj].x, bw[p][jj].y);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          store_bf16x2(st + g * kSP + 8 * jj + 2 * t, acc[jj][0], acc[jj][1]);
          store_bf16x2(st + (g + 8) * kSP + 8 * jj + 2 * t, acc[jj][2], acc[jj][3]);
        }
        __syncwarp();
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          const int row = 4 * it + (lane >> 3), ch = lane & 7;
          *reinterpret_cast<uint4*>(ob + (size_t)(16 * mt + row) * C + 8 * ch) =
              *reinterpret_cast<const uint4*>(st + row * kSP + 8 * ch);
        }
        __syncwarp();
      }
    }
  }
}

constexpr int kFP = kG + 6;   // fp32 plane: 30 x 30, zero border of 3

__global__ void __launch_bounds__(kThreads)
corr_embed_fp32(const float* __restrict__ imgn, const float* __restrict__ txt, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out, int nT, int C, int E) {
  extern __shared__ __align__(16) float fsm[];
  float* ts = fsm;                 // kTc x E
  float* planes = ts + kTc * E;    // kTc x kFP x kFP
  const int t0 = blockIdx.x * kTc, b = blockIdx.y;
  const int nc = min(kTc, nT - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kTc * E; i += kThreads)
    ts[i] = i / E < nc ? txt[((size_t)b * nT + t0) * E + i] : 0.f;
  for (int i = tid; i < kTc * kFP * kFP; i += kThreads) planes[i] = 0.f;
  __syncthreads();

  const float* ib = imgn + (size_t)b * kHW * E;
  for (int p = warp; p < kHW; p += kWarps) {
    float d[kTc];
#pragma unroll
    for (int c = 0; c < kTc; ++c) d[c] = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float x = ib[(size_t)p * E + e];
#pragma unroll
      for (int c = 0; c < kTc; ++c) d[c] = fmaf(x, ts[c * E + e], d[c]);
    }
    float mine = 0.f;
#pragma unroll
    for (int c = 0; c < kTc; ++c) {
      const float s = warp_sum(d[c]);
      if (lane == c) mine = s;
    }
    if (lane < nc) planes[lane * kFP * kFP + (p / kG + 3) * kFP + p % kG + 3] = mine;
  }
  __syncthreads();

  // thread: channel cb + tid % 128 of each 128-channel block cb, groups of 4
  // positions along x (6 a row)
  for (int cb = 0; cb < C; cb += kC) {
    const int ch = cb + tid % kC;
    float wr[49];
#pragma unroll
    for (int k = 0; k < 49; ++k) wr[k] = w[k * C + ch];
    const float bc = bias[ch];
    for (int c = 0; c < nc; ++c) {
      const float* pl = planes + c * kFP * kFP;
      float* ob = out + ((size_t)b * nT + t0 + c) * kHW * C + ch;
      for (int grp = tid / kC; grp < kHW / 4; grp += kThreads / kC) {
        const int y = grp / (kG / 4), x0 = grp % (kG / 4) * 4;
        float acc[4] = {bc, bc, bc, bc};
#pragma unroll
        for (int dy = 0; dy < 7; ++dy) {
          float v[10];
#pragma unroll
          for (int i = 0; i < 10; ++i) v[i] = pl[(y + dy) * kFP + x0 + i];
#pragma unroll
          for (int dx = 0; dx < 7; ++dx)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[q] = fmaf(v[q + dx], wr[dy * 7 + dx], acc[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) ob[(size_t)(y * kG + x0 + q) * C] = acc[q];
      }
    }
  }
}

template <typename K>
cudaError_t set_smem(K k, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                          : cudaSuccess;
}

}  // namespace

// w: bf16 taps packed (pack_mma_b of the (64, C) tap matrix, depth 16) for
// is_bf16, else the (49, C) fp32 taps.
extern "C" int catseg_corr_embed(const void* img, const void* txt, const void* w, const void* bias, void* imgn,
                                 void* out, int B, int nT, int H, int W, int C, int E, int is_bf16, void* stream) {
  if (H != kG || W != kG || B <= 0 || nT <= 0 || C <= 0 || C % kC || E <= 0 || E % 8)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int rows = B * kHW;
  const dim3 grid((nT + kTc - 1) / kTc, B);
  cudaError_t e;
  if (is_bf16) {
    normalize_kernel<bf16><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        static_cast<const bf16*>(img), static_cast<bf16*>(imgn), rows, E);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const size_t smem = (size_t)(kTc * 2 * kPlane + kWarps * 16 * kSP) * sizeof(bf16) + C * sizeof(float);
    if ((e = set_smem(corr_embed_tc, smem)) != cudaSuccess) return (int)e;
    corr_embed_tc<<<grid, kThreads, smem, st>>>(static_cast<const bf16*>(imgn), static_cast<const bf16*>(txt),
                                                static_cast<const uint2*>(w), static_cast<const float*>(bias),
                                                static_cast<bf16*>(out), nT, C, E);
  } else {
    normalize_kernel<float><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        static_cast<const float*>(img), static_cast<float*>(imgn), rows, E);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const size_t smem = (size_t)(kTc * E + kTc * kFP * kFP) * sizeof(float);
    if ((e = set_smem(corr_embed_fp32, smem)) != cudaSuccess) return (int)e;
    corr_embed_fp32<<<grid, kThreads, smem, st>>>(static_cast<const float*>(imgn), static_cast<const float*>(txt),
                                                  static_cast<const float*>(w), static_cast<const float*>(bias),
                                                  static_cast<float*>(out), nT, C, E);
  }
  return (int)cudaGetLastError();
}
