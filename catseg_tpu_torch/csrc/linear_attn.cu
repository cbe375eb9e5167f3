// Kernelized (elu + 1) linear attention across the class axis, per position.
//
// Replaces catseg_tpu/kernels/linear_attn.py:fused_linear_attention
// (_kernel).  q, k, v, out: (N, S, C) row-major in T, one sequence of S class
// rows per spatial position; heads of D = C / heads channels.  With
// phi(x) = x + 1 for x > 0, else e^x, Q = phi(q), K = phi(k), V = v / S, all
// fp32:  KV_h = K_h^T V_h (D x D per head), Ksum_h = sum_s K_h,
// out = (Q_h KV_h) / (Q_h . Ksum_h + eps) * S, rounded to T once.
//
// Bound on the card: bytes.  q, k, v read once and out written once are 1.5
// GB in bf16 at 5760 sequences of 256 x 128 (0.45 ms at 3.35 TB/s); the
// products below are ~72 GFLOP on the tensor cores (0.07 ms at the bf16 peak).
//
// One CTA per (sequence, 128 channels), one warp per 16 channels; both
// products on mma.sync m16n8k16 in both dtypes.  Q, K and V are fp32 in the
// spec (phi and / S make them so even from bf16 input), so every operand goes
// in as a bf16 pair hi = bf16(x), lo = bf16(x - hi) (bwd_common.cuh's
// convention) and each product is hi.hi + hi.lo + lo.hi in fp32 accumulators.
// Rows arrive in 32-row tiles by 16-byte cp.async in a ring of 3 (bf16 at
// head dims up to 64) or 2 stages; phi, / S and the split are applied as the
// fragments are built from the raw tile.
//  - Pass 1 (K, V tiles): warp w forms KV for its 16 channels' rows against
//    their head's D columns, plus a ones column of B whose sums are Ksum;
//    then scatters KV, masked to its head, and the per-head Ksum columns
//    into shared memory as the B fragments (hi and lo) of pass 2.  A column
//    group is one head, or two heads of D = 8 (block-diagonal mask).
//  - Pass 2 (Q tiles): out = Q [KV | Ksum] with N = G + 8, so the normalizer
//    rides the same product once per row: a task forms that last n8 tile
//    first, then each output tile in turn, each scaled and stored as it
//    completes.  A task is (16 rows, column group) and, at head dim 128 (one
//    group a CTA), a quarter of the group's output tiles, so that all eight
//    warps have one (each forms the normalizer itself).  A warp overwrites
//    its part of the Q tile with the rounded output (after the whole block
//    has read its Q fragments where warps share rows); the tile's whole rows
//    are then stored 16 bytes a thread.
//
// Head dim 128: KV's B fragments take 68 KB (hi and lo, 128 x 136); with a
// ring of 2 stages a bf16 CTA takes 102 KB, so two share an SM (fp32: 136
// KB, one).
// No atomics: two runs are bit-equal.
//
// Every other head dim at C a multiple of 128 up to 512 (1, 2, 3, 4, 6, 12,
// 24, 48, 96, 192, 256, 384, 512: heads that straddle the 128-channel
// chunk, or whose D x D KV exceeds a CTA), in both dtypes: fp32 on CUDA
// cores.  One CTA per (sequence, block of output columns): 32 columns of
// one head at D >= 32 (a head's columns over ceil(D / 32) CTAs), else the
// floor(32 / D) whole heads that fit in 32.  Pass 1 streams 16-row tiles of
// phi(K) (the block's heads' D channels) and V / S (its columns) through
// shared memory; lane e holds KV column e, warp w rows w M .. w M + M - 1
// (M = 4 ceil(D / 32)) in registers, summed over the rows in order; threads
// also sum the K columns (Ksum, recomputed by every CTA of a head).  KV
// goes to shared memory; pass 2 streams phi(Q) tiles of 32 rows: each
// (row, head)'s normaliser 1 / (Q . Ksum + eps) (a warp's sum at D >= 32,
// a lane's, d in order, below), then a warp's 4 rows of output (Q KV) *
// that * S, d in order, rounded to T once; phi(K) and phi(Q) read 4 d at a
// time where D % 4 == 0.  No padding: rows past S are not read (phi(0) = 1
// would count them), channels are whole heads.
#include "attn_common.cuh"
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kThreads = 256;   // 8 warps for the 128 channels of a CTA
constexpr int kTR = 32;         // rows per ring tile
constexpr int kChunk = 128;     // channels per CTA

template <typename T, int D> struct Ring { static constexpr int kStages = sizeof(T) == 2 && D < 128 ? 3 : 2; };

// e^x by the SFU (ex2.approx: ~2 ulp; results below 2^-126 flushed to 0)
__device__ __forceinline__ float phi(float x) { return x > 0.f ? x + 1.f : fast_exp2(x * kLog2e); }

// (x0, x1) as bf16 pairs hi = bf16(x), lo = bf16(x - hi), x0 in the low half
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const bf16* p) { return unpack_bf16(p); }
__device__ __forceinline__ void st2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void st2(bf16* p, float a, float b) { store_bf16x2(p, a, b); }

// hi.hi + hi.lo + lo.hi
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4], const unsigned (&al)[4], unsigned bh0,
                                     unsigned bh1, unsigned bl0, unsigned bl1) {
  mma_bf16(d, ah, bh0, bh1);
  mma_bf16(d, ah, bl0, bl1);
  mma_bf16(d, al, bh0, bh1);
}

// at D <= 32 three bf16 CTAs share an SM (their shared memory fits; <= 80
// registers): faster than two on the H100 at the selfcheck shape.  Two
// elsewhere (128 registers): at D = 128 two bf16 CTAs fit with the ring of 2
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 && D <= 32 ? 3 : 2)
linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ out, int S, int C, float eps) {
  constexpr int G = D < 16 ? 16 : D;   // channels of a column group
  constexpr int NB = G / 8;            // n8 tiles of a group's KV columns
  constexpr int KK = G / 16;           // k16 steps of a group in pass 2
  constexpr int NS = G == 128 ? 4 : 1;  // tasks sharing a (row tile, group): each forms NB / NS output tiles
  constexpr int kStages = Ring<T, D>::kStages;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cc = blockDim.x / 2;       // channels of this CTA (16 a warp)
  const int P = Cc + 8;                // tile row pitch (elements)
  T* ring = reinterpret_cast<T*>(smem);                                         // stages x (K | Q, V) x kTR x P
  uint4* Bp = reinterpret_cast<uint4*>(ring + (size_t)kStages * 2 * kTR * P);   // pass 2's B fragments
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int NW = blockDim.x >> 5;
  const size_t base = (size_t)blockIdx.x * S * C + (size_t)blockIdx.y * Cc;
  const int nt = (S + kTR - 1) / kTR;
  const int cpr = Cc / EPC;            // chunks per tile row
  const float fS = (float)S, invS = 1.f / fS;

  // a thread copies chunk column cc of rows rr, rr + rstep, ... (blockDim is
  // 2 EPC chunk rows, so the column is fixed)
  const int cc = tid % cpr, rr = tid / cpr, rstep = blockDim.x / cpr;
  // tile i < nt: K and V rows 32 i ..; nt <= i < 2 nt: Q rows 32 (i - nt) ..
  auto load_tile = [&](int i) {
    if (i < 2 * nt) {
      const bool kv = i < nt;
      const int s0 = (kv ? i : i - nt) * kTR;
      T* dst0 = ring + (size_t)(i % kStages) * 2 * kTR * P + cc * EPC;
      for (int r = rr; r < (kv ? 2 : 1) * kTR; r += rstep) {   // rows kTR .. 2 kTR - 1: V
        const int s = s0 + r % kTR;
        const T* src = (r >= kTR ? v : kv ? k : q) + base + (size_t)min(s, S - 1) * C + cc * EPC;
        cp_async16(dst0 + r * P, src, s < S);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_tile(i);

  // ---- pass 1: warp w's channels cs .. cs + 15 (KV rows) against its group's columns
  const int cs = 16 * warp, gi = cs / G, gc = gi * G;
  float acc[NB][4], acx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const unsigned ones = g == 0 ? 0x3F803F80u : 0u;   // B column 0 of the Ksum tile: bf16 1.0 pairs
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_tile(i + kStages - 1);
    const T* Kt = ring + (size_t)(i % kStages) * 2 * kTR * P;
    const T* Vt = Kt + kTR * P;
    const int valid = S - i * kTR;   // rows past S are zero-filled; K must read 0 there, not phi(0)
#pragma unroll
    for (int ks = 0; ks < kTR / 16; ++ks) {
      const int r0 = 16 * ks;
      // A = K^T: a0 (channel g, rows 2t, 2t + 1), a1 channel g + 8, a2 / a3 rows 2t + 8, 2t + 9
      auto kf = [&](int r, int c) { return r < valid ? phi(to_f(Kt[r * P + c])) : 0.f; };
      unsigned ah[4], al[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = r0 + 2 * t + 8 * (f >> 1), c = cs + g + 8 * (f & 1);
        split2(kf(r, c), kf(r + 1, c), ah[f], al[f]);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        // B = V: b0 (rows 2t, 2t + 1, column g of tile j), b1 rows 2t + 8, 2t + 9
        const int c = gc + 8 * j + g, r = r0 + 2 * t;
        unsigned bh0, bl0, bh1, bl1;
        split2(to_f(Vt[r * P + c]) * invS, to_f(Vt[(r + 1) * P + c]) * invS, bh0, bl0);
        split2(to_f(Vt[(r + 8) * P + c]) * invS, to_f(Vt[(r + 9) * P + c]) * invS, bh1, bl1);
        mma3(acc[j], ah, al, bh0, bh1, bl0, bl1);
      }
      mma_bf16(acx, ah, ones, ones);
      mma_bf16(acx, al, ones, ones);
    }
  }

  // scatter KV (masked to the head) and the Ksum columns as pass 2's B
  // fragments: entry ((gi KK + kk) (NB + 1) + j) 32 + lane holds {b0 hi, b1 hi,
  // b0 lo, b1 lo} of k-step kk and n-tile j
  {
    bf16* Bh = reinterpret_cast<bf16*>(Bp);
    const int kk = (cs - gc) / 16;
    const float ks0 = __shfl_sync(0xffffffffu, acx[0], lane & ~3);   // Ksum of channel g
    const float ks1 = __shfl_sync(0xffffffffu, acx[2], lane & ~3);   // of channel g + 8
    auto put = [&](int j, int dd, int e, float x) {   // B[k = 16 kk + dd][n = 8 j + e]
      const size_t entry = ((size_t)(gi * KK + kk) * (NB + 1) + j) * 32 + 4 * e + (dd & 7) / 2;
      const bf16 hi = __float2bfloat16(x);
      Bh[entry * 8 + (dd >> 3) * 2 + (dd & 1)] = hi;
      Bh[entry * 8 + 4 + (dd >> 3) * 2 + (dd & 1)] = __float2bfloat16(x - __bfloat162float(hi));
    };
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int dd = g + 8 * (f >> 1), hd = (cs - gc + dd) / D, e = 2 * t + (f & 1);
#pragma unroll
      for (int j = 0; j < NB; ++j) put(j, dd, e, (8 * j + e) / D == hd ? acc[j][f] : 0.f);
      put(NB, dd, e, e == hd ? (f >> 1 ? ks1 : ks0) : 0.f);   // column G + hd: Ksum of head hd
    }
  }
  __syncthreads();

  // ---- pass 2: task (m-tile of the tile, group gj, output tiles part) per warp in turn
  const int ngroups = Cc / G, ntask = (kTR / 16) * ngroups * NS;
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_tile(nt + i + kStages - 1);
    T* Qt = ring + (size_t)((nt + i) % kStages) * 2 * kTR * P;
    for (int t0 = 0; t0 < ntask; t0 += NW) {   // the same trip count in every warp
      const int task = t0 + warp, part = task % NS, mg = task / NS;
      const int r0 = 16 * (mg % (kTR / 16)), gj = mg / (kTR / 16), qc = gj * G;
      const bool live = task < ntask;
      unsigned ah[KK][4], al[KK][4];
      if (live) {
#pragma unroll
        for (int kq = 0; kq < KK; ++kq)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            // a0 (row g, channels 2t, 2t + 1), a1 row g + 8, a2 / a3 channels + 8
            const float2 x = ld2(Qt + (r0 + g + 8 * (f & 1)) * P + qc + 16 * kq + 2 * t + 8 * (f >> 1));
            split2(phi(x.x), phi(x.y), ah[kq][f], al[kq][f]);
          }
      }
      // every lane's Q reads are done before the tile is overwritten: the
      // warp's, or the block's where warps share the rows
      if (NS > 1) __syncthreads(); else __syncwarp();
      if (!live) continue;
      // the last tile first: Q . Ksum of head hd sits in its column hd, lane
      // 4 g; then the part's output tiles, each stored as it completes
      float z[2][2];
#pragma unroll
      for (int jj = -1; jj < NB / NS; ++jj) {
        const int j = jj < 0 ? NB : part * (NB / NS) + jj;
        float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kq = 0; kq < KK; ++kq) {
          const uint4 bb = Bp[((size_t)(gj * KK + kq) * (NB + 1) + j) * 32 + lane];
          mma3(o, ah[kq], al[kq], bb.x, bb.y, bb.z, bb.w);
        }
        if (jj < 0) {
#pragma unroll
          for (int f = 0; f < 4; ++f) z[f >> 1][f & 1] = __shfl_sync(0xffffffffu, o[f], lane & ~3);
        } else {
          const int hd = D == 8 ? j : 0;   // the tile's head within the group
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float rz = 1.f / (z[rr][hd] + eps);
            st2(Qt + (r0 + g + 8 * rr) * P + qc + 8 * j + 2 * t, o[2 * rr] * rz * fS, o[2 * rr + 1] * rz * fS);
          }
        }
      }
    }
    __syncthreads();
    for (int r = rr; r < kTR && i * kTR + r < S; r += rstep)
      *reinterpret_cast<uint4*>(out + base + (size_t)(i * kTR + r) * C + cc * EPC) =
          *reinterpret_cast<const uint4*>(Qt + r * P + cc * EPC);
  }
}

constexpr int kAnyCols = 32;   // output columns of an any-head-dim CTA
constexpr int kAnyRows = 32;   // rows of a staged tile: 4 a warp in pass 2

// the any-head-dim kernel's CTA: output columns c0 .. c0 + W - 1 of heads
// h0 .. h0 + nh - 1, reading the heads' K and Q channels kc0 .. kc0 + KW - 1
struct AnyBlock {
  int c0, W, kc0, KW, nh;
  __host__ __device__ static int per_seq(int C, int D) {   // CTAs a sequence
    const int heads = C / D;
    return D >= kAnyCols ? heads * ((D + kAnyCols - 1) / kAnyCols) : (heads + kAnyCols / D - 1) / (kAnyCols / D);
  }
  __device__ AnyBlock(int y, int C, int D) {
    if (D >= kAnyCols) {
      const int ncb = (D + kAnyCols - 1) / kAnyCols, h = y / ncb, cb = y - h * ncb;
      kc0 = h * D;
      KW = D;
      c0 = kc0 + cb * kAnyCols;
      W = min(kAnyCols, D - cb * kAnyCols);
      nh = 1;
    } else {
      const int hp = kAnyCols / D, h0 = y * hp;
      nh = min(hp, C / D - h0);
      c0 = kc0 = h0 * D;
      W = KW = nh * D;
    }
  }
};

// MM >= 4 ceil(D / 32): KV rows a thread holds in pass 1.  V4: D % 4 == 0,
// so a thread's rows of phi(K) and phi(Q) are read as float4 (each d still
// summed in order)
template <typename T, int MM, bool V4>
__global__ void __launch_bounds__(kThreads)
linear_attention_any_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            T* __restrict__ out, int S, int C, int D, float eps) {
  extern __shared__ __align__(16) float sma[];
  const AnyBlock b(blockIdx.y, C, D);
  float* xt = sma;                          // (kAnyRows, KW): phi(K), then phi(Q)
  float* vt = xt + kAnyRows * b.KW;         // (kAnyRows, kAnyCols): V / S
  float* kvs = vt + kAnyRows * kAnyCols;    // (D, kAnyCols): KV
  float* zs = kvs + D * kAnyCols;           // (kAnyRows, kAnyCols): 1 / (Q . Ksum + eps) by (row, head)
  float* ksum = zs + kAnyRows * kAnyCols;   // (KW)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * S * C;
  const float fS = (float)S, invS = 1.f / fS;
  const int M = 4 * ((D + kAnyCols - 1) / kAnyCols), d0 = warp * M;   // 8 M >= D
  const int kb = D >= kAnyCols ? 0 : (lane / D) * D;   // lane's head's first channel in the block
  const bool col = lane < b.W;

  // ---- pass 1: KV rows d0 .. d0 + M - 1 of column lane; Ksum of channels tid, tid + 256
  float acc[MM], ks0 = 0.f, ks1 = 0.f;
#pragma unroll
  for (int m = 0; m < MM; ++m) acc[m] = 0.f;
  for (int s0 = 0; s0 < S; s0 += kAnyRows) {
    const int nr = min(kAnyRows, S - s0);
    __syncthreads();   // the previous tile is read
    for (int e = tid; e < nr * b.KW; e += kThreads) {
      const int r = e / b.KW, c = e - r * b.KW;
      xt[e] = phi(to_f(k[base + (size_t)(s0 + r) * C + b.kc0 + c]));
    }
    for (int e = tid; e < nr * b.W; e += kThreads) {
      const int r = e / b.W, c = e - r * b.W;
      vt[r * kAnyCols + c] = to_f(v[base + (size_t)(s0 + r) * C + b.c0 + c]) * invS;
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      if (col) {
        const float* kr = xt + r * b.KW + kb + d0;
        const float vv = vt[r * kAnyCols + lane];
        if constexpr (V4) {
#pragma unroll
          for (int m = 0; m < MM; m += 4) {
            if (m < M && d0 + m < D) {
              const float4 kk = *reinterpret_cast<const float4*>(kr + m);
              acc[m] = fmaf(kk.x, vv, acc[m]);
              acc[m + 1] = fmaf(kk.y, vv, acc[m + 1]);
              acc[m + 2] = fmaf(kk.z, vv, acc[m + 2]);
              acc[m + 3] = fmaf(kk.w, vv, acc[m + 3]);
            }
          }
        } else {
#pragma unroll
          for (int m = 0; m < MM; ++m)
            if (m < M && d0 + m < D) acc[m] = fmaf(kr[m], vv, acc[m]);
        }
      }
      if (tid < b.KW) ks0 += xt[r * b.KW + tid];
      if (tid + kThreads < b.KW) ks1 += xt[r * b.KW + tid + kThreads];
    }
  }
  if (col) {
#pragma unroll
    for (int m = 0; m < MM; ++m)
      if (m < M && d0 + m < D) kvs[(d0 + m) * kAnyCols + lane] = acc[m];
  }
  if (tid < b.KW) ksum[tid] = ks0;
  if (tid + kThreads < b.KW) ksum[tid + kThreads] = ks1;

  // ---- pass 2: phi(Q) tiles; the normalisers, then the warp's 4 rows of output
  for (int s0 = 0; s0 < S; s0 += kAnyRows) {
    const int nr = min(kAnyRows, S - s0);
    __syncthreads();   // KV / Ksum written, the previous tile and its normalisers read
    for (int e = tid; e < nr * b.KW; e += kThreads) {
      const int r = e / b.KW, c = e - r * b.KW;
      xt[e] = phi(to_f(q[base + (size_t)(s0 + r) * C + b.kc0 + c]));
    }
    __syncthreads();
    // Q . Ksum: a warp's lanes over d (then the warp's sum) for a head of
    // D >= 32, a lane a head below
    for (int r = warp; r < nr; r += kThreads / 32) {
      const float* qr = xt + r * b.KW;
      if (D >= kAnyCols) {
        float z = 0.f;
        for (int d = lane; d < D; d += 32) z = fmaf(qr[d], ksum[d], z);
        z = warp_sum(z);
        if (lane == 0) zs[r * kAnyCols] = 1.f / (z + eps);
      } else if (lane < b.nh) {
        float z = 0.f;
        for (int d = 0; d < D; ++d) z = fmaf(qr[lane * D + d], ksum[lane * D + d], z);
        zs[r * kAnyCols + lane] = 1.f / (z + eps);
      }
    }
    __syncthreads();
    const int r0 = 4 * warp;
    if (col && r0 < nr) {
      const float* qr = xt + r0 * b.KW + kb;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (V4) {
        for (int d = 0; d < D; d += 4) {
          const float k0 = kvs[d * kAnyCols + lane], k1 = kvs[(d + 1) * kAnyCols + lane];
          const float k2 = kvs[(d + 2) * kAnyCols + lane], k3 = kvs[(d + 3) * kAnyCols + lane];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 qq = *reinterpret_cast<const float4*>(qr + i * b.KW + d);
            o[i] = fmaf(qq.w, k3, fmaf(qq.z, k2, fmaf(qq.y, k1, fmaf(qq.x, k0, o[i]))));
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float kv = kvs[d * kAnyCols + lane];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i] = fmaf(qr[i * b.KW + d], kv, o[i]);
        }
      }
      const int j = D >= kAnyCols ? 0 : lane / D;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < nr)
          out[base + (size_t)(s0 + r0 + i) * C + b.c0 + lane] = from_f<T>(o[i] * zs[(r0 + i) * kAnyCols + j] * fS);
    }
  }
}

template <typename T, int MM, bool V4>
int run_any(const void* q, const void* k, const void* v, void* out, int N, int S, int C, int D, float eps,
            cudaStream_t st) {
  const int KW = D >= kAnyCols ? D : (kAnyCols / D) * D;
  const size_t smem = (size_t)(kAnyRows * KW + 2 * kAnyRows * kAnyCols + D * kAnyCols + KW) * sizeof(float);
  auto kern = linear_attention_any_kernel<T, MM, V4>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(N, AnyBlock::per_seq(C, D)), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), S, C, D,
      eps);
  return (int)cudaGetLastError();
}

template <typename T>
int run_any_dt(const void* q, const void* k, const void* v, void* out, int N, int S, int C, int D, float eps,
               cudaStream_t st) {
  if (D % 4) return run_any<T, 4, false>(q, k, v, out, N, S, C, D, eps, st);   // D = 1, 2, 3, 6 (< 32)
  if (D <= 32) return run_any<T, 4, true>(q, k, v, out, N, S, C, D, eps, st);
  if (D <= 128) return run_any<T, 16, true>(q, k, v, out, N, S, C, D, eps, st);
  return run_any<T, 64, true>(q, k, v, out, N, S, C, D, eps, st);
}

template <typename T, int D>
int run(const void* q, const void* k, const void* v, void* out, int N, int S, int C, float eps, cudaStream_t st) {
  constexpr int G = D < 16 ? 16 : D;
  const int Cc = C < kChunk ? C : kChunk;
  const size_t smem = (size_t)Ring<T, D>::kStages * 2 * kTR * (Cc + 8) * sizeof(T) +
                      (size_t)(Cc / 16) * (G / 8 + 1) * 32 * sizeof(uint4);
  auto kern = linear_attention_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(N, C / Cc), 2 * Cc, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                              static_cast<const T*>(v), static_cast<T*>(out), S, C, eps);
  return (int)cudaGetLastError();
}

template <int D>
int run_dt(const void* q, const void* k, const void* v, void* out, int N, int S, int C, float eps, int is_bf16,
           cudaStream_t st) {
  return is_bf16 ? run<bf16, D>(q, k, v, out, N, S, C, eps, st) : run<float, D>(q, k, v, out, N, S, C, eps, st);
}

}  // namespace

// Takes head dims 8, 16, 32, 64 or 128 with C a multiple of 16 (and of the
// head dim) up to 128, or a multiple of 128, on the tensor cores (q, k, v,
// out 16-byte aligned); and every other head dim at C a multiple of 128 up
// to 512 on the any-head-dim kernel.
extern "C" int catseg_linear_attention(const void* q, const void* k, const void* v, void* out, int N, int S,
                                       int C, int heads, float eps, int is_bf16, void* stream) {
  if (N <= 0 || S <= 0 || heads <= 0 || C % heads) return (int)cudaErrorInvalidValue;
  const int D = C / heads, G = D < 16 ? 16 : D;
  auto st = static_cast<cudaStream_t>(stream);
  if (C % 16 == 0 && C % G == 0 && (C <= kChunk || C % kChunk == 0)) {
    switch (D) {
      case 8: return run_dt<8>(q, k, v, out, N, S, C, eps, is_bf16, st);
      case 16: return run_dt<16>(q, k, v, out, N, S, C, eps, is_bf16, st);
      case 32: return run_dt<32>(q, k, v, out, N, S, C, eps, is_bf16, st);
      case 64: return run_dt<64>(q, k, v, out, N, S, C, eps, is_bf16, st);
      case 128: return run_dt<128>(q, k, v, out, N, S, C, eps, is_bf16, st);
      default: break;
    }
  }
  if (C % kChunk || C > 4 * kChunk) return (int)cudaErrorInvalidValue;
  return is_bf16 ? run_any_dt<bf16>(q, k, v, out, N, S, C, D, eps, st)
                 : run_any_dt<float>(q, k, v, out, N, S, C, D, eps, st);
}
