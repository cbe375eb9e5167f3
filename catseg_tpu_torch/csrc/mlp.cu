// Transformer MLP act(x W1 + b1) W2 + b2 with the hidden activation kept on chip.
//
// Replaces catseg_tpu/kernels/mlp.py:fused_mlp (_kernel).  x (M, C) row-major
// in T, W1 (C, H) and W2 (H, Co) row-major (the reference's (in, out) layout),
// b1 / b2 fp32; out (M, Co) in T.  act 0 is GELU (tanh form in bf16, as v
// sigmoid(2u) = 0.5 v (1 + tanh u); erf in fp32: the reference's dtype
// predicate), 1 is ReLU.  The hidden is rounded to T before the second
// product, as the reference rounds it to x's dtype.
//
// Each CTA takes a tile of rows and walks the hidden width in chunks: a chunk
// is produced (x tile . W1 chunk), biased, activated, rounded, and at once
// contracted into the tile's fp32 output accumulators, so the 4x hidden never
// reaches device memory.
//
// bf16, C and Co up to 256: mma.sync m16n8k16 tensor cores, 8 warps, 256
// rows a CTA (128 for Co = 256, whose accumulators take the registers of a
// second strip).  The x tile lands once by 16-byte cp.async into a swizzled
// tile; W1's and W2's 32-wide hidden chunks stream through a 3-stage
// cp.async ring, so the next chunks' loads run under this chunk's products,
// one barrier a chunk.  A warp owns 16 or 32 rows and all Co outputs: its
// hidden chunk's fp32 C fragments take bias, activation and the bf16
// rounding in registers and are repacked as the A fragments of the W2
// product (the C -> A identity of attn_common.cuh), so the hidden never
// leaves registers; A fragments by ldmatrix from the x tile, B fragments by
// ldmatrix.trans from the chunk tiles.  The output tile goes out through the
// warp's own rows of the x tile, 16 bytes a store.  Each CTA reads all of W1
// and W2 once from L2: 5760 CTAs x 256 KB = 1.47 GB for the class MLP
// (1,474,560 rows, C = Co = 128, H = 512).
//
// bf16, C above 256 or Co 384 / 512 (the wide kernel): a warp holding all Co
// outputs of 16 rows would need Co / 2 accumulators a thread (256 at Co =
// 512), so the output columns are split over the warps and the hidden chunk
// is shared through shared memory instead.  64 rows a CTA (64 x 512 fp32
// accumulators are 128 a thread); each warp forms a 16 x 16 share of the
// 64 x 32 hidden chunk, biases, activates and rounds it to bf16 into a
// swizzled 4 KB tile; after one barrier every warp reads its rows of that
// tile as A fragments for its Co / 8 output columns (warps split rows too
// where Co < 128).  The same products, activation and rounding as the narrow
// kernel, in the same order a column.  x takes a 64 KB tile of up to 512
// columns, and a ring slot holds a 512 x 32 W1 chunk and a 32 x Co W2 chunk
// (64 KB at C = Co = 512), so the ring has 2 stages (196 KB in all): chunk c +
// 1 loads under chunk c's products, two barriers a chunk.  The output tile
// goes out through the x tile after a block barrier (a warp's columns span
// every row).  Each CTA reads all of W1 and W2 from L2: 13,500 CTAs x 4 MB =
// 54 GB for the Swin MLP at hidden 512 (864,000 rows, 512 -> 2048 -> 512).
//
// fp32: CUDA-core FMAs (32-row tiles; each thread owns one output column and
// Co / 8 rows, one weight load feeding Co / 8 FMAs, float4 reads of the
// shared rows; at Co 384 / 512 three / four columns 128 apart and 16 rows).
//
// Bound on the card: operations (2 M C H + 2 M H Co, ~386 GFLOP for the class
// MLP, 0.39 ms at the bf16 tensor cores' peak, against 0.4-0.6 GB of x and
// out; 3.6 TFLOP, 3.66 ms, for the Swin MLP at hidden 512).  mma.sync reads
// every B fragment from shared memory once per warp (no multicast), ~200
// bytes of ldmatrix per mma; wgmma would read it once per warpgroup.  The
// wide kernel reads ~380 KB of shared memory and 64 KB of L2 a chunk for
// 1024 mma, so those two, not the tensor cores, set its pace.
#include "attn_common.cuh"
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kBM32 = 32, kHC32 = 128;  // rows per CTA and hidden chunk, fp32

// fp32's activations: ReLU (act 1) or the exact erf GELU
__device__ __forceinline__ float act_fp32(float v, int act) {
  return act == 1 ? fmaxf(v, 0.f) : 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// bf16's activations: ReLU (ACT 1), or the tanh-form GELU 0.5 v (1 + tanh(u))
// written as v sigmoid(2 u), two SFU operations (ex2, rcp) where tanhf takes
// a long FMA sequence; the hidden is rounded to bf16 after it
template <int ACT> __device__ __forceinline__ float act_bf16(float v) {
  if constexpr (ACT == 1) return fmaxf(v, 0.f);
  else return __fdividef(v, 1.f + __expf(-1.5957691216057308f * (v + 0.044715f * v * v * v)));
}

// ---- bf16: tensor cores -------------------------------------------------
// shared: xs (BM rows of kXC 16-byte chunks: x, then the output tile) | a
// ring of kStages (W1 chunk (C rows of 4 chunks) | W2 chunk (kHC rows of Co / 8
// chunks)), every tile XOR-swizzled for conflict-free ldmatrix.
constexpr int kHC = 32;                      // hidden columns a chunk
constexpr int kStages = 3;                   // weight chunks in flight
constexpr int kMaxC = 256, kXC = kMaxC / 8;  // the narrow kernel's x and output rows: at most 256 columns
constexpr int kW1 = kMaxC * kHC;             // elements of a W1 chunk slot
constexpr int kWideC = 512, kWXC = kWideC / 8;  // the wide kernel's: at most 512 columns
constexpr int kWBM = 64, kWStages = 2;          // its rows a CTA, weight chunks in flight
constexpr int kWW1 = kWideC * kHC;              // elements of its W1 chunk slot

template <int CO> struct TileGeom {
  static constexpr int MS = CO <= 128 ? 2 : 1;   // 16-row strips a warp
  static constexpr int BM = 16 * MS * kWarps;   // rows a CTA
  static constexpr int RC2 = CO / 8;            // chunks a W2 chunk row
  static constexpr int STAGE = kW1 + kHC * CO;  // elements of a ring slot
  static constexpr size_t BYTES = ((size_t)BM * kXC * 8 + (size_t)kStages * STAGE) * sizeof(bf16);
};

// KC: C / 16 where known at compile time (the k loop unrolled whole), else
// 0; ACT the activation (act_bf16), compiled into each kernel
template <int CO, int KC, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
                const bf16* __restrict__ w2, const float* __restrict__ b2, bf16* __restrict__ out, int M,
                int C, int H) {
  using G = TileGeom<CO>;
  constexpr int MS = G::MS, NO = CO / 8, RC2 = G::RC2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ring = xs + G::BM * kXC * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)blockIdx.x * G::BM;
  const int wr0 = warp * 16 * MS;   // this warp's first row in the tile
  const int nch = H / kHC, xc = C / 8, nk = KC ? KC : C / 16;

  // hidden chunk c's W1 columns and W2 rows into ring slot c % kStages
  auto load_w = [&](int c) {
    bf16* w1s = ring + (c % kStages) * G::STAGE;
    bf16* w2s = w1s + kW1;
    const int h0 = c * kHC;
    for (int e = tid; e < C * (kHC / 8); e += kThreads) {
      const int k = e >> 2, ch = e & 3;
      cp_async16(w1s + swz<4>(k, ch), w1 + (size_t)k * H + h0 + 8 * ch);
    }
    for (int e = tid; e < kHC * RC2; e += kThreads) {
      const int k = e / RC2, ch = e % RC2;
      cp_async16(w2s + swz<RC2>(k, ch), w2 + (size_t)(h0 + k) * CO + 8 * ch);
    }
  };
  for (int e = tid; e < G::BM * xc; e += kThreads) {   // in chunk 0's commit group
    const int r = e / xc, ch = e % xc;
    const bool ok = row0 + r < M;
    cp_async16(xs + sw<kXC>(r, ch), ok ? x + (row0 + r) * C + 8 * ch : x, ok);
  }
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nch) load_w(c);
    cp_async_commit();
  }

  float acc[MS][NO][4];
#pragma unroll
  for (int s = 0; s < MS; ++s)
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[s][j][0] = acc[s][j][1] = acc[s][j][2] = acc[s][j][3] = 0.f;

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c landed for every thread; slot (c - 1) % kStages is free
    if (c + kStages - 1 < nch) load_w(c + kStages - 1);
    cp_async_commit();
    const bf16* w1s = ring + (c % kStages) * G::STAGE;
    const bf16* w2s = w1s + kW1;

    // hidden chunk: h (16 MS rows, 32 columns) = x W1[:, chunk]
    float h[MS][kHC / 8][4];
#pragma unroll
    for (int s = 0; s < MS; ++s)
#pragma unroll
      for (int j = 0; j < kHC / 8; ++j) h[s][j][0] = h[s][j][1] = h[s][j][2] = h[s][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < nk; ++kk) {
      unsigned a[MS][4];
#pragma unroll
      for (int s = 0; s < MS; ++s)
        ldmatrix_x4(a[s], xs + sw<kXC>(wr0 + 16 * s + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * kk + (lane >> 4)));
#pragma unroll
      for (int p = 0; p < kHC / 16; ++p) {
        unsigned r[4];
        ldmatrix_x4_trans(r, w1s + swz<4>(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * p + (lane >> 4)));
#pragma unroll
        for (int s = 0; s < MS; ++s) {
          mma_bf16(h[s][2 * p], a[s], r[0], r[1]);
          mma_bf16(h[s][2 * p + 1], a[s], r[2], r[3]);
        }
      }
    }
    // bias, activation and the bf16 rounding in registers: the A fragments of the W2 product
    unsigned ha[MS][kHC / 16][4];
#pragma unroll
    for (int j = 0; j < kHC / 8; ++j) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c * kHC + 8 * j + 2 * t));
#pragma unroll
      for (int s = 0; s < MS; ++s) {
        h[s][j][0] = act_bf16<ACT>(h[s][j][0] + bb.x);
        h[s][j][1] = act_bf16<ACT>(h[s][j][1] + bb.y);
        h[s][j][2] = act_bf16<ACT>(h[s][j][2] + bb.x);
        h[s][j][3] = act_bf16<ACT>(h[s][j][3] + bb.y);
      }
    }
#pragma unroll
    for (int s = 0; s < MS; ++s)
#pragma unroll
      for (int q = 0; q < kHC / 16; ++q) c_to_a(ha[s][q], h[s][2 * q], h[s][2 * q + 1]);
    // out (16 MS rows, Co) += h W2[chunk, :]
#pragma unroll
    for (int q = 0; q < kHC / 16; ++q)
#pragma unroll
      for (int p = 0; p < CO / 16; ++p) {
        unsigned r[4];
        ldmatrix_x4_trans(r, w2s + swz<RC2>(16 * q + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * p + (lane >> 4)));
#pragma unroll
        for (int s = 0; s < MS; ++s) {
          mma_bf16(acc[s][2 * p], ha[s][q], r[0], r[1]);
          mma_bf16(acc[s][2 * p + 1], ha[s][q], r[2], r[3]);
        }
      }
  }
  cp_async_wait<0>();

  // out = bf16(acc + b2) through this warp's own rows of the x tile, then 16-byte stores
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + 8 * j + 2 * t));
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      const int r = wr0 + 16 * s + g;
      store_bf16x2(xs + sw<kXC>(r, j) + 2 * t, acc[s][j][0] + bb.x, acc[s][j][1] + bb.y);
      store_bf16x2(xs + sw<kXC>(r + 8, j) + 2 * t, acc[s][j][2] + bb.x, acc[s][j][3] + bb.y);
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * MS * NO; e += 32) {
    const int r = wr0 + e / NO, ch = e % NO;
    if (row0 + r < M)
      *reinterpret_cast<uint4*>(out + (row0 + r) * CO + 8 * ch) = *reinterpret_cast<const uint4*>(xs + sw<kXC>(r, ch));
  }
}

// ---- bf16, wide: C up to 512, Co up to 512 ----------------------------------
// shared: xs (kWBM rows of kWXC chunks: x, then the output tile) | hs (the
// kWBM x kHC hidden chunk, rows of 4 chunks) | a ring of kWStages (W1 chunk
// (C rows of 4 chunks) | W2 chunk (kHC rows of Co / 8 chunks)).
template <int CO> struct WideGeom {
  static constexpr int WC = CO / 16 < kWarps ? CO / 16 : kWarps;  // warps across the output columns
  static constexpr int MS = kWBM / 16 / (kWarps / WC);            // 16-row strips a warp
  static constexpr int NCW = CO / WC;                             // output columns a warp, a multiple of 16
  static constexpr int RC2 = CO / 8;
  static constexpr int STAGE = kWW1 + kHC * CO;
  static constexpr size_t BYTES =
      ((size_t)kWBM * kWXC * 8 + (size_t)kWBM * kHC + (size_t)kWStages * STAGE) * sizeof(bf16);
};

template <int CO, int KC, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_bf16_wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
                     const bf16* __restrict__ w2, const float* __restrict__ b2, bf16* __restrict__ out, int M,
                     int C, int H) {
  using G = WideGeom<CO>;
  constexpr int MS = G::MS, NT = G::NCW / 8, RC2 = G::RC2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + kWBM * kWXC * 8;
  bf16* ring = hs + kWBM * kHC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)blockIdx.x * kWBM;
  const int nch = H / kHC, xc = C / 8, nk = KC ? KC : C / 16;
  const int hr0 = 16 * (warp >> 1), hp = warp & 1;   // this warp's hidden rows and 16-column half
  const int or0 = 16 * MS * (warp / G::WC), oc0 = G::NCW * (warp % G::WC);   // its output rows and columns
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lch = lane >> 4;      // ldmatrix x4 row and chunk

  auto load_w = [&](int c) {
    bf16* w1s = ring + (c % kWStages) * G::STAGE;
    bf16* w2s = w1s + kWW1;
    const int h0 = c * kHC;
    for (int e = tid; e < C * (kHC / 8); e += kThreads) {
      const int k = e >> 2, ch = e & 3;
      cp_async16(w1s + swz<4>(k, ch), w1 + (size_t)k * H + h0 + 8 * ch);
    }
    for (int e = tid; e < kHC * RC2; e += kThreads) {
      const int k = e / RC2, ch = e % RC2;
      cp_async16(w2s + swz<RC2>(k, ch), w2 + (size_t)(h0 + k) * CO + 8 * ch);
    }
  };
  for (int e = tid; e < kWBM * xc; e += kThreads) {   // in chunk 0's commit group
    const int r = e / xc, ch = e % xc;
    const bool ok = row0 + r < M;
    cp_async16(xs + sw<kWXC>(r, ch), ok ? x + (row0 + r) * C + 8 * ch : x, ok);
  }
  load_w(0);
  cp_async_commit();

  float acc[MS][NT][4];
  zero(acc);

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<0>();
    __syncthreads();   // chunk c landed for every thread; chunk c - 1's slot and hs are free
    if (c + 1 < nch) load_w(c + 1);
    cp_async_commit();
    const bf16* w1s = ring + (c % kWStages) * G::STAGE;
    const bf16* w2s = w1s + kWW1;

    // this warp's 16 x 16 share of the hidden chunk: x W1[:, chunk]
    float h[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < nk; ++kk) {
      unsigned a[4], r[4];
      ldmatrix_x4(a, xs + sw<kWXC>(hr0 + lrow, 2 * kk + lch));
      ldmatrix_x4_trans(r, w1s + swz<4>(16 * kk + lrow, 2 * hp + lch));
      mma_bf16(h[0], a, r[0], r[1]);
      mma_bf16(h[1], a, r[2], r[3]);
    }
    // bias, activation and the bf16 rounding, into the shared hidden tile
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ch = 2 * hp + j;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + c * kHC + 8 * ch + 2 * t));
      store_bf16x2(hs + swz<4>(hr0 + g, ch) + 2 * t, act_bf16<ACT>(h[j][0] + bb.x), act_bf16<ACT>(h[j][1] + bb.y));
      store_bf16x2(hs + swz<4>(hr0 + g + 8, ch) + 2 * t, act_bf16<ACT>(h[j][2] + bb.x),
                   act_bf16<ACT>(h[j][3] + bb.y));
    }
    __syncthreads();   // the hidden chunk is whole
    // out (this warp's rows and columns) += h W2[chunk, columns]
#pragma unroll
    for (int q = 0; q < kHC / 16; ++q) {
      unsigned a[MS][4];
#pragma unroll
      for (int s = 0; s < MS; ++s) ldmatrix_x4(a[s], hs + swz<4>(or0 + 16 * s + lrow, 2 * q + lch));
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        unsigned r[4];
        ldmatrix_x4_trans(r, w2s + swz<RC2>(16 * q + lrow, oc0 / 8 + 2 * p + lch));
#pragma unroll
        for (int s = 0; s < MS; ++s) {
          mma_bf16(acc[s][2 * p], a[s], r[0], r[1]);
          mma_bf16(acc[s][2 * p + 1], a[s], r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // out = bf16(acc + b2) into this warp's rows and columns of the x tile
  // (every warp read x for the last time before the last chunk's second
  // barrier), then whole rows out, 16 bytes a store
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + oc0 + 8 * j + 2 * t));
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      const int r = or0 + 16 * s + g;
      store_bf16x2(xs + sw<kWXC>(r, oc0 / 8 + j) + 2 * t, acc[s][j][0] + bb.x, acc[s][j][1] + bb.y);
      store_bf16x2(xs + sw<kWXC>(r + 8, oc0 / 8 + j) + 2 * t, acc[s][j][2] + bb.x, acc[s][j][3] + bb.y);
    }
  }
  __syncthreads();
  for (int e = tid; e < kWBM * RC2; e += kThreads) {
    const int r = e / RC2, ch = e % RC2;
    if (row0 + r < M)
      *reinterpret_cast<uint4*>(out + (row0 + r) * CO + 8 * ch) = *reinterpret_cast<const uint4*>(xs + sw<kWXC>(r, ch));
  }
}

// ---- fp32: CUDA cores -----------------------------------------------------
// shared: xs (kBM32, C) | hs (kBM32, kHC32)
template <int NTH>  // Co = 32 NTH
__global__ void __launch_bounds__(kThreads)
mlp_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int M,
                int C, int H, int act) {
  constexpr int Co = 32 * NTH;
  constexpr int NC = NTH <= 8 ? 1 : NTH / 4;   // output columns a thread (Co 384 / 512: 3 / 4)
  constexpr int CT = Co / NC;                  // threads across the output columns (at most 256)
  constexpr int RB = kBM32 * CT / kThreads;    // output rows per thread (4 NTH up to Co = 256, else 16)
  constexpr int RH = kBM32 * kHC32 / kThreads;  // hidden rows per thread (16)
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

  const int ch = tid % kHC32, rh0 = (tid / kHC32) * RH;  // hidden column, first row
  const int co = tid % CT, ro0 = (tid / CT) * RB;        // first output column (then every CT), first row
  float acc_o[RB][NC];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc_o[i][j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += kHC32) {
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
    for (int i = 0; i < RH; ++i) hs[(rh0 + i) * kHC32 + ch] = act_fp32(acc[i] + bias, act);
    __syncthreads();
    for (int k = 0; k < kHC32; k += 4) {
      float w[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < NC; ++j) w[u][j] = __ldg(w2 + (size_t)(h0 + k + u) * Co + co + CT * j);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(hs + (ro0 + i) * kHC32 + k);
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          acc_o[i][j] = fmaf(a.x, w[0][j], acc_o[i][j]);
          acc_o[i][j] = fmaf(a.y, w[1][j], acc_o[i][j]);
          acc_o[i][j] = fmaf(a.z, w[2][j], acc_o[i][j]);
          acc_o[i][j] = fmaf(a.w, w[3][j], acc_o[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const float bias = b2[co + CT * j];
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if (row0 + ro0 + i < M) out[(row0 + ro0 + i) * Co + co + CT * j] = acc_o[i][j] + bias;
  }
}

template <int CO>
cudaError_t run_wide(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                     int M, int C, int H, int act, cudaStream_t st) {
  using G = WideGeom<CO>;
  constexpr int KC = CO == 384 || CO == 512 ? CO / 16 : 0;   // the model's C = Co, its k loop unrolled
  auto k = KC && C == CO ? (act ? mlp_bf16_wide_kernel<CO, KC, 1> : mlp_bf16_wide_kernel<CO, KC, 0>)
                         : (act ? mlp_bf16_wide_kernel<CO, 0, 1> : mlp_bf16_wide_kernel<CO, 0, 0>);
  const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::BYTES);
  if (e != cudaSuccess) return e;
  k<<<(M + kWBM - 1) / kWBM, kThreads, G::BYTES, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), M, C, H);
  return cudaSuccess;
}

template <int NTH>  // Co = 32 NTH
int run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out, int M, int C,
        int H, int act, int is_bf16, cudaStream_t st) {
  constexpr int CO = 32 * NTH;
  cudaError_t e = cudaSuccess;
  if (is_bf16) {
    if (CO > kMaxC || C > kMaxC) {
      e = run_wide<CO>(x, w1, b1, w2, b2, out, M, C, H, act, st);
    } else if constexpr (CO <= kMaxC) {   // the narrow kernel, compiled for Co up to 256 only
      using G = TileGeom<CO>;
      auto k = C == 128 ? (act ? mlp_bf16_kernel<CO, 8, 1> : mlp_bf16_kernel<CO, 8, 0>)   // the model's MLPs
                        : (act ? mlp_bf16_kernel<CO, 0, 1> : mlp_bf16_kernel<CO, 0, 0>);
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::BYTES);
      if (e == cudaSuccess)
        k<<<(M + G::BM - 1) / G::BM, kThreads, G::BYTES, st>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
            static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), M, C, H);
    }
  } else {
    const size_t smem = (size_t)kBM32 * (C + kHC32) * 4;
    e = cudaFuncSetAttribute(mlp_fp32_kernel<NTH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      mlp_fp32_kernel<NTH><<<(M + kBM32 - 1) / kBM32, kThreads, smem, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
          static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), M, C, H, act);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Takes C a multiple of 16 up to 512, H a multiple of 128, Co 32, 64, 128,
// 256, 384 or 512; C or Co above 256 takes the wide bf16 kernel.
extern "C" int catseg_mlp(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                          int M, int C, int H, int Co, int act, int is_bf16, void* stream) {
  if (M <= 0 || C <= 0 || C % 16 || C > kWideC || H <= 0 || H % kHC32 || (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (Co) {
    case 32: return run<1>(x, w1, b1, w2, b2, out, M, C, H, act, is_bf16, st);
    case 64: return run<2>(x, w1, b1, w2, b2, out, M, C, H, act, is_bf16, st);
    case 128: return run<4>(x, w1, b1, w2, b2, out, M, C, H, act, is_bf16, st);
    case 256: return run<8>(x, w1, b1, w2, b2, out, M, C, H, act, is_bf16, st);
    case 384: return run<12>(x, w1, b1, w2, b2, out, M, C, H, act, is_bf16, st);
    case 512: return run<16>(x, w1, b1, w2, b2, out, M, C, H, act, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
