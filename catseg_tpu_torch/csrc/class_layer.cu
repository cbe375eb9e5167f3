// One class-attention transformer layer, one CTA per (spatial position, image).
//
// Replaces catseg_tpu/kernels/class_layer.py:fused_class_layer (_kernel,
// _kernel_v2 and _kernel_v3: one kernel here for all three).  x, out:
// (B, T, HW, 128) class-major; the CTA reads the T class rows of its position
// at stride HW*128 and writes them in the same layout to out, so the
// position-major transpose never reaches device memory.  qg, kg: (B, T, 128)
// text-guidance halves of q/k (or null); pad_kv (128, 128) and pad_ksum (128,)
// fp32 carry the pad_len - T learnable padding rows as constant linear-
// attention terms, so pad rows are never materialized.
//
// Per head: K = elu(k)+1 and V/Tp -> the 32x32 KV block and the K sum (plus
// pad terms) -> Q = elu(q)+1 -> out = Q.KV * Tp / (Q.Ksum + 1e-6).  q and k
// stay fp32 through the guidance add and elu+1, and the linear attention is
// fp32, as the reference spec does.  Then residual -> LN2 -> ReLU MLP ->
// residual.  Both paths take T <= 256 (pad_len, the count the top-k path
// hands over).
//
// bf16 (the serving dtype) runs on mma.sync tensor cores (its note below).
// Its work at T = 150 is 29 M multiply-adds a position on the tensor cores
// (qkv, fc1, fc2) and 1.3 M fp32 ones in the linear attention: 0.33 ms for
// the 5760 positions of the serving slab at the bf16 peak; it takes ~5 ms
// on an H100 (80GB HBM3, 700 W), one 16-warp CTA an SM.  A position's work
// is small and serial (LN -> 4 x (k|v, KV, q, out) -> LN -> 4 x (fc1, fc2)),
// 28 barriers, and tools/class_phases.py's clocks spread its time over all
// the phases: k|v 24%, fc1 17%, KV 14%, q 13%, attention out 12%, fc2 11%,
// loads, LayerNorms and stores 10%; every product phase runs at 4-21x its
// tensor-core cycles, so issue and latency inside each phase, not the
// tensor cores or device memory (the activation crosses it once), set the
// time.  Loading every weight fragment of a product before its first mma
// (one L2 round trip a task) did not help: it spilled and ran 14% slower.
//
// fp32 runs CUDA-core FMAs and stays the oracle-parity path: one 8-warp CTA
// an SM, seq = x + attention written straight to out and the fc2 chunks
// accumulated there, so shared memory holds one (T, C) buffer and the
// per-head rows.
#include "attn_common.cuh"
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kC = 128, kHeads = 4, kD = 32, kDP = kD + 1, kHid = 512, kHC = 64;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxT = 256;        // classes per position (pad_len)
constexpr size_t kSmemLimit = 232448;

struct ClassParams {
  const float *ln1_g, *ln1_b, *qkv_w, *qkv_b, *ln2_g, *ln2_b, *m1_w, *m1_b, *m2_w, *m2_b;
};

__device__ __forceinline__ float elu1(float v) { return v > 0.f ? v + 1.f : expf(fminf(v, 0.f)); }

constexpr size_t smem_bytes(int nT) {
  return (size_t)(nT * kC + 2 * nT * kDP + kD * kDP + kD + nT) * sizeof(float);
}

// KV block (D, DP) and K sum (D) of head hq from K (elu+1) and V/Tp rows
// (nT, DP), plus the padding rows' constant terms.
__device__ __forceinline__ void head_kv(const float* Kh, const float* Vh, int nT, int hq,
                                        const float* __restrict__ pad_kv,
                                        const float* __restrict__ pad_ksum, float* KV, float* ks) {
  for (int e = threadIdx.x; e < kD * kD; e += blockDim.x) {
    const int d = e / kD, f = e % kD;
    float s = 0.f;
    for (int t = 0; t < nT; ++t) s = fmaf(Kh[t * kDP + d], Vh[t * kDP + f], s);
    KV[d * kDP + f] = s + pad_kv[(size_t)(hq + d) * kC + hq + f];
  }
  for (int d = threadIdx.x; d < kD; d += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < nT; ++t) s += Kh[t * kDP + d];
    ks[d] = s + pad_ksum[hq + d];
  }
}

// z[t] = Q_t . Ksum, then put(t, f, (Q_t . KV[:, f]) * Tp / (z_t + 1e-6)).
template <typename Put>
__device__ __forceinline__ void head_out(const float* Qh, const float* KV, const float* ks, float* z,
                                         int nT, float Tp, Put put) {
  for (int t = threadIdx.x; t < nT; t += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < kD; ++d) s = fmaf(Qh[t * kDP + d], ks[d], s);
    z[t] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nT * kD; e += blockDim.x) {
    const int t = e / kD, f = e % kD;
    float s = 0.f;
    for (int d = 0; d < kD; ++d) s = fmaf(Qh[t * kDP + d], KV[d * kDP + f], s);
    put(t, f, s * (Tp / (z[t] + 1e-6f)));
  }
}

// fp32 layer: CUDA-core FMA products (mm_rows).
__global__ void __launch_bounds__(kThreads, 1)
class_layer_kernel(const float* x, float* out, const float* qg, const float* kg,
                   const float* __restrict__ pad_kv, const float* __restrict__ pad_ksum, ClassParams p,
                   int nT, int HW, int has_guid, float Tp) {
  using T = float;
  extern __shared__ float sm[];
  float* Y = sm;                 // (T, C): LN1 out, then LN2 out
  float* R = Y + nT * kC;        // 2 x (T, DP) per-head K/V (Q reuses K), then (T, HC) hidden
  float* KV = R + 2 * nT * kDP;  // (D, DP)
  float* ks = KV + kD * kDP;     // (D,)
  float* z = ks + kD;            // (T,)
  const int pos = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto row = [&](int t) { return ((size_t)(b * nT + t) * HW + pos) * kC; };
  const size_t gb = (size_t)b * nT * kC;

  for (int t = warp; t < nT; t += kWarps) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = x[row(t) + lane + 32 * i];
    ln_row128<T>(v, p.ln1_g, p.ln1_b, Y + t * kC, lane);
  }
  __syncthreads();

  float* Kh = R;
  float* Vh = R + nT * kDP;
  for (int h = 0; h < kHeads; ++h) {
    const int hq = h * kD, hk = kC + h * kD, hv = 2 * kC + h * kD;
    mm_rows<8>(Y, kC, p.qkv_w + hk, 3 * kC, nT, kD, kC, [&](int r, int c, float acc) {
      float k = acc + p.qkv_b[hk + c];
      if (has_guid) k += kg[gb + (size_t)r * kC + hq + c];
      Kh[r * kDP + c] = elu1(k);
    });
    mm_rows<8>(Y, kC, p.qkv_w + hv, 3 * kC, nT, kD, kC,
               [&](int r, int c, float acc) { Vh[r * kDP + c] = (acc + p.qkv_b[hv + c]) / Tp; });
    __syncthreads();
    head_kv(Kh, Vh, nT, hq, pad_kv, pad_ksum, KV, ks);
    __syncthreads();
    float* Qh = Kh;  // K is folded into KV / ks now
    mm_rows<8>(Y, kC, p.qkv_w + hq, 3 * kC, nT, kD, kC, [&](int r, int c, float acc) {
      float q = acc + p.qkv_b[hq + c];
      if (has_guid) q += qg[gb + (size_t)r * kC + hq + c];
      Qh[r * kDP + c] = elu1(q);
    });
    __syncthreads();
    // seq = x + attn straight to out (the final residual and the MLP's sum)
    head_out(Qh, KV, ks, z, nT, Tp, [&](int t, int f, float v) {
      const size_t gi = row(t) + hq + f;
      out[gi] = x[gi] + v;
    });
    __syncthreads();
  }

  for (int t = warp; t < nT; t += kWarps) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = out[row(t) + lane + 32 * i];
    ln_row128<T>(v, p.ln2_g, p.ln2_b, Y + t * kC, lane);
  }
  __syncthreads();
  for (int c0 = 0; c0 < kHid; c0 += kHC) {
    mm_rows<8>(Y, kC, p.m1_w + c0, kHid, nT, kHC, kC,
               [&](int r, int c, float acc) { R[r * kHC + c] = fmaxf(acc + p.m1_b[c0 + c], 0.f); });
    __syncthreads();
    mm_rows<8>(R, kHC, p.m2_w + (size_t)c0 * kC, kC, nT, kC, kHC,
               [&](int r, int c, float acc) { out[row(r) + c] += acc; });
    __syncthreads();
  }
  for (int i = tid; i < nT * kC; i += blockDim.x) out[row(i / kC) + i % kC] += p.m2_b[i % kC];
}

// ---- bf16 layer on the tensor cores: one 16-warp CTA per (position, image) ----
//
// Shared memory, tp = T rounded up to 16 rows:
//   Xs  (tp, C) bf16  x, by one 16-byte cp.async a chunk; then seq = x +
//       attention, a head's 32 columns at a time; then the layer's output
//   Ys  (tp, C) bf16  LN1 out, then LN2 out (rows >= T stay 0)
//   Ks, Vs (tp, kFS) fp32  K and V / Tp of one head; Q of the head then
//       takes Ks.  Together they hold the MLP's (tp, 128) hidden chunk.
//   KV (32, 32), ks (32) fp32  the head's KV block and K sum
// the bf16 tiles swizzled as in attn_common.cuh: 832 bytes a row, 137 KB at
// T = 150, 217 KB at T = 256.  Every product takes its A fragments by
// ldmatrix from Ys (or the hidden chunk) and its B fragments from weights
// packed in mma fragment order (kernels/swin_block.py pack_mma_b), 16 bytes
// a lane straight from L2 into registers; a warp's task is one 16-column
// block over a group of at most kG row strips, so a B fragment feeds up to
// kG mma.  Epilogues run on the fp32 accumulators in registers.
//
// Per head: k | v (4 column blocks) -> K, V / Tp fp32; KV = K^T V and the K
// sum by register-tiled FMAs (a thread owns a 4x4 block of KV over every
// 8th row, the 8 row phases summed by a fixed butterfly of shuffles: no
// atomics, the same order every run); q (2 blocks) -> Q fp32 over K; then a
// thread a (row, 8 columns) forms Q.KV, z = Q.Ksum and seq = bf16(x + Q.KV
// Tp / (z + 1e-6)) in Xs.  The MLP runs in four 128-wide hidden chunks:
// fc1 + bias + ReLU rounded into the chunk, fc2 accumulated in registers
// over the chunks (two output tasks a warp), then out = seq + bf16(fc2 +
// bias) in Xs and one 16-byte store a chunk of every row.
constexpr int kTcWarps = 16, kTcThreads = kTcWarps * 32;
constexpr int kG = 4;             // row strips a product task takes at most
constexpr int kFS = kD + 8;       // fp32 row stride of K, V, Q (two store wavefronts a fragment)
constexpr int kHidChunk = 128;    // MLP hidden columns a pass

// Timing build (tools/class_phases.py; never the library the port loads):
// CATSEG_CLASS_PHASE_CLOCKS makes thread 0 of every CTA add the clock64
// cycles between the kernel's barriers to g_phase_cycles, one slot a phase
// (x load + LN1, k|v, KV, q, attention out, LN2, fc1, fc2, epilogue and
// store; the head phases summed over the 4 heads), the CTA count in the last.
#ifdef CATSEG_CLASS_PHASE_CLOCKS
constexpr int kPhases = 9;
__device__ unsigned long long g_phase_cycles[kPhases + 1];
#define CLASS_PHASE(i)                                                                    \
  do {                                                                                    \
    if (threadIdx.x == 0) {                                                               \
      const long long now = clock64();                                                    \
      atomicAdd(&g_phase_cycles[i], (unsigned long long)(now - t_phase));                 \
      t_phase = now;                                                                      \
    }                                                                                     \
  } while (0)
#else
#define CLASS_PHASE(i) \
  do {                 \
  } while (0)
#endif

struct ClassParamsTC {
  const float *ln1_g, *ln1_b;
  const uint4* qkv_w;   // packed (pack_mma_b) bf16 weights
  const float *qkv_b, *ln2_g, *ln2_b;
  const uint4* m1_w;
  const float* m1_b;
  const uint4* m2_w;
  const float* m2_b;
};

__host__ __device__ constexpr int padded(int nT) { return (nT + 15) / 16 * 16; }

constexpr size_t smem_bytes_tc(int nT) {
  return (size_t)padded(nT) * (2 * kC * sizeof(bf16) + 2 * kFS * sizeof(float))
         + (size_t)(kD * kD + kD) * sizeof(float);
}
static_assert(2 * kFS * sizeof(float) >= kHidChunk * sizeof(bf16), "the hidden chunk fits the K and V rows");
static_assert(smem_bytes(kMaxT) <= kSmemLimit && smem_bytes_tc(kMaxT) <= kSmemLimit, "shared memory at T = 256");

// strips [s0, s0 + ms) of row group gi of ng over ns strips: sizes differ by at most one
__device__ __forceinline__ void row_group(int gi, int ng, int ns, int& s0, int& ms) {
  s0 = gi * ns / ng;
  ms = (gi + 1) * ns / ng - s0;
}

// acc[i][j] += A (strips s0 + i for i < ms, 128 columns) x W (n8 tiles j0 +
// j, k-pairs p0 .. p0 + 3); A a swizzled (rows, 128) bf16 tile, W packed
// with kp k-pairs a tile (swin_block.cu's gemm with a run-time strip count)
template <int NT>
__device__ __forceinline__ void gemm_rows(float (&acc)[kG][NT][4], const bf16* A, int s0, int ms,
                                          const uint4* __restrict__ W, int kp, int j0, int p0, int lane) {
#pragma unroll
  for (int p = 0; p < kC / 32; ++p) {
    uint4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = __ldg(W + ((size_t)(j0 + j) * kp + p0 + p) * 32 + lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        if (i < ms) {
          unsigned a[4];
          load_a<kC / 8>(a, A, s0 + i, 2 * p + h, lane);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, h ? b[j].z : b[j].x, h ? b[j].w : b[j].y);
        }
      }
    }
  }
}

// epi(row, col, v0, v1) for each accumulator pair of strips s0 .. s0 + ms - 1;
// col counts from the task's first column
template <int NT, typename Epi>
__device__ __forceinline__ void rows_pairs(const float (&acc)[kG][NT][4], int s0, int ms, int lane, Epi epi) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    if (i < ms) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = 16 * (s0 + i) + g, c = 8 * j + 2 * t;
        epi(r, c, acc[i][j][0], acc[i][j][1]);
        epi(r + 8, c, acc[i][j][2], acc[i][j][3]);
      }
    }
  }
}

// LayerNorm (single-pass variance, fp32 statistics) of rows < nT of X into
// Y, a warp a row, columns 4 lane .. 4 lane + 3 in each lane
__device__ __forceinline__ void ln_rows_tc(bf16* X, bf16* Y, const float* g, const float* b, int nT, int warp,
                                           int lane) {
  const float4 gv = __ldg(reinterpret_cast<const float4*>(g) + lane);
  const float4 bv = __ldg(reinterpret_cast<const float4*>(b) + lane);
  for (int r = warp; r < nT; r += kTcWarps) {
    const float2 v01 = unpack_bf16(at<16>(X, r, 4 * lane)), v23 = unpack_bf16(at<16>(X, r, 4 * lane + 2));
    const float mean = warp_sum(v01.x + v01.y + v23.x + v23.y) * (1.f / kC);
    const float var =
        warp_sum(v01.x * v01.x + v01.y * v01.y + v23.x * v23.x + v23.y * v23.y) * (1.f / kC) - mean * mean;
    const float rs = rsqrtf(var + 1e-5f);
    store_bf16x2(at<16>(Y, r, 4 * lane), (v01.x - mean) * rs * gv.x + bv.x, (v01.y - mean) * rs * gv.y + bv.y);
    store_bf16x2(at<16>(Y, r, 4 * lane + 2), (v23.x - mean) * rs * gv.z + bv.z,
                 (v23.y - mean) * rs * gv.w + bv.w);
  }
}

// KV block and K sum of head hq over rows < nT of Ks, Vs, plus the padding
// rows' terms: thread (4x4 block b, row phase s) sums rows s, s + 8, ...;
// the 8 phases (lanes s = 0..7 of one block) meet by xor shuffles
__device__ __forceinline__ void head_kv_tc(const float* Ks, const float* Vs, int nT, int hq,
                                           const float* __restrict__ pad_kv, const float* __restrict__ pad_ksum,
                                           float* KV, float* ks, int tid) {
  static_assert(kTcThreads == 8 * (kD / 4) * (kD / 4), "a thread per (4x4 KV block, row phase)");
  const int blk = tid >> 3, s = tid & 7, d0 = (blk >> 3) * 4, f0 = (blk & 7) * 4;
  float acc[4][4] = {}, kp[4] = {};
  for (int t = s; t < nT; t += 8) {
    const float4 k = *reinterpret_cast<const float4*>(Ks + t * kFS + d0);
    const float4 v = *reinterpret_cast<const float4*>(Vs + t * kFS + f0);
    const float kk[4] = {k.x, k.y, k.z, k.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      kp[i] += kk[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kk[i], vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      kp[i] += __shfl_xor_sync(0xffffffffu, kp[i], o);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
    }
  }
  if (s == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) KV[(d0 + i) * kD + f0 + j] = acc[i][j] + pad_kv[(size_t)(hq + d0 + i) * kC + hq + f0 + j];
      if (f0 == 0) ks[d0 + i] = kp[i] + pad_ksum[hq + d0 + i];
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
class_layer_tc_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, const bf16* __restrict__ qg,
                      const bf16* __restrict__ kg, const float* __restrict__ pad_kv,
                      const float* __restrict__ pad_ksum, ClassParamsTC p, int nT, int HW, int has_guid, float Tp) {
  extern __shared__ __align__(128) unsigned char smraw[];
#ifdef CATSEG_CLASS_PHASE_CLOCKS
  long long t_phase = clock64();
#endif
  const int tp = padded(nT), ns = tp / 16;
  bf16* Xs = reinterpret_cast<bf16*>(smraw);
  bf16* Ys = Xs + tp * kC;
  float* Ks = reinterpret_cast<float*>(Ys + tp * kC);
  float* Vs = Ks + tp * kFS;
  bf16* Hs = reinterpret_cast<bf16*>(Ks);
  float* KV = Vs + tp * kFS;
  float* ks = KV + kD * kD;
  const int pos = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto grow = [&](int t) { return ((size_t)(b * nT + t) * HW + pos) * kC; };
  const size_t gb = (size_t)b * nT * kC;

  // x rows by 16-byte cp.async, rows >= T zero-filled; LN1 (Ys rows >= T zero)
  for (int e = tid; e < tp * 16; e += kTcThreads) {
    const int r = e >> 4, c = e & 15;
    const bool valid = r < nT;
    cp_async16(Xs + sw<16>(r, c), x + (valid ? grow(r) + c * 8 : 0), valid);
    if (!valid) *reinterpret_cast<uint4*>(Ys + sw<16>(r, c)) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  ln_rows_tc(Xs, Ys, p.ln1_g, p.ln1_b, nT, warp, lane);
  __syncthreads();
  CLASS_PHASE(0);

  const int ng = (ns + kG - 1) / kG, ngq = (ns + 1) / 2;
  for (int h = 0; h < kHeads; ++h) {
    const int hq = h * kD;
    // k | v of the head: 4 16-column blocks x ng row groups
    for (int task = warp; task < 4 * ng; task += kTcWarps) {
      const int cb = task & 3, isv = cb >> 1, c0 = (cb & 1) * 16;
      const int col0 = (1 + isv) * kC + hq + c0;   // qkv column of the block
      int s0, ms;
      row_group(task >> 2, ng, ns, s0, ms);
      float acc[kG][2][4];
      zero(acc);
      gemm_rows<2>(acc, Ys, s0, ms, p.qkv_w, kC / 32, col0 / 8, 0, lane);
      float* dst = isv ? Vs : Ks;
      rows_pairs(acc, s0, ms, lane, [&](int r, int c, float v0, float v1) {
        if (r >= nT) return;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.qkv_b + col0 + c));
        float a0 = v0 + bb.x, a1 = v1 + bb.y;
        if (isv) {
          a0 = a0 / Tp;
          a1 = a1 / Tp;
        } else {
          if (has_guid) {
            const float2 gv = unpack_bf16(kg + gb + (size_t)r * kC + hq + c0 + c);
            a0 += gv.x;
            a1 += gv.y;
          }
          a0 = elu1(a0);
          a1 = elu1(a1);
        }
        *reinterpret_cast<float2*>(dst + r * kFS + c0 + c) = make_float2(a0, a1);
      });
    }
    __syncthreads();
    CLASS_PHASE(1);
    head_kv_tc(Ks, Vs, nT, hq, pad_kv, pad_ksum, KV, ks, tid);
    __syncthreads();
    CLASS_PHASE(2);
    // q of the head over K (folded into KV and ks now): 2 blocks x row groups of at most 2 strips
    for (int task = warp; task < 2 * ngq; task += kTcWarps) {
      const int c0 = (task & 1) * 16;
      int s0, ms;
      row_group(task >> 1, ngq, ns, s0, ms);
      float acc[kG][2][4];
      zero(acc);
      gemm_rows<2>(acc, Ys, s0, ms, p.qkv_w, kC / 32, (hq + c0) / 8, 0, lane);
      rows_pairs(acc, s0, ms, lane, [&](int r, int c, float v0, float v1) {
        if (r >= nT) return;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.qkv_b + hq + c0 + c));
        float a0 = v0 + bb.x, a1 = v1 + bb.y;
        if (has_guid) {
          const float2 gv = unpack_bf16(qg + gb + (size_t)r * kC + hq + c0 + c);
          a0 += gv.x;
          a1 += gv.y;
        }
        *reinterpret_cast<float2*>(Ks + r * kFS + c0 + c) = make_float2(elu1(a0), elu1(a1));
      });
    }
    __syncthreads();
    CLASS_PHASE(3);
    // seq = x + Q.KV Tp / (Q.Ksum + 1e-6), rounded, over x in Xs: a thread a (row, 8 columns)
    for (int it = tid; it < nT * 4; it += kTcThreads) {
      const int r = it >> 2, f0 = (it & 3) * 8;
      float o[8] = {}, z = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kD; d4 += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(Ks + r * kFS + d4);
        const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int d = d4 + u;
          z = fmaf(qq[u], ks[d], z);
          const float4 a = *reinterpret_cast<const float4*>(KV + d * kD + f0);
          const float4 c = *reinterpret_cast<const float4*>(KV + d * kD + f0 + 4);
          o[0] = fmaf(qq[u], a.x, o[0]);
          o[1] = fmaf(qq[u], a.y, o[1]);
          o[2] = fmaf(qq[u], a.z, o[2]);
          o[3] = fmaf(qq[u], a.w, o[3]);
          o[4] = fmaf(qq[u], c.x, o[4]);
          o[5] = fmaf(qq[u], c.y, o[5]);
          o[6] = fmaf(qq[u], c.z, o[6]);
          o[7] = fmaf(qq[u], c.w, o[7]);
        }
      }
      const float sc = Tp / (z + 1e-6f);
      uint4* xp = reinterpret_cast<uint4*>(at<16>(Xs, r, hq + f0));
      uint4 u = *xp;
      unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + e));
        w[e] = pack_bf16(xv.x + o[2 * e] * sc, xv.y + o[2 * e + 1] * sc);
      }
      *xp = u;
    }
    __syncthreads();
    CLASS_PHASE(4);
  }

  ln_rows_tc(Xs, Ys, p.ln2_g, p.ln2_b, nT, warp, lane);
  __syncthreads();
  CLASS_PHASE(5);

  // ReLU MLP in 128-wide hidden chunks; fc2 task warp + 16 i (16-column
  // block, row group) keeps its accumulators in registers across the chunks
  float acc2[2][kG][2][4];
  zero(acc2[0]);
  zero(acc2[1]);
  for (int c0 = 0; c0 < kHid; c0 += kHidChunk) {
    for (int task = warp; task < (kHidChunk / 16) * ng; task += kTcWarps) {
      const int cb = task % (kHidChunk / 16);
      int s0, ms;
      row_group(task / (kHidChunk / 16), ng, ns, s0, ms);
      float acc[kG][2][4];
      zero(acc);
      gemm_rows<2>(acc, Ys, s0, ms, p.m1_w, kC / 32, (c0 + 16 * cb) / 8, 0, lane);
      rows_pairs(acc, s0, ms, lane, [&](int r, int c, float v0, float v1) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.m1_b + c0 + 16 * cb + c));
        store_bf16x2(at<kHidChunk / 8>(Hs, r, 16 * cb + c), fmaxf(v0 + bb.x, 0.f), fmaxf(v1 + bb.y, 0.f));
      });
    }
    __syncthreads();
    CLASS_PHASE(6);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int task = warp + kTcWarps * i;
      if (task < (kC / 16) * ng) {
        int s0, ms;
        row_group(task / (kC / 16), ng, ns, s0, ms);
        gemm_rows<2>(acc2[i], Hs, s0, ms, p.m2_w, kHid / 32, 2 * (task % (kC / 16)), c0 / 32, lane);
      }
    }
    __syncthreads();
    CLASS_PHASE(7);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int task = warp + kTcWarps * i;
    if (task < (kC / 16) * ng) {
      const int cb = task % (kC / 16);
      int s0, ms;
      row_group(task / (kC / 16), ng, ns, s0, ms);
      rows_pairs(acc2[i], s0, ms, lane, [&](int r, int c, float v0, float v1) {
        if (r >= nT) return;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.m2_b + 16 * cb + c));
        bf16* d = at<16>(Xs, r, 16 * cb + c);
        const float2 xv = unpack_bf16(d);
        store_bf16x2(d, xv.x + rnd<bf16>(v0 + bb.x), xv.y + rnd<bf16>(v1 + bb.y));
      });
    }
  }
  __syncthreads();
  for (int e = tid; e < nT * 16; e += kTcThreads) {
    const int r = e >> 4, c = e & 15;
    *reinterpret_cast<uint4*>(out + grow(r) + c * 8) = *reinterpret_cast<const uint4*>(Xs + sw<16>(r, c));
  }
#ifdef CATSEG_CLASS_PHASE_CLOCKS
  __syncthreads();
  CLASS_PHASE(8);
  if (tid == 0) atomicAdd(&g_phase_cycles[kPhases], 1ull);
#endif
}

}  // namespace

#ifdef CATSEG_CLASS_PHASE_CLOCKS
// copies the timing build's per-phase cycle sums and CTA count (kPhases + 1
// values) to host memory and sets them to 0
extern "C" int catseg_class_phase_cycles(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles));
  static const unsigned long long zeros[kPhases + 1] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_cycles, zeros, sizeof(zeros));
  return (int)e;
}
#endif

extern "C" int catseg_class_layer(const void* x, void* out, const void* qg, const void* kg,
                                  const void* pad_kv, const void* pad_ksum, const void* ln1_g,
                                  const void* ln1_b, const void* qkv_w, const void* qkv_b,
                                  const void* ln2_g, const void* ln2_b, const void* m1_w,
                                  const void* m1_b, const void* m2_w, const void* m2_b, int B,
                                  int nT, int HW, int has_guid, float Tp, int is_bf16,
                                  void* stream) {
  if (B <= 0 || nT <= 0 || HW <= 0 || nT > kMaxT)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto h = [](const void* ptr) { return static_cast<const bf16*>(ptr); };
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(HW, B);
  cudaError_t e;
  if (is_bf16) {
    auto u = [](const void* ptr) { return static_cast<const uint4*>(ptr); };
    const ClassParamsTC p{f(ln1_g), f(ln1_b), u(qkv_w), f(qkv_b), f(ln2_g),
                          f(ln2_b), u(m1_w),  f(m1_b),  u(m2_w),  f(m2_b)};
    const size_t smem = smem_bytes_tc(nT);
    e = cudaFuncSetAttribute(class_layer_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    class_layer_tc_kernel<<<grid, kTcThreads, smem, st>>>(h(x), static_cast<bf16*>(out), h(qg), h(kg), f(pad_kv),
                                                          f(pad_ksum), p, nT, HW, has_guid, Tp);
  } else {
    const ClassParams p{f(ln1_g), f(ln1_b), f(qkv_w), f(qkv_b), f(ln2_g),
                        f(ln2_b), f(m1_w),  f(m1_b),  f(m2_w),  f(m2_b)};
    const size_t smem = smem_bytes(nT);
    e = cudaFuncSetAttribute(class_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    class_layer_kernel<<<grid, kThreads, smem, st>>>(f(x), static_cast<float*>(out), f(qg), f(kg), f(pad_kv),
                                                     f(pad_ksum), p, nT, HW, has_guid, Tp);
  }
  return (int)cudaGetLastError();
}
