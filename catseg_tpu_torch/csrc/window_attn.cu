// Windowed multi-head attention softmax(scale q k^T + mask) v over
// already-projected q / k / v.
//
// Replaces catseg_tpu/kernels/window_attn.py:fused_window_attention
// (_kernel).  q, k, v: (Bw, N, C) with rows ldq / ldk / ldv elements apart
// (the unfused Swin block hands in views of its fused qkv projection, rows
// 3C apart), windows of one image consecutive; out (Bw, N, C) contiguous;
// mask (nW, N, N) fp32 additive, window w takes mask row w % nW, or null
// (an unshifted block): then the add is skipped, which is exact.  Logits
// are scaled after the q.k product and the mask added, as the reference's
// kernel does; the softmax is exact and max-subtracted in fp32 in both
// dtypes; P is normalised, then rounded to T before the value product,
// which accumulates in fp32.  The (N, N) logits never reach device memory.
//
// Bound on the card: bytes in bf16 (0.89 GB at 6000 windows of 144 x 128,
// 0.26 ms; the 64 GFLOP take 0.06 ms on tensor cores), operations in fp32.
//
// bf16 with N % 16 == 0 and head dims 16, 32, 64, 128, where the window's K
// and V fit in shared memory (the Swin geometry, 144 tokens x 128, at 4 heads
// or one, and window 16, 256 tokens): tensor cores, one block per window
// with all its heads.  The window's whole K and V rows come in by 16-byte
// cp.async (rows XOR-swizzled in 16-byte chunks, so ldmatrix is
// conflict-free): 72 KB at 144 x 128, so three 4-warp blocks share an SM and
// one block's loads overlap another's math (registers allow no more: 156 a
// thread at D = 32).  A warp takes (16 query rows, head) tasks in turn, the
// heads of a row block one after another; its Q fragments come straight
// from device memory, at head dims up to 64 the next task's while this one
// computes.  S = Q K^T by mma.sync m16n8k16 stays in fp32 registers,
// 16 x 144 = 72 a thread; logits = S * scale + mask, the task's mask values
// (L2-resident: shared memory leaves L1 28 KB) all requested into those
// registers before the products start, so their latency overlaps Q K^T;
// exponentials on the SFU (ex2.approx) with the log2 e factor folded into
// one FMA; the row max and sum over the quad; P = e / l rounded to bf16 goes
// from the accumulators into A fragments; O = P V with V by ldmatrix.trans;
// O stored as bf16x2.  O is formed in blocks of at most 64 columns, each
// stored before the next: at head dim 128 S (72), one O block (32) and Q
// (32) fit the registers where a whole O row (64) beside a prefetched Q
// would not.  Rows of more than 144 keys (window 16: 256) do not fit the
// registers: they run as two 128-key halves in FlashAttention's order (O
// rescaled when the max moves, P rounded unnormalised, O / l at the end),
// the dense kernel's trade; a second pass recomputing the logits to
// normalise P first took 1.8x SDPA's time there (PERF.md).  At head dim 128
// such a row runs the key halves once for each 64-column O block.
//
// Head dims 48 and 96 take the same tensor-core path (O in blocks of 48
// columns at 96); it wants rows 16-byte aligned and a multiple of 8 elements
// apart (cp.async), else the call takes a CUDA-core path below.
//
// Otherwise (fp32; bf16 at other head dims, at 4 heads of 128, whose K and
// V exceed the shared memory, or with rows off the 16-byte grid) CUDA
// cores, at any head dim (1 to 512 and beyond; the reference's lane-masked
// heads take any) and any row stride: one block per (window, head, 32
// query rows), nothing held per head dim.  Q and K come in 32 head-dim
// columns at a time as fp32 rows padded to 33 (conflict-free column
// reads); a warp's 4 rows of S (N <= 256 keys over the lanes, 8 a lane) sum
// in registers over the column chunks, d in order; scale, mask, the exact
// softmax (row max and sum over the warp) and P normalised, then rounded
// to T, in a shared row per query row; then O in 32-column chunks of V,
// each lane a column of the warp's 4 rows, keys in order (P read 4 keys at
// a time).  It replaced a kernel per head dim 8-128 that held a head's
// whole K and V in shared memory and a q row in registers: the same sums
// in the same order, bitwise equal; this one takes 0.6-0.9x its time but
// at 4 heads of 32 with a mask in fp32 (1.07x; PERF.md).
#include <cstdint>

#include "attn_common.cuh"
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 256;
constexpr int kMaxJ = kMaxN / 32;
constexpr int kMaxPairs = 9;   // 16-key column pairs of S a warp keeps in registers (144 keys)
// warps of a tensor-core block where three blocks' K and V fit an SM; 8 (two
// blocks, at most 128 registers a thread) were measured once and lost (PERF.md)
constexpr int kTcWarps = 4;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kAnyRows = 32;    // query rows of an any-head-dim block, 4 a warp
constexpr int kAnyCols = 32;    // head-dim columns of Q, K or V staged at a time
constexpr int kAnyLd = kAnyCols + 1;
static_assert(kAnyCols == 32, "a full chunk's row is e >> 5");

// any head dim D, any row strides: block (window, head, row block rb) forms
// output rows 32 rb .. 32 rb + 31 of the head
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_any_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            const float* __restrict__ mask, T* __restrict__ out, int N, int C, int D, int heads,
                            int nW, int ldq, int ldk, int ldv, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int NP = (N + 3) & ~3;             // P's row pitch: rows 16-byte aligned
  float* ps = sm;                          // (kAnyRows, NP): P
  float* qs = ps + kAnyRows * NP;          // (kAnyRows, kAnyLd): a Q column chunk
  float* cs = qs + kAnyRows * kAnyLd;      // (N, kAnyLd): a K, then a V, column chunk
  const int nrb = (N + kAnyRows - 1) / kAnyRows, rb = blockIdx.x % nrb;
  const size_t wh = blockIdx.x / nrb, win = wh / heads;
  const int h = wh % heads, r0 = rb * kAnyRows, nr = min(kAnyRows, N - r0);
  const T* qw = q + (win * N + r0) * ldq + (size_t)h * D;
  const T* kw = k + win * N * ldk + (size_t)h * D;
  const T* vw = v + win * N * ldv + (size_t)h * D;
  T* ow = out + (win * N + r0) * C + (size_t)h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // S = Q K^T for the warp's rows 4 warp .. 4 warp + 3, key lane + 32 jj
  float acc[4][kMaxJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) acc[i][jj] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kAnyCols) {
    const int dc = min(kAnyCols, D - d0);
    __syncthreads();   // the previous chunk is read
    for (int e = threadIdx.x; e < nr * dc; e += kThreads) {
      const int r = dc == kAnyCols ? e >> 5 : e / dc, d = e - r * dc;
      qs[r * kAnyLd + d] = to_f(qw[(size_t)r * ldq + d0 + d]);
    }
    for (int e = threadIdx.x; e < N * dc; e += kThreads) {
      const int n = dc == kAnyCols ? e >> 5 : e / dc, d = e - n * dc;
      cs[n * kAnyLd + d] = to_f(kw[(size_t)n * ldk + d0 + d]);
    }
    __syncthreads();
    for (int d = 0; d < dc; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * warp + i) * kAnyLd + d];
#pragma unroll
      for (int jj = 0; jj < kMaxJ; ++jj) {
        const int j = lane + 32 * jj;
        if (j < N) {
          const float kv = cs[j * kAnyLd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(qv[i], kv, acc[i][jj]);
        }
      }
    }
  }

  // logits, the exact softmax, P rounded to T into the row's shared P
  const float* mw = mask ? mask + (win % nW) * N * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * warp + i;
    if (r >= nr) continue;   // warp-uniform
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = lane + 32 * jj;
      float logit = -INFINITY;
      if (j < N) {
        logit = acc[i][jj] * scale;
        if (mw) logit += mw[(size_t)(r0 + r) * N + j];
      }
      acc[i][jj] = logit;
      mx = fmaxf(mx, logit);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const float e = lane + 32 * jj < N ? expf(acc[i][jj] - mx) : 0.f;
      acc[i][jj] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = lane + 32 * jj;
      if (j < N) ps[r * NP + j] = rnd<T>(acc[i][jj] / sum);
    }
  }

  // O = P V, 32 columns of V at a time, a lane a column
  for (int d0 = 0; d0 < D; d0 += kAnyCols) {
    const int dc = min(kAnyCols, D - d0);
    __syncthreads();   // K (or the previous V chunk) is read, P is written
    for (int e = threadIdx.x; e < N * dc; e += kThreads) {
      const int n = dc == kAnyCols ? e >> 5 : e / dc, d = e - n * dc;
      cs[n * kAnyLd + d] = to_f(vw[(size_t)n * ldv + d0 + d]);
    }
    __syncthreads();
    if (lane < dc) {
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      const float* p = ps + 4 * warp * NP;
      int j = 0;
      for (; j + 4 <= N; j += 4) {   // 4 keys of the 4 rows' P at a time, keys in order
        const float v0 = cs[j * kAnyLd + lane], v1 = cs[(j + 1) * kAnyLd + lane];
        const float v2 = cs[(j + 2) * kAnyLd + lane], v3 = cs[(j + 3) * kAnyLd + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 pp = *reinterpret_cast<const float4*>(p + i * NP + j);
          o[i] = fmaf(pp.w, v3, fmaf(pp.z, v2, fmaf(pp.y, v1, fmaf(pp.x, v0, o[i]))));
        }
      }
      for (; j < N; ++j) {
        const float vv = cs[j * kAnyLd + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = fmaf(p[i * NP + j], vv, o[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * warp + i < nr) ow[(size_t)(4 * warp + i) * C + d0 + lane] = from_f<T>(o[i]);
    }
  }
}

// K / V tile layout of the tensor-core kernel: rows of C bf16 in 16-byte
// chunks, XOR-swizzled where a row holds a multiple of 8 chunks, else one
// chunk of padding (either way 8 rows at one chunk hit 8 distinct banks)
struct TileLayout {
  int ldc, swm;   // row stride in chunks, swizzle mask
  __host__ __device__ explicit TileLayout(int C) : ldc((C / 8) % 8 ? C / 8 + 1 : C / 8), swm((C / 8) % 8 ? 0 : 7) {}
  __device__ __forceinline__ int at(int row, int chunk) const { return row * ldc * 8 + ((chunk ^ (row & swm)) << 3); }
};

__device__ __forceinline__ unsigned ld32(const bf16* p) { return __ldg(reinterpret_cast<const unsigned*>(p)); }

// the A fragments of 16 query rows (row0..row0+15) of one head, from device memory
template <int D>
__device__ __forceinline__ void load_q(unsigned (&qa)[D / 16][4], const bf16* qh, int ldq, int row0, int g,
                                       int t4) {
  const bf16* p0 = qh + (size_t)(row0 + g) * ldq + 2 * t4;
  const bf16* p1 = p0 + (size_t)8 * ldq;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = ld32(p0 + 16 * kk);
    qa[kk][1] = ld32(p1 + 16 * kk);
    qa[kk][2] = ld32(p0 + 16 * kk + 8);
    qa[kk][3] = ld32(p1 + 16 * kk + 8);
  }
}

// logits of keys 16 p0 .. 16 (p0 + np) - 1 for rows g, g + 8 of a task:
// S = Q K^T (fp32), times scale, plus the mask rows m0 / m1 (or nothing).
// The mask values (L2-resident, not L1: shared memory takes the SM) are all
// requested first, into s itself, so their latency overlaps the products.
template <int D>
__device__ __forceinline__ void logits(float (&s)[2 * kMaxPairs][4], const unsigned (&qa)[D / 16][4],
                                       const bf16* ks, const TileLayout& L, int hc, int p0, int np,
                                       const float* m0, const float* m1, float scale, int lane) {
  const int mi = lane >> 3, mr = lane & 7, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * kMaxPairs; ++j) {
    if (j < 2 * np) {
      float2 a = make_float2(0.f, 0.f), b = a;
      if (m0) {
        const int key = 16 * p0 + 8 * j + 2 * t4;
        a = __ldg(reinterpret_cast<const float2*>(m0 + key));
        b = __ldg(reinterpret_cast<const float2*>(m1 + key));
      }
      s[j][0] = a.x;
      s[j][1] = a.y;
      s[j][2] = b.x;
      s[j][3] = b.y;
    }
  }
#pragma unroll
  for (int jp = 0; jp < kMaxPairs; ++jp) {
    if (jp < np) {
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned b[4];
        ldmatrix_x4(b, ks + L.at(16 * (p0 + jp) + mr + (mi >> 1) * 8, hc + 2 * kk + (mi & 1)));
        mma_bf16(acc[0], qa[kk], b[0], b[1]);
        mma_bf16(acc[1], qa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[2 * jp][e] = m0 ? acc[0][e] * scale + s[2 * jp][e] : acc[0][e] * scale;
        s[2 * jp + 1][e] = m0 ? acc[1][e] * scale + s[2 * jp + 1][e] : acc[1][e] * scale;
      }
    }
  }
}

// O += P V over keys 16 p0 .. 16 (p0 + np) - 1 for the OW columns from
// 16-byte chunk hc, P = e (rows g, g + 8 times f0, f1) rounded to bf16 from
// the accumulators straight into A fragments
template <int OW>
__device__ __forceinline__ void pv(float (&o)[OW / 8][4], const float (&s)[2 * kMaxPairs][4], int p0, int np,
                                   float f0, float f1, const bf16* vs, const TileLayout& L, int hc, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kMaxPairs; ++kk) {
    if (kk < np) {
      const float lo[4] = {s[2 * kk][0] * f0, s[2 * kk][1] * f0, s[2 * kk][2] * f1, s[2 * kk][3] * f1};
      const float hi[4] = {s[2 * kk + 1][0] * f0, s[2 * kk + 1][1] * f0, s[2 * kk + 1][2] * f1,
                           s[2 * kk + 1][3] * f1};
      unsigned pa[4];
      c_to_a(pa, lo, hi);
#pragma unroll
      for (int dp = 0; dp < OW / 16; ++dp) {
        unsigned b[4];
        ldmatrix_x4_trans(b, vs + L.at(16 * (p0 + kk) + mr + (mi & 1) * 8, hc + 2 * dp + (mi >> 1)));
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }
}

// bf16 on tensor cores; N % 16 == 0, one block per window, blockDim a multiple of 32
template <int D>
__global__ void __launch_bounds__(kThreads)
window_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const float* __restrict__ mask, bf16* __restrict__ out, int N, int C, int heads,
                           int nW, int ldq, int ldk, int ldv, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TileLayout L(C);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)N * L.ldc * 8;
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid >> 5, nwarps = nthreads >> 5;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
  const size_t win = blockIdx.x;
  const bf16* qw = q + win * N * ldq;
  const bf16* kw = k + win * N * ldk;
  const bf16* vw = v + win * N * ldv;
  bf16* ow = out + win * N * C;
  const int CH = C / 8;
  for (int e = tid; e < N * CH; e += nthreads) {
    const int r = e / CH, c = e - r * CH;
    cp_async16(ks + L.at(r, c), kw + (size_t)r * ldk + c * 8);
    cp_async16(vs + L.at(r, c), vw + (size_t)r * ldv + c * 8);
  }
  cp_async_commit();

  const int npairs = N / 16, tasks = npairs * heads;
  const int per = (tasks + nwarps - 1) / nwarps;
  const int first = warp * per, last = min(tasks, first + per);
  const int nchunk = (npairs + kMaxPairs - 1) / kMaxPairs;
  const int cpairs = (npairs + nchunk - 1) / nchunk;   // pairs per chunk, the last may hold fewer
  const float* mw = mask ? mask + (win % nW) * N * N : nullptr;

  // at head dim 128 Q is loaded at the start of its task: a prefetched
  // second copy would not fit beside S and the O block
  constexpr bool kPrefetch = D <= 64;
  constexpr int OW = D <= 64 ? D : D % 64 ? D / 2 : 64;   // columns of an O block (48 at D = 96)
  unsigned qa[D / 16][4], qn[D / 16][4];
  if (kPrefetch && first < last) load_q<D>(qn, qw + (first % heads) * D, ldq, (first / heads) * 16, g, t4);
  cp_async_wait<0>();
  __syncthreads();

  for (int task = first; task < last; ++task) {
    const int rb = task / heads, h = task - rb * heads, hc = h * D / 8;
    if constexpr (kPrefetch) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[kk][e] = qn[kk][e];
      if (task + 1 < last) load_q<D>(qn, qw + ((task + 1) % heads) * D, ldq, ((task + 1) / heads) * 16, g, t4);
    } else {
      load_q<D>(qa, qw + h * D, ldq, rb * 16, g, t4);
    }
    const float* m0 = mw ? mw + (size_t)(rb * 16 + g) * N : nullptr;
    const float* m1 = mw ? m0 + (size_t)8 * N : nullptr;
    bf16* o0 = ow + (size_t)(rb * 16 + g) * C + h * D + 2 * t4;
    bf16* o1 = o0 + (size_t)8 * C;

    // one pass over the key chunks: logits, the running row max and sum.  A
    // row in one chunk (N <= 144) is normalised before P is rounded, the
    // reference's order; a longer row takes FlashAttention's, chunk by
    // chunk: O rescaled as the max moves, P = e rounded unnormalised, O / l
    // at the end.  O is formed one block of OW columns at a time: a row in
    // one chunk keeps its P for every block, a longer one runs its chunks
    // again
    float s[2 * kMaxPairs][4];
    float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int ob = 0; ob < D / OW; ++ob) {
      const int oc = hc + ob * OW / 8;
      float o[OW / 8][4];
#pragma unroll
      for (int j = 0; j < OW / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
      if (ob == 0 || nchunk > 1) {
        mx0 = mx1 = -INFINITY;
        l0 = l1 = 0.f;
        for (int c = 0; c < nchunk; ++c) {
          const int p0 = c * cpairs, np = min(cpairs, npairs - p0);
          logits<D>(s, qa, ks, L, hc, p0, np, m0, m1, scale, lane);
          float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
          for (int j = 0; j < 2 * kMaxPairs; ++j) {
            if (j < 2 * np) {
              t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
              t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
            }
          }
          // row maxima in log2 units: e = 2^(logit log2e - max log2e)
          const float n0 = fmaxf(mx0, quad_max(t0) * kLog2e), n1 = fmaxf(mx1, quad_max(t1) * kLog2e);
          const float c0 = fast_exp2(mx0 - n0), c1 = fast_exp2(mx1 - n1);
          l0 *= c0;
          l1 *= c1;
          mx0 = n0;
          mx1 = n1;
#pragma unroll
          for (int j = 0; j < 2 * kMaxPairs; ++j) {
            if (j < 2 * np) {
              s[j][0] = fast_exp2(fmaf(s[j][0], kLog2e, -mx0));
              s[j][1] = fast_exp2(fmaf(s[j][1], kLog2e, -mx0));
              s[j][2] = fast_exp2(fmaf(s[j][2], kLog2e, -mx1));
              s[j][3] = fast_exp2(fmaf(s[j][3], kLog2e, -mx1));
              l0 += s[j][0] + s[j][1];
              l1 += s[j][2] + s[j][3];
            }
          }
          if (nchunk > 1) {
#pragma unroll
            for (int j = 0; j < OW / 8; ++j) {
              o[j][0] *= c0;
              o[j][1] *= c0;
              o[j][2] *= c1;
              o[j][3] *= c1;
            }
            pv<OW>(o, s, p0, np, 1.f, 1.f, vs, L, oc, lane);
          }
        }
      }
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
      if (nchunk == 1) {
        pv<OW>(o, s, 0, npairs, inv0, inv1, vs, L, oc, lane);
      } else {
#pragma unroll
        for (int j = 0; j < OW / 8; ++j) {
          o[j][0] *= inv0;
          o[j][1] *= inv0;
          o[j][2] *= inv1;
          o[j][3] *= inv1;
        }
      }
#pragma unroll
      for (int j = 0; j < OW / 8; ++j) {
        *reinterpret_cast<unsigned*>(o0 + ob * OW + 8 * j) = pack_bf16(o[j][0], o[j][1]);
        *reinterpret_cast<unsigned*>(o1 + ob * OW + 8 * j) = pack_bf16(o[j][2], o[j][3]);
      }
    }
  }
}

size_t tc_smem(int N, int C) { return (size_t)2 * N * TileLayout(C).ldc * 16; }

// the current device's opt-in shared memory a block (0 if unreadable)
size_t smem_optin() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return (size_t)limit;
}

// whether bf16 at this geometry takes the tensor-core kernel: N % 16 == 0,
// head dim 16 / 32 / 48 / 64 / 96 / 128 and K, V within the device's opt-in
// shared memory
bool tc_path(int N, int C, int heads, int is_bf16) {
  if (!is_bf16 || N % 16 || C % heads) return false;
  const int D = C / heads;
  if (D != 16 && D != 32 && D != 48 && D != 64 && D != 96 && D != 128) return false;
  return tc_smem(N, C) <= smem_optin();
}

// whether the rows are laid out as the tensor-core kernel reads them: 16-byte
// aligned starts, strides a multiple of 8 elements (cp.async of 16 bytes)
bool tc_layout(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv) {
  const auto a = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  return a % 16 == 0 && ldq % 8 == 0 && ldk % 8 == 0 && ldv % 8 == 0;
}

template <int D>
int run_tc(const void* q, const void* k, const void* v, const void* mask, void* out, int Bw, int N, int C,
           int heads, int nW, int ldq, int ldk, int ldv, float scale, cudaStream_t st) {
  const size_t smem = tc_smem(N, C);
  // kTcWarps where three blocks share an SM's 228 KB (1 KB reserved each),
  // else 8 warps and one block
  const int threads = 3 * (smem + 1024) <= 228 * 1024 ? kTcWarps * 32 : kThreads;
  cudaError_t e = cudaFuncSetAttribute(window_attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(window_attention_tc_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  window_attention_tc_kernel<D><<<Bw, threads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<bf16*>(out), N, C, heads, nW, ldq, ldk, ldv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int run_any(const void* q, const void* k, const void* v, const void* mask, void* out, int Bw, int N, int C,
            int heads, int nW, int ldq, int ldk, int ldv, float scale, cudaStream_t st) {
  const size_t smem = (size_t)(kAnyRows * ((N + 3) & ~3) + kAnyRows * kAnyLd + N * kAnyLd) * sizeof(float);
  const int nrb = (N + kAnyRows - 1) / kAnyRows;
  cudaError_t e = cudaFuncSetAttribute(window_attention_any_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  window_attention_any_kernel<T><<<(unsigned)((size_t)Bw * heads * nrb), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out), N, C, C / heads, heads, nW, ldq, ldk, ldv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int catseg_window_attention_tensor_cores(int N, int C, int heads, int is_bf16) {
  return tc_path(N, C, heads, is_bf16) ? 1 : 0;
}

// Takes N <= 256 tokens per window, any width, any head dim and any row
// strides ldq, ldk, ldv >= C; mask null or (nW, N, N).  Head dims 16-128 of
// the tensor-core list with rows as tc_layout reads them run on the tensor
// cores (bf16), everything else on the CUDA-core kernel.
extern "C" int catseg_window_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                                       int Bw, int N, int C, int heads, int nW, int ldq, int ldk, int ldv,
                                       float scale, int is_bf16, void* stream) {
  if (Bw <= 0 || N <= 0 || N > kMaxN || heads <= 0 || C % heads || nW <= 0 || Bw % nW)
    return (int)cudaErrorInvalidValue;
  if (ldq < C || ldk < C || ldv < C) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (tc_path(N, C, heads, is_bf16) && tc_layout(q, k, v, ldq, ldk, ldv)) {
    switch (C / heads) {
      case 16: return run_tc<16>(q, k, v, mask, out, Bw, N, C, heads, nW, ldq, ldk, ldv, scale, st);
      case 32: return run_tc<32>(q, k, v, mask, out, Bw, N, C, heads, nW, ldq, ldk, ldv, scale, st);
      case 48: return run_tc<48>(q, k, v, mask, out, Bw, N, C, heads, nW, ldq, ldk, ldv, scale, st);
      case 64: return run_tc<64>(q, k, v, mask, out, Bw, N, C, heads, nW, ldq, ldk, ldv, scale, st);
      case 96: return run_tc<96>(q, k, v, mask, out, Bw, N, C, heads, nW, ldq, ldk, ldv, scale, st);
      default: return run_tc<128>(q, k, v, mask, out, Bw, N, C, heads, nW, ldq, ldk, ldv, scale, st);
    }
  }
  if (is_bf16) return run_any<bf16>(q, k, v, mask, out, Bw, N, C, heads, nW, ldq, ldk, ldv, scale, st);
  return run_any<float>(q, k, v, mask, out, Bw, N, C, heads, nW, ldq, ldk, ldv, scale, st);
}
