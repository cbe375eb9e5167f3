// One Swin block of the aggregator's spatial stage, one CTA per
// (window, class, image).
//
// Replaces catseg_tpu/kernels/swin_block.py:fused_swin_pair (_kernel via
// _pallas_pair); the pair is two launches, shift 0 then shift win/2.
// x, out: (B, T, H, W, 128) class-major slabs; qg, kg: (B, H, W, 128) per-image
// guidance halves of the q/k projections (or null).  Weights: qkv_w (128,
// 384), proj_w (128, 128), fc1_w (128, 512), fc2_w (512, 128), in (in, out)
// layout as fp32 for the fp32 kernel, packed in mma fragment order
// (kernels/swin_block.py pack_mma_b) as bf16 for the bf16 one.  Biases and
// LayerNorm parameters are fp32.
//
// Every stage but attention is per token, so a whole block is independent
// per window: the CTA gathers its 144 tokens once (the cyclic roll is folded
// into the gather/scatter indices, so no rolled copy exists), runs LN1 ->
// qkv (+ guidance) -> 4-head window attention (shifted windows add -100
// between regions, computed from index math) -> proj -> residual -> LN2 ->
// GELU MLP -> residual, and scatters the tokens back once: the activation
// crosses device memory once a block.
//
// bf16 (the serving dtype) takes the reference's fast forms and rounding
// points: single-pass LN variance; q and k rounded after the bias, then
// after the guidance add; softmax exp(min(s scale + mask, 60)) with no max
// pass, on the SFU as 2^(y log2 e), normalised by one reciprocal a row; P
// rounded before P v; the proj and fc2 results rounded before their
// residual adds; tanh GELU.  tests/test_torch_attention_order.py holds that
// order to the reference on the CPU.  fp32 takes exact erf GELU, two-pass LN
// and a max-subtracted softmax, with CUDA-core FMAs (one thread per query in
// attention), so that fp32 stays the oracle-parity path.
//
// Bound on the card: tensor-core operations in bf16 (67 MFLOP a window,
// 806.9 GFLOP a pair at the serving slab: 0.82 ms), but a window's work is
// small and serial (LN -> qkv -> attention -> proj -> LN -> MLP), so what
// sets the time is latency inside and between its phases.  The bf16 design
// (its note below) keeps every operand on chip: the window's x, LN output,
// q/k/v of all heads and the MLP's hidden chunk in shared memory, each
// attention logit strip in registers, weights streamed from L2 in fragment
// order straight into registers; 12 barriers a block.  Per-phase clocks
// (tools/swin_phases.py, PERF.md) put every product phase at 3-7x its
// tensor-core cycles, fc1 with its tanh-GELU epilogue at a third of a
// CTA's time and the two LayerNorms at a tenth; weights read from L1
// instead of L2 save 7-8% of the launch, the most a cp.async weight ring
// in shared memory could recover.  The fp32 kernel: one 8-warp CTA per SM
// (~200 KB of shared memory), weights from L2 on CUDA cores.
#include "attn_common.cuh"
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kC = 128, kHeads = 4, kD = 32, kWin = 12, kN = kWin * kWin;
constexpr int kHid = 512, kHC = 64, kDP = kD + 1, kThreads = 256, kWarps = kThreads / 32;
constexpr float kScale = 0.17677669529663687f;  // 32 ** -0.5
static_assert(kN % 16 == 0, "attention walks keys in groups of 4; mma tiles are 16 rows");
// fp32 kernel: Y, O (N, C) fp32 + per-head q/k/v + token indices
constexpr size_t kSmem = (size_t)(2 * kN * kC + 3 * kN * kDP) * sizeof(float) + 2 * kN * sizeof(int);
struct SwinParams {
  const float *ln1_g, *ln1_b, *qkv_w, *qkv_b, *proj_w, *proj_b;
  const float *ln2_g, *ln2_b, *fc1_w, *fc1_b, *fc2_w, *fc2_b;
};

__device__ __forceinline__ float gelu_fast(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_exact(float x) { return 0.5f * x * (1.f + erff(x * 0.7071067811865476f)); }

__device__ __forceinline__ int region(int i, int size, int shift) {
  return i < size - kWin ? 0 : (i < size - shift ? 1 : 2);
}

// Token gather indices (roll folded in) and shift-mask region ids of this
// CTA's window.
__device__ __forceinline__ void window_tokens(int* src, int* reg, int H, int W, int shift) {
  const int nWw = W / kWin;
  const int wi = blockIdx.x / nWw, wj = blockIdx.x % nWw;
  for (int n = threadIdx.x; n < kN; n += blockDim.x) {
    const int ri = wi * kWin + n / kWin, rj = wj * kWin + n % kWin;  // rolled-grid coords
    src[n] = ((ri + shift) % H) * W + (rj + shift) % W;
    reg[n] = shift > 0 ? region(ri, H, shift) * 3 + region(rj, W, shift) : 0;
  }
}

// One head of fp32 window attention, one thread per query, max-subtracted
// softmax; put(n, d, value) stores the output.
template <typename Put>
__device__ __forceinline__ void attend_head(const float* Qh, const float* Kh, const float* Vh,
                                            const int* reg, Put put) {
  for (int n = threadIdx.x; n < kN; n += blockDim.x) {
    float qr[kD], acc[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      qr[d] = Qh[n * kDP + d];
      acc[d] = 0.f;
    }
    const int rn = reg[n];
    // logits of keys j..j+3: four independent dot chains per thread
    auto logit4 = [&](int j, float (&s)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] = fmaf(qr[d], Kh[(j + u) * kDP + d], s[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] = s[u] * kScale + (reg[j + u] != rn ? -100.f : 0.f);
    };
    float s[4];
    float mx = -INFINITY;
    for (int j = 0; j < kN; j += 4) {
      logit4(j, s);
#pragma unroll
      for (int u = 0; u < 4; ++u) mx = fmaxf(mx, s[u]);
    }
    float sum = 0.f;
    for (int j = 0; j < kN; j += 4) {
      logit4(j, s);
#pragma unroll
      for (int u = 0; u < 4; ++u) sum += expf(s[u] - mx);
    }
    for (int j = 0; j < kN; j += 4) {
      logit4(j, s);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float pj = expf(s[u] - mx) / sum;
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[d] = fmaf(pj, Vh[(j + u) * kDP + d], acc[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < kD; ++d) put(n, d, acc[d]);
  }
}

// fp32 block: CUDA-core FMA products (mm_rows).
__global__ void __launch_bounds__(kThreads, 1)
swin_block_kernel(const float* x, float* out, const float* qg, const float* kg, SwinParams p, int nT,
                  int H, int W, int shift, int has_guid) {
  using T = float;
  extern __shared__ float sm[];
  float* Y = sm;               // (N, C): LN1 out, then x2, then MLP accumulator
  float* O = Y + kN * kC;      // (N, C): attention out, then LN2 out
  float* R = O + kN * kC;      // 3 x (N, DP) per-head q/k/v, then (N, HC) hidden chunk
  int* src = reinterpret_cast<int*>(R + 3 * kN * kDP);  // grid index of each window token
  int* reg = src + kN;                                   // shift-mask region id

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t slab = ((size_t)blockIdx.z * nT + blockIdx.y) * H * W * kC;
  const T* xs = x + slab;
  T* os = out + slab;
  const size_t gbase = (size_t)blockIdx.z * H * W * kC;

  window_tokens(src, reg, H, W, shift);
  __syncthreads();
  for (int n = warp; n < kN; n += kWarps) {
    const T* row = xs + (size_t)src[n] * kC;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = row[lane + 32 * i];
    ln_row128<T>(v, p.ln1_g, p.ln1_b, Y + n * kC, lane);
  }
  __syncthreads();

  float* Qh = R;
  float* Kh = R + kN * kDP;
  float* Vh = Kh + kN * kDP;
  for (int h = 0; h < kHeads; ++h) {
    const int hq = h * kD, hk = kC + h * kD, hv = 2 * kC + h * kD;
    mm_rows<8>(Y, kC, p.qkv_w + hq, 3 * kC, kN, kD, kC, [&](int r, int c, float acc) {
      float q = acc + p.qkv_b[hq + c];
      if (has_guid) q += qg[gbase + (size_t)src[r] * kC + hq + c];
      Qh[r * kDP + c] = q;
    });
    mm_rows<8>(Y, kC, p.qkv_w + hk, 3 * kC, kN, kD, kC, [&](int r, int c, float acc) {
      float k = acc + p.qkv_b[hk + c];
      if (has_guid) k += kg[gbase + (size_t)src[r] * kC + hq + c];
      Kh[r * kDP + c] = k;
    });
    mm_rows<8>(Y, kC, p.qkv_w + hv, 3 * kC, kN, kD, kC,
               [&](int r, int c, float acc) { Vh[r * kDP + c] = acc + p.qkv_b[hv + c]; });
    __syncthreads();
    attend_head(Qh, Kh, Vh, reg, [&](int n, int d, float v) { O[n * kC + hq + d] = v; });
    __syncthreads();
  }

  // out-proj + residual: x2 goes to Y and, as the final residual, to out
  mm_rows<8>(O, kC, p.proj_w, kC, kN, kC, kC, [&](int r, int c, float acc) {
    const size_t gi = (size_t)src[r] * kC + c;
    const float x2 = xs[gi] + (acc + p.proj_b[c]);
    Y[r * kC + c] = x2;
    os[gi] = x2;
  });
  __syncthreads();
  for (int n = warp; n < kN; n += kWarps) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = Y[n * kC + lane + 32 * i];
    ln_row128<T>(v, p.ln2_g, p.ln2_b, O + n * kC, lane);
  }
  __syncthreads();
  for (int i = tid; i < kN * kC; i += blockDim.x) Y[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < kHid; c0 += kHC) {
    mm_rows<8>(O, kC, p.fc1_w + c0, kHid, kN, kHC, kC,
               [&](int r, int c, float acc) { R[r * kHC + c] = gelu_exact(acc + p.fc1_b[c0 + c]); });
    __syncthreads();
    mm_rows<8>(R, kHC, p.fc2_w + (size_t)c0 * kC, kC, kN, kC, kHC,
               [&](int r, int c, float acc) { Y[r * kC + c] += acc; });
    __syncthreads();
  }
  for (int i = tid; i < kN * kC; i += blockDim.x) {
    const int r = i / kC, c = i % kC;
    const size_t gi = (size_t)src[r] * kC + c;
    os[gi] = os[gi] + (Y[i] + p.fc2_b[c]);
  }
}

// ---- bf16 block on the tensor cores: one 12-warp CTA per window ----
//
// Shared memory holds five (N, C) bf16 tiles, rows of sixteen 16-byte chunks
// XOR-swizzled by the row's low 3 bits (ldmatrix's 8 row addresses at one
// chunk index hit 8 distinct bank groups):
//   Xs  x, gathered once; then x2 = x + attn; then the block's output
//   Ys  LN1 out, then LN2 out
//   Qs  q of all heads (guidance staged there first), then the attention out
//   Ks, Vs  k and v of all heads (guidance staged in Ks); then, together,
//       the MLP's (N, 256) hidden chunk
// and the token indices: 185 KB, one CTA (12 warps) a SM.  Every phase
// splits evenly over the 12 warps: qkv 24 16-column blocks over all 144
// rows, attention 36 (16-row strip, head) tasks, proj / fc1 / fc2 (16-column
// block, 48-row third) tasks.  Weights come packed in mma fragment order
// (kernels/swin_block.py pack_mma_b): a warp's B fragments for 32 rows of K
// are one 512-byte read from L2 straight into registers, each weight element
// read once a CTA; A fragments come from the tiles by ldmatrix.
constexpr int kTcWarps = 12, kTcThreads = kTcWarps * 32;
constexpr int kStrips = kN / 16;     // 9 strips of 16 tokens
constexpr int kTile = kN * kC;       // elements of one (N, C) tile
constexpr int kHidChunk = 256;       // MLP hidden columns a pass, in the K and V tiles' space
constexpr size_t kSmemTC = 5 * (size_t)kTile * sizeof(bf16) + kN * sizeof(int) + kN;
static_assert(2 * kTile == kN * kHidChunk, "the hidden chunk fills the K and V tiles");

// Timing builds (tools/swin_phases.py; never the library the port loads):
// CATSEG_SWIN_PHASE_CLOCKS makes thread 0 of every CTA add the clock64
// cycles between the kernel's barriers to g_phase_cycles, one slot a phase
// (gather, LN1, qkv, attention, proj, LN2, fc1, fc2 products, fc2 epilogue,
// scatter) and the CTA count in the last; CATSEG_SWIN_WEIGHTS_FROM_L1
// (timing only, wrong results) reads every B fragment from 8 KB of each
// weight matrix that stays in L1, the floor of what faster weight delivery
// could give.
#ifdef CATSEG_SWIN_PHASE_CLOCKS
constexpr int kPhases = 10;
__device__ unsigned long long g_phase_cycles[kPhases + 1];
#define SWIN_PHASE(i)                                                                     \
  do {                                                                                    \
    if (threadIdx.x == 0) {                                                               \
      const long long now = clock64();                                                    \
      atomicAdd(&g_phase_cycles[i], (unsigned long long)(now - t_phase));                 \
      t_phase = now;                                                                      \
    }                                                                                     \
  } while (0)
#else
#define SWIN_PHASE(i) \
  do {                \
  } while (0)
#endif

struct SwinParamsTC {
  const float *ln1_g, *ln1_b;
  const uint4* qkv_w;   // packed (pack_mma_b) bf16 weights
  const float* qkv_b;
  const uint4* proj_w;
  const float *proj_b, *ln2_g, *ln2_b;
  const uint4* fc1_w;
  const float* fc1_b;
  const uint4* fc2_w;
  const float* fc2_b;
};

// acc[i][j] += A (strips s0 + i, k-steps 0 .. 2 KP - 1) x W (n8 tiles j0 + j,
// k-pairs p0 ..).  W in fragment order: the 16 bytes of lane l at (n8 tile j,
// k-pair p) are its b0, b1 of k-steps 2p and 2p + 1, at index (j kp + p) 32 + l.
template <int RC, int MS, int NT, int KP>
__device__ __forceinline__ void gemm(float (&acc)[MS][NT][4], const bf16* A, int s0, const uint4* __restrict__ W,
                                     int kp, int j0, int p0, int lane) {
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    uint4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#ifdef CATSEG_SWIN_WEIGHTS_FROM_L1
      b[j] = __ldg(W + ((((j0 + j) << 3) + p0 + p) & 15) * 32 + lane);
#else
      b[j] = __ldg(W + ((size_t)(j0 + j) * kp + p0 + p) * 32 + lane);
#endif
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < MS; ++i) {
        unsigned a[4];
        load_a<RC>(a, A, s0 + i, 2 * p + h, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, h ? b[j].z : b[j].x, h ? b[j].w : b[j].y);
      }
    }
  }
}

// epi(row, col, v0, v1) for each accumulator pair: rows 16 (s0 + i) + g and
// + 8, columns 8 (j0 + j) + 2t and + 1
template <int MS, int NT, typename Epi>
__device__ __forceinline__ void each_pair(const float (&acc)[MS][NT][4], int s0, int j0, int lane, Epi epi) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MS; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = 16 * (s0 + i) + g, c = 8 * (j0 + j) + 2 * t;
      epi(r, c, acc[i][j][0], acc[i][j][1]);
      epi(r + 8, c, acc[i][j][2], acc[i][j][3]);
    }
}

// LayerNorm (single-pass variance, fp32 statistics) of every row of X into
// Y, a warp a row, columns 4 lane .. 4 lane + 3 in each lane
__device__ __forceinline__ void ln_rows(bf16* X, bf16* Y, const float* g, const float* b, int warp, int lane) {
  const float4 gv = __ldg(reinterpret_cast<const float4*>(g) + lane);
  const float4 bv = __ldg(reinterpret_cast<const float4*>(b) + lane);
  for (int r = warp; r < kN; r += kTcWarps) {
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

// one (16-row strip m, head h) task: S = q k^T for all 144 keys in fp32
// registers (72 a thread), e = exp(min(S scale + mask, 60)) on the SFU, P =
// e / sum rounded to bf16 from the accumulators into A fragments, O = P v
// (v by ldmatrix.trans), O rounded into the strip's q columns of the head
__device__ __forceinline__ void attend(bf16* Qs, const bf16* Ks, const bf16* Vs, const unsigned char* reg, int m,
                                       int h, bool masked, int lane) {
  const int g = lane >> 2, t = lane & 3;
  unsigned qa[2][4];
  load_a<16>(qa[0], Qs, m, 2 * h, lane);
  load_a<16>(qa[1], Qs, m, 2 * h + 1, lane);
  float s[2 * kStrips][4];
#pragma unroll
  for (int kt = 0; kt < kStrips; ++kt) {
    float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      unsigned b[4];
      ldmatrix_x4(b, Ks + sw<16>(16 * kt + (lane & 7) + (lane >> 4) * 8, 4 * h + 2 * kk + ((lane >> 3) & 1)));
      mma_bf16(a0, qa[kk], b[0], b[1]);
      mma_bf16(a1, qa[kk], b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[2 * kt][e] = a0[e];
      s[2 * kt + 1][e] = a1[e];
    }
  }
  const int r0 = masked ? reg[16 * m + g] : 0, r1 = masked ? reg[16 * m + g + 8] : 0;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * kStrips; ++j) {
    float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f;
    if (masked) {
      const int k0 = reg[8 * j + 2 * t], k1 = reg[8 * j + 2 * t + 1];
      m0 = k0 != r0 ? -100.f : 0.f;
      m1 = k1 != r0 ? -100.f : 0.f;
      m2 = k0 != r1 ? -100.f : 0.f;
      m3 = k1 != r1 ? -100.f : 0.f;
    }
    s[j][0] = fast_exp2(fminf(fmaf(s[j][0], kScale, m0), 60.f) * kLog2e);
    s[j][1] = fast_exp2(fminf(fmaf(s[j][1], kScale, m1), 60.f) * kLog2e);
    s[j][2] = fast_exp2(fminf(fmaf(s[j][2], kScale, m2), 60.f) * kLog2e);
    s[j][3] = fast_exp2(fminf(fmaf(s[j][3], kScale, m3), 60.f) * kLog2e);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
  float o[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < kStrips; ++kt) {
    const float lo[4] = {s[2 * kt][0] * i0, s[2 * kt][1] * i0, s[2 * kt][2] * i1, s[2 * kt][3] * i1};
    const float hi[4] = {s[2 * kt + 1][0] * i0, s[2 * kt + 1][1] * i0, s[2 * kt + 1][2] * i1,
                         s[2 * kt + 1][3] * i1};
    unsigned pa[4];
    c_to_a(pa, lo, hi);
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, Vs + sw<16>(16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8, 4 * h + 2 * dp + (lane >> 4)));
      mma_bf16(o[2 * dp], pa, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = 32 * h + 8 * nt + 2 * t;
    store_bf16x2(at<16>(Qs, 16 * m + g, c), o[nt][0], o[nt][1]);
    store_bf16x2(at<16>(Qs, 16 * m + g + 8, c), o[nt][2], o[nt][3]);
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
swin_block_tc_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, const bf16* __restrict__ qg,
                     const bf16* __restrict__ kg, SwinParamsTC p, int nT, int H, int W, int shift, int has_guid) {
  extern __shared__ __align__(128) unsigned char smraw[];
  bf16* Xs = reinterpret_cast<bf16*>(smraw);
  bf16* Ys = Xs + kTile;
  bf16* Qs = Ys + kTile;
  bf16* Ks = Qs + kTile;
  bf16* Vs = Ks + kTile;
  bf16* Hs = Ks;   // (N, kHidChunk) hidden chunk over the K and V tiles
  int* src = reinterpret_cast<int*>(Vs + kTile);
  unsigned char* reg = reinterpret_cast<unsigned char*>(src + kN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#ifdef CATSEG_SWIN_PHASE_CLOCKS
  long long t_phase = clock64();
#endif
  const size_t slab = ((size_t)blockIdx.z * nT + blockIdx.y) * H * W * kC;
  const bf16* xs = x + slab;
  bf16* os = out + slab;
  const size_t gbase = (size_t)blockIdx.z * H * W * kC;

  // token indices (roll folded in) and region ids, then one gather of the
  // window's x rows (and guidance rows) by cp.async
  {
    const int nWw = W / kWin, wi = blockIdx.x / nWw, wj = blockIdx.x % nWw;
    for (int n = tid; n < kN; n += kTcThreads) {
      const int ri = wi * kWin + n / kWin, rj = wj * kWin + n % kWin;
      src[n] = ((ri + shift) % H) * W + (rj + shift) % W;
      reg[n] = shift > 0 ? region(ri, H, shift) * 3 + region(rj, W, shift) : 0;
    }
  }
  __syncthreads();
  for (int e = tid; e < kN * 16; e += kTcThreads) {
    const int r = e >> 4, c = e & 15;
    const size_t gi = (size_t)src[r] * kC + c * 8;
    cp_async16(Xs + sw<16>(r, c), xs + gi);
    if (has_guid) {
      cp_async16(Qs + sw<16>(r, c), qg + gbase + gi);
      cp_async16(Ks + sw<16>(r, c), kg + gbase + gi);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  SWIN_PHASE(0);
  ln_rows(Xs, Ys, p.ln1_g, p.ln1_b, warp, lane);
  __syncthreads();
  SWIN_PHASE(1);

  // q | k | v of all heads in one pass over Ys: 24 16-column blocks of all
  // 144 rows; bias, rounding and guidance on the accumulators
  for (int cb = warp; cb < 3 * kC / 16; cb += kTcWarps) {
    float acc[kStrips][2][4];
    zero(acc);
    gemm<16, kStrips, 2, kC / 32>(acc, Ys, 0, p.qkv_w, kC / 32, 2 * cb, 0, lane);
    const int sec = cb / (kC / 16);
    bf16* dst = sec == 0 ? Qs : sec == 1 ? Ks : Vs;
    const bool guided = has_guid && sec < 2;
    each_pair(acc, 0, 2 * cb, lane, [&](int r, int c, float v0, float v1) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(p.qkv_b + c));
      bf16* d = at<16>(dst, r, c - sec * kC);
      float a0 = rnd<bf16>(v0 + bb.x), a1 = rnd<bf16>(v1 + bb.y);
      if (guided) {
        const float2 gv = unpack_bf16(d);
        a0 += gv.x;
        a1 += gv.y;
      }
      store_bf16x2(d, a0, a1);
    });
  }
  __syncthreads();
  SWIN_PHASE(2);

  for (int task = warp; task < kStrips * kHeads; task += kTcWarps)
    attend(Qs, Ks, Vs, reg, task / kHeads, task % kHeads, shift > 0, lane);
  __syncthreads();
  SWIN_PHASE(3);

  // out-proj + residual into Xs: (16-column block, 48-row third) tasks
  for (int task = warp; task < 3 * kC / 16; task += kTcWarps) {
    const int cb = task % (kC / 16), s0 = (task / (kC / 16)) * 3;
    float acc[3][2][4];
    zero(acc);
    gemm<16, 3, 2, kC / 32>(acc, Qs, s0, p.proj_w, kC / 32, 2 * cb, 0, lane);
    each_pair(acc, s0, 2 * cb, lane, [&](int r, int c, float v0, float v1) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(p.proj_b + c));
      bf16* d = at<16>(Xs, r, c);
      const float2 xv = unpack_bf16(d);
      store_bf16x2(d, xv.x + rnd<bf16>(v0 + bb.x), xv.y + rnd<bf16>(v1 + bb.y));
    });
  }
  __syncthreads();
  SWIN_PHASE(4);
  ln_rows(Xs, Ys, p.ln2_g, p.ln2_b, warp, lane);
  __syncthreads();
  SWIN_PHASE(5);

  // GELU MLP in two 256-wide hidden chunks; each warp keeps two fc2 output
  // blocks (16 columns, 48 rows) in registers across the chunks
  float acc2[2][3][2][4];
  zero(acc2[0]);
  zero(acc2[1]);
  for (int c0 = 0; c0 < kHid; c0 += kHidChunk) {
    for (int task = warp; task < 3 * kHidChunk / 16; task += kTcWarps) {
      const int cb = task % (kHidChunk / 16), s0 = (task / (kHidChunk / 16)) * 3;
      float acc[3][2][4];
      zero(acc);
      gemm<16, 3, 2, kC / 32>(acc, Ys, s0, p.fc1_w, kC / 32, c0 / 8 + 2 * cb, 0, lane);
      each_pair(acc, s0, 2 * cb, lane, [&](int r, int c, float v0, float v1) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.fc1_b + c0 + c));
        store_bf16x2(at<kHidChunk / 8>(Hs, r, c), gelu_fast(v0 + bb.x), gelu_fast(v1 + bb.y));
      });
    }
    __syncthreads();
    SWIN_PHASE(6);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int task = warp + kTcWarps * i, cb = task % (kC / 16), s0 = (task / (kC / 16)) * 3;
      gemm<kHidChunk / 8, 3, 2, kHidChunk / 32>(acc2[i], Hs, s0, p.fc2_w, kHid / 32, 2 * cb, c0 / 32, lane);
    }
    __syncthreads();
    SWIN_PHASE(7);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int task = warp + kTcWarps * i, cb = task % (kC / 16), s0 = (task / (kC / 16)) * 3;
    each_pair(acc2[i], s0, 2 * cb, lane, [&](int r, int c, float v0, float v1) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(p.fc2_b + c));
      bf16* d = at<16>(Xs, r, c);
      const float2 xv = unpack_bf16(d);
      store_bf16x2(d, xv.x + rnd<bf16>(v0 + bb.x), xv.y + rnd<bf16>(v1 + bb.y));
    });
  }
  __syncthreads();
  SWIN_PHASE(8);
  // one scatter of the block's output rows, 16 bytes a thread
  for (int e = tid; e < kN * 16; e += kTcThreads) {
    const int r = e >> 4, c = e & 15;
    *reinterpret_cast<uint4*>(os + (size_t)src[r] * kC + c * 8) = *reinterpret_cast<const uint4*>(Xs + sw<16>(r, c));
  }
#ifdef CATSEG_SWIN_PHASE_CLOCKS
  __syncthreads();
  SWIN_PHASE(9);
  if (tid == 0) atomicAdd(&g_phase_cycles[kPhases], 1ull);
#endif
}

}  // namespace

#ifdef CATSEG_SWIN_PHASE_CLOCKS
// copies the timing build's per-phase cycle sums and CTA count (kPhases + 1
// values) to host memory and sets them to 0
extern "C" int catseg_swin_phase_cycles(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(g_phase_cycles));
  static const unsigned long long zeros[kPhases + 1] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_cycles, zeros, sizeof(zeros));
  return (int)e;
}
#endif

extern "C" int catseg_swin_block(const void* x, void* out, const void* qg, const void* kg,
                                 const void* ln1_g, const void* ln1_b, const void* qkv_w,
                                 const void* qkv_b, const void* proj_w, const void* proj_b,
                                 const void* ln2_g, const void* ln2_b, const void* fc1_w,
                                 const void* fc1_b, const void* fc2_w, const void* fc2_b, int B,
                                 int nT, int H, int W, int shift, int has_guid, int is_bf16,
                                 void* stream) {
  if (H % kWin || W % kWin || B <= 0 || nT <= 0 || shift < 0 || shift >= kWin)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto h = [](const void* ptr) { return static_cast<const bf16*>(ptr); };
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((H / kWin) * (W / kWin), nT, B);
  cudaError_t e;
  if (is_bf16) {
    auto u = [](const void* ptr) { return static_cast<const uint4*>(ptr); };
    const SwinParamsTC p{f(ln1_g), f(ln1_b), u(qkv_w), f(qkv_b), u(proj_w), f(proj_b),
                         f(ln2_g), f(ln2_b), u(fc1_w), f(fc1_b), u(fc2_w), f(fc2_b)};
    e = cudaFuncSetAttribute(swin_block_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemTC);
    if (e != cudaSuccess) return (int)e;
    swin_block_tc_kernel<<<grid, kTcThreads, kSmemTC, st>>>(h(x), static_cast<bf16*>(out), h(qg), h(kg), p, nT,
                                                         H, W, shift, has_guid);
  } else {
    const SwinParams p{f(ln1_g), f(ln1_b), f(qkv_w), f(qkv_b), f(proj_w), f(proj_b),
                       f(ln2_g), f(ln2_b), f(fc1_w), f(fc1_b), f(fc2_w), f(fc2_b)};
    e = cudaFuncSetAttribute(swin_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    swin_block_kernel<<<grid, kThreads, kSmem, st>>>(f(x), static_cast<float*>(out), f(qg), f(kg), p, nT, H,
                                                     W, shift, has_guid);
  }
  return (int)cudaGetLastError();
}
