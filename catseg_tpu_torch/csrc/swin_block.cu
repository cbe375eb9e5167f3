// One Swin block of the aggregator's spatial stage, one CTA per
// (window, class, image).
//
// Replaces catseg_tpu/kernels/swin_block.py:fused_swin_pair (_kernel via
// _pallas_pair); the pair is two launches, shift 0 then shift win/2.
// x, out: (B, T, H, W, 128) class-major slabs; qg, kg: (B, H, W, 128) per-image
// guidance halves of the q/k projections (or null).  Weights are in (in, out)
// layout: qkv_w (128, 384), proj_w (128, 128), fc1_w (128, 512), fc2_w
// (512, 128); fp32 for the fp32 kernel, bf16 for the bf16 one.  Biases and
// LayerNorm parameters are fp32.
//
// Every stage but attention is per token, so a whole block is independent
// per window: the CTA gathers its 144 tokens (the cyclic roll is folded into
// the gather/scatter indices, so no rolled copy exists), runs LN1 -> qkv
// (+ guidance) -> 4-head window attention (shifted windows add -100 between
// regions, computed from index math) -> proj -> residual -> LN2 -> GELU MLP
// -> residual, and scatters the tokens back.
//
// bf16 (the serving dtype) takes the reference's fast forms (single-pass LN
// variance, tanh GELU, softmax clamped at 60 without a max pass) and runs
// every product on tensor cores (wmma bf16 -> fp32: qkv, q.k^T, P.v, proj,
// MLP); the operands are already bf16-rounded, so this is the reference's
// arithmetic.  fp32 takes exact erf GELU, two-pass LN and a max-subtracted
// softmax, with CUDA-core FMAs (one thread per query in attention), so that
// fp32 stays the oracle-parity path.
//
// Bound on the card: one CTA per SM (~200 KB of shared memory for either
// dtype) with 8 warps; the bf16 kernel's per-stage split is not measured
// yet.  The activation crosses device memory once per block instead of ~10
// times.
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kC = 128, kHeads = 4, kD = 32, kWin = 12, kN = kWin * kWin;
constexpr int kHid = 512, kHC = 64, kDP = kD + 1, kThreads = 256, kWarps = kThreads / 32;
constexpr float kScale = 0.17677669529663687f;  // 32 ** -0.5
static_assert(kN % 16 == 0, "attention walks keys in groups of 4; wmma tiles are 16 rows");
// fp32 kernel: Y, O (N, C) fp32 + per-head q/k/v + token indices
constexpr size_t kSmem = (size_t)(2 * kN * kC + 3 * kN * kDP) * sizeof(float) + 2 * kN * sizeof(int);
// bf16 kernel: Ya, Oa (N, kLdb) bf16 + per-head q/k/v (N, kLdq) bf16 + the
// (N, N) fp32 logits + per-warp staging + token indices
constexpr int kLdb = kC + 8;        // 16-byte row skew against shared-memory bank conflicts
constexpr int kLdq = kD + 8;
constexpr int kLdS = kN;            // logits row stride (fp32); probabilities reuse it as 2*kLdS bf16
constexpr int kHCt = 128;           // tensor-core MLP hidden chunk (overlays Oa)
constexpr int kOutTiles = (kN / 16) * (kC / 16);
static_assert(kOutTiles % kWarps == 0, "each warp owns the same number of fc2 output tiles");
constexpr size_t kSmemTC = 2 * (size_t)kN * kLdb * sizeof(bf16) + 3 * (size_t)kN * kLdq * sizeof(bf16)
                           + (size_t)kN * kLdS * sizeof(float) + (size_t)kWarps * 256 * sizeof(float)
                           + 2 * kN * sizeof(int);

struct SwinParams {
  const float *ln1_g, *ln1_b, *qkv_w, *qkv_b, *proj_w, *proj_b;
  const float *ln2_g, *ln2_b, *fc1_w, *fc1_b, *fc2_w, *fc2_b;
};

struct SwinParamsTC {
  const float *ln1_g, *ln1_b;
  const bf16* qkv_w;
  const float* qkv_b;
  const bf16* proj_w;
  const float *proj_b, *ln2_g, *ln2_b;
  const bf16* fc1_w;
  const float* fc1_b;
  const bf16* fc2_w;
  const float* fc2_b;
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

// bf16 block: the same stages with tensor-core products (mm_tc); the fc2
// accumulators stay in registers across the 128-wide hidden chunks.
__global__ void __launch_bounds__(kThreads, 1)
swin_block_tc_kernel(const bf16* x, bf16* out, const bf16* qg, const bf16* kg, SwinParamsTC p, int nT,
                     int H, int W, int shift, int has_guid) {
  namespace wm = nvcuda::wmma;
  using T = bf16;
  extern __shared__ __align__(128) unsigned char smraw[];
  bf16* Ya = reinterpret_cast<bf16*>(smraw);  // (N, kLdb): LN1 out, then LN2 out
  bf16* Oa = Ya + kN * kLdb;                  // (N, kLdb): attention out, then hidden chunk
  bf16* Qb = Oa + kN * kLdb;                  // (N, kLdq) per-head q, k, v
  bf16* Kb = Qb + kN * kLdq;
  bf16* Vb = Kb + kN * kLdq;
  float* S = reinterpret_cast<float*>(Vb + kN * kLdq);  // (N, kLdS) q.k, then bf16 probabilities
  float* stage = S + kN * kLdS;               // kWarps x 256 fp32
  int* src = reinterpret_cast<int*>(stage + kWarps * 256);
  int* reg = src + kN;
  bf16* Hc = Oa;

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
    for (int i = 0; i < 4; ++i) v[i] = to_f(row[lane + 32 * i]);
    ln_row128<T>(v, p.ln1_g, p.ln1_b, Ya + n * kLdb, lane);
  }
  __syncthreads();

  for (int h = 0; h < kHeads; ++h) {
    const int hq = h * kD, hk = kC + h * kD, hv = 2 * kC + h * kD;
    mm_tc(Ya, kLdb, p.qkv_w + hq, 3 * kC, kN, kD, kC, stage, [&](int r, int c, float acc) {
      float q = rnd<T>(acc + p.qkv_b[hq + c]);
      if (has_guid) q = rnd<T>(q + to_f(qg[gbase + (size_t)src[r] * kC + hq + c]));
      Qb[r * kLdq + c] = from_f<T>(q);
    });
    mm_tc(Ya, kLdb, p.qkv_w + hk, 3 * kC, kN, kD, kC, stage, [&](int r, int c, float acc) {
      float k = rnd<T>(acc + p.qkv_b[hk + c]);
      if (has_guid) k = rnd<T>(k + to_f(kg[gbase + (size_t)src[r] * kC + hq + c]));
      Kb[r * kLdq + c] = from_f<T>(k);
    });
    mm_tc(Ya, kLdb, p.qkv_w + hv, 3 * kC, kN, kD, kC, stage,
          [&](int r, int c, float acc) { Vb[r * kLdq + c] = from_f<T>(acc + p.qkv_b[hv + c]); });
    __syncthreads();

    // S = q k^T on tensor cores (k read column-major is k^T)
    constexpr int kNT = kN / 16;
    for (int t = warp; t < kNT * kNT; t += kWarps) {
      const int rt = t / kNT, ct = t % kNT;
      wm::fragment<wm::accumulator, 16, 16, 16, float> c;
      wm::fill_fragment(c, 0.f);
#pragma unroll
      for (int k = 0; k < kD; k += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> b;
        wm::load_matrix_sync(a, Qb + rt * 16 * kLdq + k, kLdq);
        wm::load_matrix_sync(b, Kb + ct * 16 * kLdq + k, kLdq);
        wm::mma_sync(c, a, b, c);
      }
      wm::store_matrix_sync(S + rt * 16 * kLdS + ct * 16, c, kLdS, wm::mem_row_major);
    }
    __syncthreads();

    // softmax of each row, one warp per row (fast form: clamped, no max
    // pass); the bf16 probabilities overwrite the row's first half once
    // every lane holds its logits
    constexpr int kPerLane = (kN + 31) / 32;
    for (int n = warp; n < kN; n += kWarps) {
      float e[kPerLane];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = lane + 32 * i;
        e[i] = 0.f;
        if (j < kN) {
          const float sv = S[n * kLdS + j] * kScale + (reg[j] != reg[n] ? -100.f : 0.f);
          e[i] = expf(fminf(sv, 60.f));
          sum += e[i];
        }
      }
      sum = warp_sum(sum);
      __syncwarp();
      bf16* P = reinterpret_cast<bf16*>(S + n * kLdS);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = lane + 32 * i;
        if (j < kN) P[j] = from_f<T>(e[i] / sum);
      }
    }
    __syncthreads();

    // O_h = P v on tensor cores, rounded to bf16 into this head's columns
    const bf16* P = reinterpret_cast<const bf16*>(S);
    mm_tc(P, 2 * kLdS, Vb, kLdq, kN, kD, kN, stage,
          [&](int r, int c, float acc) { Oa[r * kLdb + hq + c] = from_f<T>(acc); });
    __syncthreads();
  }

  // out-proj + residual: x2 goes to out, which holds the final residual
  mm_tc(Oa, kLdb, p.proj_w, kC, kN, kC, kC, stage, [&](int r, int c, float acc) {
    const size_t gi = (size_t)src[r] * kC + c;
    os[gi] = from_f<T>(to_f(xs[gi]) + rnd<T>(acc + p.proj_b[c]));
  });
  __syncthreads();
  for (int n = warp; n < kN; n += kWarps) {
    const T* row = os + (size_t)src[n] * kC;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = to_f(row[lane + 32 * i]);
    ln_row128<T>(v, p.ln2_g, p.ln2_b, Ya + n * kLdb, lane);
  }
  __syncthreads();

  constexpr int kPer = kOutTiles / kWarps;  // fc2 output tiles per warp
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) wm::fill_fragment(acc[i], 0.f);
  for (int c0 = 0; c0 < kHid; c0 += kHCt) {
    mm_tc(Ya, kLdb, p.fc1_w + c0, kHid, kN, kHCt, kC, stage, [&](int r, int c, float a) {
      Hc[r * kLdb + c] = from_f<T>(gelu_fast(a + p.fc1_b[c0 + c]));
    });
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = warp + kWarps * i, rt = t / (kC / 16), ct = t % (kC / 16);
      for (int k = 0; k < kHCt; k += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
        wm::load_matrix_sync(a, Hc + rt * 16 * kLdb + k, kLdb);
        wm::load_matrix_sync(b, p.fc2_w + (size_t)(c0 + k) * kC + ct * 16, kC);
        wm::mma_sync(acc[i], a, b, acc[i]);
      }
    }
    __syncthreads();
  }
  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = warp + kWarps * i, rt = t / (kC / 16), ct = t % (kC / 16);
    wm::store_matrix_sync(st, acc[i], 16, wm::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = rt * 16 + e / 16, c = ct * 16 + e % 16;
      const size_t gi = (size_t)src[r] * kC + c;
      os[gi] = from_f<T>(to_f(os[gi]) + rnd<T>(st[e] + p.fc2_b[c]));
    }
    __syncwarp();
  }
}

}  // namespace

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
    const SwinParamsTC p{f(ln1_g), f(ln1_b), h(qkv_w), f(qkv_b), h(proj_w), f(proj_b),
                         f(ln2_g), f(ln2_b), h(fc1_w), f(fc1_b), h(fc2_w), f(fc2_b)};
    e = cudaFuncSetAttribute(swin_block_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemTC);
    if (e != cudaSuccess) return (int)e;
    swin_block_tc_kernel<<<grid, kThreads, kSmemTC, st>>>(h(x), static_cast<bf16*>(out), h(qg), h(kg), p, nT,
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
