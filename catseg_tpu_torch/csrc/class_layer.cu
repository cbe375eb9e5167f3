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
// pad terms) in shared memory -> Q = elu(q)+1 -> out = Q.KV * Tp / (Q.Ksum +
// 1e-6).  q and k stay fp32 through the guidance add and elu+1, as the
// reference spec does.  Then residual -> LN2 -> ReLU MLP -> residual.
//
// bf16 (the serving dtype) runs the qkv and MLP products on tensor cores
// (wmma bf16 -> fp32; rows padded to 16); fp32 runs CUDA-core FMAs and stays
// the oracle-parity path.  Both take T <= 256 (pad_len, the count the top-k
// path hands over): bf16 runs the MLP in passes of at most 128 rows so its
// fc2 accumulators stay in registers; fp32 writes seq = x + attention straight
// to out and accumulates the fc2 chunks there, so shared memory holds one
// (T, C) buffer and the per-head rows.
//
// Bound on the card: the qkv / MLP products (~0.18 M multiply-adds per class
// row) and one CTA per SM; the activation is read and written once.
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kC = 128, kHeads = 4, kD = 32, kDP = kD + 1, kHid = 512, kHC = 64;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kLdb = kC + 8;      // bf16 row stride of tensor-core operands (16-byte skew)
constexpr int kHCt = 128;         // tensor-core MLP hidden chunk
constexpr int kPassTiles = 8;     // tensor-core MLP: 16-row tiles per pass
constexpr int kMaxT = 256;        // classes per position (pad_len)
constexpr size_t kSmemLimit = 232448;

struct ClassParams {
  const float *ln1_g, *ln1_b, *qkv_w, *qkv_b, *ln2_g, *ln2_b, *m1_w, *m1_b, *m2_w, *m2_b;
};

struct ClassParamsTC {
  const float *ln1_g, *ln1_b;
  const bf16* qkv_w;
  const float *qkv_b, *ln2_g, *ln2_b;
  const bf16* m1_w;
  const float* m1_b;
  const bf16* m2_w;
  const float* m2_b;
};

__device__ __forceinline__ float elu1(float v) { return v > 0.f ? v + 1.f : expf(fminf(v, 0.f)); }

constexpr size_t smem_bytes(int nT) {
  return (size_t)(nT * kC + 2 * nT * kDP + kD * kDP + kD + nT) * sizeof(float);
}

constexpr int padded(int nT) { return (nT + 15) / 16 * 16; }

constexpr size_t smem_bytes_tc(int nT) {
  return (size_t)(padded(nT) + kPassTiles * 16) * kLdb * sizeof(bf16)
         + (size_t)(2 * padded(nT) * kDP + kD * kDP + kD + padded(nT)) * sizeof(float)
         + (size_t)kWarps * 256 * sizeof(float);
}
static_assert(smem_bytes(kMaxT) <= kSmemLimit && smem_bytes_tc(kMaxT) <= kSmemLimit, "shared memory at T = 256");

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

// bf16 layer: tensor-core qkv / MLP products (mm_tc) on rows padded to a
// multiple of 16 with zeros; the MLP runs in passes of kPassTiles row tiles,
// whose fc2 accumulators stay in registers across the 128-wide hidden chunks
// (warp w owns output column tile w).
__global__ void __launch_bounds__(kThreads, 1)
class_layer_tc_kernel(const bf16* x, bf16* out, const bf16* qg, const bf16* kg,
                      const float* __restrict__ pad_kv, const float* __restrict__ pad_ksum, ClassParamsTC p,
                      int nT, int HW, int has_guid, float Tp) {
  namespace wm = nvcuda::wmma;
  using T = bf16;
  static_assert(kC / 16 == kWarps, "one fc2 output column tile per warp");
  extern __shared__ __align__(128) unsigned char smraw[];
  const int tp = (nT + 15) / 16 * 16, mt = tp / 16;
  bf16* Ya = reinterpret_cast<bf16*>(smraw);  // (tp, kLdb): LN1 out, then LN2 out; pad rows 0
  bf16* Hc = Ya + tp * kLdb;                  // (kPassTiles * 16, kLdb): MLP hidden chunk of a pass
  float* Kh = reinterpret_cast<float*>(Hc + kPassTiles * 16 * kLdb);
  float* Vh = Kh + tp * kDP;
  float* KV = Vh + tp * kDP;
  float* ks = KV + kD * kDP;
  float* z = ks + kD;
  float* stage = z + tp;
  const int pos = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto row = [&](int t) { return ((size_t)(b * nT + t) * HW + pos) * kC; };
  const size_t gb = (size_t)b * nT * kC;

  for (int i = tid; i < (tp - nT) * kLdb; i += blockDim.x) Ya[nT * kLdb + i] = from_f<T>(0.f);
  for (int t = warp; t < nT; t += kWarps) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = to_f(x[row(t) + lane + 32 * i]);
    ln_row128<T>(v, p.ln1_g, p.ln1_b, Ya + t * kLdb, lane);
  }
  __syncthreads();

  for (int h = 0; h < kHeads; ++h) {
    const int hq = h * kD, hk = kC + h * kD, hv = 2 * kC + h * kD;
    mm_tc(Ya, kLdb, p.qkv_w + hk, 3 * kC, tp, kD, kC, stage, [&](int r, int c, float acc) {
      if (r >= nT) return;
      float k = acc + p.qkv_b[hk + c];
      if (has_guid) k += to_f(kg[gb + (size_t)r * kC + hq + c]);
      Kh[r * kDP + c] = elu1(k);
    });
    mm_tc(Ya, kLdb, p.qkv_w + hv, 3 * kC, tp, kD, kC, stage, [&](int r, int c, float acc) {
      if (r < nT) Vh[r * kDP + c] = (acc + p.qkv_b[hv + c]) / Tp;
    });
    __syncthreads();
    head_kv(Kh, Vh, nT, hq, pad_kv, pad_ksum, KV, ks);
    __syncthreads();
    float* Qh = Kh;
    mm_tc(Ya, kLdb, p.qkv_w + hq, 3 * kC, tp, kD, kC, stage, [&](int r, int c, float acc) {
      if (r >= nT) return;
      float q = acc + p.qkv_b[hq + c];
      if (has_guid) q += to_f(qg[gb + (size_t)r * kC + hq + c]);
      Qh[r * kDP + c] = elu1(q);
    });
    __syncthreads();
    // seq = x + attn, rounded, straight to out (the final residual)
    head_out(Qh, KV, ks, z, nT, Tp, [&](int t, int f, float v) {
      const size_t gi = row(t) + hq + f;
      out[gi] = from_f<T>(to_f(x[gi]) + v);
    });
    __syncthreads();
  }

  for (int t = warp; t < nT; t += kWarps) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = to_f(out[row(t) + lane + 32 * i]);
    ln_row128<T>(v, p.ln2_g, p.ln2_b, Ya + t * kLdb, lane);
  }
  __syncthreads();

  float* st = stage + warp * 256;
  for (int t0 = 0; t0 < mt; t0 += kPassTiles) {
    const int pt = min(kPassTiles, mt - t0);
    wm::fragment<wm::accumulator, 16, 16, 16, float> acc[kPassTiles];
#pragma unroll
    for (int i = 0; i < kPassTiles; ++i) wm::fill_fragment(acc[i], 0.f);
    for (int c0 = 0; c0 < kHid; c0 += kHCt) {
      mm_tc(Ya + t0 * 16 * kLdb, kLdb, p.m1_w + c0, kHid, pt * 16, kHCt, kC, stage, [&](int r, int c, float a) {
        Hc[r * kLdb + c] = from_f<T>(fmaxf(a + p.m1_b[c0 + c], 0.f));
      });
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPassTiles; ++i) {
        if (i < pt) {
          for (int k = 0; k < kHCt; k += 16) {
            wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
            wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> bm;
            wm::load_matrix_sync(a, Hc + i * 16 * kLdb + k, kLdb);
            wm::load_matrix_sync(bm, p.m2_w + (size_t)(c0 + k) * kC + warp * 16, kC);
            wm::mma_sync(acc[i], a, bm, acc[i]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kPassTiles; ++i) {
      if (i < pt) {
        wm::store_matrix_sync(st, acc[i], 16, wm::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int t = (t0 + i) * 16 + e / 16, c = warp * 16 + e % 16;
          if (t < nT) {
            const size_t gi = row(t) + c;
            out[gi] = from_f<T>(to_f(out[gi]) + rnd<T>(st[e] + p.m2_b[c]));
          }
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

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
    const ClassParamsTC p{f(ln1_g), f(ln1_b), h(qkv_w), f(qkv_b), f(ln2_g),
                          f(ln2_b), h(m1_w),  f(m1_b),  h(m2_w),  f(m2_b)};
    const size_t smem = smem_bytes_tc(nT);
    e = cudaFuncSetAttribute(class_layer_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    class_layer_tc_kernel<<<grid, kThreads, smem, st>>>(h(x), static_cast<bf16*>(out), h(qg), h(kg), f(pad_kv),
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
