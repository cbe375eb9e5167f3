// Backward of one class-attention layer (linear attention over the classes
// of each position, then a ReLU MLP).
//
// Replaces catseg_tpu/kernels/class_layer.py:_bwd (_pallas_bwd, _bwd_kernel:
// the analytic backward of fused_class_layer, pad cotangents included).
// x, dout, dx: (B, T, HW, 128) class-major; qg, kg: (B, T, 128) guidance
// halves of q/k or null; pad_kv (128, 128) and pad_ksum (128) fp32 as the
// forward takes them.  Out, fp32: dqg, dkg (B, T, 128) summed over the
// positions; dpad (128 * 128 + 128): the pad_kv cotangent (block-diagonal
// by head) then the pad_ksum cotangent, summed over positions and images;
// g_ln1 / g_ln2 (256: gain, bias); g_qkv (129, 384), g_m1 (129, 512), g_m2
// (513, 128), each weight gradient with its bias gradient as the last row.
//
// Design (bwd_common.cuh): LN1, q/k/v (+ guidance), the linear attention
// (one CTA per (position, image), as the forward), x + attention, LN2 and
// the ReLU hidden layer are recomputed into an fp32 workspace; then the MLP,
// LN2, the attention and qkv are reversed.  The attention backward per head:
// with s_t = Tp / (Q_t . Ksum + 1e-6) and a_t = Q_t KV, da_t = dA_t s_t,
// dz_t = -(dA_t . a_t) s_t / (z_t + 1e-6), dQ_t = da_t KV^T + dz_t Ksum,
// dKV = sum_t Q_t^T da_t, dKsum = sum_t dz_t Q_t, dK_t = V_t dKV^T + dKsum,
// dV_t = K_t dKV; elu+1's derivative is 1 above zero, else elu+1 itself.
// dKV and dKsum are also the pad cotangents; each CTA writes its own and a
// fixed-order sum reduces them.  bf16 recomputes the forward's roundings
// (x + attention, the ReLU hidden rows) and single-pass LN statistics.
//
// Bound on the card: ~3x the forward's qkv and MLP products, ~0.57 M
// multiply-adds per class row, on fp32 CUDA-core FMAs here.
#include "bwd_common.cuh"

using namespace catseg;
using namespace catseg::bwd;

namespace {

constexpr int kC = 128, kHeads = 4, kD = 32, kDP = kD + 1, kHid = 512, kMaxT = 256;
constexpr int kPadLen = kC * kC + kC;          // one CTA's pad cotangent block
constexpr int kParts = kWSplits * 129 * 512;   // largest split-partial block

constexpr size_t lin_smem(int nT) {
  return (size_t)(4 * nT * kDP + 2 * kD * kDP + 2 * kD + 3 * nT) * sizeof(float);
}

__device__ __forceinline__ float elu1(float v) { return v > 0.f ? v + 1.f : expf(fminf(v, 0.f)); }

// q, k (+ guidance) and v in fp32, unrounded as the forward keeps them
template <typename T> struct QkvEpi {
  float* qkv;
  const float* b;
  const T *qg, *kg;
  int HW;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    float v = acc + b[n];
    if (qg && n < 2 * kC) v += to_f((n < kC ? qg : kg)[(m / HW) * kC + n % kC]);
    qkv[m * 3 * kC + n] = v;
  }
};

template <typename T> struct ReluEpi {  // h = rnd(relu(acc + b))
  float* h;
  const float* b;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    h[m * kHid + n] = rnd<T>(fmaxf(acc + b[n], 0.f));
  }
};

struct ReluGradEpi {  // dh = acc where h > 0, in place over h
  float* h;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    h[m * kHid + n] = h[m * kHid + n] > 0.f ? acc : 0.f;
  }
};

// One CTA per (position, image), 256 threads, heads in turn.  Forward (dA
// null): out = rnd(x + attention) (M, 128).  Backward: out = d(q, k, v)
// pre-activation (M, 384) from dA (M, 128); part = this CTA's pad cotangents.
template <typename T>
__global__ void __launch_bounds__(256, 1) lin_attn_kernel(const float* qkv, const T* x, const float* dA, float* out,
                                                          float* part, const float* pad_kv, const float* pad_ksum,
                                                          int nT, int HW, float Tp) {
  extern __shared__ __align__(16) float dsm[];
  float* Qs = dsm;
  float* Ks = Qs + nT * kDP;
  float* Vs = Ks + nT * kDP;
  float* Gs = Vs + nT * kDP;
  float* KV = Gs + nT * kDP;
  float* dKV = KV + kD * kDP;
  float* ks = dKV + kD * kDP;
  float* dks = ks + kD;
  float* zs = dks + kD;
  float* ss = zs + nT;
  float* dz = ss + nT;
  const int pos = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const bool bwd = dA != nullptr;
  auto row = [&](int t) { return (long long)(b * nT + t) * HW + pos; };
  float* pc = bwd ? part + ((long long)b * HW + pos) * kPadLen : nullptr;
  if (bwd)
    for (int e = tid; e < kC * kC; e += blockDim.x)
      if ((e / kC) / kD != (e % kC) / kD) pc[e] = 0.f;

  for (int h = 0; h < kHeads; ++h) {
    const int hc = h * kD;
    for (int e = tid; e < nT * kD; e += blockDim.x) {
      const int t = e / kD, d = e % kD;
      const float* r = qkv + row(t) * 3 * kC + hc + d;
      Qs[t * kDP + d] = elu1(r[0]);
      Ks[t * kDP + d] = elu1(r[kC]);
      Vs[t * kDP + d] = r[2 * kC] / Tp;
      if (bwd) Gs[t * kDP + d] = dA[row(t) * kC + hc + d];
    }
    __syncthreads();
    for (int e = tid; e < kD * kD; e += blockDim.x) {
      const int d = e / kD, f = e % kD;
      float s = 0.f;
      for (int t = 0; t < nT; ++t) s = fmaf(Ks[t * kDP + d], Vs[t * kDP + f], s);
      KV[d * kDP + f] = s + pad_kv[(long long)(hc + d) * kC + hc + f];
    }
    for (int d = tid; d < kD; d += blockDim.x) {
      float s = 0.f;
      for (int t = 0; t < nT; ++t) s += Ks[t * kDP + d];
      ks[d] = s + pad_ksum[hc + d];
    }
    __syncthreads();
    for (int t = tid; t < nT; t += blockDim.x) {
      float s = 0.f;
      for (int d = 0; d < kD; ++d) s = fmaf(Qs[t * kDP + d], ks[d], s);
      zs[t] = s;
      ss[t] = Tp / (s + 1e-6f);
    }
    __syncthreads();
    if (!bwd) {
      for (int e = tid; e < nT * kD; e += blockDim.x) {
        const int t = e / kD, f = e % kD;
        float s = 0.f;
        for (int d = 0; d < kD; ++d) s = fmaf(Qs[t * kDP + d], KV[d * kDP + f], s);
        const long long gi = row(t) * kC + hc + f;
        out[gi] = rnd<T>(to_f(x[gi]) + s * ss[t]);
      }
      __syncthreads();
      continue;
    }
    // dz_t = -(dA_t . a_t) s_t / (z_t + eps)
    for (int t = tid; t < nT; t += blockDim.x) {
      float ds = 0.f;
      for (int f = 0; f < kD; ++f) {
        float a = 0.f;
        for (int d = 0; d < kD; ++d) a = fmaf(Qs[t * kDP + d], KV[d * kDP + f], a);
        ds = fmaf(Gs[t * kDP + f], a, ds);
      }
      dz[t] = -ds * ss[t] / (zs[t] + 1e-6f);
    }
    __syncthreads();
    for (int e = tid; e < nT * kD; e += blockDim.x) Gs[(e / kD) * kDP + e % kD] *= ss[e / kD];  // da
    __syncthreads();
    for (int e = tid; e < nT * kD; e += blockDim.x) {
      const int t = e / kD, d = e % kD;
      float s = dz[t] * ks[d];
      for (int f = 0; f < kD; ++f) s = fmaf(Gs[t * kDP + f], KV[d * kDP + f], s);
      const float q = Qs[t * kDP + d];
      out[row(t) * 3 * kC + hc + d] = s * (q > 1.f ? 1.f : q);
    }
    for (int e = tid; e < kD * kD; e += blockDim.x) {
      const int d = e / kD, f = e % kD;
      float s = 0.f;
      for (int t = 0; t < nT; ++t) s = fmaf(Qs[t * kDP + d], Gs[t * kDP + f], s);
      dKV[d * kDP + f] = s;
    }
    for (int d = tid; d < kD; d += blockDim.x) {
      float s = 0.f;
      for (int t = 0; t < nT; ++t) s = fmaf(dz[t], Qs[t * kDP + d], s);
      dks[d] = s;
    }
    __syncthreads();
    for (int e = tid; e < nT * kD; e += blockDim.x) {
      const int t = e / kD, d = e % kD;
      float dk = dks[d], dv = 0.f;
      for (int f = 0; f < kD; ++f) {
        dk = fmaf(dKV[d * kDP + f], Vs[t * kDP + f], dk);
        dv = fmaf(Ks[t * kDP + f], dKV[f * kDP + d], dv);
      }
      const float k = Ks[t * kDP + d];
      out[row(t) * 3 * kC + kC + hc + d] = dk * (k > 1.f ? 1.f : k);
      out[row(t) * 3 * kC + 2 * kC + hc + d] = dv / Tp;
    }
    for (int e = tid; e < kD * kD; e += blockDim.x)
      pc[(long long)(hc + e / kD) * kC + hc + e % kD] = dKV[(e / kD) * kDP + e % kD];
    for (int d = tid; d < kD; d += blockDim.x) pc[kC * kC + hc + d] = dks[d];
    __syncthreads();
  }
}

struct Bufs {
  float *Y1, *st1, *QKV, *SEQ, *st2, *Y2, *Hh, *dY, *dSEQ, *dQKV, *lpart, *part;
};

Bufs carve(float* ws, long long M, long long cta, long long* used) {
  Carve c{ws};
  Bufs b;
  b.Y1 = c.take(M * kC);
  b.st1 = c.take(2 * M);
  b.QKV = c.take(M * 3 * kC);
  b.SEQ = c.take(M * kC);
  b.st2 = c.take(2 * M);
  b.Y2 = c.take(M * kC);
  b.Hh = c.take(M * kHid);
  b.dY = c.take(M * kC);
  b.dSEQ = c.take(M * kC);
  b.dQKV = c.take(M * 3 * kC);
  b.lpart = c.take(cta * kPadLen);
  b.part = c.take(kParts);
  if (used) *used = c.used;
  return b;
}

template <typename T>
cudaError_t run(const T* x, const T* qg, const T* kg, const T* dout, const float* pad_kv, const float* pad_ksum,
                T* dx, float* dqg, float* dkg, float* dpad, float* g_ln1, float* g_qkv, float* g_ln2, float* g_m1,
                float* g_m2, const float* const* w, float* ws, int B, int nT, int HW, float Tp, cudaStream_t st) {
  const float *ln1_g = w[0], *ln1_b = w[1], *qkv_w = w[2], *qkv_b = w[3], *ln2_g = w[4], *ln2_b = w[5];
  const float *m1_w = w[6], *m1_b = w[7], *m2_w = w[8];
  const long long Ml = (long long)B * nT * HW;
  const int M = (int)Ml;
  const Bufs b = carve(ws, Ml, (long long)B * HW, nullptr);
  const dim3 lgrid(HW, B);
  const size_t smem = lin_smem(nT);
  const float* none = nullptr;

  // forward recompute
  CATSEG_TRY(ln_fwd<T>(x, ln1_g, ln1_b, b.Y1, b.st1, Ml, st));
  CATSEG_TRY(gemm(Dense<float>{b.Y1, kC}, Dense<float>{qkv_w, 3 * kC}, QkvEpi<T>{b.QKV, qkv_b, qg, kg, HW}, M,
                  3 * kC, kC, st));
  CATSEG_TRY(launch_k(lin_attn_kernel<T>, lgrid, dim3(256), smem, st, (const float*)b.QKV, x, none, b.SEQ,
                      (float*)nullptr, pad_kv, pad_ksum, nT, HW, Tp));
  CATSEG_TRY(ln_fwd<T>((const float*)b.SEQ, ln2_g, ln2_b, b.Y2, b.st2, Ml, st));
  CATSEG_TRY(gemm(Dense<float>{b.Y2, kC}, Dense<float>{m1_w, kHid}, ReluEpi<T>{b.Hh, m1_b}, M, kHid, kC, st));

  // MLP and LN2 (the residual carries dout)
  CATSEG_TRY(wgrad(DenseT<float>{b.Hh, kHid}, Dense<T>{dout, kC}, kHid, true, kC, M, g_m2, b.part, st));
  CATSEG_TRY(gemm(Dense<T>{dout, kC}, DenseT<float>{m2_w, kC}, ReluGradEpi{b.Hh}, M, kHid, kC, st));
  CATSEG_TRY(wgrad(DenseT<float>{b.Y2, kC}, Dense<float>{b.Hh, kHid}, kC, true, kHid, M, g_m1, b.part, st));
  CATSEG_TRY(gemm(Dense<float>{b.Hh, kHid}, DenseT<float>{m1_w, kHid}, Store{b.dY, kC}, M, kC, kHid, st));
  CATSEG_TRY(ln_bwd((const float*)b.dY, (const float*)b.SEQ, b.st2, ln2_g, dout, b.dSEQ, g_ln2, b.part, Ml, st));

  // linear attention, pad cotangents, guidance sums over positions
  CATSEG_TRY(launch_k(lin_attn_kernel<T>, lgrid, dim3(256), smem, st, (const float*)b.QKV, x,
                      (const float*)b.dSEQ, b.dQKV, b.lpart, pad_kv, pad_ksum, nT, HW, Tp));
  CATSEG_TRY(sum_mid(b.lpart, dpad, 1, B * HW, 1, kPadLen, kPadLen, 0, st));
  if (qg) {
    CATSEG_TRY(sum_mid(b.dQKV, dqg, (long long)B * nT, HW, 1, kC, 3 * kC, 0, st));
    CATSEG_TRY(sum_mid(b.dQKV, dkg, (long long)B * nT, HW, 1, kC, 3 * kC, kC, st));
  }

  // qkv and LN1 (the residual carries dSEQ)
  CATSEG_TRY(wgrad(DenseT<float>{b.Y1, kC}, Dense<float>{b.dQKV, 3 * kC}, kC, true, 3 * kC, M, g_qkv, b.part, st));
  CATSEG_TRY(gemm(Dense<float>{b.dQKV, 3 * kC}, DenseT<float>{qkv_w, 3 * kC}, Store{b.dY, kC}, M, kC, 3 * kC, st));
  return ln_bwd((const float*)b.dY, x, b.st1, ln1_g, (const float*)b.dSEQ, dx, g_ln1, b.part, Ml, st);
}

}  // namespace

// fp32 workspace elements the backward of one layer needs
extern "C" long long catseg_class_layer_bwd_workspace(int B, int nT, int HW) {
  long long used = 0;
  carve(nullptr, (long long)B * nT * HW, (long long)B * HW, &used);
  return used;
}

extern "C" int catseg_class_layer_bwd(const void* x, const void* qg, const void* kg, const void* dout,
                                      const void* pad_kv, const void* pad_ksum, void* dx, void* dqg, void* dkg,
                                      void* dpad, void* g_ln1, void* g_qkv, void* g_ln2, void* g_m1, void* g_m2,
                                      const void* ln1_g, const void* ln1_b, const void* qkv_w, const void* qkv_b,
                                      const void* ln2_g, const void* ln2_b, const void* m1_w, const void* m1_b,
                                      const void* m2_w, const void* m2_b, void* ws, int B, int nT, int HW,
                                      int has_guid, float Tp, int is_bf16, void* stream) {
  if (B <= 0 || nT <= 0 || HW <= 0 || nT > kMaxT || (long long)B * nT * HW > 2147483647ll)
    return (int)cudaErrorInvalidValue;
  const void* wv[10] = {ln1_g, ln1_b, qkv_w, qkv_b, ln2_g, ln2_b, m1_w, m1_b, m2_w, m2_b};
  const float* w[10];
  for (int i = 0; i < 10; ++i) w[i] = static_cast<const float*>(wv[i]);
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  if (!has_guid) qg = kg = nullptr;
  if (is_bf16)
    return (int)run<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(qg), static_cast<const bf16*>(kg),
                          static_cast<const bf16*>(dout), c(pad_kv), c(pad_ksum), static_cast<bf16*>(dx), f(dqg),
                          f(dkg), f(dpad), f(g_ln1), f(g_qkv), f(g_ln2), f(g_m1), f(g_m2), w, f(ws), B, nT, HW, Tp,
                          st);
  return (int)run<float>(static_cast<const float*>(x), static_cast<const float*>(qg), static_cast<const float*>(kg),
                         static_cast<const float*>(dout), c(pad_kv), c(pad_ksum), static_cast<float*>(dx), f(dqg),
                         f(dkg), f(dpad), f(g_ln1), f(g_qkv), f(g_ln2), f(g_m1), f(g_m2), w, f(ws), B, nT, HW, Tp,
                         st);
}
