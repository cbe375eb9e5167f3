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
// The forward is recomputed into a workspace (LN1 rows and statistics,
// q/k/v with guidance, the linear attention, x + attention, LN2 rows, the
// ReLU hidden rows), then reversed: the MLP, LN2 with the residual, the
// attention, the guidance and pad sums, qkv, LN1.  The attention backward per
// head: with s_t = Tp / (Q_t . Ksum + 1e-6) and a_t = Q_t KV, da_t = dA_t
// s_t, dz_t = -(dA_t . a_t) s_t / (z_t + 1e-6), dQ_t = da_t KV^T + dz_t Ksum,
// dKV = sum_t Q_t^T da_t, dKsum = sum_t dz_t Q_t, dK_t = V_t dKV^T + dKsum,
// dV_t = K_t dKV; elu+1's derivative is 1 above zero, else elu+1 itself.
// dKV and dKsum are also the pad cotangents; each CTA writes its own and a
// fixed-order sum reduces them.  lin_attn_kernel runs the attention in fp32
// in both paths, as the plain version does: one two-warp CTA per (position,
// image, head), each row's columns across a warp's lanes, KV's columns in
// registers (its note below); the forward launch keeps KV and Ksum for the
// backward's.
//
// fp32 (run): every product on the CUDA-core engine (bwd::gemm), the
// workspace fp32.  Bound on the card: ~3x the forward's qkv and MLP
// products, ~0.57 M multiply-adds per class row, on fp32 FMAs.
//
// bf16 (run_tc): the seven products on the tensor-core engine (bwd::tc::gemm,
// mma.sync m16n8k16, weights packed once a call in both orientations), the
// bf16-exact planes (LN rows, x + attention, the ReLU hidden rows, which the
// forward rounds to bf16) stored as bf16.  Operand precision per product, by
// the plain version (autograd through _plain, whose bf16 tensors round their
// cotangents):
// - recompute qkv and fc1: bf16 LN rows x bf16 weights; q/k/v stay fp32
//   (bias and guidance added unrounded), h = bf16(relu(fc1 + b));
// - fc2 weight grad: h and dout (bf16); dh = dout fc2^T, rounded to bf16
//   and masked by h > 0 (dh1, the cotangent of the bf16 h), in place over h;
// - fc1 weight grad: LN2's rows and dh1; dy2 = dh1 fc1^T, rounded to bf16
//   (the cotangent of the bf16 LN2 output), into LN2's backward, whose
//   d(x + attention) adds dout and is rounded to bf16 (the cotangent of the
//   bf16 sum);
// - the attention's output cotangent dqkv, fp32 in the plain version, as a
//   bf16 pair hi + lo (two mmas) for the qkv weight grad (against LN1's
//   rows) and dy1 = dqkv qkv^T (rounded to bf16, into LN1's backward).
// Weight grads are split-K products into per-split partials, their bias
// rows summed from the B tiles, reduced in a fixed order: no atomics.
// Bound on the card: ~106 GFLOP at the train step's (4, 171, 12, 12), 0.11
// ms at the bf16 tensor cores' peak; the hi + lo products add ~19 GFLOP.
#include "bwd_common.cuh"

using namespace catseg;
using namespace catseg::bwd;

namespace {

constexpr int kC = 128, kHeads = 4, kD = 32, kHid = 512, kMaxT = 256;
constexpr int kPadLen = kC * kC + kC;          // one CTA's pad cotangent block
constexpr int kParts = kWSplits * 129 * 512;   // largest split-partial block

__device__ __forceinline__ float elu1(float v) { return v > 0.f ? v + 1.f : expf(fminf(v, 0.f)); }

// q, k (+ guidance) and v, as the forward keeps them
struct QkvEpi {
  float* qkv;
  const float* b;
  const float *qg, *kg;
  int HW;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    float v = acc + b[n];
    if (qg && n < 2 * kC) v += (n < kC ? qg : kg)[(m / HW) * kC + n % kC];
    qkv[m * 3 * kC + n] = v;
  }
};

struct ReluEpi {  // h = relu(acc + b)
  float* h;
  const float* b;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    h[m * kHid + n] = fmaxf(acc + b[n], 0.f);
  }
};

struct ReluGradEpi {  // dh = acc where h > 0, in place over h
  float* h;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    h[m * kHid + n] = h[m * kHid + n] > 0.f ? acc : 0.f;
  }
};

// a backward output element: fp32, or a bf16 pair hi + lo (lo lo elements after hi)
struct OutF32 {
  float* p;
  __device__ __forceinline__ void operator()(long long i, float v) const { p[i] = v; }
};
struct OutSplit {
  bf16* p;
  long long lo;
  __device__ __forceinline__ void operator()(long long i, float v) const {
    const bf16 h = __float2bfloat16(v);
    p[i] = h;
    p[i + lo] = __float2bfloat16(v - __bfloat162float(h));
  }
};

// The linear attention of one (position, image, head): one CTA of two warps,
// warp w taking the class rows t = w, w + 2, ... in groups of four, the
// group's global loads issued together.  A lane holds one column of a row
// (q, k, v, dA: 128 bytes a warp); a row vector that every lane needs whole
// (Q_t, K_t, V_t, da_t) is staged in the warp's shared memory, a slot per
// row of the group, and read back as float4 broadcasts, so the four rows'
// products are independent; dot products run on four partial sums.  The
// forward sums K^T V (lane f: column f, 32 registers) and K over the warp's
// rows, adds the two warps' partials in a fixed order with the pad terms
// into KV (pitch kKP: a lane's float4 reads of its own row hit distinct
// banks), stores KV and Ksum for the backward, and writes seq = rnd(x +
// (Q_t KV) Tp / (Q_t . Ksum + 1e-6)).  The backward reads them back; pass B:
// a_t = Q_t KV (KV's column in registers), dz_t, da_t, dQ_t = da_t KV^T +
// dz_t Ksum (KV's row from shared memory), and the partials of dKV = sum
// Q_t^T da_t (columns in registers) and dKsum, summed as the forward's into
// dKV, dKsum and this head's block of the pad cotangents; pass C: dK_t = V_t
// dKV^T + dKsum, dV_t = K_t dKV.
constexpr int kLW = 2;          // warps a CTA
constexpr int kLG = 4;          // rows a group
constexpr int kKP = kD + 4;     // row pitch of the KV / dKV block
constexpr int kKVS = kD * kD + kD;   // floats of one head's KV and K sum
constexpr size_t kLinSmem = (size_t)(kD * kKP + kLW * kD * kD + kD + kLW * kD + 2 * kLW * kLG * kD) * sizeof(float);

// sum_i v[i] c[i]: v staged in shared memory, c in registers
__device__ __forceinline__ float dot_sr(const float* v, const float (&c)[kD]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kD; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(v + i);
    s[0] = fmaf(q.x, c[i], s[0]);
    s[1] = fmaf(q.y, c[i + 1], s[1]);
    s[2] = fmaf(q.z, c[i + 2], s[2]);
    s[3] = fmaf(q.w, c[i + 3], s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// sum_i v[i] r[i]: both in shared memory
__device__ __forceinline__ float dot_ss(const float* v, const float* r) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kD; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(v + i), w = *reinterpret_cast<const float4*>(r + i);
    s[0] = fmaf(q.x, w.x, s[0]);
    s[1] = fmaf(q.y, w.y, s[1]);
    s[2] = fmaf(q.z, w.z, s[2]);
    s[3] = fmaf(q.w, w.w, s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// c[i] += v[i] w: v staged in shared memory
__device__ __forceinline__ void axpy_sr(float (&c)[kD], const float* v, float w) {
#pragma unroll
  for (int i = 0; i < kD; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(v + i);
    c[i] = fmaf(q.x, w, c[i]);
    c[i + 1] = fmaf(q.y, w, c[i + 1]);
    c[i + 2] = fmaf(q.z, w, c[i + 2]);
    c[i + 3] = fmaf(q.w, w, c[i + 3]);
  }
}

// KV = the two warps' partial columns c (lane f: column f) added in order,
// + add (a (kD, kC) block at column hc; null: none); KS = the partial sums
// ls added, + adds
__device__ __forceinline__ void reduce_pair(float* KV, float* KS, float* red, float* rks, const float (&c)[kD],
                                            float ls, const float* add, const float* adds, int hc) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
#pragma unroll
  for (int d = 0; d < kD; ++d) red[(w * kD + d) * kD + lane] = c[d];
  rks[w * kD + lane] = ls;
  __syncthreads();
  constexpr int kE = kD * kD / (kLW * 32);
  float pv[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int e = tid + kLW * 32 * i;
    pv[i] = add ? __ldg(add + (long long)(hc + e / kD) * kC + hc + e % kD) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int e = tid + kLW * 32 * i;
    KV[(e / kD) * kKP + e % kD] = red[e] + red[kD * kD + e] + pv[i];
  }
  if (tid < kD) KS[tid] = rks[tid] + rks[kD + tid] + (adds ? adds[hc + tid] : 0.f);
  __syncthreads();
}

// Forward (!BWD): seq = rnd(x + attention) (M, 128); kvs = this head's KV
// and K sum (kKVS floats a CTA, pad terms included).  Backward: dqkv = d(q,
// k, v) pre-activation (M, 384) from dA (M, 128) and the forward's kvs; part
// = the pad cotangents of this (position, image), one head's block a CTA.
template <bool BWD, typename T, typename S, typename G, class Out>
__global__ void __launch_bounds__(kLW * 32, 8) lin_attn_kernel(const float* qkv, const T* x, const G* dA, S* seq,
                                                               Out dqkv, float* kvs, float* part,
                                                               const float* pad_kv, const float* pad_ksum, int nT,
                                                               int HW, float Tp) {
  extern __shared__ __align__(16) float dsm[];
  float* KV = dsm;                   // [d][kKP]: KV, then dKV
  float* red = KV + kD * kKP;        // [warp][d][f]: the warps' partial columns
  float* KS = red + kLW * kD * kD;   // [d]: K sum, then dK sum
  float* rks = KS + kD;              // [warp][d]: partial K sums
  const int pos = blockIdx.x, b = blockIdx.y, hc = blockIdx.z * kD, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  float* sq = rks + kLW * kD + 2 * kLG * kD * w;   // this warp's staged rows: kLG, then kLG more
  float* sa = sq + kLG * kD;
  float* kvc = kvs + (((long long)b * HW + pos) * kHeads + blockIdx.z) * kKVS;   // this CTA's KV, K sum
  // element (t, col) of q / k / v (col < 384), of dA, x or seq (col < 128)
  auto at3 = [&](int t, int col) { return (long long)((b * nT + t) * HW + pos) * 3 * kC + col; };
  auto at1 = [&](int t, int col) { return (long long)((b * nT + t) * HW + pos) * kC + col; };
  constexpr int kStep = kLG * kLW;   // rows a group of the warp's spans
  float c[kD], r0[kLG], r1[kLG];

  if constexpr (!BWD) {
    // pass A: KV = sum_t K_t^T V_t + pad_kv, Ksum = sum_t K_t + pad_ksum
#pragma unroll
    for (int d = 0; d < kD; ++d) c[d] = 0.f;
    float ls = 0.f;
    for (int t0 = w; t0 < nT; t0 += kStep) {
#pragma unroll
      for (int u = 0; u < kLG; ++u)
        if (t0 + kLW * u < nT) {
          r0[u] = qkv[at3(t0 + kLW * u, kC + hc + lane)];
          r1[u] = qkv[at3(t0 + kLW * u, 2 * kC + hc + lane)];
        }
#pragma unroll
      for (int u = 0; u < kLG; ++u)
        if (t0 + kLW * u < nT) {
          const float K = elu1(r0[u]);
          ls += K;
          sq[u * kD + lane] = K;
        }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kLG; ++u)
        if (t0 + kLW * u < nT) axpy_sr(c, sq + u * kD, r1[u] / Tp);
      __syncwarp();
    }
    reduce_pair(KV, KS, red, rks, c, ls, pad_kv, pad_ksum, hc);
    for (int e = tid; e < kD * kD; e += blockDim.x) kvc[e] = KV[(e / kD) * kKP + e % kD];
    if (tid < kD) kvc[kD * kD + tid] = KS[tid];
  } else {
    for (int e = tid; e < kD * kD; e += blockDim.x) KV[(e / kD) * kKP + e % kD] = kvc[e];
    if (tid < kD) KS[tid] = kvc[kD * kD + tid];
    __syncthreads();
  }
#pragma unroll
  for (int d = 0; d < kD; ++d) c[d] = KV[d * kKP + lane];   // KV's column `lane`
  const float ks = KS[lane];
  const float* kvr = KV + lane * kKP;                       // KV's row `lane`

  if constexpr (!BWD) {   // seq = rnd(x + (Q_t KV) Tp / (Q_t . Ksum + eps))
    for (int t0 = w; t0 < nT; t0 += kStep) {
      float z[kLG];
#pragma unroll
      for (int u = 0; u < kLG; ++u)
        if (t0 + kLW * u < nT) {
          r0[u] = qkv[at3(t0 + kLW * u, hc + lane)];
          r1[u] = to_f(x[at1(t0 + kLW * u, hc + lane)]);
        }
#pragma unroll
      for (int u = 0; u < kLG; ++u)
        if (t0 + kLW * u < nT) {
          const float Q = elu1(r0[u]);
          z[u] = warp_sum(Q * ks);
          sq[u * kD + lane] = Q;
        }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kLG; ++u)
        if (t0 + kLW * u < nT)
          seq[at1(t0 + kLW * u, hc + lane)] =
              from_f<S>(rnd<T>(r1[u] + dot_sr(sq + u * kD, c) * (Tp / (z[u] + 1e-6f))));
      __syncwarp();
    }
    return;
  }

  // pass B: dQ; partial dKV (columns in registers) and dKsum
  const float itp = 1.f / Tp;   // exact for the power-of-two pad_len
  float* pc = part + ((long long)b * HW + pos) * kPadLen;
  for (int e = tid; e < kD * kC; e += blockDim.x)   // this head's pad cotangent rows off its diagonal block
    if (e % kC / kD != hc / kD) pc[(long long)hc * kC + e] = 0.f;
  float dc[kD], ls = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) dc[d] = 0.f;
  for (int t0 = w; t0 < nT; t0 += kStep) {
    float Q[kLG], z[kLG], dz[kLG];
#pragma unroll
    for (int u = 0; u < kLG; ++u)
      if (t0 + kLW * u < nT) {
        r0[u] = qkv[at3(t0 + kLW * u, hc + lane)];
        r1[u] = to_f(dA[at1(t0 + kLW * u, hc + lane)]);
      }
#pragma unroll
    for (int u = 0; u < kLG; ++u)
      if (t0 + kLW * u < nT) {
        Q[u] = elu1(r0[u]);
        z[u] = warp_sum(Q[u] * ks);
        sq[u * kD + lane] = Q[u];
      }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kLG; ++u)
      if (t0 + kLW * u < nT) {
        const float s = Tp / (z[u] + 1e-6f);   // s / (z + eps) = s^2 / Tp
        dz[u] = -warp_sum(r1[u] * dot_sr(sq + u * kD, c)) * (s * s * itp);
        r1[u] *= s;   // da
        sa[u * kD + lane] = r1[u];
      }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kLG; ++u)
      if (t0 + kLW * u < nT) {
        dqkv(at3(t0 + kLW * u, hc + lane), (dz[u] * ks + dot_ss(sa + u * kD, kvr)) * (Q[u] > 1.f ? 1.f : Q[u]));
        axpy_sr(dc, sq + u * kD, r1[u]);
        ls = fmaf(dz[u], Q[u], ls);
      }
    __syncwarp();
  }
  __syncthreads();   // every warp is done reading KV's rows
  reduce_pair(KV, KS, red, rks, dc, ls, nullptr, nullptr, hc);
  for (int e = tid; e < kD * kD; e += blockDim.x)
    pc[(long long)(hc + e / kD) * kC + hc + e % kD] = KV[(e / kD) * kKP + e % kD];
  if (tid < kD) pc[kC * kC + hc + tid] = KS[tid];
#pragma unroll
  for (int d = 0; d < kD; ++d) c[d] = KV[d * kKP + lane];   // dKV's column `lane`
  const float dks = KS[lane];

  // pass C: dK = V dKV^T + dKsum, dV = K dKV
  for (int t0 = w; t0 < nT; t0 += kStep) {
#pragma unroll
    for (int u = 0; u < kLG; ++u)
      if (t0 + kLW * u < nT) {
        r0[u] = qkv[at3(t0 + kLW * u, kC + hc + lane)];
        r1[u] = qkv[at3(t0 + kLW * u, 2 * kC + hc + lane)];
      }
#pragma unroll
    for (int u = 0; u < kLG; ++u)
      if (t0 + kLW * u < nT) {
        r0[u] = elu1(r0[u]);
        sq[u * kD + lane] = r1[u] * itp;   // V
        sa[u * kD + lane] = r0[u];        // K
      }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kLG; ++u)
      if (t0 + kLW * u < nT) {
        const long long o = at3(t0 + kLW * u, hc + lane);
        dqkv(o + kC, (dks + dot_ss(sq + u * kD, kvr)) * (r0[u] > 1.f ? 1.f : r0[u]));
        dqkv(o + 2 * kC, dot_sr(sa + u * kD, c) * itp);
      }
    __syncwarp();
  }
}

struct Bufs {
  float *Y1, *st1, *QKV, *SEQ, *st2, *Y2, *Hh, *dY, *dSEQ, *dQKV, *kvs, *lpart, *part;
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
  b.kvs = c.take(cta * kHeads * kKVS);
  b.lpart = c.take(cta * kPadLen);
  b.part = c.take(kParts);
  if (used) *used = c.used;
  return b;
}

cudaError_t run(const float* x, const float* qg, const float* kg, const float* dout, const float* pad_kv,
                const float* pad_ksum, float* dx, float* dqg, float* dkg, float* dpad, float* g_ln1, float* g_qkv,
                float* g_ln2, float* g_m1, float* g_m2, const float* const* w, float* ws, int B, int nT, int HW,
                float Tp, cudaStream_t st) {
  const float *ln1_g = w[0], *ln1_b = w[1], *qkv_w = w[2], *qkv_b = w[3], *ln2_g = w[4], *ln2_b = w[5];
  const float *m1_w = w[6], *m1_b = w[7], *m2_w = w[8];
  const long long Ml = (long long)B * nT * HW;
  const int M = (int)Ml;
  const Bufs b = carve(ws, Ml, (long long)B * HW, nullptr);
  const dim3 lgrid(HW, B, kHeads);
  const float* none = nullptr;

  // forward recompute
  CATSEG_TRY(ln_fwd<float>(x, ln1_g, ln1_b, b.Y1, b.st1, Ml, st));
  CATSEG_TRY(gemm(Dense<float>{b.Y1, kC}, Dense<float>{qkv_w, 3 * kC}, QkvEpi{b.QKV, qkv_b, qg, kg, HW}, M,
                  3 * kC, kC, st));
  CATSEG_TRY(launch_k(lin_attn_kernel<false, float, float, float, OutF32>, lgrid, dim3(kLW * 32), kLinSmem, st,
                      (const float*)b.QKV, x, none, b.SEQ, OutF32{nullptr}, b.kvs, (float*)nullptr, pad_kv, pad_ksum,
                      nT, HW, Tp));
  CATSEG_TRY(ln_fwd<float>((const float*)b.SEQ, ln2_g, ln2_b, b.Y2, b.st2, Ml, st));
  CATSEG_TRY(gemm(Dense<float>{b.Y2, kC}, Dense<float>{m1_w, kHid}, ReluEpi{b.Hh, m1_b}, M, kHid, kC, st));

  // MLP and LN2 (the residual carries dout)
  CATSEG_TRY(wgrad(DenseT<float>{b.Hh, kHid}, Dense<float>{dout, kC}, kHid, true, kC, M, g_m2, b.part, st));
  CATSEG_TRY(gemm(Dense<float>{dout, kC}, DenseT<float>{m2_w, kC}, ReluGradEpi{b.Hh}, M, kHid, kC, st));
  CATSEG_TRY(wgrad(DenseT<float>{b.Y2, kC}, Dense<float>{b.Hh, kHid}, kC, true, kHid, M, g_m1, b.part, st));
  CATSEG_TRY(gemm(Dense<float>{b.Hh, kHid}, DenseT<float>{m1_w, kHid}, Store{b.dY, kC}, M, kC, kHid, st));
  CATSEG_TRY(ln_bwd((const float*)b.dY, (const float*)b.SEQ, b.st2, ln2_g, dout, b.dSEQ, g_ln2, b.part, Ml, st));

  // linear attention, pad cotangents, guidance sums over positions
  CATSEG_TRY(launch_k(lin_attn_kernel<true, float, float, float, OutF32>, lgrid, dim3(kLW * 32), kLinSmem, st,
                      (const float*)b.QKV, x, (const float*)b.dSEQ, (float*)nullptr, OutF32{b.dQKV}, b.kvs, b.lpart,
                      pad_kv, pad_ksum, nT, HW, Tp));
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

// ---------------------------------------------------------------- bf16

// q, k (+ guidance) and v in fp32, unrounded, from the tensor-core product
struct QkvEpi16 {
  float* qkv;
  const float* b;
  const bf16 *qg, *kg;
  int HW;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    v0 += b[n];
    v1 += b[n + 1];
    if (qg && n < 2 * kC) {
      const float2 g = unpack_bf16((n < kC ? qg : kg) + (m / HW) * kC + n % kC);
      v0 += g.x;
      v1 += g.y;
    }
    *reinterpret_cast<float2*>(qkv + m * 3 * kC + n) = make_float2(v0, v1);
  }
};

struct ReluEpi16 {  // h = bf16(relu(acc + b))
  bf16* h;
  const float* b;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    store_bf16x2(h + m * kHid + n, fmaxf(v0 + b[n], 0.f), fmaxf(v1 + b[n + 1], 0.f));
  }
};

struct ReluGradEpi16 {  // dh1 = bf16(acc) where h > 0, in place over h
  bf16* h;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    bf16* p = h + m * kHid + n;
    const float2 hv = unpack_bf16(p);
    store_bf16x2(p, hv.x > 0.f ? v0 : 0.f, hv.y > 0.f ? v1 : 0.f);
  }
};

// bf16 weights of the products, (K, N) row-major: the recompute's as the
// forward's, the input grads' transposed
struct Packed {
  bf16 *qkv, *qkvt, *m1, *m1t, *m2t;
};

struct Bufs16 {
  bf16 *Y1, *SEQ, *Y2, *H, *dY, *dSEQ, *dQKV;
  float *st1, *st2, *QKV, *kvs, *lpart, *part;
  long long q_lo;   // dQKV's lo plane, after its hi plane
  Packed w;
};

Bufs16 carve16(float* ws, long long M, long long cta, long long* used) {
  Carve c{ws};
  Bufs16 b;
  b.Y1 = c.take16(M * kC);
  b.SEQ = c.take16(M * kC);
  b.Y2 = c.take16(M * kC);
  b.H = c.take16(M * kHid);
  b.dY = c.take16(M * kC);
  b.dSEQ = c.take16(M * kC);
  b.q_lo = M * 3 * kC;
  b.dQKV = c.take16(2 * M * 3 * kC);
  b.st1 = c.take(2 * M);
  b.st2 = c.take(2 * M);
  b.QKV = c.take(M * 3 * kC);
  b.kvs = c.take(cta * kHeads * kKVS);
  b.lpart = c.take(cta * kPadLen);
  b.part = c.take(kParts);
  b.w.qkv = c.take16(kC * 3 * kC);
  b.w.qkvt = c.take16(kC * 3 * kC);
  b.w.m1 = c.take16(kC * kHid);
  b.w.m1t = c.take16(kC * kHid);
  b.w.m2t = c.take16(kC * kHid);
  if (used) *used = c.used;
  return b;
}

cudaError_t run_tc(const bf16* x, const bf16* qg, const bf16* kg, const bf16* dout, const float* pad_kv,
                   const float* pad_ksum, bf16* dx, float* dqg, float* dkg, float* dpad, float* g_ln1, float* g_qkv,
                   float* g_ln2, float* g_m1, float* g_m2, const float* const* w, float* ws, int B, int nT, int HW,
                   float Tp, cudaStream_t st) {
  using tc::Rows;
  const float *ln1_g = w[0], *ln1_b = w[1], *qkv_w = w[2], *qkv_b = w[3], *ln2_g = w[4], *ln2_b = w[5];
  const float *m1_w = w[6], *m1_b = w[7], *m2_w = w[8];
  const long long Ml = (long long)B * nT * HW;
  const int M = (int)Ml;
  const Bufs16 b = carve16(ws, Ml, (long long)B * HW, nullptr);
  const Packed& pw = b.w;
  const dim3 lgrid(HW, B, kHeads);
  const void* dm = x;   // a mapped address for the zero-filled chunks
  const long long ql = b.q_lo;

  CATSEG_TRY(tc::pack(qkv_w, pw.qkv, kC, 3 * kC, 0, st));
  CATSEG_TRY(tc::pack(qkv_w, pw.qkvt, kC, 3 * kC, 1, st));
  CATSEG_TRY(tc::pack(m1_w, pw.m1, kC, kHid, 0, st));
  CATSEG_TRY(tc::pack(m1_w, pw.m1t, kC, kHid, 1, st));
  CATSEG_TRY(tc::pack(m2_w, pw.m2t, kHid, kC, 1, st));

  // forward recompute
  CATSEG_TRY(ln_fwd<bf16>(x, ln1_g, ln1_b, b.Y1, b.st1, Ml, st));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<false>{b.Y1, kC, 0}, Rows<false>{pw.qkv, 3 * kC, 0},
                                    QkvEpi16{b.QKV, qkv_b, qg, kg, HW}, M, 3 * kC, kC, dm, st)));
  CATSEG_TRY(launch_k(lin_attn_kernel<false, bf16, bf16, bf16, OutSplit>, lgrid, dim3(kLW * 32), kLinSmem, st,
                      (const float*)b.QKV, x, (const bf16*)nullptr, b.SEQ, OutSplit{nullptr, 0}, b.kvs,
                      (float*)nullptr, pad_kv, pad_ksum, nT, HW, Tp));
  CATSEG_TRY(ln_fwd<bf16>((const bf16*)b.SEQ, ln2_g, ln2_b, b.Y2, b.st2, Ml, st));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<false>{b.Y2, kC, 0}, Rows<false>{pw.m1, kHid, 0}, ReluEpi16{b.H, m1_b}, M,
                                    kHid, kC, dm, st)));

  // MLP and LN2 (the residual carries dout)
  CATSEG_TRY((tc::wgrad<128, 128, 2, true>(Rows<false>{b.H, kHid, 0}, Rows<false>{dout, kC, 0}, kHid, kC, M, g_m2,
                                           b.part, dm, st)));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<false>{dout, kC, 0}, Rows<false>{pw.m2t, kHid, 0}, ReluGradEpi16{b.H}, M,
                                    kHid, kC, dm, st)));
  CATSEG_TRY((tc::wgrad<128, 128, 2, true>(Rows<false>{b.Y2, kC, 0}, Rows<false>{b.H, kHid, 0}, kC, kHid, M, g_m1,
                                           b.part, dm, st)));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<false>{b.H, kHid, 0}, Rows<false>{pw.m1t, kC, 0}, tc::StoreBf16{b.dY, kC},
                                    M, kC, kHid, dm, st)));
  CATSEG_TRY(ln_bwd((const bf16*)b.dY, (const bf16*)b.SEQ, b.st2, ln2_g, dout, b.dSEQ, g_ln2, b.part, Ml, st));

  // linear attention, pad cotangents, guidance sums over positions
  CATSEG_TRY(launch_k(lin_attn_kernel<true, bf16, bf16, bf16, OutSplit>, lgrid, dim3(kLW * 32), kLinSmem, st,
                      (const float*)b.QKV, x, (const bf16*)b.dSEQ, (bf16*)nullptr, OutSplit{b.dQKV, ql}, b.kvs,
                      b.lpart, pad_kv, pad_ksum, nT, HW, Tp));
  CATSEG_TRY(sum_mid(b.lpart, dpad, 1, B * HW, 1, kPadLen, kPadLen, 0, st));
  if (qg) {
    CATSEG_TRY(sum_mid_in(SplitIn{b.dQKV, ql}, dqg, (long long)B * nT, HW, 1, kC, 3 * kC, 0, st));
    CATSEG_TRY(sum_mid_in(SplitIn{b.dQKV, ql}, dkg, (long long)B * nT, HW, 1, kC, 3 * kC, kC, st));
  }

  // qkv and LN1 (the residual carries dSEQ)
  CATSEG_TRY((tc::wgrad<128, 128, 2, true>(Rows<false>{b.Y1, kC, 0}, Rows<true>{b.dQKV, 3 * kC, ql}, kC, 3 * kC, M,
                                           g_qkv, b.part, dm, st)));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<true>{b.dQKV, 3 * kC, ql}, Rows<false>{pw.qkvt, kC, 0},
                                    tc::StoreBf16{b.dY, kC}, M, kC, 3 * kC, dm, st)));
  return ln_bwd((const bf16*)b.dY, x, b.st1, ln1_g, (const bf16*)b.dSEQ, dx, g_ln1, b.part, Ml, st);
}

}  // namespace

// workspace elements (fp32-sized) the backward of one layer needs
extern "C" long long catseg_class_layer_bwd_workspace(int B, int nT, int HW, int is_bf16) {
  long long used = 0;
  if (is_bf16)
    carve16(nullptr, (long long)B * nT * HW, (long long)B * HW, &used);
  else
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
    return (int)run_tc(static_cast<const bf16*>(x), static_cast<const bf16*>(qg), static_cast<const bf16*>(kg),
                       static_cast<const bf16*>(dout), c(pad_kv), c(pad_ksum), static_cast<bf16*>(dx), f(dqg), f(dkg),
                       f(dpad), f(g_ln1), f(g_qkv), f(g_ln2), f(g_m1), f(g_m2), w, f(ws), B, nT, HW, Tp, st);
  return (int)run(c(x), c(qg), c(kg), c(dout), c(pad_kv), c(pad_ksum), f(dx), f(dqg), f(dkg), f(dpad), f(g_ln1),
                  f(g_qkv), f(g_ln2), f(g_m1), f(g_m2), w, f(ws), B, nT, HW, Tp, st);
}
