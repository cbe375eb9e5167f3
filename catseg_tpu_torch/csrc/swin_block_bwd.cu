// Backward of one Swin block of the aggregator's spatial stage.
//
// Replaces catseg_tpu/kernels/swin_block.py:_bwd (_pallas_pair_bwd,
// _bwd_kernel: the analytic backward of fused_swin_pair with in-kernel
// recompute).  One call per block; the pair's backward is two calls in
// reverse (block 2, then block 1), each given its own block's input.
//
// x, dout, dx: (B, T, H, W, 128) class-major; qg, kg: (B, H, W, 128)
// guidance halves of q/k or null; dqg, dkg: fp32 (B, H, W, 128), summed over
// the classes.  Weights as the forward takes them ((in, out) layout, fp32,
// already rounded through the compute dtype).  Gradients out, fp32:
// g_ln1 / g_ln2 (256: gain, bias), g_qkv (129, 384), g_proj (129, 128),
// g_fc1 (129, 512), g_fc2 (513, 128) — each weight gradient with its bias
// gradient as the last row.
//
// Design (bwd_common.cuh): the forward is recomputed per token into an fp32
// workspace (LN1 rows and statistics, q/k/v with guidance, attention output,
// x2, LN2 rows, fc1 pre-activations), then reversed: fc2 / fc1 weight grads
// and dgelu on the tiled gemm, LN2 backward with the residual, proj, the
// window attention backward (one CTA per (window, class, image), the
// forward's roll-folded gather and region mask, the probabilities recomputed
// in shared memory, dS = P (dP - rowsum(dP P)) as the spec's line 325;
// 4x4 register tiles for the q.k and dO.v products, four rows per item
// for the products with v, dO, k and q), the
// guidance sums over classes, qkv, LN1.  bf16 recomputes with the forward's
// fast forms (tanh GELU and its derivative as _gelu_grad, single-pass LN
// variance, the max-free softmax clamped at 60) and rounds where the forward
// rounds; gradients stay fp32.
//
// Bound on the card: ~3x the forward's products (recompute + two products per
// forward product), 1.4 MFLOP per token per block, all on fp32 CUDA-core FMAs
// here; weight-gradient split partials and the fp32 workspace (~9 KB per
// token) add device-memory traffic.
#include "bwd_common.cuh"

using namespace catseg;
using namespace catseg::bwd;

namespace {

constexpr int kC = 128, kHeads = 4, kD = 32, kWin = 12, kN = kWin * kWin, kHid = 512, kDP = kD + 1;
constexpr float kScale = 0.17677669529663687f;  // 32 ** -0.5
constexpr int kParts = kWSplits * 129 * 512;   // largest split-partial block
constexpr size_t kAttnSmem = (size_t)(4 * kN * kDP + kN * kN + kN) * sizeof(float) + 2 * kN * sizeof(int);

template <typename T> __device__ __forceinline__ float gelu(float x) {
  if (Fast<T>::value) return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// derivative of the same form (the spec's _gelu_grad for the tanh form)
template <typename T> __device__ __forceinline__ float gelu_grad(float x) {
  if (Fast<T>::value) {
    const float k = 0.7978845608028654f, t = tanhf(k * (x + 0.044715f * x * x * x));
    return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * k * (1.f + 3.f * 0.044715f * x * x);
  }
  return 0.5f * (1.f + erff(x * 0.7071067811865476f)) + x * 0.3989422804014327f * expf(-0.5f * x * x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int region(int i, int size, int shift) {
  return i < size - kWin ? 0 : (i < size - shift ? 1 : 2);
}

// token gather indices (roll folded in) and shift-mask region ids of this
// CTA's window, as the forward kernel derives them
__device__ __forceinline__ void window_tokens(int* src, int* reg, int H, int W, int shift) {
  const int nWw = W / kWin;
  const int wi = blockIdx.x / nWw, wj = blockIdx.x % nWw;
  for (int n = threadIdx.x; n < kN; n += blockDim.x) {
    const int ri = wi * kWin + n / kWin, rj = wj * kWin + n % kWin;
    src[n] = ((ri + shift) % H) * W + (rj + shift) % W;
    reg[n] = shift > 0 ? region(ri, H, shift) * 3 + region(rj, W, shift) : 0;
  }
}

// qkv = rnd(acc + b), guidance added to q / k and rounded again
template <typename T> struct QkvEpi {
  float* qkv;
  const float* b;
  const T *qg, *kg;
  long long per_img;
  int HW;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    float v = rnd<T>(acc + b[n]);
    if (qg && n < 2 * kC) {
      const T* g = n < kC ? qg : kg;
      v = rnd<T>(v + to_f(g[((m / per_img) * HW + m % HW) * kC + n % kC]));
    }
    qkv[m * 3 * kC + n] = v;
  }
};

// x2 = rnd(x + rnd(acc + b))
template <typename T> struct ProjEpi {
  float* x2;
  const T* x;
  const float* b;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    x2[m * kC + n] = rnd<T>(to_f(x[m * kC + n]) + rnd<T>(acc + b[n]));
  }
};

struct BiasEpi {  // out = acc + b
  float* out;
  const float* b;
  long long ld;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    out[m * ld + n] = acc + b[n];
  }
};

// (hidden unit i, row j) -> rnd(gelu(h1)): fc2's input, transposed for wgrad
template <typename T> struct GeluT {
  const float* h;
  static constexpr bool kFast2 = false;
  __device__ __forceinline__ float operator()(long long i, long long j) const { return rnd<T>(gelu<T>(h[j * kHid + i])); }
};

// dh1 = acc * gelu'(h1), in place over h1
template <typename T> struct GeluGradEpi {
  float* h;
  __device__ __forceinline__ void operator()(long long m, long long n, float acc, int) const {
    h[m * kHid + n] = acc * gelu_grad<T>(h[m * kHid + n]);
  }
};

// fn(i, j, sum_d A[i][d] B[j][d]) for all i, j < kN (rows at stride kDP):
// each thread item is a 4x4 register tile of rows ti + 36a and columns
// tj + 36b, so one shared load feeds four FMAs and a warp's B rows are
// consecutive (stride 33: no bank conflicts)
template <typename Fn>
__device__ __forceinline__ void dot_tiles(const float* A, const float* B, Fn fn) {
  constexpr int kS = kN / 4;
  for (int t = threadIdx.x; t < kS * kS; t += blockDim.x) {
    const int ti = t / kS, tj = t % kS;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = A[(ti + kS * u) * kDP + d];
        b[u] = B[(tj + kS * u) * kDP + d];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) fn(ti + kS * u, tj + kS * v, acc[u][v]);
  }
}

// fn(r, d, sum_j w(r, j) V[j][d]) for r < kN, d < kD: an item is four rows
// ti + 36a of one column d; a warp shares ti, so w reads are broadcasts
template <typename Wf, typename Fn>
__device__ __forceinline__ void mix_rows(Wf w, const float* V, Fn fn) {
  constexpr int kS = kN / 4;
  for (int t = threadIdx.x; t < kS * kD; t += blockDim.x) {
    const int ti = t / kD, d = t % kD;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < kN; ++j) {
      const float v = V[j * kDP + d];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(w(ti + kS * u, j), v, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) fn(ti + kS * u, d, acc[u]);
  }
}

// One CTA per (window, class, image), 256 threads, all four heads in turn.
// Forward (dO null): out = O (M, 128), rnd(P) v rounded.  Backward: out =
// dqkv (M, 384) from dO (M, 128).  Shared: q, k, v, dO head slices (kN, kDP),
// P (kN, kN), row sums, gather indices and region ids.
template <typename T>
__global__ void __launch_bounds__(256, 1) win_attn_kernel(const float* qkv, const float* dO, float* out, int nT,
                                                          int H, int W, int shift) {
  extern __shared__ __align__(16) float dsm[];
  float* Q = dsm;
  float* K = Q + kN * kDP;
  float* V = K + kN * kDP;
  float* G = V + kN * kDP;
  float* P = G + kN * kDP;
  float* Dr = P + kN * kN;
  int* src = reinterpret_cast<int*>(Dr + kN);
  int* reg = src + kN;
  const bool bwd = dO != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const long long base = ((long long)blockIdx.z * nT + blockIdx.y) * H * W;

  window_tokens(src, reg, H, W, shift);
  __syncthreads();
  for (int h = 0; h < kHeads; ++h) {
    const int hc = h * kD;
    for (int e = tid; e < kN * kD; e += blockDim.x) {
      const int n = e / kD, d = e % kD;
      const float* row = qkv + (base + src[n]) * 3 * kC + hc + d;
      Q[n * kDP + d] = row[0];
      K[n * kDP + d] = row[kC];
      V[n * kDP + d] = row[2 * kC];
      if (bwd) G[n * kDP + d] = dO[(base + src[n]) * kC + hc + d];
    }
    __syncthreads();
    dot_tiles(Q, K, [&](int i, int j, float s) { P[i * kN + j] = s * kScale + (reg[i] != reg[j] ? -100.f : 0.f); });
    __syncthreads();
    constexpr int kPL = (kN + 31) / 32;
    for (int i = warp; i < kN; i += nwarp) {
      float e[kPL];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kPL; ++u) {
        const int j = lane + 32 * u;
        e[u] = j < kN ? P[i * kN + j] : -INFINITY;
        mx = fmaxf(mx, e[u]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kPL; ++u) {
        const int j = lane + 32 * u;
        if (j < kN) {
          e[u] = Fast<T>::value ? expf(fminf(e[u], 60.f)) : expf(e[u] - mx);
          sum += e[u];
        }
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int u = 0; u < kPL; ++u) {
        const int j = lane + 32 * u;
        if (j < kN) P[i * kN + j] = e[u] / sum;
      }
    }
    __syncthreads();
    if (!bwd) {
      mix_rows([&](int i, int j) { return rnd<T>(P[i * kN + j]); }, V,
               [&](int i, int d, float acc) { out[(base + src[i]) * kC + hc + d] = rnd<T>(acc); });
      __syncthreads();
      continue;
    }
    // dv = rnd(P)^T dO (the forward multiplied v by the rounded P)
    mix_rows([&](int j, int i) { return rnd<T>(P[i * kN + j]); }, G,
             [&](int j, int d, float acc) { out[(base + src[j]) * 3 * kC + 2 * kC + hc + d] = acc; });
    // Dr_i = sum_j P_ij dP_ij, dP_ij = dO_i . v_j; dO_i held in registers
    for (int i = warp; i < kN; i += nwarp) {
      float g[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) g[d] = G[i * kDP + d];
      float s = 0.f;
      for (int j = lane; j < kN; j += 32) {
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) dp = fmaf(g[d], V[j * kDP + d], dp);
        s = fmaf(P[i * kN + j], dp, s);
      }
      s = warp_sum(s);
      if (lane == 0) Dr[i] = s;
    }
    __syncthreads();
    // P <- dlogits = P (dP - Dr) * scale
    dot_tiles(G, V, [&](int i, int j, float dp) { P[i * kN + j] = P[i * kN + j] * (dp - Dr[i]) * kScale; });
    __syncthreads();
    mix_rows([&](int i, int j) { return P[i * kN + j]; }, K,
             [&](int i, int d, float acc) { out[(base + src[i]) * 3 * kC + hc + d] = acc; });
    mix_rows([&](int j, int i) { return P[i * kN + j]; }, Q,
             [&](int j, int d, float acc) { out[(base + src[j]) * 3 * kC + kC + hc + d] = acc; });
    __syncthreads();
  }
}

struct Bufs {
  float *Y1, *st1, *QKV, *O, *X2, *st2, *Y2, *H1, *dA, *dX2, *dQKV, *dY1, *part;
};

Bufs carve(float* ws, long long M, long long* used) {
  Carve c{ws};
  Bufs b;
  b.Y1 = c.take(M * kC);
  b.st1 = c.take(2 * M);
  b.QKV = c.take(M * 3 * kC);
  b.O = c.take(M * kC);
  b.X2 = c.take(M * kC);
  b.st2 = c.take(2 * M);
  b.Y2 = c.take(M * kC);
  b.H1 = c.take(M * kHid);
  b.dA = c.take(M * kC);
  b.dX2 = c.take(M * kC);
  b.dQKV = c.take(M * 3 * kC);
  b.dY1 = c.take(M * kC);
  b.part = c.take(kParts);
  if (used) *used = c.used;
  return b;
}

template <typename T>
cudaError_t run(const T* x, const T* qg, const T* kg, const T* dout, T* dx, float* dqg, float* dkg, float* g_ln1,
                float* g_qkv, float* g_proj, float* g_ln2, float* g_fc1, float* g_fc2, const float* const* w,
                float* ws, int B, int nT, int H, int W, int shift, cudaStream_t st) {
  const float *ln1_g = w[0], *ln1_b = w[1], *qkv_w = w[2], *qkv_b = w[3], *proj_w = w[4], *proj_b = w[5];
  const float *ln2_g = w[6], *ln2_b = w[7], *fc1_w = w[8], *fc1_b = w[9], *fc2_w = w[10];
  const int HW = H * W;
  const long long Ml = (long long)B * nT * HW;
  const int M = (int)Ml;
  const Bufs b = carve(ws, Ml, nullptr);
  const dim3 agrid((H / kWin) * (W / kWin), nT, B);
  const float* none = nullptr;

  // forward recompute
  CATSEG_TRY(ln_fwd<T>(x, ln1_g, ln1_b, b.Y1, b.st1, Ml, st));
  CATSEG_TRY(gemm(Dense<float>{b.Y1, kC}, Dense<float>{qkv_w, 3 * kC},
                  QkvEpi<T>{b.QKV, qkv_b, qg, kg, (long long)nT * HW, HW}, M, 3 * kC, kC, st));
  CATSEG_TRY(launch_k(win_attn_kernel<T>, agrid, dim3(256), kAttnSmem, st, (const float*)b.QKV, none, b.O, nT, H,
                      W, shift));
  CATSEG_TRY(gemm(Dense<float>{b.O, kC}, Dense<float>{proj_w, kC}, ProjEpi<T>{b.X2, x, proj_b}, M, kC, kC, st));
  CATSEG_TRY(ln_fwd<T>((const float*)b.X2, ln2_g, ln2_b, b.Y2, b.st2, Ml, st));
  CATSEG_TRY(gemm(Dense<float>{b.Y2, kC}, Dense<float>{fc1_w, kHid}, BiasEpi{b.H1, fc1_b, kHid}, M, kHid, kC, st));

  // MLP: fc2 grads, dgelu, fc1 grads, dLN2 input
  CATSEG_TRY(wgrad(GeluT<T>{b.H1}, Dense<T>{dout, kC}, kHid, true, kC, M, g_fc2, b.part, st));
  CATSEG_TRY(gemm(Dense<T>{dout, kC}, DenseT<float>{fc2_w, kC}, GeluGradEpi<T>{b.H1}, M, kHid, kC, st));
  CATSEG_TRY(wgrad(DenseT<float>{b.Y2, kC}, Dense<float>{b.H1, kHid}, kC, true, kHid, M, g_fc1, b.part, st));
  CATSEG_TRY(gemm(Dense<float>{b.H1, kHid}, DenseT<float>{fc1_w, kHid}, Store{b.dA, kC}, M, kC, kHid, st));
  CATSEG_TRY(ln_bwd((const float*)b.dA, (const float*)b.X2, b.st2, ln2_g, dout, b.dX2, g_ln2, b.part, Ml, st));

  // attention: proj grads, dO, window attention backward, guidance sums
  CATSEG_TRY(wgrad(DenseT<float>{b.O, kC}, Dense<float>{b.dX2, kC}, kC, true, kC, M, g_proj, b.part, st));
  CATSEG_TRY(gemm(Dense<float>{b.dX2, kC}, DenseT<float>{proj_w, kC}, Store{b.dA, kC}, M, kC, kC, st));
  CATSEG_TRY(launch_k(win_attn_kernel<T>, agrid, dim3(256), kAttnSmem, st, (const float*)b.QKV,
                      (const float*)b.dA, b.dQKV, nT, H, W, shift));
  if (qg) {
    CATSEG_TRY(sum_mid(b.dQKV, dqg, B, nT, HW, kC, 3 * kC, 0, st));
    CATSEG_TRY(sum_mid(b.dQKV, dkg, B, nT, HW, kC, 3 * kC, kC, st));
  }

  // qkv grads, LN1 backward with the x2 residual
  CATSEG_TRY(wgrad(DenseT<float>{b.Y1, kC}, Dense<float>{b.dQKV, 3 * kC}, kC, true, 3 * kC, M, g_qkv, b.part, st));
  CATSEG_TRY(gemm(Dense<float>{b.dQKV, 3 * kC}, DenseT<float>{qkv_w, 3 * kC}, Store{b.dY1, kC}, M, kC, 3 * kC, st));
  return ln_bwd((const float*)b.dY1, x, b.st1, ln1_g, (const float*)b.dX2, dx, g_ln1, b.part, Ml, st);
}

}  // namespace

// fp32 workspace elements the backward of one block needs
extern "C" long long catseg_swin_block_bwd_workspace(int B, int nT, int H, int W) {
  long long used = 0;
  carve(nullptr, (long long)B * nT * H * W, &used);
  return used;
}

extern "C" int catseg_swin_block_bwd(const void* x, const void* qg, const void* kg, const void* dout, void* dx,
                                     void* dqg, void* dkg, void* g_ln1, void* g_qkv, void* g_proj, void* g_ln2,
                                     void* g_fc1, void* g_fc2, const void* ln1_g, const void* ln1_b,
                                     const void* qkv_w, const void* qkv_b, const void* proj_w, const void* proj_b,
                                     const void* ln2_g, const void* ln2_b, const void* fc1_w, const void* fc1_b,
                                     const void* fc2_w, const void* fc2_b, void* ws, int B, int nT, int H, int W,
                                     int shift, int has_guid, int is_bf16, void* stream) {
  if (H % kWin || W % kWin || B <= 0 || nT <= 0 || shift < 0 || shift >= kWin ||
      (long long)B * nT * H * W > 2147483647ll)
    return (int)cudaErrorInvalidValue;
  const float* w[12] = {static_cast<const float*>(ln1_g), static_cast<const float*>(ln1_b),
                        static_cast<const float*>(qkv_w), static_cast<const float*>(qkv_b),
                        static_cast<const float*>(proj_w), static_cast<const float*>(proj_b),
                        static_cast<const float*>(ln2_g), static_cast<const float*>(ln2_b),
                        static_cast<const float*>(fc1_w), static_cast<const float*>(fc1_b),
                        static_cast<const float*>(fc2_w), static_cast<const float*>(fc2_b)};
  auto f = [](void* p) { return static_cast<float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  if (!has_guid) qg = kg = nullptr;
  if (is_bf16)
    return (int)run<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(qg), static_cast<const bf16*>(kg),
                          static_cast<const bf16*>(dout), static_cast<bf16*>(dx), f(dqg), f(dkg), f(g_ln1),
                          f(g_qkv), f(g_proj), f(g_ln2), f(g_fc1), f(g_fc2), w, f(ws), B, nT, H, W, shift, st);
  return (int)run<float>(static_cast<const float*>(x), static_cast<const float*>(qg), static_cast<const float*>(kg),
                         static_cast<const float*>(dout), static_cast<float*>(dx), f(dqg), f(dkg), f(g_ln1),
                         f(g_qkv), f(g_proj), f(g_ln2), f(g_fc1), f(g_fc2), w, f(ws), B, nT, H, W, shift, st);
}
