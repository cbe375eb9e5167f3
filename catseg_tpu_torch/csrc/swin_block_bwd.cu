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
// The forward is recomputed per token into a workspace (LN1 rows and
// statistics, q/k/v with guidance, attention output, x2, LN2 rows, fc1
// pre-activations), then reversed: fc2 / fc1 weight grads and dgelu, LN2
// backward with the residual, proj, the window attention backward (one CTA
// per (window, class, image), the forward's roll-folded gather and region
// mask, dS = P (dP - rowsum(dP P)) as the spec's line 325), the guidance sums
// over classes in a fixed order, qkv, LN1.  bf16 recomputes with the
// forward's fast forms (tanh GELU and its derivative as _gelu_grad,
// single-pass LN variance, the max-free softmax clamped at 60) and rounds
// where the forward rounds; gradients leave as fp32.
//
// fp32 (run): the CUDA-core engine (bwd::gemm) and win_attn_kernel (probabilities
// in shared memory, 4x4 register tiles for q.k and dO.v, four rows per item
// for the products with v, dO, k and q), everything fp32 in the workspace.
// Bound on the card: ~3x the forward's products, 1.4 MFLOP per token per
// block, on fp32 FMAs; ~9 KB of workspace per token.
//
// bf16 (run_tc): the tensor-core engine (bwd::tc::gemm) for the dense
// products and win_attn_tc_kernel for the attention, mma.sync throughout.
// Operand precision per product, by the plain version (autograd through
// swin_block_plain, whose bf16 tensors round their cotangents):
// - recompute qkv, proj, fc1: bf16 LN rows / attention output x bf16 weights;
// - fc2: dout (bf16) and rnd(gelu(h1)) (bf16); fc1: dh1 = dh gelu'(h1), fp32
//   in the plain version, as hi + lo, against LN2's bf16 rows or fc1's bf16
//   weights; proj: dx2 and the attention output, both bf16 tensors there;
//   qkv: dqkv (bf16 there) against LN1's rows or the bf16 weights;
// - attention: q, k, v, dO bf16; P rounded to bf16 for dV = P^T dO (the
//   forward multiplied v by it); dP = dO V^T fp32; dS, fp32 in the plain
//   version, as hi + lo for dQ = dS K and dK = dS^T Q.
// The attention kernel lands a window's q, k, v and dO (144 x 128 bf16
// each, 147 KB) by cp.async, a commit group per head so the first head's
// math starts under the others' loads; 9 warps, one per 16-row strip.  Per
// head, pass A (query rows): S and P into registers, dP = dO V^T, the row
// sums rowsum(dP P), dS, dQ, with 1 / l and the row sums left in shared
// memory; pass B (key rows): S^T = K Q^T and P^T recomputed into registers
// (1 / l by column), dP^T = V dO^T, dS^T, dV and dK.  P and dS never leave
// registers: the C fragments of one product are the A fragments of the
// next.  Bound on the card: 0.56 ms a launch at the train step's (4, 171,
// 24, 24, 128) with bf16 operands throughout; the hi + lo products add ~1/4.
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

// ------------------------------------------------------------ bf16 path

constexpr int kAW = kN / 16;          // warps of the attention kernel: one a 16-row strip
constexpr int kTile = kN * kC;        // bf16 elements of a window's (144, 128) tile, 16 chunks a row

constexpr size_t attn_tc_smem(bool bwd) {
  return (size_t)(bwd ? 4 : 3) * kTile * sizeof(bf16) + 2 * kHeads * kN * sizeof(float) + 2 * kN * sizeof(int);
}

__device__ __forceinline__ void wait_landed(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>();
  }
}

// acc (16 x 144) = a (16 rows x the head's 32 channels, A fragments) times
// the 144 rows of tile t at head chunk hc, transposed
__device__ __forceinline__ void strip_dot(float (&acc)[18][4], const unsigned (&a)[2][4], const bf16* t, int hc,
                                          int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int jp = 0; jp < 9; ++jp) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[2 * jp][e] = acc[2 * jp + 1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      unsigned b[4];
      ldmatrix_x4(b, t + sw<16>(16 * jp + mr + (mi >> 1) * 8, hc + 2 * kk + (mi & 1)));
      mma_bf16(acc[2 * jp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a[kk], b[2], b[3]);
    }
  }
}

// A fragments of 16 columns as the pair hi = bf16(c), lo = bf16(c - hi)
__device__ __forceinline__ void split_a(unsigned (&hi)[4], unsigned (&lo)[4], const float (&c0)[4],
                                        const float (&c1)[4]) {
  float h0[4], h1[4], r0[4], r1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h0[e] = __bfloat162float(__float2bfloat16(c0[e]));
    h1[e] = __bfloat162float(__float2bfloat16(c1[e]));
    r0[e] = c0[e] - h0[e];
    r1[e] = c1[e] - h1[e];
  }
  c_to_a(hi, h0, h1);
  c_to_a(lo, r0, r1);
}

// o (16 x 32) += c (16 x 144 fp32 C fragments, as bf16 A fragments; Split:
// as hi + lo, two products) times the 144 rows of tile t at head chunk hc
template <bool Split>
__device__ __forceinline__ void strip_mix(float (&o)[4][4], const float (&c)[18][4], const bf16* t, int hc,
                                          int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 9; ++kk) {
    unsigned hi[4], lo[4];
    if constexpr (Split) split_a(hi, lo, c[2 * kk], c[2 * kk + 1]);
    else c_to_a(hi, c[2 * kk], c[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, t + sw<16>(16 * kk + mr + (mi & 1) * 8, hc + 2 * dp + (mi >> 1)));
      mma_bf16(o[2 * dp], hi, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
      if constexpr (Split) {
        mma_bf16(o[2 * dp], lo, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }
}

// o * f as bf16 into rows r0, r0 + 8 (window tokens) of out at column col + 8 j + 2 t
__device__ __forceinline__ void store_strip(bf16* out, long long ld, const long long (&row)[2], int col,
                                            const float (&o)[4][4], float f, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    store_bf16x2(out + row[0] * ld + col + 8 * j + 2 * t, o[j][0] * f, o[j][1] * f);
    store_bf16x2(out + row[1] * ld + col + 8 * j + 2 * t, o[j][2] * f, o[j][3] * f);
  }
}

// exp of the clamped, scaled, masked logits of a strip (rows of regions
// rg0, rg1; columns' regions in reg), times fcol[j] by column where fcol is
// given; the row sums of the exponentials to l0, l1
__device__ __forceinline__ void exp_strip(float (&s)[18][4], int rg0, int rg1, const int* reg, int t,
                                          const float* fcol, float& l0, float& l1) {
  l0 = l1 = 0.f;
#pragma unroll
  for (int jt = 0; jt < 18; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * jt + 2 * t + (e & 1);
      const float x = s[jt][e] * kScale + (reg[j] != (e < 2 ? rg0 : rg1) ? -100.f : 0.f);
      float v = fast_exp2(fminf(x, 60.f) * kLog2e);
      if (e < 2) l0 += v;
      else l1 += v;
      if (fcol) v *= fcol[j];
      s[jt][e] = v;
    }
}

// Window attention on the tensor cores, bf16, one CTA per (window, class,
// image), kAW warps, the four heads in turn.  Forward (BWD false): out = O
// (M, 128), rnd(rnd(P) v).  Backward: out = dqkv (M, 384) bf16 from dO
// (M, 128).  The softmax is the forward's bf16 form: exp(min(logit, 60)) / l.
template <bool BWD>
__global__ void __launch_bounds__(kAW * 32, 1) win_attn_tc_kernel(const bf16* qkv, const bf16* dO, bf16* out,
                                                                  int nT, int H, int W, int shift) {
  extern __shared__ __align__(128) unsigned char sm_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(sm_raw);
  bf16* Ks = Qs + kTile;
  bf16* Vs = Ks + kTile;
  bf16* Gs = Vs + kTile;   // dO, backward only
  float* invl = reinterpret_cast<float*>(Qs + (BWD ? 4 : 3) * kTile);   // (heads, kN): 1 / row sum
  float* rsum = invl + kHeads * kN;                                      // (heads, kN): rowsum(dP P)
  int* src = reinterpret_cast<int*>(rsum + kHeads * kN);
  int* reg = src + kN;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, t = lane & 3;
  const long long base = ((long long)blockIdx.z * nT + blockIdx.y) * H * W;

  window_tokens(src, reg, H, W, shift);
  __syncthreads();
  for (int h = 0; h < kHeads; ++h) {   // one commit group a head
    for (int e = tid; e < kN * 4; e += blockDim.x) {
      const int n = e >> 2, c = 4 * h + (e & 3);
      const bf16* row = qkv + (base + src[n]) * 3 * kC + 8 * c;
      cp_async16(Qs + sw<16>(n, c), row);
      cp_async16(Ks + sw<16>(n, c), row + kC);
      cp_async16(Vs + sw<16>(n, c), row + 2 * kC);
      if (BWD) cp_async16(Gs + sw<16>(n, c), dO + (base + src[n]) * kC + 8 * c);
    }
    cp_async_commit();
  }
  const int r0 = 16 * w + (lane >> 2);   // this lane's strip rows r0, r0 + 8
  const int rg0 = reg[r0], rg1 = reg[r0 + 8];
  const long long row[2] = {base + src[r0], base + src[r0 + 8]};
  for (int h = 0; h < kHeads; ++h) {
    wait_landed(kHeads - 1 - h);
    __syncthreads();
    const int hc = 4 * h;
    unsigned a[2][4];
    float p[18][4], l0, l1;
    // pass A, query rows: P
    load_a<16>(a[0], Qs, w, hc / 2, lane);
    load_a<16>(a[1], Qs, w, hc / 2 + 1, lane);
    strip_dot(p, a, Ks, hc, lane);
    exp_strip(p, rg0, rg1, reg, t, nullptr, l0, l1);
    const float f0 = 1.f / quad_sum(l0), f1 = 1.f / quad_sum(l1);
#pragma unroll
    for (int jt = 0; jt < 18; ++jt) {
      p[jt][0] *= f0;
      p[jt][1] *= f0;
      p[jt][2] *= f1;
      p[jt][3] *= f1;
    }
    float o[4][4] = {};
    if constexpr (!BWD) {
      strip_mix<false>(o, p, Vs, hc, lane);   // O = rnd(P) V
      store_strip(out, kC, row, 32 * h, o, 1.f, t);
      continue;
    }
    // dP = dO V^T, the row sums of dP P, dS = P (dP - rowsum), dQ = dS K scale
    float d[18][4];
    load_a<16>(a[0], Gs, w, hc / 2, lane);
    load_a<16>(a[1], Gs, w, hc / 2 + 1, lane);
    strip_dot(d, a, Vs, hc, lane);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int jt = 0; jt < 18; ++jt) {
      d0 += p[jt][0] * d[jt][0] + p[jt][1] * d[jt][1];
      d1 += p[jt][2] * d[jt][2] + p[jt][3] * d[jt][3];
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
#pragma unroll
    for (int jt = 0; jt < 18; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[jt][e] = p[jt][e] * (d[jt][e] - (e < 2 ? d0 : d1));
    strip_mix<true>(o, d, Ks, hc, lane);
    store_strip(out, 3 * kC, row, 32 * h, o, kScale, t);
    if (t == 0) {
      invl[h * kN + r0] = f0;
      invl[h * kN + r0 + 8] = f1;
      rsum[h * kN + r0] = d0;
      rsum[h * kN + r0 + 8] = d1;
    }
    __syncthreads();
    // pass B, key rows: P^T, dV = rnd(P)^T dO, dS^T, dK = dS^T Q scale
    load_a<16>(a[0], Ks, w, hc / 2, lane);
    load_a<16>(a[1], Ks, w, hc / 2 + 1, lane);
    strip_dot(p, a, Qs, hc, lane);
    exp_strip(p, rg0, rg1, reg, t, invl + h * kN, l0, l1);
    float dv[4][4] = {};
    strip_mix<false>(dv, p, Gs, hc, lane);
    store_strip(out, 3 * kC, row, 2 * kC + 32 * h, dv, 1.f, t);
    load_a<16>(a[0], Vs, w, hc / 2, lane);
    load_a<16>(a[1], Vs, w, hc / 2 + 1, lane);
    strip_dot(d, a, Gs, hc, lane);
    const float* rs = rsum + h * kN;
#pragma unroll
    for (int jt = 0; jt < 18; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[jt][e] = p[jt][e] * (d[jt][e] - rs[8 * jt + 2 * t + (e & 1)]);
    float dk[4][4] = {};
    strip_mix<true>(dk, d, Qs, hc, lane);
    store_strip(out, 3 * kC, row, kC + 32 * h, dk, kScale, t);
  }
}

// qkv = rnd(acc + b), guidance added to q / k and rounded again, bf16
struct QkvEpi16 {
  bf16* qkv;
  const float* b;
  const bf16 *qg, *kg;
  long long per_img;
  int HW;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    v0 = rnd<bf16>(v0 + b[n]);
    v1 = rnd<bf16>(v1 + b[n + 1]);
    if (qg && n < 2 * kC) {
      const float2 g = unpack_bf16((n < kC ? qg : kg) + ((m / per_img) * HW + m % HW) * kC + n % kC);
      v0 += g.x;
      v1 += g.y;
    }
    store_bf16x2(qkv + m * 3 * kC + n, v0, v1);
  }
};

// x2 = rnd(x + rnd(acc + b)), bf16
struct ProjEpi16 {
  bf16* x2;
  const bf16* x;
  const float* b;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    const float2 xv = unpack_bf16(x + m * kC + n);
    store_bf16x2(x2 + m * kC + n, xv.x + rnd<bf16>(v0 + b[n]), xv.y + rnd<bf16>(v1 + b[n + 1]));
  }
};

// h1 = acc + b (fp32, for gelu'), and fc2's input rnd(gelu(h1)) in bf16
struct Fc1Epi {
  float* h;
  bf16* act;
  const float* b;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    v0 += b[n];
    v1 += b[n + 1];
    *reinterpret_cast<float2*>(h + m * kHid + n) = make_float2(v0, v1);
    store_bf16x2(act + m * kHid + n, gelu<bf16>(v0), gelu<bf16>(v1));
  }
};

// dh1 = acc * gelu'(h1) as the pair hi + lo
struct GeluGradEpi16 {
  const float* h;
  bf16* d;
  long long lo;
  __device__ __forceinline__ void operator()(long long m, long long n, float v0, float v1, int) const {
    const float2 hv = *reinterpret_cast<const float2*>(h + m * kHid + n);
    tc::split_store(d + m * kHid + n, lo, v0 * gelu_grad<bf16>(hv.x), v1 * gelu_grad<bf16>(hv.y));
  }
};

// bf16 weights of the products, (K, N) row-major: the recompute's as the
// forward's, the input grads' transposed
struct Packed {
  bf16 *qkv, *qkvt, *proj, *projt, *fc1, *fc1t, *fc2t;
};

struct Bufs16 {
  bf16 *Y1, *QKV, *O, *X2, *Y2, *G, *dH1, *dX2, *dO, *dQKV;
  float *st1, *st2, *H1, *dA;
  long long h_lo;   // dH1's lo plane, after its hi plane
  Packed w;
  float* part;
};

Bufs16 carve16(float* ws, long long M, long long* used) {
  Carve c{ws};
  Bufs16 b;
  b.Y1 = c.take16(M * kC);
  b.QKV = c.take16(M * 3 * kC);
  b.O = c.take16(M * kC);
  b.X2 = c.take16(M * kC);
  b.Y2 = c.take16(M * kC);
  b.G = c.take16(M * kHid);
  b.h_lo = M * kHid;
  b.dH1 = c.take16(2 * M * kHid);
  b.dX2 = c.take16(M * kC);
  b.dO = c.take16(M * kC);
  b.dQKV = c.take16(M * 3 * kC);
  b.st1 = c.take(2 * M);
  b.st2 = c.take(2 * M);
  b.H1 = c.take(M * kHid);
  b.dA = c.take(M * kC);
  b.w.qkv = c.take16(kC * 3 * kC);
  b.w.qkvt = c.take16(kC * 3 * kC);
  b.w.proj = c.take16(kC * kC);
  b.w.projt = c.take16(kC * kC);
  b.w.fc1 = c.take16(kC * kHid);
  b.w.fc1t = c.take16(kC * kHid);
  b.w.fc2t = c.take16(kC * kHid);
  b.part = c.take(kParts);
  if (used) *used = c.used;
  return b;
}

cudaError_t run_tc(const bf16* x, const bf16* qg, const bf16* kg, const bf16* dout, bf16* dx, float* dqg, float* dkg,
                   float* g_ln1, float* g_qkv, float* g_proj, float* g_ln2, float* g_fc1, float* g_fc2,
                   const float* const* w, float* ws, int B, int nT, int H, int W, int shift, cudaStream_t st) {
  using tc::Rows;
  const float *ln1_g = w[0], *ln1_b = w[1], *qkv_w = w[2], *qkv_b = w[3], *proj_w = w[4], *proj_b = w[5];
  const float *ln2_g = w[6], *ln2_b = w[7], *fc1_w = w[8], *fc1_b = w[9], *fc2_w = w[10];
  const int HW = H * W;
  const long long Ml = (long long)B * nT * HW;
  const int M = (int)Ml;
  const Bufs16 b = carve16(ws, Ml, nullptr);
  const Packed& pw = b.w;
  const dim3 agrid((H / kWin) * (W / kWin), nT, B);
  const void* dm = x;   // a mapped address for the zero-filled chunks
  const long long hl = b.h_lo;

  CATSEG_TRY(tc::pack(qkv_w, pw.qkv, kC, 3 * kC, 0, st));
  CATSEG_TRY(tc::pack(qkv_w, pw.qkvt, kC, 3 * kC, 1, st));
  CATSEG_TRY(tc::pack(proj_w, pw.proj, kC, kC, 0, st));
  CATSEG_TRY(tc::pack(proj_w, pw.projt, kC, kC, 1, st));
  CATSEG_TRY(tc::pack(fc1_w, pw.fc1, kC, kHid, 0, st));
  CATSEG_TRY(tc::pack(fc1_w, pw.fc1t, kC, kHid, 1, st));
  CATSEG_TRY(tc::pack(fc2_w, pw.fc2t, kHid, kC, 1, st));

  // forward recompute
  CATSEG_TRY(ln_fwd<bf16>(x, ln1_g, ln1_b, b.Y1, b.st1, Ml, st));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<false>{b.Y1, kC, 0}, Rows<false>{pw.qkv, 3 * kC, 0},
                                    QkvEpi16{b.QKV, qkv_b, qg, kg, (long long)nT * HW, HW}, M, 3 * kC, kC, dm, st)));
  CATSEG_TRY(launch_k(win_attn_tc_kernel<false>, agrid, dim3(kAW * 32), attn_tc_smem(false), st,
                      (const bf16*)b.QKV, (const bf16*)nullptr, b.O, nT, H, W, shift));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<false>{b.O, kC, 0}, Rows<false>{pw.proj, kC, 0},
                                    ProjEpi16{b.X2, x, proj_b}, M, kC, kC, dm, st)));
  CATSEG_TRY(ln_fwd<bf16>((const bf16*)b.X2, ln2_g, ln2_b, b.Y2, b.st2, Ml, st));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<false>{b.Y2, kC, 0}, Rows<false>{pw.fc1, kHid, 0},
                                    Fc1Epi{b.H1, b.G, fc1_b}, M, kHid, kC, dm, st)));

  // MLP: fc2 grads, dgelu, fc1 grads, dLN2 input
  CATSEG_TRY((tc::wgrad<128, 128, 2, true>(Rows<false>{b.G, kHid, 0}, Rows<false>{dout, kC, 0}, kHid, kC, M, g_fc2,
                                     b.part, dm, st)));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<false>{dout, kC, 0}, Rows<false>{pw.fc2t, kHid, 0},
                                    GeluGradEpi16{b.H1, b.dH1, hl}, M, kHid, kC, dm, st)));
  CATSEG_TRY((tc::wgrad<128, 128, 2, true>(Rows<false>{b.Y2, kC, 0}, Rows<true>{b.dH1, kHid, hl}, kC, kHid, M, g_fc1,
                                     b.part, dm, st)));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<true>{b.dH1, kHid, hl}, Rows<false>{pw.fc1t, kC, 0}, Store{b.dA, kC}, M,
                                    kC, kHid, dm, st)));
  CATSEG_TRY(ln_bwd((const float*)b.dA, (const bf16*)b.X2, b.st2, ln2_g, dout, b.dX2, g_ln2, b.part, Ml, st));

  // attention: proj grads, dO, window attention backward, guidance sums
  CATSEG_TRY((tc::wgrad<128, 128, 2, true>(Rows<false>{b.O, kC, 0}, Rows<false>{b.dX2, kC, 0}, kC, kC, M, g_proj, b.part,
                                     dm, st)));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<false>{b.dX2, kC, 0}, Rows<false>{pw.projt, kC, 0},
                                    tc::StoreBf16{b.dO, kC}, M, kC, kC, dm, st)));
  CATSEG_TRY(launch_k(win_attn_tc_kernel<true>, agrid, dim3(kAW * 32), attn_tc_smem(true), st, (const bf16*)b.QKV,
                      (const bf16*)b.dO, b.dQKV, nT, H, W, shift));
  if (qg) {
    CATSEG_TRY(sum_mid_in(Bf16In{b.dQKV}, dqg, B, nT, HW, kC, 3 * kC, 0, st));
    CATSEG_TRY(sum_mid_in(Bf16In{b.dQKV}, dkg, B, nT, HW, kC, 3 * kC, kC, st));
  }

  // qkv grads, LN1 backward with the x2 residual
  CATSEG_TRY((tc::wgrad<128, 128, 2, true>(Rows<false>{b.Y1, kC, 0}, Rows<false>{b.dQKV, 3 * kC, 0}, kC, 3 * kC, M,
                                     g_qkv, b.part, dm, st)));
  CATSEG_TRY((tc::gemm<128, 128, 2>(Rows<false>{b.dQKV, 3 * kC, 0}, Rows<false>{pw.qkvt, kC, 0}, Store{b.dA, kC}, M,
                                    kC, 3 * kC, dm, st)));
  return ln_bwd((const float*)b.dA, x, b.st1, ln1_g, (const bf16*)b.dX2, dx, g_ln1, b.part, Ml, st);
}

}  // namespace

// workspace elements (fp32-sized) the backward of one block needs
extern "C" long long catseg_swin_block_bwd_workspace(int B, int nT, int H, int W, int is_bf16) {
  long long used = 0;
  if (is_bf16)
    carve16(nullptr, (long long)B * nT * H * W, &used);
  else
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
    return (int)run_tc(static_cast<const bf16*>(x), static_cast<const bf16*>(qg), static_cast<const bf16*>(kg),
                       static_cast<const bf16*>(dout), static_cast<bf16*>(dx), f(dqg), f(dkg), f(g_ln1), f(g_qkv),
                       f(g_proj), f(g_ln2), f(g_fc1), f(g_fc2), w, f(ws), B, nT, H, W, shift, st);
  return (int)run<float>(static_cast<const float*>(x), static_cast<const float*>(qg), static_cast<const float*>(kg),
                         static_cast<const float*>(dout), static_cast<float*>(dx), f(dqg), f(dkg), f(g_ln1),
                         f(g_qkv), f(g_proj), f(g_ln2), f(g_fc1), f(g_fc2), w, f(ws), B, nT, H, W, shift, st);
}
