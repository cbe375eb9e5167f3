// Maskless multi-head softmax attention for the dense CLIP image encode.
//
// Replaces catseg_tpu/kernels/clip_attn.py:fused_dense_attention (_kernel).
// q, k, v, o: (B, S, W) row-major, heads of 64 channels, any S >= 1 (577
// for ViT-B/16 at 384^2 and ViT-L/14 at 336^2).  The (S, S) logits never
// reach device memory: 64-key tiles of K and V stream through shared memory
// while each query row keeps an online (running-max) fp32 softmax, and the
// ragged key tail (577 = 9 x 64 + 1) gets -inf logits.  Logits are scaled
// after the q.k product, as the reference does.
//
// Bound on the card: at (10, 577, 768) the work is 10.2 GFLOP over 35 MB,
// 0.011 ms on the bf16 tensor cores; 1200 blocks of little work each, so
// latency (loads, the softmax's exps, the block's short life) sets the time.
//
// bf16 (FA2 order, tensor cores): a block is one (64-query tile, head,
// image), four warps of 16 query rows (8 warps on 128 queries were
// measured once at S = 577 and tied with four: PERF.md).  The Q tile comes in
// once by cp.async and sits in registers as mma A fragments (ldmatrix).  K
// and V tiles (64 keys x 64 channels, 8 KB each) stream through a
// two-stage cp.async ring, the next tile loading while this one computes;
// rows are XOR-swizzled in 16-byte chunks so ldmatrix is conflict-free.
// S = Q K^T by mma.sync m16n8k16 into fp32 registers, the row max and sum
// over each quad's four lanes, the O accumulators rescaled when the max
// moves; P = exp(s - m) (on the SFU, ex2.approx, the scale and log2 e
// folded into one FMA) rounded to bf16 goes from the accumulators straight
// into A fragments and O += P V reads V by ldmatrix.trans.  Neither S nor P
// touches shared memory.  The epilogue multiplies O by 1 / l.  So P is
// rounded before it is normalised, where the reference rounds the
// normalised P (the standard trade; within 2^-5, tests/
// test_torch_attention_order.py emulates this order).  mma.sync rather than
// wgmma: at the tensor cores' rate the products are ~0.01 ms of the block's
// ~0.07, which goes to loads, the softmax and barriers (8 warps, half the
// K / V traffic per query, measured the same), so faster products would not
// move it.
//
// fp32 (CUDA cores; TF32 would miss the 1e-4 bound): a block is one
// (64-query tile, head, image) of 256 threads, each owning a 4 x 4 register
// tile of S (rows ty + 16a, keys tx + 16b) and of O (rows ty + 16a, channels
// 4tx..4tx+3), so every 16-byte shared read feeds 8 FMAs; Q, K, V and P
// tiles in shared memory (rows padded to 68 floats), K and V double-buffered
// by cp.async, the row statistics reduced over the 16 lanes of a half-warp.
#include "attn_common.cuh"
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kD = 64;   // head dim
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = 4;                         // warps of a bf16 block
constexpr int kBQ = kWarps * 16, kNT = kWarps * 32;  // its queries (16 a warp) and threads

// element offset of (row, 16-byte chunk) in a swizzled (rows, 64) bf16 tile
__device__ __forceinline__ int swz(int row, int chunk) { return row * kD + ((chunk ^ (row & 7)) << 3); }

__global__ void __launch_bounds__(kNT)
dense_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                            bf16* __restrict__ o, int S, int W, float scale) {
  __shared__ __align__(128) bf16 Qs[kBQ * kD];
  __shared__ __align__(128) bf16 Ks[2][kBK * kD];
  __shared__ __align__(128) bf16 Vs[2][kBK * kD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = (size_t)blockIdx.z * S * W + (size_t)blockIdx.y * kD;

  auto load = [&](bf16* dst, const bf16* src, int row0, int rows) {
    for (int e = tid; e < rows * 8; e += kNT) {
      const int r = e >> 3, c = e & 7;
      const bool ok = row0 + r < S;
      cp_async16(dst + swz(r, c), src + base + (size_t)(ok ? row0 + r : 0) * W + c * 8, ok);
    }
  };
  load(Qs, q, q0, kBQ);
  load(Ks[0], k, 0, kBK);
  load(Vs[0], v, 0, kBK);
  cp_async_commit();

  const int ntiles = (S + kBK - 1) / kBK;
  const float sl2 = scale * kLog2e;   // exp(x * scale) = exp2(x * sl2)
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: this lane's matrix and row
  unsigned qa[4][4];
  float oacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  // rows g and g + 8: running max (log2 units) and this lane's share of the sum
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load(Ks[(t + 1) & 1], k, (t + 1) * kBK, kBK);
      load(Vs[(t + 1) & 1], v, (t + 1) * kBK, kBK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(qa[kk], Qs + swz(warp * 16 + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
    }
    const bf16* ks = Ks[t & 1];
    const bf16* vs = Vs[t & 1];

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, ks + swz(16 * jp + mr + (mi >> 1) * 8, 2 * kk + (mi & 1)));
        mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
    }

    // the row max of the raw products (scale > 0), then p = 2^(s sl2 - m sl2)
    const int key0 = t * kBK + 2 * t4;
    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = key0 + 8 * j + (e & 1) < S ? s[j][e] : -INFINITY;
      tm0 = fmaxf(tm0, fmaxf(s[j][0], s[j][1]));
      tm1 = fmaxf(tm1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(tm0) * sl2), mn1 = fmaxf(m1, quad_max(tm1) * sl2);
    const float c0 = fast_exp2(m0 - mn0), c1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      oacc[j][0] *= c0;
      oacc[j][1] *= c0;
      oacc[j][2] *= c1;
      oacc[j][3] *= c1;
      s[j][0] = fast_exp2(fmaf(s[j][0], sl2, -m0));
      s[j][1] = fast_exp2(fmaf(s[j][1], sl2, -m0));
      s[j][2] = fast_exp2(fmaf(s[j][2], sl2, -m1));
      s[j][3] = fast_exp2(fmaf(s[j][3], sl2, -m1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        unsigned b[4];
        ldmatrix_x4_trans(b, vs + swz(16 * kk + mr + (mi & 1) * 8, 2 * dp + (mi >> 1)));
        mma_bf16(oacc[2 * dp], pa, b[0], b[1]);
        mma_bf16(oacc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();   // this stage is refilled by the next iteration's prefetch
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (r0 < S)
      *reinterpret_cast<unsigned*>(o + base + (size_t)r0 * W + col) = pack_bf16(oacc[j][0] * inv0, oacc[j][1] * inv0);
    if (r0 + 8 < S)
      *reinterpret_cast<unsigned*>(o + base + (size_t)(r0 + 8) * W + col) =
          pack_bf16(oacc[j][2] * inv1, oacc[j][3] * inv1);
  }
}

constexpr int kF32Threads = 256;
constexpr int kLdf = kD + 4;   // fp32 tile row stride (floats): 16-byte rows, conflict-free reads
constexpr size_t kF32Smem = (size_t)(5 * kBK + kBK) * kLdf * sizeof(float);   // Q, P, 2 x (K, V)

__global__ void __launch_bounds__(kF32Threads)
dense_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            float* __restrict__ o, int S, int W, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                 // (64 queries, kLdf)
  float* Ps = Qs + kBK * kLdf;     // (64 queries, kLdf): this tile's probabilities
  float* Ks = Ps + kBK * kLdf;     // 2 stages of (64 keys, kLdf)
  float* Vs = Ks + 2 * kBK * kLdf;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBK;
  const size_t base = (size_t)blockIdx.z * S * W + (size_t)blockIdx.y * kD;

  auto load = [&](float* dst, const float* src, int row0) {
    for (int e = tid; e < kBK * (kD / 4); e += kF32Threads) {
      const int r = e >> 4, c = (e & 15) * 4;
      const bool ok = row0 + r < S;
      cp_async16(dst + r * kLdf + c, src + base + (size_t)(ok ? row0 + r : 0) * W + c, ok);
    }
  };
  load(Qs, q, q0);
  load(Ks, k, 0);
  load(Vs, v, 0);
  cp_async_commit();

  const int ntiles = (S + kBK - 1) / kBK;
  float oacc[4][4] = {};
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) m[a] = -INFINITY, l[a] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {
      load(Ks + (st ^ 1) * kBK * kLdf, k, (t + 1) * kBK);
      load(Vs + (st ^ 1) * kBK * kLdf, v, (t + 1) * kBK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = Ks + st * kBK * kLdf;
    const float* vs = Vs + st * kBK * kLdf;

    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * kLdf + d);
#pragma unroll
      for (int b = 0; b < 4; ++b) kv[b] = *reinterpret_cast<const float4*>(ks + (tx + 16 * b) * kLdf + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qv[a].x, kv[b].x, s[a][b]);
          s[a][b] = fmaf(qv[a].y, kv[b].y, s[a][b]);
          s[a][b] = fmaf(qv[a].z, kv[b].z, s[a][b]);
          s[a][b] = fmaf(qv[a].w, kv[b].w, s[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = t * kBK + tx + 16 * b < S ? s[a][b] * scale : -INFINITY;
        mx = fmaxf(mx, s[a][b]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[a], mx), corr = expf(m[a] - mn);
      m[a] = mn;
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - mn);
        sum += p;
        Ps[(ty + 16 * a) * kLdf + tx + 16 * b] = p;
      }
      l[a] = l[a] * corr + sum;   // this thread's share; the half-warp's shares add up at the end
#pragma unroll
      for (int c = 0; c < 4; ++c) oacc[a][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * a) * kLdf + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) vv[u] = *reinterpret_cast<const float4*>(vs + (j + u) * kLdf + 4 * tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p[4] = {pv[a].x, pv[a].y, pv[a].z, pv[a].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          oacc[a][0] = fmaf(p[u], vv[u].x, oacc[a][0]);
          oacc[a][1] = fmaf(p[u], vv[u].y, oacc[a][1]);
          oacc[a][2] = fmaf(p[u], vv[u].z, oacc[a][2]);
          oacc[a][3] = fmaf(p[u], vv[u].w, oacc[a][3]);
        }
      }
    }
    __syncthreads();   // P and this K/V stage are rewritten next iteration
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float sum = l[a];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = q0 + ty + 16 * a;
    if (row < S) {
      const float inv = 1.f / sum;
      *reinterpret_cast<float4*>(o + base + (size_t)row * W + 4 * tx) =
          make_float4(oacc[a][0] * inv, oacc[a][1] * inv, oacc[a][2] * inv, oacc[a][3] * inv);
    }
  }
}

}  // namespace

extern "C" int catseg_dense_attention(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int W, int heads, int head_dim, float scale,
                                      int is_bf16, void* stream) {
  if (head_dim != kD || heads * kD != W || S <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((S + kBQ - 1) / kBQ, heads, B);
    dense_attention_bf16_kernel<<<grid, kNT, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), S, W, scale);
  } else {
    const cudaError_t e = cudaFuncSetAttribute(dense_attention_fp32_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kF32Smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((S + kBK - 1) / kBK, heads, B);
    dense_attention_fp32_kernel<<<grid, kF32Threads, kF32Smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), S, W, scale);
  }
  return (int)cudaGetLastError();
}
