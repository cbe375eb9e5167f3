// Windowed multi-head attention softmax(scale q k^T + mask) v over
// already-projected q / k / v.
//
// Replaces catseg_tpu/kernels/window_attn.py:fused_window_attention
// (_kernel).  q, k, v, out: (Bw, N, C) row-major in T, windows of one image
// consecutive; mask (nW, N, N) fp32 additive, window w takes mask row w % nW
// (zeros when unshifted).  Logits are scaled after the q.k product and the
// mask added, as the reference's kernel does; the softmax is max-subtracted
// fp32 in both dtypes (the reference has no fast form here); P is rounded to
// T before the value product, which accumulates in fp32.
//
// One CTA per (window, head).  bf16 with N and D multiples of 16 whose
// blocks fit in shared memory (the Swin geometry: 144 tokens, D = 32; not
// 256 tokens, whose 16 warps' fp32 blocks alone take 266 KB) runs on
// tensor cores: K and V head slices in shared memory, one warp per
// 16-query block holding its Q fragments,
// S = Q K^T by wmma into the warp's fp32 block (16 x N), the softmax row by
// row (max and sum by shuffles), P written back as bf16 over the rows already
// read, O = P V by wmma.  Otherwise (fp32, other geometries) CUDA cores: the
// head's K and V as fp32 rows padded to D + 1 (conflict-free column reads);
// each warp takes query rows in turn, holds its q row in registers, keeps
// its N scores spread over the lanes' registers (N <= 256), writes P to a
// per-warp shared row, and forms P.V with lanes over the head's channels.
// The (N, N) logits never reach device memory.
//
// Bound on the card: operations in fp32 (4 Bw N^2 C, 64 GFLOP at 6000
// windows of 144 x 128; every CUDA-core FMA reads one shared word), bytes in
// bf16 (0.89 GB); the tensor-core path is latency-bound on small tiles and
// the fp32 softmax.
#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 256;
constexpr int kMaxJ = kMaxN / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ mask, T* __restrict__ out, int N, int C, int heads, int nW,
                        float scale) {
  constexpr int ld = D + 1;
  extern __shared__ float sm[];
  float* ks = sm;            // (N, ld)
  float* vs = ks + N * ld;   // (N, ld)
  float* ps = vs + N * ld;   // (kWarps, N)
  const int win = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t base = (size_t)win * N * C + (size_t)h * D;
  for (int e = threadIdx.x; e < N * D; e += kThreads) {
    const int n = e / D, d = e % D;
    ks[n * ld + d] = to_f(k[base + (size_t)n * C + d]);
    vs[n * ld + d] = to_f(v[base + (size_t)n * C + d]);
  }
  __syncthreads();
  const float* mw = mask + (size_t)(win % nW) * N * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = ps + warp * N;
  for (int i = warp; i < N; i += kWarps) {
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f(q[base + (size_t)i * C + d]);
    float s[kMaxJ];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = lane + 32 * jj;
      float logit = -INFINITY;
      if (j < N) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], ks[j * ld + d], acc);
        logit = acc * scale + mw[(size_t)i * N + j];
      }
      s[jj] = logit;
      mx = fmaxf(mx, logit);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const float e = lane + 32 * jj < N ? expf(s[jj] - mx) : 0.f;
      s[jj] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = lane + 32 * jj;
      if (j < N) p[j] = rnd<T>(s[jj] / sum);
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(p[j], vs[j * ld + d], acc);
      out[base + (size_t)i * C + d] = from_f<T>(acc);
    }
    __syncwarp();  // p is rewritten by the warp's next row
  }
}

// bf16 on tensor cores; N and D multiples of 16, blockDim = 32 N / 16.
// shared: ks, vs (N, D + 8) bf16 | per warp a (16, N + 4) fp32 block (S, then P as bf16, then O)
template <int D>
__global__ void __launch_bounds__(kMaxN / 16 * 32)
window_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const float* __restrict__ mask, bf16* __restrict__ out, int N, int C, int heads,
                           int nW, float scale) {
  namespace wm = nvcuda::wmma;
  constexpr int ldk = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + N * ldk;
  const int lds = N + 4, ldp = N + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nthreads = blockDim.x;
  float* sb = reinterpret_cast<float*>(vs + N * ldk) + warp * 16 * lds;
  bf16* pb = reinterpret_cast<bf16*>(sb);
  const int win = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t base = (size_t)win * N * C + (size_t)h * D;
  for (int e = threadIdx.x; e < N * (D / 8); e += nthreads) {
    const int n = e / (D / 8), d = (e % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(ks + n * ldk + d) = *reinterpret_cast<const uint4*>(k + base + (size_t)n * C + d);
    *reinterpret_cast<uint4*>(vs + n * ldk + d) = *reinterpret_cast<const uint4*>(v + base + (size_t)n * C + d);
  }
  const int r0 = warp * 16;  // this warp's query rows
  wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> qa[D / 16];
#pragma unroll
  for (int d = 0; d < D / 16; ++d) wm::load_matrix_sync(qa[d], q + base + (size_t)r0 * C + d * 16, C);
  __syncthreads();

  for (int jt = 0; jt < N / 16; ++jt) {
    wm::fragment<wm::accumulator, 16, 16, 16, float> s;
    wm::fill_fragment(s, 0.f);
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> kb;   // K^T
      wm::load_matrix_sync(kb, ks + jt * 16 * ldk + d * 16, ldk);
      wm::mma_sync(s, qa[d], kb, s);
    }
    wm::store_matrix_sync(sb + jt * 16, s, lds, wm::mem_row_major);
  }
  __syncwarp();
  const float* mw = mask + (size_t)(win % nW) * N * N;
  for (int r = 0; r < 16; ++r) {
    float e[kMaxJ];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = lane + 32 * jj;
      e[jj] = j < N ? sb[r * lds + j] * scale + mw[(size_t)(r0 + r) * N + j] : -INFINITY;
      mx = fmaxf(mx, e[jj]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      e[jj] = lane + 32 * jj < N ? expf(e[jj] - mx) : 0.f;
      sum += e[jj];
    }
    sum = warp_sum(sum);
    __syncwarp();  // P row r overlays S rows <= r, all read by now
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = lane + 32 * jj;
      if (j < N) pb[r * ldp + j] = __float2bfloat16(e[jj] / sum);
    }
    __syncwarp();
  }

  wm::fragment<wm::accumulator, 16, 16, 16, float> o[D / 16];
#pragma unroll
  for (int d = 0; d < D / 16; ++d) wm::fill_fragment(o[d], 0.f);
  for (int j = 0; j < N; j += 16) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> pa;
    wm::load_matrix_sync(pa, pb + j, ldp);
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> vb;
      wm::load_matrix_sync(vb, vs + j * ldk + d * 16, ldk);
      wm::mma_sync(o[d], pa, vb, o[d]);
    }
  }
  __syncwarp();  // every lane is done reading P before O overwrites it
#pragma unroll
  for (int d = 0; d < D / 16; ++d) wm::store_matrix_sync(sb + d * 16, o[d], D + 4, wm::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, d = e % D;
    out[base + (size_t)(r0 + r) * C + d] = __float2bfloat16(sb[r * (D + 4) + d]);
  }
}

size_t tc_smem(int N, int D) {
  return (size_t)2 * N * (D + 8) * sizeof(bf16) + (size_t)(N / 16) * 16 * (N + 4) * sizeof(float);
}

// whether the tensor-core kernel's shared memory fits the current device's opt-in limit
bool tc_fits(int N, int D) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return false;
  return tc_smem(N, D) <= (size_t)limit;
}

template <int D>
int run_tc(const void* q, const void* k, const void* v, const void* mask, void* out, int Bw, int N, int C,
           int heads, int nW, float scale, cudaStream_t st) {
  const int warps = N / 16;
  const size_t smem = tc_smem(N, D);
  cudaError_t e = cudaFuncSetAttribute(window_attention_tc_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  window_attention_tc_kernel<D><<<Bw * heads, warps * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<bf16*>(out), N, C, heads, nW, scale);
  return (int)cudaGetLastError();
}

template <int D>
int run(const void* q, const void* k, const void* v, const void* mask, void* out, int Bw, int N, int C,
        int heads, int nW, float scale, int is_bf16, cudaStream_t st) {
  const size_t smem = (size_t)(2 * N * (D + 1) + kWarps * N) * sizeof(float);
  const int grid = Bw * heads;
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(window_attention_kernel<bf16, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    window_attention_kernel<bf16, D><<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(mask), static_cast<bf16*>(out), N, C, heads, nW, scale);
  } else {
    e = cudaFuncSetAttribute(window_attention_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    window_attention_kernel<float, D><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(mask), static_cast<float*>(out), N, C, heads, nW, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Takes N <= 256 tokens per window and head dims 8, 16, 32 or 64.
extern "C" int catseg_window_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                                       int Bw, int N, int C, int heads, int nW, float scale, int is_bf16,
                                       void* stream) {
  if (Bw <= 0 || N <= 0 || N > kMaxN || heads <= 0 || C % heads || nW <= 0 || Bw % nW)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && N % 16 == 0 && tc_fits(N, C / heads)) {
    switch (C / heads) {
      case 16: return run_tc<16>(q, k, v, mask, out, Bw, N, C, heads, nW, scale, st);
      case 32: return run_tc<32>(q, k, v, mask, out, Bw, N, C, heads, nW, scale, st);
      case 64: return run_tc<64>(q, k, v, mask, out, Bw, N, C, heads, nW, scale, st);
      default: break;
    }
  }
  switch (C / heads) {
    case 8: return run<8>(q, k, v, mask, out, Bw, N, C, heads, nW, scale, is_bf16, st);
    case 16: return run<16>(q, k, v, mask, out, Bw, N, C, heads, nW, scale, is_bf16, st);
    case 32: return run<32>(q, k, v, mask, out, Bw, N, C, heads, nW, scale, is_bf16, st);
    case 64: return run<64>(q, k, v, mask, out, Bw, N, C, heads, nW, scale, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
