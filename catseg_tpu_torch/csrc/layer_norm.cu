// Row LayerNorm with fp32 statistics over the last axis, eps given.
//
// Replaces catseg_tpu/kernels/layer_norm.py:fused_layer_norm (Pallas
// _kernel).  x, out: (M, C) contiguous, fp32 or bf16; gamma, beta (C,) fp32.
// Variance follows the reference's dtype gate: single-pass E[x^2] - mu^2
// for bf16 rows, two-pass for fp32 rows.  The output keeps x's dtype.
//
// Bound on the card: device-memory bytes (one read and one write of every
// element; 17.7 MB, 5.3 us at the CLIP encoder's 5770 x 768 bf16 rows).
// The design keeps those bytes in flight in wide requests: one warp a row,
// each lane 16-byte vectors (768 bf16 = 96 vectors, 3 a lane; no padding of
// the row to a power of two), the whole row in registers between the
// statistics and the normalisation, the warp's next row requested before
// this one is reduced; gamma and beta in registers, loaded once a warp; two
// programs a SM walking the rows with a grid stride.
#include <algorithm>

#include "common.cuh"

using namespace catseg;

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kMaxC = 4096;
// programs (of 8 warps) a SM, each walking the rows with a grid stride
constexpr int kBlocksPerSM = 2;

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

template <int P>
__device__ __forceinline__ uint4 pack(const float (&v)[P]);

template <>
__device__ __forceinline__ uint4 pack<8>(const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <>
__device__ __forceinline__ uint4 pack<4>(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// IT: 16-byte vectors a lane (vector i of lane l covers columns
// (32 i + l) P .. + P - 1, P values of T in 16 bytes); lanes past the row's
// NV = C / P vectors idle
template <typename T, int IT>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
                  T* __restrict__ out, int M, int C, float eps) {
  constexpr int P = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, NV = C / P;
  const float inv_c = 1.f / C;
  float gr[IT][P], br[IT][P];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int vi = 32 * i + lane;
#pragma unroll
    for (int e4 = 0; e4 < P / 4; ++e4) {
      float4 gg = make_float4(0.f, 0.f, 0.f, 0.f), bb = gg;
      if (vi < NV) {
        gg = __ldg(reinterpret_cast<const float4*>(g + vi * P) + e4);
        bb = __ldg(reinterpret_cast<const float4*>(b + vi * P) + e4);
      }
      const float gs[4] = {gg.x, gg.y, gg.z, gg.w}, bs[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gr[i][4 * e4 + e] = gs[e];
        br[i][4 * e4 + e] = bs[e];
      }
    }
  }
  const int stride = gridDim.x * kWarps;
  int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  uint4 cur[IT], nxt[IT];
  auto load = [&](uint4 (&dst)[IT], int row) {
    const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)row * C);
#pragma unroll
    for (int i = 0; i < IT; ++i) dst[i] = 32 * i + lane < NV ? __ldcs(p + 32 * i + lane) : make_uint4(0, 0, 0, 0);
  };
  if (r < M) load(cur, r);
  for (; r < M; r += stride) {
    if (r + stride < M) load(nxt, r + stride);
    float v[IT][P];
#pragma unroll
    for (int i = 0; i < IT; ++i) unpack(cur[i], v[i]);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < IT; ++i)
#pragma unroll
      for (int e = 0; e < P; ++e) s += v[i][e];
    const float mean = warp_sum(s) * inv_c;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      if (32 * i + lane < NV) {
#pragma unroll
        for (int e = 0; e < P; ++e) q += Fast<T>::value ? v[i][e] * v[i][e] : (v[i][e] - mean) * (v[i][e] - mean);
      }
    }
    const float var = Fast<T>::value ? warp_sum(q) * inv_c - mean * mean : warp_sum(q) * inv_c;
    const float rs = rsqrtf(var + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + (size_t)r * C);
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      if (32 * i + lane < NV) {
        float y[P];
#pragma unroll
        for (int e = 0; e < P; ++e) y[e] = (v[i][e] - mean) * rs * gr[i][e] + br[i][e];
        __stcs(orow + 32 * i + lane, pack<P>(y));
      }
    }
#pragma unroll
    for (int i = 0; i < IT; ++i) cur[i] = nxt[i];
  }
}

template <typename T, int IT>
int run(const void* x, const void* g, const void* b, void* out, int M, int C, float eps, cudaStream_t st) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = std::min(kBlocksPerSM * sms, (M + kWarps - 1) / kWarps);
  layer_norm_kernel<T, IT><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<const float*>(g),
                                                        static_cast<const float*>(b), static_cast<T*>(out), M, C,
                                                        eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* g, const void* b, void* out, int M, int C, float eps, cudaStream_t st) {
  constexpr int P = 16 / sizeof(T);
  switch ((C / P + 31) / 32) {
#define CASE(n) \
  case n: return run<T, n>(x, g, b, out, M, C, eps, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C a multiple of 8 up to 4096 (bf16) or of 4 up to 2048 (fp32); M >= 1.
extern "C" int catseg_layer_norm(const void* x, const void* g, const void* b, void* out, int M, int C, float eps,
                                 int is_bf16, void* stream) {
  if (M <= 0 || C <= 0 || C > kMaxC || C % (is_bf16 ? 8 : 4) || (!is_bf16 && C > kMaxC / 2))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(x, g, b, out, M, C, eps, st) : dispatch<float>(x, g, b, out, M, C, eps, st);
}
