// Register-fragment helpers for the two softmax-attention kernels
// (clip_attn.cu, window_attn.cu) on sm_90a: ldmatrix (plain and .trans),
// mma.sync m16n8k16 bf16 -> fp32, quad reductions, the accumulator -> A
// fragment repack and cp.async.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so a row's values sit in the four lanes of one quad, and two C tiles side
// by side (16 columns) are, rounded to bf16, the A fragment of those 16
// columns: softmax probabilities go from the Q K^T accumulators straight
// into the P V product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace catseg {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed (B fragments of a row-major (k, n) tile)
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU alone (ex2.approx.ftz: ~2 ulp, subnormal results flushed
// to 0); exp(y - m) = fast_exp2(y * log2e - m * log2e), one FFMA before it
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// A fragment of 16 columns from the C fragments of its two 8-column halves
__device__ __forceinline__ void c_to_a(unsigned (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// over the four lanes of a quad (the lanes holding one fragment row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 bytes global -> shared, asynchronous; zero-filled where !valid (src is
// then not read but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n of this thread's committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// ---- bf16 tiles in shared memory for the mma.sync products (swin_block.cu,
// class_layer.cu): rows of RC 16-byte chunks, XOR-swizzled by the row's low
// 3 bits, so the 8 row addresses of an ldmatrix at one chunk index hit 8
// distinct bank groups ----

// element offset of (row, 16-byte chunk) in a swizzled tile of RC chunks a row
template <int RC>
__device__ __forceinline__ int sw(int row, int chunk) {
  return row * RC * 8 + ((chunk ^ (row & 7)) << 3);
}

// chunks a tile row is allocated where RC may be below 8: swz needs 2, 4 or a multiple of 8
constexpr int alloc_chunks(int c) { return c <= 2 ? 2 : c <= 4 ? 4 : (c + 7) / 8 * 8 == c ? c : c <= 8 ? 8 : 16; }

// sw for any such RC: rows of 2 or 4 chunks XOR their chunk by higher row
// bits, so that the 8 rows an ldmatrix reads at one chunk still fall in 8
// distinct 16-byte bank groups (bwd_common.cuh's tiles, mlp.cu's weight chunks)
template <int RC>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (RC >= 8) return sw<RC>(row, chunk);
  else if constexpr (RC == 4) return row * 32 + ((chunk ^ ((row >> 1) & 3)) << 3);
  else return row * 16 + ((chunk ^ ((row >> 2) & 1)) << 3);
}

template <int RC>
__device__ __forceinline__ bf16* at(bf16* tile, int row, int col) {
  return tile + sw<RC>(row, col >> 3) + (col & 7);
}

__device__ __forceinline__ float2 unpack_bf16(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(lo, hi);
}

// A fragment of rows 16 strip .. + 15, columns 16 ks .. + 15
template <int RC>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* tile, int strip, int ks, int lane) {
  ldmatrix_x4(a, tile + sw<RC>(16 * strip + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * ks + (lane >> 4)));
}

template <int MS, int NT>
__device__ __forceinline__ void zero(float (&acc)[MS][NT][4]) {
#pragma unroll
  for (int i = 0; i < MS; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

}  // namespace catseg
