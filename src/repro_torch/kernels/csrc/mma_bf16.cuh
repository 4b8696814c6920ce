// Tensor-core building blocks shared by the bfloat16 flash attention
// kernels (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu) on NVIDIA
// Hopper (sm_90a): ldmatrix, mma.sync m16n8k16 bf16 -> f32, cp.async, and
// the staging of a bfloat16 tile into padded shared memory.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//  * A (16 x 16, row-major): a0 = row g, columns 2t, 2t+1; a1 = row g+8,
//    the same columns; a2, a3 = as a0, a1 at columns 2t+8, 2t+9;
//  * B (16 x 8, k x n): b0 = column g, rows 2t, 2t+1; b1 = rows 2t+8, 2t+9;
//  * C (16 x 8, float32): c0, c1 = row g, columns 2t, 2t+1; c2, c3 = row
//    g+8, the same columns.
// So the accumulators of two neighbouring n-tiles, rounded to bf16 pairs,
// are the A fragment of the next product over those 16 columns: a
// probability tile goes from one product to the next in registers.
//
// Tiles sit in shared memory row-major with rows of DP + 8 bf16 values: the
// 16-byte pad makes the 8 row addresses of every ldmatrix phase fall in
// distinct banks (row stride = 16 mod 128 bytes).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and gets row l / 4, columns 2 (l % 4), +1 of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for a 16 x 16 bf16 A, a 16 x 8 bf16 B and a float32 C
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Addresses of one lane for the three operand loads of a 16 x 16 block at
// (row r0, column c0) of a tile with row stride ld (elements):
// A from row-major storage (ldsm_x4 -> a0..a3);
__device__ __forceinline__ uint32_t a_addr(const bf16* s, int ld, int r0,
                                           int c0, int lane) {
  return smem_u32(s + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}
// B of two n-tiles (n rows r0.., k columns c0..) from storage [n][k]
// (ldsm_x4 -> b0, b1 of n-tile 0, then of n-tile 1);
__device__ __forceinline__ uint32_t bn_addr(const bf16* s, int ld, int r0,
                                            int c0, int lane) {
  return smem_u32(s + (r0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 +
                  ((lane >> 3) & 1) * 8);
}
// B of two n-tiles (k rows r0.., n columns c0..) from storage [k][n]
// (ldsm_x4_t -> b0, b1 of n-tile 0, then of n-tile 1).
__device__ __forceinline__ uint32_t bt_addr(const bf16* s, int ld, int r0,
                                            int c0, int lane) {
  return smem_u32(s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
                  (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + R) of an (n, D) bf16 matrix with row stride ss
// (elements) into dst (row stride LD, columns [0, DP)), by NT threads
// numbered tid; rows past n and columns past D are zero. vec: the base
// and the stride are 16-byte aligned, so each thread issues cp.async
// copies of 16 bytes (the tail of a row zero-filled by the src-size
// operand) that land by a later cp_wait; else each thread copies single
// elements, done when it returns.
template <int R, int DP, int LD, int NT>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long ss, int row0, int n, int D,
                                      bool vec, int tid) {
  if (vec) {
    constexpr int CPR = DP / 8;
#pragma unroll 4
    for (int i = tid; i < R * CPR; i += NT) {
      const int r = i / CPR, c = (i - r * CPR) * 8;
      const bool in = row0 + r < n && c < D;
      const bf16* s = in ? src + (long long)(row0 + r) * ss + c : src;
      cp16(smem_u32(dst + r * LD + c), s, in ? min(16, 2 * (D - c)) : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = tid; i < R * DP; i += NT) {
      const int r = i / DP, c = i - r * DP;
      dst[r * LD + c] = (row0 + r < n && c < D)
                            ? src[(long long)(row0 + r) * ss + c]
                            : zero;
    }
  }
}

// Rows [0, R) of a bf16 tile in shared memory (row stride LD) out to rows
// [row0, row0 + R) of an (n, D) matrix with row stride ss, by NT threads:
// 16-byte stores where vec allows and a whole chunk lies inside D.
template <int R, int DP, int LD, int NT>
__device__ __forceinline__ void store(bf16* dst, long long ss, int row0,
                                      int n, int D, const bf16* src,
                                      int tid, bool vec) {
  constexpr int CPR = DP / 8;
  for (int i = tid; i < R * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * 8;
    if (row0 + r >= n || c >= D) continue;
    bf16* o = dst + (long long)(row0 + r) * ss + c;
    if (vec && c + 8 <= D) {
      *reinterpret_cast<uint4*>(o) =
          *reinterpret_cast<const uint4*>(src + r * LD + c);
    } else {
      for (int e = 0; e < min(8, D - c); ++e) o[e] = src[r * LD + c + e];
    }
  }
}

}  // namespace mma
