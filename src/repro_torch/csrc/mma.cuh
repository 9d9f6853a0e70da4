// Tensor-core building blocks shared by the bf16 kernels (K5, K9, K10):
// warp-level bf16 `mma.sync` tiles with fp32 accumulators, their operands
// brought from shared memory by `ldmatrix`, and `cp.async` copies that keep
// the next tile in flight while the current one is multiplied.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
//     a2 = (g, 2t+8..), a3 = (g+8, 2t+8..), two bf16 per register, the
//     lower column in the lower half;
//   B (16 x 8, k x n): b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g);
//   C (16 x 8, fp32): c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
//
// Shared-memory tiles are row-major with `PAD` extra bf16 per row: a row
// pitch of (cols + 8) * 2 bytes is an odd number of 16-byte chunks for
// every width used here (16 to 256 columns), so the 8 rows one `ldmatrix`
// phase reads land in 8 different 16-byte bank groups (no conflicts), and
// every row stays 16-byte aligned for `cp.async`.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

constexpr int PAD = 8;                       // bf16 per row (16 bytes)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only; with `full` false the 16
// bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8, and r[j] receives matrix j in the A/B/C fragment order.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// The same with each matrix transposed (a K-major B operand).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b, bf16 inputs, fp32 accumulators.  Registers only, so not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane address of an A operand (16 x 16 at row m0, column k0) in a
// row-major tile of pitch `ld`, for ldmatrix_x4.
__device__ __forceinline__ int a_offset(int lane, int m0, int k0, int ld) {
  return (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}
// The same A operand from a tile stored k-major ([k][m], pitch ld), for
// ldmatrix_x4_trans (an A that is the transpose of a row-major matrix).
__device__ __forceinline__ int a_offset_km(int lane, int m0, int k0, int ld) {
  return (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
         ((lane >> 3) & 1) * 8;
}
// Lane address of two n8 B operands (n0..n0+15, k0..k0+15) stored n-major
// ([n][k], pitch ld), for ldmatrix_x4: r0, r1 = b0, b1 of columns n0..+7,
// r2, r3 those of n0+8..+15.
__device__ __forceinline__ int b_offset_nk(int lane, int n0, int k0, int ld) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}
// The same for a tile stored k-major ([k][n], pitch ld), for
// ldmatrix_x4_trans.
__device__ __forceinline__ int b_offset_kn(int lane, int n0, int k0, int ld) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}

// Rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major bf16 matrix
// (pitch `ld` elements) into a shared tile of pitch C + PAD; elements at
// rows >= `rows` or columns >= `cols` become zeros.  ASYNC: 16-byte
// cp.async copies, which need a 16-byte aligned base and `ld`, `cols`
// and c0 multiples of 8; else element loads (any alignment and width),
// visible after the next barrier like the copies after their wait.
template <int R, int C, int THREADS, bool ASYNC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int c0, int rows, int cols,
                                          size_t ld, int tid) {
  constexpr int LD = C + PAD;
  if constexpr (ASYNC) {
    constexpr int CHUNKS = C / 8;
    for (int i = tid; i < R * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const bool in = r0 + r < rows && c0 + c < cols;
      const __nv_bfloat16* p = in ? src + (size_t)(r0 + r) * ld + c0 + c : src;
      cp_async16(dst + r * LD + c, p, in);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < R * C; i += THREADS) {
      const int r = i / C, c = i % C;
      const bool in = r0 + r < rows && c0 + c < cols;
      dst[r * LD + c] = in ? src[(size_t)(r0 + r) * ld + c0 + c] : zero;
    }
  }
}

}  // namespace mma
