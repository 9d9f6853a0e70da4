// K11: the attention backward, the port of the reference's `_fa_bwd`
// (src/repro/kernels/ops.py:65, the XLA backward of its flash attention
// behind `jax.custom_vjp`).  It pairs with K5 (csrc/flash_attention.cu),
// whose forward saves (q, k, v, o, lse).
//
// q, o, do (B, H, Sq, D); k, v (B, Hkv, Sk, D), row-major, fp32 or bf16;
// lse (B, H, Sq) fp32.  Writes dq (B, H, Sq, D) and dk, dv (B, Hkv, Sk, D)
// in the inputs' type.  All of the math is fp32, rounded once at the end:
//   dsum = sum_d do * o,   p = exp(s * scale - lse)   (masked keys give 0),
//   ds = p * (dp - dsum) * scale   with s = q k^T and dp = do v^T,
//   dq = ds k,   dk = sum_g ds^T q,   dv = sum_g p^T do,
// query head h reading KV head h / (H / Hkv), as K5 does, and the causal
// mask kpos <= qpos with no Sk - Sq offset, as K5 and `_fa_bwd` have it.
//
// What bounds it: operations.  At TinyLlama-1.1B's training shape
// (B = 4, H = 32, Hkv = 4, S = 2048, D = 64, causal) the function is
// 10 D flops per causal (q, k) pair over 2.69e8 pairs, 171.8 GFLOP, against
// ~100 MB of traffic: 0.174 ms of bf16 tensor-core work (2.56 ms at fp32
// FMA rates) on an NVIDIA H100 SXM at its 700 W limit (data sheet: 989
// TFLOP/s bf16, 67 TFLOP/s fp32, 3.35 TB/s).
//
// Three passes, no atomics, so two launches on the same inputs give the
// same bits (`plan` below; kernels/flash_attention.py `bwd_plan` is the
// same rule):
//   1. flash_bwd_dsum: a warp a query row, dsum = sum_d do * o.
//   2. dq, a block per (64-query tile, heads), the heaviest causal tiles
//      (the last ones) first.
//   3. dk and dv, a block per (64-key tile, KV head), looping over the
//      g query heads of the group and their query tiles at or past the
//      key tile (causal), key tile 0 (the heaviest) first.
// Both product passes recompute s and dp: 14 D flops a pair instead of 10,
// the price of summing dk and dv without atomics.
//
// bf16 (flash_bwd_dq_mma, flash_bwd_dkdv_mma): tensor cores, `mma.sync`
// m16n8k16 tiles with fp32 accumulators (csrc/mma.cuh, as K5's forward).
//   dq: 4 warps a head, 16 query rows a warp, and two heads of one GQA
//   group a block where the group is even (each K and V tile read from
//   L2 serves 128 query rows).  A warp holds its Q and dO rows as A
//   fragments for the whole key loop (dO's are read from shared memory by
//   `ldmatrix` at D = 128); 64-key K and V tiles arrive through a
//   double-buffered `cp.async` ring.  In steps of 16 keys, one at a time
//   (unrolled, they spill at the 128 registers of 2 blocks an SM), it
//   forms S = Q K^T and dP = dO V^T (K and V through plain `ldmatrix`),
//   then p = exp2(s * scale * log2 e - lse * log2 e) and dS on the
//   accumulator fragments, repacks dS as A fragments in registers, and
//   adds dS K (K through `ldmatrix.trans`) to dq's fp32 accumulators.
//   dk, dv: 4 warps, 16 keys a warp; the group's (head, query tile) items
//   arrive one at a time, Q and dO tiles with their 64 lse and dsum
//   values, through a double-buffered `cp.async` ring.  In steps of 16
//   queries a warp forms S^T = K Q^T and dP^T = V dO^T
//   with K and V as A operands, held in registers up to D = 64 (2 blocks
//   an SM) and read from shared memory at D = 128, where dk and dv alone
//   take 128 registers a thread; then p^T and dS^T, repacked as A
//   fragments in registers, and adds p^T dO and dS^T Q (dO and Q through
//   `ldmatrix.trans`).  dk and dv stay fp32 in registers over the whole
//   loop and are rounded once.
//   Both passes take a tile off the diagonal and off the tails (most
//   tiles) through a branch-free step (`EDGE` false); a tile that reaches
//   the diagonal or a tail skips the steps wholly masked and masks the
//   rest.
//   Tiles wholly above the diagonal are never visited.
//   Precision: p and dS are the A operands of bf16 products, and one bf16
//   rounding would move each term by up to 2^-9 of itself, while dq is a
//   sum with heavy cancellation (sum_k ds = 0).  So each weight is split
//   into hi (its top 16 bits, exact) and lo = bf16(w - hi), and both are
//   multiplied: ~16 significant bits, as K5's P V; 20 D tensor-core flops
//   a pair in all.  Inputs off 16-byte alignment are staged by element
//   loads (`load_tile<..., false>`).
//
// fp32 (flash_bwd_dq, flash_bwd_dkdv): fp32 FMAs on the CUDA cores (a
// tensor-core product would be TF32).  dq: a 256-thread block per 64-row
// query tile and head; the query and dO tiles are staged once in shared
// memory, transposed (d-major); the loop over 64-key tiles stages K and V
// transposed (and K row-major).  A thread owns a 4 x 4 block of the score
// tile: it forms s and dp by FMAs over d, then p and ds, and ds goes
// through shared memory (key-major) to the dq += ds K product, where it
// owns 4 rows x D/16 columns of dq.  dk, dv: a block per (64-key tile, KV
// head), looping over the g query heads and their query tiles; a thread
// owns 4 keys x 4 queries of the transposed score tile, then 4 keys x D/16
// columns of dk and dv, which stay in registers over the whole loop; p^T
// and then ds^T go through shared memory to the two products.  The query
// and dO tiles are read transposed for the scores, then again row-major
// into the same buffer for the products (from L2), which keeps D = 128
// within a block's shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile (both paths)
constexpr int BK = 64;          // key rows per tile (both paths)
constexpr int PAD = 4;          // fp32: keeps float4 alignment, spreads banks
constexpr int LD = BQ + PAD;    // fp32: leading dim of the transposed tiles
constexpr int THREADS = 256;    // fp32: 16 row groups x 16 column groups
constexpr int STAGES = 2;       // bf16: depth of the cp.async rings
constexpr int KV_REG_MAX_D = 64;  // bf16 dk/dv: K, V held as A fragments
constexpr int DO_REG_MAX_D = 64;  // bf16 dq: dO held as A fragments
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rows x D of `src` (row stride D, rows from r0, `n` valid) into shared
// memory, transposed: dst[c * LD + r]; invalid rows are zeros.
template <int D>
__device__ __forceinline__ void stage_t(float* dst, const float* src, int r0,
                                        int n) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[c * LD + r] = r0 + r < n ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// The same, row-major: dst[r * D + c].
template <int D>
__device__ __forceinline__ void stage_r(float* dst, const float* src, int r0,
                                        int n) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[i] = r0 + r < n ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// 4 x 4 products a = sum_c x[c][rx..rx+3] * y[c][ry..ry+3] and
// b = sum_c u[c][rx..] * w[c][ry..] over the transposed tiles.
template <int D>
__device__ __forceinline__ void two_products(const float* x, const float* y,
                                             const float* u, const float* w,
                                             int rx, int ry, float a[4][4],
                                             float b[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = b[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const float4 x4 = *reinterpret_cast<const float4*>(&x[c * LD + rx]);
    const float4 y4 = *reinterpret_cast<const float4*>(&y[c * LD + ry]);
    const float4 u4 = *reinterpret_cast<const float4*>(&u[c * LD + rx]);
    const float4 w4 = *reinterpret_cast<const float4*>(&w[c * LD + ry]);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
    const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
    const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
        b[i][j] = fmaf(uv[i], wv[j], b[i][j]);
      }
  }
}

// acc[i][e] += sum_r t[r * LD + row0 + i] * m[r * D + col0 + e] over the
// `n` rows r of a (rows x 64) tile t and a (rows x D) row-major tile m.
template <int D>
__device__ __forceinline__ void accumulate(const float* t, const float* m,
                                           int row0, int col0, int n,
                                           float acc[4][D / 16]) {
  constexpr int DPT = D / 16;
  for (int r = 0; r < n; ++r) {
    const float4 t4 = *reinterpret_cast<const float4*>(&t[r * LD + row0]);
    const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
    float mv[DPT];
    if constexpr (DPT % 4 == 0) {
#pragma unroll
      for (int e = 0; e < DPT; e += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&m[r * D + col0 + e]);
        mv[e] = v4.x;
        mv[e + 1] = v4.y;
        mv[e + 2] = v4.z;
        mv[e + 3] = v4.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < DPT; ++e) mv[e] = m[r * D + col0 + e];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(tv[i], mv[e], acc[i][e]);
  }
}

// Pass 1 (both paths): dsum[row] = sum_d do[row, d] * o[row, d], a warp a
// row.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dsum(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ dsum, int rows) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + (size_t)row * D;
  const T* drow = dout + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s = fmaf(to_f(drow[c]), to_f(orow[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dsum[row] = s;
}

template <int D>
constexpr int dq_smem_floats() {
  // sQt, sdOt, sKt, sVt (D x LD each) + sK (BK x D) + sSt (BK x LD) +
  // lse and dsum of the tile's rows
  return 4 * D * LD + BK * D + BK * LD + 2 * BQ;
}

// fp32 pass 2: dq of one (64-row query tile, head).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             float* __restrict__ dq, int H, int Hkv, int Sq, int Sk,
             int causal, float scale) {
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                          // [D][LD]
  float* sdOt = sQt + D * LD;                 // [D][LD]
  float* sKt = sdOt + D * LD;                 // [D][LD]
  float* sVt = sKt + D * LD;                  // [D][LD]
  float* sK = sVt + D * LD;                   // [BK][D]
  float* sSt = sK + BK * D;                   // [BK][LD]: ds, key-major
  float* sL = sSt + BK * LD;                  // [BQ]
  float* sDs = sL + BQ;                       // [BQ]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // heaviest causal tiles (the last queries) first
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t qrow0 = ((size_t)b * H + h) * Sq;
  const float* qb = q + qrow0 * D;
  const float* db = dout + qrow0 * D;
  const float* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const float* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  stage_t<D>(sQt, qb, q0, Sq);
  stage_t<D>(sdOt, db, q0, Sq);
  for (int r = tid; r < BQ; r += THREADS) {
    const bool in = q0 + r < Sq;
    sL[r] = in ? lse[qrow0 + q0 + r] : 0.f;
    sDs[r] = in ? dsum[qrow0 + q0 + r] : 0.f;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                          // last tile's readers done
    stage_t<D>(sKt, kb, k0, Sk);
    stage_t<D>(sVt, vb, k0, Sk);
    stage_r<D>(sK, kb, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(sQt, sKt, sdOt, sVt, ty * 4, tx * 4, s, dp);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = kpos < Sk && qpos < Sq && (!causal || kpos <= qpos);
        const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
        ds[i][j] = p * (dp[i][j] - sDs[r]) * scale;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sSt[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();
    accumulate<D>(sSt, sK, ty * 4, tx * DPT, min(BK, k_end - k0), acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    float* out = dq + (qrow0 + row) * D + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) out[e] = acc[i][e];
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  // sKt, sVt (D x LD) + the query buffer (sQt + sdOt, D x LD each, then
  // sQ + sdO, BQ x D each) + sP (BQ x LD) + lse and dsum
  return 4 * D * LD + BQ * LD + 2 * BQ;
}

// fp32 pass 3: dk and dv of one (64-key tile, KV head), summed over the
// group's query heads.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               float* __restrict__ dk, float* __restrict__ dv, int H,
               int Hkv, int Sq, int Sk, int causal, float scale) {
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* sKt = smem;                          // [D][LD]
  float* sVt = sKt + D * LD;                  // [D][LD]
  float* sQt = sVt + D * LD;                  // [D][LD], then sQ [BQ][D]
  float* sdOt = sQt + D * LD;                 // [D][LD], then sdO [BQ][D]
  float* sQ = sQt;
  float* sdO = sQt + BQ * D;
  float* sP = sdOt + D * LD;                  // [BQ][LD]: p, then ds
  float* sL = sP + BQ * LD;                   // [BQ]
  float* sDs = sL + BQ;                       // [BQ]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;     // keys ty*4.., queries tx*4..
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const size_t krow0 = ((size_t)b * Hkv + hk) * Sk;
  stage_t<D>(sKt, k + krow0 * D, k0, Sk);
  stage_t<D>(sVt, v + krow0 * D, k0, Sk);

  float adk[4][DPT], adv[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < DPT; ++e) adk[j][e] = adv[j][e] = 0.f;

  const int q_start = causal ? k0 : 0;        // queries before k0 see no key
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const size_t qrow0 = ((size_t)b * H + h) * Sq;
    const float* qb = q + qrow0 * D;
    const float* db = dout + qrow0 * D;
    for (int q0 = q_start; q0 < Sq; q0 += BQ) {
      __syncthreads();                        // last tile's readers done
      stage_t<D>(sQt, qb, q0, Sq);
      stage_t<D>(sdOt, db, q0, Sq);
      for (int r = tid; r < BQ; r += THREADS) {
        const bool in = q0 + r < Sq;
        sL[r] = in ? lse[qrow0 + q0 + r] : 0.f;
        sDs[r] = in ? dsum[qrow0 + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];                // [key][query]
      two_products<D>(sKt, sQt, sVt, sdOt, ty * 4, tx * 4, s, dp);
      __syncthreads();                        // the transposed tiles read
      stage_r<D>(sQ, qb, q0, Sq);
      stage_r<D>(sdO, db, q0, Sq);
      float ds[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + ty * 4 + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = tx * 4 + i;
          const int qpos = q0 + r;
          const bool ok = kpos < Sk && qpos < Sq &&
                          (!causal || kpos <= qpos);
          const float p = ok ? expf(s[j][i] * scale - sL[r]) : 0.f;
          s[j][i] = p;
          ds[j][i] = p * (dp[j][i] - sDs[r]) * scale;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&sP[(tx * 4 + i) * LD + ty * 4]) =
            make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
      __syncthreads();
      const int n = min(BQ, Sq - q0);
      accumulate<D>(sP, sdO, ty * 4, tx * DPT, n, adv);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&sP[(tx * 4 + i) * LD + ty * 4]) =
            make_float4(ds[0][i], ds[1][i], ds[2][i], ds[3][i]);
      __syncthreads();
      accumulate<D>(sP, sQ, ty * 4, tx * DPT, n, adk);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = k0 + ty * 4 + j;
    if (row >= Sk) continue;
    float* pk = dk + (krow0 + row) * D + tx * DPT;
    float* ov = dv + (krow0 + row) * D + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      pk[e] = adk[j][e];
      ov[e] = adv[j][e];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// 2^x in one special-function instruction (relative error ~2^-22,
// subnormal results flushed to 0), as K5's.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// w -> (hi, lo) for two neighbouring weights, packed as A-fragment
// registers: hi = w cut to its bf16 top half (exact), lo = bf16(w - hi),
// so hi + lo carries w to ~2^-16 of itself (as K5's P V).
__device__ __forceinline__ void split_pair(float w0, float w1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(w0), u1 = __float_as_uint(w1);
  hi = __byte_perm(u0, u1, 0x7632);           // the top halves of both
  lo = mma::as_u32(__floats2bfloat162_rn(
      w0 - __uint_as_float(u0 & 0xffff0000u),
      w1 - __uint_as_float(u1 & 0xffff0000u)));
}

// The A fragments (hi, lo) of a 16 x 16 block held as two n8 accumulator
// tiles c0 (columns 0..7) and c1 (8..15).
__device__ __forceinline__ void split_tiles(const float (&c0)[4],
                                            const float (&c1)[4],
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

// 4 bytes global -> shared (cached in L1); with `full` false they are
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

template <int D>
constexpr int dq_mma_smem_bytes(int hpc) {
  // sQ and sdO (BQ rows of hpc heads each) + sK and sV (STAGES stages of
  // BK rows each), pitch D + PAD
  return (2 * hpc * BQ + 2 * STAGES * BK) * (D + mma::PAD) *
         (int)sizeof(bf16);
}

// One warp's dq step over a 64-key tile, 16 keys at a time: S = Q K^T and
// dP = dO V^T (dO's A fragments `df` held in registers, or read from the
// warp's rows `wdO` of sdO where DO_REG is false), p and ds on the
// fragments, dq += (ds_hi + ds_lo) K.  EDGE: the tile reaches the Sk tail
// or, under the causal mask, keys past the warp's first row, so steps
// wholly above its rows are skipped and the rest masked; else every key
// counts and the step has no branch.
template <int D, bool DO_REG, bool EDGE>
__device__ __forceinline__ void dq_tile(const bf16* cK, const bf16* cV,
                                        const bf16* wdO,
                                        const uint32_t (&qf)[D / 16][4],
                                        const uint32_t (&df)[DO_REG ? D / 16
                                                                    : 1][4],
                                        float (&acc)[D / 8][4],
                                        const float (&lse2)[2],
                                        const float (&dsr)[2], int k0,
                                        int row0, int Sk, int causal,
                                        float scale2, float scale,
                                        int lane) {
  constexpr int LDS = D + mma::PAD;
  constexpr int KD = D / 16;
  constexpr int NT = D / 8;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < BK / 16; ++ks) {      // 16 keys a step
    const int kb0 = k0 + ks * 16;
    if (EDGE && (kb0 >= Sk || (causal && kb0 > row0 + 15))) continue;
    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t rk[4], rv[4], ad[4];
      if constexpr (DO_REG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ad[e] = df[kd][e];
      } else {
        mma::ldmatrix_x4(ad, wdO + mma::a_offset(lane, 0, kd * 16, LDS));
      }
      mma::ldmatrix_x4(rk, cK + mma::b_offset_nk(lane, ks * 16, kd * 16,
                                                 LDS));
      mma::ldmatrix_x4(rv, cV + mma::b_offset_nk(lane, ks * 16, kd * 16,
                                                 LDS));
      mma::mma_bf16(s[0], qf[kd], rk[0], rk[1]);
      mma::mma_bf16(s[1], qf[kd], rk[2], rk[3]);
      mma::mma_bf16(dp[0], ad, rv[0], rv[1]);
      mma::mma_bf16(dp[1], ad, rv[2], rv[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2(fmaf(s[j][e], scale2, -lse2[r]));
        if (EDGE) {
          const int kpos = kb0 + j * 8 + 2 * t4 + (e & 1);
          const int qpos = row0 + g + 8 * r;
          if (kpos >= Sk || (causal && kpos > qpos)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dsr[r]) * scale;
      }
    uint32_t dh[4], dl[4];
    split_tiles(s[0], s[1], dh, dl);
    // dq += (ds_hi + ds_lo) K, K through ldmatrix.trans
#pragma unroll
    for (int dn = 0; dn < NT / 2; ++dn) {
      uint32_t r[4];
      mma::ldmatrix_x4_trans(r, cK + mma::b_offset_kn(lane, dn * 16,
                                                      ks * 16, LDS));
      mma::mma_bf16(acc[2 * dn], dh, r[0], r[1]);
      mma::mma_bf16(acc[2 * dn + 1], dh, r[2], r[3]);
      mma::mma_bf16(acc[2 * dn], dl, r[0], r[1]);
      mma::mma_bf16(acc[2 * dn + 1], dl, r[2], r[3]);
    }
  }
}

// bf16 pass 2: dq of one 64-query tile of HPC heads of one GQA group,
// 4 warps a head, 16 query rows a warp.  ASYNC: q, k, v and do 16-byte
// aligned; else their tiles are staged by element loads.
template <int D, int HPC, bool ASYNC>
__global__ void __launch_bounds__(HPC * 128, D <= 64 ? 4 / HPC : 1)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, bf16* __restrict__ dq,
                 int H, int Hkv, int Sq, int Sk, int causal, float scale) {
  constexpr int THREADS_ = HPC * 128;
  constexpr int LDS = D + mma::PAD;           // shared tile pitch
  constexpr int KD = D / 16;                  // k-steps over d
  constexpr int NT = D / 8;                   // n8 tiles of dq
  constexpr bool DO_REG = D <= DO_REG_MAX_D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [HPC][BQ][LDS]
  bf16* sdO = sQ + HPC * BQ * LDS;            // [HPC][BQ][LDS]
  bf16* sK = sdO + HPC * BQ * LDS;            // [STAGES][BK][LDS]
  bf16* sV = sK + STAGES * BK * LDS;          // [STAGES][BK][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hj = warp >> 2, wq = warp & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h0 = blockIdx.y * HPC, h = h0 + hj, b = blockIdx.z;
  const int hk = h0 / (H / Hkv);
  const bf16* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * Sk * D;
  const size_t qrow0 = ((size_t)b * H + h) * Sq;
  const int row0 = q0 + wq * 16;              // this warp's first query row
  const float scale2 = scale * LOG2E;         // scores in log2 units

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
#pragma unroll
  for (int j = 0; j < HPC; ++j) {
    const size_t r0 = ((size_t)b * H + h0 + j) * Sq * D;
    mma::load_tile<BQ, D, THREADS_, ASYNC>(sQ + j * BQ * LDS, q + r0, q0, 0,
                                           Sq, D, D, tid);
    mma::load_tile<BQ, D, THREADS_, ASYNC>(sdO + j * BQ * LDS, dout + r0,
                                           q0, 0, Sq, D, D, tid);
  }
  auto load_kv = [&](int it) {
    const int st = (it % STAGES) * BK * LDS;
    mma::load_tile<BK, D, THREADS_, ASYNC>(sK + st, kb, it * BK, 0, Sk, D, D,
                                           tid);
    mma::load_tile<BK, D, THREADS_, ASYNC>(sV + st, vb, it * BK, 0, Sk, D, D,
                                           tid);
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {   // Q, dO in the first group
    if (it < n_tiles) load_kv(it);
    mma::cp_async_commit();
  }

  // lse (log2 units) and dsum of this lane's rows g and g + 8
  float lse2[2], dsr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool in = row < Sq;
    lse2[r] = in ? lse[qrow0 + row] * LOG2E : 0.f;
    dsr[r] = in ? dsum[qrow0 + row] : 0.f;
  }

  uint32_t qf[KD][4], df[DO_REG ? KD : 1][4];
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    mma::cp_async_wait<STAGES - 2>();         // this tile (and Q) arrived,
    __syncthreads();                          // the oldest stage is free
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    mma::cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const int off = hj * BQ * LDS + mma::a_offset(lane, wq * 16,
                                                      kd * 16, LDS);
        mma::ldmatrix_x4(qf[kd], sQ + off);
        if constexpr (DO_REG) mma::ldmatrix_x4(df[kd], sdO + off);
      }
    }
    const bf16* cK = sK + (it % STAGES) * BK * LDS;
    const bf16* cV = sV + (it % STAGES) * BK * LDS;
    const bf16* wdO = sdO + (hj * BQ + wq * 16) * LDS;
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > row0))
      dq_tile<D, DO_REG, true>(cK, cV, wdO, qf, df, acc, lse2, dsr, k0, row0,
                               Sk, causal, scale2, scale, lane);
    else
      dq_tile<D, DO_REG, false>(cK, cV, wdO, qf, df, acc, lse2, dsr, k0,
                                row0, Sk, causal, scale2, scale, lane);
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= Sq) continue;
    bf16* out = dq + (qrow0 + row) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int D>
constexpr int dkdv_mma_smem_bytes() {
  // sK, sV (BK rows) + STAGES stages of (sQ, sdO: BQ rows), pitch D + PAD,
  // + STAGES x (lse, dsum: BQ floats)
  return (2 * BK + STAGES * 2 * BQ) * (D + mma::PAD) * (int)sizeof(bf16) +
         STAGES * 2 * BQ * (int)sizeof(float);
}

// One warp's dk/dv step over one (head, 64-query tile) item, 16 queries
// at a time: S^T = K Q^T and dP^T = V dO^T with K and V as A operands
// (`kf`, `vf` held in registers, or read from sK, sV where KV_REG is
// false), p^T and ds^T on the fragments, then dv += (p_hi + p_lo)^T dO
// and dk += (ds_hi + ds_lo)^T Q.  EDGE: the item reaches the Sq or Sk
// tail or, under the causal mask, the diagonal, so steps wholly before
// the warp's keys are skipped and the rest masked; else the step has no
// branch.
template <int D, bool KV_REG, bool EDGE>
__device__ __forceinline__ void kv_item(
    const bf16* cQ, const bf16* cdO, const float* cL, const float* cDs,
    const bf16* sK, const bf16* sV, const uint32_t (&kf)[KV_REG ? D / 16 : 1][4],
    const uint32_t (&vf)[KV_REG ? D / 16 : 1][4], float (&adk)[D / 8][4],
    float (&adv)[D / 8][4], int q0, int key0, int wk, int Sq, int Sk,
    int causal, float scale2, float scale, int lane) {
  constexpr int LDS = D + mma::PAD;
  constexpr int KD = D / 16;
  constexpr int NT = D / 8;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int qs = 0; qs < BQ / 16; ++qs) {      // 16 queries a step
    const int qb0 = q0 + qs * 16;
    if (EDGE && (qb0 >= Sq || (causal && qb0 + 15 < key0))) continue;
    float s[2][4], dp[2][4];                  // rows keys, columns queries
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ak[4], av[4], rq[4], rd[4];
      if constexpr (KV_REG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ak[e] = kf[kd][e];
          av[e] = vf[kd][e];
        }
      } else {
        const int off = mma::a_offset(lane, wk * 16, kd * 16, LDS);
        mma::ldmatrix_x4(ak, sK + off);
        mma::ldmatrix_x4(av, sV + off);
      }
      mma::ldmatrix_x4(rq, cQ + mma::b_offset_nk(lane, qs * 16, kd * 16,
                                                 LDS));
      mma::ldmatrix_x4(rd, cdO + mma::b_offset_nk(lane, qs * 16, kd * 16,
                                                  LDS));
      mma::mma_bf16(s[0], ak, rq[0], rq[1]);
      mma::mma_bf16(s[1], ak, rq[2], rq[3]);
      mma::mma_bf16(dp[0], av, rd[0], rd[1]);
      mma::mma_bf16(dp[1], av, rd[2], rd[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = qs * 16 + j * 8 + 2 * t4;   // column in the tile
      const float2 l2 = *reinterpret_cast<const float2*>(cL + c);
      const float2 d2 = *reinterpret_cast<const float2*>(cDs + c);
      const float lq[2] = {l2.x * LOG2E, l2.y * LOG2E};
      const float dsq[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[j][e], scale2, -lq[e & 1]));
        if (EDGE) {
          const int qpos = q0 + c + (e & 1);
          const int kpos = key0 + g + 8 * (e >> 1);
          if (qpos >= Sq || kpos >= Sk || (causal && kpos > qpos)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dsq[e & 1]) * scale;
      }
    }
    uint32_t ph[4], pl[4], dh[4], dl[4];
    split_tiles(s[0], s[1], ph, pl);
    split_tiles(dp[0], dp[1], dh, dl);
    // dv += (p_hi + p_lo)^T dO and dk += (ds_hi + ds_lo)^T Q
#pragma unroll
    for (int dn = 0; dn < NT / 2; ++dn) {
      uint32_t rd[4], rq[4];
      mma::ldmatrix_x4_trans(rd, cdO + mma::b_offset_kn(lane, dn * 16,
                                                        qs * 16, LDS));
      mma::ldmatrix_x4_trans(rq, cQ + mma::b_offset_kn(lane, dn * 16,
                                                       qs * 16, LDS));
      mma::mma_bf16(adv[2 * dn], ph, rd[0], rd[1]);
      mma::mma_bf16(adv[2 * dn + 1], ph, rd[2], rd[3]);
      mma::mma_bf16(adk[2 * dn], dh, rq[0], rq[1]);
      mma::mma_bf16(adk[2 * dn + 1], dh, rq[2], rq[3]);
      mma::mma_bf16(adv[2 * dn], pl, rd[0], rd[1]);
      mma::mma_bf16(adv[2 * dn + 1], pl, rd[2], rd[3]);
      mma::mma_bf16(adk[2 * dn], dl, rq[0], rq[1]);
      mma::mma_bf16(adk[2 * dn + 1], dl, rq[2], rq[3]);
    }
  }
}

// bf16 pass 3: dk and dv of one (64-key tile, KV head), summed over the
// group's query heads and their query tiles (the items), 4 warps of 16
// keys each.
template <int D, bool ASYNC>
__global__ void __launch_bounds__(128, D <= 64 ? 2 : 1)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                   int causal, float scale) {
  constexpr int THREADS_ = 128;
  constexpr int LDS = D + mma::PAD;
  constexpr int KD = D / 16;
  constexpr int NT = D / 8;
  constexpr bool KV_REG = D <= KV_REG_MAX_D;
  constexpr int TILE = BQ * LDS;              // elements of one tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [BK][LDS]
  bf16* sV = sK + TILE;                       // [BK][LDS]
  bf16* ring = sV + TILE;                     // [STAGES][2][BQ][LDS]
  float* sLD = reinterpret_cast<float*>(ring + STAGES * 2 * TILE);
                                              // [STAGES][2][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wk = warp;
  const int kt = blockIdx.x;                  // key tile 0 (heaviest) first
  const int k0 = kt * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int grp = H / Hkv;
  const size_t krow0 = ((size_t)b * Hkv + hk) * Sk;
  const int key0 = k0 + wk * 16;              // this warp's first key
  const float scale2 = scale * LOG2E;

  // items: (head hh, query tile qt) for the tiles at or past the key tile
  const int qt0 = causal ? kt : 0;
  const int n_qt = max((Sq + BQ - 1) / BQ - qt0, 0);
  const int n_items = grp * n_qt;
  auto item_q0 = [&](int i) { return (qt0 + i % n_qt) * BQ; };
  auto item_row0 = [&](int i) {               // (b, h) row of the item
    return ((size_t)b * H + hk * grp + i / n_qt) * Sq;
  };

  mma::load_tile<BK, D, THREADS_, ASYNC>(sK, k + krow0 * D, k0, 0, Sk, D, D,
                                         tid);
  mma::load_tile<BK, D, THREADS_, ASYNC>(sV, v + krow0 * D, k0, 0, Sk, D, D,
                                         tid);
  auto load_item = [&](int i) {               // Q, dO, lse and dsum
    const int stage = i % STAGES;
    const size_t r0 = item_row0(i);
    const int q0 = item_q0(i);
    bf16* dst = ring + stage * 2 * TILE;
    mma::load_tile<BQ, D, THREADS_, ASYNC>(dst, q + r0 * D, q0, 0, Sq, D, D,
                                           tid);
    mma::load_tile<BQ, D, THREADS_, ASYNC>(dst + TILE, dout + r0 * D, q0, 0,
                                           Sq, D, D, tid);
    const int r = tid & (BQ - 1);             // lse, then dsum
    const float* base = tid < BQ ? lse : dsum;
    const bool in = q0 + r < Sq;
    cp_async4(sLD + (stage * 2 + tid / BQ) * BQ + r,
              in ? base + r0 + q0 + r : base, in);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {      // K, V in the first group
    if (i < n_items) load_item(i);
    mma::cp_async_commit();
  }

  uint32_t kf[KV_REG ? KD : 1][4], vf[KV_REG ? KD : 1][4];
  float adk[NT][4], adv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int i = 0; i < n_items; ++i) {
    mma::cp_async_wait<STAGES - 2>();         // this item's tiles arrived,
    __syncthreads();                          // the oldest stage is free
    if (i + STAGES - 1 < n_items) load_item(i + STAGES - 1);
    mma::cp_async_commit();
    if constexpr (KV_REG) {
      if (i == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          const int off = mma::a_offset(lane, wk * 16, kd * 16, LDS);
          mma::ldmatrix_x4(kf[kd], sK + off);
          mma::ldmatrix_x4(vf[kd], sV + off);
        }
      }
    }
    const int q0 = item_q0(i);
    const int stage = i % STAGES;
    const bf16* cQ = ring + stage * 2 * TILE;
    const bf16* cdO = cQ + TILE;
    const float* cL = sLD + stage * 2 * BQ;
    const float* cDs = cL + BQ;
    if (q0 + BQ > Sq || key0 + 16 > Sk || (causal && q0 < key0 + 15))
      kv_item<D, KV_REG, true>(cQ, cdO, cL, cDs, sK, sV, kf, vf, adk, adv,
                               q0, key0, wk, Sq, Sk, causal, scale2, scale,
                               lane);
    else
      kv_item<D, KV_REG, false>(cQ, cdO, cL, cDs, sK, sV, kf, vf, adk, adv,
                                q0, key0, wk, Sq, Sk, causal, scale2, scale,
                                lane);
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key0 + g + 8 * r;
    if (row >= Sk) continue;
    bf16* ok = dk + (krow0 + row) * D + 2 * t4;
    bf16* ov = dv + (krow0 + row) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ok + j * 8) =
          __floats2bfloat162_rn(adk[j][2 * r], adk[j][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(ov + j * 8) =
          __floats2bfloat162_rn(adv[j][2 * r], adv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The launch plan (kernels/flash_attention.py `bwd_plan` is the same rule)
// ---------------------------------------------------------------------------
struct Plan {
  int launches;
  int dsum_blocks;                            // of THREADS, 8 rows each
  int dq_grid[3], dq_threads, dq_heads, dq_smem;
  int kv_grid[3], kv_threads, kv_smem;
  int dq_first_tile, kv_first_tile;           // the tiles block 0 takes
};

Plan plan(int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
          bool mma_path) {
  Plan p{};
  const int rows = B * H * Sq;
  const int q_tiles = (Sq + BQ - 1) / BQ, k_tiles = (Sk + BK - 1) / BK;
  const int hpc = mma_path && (H / Hkv) % 2 == 0 ? 2 : 1;
  if (rows > 0) {
    p.launches += 2;
    p.dsum_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    p.dq_grid[0] = q_tiles;
    p.dq_grid[1] = H / hpc;
    p.dq_grid[2] = B;
    p.dq_threads = mma_path ? hpc * 128 : THREADS;
    p.dq_heads = hpc;
    p.dq_first_tile = mma_path || causal ? q_tiles - 1 : 0;
  }
  if (B * Hkv * Sk > 0) {
    p.launches += 1;
    p.kv_grid[0] = k_tiles;
    p.kv_grid[1] = Hkv;
    p.kv_grid[2] = B;
    p.kv_threads = mma_path ? 128 : THREADS;
    p.kv_first_tile = 0;
  }
  return p;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The dsum pass of either path.
template <typename T, int D>
cudaError_t launch_dsum(const Plan& p, const void* o, const void* dout,
                        void* dsum, int rows, cudaStream_t st) {
  flash_bwd_dsum<T, D><<<p.dsum_blocks, THREADS, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(dsum), rows);
  return cudaGetLastError();
}

template <int D>
int launch_f32(const Plan& p, const void* q, const void* k, const void* v,
               const void* o, const void* lse, const void* dout, void* dq,
               void* dk, void* dv, void* dsum, int B, int H, int Hkv, int Sq,
               int Sk, int causal, float scale, cudaStream_t st) {
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* td = static_cast<const float*>(dout);
  const float* fl = static_cast<const float*>(lse);
  float* fs = static_cast<float*>(dsum);
  if (p.dq_threads) {
    cudaError_t err = launch_dsum<float, D>(p, o, dout, dsum, B * H * Sq, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int bytes = dq_smem_floats<D>() * (int)sizeof(float);
    err = set_smem(flash_bwd_dq<D>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq<D><<<dim3(p.dq_grid[0], p.dq_grid[1], p.dq_grid[2]),
                      p.dq_threads, bytes, st>>>(
        tq, tk, tv, td, fl, fs, static_cast<float*>(dq), H, Hkv, Sq, Sk,
        causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.kv_threads) {
    constexpr int bytes = dkdv_smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = set_smem(flash_bwd_dkdv<D>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkdv<D><<<dim3(p.kv_grid[0], p.kv_grid[1], p.kv_grid[2]),
                        p.kv_threads, bytes, st>>>(
        tq, tk, tv, td, fl, fs, static_cast<float*>(dk),
        static_cast<float*>(dv), H, Hkv, Sq, Sk, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D, int HPC, bool ASYNC>
cudaError_t launch_dq_mma(const Plan& p, const bf16* q, const bf16* k,
                          const bf16* v, const bf16* dout, const float* lse,
                          const float* dsum, bf16* dq, int H, int Hkv, int Sq,
                          int Sk, int causal, float scale, cudaStream_t st) {
  constexpr int bytes = dq_mma_smem_bytes<D>(HPC);
  cudaError_t err = set_smem(flash_bwd_dq_mma<D, HPC, ASYNC>, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma<D, HPC, ASYNC>
      <<<dim3(p.dq_grid[0], p.dq_grid[1], p.dq_grid[2]), p.dq_threads, bytes,
         st>>>(q, k, v, dout, lse, dsum, dq, H, Hkv, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

template <int D, bool ASYNC>
cudaError_t launch_dkdv_mma(const Plan& p, const bf16* q, const bf16* k,
                            const bf16* v, const bf16* dout, const float* lse,
                            const float* dsum, bf16* dk, bf16* dv, int H,
                            int Hkv, int Sq, int Sk, int causal, float scale,
                            cudaStream_t st) {
  constexpr int bytes = dkdv_mma_smem_bytes<D>();
  cudaError_t err = set_smem(flash_bwd_dkdv_mma<D, ASYNC>, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma<D, ASYNC>
      <<<dim3(p.kv_grid[0], p.kv_grid[1], p.kv_grid[2]), p.kv_threads, bytes,
         st>>>(q, k, v, dout, lse, dsum, dk, dv, H, Hkv, Sq, Sk, causal,
               scale);
  return cudaGetLastError();
}

template <int D>
int launch_bf16(const Plan& p, const void* q, const void* k, const void* v,
                const void* o, const void* lse, const void* dout, void* dq,
                void* dk, void* dv, void* dsum, int B, int H, int Hkv, int Sq,
                int Sk, int causal, float scale, cudaStream_t st) {
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* td = static_cast<const bf16*>(dout);
  const float* fl = static_cast<const float*>(lse);
  const float* fs = static_cast<const float*>(dsum);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  if (p.dq_threads) {
    cudaError_t err = launch_dsum<bf16, D>(p, o, dout, dsum, B * H * Sq, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    bf16* out = static_cast<bf16*>(dq);
#define FLASH_BWD_DQ(HPC, ASYNC)                                             \
  launch_dq_mma<D, HPC, ASYNC>(p, tq, tk, tv, td, fl, fs, out, H, Hkv, Sq,   \
                               Sk, causal, scale, st)
    err = p.dq_heads == 2
              ? (aligned ? FLASH_BWD_DQ(2, true) : FLASH_BWD_DQ(2, false))
              : (aligned ? FLASH_BWD_DQ(1, true) : FLASH_BWD_DQ(1, false));
#undef FLASH_BWD_DQ
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.kv_threads) {
    bf16* ok = static_cast<bf16*>(dk);
    bf16* ov = static_cast<bf16*>(dv);
    const cudaError_t err =
        aligned ? launch_dkdv_mma<D, true>(p, tq, tk, tv, td, fl, fs, ok, ov,
                                           H, Hkv, Sq, Sk, causal, scale, st)
                : launch_dkdv_mma<D, false>(p, tq, tk, tv, td, fl, fs, ok,
                                            ov, H, Hkv, Sq, Sk, causal, scale,
                                            st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* dsum, int B, int H, int Hkv, int Sq, int Sk, int D,
           int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan(B, H, Hkv, Sq, Sk, D, causal, BF16);
#define FLASH_BWD_D(DD)                                                      \
  case DD:                                                                   \
    return BF16 ? launch_bf16<DD>(p, q, k, v, o, lse, dout, dq, dk, dv,      \
                                  dsum, B, H, Hkv, Sq, Sk, causal, scale, st) \
                : launch_f32<DD>(p, q, k, v, o, lse, dout, dq, dk, dv, dsum, \
                                 B, H, Hkv, Sq, Sk, causal, scale, st);
  switch (D) {
    FLASH_BWD_D(16)
    FLASH_BWD_D(32)
    FLASH_BWD_D(64)
    FLASH_BWD_D(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_D
}

// Dynamic shared bytes and blocks an SM (CUDA's occupancy API) of the
// aligned instance of each product kernel.
template <int D>
cudaError_t occupancy(const Plan& p, bool bf16_path, int* out) {
  int dq_bytes, kv_bytes;
  cudaError_t err;
  if (bf16_path) {
    dq_bytes = dq_mma_smem_bytes<D>(p.dq_heads);
    kv_bytes = dkdv_mma_smem_bytes<D>();
    if (p.dq_heads == 2) {
      err = set_smem(flash_bwd_dq_mma<D, 2, true>, dq_bytes);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[0], flash_bwd_dq_mma<D, 2, true>, p.dq_threads, dq_bytes);
    } else {
      err = set_smem(flash_bwd_dq_mma<D, 1, true>, dq_bytes);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[0], flash_bwd_dq_mma<D, 1, true>, p.dq_threads, dq_bytes);
    }
    if (err == cudaSuccess) err = set_smem(flash_bwd_dkdv_mma<D, true>,
                                           kv_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[1], flash_bwd_dkdv_mma<D, true>, 128, kv_bytes);
  } else {
    dq_bytes = dq_smem_floats<D>() * (int)sizeof(float);
    kv_bytes = dkdv_smem_floats<D>() * (int)sizeof(float);
    err = set_smem(flash_bwd_dq<D>, dq_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[0], flash_bwd_dq<D>, THREADS, dq_bytes);
    if (err == cudaSuccess) err = set_smem(flash_bwd_dkdv<D>, kv_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[1], flash_bwd_dkdv<D>, THREADS, kv_bytes);
  }
  out[2] = dq_bytes;
  out[3] = kv_bytes;
  return err;
}

}  // namespace

// q, o, dout, dq (B, H, Sq, D); k, v, dk, dv (B, Hkv, Sk, D); lse and the
// scratch dsum (B, H, Sq) fp32; all contiguous.  Returns the CUDA error
// code of the launches (0 on success).
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
    float scale, void* stream) {
  return launch<true>(q, k, v, o, lse, dout, dq, dk, dv, dsum, B, H, Hkv, Sq,
                      Sk, D, causal, scale, stream);
}

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
    float scale, void* stream) {
  return launch<false>(q, k, v, o, lse, dout, dq, dk, dv, dsum, B, H, Hkv,
                       Sq, Sk, D, causal, scale, stream);
}

// The plan the launchers take for one call, into out[18]: launches,
// dsum blocks, dq grid (3), threads, heads a block, dynamic shared bytes,
// blocks an SM; dk/dv grid (3), threads, shared bytes, blocks an SM; the
// tiles block 0 of dq and of dk/dv take; dsum threads.
extern "C" int flash_attention_bwd_plan(int B, int H, int Hkv, int Sq, int Sk,
                                        int D, int causal, int bf16_path,
                                        int* out) {
  const Plan p = plan(B, H, Hkv, Sq, Sk, D, causal, bf16_path != 0);
  int occ[4] = {0, 0, 0, 0};
  cudaError_t err;
  switch (D) {
    case 16: err = occupancy<16>(p, bf16_path, occ); break;
    case 32: err = occupancy<32>(p, bf16_path, occ); break;
    case 64: err = occupancy<64>(p, bf16_path, occ); break;
    case 128: err = occupancy<128>(p, bf16_path, occ); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vals[18] = {p.launches, p.dsum_blocks, p.dq_grid[0], p.dq_grid[1],
                        p.dq_grid[2], p.dq_threads, p.dq_heads, occ[2],
                        occ[0], p.kv_grid[0], p.kv_grid[1], p.kv_grid[2],
                        p.kv_threads, occ[3], occ[1], p.dq_first_tile,
                        p.kv_first_tile, THREADS};
  for (int i = 0; i < 18; ++i) out[i] = vals[i];
  return static_cast<int>(err);
}
