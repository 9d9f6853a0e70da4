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
// Design (a first, simple one: fp32 FMAs on the CUDA cores, no atomics,
// so two launches on the same inputs give the same bits):
//   1. flash_bwd_dsum: a warp a query row, dsum = sum_d do * o.
//   2. flash_bwd_dq: a 256-thread block per (64-row query tile, head),
//      the heaviest causal tiles first.  The query and dO tiles are staged
//      once in shared memory, transposed (d-major); the loop over 64-key
//      tiles stages K and V transposed (and K row-major).  A thread owns
//      a 4 x 4 block of the score tile: it forms s and dp by FMAs over d,
//      then p and ds, and ds goes through shared memory (key-major) to the
//      dq += ds K product, where it owns 4 rows x D/16 columns of dq.
//   3. flash_bwd_dkdv: a block per (64-key tile, KV head), looping over
//      the g query heads of the group and their query tiles at or past
//      the key tile (causal).  A thread owns 4 keys x 4 queries of the
//      transposed score tile, then 4 keys x D/16 columns of dk and dv,
//      which stay in registers over the whole loop; p^T and then ds^T go
//      through shared memory to the two products.  The query and dO tiles
//      are read transposed for the scores, then again row-major into the
//      same buffer for the products (from L2), which keeps D = 128 within
//      a block's shared memory.
// Each pass recomputes s and dp: 14 D flops a pair instead of 10.  Tiles
// are read and transposed by plain loads; the tensor cores are unused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int PAD = 4;          // keeps float4 alignment, spreads banks
constexpr int LD = BQ + PAD;    // leading dim of the transposed tiles
constexpr int THREADS = 256;    // 16 row groups x 16 column groups

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16(v);
}

// rows x D of `src` (row stride D, rows from r0, `n` valid) into shared
// memory, transposed: dst[c * LD + r]; invalid rows are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_t(float* dst, const T* src, int r0,
                                        int n) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[c * LD + r] = r0 + r < n ? to_f(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// The same, row-major: dst[r * D + c].
template <typename T, int D>
__device__ __forceinline__ void stage_r(float* dst, const T* src, int r0,
                                        int n) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[i] = r0 + r < n ? to_f(src[(size_t)(r0 + r) * D + c]) : 0.f;
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

// Pass 1: dsum[row] = sum_d do[row, d] * o[row, d], a warp a row.
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

// Pass 2: dq of one (64-row query tile, head).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             T* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
             float scale) {
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
  const T* qb = q + qrow0 * D;
  const T* db = dout + qrow0 * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  stage_t<T, D>(sQt, qb, q0, Sq);
  stage_t<T, D>(sdOt, db, q0, Sq);
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
    stage_t<T, D>(sKt, kb, k0, Sk);
    stage_t<T, D>(sVt, vb, k0, Sk);
    stage_r<T, D>(sK, kb, k0, Sk);
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
    T* out = dq + (qrow0 + row) * D + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) out[e] = from_f<T>(acc[i][e]);
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  // sKt, sVt (D x LD) + the query buffer (sQt + sdOt, D x LD each, then
  // sQ + sdO, BQ x D each) + sP (BQ x LD) + lse and dsum
  return 4 * D * LD + BQ * LD + 2 * BQ;
}

// Pass 3: dk and dv of one (64-key tile, KV head), summed over the group's
// query heads.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int Sq,
               int Sk, int causal, float scale) {
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
  stage_t<T, D>(sKt, k + krow0 * D, k0, Sk);
  stage_t<T, D>(sVt, v + krow0 * D, k0, Sk);

  float adk[4][DPT], adv[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < DPT; ++e) adk[j][e] = adv[j][e] = 0.f;

  const int q_start = causal ? k0 : 0;        // queries before k0 see no key
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const size_t qrow0 = ((size_t)b * H + h) * Sq;
    const T* qb = q + qrow0 * D;
    const T* db = dout + qrow0 * D;
    for (int q0 = q_start; q0 < Sq; q0 += BQ) {
      __syncthreads();                        // last tile's readers done
      stage_t<T, D>(sQt, qb, q0, Sq);
      stage_t<T, D>(sdOt, db, q0, Sq);
      for (int r = tid; r < BQ; r += THREADS) {
        const bool in = q0 + r < Sq;
        sL[r] = in ? lse[qrow0 + q0 + r] : 0.f;
        sDs[r] = in ? dsum[qrow0 + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];                // [key][query]
      two_products<D>(sKt, sQt, sVt, sdOt, ty * 4, tx * 4, s, dp);
      __syncthreads();                        // the transposed tiles read
      stage_r<T, D>(sQ, qb, q0, Sq);
      stage_r<T, D>(sdO, db, q0, Sq);
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
    T* pk = dk + (krow0 + row) * D + tx * DPT;
    T* ov = dv + (krow0 + row) * D + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      pk[e] = from_f<T>(adk[j][e]);
      ov[e] = from_f<T>(adv[j][e]);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* lse, const void* dout, void* dq, void* dk, void* dv,
             void* dsum, int B, int H, int Hkv, int Sq, int Sk, int causal,
             float scale, cudaStream_t st) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* td = static_cast<const T*>(dout);
  const float* fl = static_cast<const float*>(lse);
  float* fs = static_cast<float*>(dsum);
  const int rows = B * H * Sq;
  if (rows > 0) {
    flash_bwd_dsum<T, D><<<(rows + THREADS / 32 - 1) / (THREADS / 32),
                           THREADS, 0, st>>>(static_cast<const T*>(o), td, fs,
                                             rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int bytes = dq_smem_floats<D>() * (int)sizeof(float);
    err = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq<T, D><<<dim3((Sq + BQ - 1) / BQ, H, B), THREADS, bytes,
                         st>>>(tq, tk, tv, td, fl, fs, static_cast<T*>(dq), H,
                               Hkv, Sq, Sk, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B * Hkv * Sk > 0) {
    constexpr int bytes = dkdv_smem_floats<D>() * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkdv<T, D><<<dim3((Sk + BK - 1) / BK, Hkv, B), THREADS, bytes,
                           st>>>(tq, tk, tv, td, fl, fs, static_cast<T*>(dk),
                                 static_cast<T*>(dv), H, Hkv, Sq, Sk, causal,
                                 scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* dsum, int B, int H, int Hkv, int Sq, int Sk, int D,
           int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_D(DD)                                                    \
  case DD:                                                                 \
    return launch_d<T, DD>(q, k, v, o, lse, dout, dq, dk, dv, dsum, B, H,  \
                           Hkv, Sq, Sk, causal, scale, st);
  switch (D) {
    FLASH_BWD_D(16)
    FLASH_BWD_D(32)
    FLASH_BWD_D(64)
    FLASH_BWD_D(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_D
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
  return launch<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, dsum, B, H,
                               Hkv, Sq, Sk, D, causal, scale, stream);
}

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dsum, int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
    float scale, void* stream) {
  return launch<float>(q, k, v, o, lse, dout, dq, dk, dv, dsum, B, H, Hkv,
                       Sq, Sk, D, causal, scale, stream);
}
