// K5: blockwise online-softmax attention forward, the port of
// src/repro/kernels/flash_attention.py::flash_attention_fwd (Pallas body
// `_fwd_kernel`).
//
// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), row-major, fp32 or bf16.
// Returns o (B, H, Sq, D) in q's type and lse (B, H, Sq) in fp32.  GQA by
// kv head = h / (H / Hkv); causal mask kpos <= qpos with no Sk - Sq offset,
// as the Pallas kernel; keys at or past Sk masked; all math in fp32 with
// the reference's -1e30 sentinel for masked scores.
//
// What bounds it: operations.  At the serving prefill shape (B = 1,
// H = 32, Hkv = 4, D = 64, S = 1024, causal) the work is
// 4 * D * H * S (S + 1) / 2 = 4.3 GFLOP against ~9 MB of traffic; on an
// NVIDIA H100 SXM at its 700 W limit (data-sheet peaks: 989 TFLOP/s bf16
// on the tensor cores, 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s)
// that is 4.4 us of tensor-core work and 2.7 us of traffic.  This first
// version computes both products with fp32 FMAs on the CUDA cores, so
// its own ceiling there is ~64 us; mma/wgmma is later work.
//
// Design: one 256-thread block per (b, h, 64-row query tile).  The query
// tile is staged once in shared memory as fp32, transposed (d-major), so
// that each thread reads its 4 rows as one float4 per d.  The loop over
// 64-row key tiles replaces the Pallas kernel's sequential grid axis: each
// K tile is staged transposed and each V tile row-major, as fp32.  A
// thread owns a 4 x 4 block of the 64 x 64 score tile (rows ty*4.., keys
// tx*4..) and a 4 x D/16 block of the output; row max and row sum are
// reduced across the 16 threads of a row group by xor shuffles.  The
// running max, running sum and the fp32 accumulator stay in registers
// across key tiles.  P goes through shared memory (transposed) to the
// P V product.  Key tiles wholly above the diagonal are not visited; the
// diagonal tile and the ragged tail are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int PAD = 4;          // keeps float4 alignment, spreads banks
constexpr int LD = BQ + PAD;    // leading dim of the transposed tiles
constexpr int THREADS = 256;    // 16 row groups x 16 column groups
constexpr float NEG_INF = -1e30f;

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

template <int D>
constexpr int smem_floats() {
  // sQt (D x LD) + sKt (D x LD) + sV (BK x D) + sPt (BK x LD)
  return 2 * D * LD + BK * D + BK * LD;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                 int causal, float scale) {
  constexpr int DPT = D / 16;                 // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                          // [D][LD]
  float* sKt = sQt + D * LD;                  // [D][LD]
  float* sV = sKt + D * LD;                   // [BK][D]
  float* sPt = sV + BK * D;                   // [BK][LD]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qb = q + ((size_t)b * H + h) * Sq * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    sQt[c * LD + r] = row < Sq ? to_f(qb[(size_t)row * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                          // last tile's readers done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int row = k0 + r;
      const bool in = row < Sk;
      sKt[c * LD + r] = in ? to_f(kb[(size_t)row * D + c]) : 0.f;
      sV[r * D + c] = in ? to_f(vb[(size_t)row * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&sQt[c * LD + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&sKt[c * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mb = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mb = fmaxf(mb, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_new = fmaxf(m[i], mb);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sPt[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int c_end = min(BK, k_end - k0);
    for (int c = 0; c < c_end; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sPt[c * LD + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DPT];
      if constexpr (DPT % 4 == 0) {
#pragma unroll
        for (int e = 0; e < DPT; e += 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(&sV[c * D + tx * DPT + e]);
          vv[e] = t.x;
          vv[e + 1] = t.y;
          vv[e + 2] = t.z;
          vv[e + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < DPT; ++e) vv[e] = sV[c * D + tx * DPT + e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (((size_t)b * H + h) * Sq + row) * D + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) orow[e] = from_f<T>(acc[i][e] / ls);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + row] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int H, int Hkv, int Sq, int Sk, int causal, float scale,
             cudaStream_t st) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Hkv, Sq, Sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
           float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale, st);
    case 32: return launch_d<T, 32>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale, st);
    case 64: return launch_d<T, 64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale, st);
    case 128: return launch_d<T, 128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int Hkv, int Sq, int Sk,
                                        int D, int causal, float scale,
                                        void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D, causal,
                               scale, stream);
}

extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int H, int Hkv, int Sq, int Sk,
                                       int D, int causal, float scale,
                                       void* stream) {
  return launch<float>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D, causal, scale,
                       stream);
}
