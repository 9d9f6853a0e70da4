// K8: row RMSNorm, the port of src/repro/kernels/rmsnorm.py::rmsnorm
// (Pallas body `_rmsnorm_kernel`).
//
// y[t, :] = x[t, :] * rsqrt(mean(x[t, :]^2) + eps) * (1 + scale), with the
// statistics and the scaling in fp32 and the result cast back to x's type,
// as the reference computes it.
//
// What bounds it: bytes.  Each row is read and written once (plus the
// d-vector scale, which stays in L1/L2): at T = 1024, d = 2048 in bf16
// that is 8 MB, about 2.5 us at the 3.35 TB/s of an NVIDIA H100 SXM
// (data sheet, 700 W limit).  Decode calls it at T = slots (4 rows),
// where the launch itself is the cost.
//
// Design: one pass over the row in device memory.  At the widths the
// models use (d = 2048, and 512 for MLA's kv_norm; bf16 and fp32) the row
// is a compile-time number of 16-byte pieces, and every thread issues all
// of its pieces' loads of x and of scale before it uses the first; the
// squares are summed, reduced, scaled and stored from the registers.  The
// wrapper's `launch_plan` picks threads a row (`tpr`) and rows a block:
//   - few rows: a row over a whole block (one piece a thread at d = 2048
//     bf16), summed across warps through shared memory, so each row's
//     loads are one round trip and the rows land on different SMs;
//   - many rows: a warp a row, 2 rows a block, so blocks are small and
//     many are resident on each SM with all their loads in flight.
// Other widths, or rows that are not 16-byte aligned, take the general
// kernel: a warp a row, two passes over the row (the second from L1/L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One 16-byte piece of x scaled by r * (1 + scale), elementwise.
template <typename T>
__device__ __forceinline__ uint4 scaled(const uint4& xv, const uint4& sv,
                                        float r) {
  constexpr int V = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&xv);
  const T* se = reinterpret_cast<const T*>(&sv);
  uint4 out;
  T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < V; ++j)
    oe[j] = from_f<T>(to_f(e[j]) * r * (1.0f + to_f(se[j])));
  return out;
}

// A row of D elements over TPR threads, each holding K = D / V / TPR
// pieces in registers (piece tid + k * TPR, so a warp's loads are adjacent
// 512-byte runs); blockDim.x / TPR rows a block.  TPR > 32 means one row
// a block, reduced across its warps through shared memory.
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ scale,
             T* __restrict__ y, int rows, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int K = D / V / TPR;
  static_assert(K >= 1 && K * TPR * V == D, "whole pieces a thread");
  static_assert(TPR % 32 == 0 && TPR <= kMaxThreads, "whole warps a row");
  const int tid = threadIdx.x % TPR;
  const int row = blockIdx.x * (blockDim.x / TPR) + threadIdx.x / TPR;
  if (TPR == 32 && row >= rows) return;     // a whole warp, a whole row
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)row * (D / V);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4 xv[K], sv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) xv[k] = __ldg(xr + tid + k * TPR);
#pragma unroll
  for (int k = 0; k < K; ++k) sv[k] = __ldg(sr + tid + k * TPR);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T* e = reinterpret_cast<const T*>(&xv[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f(e[j]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = warp_sum(ss);
  if constexpr (TPR > 32) {
    __shared__ float part[TPR / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) ss += part[w];
  }
  const float r = rsqrtf(ss / (float)D + eps);
  uint4* yr = reinterpret_cast<uint4*>(y) + (size_t)row * (D / V);
#pragma unroll
  for (int k = 0; k < K; ++k) yr[tid + k * TPR] = scaled<T>(xv[k], sv[k], r);
}

// Any width: a warp a row, blockDim.x / 32 rows a block, two passes (the
// second from L1/L2).  VECTOR: 16-byte pieces (d a multiple of V, x and
// scale 16-byte aligned); else one element at a time.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_general(const T* __restrict__ x, const T* __restrict__ scale,
                T* __restrict__ y, int rows, int d, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  constexpr int V = 16 / sizeof(T);

  float ss = 0.f;
  if (VECTOR) {
    for (int i = lane; i < d / V; i += 32) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
  const float r = rsqrtf(warp_sum(ss) / (float)d + eps);

  if (VECTOR) {
    for (int i = lane; i < d / V; i += 32)
      reinterpret_cast<uint4*>(yr)[i] = scaled<T>(
          reinterpret_cast<const uint4*>(xr)[i],
          reinterpret_cast<const uint4*>(scale)[i], r);
  } else {
    for (int i = lane; i < d; i += 32)
      yr[i] = from_f<T>(to_f(xr[i]) * r * (1.0f + to_f(scale[i])));
  }
}

// The compile-time width D, if the plan's (tpr, rpb) is one of its two
// layouts: a warp a row, or one block of min(pieces, 256) threads a row
// (kernels/rmsnorm.py::launch_plan keeps the same rule).
template <typename T, int D>
bool launch_fixed(const T* x, const T* s, T* y, int rows, float eps, int tpr,
                  int rpb, cudaStream_t st) {
  constexpr int P = D * (int)sizeof(T) / 16;
  constexpr int BT = P < kMaxThreads ? P : kMaxThreads;
  const dim3 grid((rows + rpb - 1) / rpb);
  if (tpr == 32)
    rmsnorm_rows<T, D, 32><<<grid, 32 * rpb, 0, st>>>(x, s, y, rows, eps);
  else if (tpr == BT && rpb == 1)
    rmsnorm_rows<T, D, BT><<<grid, BT, 0, st>>>(x, s, y, rows, eps);
  else
    return false;
  return true;
}

template <typename T>
int launch(const void* xp, const void* sp, void* yp, int rows, int d,
           float eps, int tpr, int rpb, int vector, void* stream) {
  const T* x = static_cast<const T*>(xp);
  const T* s = static_cast<const T*>(sp);
  T* y = static_cast<T*>(yp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rpb < 1 || tpr * rpb > kMaxThreads) return (int)cudaErrorInvalidValue;
  bool fixed = false;
  if (vector && d == 2048)
    fixed = launch_fixed<T, 2048>(x, s, y, rows, eps, tpr, rpb, st);
  else if (vector && d == 512)
    fixed = launch_fixed<T, 512>(x, s, y, rows, eps, tpr, rpb, st);
  if (!fixed) {
    if (tpr != 32) return (int)cudaErrorInvalidValue;  // no such layout
    const dim3 grid((rows + rpb - 1) / rpb);
    if (vector)
      rmsnorm_general<T, true><<<grid, 32 * rpb, 0, st>>>(x, s, y, rows, d,
                                                          eps);
    else
      rmsnorm_general<T, false><<<grid, 32 * rpb, 0, st>>>(x, s, y, rows, d,
                                                           eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, d) row-major; scale: (d,) of x's type.  tpr: threads a row
// (32, or a whole block at d = 512 / 2048); rpb: rows a block; vector: x
// and scale 16-byte aligned and d a multiple of 16 bytes.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int rmsnorm_bf16_bf16(const void* x, const void* scale, void* y,
                                 int rows, int d, float eps, int tpr, int rpb,
                                 int vector, void* stream) {
  return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, tpr, rpb, vector,
                               stream);
}

extern "C" int rmsnorm_f32_f32(const void* x, const void* scale, void* y,
                               int rows, int d, float eps, int tpr, int rpb,
                               int vector, void* stream) {
  return launch<float>(x, scale, y, rows, d, eps, tpr, rpb, vector, stream);
}
