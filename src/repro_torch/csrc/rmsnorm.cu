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
// Design: one warp per row, 8 rows per 256-thread block.  Pass 1 reads the
// row with 16-byte vector loads and sums squares in fp32, reduced across
// the warp by xor shuffles; pass 2 reads the row again (from L1/L2, it was
// just touched) and writes y with 16-byte stores.  Rows whose length or
// address does not allow 16-byte access take the scalar loop instead
// (the wrapper decides and passes `vector`).
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

constexpr int kWarps = 8;

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ y, int rows, int d, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  constexpr int V = 16 / sizeof(T);

  float ss = 0.f;
  if (VECTOR) {
    for (int i = lane; i < d / V; i += 32) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
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
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)d + eps);

  if (VECTOR) {
    for (int i = lane; i < d / V; i += 32) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float s = 1.0f + to_f(scale[i * V + j]);
        oe[j] = from_f<T>(to_f(e[j]) * r * s);
      }
      reinterpret_cast<uint4*>(yr)[i] = out;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      yr[i] = from_f<T>(to_f(xr[i]) * r * (1.0f + to_f(scale[i])));
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, int vector, void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vector) {
    rmsnorm_kernel<T, true><<<grid, block, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(y), rows, d, eps);
  } else {
    rmsnorm_kernel<T, false><<<grid, block, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(y), rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, d) row-major; scale: (d,) of x's type.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int rmsnorm_bf16_bf16(const void* x, const void* scale, void* y,
                                 int rows, int d, float eps, int vector,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, vector, stream);
}

extern "C" int rmsnorm_f32_f32(const void* x, const void* scale, void* y,
                               int rows, int d, float eps, int vector,
                               void* stream) {
  return launch<float>(x, scale, y, rows, d, eps, vector, stream);
}
