// K7: the diagonal linear recurrence, the port of
// src/repro/kernels/ssm_scan.py::ssm_scan (Pallas body `_scan_kernel`).
//
// h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 over a, b (B, T, C), every h_t
// written to hs (B, T, C) and the last to h_final (B, C), all in fp32
// (inputs bf16 or fp32), as the reference computes it.
//
// What bounds it: bytes.  Each step reads a_t and b_t and writes h_t once,
// 3 x 4 bytes per (b, t, c) in fp32: Falcon-Mamba-7B's flattened selective
// scan (C = 8192 x 16, T = 916) moves 1.44 GB, about 0.43 ms at the
// 3.35 TB/s of an NVIDIA H100 SXM (data sheet, 700 W limit); the FMA is
// 2 operations per 12 bytes.
//
// Design: the Pallas grid carries h in VMEM scratch along its sequential
// time axis, over channel blocks in parallel.  Here one thread owns one
// (b, c) chain and keeps h in a register for all of T, so nothing is
// carried between blocks and no time padding exists.  Adjacent threads
// take adjacent channels, so each step's loads and store are coalesced
// along C.  The loop is unrolled so the compiler can start the next steps'
// loads, which do not depend on h, ahead of the FMA chain.  A chunk-
// parallel scan over T (for small B x C, where 128-thread blocks leave most
// SMs idle) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                float* __restrict__ hs, float* __restrict__ hf, int steps,
                int channels) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= channels) return;
  const size_t base = (size_t)blockIdx.y * steps * channels + c;
  const T* ap = a + base;
  const T* bp = b + base;
  float* hp = hs + base;
  float h = 0.f;
#pragma unroll 8
  for (int t = 0; t < steps; ++t) {
    const size_t off = (size_t)t * channels;
    h = fmaf(to_f(ap[off]), h, to_f(bp[off]));
    hp[off] = h;
  }
  hf[(size_t)blockIdx.y * channels + c] = h;
}

template <typename T>
int launch(const void* a, const void* b, void* hs, void* hf, int batch,
           int steps, int channels, void* stream) {
  const dim3 grid((channels + kThreads - 1) / kThreads, batch);
  ssm_scan_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(hs), static_cast<float*>(hf), steps, channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b: (batch, steps, channels) row-major of the named input type; hs:
// (batch, steps, channels) fp32; hf: (batch, channels) fp32.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int ssm_scan_bf16_f32(const void* a, const void* b, void* hs,
                                 void* hf, int batch, int steps, int channels,
                                 void* stream) {
  return launch<__nv_bfloat16>(a, b, hs, hf, batch, steps, channels, stream);
}

extern "C" int ssm_scan_f32_f32(const void* a, const void* b, void* hs,
                                void* hf, int batch, int steps, int channels,
                                void* stream) {
  return launch<float>(a, b, hs, hf, batch, steps, channels, stream);
}
