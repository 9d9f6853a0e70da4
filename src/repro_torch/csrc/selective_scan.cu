// K12c forward: Mamba-1's selective scan, the port of
// src/repro/models/ssm.py::_mamba_chunk_scan (XLA: a checkpointed scan
// over time chunks of 64, no Pallas kernel).
//
// Inputs dt (B, S, D) fp32 (already softplus'd), Bm and Cm (B, S, N),
// x (B, S, D) (Bm, Cm and x all bf16 or all fp32), A = -exp(A_log)
// (D, N) fp32.  For every step, in the reference's order and in fp32:
//   a = exp(dt A),  b = (dt x) B,  h = a h + b,  y_t = sum_n h C_t,
// from h = 0; y (B, S, D) fp32 and the last h (B, D, N) fp32 are written.
//
// What bounds it: at Falcon-Mamba-7B's 916-token prefill (D 8,192, N 16)
// the bytes are dt and y in fp32 and x in bf16, about 76 MB (0.023 ms at
// 3.35 TB/s), and the work is B S D N exponentials, 120 M, about 0.03 ms
// at the SFU's 16 a clock per SM: the exponentials, not the bytes, may
// be the floor.  The reference forms a and b as (B, chunk, D, N) tensors
// a chunk at a time; here they live in registers only and never reach
// memory.
//
// Design: a group of G lanes a channel (G the power of two at or above
// N, 16 at Falcon-Mamba), lane n holding h[d, n] in a register, so a
// prefill of one request still gives B D G threads (131,072 at
// Falcon-Mamba, where a thread a channel would give 8,192: 64 blocks on
// 132 SMs).  y_t is a butterfly of `__shfl_xor_sync` over the group's
// lanes, in a fixed order, so two launches give the same bits.  A block
// of 128 threads takes 128 / G adjacent channels of one batch row; the
// Bm / Cm values of a step are shared by every channel of the row (one
// sector a warp, served from L1).  Each thread loads its next kUnroll
// = 4 steps' dt, x, B and C into registers before it runs them, so the
// loads of a group of steps are in flight together.  Four, not eight:
// with 8 blocks an SM every warp's loads already overlap other warps'
// steps, and the ablation (`python -m repro_torch.kernels.ablate
// selective_scan`, H100 80GB HBM3 at 700 W) timed 8 steps ahead 14 %
// slower at 916 and 3,100 tokens.  The multiplies and adds are written as
// `__fmul_rn` / `__fadd_rn` so none is contracted into an FMA, as the
// plain version rounds them, and `expf` is the accurate one (no fast
// math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kThreads = 128;
constexpr int kUnroll = 4;
// 8 blocks an SM (at most 64 registers a thread): Falcon-Mamba's 1,024
// blocks of a prefill then run in one wave on 132 SMs
constexpr int kMinBlocks = 8;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_fwd(const float* __restrict__ dt, const T* __restrict__ bm,
                   const T* __restrict__ cm, const T* __restrict__ x,
                   const float* __restrict__ A, float* __restrict__ y,
                   float* __restrict__ hf, int steps, int channels,
                   int states) {
  constexpr int kChannels = kThreads / G;
  const int lane = threadIdx.x % 32;
  const int n = threadIdx.x % G;
  const int d = blockIdx.x * kChannels + threadIdx.x / G;
  if (d >= channels) return;  // a whole group leaves together
  const unsigned group = (0xffffffffu >> (32 - G)) << (lane & ~(G - 1));
  const bool real = n < states;
  const float an = real ? A[(size_t)d * states + n] : 0.f;
  const size_t row = (size_t)blockIdx.y * steps;
  const float* dtp = dt + row * channels + d;
  const T* xp = x + row * channels + d;
  const T* bp = bm + row * states + n;
  const T* cp = cm + row * states + n;
  float* yp = y + row * channels + d;
  float h = 0.f;
  for (int t0 = 0; t0 < steps; t0 += kUnroll) {
    float dtv[kUnroll], xv[kUnroll], bv[kUnroll], cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const bool in = t < steps;
      dtv[u] = in ? dtp[(size_t)t * channels] : 0.f;
      xv[u] = in ? to_f(xp[(size_t)t * channels]) : 0.f;
      bv[u] = in && real ? to_f(bp[(size_t)t * states]) : 0.f;
      cv[u] = in && real ? to_f(cp[(size_t)t * states]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u >= steps) break;
      const float a = expf(__fmul_rn(dtv[u], an));
      const float b = __fmul_rn(__fmul_rn(dtv[u], xv[u]), bv[u]);
      h = __fadd_rn(__fmul_rn(a, h), b);
      float s = __fmul_rn(h, cv[u]);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(group, s, off, G));
      if (n == 0) yp[(size_t)(t0 + u) * channels] = s;
    }
  }
  if (real) hf[((size_t)blockIdx.y * channels + d) * states + n] = h;
}

template <typename T, int G>
int launch_g(const void* dt, const void* bm, const void* cm, const void* x,
             const void* A, void* y, void* hf, int batch, int steps,
             int channels, int states, cudaStream_t stream) {
  constexpr int kChannels = kThreads / G;
  const dim3 grid((channels + kChannels - 1) / kChannels, batch);
  selective_scan_fwd<T, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<float*>(y),
      static_cast<float*>(hf), steps, channels, states);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* dt, const void* bm, const void* cm, const void* x,
           const void* A, void* y, void* hf, int batch, int steps,
           int channels, int states, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (states <= 1)
    return launch_g<T, 1>(dt, bm, cm, x, A, y, hf, batch, steps, channels,
                          states, s);
  if (states <= 2)
    return launch_g<T, 2>(dt, bm, cm, x, A, y, hf, batch, steps, channels,
                          states, s);
  if (states <= 4)
    return launch_g<T, 4>(dt, bm, cm, x, A, y, hf, batch, steps, channels,
                          states, s);
  if (states <= 8)
    return launch_g<T, 8>(dt, bm, cm, x, A, y, hf, batch, steps, channels,
                          states, s);
  if (states <= 16)
    return launch_g<T, 16>(dt, bm, cm, x, A, y, hf, batch, steps, channels,
                           states, s);
  if (states <= 32)
    return launch_g<T, 32>(dt, bm, cm, x, A, y, hf, batch, steps, channels,
                           states, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int selective_scan_bf16(const void* dt, const void* bm, const void* cm,
                        const void* x, const void* A, void* y, void* hf,
                        int batch, int steps, int channels, int states,
                        void* stream) {
  return launch<__nv_bfloat16>(dt, bm, cm, x, A, y, hf, batch, steps,
                               channels, states, stream);
}

int selective_scan_f32(const void* dt, const void* bm, const void* cm,
                       const void* x, const void* A, void* y, void* hf,
                       int batch, int steps, int channels, int states,
                       void* stream) {
  return launch<float>(dt, bm, cm, x, A, y, hf, batch, steps, channels,
                       states, stream);
}

}  // extern "C"
