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
//
// The backward (K8's backward; the reference differentiates its XLA
// `rms_norm`, src/repro/models/layers.py:23, with jax.grad): with
// g = dL/dy, g^ = g * (1 + scale), r recomputed from x and x^ = x * r,
//   dx = r * (g^ - x^ * mean(g^ * x^))  in x's type,
//   d scale = sum over rows of g * x^   summed in fp32, rounded once.
// It reads x and g and writes dx: 100.7 MB at TinyLlama-1.1B's training
// rows (8192, 2048) in bf16, 0.030 ms at 3.35 TB/s.  `rms_bwd_rows`
// takes a warp a row, `bwd_plan`'s rows in a fixed grid-stride order;
// each warp reads its row twice (sum(x^2) and sum(g^ x), then dx; the
// second read from L1/L2) and adds g x^ into its own fp32 partial of
// d scale in shared memory; the block sums its warps' partials in warp
// order into a per-block row.  `rms_bwd_sum` then adds the blocks' rows
// column by column in block order.  No atomics: two launches on the
// same inputs give the same bits.
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


// K8's backward, per row: dx, and this warp's partial of d scale in
// shared memory.  VECTOR: 16-byte pieces (d a multiple of V; x, g,
// scale 16-byte aligned), the partial kept piece-major (column i * V + j
// at j * (d / V) + i) so a warp's 32 lanes touch 32 banks; else one
// element at a time, the partial column-major.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kMaxThreads)
rms_bwd_rows(const T* __restrict__ x, const T* __restrict__ scale,
             const T* __restrict__ g, T* __restrict__ dx,
             float* __restrict__ part, int rows, int d, float eps) {
  extern __shared__ float sacc[];             // [warps][d]
  constexpr int V = 16 / sizeof(T);
  const int warps = blockDim.x / 32;
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* acc = sacc + (size_t)w * d;
  for (int c = lane; c < d; c += 32) acc[c] = 0.f;
  const int np = d / V;
  for (int row = blockIdx.x * warps + w; row < rows;
       row += gridDim.x * warps) {
    const T* xr = x + (size_t)row * d;
    const T* gr = g + (size_t)row * d;
    T* dr = dx + (size_t)row * d;
    float ss = 0.f, sg = 0.f;
    if (VECTOR) {
      for (int i = lane; i < np; i += 32) {
        const uint4 xv = reinterpret_cast<const uint4*>(xr)[i];
        const uint4 gv = reinterpret_cast<const uint4*>(gr)[i];
        const uint4 sv = reinterpret_cast<const uint4*>(scale)[i];
        const T* xe = reinterpret_cast<const T*>(&xv);
        const T* ge = reinterpret_cast<const T*>(&gv);
        const T* se = reinterpret_cast<const T*>(&sv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xf = to_f(xe[j]);
          ss = fmaf(xf, xf, ss);
          sg = fmaf(to_f(ge[j]) * (1.0f + to_f(se[j])), xf, sg);
        }
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float xf = to_f(xr[c]);
        ss = fmaf(xf, xf, ss);
        sg = fmaf(to_f(gr[c]) * (1.0f + to_f(scale[c])), xf, sg);
      }
    }
    const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
    const float cx = r * r * warp_sum(sg) / (float)d;  // x^ mean(g^ x^) / x
    if (VECTOR) {
      for (int i = lane; i < np; i += 32) {
        const uint4 xv = reinterpret_cast<const uint4*>(xr)[i];
        const uint4 gv = reinterpret_cast<const uint4*>(gr)[i];
        const uint4 sv = reinterpret_cast<const uint4*>(scale)[i];
        const T* xe = reinterpret_cast<const T*>(&xv);
        const T* ge = reinterpret_cast<const T*>(&gv);
        const T* se = reinterpret_cast<const T*>(&sv);
        uint4 out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xf = to_f(xe[j]), gf = to_f(ge[j]);
          oe[j] = from_f<T>(r * (gf * (1.0f + to_f(se[j])) - xf * cx));
          acc[j * np + i] = fmaf(gf, xf * r, acc[j * np + i]);
        }
        reinterpret_cast<uint4*>(dr)[i] = out;
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float xf = to_f(xr[c]), gf = to_f(gr[c]);
        dr[c] = from_f<T>(r * (gf * (1.0f + to_f(scale[c])) - xf * cx));
        acc[c] = fmaf(gf, xf * r, acc[c]);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const int at = VECTOR ? (c % V) * np + c / V : c;
    float s = 0.f;
    for (int k = 0; k < warps; ++k) s += sacc[(size_t)k * d + at];
    part[(size_t)blockIdx.x * d + c] = s;
  }
}

// d scale[c] = sum over the blocks' partial rows, in block order: 8
// strided groups of blocks a column, then the 8 group sums in order.
constexpr int kSumGroups = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kSumGroups)
rms_bwd_sum(const float* __restrict__ part, T* __restrict__ dscale,
            int blocks, int d) {
  __shared__ float grp[kSumGroups][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < d)
    for (int b = threadIdx.y; b < blocks; b += kSumGroups)
      s += part[(size_t)b * d + c];
  grp[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSumGroups; ++k) t += grp[k][threadIdx.x];
    dscale[c] = from_f<T>(t);
  }
}

template <typename T>
int launch_bwd(const void* xp, const void* sp, const void* gp, void* dxp,
               void* dsp, void* partp, int rows, int d, float eps,
               int blocks, int warps, int vector, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || warps < 1 || 32 * warps > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xp);
  const T* s = static_cast<const T*>(sp);
  const T* g = static_cast<const T*>(gp);
  float* part = static_cast<float*>(partp);
  const int bytes = warps * d * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vector ? rms_bwd_rows<T, true> : rms_bwd_rows<T, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (vector)
    rms_bwd_rows<T, true><<<blocks, 32 * warps, bytes, st>>>(
        x, s, g, static_cast<T*>(dxp), part, rows, d, eps);
  else
    rms_bwd_rows<T, false><<<blocks, 32 * warps, bytes, st>>>(
        x, s, g, static_cast<T*>(dxp), part, rows, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rms_bwd_sum<T><<<(d + 31) / 32, dim3(32, kSumGroups), 0, st>>>(
      part, static_cast<T*>(dsp), blocks, d);
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

// K8's backward.  x, g, dx: (rows, d) row-major; scale, dscale: (d,) of
// x's type; part: (blocks, d) fp32 scratch.  blocks and warps: the
// wrapper's `bwd_plan` (a warp a row, warps * d floats of shared memory a
// block); vector: x, g and scale 16-byte aligned and d a multiple of 16
// bytes.  Returns the CUDA error code of the launches (0 on success).
extern "C" int rmsnorm_bwd_bf16(const void* x, const void* scale,
                                const void* g, void* dx, void* dscale,
                                void* part, int rows, int d, float eps,
                                int blocks, int warps, int vector,
                                void* stream) {
  return launch_bwd<__nv_bfloat16>(x, scale, g, dx, dscale, part, rows, d,
                                   eps, blocks, warps, vector, stream);
}

extern "C" int rmsnorm_bwd_f32(const void* x, const void* scale,
                               const void* g, void* dx, void* dscale,
                               void* part, int rows, int d, float eps,
                               int blocks, int warps, int vector,
                               void* stream) {
  return launch_bwd<float>(x, scale, g, dx, dscale, part, rows, d, eps,
                           blocks, warps, vector, stream);
}
