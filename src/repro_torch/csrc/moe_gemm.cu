// K9: grouped (per-expert) GEMM over block-sorted rows, the port of
// src/repro/kernels/moe_gemm.py::grouped_gemm (Pallas body `_gg_kernel`).
//
// x (T, d) row-major, its rows sorted so that every block_m-row block
// belongs to one expert; w (E, d, f) row-major; block_ids (T / block_m,)
// int32.  out[i, :] = x[i, :] @ w[block_ids[i / block_m]] with fp32
// accumulation over d, written in x's type (fp32 or bf16).  One addition
// to the reference's contract: a block whose id lies outside [0, E) (the
// packed layout's -1) is written as zeros and reads nothing.
//
// What bounds it: bytes.  Each expert's (d, f) weight slab is the bulk of
// the traffic: at the DeepSeek-V2-Lite widths (d 2048, f 1408, bf16) a
// slab is 5.77 MB, and a prefill of 916 tokens x top-6 touches all 64
// experts per product (369 MB, 0.11 ms at the 3.35 TB/s of an NVIDIA
// H100 SXM, data sheet, 700 W limit) for <= 32 GFLOP (0.032 ms at the
// 989 TFLOP/s of its bf16 tensor cores).  A decode tick of 4 slots routes
// 24 rows: <= 24 slabs and almost no arithmetic.  This first version does
// the arithmetic with fp32 FMAs on the CUDA cores (67 TFLOP/s peak), so
// at prefill its own ceiling is the FMA rate, not the bound; mma/wgmma
// tiles are later work.
//
// Design: the Pallas grid (row block, column tile, d step) with the d
// axis sequential becomes one block per (row tile, column tile) that
// loops over d itself.  The block reads its expert id from block_ids and
// points at that expert's slab (the TPU's scalar-prefetch index map).
// Per d step it stages the (BM, BK) row tile transposed and the (BK, BN)
// weight tile row-major in shared memory as fp32; the next step's tiles
// are loaded into registers (16 bytes a load where rows are aligned, raw)
// while this step's FMAs run.  A thread owns a TM x TN block of the
// output tile in fp32 registers and reads its operands as float4.  Two tile shapes:
// 64 x 64 (BK 32, 4 x 4 per thread) for prefill-sized groups, and 8 x 128
// (BK 64, 1 x 4 per thread) for decode, where a group holds a handful of
// rows and the kernel is a stream over weight slabs.  Ragged f and d are
// masked (zero-filled loads, no store past f).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;

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

template <typename T, int BM, int BN, int BK, int TM, int TN, bool VEC>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ block_ids, T* __restrict__ out,
                    int block_m, int n_experts, int d, int f) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one output per thread");
  static_assert(TN == 4 && (TM == 1 || TM == 4), "float4 reads");
  // elements per global load: 16 bytes when VEC (rows of x and w aligned
  // to 16 bytes, d and f multiples of V), else one
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  static_assert(BK % V == 0 && BN % V == 0, "whole vectors per tile row");
  constexpr int LDA = BM + 4;                 // transposed row tile
  constexpr int A_VECS = BM * BK / V;         // loads per tile
  constexpr int B_VECS = BK * BN / V;
  constexpr int A_PER = (A_VECS + THREADS - 1) / THREADS;
  constexpr int B_PER = B_VECS / THREADS;
  static_assert(B_VECS % THREADS == 0, "whole weight tiles per thread");
  constexpr int COLS = BN / TN;
  using Chunk = typename std::conditional<VEC, uint4, T>::type;

  __shared__ __align__(16) float sA[BK * LDA];
  __shared__ __align__(16) float sB[BK * BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ty = tid / COLS;
  const int tx = tid % COLS;
  const int e = block_ids[row0 / block_m];

  if (e < 0 || e >= n_experts) {              // an empty block: zeros
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int c = n0 + i % BN;
      if (c < f) out[(size_t)(row0 + i / BN) * f + c] = from_f<T>(0.f);
    }
    return;
  }
  const T* xb = x + (size_t)row0 * d;
  const T* wb = w + (size_t)e * d * f;

  // the next d step's tiles, held raw in registers while the FMAs run
  Chunk ra[A_PER], rb[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BK / V), c = (idx % (BK / V)) * V;
      const bool in = idx < A_VECS && k0 + c < d;
      ra[i] = in ? *reinterpret_cast<const Chunk*>(xb + (size_t)r * d + k0 + c)
                 : Chunk{};
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BN / V), c = (idx % (BN / V)) * V;
      const bool in = k0 + r < d && n0 + c < f;
      rb[i] = in ? *reinterpret_cast<const Chunk*>(
                       wb + (size_t)(k0 + r) * f + n0 + c)
                 : Chunk{};
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * THREADS;
      if (idx >= A_VECS) continue;
      const int r = idx / (BK / V), c = (idx % (BK / V)) * V;
      const T* v = reinterpret_cast<const T*>(&ra[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) sA[(c + j) * LDA + r] = to_f(v[j]);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BN / V), c = (idx % (BN / V)) * V;
      const T* v = reinterpret_cast<const T*>(&rb[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) sB[r * BN + c + j] = to_f(v[j]);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < d; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < d) load(k0 + BK);           // in flight during the FMAs
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM];
      if constexpr (TM == 4) {
        const float4 av =
            *reinterpret_cast<const float4*>(&sA[k * LDA + ty * TM]);
        a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
      } else {
        a[0] = sA[k * LDA + ty];
      }
      const float4 b = *reinterpret_cast<const float4*>(&sB[k * BN + tx * TN]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    T* o = out + (size_t)(row0 + ty * TM + i) * f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < f) o[c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch_tiles(const void* x, const void* w, const void* ids, void* out,
                 int t, int block_m, int n_experts, int d, int f, int vector,
                 cudaStream_t st) {
  const dim3 grid(t / BM, (f + BN - 1) / BN);
  auto* xp = static_cast<const T*>(x);
  auto* wp = static_cast<const T*>(w);
  auto* ip = static_cast<const int*>(ids);
  auto* op = static_cast<T*>(out);
  if (vector)
    grouped_gemm_kernel<T, BM, BN, BK, TM, TN, true><<<grid, THREADS, 0, st>>>(
        xp, wp, ip, op, block_m, n_experts, d, f);
  else
    grouped_gemm_kernel<T, BM, BN, BK, TM, TN, false><<<grid, THREADS, 0, st>>>(
        xp, wp, ip, op, block_m, n_experts, d, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* ids, void* out, int t,
           int block_m, int n_experts, int d, int f, int tile_m, int vector,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_m == 64)
    return launch_tiles<T, 64, 64, 32, 4, 4>(x, w, ids, out, t, block_m,
                                             n_experts, d, f, vector, st);
  if (tile_m == 8)
    return launch_tiles<T, 8, 128, 64, 1, 4>(x, w, ids, out, t, block_m,
                                             n_experts, d, f, vector, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (t, d), w (n_experts, d, f), block_ids (t / block_m,) int32, out (t, f);
// tile_m (64 or 8) divides block_m, which divides t; `vector` (16-byte
// loads) only where x and w start on 16 bytes and d and f are multiples of
// 16 bytes' worth of elements.  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int grouped_gemm_bf16(const void* x, const void* w,
                                 const void* block_ids, void* out, int t,
                                 int block_m, int n_experts, int d, int f,
                                 int tile_m, int vector, void* stream) {
  return launch<__nv_bfloat16>(x, w, block_ids, out, t, block_m, n_experts, d,
                               f, tile_m, vector, stream);
}

extern "C" int grouped_gemm_f32(const void* x, const void* w,
                                const void* block_ids, void* out, int t,
                                int block_m, int n_experts, int d, int f,
                                int tile_m, int vector, void* stream) {
  return launch<float>(x, w, block_ids, out, t, block_m, n_experts, d, f,
                       tile_m, vector, stream);
}
