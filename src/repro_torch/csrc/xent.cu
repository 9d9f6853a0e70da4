// K10: fused softmax cross-entropy over vocab tiles, the port of
// src/repro/kernels/xent.py::blocked_xent (Pallas body `_xent_kernel`).
//
// For each token t, with logits[t, v] = sum_k x[t, k] * emb[v, k] in fp32
// from the inputs' values (bf16 or fp32), never stored:
//   nll[t]  = max_v logits + log(sum_v exp(logits - max)) - logits[t, label]
//   amax[t] = the first v of the row maximum (the `acc` of
//             models/loss.py::blocked_cross_entropy).
// A label outside [0, V) leaves the label logit at -inf, so nll = +inf, as
// in the reference's scan.
//
// What bounds it: operations.  2 T V d of them against (T + V) d input
// elements: at T = 8192, V = 32000, d = 2048 in bf16 that is 1.07 TFLOP
// and 0.16 GB, 1.09 ms at the 989 TFLOP/s of the bf16 tensor cores of an
// NVIDIA H100 SXM (data sheet, 700 W).  This first version multiplies
// with fp32 FMAs on the CUDA cores (67 TFLOP/s peak), so it stays above
// ~16 ms there; tensor-core tiles are later work, as for K5 and K9.
//
// Design.  The Pallas grid (token tiles "parallel", vocab tiles
// "arbitrary", running max / sum-exp / label logit in VMEM scratch)
// becomes a grid of (token tiles of 64, vocab chunks of `chunk` columns):
// 128 token tiles alone would leave SMs of the 132 idle, so the vocabulary
// is split across blocks as flash decoding splits keys.  A block walks its
// chunk in tiles of 128 columns.  Each tile is a 64 x 128 product over d
// in steps of 32 through shared memory (operands converted to fp32 on the
// way in), each thread holding 4 x 8 logits in registers; the tile is then
// folded into the thread's running (max, sum-exp, label logit, argmax) of
// its own columns.  At the end of the chunk the 16 threads of a row merge
// theirs by shuffles.  With one chunk the block writes the result; else it
// writes its partials, and the last block of the token tile to finish (a
// counter per token tile, after a fence) merges the chunks and writes nll
// and the argmax: one launch per call.  Every argmax merge keeps the
// larger value and, on a tie, the lower index, so the result is the first
// index of the row maximum, as jnp.argmax within a block and strict `>`
// across blocks give it in the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;        // tokens per block
constexpr int BV = 128;       // vocab columns per tile
constexpr int BK = 32;        // d per shared-memory step
constexpr int THREADS = 256;  // 16 x 16: 4 rows x 8 columns each
constexpr int TM = 4;
constexpr int TN = 8;
constexpr int NO_INDEX = 0x7fffffff;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (m, s) <- the log-sum-exp pair of both: s relative to m.
__device__ __forceinline__ void merge_ms(float& m, float& s, float m2,
                                         float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;                 // both still empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);   // expf(-inf) = 0
  m = mn;
}

// (value, index) of the larger value; on a tie the lower index.
__device__ __forceinline__ void merge_arg(float& av, int& ai, float av2,
                                          int ai2) {
  if (av2 > av || (av2 == av && ai2 < ai)) {
    av = av2;
    ai = ai2;
  }
}

// Rows [r0, r0 + R) x columns [k0, k0 + BK) of a row-major (rows, d)
// matrix into dst[k][r] as fp32, zeros outside.  VEC: 16-byte loads (d a
// multiple of 16 bytes' elements, 16-byte aligned base).
template <int R, typename T, bool VEC>
__device__ __forceinline__ void load_k_major(const T* __restrict__ src,
                                             float (*dst)[R], int r0,
                                             int k0, int rows, int d,
                                             int tid) {
  if (VEC) {
    constexpr int E = 16 / sizeof(T);
    constexpr int PER_ROW = BK / E;
    for (int i = tid; i < R * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, kc = (i % PER_ROW) * E;
      const int gr = r0 + r, gk = k0 + kc;
      float v[E];
      if (gr < rows && gk < d) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + (size_t)gr * d + gk);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < E; ++j) v[j] = to_f(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < E; ++j) dst[kc + j][r] = v[j];
    }
  } else {
    for (int i = tid; i < R * BK; i += THREADS) {
      const int r = i / BK, k = i % BK;
      const int gr = r0 + r, gk = k0 + k;
      dst[k][r] = (gr < rows && gk < d) ? to_f(src[(size_t)gr * d + gk])
                                        : 0.f;
    }
  }
}

// Rows [k0, k0 + BK) x columns [v0, v0 + BV) of the row-major (d, V) head
// into dst[k][c] as fp32, zeros outside (columns from v_end on).  VEC:
// 16-byte loads (V a multiple of 16 bytes' elements, aligned base).
template <typename T, bool VEC>
__device__ __forceinline__ void load_v_major(const T* __restrict__ src,
                                             float (*dst)[BV], int v0,
                                             int k0, int v_end, int V,
                                             int d, int tid) {
  if (VEC) {
    constexpr int E = 16 / sizeof(T);
    constexpr int PER_K = BV / E;
    for (int i = tid; i < BK * PER_K; i += THREADS) {
      const int k = i / PER_K, c = (i % PER_K) * E;
      const int gk = k0 + k, gc = v0 + c;
      float v[E];
      if (gk < d && gc < v_end) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + (size_t)gk * V + gc);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < E; ++j) v[j] = to_f(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < E; j += 4)
        *reinterpret_cast<float4*>(&dst[k][c + j]) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else {
    for (int i = tid; i < BK * BV; i += THREADS) {
      const int k = i / BV, c = i % BV;
      const int gk = k0 + k, gc = v0 + c;
      dst[k][c] = (gk < d && gc < v_end) ? to_f(src[(size_t)gk * V + gc])
                                         : 0.f;
    }
  }
}

// Grid (ceil(T / BT), ceil(V / chunk)); chunk a multiple of BV.  With more
// than one chunk, `part` holds 5 planes of (chunks, T) partials (max,
// sum-exp, label logit, argmax value, argmax index as int bits) and
// `counter` one zeroed int per token tile.
template <typename T, bool VEC, bool EMB_DV>
__global__ void __launch_bounds__(THREADS)
xent_kernel(const T* __restrict__ x, const T* __restrict__ emb,
            const int* __restrict__ labels, float* __restrict__ nll,
            int* __restrict__ amax, float* __restrict__ part,
            int* __restrict__ counter, int n_tok, int V, int d, int chunk) {
  __shared__ __align__(16) float xs[BK][BT];
  __shared__ __align__(16) float es[BK][BV];
  __shared__ int is_last;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = blockIdx.x * BT;
  const int n_chunks = gridDim.y;
  const int v_begin = blockIdx.y * chunk;
  const int v_end = min(V, v_begin + chunk);

  int lab[TM];
  float m[TM], s[TM], ll[TM], av[TM];
  int ai[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty * TM + i;
    lab[i] = t < n_tok ? labels[t] : -1;
    m[i] = -INFINITY;
    s[i] = 0.f;
    ll[i] = -INFINITY;
    av[i] = -INFINITY;
    ai[i] = NO_INDEX;
  }

  for (int v0 = v_begin; v0 < v_end; v0 += BV) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      load_k_major<BT, T, VEC>(x, xs, t0, k0, n_tok, d, tid);
      if (EMB_DV)
        load_v_major<T, VEC>(emb, es, v0, k0, v_end, V, d, tid);
      else
        load_k_major<BV, T, VEC>(emb, es, v0, k0, v_end, d, tid);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * TM]);
        const float4 b0 = *reinterpret_cast<const float4*>(&es[k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&es[k][64 + tx * 4]);
        const float ar[TM] = {a.x, a.y, a.z, a.w};
        const float br[TN] = {b0.x, b0.y, b0.z, b0.w,
                              b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }

    // fold the tile into this thread's running statistics
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = -INFINITY;
      int targ = NO_INDEX;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = v0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        if (col < v_end) {
          if (acc[i][j] > tmax) {
            tmax = acc[i][j];
            targ = col;
          }
          if (col == lab[i]) ll[i] = acc[i][j];
        }
      }
      if (tmax != -INFINITY) {
        const float mn = fmaxf(m[i], tmax);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = v0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
          if (col < v_end) sum += expf(acc[i][j] - mn);
        }
        s[i] = s[i] * expf(m[i] - mn) + sum;
        m[i] = mn;
        merge_arg(av[i], ai[i], tmax, targ);
      }
    }
  }

  // merge the 16 threads of each row (lanes 0-15 and 16-31 hold two rows'
  // groups; xor offsets below 16 stay inside a group)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], o);
      const float ll2 = __shfl_xor_sync(0xffffffffu, ll[i], o);
      const float av2 = __shfl_xor_sync(0xffffffffu, av[i], o);
      const int ai2 = __shfl_xor_sync(0xffffffffu, ai[i], o);
      merge_ms(m[i], s[i], m2, s2);
      ll[i] = fmaxf(ll[i], ll2);
      merge_arg(av[i], ai[i], av2, ai2);
    }
  }

  const size_t plane = (size_t)n_chunks * n_tok;
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int t = t0 + ty * TM + i;
      if (t >= n_tok) continue;
      if (n_chunks == 1) {
        nll[t] = m[i] + logf(s[i]) - ll[i];
        amax[t] = ai[i];
      } else {
        const size_t o = (size_t)blockIdx.y * n_tok + t;
        part[o] = m[i];
        part[plane + o] = s[i];
        part[2 * plane + o] = ll[i];
        part[3 * plane + o] = av[i];
        part[4 * plane + o] = __int_as_float(ai[i]);
      }
    }
  }
  if (n_chunks == 1) return;

  // the last block of this token tile to finish merges the chunks
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(&counter[blockIdx.x], 1) == n_chunks - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int t = t0 + tid;
  if (tid < BT && t < n_tok) {
    float M = -INFINITY, S = 0.f, LL = -INFINITY, AV = -INFINITY;
    int AI = NO_INDEX;
    for (int c = 0; c < n_chunks; ++c) {
      const size_t o = (size_t)c * n_tok + t;
      merge_ms(M, S, __ldcg(part + o), __ldcg(part + plane + o));
      LL = fmaxf(LL, __ldcg(part + 2 * plane + o));
      merge_arg(AV, AI, __ldcg(part + 3 * plane + o),
                __float_as_int(__ldcg(part + 4 * plane + o)));
    }
    nll[t] = M + logf(S) - LL;
    amax[t] = AI;
  }
}

template <typename T>
int launch(const void* x, const void* emb, const void* labels, void* nll,
           void* amax, void* part, void* counter, int n_tok, int V, int d,
           int chunk, int emb_dv, int vector, void* stream) {
  const dim3 grid((n_tok + BT - 1) / BT, (V + chunk - 1) / chunk);
  const dim3 block(THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XENT_LAUNCH(VEC, DV)                                                \
  xent_kernel<T, VEC, DV><<<grid, block, 0, st>>>(                          \
      static_cast<const T*>(x), static_cast<const T*>(emb),                 \
      static_cast<const int*>(labels), static_cast<float*>(nll),            \
      static_cast<int*>(amax), static_cast<float*>(part),                   \
      static_cast<int*>(counter), n_tok, V, d, chunk)
  if (vector && emb_dv) XENT_LAUNCH(true, true);
  else if (vector) XENT_LAUNCH(true, false);
  else if (emb_dv) XENT_LAUNCH(false, true);
  else XENT_LAUNCH(false, false);
#undef XENT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n_tok, d) row-major; emb: (V, d), or (d, V) when emb_dv; labels:
// (n_tok,) int32; nll: (n_tok,) fp32; amax: (n_tok,) int32.  part and
// counter as for xent_kernel (unused with one chunk).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int blocked_xent_bf16(const void* x, const void* emb,
                                 const void* labels, void* nll, void* amax,
                                 void* part, void* counter, int n_tok, int V,
                                 int d, int chunk, int emb_dv, int vector,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, emb, labels, nll, amax, part, counter,
                               n_tok, V, d, chunk, emb_dv, vector, stream);
}

extern "C" int blocked_xent_f32(const void* x, const void* emb,
                                const void* labels, void* nll, void* amax,
                                void* part, void* counter, int n_tok, int V,
                                int d, int chunk, int emb_dv, int vector,
                                void* stream) {
  return launch<float>(x, emb, labels, nll, amax, part, counter, n_tok, V,
                       d, chunk, emb_dv, vector, stream);
}
