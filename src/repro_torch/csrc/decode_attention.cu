// K6: flash-decoding attention, the port of
// src/repro/kernels/decode_attention.py::decode_attention (Pallas body
// `_decode_kernel` and the XLA combine of its wrapper).
//
// One query per sequence: q (B, H, D) against the cache k, v (B, Sk, Hkv,
// D), the keys at positions >= min(length, Sk) masked, o (B, H, D) in q's
// type; scores, softmax and the PV sum in fp32.  Masked scores take the
// reference's finite -1e30, never -inf.
//
// What bounds it: bytes.  Every valid key and value row is read once:
// TinyLlama-1.1B's decode (B 4, Hkv 4, D 64, 2,048 keys, bf16) reads
// 8.39 MB, about 2.5 us at the 3.35 TB/s of an NVIDIA H100 SXM (data
// sheet, 700 W limit); a 32k cache of Qwen2.5-14B's heads (Hkv 8, D 128)
// 134 MB, about 40 us.  Each key costs 4 g D operations for the g query
// heads that share it, far below the card's rate.
//
// Design: the Pallas grid (B, Hkv, nsplit, tiles) walks each split's tiles
// along a sequential grid axis with the online-softmax state in VMEM.  Here
// one CTA of 256 threads owns one (b, kv head, split) and loops over the
// split's keys itself, 64 at a time through shared memory (a 227 KB SM
// cannot hold a reference-sized 256-key tile of K and V in fp32 at D 128),
// stopping at min(length, Sk) so that keys at or past it are never read.
// The g query heads of the kv head are the rows of the score product, so
// each K/V row is read once for all of them.  Per 64-key step: K and V
// converted to fp32 in shared memory (K rows padded to D + 1 floats, so the
// 32 keys a warp scores fall in 32 banks), g x 64 scores by FMA, one warp
// per head updates its running max and sum, then each thread rescales and
// adds to its own <= 16 of the g x D accumulators, which live in registers
// for the whole split.  The split emits un-normalised (o * l, m, l); a
// second kernel rescales and combines the splits, as the reference's XLA
// epilogue does.  A split with no valid key emits (0, -1e30, 0) and weighs
// exactly 0 in the combine (exp(-1e30 - m_max) is 0); with no valid key
// at all every weight is 1 and every l 0, so the output is 0 / 1e-30 = 0.
// Tensor cores and asynchronous copies are later work.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // keys per shared-memory step
constexpr int kMaxOut = 16;               // accumulators per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int g, int d) {
  return sizeof(float) *
         ((size_t)g * d + (size_t)kTile * (d + 1) + (size_t)kTile * d +
          (size_t)g * kTile + 3 * (size_t)g);
}

// Rows j < nk of the K and V tile starting at key t0 of (b, kv head), into
// shared memory as fp32 (K rows of stride d + 1, V rows of stride d).
template <typename T, bool VECTOR>
__device__ __forceinline__ void load_tile(const T* __restrict__ kb,
                                          const T* __restrict__ vb,
                                          size_t row_stride, int nk, int d,
                                          float* ks, float* vs) {
  if (VECTOR) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = d / V;
    for (int i = threadIdx.x; i < nk * per_row; i += kThreads) {
      const int j = i / per_row, c = (i % per_row) * V;
      const uint4 rk =
          *reinterpret_cast<const uint4*>(kb + j * row_stride + c);
      const uint4 rv =
          *reinterpret_cast<const uint4*>(vb + j * row_stride + c);
      const T* ek = reinterpret_cast<const T*>(&rk);
      const T* ev = reinterpret_cast<const T*>(&rv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ks[j * (d + 1) + c + e] = to_f(ek[e]);
        vs[j * d + c + e] = to_f(ev[e]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < nk * d; i += kThreads) {
      const int j = i / d, c = i % d;
      ks[j * (d + 1) + c] = to_f(kb[j * row_stride + c]);
      vs[j * d + c] = to_f(vb[j * row_stride + c]);
    }
  }
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ len_ptr,
             int len_val, float* __restrict__ acc, float* __restrict__ ml,
             int batch, int heads, int kv_heads, int keys, int d, int ns,
             int per_split, float scale) {
  const int split = blockIdx.x, kh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = heads / kv_heads;
  const int nout = g * d;
  int len = len_ptr ? *len_ptr : len_val;
  len = min(max(len, 0), keys);
  const int lo = split * per_split;
  const int hi = min(lo + per_split, len);

  extern __shared__ float smem[];
  float* qs = smem;                        // (g, d)
  float* ks = qs + g * d;                  // (kTile, d + 1)
  float* vs = ks + kTile * (d + 1);        // (kTile, d)
  float* ss = vs + kTile * d;              // (g, kTile): scores, then p
  float* ms = ss + g * kTile;              // (g,) running max
  float* ls = ms + g;                      // (g,) running sum
  float* as = ls + g;                      // (g,) this step's rescale

  const T* qb = q + ((size_t)bi * heads + (size_t)kh * g) * d;
  for (int i = tid; i < nout; i += kThreads) qs[i] = to_f(qb[i]);
  for (int i = tid; i < g; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }
  float accr[kMaxOut];
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) accr[r] = 0.f;
  __syncthreads();

  const size_t row_stride = (size_t)kv_heads * d;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int nk = min(kTile, hi - t0);
    const size_t off = ((size_t)bi * keys + t0) * row_stride + (size_t)kh * d;
    load_tile<T, VECTOR>(k + off, v + off, row_stride, nk, d, ks, vs);
    __syncthreads();

    // scores: thread -> key j = tid % kTile, heads tid / kTile + 4 r
    for (int e = tid; e < g * kTile; e += kThreads) {
      const int j = e % kTile, gi = e / kTile;
      float s = kNegInf;
      if (j < nk) {
        const float* qr = qs + gi * d;
        const float* kr = ks + j * (d + 1);
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s = dot * scale;
      }
      ss[gi * kTile + j] = s;
    }
    __syncthreads();

    // online softmax, one warp per head (kTile = 2 x 32 keys per lane pair)
    for (int gi = warp; gi < g; gi += kWarps) {
      float* sr = ss + gi * kTile;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float m_prev = ms[gi];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        as[gi] = alpha;
        ls[gi] = ls[gi] * alpha + sum;
        ms[gi] = m_new;
      }
    }
    __syncthreads();

    // o = o * alpha + p V over this step's valid keys
#pragma unroll
    for (int r = 0; r < kMaxOut; ++r) {
      const int o = tid + r * kThreads;
      if (o < nout) {
        const int gi = o / d, c = o % d;
        const float* pr = ss + gi * kTile;
        float sum = 0.f;
        for (int j = 0; j < nk; ++j) sum = fmaf(pr[j], vs[j * d + c], sum);
        accr[r] = fmaf(accr[r], as[gi], sum);
      }
    }
    __syncthreads();
  }

  const size_t part = ((size_t)bi * kv_heads + kh) * ns + split;
  float* accb = acc + part * nout;
#pragma unroll
  for (int r = 0; r < kMaxOut; ++r) {
    const int o = tid + r * kThreads;
    if (o < nout) accb[o] = accr[r];
  }
  float* mb = ml + part * g;
  float* lb = mb + (size_t)batch * kv_heads * ns * g;
  for (int i = tid; i < g; i += kThreads) {
    mb[i] = ms[i];
    lb[i] = ls[i];
  }
}

// o[b, h, c] = sum_s acc_s exp(m_s - m_max) / max(sum_s l_s exp(m_s - m_max),
// 1e-30), one thread per output element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
               T* __restrict__ o, int batch, int heads, int kv_heads, int d,
               int ns) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)batch * heads * d) return;
  const int c = idx % d;
  const int h = (idx / d) % heads;
  const int bi = idx / ((size_t)d * heads);
  const int g = heads / kv_heads, kh = h / g, gi = h % g;
  const size_t base = ((size_t)bi * kv_heads + kh) * ns;
  const float* m = ml;
  const float* l = ml + (size_t)batch * kv_heads * ns * g;
  float m_max = m[base * g + gi];
  for (int s = 1; s < ns; ++s) m_max = fmaxf(m_max, m[(base + s) * g + gi]);
  float l_tot = 0.f, a = 0.f;
  for (int s = 0; s < ns; ++s) {
    const size_t p = (base + s) * g + gi;
    const float w = expf(m[p] - m_max);
    l_tot = fmaf(l[p], w, l_tot);
    a = fmaf(acc[p * d + c], w, a);
  }
  o[idx] = from_f<T>(a / fmaxf(l_tot, 1e-30f));
}

template <typename T, bool VECTOR>
int launch_split(const void* q, const void* k, const void* v,
                 const int* len_ptr, int len_val, float* acc, float* ml,
                 int batch, int heads, int kv_heads, int keys, int d, int ns,
                 int per_split, float scale, cudaStream_t st) {
  const size_t bytes = smem_bytes(heads / kv_heads, d);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<T, VECTOR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(ns, kv_heads, batch);
  split_kernel<T, VECTOR><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len_ptr, len_val, acc, ml, batch, heads,
      kv_heads, keys, d, ns, per_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* len_ptr,
           int len_val, void* acc, void* ml, void* o, int batch, int heads,
           int kv_heads, int keys, int d, int ns, int per_split, float scale,
           int vector, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lp = static_cast<const int*>(len_ptr);
  float* accf = static_cast<float*>(acc);
  float* mlf = static_cast<float*>(ml);
  const int err =
      vector ? launch_split<T, true>(q, k, v, lp, len_val, accf, mlf, batch,
                                     heads, kv_heads, keys, d, ns, per_split,
                                     scale, st)
             : launch_split<T, false>(q, k, v, lp, len_val, accf, mlf, batch,
                                      heads, kv_heads, keys, d, ns, per_split,
                                      scale, st);
  if (err) return err;
  const size_t total = (size_t)batch * heads * d;
  combine_kernel<T><<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      accf, mlf, static_cast<T*>(o), batch, heads, kv_heads, d, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (batch, heads, d); k, v: (batch, keys, kv_heads, d), row-major, of the
// named type.  length: `len_ptr`, one int32 on the device, or `len_val` when
// `len_ptr` is null.  acc: (batch, kv_heads, ns, heads / kv_heads, d) fp32
// and ml: (2, batch, kv_heads, ns, heads / kv_heads) fp32 scratch; o: q's
// shape and type.  Split s covers keys [s per_split, (s + 1) per_split).
// `vector`: d is a multiple of 16 bytes and k, v are 16-byte aligned.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* len_ptr,
                                     int len_val, void* acc, void* ml,
                                     void* o, int batch, int heads,
                                     int kv_heads, int keys, int d, int ns,
                                     int per_split, float scale, int vector,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, len_ptr, len_val, acc, ml, o, batch,
                               heads, kv_heads, keys, d, ns, per_split, scale,
                               vector, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* len_ptr,
                                    int len_val, void* acc, void* ml, void* o,
                                    int batch, int heads, int kv_heads,
                                    int keys, int d, int ns, int per_split,
                                    float scale, int vector, void* stream) {
  return launch<float>(q, k, v, len_ptr, len_val, acc, ml, o, batch, heads,
                       kv_heads, keys, d, ns, per_split, scale, vector,
                       stream);
}
