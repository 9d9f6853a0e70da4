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
// heads that share it, far below the card's rate, so tensor cores would
// not help (g = 5 rows would waste most of an m16 tile).
//
// Design: the Pallas grid (B, Hkv, nsplit, tiles) walks each split's tiles
// along a sequential grid axis with the online-softmax state in VMEM.  Here
// one CTA of 256 threads owns one (b, kv head, split), and the number of
// splits is chosen by the wrapper from B Hkv, Sk and the SM count, so that
// the CTAs fill one wave of 3 an SM (kernels/decode_attention.py
// `split_plan`: 47 splits of 704 keys at the 32k cache, 376 CTAs; 16 of
// 128 at TinyLlama's, 256 CTAs).  A CTA streams its keys through a
// two-stage cp.async ring of K and V tiles in their storage type (64 keys
// in bf16, 32 in fp32; no fp32 staging copy), stopping at min(length, Sk)
// so that keys at or past it are never read.  Per tile, two barriers:
//   scores: warp w scores heads w, w + 8, ..., a lane keys lane (and
//     lane + 32 in bf16), the dot product over D from the K tile and the
//     fp32 q rows in shared memory; the same warp then updates that head's
//     running max and sum by shuffles and writes its weights p and its
//     rescale factor;
//   P V: a thread owns 2 columns x HPT heads of the g x D accumulators in
//     registers for the whole split; where those owners are fewer than
//     the 256 threads, the tile's keys are dealt among groups of owners,
//     whose sums are added in a fixed order at the end.
// The grid runs kv heads fastest, so the CTAs that read one key range's
// rows of the cache run side by side.
// The g query heads of the kv head are the rows of the score product, so
// each K/V row is read once for all of them.  The split emits
// un-normalised (o * l, m, l); a second kernel rescales and combines the
// splits, as the reference's XLA epilogue does.  A split with no valid key
// emits (0, -1e30, 0) and weighs exactly 0 in the combine (exp(-1e30 -
// m_max) is 0); with no valid key at all every weight is 1 and every l 0,
// so the output is 0 / 1e-30 = 0.  Odd head dims or unaligned caches
// stage by element loads (VECTOR false) through the same ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8;               // combine: columns a lane (D <= 256)
constexpr float kNegInf = -1e30f;

// Keys per tile (one or two a lane): bf16 tiles of 64 keys, fp32 tiles of
// 32 (the same bytes).  Two ring stages: at D 128 a CTA then takes ~74 KB
// (bf16) or ~72 KB (fp32) of shared memory, and 3 CTAs fit on an SM, each
// with a tile in flight while it computes on the other (a deeper ring
// leaves 2 CTAs an SM, and was slower on the card).
template <typename T>
constexpr int kTile = sizeof(T) == 2 ? 64 : 32;
constexpr int kStages = 2;
// CTAs an SM the registers are sized for: 3 (80 registers a thread) where
// a thread holds up to 8 heads' accumulators, 2 beyond (no spills).
template <int HPT>
constexpr int kMinBlocks = HPT <= 8 ? 3 : 2;

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

// The CTA's layout, from the shapes alone (host and device agree on it).
// Row pitches keep 16-byte rows an odd number of 16-byte chunks apart, so
// the 8 keys one phase of a 16-byte load reads fall in 8 bank groups.
template <typename T>
struct Plan {
  int dp;        // D rounded up to 8 (zero columns past D)
  int pitch;     // K / V tile row pitch, elements
  int cp;        // column pairs: ceil(D / 2)
  int hcn;       // head chunks: ceil(g / HPT)
  int units;     // cp * hcn accumulator owners
  int groups;    // key groups: kThreads / units
  int gp;        // weights row pitch (floats): hcn * HPT + 4
  size_t ring;   // ring bytes (also the final reduction's scratch)
  size_t bytes;  // dynamic shared memory

  static constexpr int KT = kTile<T>;

  __host__ __device__ Plan(int g, int d, int hpt) {
    dp = (d + 7) / 8 * 8;
    pitch = dp + 16 / (int)sizeof(T);
    cp = (d + 1) / 2;
    hcn = (g + hpt - 1) / hpt;
    units = cp * hcn;
    groups = units > 0 ? kThreads / units : 0;
    gp = hcn * hpt + 4;
    const size_t tiles = (size_t)kStages * 2 * KT * pitch * sizeof(T);
    const size_t scratch = (size_t)kThreads * 2 * hpt * sizeof(float);
    ring = tiles > scratch ? tiles : scratch;
    bytes = ring + sizeof(float) * ((size_t)g * dp + (size_t)KT * gp +
                                    3 * (size_t)gp);
  }
};

// Keys [t0, t0 + KT) of (b, kv head) into one ring stage (K rows, then V
// rows, pitch p.pitch); rows past `nk` and columns past d become zeros.
template <typename T, bool VECTOR>
__device__ __forceinline__ void fetch(T* dst, const T* __restrict__ kb,
                                      const T* __restrict__ vb,
                                      size_t row_stride, int nk, int d,
                                      const Plan<T>& p) {
  constexpr int KT = Plan<T>::KT;
  T* kd = dst;
  T* vd = dst + KT * p.pitch;
  if constexpr (VECTOR) {                 // d a multiple of 16 bytes
    constexpr int E = 16 / sizeof(T);
    const int per_row = p.dp / E;
    for (int i = threadIdx.x; i < KT * per_row; i += kThreads) {
      const int j = i / per_row, c = (i % per_row) * E;
      const bool in = j < nk && c < d;
      const size_t off = in ? j * row_stride + c : 0;
      mma::cp_async16(kd + j * p.pitch + c, kb + off, in);
      mma::cp_async16(vd + j * p.pitch + c, vb + off, in);
    }
  } else {
    for (int i = threadIdx.x; i < KT * p.dp; i += kThreads) {
      const int j = i / p.dp, c = i % p.dp;
      const bool in = j < nk && c < d;
      kd[j * p.pitch + c] = in ? kb[j * row_stride + c] : from_f<T>(0.f);
      vd[j * p.pitch + c] = in ? vb[j * row_stride + c] : from_f<T>(0.f);
    }
  }
}

// Eight fp32 values of a K row from shared memory.
__device__ __forceinline__ void row8(const bf16* r, float (&k)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(r);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    k[2 * i] = f.x;
    k[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void row8(const float* r, float (&k)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(r);
  const float4 b = *reinterpret_cast<const float4*>(r + 4);
  k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
  k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
}

// Two fp32 values of a V row (columns c, c + 1) from shared memory.
__device__ __forceinline__ float2 pair(const bf16* r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(r));
}
__device__ __forceinline__ float2 pair(const float* r) {
  return *reinterpret_cast<const float2*>(r);
}

template <typename T, int HPT, bool VECTOR>
__global__ void __launch_bounds__(kThreads, kMinBlocks<HPT>)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ len_ptr,
             int len_val, float* __restrict__ acc, float* __restrict__ ml,
             int batch, int heads, int kv_heads, int keys, int d, int ns,
             int per_split, float scale) {
  constexpr int ST = kStages, KT = Plan<T>::KT, KPL = KT / 32;
  const int kh = blockIdx.x, split = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = heads / kv_heads;
  const Plan<T> p(g, d, HPT);
  int len = len_ptr ? *len_ptr : len_val;
  len = min(max(len, 0), keys);
  const int lo = split * per_split;
  const int hi = min(lo + per_split, len);
  const size_t part = ((size_t)bi * kv_heads + kh) * ns + split;
  float* mb = ml + part * g;
  float* lb = mb + (size_t)batch * kv_heads * ns * g;
  if (hi <= lo) {                         // no valid key: (0, -1e30, 0)
    for (int i = tid; i < g * d; i += kThreads) acc[part * g * d + i] = 0.f;
    for (int i = tid; i < g; i += kThreads) {
      mb[i] = kNegInf;
      lb[i] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);            // [ST][2][KT][pitch]
  float* qs = reinterpret_cast<float*>(smem_raw + p.ring);   // (g, dp)
  float* ps = qs + g * p.dp;                           // (KT, gp) weights
  float* ms = ps + KT * p.gp;                          // (gp,) running max
  float* ls = ms + p.gp;                               // (gp,) running sum
  float* as = ls + p.gp;                               // (gp,) rescale
  const int stage_elems = 2 * KT * p.pitch;

  const size_t row_stride = (size_t)kv_heads * d;
  const T* kb = k + ((size_t)bi * keys + lo) * row_stride + (size_t)kh * d;
  const T* vb = v + ((size_t)bi * keys + lo) * row_stride + (size_t)kh * d;
  const int n_tiles = (hi - lo + KT - 1) / KT;
  auto load = [&](int it) {
    fetch<T, VECTOR>(ring + (it % ST) * stage_elems, kb + it * KT * row_stride,
                     vb + it * KT * row_stride, row_stride,
                     min(KT, hi - lo - it * KT), d, p);
  };
#pragma unroll
  for (int it = 0; it < ST - 1; ++it) {
    if (it < n_tiles) load(it);
    mma::cp_async_commit();
  }

  const T* qb = q + ((size_t)bi * heads + (size_t)kh * g) * d;
  for (int i = tid; i < g * p.dp; i += kThreads) {
    const int c = i % p.dp;
    qs[i] = c < d ? to_f(qb[(i / p.dp) * d + c]) : 0.f;
  }
  for (int i = tid; i < KT * p.gp; i += kThreads) ps[i] = 0.f;
  for (int i = tid; i < p.gp; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
    as[i] = 0.f;
  }

  // this thread's accumulators: columns c0, c0 + 1 of heads h0 .. h0 + HPT
  const int unit = tid % p.units, group = tid / p.units;
  const bool owner = group < p.groups;
  const int c0 = 2 * (unit % p.cp), h0 = (unit / p.cp) * HPT;
  float o[HPT][2];
#pragma unroll
  for (int i = 0; i < HPT; ++i) o[i][0] = o[i][1] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    mma::cp_async_wait<ST - 2>();         // tile it has arrived
    __syncthreads();                      // and tile it - 1 is consumed
    if (it + ST - 1 < n_tiles) load(it + ST - 1);
    mma::cp_async_commit();
    const T* kt = ring + (it % ST) * stage_elems;
    const T* vt = kt + KT * p.pitch;
    const int nk = min(KT, hi - lo - it * KT);

    // scores and the online softmax: warp -> heads, lane -> keys lane
    // and lane + 32 (bf16), the q chunk read once for both
    for (int gi = warp; gi < g; gi += kWarps) {
      const float* qr = qs + gi * p.dp;
      const T* kr = kt + lane * p.pitch;
      float dot[KPL][2];
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) dot[kk][0] = dot[kk][1] = 0.f;
#pragma unroll 2
      for (int c = 0; c < p.dp; c += 8) {
        const float4 qa = *reinterpret_cast<const float4*>(qr + c);
        const float4 qc = *reinterpret_cast<const float4*>(qr + c + 4);
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) {
          float kf[8];
          row8(kr + kk * 32 * p.pitch + c, kf);
          dot[kk][0] = fmaf(qa.x, kf[0], dot[kk][0]);
          dot[kk][1] = fmaf(qa.y, kf[1], dot[kk][1]);
          dot[kk][0] = fmaf(qa.z, kf[2], dot[kk][0]);
          dot[kk][1] = fmaf(qa.w, kf[3], dot[kk][1]);
          dot[kk][0] = fmaf(qc.x, kf[4], dot[kk][0]);
          dot[kk][1] = fmaf(qc.y, kf[5], dot[kk][1]);
          dot[kk][0] = fmaf(qc.z, kf[6], dot[kk][0]);
          dot[kk][1] = fmaf(qc.w, kf[7], dot[kk][1]);
        }
      }
      float sc[KPL], mx = kNegInf;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        sc[kk] = lane + kk * 32 < nk ? (dot[kk][0] + dot[kk][1]) * scale
                                     : kNegInf;
        mx = fmaxf(mx, sc[kk]);
      }
      const float m_prev = ms[gi];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const float pw = expf(sc[kk] - m_new);
        ps[(lane + kk * 32) * p.gp + gi] = pw;
        psum += pw;
      }
      const float sum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        as[gi] = alpha;
        ls[gi] = ls[gi] * alpha + sum;
        ms[gi] = m_new;
      }
    }
    __syncthreads();

    // o = o * alpha + p V over this group's keys of the tile
    if (owner) {
#pragma unroll
      for (int i = 0; i < HPT; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(as + h0 + i);
        o[i][0] *= a.x; o[i][1] *= a.x;
        o[i + 1][0] *= a.y; o[i + 1][1] *= a.y;
        o[i + 2][0] *= a.z; o[i + 2][1] *= a.z;
        o[i + 3][0] *= a.w; o[i + 3][1] *= a.w;
      }
#pragma unroll 2
      for (int j = group; j < nk; j += p.groups) {
        const float2 vv = pair(vt + j * p.pitch + c0);
        const float* pr = ps + j * p.gp + h0;
#pragma unroll
        for (int i = 0; i < HPT; i += 4) {
          const float4 w = *reinterpret_cast<const float4*>(pr + i);
          o[i][0] = fmaf(w.x, vv.x, o[i][0]);
          o[i][1] = fmaf(w.x, vv.y, o[i][1]);
          o[i + 1][0] = fmaf(w.y, vv.x, o[i + 1][0]);
          o[i + 1][1] = fmaf(w.y, vv.y, o[i + 1][1]);
          o[i + 2][0] = fmaf(w.z, vv.x, o[i + 2][0]);
          o[i + 2][1] = fmaf(w.z, vv.y, o[i + 2][1]);
          o[i + 3][0] = fmaf(w.w, vv.x, o[i + 3][0]);
          o[i + 3][1] = fmaf(w.w, vv.y, o[i + 3][1]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();                        // the ring is free: scratch

  // sum the key groups in order and write the partials
  float* red = reinterpret_cast<float*>(smem_raw);   // (groups, units, HPT, 2)
  if (owner)
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      red[(tid * HPT + i) * 2] = o[i][0];
      red[(tid * HPT + i) * 2 + 1] = o[i][1];
    }
  __syncthreads();
  float* accb = acc + part * g * d;
  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d, c = i % d;
    const int u = (gi / HPT) * p.cp + c / 2;
    const int r = (gi % HPT) * 2 + (c & 1);
    float sum = 0.f;
    for (int gr = 0; gr < p.groups; ++gr)
      sum += red[((gr * p.units + u) * HPT) * 2 + r];
    accb[i] = sum;
  }
  for (int i = tid; i < g; i += kThreads) {
    mb[i] = ms[i];
    lb[i] = ls[i];
  }
}

// One block per (b, h): o[b, h, c] = sum_s acc_s[c] exp(m_s - m_max) /
// max(sum_s l_s exp(m_s - m_max), 1e-30).  Each split's weight is taken
// once; warp w adds splits w, w + 8, ... (lane -> columns lane + 32 i, so
// a split's row is one coalesced read), and the warps' sums are added in
// a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
               T* __restrict__ o, int batch, int heads, int kv_heads, int d,
               int ns) {
  __shared__ float wsm[kThreads];               // weights of kThreads splits
  __shared__ float red[kWarps][kMaxCols * 32];  // the warps' column sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.x / heads, h = blockIdx.x % heads;
  const int g = heads / kv_heads, kh = h / g, gi = h % g;
  const size_t base = ((size_t)bi * kv_heads + kh) * ns;
  const float* m = ml + base * g + gi;                 // split s at s * g
  const float* l = m + (size_t)batch * kv_heads * ns * g;
  const float* ab = acc + (base * g + gi) * d;         // split s at s g d
  float mx = kNegInf;
  for (int s = tid; s < ns; s += kThreads) mx = fmaxf(mx, m[(size_t)s * g]);
  mx = warp_max(mx);
  if (lane == 0) wsm[warp] = mx;
  __syncthreads();
  float m_max = wsm[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m_max = fmaxf(m_max, wsm[w]);
  __syncthreads();

  float lt = 0.f, a[kMaxCols];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) a[i] = 0.f;
  for (int s0 = 0; s0 < ns; s0 += kThreads) {
    const int s = s0 + tid;
    const float w = s < ns ? expf(m[(size_t)s * g] - m_max) : 0.f;
    if (s < ns) lt = fmaf(l[(size_t)s * g], w, lt);
    wsm[tid] = w;
    __syncthreads();
    const int s1 = min(ns, s0 + kThreads);
#pragma unroll 4
    for (int t = s0 + warp; t < s1; t += kWarps) {
      const float ws = wsm[t - s0];
      const float* row = ab + (size_t)t * g * d;
#pragma unroll
      for (int i = 0; i < kMaxCols; ++i)
        if (lane + 32 * i < d) a[i] = fmaf(row[lane + 32 * i], ws, a[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) red[warp][lane + 32 * i] = a[i];
  lt = warp_sum(lt);
  if (lane == 0) wsm[warp] = lt;
  __syncthreads();
  float l_tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l_tot += wsm[w];
  for (int c = tid; c < d; c += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][c];
    o[((size_t)bi * heads + h) * d + c] =
        from_f<T>(sum / fmaxf(l_tot, 1e-30f));
  }
}

template <typename T, int HPT, bool VECTOR>
int launch_split(const void* q, const void* k, const void* v,
                 const int* len_ptr, int len_val, float* acc, float* ml,
                 int batch, int heads, int kv_heads, int keys, int d, int ns,
                 int per_split, float scale, cudaStream_t st) {
  const Plan<T> p(heads / kv_heads, d, HPT);
  if (p.groups < 1 || per_split % Plan<T>::KT) return cudaErrorInvalidValue;
  auto* kernel = split_kernel<T, HPT, VECTOR>;
  if (p.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(kv_heads, ns, batch);
  kernel<<<grid, kThreads, p.bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len_ptr, len_val, acc, ml, batch, heads,
      kv_heads, keys, d, ns, per_split, scale);
  return static_cast<int>(cudaGetLastError());
}

// Heads per thread: the fewest of 4, 8, 16 that cover g in one chunk, or
// 16 (more chunks) beyond.
int heads_per_thread(int g) { return g <= 4 ? 4 : g <= 8 ? 8 : 16; }

template <typename T, bool VECTOR>
int launch_hpt(const void* q, const void* k, const void* v, const int* lp,
               int len_val, float* acc, float* ml, int batch, int heads,
               int kv_heads, int keys, int d, int ns, int per_split,
               float scale, cudaStream_t st) {
  const int hpt = heads_per_thread(heads / kv_heads);
#define K6_SPLIT(HPT)                                                        \
  launch_split<T, HPT, VECTOR>(q, k, v, lp, len_val, acc, ml, batch, heads, \
                               kv_heads, keys, d, ns, per_split, scale, st)
  if (hpt == 4) return K6_SPLIT(4);
  if (hpt == 8) return K6_SPLIT(8);
  return K6_SPLIT(16);
#undef K6_SPLIT
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
      vector ? launch_hpt<T, true>(q, k, v, lp, len_val, accf, mlf, batch,
                                   heads, kv_heads, keys, d, ns, per_split,
                                   scale, st)
             : launch_hpt<T, false>(q, k, v, lp, len_val, accf, mlf, batch,
                                    heads, kv_heads, keys, d, ns, per_split,
                                    scale, st);
  if (err) return err;
  combine_kernel<T><<<batch * heads, kThreads, 0, st>>>(
      accf, mlf, static_cast<T*>(o), batch, heads, kv_heads, d, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (batch, heads, d); k, v: (batch, keys, kv_heads, d), row-major, of the
// named type.  length: `len_ptr`, one int32 on the device, or `len_val` when
// `len_ptr` is null.  acc: (batch, kv_heads, ns, heads / kv_heads, d) fp32
// and ml: (2, batch, kv_heads, ns, heads / kv_heads) fp32 scratch; o: q's
// shape and type.  Split s covers keys [s per_split, (s + 1) per_split);
// per_split is a multiple of the tile (64 keys in bf16, 32 in fp32).
// `vector`: d is a multiple of 16 bytes and k, v are 16-byte aligned.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* len_ptr,
                                     int len_val, void* acc, void* ml,
                                     void* o, int batch, int heads,
                                     int kv_heads, int keys, int d, int ns,
                                     int per_split, float scale, int vector,
                                     void* stream) {
  return launch<bf16>(q, k, v, len_ptr, len_val, acc, ml, o, batch, heads,
                      kv_heads, keys, d, ns, per_split, scale, vector,
                      stream);
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

// Dynamic shared memory of one split-pass CTA at these shapes (bytes).
extern "C" long long decode_attention_smem(int heads, int kv_heads, int d,
                                           int bf16_inputs) {
  const int g = heads / kv_heads, hpt = heads_per_thread(g);
  return static_cast<long long>(bf16_inputs ? Plan<bf16>(g, d, hpt).bytes
                                            : Plan<float>(g, d, hpt).bytes);
}
