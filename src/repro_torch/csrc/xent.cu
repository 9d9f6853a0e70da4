// K10: fused softmax cross-entropy over vocab tiles, the port of
// src/repro/kernels/xent.py::blocked_xent (Pallas body `_xent_kernel`).
//
// For each token t, with logits[t, v] = sum_k x[t, k] * emb[v, k] in fp32
// from the inputs' values (bf16 or fp32), never stored:
//   nll[t]  = max_v logits + log(sum_v exp(logits - max)) - logits[t, label]
//   amax[t] = the first v of the row maximum (the `acc` of
//             models/loss.py::blocked_cross_entropy);
//   lse[t]  = max_v logits + log(sum_v exp(logits - max)), which the
//             backward (K12a, csrc/xent_bwd.cu) reads instead of
//             recomputing the row statistics.
// A label outside [0, V) leaves the label logit at -inf, so nll = +inf, as
// in the reference's scan.
//
// What bounds it: operations.  2 T V d of them against (T + V) d input
// elements: at T = 8192, V = 32000, d = 2048 in bf16 that is 1.07 TFLOP
// and 0.16 GB, 1.09 ms at the 989 TFLOP/s of the bf16 tensor cores of an
// NVIDIA H100 SXM (data sheet, 700 W).
//
// Grid.  The Pallas grid (token tiles "parallel", vocab tiles
// "arbitrary", running max / sum-exp / label logit in VMEM scratch)
// becomes a grid of (token tiles, vocab chunks of `chunk` columns): the
// token tiles alone would leave SMs of the 132 idle, so the vocabulary is
// split across blocks as flash decoding splits keys.  A block walks its
// chunk in tiles of 128 columns and folds each tile into running (max,
// sum-exp, label logit, argmax) statistics.  With one chunk the block
// writes the result; else it writes its partials, and the last block of
// the token tile to finish (a counter per token tile, after a fence)
// merges the chunks and writes nll and the argmax: one launch per call.
// Every argmax merge keeps the larger value and, on a tie, the lower
// index, so the result is the first index of the row maximum, as
// jnp.argmax within a block and strict `>` across blocks give it in the
// reference.
//
// bf16 (xent_kernel_mma): token tiles of 128 rows walking their chunk in
// column tiles of 256; 8 warps, each owning a 64 x 64 sub-tile of the
// 128 x 256 logit tile as `mma.sync` accumulator fragments (bf16 in, fp32
// sums).  The tile is as wide as registers allow because each column tile
// reads the x tile again from L2: (128 + 256) x d bf16 per 2 x 128 x 256
// x d operations.  The d loop steps through a 3-stage `cp.async` ring of
// 64-deep x and head tiles, copied as bf16, the ring running on across
// column tiles so the next copies are always in flight.  The (d, V) head
// read in place is a K-major B operand (`ldmatrix.trans`), a tied (V, d)
// table a plain one.  Each column tile's epilogue works on the fragments
// in registers; at the end of the chunk the 4 lanes of a quad merge by
// shuffles and the 4 warps that share rows through shared memory.
// Unaligned or odd widths stage by element loads in the same kernel (VEC
// false).
//
// fp32 (xent_kernel): fp32 FMAs on the CUDA cores (67 TFLOP/s peak; a
// tensor-core product would be TF32), token tiles of 64.  Each tile is a
// 64 x 128 product over d in steps of 32 through shared memory, each
// thread holding 4 x 8 logits in registers; at the end of the chunk the 16
// threads of a row merge their statistics by shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BT = 64;        // fp32: tokens per block
constexpr int BV = 128;       // vocab columns per tile
constexpr int BK = 32;        // d per shared-memory step
constexpr int THREADS = 256;  // fp32: 16 x 16, 4 rows x 8 columns each
constexpr int TM = 4;
constexpr int TN = 8;
constexpr int MT = 128;       // bf16: tokens per block
constexpr int MV = 256;       // bf16: vocab columns per tile
constexpr int MK = 64;        // bf16: d per ring stage
constexpr int STAGES = 3;     // bf16: depth of the cp.async ring
constexpr int NO_INDEX = 0x7fffffff;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }

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

// Called by every thread of a block of the token tile at t0 once its
// partials are written: the last block of the tile to finish (an atomic
// ticket on `counter`, after a fence) merges the chunks' partials of its
// ROWS tokens and writes nll and the argmax.
template <int ROWS>
__device__ __forceinline__ void merge_chunks(float* __restrict__ nll,
                                             int* __restrict__ amax,
                                             float* __restrict__ lse,
                                             const float* part,
                                             int* __restrict__ counter,
                                             int n_tok, int t0, int n_chunks,
                                             int tid) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(&counter[blockIdx.x], 1) == n_chunks - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t plane = (size_t)n_chunks * n_tok;
  const int t = t0 + tid;
  if (tid < ROWS && t < n_tok) {
    float M = -INFINITY, S = 0.f, LL = -INFINITY, AV = -INFINITY;
    int AI = NO_INDEX;
    for (int c = 0; c < n_chunks; ++c) {
      const size_t o = (size_t)c * n_tok + t;
      merge_ms(M, S, __ldcg(part + o), __ldcg(part + plane + o));
      LL = fmaxf(LL, __ldcg(part + 2 * plane + o));
      merge_arg(AV, AI, __ldcg(part + 3 * plane + o),
                __float_as_int(__ldcg(part + 4 * plane + o)));
    }
    const float L = M + logf(S);
    nll[t] = L - LL;
    amax[t] = AI;
    lse[t] = L;
  }
}

// Writes one token's result (one chunk) or its chunk's partials.
__device__ __forceinline__ void write_row(float* __restrict__ nll,
                                          int* __restrict__ amax,
                                          float* __restrict__ lse,
                                          float* __restrict__ part, int t,
                                          int n_tok, int n_chunks, float m,
                                          float s, float ll, float av,
                                          int ai) {
  if (n_chunks == 1) {
    const float l = m + logf(s);
    nll[t] = l - ll;
    amax[t] = ai;
    lse[t] = l;
  } else {
    const size_t plane = (size_t)n_chunks * n_tok;
    const size_t o = (size_t)blockIdx.y * n_tok + t;
    part[o] = m;
    part[plane + o] = s;
    part[2 * plane + o] = ll;
    part[3 * plane + o] = av;
    part[4 * plane + o] = __int_as_float(ai);
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
            int* __restrict__ amax, float* __restrict__ lse,
            float* __restrict__ part, int* __restrict__ counter, int n_tok,
            int V, int d, int chunk) {
  __shared__ __align__(16) float xs[BK][BT];
  __shared__ __align__(16) float es[BK][BV];
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

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int t = t0 + ty * TM + i;
      if (t < n_tok)
        write_row(nll, amax, lse, part, t, n_tok, n_chunks, m[i], s[i],
                  ll[i], av[i], ai[i]);
    }
  }
  if (n_chunks > 1)
    merge_chunks<BT>(nll, amax, lse, part, counter, n_tok, t0, n_chunks,
                     tid);
}

using bf16 = __nv_bfloat16;

template <bool EMB_DV>
constexpr int mma_smem_bytes() {
  // per stage: the x tile (MT x MK) and the head tile, (d, V) as MK x MV
  // or (V, d) as MV x MK; pitches padded by mma::PAD
  return STAGES * (MT * (MK + mma::PAD) +
                   (EMB_DV ? MK * (MV + mma::PAD) : MV * (MK + mma::PAD))) *
         (int)sizeof(bf16);
}

// (m, s, ll, ai) <- the merge of two rows' statistics; the argmax value
// is the running max m itself.
__device__ __forceinline__ void merge_stats(float& m, float& s, float& ll,
                                            int& ai, float m2, float s2,
                                            float ll2, int ai2) {
  if (m2 > m || (m2 == m && ai2 < ai)) ai = ai2;
  merge_ms(m, s, m2, s2);
  ll = fmaxf(ll, ll2);
}

// Grid (ceil(T / MT), ceil(V / chunk)); the rest as for xent_kernel.
// Warp w owns rows (w / 4) * 64.. and columns (w % 4) * 64.. of each
// 128 x 256 logit tile: 4 x 8 m16n8 fragments.  Lane (g, t4) holds, per
// fragment, rows g and g + 8 at columns 2 t4 and 2 t4 + 1.
template <bool VEC, bool EMB_DV>
__global__ void __launch_bounds__(THREADS, 1)
xent_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ emb,
                const int* __restrict__ labels, float* __restrict__ nll,
                int* __restrict__ amax, float* __restrict__ lse,
                float* __restrict__ part, int* __restrict__ counter,
                int n_tok, int V, int d, int chunk) {
  constexpr int XLD = MK + mma::PAD;                 // x tile pitch
  constexpr int ELD = EMB_DV ? MV + mma::PAD : MK + mma::PAD;
  constexpr int XS = MT * XLD;                       // x stage, elements
  constexpr int ES = EMB_DV ? MK * ELD : MV * ELD;   // head stage
  constexpr int WN = MV / 64;                        // warps along columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);      // [STAGES][MT][XLD]
  bf16* se = sx + STAGES * XS;                       // [STAGES][..][ELD]
  __shared__ int s_lab[MT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int t0 = blockIdx.x * MT;
  const int n_chunks = gridDim.y;
  const int v_begin = blockIdx.y * chunk;
  const int v_end = min(V, v_begin + chunk);
  const int ksteps = (d + MK - 1) / MK;
  const int total = (v_end - v_begin + MV - 1) / MV * ksteps;
  for (int r = tid; r < MT; r += THREADS)
    s_lab[r] = t0 + r < n_tok ? labels[t0 + r] : -1;

  // this lane's 8 rows: fragment mt, half hh -> i = 2 mt + hh, row(i)
  auto row = [&](int i) { return wm * 64 + (i >> 1) * 16 + (i & 1) * 8 + g; };
  float m[8], s[8], ll[8];
  int ai[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
    ll[i] = -INFINITY;
    ai[i] = NO_INDEX;
  }

  // stage `it` of the ring: column tile it / ksteps, d step it % ksteps
  auto load_stage = [&](int it) {
    const int vt = it / ksteps, k0 = (it - vt * ksteps) * MK;
    const int v0 = v_begin + vt * MV;
    bf16* dx = sx + (it % STAGES) * XS;
    bf16* de = se + (it % STAGES) * ES;
    mma::load_tile<MT, MK, THREADS, VEC>(dx, x, t0, k0, n_tok, d, d, tid);
    if constexpr (EMB_DV)
      mma::load_tile<MK, MV, THREADS, VEC>(de, emb, k0, v0, d, v_end, V, tid);
    else
      mma::load_tile<MV, MK, THREADS, VEC>(de, emb, v0, k0, v_end, d, d, tid);
  };

  float acc[4][8][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < total) load_stage(it);
    mma::cp_async_commit();
  }
  int ks = 0, v0 = v_begin;
  for (int it = 0; it < total; ++it) {
    mma::cp_async_wait<STAGES - 2>();        // stage it has arrived
    __syncthreads();                         // and stage it - 1 is free
    if (it + STAGES - 1 < total) load_stage(it + STAGES - 1);
    mma::cp_async_commit();
    const bf16* cx = sx + (it % STAGES) * XS;
    const bf16* ce = se + (it % STAGES) * ES;
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t bf[4][4];                     // 8 n8 tiles: 64 columns
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n0 = wn * 64 + np * 16;
        if constexpr (EMB_DV)
          mma::ldmatrix_x4_trans(bf[np], ce + mma::b_offset_kn(lane, n0,
                                                               kk * 16, ELD));
        else
          mma::ldmatrix_x4(bf[np], ce + mma::b_offset_nk(lane, n0, kk * 16,
                                                         ELD));
      }
      uint32_t af[4][4];                     // 4 m16 tiles: 64 rows
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        mma::ldmatrix_x4(af[mt], cx + mma::a_offset(lane, wm * 64 + mt * 16,
                                                    kk * 16, XLD));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma::mma_bf16(acc[mt][2 * np], af[mt], bf[np][0], bf[np][1]);
          mma::mma_bf16(acc[mt][2 * np + 1], af[mt], bf[np][2], bf[np][3]);
        }
    }
    if (++ks < ksteps) continue;

    // the column tile at v0 is complete: fold it into the running
    // statistics of this lane's rows.  Its 16 columns of a row are
    // c0 + 8 nt + e (e = 0, 1), increasing with (nt, e).
    const int c0 = v0 + wn * 64 + 2 * t4;
    const bool full = v0 + MV <= v_end;      // no column past the chunk
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int mt = i >> 1, hh = i & 1;
      float tmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (full || c0 + nt * 8 + e < v_end)
            tmax = fmaxf(tmax, acc[mt][nt][2 * hh + e]);
      if (tmax == -INFINITY) continue;       // no column of this lane
      const int rel = s_lab[row(i)] - c0;    // the label's column, if ours
      if (rel >= 0 && rel < 64 && (rel & 7) < 2 && c0 + rel < v_end) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (nt * 8 + e == rel) ll[i] = acc[mt][nt][2 * hh + e];
      }
      if (tmax > m[i]) {                     // a new running max: the
        int first = NO_INDEX;                // first column that holds it
#pragma unroll
        for (int nt = 7; nt >= 0; --nt)
#pragma unroll
          for (int e = 1; e >= 0; --e)
            if (acc[mt][nt][2 * hh + e] == tmax &&
                (full || c0 + nt * 8 + e < v_end))
              first = c0 + nt * 8 + e;
        ai[i] = first;
        s[i] *= exp2f((m[i] - tmax) * LOG2E);
        m[i] = tmax;
      }
      const float mb = m[i] * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (full || c0 + nt * 8 + e < v_end)
            sum += exp2f(fmaf(acc[mt][nt][2 * hh + e], LOG2E, -mb));
      s[i] += sum;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
    ks = 0;
    v0 += MV;
  }

  // merge the 4 lanes of a quad (they hold one row's columns), then the
  // WN warps that share rows, in column order, through the idle ring
  mma::cp_async_wait<0>();
  __syncthreads();
  float(*red_m)[MT] = reinterpret_cast<float(*)[MT]>(smem_raw);
  float(*red_s)[MT] = red_m + WN;
  float(*red_ll)[MT] = red_s + WN;
  int(*red_ai)[MT] = reinterpret_cast<int(*)[MT]>(red_ll + WN);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      merge_stats(m[i], s[i], ll[i], ai[i],
                  __shfl_xor_sync(0xffffffffu, m[i], o),
                  __shfl_xor_sync(0xffffffffu, s[i], o),
                  __shfl_xor_sync(0xffffffffu, ll[i], o),
                  __shfl_xor_sync(0xffffffffu, ai[i], o));
    if (t4 == 0) {
      red_m[wn][row(i)] = m[i];
      red_s[wn][row(i)] = s[i];
      red_ll[wn][row(i)] = ll[i];
      red_ai[wn][row(i)] = ai[i];
    }
  }
  __syncthreads();
  if (tid < MT && t0 + tid < n_tok) {
    float M = red_m[0][tid], S = red_s[0][tid], LL = red_ll[0][tid];
    int AI = red_ai[0][tid];
#pragma unroll
    for (int w = 1; w < WN; ++w)
      merge_stats(M, S, LL, AI, red_m[w][tid], red_s[w][tid],
                  red_ll[w][tid], red_ai[w][tid]);
    write_row(nll, amax, lse, part, t0 + tid, n_tok, n_chunks, M, S, LL, M,
              AI);
  }
  if (n_chunks > 1)
    merge_chunks<MT>(nll, amax, lse, part, counter, n_tok, t0, n_chunks,
                     tid);
}

template <bool VEC, bool EMB_DV>
int launch_mma(const void* x, const void* emb, const void* labels, void* nll,
               void* amax, void* lse, void* part, void* counter, int n_tok,
               int V, int d, int chunk, cudaStream_t st) {
  constexpr int bytes = mma_smem_bytes<EMB_DV>();
  cudaError_t err = cudaFuncSetAttribute(
      xent_kernel_mma<VEC, EMB_DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_tok + MT - 1) / MT, (V + chunk - 1) / chunk);
  xent_kernel_mma<VEC, EMB_DV><<<grid, THREADS, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(emb),
      static_cast<const int*>(labels), static_cast<float*>(nll),
      static_cast<int*>(amax), static_cast<float*>(lse),
      static_cast<float*>(part), static_cast<int*>(counter), n_tok, V, d,
      chunk);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const void* emb, const void* labels,
                void* nll, void* amax, void* lse, void* part, void* counter,
                int n_tok, int V, int d, int chunk, int emb_dv, int vector,
                cudaStream_t st) {
#define XENT_MMA(VEC, DV)                                                   \
  launch_mma<VEC, DV>(x, emb, labels, nll, amax, lse, part, counter, n_tok, \
                      V, d, chunk, st)
  if (vector && emb_dv) return XENT_MMA(true, true);
  if (vector) return XENT_MMA(true, false);
  if (emb_dv) return XENT_MMA(false, true);
  return XENT_MMA(false, false);
#undef XENT_MMA
}

int launch_f32(const void* x, const void* emb, const void* labels, void* nll,
               void* amax, void* lse, void* part, void* counter, int n_tok,
               int V, int d, int chunk, int emb_dv, int vector,
               cudaStream_t st) {
  const dim3 grid((n_tok + BT - 1) / BT, (V + chunk - 1) / chunk);
  const dim3 block(THREADS);
#define XENT_LAUNCH(VEC, DV)                                                \
  xent_kernel<float, VEC, DV><<<grid, block, 0, st>>>(                      \
      static_cast<const float*>(x), static_cast<const float*>(emb),         \
      static_cast<const int*>(labels), static_cast<float*>(nll),            \
      static_cast<int*>(amax), static_cast<float*>(lse),                    \
      static_cast<float*>(part), static_cast<int*>(counter), n_tok, V, d,   \
      chunk)
  if (vector && emb_dv) XENT_LAUNCH(true, true);
  else if (vector) XENT_LAUNCH(true, false);
  else if (emb_dv) XENT_LAUNCH(false, true);
  else XENT_LAUNCH(false, false);
#undef XENT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n_tok, d) row-major; emb: (V, d), or (d, V) when emb_dv; labels:
// (n_tok,) int32; nll: (n_tok,) fp32; amax: (n_tok,) int32; lse: (n_tok,)
// fp32.  part and counter as for xent_kernel, one counter per token tile
// (128 tokens in bf16, 64 in fp32; unused with one chunk).  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int blocked_xent_bf16(const void* x, const void* emb,
                                 const void* labels, void* nll, void* amax,
                                 void* lse, void* part, void* counter,
                                 int n_tok, int V, int d, int chunk,
                                 int emb_dv, int vector, void* stream) {
  return launch_bf16(x, emb, labels, nll, amax, lse, part, counter, n_tok, V,
                     d, chunk, emb_dv, vector,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int blocked_xent_f32(const void* x, const void* emb,
                                const void* labels, void* nll, void* amax,
                                void* lse, void* part, void* counter,
                                int n_tok, int V, int d, int chunk,
                                int emb_dv, int vector, void* stream) {
  return launch_f32(x, emb, labels, nll, amax, lse, part, counter, n_tok, V,
                    d, chunk, emb_dv, vector,
                    static_cast<cudaStream_t>(stream));
}
