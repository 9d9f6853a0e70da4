// K12a: the backward of the blocked cross-entropy, one vocab chunk a
// launch.  It replaces the XLA code that differentiates the reference's
// src/repro/models/loss.py::blocked_cross_entropy: the VJP of the
// `jax.checkpoint`-ed scan over vocab blocks, which recomputes each
// block's logits and takes softmax minus one-hot through two einsums.
//
// For the chunk's columns v in [v_begin, v_begin + width) and every token
// t, with s[t, v] = sum_k x[t, k] * emb[v, k] in fp32 from the inputs'
// values (recomputed, never read), lse[t] the forward's row statistic
// (K10's third output) and g[t] the gradient of nll[t]:
//   dl[t, v - v_begin] = g[t] * (exp(s[t, v] - lse[t]) - [v == label[t]])
// written into the (n_tok, ld) buffer `dl`: fp32 on the fp32 path; on the
// bf16 path as two bf16 terms, hi = bf16(dl) into `dl` and lo =
// bf16(dl - hi) into `dl_lo`, so that products on the bf16 tensor cores
// see dl to ~2^-17 (dl alone in bf16 misses the one-rounding-step bar on
// dx where a row's softmax and one-hot terms cancel).  Columns from
// `width` to `ld` (past the vocabulary) are written as zeros.  The
// chunk's products, dx += dl E_chunk and dE_chunk = dl^T x (each over
// hi and lo in bf16, summed in fp32), are plain large matrix products
// left to cuBLAS by the wrapper (kernels/xent.py::blocked_xent_bwd), as
// the reference leaves its two einsums to XLA.
//
// What bounds it: operations.  The recomputed logits take 2 T V d of them
// over a call's chunks against (T + V) d input elements and a T x V dl
// written: at T = 8192, V = 32000, d = 2048 in bf16 1.07 TFLOP, 1.086 ms
// at the 989 TFLOP/s of the bf16 tensor cores of an NVIDIA H100 SXM (data
// sheet, 700 W), against 1.05 GB of dl (hi + lo), 0.31 ms at 3.35 TB/s.
//
// No state crosses a tile of logits, so every design below gives each
// 128 x 256 (bf16) or 64 x 128 (fp32) tile to one block, with no atomics:
// two launches give the same bits.  Three routes (the wrapper's
// `bwd_route`):
//
// "sm90", bf16 where TMA can describe the tensors (d, and V for the (d, V)
// head, multiples of 8; x, emb and dl on 16 bytes): xent_bwd_sm90
// (namespace sm90 below, on csrc/wgmma.cuh).  Three warpgroups, 384
// threads.  A producer warp issues TMA loads (128-byte swizzle) into a
// 3-stage `mbarrier` ring of 48 KB stages: x's rows as two K-major {64 d,
// 64 tokens} boxes (the A operand, one a consumer warpgroup) and the
// head's 256 columns, read in place: the (d, V) head as four MN-major {64
// v, 64 d} boxes side by side (wgmma's transpose flag 1), a tied (V, d)
// table as one K-major {64 d, 256 v} box.  Two consumer warpgroups
// (setmaxnreg 232, the producer 40) each multiply their 64 token rows by
// the shared 256 columns, four wgmma m64n256k16 a stage into 128 fp32 sums
// a thread, and release the stage on its `empty` mbarrier.  At a tile's
// last stage each consumer forms dl from its sums in registers (lse, g and
// the label of its thread's two rows), stages hi in a 32 KB swizzled tile
// and hands it to TMA stores, keeping lo packed in the sums' registers,
// then stages lo in the same tile once the hi stores have read it (hi + lo
// staging for both warpgroups, 128 KB, does not fit beside the ring); the
// next tile's products start while the lo stores run.  TMA zero-fills loads
// past d, T and V and leaves out stores past T and ld, so ragged shapes
// need no mask; the epilogue zeroes columns from v_end on.  One persistent
// block an SM walks the chunk's tiles on a static stride (tile i to block
// i mod grid), the token tiles of a column tile together, so a wave of
// blocks shares the head's 1 MB column tiles in L2 while x (32 MB at T
// 8,192) streams.  Tiles wholly past the vocabulary store zeros and load
// nothing.
//
// "mma", every other bf16 input (the first design,
// xent_bwd_kernel_mma): K10's tile on `mma.sync` m16n8k16, 8 warps each
// owning a 64 x 64 sub-tile (bf16 in, fp32 sums), the d loop through a
// 3-stage `cp.async` ring of 64-deep x and head tiles (`csrc/mma.cuh`);
// the (d, V) head read in place is a K-major B operand
// (`ldmatrix.trans`), a tied (V, d) table a plain one.  dl is formed from
// the fragments in registers and stored as hi and lo bf16 pairs.  A grid
// of (token tiles, column tiles of the chunk).
//
// "fma", fp32 (xent_bwd_kernel): K10's fp32 FMA tile, 64 tokens x 128
// columns through shared memory, each thread 4 x 8 logits in registers,
// dl stored as float4.
//
// Both products reading dl back, fused into this kernel, would need d =
// 2,048 fp32 accumulators a row of dx on chip: that design is later work
// (ROADMAP.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BT = 64;        // fp32: tokens per block
constexpr int BV = 128;       // fp32: vocab columns per block
constexpr int BK = 32;        // fp32: d per shared-memory step
constexpr int THREADS = 256;  // fp32: 16 x 16, 4 rows x 8 columns each
constexpr int TM = 4;
constexpr int TN = 8;
constexpr int MT = 128;       // bf16: tokens per block
constexpr int MV = 256;       // bf16: vocab columns per block
constexpr int MK = 64;        // bf16: d per ring stage
constexpr int STAGES = 3;     // bf16: depth of the cp.async ring

// dl of one logit: g (exp(s - lse) - [col == label]); zero past the
// vocabulary.
__device__ __forceinline__ float dlogit(float s, float lse, float g,
                                        int col, int label, int v_end) {
  if (col >= v_end) return 0.f;
  return g * (expf(s - lse) - (col == label ? 1.f : 0.f));
}

// Rows [r0, r0 + R) x columns [k0, k0 + BK) of a row-major (rows, d)
// fp32 matrix into dst[k][r], zeros outside (xent.cu's load_k_major).
template <int R, bool VEC>
__device__ __forceinline__ void load_k_major(const float* __restrict__ src,
                                             float (*dst)[R], int r0,
                                             int k0, int rows, int d,
                                             int tid) {
  if (VEC) {
    constexpr int PER_ROW = BK / 4;
    for (int i = tid; i < R * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, kc = (i % PER_ROW) * 4;
      const int gr = r0 + r, gk = k0 + kc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < rows && gk < d)
        v = *reinterpret_cast<const float4*>(src + (size_t)gr * d + gk);
      dst[kc][r] = v.x;
      dst[kc + 1][r] = v.y;
      dst[kc + 2][r] = v.z;
      dst[kc + 3][r] = v.w;
    }
  } else {
    for (int i = tid; i < R * BK; i += THREADS) {
      const int r = i / BK, k = i % BK;
      const int gr = r0 + r, gk = k0 + k;
      dst[k][r] = (gr < rows && gk < d) ? src[(size_t)gr * d + gk] : 0.f;
    }
  }
}

// Rows [k0, k0 + BK) x columns [v0, v0 + BV) of the row-major (d, V) fp32
// head into dst[k][c], zeros outside (columns from v_end on; xent.cu's
// load_v_major).
template <bool VEC>
__device__ __forceinline__ void load_v_major(const float* __restrict__ src,
                                             float (*dst)[BV], int v0,
                                             int k0, int v_end, int V,
                                             int d, int tid) {
  if (VEC) {
    constexpr int PER_K = BV / 4;
    for (int i = tid; i < BK * PER_K; i += THREADS) {
      const int k = i / PER_K, c = (i % PER_K) * 4;
      const int gk = k0 + k, gc = v0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gk < d && gc < v_end)
        v = *reinterpret_cast<const float4*>(src + (size_t)gk * V + gc);
      *reinterpret_cast<float4*>(&dst[k][c]) = v;
    }
  } else {
    for (int i = tid; i < BK * BV; i += THREADS) {
      const int k = i / BV, c = i % BV;
      const int gk = k0 + k, gc = v0 + c;
      dst[k][c] = (gk < d && gc < v_end) ? src[(size_t)gk * V + gc] : 0.f;
    }
  }
}

// fp32.  Grid (ceil(T / BT), ld / BV); ld a multiple of BV.
template <bool VEC, bool EMB_DV>
__global__ void __launch_bounds__(THREADS)
xent_bwd_kernel(const float* __restrict__ x, const float* __restrict__ emb,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ g, float* __restrict__ dl,
                int n_tok, int V, int d, int v_begin, int width, int ld) {
  __shared__ __align__(16) float xs[BK][BT];
  __shared__ __align__(16) float es[BK][BV];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = blockIdx.x * BT;
  const int v_end = v_begin + width;
  const int v0 = v_begin + blockIdx.y * BV;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (v0 < v_end) {                // else the tile is past the vocabulary
    for (int k0 = 0; k0 < d; k0 += BK) {
      load_k_major<BT, VEC>(x, xs, t0, k0, n_tok, d, tid);
      if (EMB_DV)
        load_v_major<VEC>(emb, es, v0, k0, v_end, V, d, tid);
      else
        load_k_major<BV, VEC>(emb, es, v0, k0, v_end, d, tid);
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
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty * TM + i;
    if (t >= n_tok) continue;
    const float l = lse[t], gt = g[t];
    const int lab = labels[t];
    float* row = dl + (size_t)t * ld + (v0 - v_begin);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * 64 + tx * 4;
      float4 o;
      o.x = dlogit(acc[i][4 * h], l, gt, v0 + c, lab, v_end);
      o.y = dlogit(acc[i][4 * h + 1], l, gt, v0 + c + 1, lab, v_end);
      o.z = dlogit(acc[i][4 * h + 2], l, gt, v0 + c + 2, lab, v_end);
      o.w = dlogit(acc[i][4 * h + 3], l, gt, v0 + c + 3, lab, v_end);
      *reinterpret_cast<float4*>(row + c) = o;
    }
  }
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

// bf16.  Grid (ceil(T / MT), ceil(ld / MV)); ld a multiple of 128.  Warp w
// owns rows (w / 4) * 64.. and columns (w % 4) * 64.. of the 128 x 256
// tile: 4 x 8 m16n8 fragments.  Lane (g, t4) holds, per fragment, rows g
// and g + 8 at columns 2 t4 and 2 t4 + 1.
template <bool VEC, bool EMB_DV>
__global__ void __launch_bounds__(THREADS, 1)
xent_bwd_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ emb,
                    const int* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, bf16* __restrict__ dl,
                    bf16* __restrict__ dl_lo, int n_tok, int V, int d,
                    int v_begin, int width, int ld) {
  constexpr int XLD = MK + mma::PAD;                 // x tile pitch
  constexpr int ELD = EMB_DV ? MV + mma::PAD : MK + mma::PAD;
  constexpr int XS = MT * XLD;                       // x stage, elements
  constexpr int ES = EMB_DV ? MK * ELD : MV * ELD;   // head stage
  constexpr int WN = MV / 64;                        // warps along columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);      // [STAGES][MT][XLD]
  bf16* se = sx + STAGES * XS;                       // [STAGES][..][ELD]
  __shared__ int s_lab[MT];
  __shared__ float s_lse[MT], s_g[MT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int t0 = blockIdx.x * MT;
  const int v_end = v_begin + width;
  const int v0 = v_begin + blockIdx.y * MV;
  const int ksteps = (d + MK - 1) / MK;
  for (int r = tid; r < MT; r += THREADS) {
    const bool in = t0 + r < n_tok;
    s_lab[r] = in ? labels[t0 + r] : -1;
    s_lse[r] = in ? lse[t0 + r] : 0.f;
    s_g[r] = in ? g[t0 + r] : 0.f;
  }

  float acc[4][8][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  if (v0 < v_end) {                // else the tile is past the vocabulary
    auto load_stage = [&](int ks) {
      const int k0 = ks * MK;
      bf16* dx = sx + (ks % STAGES) * XS;
      bf16* de = se + (ks % STAGES) * ES;
      mma::load_tile<MT, MK, THREADS, VEC>(dx, x, t0, k0, n_tok, d, d, tid);
      if constexpr (EMB_DV)
        mma::load_tile<MK, MV, THREADS, VEC>(de, emb, k0, v0, d, v_end, V,
                                             tid);
      else
        mma::load_tile<MV, MK, THREADS, VEC>(de, emb, v0, k0, v_end, d, d,
                                             tid);
    };
#pragma unroll
    for (int ks = 0; ks < STAGES - 1; ++ks) {
      if (ks < ksteps) load_stage(ks);
      mma::cp_async_commit();
    }
    for (int ks = 0; ks < ksteps; ++ks) {
      mma::cp_async_wait<STAGES - 2>();      // stage ks has arrived
      __syncthreads();                       // and stage ks - 1 is free
      if (ks + STAGES - 1 < ksteps) load_stage(ks + STAGES - 1);
      mma::cp_async_commit();
      const bf16* cx = sx + (ks % STAGES) * XS;
      const bf16* ce = se + (ks % STAGES) * ES;
#pragma unroll
      for (int kk = 0; kk < MK / 16; ++kk) {
        uint32_t bfr[4][4];                  // 8 n8 tiles: 64 columns
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int n0 = wn * 64 + np * 16;
          if constexpr (EMB_DV)
            mma::ldmatrix_x4_trans(bfr[np], ce + mma::b_offset_kn(
                                                     lane, n0, kk * 16, ELD));
          else
            mma::ldmatrix_x4(bfr[np], ce + mma::b_offset_nk(lane, n0,
                                                            kk * 16, ELD));
        }
        uint32_t af[4][4];                   // 4 m16 tiles: 64 rows
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mma::ldmatrix_x4(af[mt], cx + mma::a_offset(lane, wm * 64 + mt * 16,
                                                      kk * 16, XLD));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            mma::mma_bf16(acc[mt][2 * np], af[mt], bfr[np][0], bfr[np][1]);
            mma::mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[np][2],
                          bfr[np][3]);
          }
      }
    }
    mma::cp_async_wait<0>();
  }
  __syncthreads();                           // s_lab, s_lse, s_g written

  // dl from the fragments: row wm 64 + 16 mt + 8 hh + gq, columns
  // c0 + 8 nt + (0, 1), stored as a hi and a lo bf16 pair
  const int c0 = v0 + wn * 64 + 2 * t4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 64 + mt * 16 + hh * 8 + gq;
      if (t0 + r >= n_tok) continue;
      const float l = s_lse[r], gt = s_g[r];
      const int lab = s_lab[r];
      const size_t row = (size_t)(t0 + r) * ld;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = c0 + nt * 8;
        if (c - v_begin >= ld) continue;     // past the buffer's last tile
        const float a = dlogit(acc[mt][nt][2 * hh], l, gt, c, lab, v_end);
        const float b =
            dlogit(acc[mt][nt][2 * hh + 1], l, gt, c + 1, lab, v_end);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
        *reinterpret_cast<__nv_bfloat162*>(dl + row + (c - v_begin)) = hi;
        *reinterpret_cast<__nv_bfloat162*>(dl_lo + row + (c - v_begin)) =
            __floats2bfloat162_rn(a - __low2float(hi), b - __high2float(hi));
      }
    }
}

template <bool VEC, bool EMB_DV>
int launch_mma(const void* x, const void* emb, const void* labels,
               const void* lse, const void* g, void* dl, void* dl_lo,
               int n_tok, int V, int d, int v_begin, int width, int ld,
               cudaStream_t st) {
  constexpr int bytes = mma_smem_bytes<EMB_DV>();
  cudaError_t err = cudaFuncSetAttribute(
      xent_bwd_kernel_mma<VEC, EMB_DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_tok + MT - 1) / MT, (ld + MV - 1) / MV);
  xent_bwd_kernel_mma<VEC, EMB_DV><<<grid, THREADS, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(emb),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<bf16*>(dl),
      static_cast<bf16*>(dl_lo), n_tok, V, d, v_begin, width, ld);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, bool EMB_DV>
int launch_fma(const void* x, const void* emb, const void* labels,
               const void* lse, const void* g, void* dl, void*, int n_tok,
               int V, int d, int v_begin, int width, int ld,
               cudaStream_t st) {
  const dim3 grid((n_tok + BT - 1) / BT, ld / BV);
  xent_bwd_kernel<VEC, EMB_DV><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(emb),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(dl), n_tok, V, d,
      v_begin, width, ld);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------------------
// bf16 on Hopper (route "sm90"): wgmma fed by TMA, persistent blocks
// -------------------------------------------------------------------------
namespace sm90 {

constexpr int CONSUMERS = 2;       // consumer warpgroups, 64 token rows each
constexpr int BN = 256;            // tile columns: the wgmma's N
constexpr int BK = 64;             // d step: one 128-byte swizzle row of bf16
constexpr int STAGES = 3;          // depth of the TMA ring
constexpr int BM = 64 * CONSUMERS;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + one producer warpgroup
constexpr int BOX_BYTES = 64 * BK * 2;          // one 64 x 64 TMA box
constexpr int B_BYTES = BN * BK * 2;            // the head's 256 columns
constexpr int STAGE_BYTES = CONSUMERS * BOX_BYTES + B_BYTES;
constexpr int OUT_BYTES = 64 * BN * 2;          // a warpgroup's staged term
// 40 + 2 x 232 = 3 x 168, the registers a thread that __launch_bounds__
// (384, 1) leaves: the producer gives back what the accumulators take
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ALIGN = 1024;        // 128-byte swizzled tiles start on 1 KB
constexpr float LOG2E = 1.4426950408889634f;

// One ring stage's work, written by the producer before the stage's
// arrival: the tile's first token row and first column in the chunk.
struct Item {
  int row0, n0, flags;
};
constexpr int FIRST = 1, LAST = 2, ZERO = 4, DONE = 8;

constexpr int SMEM_BYTES = ALIGN + STAGES * STAGE_BYTES +
                           CONSUMERS * OUT_BYTES +
                           STAGES * (16 + (int)sizeof(Item));

struct Smem {
  unsigned char* ring;  // [STAGES][CONSUMERS x boxes | head], on 1,024 B
  unsigned char* out;   // [CONSUMERS] staged bf16 terms for TMA stores
  uint64_t* full;       // [STAGES] TMA bytes landed (one arrival: producer)
  uint64_t* empty;      // [STAGES] released (an arrival a consumer warp)
  Item* items;          // [STAGES]
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem s;
  s.ring = raw + (ALIGN - wg::smem_u32(raw) % ALIGN) % ALIGN;
  s.out = s.ring + STAGES * STAGE_BYTES;
  s.full = reinterpret_cast<uint64_t*>(s.out + CONSUMERS * OUT_BYTES);
  s.empty = s.full + STAGES;
  s.items = reinterpret_cast<Item*>(s.empty + STAGES);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      wg::bar_init(&s.full[i], 1);
      wg::bar_init(&s.empty[i], CONSUMERS * 4);
    }
    wg::bar_fence_init();
  }
  return s;
}

// Producer side of the ring: stage `it` is free once the consumer
// warpgroups released its previous use (a fresh slot passes at once).
__device__ __forceinline__ int acquire(const Smem& sm, int it) {
  const int s = it % STAGES;
  wg::bar_wait(&sm.empty[s], ((it / STAGES) & 1) ^ 1);
  return s;
}
// An item with no loads: a tile of zeros, or the end.
__device__ __forceinline__ void push_plain(const Smem& sm, int it, Item m) {
  const int s = acquire(sm, it);
  sm.items[s] = m;
  wg::bar_arrive(&sm.full[s]);
}

// What a consumer's epilogue reads beside its sums.
struct Rows {
  const int* labels;
  const float* lse;
  const float* g;
  int n_tok, v_begin, v_end, ld;
};

// The epilogue's first half: dl of the tile from its sums, thread t's
// accumulators holding rows r = 16 (t / 32) + t % 32 / 4 (and r + 8) at
// columns 8 j + 2 (t % 4) (+ 1); zeros past the vocabulary and for a
// tile of zeros.  hi = bf16(dl) goes into the staging tile, as BN / 64
// swizzled boxes of 64 x 64 (conflict-free: the 8 rows a store
// instruction writes land in 8 different 16-byte columns), and lo =
// bf16(dl - hi) stays in registers, a pair packed in place of the first
// of its two sums, until the hi stores have read the tile.
__device__ __forceinline__ void stage_hi(unsigned char* buf,
                                         float (&acc)[BN / 2], const Item& m,
                                         int wgi, const Rows& p) {
  const int t = threadIdx.x % 128, row = t / 32 * 16 + t % 32 / 4;
  const int col = t % 4 * 2;
  const int c0 = p.v_begin + m.n0 + col;
  const bool zero = m.flags & ZERO;
  float lse2[2], gt[2];
  int lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m.row0 + wgi * 64 + row + 8 * h;
    const bool in = r < p.n_tok && !zero;
    lse2[h] = in ? __ldg(p.lse + r) * LOG2E : 0.f;
    gt[h] = in ? __ldg(p.g + r) : 0.f;
    lab[h] = in ? __ldg(p.labels + r) : -1;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float dl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        dl[e] = c < p.v_end && !zero
                    ? gt[h] * (exp2f(fmaf(acc[4 * j + 2 * h + e], LOG2E,
                                          -lse2[h])) -
                               (c == lab[h] ? 1.f : 0.f))
                    : 0.f;
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(dl[0], dl[1]);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          dl[0] - __low2float(hi), dl[1] - __high2float(hi));
      *reinterpret_cast<__nv_bfloat162*>(
          buf + wg::sw128_offset(row + 8 * h, 8 * j + col, 64)) = hi;
      acc[4 * j + 2 * h] =
          __uint_as_float(*reinterpret_cast<const uint32_t*>(&lo));
    }
}

// The second half: the lo pairs `stage_hi` kept into the staging tile.
__device__ __forceinline__ void stage_lo(unsigned char* buf,
                                         const float (&acc)[BN / 2]) {
  const int t = threadIdx.x % 128, row = t / 32 * 16 + t % 32 / 4;
  const int col = t % 4 * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          buf + wg::sw128_offset(row + 8 * h, 8 * j + col, 64)) =
          __float_as_uint(acc[4 * j + 2 * h]);
}

// The TMA stores of a staged term: 64 rows from row0, one {64, 64} box a
// 64 columns from col0; TMA leaves out rows past T and columns past ld,
// and boxes wholly past ld are not issued.
__device__ __forceinline__ void store_term(const CUtensorMap* map,
                                           const unsigned char* buf,
                                           int col0, int row0, int ld) {
  for (int b = 0; b < BN / 64 && col0 + 64 * b < ld; ++b)
    wg::tma_store_2d(map, buf + b * BOX_BYTES, col0 + 64 * b, row0);
}

// Consumer warpgroup `wgi`: takes the ring's items in order, multiplies
// its 64-row box of x by the shared head columns (B MN-major for the
// (d, V) head, else K-major) into 64 x BN fp32 sums and releases the
// stage.  At a tile's last stage (or a tile of zeros) it forms dl, stages
// hi and its first thread hands it to TMA stores, then lo in the same
// staging tile once those have read it; the next tile's products start
// while the lo stores run.
template <bool EMB_DV>
__device__ __forceinline__ void consume(const Smem& sm, int wgi,
                                        const CUtensorMap* hi_map,
                                        const CUtensorMap* lo_map,
                                        const Rows& p) {
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  const bool signal = threadIdx.x % 32 == 0;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* buf = sm.out + wgi * OUT_BYTES;
  // a k16 step moves a descriptor 32 bytes along a K-major row, or 16
  // rows (2,048 bytes) down an MN-major box; in 16-byte units
  constexpr int B_STEP = EMB_DV ? 128 : 2;
  for (int it = 0;; ++it) {
    const int s = it % STAGES;
    wg::bar_wait(&sm.full[s], (it / STAGES) & 1);
    const Item m = sm.items[s];
    if (m.flags & DONE) break;
    if (!(m.flags & ZERO)) {
      const unsigned char* st = sm.ring + s * STAGE_BYTES;
      const unsigned char* b = st + CONSUMERS * BOX_BYTES;
      const uint64_t da = wg::desc_k_major(st + wgi * BOX_BYTES);
      const uint64_t db = EMB_DV ? wg::desc_mn_major(b, BOX_BYTES)
                                 : wg::desc_k_major(b);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wg::mma<BN, 0, EMB_DV>(acc, da + kk * 2, db + kk * B_STEP,
                               kk > 0 || !(m.flags & FIRST));
      wg::commit();
      wg::wait<0>();
    }
    if (signal) wg::bar_arrive(&sm.empty[s]);
    if (m.flags & (LAST | ZERO)) {
      const int row0 = m.row0 + wgi * 64;
      const bool live = leader && row0 < p.n_tok;   // else wholly past T
      if (leader) wg::store_wait_read<0>();    // the last lo stores read buf
      wg::warpgroup_sync(1 + wgi);
      stage_hi(buf, acc, m, wgi, p);
      wg::fence_async();
      wg::warpgroup_sync(1 + wgi);
      if (live) {
        store_term(hi_map, buf, m.n0, row0, p.ld);
        wg::store_commit();
        wg::store_wait_read<0>();
      }
      wg::warpgroup_sync(1 + wgi);             // the hi stores read buf
      stage_lo(buf, acc);
      wg::fence_async();
      wg::warpgroup_sync(1 + wgi);
      if (live) {
        store_term(lo_map, buf, m.n0, row0, p.ld);
        wg::store_commit();
      }
    }
  }
  if (leader) wg::store_wait_all();
}

// One launch a chunk: the ceil(T / BM) x ceil(ld / BN) tiles of dl over
// `gridDim.x` persistent blocks, tile i (token tile i % rows of column
// tile i / rows) to block i mod gridDim.x.  x_map: x (T, d) as {64 d, 64
// tokens} boxes; e_map: the (d, V) head as {64 v, 64 d} boxes (EMB_DV) or
// the (V, d) table as {64 d, BN v} boxes; hi_map, lo_map: the (T, ld)
// terms as {64, 64} boxes.
template <bool EMB_DV>
__global__ void __launch_bounds__(THREADS, 1)
xent_bwd_sm90(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap e_map,
              const __grid_constant__ CUtensorMap hi_map,
              const __grid_constant__ CUtensorMap lo_map,
              const int* __restrict__ labels, const float* __restrict__ lse,
              const float* __restrict__ g, int n_tok, int d, int v_begin,
              int width, int ld) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  const int v_end = v_begin + width;
  if (wgi == CONSUMERS) {
    wg::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      wg::prefetch_map(&x_map);
      wg::prefetch_map(&e_map);
      const int rows = (n_tok + BM - 1) / BM, cols = (ld + BN - 1) / BN;
      const int ksteps = (d + BK - 1) / BK;
      int it = 0;
      for (int i = blockIdx.x; i < rows * cols; i += gridDim.x) {
        const int r = i % rows;
        const int c = i / rows;
        const int v0 = v_begin + c * BN;
        if (v0 >= v_end) {                    // past the vocabulary: zeros
          push_plain(sm, it++, Item{r * BM, c * BN, ZERO});
          continue;
        }
        for (int k = 0; k < ksteps; ++k, ++it) {
          const int s = acquire(sm, it);
          sm.items[s] = Item{r * BM, c * BN, (k == 0 ? FIRST : 0) |
                                                 (k == ksteps - 1 ? LAST : 0)};
          unsigned char* st = sm.ring + s * STAGE_BYTES;
          wg::bar_arrive_expect_tx(&sm.full[s], STAGE_BYTES);
          for (int h = 0; h < CONSUMERS; ++h)
            wg::tma_load_2d(st + h * BOX_BYTES, &x_map, &sm.full[s], k * BK,
                            r * BM + h * 64);
          unsigned char* b = st + CONSUMERS * BOX_BYTES;
          if constexpr (EMB_DV) {
            for (int q = 0; q < BN / 64; ++q)
              wg::tma_load_2d(b + q * BOX_BYTES, &e_map, &sm.full[s],
                              v0 + q * 64, k * BK);
          } else {
            wg::tma_load_2d(b, &e_map, &sm.full[s], k * BK, v0);
          }
        }
      }
      push_plain(sm, it, Item{0, 0, DONE});
    }
  } else {
    wg::reg_alloc<CONSUMER_REGS>();
    consume<EMB_DV>(sm, wgi, &hi_map, &lo_map,
                    Rows{labels, lse, g, n_tok, v_begin, v_end, ld});
  }
}

// The row-major (rows, cols) bf16 matrix at `p` as TMA boxes {64,
// box_rows}.
int rows_map(CUtensorMap* map, const void* p, int rows, int cols,
             int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return wg::make_map_bf16(map, p, 2, dims, strides, box);
}

// The blocks a launch of n_tok tokens and ld columns takes: one an SM, no
// more than there are tiles.
int grid_for(int n_tok, int ld, int sms) {
  const int work = (n_tok + BM - 1) / BM * ((ld + BN - 1) / BN);
  return work < sms ? work : sms;
}

template <bool EMB_DV>
int launch(const void* x, const void* emb, const void* labels,
           const void* lse, const void* g, void* dl, void* dl_lo, int n_tok,
           int V, int d, int v_begin, int width, int ld, int sms,
           cudaStream_t st) {
  CUtensorMap x_map, e_map, hi_map, lo_map;
  int err = rows_map(&x_map, x, n_tok, d, 64);
  if (!err)
    err = EMB_DV ? rows_map(&e_map, emb, d, V, 64)
                 : rows_map(&e_map, emb, V, d, BN);
  if (!err) err = rows_map(&hi_map, dl, n_tok, ld, 64);
  if (!err) err = rows_map(&lo_map, dl_lo, n_tok, ld, 64);
  if (err) return err;
  static bool raised[64] = {};  // the >48 KB opt-in, once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(xent_bwd_sm90<EMB_DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) raised[dev] = true;
  }
  const int grid = grid_for(n_tok, ld, sms);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  xent_bwd_sm90<EMB_DV><<<grid, THREADS, SMEM_BYTES, st>>>(
      x_map, e_map, hi_map, lo_map, static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g), n_tok, d,
      v_begin, width, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

}  // namespace

// x: (n_tok, d) row-major; emb: (V, d), or (d, V) when emb_dv; labels:
// (n_tok,) int32; lse, g: (n_tok,) fp32; dl: (n_tok, ld) row-major, fp32
// (blocked_xent_bwd_f32, which ignores dl_lo) or, with dl_lo, the hi and
// lo bf16 terms (blocked_xent_bwd_bf16); ld a multiple of 128 and at
// least `width`, the chunk's columns from v_begin.  vector:
// 16-byte loads (d, and V for the (d, V) head, multiples of 16 bytes'
// elements; x and emb 16-byte aligned).  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int blocked_xent_bwd_bf16(const void* x, const void* emb,
                                     const void* labels, const void* lse,
                                     const void* g, void* dl, void* dl_lo,
                                     int n_tok, int V, int d, int v_begin,
                                     int width, int ld, int emb_dv,
                                     int vector, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XENT_BWD(VEC, DV)                                                   \
  launch_mma<VEC, DV>(x, emb, labels, lse, g, dl, dl_lo, n_tok, V, d,      \
                      v_begin, width, ld, st)
  if (vector && emb_dv) return XENT_BWD(true, true);
  if (vector) return XENT_BWD(true, false);
  if (emb_dv) return XENT_BWD(false, true);
  return XENT_BWD(false, false);
#undef XENT_BWD
}

extern "C" int blocked_xent_bwd_f32(const void* x, const void* emb,
                                    const void* labels, const void* lse,
                                    const void* g, void* dl, void* dl_lo,
                                    int n_tok, int V, int d, int v_begin,
                                    int width, int ld, int emb_dv,
                                    int vector, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define XENT_BWD(VEC, DV)                                                   \
  launch_fma<VEC, DV>(x, emb, labels, lse, g, dl, dl_lo, n_tok, V, d,      \
                      v_begin, width, ld, st)
  if (vector && emb_dv) return XENT_BWD(true, true);
  if (vector) return XENT_BWD(true, false);
  if (emb_dv) return XENT_BWD(false, true);
  return XENT_BWD(false, false);
#undef XENT_BWD
}

// The bf16 kernel on Hopper (route "sm90"): the arguments of
// blocked_xent_bwd_bf16 with `sms` persistent blocks in place of
// `vector`; d, and V when emb_dv, multiples of 8, and x, emb, dl and
// dl_lo on 16 bytes (TMA's rules); ld a multiple of 128.  Returns the
// CUDA error code of the launch, or of the tensor maps' encoding (0 on
// success).
extern "C" int blocked_xent_bwd_sm90(const void* x, const void* emb,
                                     const void* labels, const void* lse,
                                     const void* g, void* dl, void* dl_lo,
                                     int n_tok, int V, int d, int v_begin,
                                     int width, int ld, int emb_dv, int sms,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return emb_dv ? sm90::launch<true>(x, emb, labels, lse, g, dl, dl_lo,
                                     n_tok, V, d, v_begin, width, ld, sms, st)
                : sm90::launch<false>(x, emb, labels, lse, g, dl, dl_lo,
                                      n_tok, V, d, v_begin, width, ld, sms,
                                      st);
}

// The sm90 kernel's shape: out[0..6] = tile rows, tile columns, d step,
// ring stages, threads a block, bytes a stage, and the blocks a launch of
// n_tok tokens and ld columns takes on `sms` SMs; returns its dynamic
// shared memory (bytes).
extern "C" int blocked_xent_bwd_sm90_plan(int n_tok, int ld, int sms,
                                          int* out) {
  const int shape[7] = {sm90::BM,      sm90::BN,          sm90::BK,
                        sm90::STAGES,  sm90::THREADS,     sm90::STAGE_BYTES,
                        sm90::grid_for(n_tok, ld, sms)};
  for (int i = 0; i < 7; ++i) out[i] = shape[i];
  return sm90::SMEM_BYTES;
}
