// K9: grouped (per-expert) GEMM over block-sorted rows, the port of
// src/repro/kernels/moe_gemm.py::grouped_gemm (Pallas body `_gg_kernel`).
//
// x (T, d) row-major, its rows sorted so that every block_m-row block
// belongs to one expert; w (E, d, f) row-major; block_ids (T / block_m,)
// int32.  out[i, :] = x[i, :] @ w[block_ids[i / block_m]] with fp32
// accumulation over d, written in x's type (fp32 or bf16).  One addition
// to the reference's contract: a block whose id lies outside [0, E) (the
// packed layout's -1) is written as zeros and reads nothing.  Each block
// reads its own expert id, which takes the place of the TPU's
// scalar-prefetch index map.
//
// What bounds it, at the DeepSeek-V2-Lite widths (d 2048, f 1408, bf16;
// NVIDIA H100 SXM data sheet, 700 W: 3.35 TB/s, 989 TFLOP/s bf16 tensor
// cores): a 916-token prefill names 127 blocks of 64 rows over all 64
// experts, 46.9 GFLOP (0.047 ms) against 369 MB of weight slabs and rows
// (0.11 ms): bytes, with the products close behind.  A 4-slot decode
// tick names 22 blocks of 8 rows, 22 slabs of 5.77 MB (0.038 ms) and
// almost no arithmetic: a stream over weight slabs.
//
// bf16: two tensor-core kernels, `mma.sync` m16n8k16 tiles (bf16 in,
// fp32 sums, one rounding to bf16 at the store), operands by `ldmatrix`
// from a `cp.async` ring (csrc/mma.cuh).
//   gg_prefill (row tiles of 64, a block_m multiple of 64): one block per
//     (64-row tile, 128 columns of f), 4 warps of 32 x 64; a 4-stage ring
//     of 32-deep x and weight tiles over d.  The expert's (d, f) slab is
//     the B operand in place (k-major, `ldmatrix.trans`).  A row tile is
//     one expert, so the 64 x 128 tile is as wide as a block can share its
//     weight tile; the grid walks a row tile's column tiles together, so
//     each x tile comes from memory once and the two or so blocks of one
//     expert meet their weight tiles in L2.
//   gg_tick (row tiles of 8, any other block_m): out^T = w^T x^T, so f is
//     the `mma` M side and the 8 token rows its N = 8 side, and no half of
//     a fragment is padding.  One block per (8-row tile, 64 columns of f),
//     4 warps of 16 columns, a 4-stage ring of 64-deep slab tiles (A by
//     `ldmatrix.trans` of the k-major slab): the 22 named blocks of a tick
//     give 484 streaming blocks (704 for the down product), 3-4 per SM,
//     each holding up to 27 KB of its slab in flight.
// Unaligned x or w, or d and f off the 16-byte width, stage by element
// loads in the same kernels (VEC false).  Ragged d is zero-filled, ragged
// f masked at the store.  Blocks of a -1 id store zeros and exit.
//
// fp32: an FMA kernel (a tensor-core product would be TF32).  Per d
// step it stages the (BM, BK) row tile transposed and the (BK, BN) weight
// tile in shared memory; the next step's tiles are loaded into registers
// while this step's FMAs run; a thread owns a TM x TN block of the output
// tile.  Tiles: 64 x 64 (BK 32, 4 x 4 a thread) for prefill-sized
// groups, 8 x 128 (BK 64, 1 x 4 a thread) for a decode tick.
//
// The backward, the counterpart of XLA's gradient of the reference's
// expert einsums (src/repro/models/moe.py:105-108; the TPU has no kernel
// for it): dX (t, d) = dY W[e]^T block by block, and dW[e] (d, f) = the
// sum over the blocks of id e of X_blk^T dY_blk, in fp32, rounded once at
// the store.  What bounds it, at Moonlight-16B-A3B's training step (4 x
// 2,048 tokens, top 6: 832 blocks of 64 rows, 603 of them named, 38,592
// rows, d 2,048, f 1,408): each product is 2 x 38,592 x 2,048 x 1,408 =
// 222.6 GFLOP (0.225 ms at 989 TFLOP/s) against 0.64-0.70 GB read and
// written in memory (rows, slabs, the output; 0.19-0.21 ms at 3.35 TB/s):
// operations, the bytes close behind, the tiles fed from L2.
//
// bf16 with block_m a multiple of 64, d and f multiples of 8 and 16-byte
// aligned bases (the wrapper's route "sm90", TMA's rules): two Hopper
// kernels, namespace sm90 below, built on csrc/wgmma.cuh.
//   gg_dx_sm90: a tile is 128 token rows x 256 columns of d, two
//     consecutive 64-row chunks of one expert (an expert's odd last chunk
//     a half tile, for one warpgroup), both warpgroups sharing W[e]'s
//     tile.  A is dy's rows (K = f, K-major), B W[e]'s (d, f) slab as it
//     lies (N = d, K-major): no transpose.  L2 reads at the gate/up shape:
//     dy's named rows once a column tile (8 x 109 MB) and W[e]'s 256-row
//     tile once a named row tile (319 x 8 x 0.72 MB), 2.7 GB a call (the
//     first design's 64 x 128 tiles: 5.2 GB).
//   gg_dw_sm90: a tile is 128 rows of d x 256 columns of f of one dW[e];
//     K is the expert's rows, walked in block order.  A is x's rows (M =
//     d, MN-major), B dy's rows (N = f, MN-major): wgmma's transpose flags
//     read both as they lie.  x is read once a column tile (6 times), dy
//     once a row tile of d (16 times): 2.7 GB a call (5.2).  A tile's
//     whole sum is one warpgroup's registers: no split over K, no
//     atomics, the same bits every launch.
//   Both: three warpgroups, 384 threads.  A producer warp issues TMA
//   loads (128-byte swizzle) into a 3-stage ring of 48 KB stages, each
//   reporting to its `full` mbarrier; two consumer warpgroups (setmaxnreg
//   232 registers, the producer 40) each multiply their 64-row A box by
//   the shared B with four wgmma m64n256k16 a stage (128 fp32 sums a
//   thread) and release the stage on its `empty` mbarrier.  At a tile's
//   end a consumer writes its sums in bf16 into a 32 KB staging tile and
//   one thread hands it to TMA stores, so the next tile's products start
//   at once (the stores skip what lies past the output's bounds: ragged
//   d and f need no mask).  The producer writes each stage's work (tile,
//   expert, first/last, zeros, end) beside it, so the consumers need no
//   schedule of their own.
//   Schedule: one persistent block an SM (`sms`), tile i to block i mod
//   grid, a static stride (no tile counter, so no atomics at all).  dX's
//   tiles run row tile by row tile, a row tile's column tiles together,
//   so dy's rows and W[e]'s tiles are read from L2 by neighbours; the
//   producer pairs chunks as it walks the ids.  dW's tiles run in expert
//   order, an expert's 96 tiles (at the gate/up shape) spread over every
//   block by the stride, so each block's depth is near the mean of the
//   experts' sizes; its blocks each count every expert's chunks at their
//   start (3.3 KB of ids, no launch and no host read).  An order by
//   expert size, largest first, was no faster on a Moonlight step's own
//   routing on an H100 (expert order 1.4 % faster at gate/up, 2.4 %
//   slower at down) and was taken out.  A tile of -1 chunks (dX) or of an expert with no chunk
//   (dW) loads nothing and stores zeros.
//   Against the first design (route "mma" below): `mma.sync` became wgmma
//   (the way to the full tensor-core rate); 64 x 128 tiles that read 5.2
//   GB from L2 became 128 x 256 tiles at 2.7 GB; the cp.async copies by
//   all threads and the `ldmatrix` (.trans for dW) loads became TMA boxes
//   that the wgmma descriptors read in place; dX's 3,664 blocks of -1
//   rows and dW's blocks of uneven depth, each scanning all ids, became a
//   persistent grid on a balanced static stride.
//
// Every other bf16 launch (route "mma": 8-row decode blocks, ragged or
// unaligned shapes) takes the first design's `mma.sync` kernels:
//   gg_dx_rows / gg_dx_tick: the forward's two row tiles with the slab
//     read the other way round: W[e]'s row-major (d, f) storage is the
//     (N, K) layout of an mma B operand (rows) or the (M, K) layout of an
//     A operand (tick, dx^T = W dY^T), so both load by plain `ldmatrix`.
//   gg_dw: one block per (expert, 64 x 128 tile of dW[e]); it walks
//     block_ids in order and accumulates only its own expert's blocks,
//     both operands by `ldmatrix.trans`.  No atomics, a fixed order: two
//     launches give the same bits.
//   fp32: FMA kernels, as the forward's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // fp32 kernel

template <int BM, int BN, int BK, int TM, int TN, bool VEC>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ block_ids, float* __restrict__ out,
                    int block_m, int n_experts, int d, int f) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one output per thread");
  static_assert(TN == 4 && (TM == 1 || TM == 4), "float4 reads");
  // elements per global load: 16 bytes when VEC (rows of x and w aligned
  // to 16 bytes, d and f multiples of V), else one
  constexpr int V = VEC ? 4 : 1;
  static_assert(BK % V == 0 && BN % V == 0, "whole vectors per tile row");
  constexpr int LDA = BM + 4;                 // transposed row tile
  constexpr int A_VECS = BM * BK / V;         // loads per tile
  constexpr int B_VECS = BK * BN / V;
  constexpr int A_PER = (A_VECS + THREADS - 1) / THREADS;
  constexpr int B_PER = B_VECS / THREADS;
  static_assert(B_VECS % THREADS == 0, "whole weight tiles per thread");
  constexpr int COLS = BN / TN;
  using Chunk = typename std::conditional<VEC, uint4, float>::type;

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
      if (c < f) out[(size_t)(row0 + i / BN) * f + c] = 0.f;
    }
    return;
  }
  const float* xb = x + (size_t)row0 * d;
  const float* wb = w + (size_t)e * d * f;

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
      const float* v = reinterpret_cast<const float*>(&ra[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) sA[(c + j) * LDA + r] = v[j];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / (BN / V), c = (idx % (BN / V)) * V;
      const float* v = reinterpret_cast<const float*>(&rb[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) sB[r * BN + c + j] = v[j];
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
    float* o = out + (size_t)(row0 + ty * TM + i) * f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < f) o[c] = acc[i][j];
    }
  }
}

// -------------------------------------------------------------------------
// bf16 on the tensor cores
// -------------------------------------------------------------------------
constexpr int MMA_THREADS = 128;   // 4 warps
constexpr int STAGES = 4;          // depth of both cp.async rings

// Zeros over rows [row0, row0 + R) x columns [c0, c0 + C) of out (f wide).
template <int R, int C>
__device__ __forceinline__ void store_zeros(bf16* __restrict__ out, int row0,
                                            int c0, int f) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < R * C; i += MMA_THREADS) {
    const int c = c0 + i % C;
    if (c < f) out[(size_t)(row0 + i / C) * f + c] = zero;
  }
}

// Prefill tile: PM rows (one expert) x PN columns, d in steps of PK.
constexpr int PM = 64, PN = 128, PK = 32;
constexpr int P_ALD = PK + mma::PAD;              // x tile pitch
constexpr int P_BLD = PN + mma::PAD;              // weight tile pitch
constexpr int P_AS = PM * P_ALD, P_BS = PK * P_BLD;
constexpr int P_SMEM = STAGES * (P_AS + P_BS) * (int)sizeof(bf16);

// Grid (T / PM * ceil(f / PN)), column tile fastest: the column tiles of
// one row tile are neighbours in launch order, so its x rows are read from
// memory once and the blocks of one expert meet its weight tiles in L2.  Warp w owns rows
// (w / 2) * 32.. and columns (w % 2) * 64.. of the tile: 2 x 8 m16n8
// fragments.
template <bool VEC>
__global__ void __launch_bounds__(MMA_THREADS)
gg_prefill(const bf16* __restrict__ x, const bf16* __restrict__ w,
           const int* __restrict__ block_ids, bf16* __restrict__ out,
           int block_m, int n_experts, int d, int f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][PM][P_ALD]
  bf16* sb = sa + STAGES * P_AS;                  // [STAGES][PK][P_BLD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n_cols = (f + PN - 1) / PN;
  const int row0 = blockIdx.x / n_cols * PM, n0 = blockIdx.x % n_cols * PN;
  const int e = block_ids[row0 / block_m];
  if (e < 0 || e >= n_experts) {
    store_zeros<PM, PN>(out, row0, n0, f);
    return;
  }
  const bf16* xb = x + (size_t)row0 * d;
  const bf16* wb = w + (size_t)e * d * f;
  const int ksteps = (d + PK - 1) / PK;

  auto load_stage = [&](int ks) {
    const int k0 = ks * PK;
    mma::load_tile<PM, PK, MMA_THREADS, VEC>(sa + (ks % STAGES) * P_AS, xb, 0,
                                             k0, PM, d, d, tid);
    mma::load_tile<PK, PN, MMA_THREADS, VEC>(sb + (ks % STAGES) * P_BS, wb,
                                             k0, n0, d, f, f, tid);
  };

  float acc[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

#pragma unroll
  for (int ks = 0; ks < STAGES - 1; ++ks) {
    if (ks < ksteps) load_stage(ks);
    mma::cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    mma::cp_async_wait<STAGES - 2>();        // stage ks has arrived
    __syncthreads();                         // and stage ks - 1 is free
    if (ks + STAGES - 1 < ksteps) load_stage(ks + STAGES - 1);
    mma::cp_async_commit();
    const bf16* ca = sa + (ks % STAGES) * P_AS;
    const bf16* cb = sb + (ks % STAGES) * P_BS;
#pragma unroll
    for (int kk = 0; kk < PK / 16; ++kk) {
      uint32_t af[2][4], bfr[4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma::ldmatrix_x4(af[mt], ca + mma::a_offset(lane, wm * 32 + mt * 16,
                                                    kk * 16, P_ALD));
#pragma unroll
      for (int np = 0; np < 4; ++np)
        mma::ldmatrix_x4_trans(bfr[np], cb + mma::b_offset_kn(
                                            lane, wn * 64 + np * 16, kk * 16,
                                            P_BLD));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma::mma_bf16(acc[mt][2 * np], af[mt], bfr[np][0], bfr[np][1]);
          mma::mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[np][2], bfr[np][3]);
        }
    }
  }
  mma::cp_async_wait<0>();

  // lane (g, t4) holds rows g and g + 8 of each fragment at columns
  // 2 t4 and 2 t4 + 1
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      bf16* o = out + (size_t)(row0 + wm * 32 + mt * 16 + hh * 8 + g) * f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = n0 + wn * 64 + nt * 8 + 2 * t4;
        const float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
        if (VEC) {                           // f even: c < f means c + 1 < f
          if (c < f)
            *reinterpret_cast<__nv_bfloat162*>(o + c) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < f) o[c] = __float2bfloat16(v0);
          if (c + 1 < f) o[c + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// Tick tile: 8 token rows x TF columns of f, d in steps of TK.
constexpr int TR = 8, TF = 64, TK = 64;
constexpr int T_WLD = TF + mma::PAD;              // slab tile pitch
constexpr int T_XLD = TK + mma::PAD;              // x tile pitch
constexpr int T_WS = TK * T_WLD, T_XS = TR * T_XLD;
constexpr int T_SMEM = STAGES * (T_WS + T_XS) * (int)sizeof(bf16);

// Grid (T / TR, ceil(f / TF)).  Warp w owns columns w * 16.. of the tile:
// one m16n8 fragment of out^T (16 columns of f x the 8 rows).
template <bool VEC>
__global__ void __launch_bounds__(MMA_THREADS)
gg_tick(const bf16* __restrict__ x, const bf16* __restrict__ w,
        const int* __restrict__ block_ids, bf16* __restrict__ out,
        int block_m, int n_experts, int d, int f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sw = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][TK][T_WLD]
  bf16* sx = sw + STAGES * T_WS;                  // [STAGES][TR][T_XLD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * TR, n0 = blockIdx.y * TF;
  const int e = block_ids[row0 / block_m];
  if (e < 0 || e >= n_experts) {
    store_zeros<TR, TF>(out, row0, n0, f);
    return;
  }
  const bf16* xb = x + (size_t)row0 * d;
  const bf16* wb = w + (size_t)e * d * f;
  const int ksteps = (d + TK - 1) / TK;

  auto fetch = [&](int ks) {
    const int k0 = ks * TK;
    mma::load_tile<TK, TF, MMA_THREADS, VEC>(sw + (ks % STAGES) * T_WS, wb,
                                             k0, n0, d, f, f, tid);
    mma::load_tile<TR, TK, MMA_THREADS, VEC>(sx + (ks % STAGES) * T_XS, xb, 0,
                                             k0, TR, d, d, tid);
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < STAGES - 1; ++ks) {
    if (ks < ksteps) fetch(ks);
    mma::cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ks + STAGES - 1 < ksteps) fetch(ks + STAGES - 1);
    mma::cp_async_commit();
    const bf16* cw = sw + (ks % STAGES) * T_WS;
    const bf16* cx = sx + (ks % STAGES) * T_XS;
#pragma unroll
    for (int kp = 0; kp < TK / 32; ++kp) {
      // B (x^T, k x 8 rows) for two k16 steps: rows of x, 8 k apart
      uint32_t xf[4], wf[2][4];
      mma::ldmatrix_x4(xf,
                       cx + (lane & 7) * T_XLD + kp * 32 + (lane >> 3) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mma::ldmatrix_x4_trans(wf[h], cw + mma::a_offset_km(
                                          lane, warp * 16, kp * 32 + h * 16,
                                          T_WLD));
      mma::mma_bf16(acc, wf[0], xf[0], xf[1]);
      mma::mma_bf16(acc, wf[1], xf[2], xf[3]);
    }
  }
  mma::cp_async_wait<0>();

  // acc: columns g and g + 8 of this warp's 16, token rows 2 t4, 2 t4 + 1
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int c = n0 + warp * 16 + hh * 8 + g;
    if (c < f)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
        out[(size_t)(row0 + 2 * t4 + e2) * f + c] =
            __float2bfloat16(acc[2 * hh + e2]);
  }
}

template <typename Kernel>
int launch_mma(Kernel kernel, dim3 grid, int smem, const void* x,
               const void* w, const void* ids, void* out, int block_m,
               int n_experts, int d, int f, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(ids), static_cast<bf16*>(out), block_m,
      n_experts, d, f);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const void* w, const void* ids, void* out,
                int t, int block_m, int n_experts, int d, int f, int tile_m,
                int vector, cudaStream_t st) {
  if (tile_m == PM) {
    const dim3 grid(t / PM * ((f + PN - 1) / PN));
    return vector ? launch_mma(gg_prefill<true>, grid, P_SMEM, x, w, ids, out,
                               block_m, n_experts, d, f, st)
                  : launch_mma(gg_prefill<false>, grid, P_SMEM, x, w, ids,
                               out, block_m, n_experts, d, f, st);
  }
  if (tile_m == TR) {
    const dim3 grid(t / TR, (f + TF - 1) / TF);
    return vector ? launch_mma(gg_tick<true>, grid, T_SMEM, x, w, ids, out,
                               block_m, n_experts, d, f, st)
                  : launch_mma(gg_tick<false>, grid, T_SMEM, x, w, ids, out,
                               block_m, n_experts, d, f, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BM, int BN, int BK, int TM, int TN>
int launch_f32_tiles(const void* x, const void* w, const void* ids, void* out,
                     int t, int block_m, int n_experts, int d, int f,
                     int vector, cudaStream_t st) {
  const dim3 grid(t / BM, (f + BN - 1) / BN);
  auto* xp = static_cast<const float*>(x);
  auto* wp = static_cast<const float*>(w);
  auto* ip = static_cast<const int*>(ids);
  auto* op = static_cast<float*>(out);
  if (vector)
    grouped_gemm_kernel<BM, BN, BK, TM, TN, true><<<grid, THREADS, 0, st>>>(
        xp, wp, ip, op, block_m, n_experts, d, f);
  else
    grouped_gemm_kernel<BM, BN, BK, TM, TN, false><<<grid, THREADS, 0, st>>>(
        xp, wp, ip, op, block_m, n_experts, d, f);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* x, const void* w, const void* ids, void* out,
               int t, int block_m, int n_experts, int d, int f, int tile_m,
               int vector, cudaStream_t st) {
  if (tile_m == 64)
    return launch_f32_tiles<64, 64, 32, 4, 4>(x, w, ids, out, t, block_m,
                                              n_experts, d, f, vector, st);
  if (tile_m == 8)
    return launch_f32_tiles<8, 128, 64, 1, 4>(x, w, ids, out, t, block_m,
                                              n_experts, d, f, vector, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// -------------------------------------------------------------------------
// The backward: dX = dY W[e]^T and dW[e] = sum of X_blk^T dY_blk
// -------------------------------------------------------------------------
// bf16 dX, row tile (block_m a multiple of 64): PM rows x PN columns of d,
// f in steps of PK.  The expert's (d, f) slab, row-major, is already the
// (N, K) layout of an mma B operand: its tile is staged [n][k] and read by
// plain `ldmatrix`.  Warps as in gg_prefill (2 x 2 of 32 x 64).
constexpr int DX_WLD = PK + mma::PAD;             // slab tile pitch ([n][k])
constexpr int DX_YS = PM * P_ALD, DX_WS = PN * DX_WLD;
constexpr int DX_SMEM = STAGES * (DX_YS + DX_WS) * (int)sizeof(bf16);

template <bool VEC>
__global__ void __launch_bounds__(MMA_THREADS)
gg_dx_rows(const bf16* __restrict__ dy, const bf16* __restrict__ w,
           const int* __restrict__ block_ids, bf16* __restrict__ dx,
           int block_m, int n_experts, int d, int f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_dy = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][PM][P_ALD]
  bf16* s_w = s_dy + STAGES * DX_YS;               // [STAGES][PN][DX_WLD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n_cols = (d + PN - 1) / PN;
  const int row0 = blockIdx.x / n_cols * PM, n0 = blockIdx.x % n_cols * PN;
  const int e = block_ids[row0 / block_m];
  if (e < 0 || e >= n_experts) {
    store_zeros<PM, PN>(dx, row0, n0, d);
    return;
  }
  const bf16* dyb = dy + (size_t)row0 * f;
  const bf16* wb = w + (size_t)e * d * f;
  const int steps = (f + PK - 1) / PK;

  auto stage_in = [&](int s) {
    const int k0 = s * PK;
    mma::load_tile<PM, PK, MMA_THREADS, VEC>(s_dy + (s % STAGES) * DX_YS, dyb,
                                             0, k0, PM, f, f, tid);
    mma::load_tile<PN, PK, MMA_THREADS, VEC>(s_w + (s % STAGES) * DX_WS, wb,
                                             n0, k0, d, f, f, tid);
  };

  float sum[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[a][b][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage_in(s);
    mma::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < steps) stage_in(s + STAGES - 1);
    mma::cp_async_commit();
    const bf16* cy = s_dy + (s % STAGES) * DX_YS;
    const bf16* cw = s_w + (s % STAGES) * DX_WS;
#pragma unroll
    for (int ki = 0; ki < PK / 16; ++ki) {
      uint32_t ya[2][4], wb4[4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma::ldmatrix_x4(ya[mt], cy + mma::a_offset(lane, wm * 32 + mt * 16,
                                                    ki * 16, P_ALD));
#pragma unroll
      for (int np = 0; np < 4; ++np)
        mma::ldmatrix_x4(wb4[np], cw + mma::b_offset_nk(
                                      lane, wn * 64 + np * 16, ki * 16,
                                      DX_WLD));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          mma::mma_bf16(sum[mt][2 * np], ya[mt], wb4[np][0], wb4[np][1]);
          mma::mma_bf16(sum[mt][2 * np + 1], ya[mt], wb4[np][2], wb4[np][3]);
        }
    }
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      bf16* o = dx + (size_t)(row0 + wm * 32 + mt * 16 + hh * 8 + g) * d;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = n0 + wn * 64 + nt * 8 + 2 * t4;
        const float v0 = sum[mt][nt][2 * hh], v1 = sum[mt][nt][2 * hh + 1];
        if (VEC) {                           // d even: c < d means c + 1 < d
          if (c < d)
            *reinterpret_cast<__nv_bfloat162*>(o + c) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < d) o[c] = __float2bfloat16(v0);
          if (c + 1 < d) o[c + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// bf16 dX, tick tile (any other block_m): dx^T = W[e] dy^T, so d is the
// mma M side (TF columns of d a block, 16 a warp) and the 8 rows its
// N = 8 side, f in steps of TK.  The slab tile is staged [m][k], an A
// operand by plain `ldmatrix`; dy's rows are the B operand as in gg_tick.
constexpr int DXT_WLD = TK + mma::PAD;
constexpr int DXT_WS = TF * DXT_WLD;
constexpr int DXT_SMEM = STAGES * (DXT_WS + T_XS) * (int)sizeof(bf16);

template <bool VEC>
__global__ void __launch_bounds__(MMA_THREADS)
gg_dx_tick(const bf16* __restrict__ dy, const bf16* __restrict__ w,
           const int* __restrict__ block_ids, bf16* __restrict__ dx,
           int block_m, int n_experts, int d, int f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_w = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][TF][DXT_WLD]
  bf16* s_dy = s_w + STAGES * DXT_WS;              // [STAGES][TR][T_XLD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * TR, m0 = blockIdx.y * TF;
  const int e = block_ids[row0 / block_m];
  if (e < 0 || e >= n_experts) {
    store_zeros<TR, TF>(dx, row0, m0, d);
    return;
  }
  const bf16* dyb = dy + (size_t)row0 * f;
  const bf16* wb = w + (size_t)e * d * f;
  const int steps = (f + TK - 1) / TK;

  auto stage_in = [&](int s) {
    const int k0 = s * TK;
    mma::load_tile<TF, TK, MMA_THREADS, VEC>(s_w + (s % STAGES) * DXT_WS, wb,
                                             m0, k0, d, f, f, tid);
    mma::load_tile<TR, TK, MMA_THREADS, VEC>(s_dy + (s % STAGES) * T_XS, dyb,
                                             0, k0, TR, f, f, tid);
  };

  float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage_in(s);
    mma::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < steps) stage_in(s + STAGES - 1);
    mma::cp_async_commit();
    const bf16* cw = s_w + (s % STAGES) * DXT_WS;
    const bf16* cy = s_dy + (s % STAGES) * T_XS;
#pragma unroll
    for (int kh = 0; kh < TK / 32; ++kh) {
      // B (dy^T, k x 8 rows) for two k16 steps: rows of dy, 8 k apart
      uint32_t yb[4], wa[2][4];
      mma::ldmatrix_x4(yb, cy + (lane & 7) * T_XLD + kh * 32 + (lane >> 3) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mma::ldmatrix_x4(wa[h], cw + mma::a_offset(lane, warp * 16,
                                                   kh * 32 + h * 16,
                                                   DXT_WLD));
      mma::mma_bf16(sum, wa[0], yb[0], yb[1]);
      mma::mma_bf16(sum, wa[1], yb[2], yb[3]);
    }
  }
  mma::cp_async_wait<0>();

  // sum: columns g and g + 8 of this warp's 16 of d, rows 2 t4, 2 t4 + 1
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int c = m0 + warp * 16 + hh * 8 + g;
    if (c < d)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        dx[(size_t)(row0 + 2 * t4 + r) * d + c] =
            __float2bfloat16(sum[2 * hh + r]);
  }
}

// bf16 dW: one block per (expert, DM rows of d x DN columns of f of its
// gradient).  It scans block_ids in order, DW_CHUNK ids at a time (warp
// 0, by ballots, keeping the order), into a list of its expert's blocks,
// then runs their rows through the cp.async ring in pieces of KP rows:
// x's piece [k][m] and dy's [k][n] are the A and B operands, both read by
// `ldmatrix.trans`.  KP is 32, or 8 for a block_m off 32, each 8-row
// piece padded with zero rows to the mma's k = 16.  No atomics and a
// fixed order: two launches give the same bits; an expert that owns no
// block stores zeros.
constexpr int DM = 64, DN = 128;
constexpr int DW_XLD = DM + mma::PAD, DW_YLD = DN + mma::PAD;
constexpr int DW_CHUNK = 1024;

template <int KP>
struct DwTile {
  static constexpr int KT = KP < 16 ? 16 : KP;     // staged rows a piece
  static constexpr int XS = KT * DW_XLD, YS = KT * DW_YLD;
  static constexpr int SMEM =
      STAGES * (XS + YS) * (int)sizeof(bf16) + DW_CHUNK * (int)sizeof(int);
};

template <bool VEC, int KP>
__global__ void __launch_bounds__(MMA_THREADS)
gg_dw(const bf16* __restrict__ x, const bf16* __restrict__ dy,
      const int* __restrict__ block_ids, bf16* __restrict__ dw, int n_blocks,
      int block_m, int d, int f) {
  using Tile = DwTile<KP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_x = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][KT][DW_XLD]
  bf16* s_y = s_x + STAGES * Tile::XS;             // [STAGES][KT][DW_YLD]
  int* mine = reinterpret_cast<int*>(s_y + STAGES * Tile::YS);  // [DW_CHUNK]
  __shared__ int n_mine;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int tiles_n = (f + DN - 1) / DN;
  const int m0 = blockIdx.x / tiles_n * DM, n0 = blockIdx.x % tiles_n * DN;
  const int e = blockIdx.y;
  const int pieces = block_m / KP;

  float sum[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[a][b][c] = 0.f;

  for (int c0 = 0; c0 < n_blocks; c0 += DW_CHUNK) {
    const int cn = min(DW_CHUNK, n_blocks - c0);
    if (warp == 0) {
      int count = 0;
      for (int b = 0; b < cn; b += 32) {
        const bool hit = b + lane < cn && block_ids[c0 + b + lane] == e;
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (hit) mine[count + __popc(ballot & ((1u << lane) - 1u))] =
            c0 + b + lane;
        count += __popc(ballot);
      }
      if (lane == 0) n_mine = count;
    }
    __syncthreads();
    const int steps = n_mine * pieces;

    auto stage_in = [&](int s) {
      const int r = mine[s / pieces] * block_m + (s % pieces) * KP;
      mma::load_tile<Tile::KT, DM, MMA_THREADS, VEC>(
          s_x + (s % STAGES) * Tile::XS, x, r, m0, r + KP, d, d, tid);
      mma::load_tile<Tile::KT, DN, MMA_THREADS, VEC>(
          s_y + (s % STAGES) * Tile::YS, dy, r, n0, r + KP, f, f, tid);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) stage_in(s);
      mma::cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      mma::cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (s + STAGES - 1 < steps) stage_in(s + STAGES - 1);
      mma::cp_async_commit();
      const bf16* cx = s_x + (s % STAGES) * Tile::XS;
      const bf16* cy = s_y + (s % STAGES) * Tile::YS;
#pragma unroll
      for (int kq = 0; kq < Tile::KT / 16; ++kq) {
        uint32_t xa[2][4], yb[4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma::ldmatrix_x4_trans(xa[mt], cx + mma::a_offset_km(
                                             lane, wm * 32 + mt * 16, kq * 16,
                                             DW_XLD));
#pragma unroll
        for (int np = 0; np < 4; ++np)
          mma::ldmatrix_x4_trans(yb[np], cy + mma::b_offset_kn(
                                             lane, wn * 64 + np * 16, kq * 16,
                                             DW_YLD));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            mma::mma_bf16(sum[mt][2 * np], xa[mt], yb[np][0], yb[np][1]);
            mma::mma_bf16(sum[mt][2 * np + 1], xa[mt], yb[np][2], yb[np][3]);
          }
      }
    }
    mma::cp_async_wait<0>();
    __syncthreads();            // the list and the ring are free again
  }

  bf16* dwe = dw + (size_t)e * d * f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm * 32 + mt * 16 + hh * 8 + g;
      if (m >= d) continue;
      bf16* o = dwe + (size_t)m * f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = n0 + wn * 64 + nt * 8 + 2 * t4;
        const float v0 = sum[mt][nt][2 * hh], v1 = sum[mt][nt][2 * hh + 1];
        if (VEC) {                           // f even: c < f means c + 1 < f
          if (c < f)
            *reinterpret_cast<__nv_bfloat162*>(o + c) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < f) o[c] = __float2bfloat16(v0);
          if (c + 1 < f) o[c + 1] = __float2bfloat16(v1);
        }
      }
    }
}

// fp32 dX: FMAs, a thread owning TM x TN outputs of a BM x BN tile (BN
// columns of d); per f step of 16 the dy tile is staged transposed and
// the slab tile [k][n], both read along f, their contiguous axis.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
gg_dx_f32(const float* __restrict__ dy, const float* __restrict__ w,
          const int* __restrict__ block_ids, float* __restrict__ dx,
          int block_m, int n_experts, int d, int f) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one output per thread");
  constexpr int BK = 16, COLS = BN / TN;
  __shared__ float s_a[BK][BM + 1];
  __shared__ float s_b[BK][BN + 1];
  const int tid = threadIdx.x, ty = tid / COLS, tx = tid % COLS;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int e = block_ids[row0 / block_m];
  const bool named = e >= 0 && e < n_experts;
  const float* wb = w + (size_t)(named ? e : 0) * d * f;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; named && k0 < f; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK;
      s_a[k][m] = k0 + k < f ? dy[(size_t)(row0 + m) * f + k0 + k] : 0.f;
    }
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int n = i / BK, k = i % BK;
      s_b[k][n] = n0 + n < d && k0 + k < f
                      ? wb[(size_t)(n0 + n) * f + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(s_a[k][ty * TM + i], s_b[k][tx * TN + j],
                           acc[i][j]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < d) dx[(size_t)(row0 + ty * TM + i) * d + c] = acc[i][j];
    }
}

// fp32 dW: one block per (expert, 64 x 64 tile of its gradient), FMAs,
// 4 x 4 a thread; walks block_ids in order and takes its expert's rows 8
// at a time (block_m is a multiple of 8).
__global__ void __launch_bounds__(THREADS)
gg_dw_f32(const float* __restrict__ x, const float* __restrict__ dy,
          const int* __restrict__ block_ids, float* __restrict__ dw,
          int n_blocks, int block_m, int d, int f) {
  constexpr int BM = 64, BN = 64, BK = 8, TM = 4, TN = 4, COLS = BN / TN;
  __shared__ float s_a[BK][BM];
  __shared__ float s_b[BK][BN];
  const int tid = threadIdx.x, ty = tid / COLS, tx = tid % COLS;
  const int tiles_n = (f + BN - 1) / BN;
  const int m0 = blockIdx.x / tiles_n * BM, n0 = blockIdx.x % tiles_n * BN;
  const int e = blockIdx.y;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) {
    if (block_ids[blk] != e) continue;        // the same for every thread
    for (int r0 = blk * block_m; r0 < (blk + 1) * block_m; r0 += BK) {
      for (int i = tid; i < BK * BM; i += THREADS) {
        const int k = i / BM, m = i % BM;
        s_a[k][m] = m0 + m < d ? x[(size_t)(r0 + k) * d + m0 + m] : 0.f;
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int k = i / BN, n = i % BN;
        s_b[k][n] = n0 + n < f ? dy[(size_t)(r0 + k) * f + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(s_a[k][ty * TM + i], s_b[k][tx * TN + j],
                             acc[i][j]);
      __syncthreads();
    }
  }
  float* dwe = dw + (size_t)e * d * f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (m < d && c < f) dwe[(size_t)m * f + c] = acc[i][j];
    }
  }
}

int launch_dx_bf16(const void* dy, const void* w, const void* ids, void* dx,
                   int t, int block_m, int n_experts, int d, int f,
                   int tile_m, int vector, cudaStream_t st) {
  if (tile_m == PM) {
    const dim3 grid(t / PM * ((d + PN - 1) / PN));
    return vector ? launch_mma(gg_dx_rows<true>, grid, DX_SMEM, dy, w, ids,
                               dx, block_m, n_experts, d, f, st)
                  : launch_mma(gg_dx_rows<false>, grid, DX_SMEM, dy, w, ids,
                               dx, block_m, n_experts, d, f, st);
  }
  if (tile_m == TR) {
    const dim3 grid(t / TR, (d + TF - 1) / TF);
    return vector ? launch_mma(gg_dx_tick<true>, grid, DXT_SMEM, dy, w, ids,
                               dx, block_m, n_experts, d, f, st)
                  : launch_mma(gg_dx_tick<false>, grid, DXT_SMEM, dy, w, ids,
                               dx, block_m, n_experts, d, f, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool VEC, int KP>
int launch_dw_tile(const void* x, const void* dy, const void* ids, void* dw,
                   int n_blocks, int block_m, int n_experts, int d, int f,
                   cudaStream_t st) {
  auto kernel = gg_dw<VEC, KP>;
  const int smem = DwTile<KP>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((d + DM - 1) / DM) * ((f + DN - 1) / DN), n_experts);
  kernel<<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const int*>(ids), static_cast<bf16*>(dw), n_blocks, block_m,
      d, f);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw_bf16(const void* x, const void* dy, const void* ids, void* dw,
                   int t, int block_m, int n_experts, int d, int f,
                   int vector, cudaStream_t st) {
  const int n_blocks = t / block_m;
  if (block_m % 32 == 0)
    return vector ? launch_dw_tile<true, 32>(x, dy, ids, dw, n_blocks,
                                             block_m, n_experts, d, f, st)
                  : launch_dw_tile<false, 32>(x, dy, ids, dw, n_blocks,
                                              block_m, n_experts, d, f, st);
  if (block_m % 8 == 0)
    return vector ? launch_dw_tile<true, 8>(x, dy, ids, dw, n_blocks,
                                            block_m, n_experts, d, f, st)
                  : launch_dw_tile<false, 8>(x, dy, ids, dw, n_blocks,
                                             block_m, n_experts, d, f, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_dx_f32(const void* dy, const void* w, const void* ids, void* dx,
                  int t, int block_m, int n_experts, int d, int f,
                  int tile_m, cudaStream_t st) {
  auto* yp = static_cast<const float*>(dy);
  auto* wp = static_cast<const float*>(w);
  auto* ip = static_cast<const int*>(ids);
  auto* op = static_cast<float*>(dx);
  if (tile_m == 64)
    gg_dx_f32<64, 64, 4, 4><<<dim3(t / 64, (d + 63) / 64), THREADS, 0, st>>>(
        yp, wp, ip, op, block_m, n_experts, d, f);
  else if (tile_m == 8)
    gg_dx_f32<8, 128, 1, 4><<<dim3(t / 8, (d + 127) / 128), THREADS, 0, st>>>(
        yp, wp, ip, op, block_m, n_experts, d, f);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw_f32(const void* x, const void* dy, const void* ids, void* dw,
                  int t, int block_m, int n_experts, int d, int f,
                  cudaStream_t st) {
  if (block_m % 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((d + 63) / 64) * ((f + 63) / 64), n_experts);
  gg_dw_f32<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const int*>(ids), static_cast<float*>(dw), t / block_m,
      block_m, d, f);
  return static_cast<int>(cudaGetLastError());
}


// -------------------------------------------------------------------------
// bf16 backward on Hopper (route "sm90"): wgmma fed by TMA through an
// mbarrier ring, persistent blocks; the design is in the note at the top.
// -------------------------------------------------------------------------
namespace sm90 {

constexpr int CONSUMERS = 2;       // consumer warpgroups, 64 tile rows each
constexpr int BN = 256;            // tile columns: the wgmma's N
constexpr int BK = 64;             // K step: one 128-byte swizzle row of bf16
constexpr int STAGES = 3;          // depth of the TMA ring
constexpr int BM = 64 * CONSUMERS;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + one producer warpgroup
constexpr int BOX_BYTES = 64 * BK * 2;          // one 64 x 64 TMA box
constexpr int B_BYTES = BN * BK * 2;            // the shared B operand
constexpr int STAGE_BYTES = CONSUMERS * BOX_BYTES + B_BYTES;
constexpr int OUT_BYTES = 64 * BN * 2;          // a warpgroup's staged sums
// 40 + 2 x 232 = 3 x 168, the registers a thread that __launch_bounds__
// (384, 1) leaves: the producer gives back what the accumulators take
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ALIGN = 1024;        // 128-byte swizzled tiles start on 1 KB

// One ring stage's work, written by the producer before the stage's
// arrival: the tile (dX: its first token row; dW: its first row of d),
// its first column, the expert, and flags; bits 4.. hold how many
// consumer warpgroups the tile has rows for (dX's half tiles: 1).
struct Item {
  int row0, n0, e, flags;
};
constexpr int FIRST = 1, LAST = 2, ZERO = 4, DONE = 8, SPAN = 4;

// The flags of stage k of a tile's `steps`.
__device__ __forceinline__ int stage_flags(int k, int steps, int span) {
  return (k == 0 ? FIRST : 0) | (k == steps - 1 ? LAST : 0) | span << SPAN;
}

constexpr int smem_bytes(int extra_ints) {
  return ALIGN + STAGES * STAGE_BYTES + CONSUMERS * OUT_BYTES +
         STAGES * (16 + (int)sizeof(Item)) + 4 * extra_ints;
}

struct Smem {
  unsigned char* ring;  // [STAGES][CONSUMERS A boxes | B], on 1,024 bytes
  unsigned char* out;   // [CONSUMERS] bf16 tiles for the TMA stores
  uint64_t* full;       // [STAGES] TMA bytes landed (one arrival: producer)
  uint64_t* empty;      // [STAGES] released (an arrival a consumer warp)
  Item* items;          // [STAGES]
  int* ints;            // dW: the experts' chunk counts
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem s;
  s.ring = raw + (ALIGN - wg::smem_u32(raw) % ALIGN) % ALIGN;
  s.out = s.ring + STAGES * STAGE_BYTES;
  s.full = reinterpret_cast<uint64_t*>(s.out + CONSUMERS * OUT_BYTES);
  s.empty = s.full + STAGES;
  s.items = reinterpret_cast<Item*>(s.empty + STAGES);
  s.ints = reinterpret_cast<int*>(s.items + STAGES);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      wg::bar_init(&s.full[i], 1);
      wg::bar_init(&s.empty[i], CONSUMERS * 4);
    }
    wg::bar_fence_init();
  }
  return s;
}

// The expert of 64-row chunk c (block_m a multiple of 64).
__device__ __forceinline__ int chunk_id(const int* ids, int c, int block_m) {
  return __ldg(ids + (size_t)c * 64 / block_m);
}

// Producer side of the ring: stage `it` is free once both consumer
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

// A consumer's 64 x BN sums (or zeros) in bf16 into its staging tile, as
// BN / 64 swizzled boxes of 64 x 64 (conflict-free: the 8 rows a store
// instruction writes land in 8 different 16-byte columns).
__device__ __forceinline__ void stage_out(unsigned char* buf,
                                          const float (&acc)[BN / 2],
                                          bool zero) {
  const int t = threadIdx.x % 128, row = t / 32 * 16 + t % 32 / 4;
  const int col = t % 4 * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 v =
          zero ? __floats2bfloat162_rn(0.f, 0.f)
               : __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                       acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(
          buf + wg::sw128_offset(row + 8 * h, 8 * j + col, 64)) = v;
    }
}

// Consumer warpgroup `wgi`: takes the ring's items in order, multiplies
// its 64-row A box of each stage by the shared B (TR: both MN-major, else
// both K-major) into 64 x BN fp32 sums and releases the stage.  At a
// tile's last stage (or a tile of zeros) it stages the tile in shared
// memory and its first thread hands it to `epi`, which issues the TMA
// stores; the next tile's products start while they run (the staging
// tile is written again only once the stores have read it).
template <int TR, class Epilogue>
__device__ __forceinline__ void consume(const Smem& sm, int wgi,
                                        const Epilogue& epi) {
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  const bool signal = threadIdx.x % 32 == 0;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* buf = sm.out + wgi * OUT_BYTES;
  // a k16 step moves the descriptors 32 bytes along a K-major row, or 16
  // rows (2,048 bytes) down an MN-major box; in 16-byte units
  constexpr int STEP = TR ? 128 : 2;
  for (int it = 0;; ++it) {
    const int s = it % STAGES;
    wg::bar_wait(&sm.full[s], (it / STAGES) & 1);
    const Item m = sm.items[s];
    if (m.flags & DONE) break;
    const bool mine = wgi < m.flags >> SPAN;
    if (mine && !(m.flags & ZERO)) {
      const unsigned char* st = sm.ring + s * STAGE_BYTES;
      const unsigned char* a = st + wgi * BOX_BYTES;
      const unsigned char* b = st + CONSUMERS * BOX_BYTES;
      const uint64_t da = TR ? wg::desc_mn_major(a, BOX_BYTES)
                             : wg::desc_k_major(a);
      const uint64_t db = TR ? wg::desc_mn_major(b, BOX_BYTES)
                             : wg::desc_k_major(b);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wg::mma<BN, TR, TR>(acc, da + kk * STEP, db + kk * STEP,
                            kk > 0 || !(m.flags & FIRST));
      wg::commit();
      wg::wait<0>();
    }
    if (signal) wg::bar_arrive(&sm.empty[s]);
    if (mine && (m.flags & (LAST | ZERO))) {
      if (leader) wg::store_wait_read<0>();
      wg::warpgroup_sync(1 + wgi);         // the last tile's stores read buf
      stage_out(buf, acc, m.flags & ZERO);
      wg::fence_async();
      wg::warpgroup_sync(1 + wgi);
      if (leader) {
        epi(m, buf);
        wg::store_commit();
      }
    }
  }
  if (leader) wg::store_wait_all();
}

// The TMA stores of a consumer's staged tile: its 64 rows x BN columns
// from (row0 + 64 wgi, n0), one {64, 64} box a 64 columns; TMA leaves
// out what lies past the output's bounds, and boxes wholly past them are
// not issued.
struct DxEpilogue {
  const CUtensorMap* map;  // dx (t, d), boxes {64 d, 64 rows}
  int d, wgi;
  __device__ __forceinline__ void operator()(const Item& m,
                                             const unsigned char* buf) const {
    for (int b = 0; b < BN / 64 && m.n0 + 64 * b < d; ++b)
      wg::tma_store_2d(map, buf + b * BOX_BYTES, m.n0 + 64 * b,
                       m.row0 + wgi * 64);
  }
};

struct DwEpilogue {
  const CUtensorMap* map;  // dw (E, d, f), boxes {64 f, 64 d, 1}
  int d, f, wgi;
  __device__ __forceinline__ void operator()(const Item& m,
                                             const unsigned char* buf) const {
    if (m.row0 + wgi * 64 >= d) return;
    for (int b = 0; b < BN / 64 && m.n0 + 64 * b < f; ++b)
      wg::tma_store_3d(map, buf + b * BOX_BYTES, m.n0 + 64 * b,
                       m.row0 + wgi * 64, m.e);
  }
};

// dX = dY W[e]^T.  A: dy's rows (64 a warpgroup, K = f, K-major boxes
// {64 f, 64 rows}); B: W[e]'s (d, f) slab as it lies, N = d rows of
// K-major {64 f, BN d, 1} boxes.  Tile i of the static stride is row tile
// i / tiles_n (consecutive chunks of one id, at most CONSUMERS; an odd
// last one a half tile) and column tile i % tiles_n; the producer finds
// row tiles by walking the ids as it goes.
__global__ void __launch_bounds__(THREADS, 1)
gg_dx_sm90(const __grid_constant__ CUtensorMap dy_map,
           const __grid_constant__ CUtensorMap w_map,
           const __grid_constant__ CUtensorMap dx_map,
           const int* __restrict__ block_ids, int n_chunks, int block_m,
           int n_experts, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == CONSUMERS) {
    wg::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x % 128) return;
    wg::prefetch_map(&dy_map);
    wg::prefetch_map(&w_map);
    const int tiles_n = (d + BN - 1) / BN, ksteps = (f + BK - 1) / BK;
    auto span_at = [&](int c) {
      const int e = chunk_id(block_ids, c, block_m);
      int n = 1;
      while (n < CONSUMERS && c + n < n_chunks &&
             chunk_id(block_ids, c + n, block_m) == e)
        ++n;
      return n;
    };
    int it = 0, c = 0, r = 0, span = span_at(0);
    for (int i = blockIdx.x;; i += gridDim.x) {
      for (; r < i / tiles_n && c < n_chunks; ++r) {
        c += span;
        if (c < n_chunks) span = span_at(c);
      }
      if (c >= n_chunks) break;
      const int e = chunk_id(block_ids, c, block_m), n0 = i % tiles_n * BN;
      if (e < 0 || e >= n_experts) {
        push_plain(sm, it++, Item{c * 64, n0, e, ZERO | span << SPAN});
        continue;
      }
      for (int k = 0; k < ksteps; ++k, ++it) {
        const int s = acquire(sm, it);
        sm.items[s] = Item{c * 64, n0, e, stage_flags(k, ksteps, span)};
        unsigned char* st = sm.ring + s * STAGE_BYTES;
        wg::bar_arrive_expect_tx(&sm.full[s], span * BOX_BYTES + B_BYTES);
        for (int h = 0; h < span; ++h)
          wg::tma_load_2d(st + h * BOX_BYTES, &dy_map, &sm.full[s], k * BK,
                          (c + h) * 64);
        wg::tma_load_3d(st + CONSUMERS * BOX_BYTES, &w_map, &sm.full[s],
                        k * BK, n0, e);
      }
    }
    push_plain(sm, it, Item{0, 0, 0, DONE});
  } else {
    wg::reg_alloc<CONSUMER_REGS>();
    consume<0>(sm, wgi, DxEpilogue{&dx_map, d, wgi});
  }
}

// dW[e] = sum over e's chunks of x_c^T dy_c, in chunk order.  A: x's rows
// as they lie, an MN-major {64 d, 64 rows} box a warpgroup (M = d, K =
// rows); B: dy's rows, BN / 64 MN-major {64 f, 64 rows} boxes side by
// side (N = f).  Tile i of the static stride is tile i % per of expert
// i / per; every block first counts each expert's chunks.  A producer
// warp finds an expert's chunks by ballots over the ids in order.
__global__ void __launch_bounds__(THREADS, 1)
gg_dw_sm90(const __grid_constant__ CUtensorMap x_map,
           const __grid_constant__ CUtensorMap dy_map,
           const __grid_constant__ CUtensorMap dw_map,
           const int* __restrict__ block_ids, int n_chunks, int block_m,
           int n_experts, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  int* counts = sm.ints;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < n_experts; e += THREADS / 32) {
    int n = 0;
    for (int c0 = 0; c0 < n_chunks; c0 += 32) {
      const int c = c0 + lane;
      n += __popc(__ballot_sync(
          ~0u, c < n_chunks && chunk_id(block_ids, c, block_m) == e));
    }
    if (lane == 0) counts[e] = n;
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == CONSUMERS) {
    wg::reg_dealloc<PRODUCER_REGS>();
    if (warp != CONSUMERS * 4) return;
    if (lane == 0) {
      wg::prefetch_map(&x_map);
      wg::prefetch_map(&dy_map);
    }
    const int tiles_n = (f + BN - 1) / BN;
    const int per = (d + BM - 1) / BM * tiles_n;
    int it = 0;
    for (int i = blockIdx.x; i < n_experts * per; i += gridDim.x) {
      const int e = i / per, m0 = i % per / tiles_n * BM,
                n0 = i % per % tiles_n * BN, nk = counts[e];
      if (nk == 0) {
        if (lane == 0)
          push_plain(sm, it, Item{m0, n0, e, ZERO | CONSUMERS << SPAN});
        ++it;
        continue;
      }
      int k = 0;
      for (int c0 = 0; k < nk && c0 < n_chunks; c0 += 32) {
        unsigned hits = __ballot_sync(
            ~0u, c0 + lane < n_chunks &&
                     chunk_id(block_ids, c0 + lane, block_m) == e);
        for (; hits; hits &= hits - 1, ++k, ++it) {
          if (lane) continue;
          const int row = (c0 + __ffs(hits) - 1) * 64;
          const int s = acquire(sm, it);
          sm.items[s] = Item{m0, n0, e, stage_flags(k, nk, CONSUMERS)};
          unsigned char* st = sm.ring + s * STAGE_BYTES;
          wg::bar_arrive_expect_tx(&sm.full[s], STAGE_BYTES);
          for (int h = 0; h < CONSUMERS; ++h)
            wg::tma_load_2d(st + h * BOX_BYTES, &x_map, &sm.full[s],
                            m0 + h * 64, row);
          for (int q = 0; q < BN / 64; ++q)
            wg::tma_load_2d(st + (CONSUMERS + q) * BOX_BYTES, &dy_map,
                            &sm.full[s], n0 + q * 64, row);
        }
      }
    }
    if (lane == 0) push_plain(sm, it, Item{0, 0, 0, DONE});
  } else {
    wg::reg_alloc<CONSUMER_REGS>();
    consume<1>(sm, wgi, DwEpilogue{&dw_map, d, f, wgi});
  }
}

template <typename Kernel>
int launch(Kernel kernel, const CUtensorMap& a, const CUtensorMap& b,
           const CUtensorMap& out, const void* ids, int t, int block_m,
           int n_experts, int d, int f, int smem, int sms, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<sms, THREADS, smem, st>>>(a, b, out, static_cast<const int*>(ids),
                                     t / 64, block_m, n_experts, d, f);
  return static_cast<int>(cudaGetLastError());
}

// The row-major (rows, cols) bf16 matrix at `p` as TMA boxes {64, 64}.
int rows_map(CUtensorMap* map, const void* p, int rows, int cols) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, 64};
  return wg::make_map_bf16(map, p, 2, dims, strides, box);
}

// The (E, rows, cols) bf16 slabs at `p` as boxes {64, box_rows, 1}: a box
// never reaches into the next slab.
int slabs_map(CUtensorMap* map, const void* p, int n, int rows, int cols,
              int box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)n};
  const uint64_t strides[2] = {(uint64_t)cols * 2, (uint64_t)rows * cols * 2};
  const uint32_t box[3] = {64, (uint32_t)box_rows, 1};
  return wg::make_map_bf16(map, p, 3, dims, strides, box);
}

int launch_dx(const void* dy, const void* w, const void* ids, void* dx, int t,
              int block_m, int n_experts, int d, int f, int sms,
              cudaStream_t st) {
  CUtensorMap dy_map, w_map, dx_map;
  int err = rows_map(&dy_map, dy, t, f);
  if (!err) err = slabs_map(&w_map, w, n_experts, d, f, BN);
  if (!err) err = rows_map(&dx_map, dx, t, d);
  if (err) return err;
  return launch(gg_dx_sm90, dy_map, w_map, dx_map, ids, t, block_m,
                n_experts, d, f, smem_bytes(0), sms, st);
}

int launch_dw(const void* x, const void* dy, const void* ids, void* dw, int t,
              int block_m, int n_experts, int d, int f, int sms,
              cudaStream_t st) {
  CUtensorMap x_map, dy_map, dw_map;
  int err = rows_map(&x_map, x, t, d);
  if (!err) err = rows_map(&dy_map, dy, t, f);
  if (!err) err = slabs_map(&dw_map, dw, n_experts, d, f, 64);
  if (err) return err;
  return launch(gg_dw_sm90, x_map, dy_map, dw_map, ids, t, block_m,
                n_experts, d, f, smem_bytes(n_experts), sms, st);
}

}  // namespace sm90

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
  return launch_bf16(x, w, block_ids, out, t, block_m, n_experts, d, f,
                     tile_m, vector, static_cast<cudaStream_t>(stream));
}

extern "C" int grouped_gemm_f32(const void* x, const void* w,
                                const void* block_ids, void* out, int t,
                                int block_m, int n_experts, int d, int f,
                                int tile_m, int vector, void* stream) {
  return launch_f32(x, w, block_ids, out, t, block_m, n_experts, d, f,
                    tile_m, vector, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one bf16 block of row tile `tile_m` (bytes).
extern "C" int grouped_gemm_smem(int tile_m) {
  return tile_m == PM ? P_SMEM : tile_m == TR ? T_SMEM : -1;
}

// The backward's two entry points, each returning the CUDA error code of
// its launch.  dX: dy (t, f), w (n_experts, d, f), block_ids (t / block_m,)
// -> dx (t, d), row tile `tile_m` as in the forward.  dW: x (t, d), dy
// (t, f), block_ids -> dw (n_experts, d, f), every expert written (zeros
// for one that owns no block); block_m a multiple of 8.  `vector` as in
// the forward, for the two bf16 inputs of each.
extern "C" int grouped_gemm_dx_bf16(const void* dy, const void* w,
                                    const void* block_ids, void* dx, int t,
                                    int block_m, int n_experts, int d, int f,
                                    int tile_m, int vector, void* stream) {
  return launch_dx_bf16(dy, w, block_ids, dx, t, block_m, n_experts, d, f,
                        tile_m, vector, static_cast<cudaStream_t>(stream));
}

extern "C" int grouped_gemm_dx_f32(const void* dy, const void* w,
                                   const void* block_ids, void* dx, int t,
                                   int block_m, int n_experts, int d, int f,
                                   int tile_m, int vector, void* stream) {
  (void)vector;                          // element loads
  return launch_dx_f32(dy, w, block_ids, dx, t, block_m, n_experts, d, f,
                       tile_m, static_cast<cudaStream_t>(stream));
}

extern "C" int grouped_gemm_dw_bf16(const void* x, const void* dy,
                                    const void* block_ids, void* dw, int t,
                                    int block_m, int n_experts, int d, int f,
                                    int vector, void* stream) {
  return launch_dw_bf16(x, dy, block_ids, dw, t, block_m, n_experts, d, f,
                        vector, static_cast<cudaStream_t>(stream));
}

extern "C" int grouped_gemm_dw_f32(const void* x, const void* dy,
                                   const void* block_ids, void* dw, int t,
                                   int block_m, int n_experts, int d, int f,
                                   int vector, void* stream) {
  (void)vector;
  return launch_dw_f32(x, dy, block_ids, dw, t, block_m, n_experts, d, f,
                       static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one bf16 backward block (bytes): dX at row tile
// `tile_m`, or dW at a block_m of `tile_m` rows.
extern "C" int grouped_gemm_bwd_smem(int dw, int tile_m) {
  if (dw) return tile_m % 32 == 0 ? DwTile<32>::SMEM : DwTile<8>::SMEM;
  return tile_m == PM ? DX_SMEM : tile_m == TR ? DXT_SMEM : -1;
}

// The bf16 backward on Hopper (route "sm90"): dX and dW as above, for
// block_m a multiple of 64, d and f multiples of 8 and every base on 16
// bytes (TMA's rules); `sms` persistent blocks.  Returns the CUDA error
// code of the launch, or of the tensor maps' encoding (0 on success).
extern "C" int grouped_gemm_dx_sm90(const void* dy, const void* w,
                                    const void* block_ids, void* dx, int t,
                                    int block_m, int n_experts, int d, int f,
                                    int sms, void* stream) {
  return sm90::launch_dx(dy, w, block_ids, dx, t, block_m, n_experts, d, f,
                         sms, static_cast<cudaStream_t>(stream));
}

extern "C" int grouped_gemm_dw_sm90(const void* x, const void* dy,
                                    const void* block_ids, void* dw, int t,
                                    int block_m, int n_experts, int d, int f,
                                    int sms, void* stream) {
  return sm90::launch_dw(x, dy, block_ids, dw, t, block_m, n_experts, d, f,
                         sms, static_cast<cudaStream_t>(stream));
}

// The sm90 kernels' shape: out[0..5] = tile rows, tile columns, K step,
// ring stages, threads a block, bytes a stage; returns the dynamic shared
// memory of a dX block (dw 0) or of a dW block over n_experts (dw 1).
extern "C" int grouped_gemm_sm90_plan(int dw, int n_experts, int* out) {
  const int shape[6] = {sm90::BM, sm90::BN, sm90::BK, sm90::STAGES,
                        sm90::THREADS, sm90::STAGE_BYTES};
  for (int i = 0; i < 6; ++i) out[i] = shape[i];
  return sm90::smem_bytes(dw ? n_experts : 0);
}
