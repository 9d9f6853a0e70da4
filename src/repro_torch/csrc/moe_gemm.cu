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
// 2,048 tokens, top 6: 832 blocks of 64 rows, 49,152 token copies, d 2048,
// f 1408): each product is 2 x 49,152 x 2,048 x 1,408 = 283 GFLOP (0.29 ms
// at 989 TFLOP/s) against 0.5-0.7 GB of rows and slabs (0.15-0.22 ms):
// operations.  Design, simple first:
//   gg_dx_rows / gg_dx_tick: the forward's two row tiles with the slab
//     read the other way round: W[e]'s row-major (d, f) storage is the
//     (N, K) layout of an mma B operand (rows) or the (M, K) layout of an
//     A operand (tick, dx^T = W dY^T), so both load by plain `ldmatrix`.
//   gg_dw: one block per (expert, 64 x 128 tile of dW[e]); it walks
//     block_ids in order and accumulates only its own expert's blocks,
//     both operands by `ldmatrix.trans`.  No atomics, a fixed order: two
//     launches give the same bits.  Experts own 0 to ~20 blocks, so the
//     blocks' work is uneven.
//   fp32: FMA kernels, as the forward's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

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
