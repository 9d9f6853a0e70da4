// K5: blockwise online-softmax attention forward, the port of
// src/repro/kernels/flash_attention.py::flash_attention_fwd (Pallas body
// `_fwd_kernel`).
//
// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), row-major, fp32 or bf16.
// Returns o (B, H, Sq, D) in q's type and lse (B, H, Sq) in fp32.  GQA by
// kv head = h / (H / Hkv); causal mask kpos <= qpos with no Sk - Sq offset,
// as the Pallas kernel; keys at or past Sk masked; the softmax in fp32 with
// the reference's -1e30 sentinel for masked scores.
//
// What bounds it: operations.  At the serving prefill shape (B = 1,
// H = 32, Hkv = 4, D = 64, S = 1024, causal) the work is
// 4 * D * H * S (S + 1) / 2 = 4.3 GFLOP against ~9 MB of traffic; on an
// NVIDIA H100 SXM at its 700 W limit (data-sheet peaks: 989 TFLOP/s bf16
// on the tensor cores, 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s)
// that is 4.4 us of tensor-core work and 2.7 us of traffic.
//
// bf16 (flash_fwd_mma_kernel): FlashAttention-2 on `mma.sync`.  Four warps
// take a 64-row query tile of one (b, h), 16 rows a warp, and a block
// holds two such heads of one GQA group (one where the group is odd), so
// each K and V tile read from L2 serves 128 query rows; each warp holds
// its Q rows in registers as A fragments for the whole key loop.  K and V
// tiles of 64 keys arrive through a double-buffered `cp.async` ring, so
// the next tile's copy overlaps this tile's products.  S = Q K^T runs on
// the tensor cores (K through plain `ldmatrix`); the online softmax works
// on the fp32 accumulator fragments in log2 units (the scale and log2(e)
// folded into one FMA before exp2), row max and row sum across the 4
// lanes of a quad by shuffles.  P V takes P from registers as A fragments
// and V through `ldmatrix.trans`.  The reference multiplies P V with fp32
// weights; a bf16 P would move each weight by up to 2^-9 of itself, so
// each p is split into p_hi (its top 16 bits, exact) and p_lo =
// bf16(p - p_hi) and both are multiplied (about 16 significant bits, a
// third more tensor-core work): o then differs from the plain version by
// the order of the fp32 sums and its one final rounding.  Key tiles wholly
// above the diagonal are not visited (nor, by a warp, tiles wholly above
// its own 16 rows), the diagonal tile and the Sk tail are masked, and the
// heaviest query tiles (the last ones under the causal mask) start first.
// Up to D = 64 a thread keeps to 128 registers, so 16 warps share an SM.
//
// fp32 (flash_fwd_kernel): fp32 FMAs on the CUDA cores (a tensor-core
// product would be TF32; ~64 us at that shape at best).  One 256-thread block per
// (b, h, 64-row query tile).  The query tile is staged once in shared
// memory, transposed (d-major), so that each thread reads its 4 rows as
// one float4 per d.  The loop over 64-row key tiles replaces the Pallas
// kernel's sequential grid axis: each K tile is staged transposed and each
// V tile row-major.  A thread owns a 4 x 4 block of the 64 x 64 score tile
// (rows ty*4.., keys tx*4..) and a 4 x D/16 block of the output; row max
// and row sum are reduced across the 16 threads of a row group by xor
// shuffles.  The running max, running sum and the fp32 accumulator stay
// in registers across key tiles.  P goes through shared memory
// (transposed) to the P V product.  Key tiles wholly above the diagonal
// are not visited; the diagonal tile and the ragged tail are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BQ = 64;          // fp32: query rows per block
constexpr int BK = 64;          // fp32: key rows per tile
constexpr int PAD = 4;          // fp32: keeps float4 alignment, spreads banks
constexpr int LD = BQ + PAD;    // fp32: leading dim of the transposed tiles
constexpr int THREADS = 256;    // fp32: 16 row groups x 16 column groups
constexpr int MQ = 64;          // bf16: query rows per block and head
constexpr int KT = 64;          // bf16: keys per tile
constexpr int KV_STAGES = 2;    // bf16: depth of the K/V cp.async ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

template <int D>
constexpr int smem_floats() {
  // sQt (D x LD) + sKt (D x LD) + sV (BK x D) + sPt (BK x LD)
  return 2 * D * LD + BK * D + BK * LD;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                 int causal, float scale) {
  constexpr int DPT = D / 16;                 // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                          // [D][LD]
  float* sKt = sQt + D * LD;                  // [D][LD]
  float* sV = sKt + D * LD;                   // [BK][D]
  float* sPt = sV + BK * D;                   // [BK][LD]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qb = q + ((size_t)b * H + h) * Sq * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    sQt[c * LD + r] = row < Sq ? to_f(qb[(size_t)row * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                          // last tile's readers done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int row = k0 + r;
      const bool in = row < Sk;
      sKt[c * LD + r] = in ? to_f(kb[(size_t)row * D + c]) : 0.f;
      sV[r * D + c] = in ? to_f(vb[(size_t)row * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&sQt[c * LD + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&sKt[c * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mb = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mb = fmaxf(mb, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_new = fmaxf(m[i], mb);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sPt[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int c_end = min(BK, k_end - k0);
    for (int c = 0; c < c_end; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sPt[c * LD + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[DPT];
      if constexpr (DPT % 4 == 0) {
#pragma unroll
        for (int e = 0; e < DPT; e += 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(&sV[c * D + tx * DPT + e]);
          vv[e] = t.x;
          vv[e + 1] = t.y;
          vv[e + 2] = t.z;
          vv[e + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < DPT; ++e) vv[e] = sV[c * D + tx * DPT + e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (((size_t)b * H + h) * Sq + row) * D + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) orow[e] = from_f<T>(acc[i][e] / ls);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + row] = m[i] + logf(ls);
  }
}

using bf16 = __nv_bfloat16;

template <int D, int HPC>
constexpr int mma_smem_bytes() {
  // sQ (MQ rows of HPC heads) + sK and sV (KV_STAGES stages of KT rows
  // each), pitch D + PAD
  return (HPC * MQ + 2 * KV_STAGES * KT) * (D + mma::PAD) *
         (int)sizeof(bf16);
}

// 2^x in one special-function instruction (relative error ~2^-22,
// subnormal results flushed to 0): softmax weights, whose sums are fp32.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p -> (hi, lo) for two neighbouring weights, packed as A-fragment
// registers: hi = p cut to its bf16 top half (exact), lo = bf16(p - hi),
// so hi + lo carries p to ~2^-16 of itself.
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(p0), u1 = __float_as_uint(p1);
  hi = __byte_perm(u0, u1, 0x7632);           // the top halves of both
  lo = mma::as_u32(__floats2bfloat162_rn(
      p0 - __uint_as_float(u0 & 0xffff0000u),
      p1 - __uint_as_float(u1 & 0xffff0000u)));
}

// One warp's step over a 64-key tile: its 16 x 64 scores on the tensor
// cores, the online softmax of its rows g and g + 8 (m in log2 units, l
// this lane's columns only), and o += P V with P split into bf16 hi + lo.
template <int D>
__device__ __forceinline__ void tile_step(const bf16* cK, const bf16* cV,
                                          const uint32_t (&qf)[D / 16][4],
                                          float (&m)[2], float (&l)[2],
                                          float (&acc)[D / 8][4], int k0,
                                          int row0, int Sk, int causal,
                                          float scale2, int lane) {
  constexpr int LDS = D + mma::PAD;
  constexpr int KD = D / 16;                  // k-steps of Q K^T
  constexpr int NT = D / 8;                   // n8 tiles of the output
  constexpr int NS = KT / 8;                  // n8 tiles of a score tile
  const int g = lane >> 2, t4 = lane & 3;

  float s[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    uint32_t r[NS / 2][4];                    // K fragments, then products
#pragma unroll
    for (int np = 0; np < NS / 2; ++np)
      mma::ldmatrix_x4(r[np], cK + mma::b_offset_nk(lane, np * 16, kd * 16,
                                                    LDS));
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      mma::mma_bf16(s[2 * np], qf[kd], r[np][0], r[np][1]);
      mma::mma_bf16(s[2 * np + 1], qf[kd], r[np][2], r[np][3]);
    }
  }

  // scores stay unscaled until the exp2 below (a max commutes with a
  // positive scale); a scale <= 0 is applied here instead
  float fold = scale2;
  if (!(scale2 > 0.f)) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    fold = 1.f;
  }
  // mask the Sk tail and, under the causal mask, keys past the query
  // (only where this tile reaches them)
  const bool edge = k0 + KT > Sk || (causal && k0 + KT - 1 > row0);
  if (edge) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
        const int qpos = row0 + g + (e >> 1) * 8;
        if (kpos >= Sk || (causal && kpos > qpos)) s[j][e] = NEG_INF;
      }
  }

  // online softmax on rows g (r = 0) and g + 8 (r = 1); a quad holds a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mb = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      mb = fmaxf(mb, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
    const float m_new = fmaxf(m[r], mb * fold);
    const float alpha = ex2(m[r] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], fold, -m_new));
        rs += s[j][e];
      }
    l[r] = l[r] * alpha + rs;               // this lane's columns only
    m[r] = m_new;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][2 * r] *= alpha;
      acc[j][2 * r + 1] *= alpha;
    }
  }

  // o += (p_hi + p_lo) V, P from the score fragments
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    uint32_t ph[4], pl[4];
    split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
    split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
    split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
    split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
    uint32_t r[NT / 2][4];                    // V fragments
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp)
      mma::ldmatrix_x4_trans(r[dp], cV + mma::b_offset_kn(lane, dp * 16,
                                                          kk * 16, LDS));
    // the hi products over every n8 tile, then the lo ones: two products
    // into one accumulator stand NT products apart
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      mma::mma_bf16(acc[2 * dp], ph, r[dp][0], r[dp][1]);
      mma::mma_bf16(acc[2 * dp + 1], ph, r[dp][2], r[dp][3]);
    }
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      mma::mma_bf16(acc[2 * dp], pl, r[dp][0], r[dp][1]);
      mma::mma_bf16(acc[2 * dp + 1], pl, r[dp][2], r[dp][3]);
    }
  }
}

// HPC query heads of one GQA group per block, 4 warps of 16 rows each,
// over one K/V stream.  ASYNC: q, k and v 16-byte aligned (rows of D >= 16
// bf16 then are too); else their tiles are staged by element loads.
template <int D, int HPC, bool ASYNC>
__global__ void __launch_bounds__(HPC * MQ * 2, D <= 64 ? 4 / HPC : 1)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     int causal, float scale) {
  constexpr int THREADS_ = HPC * MQ * 2;      // 32 threads per 16 rows
  constexpr int LDS = D + mma::PAD;           // shared tile pitch
  constexpr int KD = D / 16;                  // k-steps of Q K^T
  constexpr int NT = D / 8;                   // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);    // [HPC][MQ][LDS]
  bf16* sK = sQ + HPC * MQ * LDS;             // [KV_STAGES][KT][LDS]
  bf16* sV = sK + KV_STAGES * KT * LDS;       // [KV_STAGES][KT][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hj = warp / (MQ / 16), wq = warp % (MQ / 16);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MQ;  // heaviest tiles first
  const int h0 = blockIdx.y * HPC, h = h0 + hj, b = blockIdx.z;
  const int hk = h0 / (H / Hkv);
  const bf16* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * Sk * D;
  const int row0 = q0 + wq * 16;              // this warp's first query row
  const float scale2 = scale * LOG2E;         // scores in log2 units

  const int k_end = causal ? min(Sk, q0 + MQ) : Sk;
  const int n_tiles = (k_end + KT - 1) / KT;
#pragma unroll
  for (int j = 0; j < HPC; ++j)
    mma::load_tile<MQ, D, THREADS_, ASYNC>(
        sQ + j * MQ * LDS, q + ((size_t)b * H + h0 + j) * Sq * D, q0, 0, Sq,
        D, D, tid);
  // the first KV_STAGES - 1 tiles (Q in the first group)
  auto load_kv = [&](int it) {
    const int st = (it % KV_STAGES) * KT * LDS;
    mma::load_tile<KT, D, THREADS_, ASYNC>(sK + st, kb, it * KT, 0, Sk, D, D,
                                           tid);
    mma::load_tile<KT, D, THREADS_, ASYNC>(sV + st, vb, it * KT, 0, Sk, D, D,
                                           tid);
  };
#pragma unroll
  for (int it = 0; it < KV_STAGES - 1; ++it) {
    if (it < n_tiles) load_kv(it);
    mma::cp_async_commit();
  }

  uint32_t qf[KD][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    mma::cp_async_wait<KV_STAGES - 2>();      // this tile (and Q) arrived,
    __syncthreads();                          // the oldest stage is free
    if (it + KV_STAGES - 1 < n_tiles)         // the next tiles, in flight
      load_kv(it + KV_STAGES - 1);
    mma::cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        mma::ldmatrix_x4(qf[kd], sQ + hj * MQ * LDS +
                                     mma::a_offset(lane, wq * 16, kd * 16,
                                                   LDS));
    }
    const bf16* cK = sK + (it % KV_STAGES) * KT * LDS;
    const bf16* cV = sV + (it % KV_STAGES) * KT * LDS;
    if (!causal || k0 <= row0 + 15)           // else above all its rows
      tile_step<D>(cK, cV, qf, m, l, acc, k0, row0, Sk, causal, scale2, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + g + 8 * r;
    if (row >= Sq) continue;
    const float ls = l[r] == 0.f ? 1.f : l[r];
    bf16* orow = o + (((size_t)b * H + h) * Sq + row) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] / ls, acc[j][2 * r + 1] / ls);
    if (t4 == 0)                              // back to natural units
      lse[((size_t)b * H + h) * Sq + row] =
          m[r] == NEG_INF ? NEG_INF : m[r] * LN2 + logf(ls);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
               float scale, cudaStream_t st) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<float, D><<<grid, THREADS, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int HPC, bool ASYNC>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
               float scale, cudaStream_t st) {
  constexpr int bytes = mma_smem_bytes<D, HPC>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D, HPC, ASYNC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + MQ - 1) / MQ, H / HPC, B);
  flash_fwd_mma_kernel<D, HPC, ASYNC><<<grid, HPC * MQ * 2, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// Two query heads per block where the GQA group allows it (they share
// each K/V tile); 16-byte copies where the inputs are aligned.
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
                float scale, cudaStream_t st) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const bool pair = (H / Hkv) % 2 == 0;
#define FLASH_MMA(HPC, ASYNC)                                                \
  launch_mma<D, HPC, ASYNC>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal,     \
                            scale, st)
  if (pair) return aligned ? FLASH_MMA(2, true) : FLASH_MMA(2, false);
  return aligned ? FLASH_MMA(1, true) : FLASH_MMA(1, false);
#undef FLASH_MMA
}

template <bool BF16>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
           float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_D(DD)                                                          \
  case DD:                                                                   \
    return BF16 ? launch_bf16<DD>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,        \
                                  causal, scale, st)                         \
                : launch_f32<DD>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal, \
                                 scale, st);
  switch (D) {
    FLASH_D(16)
    FLASH_D(32)
    FLASH_D(64)
    FLASH_D(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_D
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int Hkv, int Sq, int Sk,
                                        int D, int causal, float scale,
                                        void* stream) {
  return launch<true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D, causal, scale,
                      stream);
}

extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int H, int Hkv, int Sq, int Sk,
                                       int D, int causal, float scale,
                                       void* stream) {
  return launch<false>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D, causal, scale,
                       stream);
}
