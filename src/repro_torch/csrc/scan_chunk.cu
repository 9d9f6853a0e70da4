// K2: the uncoupled chunk step of the trace-scan engine, for Hopper.
//
// Replaces `_scan_chunk_jax_impl` in src/repro/core/engine_jax.py, the
// `jax.lax.scan` that XLA compiles for every plain trace sweep (the
// reference has no Pallas source for it; PyTorch has no compiled scan,
// and the slot loop in plain tensor ops costs ~40 launches per slot).
//
// Computation: one thread per scan lane runs the chunk's slot loop with
// the carried state (remaining, runtime, kWh, cost) in registers.  The
// decision row is gathered from the lane's (R, B) tables by `rowidx`
// with the reference's two-point progress lookup (`_bucket_lookup`:
// (1-w)*u[b0] + w*u[b0+1]), and B == 1 reads the single bucket.  A lane
// whose work is done (remaining <= 0) stops its arithmetic: every later
// slot of the reference is a no-op for it (dt = 0).
//
// What bounds it on an NVIDIA H100 80GB HBM3 at 700.00 W, measured
// (PERF.md §5, `python -m repro_torch.kernels.ablate`):
// The first design read each lane-major (A, C) series one element a slot,
// so a warp's load touched 32 sectors 768 B apart, and no slot's loads
// were in flight while the fp64 chain of the slot before ran.  On the
// ablation's full chunk (A 100,000, C 96, every lane all 96 slots) it
// took 2.063 ms in fp64, 0.281 with the series loads replaced by
// constants and 1.354 with the physics removed: the loads set its time.
// Staged in 32-byte pieces of a row, the series still stream slowly
// (isolated sectors: 0.377 ms for the chunk, "alt: 32-byte rows");
// in 64-byte pieces the physics (two `pow` and four divisions a
// lane-slot) and the loads each take about 0.2 ms of it and overlap
// (0.286 ms).
//
// Design:
// - A block's 128 lanes (64 or 32 when the lanes would otherwise fill
//   fewer blocks than the card has SMs, `launch_plan`) are one contiguous
//   region of every lane-major array.  Tiles of W slots, 64 bytes of a
//   row (W = 8 in fp64, 16 in fp32), of `rowidx`, `bg`, `pr`, `lens` and
//   (E <= 4) `cf` go global -> shared by 16-byte `cp.async` copies,
//   neighbouring threads on neighbouring chunks, in a ring of two
//   stages: tile k + 1 arrives while tile k is computed.  (Element-sized
//   `cp.async` copies where C is not a multiple of 4 or a base is not
//   16-byte aligned.)
// - A thread reads its slots of a staged row as they come.  Rows of 32
//   and 64 bytes would put rows 4 and 2 apart on the same banks; their
//   16-byte chunks are permuted by an XOR with the row's place among the
//   rows that share a 128-byte bank line, so a half-warp's reads of one
//   slot meet at most two or four to a bank, against 32 on a 128-byte
//   row stride.
// - At B == 1 the tile's table values are loaded by `rowidx` as soon as
//   the tile lands, ahead of the chain (L1/L2 hits: a lane's table rows
//   are 192 B), and the physics of the tile's slots, which at B == 1 do
//   not depend on the progress, is free of branches (physics.cuh), so
//   the compiler interleaves the slots' `pow`s and divisions.
// - The CO2 sums of E <= 4 members live in registers (a template on E);
//   a general path for more members keeps them in the output row and
//   reads `cf` from global memory.
// - A lane that finishes stops its arithmetic but keeps taking part in
//   the block's copies and barriers; a block whose lanes have all
//   finished stops copying.
//
// Parity: fp64 within 1e-9 relative of the reference per lane, mixed
// within 1e-6 of fp64 (chip_smoke.py checks both on the card).  Every
// slot computes what the first design computed, in the same order, with
// the divisions and powers of physics.cuh.
#include "physics.cuh"

using carina::Phys;
using carina::Rates;

namespace {

// Slots a staged tile: 64-byte rows of the compute type (8 fp64 slots,
// 16 fp32), the row length at which the ablation's loads ran fastest.
template <typename T>
constexpr int TS = 64 / (int)sizeof(T);
constexpr int STAGES = 2;  // tiles in flight

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES global -> shared; with `in` false the bytes are zero-filled and
// nothing is read.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(in ? BYTES : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of slot c of row r in a staged array of W slots of S
// bytes: 16-byte rows as they are; longer rows with their NC 16-byte
// chunks permuted by an XOR with the row's place among the rows that
// share a 128-byte bank line (see the design note).
template <int S, int W>
__device__ __forceinline__ int slot_offset(int r, int c) {
  constexpr int NC = S * W / 16;
  const int b = c * S;
  if constexpr (NC == 1) {
    return r * 16 + b;
  } else {
    constexpr int SH = NC == 2 ? 2 : (NC == 4 ? 1 : 0);
    return r * NC * 16 + ((((b >> 4) ^ (r >> SH)) & (NC - 1)) << 4) +
           (b & 15);
  }
}

// Slots [t0, t0 + W) of `nrows` rows of a lane-major (., C) array into
// a staged tile: smem row r <- global row row0 + r * rs; rows >= `valid`
// and slots >= C become zeros.
template <int W, typename V>
__device__ __forceinline__ void stage(unsigned char* dst, const V* src,
                                      size_t row0, int rs, int valid,
                                      int nrows, int C, int t0, bool vec) {
  constexpr int S = sizeof(V);
  if (vec) {
    constexpr int EPC = 16 / S;   // elements a chunk
    constexpr int CPR = W / EPC;  // chunks a row
    for (int i = threadIdx.x; i < nrows * CPR; i += blockDim.x) {
      const int r = i / CPR, c = (i % CPR) * EPC;
      const bool in = r < valid && t0 + c < C;
      const V* p = in ? src + (row0 + (size_t)r * rs) * C + t0 + c : src;
      cp_async<16>(dst + slot_offset<S, W>(r, c), p, in);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * W; i += blockDim.x) {
      const int r = i / W, c = i % W;
      const bool in = r < valid && t0 + c < C;
      const V* p = in ? src + (row0 + (size_t)r * rs) * C + t0 + c : src;
      cp_async<S>(dst + slot_offset<S, W>(r, c), p, in);
    }
  }
}

// Slot c of row r of a staged tile of W slots.
template <typename V, int W>
__device__ __forceinline__ V at(const unsigned char* base, int r, int c) {
  return *reinterpret_cast<const V*>(base + slot_offset<sizeof(V), W>(r, c));
}

// Staged arrays a stage: rowidx, bg, pr, lens, then EC carbon members.
template <typename T>
__host__ __device__ constexpr int stage_bytes(int nrows, int EC) {
  return nrows * TS<T> * (4 + (3 + EC) * (int)sizeof(T));
}

}  // namespace

// EC = E carbon members staged and summed in registers (1..4), or 0:
// the general path for any E (cf read from global memory, the sums in
// the output row).
template <typename T, int EC>
__global__ void scan_chunk_kernel(
    const T* __restrict__ u_tab, const T* __restrict__ b_tab,
    const int32_t* __restrict__ rowidx, const T* __restrict__ bg,
    const T* __restrict__ cf, const T* __restrict__ pr,
    const T* __restrict__ lens, const double* __restrict__ rem_in,
    const double* __restrict__ rt_in, const double* __restrict__ kwh_in,
    const double* __restrict__ co2_in, const double* __restrict__ cost_in,
    const T* __restrict__ n_scen, const T* __restrict__ rate,
    const T* __restrict__ oh, const T* __restrict__ idle,
    const T* __restrict__ dyn, const T* __restrict__ alpha,
    const T* __restrict__ gamma, const T* __restrict__ ohfrac,
    double* __restrict__ rem_out, double* __restrict__ rt_out,
    double* __restrict__ kwh_out, double* __restrict__ co2_out,
    double* __restrict__ cost_out, int A, int R, int B, int C, int E,
    bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nrows = blockDim.x;
  const int r = threadIdx.x;
  const size_t a0 = (size_t)blockIdx.x * nrows;
  const long long left = (long long)A - (long long)a0;
  const int valid = left < nrows ? (int)left : nrows;
  const size_t a = a0 + r;
  const bool lane = r < valid;
  const int sb = stage_bytes<T>(nrows, EC);
  constexpr int W = TS<T>;
  const int arr = nrows * W * (int)sizeof(T);

  Phys<T> p = {T(0), T(0), T(0), T(0), T(1), T(0), T(0)};
  T nsc = T(1);
  double rem = 0.0, rt = 0.0, kwh = 0.0, cost = 0.0;
  double co2[EC > 0 ? EC : 1];
  if (lane) {
    p = {rate[a], oh[a], idle[a], dyn[a], alpha[a], gamma[a], ohfrac[a]};
    nsc = n_scen[a];
    rem = rem_in[a], rt = rt_in[a], kwh = kwh_in[a], cost = cost_in[a];
    if constexpr (EC > 0) {
#pragma unroll
      for (int e = 0; e < EC; ++e) co2[e] = co2_in[a * EC + e];
    } else {
      for (int e = 0; e < E; ++e) co2_out[a * E + e] = co2_in[a * E + e];
    }
  }
  const T* ut = u_tab + a * R * B;
  const T* btab = b_tab + a * R * B;

  auto stage_tile = [&](int k) {
    unsigned char* st = smem + (k % STAGES) * sb;
    const int t0 = k * W;
    stage<W>(st, rowidx, a0, 1, valid, nrows, C, t0, vec);
    st += nrows * W * 4;
    stage<W>(st, bg, a0, 1, valid, nrows, C, t0, vec);
    stage<W>(st + arr, pr, a0, 1, valid, nrows, C, t0, vec);
    stage<W>(st + 2 * arr, lens, a0, 1, valid, nrows, C, t0, vec);
#pragma unroll
    for (int e = 0; e < EC; ++e)
      stage<W>(st + (3 + e) * arr, cf, a0 * EC + e, EC, valid, nrows, C, t0,
            vec);
  };

  const int ntiles = (C + W - 1) / W;
#pragma unroll
  for (int k = 0; k < STAGES; ++k) {
    if (k < ntiles) stage_tile(k);
    cp_async_commit();
  }
  for (int k = 0; k < ntiles; ++k) {
    // tile k has landed; the STAGES - 1 tiles after it may be in flight
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const unsigned char* st = smem + (k % STAGES) * sb;
    const int t0 = k * W;
    if (lane && rem > 0.0) {
      int row[W];
#pragma unroll
      for (int j = 0; j < W; ++j) row[j] = at<int, W>(st, r, j);
      st += nrows * W * 4;  // bg, pr, lens, cf: arr bytes apart
      T ub[W], bb[W];
      if (B == 1) {  // the tile's table values, ahead of the chain
#pragma unroll
        for (int j = 0; j < W; ++j) {
          ub[j] = __ldg(ut + row[j]);
          bb[j] = __ldg(btab + row[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int t = t0 + j;
        if (t >= C || !(rem > 0.0)) break;
        T u, bt;
        if (B == 1) {
          u = ub[j];
          bt = bb[j];
        } else {
          const T prog = (T)(1.0 - carina::xdiv(rem, (double)nsc));
          const T x = prog * T(B) - T(0.5);
          T fl = carina::xfloor(x);
          fl = fl < T(0) ? T(0) : (fl > T(B - 2) ? T(B - 2) : fl);
          const int b0 = (int)fl;
          T w = x - T(b0);
          w = w < T(0) ? T(0) : (w > T(1) ? T(1) : w);
          const T* ur = ut + (size_t)row[j] * B;
          const T* br = btab + (size_t)row[j] * B;
          u = (T(1) - w) * ur[b0] + w * ur[b0 + 1];
          bt = (T(1) - w) * br[b0] + w * br[b0 + 1];
        }
        const Rates<T> rr = carina::rates(u, bt, at<T, W>(st, r, j), p);
        const double dt =
            fmin((double)at<T, W>(st + 2 * arr, r, j),
                 carina::xdiv(rem, (double)carina::xmax(rr.scen_per_s,
                                                        T(1e-30))));
        const double en = (double)rr.kwh_per_s * dt;
        rem = rem - (double)rr.scen_per_s * dt;
        rt = rt + dt;
        kwh = kwh + en;
        if constexpr (EC > 0) {
#pragma unroll
          for (int e = 0; e < EC; ++e)
            co2[e] =
                co2[e] + en * (double)at<T, W>(st + (3 + e) * arr, r, j);
        } else {
          for (int e = 0; e < E; ++e)
            co2_out[a * E + e] =
                co2_out[a * E + e] + en * (double)cf[(a * E + e) * C + t];
        }
        cost = cost + en * (double)at<T, W>(st + arr, r, j);
      }
    }
    // every thread has read stage k % STAGES; stop once no lane runs
    if (!__syncthreads_or(lane && rem > 0.0)) break;
    if (k + STAGES < ntiles) stage_tile(k + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy may land after the block has left
  if (!lane) return;
  rem_out[a] = rem;
  rt_out[a] = rt;
  kwh_out[a] = kwh;
  cost_out[a] = cost;
  if constexpr (EC > 0) {
#pragma unroll
    for (int e = 0; e < EC; ++e) co2_out[a * EC + e] = co2[e];
  }
}

namespace {

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Threads a block: 128 lanes, or 64 / 32 when 128 would leave SMs
// without a block (kernels/scan_chunk.py::launch_plan is the same rule).
int plan_threads(int A, int sms) {
  for (int t = 128; t > 32; t >>= 1)
    if ((A + t - 1) / t >= sms) return t;
  return 32;
}

template <typename T, int EC>
int launch_ec(const void* const* ptr, void* const* out, int A, int R, int B,
              int C, int E, bool vec, cudaStream_t stream) {
  const int threads = plan_threads(A, sm_count());
  const int blocks = (A + threads - 1) / threads;
  const int smem = STAGES * stage_bytes<T>(threads, EC);
  static bool raised = false;  // the >48 KB opt-in, once a process
  if (!raised && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_chunk_kernel<T, EC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        STAGES * stage_bytes<T>(128, EC));
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  scan_chunk_kernel<T, EC><<<blocks, threads, smem, stream>>>(
      (const T*)ptr[0], (const T*)ptr[1], (const int32_t*)ptr[2],
      (const T*)ptr[3], (const T*)ptr[4], (const T*)ptr[5], (const T*)ptr[6],
      (const double*)ptr[7], (const double*)ptr[8], (const double*)ptr[9],
      (const double*)ptr[10], (const double*)ptr[11], (const T*)ptr[12],
      (const T*)ptr[13], (const T*)ptr[14], (const T*)ptr[15],
      (const T*)ptr[16], (const T*)ptr[17], (const T*)ptr[18],
      (const T*)ptr[19], (double*)out[0], (double*)out[1], (double*)out[2],
      (double*)out[3], (double*)out[4], A, R, B, C, E, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* ptr, void* const* out, int A, int R, int B,
           int C, int E, void* stream) {
  // 16-byte copies need every staged row to start on a 16-byte boundary
  bool vec = C % 4 == 0;
  for (int i : {2, 3, 4, 5, 6}) vec = vec && ((uintptr_t)ptr[i] % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  switch (E) {
    case 1: return launch_ec<T, 1>(ptr, out, A, R, B, C, E, vec, s);
    case 2: return launch_ec<T, 2>(ptr, out, A, R, B, C, E, vec, s);
    case 3: return launch_ec<T, 3>(ptr, out, A, R, B, C, E, vec, s);
    case 4: return launch_ec<T, 4>(ptr, out, A, R, B, C, E, vec, s);
    default: return launch_ec<T, 0>(ptr, out, A, R, B, C, E, vec, s);
  }
}

}  // namespace

#define SCAN_CHUNK_ARGS                                                     \
  const void *u_tab, const void *b_tab, const void *rowidx, const void *bg, \
      const void *cf, const void *pr, const void *lens, const void *rem,    \
      const void *rt, const void *kwh, const void *co2, const void *cost,   \
      const void *n_scen, const void *rate, const void *oh,                 \
      const void *idle, const void *dyn, const void *alpha,                 \
      const void *gamma, const void *ohfrac, void *rem_o, void *rt_o,       \
      void *kwh_o, void *co2_o, void *cost_o, int A, int R, int B, int C,   \
      int E, void *stream
#define SCAN_CHUNK_PASS                                                     \
  const void* in[] = {u_tab, b_tab, rowidx, bg,    cf,    pr,    lens,      \
                      rem,   rt,    kwh,    co2,   cost,  n_scen, rate,     \
                      oh,    idle,  dyn,    alpha, gamma, ohfrac};          \
  void* out[] = {rem_o, rt_o, kwh_o, co2_o, cost_o}

// Plain C entry points (loaded with ctypes); each returns the
// cudaGetLastError() code of its launch, 0 on success.
extern "C" int scan_chunk_f64(SCAN_CHUNK_ARGS) {
  SCAN_CHUNK_PASS;
  return launch<double>(in, out, A, R, B, C, E, stream);
}
extern "C" int scan_chunk_f32(SCAN_CHUNK_ARGS) {
  SCAN_CHUNK_PASS;
  return launch<float>(in, out, A, R, B, C, E, stream);
}

// The launch the kernel takes for A lanes and E members: threads a
// block, blocks, dynamic shared memory bytes, and the blocks one SM holds
// (the occupancy API at those threads and bytes) into out[0..3].
extern "C" int scan_chunk_plan(int A, int E, int f64, int* out) {
  const int threads = plan_threads(A, sm_count());
  const int ec = E >= 1 && E <= 4 ? E : 0;
  const int smem = STAGES * (f64 ? stage_bytes<double>(threads, ec)
                                 : stage_bytes<float>(threads, ec));
  int per_sm = 0;
  cudaError_t err;
  if (f64) {
    auto k = ec == 1 ? scan_chunk_kernel<double, 1>
             : ec == 2 ? scan_chunk_kernel<double, 2>
             : ec == 3 ? scan_chunk_kernel<double, 3>
             : ec == 4 ? scan_chunk_kernel<double, 4>
                       : scan_chunk_kernel<double, 0>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         STAGES * stage_bytes<double>(128, ec));
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                        smem);
  } else {
    auto k = ec == 1 ? scan_chunk_kernel<float, 1>
             : ec == 2 ? scan_chunk_kernel<float, 2>
             : ec == 3 ? scan_chunk_kernel<float, 3>
             : ec == 4 ? scan_chunk_kernel<float, 4>
                       : scan_chunk_kernel<float, 0>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         STAGES * stage_bytes<float>(128, ec));
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                        smem);
  }
  out[0] = threads;
  out[1] = (A + threads - 1) / threads;
  out[2] = smem;
  out[3] = per_sm;
  return (int)err;
}
