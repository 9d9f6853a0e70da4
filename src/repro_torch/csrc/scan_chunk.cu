// K2: the uncoupled chunk step of the trace-scan engine, for Hopper.
//
// Replaces `_scan_chunk_jax_impl` in src/repro/core/engine_jax.py, the
// `jax.lax.scan` that XLA compiles for every plain trace sweep (the
// reference has no Pallas source for it; PyTorch has no compiled scan,
// and the slot loop in plain tensor ops costs ~40 launches per slot).
//
// Design: one thread per scan lane, the whole slot loop of the chunk in
// the thread, the carried state (remaining, runtime, kWh, cost) in
// registers and the per-member CO2 sums in the output row the thread
// owns.  The decision row is gathered from the lane's (R, B) tables by
// `rowidx` inside the kernel with the reference's two-point progress
// lookup (`_bucket_lookup`: (1-w)*u[b0] + w*u[b0+1]), and B == 1 reads
// the single bucket.  A lane whose work is done (remaining <= 0) stops:
// every later slot of the reference is a no-op for it (dt = 0).
//
// What bounds it on an H100: per lane-slot the kernel reads one row
// index and the background/price/length/carbon samples (4 + (3+E)*8 B in
// fp64), plus the rows of the lane's (R, B) tables it touches, and runs
// ~40 fp64 operations counting each of its two `pow` (power at work and
// at overhead, per-lane exponent) as one: chip_smoke.py counts 31 for
// the physics and 7 + 2E for the carried sums.  At the benchmark's
// B = 1, E = 1 that is ~44 B against ~40 operations per lane-slot, so
// even with a `pow` costing tens of instructions the 3.35 TB/s memory
// side is the bound, not the fp64 units.  The series are laid out
// lane-major (A, C) as the engine builds them, so neighbouring threads
// read addresses C elements apart: each load touches one sector per
// thread and the next slots hit the same sectors in L1.  Making it
// faster (slot-major series, the table row through shared memory) is
// later work.
//
// Parity: fp64 within 1e-9 relative of the reference per lane, mixed
// within 1e-6 of fp64 (chip_smoke.py checks both on the card).  Built
// with nvcc's default FMA contraction; --fmad=false was not needed for
// that bar (chip_smoke.py reports the error it measured).
#include "physics.cuh"

using carina::Phys;
using carina::Rates;

template <typename T>
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
    double* __restrict__ cost_out, int A, int R, int B, int C, int E) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  const Phys<T> p = {rate[a], oh[a], idle[a], dyn[a], alpha[a], gamma[a],
                     ohfrac[a]};
  const T nsc = n_scen[a];
  double rem = rem_in[a], rt = rt_in[a], kwh = kwh_in[a], cost = cost_in[a];
  double* co2 = co2_out + (size_t)a * E;
  for (int e = 0; e < E; ++e) co2[e] = co2_in[(size_t)a * E + e];
  const T* ut = u_tab + (size_t)a * R * B;
  const T* bt_tab = b_tab + (size_t)a * R * B;
  const size_t s0 = (size_t)a * C;
  for (int t = 0; t < C; ++t) {
    if (!(rem > 0.0)) break;
    const int row = rowidx[s0 + t];
    T u, bt;
    if (B == 1) {
      u = ut[row];
      bt = bt_tab[row];
    } else {
      const T prog = (T)(1.0 - rem / (double)nsc);
      const T x = prog * T(B) - T(0.5);
      T fl = carina::xfloor(x);
      fl = fl < T(0) ? T(0) : (fl > T(B - 2) ? T(B - 2) : fl);
      const int b0 = (int)fl;
      T w = x - T(b0);
      w = w < T(0) ? T(0) : (w > T(1) ? T(1) : w);
      const T* ur = ut + (size_t)row * B;
      const T* br = bt_tab + (size_t)row * B;
      u = (T(1) - w) * ur[b0] + w * ur[b0 + 1];
      bt = (T(1) - w) * br[b0] + w * br[b0 + 1];
    }
    const Rates<T> r = carina::rates(u, bt, bg[s0 + t], p);
    const double dt =
        fmin((double)lens[s0 + t],
             rem / (double)carina::xmax(r.scen_per_s, T(1e-30)));
    const double en = (double)r.kwh_per_s * dt;
    rem = rem - (double)r.scen_per_s * dt;
    rt = rt + dt;
    kwh = kwh + en;
    for (int e = 0; e < E; ++e)
      co2[e] = co2[e] + en * (double)cf[((size_t)a * E + e) * C + t];
    cost = cost + en * (double)pr[s0 + t];
  }
  rem_out[a] = rem;
  rt_out[a] = rt;
  kwh_out[a] = kwh;
  cost_out[a] = cost;
}

template <typename T>
static int launch(const void* u_tab, const void* b_tab, const void* rowidx,
                  const void* bg, const void* cf, const void* pr,
                  const void* lens, const void* rem, const void* rt,
                  const void* kwh, const void* co2, const void* cost,
                  const void* n_scen, const void* rate, const void* oh,
                  const void* idle, const void* dyn, const void* alpha,
                  const void* gamma, const void* ohfrac, void* rem_o,
                  void* rt_o, void* kwh_o, void* co2_o, void* cost_o, int A,
                  int R, int B, int C, int E, void* stream) {
  const int threads = 128;
  const int blocks = (A + threads - 1) / threads;
  scan_chunk_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)u_tab, (const T*)b_tab, (const int32_t*)rowidx,
      (const T*)bg, (const T*)cf, (const T*)pr, (const T*)lens,
      (const double*)rem, (const double*)rt, (const double*)kwh,
      (const double*)co2, (const double*)cost, (const T*)n_scen,
      (const T*)rate, (const T*)oh, (const T*)idle, (const T*)dyn,
      (const T*)alpha, (const T*)gamma, (const T*)ohfrac, (double*)rem_o,
      (double*)rt_o, (double*)kwh_o, (double*)co2_o, (double*)cost_o, A, R,
      B, C, E);
  return (int)cudaGetLastError();
}

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
  u_tab, b_tab, rowidx, bg, cf, pr, lens, rem, rt, kwh, co2, cost, n_scen, \
      rate, oh, idle, dyn, alpha, gamma, ohfrac, rem_o, rt_o, kwh_o, co2_o, \
      cost_o, A, R, B, C, E, stream

// Plain C entry points (loaded with ctypes); each returns the
// cudaGetLastError() code of its launch, 0 on success.
extern "C" int scan_chunk_f64(SCAN_CHUNK_ARGS) {
  return launch<double>(SCAN_CHUNK_PASS);
}
extern "C" int scan_chunk_f32(SCAN_CHUNK_ARGS) {
  return launch<float>(SCAN_CHUNK_PASS);
}
