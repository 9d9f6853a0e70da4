// K1: the site-coupled chunk step of the trace-scan engine, for Hopper.
//
// Replaces the Pallas kernel `coupled_chunk` (`_kernel`) of
// src/repro/kernels/coupled_throttle.py: one chunk of C slots for the
// lanes of capped fleet groups, in the dense (G, Lp) layout that the
// engine repacks them into (`_run_chunk_coupled` in core/engine_torch.py,
// as `_run_chunk_coupled_pallas` does in the reference), with the
// decision rows pre-gathered to (G, Lp, C, B).
//
// Design: lanes live in threads and a group in a contiguous segment of
// Lp threads.  With Lp <= 32 (a power of two) a warp holds 32/Lp whole
// groups and the per-slot group sums are xor-butterfly shuffles inside
// each Lp-wide segment (every thread ends with the same, bitwise
// identical total: each butterfly level adds a+b, which is commutative).
// With Lp > 32 a group has a block of Lp threads, and the sum is a warp
// butterfly followed by a fixed-order sum of the warp totals in shared
// memory.  Per slot: hat-weight interpolation over the B progress
// buckets (only the two nonzero hats are evaluated: the Pallas body's
// sum over all B adds exact zeros), `model.rates`, the group sums of the
// active lanes' base and average draw, `SITE_THROTTLE_ITERS` damped
// `site_throttle` steps each re-summing the draw at the new factor,
// dt = min(len, remaining / scen_per_s), kWh/CO2[E]/cost accumulation and
// the running site peak.  State stays in registers (CO2 in the thread's
// own output row) for the whole slot loop.  A warp (or block) stops when
// none of its lanes has remaining > 0; later slots are no-ops for it.
// Padded lanes carry remaining 0, n_scen 1, alpha 1 (inactive, finite
// physics); padded groups carry cap = +inf, for which site_throttle
// returns f = 1 exactly.
//
// What bounds it on an H100: per lane-slot ~11 `pow` with a per-lane
// exponent (one base power, then the two power terms of `rates` at the
// start and after each of the 4 throttle steps) inside ~170 fp64
// operations counting a `pow` as one (chip_smoke.py counts 160 for the
// physics and 8 + 2E for the carried sums), against (2*B + 3 + E)*8 B
// of pre-gathered rows and series (48 B at the benchmark's B = 1,
// E = 1).  Counted that way the memory side bounds it; with a `pow`
// costing tens of fp64 instructions the fp64 units and the latency of
// each thread's dependent chain are the real limit.  The design keeps
// every intermediate in registers and reads each input once.  Groups of
// the benchmark fleet are 8 lanes, so a warp serves 4 groups and no
// lane idles.
//
// Parity: fp64 within 1e-9 relative of the reference per lane, mixed
// within 1e-6 of fp64 (chip_smoke.py checks both on the card).  Built
// with nvcc's default FMA contraction; --fmad=false was not needed for
// that bar (chip_smoke.py reports the error it measured).
#include "physics.cuh"

using carina::Phys;
using carina::Rates;

// Sum of `v` over the thread's group (see the design note above).
template <typename T>
__device__ __forceinline__ T group_sum(T v, int Lp, T* red) {
  if (Lp <= 32) {
    for (int off = Lp >> 1; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
  }
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = red[0];
  for (int i = 1; i < nw; ++i) s += red[i];
  __syncthreads();
  return s;
}

template <typename T>
__global__ void coupled_chunk_kernel(
    const T* __restrict__ u_rows, const T* __restrict__ b_rows,
    const T* __restrict__ bg, const T* __restrict__ cf,
    const T* __restrict__ pr, const T* __restrict__ lens,
    const T* __restrict__ cap_g, const T* __restrict__ office,
    const double* __restrict__ rem_in, const double* __restrict__ rt_in,
    const double* __restrict__ kwh_in, const double* __restrict__ co2_in,
    const double* __restrict__ cost_in, const double* __restrict__ speak_in,
    const T* __restrict__ n_scen, const T* __restrict__ rate,
    const T* __restrict__ oh, const T* __restrict__ idle,
    const T* __restrict__ dyn, const T* __restrict__ alpha,
    const T* __restrict__ gamma, const T* __restrict__ ohfrac,
    double* __restrict__ rem_out, double* __restrict__ rt_out,
    double* __restrict__ kwh_out, double* __restrict__ co2_out,
    double* __restrict__ cost_out, double* __restrict__ speak_out, int G,
    int Lp, int C, int B, int E, int iters, double finish_frac) {
  __shared__ T red[32];
  int g, lane;
  if (Lp <= 32) {
    const int gid = blockIdx.x * blockDim.x + threadIdx.x;
    g = gid / Lp;
    lane = gid % Lp;
  } else {
    g = blockIdx.x;
    lane = threadIdx.x;
  }
  // threads past the last group keep joining the shuffles as idle lanes
  const bool valid = g < G;
  const size_t L = valid ? (size_t)g * Lp + lane : 0;
  Phys<T> p = {T(0), T(0), T(0), T(0), T(1), T(0), T(0)};
  T nsc = T(1), cap = T(0);
  double rem = 0.0, rt = 0.0, kwh = 0.0, cost = 0.0, speak = 0.0;
  double* co2 = co2_out + L * E;
  if (valid) {
    p = {rate[L], oh[L], idle[L], dyn[L], alpha[L], gamma[L], ohfrac[L]};
    nsc = n_scen[L];
    cap = cap_g[g];
    rem = rem_in[L];
    rt = rt_in[L];
    kwh = kwh_in[L];
    cost = cost_in[L];
    speak = speak_in[L];
    for (int e = 0; e < E; ++e) co2[e] = co2_in[L * E + e];
  }
  const T thr = T(finish_frac) * nsc;
  for (int t = 0; t < C; ++t) {
    const bool running = rem > 0.0;
    const bool any = Lp <= 32 ? __any_sync(0xffffffffu, running)
                              : __syncthreads_or(running);
    if (!any) break;
    T u = T(0), bt = T(1), bgt = T(0), off = T(0);
    double len = 0.0;
    if (valid) {
      const T* ur = u_rows + (L * C + t) * B;
      const T* br = b_rows + (L * C + t) * B;
      if (B == 1) {
        u = ur[0];
        bt = br[0];
      } else {
        const T prog = (T)(1.0 - rem / (double)nsc);
        T x = prog * T(B) - T(0.5);
        x = x < T(0) ? T(0) : (x > T(B - 1) ? T(B - 1) : x);
        int b0 = (int)carina::xfloor(x);
        b0 = b0 > B - 2 ? B - 2 : b0;
        const T w0 = carina::xmax(T(1) - carina::xabs(x - T(b0)), T(0));
        const T w1 = carina::xmax(T(1) - carina::xabs(x - T(b0 + 1)), T(0));
        u = ur[b0] * w0 + ur[b0 + 1] * w1;
        bt = br[b0] * w0 + br[b0 + 1] * w1;
      }
      bgt = bg[L * C + t];
      off = office[(size_t)g * C + t];
      len = (double)lens[L * C + t];
    }
    const Rates<T> r = carina::rates(u, bt, bgt, p);
    const bool active = rem > (double)thr;
    const T base = group_sum(
        active ? carina::power_w(bgt, p.idle, p.dyn, p.alpha) / T(1000)
               : T(0),
        Lp, red);
    const T head = cap - off;
    T f = T(1);
    Rates<T> r2 = r;
    for (int it = 0; it < iters; ++it) {
      const T draw = group_sum(active ? r2.p_avg_w / T(1000) : T(0), Lp, red);
      f = carina::site_throttle(draw, base, head, f);
      r2 = carina::rates(u * f, bt, bgt, p);
    }
    const T site_kw =
        group_sum(active ? r2.p_avg_w / T(1000) : T(0), Lp, red) + off;
    if (!valid) continue;
    const double dt =
        running ? fmin(len, rem / (double)carina::xmax(r2.scen_per_s,
                                                        T(1e-30)))
                : 0.0;
    const double en = (double)r2.kwh_per_s * dt;
    if (active) speak = fmax(speak, (double)site_kw);
    rem = rem - (double)r2.scen_per_s * dt;
    rt = rt + dt;
    kwh = kwh + en;
    for (int e = 0; e < E; ++e)
      co2[e] = co2[e] + en * (double)cf[(L * E + e) * C + t];
    cost = cost + en * (double)pr[L * C + t];
  }
  if (!valid) return;
  rem_out[L] = rem;
  rt_out[L] = rt;
  kwh_out[L] = kwh;
  cost_out[L] = cost;
  speak_out[L] = speak;
}

template <typename T>
static int launch(const void* u_rows, const void* b_rows, const void* bg,
                  const void* cf, const void* pr, const void* lens,
                  const void* cap_g, const void* office, const void* rem,
                  const void* rt, const void* kwh, const void* co2,
                  const void* cost, const void* speak, const void* n_scen,
                  const void* rate, const void* oh, const void* idle,
                  const void* dyn, const void* alpha, const void* gamma,
                  const void* ohfrac, void* rem_o, void* rt_o, void* kwh_o,
                  void* co2_o, void* cost_o, void* speak_o, int G, int Lp,
                  int C, int B, int E, int iters, double finish_frac,
                  void* stream) {
  int threads, blocks;
  if (Lp <= 32) {
    threads = 128;                       // 128 / Lp whole groups per block
    blocks = (int)(((long long)G * Lp + threads - 1) / threads);
  } else {
    threads = Lp;                        // one block per group
    blocks = G;
  }
  coupled_chunk_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)u_rows, (const T*)b_rows, (const T*)bg, (const T*)cf,
      (const T*)pr, (const T*)lens, (const T*)cap_g, (const T*)office,
      (const double*)rem, (const double*)rt, (const double*)kwh,
      (const double*)co2, (const double*)cost, (const double*)speak,
      (const T*)n_scen, (const T*)rate, (const T*)oh, (const T*)idle,
      (const T*)dyn, (const T*)alpha, (const T*)gamma, (const T*)ohfrac,
      (double*)rem_o, (double*)rt_o, (double*)kwh_o, (double*)co2_o,
      (double*)cost_o, (double*)speak_o, G, Lp, C, B, E, iters, finish_frac);
  return (int)cudaGetLastError();
}

#define COUPLED_ARGS                                                         \
  const void *u_rows, const void *b_rows, const void *bg, const void *cf,    \
      const void *pr, const void *lens, const void *cap_g,                   \
      const void *office, const void *rem, const void *rt, const void *kwh,  \
      const void *co2, const void *cost, const void *speak,                  \
      const void *n_scen, const void *rate, const void *oh,                  \
      const void *idle, const void *dyn, const void *alpha,                  \
      const void *gamma, const void *ohfrac, void *rem_o, void *rt_o,        \
      void *kwh_o, void *co2_o, void *cost_o, void *speak_o, int G, int Lp,  \
      int C, int B, int E, int iters, double finish_frac, void *stream
#define COUPLED_PASS                                                         \
  u_rows, b_rows, bg, cf, pr, lens, cap_g, office, rem, rt, kwh, co2, cost, \
      speak, n_scen, rate, oh, idle, dyn, alpha, gamma, ohfrac, rem_o, rt_o, \
      kwh_o, co2_o, cost_o, speak_o, G, Lp, C, B, E, iters, finish_frac,     \
      stream

// Plain C entry points (loaded with ctypes); each returns the
// cudaGetLastError() code of its launch, 0 on success.
extern "C" int coupled_chunk_f64(COUPLED_ARGS) {
  return launch<double>(COUPLED_PASS);
}
extern "C" int coupled_chunk_f32(COUPLED_ARGS) {
  return launch<float>(COUPLED_PASS);
}
