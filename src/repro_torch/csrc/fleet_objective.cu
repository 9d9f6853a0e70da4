// K4: the schedule optimizer's site-coupled fleet objective scan, forward
// and backward, for Hopper.
//
// Replaces `FleetTraceObjective._step` / `_evaluate_jax` of
// src/repro/core/engine_jax.py (the `jax.lax.scan` over the horizon's
// slots that XLA compiles into one program, differentiated by `jax.grad`).
// On the card the port ran it as Python slot loops of tensor ops: a
// capped fleet solved every slot's throttle at once under an assumed
// activity mask and repeated the whole scan until the mask held (up to
// M + 1 passes, ~17,000 launches an evaluation).  Here the slots run in
// order, so the activity mask is exact and there are no passes.
//
// Computation: a warp a member of the population (N, M, n_slots); its
// lanes stride over the M campaigns (campaign m on lane m % 32).  Up to
// 128 campaigns a member each lane keeps its CPL <= 4 campaigns' state in
// registers; past that the streaming kernels loop over the lane's
// campaigns at every step of a slot, with each campaign's carried state in
// global memory (the forward's in its own output row, the backward's
// adjoint of remaining in a workspace), so any M launches.  Per slot t:
//   active_m = remaining_m > FINISH_FRAC n_scen_m
//   r_m = model.rates(u_m[rowidx[t]], ...)
//   capped: base = sum over active of the non-sheddable draw, then
//     SITE_THROTTLE_ITERS damped site_throttle steps, each over the
//     warp-summed active draw and each re-evaluating r_m at u_m f;
//     uncapped: no solve (an infinite headroom would poison the chain rule)
//   dt_m by the strict finish branch, the sums (runtime, kWh, CO2, cost),
//   the site draw (active draw + office) and the running site peak.
// Every warp sum is an xor butterfly, so all lanes hold the same bits.
//
// Backward: the same warps, the slots in reverse, from the forward's
// checkpoints of each slot's starting remaining (T, N, M) and the site
// peak before each slot (T, N).  Per slot the throttle factors are
// recomputed, then reversed through: the running max (a tie splits the
// gradient evenly), the finish branch, the physics at the final factor,
// and each throttle step back to its summed draw and its incoming factor.
// d/du is summed into each campaign's own day bins by the lane that owns
// it.
//
// What bounds it: N x M x T campaign-slots of ~160 fp64 operations (five
// operating points a slot when capped) and a few bytes each, ~1e-3 ms of
// the card at the README fleet's N = 192, M = 2, T = 624; the kernel's
// time is one warp's chain over T slots (five dependent operating points
// and five shuffle sums a slot).  A warp a member keeps the coupling
// inside the warp: no shared memory, no block barriers.  The streaming
// kernels recompute the final operating point once more a slot in the
// backward and re-read u, the remaining work and the campaign scalars
// from L1 at each step, where the register tiles hold them.
#include "physics_grad.cuh"

using carina::Phys;
using carina::RatesFwd;

namespace {

constexpr int ITERS = 4;   // model.SITE_THROTTLE_ITERS
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The series and per-campaign scalars of one objective.
struct Fleet {
  const double* u;       // (N, M, S)
  const int* rowidx;     // (T,)
  const double* bg;      // (T,)
  const double* cf;      // (T,)
  const double* pr;      // (T,)
  const double* lens;    // (T,)
  const double* office;  // (T,) kW
  const double* head;    // (T,) kW, cap - office
  const double* base;    // (T, M) kW, each campaign's non-sheddable draw
  const double* camp;    // (9, M): n_scen, finish, rate, oh, idle, dyn,
                         // alpha, gamma, ohf
  double batch;
  int capped, N, M, S, T;
};

// One campaign's scalars.
struct Camp {
  double n_scen, finish;
  Phys<double> p;
};

__device__ __forceinline__ Camp camp_of(const Fleet& F, int m) {
  const double* c = F.camp + m;
  return {c[0], c[F.M],
          {c[2 * F.M], c[3 * F.M], c[4 * F.M], c[5 * F.M], c[6 * F.M],
           c[7 * F.M], c[8 * F.M]}};
}

// The lane's campaigns: index, validity and scalars.
template <int CPL>
struct Lanes {
  int m[CPL];
  bool valid[CPL];
  double n_scen[CPL], finish[CPL];
  Phys<double> p[CPL];
  const double* urow[CPL];
};

template <int CPL>
__device__ __forceinline__ Lanes<CPL> lanes(const Fleet& F, int n,
                                            int lane) {
  Lanes<CPL> L;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int m = lane + 32 * j;
    L.valid[j] = m < F.M;
    const int mm = L.valid[j] ? m : 0;   // a spare lane computes campaign 0
    L.m[j] = mm;
    const Camp c = camp_of(F, mm);
    L.n_scen[j] = c.n_scen;
    L.finish[j] = c.finish;
    L.p[j] = c.p;
    L.urow[j] = F.u + ((size_t)n * F.M + mm) * F.S;
  }
  return L;
}

// The warp-summed draw (kW) of the lane's active campaigns at q.
template <int CPL>
__device__ __forceinline__ double active_kw(const RatesFwd<double> (&q)[CPL],
                                            const bool (&act)[CPL]) {
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < CPL; ++j) s += act[j] ? q[j].pavg / 1000.0 : 0.0;
  return warp_sum(s);
}

// One slot's operating points: the throttle factors f[0..ITERS] and the
// summed draws fk[0..ITERS-1] they were solved from (capped), the summed
// base draw, and the final point q of each of the lane's campaigns.
template <int CPL>
__device__ __forceinline__ void slot_points(const Fleet& F,
                                            const Lanes<CPL>& L, int t,
                                            const double (&uu)[CPL],
                                            const bool (&act)[CPL],
                                            RatesFwd<double> (&q)[CPL],
                                            double (&f)[ITERS + 1],
                                            double (&fk)[ITERS],
                                            double& base) {
  const double bgt = F.bg[t];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    q[j] = carina::rates_fwd<double>(uu[j], F.batch, bgt, L.p[j]);
  f[0] = 1.0;
  base = 0.0;
  if (!F.capped) return;
  double b = 0.0;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    b += act[j] ? F.base[(size_t)t * F.M + L.m[j]] : 0.0;
  base = warp_sum(b);
  const double hd = F.head[t];
#pragma unroll
  for (int k = 0; k < ITERS; ++k) {
    fk[k] = active_kw<CPL>(q, act);
    f[k + 1] = carina::site_throttle(fk[k], base, hd, f[k]);
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      q[j] = carina::rates_fwd<double>(uu[j] * f[k + 1], F.batch, bgt,
                                       L.p[j]);
  }
}

template <int CPL>
__global__ void fleet_fwd_kernel(Fleet F, double* __restrict__ kwh_o,
                                 double* __restrict__ co2_o,
                                 double* __restrict__ rt_o,
                                 double* __restrict__ cost_o,
                                 double* __restrict__ unf_o,
                                 double* __restrict__ peak_o,
                                 double* __restrict__ rem_hist,
                                 double* __restrict__ peak_hist) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= F.N) return;   // the whole warp
  const Lanes<CPL> L = lanes<CPL>(F, n, lane);
  double R[CPL], rt[CPL], kwh[CPL], co2[CPL], cost[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    R[j] = L.valid[j] ? L.n_scen[j] : 0.0;
    rt[j] = kwh[j] = co2[j] = cost[j] = 0.0;
  }
  double peak = 0.0;
  for (int t = 0; t < F.T; ++t) {
    const int day = F.rowidx[t];
    double uu[CPL];
    bool act[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      uu[j] = L.urow[j][day];
      act[j] = L.valid[j] && R[j] > L.finish[j];
      if (rem_hist && L.valid[j])
        rem_hist[((size_t)t * F.N + n) * F.M + L.m[j]] = R[j];
    }
    RatesFwd<double> q[CPL];
    double f[ITERS + 1], fk[ITERS], base;
    slot_points<CPL>(F, L, t, uu, act, q, f, fk, base);
    const double site = active_kw<CPL>(q, act) + F.office[t];
    if (peak_hist && lane == 0) peak_hist[(size_t)t * F.N + n] = peak;
    peak = fmax(peak, site);
    const double ln = F.lens[t], cft = F.cf[t], prt = F.pr[t];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const double scen = fmax(q[j].sps, 1e-30);
      double dt = R[j] > scen * ln ? ln : R[j] / scen;
      dt = R[j] > 0.0 ? dt : 0.0;
      const double e = q[j].kwh * dt;
      R[j] = R[j] - q[j].sps * dt;
      rt[j] += dt;
      kwh[j] += e;
      co2[j] += e * cft;
      cost[j] += e * prt;
    }
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (!L.valid[j]) continue;
    const size_t o = (size_t)n * F.M + L.m[j];
    kwh_o[o] = kwh[j];
    co2_o[o] = co2[j];
    rt_o[o] = rt[j] / 3600.0;
    cost_o[o] = cost[j];
    unf_o[o] = R[j] / L.n_scen[j];
  }
  if (lane == 0) peak_o[n] = peak;
}

// The gradient of sum(g_kwh kwh + g_co2 co2 + g_rt runtime_h + g_cost cost
// + g_unf unfinished) + g_peak site_peak with respect to u, added into
// g_u (N, M, S) (zeroed by the caller).  A null gradient is zero.
template <int CPL>
__global__ void fleet_bwd_kernel(Fleet F, const double* __restrict__ rem_hist,
                                 const double* __restrict__ peak_hist,
                                 const double* __restrict__ g_kwh,
                                 const double* __restrict__ g_co2,
                                 const double* __restrict__ g_rt,
                                 const double* __restrict__ g_cost,
                                 const double* __restrict__ g_unf,
                                 const double* __restrict__ g_peak,
                                 double* __restrict__ g_u) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= F.N) return;   // the whole warp
  const Lanes<CPL> L = lanes<CPL>(F, n, lane);
  double gk[CPL], gco2[CPL], grt[CPL], gcost[CPL], lam[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const size_t o = (size_t)n * F.M + L.m[j];
    const bool v = L.valid[j];
    gk[j] = v && g_kwh ? g_kwh[o] : 0.0;
    gco2[j] = v && g_co2 ? g_co2[o] : 0.0;
    grt[j] = v && g_rt ? g_rt[o] / 3600.0 : 0.0;
    gcost[j] = v && g_cost ? g_cost[o] : 0.0;
    lam[j] = v && g_unf ? g_unf[o] / L.n_scen[j] : 0.0;
  }
  double lp = g_peak ? g_peak[n] : 0.0;   // d loss / d running peak
  for (int t = F.T - 1; t >= 0; --t) {
    const int day = F.rowidx[t];
    double uu[CPL], R[CPL];
    bool act[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      uu[j] = L.urow[j][day];
      R[j] = L.valid[j] ? rem_hist[((size_t)t * F.N + n) * F.M + L.m[j]]
                        : 0.0;
      act[j] = L.valid[j] && R[j] > L.finish[j];
    }
    RatesFwd<double> q[CPL];
    double f[ITERS + 1], fk[ITERS], base;
    slot_points<CPL>(F, L, t, uu, act, q, f, fk, base);
    // the running peak: max(peak before the slot, the slot's site draw)
    const double site = active_kw<CPL>(q, act) + F.office[t];
    const double pk = peak_hist[(size_t)t * F.N + n];
    double g_site = 0.0;
    if (pk == site) {
      g_site = 0.5 * lp;
      lp *= 0.5;
    } else if (pk < site) {
      g_site = lp;
      lp = 0.0;
    }
    const double ln = F.lens[t], cft = F.cf[t], prt = F.pr[t];
    double gx[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const double scen = fmax(q[j].sps, 1e-30);
      const bool live = R[j] > 0.0;
      const bool fin = live && !(R[j] > scen * ln);
      const double dt = live ? (fin ? R[j] / scen : ln) : 0.0;
      const double ge = gk[j] + gco2[j] * cft + gcost[j] * prt;
      const double gdt = grt[j] + ge * q[j].kwh - lam[j] * q[j].sps;
      const double g_sps = -lam[j] * dt;
      double g_scen = 0.0;
      if (fin) {   // dt = remaining / scen
        g_scen = -gdt * (dt / scen);
        lam[j] += gdt / scen;
      }
      const double gs = g_sps + g_scen * carina::tie_max(q[j].sps, 1e-30);
      const double gp = ge * dt / 3.6e6 + (act[j] ? g_site / 1000.0 : 0.0);
      gx[j] = carina::rates_vjp<double>(q[j], L.p[j], F.batch, gs, gp);
    }
    double gu[CPL];
    if (F.capped) {
      // x = u f[ITERS] at the final point; each earlier point x = u f[k]
      // fed the draw fk[k] that solved f[k + 1]
      double gf = 0.0;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        gu[j] = gx[j] * f[ITERS];
        gf += L.valid[j] ? gx[j] * uu[j] : 0.0;
      }
      gf = warp_sum(gf);
      const double bgt = F.bg[t], hd = F.head[t];
#pragma unroll
      for (int k = ITERS - 1; k >= 0; --k) {
        const carina::ThrottleGrad tg =
            carina::site_throttle_vjp(fk[k], base, hd, f[k], gf);
        double part = 0.0;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const RatesFwd<double> qk = carina::rates_fwd<double>(
              k == 0 ? uu[j] : uu[j] * f[k], F.batch, bgt, L.p[j]);
          const double g = carina::rates_vjp<double>(
              qk, L.p[j], F.batch, 0.0,
              act[j] ? tg.g_fleet / 1000.0 : 0.0);
          gu[j] += k == 0 ? g : g * f[k];
          part += L.valid[j] ? g * uu[j] : 0.0;
        }
        if (k > 0) gf = tg.g_f + warp_sum(part);
      }
    } else {
#pragma unroll
      for (int j = 0; j < CPL; ++j) gu[j] = gx[j];
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (L.valid[j])
        g_u[((size_t)n * F.M + L.m[j]) * F.S + day] += gu[j];
  }
}

// ---------------------------------------------------------------------------
// Past 128 campaigns a member: the lane's campaigns streamed at each step
// ---------------------------------------------------------------------------
__device__ __forceinline__ double u_at(const Fleet& F, int n, int m,
                                       int day) {
  return F.u[((size_t)n * F.M + m) * F.S + day];
}

// One slot's throttle factors f[0..ITERS] (all 1 uncapped), the summed
// draws fk[0..ITERS-1] they were solved from and the summed base draw,
// over the lane's campaigns m = lane, lane + 32, ...; `R` (M,) is the
// member's remaining work at the slot's start.
__device__ __forceinline__ void stream_throttle(const Fleet& F, int n,
                                                int lane, int t,
                                                const double* R,
                                                double (&f)[ITERS + 1],
                                                double (&fk)[ITERS],
                                                double& base) {
#pragma unroll
  for (int k = 0; k <= ITERS; ++k) f[k] = 1.0;
  base = 0.0;
  if (!F.capped) return;
  const int day = F.rowidx[t];
  const double bgt = F.bg[t], hd = F.head[t];
  double b = 0.0;
  for (int m = lane; m < F.M; m += 32)
    b += R[m] > F.camp[F.M + m] ? F.base[(size_t)t * F.M + m] : 0.0;
  base = warp_sum(b);
  for (int k = 0; k < ITERS; ++k) {
    double s = 0.0;
    for (int m = lane; m < F.M; m += 32) {
      const Camp c = camp_of(F, m);
      if (R[m] > c.finish)
        s += carina::rates_fwd<double>(u_at(F, n, m, day) * f[k], F.batch,
                                       bgt, c.p).pavg / 1000.0;
    }
    fk[k] = warp_sum(s);
    f[k + 1] = carina::site_throttle(fk[k], base, hd, f[k]);
  }
}

// The forward, the carried state in the outputs: remaining in `unf_o`,
// seconds in `rt_o`, each scaled once the slots are done.
__global__ void fleet_fwd_stream(Fleet F, double* __restrict__ kwh_o,
                                 double* __restrict__ co2_o,
                                 double* __restrict__ rt_o,
                                 double* __restrict__ cost_o,
                                 double* __restrict__ unf_o,
                                 double* __restrict__ peak_o,
                                 double* __restrict__ rem_hist,
                                 double* __restrict__ peak_hist) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= F.N) return;   // the whole warp
  const size_t row = (size_t)n * F.M;
  double* R = unf_o + row;
  for (int m = lane; m < F.M; m += 32) {
    R[m] = F.camp[m];
    kwh_o[row + m] = co2_o[row + m] = rt_o[row + m] = cost_o[row + m] = 0.0;
  }
  double peak = 0.0;
  for (int t = 0; t < F.T; ++t) {
    const int day = F.rowidx[t];
    if (rem_hist)
      for (int m = lane; m < F.M; m += 32)
        rem_hist[((size_t)t * F.N + n) * F.M + m] = R[m];
    double f[ITERS + 1], fk[ITERS], base;
    stream_throttle(F, n, lane, t, R, f, fk, base);
    const double bgt = F.bg[t], ln = F.lens[t], cft = F.cf[t],
                 prt = F.pr[t];
    double s = 0.0;
    for (int m = lane; m < F.M; m += 32) {
      const Camp c = camp_of(F, m);
      const RatesFwd<double> q = carina::rates_fwd<double>(
          u_at(F, n, m, day) * f[ITERS], F.batch, bgt, c.p);
      const double r = R[m];
      if (r > c.finish) s += q.pavg / 1000.0;
      const double scen = fmax(q.sps, 1e-30);
      double dt = r > scen * ln ? ln : r / scen;
      dt = r > 0.0 ? dt : 0.0;
      const double e = q.kwh * dt;
      R[m] = r - q.sps * dt;
      rt_o[row + m] += dt;
      kwh_o[row + m] += e;
      co2_o[row + m] += e * cft;
      cost_o[row + m] += e * prt;
    }
    const double site = warp_sum(s) + F.office[t];
    if (peak_hist && lane == 0) peak_hist[(size_t)t * F.N + n] = peak;
    peak = fmax(peak, site);
  }
  for (int m = lane; m < F.M; m += 32) {
    rt_o[row + m] /= 3600.0;
    R[m] /= F.camp[m];
  }
  if (lane == 0) peak_o[n] = peak;
}

// The backward, the adjoint of each campaign's remaining work in `lam`
// (N, M) and d/du added into g_u at each step.
__global__ void fleet_bwd_stream(Fleet F, const double* __restrict__ rem_hist,
                                 const double* __restrict__ peak_hist,
                                 const double* __restrict__ g_kwh,
                                 const double* __restrict__ g_co2,
                                 const double* __restrict__ g_rt,
                                 const double* __restrict__ g_cost,
                                 const double* __restrict__ g_unf,
                                 const double* __restrict__ g_peak,
                                 double* __restrict__ lam,
                                 double* __restrict__ g_u) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= F.N) return;   // the whole warp
  const size_t row = (size_t)n * F.M;
  for (int m = lane; m < F.M; m += 32)
    lam[row + m] = g_unf ? g_unf[row + m] / F.camp[m] : 0.0;
  double lp = g_peak ? g_peak[n] : 0.0;   // d loss / d running peak
  for (int t = F.T - 1; t >= 0; --t) {
    const int day = F.rowidx[t];
    const double* R = rem_hist + ((size_t)t * F.N + n) * F.M;
    double f[ITERS + 1], fk[ITERS], base;
    stream_throttle(F, n, lane, t, R, f, fk, base);
    const double bgt = F.bg[t], ln = F.lens[t], cft = F.cf[t],
                 prt = F.pr[t];
    // the running peak: max(peak before the slot, the slot's site draw)
    double s = 0.0;
    for (int m = lane; m < F.M; m += 32) {
      const Camp c = camp_of(F, m);
      if (R[m] > c.finish)
        s += carina::rates_fwd<double>(u_at(F, n, m, day) * f[ITERS],
                                       F.batch, bgt, c.p).pavg / 1000.0;
    }
    const double site = warp_sum(s) + F.office[t];
    const double pk = peak_hist[(size_t)t * F.N + n];
    double g_site = 0.0;
    if (pk == site) {
      g_site = 0.5 * lp;
      lp *= 0.5;
    } else if (pk < site) {
      g_site = lp;
      lp = 0.0;
    }
    // the finish branch and the physics at the final point
    double gf = 0.0;
    for (int m = lane; m < F.M; m += 32) {
      const Camp c = camp_of(F, m);
      const size_t o = row + m;
      const double uu = u_at(F, n, m, day);
      const RatesFwd<double> q =
          carina::rates_fwd<double>(uu * f[ITERS], F.batch, bgt, c.p);
      const double r = R[m];
      const double scen = fmax(q.sps, 1e-30);
      const bool live = r > 0.0;
      const bool fin = live && !(r > scen * ln);
      const double dt = live ? (fin ? r / scen : ln) : 0.0;
      const double ge = (g_kwh ? g_kwh[o] : 0.0) +
                        (g_co2 ? g_co2[o] : 0.0) * cft +
                        (g_cost ? g_cost[o] : 0.0) * prt;
      const double l = lam[o];
      const double gdt =
          (g_rt ? g_rt[o] / 3600.0 : 0.0) + ge * q.kwh - l * q.sps;
      double g_scen = 0.0;
      if (fin) {   // dt = remaining / scen
        g_scen = -gdt * (dt / scen);
        lam[o] = l + gdt / scen;
      }
      const double gs = -l * dt + g_scen * carina::tie_max(q.sps, 1e-30);
      const double gp =
          ge * dt / 3.6e6 + (r > c.finish ? g_site / 1000.0 : 0.0);
      const double gx = carina::rates_vjp<double>(q, c.p, F.batch, gs, gp);
      g_u[o * F.S + day] += gx * f[ITERS];
      gf += gx * uu;
    }
    if (!F.capped) continue;
    // each earlier point x = u f[k] fed the draw fk[k] that solved f[k + 1]
    gf = warp_sum(gf);
    const double hd = F.head[t];
    for (int k = ITERS - 1; k >= 0; --k) {
      const carina::ThrottleGrad tg =
          carina::site_throttle_vjp(fk[k], base, hd, f[k], gf);
      double part = 0.0;
      for (int m = lane; m < F.M; m += 32) {
        const Camp c = camp_of(F, m);
        const double uu = u_at(F, n, m, day);
        const RatesFwd<double> qk =
            carina::rates_fwd<double>(uu * f[k], F.batch, bgt, c.p);
        const double g = carina::rates_vjp<double>(
            qk, c.p, F.batch, 0.0, R[m] > c.finish ? tg.g_fleet / 1000.0
                                                    : 0.0);
        g_u[(row + m) * F.S + day] += g * f[k];
        part += g * uu;
      }
      if (k > 0) gf = tg.g_f + warp_sum(part);
    }
  }
}

// Warps a block: 4, or 2 or 1 where 4 would leave SMs without a block.
int plan_warps(int n, int sms) {
  if ((n + 3) / 4 >= sms) return 4;
  if ((n + 1) / 2 >= sms) return 2;
  return 1;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

Fleet fleet(const double* u, const int* rowidx, const double* tabs,
            const double* base, const double* camp, double batch, int capped,
            int N, int M, int S, int T) {
  // tabs: (6, T) rows bg, cf, pr, lens, office, head
  return {u, rowidx, tabs, tabs + T, tabs + 2 * (size_t)T,
          tabs + 3 * (size_t)T, tabs + 4 * (size_t)T, tabs + 5 * (size_t)T,
          base, camp, batch, capped, N, M, S, T};
}

}  // namespace

// C interface (ctypes).  `tabs` (6, T): bg, cf, pr, lens, office and
// headroom (cap - office, kW); `base` (T, M); `camp` (9, M): n_scen, the
// finish threshold, rate_at_full, batch_overhead_s, idle_w, dyn_w, alpha,
// gamma, overhead_w_frac; everything double but `rowidx` (int32).  The
// backward's `lam` is an (N, M) workspace, used past 128 campaigns.
// Returns the CUDA error of the launch (0: launched).  Up to 128 campaigns
// the register kernels, past that the streaming ones.
extern "C" int fleet_scan_fwd(const double* u, const int* rowidx,
                              const double* tabs, const double* base,
                              const double* camp, double batch, int capped,
                              double* kwh, double* co2, double* rt,
                              double* cost, double* unf, double* peak,
                              double* rem_hist, double* peak_hist, int N,
                              int M, int S, int T, void* stream) {
  if (N == 0) return 0;
  if (M < 1) return (int)cudaErrorInvalidValue;
  const Fleet F = fleet(u, rowidx, tabs, base, camp, batch, capped, N, M, S,
                        T);
  const int warps = plan_warps(N, sm_count());
  const dim3 grid((N + warps - 1) / warps), block(32 * warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLEET_FWD(KERNEL)                                                  \
  KERNEL<<<grid, block, 0, s>>>(F, kwh, co2, rt, cost, unf, peak, rem_hist, \
                                peak_hist)
  if (M <= 32)
    FLEET_FWD(fleet_fwd_kernel<1>);
  else if (M <= 64)
    FLEET_FWD(fleet_fwd_kernel<2>);
  else if (M <= 128)
    FLEET_FWD(fleet_fwd_kernel<4>);
  else
    FLEET_FWD(fleet_fwd_stream);
#undef FLEET_FWD
  return (int)cudaGetLastError();
}

extern "C" int fleet_scan_bwd(const double* u, const int* rowidx,
                              const double* tabs, const double* base,
                              const double* camp, double batch, int capped,
                              const double* rem_hist, const double* peak_hist,
                              const double* g_kwh, const double* g_co2,
                              const double* g_rt, const double* g_cost,
                              const double* g_unf, const double* g_peak,
                              double* lam, double* g_u, int N, int M, int S,
                              int T, void* stream) {
  if (N == 0) return 0;
  if (M < 1) return (int)cudaErrorInvalidValue;
  const Fleet F = fleet(u, rowidx, tabs, base, camp, batch, capped, N, M, S,
                        T);
  const int warps = plan_warps(N, sm_count());
  const dim3 grid((N + warps - 1) / warps), block(32 * warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLEET_BWD(CPL)                                                      \
  fleet_bwd_kernel<CPL><<<grid, block, 0, s>>>(F, rem_hist, peak_hist,    \
                                               g_kwh, g_co2, g_rt, g_cost, \
                                               g_unf, g_peak, g_u)
  if (M <= 32)
    FLEET_BWD(1);
  else if (M <= 64)
    FLEET_BWD(2);
  else if (M <= 128)
    FLEET_BWD(4);
  else
    fleet_bwd_stream<<<grid, block, 0, s>>>(F, rem_hist, peak_hist, g_kwh,
                                            g_co2, g_rt, g_cost, g_unf,
                                            g_peak, lam, g_u);
#undef FLEET_BWD
  return (int)cudaGetLastError();
}

// The throttle steps both kernels take a slot.
extern "C" int fleet_scan_iters() { return ITERS; }
