// K3: the schedule optimizer's single-campaign objective scan, forward and
// backward, for Hopper.
//
// Replaces `TraceObjective._evaluate_jax` of src/repro/core/engine_jax.py
// (the `jax.lax.scan` over the horizon's slots that XLA compiles into one
// program, and differentiates with `jax.grad`); on the card the port ran
// it as a Python slot loop of tensor ops, ~2,000 launches an evaluation
// and ~6,000 a gradient step.
//
// Computation, per member of the flattened population (N, n_slots): for
// every slot t of the horizon the intensity u = u_day[rowidx[t]], the
// shared rate model (physics_grad.cuh, the expressions of physics.cuh),
// the strict finish branch
//     dt = remaining > scen ln ? ln : remaining / scen   (scen = max(sps, 1e-30))
//     dt = remaining > 0 ? dt : 0
// the carried remaining -= scen_per_s dt (the unclamped rate), and the
// sums: runtime, kWh, CO2 of each of E carbon members (E = 0: one trace),
// cost.  Physics at the compute type T (double, or float for
// `precision="mixed"`), the carried state and the sums in double, as the
// plain version casts.
//
// Backward: the same members, the slots in reverse.  Each slot's physics
// is recomputed from u and the slot's starting remaining, which the
// forward checkpointed ((T, N) doubles); the adjoint of remaining is
// carried back, and d/du of the slot's scen_per_s and kWh rate is summed
// into the member's own day bin, so members never share an output.
//
// What bounds it: the work is N x T lane-slots of ~40 fp64 operations
// (two `pow` among them) and a few bytes each, ~1e-4 ms of the card at
// N = 256; the kernel's time is one thread's chain over T slots.  The
// physics does not depend on the carried state, so the forward computes
// it for a tile of W slots at once (branch-free: independent `pow`s and
// divisions interleave) and then runs the tile's short chain; the
// backward recomputes a slot's physics and its derivative in the same
// way, one slot at a time.
#include "physics_grad.cuh"

using carina::Phys;
using carina::RatesFwd;

namespace {

constexpr int W = 4;       // slots a forward tile
constexpr int EREG = 8;    // carbon members kept in registers

// The workload and machine scalars, shared by every member.
struct Scalars {
  double n_scen, rate, oh, idle, dyn, alpha, gamma, ohf, batch;
};

template <typename T>
__device__ __forceinline__ Phys<T> phys(const Scalars& s) {
  return {T(s.rate), T(s.oh), T(s.idle), T(s.dyn), T(s.alpha), T(s.gamma),
          T(s.ohf)};
}

// Threads a block: 128, or 64 or 32 where 128 would leave SMs without a
// block (the members' chains are independent; more blocks, more SMs).
int plan_threads(int n, int sms) {
  if ((n + 127) / 128 >= sms) return 128;
  if ((n + 63) / 64 >= sms) return 64;
  return 32;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// EC = max(E, 1) carbon sums (E = 0: a single trace, co2 (N,), cf (T,));
// ER > 0 keeps EC <= ER sums in registers, ER = 0 sums them in the output
// row.
template <typename T, int ER>
__global__ void __launch_bounds__(128)
    trace_fwd_kernel(const double* __restrict__ u,
                     const int* __restrict__ rowidx,
                     const T* __restrict__ bg, const T* __restrict__ cf,
                     const T* __restrict__ pr, const T* __restrict__ lens,
                     Scalars s, double* __restrict__ kwh_o,
                     double* __restrict__ co2_o, double* __restrict__ rt_o,
                     double* __restrict__ cost_o, double* __restrict__ unf_o,
                     double* __restrict__ rem_hist, int N, int S, int TT,
                     int EC) {
  constexpr int NR = ER > 0 ? ER : 1;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Phys<T> p = phys<T>(s);
  const T batch = T(s.batch);
  const double* urow = u + (size_t)n * S;
  double* co2row = co2_o + (size_t)n * EC;
  double R = s.n_scen, rt = 0.0, kwh = 0.0, cost = 0.0;
  double co2[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) co2[j] = 0.0;
  if (ER == 0)
    for (int j = 0; j < EC; ++j) co2row[j] = 0.0;

  for (int t0 = 0; t0 < TT; t0 += W) {
    T sps[W], kw[W], scen[W], ln[W];
    // the tile's physics: independent of the carried state
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int t = min(t0 + i, TT - 1);
      const T ut = T(urow[rowidx[t]]);
      const RatesFwd<T> q = carina::rates_fwd<T>(ut, batch, bg[t], p);
      sps[i] = q.sps;
      kw[i] = q.kwh;
      scen[i] = carina::xmax(q.sps, T(1e-30));
      ln[i] = lens[t];
    }
    // the tile's chain
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int t = t0 + i;
      if (t >= TT) break;
      if (rem_hist) rem_hist[(size_t)t * N + n] = R;
      const T w = scen[i] * ln[i];
      double dt = R > (double)w ? (double)ln[i] : R / (double)scen[i];
      dt = R > 0.0 ? dt : 0.0;
      const double e = (double)kw[i] * dt;
      R = R - (double)sps[i] * dt;
      rt += dt;
      kwh += e;
      cost += e * (double)pr[t];
      const T* cft = cf + (size_t)t * EC;
      if (ER > 0) {
#pragma unroll
        for (int j = 0; j < NR; ++j)
          if (j < EC) co2[j] += e * (double)cft[j];
      } else {
        for (int j = 0; j < EC; ++j) co2row[j] += e * (double)cft[j];
      }
    }
  }
  kwh_o[n] = kwh;
  rt_o[n] = rt / 3600.0;
  cost_o[n] = cost;
  unf_o[n] = R / s.n_scen;
  if (ER > 0) {
#pragma unroll
    for (int j = 0; j < NR; ++j)
      if (j < EC) co2row[j] = co2[j];
  }
}

// The gradient of sum(g_kwh kwh + g_co2 . co2 + g_rt runtime_h +
// g_cost cost + g_unf unfinished) with respect to u_day, added into g_u
// (N, S) (zeroed by the caller).  A null gradient is a zero gradient.
template <typename T>
__global__ void __launch_bounds__(128)
    trace_bwd_kernel(const double* __restrict__ u,
                     const int* __restrict__ rowidx,
                     const T* __restrict__ bg, const T* __restrict__ cf,
                     const T* __restrict__ pr, const T* __restrict__ lens,
                     Scalars s, const double* __restrict__ rem_hist,
                     const double* __restrict__ g_kwh,
                     const double* __restrict__ g_co2,
                     const double* __restrict__ g_rt,
                     const double* __restrict__ g_cost,
                     const double* __restrict__ g_unf,
                     double* __restrict__ g_u, int N, int S, int TT, int EC) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Phys<T> p = phys<T>(s);
  const T batch = T(s.batch);
  const double* urow = u + (size_t)n * S;
  double* grow = g_u + (size_t)n * S;
  const double* gco2 = g_co2 ? g_co2 + (size_t)n * EC : nullptr;
  const double gk = g_kwh ? g_kwh[n] : 0.0;
  const double gc = g_cost ? g_cost[n] : 0.0;
  const double grt = g_rt ? g_rt[n] / 3600.0 : 0.0;
  double lam = g_unf ? g_unf[n] / s.n_scen : 0.0;   // d loss / d remaining
  for (int t = TT - 1; t >= 0; --t) {
    const int day = rowidx[t];
    const RatesFwd<T> q = carina::rates_fwd<T>(T(urow[day]), batch, bg[t], p);
    const T scen = carina::xmax(q.sps, T(1e-30));
    const T ln = lens[t];
    const T w = scen * ln;
    const double R = rem_hist[(size_t)t * N + n];
    const bool live = R > 0.0;
    const bool fin = live && !(R > (double)w);
    const double dt = live ? (fin ? R / (double)scen : (double)ln) : 0.0;
    // d loss / d e of this slot (e = kwh_per_s dt)
    double ge = gk + gc * (double)pr[t];
    if (gco2) {
      const T* cft = cf + (size_t)t * EC;
      for (int j = 0; j < EC; ++j) ge += gco2[j] * (double)cft[j];
    }
    // remaining' = remaining - sps dt; runtime += dt; e = kwh dt
    const double gdt = grt + ge * (double)q.kwh - lam * (double)q.sps;
    const double g_sps = -lam * dt;
    const double g_kw = ge * dt;
    double g_scen = 0.0;
    if (fin) {   // dt = remaining / scen
      g_scen = -gdt * (dt / (double)scen);
      lam += gdt / (double)scen;
    }
    const T gs = T(g_sps) + T(g_scen) * carina::tie_max(q.sps, T(1e-30));
    const T gp = T(g_kw) / T(3.6e6);
    grow[day] += (double)carina::rates_vjp<T>(q, p, batch, gs, gp);
  }
}

template <typename T>
int launch_fwd(const double* u, const int* rowidx, const void* bg,
               const void* cf, const void* pr, const void* lens, Scalars s,
               double* kwh, double* co2, double* rt, double* cost, double* unf,
               double* rem_hist, int N, int S, int TT, int EC,
               cudaStream_t stream) {
  const int threads = plan_threads(N, sm_count());
  const int blocks = (N + threads - 1) / threads;
  const T* b = static_cast<const T*>(bg);
  const T* c = static_cast<const T*>(cf);
  const T* r = static_cast<const T*>(pr);
  const T* l = static_cast<const T*>(lens);
  if (EC <= 1)
    trace_fwd_kernel<T, 1><<<blocks, threads, 0, stream>>>(
        u, rowidx, b, c, r, l, s, kwh, co2, rt, cost, unf, rem_hist, N, S,
        TT, EC);
  else if (EC <= 4)
    trace_fwd_kernel<T, 4><<<blocks, threads, 0, stream>>>(
        u, rowidx, b, c, r, l, s, kwh, co2, rt, cost, unf, rem_hist, N, S,
        TT, EC);
  else if (EC <= EREG)
    trace_fwd_kernel<T, EREG><<<blocks, threads, 0, stream>>>(
        u, rowidx, b, c, r, l, s, kwh, co2, rt, cost, unf, rem_hist, N, S,
        TT, EC);
  else
    trace_fwd_kernel<T, 0><<<blocks, threads, 0, stream>>>(
        u, rowidx, b, c, r, l, s, kwh, co2, rt, cost, unf, rem_hist, N, S,
        TT, EC);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const double* u, const int* rowidx, const void* bg,
               const void* cf, const void* pr, const void* lens, Scalars s,
               const double* rem_hist, const double* g_kwh,
               const double* g_co2, const double* g_rt, const double* g_cost,
               const double* g_unf, double* g_u, int N, int S, int TT, int EC,
               cudaStream_t stream) {
  const int threads = plan_threads(N, sm_count());
  const int blocks = (N + threads - 1) / threads;
  trace_bwd_kernel<T><<<blocks, threads, 0, stream>>>(
      u, rowidx, static_cast<const T*>(bg), static_cast<const T*>(cf),
      static_cast<const T*>(pr), static_cast<const T*>(lens), s, rem_hist,
      g_kwh, g_co2, g_rt, g_cost, g_unf, g_u, N, S, TT, EC);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (ctypes).  `scal` holds n_scen, rate_at_full,
// batch_overhead_s, idle_w, dyn_w, alpha, gamma, overhead_w_frac and the
// batch size; the series bg, cf ((T,) or (T, E)), pr and lens are in the
// compute type (f64: double, f32: float); everything else is double but
// `rowidx` (int32).  Returns the CUDA error of the launch (0: launched).
#define TRACE_FWD_ARGS                                                     \
  const double *u, const int *rowidx, const void *bg, const void *cf,      \
      const void *pr, const void *lens, const double *scal, double *kwh,   \
      double *co2, double *rt, double *cost, double *unf, double *rem_hist, \
      int N, int S, int TT, int EC, void *stream
#define TRACE_FWD_PASS                                                     \
  u, rowidx, bg, cf, pr, lens, scalars(scal), kwh, co2, rt, cost, unf,     \
      rem_hist, N, S, TT, EC, static_cast<cudaStream_t>(stream)
#define TRACE_BWD_ARGS                                                     \
  const double *u, const int *rowidx, const void *bg, const void *cf,      \
      const void *pr, const void *lens, const double *scal,                \
      const double *rem_hist, const double *g_kwh, const double *g_co2,    \
      const double *g_rt, const double *g_cost, const double *g_unf,       \
      double *g_u, int N, int S, int TT, int EC, void *stream
#define TRACE_BWD_PASS                                                     \
  u, rowidx, bg, cf, pr, lens, scalars(scal), rem_hist, g_kwh, g_co2,      \
      g_rt, g_cost, g_unf, g_u, N, S, TT, EC,                              \
      static_cast<cudaStream_t>(stream)

static Scalars scalars(const double* v) {
  return {v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8]};
}

extern "C" int trace_scan_fwd_f64(TRACE_FWD_ARGS) {
  if (N == 0) return 0;
  return launch_fwd<double>(TRACE_FWD_PASS);
}
extern "C" int trace_scan_fwd_f32(TRACE_FWD_ARGS) {
  if (N == 0) return 0;
  return launch_fwd<float>(TRACE_FWD_PASS);
}
extern "C" int trace_scan_bwd_f64(TRACE_BWD_ARGS) {
  if (N == 0) return 0;
  return launch_bwd<double>(TRACE_BWD_PASS);
}
extern "C" int trace_scan_bwd_f32(TRACE_BWD_ARGS) {
  if (N == 0) return 0;
  return launch_bwd<float>(TRACE_BWD_PASS);
}
