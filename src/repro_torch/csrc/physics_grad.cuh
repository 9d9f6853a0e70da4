// The shared rate/power model (core/model.py) with its reverse-mode
// derivative, for the optimizer's objective kernels (K3, K4).
//
// `rates_fwd` evaluates `model.rates` keeping every intermediate the
// backward needs; `rates_vjp` takes the gradients of the two fields the
// objectives read (`scen_per_s` and `p_avg_w`) back to the intensity
// `u`; `site_throttle_vjp` takes one damped `model.site_throttle` step
// back to its summed draw and its incoming factor.  Each derivative is
// the one `torch.autograd` takes through the plain PyTorch expressions
// (core/model.py), which is what the kernels' plain versions compute
// (kernels/objective_scan.py, kernels/fleet_objective.py):
// - every `maximum`/`minimum` passes its gradient to the larger/smaller
//   operand and splits it evenly at a tie (`tie_max`, `tie_min`), as
//   `torch.maximum`/`torch.minimum` and JAX's `jnp.maximum` do;
// - `x ** alpha` has the derivative `alpha * x ** (alpha - 1)`, so at
//   x = 0 it is 0 for alpha > 1, 1 for alpha = 1 and inf below, as
//   autograd's `pow` backward gives.
#pragma once

#include "physics.cuh"

namespace carina {

// d max(a, b) / da: 1 above, 1/2 at a tie, 0 below.
template <typename T>
__device__ __forceinline__ T tie_max(T a, T b) {
  return a > b ? T(1) : (a == b ? T(0.5) : T(0));
}
// d min(a, b) / da: 1 below, 1/2 at a tie, 0 above.
template <typename T>
__device__ __forceinline__ T tie_min(T a, T b) {
  return a < b ? T(1) : (a == b ? T(0.5) : T(0));
}

// `model.rates` at one operating point with its intermediates.
template <typename T>
struct RatesFwd {
  T c;        // max(1 - gamma bg, CONTENTION_FLOOR)
  T r_eff;    // rate u c
  T re;       // max(r_eff, RATE_EPS)
  T work_t;   // batch / re
  T bt;       // oh + work_t
  T wf;       // work_t / bt
  T lw, lo;   // the loads of the two power terms, before the clamp
  T pw, po;   // the two power terms
  T pavg;     // p_avg_w
  T sps;      // scen_per_s
  T kwh;      // kwh_per_s
};

template <typename T, bool CHAIN = false>
__device__ __forceinline__ RatesFwd<T> rates_fwd(T u, T batch, T bg,
                                                 const Phys<T>& p) {
  RatesFwd<T> q;
  q.c = xmax(T(1) - p.gamma * bg, T(CONTENTION_FLOOR));
  q.r_eff = p.rate * u * q.c;
  q.re = xmax(q.r_eff, T(RATE_EPS));
  q.work_t = xdiv(batch, q.re);
  q.bt = p.oh + q.work_t;
  q.wf = xdiv(q.work_t, q.bt);
  q.lw = work_load(u, bg);
  q.lo = overhead_load(u, bg, p);
  q.pw = p.idle + p.dyn * xpow<CHAIN>(xmax(q.lw, T(0)), p.alpha);
  q.po = p.idle + p.dyn * xpow<CHAIN>(xmax(q.lo, T(0)), p.alpha);
  q.pavg = q.wf * q.pw + (T(1) - q.wf) * q.po;
  q.sps = xdiv(batch, q.bt);
  q.kwh = xdiv(q.pavg, T(3.6e6));
  return q;
}

// d/du of g_sps * scen_per_s + g_pavg * p_avg_w at the point `q`.
template <typename T, bool CHAIN = false>
__device__ __forceinline__ T rates_vjp(const RatesFwd<T>& q, const Phys<T>& p,
                                       T batch, T g_sps, T g_pavg) {
  // p_avg = wf pw + (1 - wf) po
  const T g_wf = g_pavg * (q.pw - q.po);
  const T g_pw = g_pavg * q.wf;
  const T g_po = g_pavg * (T(1) - q.wf);
  // pw = idle + dyn max(lw, 0)^alpha, lw = u + bg; po at lo = ohf u + bg
  const T mw = xmax(q.lw, T(0)), mo = xmax(q.lo, T(0));
  const T am1 = p.alpha - T(1);
  const T g_mw = g_pw * p.dyn * (p.alpha * xpow<CHAIN>(mw, am1));
  const T g_mo = g_po * p.dyn * (p.alpha * xpow<CHAIN>(mo, am1));
  T g_u = g_mw * tie_max(q.lw, T(0)) + g_mo * tie_max(q.lo, T(0)) * p.ohf;
  // sps = batch / bt, wf = work_t / bt, bt = oh + work_t
  const T g_bt = -(g_sps * batch) / (q.bt * q.bt) - g_wf * q.wf / q.bt;
  const T g_work = g_wf / q.bt + g_bt;
  // work_t = batch / re, re = max(r_eff, RATE_EPS), r_eff = rate u c
  const T g_re = -g_work * q.work_t / q.re;
  const T g_reff = g_re * tie_max(q.r_eff, T(RATE_EPS));
  return g_u + g_reff * p.rate * q.c;
}

// The gradients of one `site_throttle(fleet_kw, base_kw, headroom_kw, f)`
// step (finite headroom) with respect to `fleet_kw` and `f`.
struct ThrottleGrad {
  double g_fleet, g_f;
};
__device__ __forceinline__ ThrottleGrad site_throttle_vjp(double fleet_kw,
                                                          double base_kw,
                                                          double headroom_kw,
                                                          double f,
                                                          double g_out) {
  const double shed_target = xmax(headroom_kw - base_kw, 0.0);
  const double d = fleet_kw - base_kw;
  const double shed = xmax(d, RATE_EPS);
  const double ratio = xdiv(f * shed_target, shed);
  const double y = xmin(ratio, 1.0);
  const double g_ratio =
      g_out * tie_max(y, SITE_THROTTLE_FLOOR) * tie_min(ratio, 1.0);
  const double g_shed = -g_ratio * ratio / shed;
  return {g_shed * tie_max(d, RATE_EPS), g_ratio / shed * shed_target};
}

}  // namespace carina
