// The shared rate/power model (core/model.py) for the chunk kernels.
//
// One definition per expression of `model.rates`, `model.power_w` and
// `model.site_throttle`, templated on the compute type: `double` for
// fp64 plans, `float` for `precision="mixed"` (fp32 physics; the carried
// scan state stays `double` in the kernels either way).  Python float
// constants become `T(...)`, which is what NumPy and JAX do with a weak
// scalar next to an fp32 array.  Every expression keeps the reference's
// operand order; `nvcc` may still contract a*b+c into one FMA (see the
// note in each kernel source on whether that matters for parity).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace carina {

constexpr double CONTENTION_FLOOR = 0.05;
constexpr double RATE_EPS = 1e-9;
constexpr double SITE_THROTTLE_FLOOR = 0.05;

__device__ __forceinline__ float xmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double xmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float xmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double xmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float xpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double xpow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float xfloor(float a) { return floorf(a); }
__device__ __forceinline__ double xfloor(double a) { return floor(a); }
__device__ __forceinline__ float xabs(float a) { return fabsf(a); }
__device__ __forceinline__ double xabs(double a) { return fabs(a); }

// Per-lane machine/workload scalars of `model.rates`.
template <typename T>
struct Phys {
  T rate, oh, idle, dyn, alpha, gamma, ohf;
};

// The three `Rates` fields the scan reads.
template <typename T>
struct Rates {
  T scen_per_s, p_avg_w, kwh_per_s;
};

// model.power_w: idle + dyn * max(load, 0)^alpha
template <typename T>
__device__ __forceinline__ T power_w(T load, T idle, T dyn, T alpha) {
  return idle + dyn * xpow(xmax(load, T(0)), alpha);
}

// model.rates at one operating point.
template <typename T>
__device__ __forceinline__ Rates<T> rates(T u, T batch, T bg,
                                          const Phys<T>& p) {
  T r_eff = p.rate * u * xmax(T(1) - p.gamma * bg, T(CONTENTION_FLOOR));
  T work_t = batch / xmax(r_eff, T(RATE_EPS));
  T batch_time = p.oh + work_t;
  T scen_per_s = batch / batch_time;
  T work_frac = work_t / batch_time;
  T p_work = power_w(u + bg, p.idle, p.dyn, p.alpha);
  T p_oh = power_w(p.ohf * u + bg, p.idle, p.dyn, p.alpha);
  T p_avg = work_frac * p_work + (T(1) - work_frac) * p_oh;
  return {scen_per_s, p_avg, p_avg / T(3.6e6)};
}

// model.site_throttle: one damped fixed-point step of the curtailment
// factor.  An infinite headroom gives f' = min(inf, 1) = 1 exactly.
template <typename T>
__device__ __forceinline__ T site_throttle(T fleet_kw, T base_kw,
                                           T headroom_kw, T f) {
  T shed_target = xmax(headroom_kw - base_kw, T(0));
  T shed = xmax(fleet_kw - base_kw, T(RATE_EPS));
  return xmax(xmin(f * shed_target / shed, T(1)), T(SITE_THROTTLE_FLOOR));
}

}  // namespace carina
