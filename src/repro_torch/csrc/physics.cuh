// The shared rate/power model (core/model.py) for the chunk kernels.
//
// One definition per expression of `model.rates`, `model.power_w` and
// `model.site_throttle`, templated on the compute type: `double` for
// fp64 plans, `float` for `precision="mixed"` (fp32 physics; the carried
// scan state stays `double` in the kernels either way).  Python float
// constants become `T(...)`, which is what NumPy and JAX do with a weak
// scalar next to an fp32 array.  Every expression keeps the reference's
// operand order; `nvcc` may still contract a*b+c into one FMA, and the
// divisions and powers below are within one and a few ulp of the
// correctly rounded result (chip_smoke.py reports the error they leave
// against the plain PyTorch versions).
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

// Branch-free division and power for the model's operands.  CUDA's `/`
// and `pow` branch to slow paths for special operands, so the compiler
// schedules each call as a region of its own and the two power terms of
// `rates` and their divisions run one after another.  These take only
// selects, so independent calls interleave.

// a / b for b positive, normal and finite, and a / b finite: the
// reciprocal's hardware approximation, two Newton steps and one
// correction of the quotient (within one ulp of the rounded quotient).
__device__ __forceinline__ double div_pos(double a, double b) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(b));
  y = fma(fma(-b, y, 1.0), y, y);
  y = fma(fma(-b, y, 1.0), y, y);
  const double q = a * y;
  return fma(fma(-b, q, a), y, q);
}
__device__ __forceinline__ float div_pos(float a, float b) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(b));
  y = fmaf(fmaf(-b, y, 1.f), y, y);
  const float q = a * y;
  return fmaf(fmaf(-b, q, a), y, q);
}

constexpr double LN2_HI = 6.93147180369123816490e-01;  // 32 zero low bits
constexpr double LN2_LO = 1.90821492927058770002e-10;

// ln a for a > 0 finite: a = m 2^e with m in [sqrt(1/2), sqrt(2)),
// ln m = 2 atanh(s), s = (m - 1) / (m + 1), |s| < 0.172, by its series to
// s^21 (truncation below 3e-17 relative).
__device__ __forceinline__ double log_pos(double a) {
  const bool tiny = a < 2.2250738585072014e-308;         // subnormal
  long long i = __double_as_longlong(tiny ? a * 18014398509481984.0 : a);
  int e = (int)(i >> 52) - 1023 - (tiny ? 54 : 0);
  double m = __longlong_as_double((i & 0x000fffffffffffffLL) |
                                  0x3ff0000000000000LL);
  const bool big = m > 1.4142135623730951;
  m = big ? 0.5 * m : m;
  e += big ? 1 : 0;
  const double s = div_pos(m - 1.0, m + 1.0);
  const double z = s * s, z2 = z * z, z4 = z2 * z2;
  const double p =
      (fma(1.0 / 5, z, 1.0 / 3) + z2 * fma(1.0 / 9, z, 1.0 / 7)) +
      z4 * ((fma(1.0 / 13, z, 1.0 / 11) + z2 * fma(1.0 / 17, z, 1.0 / 15)) +
            z4 * fma(1.0 / 21, z, 1.0 / 19));
  const double s2 = 2.0 * s;
  const double ed = (double)e;
  return fma(ed, LN2_HI, fma(ed, LN2_LO, fma(s2, z * p, s2)));
}

// e^y for finite y: y = k ln 2 + r, |r| <= ln 2 / 2, e^r by its Taylor
// series to r^12 (truncation below 2e-16), 2^k from its bits; 0 below
// -708 (no subnormal results).
__device__ __forceinline__ double exp_fin(double y) {
  const double k = fmin(fmax(rint(y * 1.4426950408889634), -1022.0), 1023.0);
  const double r = fma(k, -LN2_LO, fma(k, -LN2_HI, y));
  const double r2 = r * r, r4 = r2 * r2, r8 = r4 * r4;
  const double p =
      (fma(r, 1.0, 1.0) + r2 * fma(r, 1.0 / 6, 1.0 / 2)) +
      r4 * (fma(r, 1.0 / 120, 1.0 / 24) + r2 * fma(r, 1.0 / 5040, 1.0 / 720)) +
      r8 * ((fma(r, 1.0 / 362880, 1.0 / 40320) +
             r2 * fma(r, 1.0 / 39916800, 1.0 / 3628800)) +
            r4 * (1.0 / 479001600));
  const double scale =
      __longlong_as_double((long long)((int)k + 1023) << 52);
  return y < -708.0 ? 0.0 : p * scale;
}

// fp64 a^b for a >= 0 (the model's loads are max(load, 0)) or NaN:
// exp(b ln a), within a few ulp for the model's bases and exponents
// (|b ln a| below ~20), where `pow` carries a double-double logarithm;
// a == 0 gives pow's 0, 1 or inf.
__device__ __forceinline__ double xpow(double a, double b) {
  const double pos = exp_fin(b * log_pos(a > 0.0 ? a : 1.0));
  const double zero = b > 0.0 ? 0.0 : (b == 0.0 ? 1.0 : INFINITY);
  return a > 0.0 ? pos : (a == 0.0 ? zero : a);
}

// fp32 a^b: `powf`, or (CHAIN) the branch-free fp64 power rounded to
// fp32, for a kernel whose time is one thread's dependent chain (K1)
// rather than its throughput.  (exp(b ln a) in fp32 would round b ln a,
// up to ~10 in size here, to fp32: ~6e-7 in the power, too near the
// mixed bar of 1e-6.)
template <bool CHAIN>
__device__ __forceinline__ float xpow(float a, float b) {
  if constexpr (CHAIN)
    return (float)xpow((double)a, (double)b);
  else
    return powf(a, b);
}
template <bool CHAIN>
__device__ __forceinline__ double xpow(double a, double b) {
  return xpow(a, b);
}

// The model's divisions, for a positive normal divisor and a finite
// quotient.
template <typename T>
__device__ __forceinline__ T xdiv(T a, T b) {
  return div_pos(a, b);
}
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
template <typename T, bool CHAIN = false>
__device__ __forceinline__ T power_w(T load, T idle, T dyn, T alpha) {
  return idle + dyn * xpow<CHAIN>(xmax(load, T(0)), alpha);
}

// The part of `model.rates` the site throttle iterates on: the batch
// time and the average draw at one operating point.
template <typename T>
struct Point {
  T batch_time, p_avg_w;
};
// The loads of the two power terms: at work and during the overhead.
template <typename T>
__device__ __forceinline__ T work_load(T u, T bg) {
  return u + bg;
}
template <typename T>
__device__ __forceinline__ T overhead_load(T u, T bg, const Phys<T>& p) {
  return p.ohf * u + bg;
}
// The operating point from its two power terms.
template <typename T>
__device__ __forceinline__ Point<T> point(T u, T batch, T bg,
                                          const Phys<T>& p, T p_work,
                                          T p_oh) {
  T r_eff = p.rate * u * xmax(T(1) - p.gamma * bg, T(CONTENTION_FLOOR));
  T work_t = xdiv(batch, xmax(r_eff, T(RATE_EPS)));
  T batch_time = p.oh + work_t;
  T work_frac = xdiv(work_t, batch_time);
  T p_avg = work_frac * p_work + (T(1) - work_frac) * p_oh;
  return {batch_time, p_avg};
}
template <typename T, bool CHAIN = false>
__device__ __forceinline__ Point<T> point(T u, T batch, T bg,
                                          const Phys<T>& p) {
  return point(
      u, batch, bg, p,
      power_w<T, CHAIN>(work_load(u, bg), p.idle, p.dyn, p.alpha),
      power_w<T, CHAIN>(overhead_load(u, bg, p), p.idle, p.dyn, p.alpha));
}

// model.rates from its operating point.
template <typename T>
__device__ __forceinline__ Rates<T> rates(const Point<T>& q, T batch) {
  return {xdiv(batch, q.batch_time), q.p_avg_w, xdiv(q.p_avg_w, T(3.6e6))};
}

// model.rates at one operating point.
template <typename T>
__device__ __forceinline__ Rates<T> rates(T u, T batch, T bg,
                                          const Phys<T>& p) {
  return rates(point(u, batch, bg, p), batch);
}

// model.site_throttle: one damped fixed-point step of the curtailment
// factor.  An infinite headroom gives f' = min(inf, 1) = 1 exactly.
template <typename T>
__device__ __forceinline__ T site_throttle(T fleet_kw, T base_kw,
                                           T headroom_kw, T f) {
  T shed_target = xmax(headroom_kw - base_kw, T(0));
  T shed = xmax(fleet_kw - base_kw, T(RATE_EPS));
  T num = f * shed_target;
  T ratio = num < T(INFINITY) ? xdiv(num, shed) : num;
  return xmax(xmin(ratio, T(1)), T(SITE_THROTTLE_FLOOR));
}

}  // namespace carina
