// K1: the site-coupled chunk step of the trace-scan engine, for Hopper.
//
// Replaces the Pallas kernel `coupled_chunk` (`_kernel`) of
// src/repro/kernels/coupled_throttle.py: one chunk of C slots for the
// lanes of capped fleet groups, in the dense (G, Lp) layout that the
// engine repacks them into (`_run_chunk_coupled` in core/engine_torch.py,
// as `_run_chunk_coupled_pallas` does in the reference), with the
// decision rows pre-gathered to (G, Lp, C, B).
//
// Computation: lanes live in threads and a group in a contiguous segment
// of Lp threads.  With Lp <= 32 (a power of two) a warp holds one or
// more whole groups and the per-slot group sums are xor-butterfly
// shuffles inside each Lp-wide segment (every thread ends with the same,
// bitwise identical total: each butterfly level adds a+b, which is
// commutative).  With Lp > 32 a group has a block of Lp threads, and the
// sum is a warp butterfly followed by a fixed-order sum of the warp
// totals in shared memory.  Per slot: hat-weight interpolation over the
// B progress buckets (only the two nonzero hats are evaluated: the
// Pallas body's sum over all B adds exact zeros), `model.rates`, the
// group sums of the active lanes' base and average draw, up to
// `SITE_THROTTLE_ITERS` damped `site_throttle` steps each re-summing the
// draw at the new factor, dt = min(len, remaining / scen_per_s),
// kWh/CO2[E]/cost accumulation and the running site peak.  A warp (or
// block) stops when none of its lanes has remaining > 0; later slots are
// no-ops for it.  Padded lanes carry remaining 0, n_scen 1, alpha 1
// (inactive, finite physics); padded groups carry cap = +inf, for which
// site_throttle returns f = 1 exactly.
//
// What bounds it on an NVIDIA H100 80GB HBM3 at 700.00 W, measured
// (PERF.md §5, `python -m repro_torch.kernels.ablate`):
// not memory (48 B of rows and series a lane-slot) and not the fp64
// units, but the latency of one dependent chain a slot.  The first design
// took 0.790 ms on the ablation's (512, 8, 96, 1) chunk, ~16,000 cycles
// a slot: 0.380 with the fp32 intrinsic in place of each fp64 `pow`
// (the double-double `pow`, 11 a lane-slot, called as a function, was
// half of it), 0.400 with one throttle step instead of four, 0.247 with
// no physics at all (group sums, throttle divisions, the CO2 sums in
// global memory, loads started behind the slot's vote).  Its 32 blocks
// of 128 threads held 32 of the 132 SMs, one warp to a scheduler.  Now a
// throttle step costs ~1,100 cycles of one group's chain (a `pow`, two
// divisions, a shuffle sum, the vote), and K1 is ~27x its bytes bound.
//
// Design, each step shortening the chain of a slot:
// - Powers and divisions are branch-free (physics.cuh: exp(b ln a) and
//   reciprocal-Newton quotients; fp32 powers through the fp64 path,
//   which is exact enough for the mixed bar where exp(b ln a) in fp32
//   is not), so independent ones interleave: the two power terms of an
//   operating point run side by side with its divisions.
// - The throttle loop evaluates only the operating point it iterates on
//   (batch time and draw, `carina::point`); the throughput division
//   follows once, after the loop.  The kW sums take x 1e-3 for the
//   reference's / 1000 (within an ulp).
// - The fixed point stops exactly.  When a `site_throttle` step returns
//   the factor f the current operating point was computed with, bit for
//   bit, every later step returns the same f and the same point (the
//   group sums are bitwise identical across the group), so the group
//   leaves the loop there: under the cap, in every uncapped or padded
//   group, and where the iteration has converged.  A group that leaves
//   keeps joining the warp's shuffles as an idle segment until no group
//   of the warp steps again (`__shfl_xor_sync` takes the full mask).
// - Inputs are loaded two slots ahead into registers.  With B == 1 (a
//   template instance) a slot's first operating point and base draw
//   depend on its inputs alone and are computed during the slot before,
//   interleaved with that slot's group sums (which take five butterfly
//   levels without a branch for that).  With B > 1 the bucket depends on
//   the progress the slot makes: the buckets b0 .. b0+2 around the
//   current one are loaded, a slot whose bucket moved past them loads its
//   rows directly, and its first point follows its progress.
// - A warp serves one group while the card has room (`plan`: up to 8
//   warps an SM), so it runs each slot's throttle loop only as long as
//   its own group needs; more groups share a warp only past that.  The
//   warp's other threads are replicas of the group's lanes; with four or
//   more (Lp <= 8), each operating point's two power terms and the base
//   draw are computed one a replica and gathered by shuffles, so a
//   thread's chain holds one `pow` where it held three.
// - The CO2 sum of one member lives in a register (the benchmark's E);
//   more members take the general path, in the output row.
//
// Parity: fp64 within 1e-9 relative of the reference per lane, mixed
// within 1e-6 of fp64 (chip_smoke.py checks both on the card).
#include "physics.cuh"

using carina::Phys;
using carina::Point;
using carina::Rates;

namespace {

// Sum of `v` over the thread's group (see the design note above), in
// log2(Lp) butterfly levels (Lp <= 32) or a block reduction (WARP false).
template <bool WARP, typename T>
__device__ __forceinline__ T group_sum(T v, int Lp, T* red) {
  if constexpr (WARP) {
    for (int off = Lp >> 1; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
  } else {
#pragma unroll
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
}

// Two group sums side by side, the same butterflies interleaved.  With
// WARP, five levels whatever Lp, the levels at and above Lp adding an
// exact 0 (the real levels keep their order Lp/2, ..., 1): no branch, so
// the sums interleave with independent work (the next slot's first
// operating point).
template <bool WARP, typename T>
__device__ __forceinline__ void group_sum2(T& a, T& b, int Lp, T* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T x = __shfl_xor_sync(0xffffffffu, a, off);
    const T y = __shfl_xor_sync(0xffffffffu, b, off);
    a += !WARP || off < Lp ? x : T(0);
    b += !WARP || off < Lp ? y : T(0);
  }
  if constexpr (!WARP) {
    const int nw = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[threadIdx.x >> 5] = a;
      red[32 + (threadIdx.x >> 5)] = b;
    }
    __syncthreads();
    a = red[0];
    b = red[32];
    for (int i = 1; i < nw; ++i) {
      a += red[i];
      b += red[32 + i];
    }
    __syncthreads();
  }
}

// One slot's inputs of one lane.  `u`/`b` hold bucket b0's row value
// (B == 1: the only one) and, for B > 1, those of b0 + 1 and b0 + 2
// (clamped to B - 1).
template <typename T, int EC>
struct SlotIn {
  T u[3], b[3], bg, off, pr, cf[EC > 0 ? EC : 1];
  double len;
  int b0;
};

// The progress bucket of the hat interpolation at `rem`: x clamped to
// [0, B - 1] and b0 = floor(x), at most B - 2.
template <typename T>
__device__ __forceinline__ int bucket(double rem, T nsc, int B, T& x) {
  const T prog = (T)(1.0 - carina::xdiv(rem, (double)nsc));
  x = prog * T(B) - T(0.5);
  x = x < T(0) ? T(0) : (x > T(B - 1) ? T(B - 1) : x);
  const int b0 = (int)carina::xfloor(x);
  return b0 > B - 2 ? B - 2 : b0;
}

}  // namespace

// B1: one progress bucket (the decision row does not depend on the
// progress, so a slot's first operating point depends on its inputs
// alone and is computed during the slot before it).
// SPLIT (WARP, four or more replicas of each lane): the power terms of
// an operating point, and the base draw, are shared out over the lane's
// replicas, one each, and gathered by shuffles.
template <typename T, int EC, bool B1, bool WARP, bool SPLIT>
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
    int Lp, int C, int B, int E, int iters, double finish_frac, int gpw,
    unsigned int* __restrict__ hist) {
  __shared__ T red[64];
  // With WARP a warp holds gpw whole groups in its first span = gpw * Lp
  // threads, and 32 / span replicas of them: replica k of a lane is
  // thread gl + k * span.  Every replica computes what the lane computes
  // (the group sums inside each replica's Lp-wide segments are the same
  // sums); only replica 0 writes.
  const int span = WARP ? gpw * Lp : 0;
  const int tw = threadIdx.x & 31;
  const int k = WARP ? tw / span : 0, gl = WARP ? tw % span : 0;
  const int g = WARP ? ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * gpw +
                           gl / Lp
                     : (int)blockIdx.x;
  const int lane = WARP ? gl % Lp : (int)threadIdx.x;
  // threads past the last group keep joining the shuffles as idle lanes;
  // they read group 0's inputs and take no step
  const bool valid = g < G;
  const size_t L = valid ? (size_t)g * Lp + lane : 0;
  const size_t gg = valid ? (size_t)g : 0;
  Phys<T> p = {T(0), T(0), T(0), T(0), T(1), T(0), T(0)};
  T nsc = T(1), cap = T(0);
  double rem = 0.0, rt = 0.0, kwh = 0.0, cost = 0.0, speak = 0.0;
  double co2[EC > 0 ? EC : 1];
  if (valid) {
    p = {rate[L], oh[L], idle[L], dyn[L], alpha[L], gamma[L], ohfrac[L]};
    nsc = n_scen[L];
    cap = cap_g[g];
    rem = rem_in[L];
    rt = rt_in[L];
    kwh = kwh_in[L];
    cost = cost_in[L];
    speak = speak_in[L];
    if constexpr (EC > 0) {
#pragma unroll
      for (int e = 0; e < EC; ++e) co2[e] = co2_in[L * EC + e];
    } else {
      for (int e = 0; e < E; ++e) co2_out[L * E + e] = co2_in[L * E + e];
    }
  }
  const T thr = T(finish_frac) * nsc;
  // the bits of this thread's group in a warp ballot (Lp <= 32)
  const int seg = (threadIdx.x & 31) & ~(Lp - 1);
  const unsigned seg_mask = Lp >= 32 ? 0xffffffffu : (1u << Lp) - 1u;

  // slot t's inputs (t clamped to the chunk: no branch around the loads)
  auto fetch = [&](int t, int b0) {
    SlotIn<T, EC> in;
    t = min(t, C - 1);
    const size_t s = L * C + t;
    const T* ur = u_rows + s * B;
    const T* br = b_rows + s * B;
    if constexpr (B1) {
      in.u[0] = ur[0];
      in.b[0] = br[0];
    } else {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int i = min(b0 + d, B - 1);
        in.u[d] = ur[i];
        in.b[d] = br[i];
      }
    }
    in.b0 = b0;
    in.bg = bg[s];
    in.off = office[gg * C + t];
    in.pr = pr[s];
    in.len = (double)lens[s];
#pragma unroll
    for (int e = 0; e < EC; ++e) in.cf[e] = cf[(L * EC + e) * C + t];
    return in;
  };
  auto base_w = [&](T bgt) {
    return carina::power_w<T, true>(bgt, p.idle, p.dyn, p.alpha);
  };
  // the operating point at (uu, bt, bgt) and, with `base`, the base draw
  auto point = [&](T uu, T bt, T bgt, T* base) {
    if constexpr (SPLIT) {  // one power term a replica, then gathered
      const int j = k % (base != nullptr ? 3 : 2);
      const T x = j == 0   ? carina::work_load(uu, bgt)
                  : j == 1 ? carina::overhead_load(uu, bgt, p)
                           : bgt;
      const T pw = carina::power_w<T, true>(x, p.idle, p.dyn, p.alpha);
      const T p_work = __shfl_sync(0xffffffffu, pw, gl);
      const T p_oh = __shfl_sync(0xffffffffu, pw, gl + span);
      if (base != nullptr)
        *base = __shfl_sync(0xffffffffu, pw, gl + 2 * span);
      return carina::point(uu, bt, bgt, p, p_work, p_oh);
    } else {
      if (base != nullptr) *base = base_w(bgt);
      return carina::point<T, true>(uu, bt, bgt, p);
    }
  };

  // inputs of slots t + 1 and t + 2 in flight; with B1 also slot t's
  // first operating point and base draw
  T x0;
  int b0 = B1 ? 0 : bucket(rem, nsc, B, x0);
  SlotIn<T, EC> nxt, nxt2;
  Point<T> qn = {T(1), T(0)};
  T bn = T(0);
  if (C > 0) {
    nxt = fetch(0, b0);
    nxt2 = fetch(1, b0);
    if constexpr (B1) qn = point(nxt.u[0], nxt.b[0], nxt.bg, &bn);
  }
  for (int t = 0; t < C; ++t) {
    const bool running = rem > 0.0;
    bool any, grp_any;
    if constexpr (WARP) {
      const unsigned bal = __ballot_sync(0xffffffffu, running);
      any = bal != 0u;
      grp_any = ((bal >> seg) & seg_mask) != 0u;
    } else {
      any = grp_any = __syncthreads_or(running);
    }
    if (!any) break;
    const SlotIn<T, EC> in = nxt;
    nxt = nxt2;
    T u, bt, basew;
    Point<T> q;
    if constexpr (B1) {
      u = in.u[0];
      bt = in.b[0];
      q = qn;
      basew = bn;
      nxt2 = fetch(t + 2, 0);
      // the next slot's first point, independent of this slot's chain
      qn = point(nxt.u[0], nxt.b[0], nxt.bg, &bn);
    } else {
      T x;
      b0 = bucket(rem, nsc, B, x);
      T u0, u1, v0, v1;
      if (b0 == in.b0) {  // the prefetched buckets
        u0 = in.u[0], u1 = in.u[1], v0 = in.b[0], v1 = in.b[1];
      } else if (b0 == in.b0 + 1) {
        u0 = in.u[1], u1 = in.u[2], v0 = in.b[1], v1 = in.b[2];
      } else {  // the bucket moved past them: load its rows now
        const size_t s = (L * C + t) * B;
        u0 = u_rows[s + b0], u1 = u_rows[s + b0 + 1];
        v0 = b_rows[s + b0], v1 = b_rows[s + b0 + 1];
      }
      const T w0 = carina::xmax(T(1) - carina::xabs(x - T(b0)), T(0));
      const T w1 = carina::xmax(T(1) - carina::xabs(x - T(b0 + 1)), T(0));
      u = u0 * w0 + u1 * w1;
      bt = v0 * w0 + v1 * w1;
      nxt2 = fetch(t + 2, b0);
      q = point(u, bt, in.bg, &basew);
    }
    const bool active = rem > (double)thr;
    // kW: x 1e-3 for the reference's / 1000 (within an ulp)
    T base = active ? basew * T(1e-3) : T(0);
    T draw = active ? q.p_avg_w * T(1e-3) : T(0);
    group_sum2<WARP>(base, draw, Lp, red);
    const T head = cap - in.off;
    T f = T(1);
    int steps = 0;
    bool done = !valid;
    for (int it = 0; it < iters; ++it) {
      // a fixed point, bit for bit (fn == f), repeats in every later step
      const T fn = carina::site_throttle(draw, base, head, f);
      const bool stepped = !done && fn != f;
      done = !stepped;
      if (WARP ? !__any_sync(0xffffffffu, stepped)
               : !__syncthreads_or(stepped))
        break;
      if (stepped) {
        f = fn;
        ++steps;
      }
      // every thread joins the shuffles; a group that has stopped keeps q
      const Point<T> qs = point(u * f, bt, in.bg, nullptr);
      if (stepped) q = qs;
      const T s =
          group_sum<WARP>(active ? q.p_avg_w * T(1e-3) : T(0), Lp, red);
      if (stepped) draw = s;
    }
    if (hist != nullptr && valid && lane == 0 && k == 0 && grp_any)
      atomicAdd(hist + steps, 1u);
    if (!valid) continue;
    const T site_kw = draw + in.off;
    const Rates<T> r2 = carina::rates(q, bt);
    const double dt =
        running ? fmin(in.len, carina::xdiv(rem, (double)carina::xmax(
                                                     r2.scen_per_s, T(1e-30))))
                : 0.0;
    const double en = (double)r2.kwh_per_s * dt;
    if (active) speak = fmax(speak, (double)site_kw);
    rem = rem - (double)r2.scen_per_s * dt;
    rt = rt + dt;
    kwh = kwh + en;
    if constexpr (EC > 0) {
#pragma unroll
      for (int e = 0; e < EC; ++e) co2[e] = co2[e] + en * (double)in.cf[e];
    } else {
      for (int e = 0; e < E; ++e)
        co2_out[L * E + e] =
            co2_out[L * E + e] + en * (double)cf[(L * E + e) * C + t];
    }
    cost = cost + en * (double)in.pr;
  }
  if (!valid || k != 0) return;
  rem_out[L] = rem;
  rt_out[L] = rt;
  kwh_out[L] = kwh;
  cost_out[L] = cost;
  speak_out[L] = speak;
  if constexpr (EC > 0) {
#pragma unroll
    for (int e = 0; e < EC; ++e) co2_out[L * EC + e] = co2[e];
  }
}

namespace {

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// The launch (kernels/coupled_chunk.py::launch_plan is the same rule):
// Lp above 32, one block of Lp threads a group.  Else gpw groups a warp,
// the fewest (a power of two, at most 32 / Lp) that keep the warps at
// 8 an SM or fewer: the kernel is one dependent chain a group, and a
// warp runs each slot's throttle loop as long as its slowest group, so
// while the card has room a warp serves one group.  Blocks of one warp
// below 4 warps an SM, of four from there.
struct Plan {
  int threads, blocks, gpw;
};
Plan plan(int G, int Lp, int sms) {
  if (Lp > 32) return {Lp, G, 1};
  int gpw = 1;
  while (gpw < 32 / Lp && (long long)G > 8LL * sms * gpw) gpw *= 2;
  const long long warps = (G + gpw - 1) / gpw;
  const int threads = warps >= 4LL * sms ? 128 : 32;
  return {threads, (int)((warps * 32 + threads - 1) / threads), gpw};
}

// The kernel instance for a launch: a block a group above 32 lanes, the
// power terms shared out where a lane has four replicas or more.
template <typename T, int EC, bool B1>
auto instance(int Lp, int gpw) {
  return Lp > 32 ? coupled_chunk_kernel<T, EC, B1, false, false>
         : 32 / (gpw * Lp) >= 4 ? coupled_chunk_kernel<T, EC, B1, true, true>
                                : coupled_chunk_kernel<T, EC, B1, true, false>;
}

template <typename T>
int launch(const void* const* ptr, void* const* out, int G, int Lp, int C,
           int B, int E, int iters, double finish_frac, void* hist,
           void* stream) {
  const Plan pl = plan(G, Lp, sm_count());
  // the CO2 sum of one member in a register; more members, the general
  // path (in the output row)
  auto kernel = E == 1 ? (B == 1 ? instance<T, 1, true>(Lp, pl.gpw)
                                 : instance<T, 1, false>(Lp, pl.gpw))
                       : (B == 1 ? instance<T, 0, true>(Lp, pl.gpw)
                                 : instance<T, 0, false>(Lp, pl.gpw));
  kernel<<<pl.blocks, pl.threads, 0, (cudaStream_t)stream>>>(
      (const T*)ptr[0], (const T*)ptr[1], (const T*)ptr[2], (const T*)ptr[3],
      (const T*)ptr[4], (const T*)ptr[5], (const T*)ptr[6], (const T*)ptr[7],
      (const double*)ptr[8], (const double*)ptr[9], (const double*)ptr[10],
      (const double*)ptr[11], (const double*)ptr[12], (const double*)ptr[13],
      (const T*)ptr[14], (const T*)ptr[15], (const T*)ptr[16],
      (const T*)ptr[17], (const T*)ptr[18], (const T*)ptr[19],
      (const T*)ptr[20], (const T*)ptr[21], (double*)out[0], (double*)out[1],
      (double*)out[2], (double*)out[3], (double*)out[4], (double*)out[5], G,
      Lp, C, B, E, iters, finish_frac, pl.gpw, (unsigned int*)hist);
  return (int)cudaGetLastError();
}

}  // namespace

#define COUPLED_ARGS                                                         \
  const void *u_rows, const void *b_rows, const void *bg, const void *cf,    \
      const void *pr, const void *lens, const void *cap_g,                   \
      const void *office, const void *rem, const void *rt, const void *kwh,  \
      const void *co2, const void *cost, const void *speak,                  \
      const void *n_scen, const void *rate, const void *oh,                  \
      const void *idle, const void *dyn, const void *alpha,                  \
      const void *gamma, const void *ohfrac, void *rem_o, void *rt_o,        \
      void *kwh_o, void *co2_o, void *cost_o, void *speak_o, int G, int Lp,  \
      int C, int B, int E, int iters, double finish_frac
#define COUPLED_PASS                                                         \
  const void* in[] = {u_rows, b_rows, bg,     cf,   pr,    lens,  cap_g,     \
                      office, rem,    rt,     kwh,  co2,   cost,  speak,     \
                      n_scen, rate,   oh,     idle, dyn,   alpha, gamma,     \
                      ohfrac};                                               \
  void* out[] = {rem_o, rt_o, kwh_o, co2_o, cost_o, speak_o}

// Plain C entry points (loaded with ctypes); each returns the
// cudaGetLastError() code of its launch, 0 on success.
extern "C" int coupled_chunk_f64(COUPLED_ARGS, void* stream) {
  COUPLED_PASS;
  return launch<double>(in, out, G, Lp, C, B, E, iters, finish_frac,
                        nullptr, stream);
}
extern "C" int coupled_chunk_f32(COUPLED_ARGS, void* stream) {
  COUPLED_PASS;
  return launch<float>(in, out, G, Lp, C, B, E, iters, finish_frac, nullptr,
                       stream);
}
// The same launches, counting into `hist` (iters + 1 uint32, zeroed by
// the caller) the (group, slot) pairs that took 0 .. iters throttle steps
// past the first operating point, over the slots in which the group had
// a lane running.
extern "C" int coupled_chunk_steps_f64(COUPLED_ARGS, void* hist,
                                       void* stream) {
  COUPLED_PASS;
  return launch<double>(in, out, G, Lp, C, B, E, iters, finish_frac, hist,
                        stream);
}
extern "C" int coupled_chunk_steps_f32(COUPLED_ARGS, void* hist,
                                       void* stream) {
  COUPLED_PASS;
  return launch<float>(in, out, G, Lp, C, B, E, iters, finish_frac, hist,
                       stream);
}

// The launch the kernel takes: threads a block, blocks, groups a warp
// and the blocks one SM holds (the occupancy API, E = 1, B = 1) into
// out[0..3].
extern "C" int coupled_chunk_plan(int G, int Lp, int f64, int* out) {
  const Plan pl = plan(G, Lp, sm_count());
  int per_sm = 0;
  const cudaError_t err =
      f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, instance<double, 1, true>(Lp, pl.gpw), pl.threads,
                0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, instance<float, 1, true>(Lp, pl.gpw), pl.threads,
                0);
  out[0] = pl.threads;
  out[1] = pl.blocks;
  out[2] = pl.gpw;
  out[3] = per_sm;
  return (int)err;
}
