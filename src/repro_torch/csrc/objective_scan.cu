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
// What bounds it: the work is N x T member-slots of ~40 fp64 operations
// (two `pow` among them) and a few bytes each, ~1e-4 ms of the card at
// N = 256.  A slot's physics does not depend on the carried state; the
// chain is a few flops a slot.  So a block serves a member, a thread a
// slot of a tile of `slots` slots (`plan`; kernels/objective_scan.py
// `launch_plan` is the same rule): every slot's physics in parallel into
// shared memory, then thread 0 runs the tile's chain of remaining work in
// slot order, in fp64 and with the arithmetic of the slot-by-slot
// definition, keeping each slot's seconds; then the sums in slot order,
// runtime, kWh and cost on thread 0 and each carbon member's on a thread
// of its own (the chain reads none of them back).
//
// Backward: the same blocks, the tiles from the last to the first, from
// the forward's checkpoint of each slot's starting remaining ((T, N)
// doubles): every slot's physics, finish branch and d loss / d energy in
// parallel; thread 0 carries the adjoint of remaining back through the
// tile (it moves only at a finish slot); every slot's vector-Jacobian
// product in parallel; then d/du summed into each day bin in slot order,
// a thread a bin, no atomics: two launches give the same bits.
#include "physics_grad.cuh"

using carina::Phys;
using carina::RatesFwd;

namespace {

constexpr int TILE_MAX = 256;   // slots (threads) a tile (block)
constexpr int NSER = 6;         // forward, a slot: scen ln, ln, scen, sps,
                                // kWh rate, price

// The workload and machine scalars, shared by every member.
struct Scalars {
  double n_scen, rate, oh, idle, dyn, alpha, gamma, ohf, batch;
};

template <typename T>
__device__ __forceinline__ Phys<T> phys(const Scalars& s) {
  return {T(s.rate), T(s.oh), T(s.idle), T(s.dyn), T(s.alpha), T(s.gamma),
          T(s.ohf)};
}

// The launch: threads a block (= slots a tile), and the dynamic shared
// bytes of each kernel.  Tiles of at most TILE_MAX slots, as even as the
// rounding to whole warps leaves them.  Shared memory: the forward's six
// doubles a slot; the backward's three doubles, a day bin and a finish
// flag a slot.
struct Plan {
  int threads, smem_fwd, smem_bwd;
};

Plan plan(int T) {
  const int T1 = T > 1 ? T : 1;
  const int tiles = (T1 + TILE_MAX - 1) / TILE_MAX;
  const int W = ((T1 + tiles - 1) / tiles + 31) / 32 * 32;
  return {W, 8 * NSER * W, 29 * W};
}

// EC = max(E, 1) carbon sums (E = 0: a single trace, co2 (N,), cf (T,)).
template <typename T>
__global__ void __launch_bounds__(TILE_MAX)
    trace_fwd_tiles(const double* __restrict__ u,
                    const int* __restrict__ rowidx,
                    const T* __restrict__ bg, const T* __restrict__ cf,
                    const T* __restrict__ pr, const T* __restrict__ lens,
                    Scalars s, double* __restrict__ kwh_o,
                    double* __restrict__ co2_o, double* __restrict__ rt_o,
                    double* __restrict__ cost_o, double* __restrict__ unf_o,
                    double* __restrict__ rem_hist, int N, int S, int TT,
                    int EC) {
  extern __shared__ double smem[];
  const int W = blockDim.x, n = blockIdx.x, i = threadIdx.x;
  double* w_s = smem;          // scen ln, at T
  double* ln_s = w_s + W;
  double* scen_s = ln_s + W;
  double* a_s = scen_s + W;    // scen_per_s, then dt
  double* kw_s = a_s + W;
  double* pr_s = kw_s + W;
  const Phys<T> p = phys<T>(s);
  const T batch = T(s.batch);
  const double* urow = u + (size_t)n * S;
  double* co2row = co2_o + (size_t)n * EC;
  // the chain's remaining work (thread 0); the sums: runtime, kWh and
  // cost (thread 0), carbon member j in co2row[j] (thread W - 1 - j mod
  // W - 1: the last warp's first)
  double R = s.n_scen, rt = 0.0, kwh = 0.0, cost = 0.0;
  for (int j = W - 1 - i; i > 0 && j < EC; j += W - 1) co2row[j] = 0.0;

  for (int t0 = 0; t0 < TT; t0 += W) {
    const int nw = min(W, TT - t0);
    // every slot's physics: independent of the carried state
    if (i < nw) {
      const int t = t0 + i;
      const RatesFwd<T> q =
          carina::rates_fwd<T>(T(urow[rowidx[t]]), batch, bg[t], p);
      const T scen = carina::xmax(q.sps, T(1e-30));
      const T ln = lens[t];
      w_s[i] = (double)(scen * ln);
      ln_s[i] = (double)ln;
      scen_s[i] = (double)scen;
      a_s[i] = (double)q.sps;
      kw_s[i] = (double)q.kwh;
      pr_s[i] = (double)pr[t];
    }
    __syncthreads();
    // the tile's chain of remaining work: each slot's seconds.  A batch of
    // U slots is read ahead into registers and first run branch-free on
    // the assumption that each is whole or without work (its outputs
    // stored as it goes), then checked once; a batch holding a finish
    // slot is run again slot by slot from the same state, overwriting
    // them.  Both runs take the same arithmetic.
    if (i == 0) {
      constexpr int U = 8;
      for (int kb = 0; kb < nw; kb += U) {
        double w[U], ln[U], sc[U], sp[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = min(kb + u, nw - 1);
          w[u] = w_s[k];
          ln[u] = ln_s[k];
          sc[u] = scen_s[k];
          sp[u] = a_s[k];
        }
        const int nb = min(U, nw - kb);
        double Rf = R;
        bool fast = true;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u >= nb) break;
          const int k = kb + u;
          if (rem_hist) rem_hist[(size_t)(t0 + k) * N + n] = Rf;
          const bool full = Rf > w[u];
          fast = fast && (full || !(Rf > 0.0));
          const double dt = full ? ln[u] : 0.0;
          Rf = Rf - sp[u] * dt;
          a_s[k] = dt;
        }
        if (fast) {
          R = Rf;
          continue;
        }
        // slot by slot: R > scen ln is a whole slot (so R > 0), else the
        // finish branch dt = R / scen while work is left, or none
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u >= nb) break;
          const int k = kb + u;
          if (rem_hist) rem_hist[(size_t)(t0 + k) * N + n] = R;
          const bool full = R > w[u];
          double dt = full ? ln[u] : 0.0;
          if (!full && R > 0.0) dt = R / sc[u];
          R = R - sp[u] * dt;
          a_s[k] = dt;
        }
      }
    }
    __syncthreads();
    // the sums, in slot order
    if (i == 0) {
#pragma unroll 4
      for (int k = 0; k < nw; ++k) {
        const double dt = a_s[k], e = kw_s[k] * dt;
        rt += dt;
        kwh += e;
        cost += e * pr_s[k];
      }
    }
    for (int j = W - 1 - i; i > 0 && j < EC; j += W - 1) {
      double c = co2row[j];
#pragma unroll 4
      for (int k = 0; k < nw; ++k)
        c += kw_s[k] * a_s[k] * (double)cf[(size_t)(t0 + k) * EC + j];
      co2row[j] = c;
    }
    __syncthreads();
  }
  if (i != 0) return;
  kwh_o[n] = kwh;
  rt_o[n] = rt / 3600.0;
  cost_o[n] = cost;
  unf_o[n] = R / s.n_scen;
}

// The gradient of sum(g_kwh kwh + g_co2 . co2 + g_rt runtime_h +
// g_cost cost + g_unf unfinished) with respect to u_day, added into g_u
// (N, S) (zeroed by the caller).  A null gradient is a zero gradient.
template <typename T>
__global__ void __launch_bounds__(TILE_MAX)
    trace_bwd_tiles(const double* __restrict__ u,
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
  extern __shared__ double smem[];
  const int W = blockDim.x, n = blockIdx.x, i = threadIdx.x;
  double* a_s = smem;          // scen_per_s, then d/du
  double* scen_s = a_s + W;
  double* b_s = scen_s + W;    // grt + ge kwh, then the adjoint of remaining
  int* day_s = reinterpret_cast<int*>(b_s + W);
  unsigned char* fin_s = reinterpret_cast<unsigned char*>(day_s + W);
  const Phys<T> p = phys<T>(s);
  const T batch = T(s.batch);
  const double* urow = u + (size_t)n * S;
  double* grow = g_u + (size_t)n * S;
  const double* gco2 = g_co2 ? g_co2 + (size_t)n * EC : nullptr;
  const double gk = g_kwh ? g_kwh[n] : 0.0;
  const double gc = g_cost ? g_cost[n] : 0.0;
  const double grt = g_rt ? g_rt[n] / 3600.0 : 0.0;
  double lam = g_unf ? g_unf[n] / s.n_scen : 0.0;   // d loss / d remaining
  for (int t0 = (TT - 1) / W * W; t0 >= 0; t0 -= W) {
    const int nw = min(W, TT - t0);
    // every slot's physics, finish branch and d loss / d energy; the
    // thread keeps its slot's operating point for the product below
    RatesFwd<T> q;
    T scen = T(1);
    double dt = 0.0, ge = 0.0;
    bool fin = false;
    if (i < nw) {
      const int t = t0 + i, day = rowidx[t];
      q = carina::rates_fwd<T>(T(urow[day]), batch, bg[t], p);
      scen = carina::xmax(q.sps, T(1e-30));
      const T ln = lens[t];
      const T w = scen * ln;
      const double R = rem_hist[(size_t)t * N + n];
      const bool live = R > 0.0;
      fin = live && !(R > (double)w);
      dt = live ? (fin ? R / (double)scen : (double)ln) : 0.0;
      ge = gk + gc * (double)pr[t];
      if (gco2) {
        const T* cft = cf + (size_t)t * EC;
        for (int j = 0; j < EC; ++j) ge += gco2[j] * (double)cft[j];
      }
      a_s[i] = (double)q.sps;
      scen_s[i] = (double)scen;
      b_s[i] = grt + ge * (double)q.kwh;
      day_s[i] = day;
      fin_s[i] = fin;
    }
    __syncthreads();
    // the adjoint of remaining, carried back through the tile, each slot
    // given the adjoint after it; it moves only at a finish slot, so a
    // batch of U slots without one only stores it
    if (i == 0) {
      constexpr int U = 8;
      for (int kb = nw - 1; kb >= 0; kb -= U) {
        bool f[U], any = false;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          f[u] = kb - u >= 0 && fin_s[max(kb - u, 0)];
          any = any || f[u];
        }
        if (!any) {
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (kb - u >= 0) b_s[kb - u] = lam;
          continue;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = kb - u;
          if (k < 0) break;
          const double c = b_s[k];
          b_s[k] = lam;
          if (f[u]) lam += (c - lam * a_s[k]) / scen_s[k];
        }
      }
    }
    __syncthreads();
    // every slot's product: remaining' = remaining - sps dt; runtime +=
    // dt; e = kwh dt
    if (i < nw) {
      const double l = b_s[i];
      const double gdt = grt + ge * (double)q.kwh - l * (double)q.sps;
      const double g_sps = -l * dt;
      const double g_kw = ge * dt;
      const double g_scen = fin ? -gdt * (dt / (double)scen) : 0.0;
      const T gs = T(g_sps) + T(g_scen) * carina::tie_max(q.sps, T(1e-30));
      const T gp = T(g_kw) / T(3.6e6);
      a_s[i] = (double)carina::rates_vjp<T>(q, p, batch, gs, gp);
    }
    __syncthreads();
    // each day bin summed over the tile's slots in order
    for (int d = i; d < S; d += W) {
      double acc = 0.0;
      bool hit = false;
#pragma unroll 8
      for (int k = 0; k < nw; ++k) {
        const bool in = day_s[k] == d;
        acc += in ? a_s[k] : 0.0;
        hit |= in;
      }
      if (hit) grow[d] += acc;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_fwd(const double* u, const int* rowidx, const void* bg,
               const void* cf, const void* pr, const void* lens, Scalars s,
               double* kwh, double* co2, double* rt, double* cost, double* unf,
               double* rem_hist, int N, int S, int TT, int EC,
               cudaStream_t stream) {
  const Plan pl = plan(TT);
  const T* b = static_cast<const T*>(bg);
  const T* c = static_cast<const T*>(cf);
  const T* r = static_cast<const T*>(pr);
  const T* l = static_cast<const T*>(lens);
  trace_fwd_tiles<T><<<N, pl.threads, pl.smem_fwd, stream>>>(
      u, rowidx, b, c, r, l, s, kwh, co2, rt, cost, unf, rem_hist, N, S, TT,
      EC);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const double* u, const int* rowidx, const void* bg,
               const void* cf, const void* pr, const void* lens, Scalars s,
               const double* rem_hist, const double* g_kwh,
               const double* g_co2, const double* g_rt, const double* g_cost,
               const double* g_unf, double* g_u, int N, int S, int TT, int EC,
               cudaStream_t stream) {
  const Plan pl = plan(TT);
  trace_bwd_tiles<T><<<N, pl.threads, pl.smem_bwd, stream>>>(
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

// The launch over T slots: out[0..2] = threads a block (slots a tile), the
// dynamic shared bytes of the forward (bwd = 0) or backward kernel, and
// the blocks an SM holds (CUDA's occupancy API) in fp64 (f64 = 1) or
// fp32 physics.
extern "C" int trace_scan_plan(int T, int bwd, int f64, int* out) {
  const Plan p = plan(T);
  const int smem = bwd ? p.smem_bwd : p.smem_fwd;
  int blocks = 0;
  cudaError_t err;
  if (bwd)
    err = f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, trace_bwd_tiles<double>, p.threads, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, trace_bwd_tiles<float>, p.threads, smem);
  else
    err = f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, trace_fwd_tiles<double>, p.threads, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, trace_fwd_tiles<float>, p.threads, smem);
  out[0] = p.threads;
  out[1] = smem;
  out[2] = blocks;
  return (int)err;
}
