// K4: the schedule optimizer's site-coupled fleet objective scan, forward
// and backward, for Hopper.
//
// Replaces `FleetTraceObjective._step` / `_evaluate_jax` of
// src/repro/core/engine_jax.py (the `jax.lax.scan` over the horizon's
// slots that XLA compiles into one program, differentiated by `jax.grad`).
//
// Computation, per member of the population (N, M, n_slots) and slot t:
//   active_m = remaining_m > FINISH_FRAC n_scen_m
//   r_m = model.rates(u_m[rowidx[t]], ...)
//   capped: base = sum over active of the non-sheddable draw, then
//     SITE_THROTTLE_ITERS damped site_throttle steps, each over the summed
//     active draw and each re-evaluating r_m at u_m f;
//     uncapped: no solve (an infinite headroom would poison the chain rule)
//   dt_m by the strict finish branch, the sums (runtime, kWh, CO2, cost),
//   the site draw (active draw + office) and the running site peak.
//
// What bounds it: N x M x T campaign-slots of ~170 fp64 operations (five
// operating points a capped slot) and a few bytes each, ~1e-3 ms of the
// card at the README fleet's N = 192, M = 2, T = 624.  A slot's physics
// depends on the carried state only through the activity mask, which is
// monotone (remaining work never grows); what does depend on the carried
// state is a few flops a slot.  So a block serves a member and cuts the
// horizon into tiles of `slots` slots (`plan`; kernels/fleet_objective.py
// `launch_plan` is the same rule):
//   1. every slot of the tile in parallel, a group of G threads a slot
//      (G = 1: the campaigns inside the thread, up to 2; G = 32: on the
//      warp's lanes, m = lane + 32 j): the operating points under the
//      mask at the tile's start, and what the chain reads (each campaign's
//      scen_per_s, kWh rate and kW draw, the slot's series) into shared
//      memory;
//   2. warp 0, a lane a campaign, runs the tile's chain of remaining work
//      in slot order, with the arithmetic of the slot-by-slot definition
//      (the strict finish branch, remaining -= scen_per_s dt), keeping
//      each slot's seconds and each campaign's activity at the slot's
//      start;
//   3. capped, where a campaign's activity turns off inside the tile, the
//      chain stops there and step 1 runs again from that slot under the
//      new mask (a repair round); uncapped, the mask changes only which
//      draws the site sums, so there is none;
//   4. every slot's site draw over the campaigns active at its start, in
//      parallel; then in slot order a thread a campaign adds the sums
//      (runtime, kWh, CO2, cost) and one thread takes the running peak.
// The chain stays a chain: summing the rates as a prefix sum would move
// the residue a finish slot leaves, and with it finish and mask decisions.
// Only the remaining work is carried in it: the sums and the peak read
// nothing back into it, so they leave its few dependent flops a slot.
//
// Backward: the same blocks, the tiles from the last to the first, from
// the forward's checkpoints of each slot's starting remaining (T, N, M)
// and the site peak before each slot (T, N), which fix every slot's mask:
//   1. every slot in parallel: the throttle factors, the final points,
//      the site draw, each campaign's finish branch;
//   2. warp 0 runs the two reverse chains in slot order, a few flops a
//      slot: the adjoint of each campaign's remaining work (it moves only
//      at a finish slot) and of the running peak (halved at a tie, zeroed
//      below a new maximum, as `torch.maximum` splits its gradient);
//   3. every slot in parallel: the vector-Jacobian product through the
//      final point and back through the four throttle steps;
//   4. d/du summed into each campaign's day bins in slot order, a thread
//      a (campaign, bin), no atomics: two launches give the same bits.
// Every sum over campaigns is the group's (a thread's in campaign order,
// then the warp's xor butterfly), the same in the solve and in the site
// draw, so an exact cap ties in both.
//
// Past 128 campaigns a member the streaming kernels run (a warp a member,
// the slots in order, the lane's campaigns re-read from memory at each
// step of a slot), so any M launches.
#include "physics_grad.cuh"

using carina::Phys;
using carina::RatesFwd;

namespace {

constexpr int ITERS = 4;   // model.SITE_THROTTLE_ITERS
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;    // the tile kernels' most threads a block
constexpr int TILE_MAX_1 = 256; // slots a tile, a thread a slot (M <= 2)
constexpr int TILE_MAX_32 = 64; // slots a tile, a warp a slot (M > 2)
constexpr int M_THREAD = 2;     // campaigns inside a thread
constexpr int M_TILES = 128;    // campaigns of the tile kernels

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The sum over a slot's group of G threads (G = 1: the thread's own).
template <int G>
__device__ __forceinline__ double group_sum(double v) {
  if constexpr (G == 32)
    return warp_sum(v);
  else
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

// ---------------------------------------------------------------------------
// The tile kernels (M <= 128)
// ---------------------------------------------------------------------------
// The launch: threads a block, slots a tile, threads a slot's group, and
// the dynamic shared bytes of each kernel.
struct Plan {
  int threads, slots, group, smem_fwd, smem_bwd;
};

constexpr int NCAMP = 9;        // rows of `camp`
constexpr int NCAMP_BWD = 13;   // and the four output gradients
constexpr int NSER = 5;         // forward, a slot: lens, cf, pr, office,
                                // site draw
constexpr int NSLOT_BWD = 12;   // backward, a slot: f1..f4, fk0..3, base,
                                // site draw, its gradient, peak before

__host__ __device__ inline int round8(int b) { return (b + 7) / 8 * 8; }

// Tiles of at most TILE_MAX_1 slots, a thread each (M <= 2), or of at most
// TILE_MAX_32, a warp each over 8 warps; the tiles as even as the rounding
// (32 or 8 slots) leaves them.  Shared memory: the campaign rows, then per
// slot the forward's series and site draw or the backward's solve, then
// per slot and campaign the forward's three rates and activity or the
// backward's two values and finish flag, the forward's mask and stop slot,
// the backward's day bins and the slots its reverse chains move at.
Plan plan(int M, int T) {
  Plan p;
  const int T1 = T > 1 ? T : 1;
  p.group = M <= M_THREAD ? 1 : 32;
  const int cap = p.group == 1 ? TILE_MAX_1 : TILE_MAX_32;
  const int round = p.group == 1 ? 32 : 8;
  const int tiles = (T1 + cap - 1) / cap;
  p.slots = ((T1 + tiles - 1) / tiles + round - 1) / round * round;
  p.threads = p.group == 1 ? p.slots : THREADS;
  const int W = p.slots;
  p.smem_fwd = 8 * (NCAMP * M + NSER * W + 3 * W * M) + round8(W * M) +
               round8(M) + 8;
  p.smem_bwd = 8 * (NCAMP_BWD * M + NSLOT_BWD * W + 2 * W * M) + 4 * W +
               round8(W * M) + round8(W);
  return p;
}

// One campaign's physics scalars from the shared campaign rows.
__device__ __forceinline__ Phys<double> phys_at(const double* cs, int M,
                                                int m) {
  return {cs[2 * M + m], cs[3 * M + m], cs[4 * M + m], cs[5 * M + m],
          cs[6 * M + m], cs[7 * M + m], cs[8 * M + m]};
}

// One slot's operating points over the group's campaigns m = lane + G j
// (`ok[j]`: m < M): the throttle factors f[0..ITERS] (all 1 uncapped),
// the summed draws fk[0..ITERS-1] they were solved from and the summed
// base draw (0 uncapped), and each campaign's final point q.
template <int G, int CPL>
__device__ __forceinline__ void slot_solve(
    const Fleet& F, const double* cs, int t, int lane,
    const double (&uu)[CPL], const bool (&ok)[CPL], const bool (&act)[CPL],
    RatesFwd<double> (&q)[CPL], double (&f)[ITERS + 1],
    double (&fk)[ITERS], double& base) {
  const int M = F.M;
  const double bgt = F.bg[t];
  Phys<double> p[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    p[j] = phys_at(cs, M, ok[j] ? lane + G * j : 0);
    if (ok[j]) q[j] = carina::rates_fwd<double>(uu[j], F.batch, bgt, p[j]);
  }
#pragma unroll
  for (int k = 0; k <= ITERS; ++k) f[k] = 1.0;
#pragma unroll
  for (int k = 0; k < ITERS; ++k) fk[k] = 0.0;
  base = 0.0;
  if (!F.capped) return;
  double b = 0.0;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    b += act[j] ? F.base[(size_t)t * M + lane + G * j] : 0.0;
  base = group_sum<G>(b);
  const double hd = F.head[t];
#pragma unroll
  for (int k = 0; k < ITERS; ++k) {
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < CPL; ++j) s += act[j] ? q[j].pavg / 1000.0 : 0.0;
    fk[k] = group_sum<G>(s);
    f[k + 1] = carina::site_throttle(fk[k], base, hd, f[k]);
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (ok[j])
        q[j] = carina::rates_fwd<double>(uu[j] * f[k + 1], F.batch, bgt,
                                         p[j]);
  }
}

template <int G, int CPL>
__global__ void __launch_bounds__(THREADS)
    fleet_fwd_tiles(Fleet F, int W, double* __restrict__ kwh_o,
                    double* __restrict__ co2_o, double* __restrict__ rt_o,
                    double* __restrict__ cost_o, double* __restrict__ unf_o,
                    double* __restrict__ peak_o,
                    double* __restrict__ rem_hist,
                    double* __restrict__ peak_hist) {
  extern __shared__ double smem[];
  constexpr int CC = G == 1 ? 1 : CPL;   // a chain lane's campaigns
  const int M = F.M, n = blockIdx.x;
  const size_t WM = (size_t)W * M;
  double* cs = smem;                     // [NCAMP][M]
  double* ser = cs + NCAMP * M;          // [NSER][W]
  double* a_s = ser + NSER * W;          // [W][M] scen_per_s, then dt
  double* kw_s = a_s + WM;               // [W][M] kWh per second
  double* draw_s = kw_s + WM;            // [W][M] kW drawn
  unsigned char* act_s = reinterpret_cast<unsigned char*>(draw_s + WM);
  unsigned char* mask = act_s + round8(W * M);
  int* stop_s = reinterpret_cast<int*>(mask + round8(M));
  for (int i = threadIdx.x; i < NCAMP * M; i += blockDim.x)
    cs[i] = F.camp[i];
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x)
    mask[m] = cs[m] > cs[M + m];
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int groups = blockDim.x / G;
  const double* urow = F.u + (size_t)n * M * F.S;
  bool ok[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) ok[j] = lane + G * j < M;
  // the chain's state (warp 0): the remaining work of campaign cl + 32 j
  const int cl = threadIdx.x & 31;
  bool cok[CC];
  double R[CC];
#pragma unroll
  for (int j = 0; j < CC; ++j) {
    cok[j] = cl + 32 * j < M;
    R[j] = cok[j] ? F.camp[cl + 32 * j] : 0.0;
  }
  // the sums of campaign threadIdx.x (threads below M), the peak (the
  // block's last thread)
  double rt = 0.0, kwh = 0.0, co2 = 0.0, cost = 0.0, peak = 0.0;
  int s0 = 0;
  __syncthreads();
  for (int t0 = 0; t0 < F.T;) {
    const int nw = min(W, F.T - t0);
    // 1. the tile's slots from s0, in parallel, under the mask
    for (int s = s0 + grp; s < nw; s += groups) {
      const int t = t0 + s, day = F.rowidx[t];
      double uu[CPL];
      bool act[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int m = lane + G * j;
        uu[j] = ok[j] ? urow[(size_t)m * F.S + day] : 0.0;
        act[j] = ok[j] && mask[m];
      }
      RatesFwd<double> q[CPL];
      double f[ITERS + 1], fk[ITERS], base;
      slot_solve<G, CPL>(F, cs, t, lane, uu, ok, act, q, f, fk, base);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (!ok[j]) continue;
        const size_t i = (size_t)s * M + lane + G * j;
        a_s[i] = q[j].sps;
        kw_s[i] = q[j].kwh;
        draw_s[i] = q[j].pavg / 1000.0;
      }
      if (lane == 0) {
        ser[s] = F.lens[t];
        ser[W + s] = F.cf[t];
        ser[2 * W + s] = F.pr[t];
        ser[3 * W + s] = F.office[t];
      }
    }
    __syncthreads();
    // 2. the chain of remaining work, in slot order from s0: each slot's
    // activity and seconds run (over its scen_per_s); warp 0, a lane a
    // campaign
    if (threadIdx.x < 32) {
      double fin[CC];
      bool was[CC];
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        const int m = cl + 32 * j;
        fin[j] = cok[j] ? cs[M + m] : 0.0;
        was[j] = cok[j] && mask[m];
      }
      // A batch of U slots' lengths and rates is read ahead into
      // registers.  Most batches hold no finish slot and no change of
      // activity, so each is first run branch-free on that assumption
      // (its outputs stored as it goes) and checked once; a batch where
      // it fails is run again slot by slot from the same state, which
      // also overwrites what the first run stored.  Both runs take the
      // same arithmetic.
      constexpr int U = CC == 1 ? 8 : (CC == 2 ? 4 : 2);
      int stop = nw;
      for (int sb = s0; sb < stop; sb += U) {
        double ln[U], sp[U][CC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = min(sb + u, nw - 1);
          ln[u] = ser[s];
#pragma unroll
          for (int j = 0; j < CC; ++j)
            sp[u][j] = cok[j] ? a_s[(size_t)s * M + cl + 32 * j] : 0.0;
        }
        const int nb = min(U, nw - sb);
        // the branch-free run: every slot whole (R > scen ln) or without
        // work (R <= 0), each campaign's activity as before
        double Rf[CC];
        bool fast = true;
#pragma unroll
        for (int j = 0; j < CC; ++j) Rf[j] = R[j];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u >= nb) break;
          const int s = sb + u;
#pragma unroll
          for (int j = 0; j < CC; ++j) {
            if (!cok[j]) continue;
            const int m = cl + 32 * j;
            const size_t i = (size_t)s * M + m;
            const bool full = Rf[j] > fmax(sp[u][j], 1e-30) * ln[u];
            const bool act = Rf[j] > fin[j];
            fast = fast && (full || !(Rf[j] > 0.0)) && act == was[j];
            if (rem_hist)
              rem_hist[((size_t)(t0 + s) * F.N + n) * M + m] = Rf[j];
            const double dt = full ? ln[u] : 0.0;
            act_s[i] = act;
            a_s[i] = dt;
            Rf[j] = Rf[j] - sp[u][j] * dt;
          }
        }
        if (__all_sync(FULL, fast)) {
#pragma unroll
          for (int j = 0; j < CC; ++j) R[j] = Rf[j];
          continue;
        }
        // slot by slot
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u >= nb) break;
          const int s = sb + u;
          bool act[CC], full[CC];
          bool moved = false;
#pragma unroll
          for (int j = 0; j < CC; ++j) {
            act[j] = cok[j] && R[j] > fin[j];
            moved |= act[j] != was[j];
            // R > scen ln: a whole slot (so R > 0); else the finish
            // branch dt = R / scen while work is left, or none
            full[j] = R[j] > fmax(sp[u][j], 1e-30) * ln[u];
          }
          if (F.capped && __any_sync(FULL, moved)) {
            stop = s;   // 3. a repair round from this slot
            break;
          }
#pragma unroll
          for (int j = 0; j < CC; ++j) {
            if (!cok[j]) continue;
            const int m = cl + 32 * j;
            const size_t i = (size_t)s * M + m;
            if (rem_hist)
              rem_hist[((size_t)(t0 + s) * F.N + n) * M + m] = R[j];
            double dt = full[j] ? ln[u] : 0.0;
            if (!full[j] && R[j] > 0.0)
              dt = R[j] / fmax(sp[u][j], 1e-30);
            act_s[i] = act[j];
            was[j] = act[j];
            R[j] = R[j] - sp[u][j] * dt;
            a_s[i] = dt;
          }
        }
      }
      // the mask at the chain's stop: the next round's (or tile's)
#pragma unroll
      for (int j = 0; j < CC; ++j)
        if (cok[j]) mask[cl + 32 * j] = R[j] > fin[j];
      if (cl == 0) *stop_s = stop;
    }
    __syncthreads();
    const int stop = *stop_s;
    // 4. each slot's site draw over the campaigns active at its start
    for (int s = s0 + grp; s < stop; s += groups) {
      double d = 0.0;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const size_t i = (size_t)s * M + lane + G * j;
        d += ok[j] && act_s[i] ? draw_s[i] : 0.0;
      }
      d = group_sum<G>(d);
      if (lane == 0) ser[4 * W + s] = d + ser[3 * W + s];
    }
    __syncthreads();
    // 5. the sums, a thread a campaign, and the running peak, in slot
    // order
    if (threadIdx.x < M) {
#pragma unroll 4
      for (int s = s0; s < stop; ++s) {
        const size_t i = (size_t)s * M + threadIdx.x;
        const double dt = a_s[i], e = kw_s[i] * dt;
        rt += dt;
        kwh += e;
        co2 += e * ser[W + s];
        cost += e * ser[2 * W + s];
      }
    }
    if (threadIdx.x == blockDim.x - 1) {
#pragma unroll 4
      for (int s = s0; s < stop; ++s) {
        if (peak_hist) peak_hist[(size_t)(t0 + s) * F.N + n] = peak;
        peak = fmax(peak, ser[4 * W + s]);
      }
    }
    __syncthreads();
    if (stop < nw) {
      s0 = stop;
    } else {
      t0 += W;
      s0 = 0;
    }
  }
  if (threadIdx.x < M) {
    const size_t o = (size_t)n * M + threadIdx.x;
    kwh_o[o] = kwh;
    co2_o[o] = co2;
    rt_o[o] = rt / 3600.0;
    cost_o[o] = cost;
  }
  if (threadIdx.x < 32) {
#pragma unroll
    for (int j = 0; j < CC; ++j)
      if (cok[j]) unf_o[(size_t)n * M + cl + 32 * j] = R[j] / cs[cl + 32 * j];
  }
  if (threadIdx.x == blockDim.x - 1) peak_o[n] = peak;
}

// The gradient of sum(g_kwh kwh + g_co2 co2 + g_rt runtime_h + g_cost cost
// + g_unf unfinished) + g_peak site_peak with respect to u, added into
// g_u (N, M, S) (zeroed by the caller).  A null gradient is zero.
template <int G, int CPL>
__global__ void __launch_bounds__(THREADS)
    fleet_bwd_tiles(Fleet F, int W, const double* __restrict__ rem_hist,
                    const double* __restrict__ peak_hist,
                    const double* __restrict__ g_kwh,
                    const double* __restrict__ g_co2,
                    const double* __restrict__ g_rt,
                    const double* __restrict__ g_cost,
                    const double* __restrict__ g_unf,
                    const double* __restrict__ g_peak,
                    double* __restrict__ g_u) {
  extern __shared__ double smem[];
  constexpr int CC = G == 1 ? 1 : CPL;   // a chain lane's campaigns
  const int M = F.M, n = blockIdx.x;
  const size_t WM = (size_t)W * M;
  double* cs = smem;                       // [NCAMP_BWD][M]
  double* sl = cs + NCAMP_BWD * M;         // [NSLOT_BWD][W]
  double* a_s = sl + NSLOT_BWD * W;        // [W][M] scen_per_s, then d/du
  double* b_s = a_s + WM;                  // [W][M] grt + ge kwh, then lam
  int* day_s = reinterpret_cast<int*>(b_s + WM);          // [W]
  unsigned char* fin_s = reinterpret_cast<unsigned char*>(day_s + W);
  unsigned char* ev_s = fin_s + round8(W * M);   // [W] a chain moves

  const size_t nrow = (size_t)n * M;
  for (int i = threadIdx.x; i < NCAMP * M; i += blockDim.x)
    cs[i] = F.camp[i];
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    cs[NCAMP * M + m] = g_kwh ? g_kwh[nrow + m] : 0.0;
    cs[(NCAMP + 1) * M + m] = g_co2 ? g_co2[nrow + m] : 0.0;
    cs[(NCAMP + 2) * M + m] = g_rt ? g_rt[nrow + m] / 3600.0 : 0.0;
    cs[(NCAMP + 3) * M + m] = g_cost ? g_cost[nrow + m] : 0.0;
  }
  const double* gk_s = cs + NCAMP * M;
  const double* gco2_s = gk_s + M;
  const double* grt_s = gco2_s + M;
  const double* gcost_s = grt_s + M;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int groups = blockDim.x / G;
  const double* urow = F.u + (size_t)n * M * F.S;
  bool ok[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) ok[j] = lane + G * j < M;
  // the reverse chains' state (warp 0, a lane a campaign cl + 32 j)
  const int cl = threadIdx.x & 31;
  bool cok[CC];
  double lam[CC];   // d loss / d remaining
#pragma unroll
  for (int j = 0; j < CC; ++j) {
    const int m = cl + 32 * j;
    cok[j] = m < M;
    lam[j] = cok[j] && g_unf ? g_unf[nrow + m] / F.camp[m] : 0.0;
  }
  double lp = g_peak ? g_peak[n] : 0.0;   // d loss / d running peak
  __syncthreads();
  for (int t0 = (F.T - 1) / W * W; t0 >= 0; t0 -= W) {
    const int nw = min(W, F.T - t0);
    // 1. every slot's points, finish branches and site draw
    for (int s = grp; s < nw; s += groups) {
      const int t = t0 + s, day = F.rowidx[t];
      double uu[CPL], R[CPL];
      bool act[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int m = lane + G * j;
        uu[j] = ok[j] ? urow[(size_t)m * F.S + day] : 0.0;
        R[j] = ok[j] ? rem_hist[((size_t)t * F.N + n) * M + m] : 0.0;
        act[j] = ok[j] && R[j] > cs[M + m];
      }
      RatesFwd<double> q[CPL];
      double f[ITERS + 1], fk[ITERS], base;
      slot_solve<G, CPL>(F, cs, t, lane, uu, ok, act, q, f, fk, base);
      double d = 0.0;
#pragma unroll
      for (int j = 0; j < CPL; ++j) d += act[j] ? q[j].pavg / 1000.0 : 0.0;
      const double site = group_sum<G>(d) + F.office[t];
      const double pk = peak_hist[(size_t)t * F.N + n];
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < ITERS; ++k) {
          sl[k * W + s] = f[k + 1];
          sl[(ITERS + k) * W + s] = fk[k];
        }
        sl[8 * W + s] = base;
        sl[9 * W + s] = site;
        sl[11 * W + s] = pk;
        day_s[s] = day;
      }
      const double ln = F.lens[t], cft = F.cf[t], prt = F.pr[t];
      bool moves = false;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (!ok[j]) continue;
        const int m = lane + G * j;
        const size_t i = (size_t)s * M + m;
        const double scen = fmax(q[j].sps, 1e-30);
        const double ge = gk_s[m] + gco2_s[m] * cft + gcost_s[m] * prt;
        const bool fin = R[j] > 0.0 && !(R[j] > scen * ln);
        a_s[i] = q[j].sps;
        b_s[i] = grt_s[m] + ge * q[j].kwh;
        fin_s[i] = fin;
        moves |= fin;
      }
      // a slot where a reverse chain moves: a finish, or the running
      // peak tied or passed
      if constexpr (G == 32) moves = __any_sync(FULL, moves);
      if (lane == 0) ev_s[s] = moves || pk <= site;
    }
    __syncthreads();
    // 2. the reverse chains, in slot order from the tile's end; warp 0, a
    // lane a campaign.  They move only at a slot `ev_s` marks, so a batch
    // of U slots without one only stores them (the peak's gradient 0).
    if (threadIdx.x < 32) {
      constexpr int U = 8;
      for (int sb = nw - 1; sb >= 0; sb -= U) {
        bool any = false;
#pragma unroll
        for (int u = 0; u < U; ++u)
          any = any || (sb - u >= 0 && ev_s[max(sb - u, 0)]);
        if (!any) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int s = sb - u;
            if (s < 0) break;
            if (cl == 0) sl[10 * W + s] = 0.0;
#pragma unroll
            for (int j = 0; j < CC; ++j)
              if (cok[j]) b_s[(size_t)s * M + cl + 32 * j] = lam[j];
          }
          continue;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = sb - u;
          if (s < 0) break;
          // the running peak: a tie halves its gradient, a new maximum
          // takes all of it
          const double site = sl[9 * W + s], pk = sl[11 * W + s];
          const bool tie = pk == site, above = pk < site;
          const double g_site = tie ? 0.5 * lp : (above ? lp : 0.0);
          lp = tie ? 0.5 * lp : (above ? 0.0 : lp);
          if (cl == 0) sl[10 * W + s] = g_site;
#pragma unroll
          for (int j = 0; j < CC; ++j) {
            if (!cok[j]) continue;
            const size_t i = (size_t)s * M + cl + 32 * j;
            const double c = b_s[i];
            b_s[i] = lam[j];
            if (fin_s[i]) {   // dt = remaining / scen
              const double sps = a_s[i];
              lam[j] += (c - lam[j] * sps) / fmax(sps, 1e-30);
            }
          }
        }
      }
    }
    __syncthreads();
    // 3. every slot's vector-Jacobian product
    for (int s = grp; s < nw; s += groups) {
      const int t = t0 + s, day = day_s[s];
      double f[ITERS + 1], fk[ITERS];
      f[0] = 1.0;
#pragma unroll
      for (int k = 0; k < ITERS; ++k) {
        f[k + 1] = sl[k * W + s];
        fk[k] = sl[(ITERS + k) * W + s];
      }
      const double base = sl[8 * W + s], g_site = sl[10 * W + s];
      const double bgt = F.bg[t], ln = F.lens[t], cft = F.cf[t],
                   prt = F.pr[t];
      double uu[CPL], gx[CPL];
      bool act[CPL];
      Phys<double> p[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int m = ok[j] ? lane + G * j : 0;
        p[j] = phys_at(cs, M, m);
        uu[j] = ok[j] ? urow[(size_t)m * F.S + day] : 0.0;
        gx[j] = 0.0;
        act[j] = false;
        if (!ok[j]) continue;
        const double R = rem_hist[((size_t)t * F.N + n) * M + m];
        act[j] = R > cs[M + m];
        const RatesFwd<double> q = carina::rates_fwd<double>(
            uu[j] * f[ITERS], F.batch, bgt, p[j]);
        const size_t i = (size_t)s * M + m;
        const double l = b_s[i];
        const double scen = fmax(q.sps, 1e-30);
        const bool live = R > 0.0;
        const bool fin = live && !(R > scen * ln);
        const double dt = live ? (fin ? R / scen : ln) : 0.0;
        const double ge = gk_s[m] + gco2_s[m] * cft + gcost_s[m] * prt;
        const double gdt = grt_s[m] + ge * q.kwh - l * q.sps;
        const double g_sps = -l * dt;
        const double g_scen = fin ? -gdt * (dt / scen) : 0.0;
        const double gs = g_sps + g_scen * carina::tie_max(q.sps, 1e-30);
        const double gp = ge * dt / 3.6e6 + (act[j] ? g_site / 1000.0 : 0.0);
        gx[j] = carina::rates_vjp<double>(q, p[j], F.batch, gs, gp);
      }
      double gu[CPL];
      if (F.capped) {
        // x = u f[ITERS] at the final point; each earlier point x = u f[k]
        // fed the draw fk[k] that solved f[k + 1]
        double gf = 0.0;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          gu[j] = gx[j] * f[ITERS];
          gf += ok[j] ? gx[j] * uu[j] : 0.0;
        }
        gf = group_sum<G>(gf);
        const double hd = F.head[t];
#pragma unroll
        for (int k = ITERS - 1; k >= 0; --k) {
          const carina::ThrottleGrad tg =
              carina::site_throttle_vjp(fk[k], base, hd, f[k], gf);
          double part = 0.0;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            if (!ok[j]) continue;
            const RatesFwd<double> qk = carina::rates_fwd<double>(
                k == 0 ? uu[j] : uu[j] * f[k], F.batch, bgt, p[j]);
            const double g = carina::rates_vjp<double>(
                qk, p[j], F.batch, 0.0, act[j] ? tg.g_fleet / 1000.0 : 0.0);
            gu[j] += k == 0 ? g : g * f[k];
            part += g * uu[j];
          }
          if (k > 0) gf = tg.g_f + group_sum<G>(part);
        }
      } else {
#pragma unroll
        for (int j = 0; j < CPL; ++j) gu[j] = gx[j];
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (ok[j]) a_s[(size_t)s * M + lane + G * j] = gu[j];
    }
    __syncthreads();
    // 4. each (campaign, day bin) summed over the tile's slots in order
    for (int c = threadIdx.x; c < M * F.S; c += blockDim.x) {
      const int m = c / F.S, day = c % F.S;
      double acc = 0.0;
      bool hit = false;
#pragma unroll 8
      for (int s = 0; s < nw; ++s) {
        const bool in = day_s[s] == day;
        acc += in ? a_s[(size_t)s * M + m] : 0.0;
        hit |= in;
      }
      if (hit) g_u[(nrow + m) * F.S + day] += acc;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Past 128 campaigns a member: a warp a member, the lane's campaigns
// streamed at each step of a slot
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

// Warps a block of the streaming kernels: 4, or 2 or 1 where 4 would
// leave SMs without a block.
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

// Dynamic shared memory above the default 48 KB has to be allowed first.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The tile kernel of M campaigns (M <= 128), forward or backward.
template <bool BWD>
struct TileKernel;
template <>
struct TileKernel<false> {
  using Fn = void (*)(Fleet, int, double*, double*, double*, double*,
                      double*, double*, double*, double*);
  static Fn of(int M) {
    if (M <= M_THREAD) return fleet_fwd_tiles<1, M_THREAD>;
    if (M <= 32) return fleet_fwd_tiles<32, 1>;
    if (M <= 64) return fleet_fwd_tiles<32, 2>;
    return fleet_fwd_tiles<32, 4>;
  }
};
template <>
struct TileKernel<true> {
  using Fn = void (*)(Fleet, int, const double*, const double*,
                      const double*, const double*, const double*,
                      const double*, const double*, const double*, double*);
  static Fn of(int M) {
    if (M <= M_THREAD) return fleet_bwd_tiles<1, M_THREAD>;
    if (M <= 32) return fleet_bwd_tiles<32, 1>;
    if (M <= 64) return fleet_bwd_tiles<32, 2>;
    return fleet_bwd_tiles<32, 4>;
  }
};

}  // namespace

// C interface (ctypes).  `tabs` (6, T): bg, cf, pr, lens, office and
// headroom (cap - office, kW); `base` (T, M); `camp` (9, M): n_scen, the
// finish threshold, rate_at_full, batch_overhead_s, idle_w, dyn_w, alpha,
// gamma, overhead_w_frac; everything double but `rowidx` (int32).  The
// backward's `lam` is an (N, M) workspace, used past 128 campaigns.
// Returns the CUDA error of the launch (0: launched).  Up to 128 campaigns
// the tile kernels (a block a member, `plan`), past that the streaming
// ones (a warp a member).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > M_TILES) {
    const int warps = plan_warps(N, sm_count());
    fleet_fwd_stream<<<(N + warps - 1) / warps, 32 * warps, 0, s>>>(
        F, kwh, co2, rt, cost, unf, peak, rem_hist, peak_hist);
    return (int)cudaGetLastError();
  }
  const Plan p = plan(M, T);
  const auto kernel = TileKernel<false>::of(M);
  const cudaError_t err = allow_smem(kernel, p.smem_fwd);
  if (err != cudaSuccess) return (int)err;
  kernel<<<N, p.threads, p.smem_fwd, s>>>(F, p.slots, kwh, co2, rt, cost,
                                          unf, peak, rem_hist, peak_hist);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > M_TILES) {
    const int warps = plan_warps(N, sm_count());
    fleet_bwd_stream<<<(N + warps - 1) / warps, 32 * warps, 0, s>>>(
        F, rem_hist, peak_hist, g_kwh, g_co2, g_rt, g_cost, g_unf, g_peak,
        lam, g_u);
    return (int)cudaGetLastError();
  }
  const Plan p = plan(M, T);
  const auto kernel = TileKernel<true>::of(M);
  const cudaError_t err = allow_smem(kernel, p.smem_bwd);
  if (err != cudaSuccess) return (int)err;
  kernel<<<N, p.threads, p.smem_bwd, s>>>(F, p.slots, rem_hist, peak_hist,
                                          g_kwh, g_co2, g_rt, g_cost, g_unf,
                                          g_peak, g_u);
  return (int)cudaGetLastError();
}

// The tile kernels' launch for M campaigns (1..128) over T slots: out[0..4]
// = threads a block, slots a tile, threads a slot's group, the dynamic
// shared bytes of the forward (bwd = 0) or backward kernel, and the blocks
// an SM holds (CUDA's occupancy API).
extern "C" int fleet_scan_plan(int M, int T, int bwd, int* out) {
  if (M < 1 || M > M_TILES) return (int)cudaErrorInvalidValue;
  const Plan p = plan(M, T);
  const int smem = bwd ? p.smem_bwd : p.smem_fwd;
  cudaError_t err;
  int blocks = 0;
  if (bwd) {
    const auto k = TileKernel<true>::of(M);
    err = allow_smem(k, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                          p.threads, smem);
  } else {
    const auto k = TileKernel<false>::of(M);
    err = allow_smem(k, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                          p.threads, smem);
  }
  out[0] = p.threads;
  out[1] = p.slots;
  out[2] = p.group;
  out[3] = smem;
  out[4] = blocks;
  return (int)err;
}

// The throttle steps every kernel takes a slot.
extern "C" int fleet_scan_iters() { return ITERS; }
