#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CARINA on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's CUDA kernels from `src/repro_torch/csrc/` with nvcc,
drives the trace-sweep engine through its entry points at benchmark
sizes, holds every kernel against its plain PyTorch version on the card,
and checks the answers against the repo's own oracles:

  1. the card's name and power limit; the kernels' build time;
  2. K2 (`scan_chunk`): `execute_plan` over S = 100,000 uncoupled lanes
     (OEM case 1 trimmed to 300,000 scenarios, a 64-schedule hourly
     family, a week-long carbon trace, progress_buckets=8), fp64 and
     mixed, kernel vs plain version, launches and ms per launch;
  3. K1 (`coupled_chunk`): `fleet_sweep` over 8 campaigns x 500 fleet
     cases = 4,000 coupled lanes under `Site(power_cap_kw=2.0,
     office_kw=0.12)`, the same checks plus the site peak;
  4. end to end through `repro_torch.carina`: `Campaign.sweep` over a
     week-long carbon trace, the README's capped two-OEM `Fleet.sweep`
     (both against the same sweep on the CPU and the fleet against the
     sequential oracle), `scan_stats()` kernel dispatches, and the OEM
     case 1 baseline (180.30 h / 48.67 kWh);
  5. one JSON line of per-kernel numbers, then the result line.

Exits non-zero, before printing any result, without a CUDA device or
without the repo's sources beside it; any failed check raises.  Long
build logs go to `chiprun_out/chip_smoke/`.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp64 and fp32 rates
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"float64": 34e12, "float32": 67e12}
# operations per lane-slot, a `pow` counted as one (see the .cu notes)
K2_OPS = {"phys": 31, "state": 7}         # + 2 per carbon member (state)
K1_OPS = {"phys": 160, "state": 8}


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_err(a, b, scale=None):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    den = np.abs(b) if scale is None else np.asarray(scale, dtype=float)
    return float(np.max(np.abs(a - b) / np.maximum(den, 1e-300)))


def state_err(got, ref, n_scen):
    """Max per-lane relative error over the carried state (remaining is
    relative to the lane's workload, the sums to their own value)."""
    errs = [rel_err(got.remaining, ref.remaining, n_scen)]
    errs += [rel_err(getattr(got, f), getattr(ref, f))
             for f in ("runtime_s", "kwh", "co2", "cost")
             if getattr(ref, f).any()]
    if ref.site_kw_peak is not None:
        errs.append(rel_err(got.site_kw_peak, ref.site_kw_peak))
    return max(errs)


@contextlib.contextmanager
def plain_versions(k2, k1):
    """Route the engine's chunk steps to the kernels' plain versions."""
    saved = k2.scan_chunk, k1.coupled_chunk
    k2.scan_chunk, k1.coupled_chunk = (k2.scan_chunk_plain,
                                       k1.coupled_chunk_plain)
    try:
        yield
    finally:
        k2.scan_chunk, k1.coupled_chunk = saved


@contextlib.contextmanager
def first_launch(mod, name, store):
    """Keep the arguments of the first call of `mod.name`."""
    fn = getattr(mod, name)

    def rec(*args, **kwargs):
        if not store:
            store.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(mod, name, rec)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def cuda_ms(torch, fn, reps):
    """Mean ms per call of `fn` on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def slots_run(torch, rt_in, rt_out, lens):
    """Slots each lane executed in a chunk (the partial last one too):
    the slots that start before the lane's elapsed chunk time."""
    starts = torch.cumsum(lens.double(), dim=-1) - lens.double()
    elapsed = (rt_out - rt_in)[..., None]
    return (starts < elapsed - 1e-9 * lens.double()).sum(dim=-1)


def bound_ms(bytes_, ops_phys, ops_state, cdt):
    t_bytes = bytes_ / PEAK_BYTES_S
    t_ops = ops_phys / PEAK_OPS_S[cdt] + ops_state / PEAK_OPS_S["float64"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k2_bound(torch, args, out, B):
    """Least time for one K2 launch on these inputs: each lane's table
    rows it touches, its series over the slots it ran, state in and out,
    its scalars; operations per executed lane-slot."""
    u_tab, _, rowidx, bg, cf, pr, lens = args[:7]
    A, R, _ = u_tab.shape
    E = cf.shape[1]
    t = u_tab.element_size()
    run = slots_run(torch, args[8], out[1], lens)
    n = int(run.sum())
    rows = int(torch.clamp(run, max=R).sum())
    bytes_ = (rows * 2 * B * t + n * (4 + (3 + E) * t)
              + A * (2 * (4 + E) * 8 + 8 * t))
    return bound_ms(bytes_, n * K2_OPS["phys"],
                    n * (K2_OPS["state"] + 2 * E),
                    str(u_tab.dtype).split(".")[1])


def k1_bound(torch, args, out):
    """Least time for one K1 launch: the pre-gathered rows and series of
    each lane over the slots it ran, the groups' caps and office draw,
    state in and out, scalars; operations per executed lane-slot."""
    u_rows, _, bg, cf, pr, lens, cap, office = args[:8]
    G, Lp, C, B = u_rows.shape
    E = cf.shape[2]
    t = u_rows.element_size()
    run = slots_run(torch, args[9], out[1], lens)
    n = int(run.sum())
    live = int((args[8] > 0).sum())
    bytes_ = (n * (2 * B + 3 + E) * t + G * (1 + C) * t
              + live * (2 * (5 + E) * 8 + 8 * t))
    return bound_ms(bytes_, n * K1_OPS["phys"],
                    n * (K1_OPS["state"] + 2 * E),
                    str(u_rows.dtype).split(".")[1])


def max_abs(torch, outs_a, outs_b):
    return max(float((a - b).abs().max()) for a, b in zip(outs_a, outs_b)
               if a.numel())


def week_trace(carina):
    """The 7-day synthetic carbon trace of the benchmarks: diurnal swing +
    weekly drift + seeded noise around the DTE grid factor."""
    rng = np.random.RandomState(7)
    h = np.arange(168)
    return carina.TraceSignal(tuple(
        carina.DTE_FACTOR * (1.0 + 0.30 * np.sin(2 * np.pi * h / 24.0)
                             + 0.08 * np.sin(2 * np.pi * h / 168.0)
                             + 0.05 * rng.randn(168))), name="week")


def hourly_family(carina, n, prefix):
    return [carina.hourly_schedule(
        f"{prefix}{i}", [0.35 + 0.6 * ((3 * i + h) % 24) / 23
                         for h in range(24)]) for i in range(n)]


def phase_scan_chunk(torch, carina, et, k2, k1, dev, S=100_000):
    """K2 at the scale-out benchmark's size, fp64 and mixed."""
    wl, m = carina.calibrate_workload(carina.OEM_CASE_1,
                                      carina.MachineProfile())
    wl = dataclasses.replace(wl, n_scenarios=300_000)
    trace = week_trace(carina)
    scheds = hourly_family(carina, 64, "sc")
    cases = [carina.SweepCase(scheds[i % 64], wl, m, carbon=trace)
             for i in range(S)]
    t0 = time.perf_counter()
    plan = et.compile_plan(cases, progress_buckets=8)
    mixed = et.compile_plan(cases, progress_buckets=8, precision="mixed")
    t_compile = time.perf_counter() - t0

    # the main path: counts zeroed just before, read just after
    et.reset_scan_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = et.execute_plan(plan, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = et.scan_stats()
    launches = st.kernel_dispatches["scan_chunk"]
    check(launches > 0, "execute_plan launched no scan_chunk kernel")
    check(st.kernel_dispatches["coupled_chunk"] == 0,
          "an uncoupled plan launched the coupled kernel")

    captured = []
    with first_launch(k2, "scan_chunk", captured):
        got_mixed = et.execute_plan(mixed, device=dev)
    with plain_versions(k2, k1):
        ref = et.execute_plan(plan, device=dev)
        ref_mixed = et.execute_plan(mixed, device=dev)
    err64 = state_err(got, ref, plan.n_scen)
    err_mixed = max(rel_err(getattr(got_mixed, f), getattr(got, f))
                    for f in ("runtime_s", "kwh", "co2"))
    err_mixed_plain = state_err(got_mixed, ref_mixed, plan.n_scen)
    check(err64 <= 1e-9, f"K2 fp64 kernel vs plain: {err64:.3e} > 1e-9")
    check(err_mixed <= 1e-6, f"K2 mixed vs fp64: {err_mixed:.3e} > 1e-6")
    check(err_mixed_plain <= 1e-6,
          f"K2 mixed kernel vs plain: {err_mixed_plain:.3e} > 1e-6")
    check(bool((got.remaining <= 1e-6 * plan.n_scen).all()),
          "K2 lanes did not finish")
    res = et.summarize_plan(plan, got)
    check(all(r.runtime_h > 0 and r.energy_kwh > 0 and r.co2_kg > 0
              for r in res), "K2 results not positive")

    # host-side assembly of that chunk's inputs (the rest of the wall time
    # is the copies, the launch and the state bookkeeping)
    t0 = time.perf_counter()
    et._chunk_inputs(plan, np.arange(plan.n_lanes), 0, 96 * plan.sph)
    t_inputs = time.perf_counter() - t0

    # per-launch times on the first chunk of the main path (fp64 plan)
    et.reset_scan_stats()
    captured64 = []
    with first_launch(k2, "scan_chunk", captured64):
        et.execute_plan(plan, device=dev)
    args, kw = captured64[0]
    out_k = k2.scan_chunk(*args, **kw)
    out_p = k2.scan_chunk_plain(*args, **kw)
    torch.cuda.synchronize()
    abs_err = max_abs(torch, out_k, out_p)
    ms = cuda_ms(torch, lambda: k2.scan_chunk(*args, **kw), 20)
    plain_ms = cuda_ms(torch, lambda: k2.scan_chunk_plain(*args, **kw), 3)
    b_ms, b_by = k2_bound(torch, args, out_k, kw["B"])
    margs, mkw = captured[0]
    ms_mixed = cuda_ms(torch, lambda: k2.scan_chunk(*margs, **mkw), 20)
    idle = max(0.0, 1.0 - launches * ms / (wall * 1e3))
    print(f"K2 scan_chunk: S={S} lanes, tables {tuple(plan.tab_u.shape)}, "
          f"compile_plan x2 {t_compile:.1f} s, execute_plan {wall:.3f} s, "
          f"launches {launches}, chunk shape {tuple(args[2].shape)}; "
          f"fp64 kernel vs plain max rel {err64:.3e} (bar 1e-9), "
          f"mixed vs fp64 {err_mixed:.3e} (bar 1e-6), mixed kernel vs "
          f"plain {err_mixed_plain:.3e}; ms/launch fp64 {ms:.4f} "
          f"mixed {ms_mixed:.4f} plain {plain_ms:.3f}; bound {b_ms:.4f} ms "
          f"({b_by}); host chunk assembly {t_inputs:.3f} s, copy "
          f"{st.copy_bytes / 1e9:.3f} GB; device idle share of execute_plan "
          f"{idle:.3f}", flush=True)
    return {"name": "scan_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/scan_chunk.cu",
            "replaces": "src/repro/core/engine_jax.py:1559",
            "launches": launches, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def phase_coupled_chunk(torch, carina, et, k2, k1, dev, M=8, S=500):
    """K1 at the fleet benchmark's size, fp64 and mixed."""
    wl, m = carina.calibrate_workload(carina.OEM_CASE_1,
                                      carina.MachineProfile())
    site = carina.Site(power_cap_kw=2.0, office_kw=0.12)
    wls = [dataclasses.replace(wl, name=f"wl{j}",
                               n_scenarios=int(wl.n_scenarios
                                               * (0.5 + 0.12 * j)))
           for j in range(M)]
    scheds = hourly_family(carina, S, "f")
    groups = [[carina.SweepCase(scheds[i], w, m, site.bands, None, 9.0,
                                label=f"f{i}/{w.name}") for w in wls]
              for i in range(S)]
    flat = [c for g in groups for c in g]
    kw = dict(group_sizes=[M] * S, group_caps_kw=[site.power_cap_kw] * S,
              group_office_kw=[site.office_kw] * S, max_days=240)

    # the main path: counts zeroed just before, read just after
    et.reset_scan_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = carina.fleet_sweep(groups, site, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = et.scan_stats()
    launches = st.kernel_dispatches["coupled_chunk"]
    check(launches > 0, "fleet_sweep launched no coupled_chunk kernel")
    check(len(rows) == S and all(r.site.peak_kw > 0 for r in rows),
          "fleet rows missing a site peak")

    plan = et.compile_plan(flat, progress_buckets=32, **kw)
    mixed = et.compile_plan(flat, progress_buckets=32, precision="mixed",
                            **kw)
    t0 = time.perf_counter()
    et._chunk_inputs(plan, np.arange(plan.n_lanes), 0, 96 * plan.sph)
    t_inputs = time.perf_counter() - t0
    captured = []
    with first_launch(k1, "coupled_chunk", captured):
        got = et.execute_plan(plan, device=dev)
    got_mixed = et.execute_plan(mixed, device=dev)
    with plain_versions(k2, k1):
        ref = et.execute_plan(plan, device=dev)
        ref_mixed = et.execute_plan(mixed, device=dev)
    err64 = state_err(got, ref, plan.n_scen)
    err_mixed = max(rel_err(getattr(got_mixed, f), getattr(got, f))
                    for f in ("runtime_s", "kwh", "co2"))
    err_mixed_plain = state_err(got_mixed, ref_mixed, plan.n_scen)
    peak_diff = float(abs(got.site_kw_peak - ref.site_kw_peak).max())
    check(err64 <= 1e-9, f"K1 fp64 kernel vs plain: {err64:.3e} > 1e-9")
    check(err_mixed <= 1e-6, f"K1 mixed vs fp64: {err_mixed:.3e} > 1e-6")
    check(err_mixed_plain <= 1e-6,
          f"K1 mixed kernel vs plain: {err_mixed_plain:.3e} > 1e-6")
    check(peak_diff <= 1e-9 * site.power_cap_kw,
          f"K1 site peak kernel vs plain differs by {peak_diff:.3e} kW")
    check(bool((got.remaining <= 1e-6 * plan.n_scen).all()),
          "K1 lanes did not finish")

    args, akw = captured[0]
    out_k = k1.coupled_chunk(*args, **akw)
    out_p = k1.coupled_chunk_plain(*args, **akw)
    torch.cuda.synchronize()
    abs_err = max_abs(torch, out_k, out_p)
    ms = cuda_ms(torch, lambda: k1.coupled_chunk(*args, **akw), 20)
    plain_ms = cuda_ms(torch, lambda: k1.coupled_chunk_plain(*args, **akw),
                       2)
    b_ms, b_by = k1_bound(torch, args, out_k)
    idle = max(0.0, 1.0 - launches * ms / (wall * 1e3))
    print(f"K1 coupled_chunk: {M}x{S} = {M * S} coupled lanes, dense "
          f"{tuple(args[0].shape)}, fleet_sweep {wall:.3f} s, launches "
          f"{launches}; fp64 kernel vs plain max rel {err64:.3e} (bar "
          f"1e-9), mixed vs fp64 {err_mixed:.3e} (bar 1e-6), mixed kernel "
          f"vs plain {err_mixed_plain:.3e}, site peak diff {peak_diff:.3e} "
          f"kW; ms/launch {ms:.4f} plain {plain_ms:.3f}; bound {b_ms:.4f} "
          f"ms ({b_by}); host chunk assembly (first chunk) {t_inputs:.3f} s, "
          f"copy {st.copy_bytes / 1e9:.3f} GB; first-chunk launch >= the "
          f"mean launch, so device idle share of fleet_sweep <= {idle:.3f}",
          flush=True)
    return {"name": "coupled_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/coupled_chunk.cu",
            "replaces": "src/repro/kernels/coupled_throttle.py:125",
            "launches": launches, "max_abs_err": abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def phase_end_to_end(torch, carina, et, dev):
    """The public surface on the card, checked against the same calls on
    the CPU (plain versions) and the repo's oracles."""
    week = week_trace(carina)
    scheds = list(carina.POLICIES.values()) + [
        carina.progress_ramp_schedule(0.4, 0.9),
        carina.deadline_schedule(200.0)]
    site = carina.Site(power_cap_kw=0.45, office_kw=0.12)

    def fleet():
        return carina.Fleet([carina.Campaign(carina.OEM_CASE_1),
                             carina.Campaign(carina.OEM_CASE_2)], site)

    assignments = [carina.PEAK_AWARE_BOOSTED,
                   carina.deadline_weighted_split([300, 480])]
    et.reset_scan_stats()
    swept = carina.Campaign(carina.OEM_CASE_1).sweep(scheds,
                                                     carbon_trace=week)
    rows = fleet().sweep(assignments)
    st = carina.scan_stats()
    check(st.kernel_dispatches["scan_chunk"] > 0,
          "Campaign.sweep launched no scan_chunk kernel")
    check(st.kernel_dispatches["coupled_chunk"] > 0,
          "Fleet.sweep launched no coupled_chunk kernel")
    cpu_swept = carina.Campaign(carina.OEM_CASE_1).sweep(
        scheds, carbon_trace=week, device="cpu")
    cpu_rows = fleet().sweep(assignments, device="cpu")
    e_sweep = max(rel_err([r.runtime_h, r.energy_kwh, r.co2_kg],
                          [c.runtime_h, c.energy_kwh, c.co2_kg])
                  for r, c in zip(swept, cpu_swept))
    e_fleet = max(rel_err([r.runtime_h, r.energy_kwh, r.co2_kg],
                          [c.runtime_h, c.energy_kwh, c.co2_kg])
                  for fr, fc in zip(rows, cpu_rows)
                  for r, c in zip(fr.campaigns, fc.campaigns))
    check(e_sweep <= 1e-9, f"Campaign.sweep card vs CPU: {e_sweep:.3e}")
    check(e_fleet <= 1e-9, f"Fleet.sweep card vs CPU: {e_fleet:.3e}")
    f = fleet()
    cases = f._cases([carina.PEAK_AWARE_BOOSTED] * 2,
                     carbon=f._carbon(None, None), deadlines=None,
                     label="oracle")
    orc = carina.simulate_fleet(cases, site)
    e_orc = max(abs(getattr(a, k) / getattr(b, k) - 1)
                for a, b in zip(rows[0].campaigns, orc.campaigns)
                for k in ("runtime_h", "energy_kwh", "co2_kg"))
    check(e_orc < 5e-3, f"Fleet.sweep vs simulate_fleet: {e_orc:.3e}")
    base = carina.Campaign(carina.OEM_CASE_1).run().result
    check(round(base.runtime_h, 2) == 180.30
          and round(base.energy_kwh, 2) == 48.67,
          f"OEM case 1 baseline {base.runtime_h:.2f} h / "
          f"{base.energy_kwh:.2f} kWh")
    print(f"end to end: Campaign.sweep {len(swept)} schedules over the week "
          f"trace, card vs CPU {e_sweep:.3e}; Fleet.sweep 2 OEMs under "
          f"0.45 kW, card vs CPU {e_fleet:.3e}, vs simulate_fleet "
          f"{e_orc:.3e} (bar 5e-3), site peaks "
          f"{[round(r.site.peak_kw, 4) for r in rows]} kW; kernel "
          f"dispatches {st.kernel_dispatches}; OEM case 1 baseline "
          f"{base.runtime_h:.2f} h / {base.energy_kwh:.2f} kWh", flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch.carina as carina
    from repro_torch.core import engine_torch as et
    from repro_torch.kernels import _build
    from repro_torch.kernels import coupled_chunk as k1
    from repro_torch.kernels import scan_chunk as k2

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    took = _build.build()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "build.log"), "w") as fh:
        for name, log in _build.BUILD_LOG.items():
            fh.write(f"== {name}\n{log}\n")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (per source: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")",
          flush=True)
    for name, log in _build.BUILD_LOG.items():       # ptxas -v, per kernel
        used = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"ptxas {name}: " + " | ".join(used), flush=True)
    dev = torch.device("cuda", 0)
    kernels = [phase_scan_chunk(torch, carina, et, k2, k1, dev),
               phase_coupled_chunk(torch, carina, et, k2, k1, dev)]
    phase_end_to_end(torch, carina, et, dev)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
