"""The public CARINA surface of the PyTorch port in one namespace.

    import repro_torch.carina as carina

    report = carina.Campaign(carina.OEM_CASE_1,
                             carina.PEAK_AWARE_BOOSTED).run()
    swept = carina.Campaign(carina.OEM_CASE_1).sweep(
        list(carina.POLICIES.values()), carbon_trace=week_hourly)
    site = carina.Site(power_cap_kw=0.45, office_kw=0.12)
    rows = carina.Fleet([carina.Campaign(carina.OEM_CASE_1),
                         carina.Campaign(carina.OEM_CASE_2)],
                        site).sweep([carina.PEAK_AWARE_BOOSTED])

    arch = carina.load_sample_archive("grid_week_3z.csv")
    by_zone = carina.Campaign(carina.OEM_CASE_1).sweep(
        [carina.PEAK_AWARE_BOOSTED], zones=arch)
    sess = carina.ServingSession(policy="greedy", service_rate=30.0)
    sess.submit(n=1_000_000, shape="camel", seed=7)
    rollup = sess.drain()

Every public name of `repro.carina` is here, eager.  Sweeps, serving
windows and fits run on the card by default (`device="cuda"`); pass
`device="cpu"` to run the kernels' plain PyTorch versions.
`ServingSession` schedules and executes request windows
(`submit`/`tick`/`drain`, the three `SERVING_POLICIES`, core/serve.py)
and is the live-mode adapter of the decode-serving engine
(`repro_torch.serving.engine`).  `Campaign.optimize` and
`Fleet.optimize` search schedules with gradients under `torch.autograd`
(core/optimize.py); `Campaign.run_mpc` and `Fleet.run_mpc` re-plan them
in flight under receding-horizon MPC (core/mpc.py).  `cache_dir=` (or
``CARINA_PLAN_CACHE``) keeps compiled plans on disk across processes
(core/plancache.py), and `delta_sweep` re-scans only the cases a
recurring batch changed.  `zones=` sweeps real grid archives
(core/data.py) and `Campaign.calibrate` fits the rate/power model to a
measured run (core/calibrate.py).  The reference's `backend=` and
`devices` > 1 raise.
"""
from repro_torch.core.arrivals import (DEFAULT_TIERS,  # noqa: F401
                                       LOAD_SHAPES, ArrivalBatch,
                                       QualityTier, arrival_stream)
from repro_torch.core.calibrate import (FIT_PARAMS,  # noqa: F401
                                        CalibratedModel,
                                        CalibrationObjective, Observations,
                                        fit_calibration, load_observations,
                                        observations_from_units)
from repro_torch.core.carbon import (DTE_FACTOR, MIDWEST_HOURLY,  # noqa: F401
                                     GridCarbonModel)
from repro_torch.core.controller import (CarinaController,  # noqa: F401
                                         IntensityDecision, SimClock)
from repro_torch.core.dashboard import (render_frontier_dashboard,  # noqa: F401
                                        render_run_dashboard)
from repro_torch.core.data import (GAP_POLICIES,  # noqa: F401
                                   SAMPLE_ARCHIVES, CarbonArchive,
                                   QualityReport, ZoneSeries,
                                   load_carbon_archive, load_sample_archive,
                                   sample_archive_path,
                                   write_synthetic_archive)
from repro_torch.core.energy import (ChipProfile, EnergyModel,  # noqa: F401
                                     MachineProfile, StepCost)
from repro_torch.core.engine import (SweepCase,  # noqa: F401
                                     frontier_from_sweep, hourly_profile,
                                     sweep)
from repro_torch.core.engine_torch import (DeltaSweepResult,  # noqa: F401
                                           EvalMetrics, FleetEvalMetrics,
                                           FleetTraceObjective,
                                           PlanCacheInfo, PlanCursor,
                                           ScanStats, SweepPlan,
                                           TraceObjective, clear_plan_cache,
                                           compile_plan, delta_sweep,
                                           evaluate_params, execute_interval,
                                           execute_plan, new_cursor,
                                           plan_cache_info, plan_from_numpy,
                                           replace_tables, reset_scan_stats,
                                           scan_stats, summarize_plan,
                                           trace_sweep)
from repro_torch.core.fleet import (Fleet, FleetResult, Site,  # noqa: F401
                                    SiteRollup, fleet_sweep, simulate_fleet)
from repro_torch.core.model import site_throttle  # noqa: F401
from repro_torch.core.mpc import (FleetMPCSession, MPCResult,  # noqa: F401
                                  MPCSession, ReplanRecord, run_mpc)
from repro_torch.core.optimize import (ROBUST_MODES,  # noqa: F401
                                       FleetOptimizeResult, Objective,
                                       OptimizeResult, optimize_fleet,
                                       optimize_schedule, pareto_front,
                                       reduce_ensemble, scalarize_fleet)
from repro_torch.core.plancache import PlanCache  # noqa: F401
from repro_torch.core.policy import (BANDS, BASELINE,  # noqa: F401
                                     LARGE_BATCHES, LOW_PRIORITY_ONLY,
                                     PEAK_AWARE_AGGRESSIVE,
                                     PEAK_AWARE_BOOSTED, POLICIES,
                                     SMALL_BATCHES, HourlyPolicy, Policy,
                                     TimeBands, constant_schedule,
                                     hourly_schedule,
                                     make_carbon_aware_policy,
                                     make_carbon_weighted_boosted)
from repro_torch.core.schedule import (AllocationSchedule,  # noqa: F401
                                       CarbonGateSchedule, DeadlineSchedule,
                                       Decision, FunctionSchedule,
                                       ParametricSchedule, Schedule,
                                       SchedulingContext, as_schedule,
                                       carbon_gated_cap, deadline_schedule,
                                       deadline_weighted_split,
                                       dedupe_names, parametric_schedule,
                                       progress_ramp_schedule,
                                       proportional_split)
from repro_torch.core.serve import (DEFAULT_FILL_FRAC,  # noqa: F401
                                    SERVING_POLICIES, Assignment,
                                    FifoServingPolicy, GreedyServingPolicy,
                                    OptimizedServingPolicy, ServingRollup,
                                    ServingSession, ServingWindow,
                                    WindowReport, as_serving_policy,
                                    execute_assignment, serve_window)
from repro_torch.core.session import Campaign, CampaignReport  # noqa: F401
from repro_torch.core.signal import (TOU_PRICE, BandSignal,  # noqa: F401
                                     ConstantSignal, DayAheadForecast,
                                     ForecastModel, HourlySignal,
                                     OracleForecast, PersistenceForecast,
                                     Signal, SignalEnsemble, SignalSet,
                                     TraceSignal, as_ensemble, as_forecast,
                                     as_trace, background_signal,
                                     carbon_signal, day_ahead,
                                     default_signals, is_periodic_24h,
                                     oracle, persistence, sample_signal,
                                     trace_windows)
from repro_torch.core.simulator import (EnsembleStats, SimResult,  # noqa: F401
                                        calibrate_workload, ensemble_stats,
                                        policy_frontier, simulate_campaign,
                                        simulate_campaign_exact)
from repro_torch.core.tracker import (RunSummary, RunTracker,  # noqa: F401
                                      UnitRecord, load_units,
                                      merge_summaries, summary_from_units)
from repro_torch.core.workload import (OEM_CASE_1, OEM_CASE_2,  # noqa: F401
                                       OEMWorkload, TrainingCampaign)
