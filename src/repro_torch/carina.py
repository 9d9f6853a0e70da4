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

Names mirror `repro.carina` for what the port covers.  Sweeps run on the
card by default (`device="cuda"`); pass `device="cpu"` to run the
kernels' plain PyTorch versions.  Not ported yet: `optimize`, MPC,
serving, grid-data ingestion and calibration, the plan cache and
`delta_sweep` (see ROADMAP.md).
"""
from repro_torch.core.carbon import (DTE_FACTOR, MIDWEST_HOURLY,  # noqa: F401
                                     GridCarbonModel)
from repro_torch.core.controller import (CarinaController,  # noqa: F401
                                         IntensityDecision, SimClock)
from repro_torch.core.dashboard import (render_frontier_dashboard,  # noqa: F401
                                        render_run_dashboard)
from repro_torch.core.energy import (ChipProfile, EnergyModel,  # noqa: F401
                                     MachineProfile, StepCost)
from repro_torch.core.engine import (SweepCase,  # noqa: F401
                                     frontier_from_sweep, hourly_profile,
                                     sweep)
from repro_torch.core.engine_torch import (PlanCursor, ScanStats,  # noqa: F401
                                           SweepPlan, compile_plan,
                                           execute_interval, execute_plan,
                                           new_cursor, plan_from_numpy,
                                           reset_scan_stats, scan_stats,
                                           summarize_plan, trace_sweep)
from repro_torch.core.fleet import (Fleet, FleetResult, Site,  # noqa: F401
                                    SiteRollup, fleet_sweep, simulate_fleet)
from repro_torch.core.model import site_throttle  # noqa: F401
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
