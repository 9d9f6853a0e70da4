"""Recurrent-workload descriptions (paper §2: "a sequence of tracked units,
where a unit may be a full run, a refresh batch, a wave, an epoch, or a
training round").

`OEMWorkload` models the paper's sheet-metal database-generation campaigns:
N scenarios executed in batches against worker-local engines, with per-batch
orchestration overhead (write inputs / trigger recalc / extract / store) and
resume/merge/verify bookkeeping.

`TrainingCampaign` is the TPU-side analogue: a recurring train/eval workload
whose unit is a training round of `steps_per_unit` steps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.energy import StepCost


@dataclasses.dataclass(frozen=True)
class OEMWorkload:
    name: str
    n_scenarios: int
    rate_at_full: float           # scenarios/s at intensity 1.0, no contention
    batch_overhead_s: float       # per-batch orchestration time
    # measured baseline (for calibration/validation)
    measured_hours: Optional[float] = None
    measured_kwh: Optional[float] = None


# The two automotive OEM case studies (paper §3). rate_at_full is derived in
# core/simulator.calibrate_rate so that the measured runtime is matched
# exactly under the baseline policy.
OEM_CASE_1 = OEMWorkload("oem-case-1", 1_480_000, rate_at_full=0.0,
                         batch_overhead_s=2.0,
                         measured_hours=180.30, measured_kwh=48.67)
OEM_CASE_2 = OEMWorkload("oem-case-2", 3_660_000, rate_at_full=0.0,
                         batch_overhead_s=2.0,
                         measured_hours=274.75, measured_kwh=74.16)


@dataclasses.dataclass(frozen=True)
class TrainingCampaign:
    """Recurrent ML workload (scheduled retraining / eval / HPO wave)."""
    name: str
    arch: str
    total_steps: int
    steps_per_unit: int
    step_cost: Optional[StepCost] = None     # from the dry-run, when available
    step_seconds_hint: float = 1.0           # fallback if no compiled cost
