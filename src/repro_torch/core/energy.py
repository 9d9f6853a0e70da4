"""Estimation-based energy models (the paper's central methodological choice:
"estimates energy load ... enabling use even when direct device-level carbon
metrology is unavailable").

Two modes behind one API:

* RUNTIME mode (paper-faithful): E = integral of P(u, b) dt over tracked
  units, with a machine power profile (idle watts + convex dynamic term and
  background contention).  This is what the policy simulator and the OEM
  case reproduction use.

* ROOFLINE mode (TPU-native adaptation): per-step joules derived from the
  dry-run's compiled cost analysis —
      E_step = FLOPs*pJ/FLOP + HBM_bytes*pJ/B + ICI_bytes*pJ/B + idle*t_step
  grounded in the same three terms as EXPERIMENTS.md §Roofline.  This is
  strictly better-grounded than runtime-only estimation and keeps the
  paper's estimation-not-metering philosophy on hardware we cannot meter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import model

# ---------------------------------------------------------------------------
# TPU v5e-class hardware constants (assignment-specified)
PEAK_FLOPS_BF16 = 197e12          # per chip
HBM_BW = 819e9                    # B/s per chip
ICI_BW = 50e9                     # B/s per link


@dataclasses.dataclass(frozen=True)
class ChipProfile:
    """TPU chip energy profile (estimation constants, documented basis).

    pj_per_flop is set so that 100% MFU compute power ~= board TDP-class
    power: 200 W / 197e12 FLOP/s ~= 1.0 pJ/FLOP.  HBM ~15 pJ/B and ICI
    ~30 pJ/B are DRAM/interconnect-class figures from the architecture
    literature (order-of-magnitude estimates, as the paper's method allows).
    """
    name: str = "tpu-v5e"
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW
    idle_w: float = 60.0
    tdp_w: float = 200.0
    pj_per_flop: float = 1.0
    pj_per_hbm_byte: float = 15.0
    pj_per_ici_byte: float = 30.0


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """Workstation profile for RUNTIME mode (paper's OEM context).

    P(u, b) = idle_w + dyn_w * (u + b)^alpha  — u is our worker intensity,
    b the background (interactive office) load; alpha > 1 captures
    frequency/turbo convexity.  gamma is the contention throughput penalty:
    effective throughput = R * u * (1 - gamma * b).

    Defaults are the calibrated values (EXPERIMENTS.md §Paper-validation):
    with dyn_w solved per-case so the baseline kWh matches exactly, the
    boosted-off-hours policy lands at (-9.6% energy, +7.0% runtime) against
    the paper's reported (~-9%, ~+7%).
    """
    name: str = "oem-workstation"
    idle_w: float = 80.0
    dyn_w: float = 220.0            # re-solved by calibration per case
    alpha: float = 1.7
    gamma: float = 0.8
    overhead_w_frac: float = 0.35   # power fraction of dyn during batch overhead

    def power(self, u: float, b: float = 0.0) -> float:
        return model.power_w(u + b, self.idle_w, self.dyn_w, self.alpha)

    def background_power(self, b: float) -> float:
        return model.power_w(b, self.idle_w, self.dyn_w, self.alpha)


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StepCost:
    """Per-step compiled cost terms (from launch/dryrun.py analysis)."""
    flops: float                      # per chip
    hbm_bytes: float                  # per chip
    ici_bytes: float                  # per chip
    chips: int = 1

    def roofline_seconds(self, chip: ChipProfile = ChipProfile()) -> Dict[str, float]:
        return {
            "compute_s": self.flops / chip.peak_flops,
            "memory_s": self.hbm_bytes / chip.hbm_bw,
            "collective_s": self.ici_bytes / chip.ici_bw,
        }

    def step_seconds(self, chip: ChipProfile = ChipProfile()) -> float:
        t = self.roofline_seconds(chip)
        # roofline execution model: bounded by the dominant term
        return max(t.values())

    def bottleneck(self, chip: ChipProfile = ChipProfile()) -> str:
        t = self.roofline_seconds(chip)
        return max(t, key=t.get).replace("_s", "")


class EnergyModel:
    """Unified estimator. Construct with a ChipProfile (roofline mode) and/or
    a MachineProfile (runtime mode)."""

    def __init__(self, chip: ChipProfile = ChipProfile(),
                 machine: MachineProfile = MachineProfile()):
        self.chip = chip
        self.machine = machine

    # ---- roofline mode ----------------------------------------------------
    def step_energy_j(self, cost: StepCost, intensity: float = 1.0) -> float:
        """Joules per step across all chips at a given duty intensity.
        Duty-cycling stretches wall time (idle power accrues) but not the
        switched work."""
        c = self.chip
        dyn = (cost.flops * c.pj_per_flop
               + cost.hbm_bytes * c.pj_per_hbm_byte
               + cost.ici_bytes * c.pj_per_ici_byte) * 1e-12
        t = cost.step_seconds(c) / max(intensity, 1e-6)
        return (dyn + c.idle_w * t) * cost.chips

    def step_power_w(self, cost: StepCost, intensity: float = 1.0) -> float:
        t = cost.step_seconds(self.chip) / max(intensity, 1e-6)
        return self.step_energy_j(cost, intensity) / max(t, 1e-12)

    # ---- runtime mode (paper) ----------------------------------------------
    def runtime_energy_kwh(self, seconds: float, intensity: float,
                           background: float = 0.0) -> float:
        return self.machine.power(intensity, background) * seconds / 3.6e6

    def idle_energy_kwh(self, seconds: float, background: float = 0.0) -> float:
        return self.machine.background_power(background) * seconds / 3.6e6
