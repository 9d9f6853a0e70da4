"""System auto-detection (paper Algorithm 1, line 3: "Detect machine
characteristics and initialize tracker"; §2: "the current implementation
also supports system auto-detection").

Detects host characteristics (cores, memory, accelerator platform/count)
and derives an estimation MachineProfile / ChipProfile.  Pure estimation —
no meters — per the paper's method; every inferred constant is carried in
the profile `meta` so dashboards can show the provenance of the estimate.

The port of `src/repro/core/sysinfo.py`: the accelerator is read through
torch (`torch_backend`, `torch_devices`, `torch_device_kind`, the last
from `torch.cuda.get_device_name`), and the table of known chips holds
the reference's TPU rows plus the NVIDIA H100 the port runs on.  An
unknown kind (a CPU host among them) gives the v5e-class default, as in
the reference; callers on the card pass `chip_profile_from_host()`.
"""
from __future__ import annotations

import dataclasses
import os
import platform
from typing import Dict, Optional

from repro_torch.core.energy import ChipProfile, MachineProfile


def _read_meminfo_gb() -> Optional[float]:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) / 1024 / 1024
    except OSError:
        pass
    return None


def detect_host() -> Dict:
    """Raw host characteristics."""
    info: Dict = {
        "hostname": platform.node(),
        "machine": platform.machine(),
        "system": platform.system(),
        "cpus": os.cpu_count() or 1,
        "mem_gb": _read_meminfo_gb(),
    }
    try:
        import torch
        if torch.cuda.is_available():
            info["torch_backend"] = "cuda"
            info["torch_devices"] = torch.cuda.device_count()
            info["torch_device_kind"] = torch.cuda.get_device_name(0)
        else:
            info["torch_backend"] = "cpu"
            info["torch_devices"] = 1
            info["torch_device_kind"] = "cpu"
    except Exception:
        info["torch_backend"] = None
        info["torch_devices"] = 0
        info["torch_device_kind"] = "unknown"
    return info


# Workstation-class TDP estimation by core count (estimation-based, as the
# paper's method allows; the calibration pass re-solves dyn_w anyway).
_TDP_BY_CORES = ((4, 65.0), (8, 95.0), (16, 145.0), (32, 220.0), (64, 320.0))


def machine_profile_from_host(info: Optional[Dict] = None) -> MachineProfile:
    info = info or detect_host()
    cores = info.get("cpus", 8)
    dyn = next((w for c, w in _TDP_BY_CORES if cores <= c), 360.0)
    idle = max(30.0, dyn * 0.35)
    return dataclasses.replace(MachineProfile(), name=f"auto-{info.get('hostname', 'host')}",
                               idle_w=idle, dyn_w=dyn)


# NVIDIA H100 SXM (data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# 450 GB/s of NVLink each way, 700 W board power); `pj_per_flop` puts
# full-rate compute at the board power, as the TPU rows do; `idle_w` is
# the card's own `nvidia-smi` power draw at rest (PERF.md §3, device row).
H100_PEAK_FLOPS = 989e12
H100_TDP_W = 700.0
H100 = ChipProfile(name="nvidia-h100", peak_flops=H100_PEAK_FLOPS,
                   hbm_bw=3.35e12, ici_bw=450e9, idle_w=70.4,
                   tdp_w=H100_TDP_W,
                   pj_per_flop=H100_TDP_W / H100_PEAK_FLOPS * 1e12)

# Known accelerator energy profiles (per-chip; estimation constants)
_CHIP_TABLE = {
    "tpu v5e": ChipProfile(),
    "tpu v5": ChipProfile(name="tpu-v5p", peak_flops=459e12, hbm_bw=2765e9,
                          ici_bw=90e9, idle_w=90.0, tdp_w=350.0),
    "tpu v4": ChipProfile(name="tpu-v4", peak_flops=275e12, hbm_bw=1228e9,
                          ici_bw=50e9, idle_w=90.0, tdp_w=300.0),
    "h100": H100,
}


def chip_profile_from_host(info: Optional[Dict] = None) -> ChipProfile:
    info = info or detect_host()
    kind = (info.get("torch_device_kind") or "").lower()
    for key, prof in _CHIP_TABLE.items():
        if key in kind:
            return prof
    return ChipProfile()  # v5e-class default (the assignment target)
