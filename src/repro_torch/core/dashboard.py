"""Local dashboard reporting (paper §2: "structured logs, summary metrics,
plots, and dashboard artifacts").

Emits a self-contained markdown dashboard + machine-readable JSON; a PNG
frontier plot is produced when matplotlib is importable (optional).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

from repro_torch.core.simulator import SimResult
from repro_torch.core.tracker import RunSummary


def _spark(values: Sequence[float], width: int = 48) -> str:
    if not values:
        return ""
    blocks = "▁▂▃▄▅▆▇█"
    lo, hi = min(values), max(values)
    rng = (hi - lo) or 1.0
    step = max(1, len(values) // width)
    vs = [values[i] for i in range(0, len(values), step)]
    return "".join(blocks[min(7, int(7 * (v - lo) / rng))] for v in vs)


def render_run_dashboard(summary: RunSummary, out_dir: str,
                         power_series: Optional[Sequence[float]] = None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    lines = [
        f"# CARINA run dashboard — {summary.name}",
        "",
        f"| metric | value |",
        f"|---|---|",
        f"| tracked units | {summary.units} |",
        f"| runtime | {summary.runtime_h:.2f} h |",
        f"| energy load | {summary.energy_kwh:.3f} kWh |",
        f"| carbon burden | {summary.co2_kg:.3f} kg CO2e |",
        "",
        "## By phase",
        "",
        "| phase | units | runtime (h) | energy (kWh) | CO2e (kg) |",
        "|---|---|---|---|---|",
    ]
    for ph, d in sorted(summary.by_phase.items()):
        lines.append(f"| {ph} | {int(d['units'])} | {d['runtime_s']/3600:.2f} "
                     f"| {d['energy_kwh']:.3f} | {d['co2_kg']:.3f} |")
    if power_series:
        lines += ["", "## Power trace", "", "```", _spark(power_series), "```"]
    md = "\n".join(lines) + "\n"
    with open(os.path.join(out_dir, "dashboard.md"), "w") as f:
        f.write(md)
    with open(os.path.join(out_dir, "dashboard.json"), "w") as f:
        json.dump(dataclasses.asdict(summary), f, indent=2, sort_keys=True)
    return md


def _co2_cell(r: SimResult) -> str:
    """CO2 column cell: point value, or mean ±std with the q05–q95
    spread when the row carries ensemble stats."""
    s = r.co2_ensemble
    if s is None:
        return f"{r.co2_kg:.2f}"
    return (f"{s.mean:.2f} ±{s.std:.2f} "
            f"[{s.q05:.2f}…{s.q95:.2f}]")


def render_frontier_dashboard(results: List[SimResult], out_dir: str,
                              title: str = "policy frontier",
                              site_rollups=None) -> str:
    """Markdown + JSON (+ optional PNG) frontier table.

    Rows with `EnsembleStats` (carbon-ensemble sweeps) render the CO2
    column as mean ±std with the q05–q95 spread, and the PNG gains a
    CO2 whisker panel.  `site_rollups` is an optional list of
    `(label, SiteRollup)` pairs from fleet results — each gets a
    site-totals row (makespan, summed energy/CO2, peak site draw)
    appended under the per-campaign rows.
    """
    os.makedirs(out_dir, exist_ok=True)
    has_ens = any(r.co2_ensemble is not None for r in results)
    co2_head = "CO2e (kg, mean ±std [q05…q95])" if has_ens else "CO2e (kg)"
    lines = [
        f"# CARINA {title}",
        "",
        f"| policy | runtime (h) | energy (kWh) | {co2_head} "
        "| Δruntime | Δenergy |",
        "|---|---|---|---|---|---|",
    ]
    for r in results:
        lines.append(
            f"| {r.policy} | {r.runtime_h:.2f} | {r.energy_kwh:.2f} "
            f"| {_co2_cell(r)} | {r.runtime_delta_pct:+.2f}% "
            f"| {r.energy_delta_pct:+.2f}% |")
    if site_rollups:
        lines += [
            "",
            "## Site rollup",
            "",
            "| fleet case | campaigns | makespan (h) | energy (kWh) "
            f"| {co2_head} | peak draw (kW) |",
            "|---|---|---|---|---|---|",
        ]
        for label, s in site_rollups:
            s_ens = getattr(s, "co2_ensemble", None)
            co2 = (f"{s_ens.mean:.2f} ±{s_ens.std:.2f} "
                   f"[{s_ens.q05:.2f}…{s_ens.q95:.2f}]"
                   if s_ens is not None else f"{s.co2_kg:.2f}")
            peak = f"{s.peak_kw:.3f}" if s.peak_kw is not None else "—"
            lines.append(
                f"| {label} | {s.n_campaigns} | {s.runtime_h:.2f} "
                f"| {s.energy_kwh:.2f} | {co2} | {peak} |")
    md = "\n".join(lines) + "\n"
    with open(os.path.join(out_dir, "frontier.md"), "w") as f:
        f.write(md)
    payload = [dataclasses.asdict(dataclasses.replace(r, summary=None))
               for r in results]
    if site_rollups:
        payload = {"rows": payload,
                   "site_rollups": [dict(dataclasses.asdict(s), label=label)
                                    for label, s in site_rollups]}
    with open(os.path.join(out_dir, "frontier.json"), "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    try:  # optional plot
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        if has_ens:
            fig, (ax, axc) = plt.subplots(
                1, 2, figsize=(10, 4),
                gridspec_kw={"width_ratios": [3, 2]})
        else:
            fig, ax = plt.subplots(figsize=(6, 4))
            axc = None
        for r in results:
            ax.scatter(r.runtime_delta_pct, -r.energy_delta_pct, s=40)
            ax.annotate(r.policy.replace("peak_aware_", "pa_"),
                        (r.runtime_delta_pct, -r.energy_delta_pct), fontsize=7)
        ax.set_xlabel("runtime penalty (%)")
        ax.set_ylabel("energy savings (%)")
        ax.grid(alpha=0.3)
        ax.set_title(title)
        if axc is not None:
            # CO2 whiskers: mean ±std box via errorbar, q05–q95 span as
            # thin whiskers, one row per policy
            rows = [r for r in results if r.co2_ensemble is not None]
            ys = range(len(rows))
            for y, r in zip(ys, rows):
                s = r.co2_ensemble
                axc.plot([s.q05, s.q95], [y, y], color="0.6", lw=1)
                axc.errorbar([s.mean], [y], xerr=[[s.std], [s.std]],
                             fmt="o", ms=4, capsize=3)
            axc.set_yticks(list(ys))
            axc.set_yticklabels([r.policy.replace("peak_aware_", "pa_")
                                 for r in rows], fontsize=7)
            axc.set_xlabel("CO2e (kg): mean ±std, q05–q95")
            axc.grid(alpha=0.3, axis="x")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "frontier.png"), dpi=120)
        plt.close(fig)
    except Exception:
        pass
    return md
