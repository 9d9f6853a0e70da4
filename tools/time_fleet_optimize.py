"""Time the README's capped two-OEM `Fleet.optimize` on the card, for one
or more source trees of the port, each run in a process of its own.

    python3 tools/time_fleet_optimize.py [--steps 500] [--src DIR ...]

`--src` names the `src` directory of each checkout to time, in order
(default: this checkout's); give a parent checkout's twice around this
one's (parent, change, change, parent) to compare two versions on one
card.  Each run first takes a short warm-up optimize (the kernels' build
and first launches), then times `Fleet([OEM 1, OEM 2], Site(0.45,
0.12)).optimize("co2", deadlines=[300, 480], steps=...)` (the README's
call at its default 500 steps unless `--steps` says otherwise): its
wall, the seconds of each CEM and gradient search, and in each search
the objective kernels' launches (K3 `objective_scan`, K4
`fleet_objective`: forward and backward) and the plain capped fleet's
throttle passes (`FleetTraceObjective._pass`, with and without
autograd; a tree whose objectives run the kernels on the card takes
none).  Prints the card's name and power limit, then one JSON line a
run; needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_run(steps: int) -> dict:
    import torch

    from repro_torch import carina
    from repro_torch.core import engine_torch as et
    from repro_torch.core import optimize as opt

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    try:
        from repro_torch.kernels import fleet_objective as k4
        from repro_torch.kernels import objective_scan as k3
        kernels = {"k3": k3, "k4": k4}
    except ImportError:             # a tree before the objective kernels
        kernels = {}
    passes = {"grad": 0, "no_grad": 0}
    searches = []
    inner = et.FleetTraceObjective._pass

    def counted(self, *args):
        passes["grad" if torch.is_grad_enabled() else "no_grad"] += 1
        return inner(self, *args)

    def counts():
        out = dict(passes)
        for key, mod in kernels.items():
            out[f"{key}_fwd"] = mod.fwd_launches
            out[f"{key}_bwd"] = mod.bwd_launches
        return out

    def timed(name):
        fn = getattr(opt, name)

        def run(*args, **kwargs):
            c0 = counts()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                c1 = counts()
                searches.append(dict(
                    search=name.strip("_").split("_")[0],
                    s=time.perf_counter() - t0,
                    counts={k: c1[k] - c0[k] for k in c1}))
        return fn, run

    site = carina.Site(power_cap_kw=0.45, office_kw=0.12)
    fleet = carina.Fleet([carina.Campaign(carina.OEM_CASE_1),
                          carina.Campaign(carina.OEM_CASE_2)], site)
    dls = [300.0, 480.0]
    fleet.optimize("co2", deadlines=dls, candidates=8, iterations=1,
                   steps=2)
    torch.cuda.synchronize()
    et.FleetTraceObjective._pass = counted
    saved = {name: timed(name) for name in ("_cem_search", "_grad_search")}
    for name, (_, run) in saved.items():
        setattr(opt, name, run)
    try:
        t0 = time.perf_counter()
        res = fleet.optimize("co2", deadlines=dls, steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        et.FleetTraceObjective._pass = inner
        for name, (fn, _) in saved.items():
            setattr(opt, name, fn)
    return dict(wall_s=wall, steps=steps, searches=searches,
                site_co2_kg=res.site.co2_kg, peak_kw=res.site.peak_kw)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--src", nargs="+", default=[str(ROOT / "src")])
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_run(args.steps)), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for src in args.src:
        env = dict(os.environ, PYTHONPATH=str(Path(src).resolve()))
        out = subprocess.run(
            [sys.executable, __file__, "--one", "--steps", str(args.steps)],
            env=env, capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(src=src, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
