"""Serving entry point (the reference's `src/repro/launch/serve.py`) on one
device, wired as `examples/serving.py` wires the engine: a
`ServingSession` in live mode gates admissions on grid carbon and prices
every engine tick.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        [--no-smoke] [--slots N] [--s-max S] [--requests R] [--max-new M] \
        [--device cuda|cpu]

It serves the smoke config unless `--no-smoke` is given (the reference's
`--smoke` is `store_true` with default True, so it cannot be turned
off), on the card unless `--device cpu` is given (the plain PyTorch
versions of the kernels; with no card and no `--device` it raises).
Each tick is priced with the card's energy profile (`core/sysinfo.py`)
at 2 FLOP and 2 bytes per active parameter and token.  The weights are
random, drawn from seed 0; the prompts are seeded too.  On the card it
prints the launches of the model path's kernels: K5 (flash attention),
K8 (RMSNorm), K9 (the grouped expert GEMM), K7 (the RG-LRU's scan) and
K12c (Mamba's selective scan).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.carina import RunTracker, ServingSession, SimClock, StepCost
from repro_torch.core.device import resolve_device
from repro_torch.core.sysinfo import chip_profile_from_host, detect_host
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import moe_gemm as k9
from repro_torch.kernels import rmsnorm as k8
from repro_torch.kernels import selective_scan as k12c
from repro_torch.kernels import ssm_scan as k7
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="reduced config (the default); "
                    "--no-smoke serves the full one")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, device)
    print(f"serving {cfg.name} ({model.param_count():,} params) on {device}, "
          f"{args.slots} slots, s_max {args.s_max}; init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    chip = chip_profile_from_host(detect_host())
    n = cfg.active_param_count()
    tracker = RunTracker(f"serve-{cfg.name}")
    session = ServingSession(
        tracker=tracker, clock=SimClock(start_hour=12.0), chip=chip,
        step_cost=StepCost(flops=2.0 * n, hbm_bytes=2.0 * n, ici_bytes=0.0))
    engine = ServingEngine(model, params, slots=args.slots, s_max=args.s_max,
                           session=session, device=device)
    prefill_ms = []
    prefill = engine._prefill

    def timed_prefill(*a):
        t = time.perf_counter()
        out = prefill(*a)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out
    engine._prefill = timed_prefill

    rng = np.random.default_rng(0)
    lens = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=rng.integers(4, 16))
        engine.submit(prompt.astype(np.int32), max_new=args.max_new)
        lens.append(len(prompt))
    print(f"{args.requests} requests of {args.max_new} new tokens, prompts "
          f"{lens} tokens", flush=True)
    kernels = (k5, k8, k9, k7, k12c)
    before = [k.launches for k in kernels]
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    engine._prefill = prefill
    tokens = sum(len(r.generated) for r in done)
    s = tracker.close()
    print(f"completed {len(done)} requests, {tokens} tokens in {wall:.3f} s: "
          f"{tokens / wall:.1f} tokens/s; prefill "
          f"{np.median(prefill_ms):.2f} ms per request (median of "
          f"{len(prefill_ms)}); {session.live_units} ticks; energy "
          f"{s.energy_kwh * 1e3:.4e} Wh; CO2e {s.co2_kg * 1e3:.4e} g "
          f"({chip.name} profile)", flush=True)
    if device.type == "cuda":
        k5n, k8n, k9n, k7n, k12n = (k.launches - b
                                    for k, b in zip(kernels, before))
        print(f"kernel launches: K5 {k5n}, K8 {k8n}, K9 {k9n}, K7 {k7n}, "
              f"K12c {k12n}", flush=True)
    return done


if __name__ == "__main__":
    main()
