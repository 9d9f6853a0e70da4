"""Training entry point (the reference's `src/repro/launch/train.py`) on
one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --blocked-xent [--remat none|dots|full] [--ckpt-dir D] [--steps N] \
        [--batch B] [--seq S] [--policy P] [--smoke] [--device cuda|cpu]

It trains on the card unless `--device cpu` is given (the plain PyTorch
versions of the kernels; with no card and no `--device` it raises),
prices each unit with the card's energy profile (`core/sysinfo.py`), and
writes the unit log and the run dashboard under
`experiments/train_run/` of the working directory.
"""
from __future__ import annotations

import argparse
import dataclasses

import repro_torch.carina as carina
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.sysinfo import chip_profile_from_host, detect_host
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.fault_tolerance import Supervisor
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.loop import LoopConfig, run_training

OUT_DIR = "experiments/train_run"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--policy", default="baseline",
                    choices=list(carina.POLICIES))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--blocked-xent", action="store_true")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(cfg, remat=args.remat,
                              blocked_xent=args.blocked_xent)
    model = build_model(cfg)
    print(f"devices=1 ({device}) arch={cfg.name} "
          f"params={model.param_count():,}")

    opt = AdamWConfig(total_steps=args.steps,
                      warmup_steps=max(1, args.steps // 10))
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq)
    # Algorithm 1 line 3: detect machine characteristics, initialize session
    host = detect_host()
    campaign = carina.Campaign(
        carina.TrainingCampaign(f"train-{cfg.name}", cfg.name,
                                total_steps=args.steps, steps_per_unit=10),
        carina.POLICIES[args.policy],
        name=f"train-{cfg.name}", out_dir=OUT_DIR)
    controller = campaign.controller(
        max_replicas=1, clock=carina.SimClock(start_hour=9.0, speedup=600.0),
        chip=chip_profile_from_host(host))
    campaign.tracker.meta["host"] = host
    res = run_training(model, opt, data,
                       LoopConfig(total_steps=args.steps, steps_per_unit=10,
                                  ckpt_dir=args.ckpt_dir, log_every=10),
                       controller=controller, supervisor=Supervisor(),
                       device=device)
    print(f"done at step {res.final_step}; restarts={res.restarts}")
    summary = campaign.finish(render=False)
    print(carina.render_run_dashboard(summary, OUT_DIR))
    return res


if __name__ == "__main__":
    main()
