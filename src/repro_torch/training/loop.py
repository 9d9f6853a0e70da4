"""Training driver: data -> train_step -> CARINA tracking -> checkpoints,
under a fault-tolerance supervisor (the reference's
`src/repro/training/loop.py`), on one device.

Structure (a *campaign* of tracked *units*):

    for each unit (N steps):
        decision = controller.decide()            # CARINA band -> intensity
        run N steps (failure injection + straggler detection hooks)
        controller.record_unit(...)               # energy/carbon accounting
        checkpoint every K units (async)

    on WorkerFailure: supervisor.on_failure; restore the latest checkpoint
    and resume from its step counter.  The data pipeline is a pure function
    of step, so a resumed run takes the same batches.
    at the end: checkpoint the final state, unless the last unit's save
    of it was written (the reference saves the same state a second time;
    at TinyLlama-1.1B that is 11 GB); raise if the final state is not
    saved.

Not ported yet (ROADMAP.md Queue 1 item 8): `mesh_fn` and
`initial_replicas > 1` (sharded and elastic training across cards).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step,
                                               restore_checkpoint)
from repro_torch.core.controller import CarinaController, IntensityDecision
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     StragglerDetector,
                                                     Supervisor,
                                                     WorkerFailure)
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.step import (abstract_train_state,
                                       init_train_state, make_train_step,
                                       trainable)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    steps_per_unit: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every_units: int = 1
    keep: int = 3
    seed: int = 0
    log_every: int = 0


@dataclasses.dataclass
class LoopResult:
    final_step: int
    state: Any
    metrics_history: list
    restarts: int
    straggler_events: int


def _init(model: Model, opt_cfg: AdamWConfig, loop_cfg: LoopConfig, device):
    """A fresh train state drawn on `device` from `loop_cfg.seed`."""
    gen = torch.Generator(device=device).manual_seed(loop_cfg.seed)
    return init_train_state(model, gen, opt_cfg, device)


def _restore(model: Model, opt_cfg: AdamWConfig, loop_cfg: LoopConfig,
             device):
    """The latest checkpoint as a train state on `device`, its parameters
    trainable and bound to `model`; and its meta."""
    state, meta = restore_checkpoint(
        loop_cfg.ckpt_dir, abstract_train_state(model, opt_cfg),
        device=device)
    state["params"] = trainable(state["params"])
    model.bind(state["params"])
    return state, meta


def run_training(model: Model, opt_cfg: AdamWConfig, data: SyntheticLM,
                 loop_cfg: LoopConfig, *,
                 controller: Optional[CarinaController] = None,
                 injector: Optional[FailureInjector] = None,
                 detector: Optional[StragglerDetector] = None,
                 supervisor: Optional[Supervisor] = None,
                 mesh_fn: Optional[Callable[[int], Any]] = None,
                 initial_replicas: int = 1, device=None) -> LoopResult:
    """Train `model` for `loop_cfg.total_steps` steps of `data` on `device`
    (the card unless told otherwise), from the latest checkpoint in
    `loop_cfg.ckpt_dir` if there is one, else from a fresh state."""
    if mesh_fn is not None or initial_replicas != 1:
        raise NotImplementedError(
            "run_training on more than one device (mesh_fn, "
            "initial_replicas > 1: sharded and elastic training) is not "
            "ported yet (ROADMAP.md Queue 1 item 8)")
    device = resolve_device(device)
    supervisor = supervisor or Supervisor()
    detector = detector or StragglerDetector()
    replicas = initial_replicas
    ckptr = AsyncCheckpointer(loop_cfg.ckpt_dir, loop_cfg.keep) \
        if loop_cfg.ckpt_dir else None

    # ---- init or restore ---------------------------------------------------
    step = 0
    state = None
    if loop_cfg.ckpt_dir and latest_step(loop_cfg.ckpt_dir) is not None:
        state, meta = _restore(model, opt_cfg, loop_cfg, device)
        step = int(meta.get("step", latest_step(loop_cfg.ckpt_dir)))
    if state is None:
        state = _init(model, opt_cfg, loop_cfg, device)

    train_step = make_train_step(model, opt_cfg)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    metrics_history = []
    unit = 0
    while step < loop_cfg.total_steps:
        decision = (controller.decide() if controller
                    else IntensityDecision("none", 1.0, replicas, 1.0))
        t_unit0 = time.monotonic()
        try:
            n = min(loop_cfg.steps_per_unit, loop_cfg.total_steps - step)
            for _ in range(n):
                if injector is not None:
                    injector.check(step)
                batch = data.batch_at(step)
                sync()
                t0 = time.monotonic()
                state, metrics = train_step(state, batch)
                sync()
                dt = time.monotonic() - t0
                ev = detector.observe(step, dt)
                if ev is not None and detector.should_exclude(ev) \
                        and controller:
                    # straggler exclusion: a smaller width asked of the
                    # controller (one device here: it stays at 1)
                    controller.max_replicas = max(
                        1, controller.max_replicas - 1)
                step += 1
                if loop_cfg.log_every and step % loop_cfg.log_every == 0:
                    metrics_history.append(
                        {k: float(v) for k, v in metrics.items()}
                        | {"step": step})
            if controller is not None:
                controller.record_unit(decision, steps=n,
                                       runtime_s=time.monotonic() - t_unit0,
                                       meta={"unit": unit})
            unit += 1
            if ckptr and unit % loop_cfg.ckpt_every_units == 0:
                ckptr.submit(step, state, {"step": step})
        except WorkerFailure as e:
            plan = supervisor.on_failure(step, replicas, e)
            if ckptr:
                ckptr.wait()
            replicas = plan.replicas
            state = None                     # free the state before reloading
            if loop_cfg.ckpt_dir and latest_step(loop_cfg.ckpt_dir) \
                    is not None:
                state, meta = _restore(model, opt_cfg, loop_cfg, device)
                step = int(meta.get("step", 0))
            else:  # no checkpoint yet: restart from scratch
                state = _init(model, opt_cfg, loop_cfg, device)
                step = 0

    if ckptr:
        ckptr.wait()
        if ckptr.last_saved != step:   # the last unit's save, if it was made
            ckptr.submit(step, state, {"step": step})
            ckptr.wait()
        if ckptr.last_saved != step:
            raise RuntimeError(f"the final state (step {step}) was not "
                               f"saved: {'; '.join(ckptr.errors)}")
    return LoopResult(step, state, metrics_history, len(supervisor.restarts),
                      len(detector.events))
