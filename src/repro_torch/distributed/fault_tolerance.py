"""Fault tolerance: failure injection, straggler detection, elastic resize
decisions, and the checkpoint-restart supervisor policy.  The port's own
copy of the reference's `src/repro/distributed/fault_tolerance.py`
(plain Python, no framework), kept here so the port imports nothing of
the JAX package.

At fleet scale the failure source is real (a lost card, a preempted VM,
a link flap).  Here failures are *injected* (FailureInjector) so the
supervisor's restore path is exercised by tests exactly as it would run
in production: training/loop.py catches WorkerFailure, restores the
latest atomic checkpoint and resumes from the step counter — the data
pipeline being a pure function of step makes the resume bit-exact.  The
elastic plan (a smaller dp width) is computed as in the reference; the
port's loop runs one device, so it restarts at the same width.

Straggler mitigation: per-step wall times feed a window; a step slower
than `threshold x median` marks a straggler event; `policy="exclude"`
asks for a resize that drops the slow replica (on real fleets:
reschedule the host), `policy="log"` only records (the CARINA dashboard
shows the events).
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Deque, List, Optional


class WorkerFailure(RuntimeError):
    """A (simulated or real) replica failure during a step."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule: fail at the given global steps."""
    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float


class StragglerDetector:
    def __init__(self, window: int = 32, threshold: float = 2.0,
                 policy: str = "log"):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.threshold = threshold
        self.policy = policy
        self.events: List[StragglerEvent] = []

    def observe(self, step: int, step_time: float) -> Optional[StragglerEvent]:
        ev = None
        if len(self.window) >= 8:
            med = statistics.median(self.window)
            if step_time > self.threshold * med:
                ev = StragglerEvent(step, step_time, med)
                self.events.append(ev)
        self.window.append(step_time)
        return ev

    def should_exclude(self, ev: Optional[StragglerEvent]) -> bool:
        return ev is not None and self.policy == "exclude"


@dataclasses.dataclass
class ElasticPlan:
    """Resize decision: new dp width (replicas) after a failure/straggler."""
    replicas: int
    reason: str


class Supervisor:
    """Checkpoint-restart supervision state machine (driven by training/loop).

    Tracks restarts, computes the post-failure elastic plan, and enforces a
    restart budget (gives up after `max_restarts` so a crash-looping fleet
    pages a human instead of burning CO2 — CARINA would notice)."""

    def __init__(self, max_restarts: int = 8, elastic: bool = True,
                 min_replicas: int = 1):
        self.max_restarts = max_restarts
        self.elastic = elastic
        self.min_replicas = min_replicas
        self.restarts: List[dict] = []

    def on_failure(self, step: int, replicas: int, exc: Exception) -> ElasticPlan:
        if len(self.restarts) >= self.max_restarts:
            raise RuntimeError(
                f"restart budget exhausted ({self.max_restarts})") from exc
        if self.elastic and replicas > self.min_replicas:
            new_replicas = max(self.min_replicas, replicas // 2)
            reason = f"failure at step {step}: shrink {replicas}->{new_replicas}"
        else:
            new_replicas = replicas
            reason = f"failure at step {step}: restart at same width"
        self.restarts.append({"step": step, "replicas": new_replicas,
                              "reason": reason, "error": repr(exc),
                              "time": time.time()})
        return ElasticPlan(new_replicas, reason)
