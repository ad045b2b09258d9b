"""Fault tolerance: straggler watchdog, failure injection, restartable loop
— a copy of ``repro.train.ft`` (numpy only; the port keeps its own).

On a real fleet the coordinator restarts failed workers from the latest
checkpoint; here the same control flow is exercised in-process:
``run_with_restarts`` drives a step function, catches (injected or real)
worker failures, restores from the newest checkpoint — possibly onto a
*different* mesh (elastic rescale) — and continues. The watchdog flags
straggling steps by robust z-score over a rolling window (on a fleet this is
the signal that triggers a hot-spare swap or re-slicing).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class WorkerFailure(RuntimeError):
    """Raised by failure injection (or wrapped real errors)."""


@dataclasses.dataclass
class Watchdog:
    window: int = 32
    z_thresh: float = 4.0
    durations: List[float] = dataclasses.field(default_factory=list)
    stragglers: List[Dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Record a step duration; returns True if it straggles."""
        hist = self.durations[-self.window:]
        self.durations.append(dt)
        if len(hist) < 8:
            return False
        med = float(np.median(hist))
        mad = float(np.median(np.abs(np.asarray(hist) - med))) + 1e-9
        z = (dt - med) / (1.4826 * mad)
        if z > self.z_thresh:
            self.stragglers.append({"step": step, "dt": dt, "z": z})
            return True
        return False


@dataclasses.dataclass
class FailurePlan:
    """Deterministic injected failures: {step: kind}."""
    at_steps: Dict[int, str] = dataclasses.field(default_factory=dict)

    def check(self, step: int):
        kind = self.at_steps.get(step)
        if kind:
            del self.at_steps[step]
            raise WorkerFailure(f"injected {kind} at step {step}")


def run_with_restarts(total_steps: int,
                      make_runner: Callable[[int], Callable[[int], float]],
                      save_every: int,
                      saver: Callable[[int], None],
                      restorer: Callable[[], int],
                      max_failures: int = 8,
                      watchdog: Optional[Watchdog] = None) -> Dict:
    """Drive steps with checkpoint/restart semantics.

    make_runner(start_step) -> step_fn(step)->loss  (rebuilds state from the
    latest checkpoint — the restart path re-enters here, which is where an
    elastic deployment would also rebuild the mesh).
    """
    failures = 0
    step = restorer()
    runner = make_runner(step)
    log = {"restarts": [], "losses": {}}
    while step < total_steps:
        try:
            t0 = time.perf_counter()
            loss = runner(step)
            dt = time.perf_counter() - t0
            if watchdog is not None:
                watchdog.observe(step, dt)
            log["losses"][step] = float(loss)
            step += 1
            if step % save_every == 0:
                saver(step)
        except WorkerFailure as e:
            failures += 1
            if failures > max_failures:
                raise
            log["restarts"].append({"step": step, "err": str(e)})
            step = restorer()
            runner = make_runner(step)
    return log
