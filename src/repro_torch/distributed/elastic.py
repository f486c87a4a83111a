"""Elastic / fault-tolerant runtime policies for the training launcher.

Design-for-1000-nodes features (DESIGN.md §8):

  * **Failure detection & restart** — the launcher wraps every step; a
    device failure (simulated or real XlaRuntimeError) triggers restore
    from the newest complete checkpoint, optionally onto a smaller mesh
    (blades "retire" — the same rule MIND uses for its range partition).
  * **Elastic re-mesh** — checkpoints are mesh-independent (saved
    unsharded); `plan_remesh` picks the largest (data, model) grid that
    fits the surviving device count while keeping TP divisibility.
  * **Straggler mitigation** — an EWMA step-time monitor flags steps
    slower than ``threshold x`` the running mean; the policy hook lets the
    launcher rebalance (drop the slow host from the data axis) or just
    record (default).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    alpha: float = 0.1
    threshold: float = 2.0
    ewma: float | None = None
    flagged: list = field(default_factory=list)
    _t0: float | None = None

    def step_begin(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> bool:
        dt = time.perf_counter() - self._t0
        slow = False
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.flagged.append((step, dt, self.ewma))
            slow = True
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt
        )
        return slow


def plan_remesh(surviving_devices: int, model_parallel: int,
                min_data: int = 1) -> tuple[int, int]:
    """Largest (data, model) grid fitting the surviving devices.

    Keeps the TP degree if possible (params were sharded that way), else
    halves it until it fits — the re-layout is handled by checkpoint
    restore (arrays are saved unsharded).
    """
    mp = model_parallel
    while mp > 1 and surviving_devices < mp * min_data:
        mp //= 2
    data = max(min_data, surviving_devices // mp)
    return data, mp


class SimulatedFailure(RuntimeError):
    """Raised by the launcher's failure injector (tests + examples)."""


@dataclass
class FailureInjector:
    """Deterministically fail at given steps (integration tests)."""

    fail_at_steps: tuple = ()
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")
