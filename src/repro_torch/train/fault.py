"""Fault-tolerance runtime pieces: preemption capture, straggler detection.

The port of ``repro.train.fault``, a copy: plain Python. These are
host-side policies (they wrap the step, they don't live
inside it), so they work unchanged from 1 CPU to a multi-pod fleet:

* ``PreemptionGuard`` — converts SIGTERM/SIGINT (the cloud preemption
  notice) into a flag the training loop polls; the loop then commits a
  final checkpoint and exits cleanly instead of dying mid-step.
* ``StepMonitor`` — EWMA step-time tracker. A step slower than
  ``threshold ×`` the EWMA is flagged as a straggler event; after
  ``trip_limit`` consecutive events the monitor recommends exclusion
  (on a real fleet the launcher maps this to removing the slow host and
  re-meshing via the elastic checkpoint restore; on one host it logs).
"""
from __future__ import annotations

import dataclasses
import signal
import time


class PreemptionGuard:
    """Install with ``with PreemptionGuard() as guard: ... guard.fired``."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = signals
        self.fired = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.fired = True

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ewma: float
    ratio: float


class StepMonitor:
    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 trip_limit: int = 3, warmup: int = 2):
        self.alpha = alpha
        self.threshold = threshold
        self.trip_limit = trip_limit
        self.warmup = warmup
        self.ewma: float | None = None
        self.events: list[StragglerEvent] = []
        self._consecutive = 0
        self._seen = 0
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> StragglerEvent | None:
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen <= self.warmup:        # compile steps don't count
            return None
        if self.ewma is None:
            self.ewma = dt
            return None
        ratio = dt / self.ewma
        ev = None
        if ratio > self.threshold:
            ev = StragglerEvent(step, dt, self.ewma, ratio)
            self.events.append(ev)
            self._consecutive += 1
        else:
            self._consecutive = 0
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return ev

    @property
    def exclusion_recommended(self) -> bool:
        return self._consecutive >= self.trip_limit
