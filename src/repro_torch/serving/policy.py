"""Serving policies: clocks, backoff, breakers, admission, degradation.

The port of ``repro.serving.policy``, copied (the package imports nothing
of ``repro``). Everything here is host-side decision logic for the
request front end (:mod:`repro_torch.serving.frontend`), unit-testable
with a stubbed clock and a seed. Four pieces:

* **Clocks** — all deadline/backoff/breaker arithmetic runs on a
  *monotonic* clock injected at construction (``time.monotonic`` in
  production, :class:`ManualClock` in tests), never wall time: NTP
  steps must not expire deadlines or re-close breakers.
* **:class:`BackoffPolicy`** — deterministic exponential retry
  schedule for transient guard trips (attempt k waits
  ``base·mult^(k-1)``, capped), optional seeded jitter.
* **:class:`CircuitBreaker`** — the classic three-state machine per
  plan: CLOSED → (``fail_threshold`` consecutive trips) → OPEN →
  (cooldown elapsed *and* the operand rebuilt) → HALF_OPEN →
  (``probe_successes`` clean batches) → CLOSED; any failure in
  HALF_OPEN re-opens.  Every transition lands in the observe layer.
* **:class:`AdmissionPolicy` / :class:`DegradationPolicy`** — the
  bounded-queue + x-block residency admission guard and the occupancy →
  precision-tier demotion map: overload sheds value bits (bytes/nnz)
  before it sheds requests, and best-effort classes shed before tight-SLO
  ones. The residency guard applies only when a limit is set: on the card
  no x size needs one (:class:`AdmissionPolicy`).
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional

from ..observe import metrics as _obs

__all__ = [
    "ManualClock", "BackoffPolicy", "CircuitBreaker",
    "RequestClass", "DEFAULT_CLASSES", "DEFAULT_LADDER",
    "AdmissionPolicy", "DegradationPolicy", "tier_error_budget",
]


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------


class ManualClock:
    """A monotonic clock the caller advances by hand — the determinism
    substrate of every serving test (deadline math, backoff schedules,
    breaker cooldowns become exact assertions, not sleeps)."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"monotonic clocks cannot rewind (dt={dt})")
        self.t += float(dt)
        return self.t


# ---------------------------------------------------------------------------
# retry backoff
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff for transient guard trips.

    ``delay(k)`` for attempt k >= 1 is ``base · mult^(k-1)`` capped at
    ``max_delay``; with ``jitter > 0`` a seeded uniform factor in
    ``[1-jitter, 1]`` is applied (seeded per policy instance, so a
    schedule is reproducible — the property the serving tests pin)."""

    base: float = 0.005
    mult: float = 2.0
    max_delay: float = 0.5
    max_attempts: int = 3
    jitter: float = 0.0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "_rng", random.Random(self.seed))

    def delay(self, attempt: int) -> float:
        """Seconds to wait before retry ``attempt`` (1-based)."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        d = min(self.base * self.mult ** (attempt - 1), self.max_delay)
        if self.jitter > 0:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def exhausted(self, attempt: int) -> bool:
        return attempt >= self.max_attempts


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-plan trip accounting with the OPEN → HALF_OPEN → CLOSED
    recovery path.

    The breaker is advisory: it never executes anything itself, it only
    answers :meth:`allow` (may traffic use the guarded plan right now?)
    and records outcomes.  Semantics:

    * CLOSED: traffic flows; ``fail_threshold`` *consecutive* failures
      open the breaker (a success resets the streak).
    * OPEN: traffic is rerouted (the frontend's fp32 fallback);
      :meth:`allow` turns True again only once ``cooldown_s`` has
      elapsed on the monotonic clock AND :meth:`note_rebuilt` has been
      called — probing a plan that nobody repaired is pointless.
    * HALF_OPEN: entered automatically by the first :meth:`allow` after
      the conditions above; ``probe_successes`` clean batches close the
      breaker, any failure re-opens it (and requires a fresh rebuild).
    """

    def __init__(self, *, fail_threshold: int = 2, cooldown_s: float = 0.05,
                 probe_successes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = ""):
        if fail_threshold < 1 or probe_successes < 1:
            raise ValueError("fail_threshold and probe_successes are >= 1")
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = float(cooldown_s)
        self.probe_successes = int(probe_successes)
        self.clock = clock
        self.name = name
        self.state = CLOSED
        self.consecutive_failures = 0
        self.probes_ok = 0
        self.opened_at: Optional[float] = None
        self.rebuilt = False
        self.transitions: list = []     # [(t, from, to)] — test/debug trail

    def _move(self, to: str) -> None:
        if to == self.state:
            return
        t = self.clock()
        self.transitions.append((t, self.state, to))
        _obs.inc("frontend.breaker_transition", plan=self.name,
                 src=self.state, dst=to)
        self.state = to
        if to == OPEN:
            self.opened_at = t
            self.rebuilt = False
            self.probes_ok = 0
        elif to == CLOSED:
            self.consecutive_failures = 0
            self.probes_ok = 0

    def allow(self) -> bool:
        """True when traffic may use the guarded plan now.  The OPEN →
        HALF_OPEN edge happens here (lazily, on the first eligible
        call) so no background timer thread is needed."""
        if self.state == OPEN:
            if self.rebuilt and self.opened_at is not None \
                    and self.clock() - self.opened_at >= self.cooldown_s:
                self._move(HALF_OPEN)
        return self.state != OPEN

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state == HALF_OPEN:
            self.probes_ok += 1
            if self.probes_ok >= self.probe_successes:
                self._move(CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN \
                or self.consecutive_failures >= self.fail_threshold:
            self._move(OPEN)

    def note_rebuilt(self) -> None:
        """The quarantined operand was rebuilt from the retained CSR —
        half-open probing becomes possible once the cooldown elapses."""
        self.rebuilt = True


# ---------------------------------------------------------------------------
# request classes and the degradation ladder
# ---------------------------------------------------------------------------

#: The serving precision ladder, most accurate first.  Index == tier;
#: demotion moves RIGHT (toward fewer value bits — fp32→packed halves
#: bytes/nnz, and within the packed tiers accuracy decreases while the
#: word stream stays 4 B/nnz).  Kind strings are `solvers.operators`
#: kinds, so every tier rides the same plan engine.
DEFAULT_LADDER = ("fp32", "plan_e8m4", "plan_fp16", "plan_bf16")


def tier_error_budget(kind: str, *, safety: float = 256.0) -> float:
    """Backward-error budget of one ladder tier: the §8 error model's
    per-entry quantization bound times a safety factor covering fp32
    matvec rounding.  The chaos harness holds every completed response
    to this bound against the fp64 oracle."""
    import numpy as np

    from ..precision import analyze as an
    from ..solvers.operators import parse_kind

    spec = parse_kind(kind)
    eps32 = float(np.finfo(np.float32).eps)
    if spec.family == "dense":
        return safety * eps32
    return safety * max(float(an.ulp_bound(spec.codec, spec.D)), eps32)


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One SLO class: where it sits on the ladder and when it sheds.

    ``priority`` orders shedding (HIGHER sheds first — best-effort
    classes go before tight-SLO ones).  ``tier`` is the class's normal
    ladder index; ``tier_floor`` the cheapest tier overload may demote
    it to (a tight-SLO class already living at a sub-32-bit tier keeps
    it — demotion never promotes)."""

    name: str
    priority: int
    deadline_s: float
    tier: int
    tier_floor: int

    def __post_init__(self):
        if self.tier_floor < self.tier:
            raise ValueError(
                f"class {self.name!r}: tier_floor {self.tier_floor} above "
                f"(more accurate than) tier {self.tier} — demotion only "
                "moves down the ladder")


#: interactive = tight SLO, lives sub-32-bit, sheds last; batch = best
#: effort, starts at fp32 accuracy, demotes and sheds first.
DEFAULT_CLASSES = (
    RequestClass("interactive", priority=0, deadline_s=0.25, tier=2,
                 tier_floor=3),
    RequestClass("standard", priority=1, deadline_s=1.0, tier=1,
                 tier_floor=3),
    RequestClass("batch", priority=2, deadline_s=5.0, tier=0,
                 tier_floor=3),
)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Bounded-queue + x-block residency admission.

    ``max_queue`` bounds host memory and tail latency (an unbounded queue
    converts overload into unbounded p99). ``vmem_limit_words``, when set,
    bounds the multi-RHS working set: a coalesced spmm slot gathers from
    the whole ``[m, nb]`` x block (fp32 words) and writes the ``[n, nb]``
    y block, so admission requires ``(m + n) · nb <= W``, the reference's
    test (the name keeps the reference's, so that an explicit
    ``vmem_limit_words`` behaves exactly as there). Requests that break it
    are rejected loudly (reason ``vmem``).

    ``None``, the default, sets no limit. The reference's default is
    ``REPRO_FULL_X_LIMIT`` (2,000,000 words): past it a TPU plan leaves
    its fast body for one that blows every deadline queued behind it. On
    the card no size of x changes the kernel a plan runs (the port's
    ``kernels.plan`` has no x-residency rule): K3 and K5 serve any
    ``[m, nb]`` block, ``nb`` past 8 in chunks of 8, so a limit would
    only turn away requests that they answer. ``chip_smoke.py`` (phase 6)
    times both per right-hand side on either side of the L2 line
    (``m · nb · 4`` bytes at nb = 8, 12 and 16 at HPCG 104³)."""

    max_queue: int = 256
    vmem_limit_words: Optional[int] = None    # None: no limit
    shed_watermark: float = 0.9               # occupancy that starts sheds

    def _limit(self) -> Optional[int]:
        if self.vmem_limit_words is None:
            return None
        return int(self.vmem_limit_words)

    def vmem_ok(self, n: int, m: int, nb: int) -> bool:
        """True when an ``[m, nb]`` x block + ``[n, nb]`` y block stays
        within the residency limit at slot width ``nb`` (always, when no
        limit is set)."""
        limit = self._limit()
        return limit is None or (m + n) * nb <= limit

    def queue_ok(self, depth: int) -> bool:
        return depth < self.max_queue

    def occupancy(self, depth: int) -> float:
        return depth / self.max_queue if self.max_queue else 1.0


# ---------------------------------------------------------------------------
# degradation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Occupancy → ladder demotion.

    Two watermarks with hysteresis: above ``demote1`` every class drops
    one tier (toward fewer value bits), above ``demote2`` two; a class
    never drops below its ``tier_floor``.  ``recover`` (strictly below
    ``demote1``) is where demotion switches off again — the gap stops
    tier flapping at the boundary.  Demotion is *global monotone* in
    occupancy and per-class clamped, so the tight-SLO class keeps its
    sub-32-bit tier while the fp32 batch class sheds half its bytes —
    the paper's value-bits dial used as the overload valve."""

    demote1: float = 0.5
    demote2: float = 0.8
    recover: float = 0.35

    def __post_init__(self):
        if not (self.recover < self.demote1 < self.demote2):
            raise ValueError("need recover < demote1 < demote2")

    def level(self, occupancy: float, prev_level: int = 0) -> int:
        """Demotion depth for the current queue occupancy (with
        hysteresis against ``prev_level``)."""
        if occupancy >= self.demote2:
            return 2
        if occupancy >= self.demote1:
            return max(1, min(prev_level, 2)) if prev_level else 1
        if occupancy > self.recover and prev_level:
            return prev_level          # hysteresis band: hold
        return 0

    def tier_for(self, klass: RequestClass, level: int,
                 n_tiers: int) -> int:
        return min(klass.tier + max(0, int(level)), klass.tier_floor,
                   n_tiers - 1)
