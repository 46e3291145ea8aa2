"""Resilient SpMV/solve serving front end.

The port of ``repro.serving.frontend``: the service that answers *spmv*
and *solve* requests, the workload the paper's format exists for, with
defined behavior under both faults and saturation:

* **Admission** — a bounded queue with loud rejection (``queue_full``)
  plus, when ``AdmissionPolicy.vmem_limit_words`` is set, the x-block
  residency guard: a request whose coalesced ``[m, nb]`` x block breaks
  the limit is rejected at the door (``vmem``). The port sets no limit by
  default: on the card no size of x sends a plan to a slower body (see
  ``policy.AdmissionPolicy``).
* **Coalescing** — same-fingerprint spmv requests batch into multi-RHS
  ``spmm`` slots (zero-padded partial slots), so k concurrent requests
  stream the operand words ONCE: one K3 launch per slot on a fused plan
  (``plan_fp16``/``plan_bf16`` on the card), one K5 launch on a ``full``
  or ``band`` plan (``plan_e8m4``); the ``fp32`` tier runs K2 once per
  column.
* **Deadlines and retries** — per-request deadlines on a monotonic
  clock; transient guard trips retry with deterministic exponential
  backoff (:class:`~repro_torch.serving.policy.BackoffPolicy`), exhausted
  retries complete on the fp32 fallback instead of failing.
* **Breakers and self-healing** — every plan entry carries a
  :class:`~repro_torch.serving.policy.CircuitBreaker`; repeated trips
  quarantine the plan (traffic reroutes to the fp32 fallback built
  from the retained CSR), a background rebuild restores the packed
  operand, and half-open probes re-admit it.
* **Degradation** — under overload, request classes demote down the
  precision ladder (tight-SLO classes keep their sub-32-bit tiers,
  best-effort classes shed first), trading value bits for sustained QPS
  before any request is dropped.

Every decision is exported through the observe layer (queue depth,
shed rate, deadline misses, breaker transitions, per-tier goodput) and
the whole frontend is clock-injectable: tests drive it with
:class:`~repro_torch.serving.policy.ManualClock` and ``background=False``
for exact, sleep-free assertions.

On the card. The API is the reference's: ``x`` comes in and ``y`` goes
out as numpy, so a slot copies its ``[m, slots]`` block to the device and
its ``[n, slots]`` answer back. Operators live on ``FrontendConfig.device``
(``None``: the GPU). The background worker (warmups, rebuilds) runs each
task holding ``solvers.graphs.CAPTURE_LOCK``, the lock every graph capture
holds: PyTorch captures in ``"global"`` mode, where an allocation or a
sync from another thread invalidates a capture, and ``guarded_solve``
captures its correction's graphs on the dispatching thread. A
:meth:`PlanEntry.rebuild` raises the old plan's ``generation``, so a
graph captured over it captures again at its next call
(``repro_torch._generations``).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import queue as _queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels import plan as kplan
from ..observe import metrics as _obs
from ..robust import guard as gd
from ..solvers import graphs

from . import policy as pol

log = logging.getLogger(__name__)

__all__ = ["FrontendConfig", "Request", "PlanEntry", "ServingFrontend",
           "AdmissionError"]


def _host_rows(y: torch.Tensor) -> np.ndarray:
    """A slot's ``[n, slots]`` y as host rows ``[slots, n]``: the
    transpose runs on the device, so the copy and each response are
    contiguous."""
    return y.t().contiguous().cpu().numpy()


class AdmissionError(ValueError):
    """A request could not even be queued (unknown fingerprint, shape
    mismatch) — distinct from a *rejection*, which is a served answer."""


# ---------------------------------------------------------------------------
# configuration and the request record
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Everything the front end decides with, in one place."""

    slots: int = 4                         # RHS columns per spmm slot
    plan_pool: int = 8                     # resident PlanEntry cap (LRU)
    ladder: tuple = pol.DEFAULT_LADDER     # tiers, most accurate first
    classes: tuple = pol.DEFAULT_CLASSES
    admission: pol.AdmissionPolicy = dataclasses.field(
        default_factory=pol.AdmissionPolicy)
    degrade: pol.DegradationPolicy = dataclasses.field(
        default_factory=pol.DegradationPolicy)
    backoff: pol.BackoffPolicy = dataclasses.field(
        default_factory=pol.BackoffPolicy)
    fail_threshold: int = 2                # breaker: consecutive trips
    cooldown_s: float = 0.0                # breaker: OPEN dwell minimum
    probe_successes: int = 1               # breaker: half-open probes
    guard_every: int = 1                   # full-guard stride per plan
    background: bool = True                # async warmup/rebuild worker
    C: int = 32
    sigma: int = 64
    store: object = None                   # PrecisionStore or path
    solve_tol: float = 1e-8
    solve_maxiter: int = 60
    device: object = None                  # operators' device; None: GPU

    def klass(self, name: str) -> pol.RequestClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise AdmissionError(
            f"unknown request class {name!r}; configured: "
            f"{[c.name for c in self.classes]}")


@dataclasses.dataclass
class Request:
    """One spmv/solve request through its lifecycle.

    ``status`` walks queued → ok | rejected | shed | deadline_miss |
    failed; ``tier_kind`` records the operator that actually answered
    (a ladder kind, or ``'fp32_fallback'`` when a breaker rerouted
    it)."""

    uid: int
    fingerprint: str
    x: np.ndarray
    klass: pol.RequestClass
    op: str = "spmv"                     # 'spmv' | 'solve'
    deadline: float = 0.0                # absolute, monotonic
    t_submit: float = 0.0
    not_before: float = 0.0              # backoff gate
    attempts: int = 0                    # guard-trip retries so far
    status: str = "queued"
    reason: str = ""
    tier: Optional[int] = None
    tier_kind: str = ""
    y: Optional[np.ndarray] = None
    t_done: float = 0.0
    missed_deadline: bool = False
    solve_info: Optional[object] = None

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    @property
    def ok(self) -> bool:
        return self.status == "ok"


# ---------------------------------------------------------------------------
# plan entries and the bounded pool
# ---------------------------------------------------------------------------


class PlanEntry:
    """One registered matrix: retained CSR, lazily-built per-tier
    (mat, plan, guard) triples, the fp32 fallback, and the breaker.

    The CSR is the *source of truth* — every rebuild re-encodes from
    it, so no packed corruption is ever laundered into a repair."""

    def __init__(self, fingerprint: str, csr, cfg: FrontendConfig,
                 clock: Callable[[], float]):
        from ..solvers.operators import OperatorSet

        self.fingerprint = fingerprint
        self.csr = csr.tocsr()
        self.cfg = cfg
        self.n, self.m = self.csr.shape
        self.ops = OperatorSet(self.csr, C=cfg.C, sigma=cfg.sigma,
                               device=cfg.device)
        self.device = self.ops.device
        self.breaker = pol.CircuitBreaker(
            fail_threshold=cfg.fail_threshold, cooldown_s=cfg.cooldown_s,
            probe_successes=cfg.probe_successes, clock=clock,
            name=fingerprint[:8])
        self.guards: dict = {}          # kind -> GuardState
        self.tokens: dict = {}          # kind -> plan token at bind time
        self.plans: dict = {}           # kind -> plan at bind time
        self.lock = threading.RLock()   # bind/rebuild vs dispatch thread
        self.warmed: set = set()

    # -- binding -----------------------------------------------------------
    def bind(self, kind: str):
        """(mat, plan, guard) for a packed ladder kind, built/cached via
        the entry's OperatorSet.  Applies any precision-store retile
        winner on first bind (poisoned store entries are survivable:
        the build-time tiles are always valid)."""
        with self.lock:
            mat, plan = self.ops.plan_pair(kind)
            if kind not in self.guards:
                self._apply_retile(kind, plan)
                self.guards[kind] = gd.build_guard(
                    mat, plan, every=self.cfg.guard_every)
                self.tokens[kind] = getattr(mat, "_plan_token", None)
                self.plans[kind] = plan
            return mat, plan, self.guards[kind]

    def _apply_retile(self, kind: str, plan) -> None:
        if self.cfg.store is None:
            return
        from ..precision import PrecisionStore
        from ..solvers.operators import parse_kind

        try:
            store = PrecisionStore.coerce(self.cfg.store)
            spec = parse_kind(kind)
            key = f"plan_{spec.codec}{spec.D}"   # engine-warmup convention
            store.apply_retile(self.fingerprint, key, plan)
        except Exception as e:
            # engine-warmup contract: a garbled store must never take
            # the serving path down — keep build-time tiles, loudly
            log.warning("frontend: retile from store failed for %s/%s: %s",
                        self.fingerprint[:8], kind, e)
            _obs.inc("frontend.store_retile_failure", kind=kind)

    def stale(self, kind: str) -> bool:
        """Plan-token staleness: the bound operand no longer matches
        the token recorded at bind time (a refreshed/replaced matrix
        object) — the cached dispatch would ship stale operands."""
        ent = self.ops._cache.get(kind)
        if ent is None or kind not in self.tokens:
            return False
        return getattr(ent[1], "_plan_token", None) != self.tokens[kind]

    def healthy(self, kind: str) -> bool:
        """Guard-layer health of a bound tier (unbound tiers are
        vacuously healthy — nothing has tripped yet)."""
        ent = self.ops._cache.get(kind)
        if ent is None:
            return True
        return gd.is_healthy(kplan.get_plan(ent[1], force=self.ops.force))

    # -- repair ------------------------------------------------------------
    def rebuild(self, kind: str) -> None:
        """Rebuild one tier's packed operand + guard from the retained
        CSR, then tell the breaker probing may start. The old plan's
        ``generation`` goes up, so a graph captured over it captures
        again instead of replaying."""
        with self.lock:
            self.ops._cache.pop(kind, None)
            self.guards.pop(kind, None)
            self.tokens.pop(kind, None)
            old = self.plans.pop(kind, None)
            if old is not None:
                old.generation += 1
            self.bind(kind)
            self.breaker.note_rebuilt()
            _obs.inc("frontend.rebuild", kind=kind)

    # -- fp32 fallback -----------------------------------------------------
    def spmm_fp32(self, x2d: torch.Tensor) -> torch.Tensor:
        """Batched fp32 reference matvec on the uncompressed SELL
        operand — shares NO arrays with any packed tier, so it stays
        correct while a packed operand is quarantined. One SELL matvec
        (K2 per bucket) per column: each column's arithmetic is the
        single matvec's, as the reference's ``vmap`` keeps it."""
        fn = self.ops.matvec("fp32")       # builds + caches SELL fp32
        return torch.stack([fn(x2d[:, j].contiguous())
                            for j in range(x2d.shape[1])], dim=1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- warmup ------------------------------------------------------------
    def warmup(self, kinds, nb: int) -> None:
        """Pre-build and pre-trace the slot-shaped guarded spmm for the
        given ladder kinds (plus the fp32 fallback), so first traffic
        pays neither packing nor compilation."""
        x2d = torch.zeros((self.m, nb), dtype=torch.float32,
                          device=self.device)
        for kind in kinds:
            if (kind, nb) in self.warmed:
                continue
            if kind == "fp32":
                self.spmm_fp32(x2d)
            else:
                mat, plan, gs = self.bind(kind)
                gd.guarded_spmm(mat, plan, gs, x2d, full=True)
            self._sync()
            self.warmed.add((kind, nb))
        self.spmm_fp32(x2d)
        self._sync()
        _obs.inc("frontend.warmup", fingerprint=self.fingerprint[:8])


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------


class ServingFrontend:
    """Queue → coalesce → guarded dispatch → respond, under policy.

    Construction is cheap; matrices are :meth:`register`\\ ed (warmed in
    the background by default), requests :meth:`submit`\\ ted, and
    :meth:`step` runs one scheduler tick (admit/expire/shed → form one
    slot → execute → complete).  ``run_until_drained`` loops ticks and
    knows how to advance a :class:`~repro_torch.serving.policy.ManualClock`
    across backoff gaps so tests never sleep."""

    def __init__(self, cfg: FrontendConfig | None = None, *,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or FrontendConfig()
        self.clock = clock
        self.queue: list[Request] = []
        self.done: list[Request] = []
        self.registry: dict = {}                      # fingerprint -> csr
        self.pool: "collections.OrderedDict[str, PlanEntry]" = \
            collections.OrderedDict()
        self._uid = 0
        self._demote_level = 0
        self._exporter = None
        self._bg: Optional[_queue.Queue] = None
        self._bg_thread: Optional[threading.Thread] = None
        if self.cfg.background:
            self._bg = _queue.Queue()
            self._bg_thread = threading.Thread(
                target=self._bg_loop, name="repro-frontend-worker",
                daemon=True)
            self._bg_thread.start()

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "ServingFrontend":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        """Stop the background worker and the exporter (final flush) —
        idempotent, exception-safe teardown."""
        try:
            if self._bg is not None:
                self._bg.put(None)
                if self._bg_thread is not None:
                    self._bg_thread.join(timeout=5.0)
                self._bg = None
                self._bg_thread = None
        finally:
            self.stop_metrics_exporter()

    def _bg_loop(self) -> None:
        while True:
            fn = self._bg.get()
            if fn is None:
                return
            try:
                with graphs.CAPTURE_LOCK:   # no capture runs beside a task
                    fn()
            except Exception:           # a failed warmup/rebuild must not
                log.exception("frontend: background task failed")
                _obs.inc("frontend.background_failure")

    def _defer(self, fn: Callable[[], None]) -> None:
        if self._bg is not None:
            self._bg.put(fn)
        else:
            fn()

    def drain_background(self, timeout: float = 30.0) -> None:
        """Block until queued background work (warmups, rebuilds) has
        run."""
        if self._bg is None:
            return
        ev = threading.Event()
        self._bg.put(ev.set)
        if not ev.wait(timeout):
            raise TimeoutError("frontend background worker did not drain")

    # -- exporter (engine parity) -----------------------------------------
    def start_metrics_exporter(self,
                               path: str = "artifacts/obs/frontend.jsonl",
                               interval_s: float = 1.0):
        from ..observe import export as _export

        if self._exporter is None:
            meta = _export.run_meta(source="serving.frontend",
                                    slots=self.cfg.slots,
                                    pool=self.cfg.plan_pool)
            self._exporter = _export.start_exporter(
                interval_s=interval_s, path=path, meta=meta)
        return self._exporter

    def stop_metrics_exporter(self) -> None:
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None

    # -- registration ------------------------------------------------------
    def register(self, a, *, fingerprint: str | None = None,
                 warm: bool = True) -> str:
        """Retain a matrix for serving; returns its fingerprint (the
        coalescing key).  ``warm=True`` schedules background build +
        trace of the default tier kinds at the slot shape."""
        from ..precision.store import matrix_fingerprint

        csr = a.tocsr()
        fp = fingerprint or matrix_fingerprint(csr)
        self.registry[fp] = csr
        if warm:
            entry = self._entry(fp)
            kinds = sorted({self.cfg.ladder[c.tier]
                            for c in self.cfg.classes})
            self._defer(lambda: entry.warmup(kinds, self.cfg.slots))
        return fp

    def _entry(self, fp: str) -> PlanEntry:
        """Pool lookup with LRU update; a miss re-builds the entry from
        the retained CSR (re-warm happens lazily on first dispatch)."""
        ent = self.pool.get(fp)
        if ent is not None:
            self.pool.move_to_end(fp)
            return ent
        if fp not in self.registry:
            raise AdmissionError(
                f"unknown fingerprint {fp!r}; register() the matrix first")
        if len(self.pool) >= self.cfg.plan_pool:
            old_fp, old = self.pool.popitem(last=False)
            log.info("frontend: plan pool full — evicted %s (LRU)",
                     old_fp[:8])
            _obs.inc("frontend.pool_evict")
            del old
        ent = PlanEntry(fp, self.registry[fp], self.cfg, self.clock)
        self.pool[fp] = ent
        _obs.inc("frontend.pool_build")
        return ent

    # -- admission ---------------------------------------------------------
    def submit(self, fingerprint: str, x, *, klass: str = "standard",
               deadline_s: float | None = None,
               op: str = "spmv") -> Request:
        """Admit one request (or reject it loudly).  Returns the
        :class:`Request`; a rejection comes back with ``status`` in
        ``('rejected',)`` and a ``reason`` — the caller is told NOW,
        not after a deadline's worth of queueing."""
        if op not in ("spmv", "solve"):
            raise AdmissionError(f"op must be spmv|solve, got {op!r}")
        if fingerprint not in self.registry:
            raise AdmissionError(
                f"unknown fingerprint {fingerprint!r}; register() first")
        kc = self.cfg.klass(klass)
        csr = self.registry[fingerprint]
        n, m = csr.shape
        x = np.asarray(x, np.float32 if op == "spmv" else np.float64)
        want = m if op == "spmv" else n
        if x.shape != (want,):
            raise AdmissionError(
                f"x shape {x.shape} != ({want},) for {op} on {n}x{m}")
        now = self.clock()
        req = Request(self._uid, fingerprint, x, kc, op=op, t_submit=now,
                      deadline=now + (deadline_s if deadline_s is not None
                                      else kc.deadline_s))
        self._uid += 1
        adm = self.cfg.admission
        if not adm.queue_ok(len(self.queue)):
            return self._reject(req, "queue_full")
        if op == "spmv" and not adm.vmem_ok(n, m, self.cfg.slots):
            return self._reject(req, "vmem")
        self.queue.append(req)
        _obs.gauge("frontend.queue_depth", len(self.queue))
        return req

    def _reject(self, req: Request, reason: str) -> Request:
        req.status, req.reason = "rejected", reason
        req.t_done = self.clock()
        self.done.append(req)
        log.warning("frontend: REJECTED request %d (%s, klass=%s)",
                    req.uid, reason, req.klass.name)
        _obs.inc("frontend.shed", reason=reason, klass=req.klass.name)
        return req

    # -- scheduling --------------------------------------------------------
    def _finish(self, req: Request, status: str, *, reason: str = "",
                y=None, tier_kind: str = "") -> None:
        now = self.clock()
        req.status, req.reason, req.t_done = status, reason, now
        req.y, req.tier_kind = y, tier_kind or req.tier_kind
        req.missed_deadline = now > req.deadline
        self.done.append(req)
        if status == "ok":
            _obs.inc("frontend.requests_ok", tier=req.tier_kind,
                     klass=req.klass.name)
            _obs.observe("frontend.latency_s", req.latency,
                         klass=req.klass.name)
            if req.missed_deadline:
                _obs.inc("frontend.deadline_miss", klass=req.klass.name,
                         stage="completed_late")
        elif status == "deadline_miss":
            _obs.inc("frontend.deadline_miss", klass=req.klass.name,
                     stage="queued")
        elif status == "shed":
            _obs.inc("frontend.shed", reason=reason, klass=req.klass.name)
        else:
            _obs.inc("frontend.failed", reason=reason,
                     klass=req.klass.name)

    def _expire_and_shed(self, now: float) -> None:
        keep = []
        for r in self.queue:
            if now > r.deadline:
                self._finish(r, "deadline_miss", reason="expired_in_queue")
            else:
                keep.append(r)
        self.queue = keep
        adm = self.cfg.admission
        target = int(adm.shed_watermark * adm.max_queue)
        if len(self.queue) > target:
            # shed-order: lowest-priority class first (highest priority
            # number), newest first within a class — tight-SLO requests
            # and the oldest work survive longest
            order = sorted(range(len(self.queue)),
                           key=lambda i: (-self.queue[i].klass.priority,
                                          -self.queue[i].t_submit))
            drop = set(order[: len(self.queue) - target])
            kept = []
            for i, r in enumerate(self.queue):
                if i in drop:
                    self._finish(r, "shed", reason="overload")
                else:
                    kept.append(r)
            self.queue = kept

    def _pick_batch(self, now: float):
        """The next slot to run: group ready spmv requests by
        (fingerprint, demoted tier), take the group containing the
        most urgent request, oldest-first, up to the slot width."""
        level = self._demote_level
        groups: dict = {}
        for r in self.queue:
            if r.op != "spmv" or r.not_before > now:
                continue
            tier = self.cfg.degrade.tier_for(r.klass, level,
                                             len(self.cfg.ladder))
            groups.setdefault((r.fingerprint, tier), []).append(r)
        if not groups:
            return None, None
        key = min(groups, key=lambda k: min(
            (r.klass.priority, r.t_submit, r.uid) for r in groups[k]))
        batch = sorted(groups[key],
                       key=lambda r: (r.t_submit, r.uid))[: self.cfg.slots]
        return key, batch

    def step(self) -> int:
        """One scheduler tick; returns the number of requests completed
        (any terminal status)."""
        now = self.clock()
        done0 = len(self.done)
        self._expire_and_shed(now)
        occ = self.cfg.admission.occupancy(len(self.queue))
        prev = self._demote_level
        self._demote_level = self.cfg.degrade.level(occ, prev)
        if self._demote_level != prev:
            _obs.inc("frontend.demote_level_change",
                     level=self._demote_level)
            log.info("frontend: occupancy %.2f -> demotion level %d",
                     occ, self._demote_level)
        key, batch = self._pick_batch(now)
        if key is not None:
            self._run_batch(key[0], key[1], batch)
        else:
            solve = next((r for r in self.queue
                          if r.op == "solve" and r.not_before <= now),
                         None)
            if solve is not None:
                self._run_solve(solve)
        _obs.gauge("frontend.queue_depth", len(self.queue))
        return len(self.done) - done0

    # -- execution ---------------------------------------------------------
    def _run_batch(self, fp: str, tier: int, batch: list) -> None:
        entry = self._entry(fp)
        kind = self.cfg.ladder[tier]
        for r in batch:
            r.tier, r.tier_kind = tier, kind
        # staged as rows (contiguous host copies); the [m, slots] block is
        # its transpose on the device, and y comes back as rows the same way
        xt = np.zeros((self.cfg.slots, entry.m), np.float32)
        for j, r in enumerate(batch):
            xt[j] = r.x
        x2d = torch.from_numpy(xt).to(entry.device).t()
        use_guarded = kind != "fp32" and entry.breaker.allow()
        if use_guarded and entry.stale(kind):
            log.warning("frontend: plan token stale for %s/%s — "
                        "rebuilding before dispatch", fp[:8], kind)
            _obs.inc("frontend.stale_plan", kind=kind)
            entry.rebuild(kind)
        if not use_guarded:
            y = _host_rows(entry.spmm_fp32(x2d))
            label = "fp32" if kind == "fp32" else "fp32_fallback"
            _obs.inc("frontend.matvec", tier=label, n=len(batch))
            self._complete_batch(batch, y, label)
            return
        mat, plan, gs = entry.bind(kind)
        y, ok, rel = gd.guarded_spmm(mat, plan, gs, x2d)
        if bool(ok):
            entry.breaker.record_success()
            _obs.inc("frontend.matvec", tier=kind, n=len(batch))
            self._complete_batch(batch, _host_rows(y), kind)
            return
        # -- guard trip ----------------------------------------------------
        gd.mark_unhealthy(plan, "guard_trip")
        entry.breaker.record_failure()
        _obs.inc("frontend.guard_trip", kind=kind)
        log.warning("frontend: guard TRIP on %s/%s (rel=%.3g, breaker=%s)",
                    fp[:8], kind, float(rel),
                    entry.breaker.state)
        self._defer(lambda: entry.rebuild(kind))
        now = self.clock()
        fallback = []
        for r in batch:
            r.attempts += 1
            if self.cfg.backoff.exhausted(r.attempts):
                fallback.append(r)
            else:
                r.not_before = now + self.cfg.backoff.delay(r.attempts)
                _obs.inc("frontend.retry", klass=r.klass.name)
        if fallback:
            # retries exhausted: answer NOW on the uncorruptible path
            y = _host_rows(entry.spmm_fp32(x2d))
            _obs.inc("frontend.matvec", tier="fp32_fallback",
                     n=len(fallback))
            self._complete_batch(fallback, y, "fp32_fallback",
                                 cols={r.uid: j for j, r in
                                       enumerate(batch)})

    def _complete_batch(self, batch: list, yt: np.ndarray, label: str,
                        cols: dict | None = None) -> None:
        """Finish ``batch`` with the rows of ``yt`` (``[slots, n]``: row j
        is column j of the slot's y)."""
        inflight = set(id(r) for r in batch)
        self.queue = [r for r in self.queue if id(r) not in inflight]
        for j, r in enumerate(batch):
            col = cols[r.uid] if cols is not None else j
            self._finish(r, "ok", y=yt[col], tier_kind=label)

    def _run_solve(self, req: Request) -> None:
        from ..robust import recover as rc
        from ..solvers.operators import parse_kind

        entry = self._entry(req.fingerprint)
        tier = self.cfg.degrade.tier_for(req.klass, self._demote_level,
                                         len(self.cfg.ladder))
        # guarded_solve wants a packed plan kind to start its own
        # escalation ladder from; an fp32-tier request starts one rung in
        kinds = [k for k in self.cfg.ladder[max(tier, 1):]
                 if parse_kind(k).family == "plan"]
        kind = kinds[0] if kinds else "plan_fp16"
        req.tier, req.tier_kind = tier, f"solve:{kind}"
        self.queue.remove(req)
        try:
            x, info = rc.guarded_solve(
                entry.ops, kind, req.x, tol=self.cfg.solve_tol,
                maxiter=self.cfg.solve_maxiter)
        except Exception as e:
            log.exception("frontend: solve %d failed", req.uid)
            self._finish(req, "failed", reason=repr(e))
            return
        req.solve_info = info
        if info.trips:
            entry.breaker.record_failure()
            _obs.inc("frontend.guard_trip", kind=f"solve:{kind}")
        self._finish(req, "ok", y=x, tier_kind=f"solve:{info.final_kind}")

    # -- driving -----------------------------------------------------------
    def run_until_drained(self, max_ticks: int = 100_000) -> list:
        """Tick until the queue empties (or the tick budget runs out).
        Idle ticks (everything backoff-gated) advance a ManualClock, or
        briefly sleep a real one, to the next eligible time."""
        ticks = 0
        while self.queue and ticks < max_ticks:
            before = len(self.done)
            self.step()
            ticks += 1
            if len(self.done) == before and self.queue:
                now = self.clock()
                wait = max(min(r.not_before for r in self.queue) - now, 0.0)
                if wait > 0:
                    if hasattr(self.clock, "advance"):
                        self.clock.advance(wait)
                    else:
                        time.sleep(min(wait, 0.05))
        return self.done

    # -- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        by_status: dict = {}
        by_tier: dict = {}
        lat = []
        for r in self.done:
            by_status[r.status] = by_status.get(r.status, 0) + 1
            if r.status == "ok":
                by_tier[r.tier_kind] = by_tier.get(r.tier_kind, 0) + 1
                lat.append(r.latency)
        out = {
            "submitted": self._uid,
            "completed": len(self.done),
            "queued": len(self.queue),
            "by_status": by_status,
            "by_tier": by_tier,
            "deadline_misses": sum(1 for r in self.done
                                   if r.missed_deadline
                                   or r.status == "deadline_miss"),
            "demote_level": self._demote_level,
        }
        if lat:
            s = np.sort(np.asarray(lat))
            out["p50_latency_s"] = float(s[int(0.5 * (len(s) - 1))])
            out["p99_latency_s"] = float(s[int(0.99 * (len(s) - 1))])
        return out
