"""Self-healing solves: guarded PCG with a bounded escalation policy.

The port of ``repro.robust.recover``. :func:`guarded_solve` is a
host-driven iterative-refinement outer loop whose inner correction solves
run on a packed operator. After every outer step it checks three things:
the ABFT checksum guard on the plan's operands
(:func:`~repro_torch.robust.guard.guarded_spmv`), finiteness of the fp64
*true* residual (against the retained CSR on the host, never through the
operator under suspicion), and divergence. On detection it escalates:

1. **retry**   — revert x to the last accepted iterate and run the step
   again (heals transient faults);
2. **promote** — step up the precision ladder
   (``precision.select.tier_ladder``): the next tier's operand is built
   fresh from the retained CSR, which heals persistent operand corruption
   and buys accuracy;
3. **rebuild** — rebuild the current kind's operand from the retained CSR
   (the ladder is exhausted but the codec was fine);
4. **fp32**    — fall back to the uncompressed fp32 operator (terminal).

Each escalation appends a record to the recovery log, and every tripped
plan is marked unhealthy. The flight recorder gets the reference's
``guard.detection_latency_calls`` histogram and ``guard.trip`` counter
per escalation, and ``guard.solves`` and a ``guard.solve`` trace per
solve.

The correction solve is ``cg.pcg`` (fp64, ``tol=0``, ``m_in`` steps), so
it runs through CUDA graphs. The graphs of one binding (a kind and its
plan) live in that binding's cache, and a promote or rebuild makes a new
binding: no graph captured over an old plan replays after it.
"""
from __future__ import annotations

import types
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..observe import metrics as _obs
from ..solvers import cg
from ..solvers import operators as op
from . import guard as gd


class GuardedSolveInfo(NamedTuple):
    """Outcome of :func:`guarded_solve` (host values)."""

    iters: int              # accepted outer steps
    relres: float           # final TRUE relative residual ||b - Ax|| / ||b||
    history: np.ndarray     # true relres per accepted step
    log: list               # recovery log: [{step, event, action, detail}]
    final_kind: str         # operator kind that finished the solve
    trips: int              # total detections


def promotion_ladder(kind: str) -> list:
    """Operator kinds from ``kind`` up the precision ladder (``tier_ladder``
    over the kind's codec), ending at ``'fp32'``."""
    from ..precision import select as psel

    spec = op.parse_kind(kind)
    if spec.family != "plan":
        raise ValueError(
            f"guarded_solve needs a plan_<codec> kind, got {kind!r}")
    shim = types.SimpleNamespace(
        primary=psel.PrecisionClass(spec.codec, spec.D))
    return [kind if c.codec == spec.codec and c.D == spec.D
            else psel.operator_kind(c)
            for c in psel.tier_ladder(shim)]


class _Binding:
    """One ladder kind bound for the solve: its matvec, matrix, plan and
    guard (``fp32``: no plan and no guard), and the correction solve's
    graphs over them (``cache``), which die with the binding."""

    def __init__(self, ops, kind: str, dinv: torch.Tensor):
        self.kind = kind
        if kind == "fp32":
            self.matvec, self.mat, self.plan, self.guard = (
                ops.matvec("fp32"), None, None, None)
        else:
            self.mat, self.plan = ops.plan_pair(kind)
            mat, plan = self.mat, self.plan
            self.matvec = lambda v: plan.spmv(mat, v)   # noqa: E731
            self.guard = gd.build_guard(self.mat, self.plan)
        self.dinv = dinv
        self.cache: dict = {}

    def correction(self, r: np.ndarray, m_in: int) -> np.ndarray:
        """``m_in`` fixed PCG iterations on A d = r from d0 = 0 (Jacobi),
        in fp64."""
        dinv = self.dinv
        rt = torch.from_numpy(np.asarray(r, np.float64)).to(dinv.device)
        d, _ = cg.pcg(self.matvec, rt, M=lambda rr: rr * dinv, tol=0.0,
                      maxiter=m_in, dtype=torch.float64,
                      jit_cache=self.cache, jit_key=("guarded", self.kind))
        return d.cpu().numpy().astype(np.float64)


def guarded_solve(ops: op.OperatorSet, kind: str, b, *,
                  tol: float = 1e-9, maxiter: int = 60, m_in: int = 16,
                  on_step: Optional[Callable[[int, dict], None]] = None
                  ) -> tuple[np.ndarray, GuardedSolveInfo]:
    """Solve ``A x = b`` to the TRUE relative residual ``tol`` on a guarded
    packed operator, surviving operand corruption and poisoned inputs by
    the escalation policy above. x is float64 numpy.

    ``ops`` retains the source CSR: the rebuilds and the host-side
    true-residual checks read it. ``kind`` is a ``plan_<codec>`` kind (a
    leading ``'guarded:'`` is accepted and stripped). ``on_step(step,
    ctx)`` runs before each outer step with ``ctx = {mat, plan, guard, x,
    kind}`` (``x`` the live numpy iterate): the fault-injection hook."""
    if kind.startswith("guarded:"):
        kind = kind[len("guarded:"):]
    ladder = promotion_ladder(kind)

    a64 = ops.csr.tocsr().astype(np.float64)
    b = np.asarray(b, np.float64)
    bnorm = float(np.linalg.norm(b))
    bnorm = bnorm if bnorm > 0 else 1.0
    diag = np.asarray(ops.diag(), np.float64)
    dinv = torch.from_numpy(np.where(diag == 0, 1.0, 1.0 / diag)).to(
        ops.device)

    tier = 0
    cur = ladder[tier]
    bound = _Binding(ops, cur, dinv)

    x = np.zeros(a64.shape[0], np.float64)
    r = b - a64 @ x
    relres = float(np.linalg.norm(r)) / bnorm
    hist = [relres]
    log: list = []
    trips = 0
    attempts = 0          # consecutive detections (escalation state)
    rebuilt = False
    steps = 0

    for outer in range(maxiter):
        if relres < tol:
            break
        # snapshot the accepted iterate: a fault that poisons the live x
        # (ctx['x'] is the real array) must not destroy the revert target
        x_snap = x.copy()
        if on_step is not None:
            on_step(outer, dict(mat=bound.mat, plan=bound.plan,
                                guard=bound.guard, x=x, kind=cur))

        d = bound.correction(r, m_in)
        x_new = x + d
        r_new = b - a64 @ x_new
        rel_new = float(np.linalg.norm(r_new)) / bnorm

        # -- detection --------------------------------------------------
        event = None
        if bound.guard is not None:
            _, ok, rel_err = gd.guarded_spmv(
                bound.mat, bound.plan, bound.guard,
                torch.from_numpy(d).to(dinv.device))
            if not bool(ok):
                event = ("guard_trip", dict(rel_err=float(rel_err)))
        if event is None and not np.all(np.isfinite(r_new)):
            event = ("nonfinite_residual", {})
        if event is None and np.isfinite(rel_new) \
                and rel_new > 10.0 * max(relres, tol):
            event = ("divergence", dict(relres=rel_new))

        if event is None:
            x, r, relres = x_new, r_new, rel_new
            hist.append(relres)
            steps += 1
            attempts = 0
            continue

        # -- escalation -------------------------------------------------
        trips += 1
        attempts += 1
        _obs.observe("guard.detection_latency_calls",
                     bound.guard.last_check_latency
                     if bound.guard is not None else 1, event=event[0])
        x = x_snap                          # revert to the last good iterate
        r = b - a64 @ x
        relres = float(np.linalg.norm(r)) / bnorm
        if bound.plan is not None:
            gd.mark_unhealthy(bound.plan, event[0])
        if attempts == 1:
            action, detail = "retry", dict(kind=cur)
        elif tier + 1 < len(ladder) - 1:
            tier += 1
            cur = ladder[tier]
            bound = _Binding(ops, cur, dinv)
            action, detail = "promote", dict(kind=cur)
        elif not rebuilt and cur != "fp32":
            rebuilt = True
            ops._cache.pop(cur, None)       # force a fresh from_csr build
            bound = _Binding(ops, cur, dinv)
            action, detail = "rebuild", dict(kind=cur)
        else:
            tier = len(ladder) - 1
            cur = ladder[tier]              # 'fp32'
            bound = _Binding(ops, cur, dinv)
            action, detail = "fp32_fallback", dict(kind=cur)
        log.append(dict(step=outer, event=event[0], action=action,
                        detail={**event[1], **detail}))
        _obs.inc("guard.trip", event=event[0], action=action)

    _obs.inc("guard.solves", kind=cur)
    _obs.record_trace(
        "guard.solve",
        dict(iters=steps, relres=relres, trips=trips, final_kind=cur,
             log=[dict(step=e["step"], event=e["event"], action=e["action"])
                  for e in log]),
        kind=kind)
    return x, GuardedSolveInfo(steps, relres, np.asarray(hist), log, cur,
                               trips)
