"""Preconditioned CG, Jacobi-PCG in stored-row order, the
residual-adaptive mixed-precision PCG, flexible CG and fixed-iteration
PCG (the outer and inner loops of IO-CG).

The convergence criterion is the paper's eq. (6), ``||b - A x||_2 /
||b||_2 < tol``, tracked through the CG recurrence residual. Outer
vectors keep ``b``'s dtype (float64 when ``b`` is float64); the SpMV runs
in float32 and its output is cast up.

The reference runs each loop as one compiled XLA computation; the port
runs it as CUDA graphs (:mod:`.graphs`). A stopping loop (:func:`pcg`,
:func:`fcg`, :func:`adaptive_pcg`) runs in chunks of ``chunk`` steps,
each chunk one graph replay, and the host reads the loop's flag once per
chunk. Steps taken after the loop has stopped are undone or masked, so
the result, the iteration count and the history are the eager loop's bit
for bit. :func:`pcg` and :func:`fcg` mask no vector: their chunks run
the eager steps, and where the loop stopped inside a chunk, its steps up
to the stop run again from the chunk's start (:class:`_Chunks`), so a
solve runs ``ceil(iters / chunk) · chunk + iters mod chunk`` steps.
:func:`adaptive_pcg` masks them (``torch.where`` keeps every carried
value as it was). Inside :func:`.graphs.eager` each loop runs eagerly
instead, the reference's update order written out on the host with one
read per step: the tests hold the graphs to it. The set-up before each
loop (the first residual) runs eagerly; its preconditioner application
is a graph of its own.
:func:`pcg_fixed_iters` has no data-dependent control flow: one
application is one graph.

``jit_cache``/``jit_key`` keep the graphs and their static buffers
across calls, as the reference's keep the compiled solve (the caller's
key must identify the ``matvec``/``M`` closures); without them the
graphs live for one call.

The flight recorder: :func:`pcg`, :func:`jacobi_pcg_stored` and
:func:`adaptive_pcg` call ``observe.record_solve`` once, after the loop,
with the reference's ``path`` label (``jit_cache`` when the caller passes
one, else ``eager``; ``fused`` for ``jacobi_pcg_stored``), and run their
loops inside the ``packsell.solver_while`` span. A solve with a
``jit_cache`` is the reference's one compiled dispatch: nothing inside it,
its set-up included, records (``observe.metrics.quiet``), as nothing
inside the reference's traced solve does.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import observe as _observe
from ..observe import metrics as _obs
from . import graphs

Matvec = Callable[[torch.Tensor], torch.Tensor]

#: steps per graph replay of :func:`pcg` (and so of Jacobi-PCG)
PCG_CHUNK = 8


class SolveInfo(NamedTuple):
    iters: int               # iterations executed
    relres: torch.Tensor     # final relative residual (recurrence)
    history: torch.Tensor    # relres per iteration, -1 past convergence


class AdaptiveSolveInfo(NamedTuple):
    """Outcome of :func:`adaptive_pcg` (the reference's seven fields)."""

    iters: int                 # outer (refinement) steps executed
    relres: torch.Tensor       # final TRUE relative residual ||b-Ax||/||b||
    history: torch.Tensor      # true relres per outer step, -1 past end
    tier_history: torch.Tensor  # int32 tier used per outer step, -1 past end
    promotions: int            # number of codec-tier promotions
    tier_matvecs: torch.Tensor  # int32[n_tiers] inner matvecs per tier
    hi_matvecs: int            # high-precision (residual) matvecs


def _nonzero(v: torch.Tensor) -> torch.Tensor:
    """v, or 1 where v == 0 (the reference's guarded divisions)."""
    return torch.where(v == 0, torch.ones_like(v), v)


def _hist_dtype(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _prep(b, x0, dtype):
    dtype = dtype or b.dtype
    b = b.to(dtype)
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    return b, x, _nonzero(torch.linalg.vector_norm(b)), dtype


def _masked(go: torch.Tensor, bufs, vals) -> None:
    """``buf = val`` where ``go``, else ``buf`` unchanged, in place."""
    for buf, val in zip(bufs, vals):
        torch.where(go, val, buf, out=buf)


class _Chunks:
    """A stopping loop in chunks of ``chunk`` steps of
    ``step(bnorm, *state) -> (*state, relres)``, the carried values in
    static buffers. A step is taken while ``go``; after it ``go`` stays
    true while ``relres < tol`` does not hold and fewer than ``maxiter``
    steps were taken: the eager loop's test.

    ``graph`` saves the state (and ``k``) in ``start`` and runs a chunk of
    the eager steps. Only the step count ``k``, ``go`` and the history are
    masked, so they stop where the eager loop stops; the vectors run on.
    Where the loop stopped ``j`` steps into a chunk, ``rerun[j]`` restores
    ``start`` and runs those ``j`` steps again, so no vector is ever
    masked."""

    def __init__(self, step, state, bnorm, tol: float, maxiter: int,
                 chunk: int):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.step, self.tol, self.maxiter, self.chunk = (step, tol, maxiter,
                                                         chunk)
        self.dev = state[0].device
        self.state = tuple(torch.empty_like(v) for v in state)
        self.start = tuple(torch.empty_like(v) for v in state)
        self.bnorm = torch.empty_like(bnorm)
        # the last slot takes the writes of steps past the stop
        self.hist = torch.empty(maxiter + 2, dtype=_hist_dtype(
            state[0].dtype), device=self.dev)
        self.k = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.k0 = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.go = torch.zeros((), dtype=torch.bool, device=self.dev)
        self.pool, self.steps = graphs.Pool(), graphs.method(self._steps)
        self.graph = graphs.Graph(functools.partial(self.steps, chunk, False),
                                  self.dev, self.pool)
        self.rerun: dict = {}

    def _steps(self, n: int, again: bool):
        """``n`` steps: a chunk from the state (saved first in ``start``),
        or ``again`` from ``start``."""
        dst, src = (self.state, self.start) if again else \
            (self.start, self.state)
        for buf, v in zip(dst, src):
            buf.copy_(v)
        if again:
            self.k.copy_(self.k0)
            self.go.fill_(True)
        else:
            self.k0.copy_(self.k)
        state = self.state
        for _ in range(n):
            *state, relres = self.step(self.bnorm, *state)
            pos = torch.where(self.go, self.k + 1, self.maxiter + 1)
            self.hist.index_copy_(0, pos.reshape(1),
                                  relres.to(self.hist.dtype).reshape(1))
            self.k.add_(self.go)
            self.go.logical_and_(torch.logical_not(relres < self.tol)
                                 & (self.k < self.maxiter))
        for buf, v in zip(self.state, state):
            buf.copy_(v)
        return torch.stack([self.k, self.go.long()])

    def run(self, state, bnorm, rel0):
        """The loop from ``state``: ``(state, iters, history)``, the state
        and the history cloned out of the buffers."""
        for buf, v in zip(self.state, state):
            buf.copy_(v)
        self.bnorm.copy_(bnorm)
        self.hist.fill_(-1.0)
        self.hist[0] = rel0
        self.k.zero_()
        self.go.fill_(self.maxiter > 0)
        k = 0
        if self.maxiter > 0:
            go, k0 = True, 0
            while go:
                k0 = k
                k, go = self.graph().tolist()   # the one host read per chunk
            j = k - k0
            if j < self.chunk:                  # it stopped inside the chunk
                if j not in self.rerun:
                    self.rerun[j] = graphs.Graph(functools.partial(
                        self.steps, j, True), self.dev, self.pool)
                self.rerun[j]()
        return (tuple(v.clone() for v in self.state), k,
                self.hist[:self.maxiter + 1].clone())


def _loop(step, state, bnorm, rel0, *, tol, maxiter, chunk, cache, key):
    """``(state, iters, history)`` of the stopping loop: eager inside
    :func:`.graphs.eager`, else masked chunks (kept in ``cache`` under
    ``key``)."""
    if graphs.is_eager():
        hist = torch.full((maxiter + 1,), -1.0, device=rel0.device,
                          dtype=_hist_dtype(state[0].dtype))
        hist[0] = rel0
        k, done = 0, False
        while k < maxiter and not done:
            *state, relres = step(bnorm, *state)
            hist[k + 1] = relres
            done = bool(relres < tol)
            k += 1
        return state, k, hist
    loop = cache.get(key) if cache is not None else None
    if loop is None:
        loop = _Chunks(step, state, bnorm, tol, maxiter, chunk)
        if cache is not None:
            cache[key] = loop
    return loop.run(state, bnorm, rel0)


def _key(name, jit_key, tol, maxiter, b, dtype, chunk, *extra):
    return (name, jit_key, float(tol), int(maxiter), tuple(b.shape),
            dtype or b.dtype, *extra, chunk)


def _compiled(jit_cache):
    """The recorder's rule for a solve: quiet inside one with a
    ``jit_cache`` (the reference's compiled dispatch)."""
    return _obs.quiet() if jit_cache is not None \
        else contextlib.nullcontext()


def pcg(matvec: Matvec, b: torch.Tensor, *, M: Matvec | None = None,
        tol: float = 1e-9, maxiter: int = 1000, x0=None, dtype=None,
        chunk: int = PCG_CHUNK, jit_cache: dict | None = None,
        jit_key=None) -> tuple[torch.Tensor, SolveInfo]:
    """Preconditioned CG. ``M`` must be a fixed SPD operator; ``chunk``
    steps per graph replay."""
    with _compiled(jit_cache):
        x, info = _pcg(matvec, b, M=M, tol=tol, maxiter=maxiter, x0=x0,
                       dtype=dtype, chunk=chunk, jit_cache=jit_cache,
                       jit_key=jit_key)
    _observe.record_solve("pcg", info, path="eager" if jit_cache is None
                          else "jit_cache")
    return x, info


def _pcg(matvec, b, *, M, tol, maxiter, x0, dtype, chunk, jit_cache,
         jit_key) -> tuple[torch.Tensor, SolveInfo]:
    dot, norm = torch.dot, torch.linalg.vector_norm
    key = _key("pcg", jit_key, tol, maxiter, b, dtype, chunk)
    b, x, bnorm, dtype = _prep(b, x0, dtype)
    M = M or (lambda r: r)

    def step(bnorm, x, r, p, rz):
        Ap = matvec(p).to(dtype)
        pAp = dot(p, Ap)
        alpha = rz / _nonzero(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        relres = norm(r) / bnorm
        z = M(r).to(dtype)
        rz_new = dot(r, z)
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        return x, r, p, rz_new, relres

    r = b - matvec(x).to(dtype)
    z = M(r).to(dtype)
    with _obs.span("packsell.solver_while"):
        (x, r, _, _), k, hist = _loop(
            step, (x, r, z, dot(r, z)), bnorm, norm(r) / bnorm, tol=tol,
            maxiter=maxiter, chunk=chunk, cache=jit_cache, key=key)
    return x, SolveInfo(k, norm(r) / bnorm, hist)


def fcg(matvec: Matvec, b: torch.Tensor, *, M: Matvec, tol: float = 1e-9,
        maxiter: int = 1000, x0=None, dtype=None, chunk: int = 1,
        jit_cache: dict | None = None,
        jit_key=None) -> tuple[torch.Tensor, SolveInfo]:
    """Flexible CG (Notay 2000), FCG(1): tolerates a varying
    preconditioner, such as an inner Krylov solve (the IO-CG outer
    iteration, paper §5.2.2). One step, the inner solve included, is one
    graph replay and one host read (``chunk`` steps per replay)."""
    dot, norm = torch.dot, torch.linalg.vector_norm
    key = _key("fcg", jit_key, tol, maxiter, b, dtype, chunk)
    b, x, bnorm, dtype = _prep(b, x0, dtype)

    def step(bnorm, x, r, p):
        Ap = matvec(p).to(dtype)
        pAp = _nonzero(dot(p, Ap))
        alpha = dot(p, r) / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        relres = norm(r) / bnorm
        z = M(r).to(dtype)
        # one-step A-orthogonalization against the previous direction
        p = z - (dot(z, Ap) / pAp) * p
        return x, r, p, relres

    r = b - matvec(x).to(dtype)
    p = M(r).to(dtype)
    (x, r, _), k, hist = _loop(
        step, (x, r, p), bnorm, norm(r) / bnorm, tol=tol, maxiter=maxiter,
        chunk=chunk, cache=jit_cache, key=key)
    return x, SolveInfo(k, norm(r) / bnorm, hist)


def pcg_fixed_iters(matvec: Matvec, M: Matvec, m_in: int,
                    dtype=torch.float32) -> graphs.Applied:
    """``m_in`` PCG iterations from x0 = 0, packaged as a preconditioner:
    the inner solver of IO-CG (paper §5.2.2). One application is one
    graph (the eager body is ``.fn``)."""
    dot = torch.dot

    def apply(rhs: torch.Tensor) -> torch.Tensor:
        r = rhs.to(dtype)
        x = torch.zeros_like(r)
        z = M(r).to(dtype)
        p = z
        rz = dot(r, z)
        for _ in range(m_in):
            Ap = matvec(p).to(dtype)
            alpha = rz / _nonzero(dot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r).to(dtype)
            rz_new = dot(r, z)
            p = z + (rz_new / _nonzero(rz)) * p
            rz = rz_new
        return x

    return graphs.Applied(apply)


def jacobi_pcg_stored(mat, plan, diag, b: torch.Tensor, *,
                      tol: float = 1e-9, maxiter: int = 1000,
                      dtype=None, chunk: int = PCG_CHUNK
                      ) -> tuple[torch.Tensor, SolveInfo]:
    """Jacobi-PCG run entirely in σ-stored-row order.

    The operator is the symmetrically permuted ``P A Pᵀ`` (SPD iff A is):
    each matvec gathers x back to original order and takes the plan's
    ``permuted=True`` output, so no σ-scatter runs per iteration. The
    Jacobi preconditioner and the right-hand side are permuted once at
    setup. σ-padding slots stay zero throughout, so stored-space dot
    products and norms equal the original-space ones and the stopping
    test is unchanged. As in the reference, the solve's graphs are cached
    on the plan (``plan._fns``), so a second solve only replays.

    ``mat``/``plan``: a PackSELL matrix and its SpMVPlan (see
    ``OperatorSet.plan_pair``); ``diag``: the matrix diagonal in original
    row order (numpy or tensor); ``b`` on the plan's device.
    """
    from ..kernels import plan as _kp

    dev = plan.device_operands()
    diag = torch.as_tensor(diag, device=b.device)
    dinv = torch.where(diag == 0, torch.ones_like(diag), 1.0 / diag)
    dinv_s = _kp.stored_permute(dinv.to(b.dtype), dev["outrow"], plan.n)
    b_s = _kp.stored_permute(b, dev["outrow"], plan.n)
    key = ("jpcg_stored", _kp._plan_token(mat), dinv_s.dtype)
    ent = plan._fns.get(key)
    if ent is None:
        # weakly: the plan cache holds the matrix weakly, and the plan
        # holds this closure (no cycle, see graphs)
        mref, pref = weakref.ref(mat), weakref.ref(plan)

        def matvec_s(x_s):
            return pref().execute_with(
                mref(), dev, _kp.stored_unpermute(x_s, dev["inv"]),
                permuted=True)

        ent = plan._fns[key] = (torch.empty_like(dinv_s), matvec_s, {})
    dinv_buf, matvec_s, cache = ent
    dinv_buf.copy_(dinv_s)
    with _obs.quiet():
        x_s, info = _pcg(matvec_s, b_s, M=lambda r: r * dinv_buf, tol=tol,
                         maxiter=maxiter, x0=None, dtype=dtype, chunk=chunk,
                         jit_cache=cache, jit_key=key)
    _observe.record_solve("jacobi_pcg_stored", info, path="fused")
    return _kp.stored_unpermute(x_s, dev["inv"]), info


class _Refinement:
    """:func:`adaptive_pcg` as masked chunks: one graph per tier, each of
    ``chunk`` outer steps (``m_in`` inner iterations on the tier, the
    update and the true residual). A step is taken while the loop runs
    and no promotion happened in the chunk; the host reads
    ``(k, live, promoted)`` once per chunk and picks the next tier."""

    def __init__(self, inner, hi, b, x, rel_t, *, tol, maxiter, m_in,
                 stag_factor, chunk):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        dev, dtype = b.device, b.dtype
        self.inner, self.hi, self.tol, self.maxiter = inner, hi, tol, maxiter
        self.chunk = chunk
        hdt = _hist_dtype(dtype)
        self.b, self.x, self.r = (torch.empty_like(b), torch.empty_like(x),
                                  torch.empty_like(b))
        self.bnorm, self.rel_t = (torch.empty_like(rel_t),
                                  torch.empty_like(rel_t))
        self.relres = torch.empty((), dtype=hdt, device=dev)
        self.stag = torch.tensor(stag_factor, dtype=hdt, device=dev)
        self.hist = torch.empty(maxiter + 2, dtype=hdt, device=dev)
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.live = torch.zeros((), dtype=torch.bool, device=dev)
        self.prom = torch.zeros((), dtype=torch.bool, device=dev)
        pool = graphs.Pool()
        steps = graphs.method(self._steps)
        self.graphs = [graphs.Graph(functools.partial(steps, t), dev, pool)
                       for t in range(len(inner))]

    def _steps(self, tier: int):
        dtype = self.b.dtype
        can_promote = tier < len(self.inner) - 1
        self.prom.zero_()
        for _ in range(self.chunk):
            go = self.live & torch.logical_not(self.prom)
            x = self.x + self.inner[tier](self.r)
            r = self.b - self.hi(x).to(dtype)
            rel_t = torch.linalg.vector_norm(r) / self.bnorm
            rel_new = rel_t.to(self.relres.dtype)
            pos = torch.where(go, self.k + 1, self.maxiter + 1)
            self.hist.index_copy_(0, pos.reshape(1), rel_new.reshape(1))
            # stagnation: the tier's quantization floor caps the contraction
            promote = go & (rel_new > self.stag * self.relres) \
                & (rel_new >= self.tol) & can_promote
            _masked(go, (self.x, self.r, self.rel_t, self.relres),
                    (x, r, rel_t, rel_new))
            self.k.add_(go)
            torch.where(go, (self.k < self.maxiter) & (rel_new >= self.tol),
                        self.live, out=self.live)
            self.prom.logical_or_(promote)
        return torch.stack([self.k, self.live.long(), self.prom.long()])

    def run(self, b, x, r, bnorm, rel_t, tier: int, n_tiers: int, m_in: int):
        for buf, v in ((self.b, b), (self.x, x), (self.r, r),
                       (self.bnorm, bnorm), (self.rel_t, rel_t),
                       (self.relres, rel_t)):
            buf.copy_(v)
        self.hist.fill_(-1.0)
        self.hist[0] = rel_t
        self.k.zero_()
        self.live.copy_((self.relres >= self.tol) & (self.maxiter > 0))
        thist = torch.full((self.maxiter + 1,), -1, dtype=torch.int32)
        mvc = torch.zeros((n_tiers,), dtype=torch.int32)
        k, live, nprom = 0, bool(self.live), 0
        while live:                         # one host read per chunk
            k_new, live, prom = self.graphs[tier]().tolist()
            thist[k:k_new] = tier
            mvc[tier] += m_in * (k_new - k)
            k = k_new
            if prom:
                tier += 1
                nprom += 1
        return (self.x.clone(), AdaptiveSolveInfo(
            k, self.rel_t.clone(), self.hist[:self.maxiter + 1].clone(),
            thist, nprom, mvc, 1 + k))


def adaptive_pcg(tiers, b: torch.Tensor, *, M: Matvec | None = None,
                 matvec_hi: Matvec | None = None, tol: float = 1e-9,
                 maxiter: int = 60, m_in: int = 16, x0=None, dtype=None,
                 stag_factor: float = 0.25, start_tier: int = 0,
                 chunk: int = 1, jit_cache: dict | None = None, jit_key=None
                 ) -> tuple[torch.Tensor, AdaptiveSolveInfo]:
    """Residual-adaptive mixed-precision PCG (iterative refinement).

    ``tiers`` is a codec ladder of matvecs, lowest precision first
    (``precision.select.build_tier_matvecs`` over a ``tier_ladder``). Each
    outer step runs ``m_in`` inner PCG iterations on ``A_tier d = r`` from
    ``d = 0`` with the current tier and ``M``, updates ``x`` and
    recomputes the TRUE residual with ``matvec_hi`` (default: the last
    tier). A step that contracts the true residual by less than
    ``stag_factor`` promotes the operator to the next tier. The tier is
    chosen on the host: ``chunk`` outer steps on one tier are one graph
    replay and one host read (a promotion masks the rest of the chunk);
    inside :func:`.graphs.eager` it is the reference's loop written out on
    the host, which reads the residual once per outer step.
    """
    if not tiers:
        raise ValueError("need at least one tier")
    with _compiled(jit_cache):
        x, info = _adaptive_pcg(
            tiers, b, M=M, matvec_hi=matvec_hi, tol=tol, maxiter=maxiter,
            m_in=m_in, x0=x0, dtype=dtype, stag_factor=stag_factor,
            start_tier=start_tier, chunk=chunk, jit_cache=jit_cache,
            jit_key=jit_key)
    _observe.record_solve("adaptive_pcg", info,
                          path="eager" if jit_cache is None else "jit_cache")
    return x, info


def _adaptive_pcg(tiers, b, *, M, matvec_hi, tol, maxiter, m_in, x0, dtype,
                  stag_factor, start_tier, chunk, jit_cache, jit_key):
    norm = torch.linalg.vector_norm
    n_tiers = len(tiers)
    key = _key("adaptive", jit_key, tol, maxiter, b, dtype, chunk, int(m_in),
               float(stag_factor), int(start_tier))
    b, x, bnorm, dtype = _prep(b, x0, dtype)
    M = M or (lambda r: r)
    hi = matvec_hi or tiers[-1]
    tier = min(start_tier, n_tiers - 1)
    loop = jit_cache.get(key) if jit_cache is not None else None
    if loop is None:
        # m_in PCG iterations on A_tier d = r from d = 0: one graph each
        inner_solve = [pcg_fixed_iters(t, M, m_in, dtype) for t in tiers]
    else:
        inner_solve = loop.inner

    r = b - hi(x).to(dtype)
    rel_t = norm(r) / bnorm
    if not graphs.is_eager():
        if loop is None:
            loop = _Refinement(inner_solve, hi, b, x, rel_t, tol=tol,
                               maxiter=maxiter, m_in=m_in,
                               stag_factor=stag_factor, chunk=chunk)
            if jit_cache is not None:
                jit_cache[key] = loop
        with _obs.span("packsell.solver_while"):
            return loop.run(b, x, r, bnorm, rel_t, tier, n_tiers, m_in)

    # the host's stop and promotion tests compare in the history's type,
    # as the reference's traced comparisons do
    hdt = _hist_dtype(dtype)
    as_h = (np.float64 if hdt == torch.float64 else np.float32)
    hist = torch.full((maxiter + 1,), -1.0, dtype=hdt, device=b.device)
    hist[0] = rel_t
    thist = torch.full((maxiter + 1,), -1, dtype=torch.int32)
    mvc = torch.zeros((n_tiers,), dtype=torch.int32)
    relres = as_h(float(rel_t))
    tol_h, stag_h = as_h(tol), as_h(stag_factor)
    k, nprom, hic = 0, 0, 1
    with _obs.span("packsell.solver_while"):
        while k < maxiter and relres >= tol_h:
            x = x + inner_solve[tier](r)
            r = b - hi(x).to(dtype)
            rel_t = norm(r) / bnorm
            mvc[tier] += m_in
            hic += 1
            hist[k + 1] = rel_t
            thist[k] = tier
            rel_new = as_h(float(rel_t))
            # stagnation: the tier's quantization floor caps the contraction
            if rel_new > stag_h * relres and rel_new >= tol_h \
                    and tier < n_tiers - 1:
                tier += 1
                nprom += 1
            relres = rel_new
            k += 1
    return x, AdaptiveSolveInfo(k, rel_t, hist, thist, nprom, mvc, hic)
