"""Preconditioned CG, Jacobi-PCG in stored-row order, the
residual-adaptive mixed-precision PCG, flexible CG and fixed-iteration
PCG (the outer and inner loops of IO-CG).

The convergence criterion is the paper's eq. (6), ``||b - A x||_2 /
||b||_2 < tol``, tracked through the CG recurrence residual. The loop is
the reference's ``lax.while_loop`` written out on the host: the same
update order, the same ``done`` test after each residual update, so a
solve stops at the same iteration. Outer vectors keep ``b``'s dtype
(float64 when ``b`` is float64); the SpMV runs in float32 and its output
is cast up. Each iteration reads ``done`` on the host, one device
synchronisation per iteration, and so does :func:`fcg`.
:func:`adaptive_pcg` syncs once per outer step: its ``m_in`` inner
iterations have a fixed count. :func:`pcg_fixed_iters` has no
data-dependent control flow and reads nothing on the host, so it adds no
synchronisation of its own.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

Matvec = Callable[[torch.Tensor], torch.Tensor]


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


def pcg(matvec: Matvec, b: torch.Tensor, *, M: Matvec | None = None,
        tol: float = 1e-9, maxiter: int = 1000, x0=None,
        dtype=None) -> tuple[torch.Tensor, SolveInfo]:
    """Preconditioned CG. ``M`` must be a fixed SPD operator."""
    dot, norm = torch.dot, torch.linalg.vector_norm
    dtype = dtype or b.dtype
    b = b.to(dtype)
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    bnorm = _nonzero(norm(b))
    M = M or (lambda r: r)

    r = b - matvec(x).to(dtype)
    z = M(r).to(dtype)
    rz = dot(r, z)
    p = z
    hist = torch.full((maxiter + 1,), -1.0, device=b.device,
                      dtype=torch.float64 if dtype == torch.float64
                      else torch.float32)
    hist[0] = norm(r) / bnorm
    k, done = 0, False
    while k < maxiter and not done:
        Ap = matvec(p).to(dtype)
        pAp = dot(p, Ap)
        alpha = rz / _nonzero(pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        relres = norm(r) / bnorm
        hist[k + 1] = relres
        done = bool(relres < tol)
        z = M(r).to(dtype)
        rz_new = dot(r, z)
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, SolveInfo(k, norm(r) / bnorm, hist)


def fcg(matvec: Matvec, b: torch.Tensor, *, M: Matvec, tol: float = 1e-9,
        maxiter: int = 1000, x0=None,
        dtype=None) -> tuple[torch.Tensor, SolveInfo]:
    """Flexible CG (Notay 2000), FCG(1): tolerates a varying
    preconditioner, such as an inner Krylov solve (the IO-CG outer
    iteration, paper §5.2.2). The reference's loop on the host, one sync
    per step for the stopping test."""
    dot, norm = torch.dot, torch.linalg.vector_norm
    dtype = dtype or b.dtype
    b = b.to(dtype)
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    bnorm = _nonzero(norm(b))

    r = b - matvec(x).to(dtype)
    p = M(r).to(dtype)
    hist = torch.full((maxiter + 1,), -1.0, device=b.device,
                      dtype=torch.float64 if dtype == torch.float64
                      else torch.float32)
    hist[0] = norm(r) / bnorm
    k, done = 0, False
    while k < maxiter and not done:
        Ap = matvec(p).to(dtype)
        pAp = _nonzero(dot(p, Ap))
        alpha = dot(p, r) / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        relres = norm(r) / bnorm
        hist[k + 1] = relres
        done = bool(relres < tol)
        z = M(r).to(dtype)
        # one-step A-orthogonalization against the previous direction
        p = z - (dot(z, Ap) / pAp) * p
        k += 1
    return x, SolveInfo(k, norm(r) / bnorm, hist)


def pcg_fixed_iters(matvec: Matvec, M: Matvec, m_in: int,
                    dtype=torch.float32) -> Matvec:
    """``m_in`` PCG iterations from x0 = 0, packaged as a preconditioner:
    the inner solver of IO-CG (paper §5.2.2). It reads nothing on the
    host, so it adds no device synchronisation to its matvecs'."""
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

    return apply


def jacobi_pcg_stored(mat, plan, diag, b: torch.Tensor, *,
                      tol: float = 1e-9, maxiter: int = 1000,
                      dtype=None) -> tuple[torch.Tensor, SolveInfo]:
    """Jacobi-PCG run entirely in σ-stored-row order.

    The operator is the symmetrically permuted ``P A Pᵀ`` (SPD iff A is):
    each matvec gathers x back to original order and takes the plan's
    ``permuted=True`` output, so no σ-scatter runs per iteration. The
    Jacobi preconditioner and the right-hand side are permuted once at
    setup. σ-padding slots stay zero throughout, so stored-space dot
    products and norms equal the original-space ones and the stopping
    test is unchanged.

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

    def matvec_s(x_s):
        return plan.execute_with(mat, dev,
                                 _kp.stored_unpermute(x_s, dev["inv"]),
                                 permuted=True)

    x_s, info = pcg(matvec_s, b_s, M=lambda r: r * dinv_s, tol=tol,
                    maxiter=maxiter, dtype=dtype)
    return _kp.stored_unpermute(x_s, dev["inv"]), info


def adaptive_pcg(tiers, b: torch.Tensor, *, M: Matvec | None = None,
                 matvec_hi: Matvec | None = None, tol: float = 1e-9,
                 maxiter: int = 60, m_in: int = 16, x0=None, dtype=None,
                 stag_factor: float = 0.25, start_tier: int = 0
                 ) -> tuple[torch.Tensor, AdaptiveSolveInfo]:
    """Residual-adaptive mixed-precision PCG (iterative refinement).

    ``tiers`` is a codec ladder of matvecs, lowest precision first
    (``precision.select.build_tier_matvecs`` over a ``tier_ladder``). Each
    outer step runs ``m_in`` inner PCG iterations on ``A_tier d = r`` from
    ``d = 0`` with the current tier and ``M``, updates ``x`` and
    recomputes the TRUE residual with ``matvec_hi`` (default: the last
    tier). A step that contracts the true residual by less than
    ``stag_factor`` promotes the operator to the next tier. The reference's
    ``lax.while_loop`` written as a host loop, in the same update order:
    the stop and promotion tests read the residual on the host once per
    outer step, and the tier is chosen there.
    """
    if not tiers:
        raise ValueError("need at least one tier")
    norm = torch.linalg.vector_norm
    n_tiers = len(tiers)
    dtype = dtype or b.dtype
    b = b.to(dtype)
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    bnorm = _nonzero(norm(b))
    M = M or (lambda r: r)
    hi = matvec_hi or tiers[-1]
    # the host's stop and promotion tests compare in the history's type,
    # as the reference's traced comparisons do
    hdt = torch.float64 if dtype == torch.float64 else torch.float32
    as_h = (np.float64 if hdt == torch.float64 else np.float32)

    # m_in PCG iterations on A_tier d = r from d = 0: no host sync
    inner_solve = [pcg_fixed_iters(t, M, m_in, dtype) for t in tiers]

    r = b - hi(x).to(dtype)
    rel_t = norm(r) / bnorm
    hist = torch.full((maxiter + 1,), -1.0, dtype=hdt, device=b.device)
    hist[0] = rel_t
    thist = torch.full((maxiter + 1,), -1, dtype=torch.int32)
    mvc = torch.zeros((n_tiers,), dtype=torch.int32)
    relres = as_h(float(rel_t))
    tol_h, stag_h = as_h(tol), as_h(stag_factor)
    k, tier, nprom, hic = 0, min(start_tier, n_tiers - 1), 0, 1
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
