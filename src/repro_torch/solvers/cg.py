"""Preconditioned CG and Jacobi-PCG in stored-row order.

The convergence criterion is the paper's eq. (6), ``||b - A x||_2 /
||b||_2 < tol``, tracked through the CG recurrence residual. The loop is
the reference's ``lax.while_loop`` written out on the host: the same
update order, the same ``done`` test after each residual update, so a
solve stops at the same iteration. Outer vectors keep ``b``'s dtype
(float64 when ``b`` is float64); the SpMV runs in float32 and its output
is cast up. Each iteration reads ``done`` on the host, one device
synchronisation per iteration.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Matvec = Callable[[torch.Tensor], torch.Tensor]


class SolveInfo(NamedTuple):
    iters: int               # iterations executed
    relres: torch.Tensor     # final relative residual (recurrence)
    history: torch.Tensor    # relres per iteration, -1 past convergence


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
