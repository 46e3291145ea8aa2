"""Restarted (flexible) GMRES with modified Gram-Schmidt Arnoldi.

FGMRES stores the preconditioned basis Z, so the preconditioner may itself
be an inner Krylov solve: the building block of the paper's F3R hierarchy.
The reference's Arnoldi ``fori_loop`` and restart ``while_loop`` written
as host loops, in the same update order. Its masked MGS runs over the
rows ``0..j`` of the basis, which is the mask as a slice: the rows past
``j`` are still zero.

The small least-squares problem ``min ||beta e1 - H y||`` of each cycle
is solved on the host in float64 (:func:`_lstsq`), by the reference's
rule: the SVD, with singular values below ``eps · max(m + 1, m) · s_max``
(``eps`` of the solve's dtype) dropped. ``torch.linalg.lstsq`` on CUDA
solves by QR for full rank only, and it synchronises as well. So each
cycle copies ``H`` and ``beta`` to the host once; :func:`fgmres` reads its
stopping test from that copy, one synchronisation per cycle.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .cg import SolveInfo, _nonzero

Matvec = Callable[[torch.Tensor], torch.Tensor]

_EPS = 1e-30


def _lstsq(H: torch.Tensor, beta: torch.Tensor) -> tuple[torch.Tensor, float]:
    """(y, ||beta e1 - H y||) for the (m+1)×m Hessenberg ``H``: the
    minimum-norm least-squares solution by the SVD with the reference's
    cut-off (``jnp.linalg.lstsq`` with ``rcond=None``), in float64 on the
    host. ``y`` comes back in H's dtype on H's device; the residual is a
    host float."""
    hb = torch.cat([H.reshape(-1), beta.reshape(1)]).to(
        "cpu", torch.float64).numpy()
    Hh = hb[:-1].reshape(H.shape)
    e1 = np.zeros(H.shape[0])
    e1[0] = hb[-1]
    u, s, vh = np.linalg.svd(Hh, full_matrices=False)
    rcond = torch.finfo(H.dtype).eps * max(H.shape)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = np.where(keep, 1.0 / np.where(keep, s, 1.0), 0.0)
    y = vh.T @ (s_inv * (u.T @ e1))
    res = float(np.linalg.norm(e1 - Hh @ y))
    return torch.from_numpy(y).to(H.device, H.dtype), res


def _fgmres_cycle(matvec: Matvec, M: Matvec, b, x, m: int, dtype):
    """One FGMRES(m) cycle from iterate x. Returns (x_new, residual
    estimate ||beta e1 - H y|| as a host float)."""
    norm = torch.linalg.vector_norm
    n = b.shape[0]
    r = b - matvec(x).to(dtype)
    beta = norm(r)
    V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
    V[0] = r / _nonzero(beta)
    Z = torch.zeros((m, n), dtype=dtype, device=b.device)
    H = torch.zeros((m + 1, m), dtype=dtype, device=b.device)
    for j in range(m):
        z = M(V[j]).to(dtype)
        w = matvec(z).to(dtype)
        # modified Gram-Schmidt against v_0..v_j, then one
        # re-orthogonalization pass (it stabilises the fp32 layers)
        Vj = V[:j + 1]
        h = torch.mv(Vj, w)
        w = w - torch.mv(Vj.T, h)
        h2 = torch.mv(Vj, w)
        w = w - torch.mv(Vj.T, h2)
        hnext = norm(w)
        V[j + 1] = w / torch.where(hnext < _EPS, torch.ones_like(hnext),
                                   hnext)
        H[:j + 1, j] = h + h2
        H[j + 1, j] = hnext
        Z[j] = z
    y, res = _lstsq(H, beta)
    return x + torch.mv(Z.T, y), res


def fgmres(matvec: Matvec, b: torch.Tensor, *, M: Matvec | None = None,
           m: int = 30, tol: float = 1e-9, max_cycles: int = 100, x0=None,
           dtype=None) -> tuple[torch.Tensor, SolveInfo]:
    """Restarted FGMRES(m) to ``||b - A x|| / ||b|| < tol`` (the cycle's
    residual estimate), at most ``max_cycles`` cycles."""
    norm = torch.linalg.vector_norm
    dtype = dtype or b.dtype
    b = b.to(dtype)
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    M = M or (lambda r: r)
    bnorm = _nonzero(norm(b))
    hdt = torch.float64 if dtype == torch.float64 else torch.float32
    # the host's stopping test compares in the solve's dtype, as the
    # reference's traced comparison does
    as_h = np.float64 if dtype == torch.float64 else np.float32
    hist = torch.full((max_cycles + 1,), -1.0, dtype=hdt, device=b.device)
    r0 = norm(b - matvec(x).to(dtype)) / bnorm
    hist[0] = r0
    relres, bnorm_h, tol_h = as_h(float(r0)), float(bnorm), as_h(tol)
    k = 0
    while k < max_cycles and relres >= tol_h:
        x, res = _fgmres_cycle(matvec, M, b, x, m, dtype)
        relres = as_h(res / bnorm_h)
        hist[k + 1] = float(relres)
        k += 1
    return x, SolveInfo(k, torch.tensor(float(relres), dtype=dtype,
                                        device=b.device), hist)


def fgmres_fixed_cycles(matvec: Matvec, M: Matvec, m: int, cycles: int = 1,
                        dtype=torch.float32) -> Matvec:
    """FGMRES(m) × cycles from x0 = 0, packaged as a (flexible)
    preconditioner: the middle layers of F3R."""

    def apply(rhs: torch.Tensor) -> torch.Tensor:
        b = rhs.to(dtype)
        x = torch.zeros_like(b)
        for _ in range(cycles):
            x, _ = _fgmres_cycle(matvec, M, b, x, m, dtype)
        return x

    return apply
