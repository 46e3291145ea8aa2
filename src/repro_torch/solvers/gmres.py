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

The Arnoldi steps up to that copy (the residual, the ``m`` steps and
their preconditioner applications) run as CUDA graphs over static
buffers (:class:`_Arnoldi`), ``chunk`` steps per graph (all ``m`` in
:func:`fgmres_fixed_cycles`); the least-squares solve and ``x + Zᵀy``
follow eagerly. Inside :func:`.graphs.eager` the same bodies run inline.
A preconditioner that reads the host itself (``host_sync``, as
:func:`fgmres_fixed_cycles` does) cannot be captured: with one, the
cycle runs the eager loop (:func:`_fgmres_cycle`).
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from . import graphs
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


def _arnoldi_step(matvec: Matvec, M: Matvec, V, Z, H, j: int, dtype):
    """Arnoldi step ``j`` in place on the basis ``V``, the preconditioned
    basis ``Z`` and the Hessenberg ``H``."""
    norm = torch.linalg.vector_norm
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
    V[j + 1] = w / torch.where(hnext < _EPS, torch.ones_like(hnext), hnext)
    H[:j + 1, j] = h + h2
    H[j + 1, j] = hnext
    Z[j] = z


def _fgmres_cycle(matvec: Matvec, M: Matvec, b, x, m: int, dtype):
    """One FGMRES(m) cycle from iterate x, eagerly. Returns (x_new,
    residual estimate ||beta e1 - H y|| as a host float)."""
    n = b.shape[0]
    r = b - matvec(x).to(dtype)
    beta = torch.linalg.vector_norm(r)
    V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
    V[0] = r / _nonzero(beta)
    Z = torch.zeros((m, n), dtype=dtype, device=b.device)
    H = torch.zeros((m + 1, m), dtype=dtype, device=b.device)
    for j in range(m):
        _arnoldi_step(matvec, M, V, Z, H, j, dtype)
    y, res = _lstsq(H, beta)
    return x + torch.mv(Z.T, y), res


class _Arnoldi:
    """FGMRES(m) cycles of one shape over static buffers: ``b``, ``x``,
    the bases ``V`` and ``Z``, ``H`` and ``beta``. Every cycle overwrites
    each entry the least-squares solve reads, so the buffers are zeroed
    once. The residual and the ``m`` Arnoldi steps run as graphs of
    ``chunk`` steps. A call is one cycle, ``(b, x) -> (x_new, res)``."""

    def __init__(self, matvec: Matvec, M: Matvec, b, m: int, dtype,
                 chunk: int):
        n, dev = b.shape[0], b.device
        self.matvec, self.M, self.dtype = matvec, M, dtype
        self.b = torch.empty((n,), dtype=dtype, device=dev)
        self.x = torch.empty((n,), dtype=dtype, device=dev)
        self.V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        self.Z = torch.zeros((m, n), dtype=dtype, device=dev)
        self.H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        self.beta = torch.zeros((), dtype=dtype, device=dev)
        pool, steps = graphs.Pool(), graphs.method(self._steps)
        self.graphs = [
            graphs.Graph(functools.partial(steps, j0, min(j0 + chunk, m)),
                         dev, pool) for j0 in range(0, m, chunk)]

    def _steps(self, j0: int, j1: int) -> None:
        if j0 == 0:
            r = self.b - self.matvec(self.x).to(self.dtype)
            self.beta.copy_(torch.linalg.vector_norm(r))
            self.V[0] = r / _nonzero(self.beta)
        for j in range(j0, j1):
            _arnoldi_step(self.matvec, self.M, self.V, self.Z, self.H, j,
                          self.dtype)

    def __call__(self, b, x):
        self.b.copy_(b)
        self.x.copy_(x)
        for g in self.graphs:
            g()
        y, res = _lstsq(self.H, self.beta)
        return x + torch.mv(self.Z.T, y), res


def _cycles(matvec: Matvec, M: Matvec, b, m: int, dtype, chunk):
    """The cycle function ``(b, x) -> (x_new, res)`` for ``b``'s shape:
    :class:`_Arnoldi` graphs (inline inside :func:`.graphs.eager`), or
    the eager cycle for a ``host_sync`` preconditioner."""
    if getattr(M, "host_sync", False):
        return lambda b, x: _fgmres_cycle(matvec, M, b, x, m, dtype)
    return _Arnoldi(matvec, M, b, m, dtype, chunk or m)


def fgmres(matvec: Matvec, b: torch.Tensor, *, M: Matvec | None = None,
           m: int = 30, tol: float = 1e-9, max_cycles: int = 100, x0=None,
           dtype=None, chunk: int | None = None
           ) -> tuple[torch.Tensor, SolveInfo]:
    """Restarted FGMRES(m) to ``||b - A x|| / ||b|| < tol`` (the cycle's
    residual estimate), at most ``max_cycles`` cycles; ``chunk`` Arnoldi
    steps per graph (None: all ``m``)."""
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
    cycle = _cycles(matvec, M, b, m, dtype, chunk)
    k = 0
    while k < max_cycles and relres >= tol_h:
        x, res = cycle(b, x)
        relres = as_h(res / bnorm_h)
        hist[k + 1] = float(relres)
        k += 1
    return x, SolveInfo(k, torch.tensor(float(relres), dtype=dtype,
                                        device=b.device), hist)


def fgmres_fixed_cycles(matvec: Matvec, M: Matvec, m: int, cycles: int = 1,
                        dtype=torch.float32) -> Matvec:
    """FGMRES(m) × cycles from x0 = 0, packaged as a (flexible)
    preconditioner: the middle layers of F3R. Each cycle is one Arnoldi
    graph of all ``m`` steps (kept per input shape and device in
    ``.cycles``), then the host's least-squares solve; so the application
    reads the host (``host_sync``)."""
    cycle_of: dict = {}

    def apply(rhs: torch.Tensor) -> torch.Tensor:
        b = rhs.to(dtype)
        key = (tuple(b.shape), b.device)
        if key not in cycle_of:
            cycle_of[key] = _cycles(matvec, M, b, m, dtype, None)
        x = torch.zeros_like(b)
        for _ in range(cycles):
            x, _ = cycle_of[key](b, x)
        return x

    apply.host_sync = True
    apply.cycles = cycle_of
    return apply
