"""Sparse triangular solve on PackSELL (paper §6 future work #3: "applying
PackSELL to other sparse matrix kernels, such as sparse triangular solves,
is promising because some of their implementations are similar to SpMV").

A serial forward substitution is hostile to SIMT hardware; the
throughput-friendly form is the **level-bounded Jacobi iteration**

    x_{k+1} = D^{-1} (b - L_strict x_k)

where ``N = D^{-1} L_strict`` is *nilpotent* with index = the number of
dependency levels of L, so the iteration is EXACT after ``n_levels``
steps, each one PackSELL SpMV and elementwise ops. The strict factor is
stored in PackSELL, so it gets the format's footprint reduction. The
SpMV is ``kernels.ops.packsell_spmv_percall``, as the
``packsell_<codec>`` operator kinds run it: the scan body on the CPU (the
reference's ``packsell_spmv_jnp``), the plan's kernel on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp
import torch

from .. import _device
from . import packsell as pk


def split_triangular(t: sp.csr_matrix, lower: bool = True):
    """(strict part CSR, diag) of a triangular matrix; validates shape."""
    t = t.tocsr()
    d = t.diagonal()
    if np.any(d == 0):
        raise ValueError("triangular solve needs a nonzero diagonal")
    strict = sp.tril(t, -1) if lower else sp.triu(t, 1)
    other = sp.triu(t, 1) if lower else sp.tril(t, -1)
    if other.nnz:
        raise ValueError("matrix is not triangular")
    strict = strict.tocsr()
    strict.sort_indices()
    return strict, d


def n_levels(strict: sp.csr_matrix, lower: bool = True) -> int:
    """Length of the longest dependency chain (host-side, O(nnz))."""
    strict = strict.tocsr()
    n = strict.shape[0]
    lev = np.zeros(n, dtype=np.int64)
    indptr, indices = strict.indptr, strict.indices
    rows = range(n) if lower else range(n - 1, -1, -1)
    for i in rows:
        deps = indices[indptr[i]:indptr[i + 1]]
        if len(deps):
            lev[i] = 1 + lev[deps].max()
    return int(lev.max()) + 1


class PackSELLTriSolver:
    """Triangular solver over a PackSELL-stored strict factor, on
    ``device`` (``None`` means the GPU). ``force`` is the plan variant of
    the SpMV on the card, as ``OperatorSet.force`` is; on the CPU
    ``"auto"`` runs the scan body."""

    def __init__(self, t: sp.csr_matrix, *, lower: bool = True,
                 C: int = 32, sigma: int = 256, D: int = 1,
                 codec: str = "e8m", device=None, force: str = "auto"):
        dev = _device.resolve_device(device)
        strict, diag = split_triangular(t, lower)
        self.levels = n_levels(strict, lower)
        self.mat = pk.from_csr(strict, C=C, sigma=sigma, D=D, codec=codec,
                               device=dev)
        self.dinv = torch.as_tensor(1.0 / diag, dtype=torch.float32,
                                    device=dev)
        self.lower = lower
        # imported here: the kernels package imports ``core`` itself
        from ..kernels import ops as kops

        self.plan = kops.percall_plan(self.mat, force)   # built now
        self._spmv = functools.partial(kops.packsell_spmv_percall, self.mat,
                                       force=force)
        self._graphs: dict = {}

    def memory_stats(self) -> dict:
        return self.mat.memory_stats()

    def _jacobi(self, b: torch.Tensor, iters: int) -> torch.Tensor:
        """``iters`` Jacobi steps from ``D^{-1} b``, eagerly."""
        x = self.dinv * b
        for _ in range(iters):
            x = self.dinv * (b - self._spmv(x))
        return x

    def solve(self, b: torch.Tensor, iters: int | None = None
              ) -> torch.Tensor:
        """Exact after ``self.levels`` iterations (nilpotent Jacobi). The
        reference's ``fori_loop`` over the steps: one CUDA graph per step
        count, kept on the solver, so a second solve only replays."""
        from ..solvers import graphs   # the solvers import ``core``

        iters = self.levels if iters is None else iters
        if iters not in self._graphs:
            self._graphs[iters] = graphs.Applied(
                functools.partial(graphs.method(self._jacobi), iters=iters))
        return self._graphs[iters](b.to(torch.float32))


def trisolve(t: sp.csr_matrix, b, *, lower: bool = True, device=None,
             **kw):
    """One-shot helper: build + solve (tests/benchmarks); ``b`` numpy or a
    tensor, moved to the solver's device."""
    solver = PackSELLTriSolver(t, lower=lower, device=device, **kw)
    if not torch.is_tensor(b):
        b = torch.from_numpy(np.asarray(b))
    return solver.solve(b.to(solver.mat.device)), solver
