"""Inner-outer CG (paper §5.2.2): FP64 flexible CG preconditioned by m_in
iterations of lower-precision PCG whose SpMV runs in FP32 / FP16 / E8MY.

Variants (paper Fig. 11): fp64 / fp32 / fp16 / e8m<D>; the last one is
the PackSELL solver that tunes the mantissa width Y = 22 - D. The
baseline is :func:`pcg_reference`, FP64 PCG with the same preconditioner.
"""
from __future__ import annotations

import dataclasses

import torch

from . import precond
from .cg import SolveInfo, fcg, pcg, pcg_fixed_iters
from .operators import OperatorSet


@dataclasses.dataclass
class IOCGConfig:
    m_in: int = 50             # inner PCG iterations (paper: 20 / 50 / 80)
    inner_spmv: str = "fp32"   # 'fp64'|'fp32'|'fp16'|'packsell_e8m<D>'
    ainv_terms: int = 2
    tol: float = 1e-9
    maxiter: int = 2000        # outer FCG iterations


def variant(name: str, m_in: int = 50) -> IOCGConfig:
    if name in ("fp64", "fp32", "fp16"):
        return IOCGConfig(m_in=m_in, inner_spmv=name)
    if name.startswith("e8m"):  # e8m<D> with D the delta width
        return IOCGConfig(m_in=m_in, inner_spmv=f"packsell_{name}")
    raise ValueError(name)


def solve(ops: OperatorSet, b: torch.Tensor,
          config: IOCGConfig) -> tuple[torch.Tensor, SolveInfo]:
    """FCG on the fp64 operator, each step preconditioned by
    :func:`~.cg.pcg_fixed_iters` on ``config.inner_spmv`` with the Neumann
    approximate inverse; ``b`` on the set's device. The preconditioner
    and the step graphs are kept in ``ops.graphs``, so a second solve on
    the same operators only replays."""
    key = ("iocg", config.inner_spmv, config.m_in, config.ainv_terms)
    M = ops.graphs.get(key)
    if M is None:
        A_in = ops.matvec(config.inner_spmv)
        inner_dtype = (torch.float64 if config.inner_spmv == "fp64"
                       else torch.float32)
        M_in = precond.neumann_ainv(ops.diag(), A_in, k=config.ainv_terms,
                                    dtype=inner_dtype, device=ops.device)
        M = ops.graphs[key] = pcg_fixed_iters(A_in, M_in, config.m_in,
                                              dtype=inner_dtype)
    return fcg(ops.matvec("fp64"), b, M=M, tol=config.tol,
               maxiter=config.maxiter, dtype=b.dtype, jit_cache=ops.graphs,
               jit_key=key)


def pcg_reference(ops: OperatorSet, b: torch.Tensor, *, tol: float = 1e-9,
                  maxiter: int = 20000,
                  ainv_terms: int = 2) -> tuple[torch.Tensor, SolveInfo]:
    """The paper's baseline: standard full-precision PCG with the same
    approximate-inverse preconditioner (its graphs kept in
    ``ops.graphs``)."""
    key = ("pcg_reference", ainv_terms)
    M = ops.graphs.get(key)
    if M is None:
        M = ops.graphs[key] = precond.neumann_ainv(
            ops.diag(), ops.matvec("fp64"), k=ainv_terms,
            dtype=torch.float64, device=ops.device)
    return pcg(ops.matvec("fp64"), b, M=M, tol=tol, maxiter=maxiter,
               dtype=b.dtype, jit_cache=ops.graphs, jit_key=key)
