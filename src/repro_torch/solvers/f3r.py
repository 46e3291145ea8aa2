"""F3R: the FP16-enabled nested Krylov solver of Suzuki & Iwashita (2025),
at the structure level the PackSELL paper relies on (§5.2.1):

    L1  FGMRES            — FP64 SpMV, convergence-controlling outer loop
    L2  FGMRES (fixed)    — FP32 SpMV, preconditioner of L1
    L3  FGMRES (fixed)    — **FP16 SpMV** (SELL or PackSELL), preconditioner of L2
    L4  Richardson (fixed)— **FP16 SpMV** + approximate-inverse preconditioner

The two inner layers (L3 + L4) run most of the SpMVs, so swapping their
SpMV between SELL-FP16 and PackSELL-FP16 measures what the paper's Fig.
10 measures. The defaults are the reference's documented assumptions: the
paper does not give F3R's hyper-parameters.
"""
from __future__ import annotations

import dataclasses

import torch

from . import precond
from .cg import SolveInfo
from .gmres import fgmres, fgmres_fixed_cycles
from .operators import OperatorSet
from .richardson import richardson_fixed_iters


@dataclasses.dataclass
class F3RConfig:
    m_outer: int = 20         # L1 restart length
    m_mid: int = 10           # L2 Arnoldi steps per application
    m_inner: int = 5          # L3 Arnoldi steps per application
    richardson_iters: int = 4  # L4
    ainv_terms: int = 2        # Neumann terms in the SD-AINV-role precond
    tol: float = 1e-9
    max_cycles: int = 200
    # SpMV kinds per layer ('fp64'/'fp32'/'fp16'/'packsell_fp16'/...)
    spmv_outer: str = "fp64"
    spmv_mid: str = "fp32"
    spmv_inner: str = "fp16"


def presets(variant: str) -> F3RConfig:
    """The paper's three F3R builds (§5.2.1)."""
    if variant == "fp64":          # FP64-F3R
        return F3RConfig(spmv_outer="fp64", spmv_mid="fp64", spmv_inner="fp64")
    if variant == "fp16":          # FP16-F3R (SELL fp16 inner SpMV)
        return F3RConfig(spmv_inner="fp16")
    if variant == "packsell":      # PackSELL-F3R (V=16, D=15 fp16 embed)
        return F3RConfig(spmv_inner="packsell_fp16")
    raise ValueError(variant)


def solve(ops: OperatorSet, b: torch.Tensor,
          config: F3RConfig) -> tuple[torch.Tensor, SolveInfo]:
    """The four layers over ``ops``' kinds; ``b`` on the set's device. An
    L3 application (L4 inside it) is one graph replay and the host's
    least-squares solve; L2 and L1 call a preconditioner that reads the
    host, so they run eagerly around those replays. The layers are kept
    in ``ops.graphs``, so a second solve on the same operators only
    replays."""
    key = ("f3r", config.spmv_mid, config.spmv_inner, config.m_mid,
           config.m_inner, config.richardson_iters, config.ainv_terms)
    l2 = ops.graphs.get(key)
    if l2 is None:
        A16 = ops.matvec(config.spmv_inner)
        ainv = precond.neumann_ainv(ops.diag(), A16, k=config.ainv_terms,
                                    dtype=torch.float32, device=ops.device)
        l4 = richardson_fixed_iters(A16, ainv, config.richardson_iters,
                                    dtype=torch.float32)
        l3 = fgmres_fixed_cycles(A16, l4, m=config.m_inner,
                                 dtype=torch.float32)
        l2 = ops.graphs[key] = fgmres_fixed_cycles(
            ops.matvec(config.spmv_mid), l3, m=config.m_mid,
            dtype=torch.float32)
    return fgmres(ops.matvec(config.spmv_outer), b, M=l2, m=config.m_outer,
                  tol=config.tol, max_cycles=config.max_cycles,
                  dtype=b.dtype)
