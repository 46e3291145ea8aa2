"""Public SpMV entry points: PackSELL through the plan engine, and SELL.

``packsell_spmv(mat, x)`` looks up (or builds) the matrix's cached
:class:`~repro_torch.kernels.plan.SpMVPlan` and runs it: on CUDA the
fused-stream kernel (K1), the band kernel (K6) or the per-bucket kernel
(K4), on the CPU the plain body. ``force=`` pins the variant
(``auto|fused|full|band|jnp``), ``sb``/``wb``/``hw`` are the per-bucket
kernels' tiles and band half-window, and ``permuted=True`` returns y in
stored-row order.
"""
from __future__ import annotations

import torch

from ..core.packsell import PackSELLMatrix
from ..core.sell import SELLMatrix
from . import plan as _plan
from . import sell_spmv as _sk


def packsell_spmv(mat: PackSELLMatrix, x: torch.Tensor, *, sb: int = 8,
                  wb: int = 32, hw: int = _plan._DEF_HW, force: str = "auto",
                  decode_cache: str = "checkpoint",
                  permuted: bool = False) -> torch.Tensor:
    """y = A @ x via the plan engine."""
    plan = _plan.get_plan(mat, sb=sb, wb=wb, hw=hw, force=force,
                          decode_cache=decode_cache)
    return plan.spmv(mat, x, permuted=permuted)


def packsell_spmm(mat: PackSELLMatrix, x: torch.Tensor, *, sb: int = 8,
                  wb: int = 32, hw: int = _plan._DEF_HW, force: str = "auto",
                  decode_cache: str = "checkpoint",
                  permuted: bool = False) -> torch.Tensor:
    """Y = A @ X for X: [m, nb] (one pass over the words for all nb
    right-hand sides)."""
    if x.dim() != 2:
        raise ValueError(f"packsell_spmm expects x of shape [m, nb], got "
                         f"{tuple(x.shape)}; use packsell_spmv for a single "
                         "RHS")
    plan = _plan.get_plan(mat, sb=sb, wb=wb, hw=hw, force=force,
                          decode_cache=decode_cache)
    return plan.spmm(mat, x, permuted=permuted)


def sell_spmv(mat: SELLMatrix, x: torch.Tensor,
              compute_dtype=torch.float32) -> torch.Tensor:
    """y = A @ x over SELL in ``compute_dtype`` (float32, or float64 for
    the fp64 operator): the K2 kernel per width bucket, then one scatter
    of the concatenated stored rows by ``outrows`` (sentinel rows, >= n,
    dropped)."""
    xc = x.to(compute_dtype).contiguous()
    y = torch.zeros((mat.n,), dtype=compute_dtype, device=x.device)
    parts = [_sk.sell_spmv_bucket(val, col, xc, compute_dtype).reshape(-1)
             for val, col in zip(mat.vals, mat.cols)]
    if not parts:
        return y
    t_cat = torch.cat(parts)
    outrow = torch.cat([o.reshape(-1) for o in mat.outrows]).long()
    keep = outrow < mat.n
    y[outrow[keep]] = t_cat[keep]
    return y
