"""Public SpMV entry points: PackSELL through the plan engine, and SELL.

``packsell_spmv(mat, x)`` looks up (or builds) the matrix's cached
:class:`~repro_torch.kernels.plan.SpMVPlan` and runs it: on CUDA the
fused-stream kernel (K1), the band kernel (K6) or the per-bucket kernel
(K4), on the CPU the plain body. ``force=`` pins the variant
(``auto|fused|full|band|jnp``), ``sb``/``wb``/``hw`` are the per-bucket
kernels' tiles and band half-window, and ``permuted=True`` returns y in
stored-row order.

``REPRO_DEBUG_FINITE=1`` makes :func:`packsell_spmv` reject NaN/Inf in x
before it enters the kernels (:func:`_debug_check_finite`).
"""
from __future__ import annotations

import os

import torch

from ..core.packsell import PackSELLMatrix, packsell_spmv_torch
from ..core.sell import SELLMatrix, gather_rows
from . import plan as _plan
from . import sell_spmv as _sk


def _debug_check_finite(x: torch.Tensor) -> None:
    """Opt-in input screen (``REPRO_DEBUG_FINITE=1``): reject NaN/Inf in x
    BEFORE it enters the packed kernels, where a poisoned entry smears
    into every output row touching its column. It reads the device from
    the host, so it is skipped while a CUDA graph is being captured (there
    the guard layer owns detection)."""
    if os.environ.get("REPRO_DEBUG_FINITE", "0") != "1":
        return
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    bad = int((~torch.isfinite(x)).sum())
    if bad:
        raise FloatingPointError(
            f"packsell_spmv: input x has {bad} non-finite (NaN/Inf) "
            "entries (REPRO_DEBUG_FINITE=1)")


def packsell_spmv(mat: PackSELLMatrix, x: torch.Tensor, *, sb: int = 8,
                  wb: int = 32, hw: int = _plan._DEF_HW, force: str = "auto",
                  decode_cache: str = "checkpoint",
                  permuted: bool = False) -> torch.Tensor:
    """y = A @ x via the plan engine."""
    _debug_check_finite(x)
    plan = _plan.get_plan(mat, sb=sb, wb=wb, hw=hw, force=force,
                          decode_cache=decode_cache)
    return plan.spmv(mat, x, permuted=permuted)


def percall_plan(mat: PackSELLMatrix, force: str = "auto"):
    """The plan :func:`packsell_spmv_percall` runs for ``mat``, built (and
    cached) now; ``None`` where it runs the scan body: a CPU matrix under
    ``force="auto"``."""
    if mat.device.type == "cpu" and force == "auto":
        return None
    return _plan.get_plan(mat, force=force)


def packsell_spmv_percall(mat: PackSELLMatrix, x: torch.Tensor, *,
                          force: str = "auto") -> torch.Tensor:
    """The reference's per-call PackSELL SpMV (``packsell_spmv_jnp``), as
    the ``packsell_<codec>`` operator kinds and the triangular solve run
    it: for a CPU matrix under ``force="auto"`` the scan body
    (``core.packsell.packsell_spmv_torch``), bit-equal to the reference's;
    otherwise the plan of ``force`` (:func:`packsell_spmv`), which on the
    card runs the plan's kernel, or its plain body under ``force="jnp"``."""
    plan = percall_plan(mat, force)
    if plan is None:
        return packsell_spmv_torch(mat, x)
    return plan.spmv(mat, x)


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
    the fp64 operator): the K2 kernel per width bucket, then one ``cat``
    of the stored rows and one gather by the matrix's row → stored-row
    map (``core.sell.gather_rows``), so no host sync runs."""
    xc = x.to(compute_dtype).contiguous()
    parts = [_sk.sell_spmv_bucket(val, col, xc, compute_dtype)
             for val, col in zip(mat.vals, mat.cols)]
    return gather_rows(mat, parts, compute_dtype)
