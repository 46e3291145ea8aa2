"""Plain oracles for the kernels: the PyTorch bodies of ``core`` and the
dense float64 decode."""
from __future__ import annotations

import numpy as np
import torch

from ..core.packsell import PackSELLMatrix, decode_to_dense, packsell_spmv_torch
from ..core.sell import SELLMatrix, sell_spmv


def packsell_spmv_ref(mat: PackSELLMatrix, x: torch.Tensor) -> torch.Tensor:
    return packsell_spmv_torch(mat, x)


def sell_spmv_ref(mat: SELLMatrix, x: torch.Tensor) -> torch.Tensor:
    return sell_spmv(mat, x)


def packsell_spmv_dense_oracle(mat: PackSELLMatrix, x: np.ndarray) -> np.ndarray:
    """Slow exact oracle: decode to dense (quantized) and matvec in float64."""
    return decode_to_dense(mat) @ np.asarray(x, dtype=np.float64)


# ---------------------------------------------------------------------------
# Plain twins of the kernel paths: the same operands and the same order of
# operations, each kernel replaced by its plain version, so that on the card
# a kernel path and its twin agree bit for bit.
# ---------------------------------------------------------------------------


def plan_plain(plan, mat: PackSELLMatrix, x: torch.Tensor, *,
               permuted: bool = False,
               multi_rhs: bool = False) -> torch.Tensor:
    """``plan.spmv``/``plan.spmm`` with each kernel's plain version: K1/K3
    over a ``fused`` plan's stream, K4/K5/K6 over a ``full`` or ``band``
    plan's bucket table. A plan that launches no kernel runs as it is."""
    from . import packsell_spmv as _pk
    from . import plan as kplan

    dev = plan.device_operands()
    fused = dev.get("fused")
    kw = dict(codec_name=mat.codec_name, D=mat.D)
    xc = x.to(torch.float32).contiguous()
    if plan.variant == "fused" and fused is not None:
        lay = plan.fused_layout
        body = (_pk.packsell_spmm_fused_plain if multi_rhs
                else _pk.packsell_spmv_fused_plain)
        part = body(fused[0], fused[1], xc, encoding=lay.encoding,
                    scale=lay.scale, **kw)
        return plan._fused_epilogue(part, dev, permuted)
    if plan.variant not in ("full", "band") or fused is not None:
        return plan.execute_with(mat, dev, x, permuted=permuted,
                                 multi_rhs=multi_rhs)
    args = (mat.packs, mat.d0s, dev["kckpt"], dev["ktable"], xc)
    if multi_rhs:
        t = _pk.packsell_spmm_buckets_plain(*args, **kw)
    elif plan.variant == "full":
        t = _pk.packsell_spmv_buckets_plain(*args, **kw)
    else:
        t = _pk.packsell_spmv_band_buckets_plain(
            mat.packs, mat.d0s, dev["wins"], *args[2:], hw=plan.hw, **kw)
    return t if permuted else kplan.stored_unpermute(t, dev["inv"])


def composite_plain(cp, x: torch.Tensor, *,
                    multi_rhs: bool = False) -> torch.Tensor:
    """``cp.spmv``/``cp.spmm`` of a
    :class:`~repro_torch.kernels.composite.CompositePlan` with every
    member's kernels' plain versions (:func:`plan_plain`; K2's for a SELL
    member) and the same gather per term."""
    from ..core import sell as sl
    from . import composite as kc

    parts = [[] for _ in range(cp.n_terms)]
    for mem in cp.members:
        xm = (x,)[mem.x_index]
        parts[mem.term].append(
            kc.stored_parts(mem.mat, xm, multi_rhs, sl.sell_bucket_spmv)
            if mem.plan is None else
            plan_plain(mem.plan, mem.mat, xm, permuted=True,
                       multi_rhs=multi_rhs))
    return cp.gather(parts, cp.invs)
