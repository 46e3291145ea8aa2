"""MixedPackSELL: one operator, rows split across codecs.

The port of ``repro.precision.mixed``. A per-row-class
:class:`~repro_torch.precision.select.PrecisionPlan` partitions the rows
by required precision; each class becomes its own format block over that
class's row submatrix (full column space, so x is shared) at its own
``(codec, D)``, an ``fp32`` class an uncompressed SELL block. It is a thin
wrapper over :class:`~repro_torch.kernels.composite.CompositePlan`: every
class is one member of a single term, each runs its own kernel, and one
inverse-permutation gather gives y. ``memory_stats`` is the composite
blend in the historical per-class key layout.
"""
from __future__ import annotations

import scipy.sparse as sp
import torch

from ..kernels import composite as kc
from .select import PrecisionPlan


class MixedPackSELL:
    """Rows partitioned by precision class into stacked format blocks, on
    ``device`` (``None``: the GPU); ``force`` is the plan variant of the
    PackSELL blocks (one, or one per class)."""

    def __init__(self, a: sp.csr_matrix, plan: PrecisionPlan, *,
                 C: int = 32, sigma: int = 256, device=None, force="auto"):
        a = a.tocsr()
        a.sort_indices()
        self.n, self.m = a.shape
        self.nnz = int(a.nnz)
        self.pplan = plan
        self.C, self.sigma = C, sigma
        # every row needs exactly one class slot for the gather epilogue:
        # the composite build checks coverage and overlap
        self.cplan = kc.CompositePlan.from_classes(
            a, [(c.codec, c.D, c.rows) for c in plan.classes],
            C=C, sigma=sigma, name="mixed", device=device, force=force)

    @property
    def blocks(self):
        """The per-class composite members."""
        return self.cplan.members

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x with each row computed at its class's precision."""
        return self.cplan.spmv(x)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A X for X: [m, nb]."""
        return self.cplan.spmm(x)

    @property
    def matvec(self):
        return self.spmv

    @property
    def shape(self):
        return (self.n, self.m)

    def memory_stats(self) -> dict:
        """Blended memory profile: total bytes, bytes/nnz, and the
        per-class breakdown."""
        st = self.cplan.memory_stats()
        return {
            "mixed_bytes": st["composite_bytes"],
            "bytes_per_nnz": st["composite_bytes"] / max(self.nnz, 1),
            "nnz": self.nnz, "n": self.n, "m": self.m,
            "classes": [{
                "codec": mb["codec"], "D": mb["D"], "rows": mb["rows"],
                "bytes": mb["bytes"], "nnz": mb["nnz"],
                "bytes_per_nnz": mb["bytes_per_nnz"],
            } for mb in st["members"]],
        }

    def warmup(self, nb: int = 0) -> "MixedPackSELL":
        """Run each product once ahead of the first real call."""
        self.cplan.warmup(nb=nb)
        return self
