"""CSR / COO baseline SpMV (the paper's cuCSR / cuCOO counterparts).

The port of ``repro.core.sparse``. The reference's product is
``jax.ops.segment_sum`` and no Pallas kernel, so it has no hand-written
kernel here either: on the card :meth:`CSRMatrix.spmv` runs cuSPARSE
through ``torch.sparse`` (a CSR tensor built once per compute dtype), on
the CPU the plain body, one ``index_add_`` of the products by row in
entry order. Neither fixes the order of a row's adds the way the
reference's segment sum does, so the two agree with the reference to a
stated tolerance, not bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .. import _device


@dataclasses.dataclass
class CSRMatrix:
    data: torch.Tensor      # value_dtype[nnz]
    indices: torch.Tensor   # int32[nnz]
    row_ids: torch.Tensor   # int32[nnz]  (expanded indptr: segment ids)
    indptr: torch.Tensor    # int64[n + 1]
    n: int
    m: int
    _sparse: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def shape(self):
        return (self.n, self.m)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def _csr_tensor(self, dtype) -> torch.Tensor:
        t = self._sparse.get(dtype)
        if t is None:
            t = self._sparse[dtype] = torch.sparse_csr_tensor(
                self.indptr, self.indices.to(torch.int64),
                self.data.to(dtype), size=(self.n, self.m))
        return t

    def spmv(self, x: torch.Tensor, compute_dtype=torch.float32
             ) -> torch.Tensor:
        """y = A x in ``compute_dtype``: cuSPARSE on the card, the plain
        ``index_add_`` body on the CPU."""
        xc = x.to(compute_dtype)
        if xc.device.type == "cuda":
            return torch.mv(self._csr_tensor(compute_dtype), xc)
        prod = self.data.to(compute_dtype) * xc[self.indices.long()]
        y = torch.zeros(self.n, dtype=compute_dtype, device=xc.device)
        return y.index_add_(0, self.row_ids.long(), prod)

    def memory_stats(self) -> dict:
        vb = self.data.element_size()
        nnz = self.data.numel()
        return dict(csr_bytes=vb * nnz + 4 * nnz + 4 * (self.n + 1))


def csr_from_scipy(a: sp.csr_matrix, value_dtype="float32", *,
                   device=None) -> CSRMatrix:
    dev = _device.resolve_device(device)
    a = a.tocsr()
    a.sort_indices()
    row_ids = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    return CSRMatrix(
        data=torch.from_numpy(a.data.astype(value_dtype)).to(dev),
        indices=torch.from_numpy(a.indices.astype(np.int32)).to(dev),
        row_ids=torch.from_numpy(row_ids.astype(np.int32)).to(dev),
        indptr=torch.from_numpy(a.indptr.astype(np.int64)).to(dev),
        n=a.shape[0], m=a.shape[1])


@dataclasses.dataclass
class COOMatrix(CSRMatrix):
    """COO shares the CSR product (row ids are explicit in both after
    expansion), with its own memory model."""

    def memory_stats(self) -> dict:
        vb = self.data.element_size()
        return dict(coo_bytes=(vb + 8) * self.data.numel())


def coo_from_scipy(a: sp.csr_matrix, value_dtype="float32", *,
                   device=None) -> COOMatrix:
    c = csr_from_scipy(a, value_dtype, device=device)
    return COOMatrix(c.data, c.indices, c.row_ids, c.indptr, c.n, c.m)
