"""Matrix reordering for delta locality (paper §5.1.1 future work:
"matrix reordering to improve the locality of nonzero elements is promising
for further improvements of PackSELL").

Reverse Cuthill–McKee clusters each row's nonzeros around the diagonal, so
column deltas shrink and D-bit fields cover them without dummy elements.
Host scipy code, the reference's ``repro.core.reorder`` line for line: it
is kept here because importing ``repro.core`` pulls in JAX.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


def rcm_permutation(a: sp.csr_matrix, symmetric_pattern: bool = False) \
        -> np.ndarray:
    """RCM ordering of the symmetrized pattern of a square matrix."""
    n, m = a.shape
    if n != m:
        raise ValueError("RCM needs a square matrix")
    return np.asarray(reverse_cuthill_mckee(
        a.tocsr(), symmetric_mode=symmetric_pattern), dtype=np.int64)


def apply_symmetric(a: sp.csr_matrix, perm: np.ndarray) -> sp.csr_matrix:
    """P A Pᵀ for a permutation vector ``perm`` (new index i = old
    perm[i]); preserves SPD-ness and spectra."""
    pr = sp.csr_matrix(
        (np.ones(len(perm)), (np.arange(len(perm)), perm)),
        shape=a.shape)
    out = (pr @ a @ pr.T).tocsr()
    out.sort_indices()
    return out


def rcm_reorder(a: sp.csr_matrix) -> tuple[sp.csr_matrix, np.ndarray]:
    """(reordered matrix, permutation). For solvers: solve P A Pᵀ y = P b,
    then x = Pᵀ y."""
    perm = rcm_permutation(a)
    return apply_symmetric(a, perm), perm


def bandwidth(a: sp.csr_matrix) -> int:
    """max |i - j| over stored entries (locality metric)."""
    coo = a.tocoo()
    if coo.nnz == 0:
        return 0
    return int(np.max(np.abs(coo.row.astype(np.int64) - coo.col)))
