"""Synthetic sparse matrices reproducing the *classes* of the paper's suite.

SuiteSparse is not available offline; each generator below targets one of the
structural regimes in Table 1 / §5 of the paper:

* ``stencil_1d/2d/3d``   — banded FEM-style stencils (parabolic_fem, CurlCurl,
  HPCG-like). Low RSD, high locality → PackSELL's best case. ``stencil_3d``
  with 27 neighbours *is* the HPCG operator (HPCG_x_y_z rows = 2^(x+y+z)).
* ``random_banded``      — random pattern within a bandwidth (Flan/audikw-like
  clustered rows).
* ``scattered``          — uniformly random columns (GL7d17/cont11-like):
  large deltas → many dummies, PackSELL's worst case.
* ``powerlaw``           — Zipf row degrees (language/degme-like): high RSD,
  SELL's worst case.

All generators return scipy CSR with reproducible values; SPD variants are
produced by diagonal dominance (for CG / PCG tests).

The generators of ``repro.core.testmats``, unchanged (same seeds, same
CSR): kept here because importing ``repro.core`` pulls in JAX.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _finish(rows, cols, vals, n, m, rng, spd):
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, m))
    a.sum_duplicates()
    a.sort_indices()
    if spd:
        a = a + a.T  # symmetrize
        rowsum = np.abs(a).sum(axis=1).A1 if hasattr(np.abs(a).sum(axis=1), "A1") \
            else np.asarray(np.abs(a).sum(axis=1)).ravel()
        a = a + sp.diags(rowsum + 1.0)
        a = a.tocsr()
        a.sort_indices()
    return a


def stencil_1d(n: int, half_bw: int = 1, spd: bool = True,
               seed: int = 0) -> sp.csr_matrix:
    rng = np.random.default_rng(seed)
    diags, offs = [], []
    for k in range(-half_bw, half_bw + 1):
        if k == 0:
            continue
        diags.append(-np.abs(rng.standard_normal(n - abs(k))) - 0.1)
        offs.append(k)
    a = sp.diags(diags, offs, shape=(n, n)).tocsr()
    if spd:
        a = 0.5 * (a + a.T)
        rowsum = np.asarray(np.abs(a).sum(axis=1)).ravel()
        a = a + sp.diags(rowsum + 1.0)
    a = a.tocsr()
    a.sort_indices()
    return a


def stencil_3d(nx: int, ny: int, nz: int, neighbours: int = 27,
               spd: bool = True, seed: int = 0) -> sp.csr_matrix:
    """HPCG-style 27-point (or 7-point) stencil on an nx×ny×nz grid."""
    assert neighbours in (7, 27)
    n = nx * ny * nz
    idx = np.arange(n)
    iz, iy, ix = idx // (nx * ny), (idx // nx) % ny, idx % nx
    rows, cols = [], []
    if neighbours == 7:
        offsets = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                   (0, 0, 1), (0, 0, -1)]
    else:
        offsets = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                   for dx in (-1, 0, 1)]
    for dx, dy, dz in offsets:
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
        rows.append(idx[ok])
        cols.append((jz * ny + jy)[ok] * nx + jx[ok])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.where(rows == cols, 26.0 if neighbours == 27 else 6.0, -1.0)
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    a.sort_indices()
    if not spd:
        # HPGMxP-style asymmetry: scale the upper triangle
        a = sp.triu(a, 1) * 0.5 + sp.tril(a)
        a = a.tocsr()
        a.sort_indices()
    return a


def random_banded(n: int, half_bw: int, nnz_per_row: int, spd: bool = True,
                  seed: int = 0) -> sp.csr_matrix:
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz_per_row)
    off = rng.integers(-half_bw, half_bw + 1, size=rows.size)
    cols = np.clip(rows + off, 0, n - 1)
    vals = rng.standard_normal(rows.size) * 0.1
    return _finish(rows, cols, vals, n, n, rng, spd)


def scattered(n: int, m: int | None = None, nnz_per_row: int = 8,
              spd: bool = False, seed: int = 0) -> sp.csr_matrix:
    m = m or n
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = rng.integers(0, m, size=rows.size)
    vals = rng.standard_normal(rows.size) * 0.1
    return _finish(rows, cols, vals, n, m, rng, spd and n == m)


def powerlaw(n: int, mean_deg: int = 8, alpha: float = 2.0,
             spd: bool = False, seed: int = 0) -> sp.csr_matrix:
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(alpha, n) + 1) * mean_deg, n // 2).astype(int)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.size)
    vals = rng.standard_normal(rows.size) * 0.1
    return _finish(rows, cols, vals, n, n, rng, spd)


def hpcg(nx: int, ny: int, nz: int, seed: int = 0) -> sp.csr_matrix:
    return stencil_3d(nx, ny, nz, neighbours=27, spd=True, seed=seed)


def hpgmp(nx: int, ny: int, nz: int, seed: int = 0) -> sp.csr_matrix:
    return stencil_3d(nx, ny, nz, neighbours=27, spd=False, seed=seed)


def suite(scale: str = "small") -> dict:
    """The benchmark suite: one generator per structural class of Table 1."""
    if scale == "tiny":       # unit tests
        return {
            "stencil1d": stencil_1d(400, 2),
            "hpcg_mini": hpcg(8, 8, 8),
            "banded": random_banded(512, 24, 6),
            "scattered": scattered(512, nnz_per_row=5),
            "powerlaw": powerlaw(512, mean_deg=5),
        }
    if scale == "small":      # benchmarks on 1 CPU
        return {
            "parabolic_like": stencil_1d(60_000, 3),
            "hpcg_16": hpcg(16, 16, 16),
            "curlcurl_like": random_banded(50_000, 60, 11),
            "flan_like": random_banded(40_000, 400, 40),
            "scattered_like": scattered(30_000, nnz_per_row=17),
            "language_like": powerlaw(30_000, mean_deg=3),
        }
    if scale == "medium":     # heavier benchmark pass
        return {
            "parabolic_like": stencil_1d(250_000, 3),
            "hpcg_32": hpcg(32, 32, 32),
            "curlcurl_like": random_banded(200_000, 60, 11),
            "flan_like": random_banded(100_000, 400, 40),
            "scattered_like": scattered(80_000, nnz_per_row=17),
            "language_like": powerlaw(80_000, mean_deg=3),
        }
    raise ValueError(scale)
