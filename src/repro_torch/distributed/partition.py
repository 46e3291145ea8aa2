"""Row-block partitioning with a local/remote column split (DESIGN.md §7.1).

The port of ``repro.distributed.partition``, copied as it is: host
numpy/scipy, no tensor and no device.

The canonical distributed-SpMV recipe (Kreutzer et al., "SpMV on GPGPU
clusters", arXiv:1112.5588): rows are split into contiguous blocks, one per
device, and each block's columns are classified against the row ownership —

* **local** columns fall inside the shard's own row range; they are
  renumbered to ``[0, n_loc)`` and index the shard's resident x-block.
* **halo** columns belong to other shards; the sorted set of distinct halo
  columns is renumbered to ``[0, n_halo)`` and indexes the buffer the halo
  exchange fills (:mod:`repro_torch.distributed.halo`).

Each shard therefore stores TWO sparse blocks, ``A_loc`` and ``A_rem``, and
``y_p = A_loc @ x_loc + A_rem @ x_halo`` — the split is what lets the local
matvec overlap with the communication that produces ``x_halo``.

Everything in this module is host-side numpy/scipy (format construction
happens on the host, like the paper's single-device build); σ-sorting is
applied *per partition* downstream (``from_csr`` on each block — SELL-C-σ,
arXiv:1307.6209 §3, keeps padding low exactly when σ spans one partition).

Square matrices only: column ownership must coincide with row ownership for
x and y to share one partition (the Krylov-solver contract).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Contiguous balanced row blocks: shard p owns rows
    ``[starts[p], starts[p+1])`` (and, square matrices, the same columns)."""

    n: int
    n_shards: int
    starts: np.ndarray          # int64 [n_shards + 1]

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.starts)

    def rows_of(self, p: int) -> tuple[int, int]:
        return int(self.starts[p]), int(self.starts[p + 1])

    def owner(self, cols: np.ndarray) -> np.ndarray:
        """Owning shard of each (global) column index."""
        return np.searchsorted(self.starts, np.asarray(cols), side="right") - 1


def partition_rows(n: int, n_shards: int) -> RowPartition:
    """Balanced contiguous split: the first ``n % n_shards`` shards get one
    extra row. Shards may be empty when ``n < n_shards`` (padding downstream
    keeps SPMD shapes uniform)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    base, rem = divmod(n, n_shards)
    counts = base + (np.arange(n_shards) < rem).astype(np.int64)
    starts = np.zeros(n_shards + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    return RowPartition(n=n, n_shards=n_shards, starts=starts)


@dataclasses.dataclass(frozen=True)
class ShardSplit:
    """One shard's row block, split and renumbered.

    ``a_loc``: [n_loc, n_pad] CSR over local columns (global col g ↦
    g - starts[p]; the column space is padded to the fleet-wide ``n_pad`` so
    every shard's x-block has one static length).
    ``a_rem``: [n_loc, h_pad] CSR over halo slots (global col ↦ its rank in
    ``halo_cols``); absent (None) when the whole fleet has no halo columns.
    ``halo_cols``: sorted distinct global column ids this shard must receive.
    """

    a_loc: sp.csr_matrix
    a_rem: sp.csr_matrix | None
    halo_cols: np.ndarray


def split_csr(a: sp.csr_matrix, part: RowPartition, *,
              n_pad: int) -> tuple[list[ShardSplit], int]:
    """Split ``a`` by ``part`` into per-shard (A_loc, A_rem, halo_cols).

    Returns ``(splits, h_pad)`` where ``h_pad`` is the fleet-wide maximum
    halo count — every ``a_rem`` is built with ``m = h_pad`` so the halo
    buffer has one static length (0 when no shard has halo columns).
    """
    a = a.tocsr()
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"distribution needs a square matrix, got {a.shape}")
    if n_pad < int(part.counts.max(initial=0)):
        raise ValueError(f"n_pad={n_pad} smaller than the largest shard")

    coos, halos = [], []
    for p in range(part.n_shards):
        r0, r1 = part.rows_of(p)
        blk = a[r0:r1].tocoo()
        local = (blk.col >= r0) & (blk.col < r1)
        coos.append((blk, local, r0))
        halos.append(np.unique(blk.col[~local]).astype(np.int64))
    h_pad = max((len(h) for h in halos), default=0)

    splits = []
    for (blk, local, r0), halo_cols in zip(coos, halos):
        n_loc = blk.shape[0]
        a_loc = sp.csr_matrix(
            (blk.data[local], (blk.row[local], blk.col[local] - r0)),
            shape=(n_loc, n_pad))
        a_loc.sum_duplicates()
        a_loc.sort_indices()
        a_rem = None
        if h_pad > 0:
            slot = np.searchsorted(halo_cols, blk.col[~local])
            a_rem = sp.csr_matrix(
                (blk.data[~local], (blk.row[~local], slot)),
                shape=(n_loc, h_pad))
            a_rem.sum_duplicates()
            a_rem.sort_indices()
        splits.append(ShardSplit(a_loc=a_loc, a_rem=a_rem,
                                 halo_cols=halo_cols))
    return splits, h_pad


def comm_counts(part: RowPartition,
                halo_cols_list: list[np.ndarray]) -> np.ndarray:
    """``counts[p, q]`` = x-entries shard p must receive from shard q — the
    halo-exchange traffic matrix (diagonal is zero by construction)."""
    counts = np.zeros((part.n_shards, part.n_shards), np.int64)
    for p, hc in enumerate(halo_cols_list):
        owners = part.owner(hc)
        for q in np.unique(owners):
            counts[p, q] = int((owners == q).sum())
    return counts


def comm_matrix(part: RowPartition,
                splits: list[ShardSplit]) -> np.ndarray:
    """:func:`comm_counts` over a list of :class:`ShardSplit`."""
    return comm_counts(part, [s.halo_cols for s in splits])


def assemble_global(part: RowPartition, splits: list[ShardSplit],
                    shape: tuple[int, int]) -> sp.csr_matrix:
    """Reassemble the global matrix from per-shard blocks (test oracle:
    ``assemble_global(split_csr(a)) == a``)."""
    rows, cols, vals = [], [], []
    for p, s in enumerate(splits):
        r0, _ = part.rows_of(p)
        loc = s.a_loc.tocoo()
        rows.append(loc.row + r0)
        cols.append(loc.col + r0)
        vals.append(loc.data)
        if s.a_rem is not None and s.a_rem.nnz:
            rem = s.a_rem.tocoo()
            rows.append(rem.row + r0)
            cols.append(s.halo_cols[rem.col])
            vals.append(rem.data)
    out = sp.csr_matrix(
        (np.concatenate(vals) if vals else np.zeros(0),
         (np.concatenate(rows) if rows else np.zeros(0, np.int64),
          np.concatenate(cols) if cols else np.zeros(0, np.int64))),
        shape=shape)
    out.sum_duplicates()
    out.sort_indices()
    return out
