"""Delta encoding of column indices (paper §4.1, eqs. 2–4) + dummy insertion.

All of this is host-side *format construction* (the paper builds formats on
the CPU too); it is vectorized numpy over the CSR stream, no Python per-row
loops on the hot path.

Byte-for-byte the host code of ``repro.core.delta``: it is kept here
because importing ``repro.core`` pulls in JAX.
"""
from __future__ import annotations

import numpy as np

# Largest delta a single flag=0 dummy word can carry (31-bit field).
MAX_DUMMY_DELTA = (1 << 31) - 1


def lower_bandwidth(indptr: np.ndarray, indices: np.ndarray, n: int) -> int:
    """k_left = max_i (i - j_min(i)) clipped at 0 (paper eq. 3 context)."""
    row_nnz = np.diff(indptr)
    rows = np.arange(n)[row_nnz > 0]
    if rows.size == 0:
        return 0
    jmin = indices[indptr[:-1][row_nnz > 0]]
    return int(max(0, np.max(rows - jmin)))


def d0_for_rows(n: int, sigma: int, k_left: int) -> np.ndarray:
    """Base column offset 𝔡_i, uniform within each σ-block (paper eq. 4)."""
    block_start = (np.arange(n) // sigma) * sigma
    return np.maximum(block_start - k_left, 0).astype(np.int64)


def dummies_for_deltas(deltas: np.ndarray, D: int) -> np.ndarray:
    """Dummy words required ahead of each element (int64[nnz]).

    A delta that fits the ``D``-bit flag=1 field needs none. A larger delta
    is carried by a *chain* of flag=0 dummy words, each holding at most
    :data:`MAX_DUMMY_DELTA` (31 bits) — one dummy for any matrix with
    m < 2^31, more only for column gaps beyond that.
    """
    deltas = np.asarray(deltas, dtype=np.int64)
    big = deltas >= (1 << D)
    out = np.zeros(len(deltas), dtype=np.int64)
    out[big] = -(-deltas[big] // MAX_DUMMY_DELTA)  # ceil-div, >= 1
    return out


def encode_rows(indptr: np.ndarray, indices: np.ndarray, d0: np.ndarray,
                D: int):
    """Compute per-element deltas and dummy-element placement.

    Returns
    -------
    deltas : int64[nnz]    delta of each real element (vs predecessor / 𝔡_i)
    n_dummies : int64[nnz] dummy words chained before this element (0 when
                           the delta fits ``D`` bits; truthiness/sum match
                           the old boolean ``needs_dummy`` return)
    stored_len : int64[n]  stored words per row = nnz + dummies
    """
    n = len(indptr) - 1
    nnz = len(indices)
    row_nnz = np.diff(indptr)

    prev = np.empty(nnz, dtype=np.int64)
    prev[1:] = indices[:-1]
    starts = indptr[:-1][row_nnz > 0]
    prev[starts] = d0[np.arange(n)[row_nnz > 0]]

    deltas = indices.astype(np.int64) - prev
    if np.any(deltas < 0):
        bad = np.nonzero(deltas < 0)[0][0]
        raise ValueError(
            f"negative delta at element {bad}: columns must be sorted "
            f"ascending per row and d0 must not exceed the first column")

    n_dummies = dummies_for_deltas(deltas, D)
    row_of_elem = np.repeat(np.arange(n), row_nnz)
    dummy_per_row = np.bincount(row_of_elem, weights=n_dummies,
                                minlength=n).astype(np.int64)
    stored_len = row_nnz.astype(np.int64) + dummy_per_row
    return deltas, n_dummies, stored_len


def emit_word_stream(values: np.ndarray, deltas: np.ndarray,
                     n_dummies: np.ndarray):
    """Expand (value, delta) elements into the stored word stream.

    Elements with a large delta become 1 + n_dummies[k] entries: a chain of
    dummies carrying the delta (flag=0, each at most 31 bits) followed by
    the real element with delta 0 (flag=1) (paper §4.3). ``n_dummies``
    accepts the old boolean ``needs_dummy`` array too (cast to counts).

    Returns (w_values f32, w_deltas int64, w_flags uint8, elem_out_pos int64,
    n_words) where elem_out_pos[k] is the stream position of real element k.
    """
    nnz = len(deltas)
    extra = n_dummies.astype(np.int64)
    # position of each real element in the expanded stream
    elem_pos = np.arange(nnz, dtype=np.int64) + np.cumsum(extra)
    n_words = int(nnz + extra.sum())

    w_values = np.zeros(n_words, dtype=np.float32)
    w_deltas = np.zeros(n_words, dtype=np.int64)
    w_flags = np.zeros(n_words, dtype=np.uint8)

    # real elements
    w_values[elem_pos] = values
    w_flags[elem_pos] = 1
    w_deltas[elem_pos] = np.where(extra > 0, 0, deltas)

    # dummy chains sit immediately before their element: the first e-1 links
    # carry MAX_DUMMY_DELTA each, the last carries the remainder
    big = extra > 0
    if np.any(big):
        e = extra[big]                          # chain length per big elem
        total = int(e.sum())
        # link index 0..e-1 within each chain
        link = np.arange(total, dtype=np.int64) - \
            np.repeat(np.cumsum(e) - e, e)
        pos = np.repeat(elem_pos[big] - e, e) + link
        d_big = np.repeat(deltas[big], e)
        e_rep = np.repeat(e, e)
        w_deltas[pos] = np.where(
            link < e_rep - 1, MAX_DUMMY_DELTA,
            d_big - MAX_DUMMY_DELTA * (e_rep - 1))
    # (w_flags, w_values already 0 at dummy positions)
    return w_values, w_deltas, w_flags, elem_pos, n_words
