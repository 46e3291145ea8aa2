"""SELL-C-σ baseline format (paper §3), the comparison target for PackSELL.

The bucket layout mirrors PackSELL's so kernel comparisons isolate the
*format* difference (separate val/col arrays vs one packed word array).
Leaves are those of ``repro.core.sell``, byte for byte.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .. import _device
from .packsell import _bucket_slices, _cumsum0, _nonempty, _sigma_sort

#: value dtypes the format stores (names as in the reference)
VALUE_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                "float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class SELLMatrix:
    vals: tuple       # tuple of dtype[S_b, w_b, C]
    cols: tuple       # tuple of int32[S_b, w_b, C]   (padding -> col 0, val 0)
    outrows: tuple    # tuple of int32[S_b * C]
    perm: torch.Tensor
    slot: torch.Tensor  # int32[n]: the stored row of each row, in cat order

    n: int
    m: int
    C: int
    sigma: int
    value_dtype: str
    nnz: int
    words_sell_padded: int
    words_bucketed: int

    STATIC = ("n", "m", "C", "sigma", "value_dtype", "nnz",
              "words_sell_padded", "words_bucketed")

    @property
    def shape(self):
        return (self.n, self.m)

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def memory_stats(self) -> dict:
        vb = VALUE_DTYPES[self.value_dtype].itemsize
        n_slices = sum(int(v.shape[0]) for v in self.vals)
        perm_bytes = self.perm.numel() * self.perm.element_size()
        sell = (vb + 4) * self.words_sell_padded + 4 * (n_slices + 1) + perm_bytes
        return dict(sell_bytes=sell, value_bytes=vb,
                    words_sell_padded=self.words_sell_padded,
                    words_bucketed=self.words_bucketed)


def sell_bucket_spmv(val: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """One bucket's stored-row outputs ``y[s, c] = Σ_j cd(val[s,j,c]) ·
    cd(x)[min(col[s,j,c], m-1)]`` in the compute dtype ``cd`` (float32, or
    float64 for the fp64 operator), added in j order from 0. SELL columns
    are < m by construction (padding has col 0), so the clamp never moves
    a read."""
    S, w, C = val.shape
    xc = _nonempty(x.to(compute_dtype))
    col = col.long().clamp(0, xc.shape[0] - 1)
    prod = val.to(compute_dtype) * xc[col]       # every product at once
    t = torch.zeros((S, C), dtype=compute_dtype, device=x.device)
    for j in range(w):
        t = t + prod[:, j, :]
    return t


def gather_rows(mat: SELLMatrix, parts, dtype) -> torch.Tensor:
    """y[r] = the stored row of r among the buckets' outputs ``parts``
    (each ``[S_b, C]``), by the precomputed ``mat.slot``: one ``cat`` and
    one gather, with no mask and no host sync. Every row is stored exactly
    once, so this equals the scatter by ``outrows``; σ-padding rows are
    never read."""
    if not parts:
        return torch.zeros((mat.n,), dtype=dtype, device=mat.device)
    flat = [t.reshape(-1) for t in parts]
    t_cat = flat[0] if len(flat) == 1 else torch.cat(flat)
    return torch.index_select(t_cat, 0, mat.slot)


def sell_spmv(mat: SELLMatrix, x: torch.Tensor,
              compute_dtype=torch.float32) -> torch.Tensor:
    """y = A @ x over SELL (paper §3) with the plain bucket body, in
    ``compute_dtype`` (the reference's ``sell_spmv_jnp``);
    ``repro_torch.kernels.ops.sell_spmv`` runs the kernel instead."""
    parts = [sell_bucket_spmv(v, c, x, compute_dtype)
             for v, c in zip(mat.vals, mat.cols)]
    return gather_rows(mat, parts, compute_dtype)


def _row_slots(outrows, n: int) -> torch.Tensor:
    """int32[n]: the position of row r in the concatenated ``outrows``
    (sentinel rows, >= n, are skipped). Raises unless every row is stored
    exactly once."""
    cat = (np.concatenate([np.asarray(o, np.int64).reshape(-1)
                           for o in outrows]) if len(outrows)
           else np.zeros((0,), np.int64))
    real = np.nonzero(cat < n)[0]
    if len(real) != n or np.bincount(cat[real], minlength=n).max(
            initial=1) != 1:
        raise ValueError("SELL outrows must store every row exactly once")
    slot = np.zeros(n, np.int32)
    slot[cat[real]] = real.astype(np.int32)
    return torch.from_numpy(slot)


def _values_to_torch(v: np.ndarray, value_dtype: str) -> torch.Tensor:
    """float64 values → the stored dtype. numpy rounds float64 straight to
    float16 as the reference does; bfloat16 (which numpy lacks) goes
    float64 → float32 → bfloat16, as the reference's bfloat16 cast does."""
    if value_dtype == "bfloat16":
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(v.astype(value_dtype))


def from_csr(a: sp.csr_matrix, *, C: int = 128, sigma: int = 256,
             value_dtype: str = "float32", bucket_strategy: str = "pow2",
             device=None) -> SELLMatrix:
    dev = _device.resolve_device(device)
    if value_dtype not in VALUE_DTYPES:
        raise ValueError(f"value_dtype={value_dtype!r} not in "
                         f"{tuple(VALUE_DTYPES)}")
    if sigma % C != 0:
        raise ValueError("sigma must be a multiple of C")
    a = a.tocsr()
    a.sort_indices()
    n, m = a.shape
    indptr = a.indptr.astype(np.int64)
    indices = a.indices.astype(np.int64)
    # keep full precision here; cast happens once into value_dtype below
    values = a.data.astype(np.float64)
    row_nnz = np.diff(indptr).astype(np.int64)
    row_word_start = _cumsum0(row_nnz)

    outrow, perm = _sigma_sort(row_nnz, n, sigma, C)
    n_padded = len(outrow)
    S = n_padded // C
    lens_padded = np.zeros(n_padded, dtype=np.int64)
    valid = outrow < n
    lens_padded[valid] = row_nnz[outrow[valid]]
    slice_width = lens_padded.reshape(S, C).max(axis=1)
    words_sell_padded = int((slice_width * C).sum())

    buckets = _bucket_slices(slice_width, bucket_strategy)
    vals, cols, outrows = [], [], []
    words_bucketed = 0
    vals_g = values if a.nnz else np.zeros(1, np.float64)
    inds_g = indices if a.nnz else np.zeros(1, np.int64)
    for slice_ids, w_b in buckets:
        rows = (slice_ids[:, None] * C + np.arange(C)[None, :]).reshape(-1)
        orig = outrow[rows]
        lens = lens_padded[rows]
        starts = np.where(orig < n, row_word_start[np.minimum(orig, n - 1)], 0)
        j = np.arange(w_b, dtype=np.int64)
        idx = np.minimum(starts[:, None] + j[None, :], len(vals_g) - 1)
        ok = j[None, :] < lens[:, None]
        v = np.where(ok, vals_g[idx], 0.0)
        c = np.where(ok, inds_g[idx], 0).astype(np.int32)
        Sb = len(slice_ids)
        vals.append(np.ascontiguousarray(v.reshape(Sb, C, w_b).transpose(0, 2, 1)))
        cols.append(np.ascontiguousarray(c.reshape(Sb, C, w_b).transpose(0, 2, 1)))
        outrows.append(np.where(orig < n, orig, n).astype(np.int32))
        words_bucketed += v.size

    return SELLMatrix(
        vals=tuple(_values_to_torch(v, value_dtype).to(dev) for v in vals),
        cols=tuple(torch.from_numpy(c).to(dev) for c in cols),
        outrows=tuple(torch.from_numpy(o).to(dev) for o in outrows),
        perm=torch.from_numpy(perm).to(dev),
        slot=_row_slots(outrows, n).to(dev),
        n=n, m=m, C=C, sigma=sigma, value_dtype=value_dtype, nnz=int(a.nnz),
        words_sell_padded=words_sell_padded, words_bucketed=int(words_bucketed),
    )


def from_dense(a: np.ndarray, **kw) -> SELLMatrix:
    """A SELL matrix from a dense 2-D array (its nonzeros)."""
    return from_csr(sp.csr_matrix(np.asarray(a)), **kw)


def pad_uniform(mat: SELLMatrix, *, n_slices: int | None = None,
                width: int | None = None,
                device: bool = True) -> SELLMatrix:
    """Pad a single-bucket ('uniform') SELL matrix to a common [S, w, C]
    shape: the fp32/fp64 twin of
    :func:`repro_torch.core.packsell.pad_uniform`, used by the distributed
    composite to stack uncompressed members across shards. Padding entries
    carry ``val=0, col=0`` (a harmless read that contributes nothing);
    padded slices get sentinel outrows (>= n). ``device``: as there."""
    if len(mat.vals) != 1:
        raise ValueError("pad_uniform needs a single-bucket matrix "
                         "(build with bucket_strategy='uniform')")
    val = mat.vals[0].cpu()
    col = mat.cols[0].cpu()
    outrow = mat.outrows[0].cpu().numpy()
    perm = mat.perm.cpu().numpy()
    S, w, C = val.shape
    S_t = S if n_slices is None else int(n_slices)
    w_t = w if width is None else int(width)
    if S_t < S or w_t < w:
        raise ValueError(f"cannot shrink: have (S={S}, w={w}), "
                         f"asked (S={S_t}, w={w_t})")
    val_p = torch.zeros((S_t, w_t, C), dtype=val.dtype)
    val_p[:S, :w, :] = val
    col_p = torch.zeros((S_t, w_t, C), dtype=torch.int32)
    col_p[:S, :w, :] = col
    outrow_p = np.full(S_t * C, mat.n, np.int32)
    outrow_p[:S * C] = outrow
    perm_p = np.zeros(S_t * C, perm.dtype)
    perm_p[:len(perm)] = perm
    dev = mat.device if device else torch.device("cpu")
    return SELLMatrix(
        vals=(val_p.to(dev),), cols=(col_p.to(dev),),
        outrows=(torch.from_numpy(outrow_p).to(dev),),
        perm=torch.from_numpy(perm_p).to(dev),
        slot=_row_slots((outrow_p,), mat.n).to(dev),
        n=mat.n, m=mat.m, C=C, sigma=mat.sigma, value_dtype=mat.value_dtype,
        nnz=mat.nnz, words_sell_padded=mat.words_sell_padded,
        words_bucketed=int(val_p.numel()))


def from_arrays(leaves, meta: dict, *, device=None) -> SELLMatrix:
    """A SELL matrix from host arrays: ``leaves = (vals, cols, outrows,
    perm)`` as numpy and ``meta`` the static fields by name: the leaves of
    a ``repro.core.sell`` matrix carry over unchanged. bfloat16 values
    arrive as the reference's 2-byte arrays and keep their bits."""
    dev = _device.resolve_device(device)
    vals, cols, outrows, perm = leaves
    vdt = VALUE_DTYPES[meta["value_dtype"]]

    def values(v):
        v = np.ascontiguousarray(v)
        if vdt == torch.bfloat16:
            return torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(v.copy()).to(dev)

    return SELLMatrix(
        vals=tuple(values(v) for v in vals),
        cols=tuple(torch.from_numpy(np.array(c, np.int32)).to(dev)
                   for c in cols),
        outrows=tuple(torch.from_numpy(np.array(o, np.int32)).to(dev)
                      for o in outrows),
        perm=torch.from_numpy(np.array(perm)).to(dev),
        slot=_row_slots(outrows, meta["n"]).to(dev),
        **{k: meta[k] for k in SELLMatrix.STATIC})
