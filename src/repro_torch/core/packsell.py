"""The PackSELL sparse matrix format (paper §4) on PyTorch tensors.

The layout is that of ``repro.core.packsell``, leaf for leaf: rows are
σ-sorted (descending stored length, stable) within blocks of σ rows, then
grouped into slices of C consecutive stored rows, and slices are grouped
into width buckets so each bucket is a dense ``[S, w, C]`` word tensor
padded with ``flag=0, delta=0`` words. Words are int32 bit patterns (see
:mod:`repro_torch.core.codecs`).

The matvec here is the plain scan body (cursor = prefix sum of the word
deltas); the hot path is the plan engine's fused stream
(:mod:`repro_torch.kernels.plan`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .. import _device
from . import codecs as cd
from . import delta as de

PAD_WORD = np.uint32(0)  # flag=0, delta=0: contributes v=0, cursor unchanged

#: width chunk of the scan decode (bounds the [S, chunk, C] intermediates)
_SCAN_CHUNK = 128
#: XLA's CPU compiler splits a reduction longer than this into windows of
#: this many elements (its tree-reduction rewrite), each summed from 0
_XLA_BLOCK = 32


def _ceil_to(x: int, q: int) -> int:
    return (x + q - 1) // q * q


def _cumsum0(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + 1, dtype=np.int64)
    np.cumsum(a, out=out[1:])
    return out


@dataclasses.dataclass
class PackSELLMatrix:
    """PackSELL matrix: tensor leaves on one device + static metadata."""

    packs: tuple          # tuple of int32[S_b, w_b, C]  (uint32 word bits)
    d0s: tuple            # tuple of int32[S_b]      base column per slice
    outrows: tuple        # tuple of int32[S_b * C]  stored row -> orig row (n == drop)
    maxcols: tuple        # tuple of int32[S_b]      max column per slice
    perm: torch.Tensor    # uint8/uint16[n_padded]   σ-local perm (paper-faithful)

    n: int
    m: int
    C: int
    sigma: int
    D: int
    codec_name: str
    k_left: int
    nnz: int
    n_dummy: int
    words_sell_padded: int   # words if padded per-slice (paper layout)
    words_bucketed: int      # words actually stored (bucket layout)

    STATIC = ("n", "m", "C", "sigma", "D", "codec_name", "k_left", "nnz",
              "n_dummy", "words_sell_padded", "words_bucketed")

    @property
    def codec(self) -> cd.Codec:
        return cd.make_codec(self.codec_name)

    @property
    def shape(self):
        return (self.n, self.m)

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def memory_stats(self) -> dict:
        n_slices = sum(int(p.shape[0]) for p in self.packs)
        perm_bytes = self.perm.numel() * self.perm.element_size()
        pack_bytes = 4 * self.words_sell_padded
        offset_bytes = 4 * (n_slices + 1)
        packsell = pack_bytes + offset_bytes + perm_bytes
        bucket_overhead = 4 * (self.words_bucketed - self.words_sell_padded)
        return dict(
            packsell_bytes=packsell,
            bucket_overhead_bytes=bucket_overhead,
            pack_bytes=pack_bytes,
            perm_bytes=perm_bytes,
            offset_bytes=offset_bytes,
            nnz=self.nnz,
            n_dummy=self.n_dummy,
            words_sell_padded=self.words_sell_padded,
            words_bucketed=self.words_bucketed,
        )

    def validate(self, *, raise_: bool = True) -> list:
        """Structural integrity check (``robust.guard.validate_matrix``):
        offset/outrow lengths and ranges, finite packed values, decoded
        column bounds, outrow bijectivity. Returns the list of problem
        strings (empty when clean); raises ``IntegrityError`` instead when
        ``raise_`` is set."""
        from ..robust import guard as _guard
        return _guard.validate_matrix(self, raise_=raise_)


# ---------------------------------------------------------------------------
# Plain SpMV / SpMM bodies (scan and loop decode)
# ---------------------------------------------------------------------------


def _bucket_spmv_scan(pack, d0, xc, codec, D, mlim):
    """One bucket's stored-row outputs [S, C] (or [S, C, nb] for a 2-D
    ``xc``): per width chunk, one prefix sum of the deltas, one gather and
    one reduction over the width axis. The reduction adds in the order of
    the reference's ``jnp.sum`` over that axis on the CPU, so the two agree
    bit for bit: blocks of :data:`_XLA_BLOCK` products, each added in j
    order from 0, then the block sums in order from 0."""
    S, w, C = pack.shape
    tail = tuple(xc.shape[1:])
    carry = d0.to(torch.int64)[:, None].expand(S, C)
    t = torch.zeros((S, C) + tail, dtype=torch.float32, device=xc.device)
    for j0 in range(0, w, _SCAN_CHUNK):
        v, d = cd.unpack_words_torch(pack[:, j0:j0 + _SCAN_CHUNK, :], codec,
                                     D)
        cols = carry[:, None, :] + torch.cumsum(d, dim=1)
        xv = xc[cols.clamp(0, mlim).reshape(-1)].reshape(cols.shape + tail)
        v = v.to(torch.float32).reshape(v.shape + (1,) * len(tail))
        prod = v * xv
        part = torch.zeros_like(t)
        for b0 in range(0, prod.shape[1], _XLA_BLOCK):
            blk = torch.zeros_like(t)
            for j in range(b0, min(b0 + _XLA_BLOCK, prod.shape[1])):
                blk = blk + prod[:, j]
            part = part + blk
        t = t + part
        carry = cols[:, -1, :]
    return t


def _bucket_spmv_loop(pack, d0, xc, codec, D, mlim):
    """One bucket's stored-row outputs [S, C] (or [S, C, nb] for a 2-D
    ``xc``) by the sequential word walk, the paper's per-word recurrence:
    for each word, ``c += d``, gather x at ``min(c, m-1)``, ``t += v·x``."""
    S, w, C = pack.shape
    tail = tuple(xc.shape[1:])
    c = d0.to(torch.int64)[:, None].expand(S, C)
    t = torch.zeros((S, C) + tail, dtype=torch.float32, device=xc.device)
    for j in range(w):
        v, d = cd.unpack_words_torch(pack[:, j, :], codec, D)
        c = c + d
        xv = xc[c.clamp(0, mlim).reshape(-1)].reshape((S, C) + tail)
        t = t + v.to(torch.float32).reshape(v.shape + (1,) * len(tail)) * xv
    return t


#: the bodies ``decode=`` selects; an unknown name raises ``KeyError``, as
#: the reference's dict lookup does
_BODIES = {"scan": _bucket_spmv_scan, "loop": _bucket_spmv_loop}


def _scatter_rows(n: int, parts, outrows, tail, device,
                  dtype=torch.float32) -> torch.Tensor:
    """y[outrow[k]] = t[k], sentinel rows (>= n) dropped."""
    y = torch.zeros((n,) + tail, dtype=dtype, device=device)
    for t, outrow in zip(parts, outrows):
        o = outrow.to(torch.int64)
        keep = o < n
        y[o[keep]] = t.reshape((-1,) + tail)[keep]
    return y


def packsell_spmv_torch(mat: PackSELLMatrix, x: torch.Tensor,
                        decode: str = "scan") -> torch.Tensor:
    """y = A @ x over the bucketed layout (paper §4.4), float32. Padding
    and dummy words decode to v = 0, so nothing is masked.
    ``decode="scan"`` decodes the column cursors by prefix sums over width
    chunks; ``"loop"`` walks the words one at a time (the reference's
    oracle and benchmark baseline)."""
    body = _BODIES[decode]
    codec, mlim = mat.codec, max(mat.m - 1, 0)
    xc = _nonempty(x.to(torch.float32))
    parts = [body(p, d0, xc, codec, mat.D, mlim)
             for p, d0 in zip(mat.packs, mat.d0s)]
    return _scatter_rows(mat.n, parts, mat.outrows, (), x.device)


def packsell_spmm_torch(mat: PackSELLMatrix, x: torch.Tensor,
                        decode: str = "scan") -> torch.Tensor:
    """Y = A @ X for X: [m, nb]: one pass over the words for all nb
    right-hand sides; ``decode`` as :func:`packsell_spmv_torch`."""
    body = _BODIES[decode]
    codec, mlim = mat.codec, max(mat.m - 1, 0)
    xc = _nonempty(x.to(torch.float32))
    parts = [body(p, d0, xc, codec, mat.D, mlim)
             for p, d0 in zip(mat.packs, mat.d0s)]
    return _scatter_rows(mat.n, parts, mat.outrows, (x.shape[1],), x.device)


def _nonempty(xc: torch.Tensor) -> torch.Tensor:
    """A zero row stands in for an empty x (m == 0), so the clamped
    gathers of padding words stay in bounds and read 0."""
    if xc.shape[0]:
        return xc
    return torch.zeros((1,) + tuple(xc.shape[1:]), dtype=xc.dtype,
                       device=xc.device)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def _sigma_sort(stored_len: np.ndarray, n: int, sigma: int, C: int):
    """σ-block stable descending sort. Returns (outrow, perm_local).

    outrow[stored_idx] = original row (len n_padded, sentinel n for padding
    rows); perm_local[stored_idx] = original index within the σ-block.
    """
    n_padded = _ceil_to(max(n, 1), C)
    outrow = np.full(n_padded, n, dtype=np.int64)
    for b0 in range(0, n, sigma):
        b1 = min(b0 + sigma, n)
        order = np.argsort(-stored_len[b0:b1], kind="stable")
        outrow[b0:b1] = b0 + order
    perm_dtype = np.uint8 if sigma <= 256 else np.uint16
    perm_local = (outrow[:n] - (np.arange(n) // sigma) * sigma).astype(perm_dtype)
    pad_perm = np.zeros(n_padded - n, dtype=perm_dtype)
    return outrow, np.concatenate([perm_local, pad_perm])


def _bucket_slices(widths: np.ndarray, strategy: str):
    """Group slice ids into width buckets.

    'pow2'    : bucket width = next power of two (small, bounded padding)
    'uniform' : a single bucket at max width (simplest kernels)
    'exact'   : one bucket per distinct width (zero bucket padding)
    """
    S = len(widths)
    if S == 0:
        return []
    if strategy == "uniform":
        wmax = int(widths.max())
        return [(np.arange(S), max(wmax, 1))]
    if strategy == "pow2":
        keys = np.where(widths <= 1, 1,
                        2 ** np.ceil(np.log2(np.maximum(widths, 1))).astype(np.int64))
    elif strategy == "exact":
        keys = np.maximum(widths, 1)
    else:
        raise ValueError(strategy)
    out = []
    for k in np.unique(keys):
        ids = np.nonzero(keys == k)[0]
        out.append((ids, int(k)))
    return out


def from_csr(a: sp.csr_matrix, *, C: int = 128, sigma: int = 256, D: int = 15,
             codec: str = "fp16", bucket_strategy: str = "pow2",
             device=None) -> PackSELLMatrix:
    """Build a PackSELL matrix from a scipy CSR matrix (host numpy, then
    one copy of each leaf to ``device``; ``None`` means the GPU)."""
    dev = _device.resolve_device(device)
    if sigma % C != 0:
        raise ValueError(f"sigma ({sigma}) must be a multiple of C ({C})")
    a = a.tocsr()
    a.sort_indices()
    n, m = a.shape
    indptr = a.indptr.astype(np.int64)
    indices = a.indices.astype(np.int64)
    if a.nnz and not np.all(np.isfinite(a.data)):
        bad = int(np.count_nonzero(~np.isfinite(a.data)))
        raise ValueError(
            f"from_csr: input has {bad} non-finite (NaN/Inf) values; "
            "packed codecs cannot represent them")
    if a.nnz and (indices.min() < 0 or indices.max() >= m):
        raise ValueError(
            f"from_csr: column indices outside [0, {m}) "
            f"(min {int(indices.min())}, max {int(indices.max())})")
    values = a.data.astype(np.float32)
    codec_obj = cd.make_codec(codec)
    if not (codec_obj.min_D <= D <= codec_obj.max_D):
        raise ValueError(f"D={D} outside [{codec_obj.min_D},{codec_obj.max_D}] "
                         f"for codec {codec}")

    k_left = de.lower_bandwidth(indptr, indices, n)
    d0_row = de.d0_for_rows(n, sigma, k_left)
    deltas, n_dummies, stored_len = de.encode_rows(indptr, indices, d0_row, D)
    w_values, w_deltas, w_flags, _, n_words = de.emit_word_stream(
        values, deltas, n_dummies)
    words = cd.pack_words_np(w_values, w_deltas, w_flags, codec_obj, D)
    row_word_start = _cumsum0(stored_len)

    outrow, perm = _sigma_sort(stored_len, n, sigma, C)
    n_padded = len(outrow)
    S = n_padded // C

    stored_len_padded = np.zeros(n_padded, dtype=np.int64)
    valid = outrow < n
    stored_len_padded[valid] = stored_len[outrow[valid]]
    slice_width = stored_len_padded.reshape(S, C).max(axis=1)
    words_sell_padded = int((slice_width * C).sum())

    d0_slice = np.maximum((np.arange(S) * C // sigma) * sigma - k_left, 0)

    # per-row last column (band-window metadata); empty rows -> d0
    lastcol_row = d0_row.copy()
    nz_rows = np.diff(indptr) > 0
    lastcol_row[nz_rows] = indices[indptr[1:][nz_rows] - 1]
    lastcol_padded = np.zeros(n_padded, dtype=np.int64)
    lastcol_padded[valid] = lastcol_row[outrow[valid]]
    maxcol_slice = lastcol_padded.reshape(S, C).max(axis=1)

    buckets = _bucket_slices(slice_width, bucket_strategy)
    packs, d0s, outrows, maxcols_l = [], [], [], []
    words_bucketed = 0
    # guard row for the gather below (padding rows index word 0 harmlessly)
    words_g = words if n_words > 0 else np.zeros(1, dtype=np.uint32)
    for slice_ids, w_b in buckets:
        rows = (slice_ids[:, None] * C + np.arange(C)[None, :]).reshape(-1)
        orig = outrow[rows]                         # [S_b*C]
        lens = stored_len_padded[rows]              # [S_b*C]
        starts = np.where(orig < n, row_word_start[np.minimum(orig, n - 1)], 0)
        j = np.arange(w_b, dtype=np.int64)
        idx = starts[:, None] + j[None, :]          # [S_b*C, w_b]
        ok = j[None, :] < lens[:, None]
        gathered = np.where(ok, words_g[np.minimum(idx, len(words_g) - 1)],
                            PAD_WORD)
        pack3d = gathered.reshape(len(slice_ids), C, w_b).transpose(0, 2, 1)
        packs.append(np.ascontiguousarray(pack3d.astype(np.uint32)))
        d0s.append(d0_slice[slice_ids].astype(np.int32))
        outrows.append(np.where(orig < n, orig, n).astype(np.int32))
        maxcols_l.append(maxcol_slice[slice_ids].astype(np.int32))
        words_bucketed += pack3d.size

    meta = dict(n=n, m=m, C=C, sigma=sigma, D=D, codec_name=codec,
                k_left=k_left, nnz=int(a.nnz), n_dummy=int(n_dummies.sum()),
                words_sell_padded=words_sell_padded,
                words_bucketed=int(words_bucketed))
    return from_arrays((packs, d0s, outrows, maxcols_l, perm), meta,
                       device=dev)


def from_arrays(leaves, meta: dict, *, device=None) -> PackSELLMatrix:
    """A matrix from host arrays: ``leaves = (packs, d0s, outrows, maxcols,
    perm)`` as numpy (``packs`` uint32 words) and ``meta`` the static fields
    by name. It takes the leaves of a ``repro.core.packsell`` matrix
    (``np.asarray`` of each) unchanged, which is how the parameters of a
    reference matrix carry over to the port."""
    dev = _device.resolve_device(device)
    packs, d0s, outrows, maxcols, perm = leaves

    def i32(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    return PackSELLMatrix(
        packs=tuple(cd.words_to_torch(p, dev) for p in packs),
        d0s=tuple(i32(d) for d in d0s),
        outrows=tuple(i32(o) for o in outrows),
        maxcols=tuple(i32(mc) for mc in maxcols),
        perm=torch.from_numpy(np.array(perm)).to(dev),
        **{k: meta[k] for k in PackSELLMatrix.STATIC})


def from_dense(a: np.ndarray, **kw) -> PackSELLMatrix:
    """A PackSELL matrix from a dense 2-D array (its nonzeros), with the
    words of :func:`from_csr`."""
    a = np.asarray(a)
    if a.ndim != 2:
        raise ValueError(f"from_dense: expected a 2-D array, got shape "
                         f"{a.shape}")
    if not np.all(np.isfinite(a)):
        bad = int(np.count_nonzero(~np.isfinite(a)))
        raise ValueError(
            f"from_dense: input has {bad} non-finite (NaN/Inf) values; "
            "packed codecs cannot represent them")
    return from_csr(sp.csr_matrix(a), **kw)


# ---------------------------------------------------------------------------
# Per-partition build hooks (the distributed layer)
# ---------------------------------------------------------------------------


def pad_uniform(mat: PackSELLMatrix, *, n_slices: int | None = None,
                width: int | None = None, n_rows: int | None = None,
                device: bool = True) -> PackSELLMatrix:
    """Pad a single-bucket ('uniform') matrix to a common [S, w, C] shape.

    The distributed partitioner σ-sorts and builds each shard's block
    independently, which leaves every shard with different slice counts
    and widths; the shards' blocks are stacked along a shard axis, so each
    is padded here to the fleet-wide maxima: extra words are ``PAD_WORD``
    (flag=0, delta=0 → contribute nothing), extra slices get sentinel
    outrows, and ``n`` grows to ``n_rows`` with the old sentinel value
    remapped so padding rows stay dead. Every padding row gets a stored
    slot of its own, carved out of the all-PAD sentinel slots, so it reads
    exactly 0 through the plan engine's inverse-permutation gather too.
    The words, ``d0s``, outrows and maxcols are the reference's byte for
    byte. ``device=False`` keeps the result on the host (CPU), else it
    lands on the matrix's own device.
    """
    if len(mat.packs) != 1:
        raise ValueError("pad_uniform needs a single-bucket matrix "
                         "(build with bucket_strategy='uniform')")
    pack = cd.words_to_numpy(mat.packs[0])
    d0 = mat.d0s[0].cpu().numpy()
    outrow = mat.outrows[0].cpu().numpy()
    maxcol = mat.maxcols[0].cpu().numpy()
    perm = mat.perm.cpu().numpy()
    S, w, C = pack.shape
    S_t = S if n_slices is None else int(n_slices)
    w_t = w if width is None else int(width)
    n_t = mat.n if n_rows is None else int(n_rows)
    if S_t < S or w_t < w or n_t < mat.n:
        raise ValueError(f"cannot shrink: have (S={S}, w={w}, n={mat.n}), "
                         f"asked (S={S_t}, w={w_t}, n={n_t})")
    if S_t * C < n_t:
        raise ValueError(f"S={S_t} slices of C={C} cannot hold n={n_t} rows")

    pack_p = np.full((S_t, w_t, C), PAD_WORD, dtype=np.uint32)
    pack_p[:S, :w, :] = pack
    d0_p = np.zeros(S_t, np.int32)
    d0_p[:S] = d0
    maxcol_p = np.zeros(S_t, np.int32)
    maxcol_p[:S] = maxcol
    # remap the old padding sentinel (== mat.n) to the new one (== n_t)
    outrow_p = np.full(S_t * C, n_t, np.int32)
    outrow_p[:S * C] = np.where(outrow >= mat.n, n_t, outrow)
    sentinel = np.nonzero(outrow_p >= n_t)[0]
    extra = n_t - mat.n
    outrow_p[sentinel[:extra]] = mat.n + np.arange(extra, dtype=np.int32)
    perm_p = np.zeros(S_t * C, perm.dtype)
    perm_p[:len(perm)] = perm

    meta = {k: getattr(mat, k) for k in PackSELLMatrix.STATIC}
    meta.update(n=n_t, words_bucketed=int(pack_p.size))
    return from_arrays(((pack_p,), (d0_p,), (outrow_p,), (maxcol_p,),
                        perm_p), meta,
                       device=mat.device if device else torch.device("cpu"))


def aggregate_memory_stats(mats) -> dict:
    """Fleet-level :meth:`PackSELLMatrix.memory_stats`: per-shard sums plus
    the max/min shard footprint (load-balance signal for the partitioner)."""
    stats = [m.memory_stats() for m in mats]
    agg = {k: sum(s[k] for s in stats) for k in stats[0]} if stats else {}
    per_shard = [s["packsell_bytes"] for s in stats]
    agg["shards"] = len(stats)
    agg["max_shard_bytes"] = max(per_shard) if per_shard else 0
    agg["min_shard_bytes"] = min(per_shard) if per_shard else 0
    return agg


# ---------------------------------------------------------------------------
# Host-side decode (oracle for tests)
# ---------------------------------------------------------------------------


def decode_to_dense(mat: PackSELLMatrix) -> np.ndarray:
    """Reconstruct the (quantized) dense matrix by walking the packed words."""
    codec = mat.codec
    out = np.zeros((mat.n, mat.m), dtype=np.float64)
    for pack, d0, outrow in zip(mat.packs, mat.d0s, mat.outrows):
        pack = cd.words_to_numpy(pack)
        d0 = d0.cpu().numpy()
        outrow = outrow.cpu().numpy()
        S, w, C = pack.shape
        v, d, flag = cd.unpack_words_np(pack.reshape(-1), codec, mat.D)
        v = v.astype(np.float64).reshape(S, w, C)
        d = d.astype(np.int64).reshape(S, w, C)
        flag = flag.reshape(S, w, C)
        cols = d0[:, None, None] + np.cumsum(d, axis=1)
        rows = outrow.reshape(S, C)
        for s in range(S):
            for l in range(C):
                r = rows[s, l]
                if r >= mat.n:
                    continue
                sel = flag[s, :, l] == 1
                out[r, cols[s, sel, l]] += v[s, sel, l]
    return out
