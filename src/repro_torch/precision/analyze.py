"""Matrix analysis for codec selection: statistics, error model, probes.

The port of ``repro.precision.analyze`` (numpy and scipy only), built on
``repro_torch.core.codecs`` and ``delta``: the reference's module pulls
JAX in through ``repro.core``.

Three layers, each cheap enough to run at format-construction time:

1. :func:`matrix_stats` — vectorized numpy pass over the CSR stream: value
   dynamic range (global and per row), the delta distribution under the
   paper's σ-block base-offset convention (max |Δcol|, dummy-word counts for
   every candidate ``D``), and row-regularity numbers.
2. :func:`model_error` — the a-priori quantization-error model per codec
   (DESIGN.md §8.1): a relative ulp bound for the float codecs
   (``2^-(Y+1)`` for E8MY, ``2^-11``/``2^-8`` for fp16/bf16 with
   range-clipping penalties where the value range leaves the codec's
   representable range) and an absolute-step bound for ``fixed<F>``.
3. :func:`probe_error` — the empirical validation of the model:
   ``||A_q x − A x|| / ||A x||`` on seeded probe vectors, with ``A_q`` the
   element-wise codec round-trip of ``A`` (quantization is element-wise, so
   the probe needs no PackSELL build; dummy words are exact by
   construction).

:func:`analyze_matrix` bundles all three into an :class:`AnalysisReport`
for a candidate list — the input :mod:`.select` ranks.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import scipy.sparse as sp

from ..core import codecs as cd
from ..core import delta as de

# fp32 exponent range landmarks
_F32_MIN_NORMAL = 2.0 ** -126
_F16_MAX = 65504.0
_F16_MIN_NORMAL = 2.0 ** -14
_F16_MIN_SUBNORMAL = 2.0 ** -24


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    """Host-side value/delta statistics of one CSR matrix."""

    n: int
    m: int
    nnz: int
    k_left: int
    max_abs: float
    min_abs_nz: float           # smallest nonzero magnitude (inf if empty)
    dyn_range: float            # max_abs / min_abs_nz
    has_subnormal: bool         # any |v| below the fp32 normal range
    row_max_abs: np.ndarray     # float64[n]
    row_min_abs_nz: np.ndarray  # float64[n] (inf for empty rows)
    row_nnz: np.ndarray         # int64[n]
    max_delta: int              # largest column delta under the σ-block d0
    deltas_sorted: np.ndarray   # int64[nnz] ascending (dummy counting)
    sigma: int

    def dummy_words(self, D: int) -> int:
        """Dummy words needed at delta width ``D`` (chained for >31-bit
        gaps) — the delta-feasibility cost of a candidate. Delegates the
        chain-length rule to :func:`..core.delta.dummies_for_deltas`
        so pricing can never diverge from what ``from_csr`` emits."""
        return int(de.dummies_for_deltas(self.deltas_sorted, D).sum())

    def words(self, D: int) -> int:
        """Stored words (real + dummy) at delta width ``D``."""
        return self.nnz + self.dummy_words(D)


def matrix_stats(a: sp.csr_matrix, *, sigma: int = 256) -> MatrixStats:
    """One vectorized pass: value-range and delta statistics of ``a``."""
    a = a.tocsr()
    a.sort_indices()
    n, m = a.shape
    data = np.abs(a.data.astype(np.float64))
    indptr = a.indptr.astype(np.int64)
    indices = a.indices.astype(np.int64)
    row_nnz = np.diff(indptr)

    nz = data > 0
    max_abs = float(data.max(initial=0.0))
    min_abs_nz = float(data[nz].min()) if nz.any() else math.inf
    row_max_abs = np.zeros(n)
    row_min_abs_nz = np.full(n, math.inf)
    rows_of = np.repeat(np.arange(n), row_nnz)
    np.maximum.at(row_max_abs, rows_of, data)
    np.minimum.at(row_min_abs_nz, rows_of[nz], data[nz])

    k_left = de.lower_bandwidth(indptr, indices, n)
    d0 = de.d0_for_rows(n, sigma, k_left)
    deltas, _, _ = de.encode_rows(indptr, indices, d0, D=31)
    deltas_sorted = np.sort(deltas)

    return MatrixStats(
        n=n, m=m, nnz=int(a.nnz), k_left=k_left,
        max_abs=max_abs, min_abs_nz=min_abs_nz,
        dyn_range=(max_abs / min_abs_nz if nz.any() and min_abs_nz > 0
                   else 1.0),
        has_subnormal=bool(nz.any() and min_abs_nz < _F32_MIN_NORMAL),
        row_max_abs=row_max_abs, row_min_abs_nz=row_min_abs_nz,
        row_nnz=row_nnz.astype(np.int64),
        max_delta=int(deltas_sorted[-1]) if len(deltas_sorted) else 0,
        deltas_sorted=deltas_sorted, sigma=sigma)


# ---------------------------------------------------------------------------
# A-priori error model (DESIGN.md §8.1)
# ---------------------------------------------------------------------------


def ulp_bound(codec_name: str, D: int) -> float:
    """Stats-free relative RNE half-ulp bound of a codec — the single
    source of the per-codec constants (``model_error`` degrades it with
    range penalties; ``select._tier_err`` orders promotion ladders)."""
    if codec_name == "fp32":
        return 0.0
    if codec_name == "e8m":
        return 2.0 ** -(23 - D)          # Y = 22 - D mantissa bits kept
    if codec_name == "bf16":
        return 2.0 ** -8                 # 7 fraction bits
    if codec_name == "fp16":
        return 2.0 ** -11                # 10 fraction bits
    return math.inf                      # fixed<F>: absolute, not relative


def model_error(codec_name: str, D: int, stats: MatrixStats) -> float:
    """A-priori element-wise relative quantization-error bound.

    Float codecs: the ulp bound of the truncated format, degraded to 1.0
    (no guarantee) when the matrix's value range leaves the codec's normal
    range, and to ``inf`` when values overflow the representable range
    entirely (fp16/fixed clipping). Fixed point: absolute step ``2^-F``
    turned relative via the smallest nonzero magnitude.
    """
    if codec_name == "fp32":
        return 0.0
    if codec_name in ("e8m", "bf16"):
        if stats.has_subnormal:          # mantissa truncation of subnormals
            return 1.0                   # has no relative-error guarantee
        return ulp_bound(codec_name, D)
    if codec_name == "fp16":
        if stats.max_abs > _F16_MAX:
            return math.inf              # overflow clips to inf
        bound = ulp_bound(codec_name, D)
        if stats.min_abs_nz < _F16_MIN_SUBNORMAL:
            return 1.0                   # flushed to zero
        if stats.min_abs_nz < _F16_MIN_NORMAL:
            # subnormal fp16: absolute step 2^-24 relative to the value
            bound = max(bound, _F16_MIN_SUBNORMAL / (2 * stats.min_abs_nz))
        return min(bound, 1.0)
    if codec_name.startswith("fixed"):
        frac = int(codec_name[len("fixed"):])
        V = cd.vbits_for(D)
        if stats.max_abs >= 2.0 ** (V - 1 - frac):
            return math.inf              # range clipping
        step = 2.0 ** -frac
        if not math.isfinite(stats.min_abs_nz):
            return 0.0
        return min(0.5 * step / stats.min_abs_nz, 1.0) if stats.min_abs_nz \
            else 1.0
    raise ValueError(f"unknown codec {codec_name!r}")


# ---------------------------------------------------------------------------
# Empirical probe
# ---------------------------------------------------------------------------


def _quantized(a: sp.csr_matrix, codec_name: str, D: int) -> sp.csr_matrix:
    if codec_name == "fp32":
        aq = a.copy()
        aq.data = a.data.astype(np.float32)
        return aq
    codec = cd.make_codec(codec_name)
    aq = a.copy()
    aq.data = cd.quantize_np(a.data.astype(np.float32), codec, D)
    return aq


def _probe_vectors(m: int, n_probes: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_probes, m))


def _probe_context(a: sp.csr_matrix, n_probes: int, seed: int):
    """Candidate-independent probe precomputation: the float64 matrix,
    the probe vectors, and the reference ``||A x||`` norms — shared by
    every candidate in :func:`analyze_matrix` (one conversion + one
    reference SpMV per probe instead of one per candidate)."""
    a64 = a.astype(np.float64)
    xs = _probe_vectors(a.shape[1], n_probes, seed)
    ax_norms = [max(float(np.linalg.norm(a64 @ x)), 1e-300) for x in xs]
    return a64, xs, ax_norms


def probe_error(a: sp.csr_matrix, codec_name: str, D: int, *,
                n_probes: int = 3, seed: int = 0, _ctx=None) -> float:
    """max over seeded probes of ``||A_q x − A x||₂ / ||A x||₂``."""
    a64, xs, ax_norms = _ctx or _probe_context(a, n_probes, seed)
    e = _quantized(a, codec_name, D).astype(np.float64) - a64
    worst = 0.0
    for x, axn in zip(xs, ax_norms):
        err = float(np.linalg.norm(e @ x)) / axn
        if not np.isfinite(err):
            # range overflow quantizes to ±inf, so e @ x is inf/nan —
            # and max(0.0, nan) would silently report a PERFECT probe;
            # an out-of-range codec certifies nothing
            return float("inf")
        worst = max(worst, err)
    return worst


def row_error_bound(a: sp.csr_matrix, codec_name: str, D: int) -> np.ndarray:
    """Deterministic per-row relative error bound (float64[n]).

    ``max_j |q(a_ij) − a_ij| / |a_ij|`` per row: since
    ``|(A_q − A) x|_i ≤ max_j(|E_ij|/|A_ij|) · (|A| |x|)_i`` for EVERY x,
    this bounds the row-wise probe error of any probe vector — the
    guarantee per-row-class selection needs (a sampled probe would only
    bound the sampled x's)."""
    a = a.tocsr()
    e = np.abs(_quantized(a, codec_name, D).data.astype(np.float64)
               - a.data.astype(np.float64))
    da = np.abs(a.data.astype(np.float64))
    ratio = np.where(da > 0, e / np.maximum(da, 1e-300), 0.0)
    out = np.zeros(a.shape[0])
    rows_of = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    np.maximum.at(out, rows_of, ratio)
    return out


def probe_error_rows(a: sp.csr_matrix, codec_name: str, D: int, *,
                     n_probes: int = 3, seed: int = 0) -> np.ndarray:
    """Per-row relative probe error: max over probes of
    ``|(A_q − A) x|_i / (|A| |x|)_i`` — the row-wise backward-error
    analogue used by per-row-class selection."""
    a64 = a.astype(np.float64)
    e = _quantized(a, codec_name, D).astype(np.float64) - a64
    aabs = abs(a64)
    worst = np.zeros(a.shape[0])
    for x in _probe_vectors(a.shape[1], n_probes, seed):
        denom = aabs @ np.abs(x)
        err = np.abs(e @ x) / np.maximum(denom, 1e-300)
        np.maximum(worst, err, out=worst)
    return worst


# ---------------------------------------------------------------------------
# Bundled report
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CandidateReport:
    """One (codec, D) candidate's full scorecard."""

    codec: str
    D: int
    value_bits: int
    words: int                  # nnz + dummy words at this D
    dummy_words: int
    bytes_per_nnz: float        # 4 * words / nnz (bucket padding excluded)
    model_err: float
    probe_err: float | None     # None when the probe was skipped

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("model_err", "probe_err"):   # JSON has no inf
            if d[k] is not None and not math.isfinite(d[k]):
                d[k] = 1e308
        return d


@dataclasses.dataclass(frozen=True)
class AnalysisReport:
    """Stats + scored candidates for one matrix (selection input)."""

    stats: MatrixStats
    candidates: tuple            # tuple[CandidateReport, ...]
    n_probes: int
    seed: int


def _candidate_value_bits(codec_name: str, D: int) -> int:
    if codec_name == "fp32":
        return 32
    return int(cd.make_codec(codec_name).value_bits(D))


def analyze_matrix(a: sp.csr_matrix, candidates, *, sigma: int = 256,
                   n_probes: int = 3, seed: int = 0,
                   probe_skip_factor: float = 100.0,
                   error_budget: float | None = None) -> AnalysisReport:
    """Score every ``(codec, D)`` candidate on ``a``.

    The probe (the expensive part: one sparse matvec pair per probe vector)
    is skipped for candidates whose a-priori model bound already exceeds
    ``probe_skip_factor × error_budget`` — they cannot be selected, so the
    measurement would be wasted.
    """
    a = a.tocsr()
    stats = matrix_stats(a, sigma=sigma)
    ctx = None          # built lazily: all-skipped analyses never pay it
    reports = []
    for codec_name, D in candidates:
        if codec_name != "fp32":
            obj = cd.make_codec(codec_name)
            if not (obj.min_D <= D <= obj.max_D):
                continue
        mod = model_error(codec_name, D, stats)
        skip = (error_budget is not None
                and mod > probe_skip_factor * error_budget)
        if skip:
            perr = None
        else:
            ctx = ctx or _probe_context(a, n_probes, seed)
            perr = probe_error(a, codec_name, D, _ctx=ctx)
        dummy = 0 if codec_name == "fp32" else stats.dummy_words(D)
        words = stats.nnz + dummy
        reports.append(CandidateReport(
            codec=codec_name, D=D,
            value_bits=_candidate_value_bits(codec_name, D),
            words=words, dummy_words=dummy,
            bytes_per_nnz=4.0 * words / max(stats.nnz, 1),
            model_err=mod, probe_err=perr))
    return AnalysisReport(stats=stats, candidates=tuple(reports),
                          n_probes=n_probes, seed=seed)
