"""Integrity validation and the ABFT checksum guard.

The port of ``repro.robust.guard``. Two detection layers:

* **Structural validation** (:func:`validate_matrix`,
  :func:`validate_plan`, :func:`validate_composite`): host numpy passes
  over the packed and fused operands (checkpoint monotonicity and range,
  fused-stream length accounting, column range, permutation bijectivity),
  run on demand after suspicion.

* **The ABFT guard** (:func:`build_guard` + :func:`guarded_spmv`): the
  fp64 column sums ``c = eᵀA`` of the decoded operator are computed once;
  every guarded matvec then checks ``c·x ≈ sum(y)`` in fp64 on the device,
  with a codec-aware tolerance, and recomputes an exact mod-2³² checksum
  (plain and position-weighted) over every operand array the execution
  reads. A single flipped bit changes the plain sum by ±2^b ≠ 0 (mod 2³²),
  and a swap of two words changes the weighted one, so single-word
  operand corruption is caught exactly, value-neutral corruption included;
  the analytic identity catches NaN/Inf in x or the operands.

The checksum of a tensor is taken over its 32-bit words (int32 bit
patterns; a 64-bit array counts as its two 32-bit halves, low first). On
the device it runs in int64, whose sums wrap mod 2⁶⁴ and so keep the low
32 bits exact. :func:`guarded_spmv` returns ``ok`` as a device bool and
reads nothing on the host: only its caller reads ``ok``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core import codecs as cd
from ..core.packsell import PackSELLMatrix
from ..kernels import packsell_spmv as _pk
from ..observe import metrics as _obs


class IntegrityError(ValueError):
    """An operand failed structural validation or a guard check."""


# ---------------------------------------------------------------------------
# Plan health (tripped plans are rebuilt before reuse)
# ---------------------------------------------------------------------------


def mark_unhealthy(plan, reason: str) -> None:
    """Flag a plan as tripped."""
    plan._unhealthy = str(reason)
    _obs.inc("guard.plan_unhealthy", reason=str(reason))


def plan_health(plan) -> str | None:
    """The trip reason, or None for a healthy plan."""
    return getattr(plan, "_unhealthy", None)


def is_healthy(plan) -> bool:
    return plan_health(plan) is None


# ---------------------------------------------------------------------------
# Exact mod-2^32 operand checksums
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
#: words per row of the device checksum's [R, K] view: wide rows, so the
#: column sums have K outputs to spread over the card
_CHECKSUM_K = 1 << 16


def _as_u32_np(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a
    if a.dtype.itemsize in (4, 8):
        return a.view(np.uint32)    # 64-bit: both halves, low first
    return a.astype(np.uint32)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def checksum(arrays) -> np.uint64:
    """Host checksum over every 32-bit word in ``arrays`` (tensors or
    numpy): the mod-2³² word sum packed with the position-weighted sum
    ``Σ (i+1)·wᵢ mod 2³²`` (positions restart at each array); the
    reference's values bit for bit, and those of :func:`_checksum_torch`."""
    s0 = 0
    s1 = 0
    for a in arrays:
        if a is None:
            continue
        a = _host(a)
        if not a.size:
            continue
        u = _as_u32_np(a).ravel()
        s0 = (s0 + int(u.sum(dtype=np.uint32))) & _MASK32
        w = np.arange(1, u.size + 1, dtype=np.uint32)
        s1 = (s1 + int((u * w).sum(dtype=np.uint32))) & _MASK32
    return np.uint64((s0 << 32) | s1)


def _checksum_ref_pair(ref: np.uint64):
    ref = int(np.uint64(ref))
    return ref >> 32, ref & _MASK32


def _words(t: torch.Tensor) -> torch.Tensor:
    """The flat 32-bit words of ``t`` as int32 (1- and 2-byte types
    converted by value, as the host's ``astype(uint32)``)."""
    t = t.contiguous().reshape(-1)
    if t.element_size() in (4, 8):
        return t.view(torch.int32)
    return t.to(torch.int32)


def _checksum_torch(arrays):
    """Device ``(plain, weighted)`` checksums as int64 scalars in
    ``[0, 2³²)``: the two halves of :func:`checksum`. Signed words are
    congruent to the unsigned ones mod 2³², and so is every sum below
    taken mod 2³² or 2⁶⁴. The weighted sum views an array as ``[R, K]``
    (position ``i = r·K + k``): ``Σ (i+1)·wᵢ = K·Σ_r r·rowsum_r + Σ_k
    (k+1)·colsum_k``, two reductions over the words and no full-length
    temporary. The two reductions keep int32 outputs (the sum runs in
    int64 and its low 32 bits are kept), so no int64 copy of the words is
    made; the short row and column sums are then weighted in int64."""
    s0 = s1 = None
    for a in arrays:
        if a is None or a.numel() == 0:
            continue
        w = _words(a)
        n = w.numel()
        K = _CHECKSUM_K
        R = n // K
        dev = w.device
        parts0, parts1 = [], []
        if R:
            blk = w[:R * K].view(R, K)
            rows = blk.sum(dim=1, dtype=torch.int32).to(torch.int64)
            cols = blk.sum(dim=0, dtype=torch.int32).to(torch.int64)
            parts0.append(rows.sum())
            parts1.append(K * (torch.arange(R, dtype=torch.int64, device=dev)
                               * rows).sum())
            parts1.append((torch.arange(1, K + 1, dtype=torch.int64,
                                        device=dev) * cols).sum())
        if n > R * K:
            tail = w[R * K:].to(torch.int64)
            parts0.append(tail.sum())
            parts1.append((torch.arange(R * K + 1, n + 1, dtype=torch.int64,
                                        device=dev) * tail).sum())
        for p in parts0:
            s0 = p if s0 is None else s0 + p
        for p in parts1:
            s1 = p if s1 is None else s1 + p
    if s0 is None:
        return (torch.zeros((), dtype=torch.int64),) * 2
    return s0 & _MASK32, s1 & _MASK32


def guard_arrays(mat: PackSELLMatrix, plan) -> list:
    """Every operand array the plan's execution path reads: the checksum
    coverage set (and the injection surface of ``robust.inject``).

    A plan with a fused stream (``fused``, which launches K1, or ``jnp``,
    its plain body; the reference's ``jnp`` variant) reads the stream's
    words and checkpoints. Otherwise the buckets' words and ``d0``, with
    the cursor cache (``cols``) or width-block checkpoints (``kckpt``)
    where the plan has them, and for ``full``/``band`` (K4/K5/K6) the
    bucket table's rows and the band windows, which the kernels read
    through. Then the inverse permutation (``inv2``, else ``inv``) and
    ``outrow``."""
    dev = plan.device_operands()
    arrs = []
    if dev.get("fused") is not None:
        arrs += [dev["fused"][0], dev["fused"][1]]
    else:
        arrs += list(mat.packs) + list(mat.d0s)
        for k in ("cols", "kckpt", "wins"):
            if dev.get(k) is not None:
                arrs += list(dev[k])
        if dev.get("ktable") is not None:
            arrs.append(dev["ktable"].rows)
    if dev.get("inv2") is not None:
        arrs.append(dev["inv2"])
    elif dev.get("inv") is not None:
        arrs.append(dev["inv"])
    arrs.append(dev["outrow"])
    return arrs


# ---------------------------------------------------------------------------
# ABFT column sums (host, fp64)
# ---------------------------------------------------------------------------


def matrix_colsums(mat: PackSELLMatrix):
    """``(c, cabs)``: fp64 column sums of the decoded (quantized) operator
    and of its magnitudes. Decoding the packed words (not the source CSR)
    makes ``c·x = eᵀ(Ax)`` exact up to the matvec's rounding.

    One ``np.bincount`` over every contributing word, in bucket and word
    order: the same adds, in the same order from 0, as the reference's
    ``np.add.at``, and so the same sums bit for bit, at a fraction of its
    time."""
    codec = mat.codec
    idx, vals = [], []
    for pack, d0, outrow in zip(mat.packs, mat.d0s, mat.outrows):
        words = cd.words_to_numpy(pack)
        S, w, C = words.shape
        if words.size == 0:
            continue
        v, d, flag = cd.unpack_words_np(words.reshape(-1), codec, mat.D)
        v = v.astype(np.float64).reshape(S, w, C)
        cols = d0.cpu().numpy()[:, None, None].astype(np.int64) + \
            np.cumsum(d.astype(np.int64).reshape(S, w, C), axis=1)
        rows_ok = (outrow.cpu().numpy().reshape(S, C) < mat.n)[:, None, :]
        valid = (flag.reshape(S, w, C) == 1) & rows_ok
        idx.append(np.clip(cols[valid], 0, max(mat.m - 1, 0)))
        vals.append(v[valid])
    if not idx:
        return np.zeros(mat.m, np.float64), np.zeros(mat.m, np.float64)
    idx, vals = np.concatenate(idx), np.concatenate(vals)
    c = np.bincount(idx, weights=vals, minlength=mat.m)
    cabs = np.bincount(idx, weights=np.abs(vals), minlength=mat.m)
    return c, cabs


def _max_row_words(mat: PackSELLMatrix) -> int:
    return max((int(p.shape[1]) for p in mat.packs), default=1)


@dataclasses.dataclass
class GuardState:
    """Per-plan ABFT guard operands, built once (:func:`build_guard`).

    The guarded matvec accepts ``|sum(y) - c·x| <= tau_rel·(cabs·|x| +
    |c·x|) + tau_quant·cabs·|x|``. ``tau_quant`` is nonzero only when the
    column sums come from the original CSR (``source='csr'``): the decoded
    operator then differs from it by the codec's quantization, bounded per
    entry by ``ulp_bound(codec, D)``.

    With ``every=K > 1`` only every K-th :func:`guarded_spmv` call runs the
    full guard (ABFT identity + exact operand checksum); the others check
    ``isfinite(y)`` only, which still catches NaN/Inf at once. The host
    counters ``calls``, ``calls_since_full`` and ``last_check_latency``
    (guarded calls since the last full guard, inclusive: the window a
    silent corruption could have survived) follow the stride."""

    c: torch.Tensor           # fp64 [m] colsums
    cabs: torch.Tensor        # fp64 [m] magnitude colsums
    ref_checksum: np.uint64   # packed (plain, weighted) operand checksum
    tau_rel: float
    tau_quant: float
    source: str               # 'decoded' | 'csr'
    every: int = 1            # full-guard stride (1 = every call)
    calls: int = 0
    calls_since_full: int = 0
    last_check_latency: int = 1
    _dev: dict | None = dataclasses.field(default=None, repr=False)

    def dev(self) -> dict:
        """The device form of the guard's constants (cached)."""
        if self._dev is None:
            d = self.c.device
            self._dev = {
                "c": self.c, "cabs": self.cabs,
                "ref": torch.tensor(_checksum_ref_pair(self.ref_checksum),
                                    dtype=torch.int64, device=d),
                "tau": torch.tensor([self.tau_rel, self.tau_quant],
                                    dtype=torch.float64, device=d)}
        return self._dev

    def refresh_checksum(self, mat: PackSELLMatrix, plan) -> None:
        """Re-baseline the operand checksum (after a legitimate operand
        change, e.g. ``plan.retile``)."""
        self.ref_checksum = checksum(guard_arrays(mat, plan))
        self._dev = None


#: guard-tolerance safety factor over the worst-case fp32 rounding model;
#: the exact checksum, not this tolerance, carries the single-bit
#: detection guarantee
_TAU_SAFETY = 32.0


def build_guard(mat: PackSELLMatrix, plan, *, csr=None,
                safety: float = _TAU_SAFETY,
                every: int | None = None) -> GuardState:
    """Precompute the ABFT guard for ``(mat, plan)``: fp64 column sums, the
    exact operand checksum and the tolerance constants, on the plan's
    device. ``csr`` (the original scipy matrix) takes the column sums from
    the source data, which also certifies the packing, at the price of a
    quantization term (``precision.analyze.ulp_bound``) in the tolerance.
    ``every`` is the full-guard stride (default: env ``REPRO_GUARD_EVERY``,
    else 1)."""
    from ..precision import analyze as an

    if every is None:
        every = int(os.environ.get("REPRO_GUARD_EVERY", "1"))
    if every < 1:
        raise ValueError(f"build_guard: every must be >= 1, got {every}")

    if csr is not None:
        a = csr.tocsr().astype(np.float64)
        c = np.asarray(a.sum(axis=0)).ravel()
        cabs = np.asarray(abs(a).sum(axis=0)).ravel()
        tau_quant = float(an.ulp_bound(mat.codec_name, mat.D))
        if not np.isfinite(tau_quant):
            raise IntegrityError(
                f"codec {mat.codec_name!r} has no finite ulp bound; build "
                f"the guard from the decoded operator (csr=None)")
        source = "csr"
    else:
        c, cabs = matrix_colsums(mat)
        tau_quant = 0.0
        source = "decoded"
    eps32 = float(np.finfo(np.float32).eps)
    tau_rel = safety * eps32 * (_max_row_words(mat) + 8)
    dev = plan.device
    return GuardState(
        c=torch.from_numpy(np.asarray(c, np.float64)).to(dev),
        cabs=torch.from_numpy(np.asarray(cabs, np.float64)).to(dev),
        ref_checksum=checksum(guard_arrays(mat, plan)),
        tau_rel=tau_rel, tau_quant=tau_quant, source=source, every=every)


def _guard_terms(gdev: dict, x, y):
    """The guard arithmetic in fp64: (ok_analytic, rel_err)."""
    x64 = x.to(torch.float64)
    s_y = y.to(torch.float64).sum()
    s_c = torch.dot(gdev["c"], x64)
    mag = torch.dot(gdev["cabs"], x64.abs())
    tau = gdev["tau"][0] * (mag + s_c.abs()) + gdev["tau"][1] * mag
    err = (s_y - s_c).abs()
    # NaN/Inf anywhere => comparisons go False / err non-finite: tripped
    ok = (err <= tau) & torch.isfinite(y).all() & torch.isfinite(mag)
    rel = err / torch.where(mag > 0, mag, torch.ones_like(mag))
    return ok, rel


def _guard_terms_mm(gdev: dict, x, y):
    """Per-column ABFT identity for multi-RHS: ``eᵀ(AX) = (eᵀA)X``.
    Returns (ok over all columns, max column rel)."""
    x64 = x.to(torch.float64)
    s_y = y.to(torch.float64).sum(dim=0)                   # [nb]
    s_c = gdev["c"] @ x64                                  # [nb]
    mag = gdev["cabs"] @ x64.abs()                         # [nb]
    tau = gdev["tau"][0] * (mag + s_c.abs()) + gdev["tau"][1] * mag
    err = (s_y - s_c).abs()
    ok = (err <= tau).all() & torch.isfinite(y).all() \
        & torch.isfinite(mag).all()
    rel = (err / torch.where(mag > 0, mag, torch.ones_like(mag))).max()
    return ok, rel


def _stride(gs: GuardState, full):
    """The check depth of this call, with the guard's host counters."""
    if full is None:
        full = gs.every <= 1 or (gs.calls % gs.every == 0)
        gs.calls += 1
    gs.last_check_latency = gs.calls_since_full + 1
    gs.calls_since_full = 0 if full else gs.calls_since_full + 1
    return full


def _checked(mat, plan, gdev, ok):
    with _obs.span("packsell.guard_checksum"):
        cs0, cs1 = _checksum_torch(guard_arrays(mat, plan))
    return ok & (cs0 == gdev["ref"][0]) & (cs1 == gdev["ref"][1])


def guarded_spmv(mat: PackSELLMatrix, plan, gs: GuardState, x, *,
                 full: bool | None = None):
    """``(y, ok, rel_err)``: the plan's SpMV (its execution body: a guarded
    call counts as ``guard.check``, not ``spmv.dispatch``, as in the
    reference) plus the ABFT identity and the exact operand checksum. ``ok`` is a device bool scalar (False = the
    guard tripped) and ``rel_err`` the analytic residual scaled by
    ``cabs·|x|``; nothing is read on the host. Callers that confirm a trip
    should :func:`mark_unhealthy` the plan.

    ``full``: ``True`` = identity + checksum, ``False`` = ``isfinite(y)``
    only (``rel_err`` 0), ``None`` = the guard's stride
    (:class:`GuardState`)."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, device=plan.device)
    full = _stride(gs, full)
    _obs.inc("guard.check", depth="full" if full else "light")
    y = plan.execute_with(mat, plan.device_operands(), x)
    if not full:
        return (y, torch.isfinite(y).all(),
                torch.zeros((), dtype=torch.float64, device=y.device))
    gdev = gs.dev()
    ok, rel = _guard_terms(gdev, x, y)
    return y, _checked(mat, plan, gdev, ok), rel


def guarded_spmm(mat: PackSELLMatrix, plan, gs: GuardState, x, *,
                 full: bool | None = None):
    """``(Y, ok, rel_err)``: the multi-RHS analogue of
    :func:`guarded_spmv` (``plan.spmm`` plus a per-column identity; one
    checksum serves all ``nb`` columns, and a batch counts as one guarded
    call in the stride)."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, device=plan.device)
    if x.dim() != 2:
        raise ValueError(f"guarded_spmm wants x of shape [m, nb], got "
                         f"{tuple(x.shape)}")
    full = _stride(gs, full)
    _obs.inc("guard.check", depth="full" if full else "light", op="spmm")
    y = plan.execute_with(mat, plan.device_operands(), x, multi_rhs=True)
    if not full:
        return (y, torch.isfinite(y).all(),
                torch.zeros((), dtype=torch.float64, device=y.device))
    gdev = gs.dev()
    ok, rel = _guard_terms_mm(gdev, x, y)
    return y, _checked(mat, plan, gdev, ok), rel


def check_integrity(mat: PackSELLMatrix, plan, gs: GuardState) -> bool:
    """Recompute the operand checksum on the host and compare it with the
    build-time reference (no matvec)."""
    cs = checksum(guard_arrays(mat, plan))
    return bool(np.uint64(cs) == np.uint64(gs.ref_checksum))


# ---------------------------------------------------------------------------
# Structural validation
# ---------------------------------------------------------------------------


def validate_matrix(mat: PackSELLMatrix, *, raise_: bool = False) -> list:
    """Structural checks on the packed buckets (host numpy): delta-decoded
    column range, permutation bijectivity, slice-base (d0) range. Returns
    a list of problem strings (empty = valid); ``raise_=True`` raises
    :class:`IntegrityError` instead."""
    issues = []
    codec = mat.codec
    mlim = max(mat.m - 1, 0)
    outrow_all = []
    for b, (pack, d0, outrow) in enumerate(
            zip(mat.packs, mat.d0s, mat.outrows)):
        words = cd.words_to_numpy(pack)
        d0 = d0.cpu().numpy()
        outrow = outrow.cpu().numpy()
        outrow_all.append(outrow)
        S, w, C = words.shape
        if len(d0) != S:
            issues.append(f"bucket {b}: d0 length {len(d0)} != S={S}")
            continue
        if len(outrow) != S * C:
            issues.append(
                f"bucket {b}: outrow length {len(outrow)} != S*C={S * C}")
            continue
        if S and (d0.min(initial=0) < 0 or d0.max(initial=0) > mlim):
            issues.append(f"bucket {b}: d0 outside [0, {mlim}]")
        if words.size == 0:
            continue
        v, d, flag = cd.unpack_words_np(words.reshape(-1), codec, mat.D)
        if not np.all(np.isfinite(v[flag == 1])):
            issues.append(f"bucket {b}: non-finite packed value")
        cols = d0[:, None, None].astype(np.int64) + \
            np.cumsum(d.astype(np.int64).reshape(S, w, C), axis=1)
        rows_ok = (outrow.reshape(S, C) < mat.n)[:, None, :]
        f1 = (flag.reshape(S, w, C) == 1) & rows_ok
        if np.any(f1) and int(cols[f1].max()) > mlim:
            issues.append(
                f"bucket {b}: decoded column {int(cols[f1].max())} >= "
                f"m={mat.m}")
    if outrow_all:
        cat = np.concatenate(outrow_all)
        counts = np.bincount(cat[cat < mat.n], minlength=mat.n)
        if len(cat) and (counts.min(initial=1) < 1
                         or counts.max(initial=1) > 1):
            issues.append("outrow is not a bijection onto [0, n)")
    if issues and raise_:
        raise IntegrityError("; ".join(issues))
    return issues


def validate_plan(mat: PackSELLMatrix, plan, *, raise_: bool = False) -> list:
    """Structural checks on a plan's derived operands: fused-stream length
    accounting, segment coverage, checkpoint monotonicity and range,
    offset range under the stream encoding, inverse-permutation
    bijectivity, and (port) that the bucket kernels' table was built for
    the matrix's buffers. Host numpy."""
    issues = []
    outrow = plan.outrow_cat.cpu().numpy()
    if len(outrow) != plan.total_stored:
        issues.append(f"outrow_cat length {len(outrow)} != total_stored="
                      f"{plan.total_stored}")
    counts = np.bincount(outrow[outrow < plan.n], minlength=plan.n)
    if plan.n and (counts.min(initial=1) < 1 or counts.max(initial=1) > 1):
        issues.append("outrow_cat is not a bijection onto [0, n)")
    if plan.inv_cat is not None:
        inv = plan.inv_cat.cpu().numpy()
        if len(inv) != plan.n:
            issues.append(f"inv_cat length {len(inv)} != n={plan.n}")
        elif plan.n and not np.array_equal(
                outrow[np.clip(inv, 0, len(outrow) - 1)],
                np.arange(plan.n)):
            issues.append("inv_cat does not invert outrow_cat")
    if plan.inv2_cat is not None and plan.inv_cat is not None:
        inv2 = plan.inv2_cat.cpu().numpy()
        if not np.array_equal(inv2[:, 0] * mat.C + inv2[:, 1],
                              plan.inv_cat.cpu().numpy()):
            issues.append("inv2_cat disagrees with inv_cat")
    if plan.ktable is not None and \
            _pk._operands(mat.packs, mat.d0s) != plan.ktable.operands:
        issues.append("bucket table built for other buckets")

    layout = plan.fused_layout
    if plan.fused is not None and layout is not None:
        words3d = cd.words_to_numpy(plan.fused[0])
        ckpt = plan.fused[1].cpu().numpy()
        if words3d.shape != (layout.groups, layout.wr, layout.C):
            issues.append(
                f"fused stream shape {words3d.shape} != layout "
                f"({layout.groups}, {layout.wr}, {layout.C})")
        if ckpt.shape != (layout.groups, layout.C):
            issues.append(f"fused checkpoint shape {ckpt.shape} != "
                          f"({layout.groups}, {layout.C})")
        g_sum = sum(seg.groups for seg in layout.segments)
        if g_sum != layout.groups:
            issues.append(f"segment group accounting {g_sum} != "
                          f"{layout.groups}")
        stored = sum(seg.stored for seg in layout.segments)
        if stored != plan.total_stored:
            issues.append(f"segment stored accounting {stored} != "
                          f"{plan.total_stored}")
        mlim = max(plan.m - 1, 0)
        if ckpt.size and (int(ckpt.min()) < 0 or int(ckpt.max()) > mlim):
            issues.append(f"checkpoint outside [0, {mlim}]")
        for si, seg in enumerate(layout.segments):
            levels = seg.levels
            if any(levels[k] < levels[k + 1]
                   for k in range(len(levels) - 1)):
                issues.append(f"segment {si}: level sizes not "
                              f"non-increasing: {levels}")
            if levels and levels[0] > seg.S:
                issues.append(f"segment {si}: level 0 covers {levels[0]} "
                              f"> S={seg.S} slices")
            # along one slice's run chain the cursor may only advance
            if not issues and words3d.size:
                off = 0
                prev = None
                for Sk in levels:
                    cur = ckpt[seg.g0 + off:seg.g0 + off + Sk]
                    if prev is not None and np.any(cur < prev[:Sk]):
                        issues.append(
                            f"segment {si}: checkpoint not monotone")
                        break
                    prev = cur
                    off += Sk
        # every decoded column must land in [0, m)
        if not issues and words3d.size:
            v, local = _decode_stream_np(words3d, mat, layout)
            cols = ckpt[:, None, :].astype(np.int64) + local
            contrib = v != 0
            if np.any(contrib) and int(cols[contrib].max()) > mlim:
                issues.append(
                    f"fused offset overflow: column "
                    f"{int(cols[contrib].max())} >= m={plan.m}")
            if not np.all(np.isfinite(v)):
                issues.append("fused stream decodes a non-finite value")
    if issues and raise_:
        raise IntegrityError("; ".join(issues))
    return issues


def _decode_stream_np(words3d: np.ndarray, mat: PackSELLMatrix, layout):
    """Numpy decode of fused-stream words: (value fp64, run-local offset
    int64), as the kernels decode them."""
    w = np.asarray(words3d).astype(np.uint32)
    enc = layout.encoding
    if enc == "f16":
        v = (w >> np.uint32(16)).astype(np.uint16).view(np.float16)
        local = (w & np.uint32(0xFFFF)).astype(np.int64)
    elif enc == "top16":
        v = (w & np.uint32(0xFFFF0000)).view(np.float32)
        local = (w & np.uint32(0xFFFF)).astype(np.int64)
    elif enc == "fixed16":
        v = (w.view(np.int32) >> np.int32(16)).astype(np.float64) \
            * layout.scale
        local = (w & np.uint32(0xFFFF)).astype(np.int64)
    else:                            # 'words'
        v, d, flag = cd.unpack_words_np(w.reshape(-1), mat.codec, mat.D)
        v = np.where(flag == 1, v, 0.0).reshape(w.shape)
        local = d.astype(np.int64).reshape(w.shape)
    return np.asarray(v, np.float64), local


def validate_composite(comp, *, raise_: bool = False) -> list:
    """Validate every member block of a
    :class:`~repro_torch.kernels.composite.CompositePlan` and the per-term
    inverse permutations (each must index a valid slot per covered
    row)."""
    issues = []
    for i, mem in enumerate(comp.members):
        if isinstance(mem.mat, PackSELLMatrix):
            for msg in validate_matrix(mem.mat):
                issues.append(f"member {i} ({mem.label}): {msg}")
            if mem.plan is not None:
                for msg in validate_plan(mem.mat, mem.plan):
                    issues.append(f"member {i} ({mem.label}): {msg}")
    for t, inv in enumerate(comp._invs_np):
        inv = np.asarray(inv)
        if len(inv) != comp.n:
            issues.append(f"term {t}: inverse length {len(inv)} != "
                          f"n={comp.n}")
        else:
            stored = sum(mem.stored for mem in comp.members
                         if mem.term == t) + (1 if comp.pad_slot else 0)
            if len(inv) and (int(inv.min()) < 0
                             or int(inv.max()) >= stored):
                issues.append(f"term {t}: inverse indexes outside "
                              f"[0, {stored})")
    if issues and raise_:
        raise IntegrityError("; ".join(issues))
    return issues
