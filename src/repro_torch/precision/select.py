"""Codec selection: error budget → :class:`PrecisionPlan` (DESIGN.md §8.2).

The port of ``repro.precision.select``: the same decisions, to the same
``PrecisionPlan.to_dict()``, so a plan selected by either package loads
in the other (``to_json``/``from_json``).

Policy
------
Candidates are scored by :func:`~.analyze.analyze_matrix`
and ranked by storage cost ascending — stored words ``nnz + dummies(D)``,
i.e. the delta-feasibility constraint priced in (a small ``D`` frees
mantissa bits but forces dummy words on long-gap rows; this is exactly the
paper's value/delta bit-allocation axis). The selector walks the ranking
and picks the FIRST candidate whose measured probe error fits
``safety × error_budget`` (the a-priori model bound is a pre-filter only:
it decides which candidates are worth probing, the probe decides). Ties in
cost are broken toward the smaller model bound, so ``e8m`` beats ``fp16``
at equal words when the value range strains fp16.

``mode='rows'`` does the same per row: every row gets the cheapest
candidate whose deterministic row-wise error bound
(:func:`~.analyze.row_error_bound` — valid for every x,
unlike a sampled probe) fits the budget, the resulting
classes are coalesced to ``max_classes`` (small classes are bumped UP in
precision, never down, so the budget still holds), and the outcome is a
multi-class plan for the reference's ``MixedPackSELL`` (not ported yet:
ROADMAP.md, M5).

Every decision — per-candidate metrics, rejection reasons, the winner —
lands in ``PrecisionPlan.rationale`` (machine-readable; the reference's
``PrecisionStore`` persists it, not ported yet: ROADMAP.md, M5).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import scipy.sparse as sp

from . import analyze as an

# Default candidate ladder: the E8MY sweep over the delta/value split plus
# the two 16-bit embeddings. Cost-ranked at selection time.
DEFAULT_CANDIDATES = (
    ("e8m", 15), ("e8m", 12), ("e8m", 8), ("e8m", 4), ("e8m", 1),
    ("bf16", 15), ("fp16", 15),
)

#: The always-feasible fallback: uncompressed fp32 (SELL / plan passthrough).
FP32_CLASS = ("fp32", 0)


@dataclasses.dataclass(frozen=True)
class PrecisionClass:
    """One (codec, D) assignment, optionally restricted to a row set."""

    codec: str
    D: int
    rows: tuple | None = None     # None: all rows (global plan)

    @property
    def label(self) -> str:
        if self.codec == "fp32":
            return "fp32"
        return f"{self.codec}/D={self.D}"

    @property
    def sub32(self) -> bool:
        """True when the stored value representation is below 32 bits."""
        return self.codec != "fp32"

    def n_rows(self) -> int | None:
        return None if self.rows is None else len(self.rows)

    def to_dict(self) -> dict:
        return {"codec": self.codec, "D": self.D,
                "rows": None if self.rows is None else list(map(int,
                                                                self.rows))}

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionClass":
        rows = d.get("rows")
        return cls(codec=d["codec"], D=int(d["D"]),
                   rows=None if rows is None else tuple(int(r)
                                                        for r in rows))


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """The machine-readable outcome of codec selection.

    ``classes`` are ordered lowest-precision first; a global plan has one
    class with ``rows=None``. ``rationale`` holds every candidate's
    scorecard and the decision trail.
    """

    mode: str                       # 'global' | 'rows'
    classes: tuple                  # tuple[PrecisionClass, ...]
    error_budget: float
    rationale: dict
    fingerprint: str | None = None

    @property
    def primary(self) -> PrecisionClass:
        return self.classes[0]

    @property
    def is_mixed(self) -> bool:
        return self.mode == "rows" and len(self.classes) > 1

    def to_dict(self) -> dict:
        return {"mode": self.mode,
                "classes": [c.to_dict() for c in self.classes],
                "error_budget": self.error_budget,
                "rationale": self.rationale,
                "fingerprint": self.fingerprint}

    @classmethod
    def from_dict(cls, d: dict) -> "PrecisionPlan":
        return cls(mode=d["mode"],
                   classes=tuple(PrecisionClass.from_dict(c)
                                 for c in d["classes"]),
                   error_budget=float(d["error_budget"]),
                   rationale=d.get("rationale", {}),
                   fingerprint=d.get("fingerprint"))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "PrecisionPlan":
        return cls.from_dict(json.loads(s))


def _rank(reports) -> list:
    """Cost-ascending candidate order: (words, model_err) lexicographic."""
    return sorted(reports, key=lambda r: (r.words, r.model_err))


def select_codec(a: sp.csr_matrix, error_budget: float, *,
                 mode: str = "global", candidates=DEFAULT_CANDIDATES,
                 sigma: int = 256, n_probes: int = 3, seed: int = 0,
                 safety: float = 0.5, max_classes: int = 2,
                 fingerprint: str | None = None) -> PrecisionPlan:
    """Pick ``(codec, D)`` (globally or per row-class) for ``a``.

    The chosen candidate's measured probe error is at most
    ``safety × error_budget`` (default 0.5: headroom for probe-vector
    variance, so independent probes still respect the budget). Falls back
    to uncompressed fp32 when no packed codec fits.
    """
    if mode not in ("global", "rows"):
        raise ValueError(f"mode={mode!r} not in ('global', 'rows')")
    if not (error_budget > 0):
        raise ValueError(f"error_budget must be positive, got {error_budget}")
    a = a.tocsr()
    report = an.analyze_matrix(a, candidates, sigma=sigma,
                               n_probes=n_probes, seed=seed,
                               error_budget=error_budget)
    ranked = _rank(report.candidates)
    threshold = safety * error_budget
    trail, winner = [], None
    for cand in ranked:
        entry = cand.to_dict()
        if cand.probe_err is None:
            entry["decision"] = "rejected:model-bound-over-budget"
        elif cand.probe_err > threshold:
            entry["decision"] = ("rejected:probe-error-over-threshold"
                                 f" ({cand.probe_err:.3e} > {threshold:.3e})")
        elif winner is None:
            entry["decision"] = "selected:cheapest-within-budget"
            winner = cand
        else:
            entry["decision"] = "skipped:costlier-than-winner"
        trail.append(entry)

    rationale = {
        "budget": error_budget, "safety": safety, "threshold": threshold,
        "mode": mode, "n_probes": n_probes, "seed": seed, "sigma": sigma,
        "matrix": {"n": report.stats.n, "m": report.stats.m,
                   "nnz": report.stats.nnz,
                   "max_delta": report.stats.max_delta,
                   "dyn_range": report.stats.dyn_range,
                   "max_abs": report.stats.max_abs},
        "candidates": trail,
    }

    if mode == "global":
        if winner is None:
            rationale["fallback"] = "no packed codec within budget -> fp32"
            classes = (PrecisionClass(*FP32_CLASS),)
        else:
            classes = (PrecisionClass(winner.codec, winner.D),)
        return PrecisionPlan(mode="global", classes=classes,
                             error_budget=error_budget, rationale=rationale,
                             fingerprint=fingerprint)

    return _select_rows(a, report, ranked, threshold, error_budget,
                        rationale, n_probes, seed, max_classes, fingerprint)


def _select_rows(a, report, ranked, threshold, error_budget, rationale,
                 n_probes, seed, max_classes, fingerprint) -> PrecisionPlan:
    """Per-row assignment: cheapest candidate whose row-wise probe error
    fits, coalesced to ``max_classes`` classes (bumping UP in precision)."""
    n = a.shape[0]
    assign = np.full(n, -1, dtype=np.int64)       # index into `viable`
    viable = [c for c in ranked if c.probe_err is not None]
    for ci, cand in enumerate(viable):
        # deterministic per-row bound: holds for EVERY x, so independent
        # probes always respect the budget (the global mode's probe only
        # certifies sampled vectors; per-row noise is too high for that)
        errs = an.row_error_bound(a, cand.codec, cand.D)
        take = (assign < 0) & (errs <= threshold)
        assign[take] = ci
        if not np.any(assign < 0):
            break

    # unassigned rows -> fp32 passthrough class (index len(viable))
    fp32_idx = len(viable)
    assign[assign < 0] = fp32_idx

    def acc_err(ci: int) -> float:   # model accuracy of a class index
        return 0.0 if ci == fp32_idx else viable[ci].model_err

    # Coalesce to <= max_classes: keep the most-populated classes (always
    # including the most accurate one, so every drop has a bump target),
    # then bump each dropped class UP to the least-accurate kept class that
    # is still at least as accurate — row errors can only shrink, so the
    # budget keeps holding.
    used, counts = np.unique(assign, return_counts=True)
    if len(used) > max_classes:
        by_pop = used[np.argsort(-counts)].tolist()
        most_accurate = min(used.tolist(), key=acc_err)
        kept = by_pop[:max_classes]
        if most_accurate not in kept:
            kept[-1] = most_accurate
        kept = set(kept)
        for drop in used:
            if drop in kept:
                continue
            ok = [k for k in kept if acc_err(k) <= acc_err(drop)]
            target = max(ok, key=acc_err) if ok else most_accurate
            assign[assign == drop] = target

    classes = []
    class_info = []
    for ci in np.unique(assign):
        rows = tuple(int(r) for r in np.nonzero(assign == ci)[0])
        if ci == fp32_idx:
            pc = PrecisionClass("fp32", 0, rows=rows)
            class_info.append({"codec": "fp32", "D": 0,
                               "n_rows": len(rows)})
        else:
            cand = viable[ci]
            pc = PrecisionClass(cand.codec, cand.D, rows=rows)
            class_info.append({"codec": cand.codec, "D": cand.D,
                               "n_rows": len(rows),
                               "model_err": cand.model_err})
        classes.append(pc)
    # lowest precision (largest model error) first
    classes.sort(key=lambda c: 0.0 if c.codec == "fp32"
                 else -an.model_error(c.codec, c.D, report.stats))
    rationale["row_classes"] = class_info
    return PrecisionPlan(mode="rows", classes=tuple(classes),
                         error_budget=error_budget, rationale=rationale,
                         fingerprint=fingerprint)


# ---------------------------------------------------------------------------
# Tier ladder for the adaptive solver
# ---------------------------------------------------------------------------


def tier_ladder(plan: PrecisionPlan, *, top: str = "fp32") -> list:
    """Promotion ladder for ``solvers.cg.adaptive_pcg``: the plan's chosen
    codec first, then strictly more accurate packed tiers, ending at the
    uncompressed ``top`` tier. Each entry is a :class:`PrecisionClass`
    (``rows=None`` — tiers are whole-operator)."""
    first = plan.primary
    if first.codec == "fp32":
        return [PrecisionClass(top, 0)]   # fallback plan: nothing to promote
    ladder = [PrecisionClass(first.codec, first.D)]
    first_err = _tier_err(first)
    for codec, D in (("e8m", 8), ("e8m", 4), ("e8m", 1)):
        c = PrecisionClass(codec, D)
        if _tier_err(c) < 0.25 * first_err:
            ladder.append(c)
            first_err = _tier_err(c)
    ladder.append(PrecisionClass(top, 0))
    return ladder


def _tier_err(c: PrecisionClass) -> float:
    return an.ulp_bound(c.codec, c.D)


def operator_kind(c: PrecisionClass, *, engine: str = "plan") -> str:
    """The ``solvers.operators.OperatorSet`` kind string of a tier."""
    if c.codec == "fp32":
        return "fp32"
    if c.codec in ("fp16", "bf16"):
        return f"{engine}_{c.codec}"
    if c.codec == "e8m":
        return f"{engine}_e8m{c.D}"
    raise ValueError(f"no OperatorSet kind for codec {c.codec!r}")


def build_tier_matvecs(ops, ladder, *, engine: str = "plan"):
    """Materialize a ladder against an ``OperatorSet``: returns
    ``(matvecs, labels, sub32_mask)`` — the inputs of ``adaptive_pcg``."""
    matvecs = [ops.matvec(operator_kind(c, engine=engine)) for c in ladder]
    labels = [c.label for c in ladder]
    sub32 = np.array([c.sub32 for c in ladder], dtype=bool)
    return matvecs, labels, sub32
