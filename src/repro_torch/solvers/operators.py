"""Linear operators over the sparse formats, with per-precision variants.

``OperatorSet`` builds the requested variants of one matrix once, on one
device, and hands out matvec callables. The port carries the dense SELL
kinds (``fp64`` with a float64 sum, ``fp32``, ``fp16``, ``bf16``; kernel
K2), ``csr64`` (float64 CSR: cuSPARSE on the card), the
``packsell_<codec>`` kinds (the reference's per-call scan body on the CPU,
the matrix's plan kernels on the card), the ``plan_<codec>`` kinds (the
cached plan engine) with ``plan_pair`` for ``cg.jacobi_pcg_stored``, their
``guarded:plan_<codec>`` form (the ABFT guard on every call outside a
graph capture), the budget-driven ``auto:`` and ``mixed:`` kinds (one
codec, or a ``MixedPackSELL`` composite of row classes), the
``cg.adaptive_pcg`` inputs (:meth:`OperatorSet.precision_plan`,
:meth:`OperatorSet.adaptive_tiers`), with an optional
:class:`~repro_torch.precision.store.PrecisionStore`, and the distributed
kinds ``dist_<codec>``, ``dist_auto:`` and ``dist_mixed:`` (a
:class:`~repro_torch.distributed.plan.DistSpMVPlan` over the default shard
mesh of the set's device, or over the set's ``mesh``: a rank mesh runs
them one process per shard; global vectors in and out) with
:meth:`OperatorSet.dist_plan` and :meth:`OperatorSet.dist_adaptive_tiers`
for ``cg.jacobi_pcg_dist`` and ``cg.adaptive_pcg_dist``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .. import _device
from ..core import packsell as pk
from ..core import sell as sl
from ..core import sparse as sps
from ..kernels import ops as kops
from ..kernels import plan as kplan
from ..precision import select as psel

Matvec = Callable[[torch.Tensor], torch.Tensor]


def row_scale(a: sp.csr_matrix) -> tuple[sp.csr_matrix, np.ndarray]:
    """G^{-1} A with g_i = sum_j |a_ij| (paper §5.1.2 scaling for SpMV)."""
    g = np.asarray(np.abs(a).sum(axis=1)).ravel()
    g = np.where(g == 0, 1.0, g)
    return sp.diags(1.0 / g) @ a, g


def sym_scale(a: sp.csr_matrix) -> tuple[sp.csr_matrix, np.ndarray]:
    """Ḡ^{-1} A Ḡ^{-1} with ḡ_i = sqrt(|a_ii|) (paper §5.2 scaling)."""
    d = np.sqrt(np.abs(a.diagonal()))
    d = np.where(d == 0, 1.0, d)
    dinv = sp.diags(1.0 / d)
    s = (dinv @ a @ dinv).tocsr()
    s.sort_indices()
    return s, d


# ---------------------------------------------------------------------------
# Kind-string parsing (the reference's parser, whole)
# ---------------------------------------------------------------------------

#: engine-less dense/baseline kinds
DENSE_KINDS = ("fp64", "fp32", "fp16", "bf16")

#: the valid-kind menu malformed inputs are pointed at
KIND_MENU = (
    "fp64 | fp32 | fp16 | bf16 | csr64 | packsell_<codec> | plan_<codec> "
    "| dist_<codec> | auto:<budget> | mixed:<budget> | dist_auto:<budget> "
    "| dist_mixed:<budget> | guarded:plan_<codec>   (<codec>: fp16 | bf16 "
    "| e8m<D>, e.g. e8m8; <budget>: a positive float, e.g. 1e-3)")

@dataclasses.dataclass(frozen=True)
class KindSpec:
    """One parsed operator-kind string (``family`` is the dispatch
    class: 'dense', 'csr64', 'packsell', 'plan', 'dist', 'auto', 'mixed',
    'dist_auto', 'dist_mixed' or 'guarded')."""

    raw: str
    family: str
    codec: Optional[str] = None
    D: Optional[int] = None
    budget: Optional[float] = None
    inner: Optional["KindSpec"] = None

    @property
    def distributed(self) -> bool:
        return self.family.startswith("dist")


def _parse_codec(sub: str, kind: str) -> tuple[str, int]:
    if sub in ("fp16", "bf16"):
        return sub, 15
    if sub.startswith("e8m") and sub[3:].isdigit():
        # *_e8mD where D is the *delta* width (Y = 22 - D)
        return "e8m", int(sub[3:])
    raise ValueError(
        f"unknown codec {sub!r} in operator kind {kind!r}; valid kinds: "
        f"{KIND_MENU}")


def _parse_budget(sub: str, kind: str) -> float:
    try:
        budget = float(sub)
    except ValueError:
        raise ValueError(
            f"malformed error budget {sub!r} in operator kind {kind!r}; "
            f"valid kinds: {KIND_MENU}") from None
    if not budget > 0:
        raise ValueError(
            f"error budget must be positive, got {budget} in operator "
            f"kind {kind!r}; valid kinds: {KIND_MENU}")
    return budget


def parse_kind(kind: str) -> KindSpec:
    """Parse an operator kind string; raises ValueError listing every
    valid kind on malformed input."""
    if not isinstance(kind, str):
        raise ValueError(
            f"operator kind must be a string, got {type(kind).__name__}; "
            f"valid kinds: {KIND_MENU}")
    if kind in DENSE_KINDS:
        return KindSpec(kind, "dense", codec=kind)
    if kind == "csr64":
        return KindSpec(kind, "csr64")
    if kind.startswith("guarded:"):
        inner = parse_kind(kind[len("guarded:"):])
        if inner.family != "plan":
            raise ValueError(
                f"guarded: wraps plan_<codec> kinds only (ABFT checksums "
                f"need the plan engine's packed operands), got "
                f"{inner.raw!r} in {kind!r}; valid kinds: {KIND_MENU}")
        return KindSpec(kind, "guarded", codec=inner.codec, D=inner.D,
                        inner=inner)
    for family in ("dist_auto", "dist_mixed", "auto", "mixed"):
        if kind.startswith(family + ":"):
            return KindSpec(kind, family,
                            budget=_parse_budget(kind[len(family) + 1:],
                                                 kind))
    for family in ("packsell", "plan", "dist"):
        if kind.startswith(family + "_"):
            codec, D = _parse_codec(kind[len(family) + 1:], kind)
            return KindSpec(kind, family, codec=codec, D=D)
    raise ValueError(
        f"unknown operator kind {kind!r}; valid kinds: {KIND_MENU}")


@dataclasses.dataclass
class OperatorSet:
    """The operator variants of one (scaled) matrix, built lazily on
    ``device`` (``None`` means the GPU). ``force`` is the plan variant of
    every ``plan_<codec>``, ``packsell_<codec>`` and ``mixed:`` kind
    (``kernels.plan.build_plan``); ``"jnp"`` also gives the dense kinds
    the plain SELL body instead of K2. ``store`` — an optional
    :class:`~repro_torch.precision.store.PrecisionStore` (or a path to
    one) that every budget-driven kind consults. ``mesh`` — the shard
    mesh of the distributed kinds (None: ``make_shard_mesh`` on the set's
    device); with a :class:`~repro_torch.parallel.sharding.RankMesh`
    every rank builds the set and its distributed kinds run over the
    ranks (the set's device is the rank's)."""

    csr: sp.csr_matrix
    C: int = 32
    sigma: int = 256
    device: object = None
    force: str = "auto"
    store: object = None
    mesh: object = None
    _cache: dict = dataclasses.field(default_factory=dict)
    #: the solvers' graphs and static buffers (``iocg``, ``f3r``), kept
    #: per solver, kinds, inner iterations and shape
    graphs: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def __post_init__(self):
        if self.mesh is not None and self.device is None:
            self.device = self.mesh.device
        self.device = _device.resolve_device(self.device)

    @property
    def n(self) -> int:
        return self.csr.shape[0]

    def diag(self) -> np.ndarray:
        """The matrix diagonal (host numpy), read from the CSR once:
        scipy walks every stored entry for it, which each solver's set-up
        would otherwise pay again."""
        if ("diag",) not in self._cache:
            self._cache[("diag",)] = self.csr.diagonal()
        return self._cache[("diag",)]

    # -- adaptive precision (repro_torch.precision) ------------------------
    def precision_plan(self, error_budget: float, *, mode: str = "global",
                       store=None, **select_kw):
        """Budget → :class:`~repro_torch.precision.select.PrecisionPlan`
        for this matrix (cached per budget, mode, store and selection
        arguments). ``store`` (or the set's own) skips the analysis when
        the matrix's fingerprint hits."""
        from ..precision.store import PrecisionStore

        store = store if store is not None else self.store
        key = ("pplan", error_budget, mode,
               None if store is None else getattr(store, "path", store),
               tuple(sorted(select_kw.items())))
        if key not in self._cache:
            if store is not None:
                self._cache[key], _ = PrecisionStore.coerce(
                    store).lookup_or_select(self.csr, error_budget,
                                            mode=mode, sigma=self.sigma,
                                            **select_kw)
            else:
                self._cache[key] = psel.select_codec(
                    self.csr, error_budget, mode=mode, sigma=self.sigma,
                    **select_kw)
        return self._cache[key]

    def adaptive_tiers(self, error_budget: float, *, store=None,
                       **select_kw):
        """The ``cg.adaptive_pcg`` inputs at a budget: ``(matvecs, labels,
        sub32_mask, matvec_hi)`` over the plan's tier ladder; ``matvec_hi``
        is the fp64 operator (float64 sum) of the outer residual."""
        plan = self.precision_plan(error_budget, store=store, **select_kw)
        mvs, labels, sub32 = psel.build_tier_matvecs(
            self, psel.tier_ladder(plan))
        return mvs, labels, sub32, self.matvec("fp64")

    def dist_adaptive_tiers(self, error_budget: float, *,
                            n_shards: int | None = None, mesh=None,
                            exchange: str = "ppermute", store=None,
                            **select_kw):
        """The same tier ladder as :meth:`adaptive_tiers`, built as a
        :class:`~repro_torch.distributed.plan.DistTierLadder` for
        ``cg.adaptive_pcg_dist``: per-tier stacked member sets over one
        shared partition plus the exact fp64 outer operator, on ``mesh``
        (default: the set's ``mesh``, else ``make_shard_mesh(n_shards)`` on
        the set's device)."""
        from ..distributed import build_dist_tiers

        plan = self.precision_plan(error_budget, store=store, **select_kw)
        return build_dist_tiers(self.csr, psel.tier_ladder(plan),
                                n_shards=n_shards, mesh=mesh or self.mesh,
                                exchange=exchange, C=self.C,
                                sigma=self.sigma, device=self.device)

    def matvec(self, kind: str) -> Matvec:
        """The matvec of a dense SELL kind (K2; ``fp64`` sums in float64),
        ``csr64``, a ``packsell_<codec>`` kind, a ``plan_<codec>`` kind
        (the matrix's cached SpMVPlan), its ``guarded:`` form, an
        ``auto:<budget>`` kind (the selected codec's ``plan_`` kind, or
        ``fp32``), a ``mixed:<budget>`` kind (a ``MixedPackSELL`` of the
        per-row-class selection), or a distributed kind over the default
        shard mesh of the set's device: ``dist_<codec>``, ``dist_auto:``
        (per-shard selection coalesced to one fleet codec) and
        ``dist_mixed:`` (per-shard per-class members); these take and
        return global vectors, so they drop into any solver unchanged.

        ``packsell_<codec>`` is the reference's per-call path
        (``kernels.ops.packsell_spmv_percall``): on the CPU with
        ``force="auto"`` the scan body, so CPU results equal the
        reference's bit for bit; on the card the plan's kernel (K1, K4 or
        K6 by ``plan.choose_variant``), or with ``force="jnp"`` the plan's
        plain body.

        ``guarded:plan_<codec>`` runs ``robust.guard.guarded_spmv`` and
        reads its ``ok`` on the host, counting trips in ``fn.trips()`` and
        marking a tripped plan unhealthy; ``fn.guard`` and ``fn.pair`` are
        the guard state and ``(mat, plan)``. While the current CUDA stream
        is capturing a graph it runs ``plan.spmv`` unguarded: reading
        ``ok`` would be a host sync inside the capture (the reference
        passes tracers through unguarded the same way)."""
        if kind in self._cache:
            return self._cache[kind][0]
        spec = parse_kind(kind)
        if spec.family == "dense":
            dtype = {"fp64": "float64", "fp32": "float32",
                     "fp16": "float16", "bf16": "bfloat16"}[spec.codec]
            mat = sl.from_csr(self.csr, C=self.C, sigma=self.sigma,
                              value_dtype=dtype, device=self.device)
            comp = torch.float64 if spec.codec == "fp64" else torch.float32
            body = sl.sell_spmv if self.force == "jnp" else kops.sell_spmv
            fn = lambda x, mat=mat, comp=comp: body(mat, x, comp)  # noqa: E731
        elif spec.family == "packsell":
            mat = pk.from_csr(self.csr, C=self.C, sigma=self.sigma, D=spec.D,
                              codec=spec.codec, device=self.device)
            kops.percall_plan(mat, self.force)     # build the plan now
            fn = functools.partial(kops.packsell_spmv_percall, mat,
                                   force=self.force)
        elif spec.family == "plan":
            mat = pk.from_csr(self.csr, C=self.C, sigma=self.sigma, D=spec.D,
                              codec=spec.codec, device=self.device)
            p = kplan.get_plan(mat, force=self.force)
            fn = lambda x, mat=mat, p=p: p.spmv(mat, x)  # noqa: E731
        elif spec.family == "csr64":
            mat = sps.csr_from_scipy(self.csr, "float64", device=self.device)
            fn = functools.partial(mat.spmv, compute_dtype=torch.float64)
        elif spec.family == "guarded":
            fn, mat = self._guarded(spec)
        elif spec.family == "auto":
            sub = psel.operator_kind(self.precision_plan(spec.budget).primary)
            fn = self.matvec(sub)
            mat = self._cache[sub][1]
        elif spec.family == "mixed":
            from ..precision.mixed import MixedPackSELL
            mat = MixedPackSELL(self.csr, self.precision_plan(
                spec.budget, mode="rows"), C=self.C, sigma=self.sigma,
                device=self.device, force=self.force)
            fn = mat.spmv
        else:
            mat = self._dist(spec)
            fn = mat.spmv
        self._cache[kind] = (fn, mat)
        return fn

    def _dist(self, spec: KindSpec):
        """The DistSpMVPlan of a ``dist_<codec>``, ``dist_auto:`` or
        ``dist_mixed:`` kind."""
        from ..distributed import build_dist_plan

        kw = dict(C=self.C, sigma=self.sigma, device=self.device,
                  mesh=self.mesh)
        if spec.family == "dist":
            return build_dist_plan(self.csr, D=spec.D, codec=spec.codec,
                                   **kw)
        if spec.family == "dist_auto":
            # per-shard fingerprinted selection, coalesced to the most
            # conservative fleet codec (one program for every shard)
            from ..precision.store import select_codec_per_shard
            _, fleet = select_codec_per_shard(
                self.csr, self._dist_shards(), spec.budget,
                store=self.store, sigma=self.sigma)
            return build_dist_plan(
                self.csr, classes=[(fleet.codec, fleet.D, None)], **kw)
        if spec.family == "dist_mixed":
            return build_dist_plan(
                self.csr, pplan=self.precision_plan(spec.budget,
                                                    mode="rows"), **kw)
        raise ValueError(spec.raw)  # pragma: no cover: parse_kind is total

    def _dist_shards(self) -> int:
        """Shards of the set's mesh (a rank mesh: the world size), else of
        the default mesh on the set's device."""
        if self.mesh is not None:
            return self.mesh.size
        from ..parallel import make_shard_mesh
        return make_shard_mesh(device=self.device).size

    def _guarded(self, spec: KindSpec):
        from ..robust import guard as gd

        mat, p = self.plan_pair(spec.inner.raw)
        gs = gd.build_guard(mat, p)
        state = {"trips": 0}

        def fn(x, mat=mat, p=p, gs=gs, state=state):
            if x.is_cuda and torch.cuda.is_current_stream_capturing():
                return p.spmv(mat, x)
            y, ok, _ = gd.guarded_spmv(mat, p, gs, x)
            if not bool(ok):
                state["trips"] += 1
                gd.mark_unhealthy(p, "guard_trip")
            return y

        fn.guard = gs
        fn.pair = (mat, p)
        fn.trips = lambda state=state: state["trips"]
        return fn, mat

    def stored(self, kind: str):
        """The underlying format object (for memory stats)."""
        self.matvec(kind)
        return self._cache[kind][1]

    def plan_pair(self, kind: str):
        """(mat, plan) for a 'plan_<codec>' kind — the inputs of
        ``cg.jacobi_pcg_stored``."""
        if parse_kind(kind).family != "plan":
            raise ValueError(
                f"{kind!r} is not a plan_ kind (valid: plan_<codec> with "
                f"<codec>: fp16 | bf16 | e8m<D>)")
        self.matvec(kind)
        mat = self._cache[kind][1]
        return mat, kplan.get_plan(mat, force=self.force)

    def dist_plan(self, kind: str):
        """The :class:`~repro_torch.distributed.plan.DistSpMVPlan` behind a
        distributed kind (``dist_<codec>`` / ``dist_auto:<b>`` /
        ``dist_mixed:<b>``): what ``cg.jacobi_pcg_dist`` takes."""
        if not parse_kind(kind).distributed:
            raise ValueError(
                f"{kind!r} is not a distributed kind (valid: dist_<codec> "
                f"| dist_auto:<budget> | dist_mixed:<budget>)")
        self.matvec(kind)
        return self._cache[kind][1]
