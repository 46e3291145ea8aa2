"""repro_torch's mixed-precision path against the reference, on the CPU.

* ``precision.analyze`` and ``precision.select``: the same statistics,
  model bounds and probe errors, the same ``select_codec(...).to_dict()``
  in both modes, the same ``tier_ladder``, and plans that load in either
  package through JSON;
* the dense SELL operator kinds (``fp64`` with a float64 sum, ``fp32``,
  ``fp16``, ``bf16``) and ``auto:<budget>``;
* ``cg.adaptive_pcg``, the slice as a whole: on the reference's own
  acceptance matrices (banded and power-law, n = 1200) and its promotion
  case (a 1D Laplacian under a coarse codec), the port takes the same
  outer steps, tiers, promotions and matvec counts, its x is within 1e-6
  relative of the reference's, and the true relative residual is below
  1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import testmats as rtm
from repro.precision import analyze as ran
from repro.precision import select as rsel
from repro.solvers import cg as rcg
from repro.solvers import operators as rop
from repro_torch.precision import analyze as tan
from repro_torch.precision import select as tsel
from repro_torch.solvers import cg as tcg
from repro_torch.solvers import operators as top


def _laplace1d(n=96):
    return sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()


MATRICES = {
    "banded1200": lambda: rtm.random_banded(1200, 24, 6, seed=1),
    "powerlaw1200": lambda: rtm.powerlaw(1200, mean_deg=5, spd=True, seed=2),
    "hpcg10": lambda: rop.sym_scale(rtm.hpcg(10, 10, 10))[0],
    "scattered": lambda: rtm.suite("tiny")["scattered"],
    "laplace1d": _laplace1d,
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# analysis and selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_analysis_matches_reference(name):
    a = MATRICES[name]()
    st, sr = tan.matrix_stats(a), ran.matrix_stats(a)
    for f in ("n", "m", "nnz", "k_left", "max_abs", "min_abs_nz",
              "dyn_range", "has_subnormal", "max_delta", "sigma"):
        assert getattr(st, f) == getattr(sr, f), f
    for f in ("row_max_abs", "row_min_abs_nz", "row_nnz", "deltas_sorted"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sr, f))
    for codec, D in tsel.DEFAULT_CANDIDATES + (("fixed12", 15),):
        assert st.words(D) == sr.words(D)
        assert tan.model_error(codec, D, st) == ran.model_error(codec, D, sr)
        assert tan.ulp_bound(codec, D) == ran.ulp_bound(codec, D)
    for codec, D in (("e8m", 8), ("bf16", 15)):
        assert tan.probe_error(a, codec, D, n_probes=2) == \
            ran.probe_error(a, codec, D, n_probes=2)
        np.testing.assert_array_equal(tan.row_error_bound(a, codec, D),
                                      ran.row_error_bound(a, codec, D))
        np.testing.assert_array_equal(tan.probe_error_rows(a, codec, D),
                                      ran.probe_error_rows(a, codec, D))


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("mode", ["global", "rows"])
@pytest.mark.parametrize("budget", [1e-3, 1e-2, 1e-6])
def test_select_codec_to_dict_equal(name, mode, budget):
    a = MATRICES[name]()
    got = tsel.select_codec(a, budget, mode=mode, n_probes=2)
    want = rsel.select_codec(a, budget, mode=mode, n_probes=2)
    assert got.to_dict() == want.to_dict()
    ladder_t, ladder_r = tsel.tier_ladder(got), rsel.tier_ladder(want)
    assert [c.to_dict() for c in ladder_t] == [c.to_dict() for c in ladder_r]
    assert [tsel.operator_kind(c) for c in ladder_t] == \
        [rsel.operator_kind(c) for c in ladder_r]
    # a plan selected by either package loads in the other
    assert tsel.PrecisionPlan.from_json(want.to_json()).to_dict() == \
        want.to_dict()
    assert rsel.PrecisionPlan.from_json(got.to_json()).to_dict() == \
        got.to_dict()


@pytest.mark.parametrize("codec,D", tsel.DEFAULT_CANDIDATES + (("fp32", 0),))
def test_tier_ladder_and_kinds_match_reference(codec, D):
    plan_t = tsel.PrecisionPlan("global", (tsel.PrecisionClass(codec, D),),
                                1e-3, {})
    plan_r = rsel.PrecisionPlan("global", (rsel.PrecisionClass(codec, D),),
                                1e-3, {})
    for top_tier in ("fp32", "fp64"):
        got = [c.to_dict() for c in tsel.tier_ladder(plan_t, top=top_tier)]
        assert got == [c.to_dict() for c in rsel.tier_ladder(plan_r,
                                                             top=top_tier)]
    c = tsel.PrecisionClass(codec, D)
    assert (c.label, c.sub32) == (rsel.PrecisionClass(codec, D).label,
                                  rsel.PrecisionClass(codec, D).sub32)


def test_select_rejects_bad_mode_and_budget():
    a = MATRICES["scattered"]()
    for kw, msg in (({"mode": "cols"}, "mode="), ({}, "positive")):
        with pytest.raises(ValueError, match=msg):
            tsel.select_codec(a, 1e-3 if kw else 0.0, **kw)


# ---------------------------------------------------------------------------
# operator kinds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fp64", "fp32", "fp16", "bf16"])
def test_dense_kinds_match_reference(kind):
    """fp64 sums in float64 (rtol 1e-12: the order of XLA's fused loop
    against torch's j-ordered adds); the others in float32 (rtol 1e-6)."""
    s, _ = rop.sym_scale(rtm.suite("tiny")["powerlaw"])
    x = np.random.default_rng(3).standard_normal(s.shape[1])
    port = top.OperatorSet(s, device="cpu")
    got = port.matvec(kind)(torch.from_numpy(x))
    want = np.asarray(rop.OperatorSet(s).matvec(kind)(jnp.asarray(x)))
    assert got.dtype == (torch.float64 if kind == "fp64" else torch.float32)
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    tol = 1e-12 if kind == "fp64" else 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())
    assert port.stored(kind).memory_stats() == \
        rop.OperatorSet(s).stored(kind).memory_stats()


@pytest.mark.parametrize("kind", ["fp32", "auto:1e-3"])
def test_operator_families_now_ported_match_reference(kind):
    """The two families that raised before this slice: ``fp32`` (SELL
    through K2) and ``auto:<budget>`` (the selected codec's plan)."""
    a = rtm.suite("tiny")["hpcg_mini"]
    x = np.random.default_rng(4).standard_normal(a.shape[1]).astype(
        np.float32)
    port, ref = top.OperatorSet(a, device="cpu"), rop.OperatorSet(a)
    got = port.matvec(kind)(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.matvec(kind)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert port.matvec(kind) is port.matvec(kind)
    if kind.startswith("auto:"):
        sub = tsel.operator_kind(port.precision_plan(1e-3).primary)
        assert port.stored(kind) is port.stored(sub)
        assert port.precision_plan(1e-3).to_dict() == \
            ref.precision_plan(1e-3).to_dict()


def test_mixed_kind_and_store_raise_naming_roadmap(tmp_path):
    """``mixed:``, ``store=`` and the distributed ``dist_mixed:`` are
    ported (M5, M9): they build and agree with the reference."""
    a = MATRICES["scattered"]()
    ops = top.OperatorSet(a, device="cpu")
    ref = rop.OperatorSet(a)
    x = np.random.default_rng(4).standard_normal(a.shape[1]).astype(
        np.float32)
    np.testing.assert_allclose(
        ops.matvec("mixed:1e-3")(torch.from_numpy(x)).numpy(),
        np.asarray(ref.matvec("mixed:1e-3")(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    store = str(tmp_path / "store.json")
    assert ops.precision_plan(1e-3, store=store).to_dict() == \
        ref.precision_plan(1e-3, store=str(tmp_path / "ref.json")).to_dict()
    assert ops.adaptive_tiers(1e-3, store=store)[1] == \
        ref.adaptive_tiers(1e-3)[1]
    np.testing.assert_allclose(
        ops.matvec("dist_mixed:1e-3")(torch.from_numpy(x)).numpy(),
        np.asarray(ref.matvec("dist_mixed:1e-3")(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


def test_adaptive_tiers_match_reference():
    s, _ = rop.sym_scale(rtm.hpcg(10, 10, 10))
    port, ref = top.OperatorSet(s, device="cpu"), rop.OperatorSet(s)
    tt, tl, ts, th = port.adaptive_tiers(1e-3, n_probes=2)
    rt, rl, rs, rh = ref.adaptive_tiers(1e-3, n_probes=2)
    assert tl == rl and len(tt) == len(rt)
    np.testing.assert_array_equal(ts, rs)
    x = np.random.default_rng(6).standard_normal(s.shape[1])
    for ft, fr in zip(tt + [th], rt + [rh]):
        np.testing.assert_allclose(ft(torch.from_numpy(x)).numpy(),
                                   np.asarray(fr(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# adaptive_pcg: the slice as a whole
# ---------------------------------------------------------------------------


def _solve_both(a, *, ladder=None, budget=1e-3, m_in=16, jacobi=True,
                C=32, sigma=256):
    """The same solve in both packages: b and the Jacobi M from numpy,
    the ladder from ``adaptive_tiers`` (or ``ladder`` of (codec, D))."""
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    diag = a.diagonal()
    dinv = np.where(diag == 0, 1.0, 1.0 / diag)
    port, ref = (top.OperatorSet(a, C=C, sigma=sigma, device="cpu"),
                 rop.OperatorSet(a, C=C, sigma=sigma))
    if ladder is None:
        tt, _, _, th = port.adaptive_tiers(budget, n_probes=2)
        rt, _, _, rh = ref.adaptive_tiers(budget, n_probes=2)
    else:
        tt, _, _ = tsel.build_tier_matvecs(
            port, [tsel.PrecisionClass(c, D) for c, D in ladder])
        rt, _, _ = rsel.build_tier_matvecs(
            ref, [rsel.PrecisionClass(c, D) for c, D in ladder])
        th, rh = port.matvec("fp64"), ref.matvec("fp64")
    dt, dr = torch.from_numpy(dinv), jnp.asarray(dinv)
    kw = dict(tol=1e-8, maxiter=60, m_in=m_in)
    xt, it = tcg.adaptive_pcg(tt, torch.from_numpy(b), matvec_hi=th,
                              M=(lambda r: r * dt) if jacobi else None, **kw)
    xr, ir = rcg.adaptive_pcg(rt, jnp.asarray(b), matvec_hi=rh,
                              M=(lambda r: r * dr) if jacobi else None, **kw)
    return b, xt, it, np.asarray(xr), ir


def _assert_same_schedule(a, b, xt, it, xr, ir):
    k = it.iters
    assert k == int(ir.iters) > 0
    np.testing.assert_array_equal(it.tier_history.numpy(),
                                  np.asarray(ir.tier_history))
    assert it.promotions == int(ir.promotions)
    np.testing.assert_array_equal(it.tier_matvecs.numpy(),
                                  np.asarray(ir.tier_matvecs))
    assert it.hi_matvecs == int(ir.hi_matvecs)
    np.testing.assert_allclose(it.history[:k + 1].numpy(),
                               np.asarray(ir.history)[:k + 1], rtol=1e-4)
    assert (it.history[k + 1:] == -1).all()
    assert xt.dtype == torch.float64
    assert _rel(xt.numpy(), xr) <= 1e-6
    true_rel = np.linalg.norm(b - a @ xt.numpy()) / np.linalg.norm(b)
    assert true_rel <= 1e-8 and float(it.relres) <= 1e-8


@pytest.mark.parametrize("name", ["banded1200", "powerlaw1200"])
def test_adaptive_pcg_matches_reference(name):
    """The reference's acceptance matrices (sym-scaled), budget 1e-3."""
    a, _ = rop.sym_scale(MATRICES[name]())
    b, xt, it, xr, ir = _solve_both(a)
    _assert_same_schedule(a, b, xt, it, xr, ir)
    counts = it.tier_matvecs.numpy()
    assert counts[:-1].sum() / (counts.sum() + it.hi_matvecs) >= 0.8


def test_adaptive_pcg_promotion_matches_reference():
    """The reference's promotion case: a 1D Laplacian under e8m/D15 with
    no preconditioner stalls and promotes (its test_precision.py)."""
    a = _laplace1d()
    b, xt, it, xr, ir = _solve_both(
        a, ladder=(("e8m", 15), ("e8m", 1), ("fp32", 0)), m_in=48,
        jacobi=False, C=8, sigma=32)
    _assert_same_schedule(a, b, xt, it, xr, ir)
    assert it.promotions >= 1
    used = it.tier_history[:it.iters].numpy()
    assert used[0] == 0 and used[-1] > 0


def test_adaptive_pcg_edges():
    a = _laplace1d(16)
    ops = top.OperatorSet(a, C=8, sigma=32, device="cpu")
    with pytest.raises(ValueError, match="at least one tier"):
        tcg.adaptive_pcg([], torch.ones(16))
    # a zero right-hand side is already solved: no outer step
    x, info = tcg.adaptive_pcg([ops.matvec("fp32")], torch.zeros(16,
                               dtype=torch.float64))
    assert info.iters == 0 and info.hi_matvecs == 1 and not x.any()
    # maxiter caps the outer steps; the last tier is the default matvec_hi
    _, info = tcg.adaptive_pcg([ops.matvec("plan_e8m1"), ops.matvec("fp64")],
                               torch.ones(16, dtype=torch.float64), m_in=1,
                               maxiter=2, tol=0.0)
    assert info.iters == 2 and info.hi_matvecs == 3
