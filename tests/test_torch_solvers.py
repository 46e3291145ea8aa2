"""repro_torch solvers against the reference, on the CPU: the scalings,
the operator-kind parser, the preconditioners, PCG on a dense SPD
operator, and the slice as a whole — Jacobi-PCG in stored-row order over
sym-scaled HPCG through ``OperatorSet.plan_pair`` stops at the reference's
iteration with ||x_port - x_ref|| / ||x_ref|| <= 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import testmats as rtm
from repro.solvers import cg as rcg
from repro.solvers import operators as rop
from repro.solvers import precond as rpc
from repro_torch.kernels import plan as tpl
from repro_torch.solvers import cg as tcg
from repro_torch.solvers import operators as top
from repro_torch.solvers import precond as tpc

SUITE = rtm.suite("tiny")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("klass", sorted(SUITE))
def test_scalings_identical(klass):
    a = SUITE[klass]
    for scale in ("row_scale", "sym_scale"):
        (st, gt), (sr, gr) = (getattr(top, scale)(a), getattr(rop, scale)(a))
        st, sr = st.tocsr(), sr.tocsr()
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(st, f), getattr(sr, f))
        np.testing.assert_array_equal(gt, gr)


@pytest.mark.parametrize("kind", [
    "fp64", "bf16", "csr64", "plan_fp16", "plan_bf16", "plan_e8m8",
    "packsell_e8m12", "dist_fp16", "auto:1e-3", "mixed:2.5e-2",
    "dist_auto:1e-4", "dist_mixed:1e-3", "guarded:plan_e8m8",
    # malformed: the same ValueError text
    "plan_fp8", "plan_e8mx", "auto:abc", "auto:-1", "guarded:fp32",
    "guarded:", "sparse", 7])
def test_parse_kind_matches_reference(kind):
    try:
        want = rop.parse_kind(kind)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            top.parse_kind(kind)
        assert str(got.value) == str(e)
        return
    got = top.parse_kind(kind)
    fields = ("raw", "family", "codec", "D", "budget", "distributed")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]
    assert (got.inner is None) == (want.inner is None)
    assert top.KIND_MENU == rop.KIND_MENU


@pytest.mark.parametrize("kind", ["csr64", "dist_fp16", "mixed:1e-3",
                                  "dist_auto:1e-3", "dist_mixed:1e-3",
                                  "guarded:plan_fp16"])
def test_operator_families_build_and_match(kind):
    """Every family outside ``plan_`` builds: ``csr64``, ``mixed:`` and
    ``guarded:`` within 1e-3 of the fp64 product, and the distributed
    families (one shard on the set's device, as the reference's without
    the XLA flag) equal to the reference's kind within 1e-6, with
    ``dist_plan`` their DistSpMVPlan. No family but ``plan_`` gives a
    ``plan_pair``."""
    a = SUITE["hpcg_mini"]
    ops = top.OperatorSet(a, device="cpu")
    x = torch.ones(ops.n)
    if top.parse_kind(kind).distributed:
        want = torch.from_numpy(np.asarray(rop.OperatorSet(a).matvec(kind)(
            jnp.ones(ops.n, jnp.float32))))
        torch.testing.assert_close(ops.matvec(kind)(x), want, rtol=1e-6,
                                   atol=1e-6)
        assert ops.dist_plan(kind).n_shards == 1
        assert ops.dist_plan(kind).spmv is not None
    else:
        want = torch.from_numpy(a @ np.ones(ops.n))
        torch.testing.assert_close(ops.matvec(kind)(x).double(), want,
                                   rtol=1e-3, atol=1e-3)
        with pytest.raises(ValueError, match="not a distributed kind"):
            ops.dist_plan(kind)
    with pytest.raises(ValueError, match="not a plan_ kind"):
        ops.plan_pair(kind)


def test_operator_set_plan_kind_matches_reference():
    s, _ = rop.sym_scale(SUITE["banded"])
    x = np.random.default_rng(2).standard_normal(s.shape[1]).astype(
        np.float32)
    ref = rop.OperatorSet(s)
    port = top.OperatorSet(s, device="cpu")
    np.testing.assert_array_equal(port.diag(), ref.diag())
    for kind in ("plan_fp16", "plan_e8m8"):
        y = port.matvec(kind)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(y, np.asarray(ref.matvec(kind)(
            jnp.asarray(x))), rtol=1e-6, atol=1e-6)
        assert port.stored(kind).memory_stats() == \
            ref.stored(kind).memory_stats()
        mat, plan = port.plan_pair(kind)
        assert mat is port.stored(kind) and plan is tpl.get_plan(mat)


def test_preconditioners_match():
    diag = np.array([4.0, 0.0, -2.0, 0.5])
    r = np.array([1.0, 2.0, 3.0, 4.0])
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.float64, jnp.float64)):
        got = tpc.jacobi(diag, dtype=dtype, device="cpu")(torch.from_numpy(r))
        want = rpc.jacobi(diag, dtype=jdt)(jnp.asarray(r))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tpc.identity()(torch.from_numpy(r)) is not None


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pcg_matches_reference_on_dense_spd(dtype):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((60, 60))
    a = q @ q.T + 60 * np.eye(60)
    b = rng.standard_normal(60)
    at, ar = torch.from_numpy(a), jnp.asarray(a)
    dt, dr = getattr(torch, dtype), getattr(jnp, dtype)
    xt, it = tcg.pcg(lambda v: at.to(v.dtype) @ v, torch.from_numpy(b),
                     M=tpc.jacobi(np.diag(a), dtype=dt, device="cpu"),
                     tol=1e-6 if dtype == "float32" else 1e-10,
                     maxiter=200, dtype=dt)
    xr, ir = rcg.pcg(lambda v: ar.astype(v.dtype) @ v, jnp.asarray(b),
                     M=rpc.jacobi(np.diag(a), dtype=dr),
                     tol=1e-6 if dtype == "float32" else 1e-10,
                     maxiter=200, dtype=dr)
    assert it.iters == int(ir.iters)
    assert xt.dtype == dt
    assert _rel(xt.numpy(), xr) <= (1e-5 if dtype == "float32" else 1e-10)
    k = it.iters
    np.testing.assert_allclose(it.history[:k + 1].numpy(),
                               np.asarray(ir.history)[:k + 1], rtol=1e-4)
    assert (it.history[k + 1:] == -1).all()


@pytest.mark.parametrize("side", [8, 12])
@pytest.mark.parametrize("kind", ["plan_fp16", "plan_bf16"])
def test_jacobi_pcg_stored_matches_reference(side, kind):
    """The slice end to end: sym-scaled HPCG, OperatorSet.plan_pair,
    Jacobi-PCG in stored-row order with float64 outer vectors."""
    s, _ = rop.sym_scale(rtm.hpcg(side, side, side))
    n = s.shape[0]
    rmat, rplan = rop.OperatorSet(s).plan_pair(kind)
    xr, ir = rcg.jacobi_pcg_stored(rmat, rplan, s.diagonal(),
                                   jnp.ones(n, jnp.float64), tol=1e-8,
                                   maxiter=500)
    tmat, tplan = top.OperatorSet(s, device="cpu").plan_pair(kind)
    assert tplan.variant == rplan.variant == "jnp"
    b = torch.ones(n, dtype=torch.float64)
    xt, it = tcg.jacobi_pcg_stored(tmat, tplan, s.diagonal(), b, tol=1e-8,
                                   maxiter=500)
    assert xt.dtype == torch.float64
    assert it.iters == int(ir.iters) > 5
    assert float(it.relres) < 1e-8
    assert _rel(xt.numpy(), xr) <= 1e-6
    # the kernel wrapper's path (its plain version on the CPU), asked for
    # through the operator set, stops at the same iteration
    fmat, fplan = top.OperatorSet(s, device="cpu",
                                  force="fused").plan_pair(kind)
    assert fplan.variant == "fused" and fplan is tpl.get_plan(fmat,
                                                             force="fused")
    xf, itf = tcg.jacobi_pcg_stored(fmat, fplan, s.diagonal(), b, tol=1e-8,
                                    maxiter=500)
    assert itf.iters == it.iters
    assert _rel(xf.numpy(), xr) <= 1e-6
