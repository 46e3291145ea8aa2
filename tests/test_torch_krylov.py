"""repro_torch's Krylov layer against the reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference's
function and the port's, at the reference tests' sizes: the n = 576 SPD
system of ``tests/test_solvers.py`` and sym-scaled HPCG 6³–12³, with
C = 8 and σ = 32.

- ``ops.sell_spmv`` and the plain ``sell_spmv`` gather by the matrix's
  row → stored-row map: bit-equal to the masked scatter they replace, on
  every dense kind and with empty buckets.
- ``packsell_<codec>`` matvecs: bit-equal to the reference's
  ``packsell_spmv_jnp``.
- ``neumann_ainv``, ``pcg_fixed_iters``, ``richardson_fixed_iters`` and
  ``fgmres_fixed_cycles``: outputs within rtol 1e-5 in float32 and 1e-12
  in float64 (elementwise, with an absolute floor of rtol · max |ref|).
- ``fcg``, ``fgmres``, IO-CG (all five variants and ``pcg_reference``)
  and F3R (three presets): the reference's iteration counts, and x within
  1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import testmats as rtm
from repro.solvers import cg as rcg
from repro.solvers import f3r as rf3r
from repro.solvers import gmres as rgm
from repro.solvers import iocg as riocg
from repro.solvers import operators as rop
from repro.solvers import precond as rpc
from repro.solvers import richardson as rri
from repro_torch import solvers as tsolvers
from repro_torch.core import sell as tsl
from repro_torch.kernels import ops as tops
from repro_torch.solvers import cg as tcg
from repro_torch.solvers import f3r as tf3r
from repro_torch.solvers import gmres as tgm
from repro_torch.solvers import iocg as tiocg
from repro_torch.solvers import operators as top
from repro_torch.solvers import precond as tpc
from repro_torch.solvers import richardson as tri

TOL = 1e-9
SUITE = rtm.suite("tiny")
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "float64": (torch.float64, jnp.float64, 1e-12)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The solves run thousands of small tensor ops; one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(got: torch.Tensor, want, rtol: float) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _bits(a: torch.Tensor, b) -> None:
    b = torch.from_numpy(np.array(b))
    assert a.dtype == b.dtype and a.shape == b.shape
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    assert torch.equal(a.view(view), b.view(view))


def _spd():
    """The reference tests' SPD system (``tests/test_solvers.py``)."""
    a = rtm.stencil_3d(8, 8, 9, neighbours=27)
    s, _ = rop.sym_scale(a.tocsr())
    return s, np.random.default_rng(0).random(a.shape[0])


def _hpcg(side: int, seed: int = 0):
    s, _ = rop.sym_scale(rtm.hpcg(side, side, side))
    return s, np.random.default_rng(seed).standard_normal(s.shape[0])


def _pair(s):
    return (rop.OperatorSet(s, C=8, sigma=32),
            top.OperatorSet(s, C=8, sigma=32, device="cpu"))


def test_solvers_package_exports():
    for name in ("fcg", "pcg_fixed_iters", "neumann_ainv",
                 "richardson_fixed_iters", "fgmres", "fgmres_fixed_cycles",
                 "iocg", "f3r"):
        assert hasattr(tsolvers, name), name


# ---------------------------------------------------------------------------
# The SELL gather (the host-sync repair)
# ---------------------------------------------------------------------------


def _old_scatter(mat, parts, dtype) -> torch.Tensor:
    """The masked scatter ``ops.sell_spmv`` ran before the row map."""
    y = torch.zeros((mat.n,), dtype=dtype)
    if not parts:
        return y
    t_cat = torch.cat([p.reshape(-1) for p in parts])
    outrow = torch.cat([o.reshape(-1) for o in mat.outrows]).long()
    keep = outrow < mat.n
    y[outrow[keep]] = t_cat[keep]
    return y


def _with_empty_buckets(mat):
    """The same matrix with an empty bucket before, between and after
    its buckets (``from_arrays`` of its leaves)."""
    def host(v):
        return (v.view(torch.int16) if v.dtype == torch.bfloat16
                else v).numpy()

    C = mat.C
    vals, cols, outs = [], [], []
    empty_v = host(torch.zeros((0, 4, C), dtype=mat.vals[0].dtype))
    for v, c, o in zip(mat.vals, mat.cols, mat.outrows):
        vals += [empty_v, host(v)]
        cols += [np.zeros((0, 4, C), np.int32), c.numpy()]
        outs += [np.zeros((0,), np.int32), o.numpy()]
    vals.append(empty_v)
    cols.append(np.zeros((0, 4, C), np.int32))
    outs.append(np.zeros((0,), np.int32))
    meta = {k: getattr(mat, k) for k in tsl.SELLMatrix.STATIC}
    return tsl.from_arrays((vals, cols, outs, mat.perm.numpy()), meta,
                           device="cpu")


@pytest.mark.parametrize("klass", ["hpcg_mini", "scattered", "powerlaw"])
@pytest.mark.parametrize("kind", ["fp64", "fp32", "fp16", "bf16"])
def test_sell_gather_bit_equal_old_scatter(klass, kind):
    ops = top.OperatorSet(SUITE[klass], C=8, sigma=32, device="cpu")
    mat = ops.stored(kind)
    comp = torch.float64 if kind == "fp64" else torch.float32
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(mat.m))
    for m in (mat, _with_empty_buckets(mat)):
        parts = [tsl.sell_bucket_spmv(v, c, x, comp)
                 for v, c in zip(m.vals, m.cols)]
        want = _old_scatter(m, parts, comp)
        for got in (tops.sell_spmv(m, x, comp), tsl.sell_spmv(m, x, comp),
                    tsl.gather_rows(m, parts, comp)):
            _bits(got, want.numpy())
    assert len(_with_empty_buckets(mat).vals) == 2 * len(mat.vals) + 1


def test_sell_row_map_rejects_rows_stored_twice_or_never():
    mat = tsl.from_csr(SUITE["hpcg_mini"], C=8, sigma=32, device="cpu")
    leaves = ([v.numpy() for v in mat.vals], [c.numpy() for c in mat.cols],
              [o.numpy().copy() for o in mat.outrows], mat.perm.numpy())
    leaves[2][0][1] = leaves[2][0][0]
    meta = {k: getattr(mat, k) for k in tsl.SELLMatrix.STATIC}
    with pytest.raises(ValueError, match="exactly once"):
        tsl.from_arrays(leaves, meta, device="cpu")


# ---------------------------------------------------------------------------
# packsell_<codec>
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("klass", ["hpcg_mini", "banded", "scattered"])
@pytest.mark.parametrize("codec", ["fp16", "bf16", "e8m8", "e8m12", "e8m1"])
def test_packsell_kind_bit_equal_reference(klass, codec):
    s, _ = rop.sym_scale(SUITE[klass])
    rops, tops_ = _pair(s)
    kind = f"packsell_{codec}"
    x = np.random.default_rng(4).standard_normal(s.shape[1]).astype(
        np.float32)
    got = tops_.matvec(kind)(torch.from_numpy(x))
    _bits(got, rops.matvec(kind)(jnp.asarray(x)))
    assert tops_.stored(kind).memory_stats() == \
        rops.stored(kind).memory_stats()
    # a forced plan variant runs the plan (its plain versions on the CPU),
    # in another order of the sum
    for force in ("fused", "full", "jnp"):
        y = top.OperatorSet(s, C=8, sigma=32, device="cpu",
                            force=force).matvec(kind)(torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), got.numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# The fixed-iteration pieces, output for output
# ---------------------------------------------------------------------------


def _kind(dtype: str) -> str:
    return "fp64" if dtype == "float64" else "fp32"


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_neumann_ainv_matches(dtype, k):
    s, r = _hpcg(8)
    rops, tops_ = _pair(s)
    tdt, rdt, rtol = DTYPES[dtype]
    kind = _kind(dtype)
    got = tpc.neumann_ainv(tops_.diag(), tops_.matvec(kind), k=k, dtype=tdt,
                           device="cpu")(torch.from_numpy(r))
    want = rpc.neumann_ainv(rops.diag(), rops.matvec(kind), k=k,
                            dtype=rdt)(jnp.asarray(r))
    _close(got, want, rtol)


@pytest.mark.parametrize("dtype,kind", [("float32", "fp32"),
                                        ("float32", "packsell_e8m8"),
                                        ("float32", "fp16"),
                                        ("float64", "fp64")])
def test_pcg_fixed_iters_matches(dtype, kind):
    s, r = _hpcg(8, seed=1)
    rops, tops_ = _pair(s)
    tdt, rdt, rtol = DTYPES[dtype]
    tA, rA = tops_.matvec(kind), rops.matvec(kind)
    got = tcg.pcg_fixed_iters(
        tA, tpc.neumann_ainv(tops_.diag(), tA, dtype=tdt, device="cpu"), 20,
        dtype=tdt)(torch.from_numpy(r))
    want = rcg.pcg_fixed_iters(rA, rpc.neumann_ainv(rops.diag(), rA,
                                                    dtype=rdt), 20,
                               dtype=rdt)(jnp.asarray(r))
    _close(got, want, rtol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_richardson_fixed_iters_matches(dtype):
    s, r = _hpcg(8, seed=2)
    rops, tops_ = _pair(s)
    tdt, rdt, rtol = DTYPES[dtype]
    kind = _kind(dtype)
    tA, rA = tops_.matvec(kind), rops.matvec(kind)
    got = tri.richardson_fixed_iters(
        tA, tpc.neumann_ainv(tops_.diag(), tA, dtype=tdt, device="cpu"), 4,
        dtype=tdt)(torch.from_numpy(r))
    want = rri.richardson_fixed_iters(
        rA, rpc.neumann_ainv(rops.diag(), rA, dtype=rdt), 4,
        dtype=rdt)(jnp.asarray(r))
    _close(got, want, rtol)


@pytest.mark.parametrize("m,cycles", [(5, 1), (10, 2)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fgmres_fixed_cycles_matches(dtype, m, cycles):
    s, r = _hpcg(8, seed=3)
    rops, tops_ = _pair(s)
    tdt, rdt, rtol = DTYPES[dtype]
    kind = _kind(dtype)
    tA, rA = tops_.matvec(kind), rops.matvec(kind)
    got = tgm.fgmres_fixed_cycles(
        tA, tpc.jacobi(tops_.diag(), dtype=tdt, device="cpu"), m, cycles,
        dtype=tdt)(torch.from_numpy(r))
    want = rgm.fgmres_fixed_cycles(
        rA, rpc.jacobi(rops.diag(), dtype=rdt), m, cycles,
        dtype=rdt)(jnp.asarray(r))
    _close(got, want, rtol)


def test_lstsq_drops_small_singular_values_as_the_reference():
    """A rank-deficient Hessenberg: the minimum-norm solution of
    ``jnp.linalg.lstsq`` (singular values below eps·max(shape)·s_max
    dropped), in float32 and float64."""
    rng = np.random.default_rng(5)
    H = np.triu(rng.standard_normal((6, 5)), -1)
    H[:, 4] = H[:, 3]
    for dt in (np.float32, np.float64):
        Ht = torch.from_numpy(H.astype(dt))
        y, res = tgm._lstsq(Ht, torch.tensor(2.0, dtype=Ht.dtype))
        e1 = np.zeros(6, dt)
        e1[0] = 2.0
        want, *_ = jnp.linalg.lstsq(jnp.asarray(H.astype(dt)),
                                    jnp.asarray(e1))
        assert y.dtype == Ht.dtype
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(res, np.linalg.norm(
            e1 - H @ np.asarray(want, np.float64)), rtol=1e-4)
    y, res = tgm._lstsq(torch.zeros((3, 2)), torch.tensor(0.0))
    assert not y.any() and res == 0.0


# ---------------------------------------------------------------------------
# The solvers, iteration for iteration
# ---------------------------------------------------------------------------


def _same_solve(xt, it, xr, ir, hist_rtol: float = 1e-3) -> None:
    """Same iterations, x within 1e-6, relres histories within
    ``hist_rtol`` (or 1e-3 of the tolerance, at the rounding floor). An
    outer step whose preconditioner is a float32 inner solve ends near
    float32's floor, which the two packages' dot products reach by
    different roundings: those histories agree to 0.1."""
    assert it.iters == int(ir.iters)
    assert xt.dtype == torch.float64
    assert _rel(xt.numpy(), xr) <= 1e-6
    k = it.iters
    np.testing.assert_allclose(it.history[:k + 1].numpy(),
                               np.asarray(ir.history)[:k + 1],
                               rtol=hist_rtol, atol=1e-3 * TOL)
    assert (it.history[k + 1:] == -1).all()


@pytest.mark.parametrize("side", [6, 12])
def test_fcg_matches_reference(side):
    """FCG with a fixed (Jacobi) and with a flexible (inner PCG)
    preconditioner."""
    s, b = _hpcg(side, seed=6)
    rops, tops_ = _pair(s)
    bt, br = torch.from_numpy(b), jnp.asarray(b)
    xt, it = tcg.fcg(tops_.matvec("fp64"), bt, M=tpc.jacobi(
        tops_.diag(), dtype=torch.float64, device="cpu"), tol=TOL,
        maxiter=500)
    xr, ir = rcg.fcg(rops.matvec("fp64"), br, M=rpc.jacobi(
        rops.diag(), dtype=jnp.float64), tol=TOL, maxiter=500)
    _same_solve(xt, it, xr, ir)
    assert it.iters > 10
    tA, rA = tops_.matvec("fp32"), rops.matvec("fp32")
    xt, it = tcg.fcg(tops_.matvec("fp64"), bt, M=tcg.pcg_fixed_iters(
        tA, tpc.jacobi(tops_.diag(), device="cpu"), 5), tol=TOL, maxiter=500)
    xr, ir = rcg.fcg(rops.matvec("fp64"), br, M=rcg.pcg_fixed_iters(
        rA, rpc.jacobi(rops.diag()), 5), tol=TOL, maxiter=500)
    _same_solve(xt, it, xr, ir, 0.1)


@pytest.mark.parametrize("system,m", [("hpgmp6", 30), ("hpcg8", 8)])
def test_fgmres_matches_reference(system, m):
    """The reference test's nonsymmetric HPGMP 6³ at m = 30, and HPCG 8³
    at m = 8, which restarts."""
    if system == "hpgmp6":
        s, _ = rop.sym_scale(rtm.hpgmp(6, 6, 6).tocsr())
        b = np.random.default_rng(1).random(s.shape[0])
    else:
        s, b = _hpcg(8, seed=7)
    rops, tops_ = _pair(s)
    xt, it = tgm.fgmres(tops_.matvec("fp64"), torch.from_numpy(b),
                        M=tpc.jacobi(tops_.diag(), dtype=torch.float64,
                                     device="cpu"), m=m, tol=TOL,
                        max_cycles=50)
    xr, ir = rgm.fgmres(rops.matvec("fp64"), jnp.asarray(b),
                        M=rpc.jacobi(rops.diag(), dtype=jnp.float64), m=m,
                        tol=TOL, max_cycles=50)
    _same_solve(xt, it, xr, ir)
    assert float(it.relres) < TOL
    if system == "hpcg8":
        assert it.iters > 1


@pytest.fixture(scope="module")
def spd_pair():
    s, b = _spd()
    return s, b, _pair(s)


@pytest.mark.parametrize("name", ["fp64", "fp32", "fp16", "e8m8", "e8m12"])
def test_iocg_matches_reference(spd_pair, name):
    s, b, (rops, tops_) = spd_pair
    cfg_t, cfg_r = tiocg.variant(name), riocg.variant(name)
    assert cfg_t.__dict__ == cfg_r.__dict__
    xt, it = tiocg.solve(tops_, torch.from_numpy(b), cfg_t)
    xr, ir = riocg.solve(rops, jnp.asarray(b), cfg_r)
    _same_solve(xt, it, xr, ir, 1e-3 if name == "fp64" else 0.1)
    assert np.linalg.norm(b - s @ xt.numpy()) / np.linalg.norm(b) < 5 * TOL


def test_iocg_variant_rejects_unknown():
    with pytest.raises(ValueError):
        tiocg.variant("fp8")


def test_pcg_reference_matches_reference(spd_pair):
    s, b, (rops, tops_) = spd_pair
    xt, it = tiocg.pcg_reference(tops_, torch.from_numpy(b))
    xr, ir = riocg.pcg_reference(rops, jnp.asarray(b))
    _same_solve(xt, it, xr, ir)
    assert it.iters > 5


@pytest.fixture(scope="module")
def f3r_runs(spd_pair):
    s, b, (rops, tops_) = spd_pair
    out = {}
    for name in ("fp64", "fp16", "packsell"):
        assert tf3r.presets(name).__dict__ == rf3r.presets(name).__dict__
        out[name] = (tf3r.solve(tops_, torch.from_numpy(b),
                                tf3r.presets(name)),
                     rf3r.solve(rops, jnp.asarray(b), rf3r.presets(name)))
    return out


@pytest.mark.parametrize("name", ["fp64", "fp16", "packsell"])
def test_f3r_matches_reference(spd_pair, f3r_runs, name):
    s, b, _ = spd_pair
    (xt, it), (xr, ir) = f3r_runs[name]
    _same_solve(xt, it, xr, ir)
    assert np.linalg.norm(b - s @ xt.numpy()) / np.linalg.norm(b) < 5 * TOL


def test_f3r_fp16_and_packsell_take_the_same_cycles(f3r_runs):
    """Paper §5.2.1: FP16 values embed exactly in PackSELL fp16/D15."""
    assert f3r_runs["fp16"][0][1].iters == f3r_runs["packsell"][0][1].iters
    with pytest.raises(ValueError):
        tf3r.presets("bf16")
