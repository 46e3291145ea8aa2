"""repro_torch's reordering and PackSELL triangular solve against the
reference, on the CPU: RCM's permutation, the reordered matrix and its
bandwidth equal the reference's; ``split_triangular``, ``n_levels`` and
``PackSELLTriSolver`` give the reference's levels and a solution within
1e-6 of the reference's (relative, float32), on sym-scaled HPCG 6³–12³
and the reference tests' banded systems."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

from repro.core import reorder as rro
from repro.core import testmats as rtm
from repro.core import trisolve as rts
from repro.solvers import operators as rop
from repro_torch import core as tcore
from repro_torch.core import reorder as tro
from repro_torch.core import trisolve as tts


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _symmetric(name: str) -> sp.csr_matrix:
    if name.startswith("hpcg"):
        side = int(name[4:])
        return rop.sym_scale(rtm.hpcg(side, side, side))[0]
    if name == "stencil1d":
        return rtm.stencil_1d(200, 2).tocsr()
    a = {"scattered": rtm.scattered(400, nnz_per_row=4, seed=0),
         "powerlaw": rtm.powerlaw(300, mean_deg=4)}[name]
    return (a + a.T).tocsr()


SYMMETRIC = ["hpcg6", "hpcg8", "stencil1d", "scattered", "powerlaw"]


def test_core_package_exports():
    assert tcore.reorder is tro and tcore.trisolve is tts


@pytest.mark.parametrize("name", SYMMETRIC)
def test_rcm_equal_reference(name):
    a = _symmetric(name)
    for sym in (False, True):
        np.testing.assert_array_equal(tro.rcm_permutation(a, sym),
                                      rro.rcm_permutation(a, sym))
    at, pt = tro.rcm_reorder(a)
    ar, pr = rro.rcm_reorder(a)
    np.testing.assert_array_equal(pt, pr)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(at, f), getattr(ar, f))
    assert tro.bandwidth(a) == rro.bandwidth(a)
    assert tro.bandwidth(at) == rro.bandwidth(ar)


def test_rcm_edges():
    with pytest.raises(ValueError, match="square"):
        tro.rcm_permutation(sp.csr_matrix((3, 4)))
    assert tro.bandwidth(sp.csr_matrix((5, 5))) == 0


def _factor(name: str, lower: bool) -> sp.csr_matrix:
    a = (_symmetric(name) if name.startswith("hpcg")
         else rtm.stencil_1d(300, 2, spd=True, seed=0))
    t = (sp.tril(a) if lower else sp.triu(a)).tocsr()
    t.sort_indices()
    return t


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", ["hpcg6", "hpcg8", "hpcg12", "stencil1d"])
def test_trisolve_matches_reference(name, lower):
    t = _factor(name, lower)
    b = np.random.default_rng(1).standard_normal(t.shape[0])
    xt, st = tts.trisolve(t, b, lower=lower, D=1, C=8, sigma=32,
                          device="cpu")
    xr, sr = rts.trisolve(t, b, lower=lower, D=1, C=8, sigma=32)
    assert st.levels == sr.levels == tts.n_levels(
        tts.split_triangular(t, lower)[0], lower)
    assert xt.dtype == torch.float32
    assert _rel(xt.numpy(), xr) <= 1e-6
    assert st.memory_stats() == sr.memory_stats()
    want = spsolve_triangular(t, b, lower=lower)
    assert _rel(xt.numpy(), want) <= 1e-5
    # the plan's plain versions (a forced variant) on the CPU
    for force in ("fused", "full"):
        xf, _ = tts.trisolve(t, b, lower=lower, D=1, C=8, sigma=32,
                             device="cpu", force=force)
        assert _rel(xf.numpy(), xr) <= 1e-6


def test_trisolve_exact_only_at_level_count():
    """The reference test's non-contractive factor: exact at n_levels,
    divergent at half of them."""
    n = 60
    lo = (sp.eye(n, format="csr") + sp.diags(
        [-1.2 * np.ones(n - 1)], [-1], format="csr")).tocsr()
    lo.sort_indices()
    b = np.random.default_rng(2).standard_normal(n)
    st = tts.PackSELLTriSolver(lo, lower=True, D=1, device="cpu")
    sr = rts.PackSELLTriSolver(lo, lower=True, D=1)
    assert st.levels == sr.levels == n
    for iters in (None, n // 2):
        np.testing.assert_allclose(
            st.solve(torch.from_numpy(b), iters=iters).numpy(),
            np.asarray(sr.solve(jnp.asarray(b), iters=iters)), rtol=1e-6,
            atol=1e-6)


def test_split_triangular_rejects_as_reference():
    a = rtm.stencil_1d(50, 1)
    for mod in (tts, rts):
        with pytest.raises(ValueError, match="not triangular"):
            mod.split_triangular(a, True)
    z = sp.tril(a).tolil()
    z[3, 3] = 0
    for mod in (tts, rts):
        with pytest.raises(ValueError, match="nonzero diagonal"):
            mod.split_triangular(z.tocsr(), True)
