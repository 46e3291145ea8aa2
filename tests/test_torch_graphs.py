"""repro_torch's graph-run solvers (``solvers/graphs.py``) on the CPU.

On the CPU a graph runs its body where the card would replay it, with
the same static buffers, so these tests hold the chunked and masked step
functions to the eager loops (``graphs.eager()``):

- ``pcg``, ``jacobi_pcg_stored``, ``fcg``, ``adaptive_pcg`` (a ladder
  that promotes) and FGMRES (``fgmres``), at chunk lengths 1, 3 and 8:
  the eager loop's iteration counts, histories and x bit for bit, and
  the reference's iteration counts with x within 1e-6
  (``tests/test_torch_krylov.py``'s tolerance) on the same seeded numpy
  inputs; a loop that stops inside a chunk runs that chunk's steps up to
  the stop again, one that stops at its end does not;
- ``fgmres_fixed_cycles`` (F3R's L3): one Arnoldi graph per cycle that
  replays whether the eager loop or the graphs ran first;
- ``neumann_ainv``, ``pcg_fixed_iters``, ``richardson_fixed_iters``, the
  triangular solve, IO-CG and F3R: bit for bit against their eager
  bodies, twice in a row from the cache;
- every captured body runs without a host read: a dispatch mode that
  raises on ``aten._local_scalar_dense``, ``aten.nonzero`` and copies to
  the CPU wraps each body run (the CPU's stand-in for
  ``torch.cuda.set_sync_debug_mode("error")``);
- the static-buffer rule: two applications in a row give independent
  results, and a graph's own output buffer is overwritten by its next
  call;
- no graph sits in a reference cycle: each dies with its owner with the
  garbage collector off.
"""
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import testmats as rtm
from repro.solvers import cg as rcg
from repro.solvers import gmres as rgm
from repro.solvers import operators as rop
from repro.solvers import precond as rpc
from repro.precision import select as rsel
from repro_torch.core import trisolve as ttri
from repro_torch.precision import select as tsel
from repro_torch.solvers import cg as tcg
from repro_torch.solvers import f3r as tf3r
from repro_torch.solvers import gmres as tgm
from repro_torch.solvers import graphs
from repro_torch.solvers import iocg as tiocg
from repro_torch.solvers import operators as top
from repro_torch.solvers import precond as tpc
from repro_torch.solvers import richardson as tri

CHUNKS = (1, 3, 8)
TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bits(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    view = {torch.float64: torch.int64, torch.float32: torch.int32}.get(
        a.dtype)
    assert torch.equal(a.view(view), b.view(view)) if view else \
        torch.equal(a, b)


def _same(got, want) -> None:
    """Two (x, SolveInfo) results equal bit for bit."""
    (xg, ig), (xw, iw) = got, want
    assert ig.iters == iw.iters
    _bits(xg, xw)
    _bits(ig.history, iw.history)
    _bits(ig.relres, iw.relres)


def _hpcg(side: int, seed: int):
    s, _ = rop.sym_scale(rtm.hpcg(side, side, side))
    return s, np.random.default_rng(seed).standard_normal(s.shape[0])


@pytest.fixture(scope="module")
def hpcg8():
    s, b = _hpcg(8, seed=3)
    return s, b, (rop.OperatorSet(s, C=8, sigma=32),
                  top.OperatorSet(s, C=8, sigma=32, device="cpu"))


# ---------------------------------------------------------------------------
# The stopping loops: chunked and masked against eager and the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", CHUNKS)
def test_pcg_chunks_equal_eager_and_reference(hpcg8, chunk):
    s, b, (rops, tops_) = hpcg8
    A = tops_.matvec("fp64")
    M = tpc.neumann_ainv(tops_.diag(), A, dtype=torch.float64, device="cpu")
    bt = torch.from_numpy(b)
    with graphs.eager():
        want = tcg.pcg(A, bt, M=M, tol=TOL, maxiter=300)
    got = tcg.pcg(A, bt, M=M, tol=TOL, maxiter=300, chunk=chunk)
    _same(got, want)
    assert (got[1].history[got[1].iters + 1:] == -1).all()
    xr, ir = rcg.pcg(rops.matvec("fp64"), jnp.asarray(b),
                     M=rpc.neumann_ainv(rops.diag(), rops.matvec("fp64"),
                                        dtype=jnp.float64),
                     tol=TOL, maxiter=300)
    assert got[1].iters == int(ir.iters) > chunk
    assert _rel(got[0].numpy(), xr) <= 1e-6


@pytest.mark.parametrize("chunk", CHUNKS)
def test_pcg_maxiter_cuts_inside_a_chunk(hpcg8, chunk):
    """maxiter = 7 ends inside a chunk of 3 and of 8: the steps
    past it change nothing."""
    s, b, (_, tops_) = hpcg8
    A = tops_.matvec("fp32")
    bt = torch.from_numpy(b)
    with graphs.eager():
        want = tcg.pcg(A, bt, tol=0.0, maxiter=7)
    got = tcg.pcg(A, bt, tol=0.0, maxiter=7, chunk=chunk)
    _same(got, want)
    assert got[1].iters == 7


@pytest.mark.parametrize("maxiter, chunk", [(7, 3), (6, 3), (7, 8),
                                             (8, 8), (5, 1)])
def test_pcg_reruns_the_steps_of_the_stopping_chunk(hpcg8, maxiter, chunk):
    """The chunks run the eager steps; where the loop stopped ``j`` steps
    into a chunk, those ``j`` steps run again from the chunk's start, as
    one graph. So the matvecs are whole chunks plus ``maxiter mod
    chunk``; the result is the eager loop's either way."""
    s, b, (_, tops_) = hpcg8
    A = tops_.matvec("fp32")
    calls = []

    def counted(v):
        calls.append(1)
        return A(v)

    bt = torch.from_numpy(b)
    with graphs.eager():
        want = tcg.pcg(counted, bt, tol=0.0, maxiter=maxiter)
    assert len(calls) == 1 + maxiter
    calls.clear()
    cache = {}
    got = tcg.pcg(counted, bt, tol=0.0, maxiter=maxiter, chunk=chunk,
                  jit_cache=cache, jit_key="A")
    _same(got, want)
    (loop,) = cache.values()
    j = maxiter % chunk
    assert len(calls) == 1 + -(-maxiter // chunk) * chunk + j
    assert sorted(loop.rerun) == ([j] if j else [])
    _same(tcg.pcg(counted, bt, tol=0.0, maxiter=maxiter, chunk=chunk,
                  jit_cache=cache, jit_key="A"), want)
    assert [g.replays for g in loop.rerun.values()] == ([1] if j else [])


def test_pcg_without_steps_and_chunk_check():
    a = torch.from_numpy(np.diag(np.arange(1.0, 9.0)))
    b = torch.ones(8, dtype=torch.float64)
    x, info = tcg.pcg(lambda v: a @ v, b, maxiter=0)
    assert info.iters == 0 and not x.any()
    assert (info.history[1:] == -1).all()
    with pytest.raises(ValueError, match="chunk"):
        tcg.pcg(lambda v: a @ v, b, chunk=0)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", ["plan_fp16", "plan_bf16"])
def test_jacobi_pcg_stored_chunks_equal_eager_and_reference(chunk, kind):
    s, _ = rop.sym_scale(rtm.hpcg(8, 8, 8))
    n = s.shape[0]
    tmat, tplan = top.OperatorSet(s, device="cpu").plan_pair(kind)
    b = torch.ones(n, dtype=torch.float64)
    with graphs.eager():
        want = tcg.jacobi_pcg_stored(tmat, tplan, s.diagonal(), b, tol=1e-8,
                                     maxiter=500)
    got = tcg.jacobi_pcg_stored(tmat, tplan, s.diagonal(), b, tol=1e-8,
                                maxiter=500, chunk=chunk)
    _same(got, want)
    # the second solve replays the graphs cached on the plan
    n_fns = len(tplan._fns)
    _same(tcg.jacobi_pcg_stored(tmat, tplan, s.diagonal(), b, tol=1e-8,
                                maxiter=500, chunk=chunk), want)
    assert len(tplan._fns) == n_fns
    rmat, rplan = rop.OperatorSet(s).plan_pair(kind)
    xr, ir = rcg.jacobi_pcg_stored(rmat, rplan, s.diagonal(),
                                   jnp.ones(n, jnp.float64), tol=1e-8,
                                   maxiter=500)
    assert got[1].iters == int(ir.iters) > 5
    assert _rel(got[0].numpy(), xr) <= 1e-6


@pytest.mark.parametrize("chunk", CHUNKS)
def test_fcg_chunks_equal_eager_and_reference(hpcg8, chunk):
    """FCG preconditioned by an inner fp32 PCG (IO-CG's structure)."""
    s, b, (rops, tops_) = hpcg8
    A32 = tops_.matvec("fp32")
    M = tcg.pcg_fixed_iters(A32, tpc.neumann_ainv(tops_.diag(), A32,
                                                  device="cpu"), 5)
    bt = torch.from_numpy(b)
    with graphs.eager():
        want = tcg.fcg(tops_.matvec("fp64"), bt, M=M, tol=TOL, maxiter=100)
    got = tcg.fcg(tops_.matvec("fp64"), bt, M=M, tol=TOL, maxiter=100,
                  chunk=chunk)
    _same(got, want)
    R32 = rops.matvec("fp32")
    xr, ir = rcg.fcg(rops.matvec("fp64"), jnp.asarray(b),
                     M=rcg.pcg_fixed_iters(R32, rpc.neumann_ainv(
                         rops.diag(), R32), 5), tol=TOL, maxiter=100)
    assert got[1].iters == int(ir.iters) > 1
    assert _rel(got[0].numpy(), xr) <= 1e-6


def _laplace1d(n=96):
    return sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()


@pytest.fixture(scope="module")
def promoting():
    """The reference's promotion case: a 1D Laplacian under e8m/D15, no
    preconditioner, ladder e8m/D15 → e8m/D1 → fp32; both packages."""
    a = _laplace1d()
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    ladder = (("e8m", 15), ("e8m", 1), ("fp32", 0))
    port = top.OperatorSet(a, C=8, sigma=32, device="cpu")
    ref = rop.OperatorSet(a, C=8, sigma=32)
    tt, _, _ = tsel.build_tier_matvecs(
        port, [tsel.PrecisionClass(c, D) for c, D in ladder])
    rt, _, _ = rsel.build_tier_matvecs(
        ref, [rsel.PrecisionClass(c, D) for c, D in ladder])
    kw = dict(tol=1e-8, maxiter=60, m_in=48)
    xr, ir = rcg.adaptive_pcg(rt, jnp.asarray(b), matvec_hi=ref.matvec(
        "fp64"), **kw)
    return tt, port.matvec("fp64"), torch.from_numpy(b), kw, (xr, ir)


def _same_adaptive(got, want) -> None:
    (xg, ig), (xw, iw) = got, want
    assert (ig.iters, ig.promotions, ig.hi_matvecs) == \
        (iw.iters, iw.promotions, iw.hi_matvecs)
    _bits(xg, xw)
    _bits(ig.relres, iw.relres)
    _bits(ig.history, iw.history)
    assert torch.equal(ig.tier_history, iw.tier_history)
    assert torch.equal(ig.tier_matvecs, iw.tier_matvecs)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_adaptive_pcg_chunks_equal_eager_and_reference(promoting, chunk):
    tt, hi, bt, kw, (xr, ir) = promoting
    with graphs.eager():
        want = tcg.adaptive_pcg(tt, bt, matvec_hi=hi, **kw)
    got = tcg.adaptive_pcg(tt, bt, matvec_hi=hi, chunk=chunk, **kw)
    _same_adaptive(got, want)
    info = got[1]
    assert info.promotions >= 1 and info.iters > chunk
    assert info.iters == int(ir.iters)
    assert info.promotions == int(ir.promotions)
    np.testing.assert_array_equal(info.tier_history.numpy(),
                                  np.asarray(ir.tier_history))
    np.testing.assert_array_equal(info.tier_matvecs.numpy(),
                                  np.asarray(ir.tier_matvecs))
    assert _rel(got[0].numpy(), xr) <= 1e-6


def test_adaptive_pcg_jit_cache_replays(promoting):
    tt, hi, bt, kw, _ = promoting
    cache = {}
    first = tcg.adaptive_pcg(tt, bt, matvec_hi=hi, jit_cache=cache,
                             jit_key="ladder", **kw)
    (loop,) = cache.values()
    second = tcg.adaptive_pcg(tt, bt, matvec_hi=hi, jit_cache=cache,
                              jit_key="ladder", **kw)
    assert list(cache.values()) == [loop]
    _same_adaptive(second, first)
    assert sum(g.replays for g in loop.graphs) > 0


def test_adaptive_pcg_edges_on_graphs():
    a = _laplace1d(16)
    ops = top.OperatorSet(a, C=8, sigma=32, device="cpu")
    x, info = tcg.adaptive_pcg([ops.matvec("fp32")], torch.zeros(
        16, dtype=torch.float64), chunk=3)
    assert info.iters == 0 and info.hi_matvecs == 1 and not x.any()
    _, info = tcg.adaptive_pcg([ops.matvec("plan_e8m1"), ops.matvec("fp64")],
                               torch.ones(16, dtype=torch.float64), m_in=1,
                               maxiter=2, tol=0.0, chunk=3)
    assert info.iters == 2 and info.hi_matvecs == 3
    assert info.tier_matvecs.tolist() == [1, 1]


@pytest.mark.parametrize("chunk", (*CHUNKS, None))
def test_fgmres_chunks_equal_eager_and_reference(chunk):
    """HPCG 8³ at m = 8 (it restarts), Arnoldi steps in graphs of
    ``chunk`` (None: all m)."""
    s, b = _hpcg(8, seed=7)
    rops, tops_ = (rop.OperatorSet(s, C=8, sigma=32),
                   top.OperatorSet(s, C=8, sigma=32, device="cpu"))
    A = tops_.matvec("fp64")
    M = tpc.jacobi(tops_.diag(), dtype=torch.float64, device="cpu")
    bt = torch.from_numpy(b)
    with graphs.eager():
        want = tgm.fgmres(A, bt, M=M, m=8, tol=TOL, max_cycles=50)
    got = tgm.fgmres(A, bt, M=M, m=8, tol=TOL, max_cycles=50, chunk=chunk)
    _same(got, want)
    xr, ir = rgm.fgmres(rops.matvec("fp64"), jnp.asarray(b),
                        M=rpc.jacobi(rops.diag(), dtype=jnp.float64), m=8,
                        tol=TOL, max_cycles=50)
    assert got[1].iters == int(ir.iters) > 1
    assert _rel(got[0].numpy(), xr) <= 1e-6


@pytest.fixture
def arnoldis(monkeypatch):
    """Every :class:`gmres._Arnoldi` made while the test runs."""
    made = []
    init = tgm._Arnoldi.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(tgm._Arnoldi, "__init__", record)
    return made


@pytest.mark.parametrize("m", [3, 5])
@pytest.mark.parametrize("first", ["eager", "graphs"])
def test_fgmres_fixed_cycles_graphs_equal_eager(hpcg8, arnoldis, first, m):
    """F3R's L3 over L4: one Arnoldi graph of all ``m`` steps with the
    Richardson (and its Neumann) preconditioner inline, two cycles,
    applied three times. Whichever runs first, the eager loop or the
    graphs, the graph path replays and equals the eager loop."""
    s, b, (_, tops_) = hpcg8
    A = tops_.matvec("packsell_fp16")
    l4 = tri.richardson_fixed_iters(A, tpc.neumann_ainv(
        tops_.diag(), A, device="cpu"), 4)
    l3 = tgm.fgmres_fixed_cycles(A, l4, m=m, cycles=2)
    assert l3.host_sync
    r1, r2 = (torch.from_numpy(b), torch.from_numpy(b[::-1].copy()))

    def eager():
        with graphs.eager():
            return [l3(r1), l3(r2)]

    want = eager() if first == "eager" else None
    got = [l3(r1), l3(r2), l3(r1)]
    if want is None:
        want = eager()
    _bits(got[0], want[0])
    _bits(got[1], want[1])
    _bits(got[2], want[0])
    (arn,) = arnoldis
    (graph,) = arn.graphs
    assert list(l3.cycles.values()) == [arn]
    assert graph.replays == 5       # six cycles through the graph, one warm-up
    assert not l4.graphs            # L4 ran inline, inside L3's graph


# ---------------------------------------------------------------------------
# The fixed-iteration graphs, the caches and the aliasing rule
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def applied(hpcg8):
    s, b, (_, tops_) = hpcg8
    A32 = tops_.matvec("fp32")
    A16 = tops_.matvec("packsell_fp16")
    M32 = tpc.neumann_ainv(tops_.diag(), A32, device="cpu")
    M16 = tpc.neumann_ainv(tops_.diag(), A16, k=3, device="cpu")
    return {"neumann_ainv": M32,
            "pcg_fixed_iters": tcg.pcg_fixed_iters(A32, M32, 6),
            "richardson_fixed_iters": tri.richardson_fixed_iters(A16, M16,
                                                                 4)}


@pytest.mark.parametrize("name", ["neumann_ainv", "pcg_fixed_iters",
                                  "richardson_fixed_iters"])
def test_applications_equal_eager_and_stay_independent(hpcg8, applied,
                                                       name):
    """Three applications in a row (call 1 and two replays): each equal
    to the eager body bit for bit, and the earlier results unchanged by
    the later ones (they are cloned out of the static buffers)."""
    s, b, _ = hpcg8
    f = applied[name]
    rs = [torch.from_numpy(np.random.default_rng(i).standard_normal(
        s.shape[0])) for i in range(3)]
    want = [f.fn(r) for r in rs]
    got = [f(r) for r in rs]
    for g, w in zip(got, want):
        _bits(g, w)
    assert len({g.data_ptr() for g in got}) == 3
    (vs, graph), = f.graphs.values()
    assert graph.replays == 2
    assert not any(g.data_ptr() == graph.out[0].data_ptr() for g in got)


def test_graph_output_buffer_is_overwritten_by_its_next_call():
    """The rule the callers keep: a graph's returned buffer holds until
    its next call."""
    v = torch.zeros(4)
    g = graphs.Graph(lambda: v + 1.0, torch.device("cpu"))
    first = g()
    v.fill_(1.0)
    second = g()
    v.fill_(5.0)
    third = g()
    assert second is third and float(third[0]) == 6.0
    assert float(first[0]) == 1.0           # call 1 is the eager warm-up


def test_nested_graph_runs_inline():
    """A graph called from another graph's body (its warm-up, capture or
    CPU run) runs its body inline and makes no graph of its own; called
    on its own, it does."""
    inner_runs = []
    inner = graphs.Applied(lambda v: inner_runs.append(1) or v * 2.0)
    v = torch.ones(3)
    outer = graphs.Graph(lambda: inner(v) + 1.0, torch.device("cpu"))
    outer()                  # call 1: the warm-up
    outer()                  # replays
    outer()
    assert len(inner_runs) == 3 and not inner.graphs
    assert torch.equal(outer(), torch.full((3,), 3.0))
    inner(v)
    assert len(inner.graphs) == 1
    with graphs.eager():
        outer()
    assert outer.replays == 3


def test_trisolve_graph_equals_eager_and_replays():
    a, _ = rop.sym_scale(rtm.hpcg(6, 6, 6))
    lo = sp.tril(a).tocsr()
    lo.sort_indices()
    solver = ttri.PackSELLTriSolver(lo, lower=True, C=8, sigma=32, D=1,
                                    codec="e8m", device="cpu")
    b = torch.from_numpy(np.random.default_rng(19).standard_normal(
        a.shape[0]))
    want = solver._jacobi(b.to(torch.float32), solver.levels)
    got = [solver.solve(b), solver.solve(b)]
    for g in got:
        _bits(g, want)
    (app,) = solver._graphs.values()
    (_, graph), = app.graphs.values()
    assert graph.replays == 1
    with graphs.eager():
        _bits(solver.solve(b), want)


def test_iocg_and_f3r_replay_from_the_operator_set(hpcg8):
    s, b, (_, tops_) = hpcg8
    ops = top.OperatorSet(s, C=8, sigma=32, device="cpu")
    bt = torch.from_numpy(b)
    cfg = tf3r.presets("fp16")
    cfg.m_outer, cfg.tol = 4, 1e-6

    def solves(o):
        return {"iocg": tiocg.solve(o, bt, tiocg.variant("fp16", 10)),
                "ref": tiocg.pcg_reference(o, bt),
                "f3r": tf3r.solve(o, bt, cfg)}

    with graphs.eager():
        want = solves(tops_)
    for _ in range(2):
        got = solves(ops)
        for k in want:
            _same(got[k], want[k])
        keys = set(ops.graphs)
    assert len(keys) == 5     # iocg: M and fcg; pcg_reference: M and pcg; f3r


# ---------------------------------------------------------------------------
# No host read inside a captured body
# ---------------------------------------------------------------------------


class _NoHostRead(TorchDispatchMode):
    """Raise on a read of a device value on the host: ``item()``/``bool``
    (``_local_scalar_dense``), ``nonzero`` (a mask's size) and an explicit
    copy to the CPU."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in ("_local_scalar_dense", "nonzero"):
            raise AssertionError(f"host read in a captured body: {name}")
        if name in ("_to_copy", "to") and str(kwargs.get("device", "")) \
                == "cpu":
            raise AssertionError("copy to the CPU in a captured body")
        return func(*args, **kwargs)


@pytest.fixture
def no_host_read(monkeypatch):
    runs = []
    body = graphs.Graph._run

    def guarded(self):
        runs.append(self)
        with _NoHostRead():
            return body(self)

    monkeypatch.setattr(graphs.Graph, "_run", guarded)
    return runs


def test_no_host_read_mode_catches_a_read(no_host_read):
    v = torch.ones(3)
    g = graphs.Graph(lambda: v * float(v.sum()), torch.device("cpu"))
    with pytest.raises(AssertionError, match="host read"):
        g()
    g = graphs.Graph(lambda: torch.nonzero(v), torch.device("cpu"))
    with pytest.raises(AssertionError, match="nonzero"):
        g()


@pytest.mark.parametrize("solver", ["pcg", "jacobi_pcg_stored", "fcg",
                                    "adaptive_pcg", "fgmres", "f3r",
                                    "trisolve"])
def test_captured_bodies_read_nothing_on_the_host(hpcg8, promoting,
                                                  no_host_read, solver):
    s, b, (_, tops_) = hpcg8
    bt = torch.from_numpy(b)
    ops = top.OperatorSet(s, C=8, sigma=32, device="cpu")
    if solver == "pcg":
        tiocg.pcg_reference(ops, bt)
    elif solver == "jacobi_pcg_stored":
        mat, plan = ops.plan_pair("plan_fp16")
        tcg.jacobi_pcg_stored(mat, plan, s.diagonal(), bt, tol=1e-8,
                              maxiter=100)
    elif solver == "fcg":
        tiocg.solve(ops, bt, tiocg.variant("fp32", 5))
    elif solver == "adaptive_pcg":
        tt, hi, bp, kw, _ = promoting
        tcg.adaptive_pcg(tt, bp, matvec_hi=hi, chunk=3, **kw)
    elif solver == "fgmres":
        tgm.fgmres(ops.matvec("fp64"), bt, M=tpc.neumann_ainv(
            ops.diag(), ops.matvec("fp32"), device="cpu"), m=6, tol=TOL,
            max_cycles=3, chunk=4)
    elif solver == "f3r":
        cfg = tf3r.presets("fp16")
        cfg.m_outer, cfg.max_cycles = 2, 1
        tf3r.solve(ops, bt, cfg)
    else:
        lo = sp.tril(s).tocsr()
        lo.sort_indices()
        tsv = ttri.PackSELLTriSolver(lo, C=8, sigma=32, device="cpu")
        tsv.solve(bt)
        tsv.solve(bt)
    assert len(no_host_read) >= 2          # the bodies ran under the mode


# ---------------------------------------------------------------------------
# No graph in a reference cycle: a graph dies with its owner, by reference
# count, never later in the garbage collector (which may run during another
# capture, where destroying a graph is illegal)
# ---------------------------------------------------------------------------


@pytest.fixture
def made_graphs(monkeypatch):
    refs = []
    init = graphs.Graph.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        refs.append(weakref.ref(self))

    monkeypatch.setattr(graphs.Graph, "__init__", record)
    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    yield refs
    if collecting:
        gc.enable()


@pytest.mark.parametrize("solver", ["pcg", "jacobi_pcg_stored",
                                    "adaptive_pcg", "fgmres", "operator_set",
                                    "trisolve"])
def test_graphs_die_with_their_owner(hpcg8, promoting, made_graphs, solver):
    s, b, _ = hpcg8
    bt = torch.from_numpy(b)
    ops = top.OperatorSet(s, C=8, sigma=32, device="cpu")
    if solver == "pcg":
        tcg.pcg(ops.matvec("fp32"), bt, M=tpc.neumann_ainv(
            ops.diag(), ops.matvec("fp32"), device="cpu"), tol=1e-6)
    elif solver == "jacobi_pcg_stored":
        mat, plan = ops.plan_pair("plan_fp16")
        tcg.jacobi_pcg_stored(mat, plan, s.diagonal(), bt, tol=1e-6)
        assert plan._fns
        del mat, plan
        tpl_clear()
    elif solver == "adaptive_pcg":
        tt, hi, bp, kw, _ = promoting
        tcg.adaptive_pcg(tt, bp, matvec_hi=hi, jit_cache={}, **kw)
    elif solver == "fgmres":
        tgm.fgmres(ops.matvec("fp64"), bt, M=tri.richardson_fixed_iters(
            ops.matvec("fp32"), tpc.jacobi(ops.diag(), device="cpu"), 2),
            m=4, tol=1e-6, max_cycles=2)
    elif solver == "operator_set":
        tiocg.solve(ops, bt, tiocg.variant("fp32", 5))
        cfg = tf3r.presets("fp16")
        cfg.m_outer, cfg.max_cycles = 2, 1
        tf3r.solve(ops, bt, cfg)
        assert ops.graphs
    else:
        lo = sp.tril(s).tocsr()
        lo.sort_indices()
        tsv = ttri.PackSELLTriSolver(lo, C=8, sigma=32, device="cpu")
        tsv.solve(bt)
        del tsv
    del ops
    assert made_graphs
    assert not [r for r in made_graphs if r() is not None]


def tpl_clear():
    from repro_torch.kernels import plan as tpl

    tpl.clear_cache()
