"""repro_torch's composite, ``MixedPackSELL``, ``csr64``, ``from_dense`` and
``SpMVPlan.retile`` against the reference, on the CPU.

* ``term_inverse`` gives the reference's arrays and errors;
* ``CompositePlan.from_classes`` over the tiny suite with five row classes
  (fp16/D15, bf16/D12, e8m/D8, fp32, fp64): y and Y (nb = 3) bit for bit on
  integer-valued data, and within 1e-6 relative of the largest |y| on
  real data; a two-term composite sums its terms; the one-member composite
  is the plan engine; ``memory_stats``/``describe`` equal the reference's
  (a member plan's variant is ``jnp`` in both packages on the CPU);
* ``MixedPackSELL`` and ``ops.matvec("mixed:1e-3")`` on the row-scaled
  ``scattered_like`` matrix (two classes, fp16/D15 and e8m/D12);
* ``csr64`` within 1e-12 (a segment sum fixes no order of adds);
  ``from_dense`` gives ``from_csr``'s words and the reference's errors;
* ``retile`` gives the reference's checkpoints, band windows and
  re-widthed fused stream for the same tiles, and rebuilds the bucket
  kernels' table;
* a composite matvec reads nothing on the host, and Jacobi-PCG on it runs
  through ``cg.pcg``'s graphs equal to the eager loop bit for bit.
"""
import dataclasses
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import packsell as rpk
from repro.core import sell as rsl
from repro.core import sparse as rsps
from repro.core import testmats as rtm
from repro.kernels import composite as rkc
from repro.kernels import plan as rpl
from repro.precision import mixed as rmx
from repro.precision import select as rsel
from repro.solvers import operators as rop
from repro_torch import _generations as generations
from repro_torch.core import packsell as tpk
from repro_torch.core import sell as tsl
from repro_torch.core import sparse as tsps
from repro_torch.kernels import composite as tkc
from repro_torch.kernels import packsell_spmv as tkp
from repro_torch.kernels import plan as tpl
from repro_torch.kernels import ref as tref
from repro_torch.precision import mixed as tmx
from repro_torch.precision import select as tsel
from repro_torch.solvers import cg as tcg
from repro_torch.solvers import graphs
from repro_torch.solvers import operators as top

TINY = rtm.suite("tiny")
CLASSES5 = [("fp16", 15), ("bf16", 12), ("e8m", 8), ("fp32", 0),
            ("fp64", 0)]
CPU = "cpu"


def _int_csr(a, seed=11):
    """``a``'s pattern with integer values in [-8, 8] \\ {0}."""
    a = a.tocsr().copy()
    rng = np.random.default_rng(seed)
    v = rng.integers(1, 9, size=a.nnz) * rng.choice([-1, 1], size=a.nnz)
    a.data = v.astype(np.float64)
    return a


def _x(m, seed=3, nb=None, integer=False):
    rng = np.random.default_rng(seed)
    shape = (m,) if nb is None else (m, nb)
    if integer:
        return rng.integers(-8, 9, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _row_classes(n, pool=CLASSES5):
    rows = np.arange(n)
    return [(c, D, rows[rows % len(pool) == i])
            for i, (c, D) in enumerate(pool)]


def _both(a, classes, **kw):
    ref = rkc.CompositePlan.from_classes(a, classes, C=8, sigma=32, **kw)
    port = tkc.CompositePlan.from_classes(a, classes, C=8, sigma=32,
                                          device=CPU, **kw)
    return ref, port


def _run_ref(fn, x):
    return np.asarray(fn(jnp.asarray(x)))


def _run_port(fn, x):
    return fn(torch.from_numpy(x)).numpy()


# ---------------------------------------------------------------------------
# term inverses
# ---------------------------------------------------------------------------


def test_term_inverse_equals_reference():
    a = TINY["powerlaw"]
    ref, port = _both(a, _row_classes(a.shape[0]))
    assert len(port._invs_np) == len(ref._invs_np) == 1
    np.testing.assert_array_equal(port._invs_np[0], ref._invs_np[0])
    np.testing.assert_array_equal(port.invs[0].numpy(), ref._invs_np[0])
    # uncovered rows point at the pad slot in both packages
    half = [("e8m", 8, np.arange(0, a.shape[0], 2))]
    mr = [rkc.member_from_csr(a.tocsr()[half[0][2]], "e8m", 8, C=8,
                              sigma=32, rows=half[0][2])]
    mp = [tkc.member_from_csr(a.tocsr()[half[0][2]], "e8m", 8, C=8,
                              sigma=32, rows=half[0][2], device=CPU)]
    np.testing.assert_array_equal(
        tkc.term_inverse(a.shape[0], mp, allow_uncovered=True),
        rkc.term_inverse(a.shape[0], mr, allow_uncovered=True))


@pytest.mark.parametrize("case", ["uncovered", "overlap"])
def test_term_inverse_errors_equal_reference(case):
    a = TINY["banded"]
    classes = ([("e8m", 8, np.arange(10))] if case == "uncovered" else
               [("e8m", 8, np.arange(40)), ("fp32", 0, np.arange(30, 512))])
    with pytest.raises(ValueError) as want:
        rkc.CompositePlan.from_classes(a, classes, C=8, sigma=16)
    with pytest.raises(ValueError) as got:
        tkc.CompositePlan.from_classes(a, classes, C=8, sigma=16,
                                       device=CPU)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# from_classes, spmm, terms, single member
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TINY))
def test_from_classes_bit_equal_on_integer_data(name):
    a = _int_csr(TINY[name])
    ref, port = _both(a, _row_classes(a.shape[0]))
    x = _x(a.shape[1], integer=True)
    y = _run_port(port.spmv, x)
    assert y.dtype == np.float64           # the fp64 member promotes
    np.testing.assert_array_equal(y, _run_ref(ref.spmv, x))
    X = _x(a.shape[1], nb=3, integer=True)
    np.testing.assert_array_equal(_run_port(port.spmm, X),
                                  _run_ref(ref.spmm, X))


@pytest.mark.parametrize("name", sorted(TINY))
def test_from_classes_real_data_within_tolerance(name):
    a = TINY[name]
    ref, port = _both(a, _row_classes(a.shape[0]))
    for x in (_x(a.shape[1], seed=5), _x(a.shape[1], seed=6, nb=3)):
        fn_p = port.spmv if x.ndim == 1 else port.spmm
        fn_r = ref.spmv if x.ndim == 1 else ref.spmm
        want = _run_ref(fn_r, x)
        np.testing.assert_allclose(_run_port(fn_p, x), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    # the spmm columns are the spmv of each column, bit for bit
    X = _x(a.shape[1], seed=7, nb=3)
    Y = _run_port(port.spmm, X)
    for j in range(3):
        np.testing.assert_array_equal(
            Y[:, j], _run_port(port.spmv, np.ascontiguousarray(X[:, j])))


def test_two_term_composite_sums_terms():
    a = _int_csr(rtm.random_banded(96, 8, 3, seed=4)).tocsr()
    lo, hi = a.copy(), a.copy()
    lo[:, 48:] = 0
    hi[:, :48] = 0
    lo.eliminate_zeros()
    hi.eliminate_zeros()
    mr = [rkc.member_from_csr(m_.tocsr(), c, D, C=8, sigma=16, term=t)
          for t, (m_, c, D) in enumerate([(lo, "fp32", 0),
                                          (hi, "e8m", 8)])]
    mp = [tkc.member_from_csr(m_.tocsr(), c, D, C=8, sigma=16, term=t,
                              device=CPU)
          for t, (m_, c, D) in enumerate([(lo, "fp32", 0),
                                          (hi, "e8m", 8)])]
    ref = rkc.CompositePlan(mr, n=96, m=96)
    port = tkc.CompositePlan(mp, n=96, m=96)
    assert port.n_terms == 2
    x = _x(96, seed=5, integer=True)
    y = _run_port(port.spmv, x)
    np.testing.assert_array_equal(y, _run_ref(ref.spmv, x))
    np.testing.assert_array_equal(y, (a.toarray() @ x).astype(np.float32))


def test_single_member_composite_is_the_plan_engine():
    a = rtm.scattered(256, nnz_per_row=6, spd=True, seed=6)
    mat = tpk.from_csr(a, C=8, sigma=32, D=8, codec="e8m", device=CPU)
    x = torch.from_numpy(_x(256, seed=7))
    for force in ("auto", "full", "fused"):
        plan = tpl.get_plan(mat, force=force)
        cp = plan.as_composite(mat)
        assert len(cp.members) == 1 and cp.n_terms == 1
        assert torch.equal(cp.spmv(x), plan.spmv(mat, x))
    s = tsl.from_csr(a, C=8, sigma=32, value_dtype="float32", device=CPU)
    assert torch.equal(tkc.CompositePlan.single(s).spmv(x),
                       tsl.sell_spmv(s, x))
    with pytest.raises(TypeError):
        tkc.CompositePlan.single(a)


def test_memory_stats_and_describe_equal_reference():
    a = TINY["powerlaw"]
    ref, port = _both(a, _row_classes(a.shape[0]))
    assert port.memory_stats() == ref.memory_stats()
    # a member plan's variant: 'jnp' (the plain fused-stream body) in both
    # packages on the CPU; 'fused'/'full'/'band' on the card
    assert port.describe() == ref.describe()
    assert [m["plan"] for m in port.describe()["members"]] == \
        ["jnp", "jnp", "jnp", None, None]


def test_from_arrays_carries_a_reference_composite():
    a = _int_csr(TINY["stencil1d"])
    ref, _ = _both(a, _row_classes(a.shape[0]))
    entries = []
    for mem in ref.members:
        m = mem.mat
        if mem.plan is None:
            leaves = ([np.asarray(v) for v in m.vals],
                      [np.asarray(c) for c in m.cols],
                      [np.asarray(o) for o in m.outrows], np.asarray(m.perm))
            meta = {k: getattr(m, k) for k in tsl.SELLMatrix.STATIC}
        else:
            leaves = ([np.asarray(p) for p in m.packs],
                      [np.asarray(d) for d in m.d0s],
                      [np.asarray(o) for o in m.outrows],
                      [np.asarray(c) for c in m.maxcols], np.asarray(m.perm))
            meta = {k: getattr(m, k) for k in tpk.PackSELLMatrix.STATIC}
        entries.append(dict(fmt=mem.fmt, leaves=leaves, meta=meta,
                            codec=mem.codec, D=mem.D, rows=mem.rows,
                            x_index=mem.x_index, term=mem.term,
                            label=mem.label))
    port = tkc.from_arrays(entries, a.shape[0], a.shape[1], device=CPU,
                           name=ref.name)
    x = _x(a.shape[1], integer=True)
    np.testing.assert_array_equal(_run_port(port.spmv, x),
                                  _run_ref(ref.spmv, x))
    assert port.describe() == ref.describe()


def test_fused_cat_keeps_the_reference_slice_table():
    a = _int_csr(rtm.random_banded(80, 6, 3, seed=17))
    rows = np.arange(80)
    classes = [("fp16", 15, rows[:40]), ("bf16", 12, rows[40:])]
    ref, port = _both(a, classes)
    cat = port.fused_cat()
    assert cat is not None and sum(s is not None for s in cat[2]) == 2
    rcat = ref.fused_cat()
    assert cat[2] == rcat[2]
    np.testing.assert_array_equal(cat[0].numpy().view(np.uint32),
                                  np.asarray(rcat[0]))
    np.testing.assert_array_equal(cat[1].numpy(), np.asarray(rcat[1]))
    x = _x(80, integer=True)
    y0 = _run_port(port.spmv, x)
    np.testing.assert_array_equal(y0, _run_ref(ref.spmv, x))
    # the matvec reads the members' own streams, not this copy
    cat[0].zero_()
    np.testing.assert_array_equal(_run_port(port.spmv, x), y0)
    assert tkc.CompositePlan.from_classes(
        a, [("fp16", 15, None)], C=8, sigma=32,
        device=CPU).fused_cat() is None


def test_plain_twin_and_forced_members():
    a = TINY["banded"]
    classes = _row_classes(a.shape[0])
    port = tkc.CompositePlan.from_classes(
        a, classes, C=8, sigma=32, device=CPU,
        force=["fused", "full", "band", "auto", "auto"])
    assert [None if m.plan is None else m.plan.variant
            for m in port.members] == ["fused", "full", "band", None, None]
    x = torch.from_numpy(_x(a.shape[1]))
    assert torch.equal(port.spmv(x), tref.composite_plain(port, x))
    X = torch.from_numpy(_x(a.shape[1], nb=4))
    assert torch.equal(port.spmm(X),
                       tref.composite_plain(port, X, multi_rhs=True))
    for mem in port.members[:3]:
        for permuted in (False, True):
            assert torch.equal(
                mem.plan.spmv(mem.mat, x, permuted=permuted),
                tref.plan_plain(mem.plan, mem.mat, x, permuted=permuted))
        assert torch.equal(mem.plan.spmm(mem.mat, X),
                           tref.plan_plain(mem.plan, mem.mat, X,
                                           multi_rhs=True))
    _, auto = _both(a, classes)
    np.testing.assert_allclose(port.spmv(x).numpy(), auto.spmv(x).numpy(),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# MixedPackSELL and the mixed: kind
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scattered_rs():
    a = rtm.suite("small")["scattered_like"]
    return rop.row_scale(a)[0].tocsr()


def test_mixed_packsell_two_classes_equal_reference(scattered_rs):
    a = scattered_rs
    rp = rsel.select_codec(a, 1e-3, mode="rows")
    assert [(c.codec, c.D) for c in rp.classes] == [("fp16", 15),
                                                     ("e8m", 12)]
    tp = tsel.PrecisionPlan.from_dict(rp.to_dict())
    ref = rmx.MixedPackSELL(a, rp)
    port = tmx.MixedPackSELL(a, tp, device=CPU)
    assert port.memory_stats() == ref.memory_stats()
    assert len(port.blocks) == 2 and port.shape == a.shape
    x = _x(a.shape[1], seed=2)
    want = _run_ref(ref.spmv, x)
    np.testing.assert_allclose(_run_port(port.spmv, x), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    ops_p = top.OperatorSet(a, device=CPU)
    ops_r = rop.OperatorSet(a)
    np.testing.assert_allclose(_run_port(ops_p.matvec("mixed:1e-3"), x),
                               _run_ref(ops_r.matvec("mixed:1e-3"), x),
                               rtol=0, atol=1e-6 * np.abs(want).max())
    assert isinstance(ops_p.stored("mixed:1e-3"), tmx.MixedPackSELL)
    assert ops_p.precision_plan(1e-3, mode="rows").to_dict() == rp.to_dict()


# ---------------------------------------------------------------------------
# csr64 and from_dense
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TINY))
def test_csr64_kind_equals_reference(name):
    a = TINY[name]
    x = np.random.default_rng(1).standard_normal(a.shape[1])
    got = top.OperatorSet(a, device=CPU).matvec("csr64")(
        torch.from_numpy(x)).numpy()
    want = np.asarray(rop.OperatorSet(a).matvec("csr64")(jnp.asarray(x)))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    for vd in ("float32", "float64"):
        r = rsps.csr_from_scipy(a, vd)
        t = tsps.csr_from_scipy(a, vd, device=CPU)
        assert t.memory_stats() == r.memory_stats()
        assert tsps.coo_from_scipy(a, vd, device=CPU).memory_stats() == \
            rsps.coo_from_scipy(a, vd).memory_stats()
        np.testing.assert_array_equal(t.row_ids.numpy(),
                                      np.asarray(r.row_ids))


def test_from_dense_same_words_and_errors():
    rng = np.random.default_rng(4)
    d = rng.standard_normal((40, 30)) * (rng.random((40, 30)) < 0.2)
    mr = rpk.from_dense(d, C=8, sigma=16, codec="e8m", D=8)
    mt = tpk.from_dense(d, C=8, sigma=16, codec="e8m", D=8, device=CPU)
    for p_r, p_t in zip(mr.packs, mt.packs):
        np.testing.assert_array_equal(p_t.numpy().view(np.uint32),
                                      np.asarray(p_r))
    sr = rsl.from_dense(d, C=8, sigma=16)
    st = tsl.from_dense(d, C=8, sigma=16, device=CPU)
    for v_r, v_t in zip(sr.vals, st.vals):
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_r))
    for bad in (np.array([[1.0, np.nan], [0.0, 2.0]]),
                np.array([[np.inf, 1.0], [0.0, 2.0]]), np.ones(4)):
        with pytest.raises(ValueError) as want:
            rpk.from_dense(bad, C=1, sigma=1)
        with pytest.raises(ValueError) as got:
            tpk.from_dense(bad, C=1, sigma=1, device=CPU)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# retile
# ---------------------------------------------------------------------------


def _pair(a, **kw):
    mr = rpk.from_csr(a, C=8, sigma=32, codec="e8m", D=8,
                      bucket_strategy="uniform")
    mt = tpk.from_csr(a, C=8, sigma=32, codec="e8m", D=8,
                      bucket_strategy="uniform", device=CPU)
    return (mr, rpl.build_plan(mr, **kw)), (mt, tpl.build_plan(mt, **kw))


@pytest.mark.parametrize("force", ["band", "full"])
def test_retile_gives_reference_checkpoints_and_windows(force):
    a = _int_csr(rtm.random_banded(512, 24, 6, seed=1))
    (mr, pr), (mt, pt) = _pair(a, force=force, hw=128)
    x = _x(512, integer=True)
    y0 = pt.spmv(mt, torch.from_numpy(x))
    tiles = [(4, 16)] * len(pt.tiles)
    pr.retile(tiles)
    pt._fns["probe"] = object()
    with generations.recording() as reads:
        pt.spmv(mt, torch.from_numpy(x))
    assert not generations.stale(reads)
    pt.retile(tiles)
    assert pt.tiles == pr.tiles and pt._fns == {}
    # a graph captured over the old table captures again
    assert pt.generation == 1 and generations.stale(reads)
    for k_t, k_r in zip(pt.kckpts, pr.kckpts):
        np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_r))
    if force == "band":
        for w_t, w_r in zip(pt.wins, pr.wins):
            np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_r))
    assert pt.ktable.wbs == (16,) * len(pt.tiles)
    assert pt.ktable.sbs == (4,) * len(pt.tiles)
    y1 = pt.spmv(mt, torch.from_numpy(x))
    assert torch.equal(y1, y0)
    np.testing.assert_array_equal(y1.numpy(), np.asarray(
        pr.spmv(mr, jnp.asarray(x))))
    with pytest.raises(ValueError):
        pt.retile([(4, 16, 8), (4, 16, 16)] * len(pt.tiles))


def test_retile_rewidths_the_fused_stream_as_the_reference():
    a = _int_csr(TINY["powerlaw"])
    mr = rpk.from_csr(a, C=8, sigma=32, codec="fp16", D=15)
    mt = tpk.from_csr(a, C=8, sigma=32, codec="fp16", D=15, device=CPU)
    pr, pt = rpl.build_plan(mr), tpl.build_plan(mt)
    wr = 8 if pt.fused_layout.wr != 8 else 16
    tiles = [(8, 32, wr)] * len(pt.tiles)
    pr.retile(tiles)
    old = weakref.ref(pt.fused[0])
    pt.retile(tiles)
    assert old() is None and pt.generation == 1   # the old stream is freed
    assert dataclasses.astuple(pt.fused_layout) == \
        dataclasses.astuple(pr.fused_layout)
    np.testing.assert_array_equal(pt.fused[0].numpy().view(np.uint32),
                                  np.asarray(pr.fused[0]))
    for t, r in ((pt.fused[1], pr.fused[1]), (pt.outrow_cat, pr.outrow_cat),
                 (pt.inv_cat, pr.inv_cat), (pt.inv2_cat, pr.inv2_cat)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    x = _x(a.shape[1], integer=True)
    np.testing.assert_array_equal(_run_port(lambda v: pt.spmv(mt, v), x),
                                  _run_ref(lambda v: pr.spmv(mr, v), x))


def test_composite_retile_plumbing():
    a = rtm.random_banded(128, 8, 3, seed=9)
    cp = tkc.CompositePlan.from_classes(a, [("fp16", 15, None)], C=8,
                                        sigma=32, device=CPU, force="full")
    x = torch.from_numpy(_x(128, seed=10))
    y0 = cp.spmv(x)
    cp.retile(0, [(4, 16)] * len(cp.members[0].plan.tiles))
    assert cp.members[0].plan.tiles[0] == (4, 16)
    assert cp.members[0].plan.ktable.wbs[0] == 16
    assert torch.equal(cp.spmv(x), y0)
    with pytest.raises(ValueError, match="SELL"):
        tkc.CompositePlan.from_classes(
            a, [("fp32", 0, None)], C=8, sigma=32, device=CPU).retile(0, [])


def test_generations_mark_what_a_capture_read():
    """What a graph capture records (``solvers.graphs`` opens the
    recording): every plan a composite matvec runs, at its generation; a
    member's retile makes the record stale, and so does a plan that is
    gone. A nested recording passes its reads on to the outer one."""
    a = rtm.random_banded(128, 8, 3, seed=9)
    cp = tkc.CompositePlan.from_classes(
        a, [("fp16", 15, np.arange(0, 128, 2)),
            ("e8m", 8, np.arange(1, 128, 2))], C=8, sigma=32, device=CPU,
        force=["fused", "full"])
    x = torch.from_numpy(_x(128, seed=11))
    assert generations.stale({}) is False
    with generations.recording() as outer:
        with generations.recording() as inner:
            cp.spmv(x)
    plans = {id(m.plan) for m in cp.members}
    assert set(inner) == set(outer) == plans
    assert not generations.stale(outer)
    cp.retile(1, [(4, 16)] * len(cp.members[1].plan.tiles))
    assert generations.stale(outer)
    with generations.recording() as again:
        cp.spmv(x)
    assert not generations.stale(again)
    generations.read(cp.members[0].plan)      # outside a recording: no-op
    mt = tpk.from_csr(a, C=8, sigma=32, codec="fp16", D=15, device=CPU)
    with generations.recording() as gone:
        tpl.build_plan(mt).spmv(mt, x)
    gc.collect()
    assert generations.stale(gone)


def test_stale_table_is_refused():
    """The bucket wrappers hold the table against the tensors they are
    given: a table of other buffers raises, so a plan whose table was not
    rebuilt could not launch."""
    a = rtm.random_banded(256, 12, 4, seed=2)
    mt = tpk.from_csr(a, C=8, sigma=32, codec="e8m", D=8,
                      bucket_strategy="uniform", device=CPU)
    pt = tpl.build_plan(mt, force="band", hw=128)
    stale = pt.ktable
    pt.retile([(4, 16)] * len(pt.tiles))
    x = torch.from_numpy(_x(256))
    with pytest.raises(ValueError, match="other windows"):
        tkp.packsell_spmv_band_buckets(mt.packs, mt.d0s, pt.wins, pt.kckpts,
                                       stale, x, codec_name="e8m", D=8,
                                       hw=pt.hw)


# ---------------------------------------------------------------------------
# the composite inside the solvers' graphs
# ---------------------------------------------------------------------------


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("_local_scalar_dense", "nonzero"):
            raise AssertionError(f"host read in a composite matvec: {name}")
        return func(*args, **(kwargs or {}))


def test_composite_matvec_reads_nothing_on_the_host():
    a = TINY["hpcg_mini"]
    _, port = _both(a, _row_classes(a.shape[0]))
    x = torch.from_numpy(_x(a.shape[1]))
    X = torch.from_numpy(_x(a.shape[1], nb=2))
    with _NoHostRead():
        port.spmv(x)
        port.spmm(X)
    with pytest.raises(AssertionError, match="host read"), _NoHostRead():
        float(port.spmv(x).sum())


def test_jacobi_pcg_on_composite_graphs_equal_eager():
    a = rop.sym_scale(rtm.hpcg(8, 8, 8))[0]
    n = a.shape[0]
    rows = np.arange(n)
    cp = tkc.CompositePlan.from_classes(
        a, [("fp16", 15, rows[rows % 3 == 0]), ("e8m", 8, rows[rows % 3 == 1]),
            ("fp32", 0, rows[rows % 3 == 2])], C=8, sigma=32, device=CPU)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(n))
    dinv = torch.from_numpy(1.0 / a.diagonal())
    M = lambda r: r * dinv                                   # noqa: E731
    with graphs.eager():
        xe, ie = tcg.pcg(cp.spmv, b, M=M, tol=1e-8, maxiter=500)
    xg, ig = tcg.pcg(cp.spmv, b, M=M, tol=1e-8, maxiter=500)
    assert ig.iters == ie.iters > 0
    assert torch.equal(xg, xe)
