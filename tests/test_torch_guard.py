"""repro_torch's guards, injectors and self-healing solve against the
reference, on the CPU.

* ``checksum`` equals the reference's on the same arrays (sums that wrap
  mod 2³² included), and the device path (``_checksum_torch``) equals the
  host path;
* ``matrix_colsums`` equals the reference's column sums bit for bit (the
  port's one ``np.bincount`` against its ``np.add.at``), and
  ``build_guard`` its tolerances and operand checksum;
* every injector, seeds 0–19, on operands of the reference's shapes: the
  same ``target``, ``detail`` and ``value_neutral``, and the same guard
  verdict. The exact operand checksum sees every injection, value-neutral
  ones included (the reference's own property: ``value_neutral`` says
  whether y can change, not whether the guard trips), so the guard trips
  on every injection; y stays bit-equal on every neutral one; after
  ``undo()`` the guard passes and y is the clean y again;
* injections write in place: the plan's tensors are the same objects, and
  a solve's cached graphs see the fault and, after ``undo()``, its
  absence;
* ``validate_*`` flag what the reference's flag; the ``guarded:`` kind
  counts trips; ``guarded_solve`` takes the reference's recovery log and
  accepted steps, with x within 1e-6; its old bindings' graphs die after a
  promote and a rebuild; ``REPRO_DEBUG_FINITE``.
"""
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import codecs as rcd
from repro.core import packsell as rpk
from repro.core import testmats as rtm
from repro.kernels import composite as rkc
from repro.kernels import plan as rpl
from repro.robust import guard as rgd
from repro.robust import inject as rinj
from repro.robust import recover as rrc
from repro.solvers import operators as rop
from repro_torch.core import packsell as tpk
from repro_torch.kernels import composite as tkc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import plan as tpl
from repro_torch.robust import guard as tgd
from repro_torch.robust import inject as tinj
from repro_torch.robust import recover as trc
from repro_torch.solvers import cg as tcg
from repro_torch.solvers import operators as top

TINY = rtm.suite("tiny")
SEEDS = range(20)
CPU = "cpu"


def _spd(a: sp.csr_matrix) -> sp.csr_matrix:
    """Symmetrize + diagonally-dominant shift (the reference tests')."""
    s = ((a + a.T) / 2).tocsr()
    shift = float(np.abs(s).sum(axis=1).max())
    return (s + sp.eye(s.shape[0]) * shift).tocsr()


def _x(m, seed=0):
    return np.random.default_rng(seed).standard_normal(m).astype(np.float32)


def _pair(a, *, C=32, sigma=64, codec="fp16", D=15, **plan_kw):
    a = a.tocsr()
    mr = rpk.from_csr(a, C=C, sigma=sigma, codec=codec, D=D)
    mt = tpk.from_csr(a, C=C, sigma=sigma, codec=codec, D=D, device=CPU)
    return (mr, rpl.get_plan(mr, **plan_kw)), (mt, tpl.get_plan(mt, **plan_kw))


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------


def _checksum_arrays():
    rng = np.random.default_rng(1)
    out = [rng.integers(0, 2 ** 32, size=s, dtype=np.uint32)
           for s in (5, 64, 1, 1024, 3 * 1024 + 7)]
    out.append(rng.integers(-100, 100, size=17).astype(np.int32))
    out.append(rng.integers(-2 ** 62, 2 ** 62, size=(9, 10)).astype(
        np.int64))
    out.append(np.zeros(0, np.int32))
    # long enough that both sums wrap many times over
    out.append(np.full(300_000, 0xFFFFFFFF, np.uint32))
    out.append(rng.integers(0, 2 ** 32, size=200_003, dtype=np.uint32))
    out.append(rng.integers(0, 255, size=33).astype(np.uint8))
    return out


def test_checksum_equals_reference_host_and_device():
    arrs = _checksum_arrays()
    want = rgd.checksum(arrs)
    assert tgd.checksum(arrs) == want
    as_t = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                             else a) for a in arrs]
    assert tgd.checksum(as_t) == want
    s0, s1 = tgd._checksum_torch(as_t)
    assert (int(s0), int(s1)) == tuple(int(v) for v in
                                       rgd._checksum_ref_pair(want))
    for a in arrs:
        one = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a)]
        s0, s1 = tgd._checksum_torch(one)
        r0, r1 = rgd._checksum_ref_pair(rgd.checksum([a]))
        assert (int(s0), int(s1)) == (int(r0), int(r1)), a.shape


def test_checksum_detects_single_bit_and_transposition():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, size=2057, dtype=np.uint32)
    ref = tgd._checksum_torch([torch.from_numpy(a.view(np.int32))])
    for bit in (0, 7, 16, 31):
        b = a.copy()
        b[1100] ^= np.uint32(1 << bit)
        got = tgd._checksum_torch([torch.from_numpy(b.view(np.int32))])
        assert int(got[0]) != int(ref[0])
    c = a.copy()
    c[[3, 2000]] = c[[2000, 3]]
    got = tgd._checksum_torch([torch.from_numpy(c.view(np.int32))])
    assert int(got[0]) == int(ref[0]) and int(got[1]) != int(ref[1])


@pytest.mark.parametrize("codec,D", [("fp16", 15), ("e8m", 8)])
@pytest.mark.parametrize("name", sorted(TINY))
def test_colsums_and_guard_equal_reference(name, codec, D):
    (mr, pr), (mt, pt) = _pair(TINY[name], C=16, sigma=32, codec=codec, D=D)
    cr, ar = rgd.matrix_colsums(mr)
    ct, at = tgd.matrix_colsums(mt)
    np.testing.assert_array_equal(ct, cr)
    np.testing.assert_array_equal(at, ar)
    gr, gt = rgd.build_guard(mr, pr), tgd.build_guard(mt, pt)
    assert (gt.tau_rel, gt.tau_quant, gt.source, gt.every) == \
        (gr.tau_rel, gr.tau_quant, gr.source, gr.every)
    assert gt.ref_checksum == gr.ref_checksum
    np.testing.assert_array_equal(gt.c.numpy(), np.asarray(gr.c))
    gcr = rgd.build_guard(mr, pr, csr=TINY[name])
    gct = tgd.build_guard(mt, pt, csr=TINY[name])
    assert gct.source == "csr" and gct.tau_quant == gcr.tau_quant > 0
    np.testing.assert_array_equal(gct.cabs.numpy(), np.asarray(gcr.cabs))


# ---------------------------------------------------------------------------
# injectors: parity, guard verdicts, in place
# ---------------------------------------------------------------------------

_PLAN_INJECTORS = ("flip_fused_word", "corrupt_fused_checkpoint",
                   "corrupt_permutation")


def _verdicts(inject_r, inject_t, r, t, x, seeds=SEEDS):
    """Inject both packages with each seed; compare the injections and
    the guard's verdicts; return the port's (injection, y, ok) triples."""
    (mr, pr, gr), (mt, pt, gt) = r, t
    xr, xt = jnp.asarray(x), torch.from_numpy(x)
    out = []
    for seed in seeds:
        ir, it = inject_r(seed), inject_t(seed)
        assert (it.target, it.detail, it.value_neutral) == \
            (ir.target, ir.detail, ir.value_neutral), seed
        ok_r = bool(rgd.guarded_spmv(mr, pr, gr, xr)[1])
        y, ok, _ = tgd.guarded_spmv(mt, pt, gt, xt)
        assert bool(ok) == ok_r, seed
        out.append((it, y.clone(), bool(ok)))
        ir.undo()
        it.undo()
    return out


@pytest.mark.parametrize("injector", _PLAN_INJECTORS)
def test_plan_injectors_equal_reference_and_guard_trips(injector):
    (mr, pr), (mt, pt) = _pair(rtm.random_banded(512, 24, 6, seed=1))
    assert pt.fused is not None
    gr, gt = rgd.build_guard(mr, pr), tgd.build_guard(mt, pt)
    x = _x(512)
    y0 = pt.spmv(mt, torch.from_numpy(x))
    before = [t.data_ptr() for t in (*pt.fused, pt.inv_cat, pt.inv2_cat)]
    runs = _verdicts(lambda s: getattr(rinj, injector)(mr, pr, s),
                     lambda s: getattr(tinj, injector)(mt, pt, s),
                     (mr, pr, gr), (mt, pt, gt), x)
    assert any(not i.value_neutral for i, _, _ in runs)
    for inj, y, ok in runs:
        assert not ok            # the checksum sees every injection
        if inj.value_neutral:
            assert torch.equal(y, y0)
    assert [t.data_ptr() for t in (*pt.fused, pt.inv_cat,
                                   pt.inv2_cat)] == before
    y, ok, _ = tgd.guarded_spmv(mt, pt, gt, torch.from_numpy(x))
    assert bool(ok) and torch.equal(y, y0)


@pytest.mark.parametrize("mode", ["full", "0"])
def test_pack_word_injector_equals_reference(mode):
    (mr, pr), (mt, pt) = _pair(rtm.random_banded(256, 16, 5, seed=2),
                               C=16, sigma=32, decode_cache=mode)
    gr, gt = rgd.build_guard(mr, pr), tgd.build_guard(mt, pt)
    x = _x(256, seed=3)
    y0 = pt.spmv(mt, torch.from_numpy(x))
    runs = _verdicts(lambda s: rinj.flip_pack_word(mr, pr, s),
                     lambda s: tinj.flip_pack_word(mt, pt, s),
                     (mr, pr, gr), (mt, pt, gt), x)
    assert any(not i.value_neutral for i, _, _ in runs)
    for inj, y, ok in runs:
        assert not ok
        if inj.value_neutral:
            assert torch.equal(y, y0)


def test_pack_word_injector_reaches_the_bucket_kernels():
    """On a ``full`` plan (K4's plain version here) the guard covers the
    words, d0, checkpoints and the kernel table, and the oracle follows
    the kernels' walk from d0."""
    a = rtm.random_banded(256, 16, 5, seed=2).tocsr()
    mr = rpk.from_csr(a, C=16, sigma=32, codec="e8m", D=8)
    pr = rpl.get_plan(mr, decode_cache="0")
    mt = tpk.from_csr(a, C=16, sigma=32, codec="e8m", D=8, device=CPU)
    pt = tpl.get_plan(mt, force="full")
    gt = tgd.build_guard(mt, pt)
    arrs = tgd.guard_arrays(mt, pt)
    assert arrs[-2] is pt.inv_cat and arrs[-1] is pt.outrow_cat
    assert any(t is pt.ktable.rows for t in arrs)
    x = torch.from_numpy(_x(256, seed=3))
    y0 = pt.spmv(mt, x)
    changed = 0
    for seed in SEEDS:
        ir = rinj.flip_pack_word(mr, pr, seed)
        it = tinj.flip_pack_word(mt, pt, seed)
        assert it.value_neutral == ir.value_neutral
        assert it.detail["pos"] == ir.detail["pos"]
        y, ok, _ = tgd.guarded_spmv(mt, pt, gt, x)
        assert not bool(ok)
        if it.value_neutral:
            assert torch.equal(y, y0)
        changed += not torch.equal(y, y0)
        it.undo()
        ir.undo()
    assert changed > 0 and bool(tgd.guarded_spmv(mt, pt, gt, x)[1])


def test_poison_x_equals_reference_and_trips():
    (mr, pr), (mt, pt) = _pair(rtm.stencil_1d(200, 2), C=8, sigma=16)
    gt = tgd.build_guard(mt, pt)
    for mode in ("nan", "inf"):
        for seed in SEEDS:
            xr, ir = rinj.poison_x(np.ones(mt.m), seed=seed, mode=mode)
            xt, it = tinj.poison_x(torch.ones(mt.m), seed=seed, mode=mode)
            assert it.detail == ir.detail and not it.value_neutral
            assert xt.dtype == torch.float32
            np.testing.assert_array_equal(xt.numpy(), xr.astype(np.float32))
            assert not bool(tgd.guarded_spmv(mt, pt, gt, xt)[1])
            assert not bool(tgd.guarded_spmv(mt, pt, gt, xt, full=False)[1])
        xn, _ = tinj.poison_x(np.ones(4), seed=1, mode=mode)
        assert isinstance(xn, np.ndarray) and xn.dtype == np.float64
    with pytest.raises(ValueError):
        tinj.poison_x(torch.ones(3), seed=0, mode="zero")


def test_composite_injector_equals_reference_in_place():
    a = _spd(rtm.random_banded(128, 8, 3, seed=10))
    rows = np.arange(128)
    classes = [("fp16", 15, rows[rows % 2 == 0]),
               ("e8m", 8, rows[rows % 2 == 1])]
    ref = rkc.CompositePlan.from_classes(a, classes, C=8, sigma=16)
    port = tkc.CompositePlan.from_classes(a, classes, C=8, sigma=16,
                                          device=CPU, force=["auto", "full"])
    assert port.validate(raise_=False) == []
    x = _x(128, seed=6)
    xt = torch.from_numpy(x)
    y0 = port.spmv(xt)
    for member in (0, 1):
        mem = port.members[member]
        gs = tgd.build_guard(mem.mat, mem.plan)
        changed = 0
        for seed in SEEDS:
            ir = rinj.corrupt_composite_word(ref, member, seed)
            it = tinj.corrupt_composite_word(port, member, seed)
            if member == 0:         # both members' plans differ at 1
                assert (it.target, it.detail, it.value_neutral) == \
                    (ir.target, ir.detail, ir.value_neutral)
            assert it.target == ("composite_fused_word" if member == 0
                                 else "composite_pack_word")
            assert not tgd.check_integrity(mem.mat, mem.plan, gs)
            y = port.spmv(xt)       # no invalidation: the member's buffer
            if it.value_neutral:
                assert torch.equal(y, y0)
            changed += not torch.equal(y, y0)
            it.undo()
            ir.undo()
            assert tgd.check_integrity(mem.mat, mem.plan, gs)
        assert changed > 0
    assert torch.equal(port.spmv(xt), y0)


def test_injection_reaches_cached_solve_graphs():
    """``jacobi_pcg_stored`` keeps its graphs on the plan; an in-place
    fault reaches them, and ``undo()`` takes it out again."""
    a = rop.sym_scale(rtm.hpcg(8, 8, 8))[0]
    mt = tpk.from_csr(a, C=8, sigma=32, codec="fp16", D=15, device=CPU)
    pt = tpl.get_plan(mt)
    b = torch.ones(a.shape[0], dtype=torch.float64)
    x0, i0 = tcg.jacobi_pcg_stored(mt, pt, a.diagonal(), b, tol=1e-8)
    graphs_before = dict(pt._fns)
    inj = next(i for i in (tinj.flip_fused_word(mt, pt, s, bit=27)
                           for s in range(40))
               if not i.value_neutral or i.undo())
    x1, _ = tcg.jacobi_pcg_stored(mt, pt, a.diagonal(), b, tol=1e-8)
    assert not torch.equal(x1, x0)
    inj.undo()
    x2, i2 = tcg.jacobi_pcg_stored(mt, pt, a.diagonal(), b, tol=1e-8)
    assert torch.equal(x2, x0) and i2.iters == i0.iters
    assert pt._fns.keys() == graphs_before.keys()
    assert all(pt._fns[k] is v for k, v in graphs_before.items())


# ---------------------------------------------------------------------------
# structural validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TINY))
def test_validate_clean_build(name):
    (_, _), (mt, pt) = _pair(TINY[name], C=16, sigma=32)
    assert mt.validate(raise_=False) == []
    assert pt.validate(mt, raise_=False) == []
    full = tpl.get_plan(mt, force="full")
    assert full.validate(raise_=False) == []


def test_validate_flags_what_the_reference_flags():
    (mr, pr), (mt, pt) = _pair(rtm.random_banded(256, 16, 5, seed=3),
                               C=16, sigma=32)
    for seed in SEEDS:
        ir = rinj.corrupt_fused_checkpoint(mr, pr, seed)
        it = tinj.corrupt_fused_checkpoint(mt, pt, seed)
        assert pt.validate(mt, raise_=False) == \
            pr.validate(mr, raise_=False)
        ir.undo()
        it.undo()
    assert pt.validate(mt, raise_=False) == []
    # an Inf fp16 payload in a live word
    (mr, pr), (mt, pt) = _pair(rtm.stencil_1d(128, 2), C=8, sigma=16)
    w = mt.packs[0].numpy().view(np.uint32).reshape(-1)
    _, _, flag = rcd.unpack_words_np(w, mr.codec, mr.D)
    live = int(np.nonzero(flag == 1)[0][0])
    bad = (w[live] & np.uint32(0xFFFF)) | (np.uint32(0x7C00) << np.uint32(16))
    old = int(mt.packs[0].view(-1)[live])
    mt.packs[0].view(-1)[live] = int(bad.view(np.int32))
    issues = mt.validate(raise_=False)
    assert any("non-finite" in s for s in issues)
    with pytest.raises(tgd.IntegrityError):
        mt.validate(raise_=True)
    mt.packs[0].view(-1)[live] = old
    assert mt.validate(raise_=False) == []
    # a table of other buffers
    full = tpl.get_plan(mt, force="full")
    full.ktable = tpl._pk.bucket_table(
        [p.clone() for p in mt.packs], mt.d0s, full.kckpts,
        [wb for _, wb in full.tiles])
    assert "bucket table built for other buckets" in \
        full.validate(raise_=False)


def test_build_plan_rejects_garbage():
    bad = tpk.from_csr(rtm.stencil_1d(96, 2).tocsr(), C=8, sigma=16,
                       device=CPU)
    o0 = bad.outrows[0]
    real = torch.nonzero(o0 < bad.n).reshape(-1)
    o0[real[1]] = o0[real[0]]            # duplicate a stored row
    with pytest.raises(ValueError):
        tpl.build_plan(bad)


def test_composite_validation_flags_a_bad_inverse():
    a = rtm.random_banded(64, 4, 3, seed=1)
    cp = tkc.CompositePlan.from_classes(a, [("e8m", 8, None)], C=8,
                                        sigma=16, device=CPU)
    assert cp.validate(raise_=False) == []
    cp._invs_np = (np.full(64, 10_000, np.int32),)
    assert "inverse indexes outside" in cp.validate(raise_=False)[0]
    with pytest.raises(tgd.IntegrityError):
        cp.validate()


# ---------------------------------------------------------------------------
# the guard's stride, spmm, integrity probe and health
# ---------------------------------------------------------------------------


def test_stride_counters_equal_reference():
    (mr, pr), (mt, pt) = _pair(rtm.stencil_1d(128, 2), C=8, sigma=16)
    gr = rgd.build_guard(mr, pr, every=3)
    gt = tgd.build_guard(mt, pt, every=3)
    x = _x(128)
    for k in range(7):
        _, _, rel_r = rgd.guarded_spmv(mr, pr, gr, jnp.asarray(x))
        _, _, rel_t = tgd.guarded_spmv(mt, pt, gt, torch.from_numpy(x))
        assert (gt.calls, gt.calls_since_full, gt.last_check_latency) == \
            (gr.calls, gr.calls_since_full, gr.last_check_latency)
        assert (float(rel_t) == 0.0) == (float(rel_r) == 0.0), k
    with pytest.raises(ValueError):
        tgd.build_guard(mt, pt, every=0)


def test_guard_every_reads_the_environment(monkeypatch):
    (_, _), (mt, pt) = _pair(rtm.stencil_1d(64, 2), C=8, sigma=16)
    monkeypatch.setenv("REPRO_GUARD_EVERY", "4")
    assert tgd.build_guard(mt, pt).every == 4


def test_guarded_spmm_clean_and_tripped():
    (mr, pr), (mt, pt) = _pair(rtm.random_banded(256, 16, 5, seed=2),
                               C=16, sigma=32)
    gr, gt = rgd.build_guard(mr, pr), tgd.build_guard(mt, pt)
    X = np.random.default_rng(2).standard_normal((256, 3)).astype(
        np.float32)
    Y, ok, rel = tgd.guarded_spmm(mt, pt, gt, torch.from_numpy(X))
    Yr, okr, relr = rgd.guarded_spmm(mr, pr, gr, jnp.asarray(X))
    assert bool(ok) and bool(okr) and float(rel) < 1e-6
    assert torch.equal(Y, pt.spmm(mt, torch.from_numpy(X)))
    inj = tinj.flip_fused_word(mt, pt, seed=4)
    assert not bool(tgd.guarded_spmm(mt, pt, gt, torch.from_numpy(X))[1])
    inj.undo()
    with pytest.raises(ValueError):
        tgd.guarded_spmm(mt, pt, gt, torch.from_numpy(X[:, 0]))


def test_check_integrity_probe_and_refresh():
    (_, _), (mt, pt) = _pair(rtm.stencil_1d(128, 2), C=8, sigma=16)
    gs = tgd.build_guard(mt, pt)
    assert tgd.check_integrity(mt, pt, gs)
    i = tinj.flip_fused_word(mt, pt, seed=1)
    assert not tgd.check_integrity(mt, pt, gs)
    gs.refresh_checksum(mt, pt)
    assert tgd.check_integrity(mt, pt, gs)
    i.undo()


def test_plan_health_marking():
    (_, _), (mt, pt) = _pair(rtm.stencil_1d(96, 2), C=8, sigma=16)
    assert tgd.is_healthy(pt) and tgd.plan_health(pt) is None
    tgd.mark_unhealthy(pt, "guard_trip")
    assert not tgd.is_healthy(pt) and tgd.plan_health(pt) == "guard_trip"


def test_guarded_kind_counts_trips():
    a = _spd(TINY["banded"])
    ops_t = top.OperatorSet(a, C=32, sigma=64, device=CPU)
    ops_r = rop.OperatorSet(a, C=32, sigma=64)
    fn, fr = ops_t.matvec("guarded:plan_fp16"), ops_r.matvec(
        "guarded:plan_fp16")
    x = _x(a.shape[0])
    fn(torch.from_numpy(x))
    fr(jnp.asarray(x))
    assert fn.trips() == fr.trips() == 0
    for seed, bit in ((3, 28), (5, 2), (8, 30)):
        i = tinj.flip_fused_word(*fn.pair, seed=seed, bit=bit)
        ir = rinj.flip_fused_word(*fr.pair, seed=seed, bit=bit)
        y = fn(torch.from_numpy(x))
        fr(jnp.asarray(x))
        assert fn.trips() == fr.trips()
        assert torch.equal(y, fn.pair[1].spmv(fn.pair[0],
                                              torch.from_numpy(x)))
        i.undo()
        ir.undo()
    assert fn.trips() == 3 and tgd.plan_health(fn.pair[1]) == "guard_trip"
    assert fn.guard is not None and ops_t.stored("guarded:plan_fp16") is \
        fn.pair[0]


# ---------------------------------------------------------------------------
# guarded_solve
# ---------------------------------------------------------------------------


def test_promotion_ladder_equals_reference():
    for kind in ("plan_fp16", "plan_bf16", "plan_e8m12", "plan_e8m1"):
        assert trc.promotion_ladder(kind) == rrc.promotion_ladder(kind)
    with pytest.raises(ValueError):
        trc.promotion_ladder("fp64")


def _log_shape(log):
    return [(e["step"], e["event"], e["action"], e["detail"].get("kind"))
            for e in log]


def _solve_both(a, kind, b, sabotage_t=None, sabotage_r=None, **kw):
    ops_t = top.OperatorSet(a, C=32, sigma=64, device=CPU)
    ops_r = rop.OperatorSet(a, C=32, sigma=64)
    xt, it = trc.guarded_solve(ops_t, kind, b, on_step=sabotage_t, **kw)
    xr, ir = rrc.guarded_solve(ops_r, kind, b, on_step=sabotage_r, **kw)
    assert _log_shape(it.log) == _log_shape(ir.log)
    assert (it.iters, it.trips, it.final_kind) == \
        (ir.iters, ir.trips, ir.final_kind)
    assert np.linalg.norm(xt - xr) <= 1e-6 * np.linalg.norm(xr)
    return xt, it


def _fault(pkg, fired, step=1, seed=19, bit=27):
    def sabotage(k, ctx):
        if k == step and not fired and ctx["plan"] is not None \
                and ctx["plan"].fused is not None:
            fired.append(pkg.flip_fused_word(ctx["mat"], ctx["plan"],
                                             seed=seed, bit=bit))
    return sabotage


@pytest.mark.parametrize("name", sorted(TINY))
def test_guarded_solve_mid_solve_fault_log_equals_reference(name):
    a = _spd(TINY[name])
    b = np.random.default_rng(17).standard_normal(a.shape[0])
    ft, fr = [], []
    x, info = _solve_both(a, "guarded:plan_fp16", b, _fault(tinj, ft),
                          _fault(rinj, fr), tol=1e-8, maxiter=60, m_in=16)
    assert ft and fr and info.trips >= 1
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) <= 1e-8
    assert info.relres <= 1e-8
    assert ft[0].detail == fr[0].detail


def test_guarded_solve_clean_no_trips():
    a = _spd(TINY["stencil1d"])
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    x, info = _solve_both(a, "plan_fp16", b, tol=1e-9, maxiter=60)
    assert info.trips == 0 and info.log == []
    assert info.relres <= 1e-9 and info.final_kind == "plan_fp16"


def test_guarded_solve_poisoned_x_heals():
    a = _spd(TINY["scattered"])
    b = np.random.default_rng(5).standard_normal(a.shape[0])

    def sabotage(step, ctx):
        if step == 1:
            ctx["x"][0] = np.nan

    x, info = _solve_both(a, "plan_fp16", b, sabotage, sabotage, tol=1e-8,
                          maxiter=60)
    assert np.all(np.isfinite(x)) and info.relres <= 1e-8
    assert any(e["event"] == "nonfinite_residual" for e in info.log)


def test_guarded_solve_escalates_and_old_graphs_die(monkeypatch):
    """A fault re-injected on every fused plan it meets walks the whole
    policy: retry, promote, rebuild, fp32. After each new binding the old
    one, and with it every graph its correction solves captured over the
    old plan, is gone (with the collector off: no cycle keeps it)."""
    a = _spd(TINY["banded"])
    b = np.random.default_rng(7).standard_normal(a.shape[0])
    made = []
    Binding = trc._Binding

    class Watched(Binding):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(weakref.ref(self))

    monkeypatch.setattr(trc, "_Binding", Watched)

    def always_t(step, ctx):
        if ctx["plan"] is not None:
            flip = (tinj.flip_fused_word if ctx["plan"].fused is not None
                    else tinj.flip_pack_word)
            flip(ctx["mat"], ctx["plan"], seed=step, bit=30)

    def always_r(step, ctx):
        if ctx["plan"] is not None:
            flip = (rinj.flip_fused_word if ctx["plan"].fused is not None
                    else rinj.flip_pack_word)
            flip(ctx["mat"], ctx["plan"], seed=step, bit=30)

    collecting = gc.isenabled()
    gc.disable()
    try:
        x, info = _solve_both(a, "plan_fp16", b, always_t, always_r,
                              tol=1e-8, maxiter=60)
        actions = [e["action"] for e in info.log]
        assert actions[:2] == ["retry", "promote"]
        assert "rebuild" in actions and actions[-1] == "fp32_fallback"
        assert info.final_kind == "fp32" and info.relres <= 1e-8
        alive = [r for r in made if r() is not None]
        assert len(made) == 1 + actions.count("promote") + \
            actions.count("rebuild") + actions.count("fp32_fallback")
        assert alive == []        # the last binding died with the solve
    finally:
        if collecting:
            gc.enable()


# ---------------------------------------------------------------------------
# REPRO_DEBUG_FINITE
# ---------------------------------------------------------------------------


def test_debug_finite_env_guard(monkeypatch):
    (_, _), (mt, _) = _pair(rtm.stencil_1d(96, 2), C=8, sigma=16)
    x_bad, _ = tinj.poison_x(torch.ones(mt.m), seed=2)
    monkeypatch.delenv("REPRO_DEBUG_FINITE", raising=False)
    tops.packsell_spmv(mt, x_bad)           # off: NaNs flow through
    monkeypatch.setenv("REPRO_DEBUG_FINITE", "1")
    with pytest.raises(FloatingPointError, match="non-finite"):
        tops.packsell_spmv(mt, x_bad)
    tops.packsell_spmv(mt, torch.ones(mt.m))
