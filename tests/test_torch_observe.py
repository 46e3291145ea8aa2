"""repro_torch's flight recorder against the reference, on the CPU.

* the registry: the same ``inc``/``gauge``/``observe``/``record_trace``
  calls give equal snapshots in both packages, reservoir quantiles
  included; the Prometheus text of each parses in the other; the JSONL
  sink's deltas, its rebase after ``reset`` and whole records under
  concurrent flushes; the exporter's clean shutdown; ``run_meta``'s keys;
* ``REPRO_OBS`` on against off gives the same bits for
  ``jacobi_pcg_stored``, ``adaptive_pcg`` and ``plan.spmv``, and nothing
  records inside a graph body (the reference's tracer skip);
* the counter series both packages record for the same calls: plan
  dispatches and the plan cache, ``record_solve``, the store, the
  composite, the guard and ``guarded_solve``. The series that legitimately
  differ are listed with their reasons (:data:`DIFFERS`);
* ``profile_dispatch`` on the CPU attributes ``plan.spmv``'s time to the
  plan's spans, and keeps the reference's wall-clock marker when the
  profiler fails.
"""
import gc
import json
import os
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro import observe as robs
from repro.core import packsell as rpk
from repro.core import testmats as rtm
from repro.kernels import composite as rkc
from repro.kernels import plan as rpl
from repro.observe import export as rexp
from repro.observe import metrics as rmet
from repro.precision import store as rst
from repro.robust import guard as rgd
from repro.robust import inject as rinj
from repro.robust import recover as rrc
from repro.solvers import cg as rcg
from repro.solvers import operators as rop
from repro_torch import observe as tobs
from repro_torch.core import packsell as tpk
from repro_torch.kernels import composite as tkc
from repro_torch.kernels import plan as tpl
from repro_torch.observe import export as texp
from repro_torch.observe import metrics as tmet
from repro_torch.observe import profile as tprof
from repro_torch.precision import store as tst
from repro_torch.robust import guard as tgd
from repro_torch.robust import inject as tinj
from repro_torch.robust import recover as trc
from repro_torch.solvers import cg as tcg
from repro_torch.solvers import graphs
from repro_torch.solvers import operators as top

TINY = rtm.suite("tiny")
CPU = "cpu"


def _spd(a):
    s = ((a + a.T) / 2).tocsr()
    return (s + sp.eye(s.shape[0]) * float(np.abs(s).sum(axis=1).max())
            ).tocsr()


@pytest.fixture
def both_on():
    """Both recorders on, clean, restored after."""
    prev = (robs.enable(True), tobs.enable(True))
    robs.reset()
    tobs.reset()
    yield
    robs.reset()
    tobs.reset()
    robs.enable(prev[0])
    tobs.enable(prev[1])


@pytest.fixture
def res_rng():
    """The reservoir streams of both registries, restored after a test
    that reseeds them."""
    states = (rmet._RES_RNG.getstate(), tmet._RES_RNG.getstate())
    yield
    rmet._RES_RNG.setstate(states[0])
    tmet._RES_RNG.setstate(states[1])


def _recorded(obs, fn):
    """``fn()`` with ``obs`` on and reset first; its snapshot after (what
    ``fn`` returns lives until then)."""
    prev = obs.enable(True)
    try:
        obs.reset()
        keep = fn()                                 # noqa: F841
        return obs.snapshot()
    finally:
        obs.reset()
        obs.enable(prev)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _sequence(m):
    m.inc("spmv.dispatch", 3, variant="jnp", codec="fp16")
    m.inc("spmv.dispatch", 2, variant="band", codec="e8m")
    m.inc("serving.tick", 7)
    m.gauge("spmv.bytes_per_nnz", 7.51, codec="fp16")
    m.gauge("weird.gauge", -2.5, note='quo"te', path="a\\b", nl="x\ny")
    for i in range(700):                     # past the reservoir's cap
        m.observe("solver.time_s", float((i * 37) % 101), solver="pcg")
    for v in (0.1, 0.2, 0.4, 0.8):
        m.observe("q.small", v)
    for i in range(m._TRACE_CAP + 5):
        m.record_trace("t", {"i": i}, lane="a")


def test_same_calls_give_equal_snapshots(both_on, res_rng):
    rmet._RES_RNG.seed(0xC0FFEE)
    tmet._RES_RNG.seed(0xC0FFEE)
    _sequence(rmet)
    _sequence(tmet)
    r, t = rmet.snapshot(), tmet.snapshot()
    assert t == r
    assert t["histograms"]["solver.time_s{solver=pcg}"]["count"] == 700
    assert len(t["traces"]["t{lane=a}"]) == tmet._TRACE_CAP


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_prometheus_text_parses_in_the_other_package(both_on, writer,
                                                    res_rng):
    _sequence(rmet)
    _sequence(tmet)
    w, r = (texp, rexp) if writer == "port" else (rexp, texp)
    raw = (tmet if writer == "port" else rmet).raw_snapshot()
    back = r.parse_prometheus_text(w.prometheus_text())
    assert back["counters"] == raw["counters"]
    assert back["gauges"] == raw["gauges"]
    for k, h in raw["histograms"].items():
        assert back["histograms"][k] == {
            f: h[f] for f in ("p50", "p95", "p99", "count", "sum", "min",
                              "max", "last")}
    assert texp.prometheus_text(raw) == rexp.prometheus_text(raw)


def test_prometheus_rejects_malformed():
    with pytest.raises(ValueError, match="malformed"):
        texp.parse_prometheus_text("# TYPE x counter\nx{ 1\n")
    with pytest.raises(ValueError, match="no # TYPE"):
        texp.parse_prometheus_text("nosuch 1\n")


def _sink_records(exp, met, path):
    sink = exp.JsonlSink(str(path), meta={"run": "t1"})
    met.inc("c.a", 5)
    met.observe("h.a", 2.0)
    sink.flush()
    met.inc("c.a", 2)
    met.gauge("g.b", 1.5)
    sink.flush()
    met.reset()
    met.inc("c.a", 3)
    sink.flush()
    recs = exp.JsonlSink.read(str(path))
    for r in recs:
        r.pop("t", None)
    return recs


def test_jsonl_sink_deltas_and_rebase_equal_reference(both_on, tmp_path):
    t = _sink_records(texp, tmet, tmp_path / "t.jsonl")
    r = _sink_records(rexp, rmet, tmp_path / "r.jsonl")
    assert t == r
    assert t[0] == {"kind": "meta", "run": "t1"}
    assert t[1]["counters"] == {"c.a": 5} and t[2]["counters"] == {"c.a": 2}
    assert t[3]["rebased"] is True and t[3]["counters"] == {"c.a": 3}


def test_jsonl_sink_concurrent_flush_and_reset(both_on, tmp_path):
    p = tmp_path / "m.jsonl"
    sink = texp.JsonlSink(str(p))
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            sink.flush()

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for i in range(300):
        tmet.inc("c.hot", 1, lane=str(i % 3))
        tmet.observe("h.hot", float(i % 7))
        if i == 150:
            tobs.reset()
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    sink.flush()
    recs = texp.JsonlSink.read(str(p))
    assert recs[0]["kind"] == "meta"
    deltas = [r for r in recs[1:] if r["kind"] == "delta"]
    assert [r["seq"] for r in deltas] == list(range(len(deltas)))
    assert all(v >= 0 for r in deltas for v in r["counters"].values())


def test_exporter_clean_shutdown(both_on, tmp_path):
    p = tmp_path / "exp.jsonl"
    exp = texp.start_exporter(interval_s=0.05, path=str(p))
    try:
        tmet.inc("c.exp", 4)
        stop = threading.Event()
        stop.wait(0.2)
    finally:
        exp.stop()
    assert not exp.alive
    recs = texp.JsonlSink.read(str(p))
    assert sum(r.get("counters", {}).get("c.exp", 0)
               for r in recs if r["kind"] == "delta") == 4
    n = len(recs)
    exp.stop()                                   # idempotent
    assert len(texp.JsonlSink.read(str(p))) == n
    with texp.Exporter(texp.JsonlSink(str(tmp_path / "cm.jsonl")), 60.0) \
            as ex:
        assert ex.alive
    assert not ex.alive and ex.flushes >= 1


def test_run_meta_keys_map_to_the_reference():
    t, r = texp.run_meta(source="x"), rexp.run_meta(source="x")
    mapped = {"jax_version": "torch_version"}
    assert set(t) == (set(r) - set(mapped)) | set(mapped.values()) | {
        "cuda_version", "device"}
    assert t["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert t["torch_version"] == torch.__version__
    for k in ("git_sha", "platform", "cpu", "python", "source"):
        assert t[k] == r[k]


def test_disabled_recorder_records_nothing():
    prev = tobs.enable(False)
    try:
        tobs.reset()
        tobs.inc("x.count", variant="jnp")
        tobs.gauge("x.g", 3.5)
        tobs.observe("x.h", 1.0)
        tobs.record_trace("x.t", {"a": 1})
        snap = tobs.snapshot()
        assert snap["enabled"] is False
        assert snap["counters"] == snap["histograms"] == snap["traces"] == {}
    finally:
        tobs.enable(prev)


def test_env_default_matches_repro_obs():
    assert tobs.enabled() == tmet._env_on(os.environ.get("REPRO_OBS"))


def test_span_usable_enabled_and_disabled(both_on):
    with tobs.span("packsell.test_span"):
        y = torch.arange(4.0).sum()
    tobs.enable(False)
    with tobs.span("packsell.test_span"):
        y2 = torch.arange(4.0).sum()
    assert float(y) == float(y2)


def test_records_inside_a_graph_body_are_skipped(both_on):
    """The counterpart of the reference's tracer skip: a graph body
    (warm-up, capture, or a CPU run) records nothing."""
    ran = []

    def body():
        tobs.inc("inside")
        ran.append(1)
        return torch.zeros(1)

    g = graphs.Graph(body, torch.device(CPU))
    g()
    g()
    tobs.inc("outside")
    assert len(ran) == 2
    assert tobs.snapshot()["counters"] == {"outside": 1}
    info = tcg.SolveInfo(3, torch.tensor(1e-9), torch.full((8,), -1.0))
    with tmet.quiet():
        tobs.record_solve("fake", info)
    assert "solver.solves{solver=fake}" not in tobs.snapshot()["counters"]
    tobs.record_solve("fake", info)
    snap = tobs.snapshot()
    assert snap["counters"]["solver.solves{solver=fake}"] == 1
    rec = snap["traces"]["solver.trace{solver=fake}"][-1]
    assert rec["iters"] == 3 and len(rec["history"]) == 4


def test_report_carries_plan_cache_and_graph_replays(both_on):
    mat = tpk.from_csr(rtm.stencil_1d(96, 2), C=8, sigma=16, D=15,
                       codec="fp16", device=CPU)
    tpl.clear_cache()
    plan = tpl.get_plan(mat)
    plan.spmv(mat, torch.ones(mat.m))
    rep = tobs.report()
    assert rep["enabled"] is True
    assert any(k.startswith("spmv.dispatch{") for k in rep["counters"])
    assert rep["counters"]["plan_cache.miss"] == 1
    assert rep["plan_cache"]["misses"] >= 1
    assert rep["plan_cache"]["jit_cache_cap"] == tpl.JIT_CACHE_CAP
    assert set(rep["graphs"]) == {"replays", "replayed_calls"}


def test_plan_fns_is_a_bounded_lru(both_on):
    d = tpl.LRUDict()
    for i in range(tpl.JIT_CACHE_CAP + 3):
        d[i] = i
    d.get(3)                                    # touch: 3 becomes MRU
    d["new"] = 0
    assert len(d) == tpl.JIT_CACHE_CAP and 3 in d and 4 not in d
    assert tobs.snapshot()["counters"]["jit_cache.evict{cache=plan._fns}"] \
        == 4


# ---------------------------------------------------------------------------
# REPRO_OBS on and off: the same bits
# ---------------------------------------------------------------------------


def _on_off(fn):
    out = []
    for on in (False, True):
        prev = tobs.enable(on)
        try:
            tobs.reset()
            tpl.clear_cache()
            out.append(fn())
        finally:
            tobs.enable(prev)
            tobs.reset()
    return out


def _bits(*ts):
    return tuple(np.asarray(t.numpy() if torch.is_tensor(t) else t).tobytes()
                 for t in ts)


@pytest.mark.parametrize("klass", ["stencil1d", "banded"])
def test_obs_parity_jacobi_pcg_stored(klass):
    s = _spd(TINY[klass])
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        s.shape[0]))

    def solve():
        ops = top.OperatorSet(s, C=32, sigma=64, device=CPU)
        mat, plan = ops.plan_pair("plan_fp16")
        x, info = tcg.jacobi_pcg_stored(mat, plan, s.diagonal(), b,
                                        tol=1e-8, maxiter=100)
        x2, _ = tcg.jacobi_pcg_stored(mat, plan, s.diagonal(), b,
                                      tol=1e-8, maxiter=100)
        return _bits(x, x2, info.history) + (info.iters,)

    off, on = _on_off(solve)
    assert off == on


@pytest.mark.parametrize("klass", ["stencil1d", "banded"])
def test_obs_parity_adaptive_pcg(klass):
    s = _spd(TINY[klass])
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        s.shape[0]))

    def solve():
        ops = top.OperatorSet(s, C=32, sigma=64, device=CPU)
        tiers, _, _, hi = ops.adaptive_tiers(1e-3, n_probes=2)
        x, info = tcg.adaptive_pcg(tiers, b, matvec_hi=hi, tol=1e-8,
                                   maxiter=40, m_in=8)
        return _bits(x, info.history, info.tier_history) + (info.iters,)

    off, on = _on_off(solve)
    assert off == on


def test_obs_parity_spmv_and_spmm():
    a = TINY["powerlaw"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (a.shape[1], 3)).astype(np.float32))

    def run():
        out = []
        for force in ("auto", "fused", "full", "jnp"):
            mat = tpk.from_csr(a, C=8, sigma=32, D=15, codec="fp16",
                               device=CPU)
            plan = tpl.get_plan(mat, force=force)
            out += [plan.spmv(mat, x[:, 0].contiguous()), plan.spmm(mat, x),
                    plan.spmv(mat, x[:, 1].contiguous(), permuted=True)]
        return _bits(*out)

    off, on = _on_off(run)
    assert off == on


def test_instrumented_spmv_counts_every_call(both_on):
    mat = tpk.from_csr(rtm.stencil_1d(128, 3), C=8, sigma=32, D=15,
                       codec="fp16", device=CPU)
    tpl.clear_cache()
    plan = tpl.get_plan(mat)
    for i in range(10):
        plan.spmv(mat, torch.ones(mat.m) * i)
    assert [k for k in plan._fns] == [("_obs", "spmv")]   # one record
    snap = tobs.snapshot()
    disp = [v for k, v in snap["counters"].items()
            if k.startswith("spmv.dispatch{")]
    assert disp == [10]
    assert [v for k, v in snap["gauges"].items()
            if k.startswith("spmv.bytes_per_nnz{")][0] > 0


# ---------------------------------------------------------------------------
# counter series: both packages, the same calls
# ---------------------------------------------------------------------------

#: series that legitimately differ between the packages, with the reason:
#: the port runs ``guarded_solve``'s correction solve and IO-CG's
#: ``pcg_reference`` with a ``jit_cache`` (their graphs are kept per
#: binding), so its ``path`` label is ``jit_cache`` where the reference's
#: uncached call says ``eager``, and its set-up matvec belongs to that
#: cached solve (no ``spmv.dispatch``) where the reference's eager set-up
#: records one dispatch per correction
DIFFERS = {
    "guarded_solve": ("solver.solves{path=", "solver.iters{path=",
                      "spmv.dispatch{", "spmv.nnz{"),
}


def _counters(snap, drop=()):
    return {k: v for k, v in snap["counters"].items()
            if not k.startswith(tuple(drop))}


def _hist_counts(snap):
    return {k: h["count"] for k, h in snap["histograms"].items()}


def _plan_dispatch(pk, pl, arr, dev):
    a = TINY["powerlaw"]
    rng = np.random.default_rng(4)
    mat = pk.from_csr(a, C=8, sigma=32, D=15, codec="fp16", **dev)
    pl.clear_cache()

    def run():
        plan = pl.get_plan(mat)
        plan = pl.get_plan(mat)
        for _ in range(3):
            plan.spmv(mat, arr(rng.standard_normal(a.shape[1]).astype(
                np.float32)))
        for _ in range(2):
            plan.spmm(mat, arr(rng.standard_normal((a.shape[1], 2)).astype(
                np.float32)))
        pl.get_plan(mat, force="full").spmv(mat, arr(np.ones(
            a.shape[1], np.float32)))
        tmp = pk.from_csr(a, C=8, sigma=32, D=12, codec="e8m", **dev)
        pl.get_plan(tmp)
        del tmp
        gc.collect()
    return run


def test_plan_series_equal_reference():
    r = _recorded(robs, _plan_dispatch(rpk, rpl, jnp.asarray, {}))
    t = _recorded(tobs, _plan_dispatch(tpk, tpl, torch.from_numpy,
                                       {"device": CPU}))
    assert _counters(t) == _counters(r)
    assert t["gauges"] == r["gauges"]
    assert _hist_counts(t) == _hist_counts(r)
    assert r["counters"]["plan_cache.hit"] == 1
    assert r["counters"]["plan_cache.evict{cause=matrix_dead}"] == 1


def _solves(cg, op, arr, dev):
    s = _spd(TINY["banded"])
    b = np.random.default_rng(3).standard_normal(s.shape[0])

    def run():
        ops = op.OperatorSet(s, C=32, sigma=64, **dev)
        diag = arr(s.diagonal())
        dinv = 1.0 / diag
        cg.pcg(ops.matvec("plan_fp16"), arr(b), M=lambda r: r * dinv,
               tol=1e-8, maxiter=100)
        mat, plan = ops.plan_pair("plan_fp16")
        cg.jacobi_pcg_stored(mat, plan, s.diagonal(), arr(b), tol=1e-8,
                             maxiter=100)
        tiers, _, _, hi = ops.adaptive_tiers(1e-3, n_probes=2)
        cg.adaptive_pcg(tiers, arr(b), matvec_hi=hi, tol=1e-8, maxiter=40,
                        m_in=8)
    return run


def _trace_shape(snap):
    return {k: [(r["solver"], r["iters"], len(r["history"]),
                 r.get("tier_history"), r.get("promotions")) for r in v]
            for k, v in snap["traces"].items()}


def test_record_solve_series_equal_reference():
    r = _recorded(robs, _solves(rcg, rop, jnp.asarray, {}))
    t = _recorded(tobs, _solves(tcg, top, torch.from_numpy,
                                {"device": CPU}))
    assert _counters(t) == _counters(r)
    assert _trace_shape(t) == _trace_shape(r)
    assert {k for k in r["counters"] if k.startswith("solver.solves")} == {
        "solver.solves{path=eager,solver=pcg}",
        "solver.solves{path=fused,solver=jacobi_pcg_stored}",
        "solver.solves{path=eager,solver=adaptive_pcg}"}
    for k, recs in t["traces"].items():
        for rt, rr in zip(recs, r["traces"][k]):
            assert np.allclose(rt["history"], rr["history"], rtol=1e-4,
                               atol=1e-12)


def _store_calls(st, inj, pk, pl, dev, path):
    a = TINY["powerlaw"]

    def run():
        s = st.PrecisionStore(path)
        s.lookup_or_select(a, 1e-3)                     # miss
        s.lookup_or_select(a, 1e-3)                     # hit
        s.lookup_or_select(a, 1e-3, validate=True)      # hit, validated
        mat = pk.from_csr(a, C=8, sigma=32, codec="e8m", D=8, **dev)
        plan = pl.build_plan(mat, force="full")
        fp = st.matrix_fingerprint(a)
        s.put_retile(fp, "plan_e8m8", [(4, 16)] * len(plan.tiles),
                     backend="cpu")
        s.apply_retile(fp, "plan_e8m8", plan, backend="cpu")   # yes
        s.apply_retile(fp, "missing", plan, backend="cpu")     # no
        inj.corrupt_store(path, seed=3, mode="garble")
        with pytest.warns(RuntimeWarning):
            st.PrecisionStore(path)                     # quarantine
    return run


def test_store_series_equal_reference(tmp_path):
    r = _recorded(robs, _store_calls(rst, rinj, rpk, rpl, {},
                                     str(tmp_path / "r.json")))
    t = _recorded(tobs, _store_calls(tst, tinj, tpk, tpl, {"device": CPU},
                                     str(tmp_path / "t.json")))
    assert _counters(t) == _counters(r)
    want = {"store.lookup{mode=global,outcome=miss}": 1,
            "store.lookup{mode=global,outcome=hit}": 2,
            "store.retile{applied=yes}": 1, "store.retile{applied=no}": 1,
            "store.quarantine": 1}
    assert {k: t["counters"].get(k) for k in want} == want


def _composite_calls(kc, arr, dev):
    a = TINY["banded"].tocsr()
    rows = np.arange(a.shape[0])
    classes = [("fp16", 15, rows[rows % 2 == 0]),
               ("e8m", 8, rows[rows % 2 == 1])]
    x = np.random.default_rng(2).standard_normal(
        (a.shape[1], 2)).astype(np.float32)

    def run():
        cp = kc.CompositePlan.from_classes(a, classes, C=8, sigma=32, **dev)
        cp.spmv(arr(x[:, 0].copy()))
        cp.spmv(arr(x[:, 1].copy()))
        cp.spmm(arr(x))
        return cp
    return run


def test_composite_series_equal_reference():
    r = _recorded(robs, _composite_calls(rkc, jnp.asarray, {}))
    t = _recorded(tobs, _composite_calls(tkc, torch.from_numpy,
                                         {"device": CPU}))
    assert _counters(t) == _counters(r)
    assert r["counters"][
        "composite.dispatch{composite=mixed,kind=spmv,members=2,terms=1}"] \
        == 2


def _guard_calls(pk, pl, gd, inj, rc, op, arr, dev):
    a = _spd(TINY["stencil1d"])
    x = np.random.default_rng(6).standard_normal(a.shape[1]).astype(
        np.float32)
    b = np.random.default_rng(17).standard_normal(a.shape[0])

    def run():
        mat = pk.from_csr(a, C=32, sigma=64, codec="fp16", D=15, **dev)
        plan = pl.get_plan(mat)
        gs = gd.build_guard(mat, plan, every=2)
        for _ in range(3):
            gd.guarded_spmv(mat, plan, gs, arr(x))
        gd.guarded_spmm(mat, plan, gs, arr(np.stack([x, x], 1)))
        i = inj.flip_fused_word(mat, plan, seed=5, bit=27)
        _, ok, _ = gd.guarded_spmv(mat, plan, gs, arr(x), full=True)
        if not bool(ok):
            gd.mark_unhealthy(plan, "guard_trip")
        i.undo()
        fired = []

        def sabotage(k, ctx):
            if k == 1 and not fired and ctx["plan"] is not None:
                fired.append(inj.flip_fused_word(ctx["mat"], ctx["plan"],
                                                 seed=19, bit=27))

        ops = op.OperatorSet(a, C=32, sigma=64, **dev)
        rc.guarded_solve(ops, "guarded:plan_fp16", b, tol=1e-8, maxiter=60,
                         m_in=16, on_step=sabotage)
    return run


def test_guard_series_equal_reference():
    r = _recorded(robs, _guard_calls(rpk, rpl, rgd, rinj, rrc, rop,
                                     jnp.asarray, {}))
    t = _recorded(tobs, _guard_calls(tpk, tpl, tgd, tinj, trc, top,
                                     torch.from_numpy, {"device": CPU}))
    drop = DIFFERS["guarded_solve"]
    assert _counters(t, drop) == _counters(r, drop)
    assert _hist_counts(t) == _hist_counts(r)
    assert t["histograms"]["guard.detection_latency_calls{event=guard_trip}"
                           ] == r["histograms"][
        "guard.detection_latency_calls{event=guard_trip}"]
    assert [{k: v for k, v in e.items() if k != "relres"}
            for e in t["traces"]["guard.solve{kind=plan_fp16}"]] \
        == [{k: v for k, v in e.items() if k != "relres"}
            for e in r["traces"]["guard.solve{kind=plan_fp16}"]]
    assert t["counters"]["guard.plan_unhealthy{reason=guard_trip}"] >= 2
    assert t["counters"]["guard.check{depth=light}"] >= 1
    # the listed differences, as stated
    assert "solver.solves{path=jit_cache,solver=pcg}" in t["counters"]
    assert "solver.solves{path=eager,solver=pcg}" in r["counters"]
    assert not any(k.startswith("spmv.dispatch") for k in t["counters"])


# ---------------------------------------------------------------------------
# span profiling
# ---------------------------------------------------------------------------


def test_profile_dispatch_attributes_plan_spans():
    a = TINY["hpcg_mini"]
    mat = tpk.from_csr(a.tocsr(), C=32, sigma=256, D=15, codec="fp16",
                       device=CPU)
    plan = tpl.get_plan(mat)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        mat.m).astype(np.float32))
    prof = tprof.profile_dispatch(lambda v: plan.spmv(mat, v), x,
                                  repeats=5, device=CPU)
    assert prof.mode == "trace" and not prof.profiler_unavailable
    assert prof.backend == "cpu"
    assert prof.spans["packsell.fused_decode"]["device_s"] > 0
    assert prof.spans["packsell.gather_epilogue"]["device_s"] > 0
    assert prof.attributed_frac >= 0.8
    assert prof.accounted_frac_of_wall >= 0.8
    d = prof.to_dict()
    assert d["spans"] and d["wall_s"] > 0
    assert set(d) == set(tprof.SpanProfile.__dataclass_fields__)


def test_profile_dispatch_fallback_marker_on_the_cpu(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tprof, "_trace_events", boom)
    prof = tprof.profile_dispatch(lambda v: v * 2.0, torch.ones(3),
                                  repeats=3, device=CPU)
    assert prof.profiler_unavailable is True
    assert prof.mode == "wallclock" and "trace failed" in prof.note
    assert prof.wall_s > 0


def test_span_names_equal_reference():
    from repro.observe import profile as rprof

    assert tprof.SPAN_NAMES == rprof.SPAN_NAMES
    assert set(tprof.SpanProfile.__dataclass_fields__) == set(
        rprof.SpanProfile.__dataclass_fields__)


def test_export_json_round_trip(both_on, tmp_path):
    tobs.inc("c")
    p = tmp_path / "obs.json"
    tobs.export_json(str(p))
    assert json.loads(p.read_text())["counters"]["c"] == 1
    tobs.reset()
    assert tobs.snapshot()["counters"] == {}


def test_reservoir_draws_match_reference_past_the_cap(both_on, res_rng):
    for seed in (0, 1):
        rmet._RES_RNG.seed(seed)
        tmet._RES_RNG.seed(seed)
        draw = random.Random(seed)
        vals = [draw.random() for _ in range(1000)]
        for v in vals:
            rmet.observe("q", v)
            tmet.observe("q", v)
        assert tmet.snapshot()["histograms"] == rmet.snapshot()["histograms"]
        robs.reset()
        tobs.reset()
