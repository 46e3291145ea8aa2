"""repro_torch's serving policies and front end, on the CPU.

* every case of the reference's ``TestPolicies`` and ``TestFrontend``
  (``tests/test_serving.py``), and its exporter-lifecycle cases but the
  LM decode engine's, run on the port;
* each front-end scenario, and the chaos campaigns of
  ``tests/test_serving_chaos.py`` with the same injector seeds (the
  breaker's open and re-close, store garbling, a stale plan token, the
  overload-plus-faults acceptance trace), run through both packages on a
  ``ManualClock`` with ``background=False``: the request statuses,
  reasons, ``tier_kind``s, deadline flags and times, ``stats()``
  (latencies included, which the clock makes exact), every breaker's
  transitions and the ``frontend.*`` series are equal; y is bit-equal
  on integer data and otherwise within ``Y_RTOL`` of the reference's;
* the default admission limit (derived from the card's L2, not the
  reference's TPU VMEM limit) admits HPCG 104³ at 4 slots;
* the background worker holds ``graphs.CAPTURE_LOCK`` around each task,
  and a rebuild raises the old plan's generation.

Each scenario's reference run is computed once per module (``ref``).
"""
import logging
import threading
import types

import numpy as np
import pytest
import torch

from repro.core import testmats as rtm
from repro.observe import metrics as robs
from repro.precision import store as rst
from repro.robust import inject as rinj
from repro.serving import frontend as rfe
from repro.serving import policy as rpol
from repro_torch.observe import export as texp
from repro_torch.observe import metrics as tobs
from repro_torch.precision import store as tst
from repro_torch.robust import inject as tinj
from repro_torch.serving import frontend as fe
from repro_torch.serving import policy as pol
from repro_torch.solvers import graphs

#: y of a non-integer response against the reference's: the fp32 sums of
#: the two packages' plain bodies may round differently
Y_RTOL = 1e-5
#: the chaos harness's tier budget safety (tests/test_serving_chaos.py)
SAFETY = 16.0

REF = types.SimpleNamespace(fe=rfe, pol=rpol, obs=robs, inj=rinj,
                            store=rst, kw={})
PORT = types.SimpleNamespace(fe=fe, pol=pol, obs=tobs, inj=tinj, store=tst,
                             kw={"device": "cpu"})


@pytest.fixture(scope="module")
def tiny_csr():
    return rtm.suite("tiny")["stencil1d"]


@pytest.fixture()
def obs():
    was = tobs.enabled()
    tobs.enable(True)
    tobs.reset()
    yield tobs
    tobs.reset()
    tobs.enable(was)


def mk(P, clock=None, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("background", False)
    kw.setdefault("C", 32)
    kw.setdefault("sigma", 64)
    return P.fe.ServingFrontend(P.fe.FrontendConfig(**P.kw, **kw),
                                clock=clock or P.pol.ManualClock())


def mk_frontend(clock=None, **kw):
    return mk(PORT, clock, **kw)


def in_budget(P, req, a_csr) -> bool:
    kind = "fp32" if req.tier_kind == "fp32_fallback" else req.tier_kind
    budget = P.pol.tier_error_budget(kind, safety=SAFETY)
    x = np.asarray(req.x, np.float64)
    exact = a_csr.astype(np.float64) @ x
    num = float(np.max(np.abs(np.asarray(req.y, np.float64) - exact)))
    anorm = float(np.max(np.abs(a_csr).sum(axis=1)))
    return num <= budget * max(anorm * float(np.max(np.abs(x))), 1e-300)


# ---------------------------------------------------------------------------
# the reference's policy cases, on the port
# ---------------------------------------------------------------------------


class TestPolicies:
    def test_manual_clock_is_monotonic(self):
        c = pol.ManualClock()
        c.advance(1.5)
        assert c() == 1.5
        with pytest.raises(ValueError):
            c.advance(-0.1)

    def test_backoff_schedule_is_deterministic(self):
        bp = pol.BackoffPolicy(base=0.01, mult=2.0, max_delay=0.05,
                               max_attempts=4)
        assert [bp.delay(k) for k in (1, 2, 3, 4)] == \
            [0.01, 0.02, 0.04, 0.05]
        assert not bp.exhausted(3)
        assert bp.exhausted(4)
        with pytest.raises(ValueError):
            bp.delay(0)

    def test_backoff_jitter_is_seeded(self):
        a = pol.BackoffPolicy(jitter=0.5, seed=7)
        b = pol.BackoffPolicy(jitter=0.5, seed=7)
        r = rpol.BackoffPolicy(jitter=0.5, seed=7)
        seq_a = [a.delay(k) for k in (1, 2, 3)]
        assert seq_a == [b.delay(k) for k in (1, 2, 3)]
        assert seq_a == [r.delay(k) for k in (1, 2, 3)]
        assert all(d <= pol.BackoffPolicy().delay(k)
                   for d, k in zip(seq_a, (1, 2, 3)))

    def test_breaker_full_lifecycle(self):
        clk = pol.ManualClock()
        cb = pol.CircuitBreaker(fail_threshold=2, cooldown_s=1.0,
                                probe_successes=2, clock=clk)
        cb.record_failure()
        assert cb.state == pol.CLOSED
        cb.record_failure()
        assert cb.state == pol.OPEN
        assert not cb.allow()
        cb.note_rebuilt()
        assert not cb.allow()
        clk.advance(1.0)
        assert cb.allow()
        assert cb.state == pol.HALF_OPEN
        cb.record_success()
        assert cb.state == pol.HALF_OPEN
        cb.record_success()
        assert cb.state == pol.CLOSED
        assert [(s, d) for _, s, d in cb.transitions] == \
            [(pol.CLOSED, pol.OPEN), (pol.OPEN, pol.HALF_OPEN),
             (pol.HALF_OPEN, pol.CLOSED)]

    def test_breaker_probe_failure_reopens(self):
        clk = pol.ManualClock()
        cb = pol.CircuitBreaker(fail_threshold=1, cooldown_s=0.0, clock=clk)
        cb.record_failure()
        cb.note_rebuilt()
        assert cb.allow() and cb.state == pol.HALF_OPEN
        cb.record_failure()
        assert cb.state == pol.OPEN
        assert not cb.rebuilt

    def test_breaker_open_without_rebuild_never_probes(self):
        clk = pol.ManualClock()
        cb = pol.CircuitBreaker(fail_threshold=1, cooldown_s=0.1, clock=clk)
        cb.record_failure()
        clk.advance(100.0)
        assert not cb.allow()

    def test_admission_vmem_residency_math(self):
        adm = pol.AdmissionPolicy(max_queue=4, vmem_limit_words=1000)
        assert adm.vmem_ok(n=300, m=200, nb=2)
        assert not adm.vmem_ok(n=300, m=200, nb=3)
        assert adm.queue_ok(3) and not adm.queue_ok(4)
        assert adm.occupancy(2) == 0.5

    def test_degradation_hysteresis(self):
        dp = pol.DegradationPolicy(demote1=0.5, demote2=0.8, recover=0.35)
        assert dp.level(0.2) == 0
        assert dp.level(0.6) == 1
        assert dp.level(0.85) == 2
        assert dp.level(0.4, prev_level=2) == 2
        assert dp.level(0.3, prev_level=2) == 0
        ic = pol.DEFAULT_CLASSES[0]
        assert dp.tier_for(ic, 0, 4) == 2
        assert dp.tier_for(ic, 2, 4) == 3

    def test_request_class_floor_validation(self):
        with pytest.raises(ValueError):
            pol.RequestClass("bad", priority=0, deadline_s=1.0,
                             tier=2, tier_floor=1)

    def test_tier_budgets_widen_down_the_ladder(self):
        budgets = [pol.tier_error_budget(k) for k in pol.DEFAULT_LADDER]
        assert budgets == sorted(budgets)
        assert budgets[0] < budgets[-1]


def test_policy_tables_equal_reference():
    assert pol.DEFAULT_LADDER == rpol.DEFAULT_LADDER
    assert [vars(c) for c in pol.DEFAULT_CLASSES] == \
        [vars(c) for c in rpol.DEFAULT_CLASSES]
    for kind in pol.DEFAULT_LADDER + ("plan_e8m8", "plan_e8m1"):
        for safety in (256.0, SAFETY):
            assert pol.tier_error_budget(kind, safety=safety) == \
                rpol.tier_error_budget(kind, safety=safety)
    dp, rdp = pol.DegradationPolicy(), rpol.DegradationPolicy()
    for occ in np.linspace(0, 1, 21):
        for prev in (0, 1, 2):
            assert dp.level(occ, prev) == rdp.level(occ, prev)


def test_default_admission_admits_hpcg_104_at_4_slots():
    n = m = 104 ** 3                       # testmats.hpcg(104, 104, 104)
    adm = pol.AdmissionPolicy()
    assert adm.vmem_ok(n, m, 4)
    # no default limit: past the L2 line (nb 12 and 16) and at 150^3 too
    assert adm._limit() is None
    assert adm.vmem_ok(n, m, 12) and adm.vmem_ok(n, m, 16)
    assert adm.vmem_ok(150 ** 3, 150 ** 3, 4)
    # the reference's TPU VMEM default would reject it at the door
    assert not rpol.AdmissionPolicy().vmem_ok(n, m, 4)
    # an explicit limit behaves exactly as the reference's
    for w in (1000, 9_000_000):
        assert pol.AdmissionPolicy(vmem_limit_words=w).vmem_ok(n, m, 4) == \
            rpol.AdmissionPolicy(vmem_limit_words=w).vmem_ok(n, m, 4)


# ---------------------------------------------------------------------------
# the reference's front-end cases, on the port
# ---------------------------------------------------------------------------


class TestFrontend:
    def test_deadline_miss_on_monotonic_clock(self, tiny_csr):
        clk = pol.ManualClock()
        with mk_frontend(clk) as f:
            fp = f.register(tiny_csr, warm=False)
            rng = np.random.default_rng(0)
            late = f.submit(fp, rng.standard_normal(tiny_csr.shape[1]),
                            klass="standard", deadline_s=0.1)
            ok = f.submit(fp, rng.standard_normal(tiny_csr.shape[1]),
                          klass="standard", deadline_s=10.0)
            clk.advance(0.2)
            f.run_until_drained()
            assert late.status == "deadline_miss"
            assert late.y is None
            assert ok.status == "ok" and not ok.missed_deadline
            assert f.stats()["deadline_misses"] == 1

    def test_completed_late_is_accounted(self, tiny_csr, monkeypatch):
        clk = pol.ManualClock()
        with mk_frontend(clk) as f:
            fp = f.register(tiny_csr, warm=False)
            r = f.submit(fp, np.ones(tiny_csr.shape[1]), deadline_s=0.1)
            orig = fe.ServingFrontend._run_batch

            def slow(self, *a, **kw):
                clk.advance(0.5)
                return orig(self, *a, **kw)

            monkeypatch.setattr(fe.ServingFrontend, "_run_batch", slow)
            f.run_until_drained()
            assert r.status == "ok"
            assert r.missed_deadline
            assert f.stats()["deadline_misses"] == 1

    def test_queue_full_rejects_loudly(self, tiny_csr, caplog, obs):
        with mk_frontend(admission=pol.AdmissionPolicy(max_queue=2)) as f:
            fp = f.register(tiny_csr, warm=False)
            x = np.ones(tiny_csr.shape[1])
            a, b = f.submit(fp, x), f.submit(fp, x)
            with caplog.at_level(logging.WARNING):
                c = f.submit(fp, x)
            assert (a.status, b.status) == ("queued", "queued")
            assert c.status == "rejected" and c.reason == "queue_full"
            assert any("REJECTED" in m for m in caplog.messages)
            shed = {k: v for k, v in obs.snapshot()["counters"].items()
                    if k.startswith("frontend.shed")}
            assert sum(shed.values()) == 1

    def test_vmem_admission_guard_rejects(self, tiny_csr):
        n, m = tiny_csr.shape
        adm = pol.AdmissionPolicy(vmem_limit_words=(n + m) * 2)
        with mk_frontend(slots=4, admission=adm) as f:
            fp = f.register(tiny_csr, warm=False)
            r = f.submit(fp, np.ones(m))
            assert r.status == "rejected" and r.reason == "vmem"
        with mk_frontend(slots=2, admission=adm) as f:
            fp = f.register(tiny_csr, warm=False)
            assert f.submit(fp, np.ones(m)).status == "queued"

    def test_unknown_fingerprint_and_class_raise(self, tiny_csr):
        with mk_frontend() as f:
            with pytest.raises(fe.AdmissionError):
                f.submit("deadbeef", np.ones(4))
            fp = f.register(tiny_csr, warm=False)
            with pytest.raises(fe.AdmissionError):
                f.submit(fp, np.ones(tiny_csr.shape[1]), klass="nope")
            with pytest.raises(fe.AdmissionError):
                f.submit(fp, np.ones(3))

    def test_coalesced_spmm_bitexact_vs_spmv(self, tiny_csr):
        a = tiny_csr.copy()
        rng = np.random.default_rng(3)
        a.data = rng.integers(-4, 5, size=a.nnz).astype(np.float64)
        a.eliminate_zeros()
        with mk_frontend(slots=4) as f:
            fp = f.register(a, warm=False)
            xs = [rng.integers(-8, 9, size=a.shape[1]).astype(np.float32)
                  for _ in range(4)]
            reqs = [f.submit(fp, x, klass="interactive") for x in xs]
            f.run_until_drained()
            assert all(r.status == "ok" for r in reqs)
            kind = reqs[0].tier_kind
            assert kind.startswith("plan_")
            mat, plan, _ = f._entry(fp).bind(kind)
            for r, x in zip(reqs, xs):
                single = plan.spmv(mat, torch.from_numpy(x)).numpy()
                np.testing.assert_array_equal(r.y, single)

    def test_lru_pool_eviction_and_rewarm(self, obs):
        mats = rtm.suite("tiny")
        names = ["stencil1d", "banded", "scattered"]
        with mk_frontend(plan_pool=2) as f:
            fps = [f.register(mats[k], warm=False) for k in names]
            x = {fp: np.random.default_rng(1).standard_normal(
                mats[k].shape[1]) for fp, k in zip(fps, names)}
            for fp in fps:
                f.submit(fp, x[fp])
                f.run_until_drained()
            assert len(f.pool) == 2
            assert fps[0] not in f.pool
            assert obs.snapshot()["counters"]["frontend.pool_evict"] == 1
            r = f.submit(fps[0], x[fps[0]])
            f.run_until_drained()
            assert r.status == "ok"
            assert fps[0] in f.pool and fps[1] not in f.pool
            a64 = mats["stencil1d"].astype(np.float64)
            ref = a64 @ np.asarray(x[fps[0]], np.float64)
            assert np.max(np.abs(r.y - ref)) <= \
                pol.tier_error_budget(r.tier_kind) * np.max(np.abs(ref))

    def test_shed_order_drops_best_effort_first(self, tiny_csr):
        adm = pol.AdmissionPolicy(max_queue=10, shed_watermark=0.5)
        clk = pol.ManualClock()
        with mk_frontend(clk, admission=adm) as f:
            fp = f.register(tiny_csr, warm=False)
            x = np.ones(tiny_csr.shape[1])
            batch = []
            for _ in range(4):
                batch.append(f.submit(fp, x, klass="batch"))
                clk.advance(0.001)
            inter = []
            for _ in range(4):
                inter.append(f.submit(fp, x, klass="interactive"))
                clk.advance(0.001)
            f.step()
            shed = [r for r in batch + inter if r.status == "shed"]
            assert len(shed) == 3
            assert all(r.klass.name == "batch" for r in shed)
            assert [r.uid for r in shed] == [r.uid for r in batch[1:]]
            f.run_until_drained()
            assert all(r.status == "ok" for r in inter)

    def test_overload_demotes_down_the_ladder(self, tiny_csr):
        adm = pol.AdmissionPolicy(max_queue=10, shed_watermark=0.95)
        with mk_frontend(admission=adm) as f:
            fp = f.register(tiny_csr, warm=False)
            x = np.ones(tiny_csr.shape[1])
            reqs = [f.submit(fp, x, klass="interactive") for _ in range(9)]
            f.run_until_drained()
            assert all(r.status == "ok" for r in reqs)
            assert reqs[0].tier_kind == pol.DEFAULT_LADDER[3]
            r = f.submit(fp, x, klass="interactive")
            f.run_until_drained()
            assert r.tier_kind == pol.DEFAULT_LADDER[2]

    def test_solve_requests_are_served(self, tiny_csr):
        with mk_frontend() as f:
            fp = f.register(tiny_csr, warm=False)
            b = tiny_csr.astype(np.float64) @ np.ones(tiny_csr.shape[0])
            r = f.submit(fp, b, klass="batch", op="solve")
            f.run_until_drained()
            assert r.status == "ok"
            assert r.tier_kind.startswith("solve:")
            assert r.solve_info.relres <= 1e-7


class TestExporterLifecycle:
    def test_exporter_context_manager_stops_and_flushes(self, tmp_path,
                                                        obs):
        obs.inc("lifecycle.probe")
        path = str(tmp_path / "m.jsonl")
        with texp.Exporter(texp.JsonlSink(path), 60.0) as ex:
            assert ex.alive
        assert not ex.alive
        assert ex.flushes >= 1
        assert (tmp_path / "m.jsonl").exists()

    def test_frontend_context_manager_stops_exporter(self, tmp_path,
                                                     tiny_csr, obs):
        path = str(tmp_path / "fe.jsonl")
        with mk_frontend() as f:
            fp = f.register(tiny_csr, warm=False)
            ex = f.start_metrics_exporter(path=path, interval_s=60.0)
            f.submit(fp, np.ones(tiny_csr.shape[1]))
            f.run_until_drained()
            assert ex.alive
        assert not ex.alive and f._exporter is None
        recs = texp.JsonlSink.read(path)
        assert recs[0]["source"] == "serving.frontend"
        assert recs[0]["slots"] == 4 and recs[0]["backend"] in ("cpu",
                                                                "cuda")


# ---------------------------------------------------------------------------
# scenarios through both packages
# ---------------------------------------------------------------------------


def _int_data(a, seed=3):
    a = a.copy()
    rng = np.random.default_rng(seed)
    a.data = rng.integers(-4, 5, size=a.nnz).astype(np.float64)
    a.eliminate_zeros()
    return a


def sc_deadlines(P, a):
    clk = P.pol.ManualClock()
    with mk(P, clk) as f:
        fp = f.register(a, warm=False)
        rng = np.random.default_rng(0)
        reqs = [f.submit(fp, rng.standard_normal(a.shape[1]),
                         klass="standard", deadline_s=d)
                for d in (0.1, 10.0, 0.15)]
        clk.advance(0.2)
        reqs.append(f.submit(fp, rng.standard_normal(a.shape[1]),
                             klass="interactive", deadline_s=0.1))
        f.run_until_drained()
        return f, reqs


def sc_queue_full_and_vmem(P, a):
    n, m = a.shape
    reqs = []
    with mk(P, admission=P.pol.AdmissionPolicy(max_queue=2)) as f:
        fp = f.register(a, warm=False)
        x = np.ones(m)
        reqs += [f.submit(fp, x), f.submit(fp, x), f.submit(fp, x)]
        f.run_until_drained()
    adm = P.pol.AdmissionPolicy(vmem_limit_words=(n + m) * 2)
    with mk(P, slots=4, admission=adm) as g:
        fp = g.register(a, warm=False)
        reqs.append(g.submit(fp, np.ones(m)))
        g.run_until_drained()
    return f, reqs


def sc_coalesced_integer(P, a):
    a = _int_data(a)
    rng = np.random.default_rng(3)
    with mk(P, slots=4) as f:
        fp = f.register(a, warm=False)
        reqs = []
        for klass in ("interactive", "standard", "batch", "interactive",
                      "standard", "batch"):
            reqs.append(f.submit(fp, rng.integers(-8, 9, size=a.shape[1])
                                 .astype(np.float32), klass=klass))
        f.run_until_drained()
        return f, reqs


def sc_lru_pool(P, a):
    mats = rtm.suite("tiny")
    names = ["stencil1d", "banded", "scattered"]
    reqs = []
    with mk(P, plan_pool=2) as f:
        fps = [f.register(mats[k], warm=False) for k in names]
        for i, (fp, k) in enumerate(zip(fps + fps[:1], names + names[:1])):
            reqs.append(f.submit(fp, np.random.default_rng(i)
                                 .standard_normal(mats[k].shape[1])))
            f.run_until_drained()
        return f, reqs


def sc_shed_order(P, a):
    adm = P.pol.AdmissionPolicy(max_queue=10, shed_watermark=0.5)
    clk = P.pol.ManualClock()
    with mk(P, clk, admission=adm) as f:
        fp = f.register(a, warm=False)
        x = np.ones(a.shape[1])
        reqs = []
        for klass in ["batch"] * 4 + ["interactive"] * 4 + ["standard"] * 2:
            reqs.append(f.submit(fp, x, klass=klass))
            clk.advance(0.001)
        f.run_until_drained()
        return f, reqs


def sc_overload_demotes(P, a):
    adm = P.pol.AdmissionPolicy(max_queue=10, shed_watermark=0.95)
    with mk(P, admission=adm) as f:
        fp = f.register(a, warm=False)
        x = np.random.default_rng(5).standard_normal(a.shape[1])
        reqs = [f.submit(fp, x, klass=k) for k in
                ["interactive"] * 5 + ["standard"] * 2 + ["batch"] * 2]
        f.run_until_drained()
        reqs.append(f.submit(fp, x, klass="interactive"))
        f.run_until_drained()
        return f, reqs


def sc_solve(P, a):
    with mk(P) as f:
        fp = f.register(a, warm=False)
        b = a.astype(np.float64) @ np.ones(a.shape[0])
        reqs = [f.submit(fp, b, klass=k, op="solve")
                for k in ("batch", "standard")]
        f.run_until_drained()
        return f, reqs


def sc_chaos_breaker(P, a):
    clk = P.pol.ManualClock()
    with mk(P, clk, fail_threshold=2, cooldown_s=0.008,
            backoff=P.pol.BackoffPolicy(base=0.005, max_attempts=6)) as f:
        fp = f.register(a, warm=False)
        rng = np.random.default_rng(0)
        r0 = f.submit(fp, rng.standard_normal(a.shape[1]),
                      klass="interactive")
        f.run_until_drained()
        kind = r0.tier_kind
        entry = f._entry(fp)
        mat, plan, _ = entry.bind(kind)
        P.inj.flip_fused_word(mat, plan, seed=1)
        real_rebuild, sabotage = entry.rebuild, {"left": 1}

        def sabotaged(k):
            real_rebuild(k)
            if sabotage["left"] > 0:
                sabotage["left"] -= 1
                m2, p2, _ = entry.bind(k)
                P.inj.flip_fused_word(m2, p2, seed=2)

        entry.rebuild = sabotaged
        reqs = [r0] + [f.submit(fp, rng.standard_normal(a.shape[1]),
                                klass="interactive") for _ in range(3)]
        f.run_until_drained(max_ticks=500)
        reqs.append(f.submit(fp, rng.standard_normal(a.shape[1]),
                             klass="interactive"))
        f.run_until_drained()
        assert entry.healthy(kind)
        return f, reqs


def sc_store_garbling(P, a, tmp):
    path = str(tmp / f"{'port' if P is PORT else 'ref'}-store.json")
    P.store.PrecisionStore(path).lookup_or_select(a, 1e-3, sigma=64)
    P.inj.corrupt_store(path, seed=0, mode="garble")
    with mk(P, store=path) as f:
        fp = f.register(a, warm=False)
        rng = np.random.default_rng(1)
        reqs = [f.submit(fp, rng.standard_normal(a.shape[1]),
                         klass=k) for k in ("interactive", "standard",
                                             "interactive")]
        with pytest.warns(RuntimeWarning):
            f.run_until_drained()
        return f, reqs


def sc_stale_token(P, a):
    with mk(P) as f:
        fp = f.register(a, warm=False)
        rng = np.random.default_rng(2)
        r0 = f.submit(fp, rng.standard_normal(a.shape[1]),
                      klass="interactive")
        f.run_until_drained()
        entry = f._entry(fp)
        mat, _, _ = entry.bind(r0.tier_kind)
        mat._plan_token = object()
        assert entry.stale(r0.tier_kind)
        r = f.submit(fp, rng.standard_normal(a.shape[1]),
                     klass="interactive")
        f.run_until_drained()
        assert not entry.stale(r0.tier_kind)
        return f, [r0, r]


def sc_acceptance_trace(P, a):
    """tests/test_serving_chaos.py's acceptance trace: 2x-capacity
    overload plus a 50-injection campaign, in simulated time."""
    DT, SLOTS = 0.01, 4
    clk = P.pol.ManualClock()
    adm = P.pol.AdmissionPolicy(max_queue=32, shed_watermark=0.9)
    rng = np.random.default_rng(7)
    classes = ["interactive", "standard", "batch"]
    with mk(P, clk, slots=SLOTS, admission=adm, fail_threshold=1,
            cooldown_s=0.02, plan_pool=4,
            backoff=P.pol.BackoffPolicy(base=0.005, max_attempts=3)) as f:
        fp = f.register(a, warm=False)
        reqs = []

        def arrive(rate):
            for _ in range(rng.poisson(rate * DT)):
                reqs.append(f.submit(fp, rng.standard_normal(a.shape[1]),
                                     klass=classes[int(rng.integers(3))]))

        def inject_burst(n, seed0):
            entry = f._entry(fp)
            kinds = list(entry.guards)
            done = 0
            for i in range(n):
                if not kinds:
                    break
                kind = kinds[int(rng.integers(len(kinds)))]
                mat, plan, _ = entry.bind(kind)
                try:
                    P.inj.flip_fused_word(mat, plan, seed=seed0 + i)
                except ValueError:
                    P.inj.flip_pack_word(mat, plan, seed=seed0 + i)
                done += 1
            return done

        cap = SLOTS / DT
        for _ in range(60):
            arrive(0.8 * cap)
            f.step()
            clk.advance(DT)
        injected = 0
        for t in range(150):
            arrive(2.0 * cap)
            if t % 15 == 5 and injected < 50:
                injected += inject_burst(5, seed0=100 + injected)
            f.step()
            clk.advance(DT)
        for _ in range(40):
            arrive(0.3 * cap)
            f.step()
            clk.advance(DT)
        f.run_until_drained(max_ticks=2000)
        assert injected == 50
        return f, reqs


SCENARIOS = {
    "deadlines": sc_deadlines,
    "queue_full_and_vmem": sc_queue_full_and_vmem,
    "coalesced_integer": sc_coalesced_integer,
    "lru_pool": sc_lru_pool,
    "shed_order": sc_shed_order,
    "overload_demotes": sc_overload_demotes,
    "solve": sc_solve,
    "chaos_breaker": sc_chaos_breaker,
    "store_garbling": sc_store_garbling,
    "stale_token": sc_stale_token,
    "acceptance_trace": sc_acceptance_trace,
}


def _run(P, name, tmp):
    """A scenario with a fresh registry and reservoir stream: everything
    the comparison reads."""
    a = rtm.suite("tiny")["stencil1d"]
    prev = P.obs.enable(True)
    P.obs.reset()
    rng_state = P.obs._RES_RNG.getstate()
    P.obs._RES_RNG.seed(0xC0FFEE)
    entries = []
    orig = P.fe.PlanEntry.__init__

    def track(self, *args, **kw):
        orig(self, *args, **kw)
        entries.append(self)

    P.fe.PlanEntry.__init__ = track
    try:
        fn = SCENARIOS[name]
        f, reqs = fn(P, a, tmp) if name == "store_garbling" else fn(P, a)
        snap = P.obs.snapshot()
    finally:
        P.fe.PlanEntry.__init__ = orig
        P.obs._RES_RNG.setstate(rng_state)
        P.obs.reset()
        P.obs.enable(prev)
    return dict(
        requests=[(r.uid, r.op, r.klass.name, r.status, r.reason, r.tier,
                   r.tier_kind, r.missed_deadline, r.attempts, r.t_submit,
                   r.t_done) for r in reqs],
        ys=[None if r.y is None else np.asarray(r.y) for r in reqs],
        solves=[(r.solve_info.iters, r.solve_info.trips,
                 r.solve_info.final_kind) for r in reqs
                if r.solve_info is not None],
        stats=f.stats(),
        transitions=[(e.fingerprint, list(e.breaker.transitions))
                     for e in entries],
        series={k: v for k, v in snap["counters"].items()
                if k.startswith("frontend.")},
        hists={k: v for k, v in snap["histograms"].items()
               if k.startswith("frontend.")},
        gauges={k: v for k, v in snap["gauges"].items()
                if k.startswith("frontend.")},
        in_budget=[in_budget(P, r, a) for r in reqs
                   if r.status == "ok" and r.op == "spmv"
                   # other matrices than ``a``
                   and name not in ("lru_pool", "coalesced_integer")])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Each scenario's reference run, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run(REF, name, tmp_path_factory.mktemp(name))
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_reference(name, ref, tmp_path):
    r = ref(name)
    t = _run(PORT, name, tmp_path)
    assert t["requests"] == r["requests"]
    assert t["stats"] == r["stats"]
    assert t["transitions"] == r["transitions"]
    assert t["series"] == r["series"]
    assert t["hists"] == r["hists"]
    assert t["gauges"] == r["gauges"]
    assert t["solves"] == r["solves"]
    assert all(t["in_budget"]) and all(r["in_budget"])
    for yt, yr in zip(t["ys"], r["ys"]):
        assert (yt is None) == (yr is None)
        if yt is None:
            continue
        assert yt.shape == yr.shape
        if name == "coalesced_integer":
            np.testing.assert_array_equal(yt, yr)
        elif yt.dtype == np.float64:            # a solve's x
            assert np.linalg.norm(yt - yr) <= 1e-6 * np.linalg.norm(yr)
        else:
            assert np.max(np.abs(yt - yr)) <= \
                Y_RTOL * max(np.max(np.abs(yr)), 1e-30)


def test_chaos_scenarios_exercise_what_they_claim(ref):
    edges = [(s, d) for _, trans in ref("chaos_breaker")["transitions"]
             for _, s, d in trans]
    assert (rpol.CLOSED, rpol.OPEN) in edges
    assert (rpol.HALF_OPEN, rpol.CLOSED) in edges
    tr = ref("acceptance_trace")
    assert tr["stats"]["by_status"].get("shed", 0) > 0
    assert all(s in ("ok", "shed", "rejected", "deadline_miss")
               for _, _, _, s, *_ in tr["requests"])
    assert sum(v for k, v in tr["series"].items()
               if k.startswith("frontend.stale_plan")) == 0
    assert sum(v for k, v in ref("stale_token")["series"].items()
               if k.startswith("frontend.stale_plan")) == 1
    kinds = {k for *_, k, _, _, _, _ in ref("overload_demotes")["requests"]}
    assert rpol.DEFAULT_LADDER[3] in kinds


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


def test_fingerprints_and_retile_keys_equal_reference(tiny_csr, tmp_path,
                                                     monkeypatch):
    """One matrix registered in both front ends: the same fingerprint and
    the same store-retile key for each ladder tier."""
    out = {}
    for P in (PORT, REF):
        seen = []
        monkeypatch.setattr(
            P.store.PrecisionStore, "apply_retile",
            lambda self, fpr, key, plan, seen=seen, **kw:
            seen.append((fpr, key)) and False)
        with mk(P, store=str(tmp_path / "s.json")) as f:
            fp = f.register(tiny_csr, warm=False)
            entry = f._entry(fp)
            for kind in ("plan_fp16", "plan_e8m4", "plan_bf16"):
                entry.bind(kind)
        out[P is PORT] = (fp, seen)
    assert out[True] == out[False]
    assert [k for _, k in out[True][1]] == ["plan_fp1615", "plan_e8m4",
                                            "plan_bf1615"]


def test_background_worker_runs_under_the_capture_lock(tiny_csr):
    seen = []
    with fe.ServingFrontend(fe.FrontendConfig(background=True,
                                              device="cpu")) as f:
        fp = f.register(tiny_csr, warm=True)
        f._defer(lambda: seen.append(graphs.CAPTURE_LOCK._is_owned()))
        f.drain_background(timeout=120)
        assert seen == [True]
        assert not graphs.CAPTURE_LOCK._is_owned()
        entry = f._entry(fp)
        assert {k for k, _ in entry.warmed} == {"fp32", "plan_e8m4",
                                                "plan_fp16"}
        r = f.submit(fp, np.ones(tiny_csr.shape[1]), klass="interactive")
        f.run_until_drained()
        assert r.status == "ok"
    assert f._bg_thread is None


def test_a_capture_waits_for_a_background_task():
    """While the worker runs a task, another thread cannot take the lock a
    capture holds (the worker's own thread can: the lock is
    re-entrant)."""
    with fe.ServingFrontend(fe.FrontendConfig(background=True,
                                              device="cpu")) as f:
        started, release, got = (threading.Event(), threading.Event(),
                                 [])
        f._defer(lambda: (started.set(), release.wait(30)))
        assert started.wait(30)
        got.append(graphs.CAPTURE_LOCK.acquire(timeout=0.05))
        release.set()
        f.drain_background(timeout=30)
        got.append(graphs.CAPTURE_LOCK.acquire(timeout=30))
        graphs.CAPTURE_LOCK.release()
        assert got == [False, True]


def test_rebuild_raises_the_old_plans_generation(tiny_csr):
    with mk_frontend() as f:
        fp = f.register(tiny_csr, warm=False)
        entry = f._entry(fp)
        mat, plan, _ = entry.bind("plan_fp16")
        gen = plan.generation
        entry.rebuild("plan_fp16")
        mat2, plan2, _ = entry.bind("plan_fp16")
        assert plan2 is not plan and plan.generation == gen + 1
        assert entry.breaker.rebuilt
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            tiny_csr.shape[1]).astype(np.float32))
        assert torch.equal(plan2.spmv(mat2, x), plan.spmv(mat, x))


def test_fp32_tier_is_one_matvec_per_column(tiny_csr):
    with mk_frontend() as f:
        fp = f.register(tiny_csr, warm=False)
        entry = f._entry(fp)
        x = np.random.default_rng(1).standard_normal(
            (tiny_csr.shape[1], 4)).astype(np.float32)
        y = entry.spmm_fp32(torch.from_numpy(x))
        mv = entry.ops.matvec("fp32")
        for j in range(4):
            assert torch.equal(y[:, j], mv(torch.from_numpy(x[:, j].copy())))


def test_frontend_defaults_to_the_gpu(tiny_csr):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with fe.ServingFrontend(fe.FrontendConfig(background=False),
                            clock=pol.ManualClock()) as f:
        fp = f.register(tiny_csr, warm=False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            f._entry(fp)
