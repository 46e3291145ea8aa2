"""repro_torch's BENCH trajectory store and regression gate against the
reference's, on the CPU.

The reference's gate cases (``tests/test_sentinel.py``) run through both
packages and must give the same result dicts; ``ingest`` of payloads
built here, the schema errors, the baseline's build, save and load
(across packages), ``append`` / ``read_trajectory`` and the CLI give the
reference's records. No test reads a committed ``BENCH_*.json``: the
port's benchmark files come later.
"""
import json

import pytest

from repro.observe import trajectory as rtj
from repro_torch.observe import trajectory as tj

BOTH = (rtj, tj)


def _recs(**times):
    """Synthetic gated records: klass -> dispatch_cached_s."""
    return [{"bench": "spmv", "klass": k, "codec": "", "scale": "tiny",
             "metric": "dispatch_cached_s", "value": v,
             "git_sha": "t", "backend": "cpu"}
            for k, v in times.items()]


def _runs():
    return [_recs(a=1.00, b=2.00, c=4.00),
            _recs(a=1.05, b=1.95, c=4.10),
            _recs(a=0.95, b=2.05, c=3.90)]


def _frac(v):
    return [{"bench": "roofline", "klass": "k", "codec": "fp16",
             "metric": "achieved_frac_of_peak", "value": v,
             "scale": "tiny", "git_sha": "t", "backend": "cpu"}]


def _small(recs):
    for r in recs:
        r["scale"] = "small"
    return recs


#: (name, baseline runs, current records, expected ok) from the
#: reference's gate tests
CASES = (
    ("clean", _runs(), _recs(a=1.02, b=1.98, c=4.05), True),
    ("single_class_noise", _runs(), _recs(a=1.40, b=2.00, c=4.00), True),
    ("synthetic_2x_single_class", _runs(), _recs(a=2.00, b=2.00, c=4.00),
     False),
    ("correlated_drift", _runs(), _recs(a=1.40, b=2.80, c=4.00), False),
    ("iqr_widens_threshold", [_recs(a=1.0), _recs(a=2.0), _recs(a=1.5)],
     _recs(a=2.2), True),
    ("direction_inversion", [_frac(0.30)] * 3, _frac(0.10), False),
    ("scale_mismatch_skips", _runs(), _small(_recs(a=5.0)), True),
)


@pytest.mark.parametrize("name, runs, cur, ok", CASES,
                         ids=[c[0] for c in CASES])
def test_gate_cases_equal_reference(name, runs, cur, ok):
    ref = rtj.gate(cur, rtj.build_baseline(runs))
    ours = tj.gate(cur, tj.build_baseline(runs))
    assert ours == ref
    assert ours["ok"] is ok


@pytest.mark.parametrize("kw", ({}, {"rel_tol": 0.1}, {"iqr_k": 0.5},
                                {"severe_tol": 0.3}, {"min_classes": 1}))
def test_gate_options_equal_reference(kw):
    cur = _recs(a=1.30, b=2.40, c=4.00)
    assert tj.gate(cur, tj.build_baseline(_runs()), **kw) == \
        rtj.gate(cur, rtj.build_baseline(_runs()), **kw)


def _payload():
    return {
        "meta": {"schema_version": 2, "git_sha": "abc", "backend": "gpu",
                 "generated_at": "2026-01-01"},
        "scale": "small",
        "note": "not rows",
        "peak_bandwidth": {"bw": 3.35e12},
        "cases": {"hpcg": {"codec": "fp16", "dispatch_cached_s": 0.5,
                           "fused_speedup_vs_pr1": 1.7, "status": "ok",
                           "flag": True},
                  "fem": {"codec": "e8m", "dispatch_cached_s": 0.25}},
        "rows": [{"klass": "a", "t_spmv_s": 1e-3, "bench": "sub"},
                 {"case": "b", "achieved_frac_of_peak": 0.6},
                 {"name": "c", "x": 1}, {"cell": "d", "y": 2.5},
                 {"z": 3}, "not a dict"],
    }


@pytest.mark.parametrize("path", ("BENCH_spmv.json", "roofline.json",
                                  "/x/y/BENCH_roofline.json"))
def test_ingest_payload_equal_reference(path):
    ref = rtj.ingest(path, payload=_payload())
    ours = tj.ingest(path, payload=_payload())
    assert ours == ref and len(ours) == 8


@pytest.mark.parametrize("payload", (
    {"scale": "small", "rows": [{"t": 1.0}]},
    {"meta": {"schema_version": 0}, "rows": []},
    {"meta": {"schema_version": "1"}, "rows": []},
    ["not", "a", "dict"]))
def test_ingest_schema_errors_equal_reference(payload):
    msgs = []
    for mod in BOTH:
        with pytest.raises(mod.SchemaError) as e:
            mod.ingest("BENCH_old.json", payload=payload)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_baseline_across_packages(tmp_path):
    runs = [tj.ingest("BENCH_spmv.json", payload=_payload())] * 3
    base = tj.build_baseline(runs, meta={"note": "x"})
    assert base == rtj.build_baseline(runs, meta={"note": "x"})
    assert tj.build_baseline(runs, gated_only=False) == \
        rtj.build_baseline(runs, gated_only=False)
    p = tmp_path / "base.json"
    tj.save_baseline(base, str(p))
    assert rtj.load_baseline(str(p)) == tj.load_baseline(str(p))
    rtj.save_baseline(base, str(tmp_path / "r.json"))
    assert (tmp_path / "r.json").read_text() == p.read_text()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"meta": {"schema_version": 99},
                               "entries": {}}))
    msgs = []
    for mod in BOTH:
        with pytest.raises(mod.SchemaError, match="perf-baseline") as e:
            mod.load_baseline(str(bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_append_read_and_cli_equal_reference(tmp_path):
    recs = tj.ingest("BENCH_spmv.json", payload=_payload())
    for mod, name in ((rtj, "ref"), (tj, "ours")):
        out = tmp_path / name / "trajectory.jsonl"
        assert mod.append(recs, str(out)) == len(recs)
        assert mod.append(recs[:2], str(out)) == 2
    assert tj.read_trajectory(str(tmp_path / "ours" / "trajectory.jsonl")) \
        == rtj.read_trajectory(str(tmp_path / "ref" / "trajectory.jsonl"))
    bench = tmp_path / "BENCH_spmv.json"
    bench.write_text(json.dumps(_payload()))
    for mod, name in ((rtj, "ref_cli"), (tj, "ours_cli")):
        assert mod.main([str(bench), "--out",
                         str(tmp_path / name / "t.jsonl")]) == 0
    assert (tmp_path / "ours_cli" / "t.jsonl").read_text() == \
        (tmp_path / "ref_cli" / "t.jsonl").read_text()
    assert tj.ingest_many([str(bench)] * 2) == \
        rtj.ingest_many([str(bench)] * 2)


def test_gated_metrics_and_names_equal_reference():
    assert tj.GATED_METRICS == rtj.GATED_METRICS
    assert tj.__all__ == rtj.__all__
    assert tj.TRAJECTORY_SCHEMA_VERSION == rtj.TRAJECTORY_SCHEMA_VERSION
