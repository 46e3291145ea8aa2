"""BENCH trajectory store and noise-aware performance regression gate.

A copy of the reference's ``observe/trajectory.py`` (pure Python, JSON
only; the port imports nothing of ``repro``), with its functions, its
``GATED_METRICS`` and its error messages. It turns schema-versioned
``BENCH_*.json`` payloads into an enforced contract, and waits for the
port's own benchmark files:

* :func:`ingest` flattens one schema-versioned BENCH payload into flat
  records keyed ``(bench, klass, codec, metric)`` + provenance
  (``git_sha``, ``backend``, ``scale``) from its ``meta`` header.
  Files *without* that header are rejected with :class:`SchemaError`:
  an unversioned number cannot be compared.
* :func:`append` accumulates records into the unified
  ``artifacts/trajectory.jsonl`` (append-only, one JSON record/line).
* :func:`build_baseline` reduces repeated runs to per-key median + IQR;
  :func:`gate` compares a current run against that committed baseline
  (``artifacts/perf_baseline.json``).

The gate statistics (why two thresholds): timings on a shared machine
are noisy (IQR across baseline reps is routinely 10-30% of the median),
so a single class drifting 25% is weather, not a regression. A metric
*regresses* when its ratio to the baseline median exceeds
``max(rel_tol, iqr_k x IQR/median)``; the gate FAILS when either (a) >=
``min_classes`` distinct (bench, klass) cells regress (correlated drift
across classes is a real slowdown) or (b) any single cell exceeds the
``severe_tol`` hard threshold (a 2x slowdown must never pass just
because it only hit one class). Higher-is-better metrics declare
``"higher"`` in GATED_METRICS and the ratio is inverted.

    PYTHONPATH=src python -m repro_torch.observe.trajectory BENCH_*.json
"""
from __future__ import annotations

import json
import os

__all__ = [
    "SchemaError", "ingest", "ingest_many", "append", "read_trajectory",
    "build_baseline", "gate", "GATED_METRICS",
]

#: trajectory/baseline record schema (independent of BENCH_SCHEMA_VERSION)
TRAJECTORY_SCHEMA_VERSION = 1

#: payload keys that are never metric rows
_SKIP_KEYS = {"meta", "note", "observe_report", "legacy_dryrun",
              "peak_bandwidth", "telemetry"}
#: row fields that identify rather than measure
_ID_FIELDS = {"klass", "case", "name", "codec", "bench", "status", "cell"}

#: the metrics the regression gate watches, with their direction.
#: Timings gate the hot path; everything else in the trajectory is
#: recorded but advisory.  Keyed by (bench, metric).
GATED_METRICS = {
    ("spmv", "dispatch_cached_s"): "lower",
    ("spmv", "fused_speedup_vs_pr1"): "higher",
    ("roofline", "t_spmv_s"): "lower",
    ("roofline", "achieved_frac_of_peak"): "higher",
}


class SchemaError(ValueError):
    """A BENCH payload without (or with an incompatible) ``meta`` header."""


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

def _bench_name(path: str) -> str:
    base = os.path.basename(path)
    if base.startswith("BENCH_") and base.endswith(".json"):
        return base[len("BENCH_"):-len(".json")]
    return os.path.splitext(base)[0]


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _row_records(bench, klass, codec, row: dict):
    sub = row.get("bench")
    name = f"{bench}.{sub}" if sub and sub != bench else bench
    for k, v in row.items():
        if k in _ID_FIELDS or not _is_num(v):
            continue
        yield {"bench": name, "klass": str(klass), "codec": str(codec),
               "metric": k, "value": float(v)}


def _iter_rows(bench: str, payload: dict):
    """Yield flat records from every row-shaped section of a BENCH
    payload: dict-of-dicts sections (``cases``) use the dict key as the
    class, list-of-dicts sections (``rows``, ``cells``, ``frontier``,
    ...) read ``klass``/``case``/``name`` fields."""
    for section, val in payload.items():
        if section in _SKIP_KEYS:
            continue
        if isinstance(val, dict) and val and \
                all(isinstance(v, dict) for v in val.values()):
            for klass, row in val.items():
                yield from _row_records(bench, klass,
                                        row.get("codec", ""), row)
        elif isinstance(val, list):
            for i, row in enumerate(val):
                if not isinstance(row, dict):
                    continue
                klass = row.get("klass") or row.get("case") \
                    or row.get("name") or row.get("cell") or f"row{i}"
                yield from _row_records(bench, klass,
                                        row.get("codec", ""), row)


def ingest(path: str, payload: dict | None = None) -> list[dict]:
    """Flatten one BENCH_*.json into trajectory records.  Requires the
    schema-versioned ``meta`` header; raises :class:`SchemaError`
    otherwise (with the fix spelled out)."""
    if payload is None:
        with open(path) as f:
            payload = json.load(f)
    if not isinstance(payload, dict) or "meta" not in payload:
        raise SchemaError(
            f"{path}: no 'meta' header — this is a pre-schema-version "
            "BENCH file; regenerate it with benchmarks.common."
            "save_bench_json (make bench-<name>) so runs are comparable")
    meta = payload["meta"]
    sv = meta.get("schema_version")
    if not isinstance(sv, int) or sv < 1:
        raise SchemaError(
            f"{path}: meta.schema_version={sv!r} — need a versioned "
            "header (>=1) to compare runs; regenerate the file")
    bench = _bench_name(path)
    prov = {"git_sha": meta.get("git_sha", "unknown"),
            "backend": meta.get("backend", "unknown"),
            "scale": payload.get("scale", meta.get("scale", "unknown")),
            "schema_version": sv,
            "generated_at": meta.get("generated_at", "")}
    return [{**rec, **prov} for rec in _iter_rows(bench, payload)]


def ingest_many(paths) -> list[dict]:
    out = []
    for p in paths:
        out.extend(ingest(p))
    return out


def append(records, path: str = "artifacts/trajectory.jsonl") -> int:
    """Append records to the unified trajectory JSONL; returns the count."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    n = 0
    with open(path, "a") as f:
        for rec in records:
            f.write(json.dumps(rec, default=float) + "\n")
            n += 1
    return n


def read_trajectory(path: str = "artifacts/trajectory.jsonl") -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def _key(rec: dict) -> str:
    return "|".join((rec["bench"], rec["klass"], rec["codec"],
                     rec["metric"]))


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _iqr(xs):
    s = sorted(xs)
    n = len(s)
    if n < 2:
        return 0.0
    q1 = s[max(0, int(0.25 * (n - 1)))]
    q3 = s[min(n - 1, int(round(0.75 * (n - 1))))]
    return float(q3 - q1)


def build_baseline(runs, *, gated_only: bool = True,
                   meta: dict | None = None) -> dict:
    """Reduce repeated runs (a list of record-lists, one per rep) to the
    committed baseline: per key, the median across reps plus the
    observed IQR — the dispersion term of the gate threshold."""
    vals: dict = {}
    prov: dict = {}
    for run in runs:
        for rec in run:
            if gated_only and \
                    (rec["bench"].split(".")[0], rec["metric"]) \
                    not in GATED_METRICS:
                continue
            vals.setdefault(_key(rec), []).append(rec["value"])
            prov.setdefault(_key(rec), rec)
    entries = {}
    for k, xs in sorted(vals.items()):
        r = prov[k]
        entries[k] = {
            "bench": r["bench"], "klass": r["klass"], "codec": r["codec"],
            "metric": r["metric"], "median": _median(xs), "iqr": _iqr(xs),
            "n": len(xs), "values": xs,
        }
    base_meta = {"schema_version": TRAJECTORY_SCHEMA_VERSION,
                 "reps": max((e["n"] for e in entries.values()), default=0)}
    if runs and runs[0]:
        base_meta.update({f: runs[0][0].get(f, "unknown")
                          for f in ("git_sha", "backend", "scale")})
    if meta:
        base_meta.update(meta)
    return {"meta": base_meta, "entries": entries}


# ---------------------------------------------------------------------------
# gate
# ---------------------------------------------------------------------------

def gate(current: list[dict], baseline: dict, *, rel_tol: float = 0.25,
         iqr_k: float = 3.0, severe_tol: float = 0.75,
         min_classes: int = 2) -> dict:
    """Compare a current run's records against a committed baseline.

    Returns ``{"ok": bool, "checked": [...], "regressed": [...],
    "severe": [...], "skipped": [...]}`` — every comparison is reported,
    pass or fail, so a green gate still shows its work.  See the module
    docstring for the two-threshold statistics."""
    bmeta = baseline.get("meta", {})
    entries = baseline.get("entries", {})
    checked, regressed, severe, skipped = [], [], [], []
    seen = set()
    for rec in current:
        if (rec["bench"].split(".")[0], rec["metric"]) not in GATED_METRICS:
            continue
        k = _key(rec)
        if k in seen:
            continue
        seen.add(k)
        ent = entries.get(k)
        if ent is None:
            skipped.append({"key": k, "reason": "not in baseline"})
            continue
        if bmeta.get("scale") not in (None, "unknown") and \
                rec.get("scale") not in (None, "unknown") and \
                rec["scale"] != bmeta["scale"]:
            skipped.append({"key": k, "reason":
                            f"scale mismatch ({rec['scale']} vs "
                            f"{bmeta['scale']})"})
            continue
        direction = GATED_METRICS[(rec["bench"].split(".")[0],
                                   rec["metric"])]
        base, iqr = float(ent["median"]), float(ent["iqr"])
        cur = float(rec["value"])
        if base <= 0 or cur <= 0:
            skipped.append({"key": k, "reason": "non-positive value"})
            continue
        ratio = (cur / base) if direction == "lower" else (base / cur)
        regression = ratio - 1.0               # >0 means worse
        noise = iqr_k * iqr / base
        threshold = max(rel_tol, noise)
        row = {"key": k, "bench": rec["bench"], "klass": rec["klass"],
               "codec": rec["codec"], "metric": rec["metric"],
               "direction": direction, "baseline": base, "current": cur,
               "baseline_iqr": iqr, "regression": regression,
               "threshold": threshold, "severe_tol": severe_tol,
               "regressed": bool(regression > threshold),
               "severe": bool(regression > max(severe_tol, threshold))}
        checked.append(row)
        if row["severe"]:
            severe.append(row)
        if row["regressed"]:
            regressed.append(row)
    # correlated drift: count distinct (bench, klass) cells that regressed
    cells = {(r["bench"], r["klass"]) for r in regressed}
    ok = not severe and len(cells) < min_classes
    return {"ok": ok, "checked": checked, "regressed": regressed,
            "severe": severe, "skipped": skipped,
            "regressed_classes": sorted("/".join(c) for c in cells),
            "min_classes": min_classes, "rel_tol": rel_tol,
            "iqr_k": iqr_k, "severe_tol": severe_tol,
            "baseline_meta": bmeta}


def load_baseline(path: str) -> dict:
    with open(path) as f:
        base = json.load(f)
    sv = base.get("meta", {}).get("schema_version")
    if sv != TRAJECTORY_SCHEMA_VERSION:
        raise SchemaError(
            f"{path}: baseline schema_version={sv!r}, expected "
            f"{TRAJECTORY_SCHEMA_VERSION}; refresh with `make "
            "perf-baseline`")
    return base


def save_baseline(baseline: dict, path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(baseline, f, indent=1, default=float)


def main(argv=None) -> int:
    """``python -m repro_torch.observe.trajectory BENCH_*.json``: ingest
    into the unified trajectory store."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+", help="BENCH_*.json files")
    ap.add_argument("--out", default="artifacts/trajectory.jsonl")
    args = ap.parse_args(argv)
    recs = ingest_many(args.files)
    n = append(recs, args.out)
    print(f"[trajectory] appended {n} records from {len(args.files)} "
          f"files -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
