"""Getting metrics out of the process.

The port of ``repro.observe.export``. The registry is process-local:
right for benchmarks, not for a long-running serving front end that
someone else has to watch. This module is the egress layer:

* :func:`prometheus_text`: Prometheus/OpenMetrics text exposition of the
  registry (counters, gauges, histogram summaries with reservoir
  quantiles). Metric names are sanitized (``spmv.dispatch`` →
  ``spmv_dispatch``) with the original series name kept in the ``# HELP``
  line, so :func:`parse_prometheus_text` round-trips the exact registry
  state. The text is the reference's format: either package parses the
  other's.
* :class:`JsonlSink`: an append-only JSONL archive: one ``meta`` header
  record per file (:func:`run_meta`), then one snapshot-*delta* record per
  flush. Deltas are computed against the last flushed state and re-base
  after a registry ``reset()`` (a negative counter delta means the
  registry restarted, not that traffic ran backwards).
* :func:`start_exporter`: a daemon-thread flusher with a clean ``stop()``
  (final flush + join), the piece the serving front end wires in.

Everything here reads :func:`metrics.raw_snapshot` (tuple-keyed series,
no string parsing) and never writes the registry, so an exporter thread
cannot perturb what it measures beyond the cost of a copy.

:func:`run_meta` carries the reference's keys except its two JAX ones:
``jax_version`` becomes ``torch_version`` (and ``cuda_version``, the CUDA
PyTorch was built for, or ``"none"``), and ``backend`` is ``"cuda"`` when
a CUDA device is available, else ``"cpu"``, with the device's name in
``device`` (``torch.cuda.get_device_name(0)``, or ``"cpu"``).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

from . import metrics

__all__ = [
    "run_meta", "prometheus_text", "parse_prometheus_text",
    "JsonlSink", "Exporter", "start_exporter",
]

#: order of the quantile sample lines inside a histogram summary
_QTAGS = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}
_QTAGS_INV = {v: k for k, v in _QTAGS.items()}
#: histogram aggregate fields exported as suffixed samples
_HSUFFIXES = ("count", "sum", "min", "max", "last")


# ---------------------------------------------------------------------------
# provenance header
# ---------------------------------------------------------------------------

def run_meta(**extra) -> dict:
    """Provenance header for exported telemetry: commit, toolchain,
    backend, device, machine, UTC timestamp (the key mapping against the
    reference is in the module docstring)."""
    import platform
    import subprocess
    from datetime import datetime, timezone

    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        sha = "unknown"
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    cpu = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    meta = {
        "generated_at": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "git_sha": sha,
        "platform": platform.platform(),
        "cpu": cpu or platform.processor() or platform.machine() or "unknown",
        "python": platform.python_version(),
    }
    import torch

    meta["torch_version"] = torch.__version__
    meta["cuda_version"] = torch.version.cuda or "none"
    if torch.cuda.is_available():
        meta["backend"] = "cuda"
        meta["device"] = torch.cuda.get_device_name(0)
    else:
        meta["backend"] = meta["device"] = "cpu"
    meta.update(extra)
    return meta


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _sanitize(name: str) -> str:
    s = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not re.match(r"[a-zA-Z_:]", s):
        s = "_" + s
    return s


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unesc(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            n = v[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(n, "\\" + n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _labelstr(labels, extra=()) -> str:
    items = list(labels) + list(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_esc(str(v))}"' for k, v in items) + "}"


def _num(v) -> str:
    # repr round-trips both int and float exactly through the parser
    if isinstance(v, bool):
        return repr(int(v))
    if isinstance(v, int):
        return repr(v)
    return repr(float(v))


def prometheus_text(snap: dict | None = None) -> str:
    """Render the registry (or a :func:`metrics.raw_snapshot`) in
    Prometheus text exposition format.  One ``# HELP`` line per family
    records the original dotted series name; histograms export as
    summaries (quantile samples + ``_count``/``_sum``/``_min``/``_max``/
    ``_last``)."""
    snap = snap if snap is not None else metrics.raw_snapshot()
    # family: sanitized name -> (original name, type, [(labels, value)])
    fams: dict = {}
    for kind, typ in (("counters", "counter"), ("gauges", "gauge")):
        for (name, labels), v in sorted(snap.get(kind, {}).items()):
            fams.setdefault((_sanitize(name), typ), (name, []))[1] \
                .append((labels, v))
    lines = []
    for (sname, typ), (name, series) in sorted(fams.items()):
        lines.append(f"# HELP {sname} {name}")
        lines.append(f"# TYPE {sname} {typ}")
        for labels, v in series:
            lines.append(f"{sname}{_labelstr(labels)} {_num(v)}")
    for (name, labels), h in sorted(snap.get("histograms", {}).items()):
        sname = _sanitize(name)
        lines.append(f"# HELP {sname} {name}")
        lines.append(f"# TYPE {sname} summary")
        for tag, q in _QTAGS.items():
            lines.append(f"{sname}"
                         f"{_labelstr(labels, [('quantile', q)])} "
                         f"{_num(h[tag])}")
        for suf in _HSUFFIXES:
            lines.append(f"{sname}_{suf}{_labelstr(labels)} "
                         f"{_num(h[suf])}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_num(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def parse_prometheus_text(text: str) -> dict:
    """Inverse of :func:`prometheus_text`: rebuild the tuple-keyed
    ``{"counters", "gauges", "histograms"}`` structure, restoring
    original dotted names from the ``# HELP`` lines.  Raises
    ``ValueError`` on a malformed sample line."""
    helps: dict = {}
    types: dict = {}
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    hists: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            sname, _, orig = rest.partition(" ")
            helps[sname] = orig
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            sname, _, typ = rest.partition(" ")
            types[sname] = typ
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed exposition line: {line!r}")
        sname, labelblob, val = m.groups()
        labels = tuple((k, _unesc(v))
                       for k, v in _LABEL_RE.findall(labelblob or ""))
        # histogram summaries: quantile label or an aggregate suffix
        base, field = sname, None
        if any(l[0] == "quantile" for l in labels):
            field = _QTAGS_INV[dict(labels)["quantile"]]
            labels = tuple(l for l in labels if l[0] != "quantile")
        else:
            for suf in _HSUFFIXES:
                cand = sname[: -len(suf) - 1]
                if sname.endswith("_" + suf) and types.get(cand) == "summary":
                    base, field = cand, suf
                    break
        if field is not None and types.get(base) == "summary":
            key = (helps.get(base, base), labels)
            hists.setdefault(key, {})[field] = _parse_num(val)
            continue
        kind = {"counter": "counters", "gauge": "gauges"}.get(
            types.get(sname))
        if kind is None:
            raise ValueError(f"sample {sname!r} has no # TYPE line")
        out[kind][(helps.get(sname, sname), labels)] = _parse_num(val)
    out["histograms"] = hists
    return out


# ---------------------------------------------------------------------------
# JSONL sink
# ---------------------------------------------------------------------------

def _fmt_key(k) -> str:
    name, labels = k
    if not labels:
        return name
    return name + "{" + ",".join(f"{a}={b}" for a, b in labels) + "}"


class JsonlSink:
    """Append-only telemetry archive: ``{"kind": "meta", ...}`` header on
    first flush, then one ``{"kind": "delta", ...}`` record per flush.

    Counter/histogram-count deltas are against the previous flush; a
    registry ``reset()`` between flushes makes the raw delta negative, in
    which case the current absolute value is taken (re-base) and the
    record is marked ``"rebased": true``.  All methods are serialized by
    an internal lock, so concurrent flushers (exporter thread + an
    explicit engine flush) interleave whole records, never partial
    lines."""

    def __init__(self, path: str, meta: dict | None = None):
        self.path = os.fspath(path)
        self._lock = threading.Lock()
        self._last_counters: dict = {}
        self._last_hists: dict = {}
        self._meta = meta
        self._seq = 0
        self._header_written = False

    def _write(self, rec: dict) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")

    def flush(self) -> dict | None:
        """Write one snapshot-delta record; returns it (None when there
        is nothing to report and nothing was written yet)."""
        with self._lock:
            snap = metrics.raw_snapshot()
            if not self._header_written:
                self._write({"kind": "meta",
                             **(self._meta or run_meta())})
                self._header_written = True
            rebased = False
            counters = {}
            for k, v in snap["counters"].items():
                d = v - self._last_counters.get(k, 0)
                if d < 0:                      # registry reset since last
                    d, rebased = v, True       # flush: re-base on absolute
                if d:
                    counters[_fmt_key(k)] = d
            hists = {}
            for k, h in snap["histograms"].items():
                prev = self._last_hists.get(k, {"count": 0, "sum": 0.0})
                dc = h["count"] - prev["count"]
                ds = h["sum"] - prev["sum"]
                if dc < 0:
                    dc, ds, rebased = h["count"], h["sum"], True
                if dc:
                    hists[_fmt_key(k)] = {
                        "count": dc, "sum": ds, "min": h["min"],
                        "max": h["max"], "last": h["last"],
                        "p50": h["p50"], "p95": h["p95"], "p99": h["p99"],
                    }
            self._last_counters = dict(snap["counters"])
            self._last_hists = {k: {"count": h["count"], "sum": h["sum"]}
                                for k, h in snap["histograms"].items()}
            rec = {
                "kind": "delta",
                "seq": self._seq,
                "t": time.time(),
                "counters": counters,
                "gauges": {_fmt_key(k): v
                           for k, v in snap["gauges"].items()},
                "histograms": hists,
            }
            if rebased:
                rec["rebased"] = True
            self._seq += 1
            self._write(rec)
            return rec

    @staticmethod
    def read(path: str) -> list[dict]:
        """Load every record of an archive."""
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out


# ---------------------------------------------------------------------------
# exporter thread
# ---------------------------------------------------------------------------

class Exporter:
    """Daemon-thread flusher around a :class:`JsonlSink`.  ``stop()``
    wakes the thread, takes a final flush, and joins — telemetry from
    the last partial interval is never lost on clean shutdown."""

    def __init__(self, sink: JsonlSink, interval_s: float):
        self.sink = sink
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="repro-torch-obs-exporter", daemon=True)
        self.flushes = 0

    def start(self) -> "Exporter":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush()

    def flush(self) -> None:
        self.sink.flush()
        self.flushes += 1

    def stop(self, timeout: float = 5.0) -> None:
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join(timeout)
            self.flush()                       # final partial interval

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def __enter__(self) -> "Exporter":
        if not self._thread.is_alive() and not self._stop.is_set():
            self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


def start_exporter(interval_s: float = 1.0,
                   path: str = "artifacts/obs/metrics.jsonl",
                   meta: dict | None = None) -> Exporter:
    """Start a daemon flusher writing snapshot-deltas to ``path`` every
    ``interval_s`` seconds.  Returns the :class:`Exporter`; call
    ``stop()`` for a clean final flush."""
    return Exporter(JsonlSink(path, meta=meta), interval_s).start()
