"""Process-local metrics registry and trace spans.

The port of ``repro.observe.metrics``: the flight recorder behind every
PackSELL dispatch. Counters, gauges and histograms keyed by ``(name,
labels)``, plus ``span()`` context managers that name hot regions in
profiles. Two invariants shape the design, as in the reference:

* **Zero cost when disabled.** ``REPRO_OBS=0`` (the tier-1 default) makes
  every recording call a single predicate check and ``span()`` a bare
  ``yield``: no dict lookup, no allocation, no lock.
* **Host entry points only.** The reference records outside its traced
  bodies, where a counter would freeze at trace time. The port's
  counterpart of a traced body is a CUDA-graph body
  (``solvers.graphs``): a counter inside one would count at the warm-up
  and the capture and never at a replay, and on the CPU (no capture) at
  every call. So a record made while a graph body runs on this thread
  (:func:`quiet`), or while the current CUDA stream captures, is
  skipped, whatever the call site: counts are those of host-entry calls,
  the same on the CPU and on the card. Graph replays are counted by
  ``solvers.graphs.LEDGER``, which ``observe.report()`` carries.
  ``span()`` is legal anywhere: ``torch.profiler.record_function`` and
  an NVTX range act on the host only, so they are legal inside a stream
  capture, and neither can change a number.

Series naming follows ``subsystem.event`` with labels for dimensions, e.g.
``spmv.dispatch{cache_mode=checkpoint,codec=fp16,kind=spmv,variant=fused}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import random
import threading

import torch

__all__ = [
    "enabled", "enable", "inc", "gauge", "observe", "record_trace",
    "series_key", "inc_many", "counter_bump", "snapshot", "raw_snapshot",
    "reset", "export_json", "span", "quiet", "recording",
]


def _env_on(val: str | None) -> bool:
    return (val or "0").strip().lower() not in ("", "0", "false", "off", "no")


_ENABLED = _env_on(os.environ.get("REPRO_OBS"))

_LOCK = threading.Lock()
# series key: (name, (("k","v"), ...)) with labels sorted by key
_COUNTERS: dict = {}
_GAUGES: dict = {}
_HISTS: dict = {}          # key -> {"count", "sum", "min", "max", "last"}
_TRACES: dict = {}         # key -> list of records (bounded)
_TRACE_CAP = 256           # per-series record cap (drop-oldest)
_RES_CAP = 256             # per-histogram quantile reservoir size
_QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))
# Algorithm-R replacement draws: a dedicated seeded stream so reservoir
# contents are reproducible per process and never perturb user RNG state
_RES_RNG = random.Random(0xC0FFEE)
# .quiet: graph bodies running on this thread (solvers.graphs)
_LOCAL = threading.local()
# the NVTX bindings (a stub on a build without CUDA)
_NVTX = torch.cuda.nvtx._nvtx


def enabled() -> bool:
    """True when the registry records (``REPRO_OBS`` truthy or enable())."""
    return _ENABLED


def enable(on: bool = True) -> bool:
    """Flip recording on/off at runtime (benchmarks/tests; the env var
    only sets the process default). Returns the previous state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


@contextlib.contextmanager
def quiet():
    """Skip every record made on this thread inside the block:
    ``solvers.graphs`` runs each graph body (warm-up, capture, a CPU run)
    inside one."""
    _LOCAL.quiet = getattr(_LOCAL, "quiet", 0) + 1
    try:
        yield
    finally:
        _LOCAL.quiet -= 1


def _host_entry() -> bool:
    """No graph body runs on this thread and the current CUDA stream is
    not capturing (nothing captures before CUDA is initialized)."""
    if getattr(_LOCAL, "quiet", 0):
        return False
    return not (torch.cuda.is_initialized()
                and torch._C._cuda_isCurrentStreamCapturing())


def recording() -> bool:
    """True when a record made now counts: the recorder is on and the
    call is a host entry (module docstring). Call sites whose record
    costs work of its own (reading a device value) test it first."""
    return _ENABLED and _host_entry()


def _key(name: str, labels: dict):
    if not labels:
        return (name, ())
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def inc(name: str, value: float = 1, **labels) -> None:
    """Add ``value`` to counter ``name{labels}`` (no-op when disabled)."""
    if not (_ENABLED and _host_entry()):
        return
    k = _key(name, labels)
    with _LOCK:
        _COUNTERS[k] = _COUNTERS.get(k, 0) + value


def series_key(name: str, **labels):
    """Precompute a series handle for :func:`inc_many`: hot dispatch paths
    pay the label sort/stringification once at plan setup instead of on
    every call."""
    return _key(name, labels)


def inc_many(pairs) -> None:
    """Bump several precomputed ``(series_key, value)`` counters, the
    steady-state dispatch record. Deliberately lock-free: each get/set is
    GIL-atomic, so the only cross-thread hazard is a lost increment when
    two threads interleave on the SAME series, acceptable for a flight
    recorder (the lock acquisition costs as much as both bumps)."""
    if not (_ENABLED and _host_entry()):
        return
    for k, v in pairs:
        _COUNTERS[k] = _COUNTERS.get(k, 0) + v


def counter_bump(pairs):
    """Compile ``(series_key, value)`` pairs into a zero-arg closure, the
    cheapest steady-state record (everything resolvable is bound at build
    time; the common two-counter case is unrolled). The closure re-checks
    the switch and the host-entry rule, so a cached bump goes quiet when
    the recorder is turned off. Same lock-free tradeoff as
    :func:`inc_many`."""
    pairs = tuple(pairs)
    C = _COUNTERS          # reset() clears in place, never rebinds
    if len(pairs) == 2:
        (k1, v1), (k2, v2) = pairs

        def bump(C=C, get=C.get):
            if _ENABLED and _host_entry():
                C[k1] = get(k1, 0) + v1
                C[k2] = get(k2, 0) + v2
        return bump

    def bump(C=C, get=C.get):
        if _ENABLED and _host_entry():
            for k, v in pairs:
                C[k] = get(k, 0) + v
    return bump


def gauge(name: str, value: float, **labels) -> None:
    """Set gauge ``name{labels}`` to the latest ``value``."""
    if not (_ENABLED and _host_entry()):
        return
    k = _key(name, labels)
    with _LOCK:
        _GAUGES[k] = value


def observe(name: str, value: float, **labels) -> None:
    """Record ``value`` into histogram ``name{labels}``: count/sum/min/
    max/last aggregates plus a bounded reservoir (Algorithm R, cap
    ``_RES_CAP``) that :func:`snapshot` turns into p50/p95/p99. Still
    strictly a no-op when the recorder is disabled."""
    if not (_ENABLED and _host_entry()):
        return
    k = _key(name, labels)
    v = float(value)
    with _LOCK:
        h = _HISTS.get(k)
        if h is None:
            _HISTS[k] = {"count": 1, "sum": v, "min": v, "max": v,
                         "last": v, "res": [v]}
        else:
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)
            h["last"] = v
            res = h["res"]
            if len(res) < _RES_CAP:
                res.append(v)
            else:
                # uniform reservoir: each of the count values seen so far
                # keeps an equal _RES_CAP/count chance of being resident
                j = _RES_RNG.randrange(h["count"])
                if j < _RES_CAP:
                    res[j] = v


def _quantiles(res: list) -> dict:
    """Nearest-rank percentiles from a reservoir sample (exact when the
    series has fewer than ``_RES_CAP`` observations)."""
    s = sorted(res)
    n = len(s)
    return {tag: s[min(int(q * n), n - 1)] for tag, q in _QUANTILES}


def record_trace(name: str, record: dict, **labels) -> None:
    """Append a structured record (e.g. one solve's convergence history)
    to trace series ``name{labels}``; oldest records drop past the cap."""
    if not (_ENABLED and _host_entry()):
        return
    k = _key(name, labels)
    with _LOCK:
        lst = _TRACES.setdefault(k, [])
        lst.append(record)
        if len(lst) > _TRACE_CAP:
            del lst[: len(lst) - _TRACE_CAP]


def _fmt_key(k) -> str:
    name, labels = k
    if not labels:
        return name
    return name + "{" + ",".join(f"{a}={b}" for a, b in labels) + "}"


def _hist_view(h: dict) -> dict:
    """Exported histogram record: aggregates + reservoir percentiles (the
    raw reservoir stays private to the registry)."""
    out = {k: v for k, v in h.items() if k != "res"}
    out.update(_quantiles(h["res"]))
    return out


def snapshot() -> dict:
    """Point-in-time copy of every series, keyed ``name{k=v,...}``."""
    with _LOCK:
        return {
            "enabled": _ENABLED,
            "counters": {_fmt_key(k): v for k, v in sorted(_COUNTERS.items())},
            "gauges": {_fmt_key(k): v for k, v in sorted(_GAUGES.items())},
            "histograms": {_fmt_key(k): _hist_view(v)
                           for k, v in sorted(_HISTS.items())},
            "traces": {_fmt_key(k): [dict(r) for r in v]
                       for k, v in sorted(_TRACES.items())},
        }


def raw_snapshot() -> dict:
    """Structured twin of :func:`snapshot` for machine consumers (the
    exporters): series keyed by the raw ``(name, ((label, value), ...))``
    tuples, so no string parsing is needed to recover labels. Traces are
    excluded: they are logs, not metrics."""
    with _LOCK:
        return {
            "counters": dict(_COUNTERS),
            "gauges": dict(_GAUGES),
            "histograms": {k: _hist_view(v) for k, v in _HISTS.items()},
        }


def reset() -> None:
    """Clear every series (the enabled flag is left as-is)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
        _TRACES.clear()


def export_json(path: str) -> dict:
    """Write :func:`snapshot` to ``path``; returns the snapshot."""
    snap = snapshot()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(snap, f, indent=1, default=float)
    return snap


@contextlib.contextmanager
def span(name: str):
    """Name a hot region: a ``torch.profiler.record_function`` interval
    while a profiler runs (what ``observe.profile`` attributes kernels
    to) and an NVTX range once CUDA is initialized. A bare yield when the
    recorder is disabled. Host-side only, so legal inside a CUDA-graph
    capture, and no number can change."""
    if not _ENABLED:
        yield
        return
    rf = (torch.profiler.record_function(name)
          if torch._C._autograd._profiler_enabled() else None)
    nvtx = torch.cuda.is_initialized()
    if rf is not None:
        rf.__enter__()
    if nvtx:
        _NVTX.rangePushA(name)
    try:
        yield
    finally:
        if nvtx:
            _NVTX.rangePop()
        if rf is not None:
            rf.__exit__(None, None, None)
