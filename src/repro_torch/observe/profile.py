"""Span-level device-time attribution.

The port of ``repro.observe.profile``. The recorder counts dispatches;
this module answers where inside a dispatch the time goes.
:func:`profile_dispatch` runs a callable under ``torch.profiler`` (CPU
and, on the card, CUDA activities), reads the exported Chrome trace, and
buckets device time under the span names of :data:`SPAN_NAMES`
(``packsell.fused_kernel``, ``packsell.gather_epilogue``, ...).

How attribution works. The reference joins XLA's per-op events against
the scope paths in the compiled HLO text (``hlo_span_map``); the port has
no HLO, so it has no counterpart of that function, and it attributes by
the host interval of each kernel's launch instead:

* ``observe.span`` opens a ``record_function`` interval on the host
  (``user_annotation`` events in the trace, with their thread);
* every kernel on the card has a runtime launch event on the host
  (``cudaLaunchKernel``; ``cudaGraphLaunch`` for a graph replay) with the
  kernel's correlation id. The port's kernels launch through ctypes, not
  as aten ops, and CUPTI records their launch events all the same;
* a kernel is credited to the innermost span, on the launch event's
  thread, whose interval contains its launch. A graph replay's kernels
  therefore go to the span around the replay (``packsell.solver_while``),
  not to the spans that ran inside the capture. Kernels launched outside
  every span go to a top-k ``unattributed`` list by device time, as in
  the reference: a kernel there is a hot region nobody wrapped yet.

On the CPU the device is the host: the top-level aten ops (those inside
no other op on their thread) stand for the device events and are
credited the same way, by their own interval.

Span intervals whose name is a span name are also credited as host time
for that span, and the measured calls are bracketed by a marker
interval, so ``traced_wall_s`` is the per-call wall under the trace.

**No fallback on the card.** The reference falls back to a wall clock
when its profiler fails. On the CPU the port keeps that fallback and its
``profiler_unavailable`` marker; on the card it raises, since a wall
clock would hide the device. A trace on the card that holds no kernel
event is taken again, up to :data:`TRACE_ATTEMPTS` traces, before it
raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time

import torch

from .. import _device
from . import metrics as _obs

__all__ = ["SPAN_NAMES", "SpanProfile", "profile_dispatch"]

#: the fixed span vocabulary: attribution targets
SPAN_NAMES = (
    "packsell.plan_build",
    "packsell.fused_decode",
    "packsell.fused_kernel",
    "packsell.bucket_decode",
    "packsell.gather_epilogue",
    "packsell.halo_prestage",
    "packsell.guard_checksum",
    "packsell.solver_while",
)

#: marker interval bracketing each measured call
_MARKER = "packsell.profile_dispatch"

#: traces of the same calls taken on the card before a trace without any
#: kernel event fails: CUPTI has delivered no kernel activity for one
#: trace on the H100 in a process whose other traces held theirs
TRACE_ATTEMPTS = 3

#: host events that launch device work; the kernels they launch carry the
#: same correlation id
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
             "cudaLaunchCooperativeKernel")


@dataclasses.dataclass
class SpanProfile:
    """Per-span time attribution for one dispatched callable (the
    reference's fields).

    ``spans`` maps span name -> ``{"device_s", "host_s", "ops",
    "events"}`` (seconds are per-call averages across ``repeats``; ``ops``
    counts the distinct kernels or ops credited). ``coverage_of_wall`` =
    attributed span device time / clean wall; ``host_overhead_s`` is the
    wall the device events do not explain and ``accounted_frac_of_wall``
    = (device + host overhead) / wall."""

    mode: str                       # "trace" | "wallclock"
    backend: str                    # "cuda" | "cpu"
    repeats: int
    wall_s: float                   # per-call dispatch wall, no profiler
    traced_wall_s: float = 0.0      # per-call wall under the trace
    device_total_s: float = 0.0     # per-call, all device events
    host_overhead_s: float = 0.0    # wall - device time
    spans: dict = dataclasses.field(default_factory=dict)
    unattributed: list = dataclasses.field(default_factory=list)
    attributed_frac: float = 0.0    # of device_total_s
    coverage_of_wall: float = 0.0   # span device time / wall
    accounted_frac_of_wall: float = 0.0
    profiler_unavailable: bool = False
    note: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wallclock(fn, args, repeats: int, dev, note: str) -> SpanProfile:
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(*args)
    _sync(dev)
    wall = (time.perf_counter() - t0) / max(repeats, 1)
    return SpanProfile(mode="wallclock", backend=dev.type, repeats=repeats,
                       wall_s=wall, profiler_unavailable=True, note=note)


def _trace_events(fn, args, repeats: int, dev) -> tuple[list, float]:
    """Run the calls under ``torch.profiler``; ``(complete events of the
    exported Chrome trace, host seconds of the traced loop)``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    td = tempfile.mkdtemp(prefix="repro_torch_profile_")
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(repeats):
                with torch.profiler.record_function(_MARKER):
                    fn(*args)
                    _sync(dev)
            t_wall = time.perf_counter() - t0
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            payload = json.load(f)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    events = [e for e in payload.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    return events, t_wall


def _innermost(intervals, tid, t: float):
    """The innermost ``(start, end, name)`` of ``intervals[tid]``
    containing ``t`` (the shortest that does), or None."""
    best = None
    for s, e, name in intervals.get(tid, ()):
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return None if best is None else best[2]


def _top_level(ops: list) -> list:
    """The ops of one thread that lie inside no other op."""
    out, end = [], float("-inf")
    for e in sorted(ops, key=lambda e: (float(e["ts"]), -float(e["dur"]))):
        ts = float(e["ts"])
        if ts >= end:
            out.append(e)
            end = ts + float(e["dur"])
    return out


def _device_events(events: list, backend: str) -> list:
    """``(kernel or op name, µs, tid, host time to attribute at)`` for the
    device work: kernels at their launch event (card), top-level aten ops
    at their start (CPU)."""
    if backend == "cuda":
        launch = {}
        for e in events:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None and e["name"] in _LAUNCHES \
                    and e.get("cat") in ("cuda_runtime", "cuda_driver"):
                launch[corr] = e
        out = []
        for e in events:
            if e.get("cat") != "kernel":
                continue
            corr = (e.get("args") or {}).get("correlation")
            src = launch.get(corr)
            out.append((e["name"], float(e["dur"]),
                        None if src is None else src.get("tid"),
                        None if src is None else float(src["ts"])))
        return out
    by_tid: dict = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            by_tid.setdefault(e.get("tid"), []).append(e)
    return [(e["name"], float(e["dur"]), tid, float(e["ts"]))
            for tid, ops in by_tid.items() for e in _top_level(ops)]


def profile_dispatch(fn, *args, spans=SPAN_NAMES, repeats: int = 10,
                     warmup: int = 2, top_k: int = 8,
                     device=None) -> SpanProfile:
    """Profile ``repeats`` calls of ``fn(*args)`` on ``device`` (``None``:
    the GPU) and attribute device time to named spans (module
    docstring). The recorder is on for every call, so the spans fire."""
    dev = _device.resolve_device(device)
    backend = dev.type
    prev = _obs.enable(True)
    try:
        for _ in range(max(warmup, 1)):
            fn(*args)
        _sync(dev)
        t0 = time.perf_counter()                # clean wall: no profiler
        for _ in range(repeats):
            fn(*args)
        _sync(dev)
        wall_clean = (time.perf_counter() - t0) / max(repeats, 1)
        try:
            for _ in range(TRACE_ATTEMPTS if backend == "cuda" else 1):
                events, t_wall = _trace_events(fn, args, repeats, dev)
                dev_events = _device_events(events, backend)
                if dev_events:
                    break
        except Exception as e:
            if backend == "cuda":
                raise RuntimeError(f"profile_dispatch: the profiler failed "
                                   f"on the card: {e!r}") from e
            return _wallclock(fn, args, repeats, dev, f"trace failed: {e!r}")
    finally:
        _obs.enable(prev)
    if not dev_events:
        if backend == "cuda":
            raise RuntimeError("profile_dispatch: the trace holds no kernel "
                               "event on the card")
        return _wallclock(fn, args, repeats, dev,
                          "no device events in the trace")

    spanset = set(spans)
    acc = {s: {"device_s": 0.0, "host_s": 0.0, "ops": 0, "events": 0}
           for s in spans}
    intervals: dict = {}
    marker_us = 0.0
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        if e["name"] == _MARKER:
            marker_us += float(e["dur"])
        elif e["name"] in spanset:
            s = float(e["ts"])
            intervals.setdefault(e.get("tid"), []).append(
                (s, s + float(e["dur"]), e["name"]))
            acc[e["name"]]["host_s"] += float(e["dur"]) * 1e-6
            acc[e["name"]]["events"] += 1
    device_us = 0.0
    unattr: dict = {}
    kinds: dict = {s: set() for s in spans}
    for name, dur, tid, t in dev_events:
        device_us += dur
        span = None if t is None else _innermost(intervals, tid, t)
        if span is None:
            unattr[name] = unattr.get(name, 0.0) + dur
            continue
        acc[span]["device_s"] += dur * 1e-6
        acc[span]["events"] += 1
        kinds[span].add(name)
    reps = max(repeats, 1)
    for s, v in acc.items():
        v["ops"] = len(kinds[s])
        v["device_s"] /= reps
        v["host_s"] /= reps
    traced = (marker_us * 1e-6 / reps) if marker_us else t_wall / reps
    dev_total = device_us * 1e-6 / reps
    span_dev = sum(v["device_s"] for v in acc.values())
    top = sorted(unattr.items(), key=lambda kv: -kv[1])[:top_k]
    note = ""
    host_over = wall_clean - dev_total
    if host_over < 0:
        host_over = 0.0
        note = ("summed device events exceed the untraced wall "
                "(instrumentation inflation); host overhead clamped to 0")
    accounted = min((dev_total + host_over) / wall_clean, 1.0) \
        if wall_clean else 0.0
    return SpanProfile(
        mode="trace", backend=backend, repeats=repeats, wall_s=wall_clean,
        traced_wall_s=traced, device_total_s=dev_total,
        host_overhead_s=host_over,
        spans={k: v for k, v in acc.items() if v["events"] or v["ops"]},
        unattributed=[{"op": k, "device_s": v * 1e-6 / reps}
                      for k, v in top],
        attributed_frac=(span_dev / dev_total) if dev_total else 0.0,
        coverage_of_wall=(span_dev / wall_clean) if wall_clean else 0.0,
        accounted_frac_of_wall=accounted, note=note)
