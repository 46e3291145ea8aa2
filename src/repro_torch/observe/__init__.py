"""PackSELL flight recorder: one observability surface for the stack.

The port of ``repro.observe``: the metrics and tracing layer every
dispatch, solve, guard check and cache flows through. Recording is off by
default (``REPRO_OBS=0``); flip it with the env var or :func:`enable`.

    from repro_torch import observe
    observe.enable()
    ...  # run solves, serve requests
    print(json.dumps(observe.report(), indent=1))

The exporters and the span profiler are submodules, imported on demand:
``from repro_torch.observe import export, profile``.
"""
from __future__ import annotations

from .metrics import (enable, enabled, export_json, gauge, inc, observe,
                      raw_snapshot, record_trace, recording, reset, snapshot,
                      span)

__all__ = [
    "enable", "enabled", "export_json", "gauge", "inc", "observe",
    "raw_snapshot", "record_trace", "record_solve", "reset", "snapshot",
    "span", "report",
]


def record_solve(solver: str, info, **labels) -> None:
    """Post-hoc solver convergence trace from a ``SolveInfo`` /
    ``AdaptiveSolveInfo``: the per-iteration residual and the tier
    history, recorded once the solve has returned. Reading ``relres``,
    ``history`` and ``tier_history`` copies device tensors to the host (a
    sync), so it returns at once when the recorder is off, and it skips
    inside a graph body or a stream capture (the reference's tracer skip):
    a solver calls it once, after its loop, never inside a chunk."""
    if not recording():
        return
    import numpy as np
    import torch

    def host(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) \
            else np.asarray(v)

    rec: dict = {"solver": solver}
    iters = int(host(info.iters))
    rec["iters"] = iters
    rec["relres"] = float(host(info.relres))
    hist = host(info.history).astype(np.float64)
    # history buffers are fixed-size: trim the unwritten tail (entry 0 is
    # the seed)
    rec["history"] = [float(h) for h in hist[: iters + 1]]
    tiers = getattr(info, "tier_history", None)
    if tiers is not None:
        th = host(tiers)
        rec["tier_history"] = [int(t) for t in th[: iters + 1]]
    if getattr(info, "promotions", None) is not None:
        rec["promotions"] = int(host(info.promotions))
    record_trace("solver.trace", rec, solver=solver, **labels)
    inc("solver.solves", solver=solver, **labels)
    inc("solver.iters", iters, solver=solver, **labels)


def report() -> dict:
    """One-call populated snapshot: every registry series, the live plan
    cache statistics (``kernels.plan.cache_stats()``, present even when
    recording was off) with the per-plan cache cap, and the graph replays
    ``solvers.graphs.LEDGER`` counted (a replay makes no Python call, so
    no counter sees it)."""
    snap = snapshot()
    from ..kernels import plan as _kplan
    from ..solvers import graphs as _graphs

    snap["plan_cache"] = dict(_kplan.cache_stats())
    snap["plan_cache"]["jit_cache_cap"] = _kplan.JIT_CACHE_CAP
    snap["graphs"] = {"replays": int(_graphs.LEDGER.replays),
                      "replayed_calls": {k: int(v) for k, v in
                                         _graphs.LEDGER.replayed.items()}}
    return snap
