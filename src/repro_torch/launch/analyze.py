"""Hotspot analyzer for one dry-run cell: ranks the step's aten ops by
bytes and by FLOPs, grouped by op and ``repro_torch`` call site, and on
the card by device time.

The port of the reference's ``launch/analyze.py``. The reference ranks
the instructions of a cell's compiled HLO by cost × loop trips, with the
jax op from the HLO metadata; the port ranks ``launch.op_cost``'s rows:
one per (aten op, call site), whose count is the analogue of "× trips"
(a Python loop over layers or chunks repeats a call site). Sections:
the totals and the collectives (none on one device), then the top N by
bytes and by FLOPs, each closed by a row summing the rest, so that every
section sums to the totals; with ``--device cuda`` one real step also
runs under ``torch.profiler`` and a third section ranks its kernels by
device time.

    PYTHONPATH=src python -m repro_torch.launch.analyze --arch qwen2-0.5b \\
        --shape decode_32k [--top 25] [--device meta|cpu|cuda]
    PYTHONPATH=src python -m repro_torch.launch.analyze --ops ops.jsonl

``--save-ops FILE`` writes the rows as JSONL and ``--ops FILE`` analyzes
saved rows (the reference's ``--save-hlo`` / ``--hlo``). ``--device
meta`` (the default) counts on meta; ``cpu`` and ``cuda`` count one real
step there (``--reduce`` for the reduced configs on the host).

``--multi-pod`` analyzes a cell per device on the 2 × 16 × 16
production mesh (rank 0 of ``launch.mesh.make_production_mesh``, on
meta: ``dryrun.count_on_mesh``; any shape, as the reference's), a train
cell with ``--pod-compress u16|u8`` the ``pod_wire`` step. The collectives section then lists the bytes the rank
puts on the wire by kind, as the reference lists them, and a section
ranks them by kind, axis and dtype, closed like the others so that it
sums to the total.

    PYTHONPATH=src python -m repro_torch.launch.analyze --arch qwen2-0.5b \\
        --shape train_4k --multi-pod --pod-compress u16 [--reduce]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from .. import _device, configs
from ..models import SHAPES
from . import op_cost


def _ranked(records, key: str, top: int) -> list:
    """The top ``top`` rows by ``key`` (rows where it is 0 left out), and
    one row summing the rest."""
    rows = sorted((r for r in records if r[key] > 0), key=lambda r: -r[key])
    shown, rest = rows[:top], rows[top:]
    if rest:
        shown = shown + [{"op": f"({len(rest)} more rows)", "site": "",
                          "count": sum(r["count"] for r in rest),
                          key: sum(r[key] for r in rest)}]
    return shown


def _wire_rows(tally: dict) -> list:
    """One row per (kind, axis, dtype) of a rank's tally
    (``launch.mesh``), with its bytes and exchanges."""
    return [{"op": kind, "site": f"axis {axis}, {dtype}", "count": n,
             "wire": nbytes}
            for (kind, axis, dtype), (nbytes, n) in tally.items()]


def analyze_ops(records, top: int = 20, kernels=None, wire=None) -> dict:
    """Print the sections (module docstring) for op records (``op_cost``'s
    ``records()``) and, when given, ``kernels``: ``(ms, count, name)``
    from the profiler, and ``wire``: a mesh rank's tally. Returns them:
    ``totals``, ``collectives``, ``bytes``, ``flops`` (and ``wire``) and
    ``device_ms``."""
    agg = op_cost.totals(records)
    rows = _wire_rows(wire or {})
    kinds = {}
    for r in rows:
        k = kinds.setdefault(r["op"], {"bytes": 0, "count": 0})
        k["bytes"] += r["wire"]
        k["count"] += r["count"]
    agg["collectives"] = kinds
    agg["collective_bytes"] = float(sum(r["wire"] for r in rows))
    print(f"ops={agg['ops']}  flops={agg['flops']:.3e}  "
          f"bytes={agg['bytes']:.3e}  "
          f"transcendentals={agg['transcendentals']:.3e}  "
          f"coll_wire={agg['collective_bytes']:.3e}")
    if wire is None:
        print("  collectives: none on one device")
    for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]["bytes"]):
        print(f"  {k:20s} wire={v['bytes']:.3e}  count={v['count']}")
    out = {"totals": agg}
    sections = [("memory bytes", "bytes"), ("flops", "flops")]
    if wire is not None:
        print(f"\n--- top {top} by collective wire bytes ---")
        out["wire"] = _ranked(rows, "wire", top)
        for r in out["wire"]:
            print(f"{r['wire']:11.3e}  x{r['count']:<6d} {r['op']:24s} "
                  f"{r['site']}")
    for title, key in sections:
        print(f"\n--- top {top} by {title} (x count) ---")
        out[key] = _ranked(records, key, top)
        for r in out[key]:
            print(f"{r[key]:11.3e}  x{r['count']:<6d} {r['op']:24s} "
                  f"{r['site'][-90:]}")
    out["device_ms"] = None
    if kernels is not None:
        print(f"\n--- top {top} kernels by device time (torch.profiler, "
              "one step) ---")
        for ms, n, name in kernels[:top]:
            print(f"{ms:11.3f} ms  x{n:<6d} {name[:90]}")
        out["device_ms"] = kernels
    return out


def _kernels(step, args) -> list:
    """``(ms, count, name)`` of every kernel one call of ``step`` runs,
    by ``torch.profiler``'s device time, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)


def analyze_cell(arch: str, shape_name: str, *, top: int = 20,
                 device="meta", microbatch=None, cfg=None, shape=None,
                 save_ops: str | None = None, mesh=None,
                 pod_wire=None) -> dict:
    """Count one cell's step on ``device`` (meta: the dry-run's trace;
    else one real step, and on the card the profiler's kernels) and
    print its sections; returns :func:`analyze_ops`' dict with the
    records under ``records``. ``mesh``: a ``launch.mesh.MetaMesh`` (the
    production mesh's rank 0) to count the step on, per device, a train
    step with ``pod_wire`` across its pods."""
    from . import dryrun

    cfg = cfg or configs.get(arch)
    shape = shape or SHAPES[shape_name]
    kernels = wire = None
    if mesh is not None:
        if torch.device(device or "meta").type != "meta":
            raise ValueError(f"a {mesh.name} mesh is counted on meta, not "
                             f"on {device}")
        fields, cost = dryrun.count_on_mesh(cfg, shape, mesh,
                                            pod_wire=pod_wire,
                                            microbatch=microbatch)
        wire = mesh.tally.get(mesh.index, {})
        held = ("optimizer state", fields["opt_state_bytes_per_device"]) \
            if shape.kind == "train" else ("cache",
                                           fields["cache_bytes_per_device"])
        print(f"{mesh.name} mesh, per device of {mesh.size}: arguments "
              f"{fields['memory_analysis']['argument_size_in_bytes'] / 1e9:.3f}"
              f" GB (parameters {fields['param_bytes_per_device'] / 1e9:.3f}"
              f" GB, {held[0]} {held[1] / 1e9:.3f} GB), peak "
              f"live above them {fields['meta_peak_live_bytes'] / 1e9:.2f} "
              f"GB (meta){'' if pod_wire is None else f'; pod wire {pod_wire}'}")
    elif torch.device(device or "cuda").type == "meta":
        rec, cost = dryrun.compile_cell(arch, shape_name, cfg=cfg,
                                        shape=shape, microbatch=microbatch)
        arg = rec["memory_analysis"]["argument_size_in_bytes"]
        print(f"arguments {arg / 1e9:.2f} GB, peak live above them "
              f"{rec['meta_peak_live_bytes'] / 1e9:.2f} GB (meta)")
    else:
        dev = _device.resolve_device(device)
        step, args, _ = dryrun._lower_cell(cfg, shape, microbatch,
                                           device=dev)
        _, cost = op_cost.count(step, *args)
        if dev.type == "cuda":
            if shape.kind == "decode":
                dryrun._full_context(args[2], shape.seq_len)
            kernels = _kernels(step, args)
    records = cost.records()
    if save_ops:
        with open(save_ops, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        print(f"wrote {save_ops}")
    out = analyze_ops(records, top, kernels, wire)
    out["records"] = records
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--pod-compress", default=None, choices=("u16", "u8"))
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ops", default=None, help="analyze saved op rows")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--save-ops", default=None)
    ap.add_argument("--device", default="meta")
    ap.add_argument("--reduce", action="store_true")
    args = ap.parse_args(argv)

    if args.ops:
        with open(args.ops) as f:
            analyze_ops([json.loads(line) for line in f if line.strip()],
                        args.top)
        return 0
    if args.pod_compress and not args.multi_pod:
        raise ValueError("--pod-compress compresses the gradient across the "
                         "pods: it needs --multi-pod (2x16x16)")
    mesh = None
    if args.multi_pod:
        from .mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=True)
    cfg = configs.get(args.arch)
    shape = SHAPES[args.shape]
    if args.reduce:
        from .dryrun import reduced_shape
        cfg, shape = configs.reduce(cfg), reduced_shape(shape)
        if mesh is not None:
            # one row a data-parallel shard at least
            shape = dataclasses.replace(shape, global_batch=max(
                shape.global_batch, mesh.dp_size))
    analyze_cell(args.arch, args.shape, top=args.top, device=args.device,
                 microbatch=args.microbatch, cfg=cfg, shape=shape,
                 save_ops=args.save_ops, mesh=mesh,
                 pod_wire=args.pod_compress)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
