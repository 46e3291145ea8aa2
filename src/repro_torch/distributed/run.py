"""Distributed PackSELL across processes: one rank per shard.

The port's counterpart of ``examples/distributed_pcg.py``: an HPCG
``side``³ matrix, symmetrically scaled, partitioned over ``--ranks``
shards; each shard runs in a process of its own (``parallel.launch.
spawn_ranks``). The parent builds the stacked operands once on the host
and hands each rank its row (``DistOperands.from_host``); every rank then
runs one distributed matvec, held bit for bit to the CPU replay of the
same host dict (``reference_spmv``) on integer x, and ``jacobi_pcg_dist``
on a N(0, 1) right-hand side. It prints the iterations, the recurrence
and true relative residuals and the walls, and exits non-zero on any
mismatch::

    PYTHONPATH=src python -m repro_torch.distributed.run --ranks 4 \\
        --backend gloo                     # four CPU ranks
    PYTHONPATH=src python -m repro_torch.distributed.run --ranks 4 \\
        --backend gloo --device cuda       # four ranks sharing one card
    PYTHONPATH=src python -m repro_torch.distributed.run --ranks 4 \\
        --backend nccl --side 104          # one rank per card

Under NCCL each rank takes its own card and the solve's loop runs through
CUDA graphs with the collectives captured; under gloo it runs eagerly and
every collective stages through the host when the ranks hold CUDA tensors.
On CUDA each rank also times one matvec and the exchange alone on the
device (``REPS`` calls: a CUDA graph of them under NCCL, CUDA events
over eager calls under gloo), and ``--stacked`` first builds the stacked
operands on the first card, times the one-card matvec and exchange the
same way, and hands the ranks that build's host dict.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

#: the solve's iteration limit
MAXITER = 2000
#: seconds before every rank is killed
TIMEOUT_S = 600.0
#: calls per device timing (on CUDA)
REPS = 50


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_ms(fn, reps: int, *, capture: bool) -> float:
    """Mean device ms of ``fn()`` on the current card: ``reps`` calls
    captured in one CUDA graph and replayed (``capture``), or ``reps``
    eager calls, between CUDA events (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    graph = None
    if capture:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph is not None:
        graph.replay()
    else:
        for _ in range(reps):
            fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _timings(plan, xs, capture: bool) -> dict:
    """A matvec's and the exchange's device ms on ``plan``'s card."""
    from . import halo as dh

    ops = plan.ops
    if ops.rank is None:
        exchange = lambda: dh.gather_halo(  # noqa: E731
            xs, ops.index, n_shards=plan.n_shards, h_pad=ops.h_pad,
            mode=plan.exchange)
    else:
        exchange = lambda: dh.gather_halo_rank(  # noqa: E731
            xs, ops.index, mesh=plan.mesh, h_pad=ops.h_pad,
            mode=plan.exchange)
    return {"matvec_device_ms": device_ms(lambda: plan.spmv_sharded(xs),
                                          REPS, capture=capture),
            "exchange_device_ms": device_ms(exchange, REPS, capture=capture)
            if ops.h_pad else 0.0}


def _rank_solve(mesh, host_dir: str, meta, x: np.ndarray, b: np.ndarray,
                diag: np.ndarray, tol: float, exchange: str) -> dict:
    """One rank: its operands, one matvec, the solve; rank 0 returns the
    vectors, every rank its walls."""
    from ..solvers import cg
    from . import DistOperands, DistSpMVPlan
    from .plan import read_host

    dev = mesh.device
    t0 = time.perf_counter()
    ops = DistOperands.from_host(read_host(host_dir), meta, rank=mesh.rank,
                                 device=dev)
    plan = DistSpMVPlan(ops, mesh, exchange=exchange)
    _sync(dev)
    load_s = time.perf_counter() - t0
    xt = torch.from_numpy(x).to(dev)
    y = plan.spmv(xt)
    _sync(dev)
    t0 = time.perf_counter()
    y = plan.spmv(xt)
    _sync(dev)
    matvec_ms = 1e3 * (time.perf_counter() - t0)
    bt = torch.from_numpy(b).to(dev)
    t0 = time.perf_counter()
    xs, info = cg.jacobi_pcg_dist(plan, diag, bt, tol=tol, maxiter=MAXITER,
                                  dtype=torch.float64)
    _sync(dev)
    out = {"rank": mesh.rank, "device": str(dev), "load_s": load_s,
           "matvec_ms": matvec_ms, "solve_s": time.perf_counter() - t0,
           "iters": info.iters, "relres": float(info.relres),
           "bytes": plan.memory_stats()["rank_bytes"]}
    if dev.type == "cuda":
        out.update(_timings(plan, plan.shard_vector(xt),
                            capture=mesh.backend == "nccl"))
    if mesh.rank == 0:
        out.update(y=y.cpu().numpy(), x=xs.cpu().numpy())
    return out


def main(argv=None) -> int:
    from ..core import testmats
    from ..parallel import make_shard_mesh
    from ..parallel.launch import spawn_ranks
    from ..solvers import operators as op
    from . import DistSpMVPlan, build_operands, reference_spmv
    from .plan import write_host

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="gloo")
    ap.add_argument("--device", default=None,
                    help="gloo: cpu (default) or a card the ranks share; "
                    "nccl: one card per rank (default)")
    ap.add_argument("--side", type=int, default=10,
                    help="HPCG grid side (n = side^3 rows)")
    ap.add_argument("--codec", default="fp16",
                    help="value codec: fp16 | bf16 | e8m")
    ap.add_argument("--dwidth", type=int, default=15, help="delta width D")
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--exchange", choices=("ppermute", "all_gather"),
                    default="ppermute")
    ap.add_argument("--stacked", action="store_true",
                    help="build and time the stacked operands on the first "
                    "card first (CUDA)")
    args = ap.parse_args(argv)

    s, _ = op.sym_scale(testmats.hpcg(args.side, args.side, args.side))
    n = s.shape[0]
    t0 = time.perf_counter()
    ops = build_operands(s, args.ranks, C=32, sigma=256, D=args.dwidth,
                         codec=args.codec,
                         device="cuda:0" if args.stacked else "cpu")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 9, n).astype(np.float32)
    b = rng.standard_normal(n)
    stacked = None
    if args.stacked:
        plan = DistSpMVPlan(ops, make_shard_mesh(
            args.ranks, devices=[ops.device] * args.ranks),
            exchange=args.exchange)
        stacked = _timings(plan, plan.shard_vector(torch.from_numpy(x).to(
            ops.device)), capture=True)
        print(f"stacked on one card ({torch.cuda.get_device_name(0)}): "
              f"{args.ranks} shards, one matvec "
              f"{stacked['matvec_device_ms']!r} ms, the exchange alone "
              f"{stacked['exchange_device_ms']!r} ms (device, a CUDA graph "
              f"of {REPS} calls)", flush=True)
    want = reference_spmv(ops, x, args.exchange)
    print(f"matrix: HPCG {args.side}^3 -> n={n}, nnz={s.nnz}; {args.ranks} "
          f"shards, n_pad {ops.n_pad}, h_pad {ops.h_pad}, halo entries "
          f"{int(ops.maps.counts.sum())}; host build {build_s:.1f} s",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="repro_host_") as d:
        write_host(ops.host, d)
        meta = ops.meta
        if args.stacked:
            del plan, ops
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = spawn_ranks(_rank_solve, args.ranks, backend=args.backend,
                          device=args.device, timeout=TIMEOUT_S,
                          args=(d, meta, x, b, s.diagonal(), args.tol,
                                args.exchange))
        ranks_s = time.perf_counter() - t0
    r0 = out[0]
    ok = bool(np.array_equal(r0["y"], want))
    true_rel = float(np.linalg.norm(b - s @ r0["x"]) / np.linalg.norm(b))
    print(f"ranks: {args.ranks} under {args.backend} on "
          f"{[o['device'] for o in out]}; spawned and run in {ranks_s:.1f} s")
    print(f"spmv: equal to the CPU replay (reference_spmv) bit for bit on "
          f"integer x: {ok}; one matvec's wall per rank (ms) "
          f"{[round(o['matvec_ms'], 3) for o in out]}")
    print(f"pcg: {r0['iters']} iters, recurrence relres {r0['relres']:.3e}, "
          f"true relres {true_rel:.3e}; solve wall per rank (s) "
          f"{[round(o['solve_s'], 3) for o in out]}; operand bytes per rank "
          f"{[o['bytes'] for o in out]}")
    timing = {key: [o[key] for o in out] for key in (
        "matvec_device_ms", "exchange_device_ms") if key in out[0]}
    if timing:
        card = torch.cuda.get_device_name(0)
        print(f"device ms per rank ({card}; "
              f"{'a CUDA graph of' if args.backend == 'nccl' else 'CUDA events over'} "
              f"{REPS} calls): one matvec "
              f"{timing['matvec_device_ms']!r}, the exchange alone "
              f"{timing['exchange_device_ms']!r}")
    print(json.dumps({"ranks": args.ranks, "backend": args.backend,
                      "iters": r0["iters"], "relres": r0["relres"],
                      "true_relres": true_rel, "spmv_bit_equal": ok,
                      "matvec_ms": [o["matvec_ms"] for o in out],
                      "solve_s": [o["solve_s"] for o in out], **timing,
                      "stacked": stacked}))
    good = ok and r0["relres"] < args.tol
    print("OK" if good else "FAILED")
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
