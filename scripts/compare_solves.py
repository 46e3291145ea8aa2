#!/usr/bin/env python3
"""Solve walls of repro_torch at HPCG 104^3 on one NVIDIA GPU, for
comparing two checkouts on one card.

Times, by the host clock around a solve that ends in ``synchronize()``,
Jacobi-PCG (``cg.pcg``, tol 1e-8, b = ones) over the SELL operators of
``OperatorSet``: ``fp32`` (K2 with float32 values) and ``fp64`` (K2 with a
float64 sum). Each matvec of these kinds is the K2 launch per bucket and
the assembly of the rows in original order: the masked scatter of older
checkouts, which reads the mask on the host, or the gather by the row map.

    python3 scripts/compare_solves.py [--src DIR] [--side 104] [--reps 3]
                                      [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is loaded
(default: this checkout's). ``--out`` writes the results as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--side", type=int, default=104)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_solves: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import testmats
    from repro_torch.solvers import cg, precond
    from repro_torch.solvers.operators import OperatorSet, sym_scale

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    side = args.side
    s, _ = sym_scale(testmats.hpcg(side, side, side))
    ops = OperatorSet(s, C=32, sigma=256, device=dev)
    b = torch.ones(s.shape[0], dtype=torch.float64, device=dev)
    out = {"src": args.src, "card": card, "side": side}
    for kind in ("fp32", "fp64"):
        mv = ops.matvec(kind)
        M = precond.jacobi(s.diagonal(), dtype=torch.float64, device=dev)
        mv(b)
        walls, iters = [], None
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = cg.pcg(mv, b, M=M, tol=1e-8, maxiter=5000)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            iters = info.iters
        out[kind] = {"iterations": iters, "walls_s": walls,
                     "ms_per_iteration": [1e3 * w / iters for w in walls]}
        print(f"{kind} Jacobi-PCG (tol 1e-8): iterations {iters}, walls "
              f"{walls} s (host clock, ends in synchronize); on {card}",
              flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
