#!/usr/bin/env python3
"""Solve walls and solutions of repro_torch at HPCG 104^3 on one NVIDIA
GPU, for comparing two checkouts on one card, and a check that their
solutions agree bit for bit.

Runs, on the sym-scaled matrix with the solvers' own entry points, the
solves of the port's solver layer: Jacobi-PCG in stored-row order through
the fp16 fused plan (``cg.jacobi_pcg_stored``, tol 1e-8, b = ones),
Jacobi-PCG over the SELL operators ``fp32`` and ``fp64`` (``cg.pcg``),
``iocg.pcg_reference``, IO-CG (fp32, e8m8, fp16; m_in 50), F3R (fp16,
packsell), ``cg.adaptive_pcg`` over the budget-1e-3 ladder (with a
``jit_cache`` where the checkout takes one), the e8m/D1 triangular
solve of ``tril``, and the distributed solves of the stacked form with
four shards on the one card (``jacobi_pcg_dist`` over ``dist_fp16``,
b = ones, tol 1e-8; ``adaptive_pcg_dist`` over the budget-1e-3 ladder,
tol 1e-8, m_in 16). The checkout's kernels are built first. Each solve
runs ``--reps`` times in one process, timed by the host clock around a
call that ends in ``synchronize()``; the first run of a checkout whose
solvers run as CUDA graphs captures them, the later ones replay.

    python3 scripts/compare_solves.py [--src DIR] [--side 104] [--reps 3]
                                      [--only NAME,...] [--out DIR]
    python3 scripts/compare_solves.py --check DIR_A DIR_B

With ``jacobi_fp16`` it also times one step of that loop: the solve at
tol 0 with 64 steps against 8, by CUDA events (``step_ms``).

``--src`` is the ``src`` directory whose ``repro_torch`` is loaded
(default: this checkout's). ``--out`` writes ``result.json`` (the card,
iterations and walls) and ``<solve>.npy`` (each solve's x) into DIR.
``--check`` compares two such directories: the same iterations and every
x equal bit for bit, or it exits 1 naming the solves that differ. To
compare a parent with a change, run each tree in its own process in
turns (parent, change, change, parent) and check each change against
each parent.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOLVES = ("jacobi_fp16", "pcg_fp32", "pcg_fp64", "pcg_reference",
          "iocg_fp32", "iocg_e8m8", "iocg_fp16", "f3r_fp16", "f3r_packsell",
          "adaptive", "trisolve", "jacobi_dist4", "adaptive_dist4")


def check(a: Path, b: Path) -> int:
    ra = json.loads((a / "result.json").read_text())
    rb = json.loads((b / "result.json").read_text())
    differ = []
    for name in sorted(set(ra["solves"]) & set(rb["solves"])):
        xa, xb = np.load(a / f"{name}.npy"), np.load(b / f"{name}.npy")
        same = (ra["solves"][name]["iterations"]
                == rb["solves"][name]["iterations"]
                and xa.dtype == xb.dtype and xa.shape == xb.shape
                and xa.tobytes() == xb.tobytes())
        print(f"{name}: iterations {ra['solves'][name]['iterations']} and "
              f"{rb['solves'][name]['iterations']}, x "
              f"{'equal bit for bit' if same else 'DIFFERENT'}", flush=True)
        if not same:
            differ.append(name)
    if differ:
        print(f"differ: {differ}", flush=True)
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--side", type=int, default=104)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default=",".join(SOLVES))
    ap.add_argument("--out")
    ap.add_argument("--check", nargs=2, metavar="DIR")
    args = ap.parse_args()
    if args.check:
        return check(Path(args.check[0]), Path(args.check[1]))
    import torch
    if not torch.cuda.is_available():
        print("compare_solves: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import scipy.sparse as sp

    from repro_torch.core import testmats, trisolve
    from repro_torch.kernels import _build
    from repro_torch.solvers import cg, f3r, iocg, precond
    from repro_torch.solvers.operators import OperatorSet, sym_scale

    _build.build_all()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    side = args.side
    s, _ = sym_scale(testmats.hpcg(side, side, side))
    n = s.shape[0]
    ops = OperatorSet(s, C=32, sigma=256, device=dev)
    ones = torch.ones(n, dtype=torch.float64, device=dev)
    only = args.only.split(",")
    jac = precond.jacobi(s.diagonal(), dtype=torch.float64, device=dev)

    def solve_of(name):
        """Set-up (outside the timed runs) and the solve ``() -> (x,
        iterations)``."""
        if name.endswith("_dist4"):
            from repro_torch import distributed as dist
            from repro_torch.parallel import make_shard_mesh

            mesh = make_shard_mesh(4, devices=[dev] * 4)
            diag = s.diagonal()
            if name == "jacobi_dist4":
                d4 = dist.build_dist_plan(s, mesh=mesh, codec="fp16", D=15,
                                          C=32, sigma=256)
                return lambda: cg.jacobi_pcg_dist(d4, diag, ones, tol=1e-8,
                                                  maxiter=2000)
            ladder = ops.dist_adaptive_tiers(1e-3, mesh=mesh, n_probes=2)
            b = torch.from_numpy(np.random.default_rng(0).standard_normal(
                n)).to(dev)
            return lambda: cg.adaptive_pcg_dist(ladder, diag, b, tol=1e-8,
                                                maxiter=60, m_in=16)
        if name == "jacobi_fp16":
            mat, plan = ops.plan_pair("plan_fp16")
            diag = s.diagonal()
            return lambda: cg.jacobi_pcg_stored(mat, plan, diag, ones,
                                                tol=1e-8, maxiter=2000)
        if name.startswith("pcg_fp"):
            mv = ops.matvec(name[4:])
            return lambda: cg.pcg(mv, ones, M=jac, tol=1e-8, maxiter=5000)
        if name == "pcg_reference":
            ops.matvec("fp64")
            ops.diag()
            return lambda: iocg.pcg_reference(ops, ones)
        if name.startswith("iocg_"):
            cfg = iocg.variant(name[5:], m_in=50)
            ops.matvec(cfg.inner_spmv)
            return lambda: iocg.solve(ops, ones, cfg)
        if name.startswith("f3r_"):
            cfg = f3r.presets(name[4:])
            for kind in (cfg.spmv_outer, cfg.spmv_mid, cfg.spmv_inner):
                ops.matvec(kind)
            return lambda: f3r.solve(ops, ones, cfg)
        if name == "adaptive":
            tiers, _, _, hi = ops.adaptive_tiers(1e-3, n_probes=2)
            diag = torch.as_tensor(s.diagonal(), device=dev)
            dinv = torch.where(diag == 0, torch.ones_like(diag), 1.0 / diag)
            b = torch.from_numpy(np.random.default_rng(0).standard_normal(
                n)).to(dev)
            # a checkout whose adaptive_pcg keeps its graphs across calls
            # gets a cache, as its users would pass one
            kw = ({"jit_cache": {}, "jit_key": "ladder"} if "jit_cache" in
                  inspect.signature(cg.adaptive_pcg).parameters else {})
            return lambda: cg.adaptive_pcg(tiers, b, M=lambda r: r * dinv,
                                           matvec_hi=hi, tol=1e-8,
                                           maxiter=60, m_in=16, **kw)
        lo = sp.tril(s).tocsr()
        lo.sort_indices()
        solver = trisolve.PackSELLTriSolver(lo, lower=True, C=32, sigma=256,
                                            D=1, codec="e8m", device=dev)
        b = torch.from_numpy(np.random.default_rng(19).standard_normal(
            n)).to(dev)
        return lambda: (solver.solve(b), None)

    def step_ms(lo: int = 8, hi: int = 64, reps: int = 5) -> float:
        """ms per step of the fp16 Jacobi-PCG loop: CUDA-event walls of
        the solve at tol 0 and ``hi`` against ``lo`` steps (whole chunks
        of 8), median of ``reps`` after a first solve of each."""
        mat, plan = ops.plan_pair("plan_fp16")
        diag = s.diagonal()

        def event_ms(k: int) -> float:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            cg.jacobi_pcg_stored(mat, plan, diag, ones, tol=0.0, maxiter=k)
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop)

        walls = {}
        for k in (lo, hi):
            event_ms(k)
            walls[k] = float(np.median([event_ms(k) for _ in range(reps)]))
        return (walls[hi] - walls[lo]) / (hi - lo)

    out = {"src": args.src, "card": card, "side": side, "torch":
           torch.__version__, "solves": {}}
    xs = {}
    for name in (x for x in SOLVES if x in only):
        t0 = time.perf_counter()
        fn = solve_of(name)
        set_up = time.perf_counter() - t0
        walls, iters, x = [], None, None
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            iters = None if info is None else int(info.iters)
        xs[name] = x.cpu().numpy()
        out["solves"][name] = {"iterations": iters, "walls_s": walls,
                               "set_up_s": set_up}
        print(f"{name}: iterations {iters}, walls {walls} s (host clock, "
              f"ends in synchronize; set-up {set_up:.1f} s apart); on "
              f"{card}", flush=True)
        if name == "jacobi_fp16":
            out["step_ms"] = step_ms()
            print(f"jacobi_fp16: {out['step_ms']!r} ms per step (CUDA "
                  f"events, 64 against 8 steps at tol 0); on {card}",
                  flush=True)
    if args.out:
        d = Path(args.out)
        d.mkdir(parents=True, exist_ok=True)
        for name, x in xs.items():
            np.save(d / f"{name}.npy", x)
        (d / "result.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
