#!/usr/bin/env python3
"""Kernel probe of repro_torch at HPCG 104^3 on one NVIDIA GPU.

Measures, by CUDA events over CUDA-graph replays of the launches
(``chip_smoke.device_ms``):

* the per-bucket SpMV (K4) of the e8m/D8, D4, D1 and D12 ``full`` plans,
  per matvec and bucket by bucket;
* K4 against the fused-stream SpMV (K1) on one matrix (fp16/D15): K4 over
  the ``full`` plan's buckets, K1 over the fused stream of the same words;
* the fused SpMM (K3) at nb = 1, 2, 4 and 8 beside K1;
* the bucket SpMM (K5) of the e8m/D8 ``full`` plan at nb = 1, 2, 4 and 8,
  per SpMM and bucket by bucket, and the plan's stored-order ``spmm``;
* the band SpMV (K6) of the e8m/D8 ``band`` plan on uniform buckets at the
  smallest feasible half-window, and the plan's stored-order ``spmv``;

and prints each kernel's registers and spills from its ``ptxas`` lines.

    python3 scripts/probe_kernels.py [--src DIR] [--side 104] [--reps 50]
                                     [--only k4,k1,k3,k5,k6] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is loaded
(default: this checkout's), so that two checkouts can be compared on one
card in one run. It takes either form of K4, K5 and K6: the per-bucket
wrappers of older checkouts (one launch per bucket) or the all-bucket ones
(one launch per SpMV or SpMM; one bucket is timed through a one-bucket
table). ``--only`` picks the parts (``k1`` is K4 against K1 on the fp16
words; ``k3`` needs ``k1``'s stream and runs it too). ``--out`` writes the
results as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def k4_runner(kpk, mat, plan, x, buckets):
    """A callable that runs K4 over ``buckets`` of a ``full`` plan: one
    launch of the all-bucket K4, or one per bucket of the per-bucket one."""
    kck = plan.kckpts or (None,) * len(mat.packs)
    wbs = [plan.tiles[b][1] for b in buckets]
    kw = dict(codec_name=mat.codec_name, D=mat.D)
    packs = [mat.packs[b] for b in buckets]
    d0s = [mat.d0s[b] for b in buckets]
    cks = [kck[b] for b in buckets]
    if hasattr(kpk, "packsell_spmv_buckets"):
        cks = None if plan.kckpts is None else cks
        table = kpk.bucket_table(packs, d0s, cks, wbs)
        return lambda: kpk.packsell_spmv_buckets(packs, d0s, cks, table, x,
                                                 **kw)

    def run():
        for pack, d0, ck, wb in zip(packs, d0s, cks, wbs):
            kpk.packsell_spmv_bucket(pack, d0, x, wb=wb, ckpt=ck, **kw)
    return run


def k5_runner(kpk, mat, plan, X, buckets):
    """K5 over ``buckets`` of a plan: one launch of the all-bucket K5, or
    one per bucket of the per-bucket one (its kernels alone: no width sum,
    no concatenation)."""
    kck = plan.kckpts or (None,) * len(mat.packs)
    kw = dict(codec_name=mat.codec_name, D=mat.D)
    packs = [mat.packs[b] for b in buckets]
    d0s = [mat.d0s[b] for b in buckets]
    cks = [kck[b] for b in buckets]
    if hasattr(kpk, "packsell_spmm_buckets"):
        cks = None if plan.kckpts is None else cks
        table = (plan.ktable if len(buckets) == len(mat.packs) else
                 kpk.bucket_table(packs, d0s, cks,
                                  [plan.tiles[b][1] for b in buckets]))
        return lambda: kpk.packsell_spmm_buckets(packs, d0s, cks, table, X,
                                                 **kw)

    def run():
        for b, pack, d0, ck in zip(buckets, packs, d0s, cks):
            kpk.packsell_spmm_bucket(pack, d0, X, wb=plan.tiles[b][1],
                                     ckpt=ck, **kw)
    return run


def k6_runner(kpk, mat, plan, x):
    """K6 over all buckets of a ``band`` plan: one launch of the all-bucket
    K6, or one per bucket of the per-bucket one (kernels alone)."""
    kck = plan.kckpts or (None,) * len(mat.packs)
    kw = dict(codec_name=mat.codec_name, D=mat.D, hw=plan.hw)
    if hasattr(kpk, "packsell_spmv_band_buckets"):
        return lambda: kpk.packsell_spmv_band_buckets(
            mat.packs, mat.d0s, plan.wins, plan.kckpts, plan.ktable, x, **kw)

    def run():
        for b, (pack, d0) in enumerate(zip(mat.packs, mat.d0s)):
            sb, wb = plan.tiles[b]
            kpk.packsell_spmv_band_bucket(pack, d0, plan.wins[b], x, sb=sb,
                                          wb=wb, ckpt=kck[b], **kw)
    return run


PARTS = ("k4", "k1", "k3", "k5", "k6")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--side", type=int, default=104)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--only", default=",".join(PARTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    parts = set(args.only.split(","))
    if not parts <= set(PARTS):
        ap.error(f"--only takes {PARTS}, got {sorted(parts)}")
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs     # helpers only; it puts this checkout's src
    sys.path.insert(0, str(Path(args.src).resolve()))   # first; --src wins
    res = probe(cs, torch.device("cuda"), args.side, args.reps, parts)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({"probe": "done", "card": res["card"]}), flush=True)
    return 0


def probe(cs, dev, side: int, reps: int, parts=frozenset(PARTS)) -> dict:
    """The measurements of ``parts``; ``cs`` is ``chip_smoke`` (its timing
    helpers)."""
    from repro_torch.core import packsell as pk
    from repro_torch.core import testmats
    from repro_torch.kernels import _build
    from repro_torch.kernels import packsell_spmv as kpk
    from repro_torch.kernels import plan as kplan
    from repro_torch.solvers.operators import sym_scale

    card = cs.card_line()
    print(f"card: {card}; repro_torch from {kpk.__file__}", flush=True)
    res = {"card": card, "src": kpk.__file__, "ptxas": [], "k4": {},
           "k3": {}, "k5": {}}
    for src, kernel, regs, st, ld in cs.ptxas_table(_build.build_all()):
        res["ptxas"].append([src, kernel, regs, st, ld])
        print(f"  {src}.cu {kernel}: {regs} registers, spills {st}/{ld} B",
              flush=True)

    t0 = time.perf_counter()
    s, _ = sym_scale(testmats.hpcg(side, side, side))
    m = s.shape[1]
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(dev)
    print(f"HPCG {side}^3 n={s.shape[0]} nnz={s.nnz} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def k4_rows(label, mat, plan):
        out = {"shapes": [list(p.shape) for p in mat.packs], "buckets": []}
        nb_ = len(mat.packs)
        for sel in [list(range(nb_))] + [[b] for b in range(nb_)]:
            t = cs.device_ms(k4_runner(kpk, mat, plan, x, sel), reps)
            words = sum(mat.packs[b].numel() for b in sel)
            rows = sum(mat.packs[b].shape[0] * mat.packs[b].shape[2]
                       for b in sel)
            seeds = sum(mat.d0s[b].numel() for b in sel)
            tb, _ = cs.bound_ms(4 * (words + seeds + rows + m), 2 * words)
            entry = {"buckets": sel, "ms": t, "bound_ms": tb,
                     "words": words, "x_bound": t / tb}
            if len(sel) == nb_:
                out["all"] = entry
            else:
                out["buckets"].append(entry)
            print(f"  K4 {label} buckets {sel}: {t!r} ms (bound {tb!r} ms, "
                  f"{t / tb:.2f}x), words {words}", flush=True)
        return out

    for D in (8, 4, 1, 12) if "k4" in parts else ():
        t0 = time.perf_counter()
        mat = pk.from_csr(s, C=32, sigma=256, D=D, codec="e8m", device=dev)
        plan = kplan.build_plan(mat, force="full")
        print(f"e8m/D{D}: built in {time.perf_counter() - t0:.1f} s; "
              f"buckets {[tuple(p.shape) for p in mat.packs]}", flush=True)
        res["k4"][f"e8m/D{D}"] = k4_rows(f"e8m/D{D}", mat, plan)
        del mat, plan

    if "k5" in parts:
        probe_k5(cs, res, dev, s, rng, reps)
    if "k6" in parts:
        probe_k6(cs, res, dev, s, x, reps)
    if not parts & {"k1", "k3"}:
        return res
    mat = pk.from_csr(s, C=32, sigma=256, D=15, codec="fp16", device=dev)
    pf = kplan.build_plan(mat, force="fused")
    pk4 = kplan.build_plan(mat, force="full")
    res["k4"]["fp16/D15"] = k4_rows("fp16/D15", mat, pk4)
    words, ckpt = pf.fused
    G, wr, C = words.shape
    lay = pf.fused_layout
    kw = dict(codec_name="fp16", D=15, encoding=lay.encoding, scale=lay.scale)
    k1 = cs.device_ms(lambda: kpk.packsell_spmv_fused(words, ckpt, x, **kw),
                      reps)
    tb1, _ = cs.bound_ms(4 * (G * wr * C + 2 * G * C + m), 2 * G * wr * C)
    res["k1"] = {"shape": [G, wr, C], "ms": k1, "bound_ms": tb1}
    print(f"  K1 fp16/D15 stream {[G, wr, C]}: {k1!r} ms (bound {tb1!r} ms, "
          f"{k1 / tb1:.2f}x)", flush=True)
    for nb in (1, 2, 4, 8) if "k3" in parts else ():
        X = torch.from_numpy(rng.standard_normal((m, nb)).astype(
            np.float32)).to(dev)
        t = cs.device_ms(lambda: kpk.packsell_spmm_fused(words, ckpt, X, **kw),
                         reps)
        tb, _ = cs.bound_ms(4 * (G * wr * C + G * C + m * nb + G * C * nb),
                            2 * G * wr * C * nb)
        res["k3"][nb] = {"ms": t, "bound_ms": tb, "per_rhs_ms": t / nb,
                         "vs_k1": t / k1}
        print(f"  K3 nb={nb}: {t!r} ms (bound {tb!r} ms, {t / tb:.2f}x; "
              f"{t / k1:.2f}x K1)", flush=True)
    return res


def probe_k5(cs, res, dev, s, rng, reps):
    """K5 on the e8m/D8 ``full`` plan (checkpoints at wb = 32, as
    ``OperatorSet`` builds it) at nb = 1, 2, 4, 8: per SpMM, bucket by
    bucket, and the plan's stored-order ``spmm``. The bound is the
    function's: words, d0, X and Y once each."""
    from repro_torch.core import packsell as pk
    from repro_torch.kernels import packsell_spmv as kpk
    from repro_torch.kernels import plan as kplan

    mat = pk.from_csr(s, C=32, sigma=256, D=8, codec="e8m", device=dev)
    plan = kplan.build_plan(mat, force="full")
    m, nbk = mat.m, len(mat.packs)
    res["k5"]["shapes"] = [list(p.shape) for p in mat.packs]
    for nb in (8, 1, 2, 4):
        X = torch.from_numpy(rng.standard_normal((m, nb)).astype(
            np.float32)).to(dev)
        ent = {"buckets": []}
        for sel in [list(range(nbk))] + [[b] for b in range(nbk)]:
            t = cs.device_ms(k5_runner(kpk, mat, plan, X, sel), reps)
            words = sum(mat.packs[b].numel() for b in sel)
            rows = sum(mat.packs[b].shape[0] * mat.packs[b].shape[2]
                       for b in sel)
            seeds = sum(mat.d0s[b].numel() for b in sel)
            tb, _ = cs.bound_ms(4 * (words + seeds + (rows + m) * nb),
                                2 * words * nb)
            e = {"buckets": sel, "ms": t, "bound_ms": tb, "x_bound": t / tb}
            if len(sel) == nbk:
                ent["all"] = e
            else:
                ent["buckets"].append(e)
            print(f"  K5 e8m/D8 nb={nb} buckets {sel}: {t!r} ms (bound "
                  f"{tb!r} ms, {t / tb:.2f}x)", flush=True)
        tp = cs.device_ms(lambda: plan.spmm(mat, X, permuted=True), reps)
        ent["plan_spmm_ms"] = tp
        print(f"  plan.spmm(permuted=True) e8m/D8 nb={nb}: {tp!r} ms",
              flush=True)
        res["k5"][nb] = ent


def probe_k6(cs, res, dev, s, x, reps):
    """K6 on the e8m/D8 ``band`` plan of uniform buckets at the smallest
    feasible half-window, beside the plan's stored-order ``spmv``. The
    bound: words, d0, the windows, x and y once each."""
    from repro_torch.core import packsell as pk
    from repro_torch.kernels import packsell_spmv as kpk
    from repro_torch.kernels import plan as kplan

    mat = pk.from_csr(s, C=32, sigma=256, D=8, codec="e8m", device=dev,
                      bucket_strategy="uniform")
    hw = cs.smallest_hw(mat)
    plan = kplan.build_plan(mat, force="band", hw=hw)
    t = cs.device_ms(k6_runner(kpk, mat, plan, x), reps)
    words = sum(p.numel() for p in mat.packs)
    rows = sum(p.shape[0] * p.shape[2] for p in mat.packs)
    seeds = sum(d.numel() for d in mat.d0s)
    wins = sum(w.numel() for w in plan.wins)
    tb, _ = cs.bound_ms(4 * (words + seeds + wins + rows + mat.m), 2 * words)
    tp = cs.device_ms(lambda: plan.spmv(mat, x, permuted=True), reps)
    res["k6"] = {"shapes": [list(p.shape) for p in mat.packs], "hw": hw,
                 "ms": t, "bound_ms": tb, "x_bound": t / tb,
                 "plan_spmv_ms": tp}
    print(f"  K6 e8m/D8 uniform {res['k6']['shapes']} hw={hw}: {t!r} ms "
          f"(bound {tb!r} ms, {t / tb:.2f}x); plan.spmv(permuted=True) "
          f"{tp!r} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
