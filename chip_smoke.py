#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA GPU: builds the CUDA kernels from
the sources in this checkout, holds each against its plain PyTorch
version, drives the main path (PackSELL fp16 at HPCG 104^3, the
fused-stream plan, Jacobi-PCG in stored-row order, a multi-RHS product and
the SELL baseline), times the kernels, and ends with one JSON line.

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero without one; it imports
nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: H100 SXM: HBM3 bandwidth and float32 (non-tensor-core) peak, NVIDIA data
#: sheet, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def fail(msg: str):
    raise RuntimeError(msg)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def same_bits(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Kernel vs plain version: equal bit for bit (NaNs included); returns
    the max |difference|, which is then 0."""
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"{what}: {tuple(a.shape)}/{a.dtype} vs {tuple(b.shape)}/"
             f"{b.dtype}")
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        fail(f"{what}: kernel differs from its plain version "
             f"(max |diff| {max_abs(a, b)})")
    return max_abs(a, b)


def timed(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Smoke:
    """The phases; ``dev`` is the CUDA device, sizes are the full ones
    unless a caller shrinks them."""

    def __init__(self, dev, *, main_side=104, check_side=32,
                 suite="small", reps=50, force="auto"):
        from repro_torch.core import testmats
        from repro_torch.kernels import packsell_spmv as kpk
        from repro_torch.kernels import sell_spmv as ksl

        self.dev = dev
        self.main_side = main_side
        self.check_side = check_side
        self.suite = testmats.suite(suite)
        self.reps = reps
        self.force = force          # the main path's plan variant
        self.k1, self.k3, self.k2 = (kpk.packsell_spmv_fused,
                                     kpk.packsell_spmm_fused,
                                     ksl.sell_spmv_bucket)
        self.err = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
        self.cases = {"K1": 0, "K2": 0, "K3": 0}

    # -- phase 3: each kernel against its plain version --------------------
    def check_packsell(self, label, a, codec, D, wr=None):
        from repro_torch.core import codecs as cd
        from repro_torch.core import packsell as pk
        from repro_torch.kernels import packsell_spmv as kpk
        from repro_torch.kernels import plan as kplan

        mat = pk.from_csr(a, C=32, sigma=256, D=D, codec=codec,
                          device=self.dev)
        pf = kplan.build_plan(mat, force="fused", ckpt_wr=wr)
        if pf.variant != "fused":
            fail(f"{label}: plan is {pf.policy}")
        lay = pf.fused_layout
        words, ckpt = pf.fused
        kw = dict(codec_name=codec, D=D, encoding=lay.encoding,
                  scale=lay.scale)
        rng = np.random.default_rng(7)
        x = torch.from_numpy(rng.standard_normal(mat.m).astype(
            np.float32)).to(self.dev)
        e = same_bits(self.k1(words, ckpt, x, **kw),
                      kpk.packsell_spmv_fused_plain(words, ckpt, x, **kw),
                      f"K1 {label}")
        self.err["K1"] = max(self.err["K1"], e)
        self.cases["K1"] += 1
        for nb in (1, 3, 8):
            X = torch.from_numpy(rng.standard_normal((mat.m, nb)).astype(
                np.float32)).to(self.dev)
            e = same_bits(self.k3(words, ckpt, X, **kw),
                          kpk.packsell_spmm_fused_plain(words, ckpt, X, **kw),
                          f"K3 {label} nb={nb}")
            self.err["K3"] = max(self.err["K3"], e)
            self.cases["K3"] += 1
        # the whole plan against the plain plan, and against the quantized
        # matrix in float64 on the host (an oracle independent of the port)
        pj = kplan.build_plan(mat, force="jnp", ckpt_wr=wr)
        y = pf.spmv(mat, x)
        same_bits(y, pj.spmv(mat, x), f"plan {label}")
        aq = a.tocsr().astype(np.float64)
        aq.data = cd.quantize_np(aq.data, cd.make_codec(codec), D).astype(
            np.float64)
        want = aq @ x.cpu().numpy().astype(np.float64)
        rel = float(np.abs(y.cpu().numpy() - want).max()
                    / max(np.abs(want).max(), 1e-30))
        if not rel < 1e-5:
            fail(f"{label}: fused plan vs host float64 oracle rel {rel:.3e}")
        print(f"  {label:28s} enc={lay.encoding:7s} wr={lay.wr:3d} "
              f"G={lay.groups} bit-equal K1,K3(nb=1,3,8); "
              f"vs host f64 oracle rel {rel:.2e}", flush=True)

    def check_sell(self, label, a, value_dtype):
        from repro_torch.core import sell as sl
        from repro_torch.kernels import ops

        mat = sl.from_csr(a, C=32, sigma=256, value_dtype=value_dtype,
                          device=self.dev)
        rng = np.random.default_rng(8)
        x = torch.from_numpy(rng.standard_normal(mat.m).astype(
            np.float32)).to(self.dev)
        for val, col in zip(mat.vals, mat.cols):
            e = same_bits(self.k2(val, col, x),
                          sl.sell_bucket_spmv(val, col, x),
                          f"K2 {label} {value_dtype}")
            self.err["K2"] = max(self.err["K2"], e)
            self.cases["K2"] += 1
        same_bits(ops.sell_spmv(mat, x), sl.sell_spmv(mat, x),
                  f"sell_spmv {label} {value_dtype}")
        print(f"  {label:28s} SELL {value_dtype:8s} buckets="
              f"{len(mat.vals)} bit-equal K2", flush=True)

    def kernels_vs_plain(self):
        from repro_torch.core import testmats
        from repro_torch.kernels import plan as kplan
        from repro_torch.solvers.operators import sym_scale

        s = self.check_side
        h, _ = sym_scale(testmats.hpcg(s, s, s))
        hn = f"hpcg{s}^3"
        for codec, D in (("fp16", 15), ("bf16", 15), ("e8m", 15),
                         ("fixed12", 15), ("e8m", 12)):
            self.check_packsell(f"{hn} {codec}/D{D}", h, codec, D)
        banded = self.suite["curlcurl_like"]
        self.check_packsell("curlcurl_like e8m/D12", banded, "e8m", 12)
        for klass in ("scattered_like", "language_like"):
            for codec in ("fp16", "bf16"):
                self.check_packsell(f"{klass} {codec}/D15",
                                    self.suite[klass], codec, 15)
        for wr in kplan._CKPT_WIDTHS:
            self.check_packsell(f"{hn} fp16/D15 wr={wr}", h, "fp16", 15, wr)
        for vd in ("float16", "bfloat16", "float32"):
            self.check_sell(hn, h, vd)
        for k in ("K1", "K2", "K3"):
            print(f"  {k}: cases {self.cases[k]}, max |kernel - plain| "
                  f"{self.err[k]!r}", flush=True)

    # -- phase 4: the main path --------------------------------------------
    def main_path(self):
        from repro_torch.core import sell as sl
        from repro_torch.core import testmats
        from repro_torch.kernels import ops
        from repro_torch.kernels import plan as kplan
        from repro_torch.solvers import cg
        from repro_torch.solvers.operators import OperatorSet, sym_scale

        side = self.main_side
        t0 = time.perf_counter()
        a = testmats.hpcg(side, side, side)
        s, _ = sym_scale(a)
        t1 = time.perf_counter()
        ops_set = OperatorSet(s, C=32, sigma=256, device=self.dev,
                              force=self.force)
        mat, plan = ops_set.plan_pair("plan_fp16")
        t2 = time.perf_counter()
        sell = sl.from_csr(s, C=32, sigma=256, value_dtype="float16",
                           device=self.dev)
        t3 = time.perf_counter()
        lay = plan.fused_layout
        print(f"  HPCG {side}^3: n={s.shape[0]} nnz={s.nnz}; generate+scale "
              f"{t1 - t0:.1f} s, PackSELL+plan {t2 - t1:.1f} s, SELL "
              f"{t3 - t2:.1f} s (host)", flush=True)
        print(f"  plan: {plan.policy}", flush=True)
        print(f"  stream: enc={lay.encoding} wr={lay.wr} C={lay.C} "
              f"G={lay.groups} words={lay.stream_bytes} B "
              f"pad_words={lay.pad_words}", flush=True)
        if plan.variant != "fused":
            fail(f"main path plan variant is {plan.variant!r}, not 'fused'")
        n = s.shape[0]
        b = torch.ones(n, dtype=torch.float64, device=self.dev)
        rng = np.random.default_rng(11)
        X = rng.standard_normal((mat.m, 8)).astype(np.float32)

        diag = s.diagonal()
        for k in (self.k1, self.k2, self.k3):
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = cg.jacobi_pcg_stored(mat, plan, diag, b, tol=1e-8,
                                       maxiter=2000)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        k1_solve = self.k1.launches
        # the multi-RHS product (K3) over the solution and 7 seeded vectors,
        # and the SELL baseline (K2) on the solution
        X[:, 0] = x.float().cpu().numpy()
        Xd = torch.from_numpy(X).to(self.dev)
        Y = plan.spmm(mat, Xd)
        y_sell = ops.sell_spmv(sell, x)
        torch.cuda.synchronize()
        launches = {"K1": k1_solve, "K2": self.k2.launches,
                    "K3": self.k3.launches}

        relres = float(info.relres)
        x_h = x.cpu().numpy()
        true_rel = float(np.linalg.norm(1.0 - s @ x_h) / np.sqrt(n))
        y_h = Y.cpu().numpy()
        if not (np.isfinite(x_h).all() and np.isfinite(y_h).all()):
            fail("non-finite values on the main path")
        sp_rel = float(np.abs(y_h[:, 0] - y_sell.cpu().numpy()).max()
                       / np.abs(y_h[:, 0]).max())
        q_rel = float(np.linalg.norm(1.0 - y_h[:, 0]) / np.sqrt(n))
        print(f"  Jacobi-PCG (tol 1e-8): iterations {info.iters}, "
              f"recurrence relres {relres!r}, solve wall {solve_s!r} s "
              "(host clock, ends in synchronize)", flush=True)
        print(f"  true relres vs unquantized s (host scipy float64): "
              f"{true_rel!r}", flush=True)
        print(f"  spmm nb=8: ||1 - A_q x|| / ||1|| on column 0 {q_rel!r}; "
              f"|spmm col 0 - SELL f16 spmv| / max {sp_rel!r}", flush=True)
        print(f"  launches in this run: {launches}", flush=True)
        if not relres < 1e-8:
            fail(f"recurrence relres {relres} not < 1e-8")
        if launches["K1"] != info.iters + 1:
            fail(f"K1 launches {launches['K1']} != iterations + 1 "
                 f"({info.iters + 1})")
        if min(launches.values()) < 1:
            fail(f"a kernel of the main path never launched: {launches}")
        if not sp_rel < 1e-3:
            fail(f"PackSELL spmm and SELL spmv disagree: {sp_rel}")

        # the same solve on the plain body, on the card
        pj = kplan.get_plan(mat, force="jnp")
        before = self.k1.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xj, info_j = cg.jacobi_pcg_stored(mat, pj, diag, b, tol=1e-8,
                                          maxiter=2000)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if self.k1.launches != before:
            fail("the plain solve launched K1")
        dx = float(torch.linalg.vector_norm(x - xj)
                   / torch.linalg.vector_norm(x))
        print(f"  plain body (force='jnp') on the card: iterations "
              f"{info_j.iters}, solve wall {plain_s!r} s, "
              f"||x - x_plain|| / ||x|| {dx!r}", flush=True)
        if info_j.iters != info.iters:
            fail(f"plain solve took {info_j.iters} iterations, kernel "
                 f"{info.iters}")
        return dict(a=s, mat=mat, plan=plan, sell=sell, launches=launches,
                    iters=info.iters)

    # -- phase 5: times at the main path's shapes --------------------------
    def times(self, mp):
        from repro_torch.core import codecs as cd
        from repro_torch.core import sell as sl
        from repro_torch.kernels import packsell_spmv as kpk

        s, mat, plan, sell = mp["a"], mp["mat"], mp["plan"], mp["sell"]
        lay = plan.fused_layout
        words, ckpt = plan.fused
        kw = dict(codec_name=mat.codec_name, D=mat.D, encoding=lay.encoding,
                  scale=lay.scale)
        G, wr, C = words.shape
        m, nb = mat.m, 8
        rng = np.random.default_rng(12)
        x = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(
            self.dev)
        X = torch.from_numpy(rng.standard_normal((m, nb)).astype(
            np.float32)).to(self.dev)
        reps, preps = self.reps, max(self.reps // 10, 2)

        # each kernel against its plain version at the main path's shapes
        for k, got, want in (
                ("K1", lambda: self.k1(words, ckpt, x, **kw),
                 lambda: kpk.packsell_spmv_fused_plain(words, ckpt, x, **kw)),
                ("K3", lambda: self.k3(words, ckpt, X, **kw),
                 lambda: kpk.packsell_spmm_fused_plain(words, ckpt, X, **kw)),
                *(("K2", lambda v=v, c=c: self.k2(v, c, x),
                   lambda v=v, c=c: sl.sell_bucket_spmv(v, c, x))
                  for v, c in zip(sell.vals, sell.cols))):
            e = same_bits(got(), want(), f"{k} at HPCG {self.main_side}^3")
            self.err[k] = max(self.err[k], e)
            self.cases[k] += 1
        print(f"  K1, K3 (nb={nb}) and K2 (f16, {len(sell.vals)} buckets) "
              "bit-equal to their plain versions at these shapes", flush=True)

        def csr(values):
            with warnings.catch_warnings():     # "sparse CSR is in beta"
                warnings.simplefilter("ignore", UserWarning)
                return torch.sparse_csr_tensor(
                    torch.from_numpy(s.indptr.astype(np.int64)),
                    torch.from_numpy(s.indices.astype(np.int64)),
                    torch.from_numpy(values.astype(np.float32)),
                    size=s.shape, check_invariants=False).to(self.dev)

        a_q = csr(cd.quantize_np(s.data, mat.codec, mat.D))
        a_h = csr(s.data.astype(np.float16))
        rows = {}

        k1 = timed(lambda: self.k1(words, ckpt, x, **kw), reps)
        k1p = timed(lambda: kpk.packsell_spmv_fused_plain(words, ckpt, x,
                                                          **kw), preps)
        lib1 = timed(lambda: a_q @ x, reps)
        nbytes = 4 * G * wr * C + 4 * G * C + 4 * m + 4 * G * C
        rows["K1"] = (k1, k1p, lib1, *bound_ms(nbytes, 2 * G * wr * C))

        def k2_all():
            for v, c in zip(sell.vals, sell.cols):
                self.k2(v, c, x)

        def k2_plain():
            for v, c in zip(sell.vals, sell.cols):
                sl.sell_bucket_spmv(v, c, x)

        k2 = timed(k2_all, reps)
        k2p = timed(k2_plain, preps)
        lib2 = timed(lambda: a_h @ x, reps)
        ent = sum(v.numel() for v in sell.vals)
        nbytes = ent * (2 + 4) + 4 * m + 4 * sum(
            v.shape[0] * v.shape[2] for v in sell.vals)
        rows["K2"] = (k2, k2p, lib2, *bound_ms(nbytes, 2 * ent))

        k3 = timed(lambda: self.k3(words, ckpt, X, **kw), reps)
        k3p = timed(lambda: kpk.packsell_spmm_fused_plain(words, ckpt, X,
                                                          **kw), preps)
        lib3 = timed(lambda: a_q @ X, reps)
        nbytes = 4 * G * wr * C + 4 * G * C + 4 * m * nb + 4 * G * C * nb
        rows["K3"] = (k3, k3p, lib3, *bound_ms(nbytes, 2 * G * wr * C * nb))

        card = card_line()
        for k, (t, tp, tl, tb, by) in rows.items():
            print(f"  {k}: {t!r} ms (plain {tp!r} ms, torch.sparse CSR "
                  f"{tl!r} ms, bound {tb!r} ms by {by}) on {card}",
                  flush=True)
        return rows

    # -- phase 6: where a solve's time goes --------------------------------
    def breakdown(self, mp, iters: int = 20, reps: int = 3):
        """A solve's cost split into set-up and iterations, and the device's
        busy share of the same run. Each solve is timed by CUDA events
        recorded around the call: its wall on the device's clock, host gaps
        included. ``maxiter=0`` is the set-up (the stored-order permutes,
        the first residual's matvec, the final gather); ``iters`` more
        iterations give the cost per iteration. The profiler's device time
        by kernel is divided by the event wall of the one solve it
        traced."""
        from statistics import median

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.solvers import cg

        mat, plan, s = mp["mat"], mp["plan"], mp["a"]
        b = torch.ones(s.shape[0], dtype=torch.float64, device=self.dev)
        t0 = time.perf_counter()
        diag = torch.as_tensor(s.diagonal(), device=self.dev)
        torch.cuda.synchronize()
        diag_ms = (time.perf_counter() - t0) * 1e3

        def solve(k: int) -> float:    # tol 0: exactly k iterations
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            cg.jacobi_pcg_stored(mat, plan, diag, b, tol=0.0, maxiter=k)
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop)

        def profiled(k: int):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                wall = solve(k)
            kern = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                           for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA
                           and e.self_device_time_total > 0), reverse=True)
            return wall, kern

        solve(iters)
        set_up = median(solve(0) for _ in range(reps))
        whole = median(solve(iters) for _ in range(reps))
        per_iter = (whole - set_up) / iters
        print(f"  host: the diagonal from scipy and its copy to the card "
              f"{diag_ms!r} ms, once, outside the solves", flush=True)
        print(f"  solve walls (CUDA events, median of {reps}): set-up "
              f"(maxiter=0) {set_up!r} ms, {iters} iterations {whole!r} ms; "
              f"per iteration {per_iter!r} ms", flush=True)
        wall0, kern0 = profiled(0)
        wall, kern = profiled(iters)
        if not kern:
            print("  device time by kernel: not measured (the profiler saw "
                  "no device events)", flush=True)
            return
        busy0, busy = sum(k[0] for k in kern0), sum(k[0] for k in kern)
        print(f"  profiled set-up: device busy {busy0!r} ms of a {wall0!r} ms "
              f"event wall", flush=True)
        print(f"  profiled {iters} iterations: device busy {busy!r} ms of a "
              f"{wall!r} ms event wall (idle share {1 - busy / wall!r}); "
              f"device time per iteration {(busy - busy0) / iters!r} ms; "
              f"by kernel:", flush=True)
        for ms, count, key in kern[:12]:
            print(f"    {ms:10.4f} ms  {count:5d}x  {key[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    print("== 1. card", flush=True)
    card = card_line()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"  nvidia-smi: {card}", flush=True)
    print(f"  torch: {name}, device count {count}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)

    print("== 2. build the kernels", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"  nvcc (all sources at once): {time.perf_counter() - t0:.1f} s",
          flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}", flush=True)

    smoke = Smoke(dev)
    print("== 3. kernels against their plain versions, on the card",
          flush=True)
    smoke.kernels_vs_plain()
    print("== 4. main path: HPCG 104^3, plan_fp16, Jacobi-PCG", flush=True)
    mp = smoke.main_path()
    print("== 5. times at the main path's shapes (CUDA events)", flush=True)
    rows = smoke.times(mp)
    print("== 6. where a solve's time goes (torch.profiler)", flush=True)
    smoke.breakdown(mp)

    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "K1": ("packsell_spmv_fused", src + "packsell_fused.cu",
               "src/repro/kernels/packsell_spmv.py:567"),
        "K2": ("sell_spmv_bucket", src + "sell_spmv.cu",
               "src/repro/kernels/sell_spmv.py:47"),
        "K3": ("packsell_spmm_fused", src + "packsell_fused.cu",
               "src/repro/kernels/packsell_spmv.py:620"),
    }
    kernels = []
    for k, (kname, source, replaces) in meta.items():
        t, tp, tl, tb, by = rows[k]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": mp["launches"][k],
                        "max_abs_err": smoke.err[k], "ms": t,
                        "plain_ms": tp, "bound_ms": tb, "bound_by": by,
                        "library_ms": tl,
                        "checked_cases": smoke.cases[k]})
    print(f"== 7. done in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
