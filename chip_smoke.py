#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA GPU: builds the CUDA kernels from
the sources in this checkout, holds each against its plain PyTorch
version, drives the main paths at HPCG 104^3 -- PackSELL fp16 through
the fused-stream plan with Jacobi-PCG in stored-row order, a multi-RHS
product and the SELL baseline; then the mixed-precision adaptive PCG over
the e8m tier ladder (the bucket kernels, a float64 SELL outer operator),
a multi-RHS product and a band-windowed plan; then the paper's solvers
(IO-CG against fp64 PCG, F3R, the PackSELL triangular solve); then the
composite (three row classes through K1, K4 and K2, the mixed: kind and
the precision store) and the guards (guarded SpMV, every fault injector,
the self-healing guarded_solve); then the flight recorder (bit-neutral,
sync-free, its host cost, span attribution, the exporters) and the
serving front end (coalesced slots through K3 and K5, the fp32 tier
through K2, solve requests, overload and a fault that opens and heals a
breaker) -- times the kernels, and ends with one JSON line. Every solve runs as the port runs
it, through CUDA-graph replays (``repro_torch.solvers.graphs``), and in
turns with its eager loop (eager, captured, captured, eager), which it
must equal bit for bit.

    python3 chip_smoke.py [--seed N]

It needs one CUDA device and exits non-zero without one; it imports
nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import collections
import contextlib
import json
import re
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
#: the kernel a plan variant's SpMV launches
PLAN_KERNEL = {"fused": "K1", "full": "K4", "band": "K6"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def fail(msg: str):
    raise RuntimeError(msg)


def wall(fn):
    """``(fn(), seconds)``: the host clock around the call, ending in
    ``synchronize()``, Python's garbage collector on (its pauses are the
    user's too)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


#: the four turns of every solve, in order: the eager loop, the graphs'
#: first solve (warm-up and capture), later ones (replays only), eager
TURNS = ("eager", "capture", "replay", "eager again")


def turn_walls(out: dict) -> str:
    walls = [f"{t} {out[t][2]!r} s" for t in TURNS if t in out]
    if len(out.get("replays", ())) > 1:
        walls[2] += f" (median of {out['replays']!r})"
    return ", ".join(walls)


def chunk_steps(iters: int, chunk: int) -> int:
    """Steps a solve in chunks runs: whole chunks, and the steps of the
    chunk it stopped in again, up to the stop."""
    return -(-iters // chunk) * chunk + iters % chunk


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def same_bits(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Equal bit for bit (NaNs included), as a kernel and its plain
    version or a captured solve and its eager loop are; returns the max
    |difference|, which is then 0."""
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"{what}: {tuple(a.shape)}/{a.dtype} vs {tuple(b.shape)}/"
             f"{b.dtype}")
    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    if not torch.equal(a.view(bits), b.view(bits)):
        fail(f"{what}: not equal bit for bit (max |diff| "
             f"{max_abs(a, b)})")
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


def device_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device time of one call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed back to back and timed by CUDA events. The
    Python wrapper's host work is not in the graph, so this is the
    kernels' own time (with the device's gap between graph nodes, about a
    microsecond). The profiler is not used: in a long run it dropped
    kernel records and misreported durations of some windows."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the capturing stream
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
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * reps)


def sparse_csr(a, values, dev, dtype=np.float32) -> torch.Tensor:
    """``torch.sparse`` CSR (cuSPARSE on the card) of ``a``'s pattern with
    ``values``: the library yardstick, used nowhere in the port."""
    with warnings.catch_warnings():     # "sparse CSR is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr.astype(np.int64)),
            torch.from_numpy(a.indices.astype(np.int64)),
            torch.from_numpy(values.astype(dtype)),
            size=a.shape, check_invariants=False).to(dev)


def smallest_hw(mat, sb: int = 8) -> int:
    """The smallest multiple of 128 for which the band plan is feasible."""
    from repro_torch.kernels import plan as kplan

    for hw in range(128, 1 << 24, 128):
        if kplan.band_plan(mat, sb, hw) is not None:
            return hw
    fail("no half-window makes the band plan feasible")


def l2_share(m: int, nb: int) -> str:
    """The fp32 ``[m, nb]`` x block's size against the card's L2."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return f"{4 * m * nb} B = {4 * m * nb / l2!r} x L2 ({l2} B)"


def print_rows(rows: dict, per: str) -> None:
    card = card_line()
    for k, (t, tp, tl, tb, by, te) in rows.items():
        print(f"  {k}: {t!r} ms{per} on the device (a CUDA graph of the "
              f"calls; eager loop {te!r} ms), plain {tp!r} ms, torch.sparse "
              f"CSR {tl!r} ms, bound {tb!r} ms by {by}; on {card}",
              flush=True)


def _short_kernel_name(mangled: str) -> str:
    """``spmv_fused_kernel<0, 0>`` from a mangled entry name, through the
    toolkit's demangler where there is one."""
    for tool in ("cu++filt", "/usr/local/cuda/bin/cu++filt", "c++filt"):
        try:
            out = subprocess.run([tool, mangled], capture_output=True,
                                 text=True, timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            continue
        if out and out != mangled:
            name = re.sub(r"\((?:anonymous namespace|int|bool)\)|<unnamed>",
                          "", out).replace("::", "")
            name = name.split("(", 1)[0]
            return name[5:] if name.startswith("void ") else name
    return mangled


def ptxas_table(logs: dict) -> list:
    """``(source, kernel, registers, spill stores, spill loads)`` for every
    kernel in the ``-Xptxas -v`` logs of :func:`_build.build_all`."""
    rows = []
    for src, log in logs.items():
        cur, spills = None, (0, 0)
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                cur = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                rows.append((src, _short_kernel_name(cur), int(m.group(1)),
                             *spills))
                cur, spills = None, (0, 0)
    return rows


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def profiled(fn):
    """``(wall, kernels)`` of one call of ``fn`` under ``torch.profiler``:
    its wall in ms between CUDA events recorded around it (host gaps
    included), and the device time by kernel, ``(ms, count, name)``,
    largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
    kern = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    return start.elapsed_time(stop), kern


def aten_ops(fn) -> list:
    """The names of the aten ops one call of ``fn`` dispatches that compute
    on the device: ops that return a tensor on the card, allocations and
    views left out (host-side ops such as ``promote_types`` return none).
    With the kernel wrappers' launches, they are the device operations the
    call issues (counted on the host, whatever the profiler records)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    skip = ("empty", "empty_strided", "empty_like", "view", "reshape",
            "_reshape_alias", "_unsafe_view", "as_strided", "slice", "select",
            "expand", "alias", "detach", "t", "transpose", "unsqueeze",
            "squeeze", "permute", "lift_fresh")
    names = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name not in skip and any(
                    torch.is_tensor(t) and t.is_cuda
                    for t in tree_leaves(out)):
                names.append(name)
            return out

    with Record():
        fn()
    return names


@contextlib.contextmanager
def sync_debug(mode: str):
    """``torch.cuda.set_sync_debug_mode(mode)`` inside the block: "error"
    raises on any device synchronisation, "warn" warns on each."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def plain_twin(ops, kinds):
    """An ``OperatorSet`` over ``ops``' matrices whose ``kinds`` run the
    plain bodies, as ``force="jnp"`` builds them (the plain SELL body; the
    matrix's ``force="jnp"`` plan, built now), without encoding the
    matrices again."""
    import functools

    from repro_torch.core import sell as sl
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import plan as kplan
    from repro_torch.solvers.operators import OperatorSet, parse_kind

    twin = OperatorSet(ops.csr, C=ops.C, sigma=ops.sigma, device=ops.device,
                       force="jnp")
    twin._cache[("diag",)] = ops.diag()
    for kind in kinds:
        mat, family = ops.stored(kind), parse_kind(kind).family
        if family == "dense":
            comp = torch.float64 if kind == "fp64" else torch.float32
            fn = functools.partial(sl.sell_spmv, mat, compute_dtype=comp)
        elif family == "plan":
            fn = functools.partial(kplan.get_plan(mat, force="jnp").spmv, mat)
        else:
            kops.percall_plan(mat, "jnp")
            fn = functools.partial(kops.packsell_spmv_percall, mat,
                                   force="jnp")
        twin._cache[kind] = (fn, mat)
    return twin


class CountedOps:
    """An ``OperatorSet`` whose matvecs count their calls by kind: what
    ``iocg.solve`` and ``f3r.solve`` read of it (``matvec``, ``diag``,
    ``device``, ``csr``), passed through, with a graph cache of its own
    (the graphs hold its counting matvecs). :meth:`ran` adds the calls
    that graph replays ran since :meth:`reset` (``graphs.LEDGER``, which
    watches :attr:`calls` while :meth:`watch` is open)."""

    def __init__(self, ops):
        from repro_torch.solvers import graphs

        self.ops = ops
        self.csr = ops.csr
        self.calls = collections.Counter()
        self.graphs = {}
        self.kinds = set()
        self.ledger = graphs.LEDGER
        self.net0 = collections.Counter()

    def watch(self):
        return self.ledger.watch(lambda: self.calls)

    def reset(self) -> None:
        self.calls.clear()
        self.net0 = collections.Counter(self.ledger.net)

    def ran(self) -> dict:
        out = {k: self.calls[k] + self.ledger.net[k] - self.net0[k]
               for k in self.kinds}
        return {k: v for k, v in out.items() if v}

    @property
    def device(self):
        return self.ops.device

    def diag(self):
        return self.ops.diag()

    def matvec(self, kind: str):
        fn = self.ops.matvec(kind)
        self.kinds.add(kind)
        calls = self.calls      # not self: the graphs hold this closure

        def counted(x):
            calls[kind] += 1
            return fn(x)

        return counted


def f3r_layer_spmvs(cfg, cycles: int) -> dict:
    """SpMVs per F3R layer for ``cycles`` L1 cycles: L1 one for the
    initial residual and 1 + m_outer per cycle; each L2 application (one
    per L1 Arnoldi step) 1 + m_mid; each L3 application 1 + m_inner; each
    L4 application (ainv_terms - 1) + iters · ainv_terms."""
    l2 = cycles * cfg.m_outer
    l3 = l2 * cfg.m_mid
    l4 = l3 * cfg.m_inner
    return {"L1": 1 + cycles * (1 + cfg.m_outer), "L2": l2 * (1 + cfg.m_mid),
            "L3": l3 * (1 + cfg.m_inner),
            "L4": l4 * (cfg.ainv_terms - 1
                        + cfg.richardson_iters * cfg.ainv_terms)}


class Smoke:
    """The phases; ``dev`` is the CUDA device, sizes are the full ones
    unless a caller shrinks them."""

    def __init__(self, dev, *, main_side=104, check_side=32,
                 suite="small", reps=50, force="auto", force_mixed="auto",
                 force_band="auto"):
        from repro_torch.core import testmats
        from repro_torch.kernels import packsell_spmv as kpk
        from repro_torch.kernels import sell_spmv as ksl

        self.dev = dev
        self.main_side = main_side
        self.check_side = check_side
        self.suite = testmats.suite(suite)
        self.reps = reps
        self.force = force          # the main path's plan variant
        self.force_mixed = force_mixed      # the mixed path's tier plans
        self.force_band = force_band        # its uniform-bucket plan
        self.k1, self.k3, self.k2 = (kpk.packsell_spmv_fused,
                                     kpk.packsell_spmm_fused,
                                     ksl.sell_spmv_bucket)
        self.k4, self.k5, self.k6 = (kpk.packsell_spmv_buckets,
                                     kpk.packsell_spmm_buckets,
                                     kpk.packsell_spmv_band_buckets)
        ids = ("K1", "K2", "K3", "K4", "K5", "K6", "K2-f64")
        self.err = dict.fromkeys(ids, 0.0)
        self.cases = dict.fromkeys(ids, 0)

    def raw_counts(self) -> dict:
        """Every wrapper's launch count (K2-f64: K2's float64 launches):
        its Python calls, eager and in captures."""
        return {"K1": self.k1.launches, "K2": self.k2.launches,
                "K3": self.k3.launches, "K4": self.k4.launches,
                "K5": self.k5.launches, "K6": self.k6.launches,
                "K2-f64": self.k2.launches_f64}

    def counts(self) -> dict:
        """The launches that ran on the device: the wrappers' counts less
        the calls captures recorded, plus those graph replays ran
        (``graphs.LEDGER``, which watches :meth:`raw_counts`)."""
        from repro_torch.solvers import graphs

        return graphs.LEDGER.ran(self.raw_counts())

    def zero_counts(self) -> None:
        from repro_torch.solvers import graphs

        for k in (self.k1, self.k2, self.k3, self.k4, self.k5, self.k6):
            k.launches = 0
        self.k2.launches_f64 = 0
        for k in self.raw_counts():
            graphs.LEDGER.net[k] = 0

    def in_turns(self, fn, label: str, each=None, start=None,
                 turns=TURNS, replays: int = 3) -> dict:
        """``fn() -> (x, info)`` run in ``turns`` (``graphs.eager()`` for
        the eager ones; the replay turn ``replays`` times), each run timed
        by :func:`wall`. ``start(turn)`` runs before a run, ``each(turn, x,
        info, launched)`` checks it after (``launched``: the device
        launches of the run by kernel). Fails unless every run has the
        first's iterations (where there is an info) and x bit for bit.
        Returns ``{turn: (x, info, seconds, launched)}`` (the replay turn:
        its median wall, and ``"replays"``: every replay's wall)."""
        from repro_torch.solvers import graphs

        out, x0, info0 = {"replays": []}, None, None
        for turn in turns:
            for _ in range(replays if turn == "replay" else 1):
                if start is not None:
                    start(turn)
                before = self.counts()
                with (graphs.eager() if turn.startswith("eager")
                      else contextlib.nullcontext()):
                    (x, info), sec = wall(fn)
                launched = {k: v - before[k]
                            for k, v in self.counts().items()}
                if each is not None:
                    each(turn, x, info, launched)
                if x0 is None:
                    x0, info0 = x, info
                if info0 is not None and info.iters != info0.iters:
                    fail(f"{label}: the {turn} run took {info.iters} "
                         f"iterations, the eager loop {info0.iters}")
                same_bits(x, x0, f"{label}: x of the {turn} run vs the "
                          "eager loop")
                out[turn] = (x, info, sec, launched)
                if turn == "replay":
                    out["replays"].append(sec)
        if out["replays"]:
            out["replay"] = out["replay"][:2] + (
                float(np.median(out["replays"])), out["replay"][3])
        return out

    def note(self, k: str, e: float) -> None:
        self.err[k] = max(self.err[k], e)
        self.cases[k] += 1

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
        self.note("K1", same_bits(
            self.k1(words, ckpt, x, **kw),
            kpk.packsell_spmv_fused_plain(words, ckpt, x, **kw),
            f"K1 {label}"))
        self.check_k3(words, ckpt, mat.m, kw, rng, label)
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
              f"G={lay.groups} bit-equal K1,K3(nb=1,3,4,8,12; aligned and "
              f"not); vs host f64 oracle rel {rel:.2e}", flush=True)

    def check_k3(self, words, ckpt, m, kw, rng, label):
        """K3 against its plain version at nb = 1, 3, 4, 8, 12, on X
        16-byte aligned (vector loads where nb % 4 == 0) and on a view 4
        bytes past that (scalar loads)."""
        from repro_torch.kernels import packsell_spmv as kpk

        for nb in (1, 3, 4, 8, 12):
            flat = torch.from_numpy(rng.standard_normal(m * nb + 1).astype(
                np.float32)).to(self.dev)
            for X, how in ((flat[:m * nb].view(m, nb), "aligned"),
                           (flat[1:].view(m, nb), "offset by 4 B")):
                vec = kpk.spmm_vector_loads(X)
                if vec != (how == "aligned" and nb % 4 == 0):
                    fail(f"K3 {label} nb={nb} {how}: vector loads {vec}")
                self.note("K3", same_bits(
                    self.k3(words, ckpt, X, **kw),
                    kpk.packsell_spmm_fused_plain(words, ckpt, X, **kw),
                    f"K3 {label} nb={nb} {how}"))

    def check_sell(self, label, a, value_dtype, compute=torch.float32):
        from repro_torch.core import sell as sl
        from repro_torch.kernels import ops

        mat = sl.from_csr(a, C=32, sigma=256, value_dtype=value_dtype,
                          device=self.dev)
        rng = np.random.default_rng(8)
        x = torch.from_numpy(rng.standard_normal(mat.m)).to(self.dev,
                                                             compute)
        k = "K2-f64" if compute == torch.float64 else "K2"
        for val, col in zip(mat.vals, mat.cols):
            self.note(k, same_bits(self.k2(val, col, x, compute),
                                   sl.sell_bucket_spmv(val, col, x, compute),
                                   f"{k} {label} {value_dtype}"))
        same_bits(ops.sell_spmv(mat, x, compute),
                  sl.sell_spmv(mat, x, compute),
                  f"sell_spmv {label} {value_dtype} {compute}")
        print(f"  {label:28s} SELL {value_dtype:8s} buckets="
              f"{len(mat.vals)} bit-equal {k}", flush=True)

    def check_bucket(self, label, a, codec, D, strategy="pow2"):
        """K4, K5 (nb = 1, 3, 4, 8, 12, on X 16-byte aligned -- vector loads
        where nb % 4 == 0 -- and on a view 4 bytes past that) and, on
        uniform buckets at the smallest feasible half-window, K6, each over
        all buckets in one launch, in both bodies (carry; checkpoint at wb
        = 32 and 8); then the plans against the quantized matrix in float64
        on the host."""
        from repro_torch.core import codecs as cd
        from repro_torch.core import packsell as pk
        from repro_torch.kernels import packsell_spmv as kpk
        from repro_torch.kernels import plan as kplan

        mat = pk.from_csr(a, C=32, sigma=256, D=D, codec=codec,
                          device=self.dev, bucket_strategy=strategy)
        rng = np.random.default_rng(9)
        m = mat.m
        x = torch.from_numpy(rng.standard_normal(m).astype(
            np.float32)).to(self.dev)
        Xs = []
        for nb in (1, 3, 4, 8, 12):
            flat = torch.from_numpy(rng.standard_normal(m * nb + 1).astype(
                np.float32)).to(self.dev)
            for X, how in ((flat[:m * nb].view(m, nb), "aligned"),
                           (flat[1:].view(m, nb), "offset by 4 B")):
                if kpk.spmm_vector_loads(X) != (how == "aligned"
                                                and nb % 4 == 0):
                    fail(f"K5 {label} nb={nb} {how}: wrong X loads")
                Xs.append((f"nb={nb} {how}", X))
        band = strategy == "uniform"
        hw = smallest_hw(mat) if band else None
        wins = ([torch.from_numpy(w).to(self.dev)
                 for w in kplan.band_plan(mat, 8, hw)] if band else None)
        for wb in (None, 32, 8):
            tiles = tuple((8, wb or 32) for _ in mat.packs)
            kck = (list(kplan._build_block_checkpoints(mat, tiles)) if wb
                   else None)
            table = kpk.bucket_table(mat.packs, mat.d0s, kck,
                                     [t[1] for t in tiles], wins=wins,
                                     sbs=[t[0] for t in tiles])
            args = (mat.packs, mat.d0s, kck, table)
            kw = dict(codec_name=codec, D=D)
            self.note("K4", same_bits(
                self.k4(*args, x, **kw),
                kpk.packsell_spmv_buckets_plain(*args, x, **kw),
                f"K4 {label} wb={wb}"))
            for how, X in Xs:
                self.note("K5", same_bits(
                    self.k5(*args, X, **kw),
                    kpk.packsell_spmm_buckets_plain(*args, X, **kw),
                    f"K5 {label} wb={wb} {how}"))
            if band:
                self.note("K6", same_bits(
                    self.k6(mat.packs, mat.d0s, wins, kck, table, x, hw=hw,
                            **kw),
                    kpk.packsell_spmv_band_buckets_plain(
                        mat.packs, mat.d0s, wins, kck, table, x, hw=hw, **kw),
                    f"K6 {label} wb={wb}"))
        pf = kplan.build_plan(mat, force="full")
        y = pf.spmv(mat, x)
        if band:
            pb = kplan.build_plan(mat, force="band", hw=hw)
            same_bits(pb.spmv(mat, x), y, f"band vs full plan {label}")
        aq = a.tocsr().astype(np.float64)
        aq.data = cd.quantize_np(aq.data, cd.make_codec(codec), D).astype(
            np.float64)
        want = aq @ x.cpu().numpy().astype(np.float64)
        rel = float(np.abs(y.cpu().numpy() - want).max()
                    / max(np.abs(want).max(), 1e-30))
        if not rel < 1e-5:
            fail(f"{label}: full plan vs host float64 oracle rel {rel:.3e}")
        print(f"  {label:28s} {strategy:7s} buckets={len(mat.packs)} "
              f"bit-equal K4,K5(nb=1,3,4,8,12; aligned and not)"
              f"{',K6 hw=' + str(hw) if band else ''}, one launch each "
              f"(carry, wb=32, wb=8); vs host f64 oracle rel {rel:.2e}",
              flush=True)

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
        for vd in ("float64", "float32"):
            self.check_sell(hn, h, vd, torch.float64)
        for codec, D in (("e8m", 12), ("e8m", 8), ("e8m", 4), ("e8m", 1),
                         ("bf16", 15)):
            self.check_bucket(f"{hn} {codec}/D{D}", h, codec, D)
        for codec, D in (("e8m", 8), ("e8m", 12), ("fp16", 15)):
            self.check_bucket(f"{hn} {codec}/D{D}", h, codec, D, "uniform")
        for k in self.err:
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

        def each(turn, x, info, launched):
            steps = info.iters if turn.startswith("eager") else \
                chunk_steps(info.iters, cg.PCG_CHUNK)
            if launched["K1"] != steps + 1:
                fail(f"Jacobi-PCG {turn}: K1 launches {launched['K1']} != "
                     f"steps + 1 ({steps + 1})")

        # the main path's run is the captured solve: the counts are set to
        # 0 just before it
        runs = self.in_turns(
            lambda: cg.jacobi_pcg_stored(mat, plan, diag, b, tol=1e-8,
                                         maxiter=2000), "Jacobi-PCG", each,
            start=lambda turn: turn == "capture" and self.zero_counts())
        x, info, solve_s, launched = runs["capture"]
        k1_solve = launched["K1"]
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
        steps = chunk_steps(info.iters, cg.PCG_CHUNK)
        print(f"  Jacobi-PCG (tol 1e-8): iterations {info.iters}, "
              f"recurrence relres {relres!r}; the same x bit for bit in "
              f"every run; solve walls (host clock, ends in synchronize): "
              f"{turn_walls(runs)}; graphs: chunks of {cg.PCG_CHUNK} steps, "
              f"{steps} steps run, {steps - info.iters} more than the eager "
              f"loop (the stopping chunk past the stop, then its steps up "
              f"to the stop again)",
              flush=True)
        print(f"  true relres vs unquantized s (host scipy float64): "
              f"{true_rel!r}", flush=True)
        print(f"  spmm nb=8: ||1 - A_q x|| / ||1|| on column 0 {q_rel!r}; "
              f"|spmm col 0 - SELL f16 spmv| / max {sp_rel!r}", flush=True)
        print(f"  launches in this run: {launches}", flush=True)
        if not relres < 1e-8:
            fail(f"recurrence relres {relres} not < 1e-8")
        if min(launches.values()) < 1:
            fail(f"a kernel of the main path never launched: {launches}")
        if not sp_rel < 1e-3:
            fail(f"PackSELL spmm and SELL spmv disagree: {sp_rel}")

        # the same solve on the plain body, on the card
        pj = kplan.get_plan(mat, force="jnp")
        before = self.counts()
        (xj, info_j), plain_s = wall(lambda: cg.jacobi_pcg_stored(
            mat, pj, diag, b, tol=1e-8, maxiter=2000))
        if self.counts()["K1"] != before["K1"]:
            fail("the plain solve launched K1")
        dx = float(torch.linalg.vector_norm(x - xj)
                   / torch.linalg.vector_norm(x))
        print(f"  plain body (force='jnp') on the card: iterations "
              f"{info_j.iters}, solve wall {plain_s!r} s, "
              f"||x - x_plain|| / ||x|| {dx!r}", flush=True)
        if info_j.iters != info.iters:
            fail(f"plain solve took {info_j.iters} iterations, kernel "
                 f"{info.iters}")
        return dict(a=s, ops=ops_set, mat=mat, plan=plan, sell=sell,
                    launches=launches, iters=info.iters)

    # -- phase 5: the mixed-precision path ----------------------------------
    def mixed_path(self, a_s):
        """``adaptive_pcg`` over the e8m tier ladder of ``OperatorSet.
        adaptive_tiers`` on the sym-scaled matrix ``a_s`` (K4 in every e8m
        tier, K2 with a float64 sum for the outer residual), then
        ``plan.spmm`` (nb = 8) on the e8m/D8 tier (one K5 launch) and the
        band plan of e8m/D8 on uniform buckets (one K6 launch). Then the
        same solve on the plain bodies, and fp32 Jacobi-PCG through K2 to
        1e-8."""
        from repro_torch.core import packsell as pk
        from repro_torch.kernels import plan as kplan
        from repro_torch.precision import select as psel
        from repro_torch.solvers import cg
        from repro_torch.solvers.operators import OperatorSet

        n = a_s.shape[0]
        ops_k = OperatorSet(a_s, C=32, sigma=256, device=self.dev,
                            force=self.force_mixed)
        t0 = time.perf_counter()
        pplan = ops_k.precision_plan(1e-3, n_probes=2)
        ladder = psel.tier_ladder(pplan)
        print(f"  analysis (select_codec, budget 1e-3, 2 probes): "
              f"{time.perf_counter() - t0:.1f} s (host); ladder "
              f"{[c.label for c in ladder]}", flush=True)
        for c in ladder + [psel.PrecisionClass("fp64", 0)]:
            kind = "fp64" if c.codec == "fp64" else psel.operator_kind(c)
            t0 = time.perf_counter()
            ops_k.matvec(kind)
            built = time.perf_counter() - t0
            if kind.startswith("plan_"):
                mat, plan = ops_k.plan_pair(kind)
                desc = f"buckets={len(mat.packs)} plan: {plan.policy}"
                if c.D < 15 and plan.variant != "full":
                    fail(f"tier {c.label}: plan variant {plan.variant!r}, "
                         "not 'full'")
            else:
                desc = f"SELL buckets={len(ops_k.stored(kind).vals)}"
            print(f"  tier {kind:10s} built in {built:.1f} s (host): {desc}",
                  flush=True)
        tiers, labels, sub32, hi = ops_k.adaptive_tiers(1e-3, n_probes=2)
        diag = torch.as_tensor(a_s.diagonal(), device=self.dev)
        dinv = torch.where(diag == 0, torch.ones_like(diag), 1.0 / diag)
        M = lambda r: r * dinv                              # noqa: E731
        b_h = np.random.default_rng(0).standard_normal(n)
        b = torch.from_numpy(b_h).to(self.dev)
        kw = dict(M=M, tol=1e-8, maxiter=60, m_in=16)

        def true_rel(x):
            x_h = x.cpu().numpy().astype(np.float64)
            if not np.isfinite(x_h).all():
                fail("non-finite solution of the mixed-precision solve")
            return float(np.linalg.norm(b_h - a_s @ x_h)
                         / np.linalg.norm(b_h))

        fp64_buckets = len(ops_k.stored("fp64").vals)
        full = [c.codec != "fp32" and ops_k.plan_pair(
            psel.operator_kind(c))[1].variant == "full" for c in ladder]

        def each(turn, x, info, launched):
            # one K4 launch per matvec of a full plan, one K2-f64 per fp64
            # bucket and matvec: one outer step per replay, none masked
            want_k4 = sum(c for c, f in zip(info.tier_matvecs.tolist(),
                                            full) if f)
            if launched["K4"] != want_k4:
                fail(f"adaptive_pcg {turn}: K4 launches {launched['K4']} != "
                     f"{want_k4}")
            if launched["K2-f64"] != info.hi_matvecs * fp64_buckets:
                fail(f"adaptive_pcg {turn}: K2-f64 launches "
                     f"{launched['K2-f64']} != hi_matvecs {info.hi_matvecs} "
                     f"x {fp64_buckets} buckets")

        cache = {}
        runs = self.in_turns(
            lambda: cg.adaptive_pcg(tiers, b, matvec_hi=hi, jit_cache=cache,
                                    jit_key="ladder", **kw),
            "adaptive_pcg", each,
            start=lambda turn: turn == "capture" and self.zero_counts())
        x, info, solve_s, after_solve = runs["capture"]
        counts = info.tier_matvecs.tolist()
        share = sum(c for c, s32 in zip(counts, sub32) if s32) / (
            sum(counts) + info.hi_matvecs)
        rel = true_rel(x)
        print(f"  adaptive_pcg (tol 1e-8, m_in 16, Jacobi M): outer steps "
              f"{info.iters}, promotions {info.promotions}, tier_history "
              f"{info.tier_history[:info.iters].tolist()}, tier_matvecs "
              f"{counts}, hi_matvecs {info.hi_matvecs}, sub-32-bit share "
              f"{share!r}", flush=True)
        print(f"  solve walls (host clock, ends in synchronize; set-up "
              f"outside; the same x bit for bit in every run): "
              f"{turn_walls(runs)}; true relres vs s (host scipy float64) "
              f"{rel!r}", flush=True)
        print(f"  launches in the captured solve: {after_solve} (K4 one per "
              f"packed-tier matvec of the full plans, K2-f64 hi_matvecs x "
              f"{fp64_buckets} buckets)", flush=True)
        if not rel <= 1e-8:
            fail(f"true relres {rel} > 1e-8")

        # K5: the multi-RHS product on the e8m/D8 tier's plan, one launch
        mat8, plan8 = ops_k.plan_pair("plan_e8m8")
        rng = np.random.default_rng(13)
        X = torch.from_numpy(rng.standard_normal((n, 8)).astype(
            np.float32)).to(self.dev)
        before = self.k5.launches
        Y = plan8.spmm(mat8, X)
        if self.k5.launches != before + 1:
            fail(f"plan.spmm launched K5 {self.k5.launches - before} times, "
                 "not once")
        y0 = plan8.spmv(mat8, X[:, 0].contiguous())
        if not torch.equal(Y[:, 0], y0):
            # K5 and K4 walk a row alike and add one column in one order
            fail("plan.spmm column 0 differs from plan.spmv on it")

        # K6: e8m/D8 on uniform buckets at the smallest feasible half-window
        t0 = time.perf_counter()
        mat_u = pk.from_csr(a_s, C=32, sigma=256, D=8, codec="e8m",
                            device=self.dev, bucket_strategy="uniform")
        H = smallest_hw(mat_u)
        band = kplan.get_plan(mat_u, hw=H, force=self.force_band)
        full = kplan.get_plan(mat_u, force="full")
        print(f"  e8m/D8 uniform buckets: built in "
              f"{time.perf_counter() - t0:.1f} s (host), smallest feasible "
              f"hw {H} ({H / (self.main_side ** 2):.2f} nx*ny); plan: "
              f"{band.policy}", flush=True)
        if band.variant != "band":
            fail(f"uniform e8m/D8 plan is {band.variant!r}, not 'band'")
        xb = torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to(self.dev)
        before = self.k6.launches
        yb = band.spmv(mat_u, xb)
        if self.k6.launches != before + 1:
            fail(f"the band SpMV launched K6 {self.k6.launches - before} "
                 "times, not once")
        same_bits(yb, full.spmv(mat_u, xb),
                  "band plan vs full plan, uniform e8m/D8")
        torch.cuda.synchronize()
        launches = self.counts()
        print(f"  launches in this run (solve, spmm, band and full spmv): "
              f"{launches}", flush=True)
        for k in ("K4", "K5", "K6", "K2-f64"):
            if launches[k] < 1:
                fail(f"{k} never launched on the mixed-precision path")

        # the same solve on the plain bodies, on the card: same schedule
        ops_p = plain_twin(ops_k, [psel.operator_kind(c) for c in ladder]
                           + ["fp64"])
        tiers_p, _, _ = psel.build_tier_matvecs(ops_p, ladder)
        hi_p = ops_p.matvec("fp64")
        before = self.counts()
        (xp, info_p), plain_s = wall(lambda: cg.adaptive_pcg(
            tiers_p, b, matvec_hi=hi_p, **kw))
        dx = float(torch.linalg.vector_norm(x - xp)
                   / torch.linalg.vector_norm(x))
        print(f"  plain bodies (force='jnp') on the card: outer steps "
              f"{info_p.iters}, tier_history "
              f"{info_p.tier_history[:info_p.iters].tolist()}, tier_matvecs "
              f"{info_p.tier_matvecs.tolist()}, hi_matvecs "
              f"{info_p.hi_matvecs}, solve wall {plain_s!r} s, "
              f"||x - x_plain|| / ||x|| {dx!r}, true relres "
              f"{true_rel(xp)!r}", flush=True)
        if self.counts() != before:
            fail("the plain solve launched a kernel")
        if (info_p.iters, info_p.promotions, info_p.hi_matvecs) != \
                (info.iters, info.promotions, info.hi_matvecs) \
                or not torch.equal(info_p.tier_history, info.tier_history) \
                or not torch.equal(info_p.tier_matvecs, info.tier_matvecs):
            fail("the plain solve's schedule differs from the kernels'")

        # the paper's comparison: fp32 Jacobi-PCG through K2 to 1e-8
        mv32 = ops_k.matvec("fp32")
        cache32 = {}
        r32 = self.in_turns(lambda: cg.pcg(
            mv32, b, M=M, tol=1e-8, maxiter=5000, jit_cache=cache32,
            jit_key="fp32"), "fp32 Jacobi-PCG")
        x32, info32 = r32["capture"][:2]
        print(f"  fp32 Jacobi-PCG through K2 (tol 1e-8): iterations "
              f"{info32.iters}, recurrence relres {float(info32.relres)!r}, "
              f"solve walls {turn_walls(r32)}, true relres "
              f"{true_rel(x32)!r}", flush=True)
        return dict(ops=ops_k, ladder=ladder, mat_u=mat_u,
                    band=band, launches=launches, info=info)

    # -- phase 6: times at the main path's shapes --------------------------
    def times(self, mp):
        """K1, K2 (f16 values) and K3 at the main path's shapes; K3 at nb =
        1, 2, 4 beside K1 (nb = 8 is its row); K4 over the same fp16/D15
        words as K1, through a ``full`` plan of the main matrix."""
        from repro_torch.core import codecs as cd
        from repro_torch.core import sell as sl
        from repro_torch.kernels import packsell_spmv as kpk
        from repro_torch.kernels import plan as kplan

        s, mat, plan, sell = mp["a"], mp["mat"], mp["plan"], mp["sell"]
        lay = plan.fused_layout
        words, ckpt = plan.fused
        kw = dict(codec_name=mat.codec_name, D=mat.D, encoding=lay.encoding,
                  scale=lay.scale)
        G, wr, C = words.shape
        m = mat.m
        rng = np.random.default_rng(12)
        x = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(
            self.dev)
        reps, preps = self.reps, max(self.reps // 10, 2)
        where = f"HPCG {self.main_side}^3"

        # each kernel against its plain version at the main path's shapes
        for k, got, want in (
                ("K1", lambda: self.k1(words, ckpt, x, **kw),
                 lambda: kpk.packsell_spmv_fused_plain(words, ckpt, x, **kw)),
                *(("K2", lambda v=v, c=c: self.k2(v, c, x),
                   lambda v=v, c=c: sl.sell_bucket_spmv(v, c, x))
                  for v, c in zip(sell.vals, sell.cols))):
            self.note(k, same_bits(got(), want(), f"{k} at {where}"))
        self.check_k3(words, ckpt, m, kw, rng, where)
        print(f"  K1, K3 (nb=1,3,4,8,12; aligned and not) and K2 (f16, "
              f"{len(sell.vals)} buckets) bit-equal to their plain versions "
              "at these shapes", flush=True)

        a_q = sparse_csr(s, cd.quantize_np(s.data, mat.codec, mat.D),
                         self.dev)
        a_h = sparse_csr(s, s.data.astype(np.float16), self.dev)
        rows = {}

        def k1():
            self.k1(words, ckpt, x, **kw)

        k1p = timed(lambda: kpk.packsell_spmv_fused_plain(words, ckpt, x,
                                                          **kw), preps)
        lib1 = timed(lambda: a_q @ x, reps)
        nbytes = 4 * G * wr * C + 4 * G * C + 4 * m + 4 * G * C
        rows["K1"] = (device_ms(k1, reps), k1p, lib1,
                      *bound_ms(nbytes, 2 * G * wr * C), timed(k1, reps))

        def k2_all():
            for v, c in zip(sell.vals, sell.cols):
                self.k2(v, c, x)

        def k2_plain():
            for v, c in zip(sell.vals, sell.cols):
                sl.sell_bucket_spmv(v, c, x)

        k2p = timed(k2_plain, preps)
        lib2 = timed(lambda: a_h @ x, reps)
        ent = sum(v.numel() for v in sell.vals)
        nbytes = ent * (2 + 4) + 4 * m + 4 * sum(
            v.shape[0] * v.shape[2] for v in sell.vals)
        rows["K2"] = (device_ms(k2_all, reps), k2p, lib2,
                      *bound_ms(nbytes, 2 * ent), timed(k2_all, reps))

        # K3: nb = 8 is the kernel's row; nb = 1, 2, 4 show how its time
        # grows with the right-hand sides, nb = 12 and 16 whether it moves
        # when the [m, nb] x block outgrows L2 (no admission limit's rule)
        for nb in (8, 1, 2, 4, 12, 16):
            X = torch.from_numpy(rng.standard_normal((m, nb)).astype(
                np.float32)).to(self.dev)

            def k3(X=X):
                self.k3(words, ckpt, X, **kw)

            k3p = timed(lambda: kpk.packsell_spmm_fused_plain(
                words, ckpt, X, **kw), preps)
            lib3 = timed(lambda: a_q @ X, reps)
            nbytes = (4 * G * wr * C + 4 * G * C + 4 * m * nb
                      + 4 * G * C * nb)
            rows["K3" if nb == 8 else f"K3 nb={nb}"] = (
                device_ms(k3, reps), k3p, lib3,
                *bound_ms(nbytes, 2 * G * wr * C * nb), timed(k3, reps))

        # K4 on the words K1 walks: the fp16/D15 matrix through a full plan
        pk4 = kplan.build_plan(mat, force="full")
        print(f"  fp16/D15 full plan buckets "
              f"{[tuple(p.shape) for p in mat.packs]} (K1's stream "
              f"{[G, wr, C]})", flush=True)
        self.k4_rows(rows, "K4 fp16/D15", mat, pk4, x, a_q, per_bucket=True)
        print_rows(rows, "")
        for nb in (1, 2, 4, 8, 12, 16):
            t = rows["K3" if nb == 8 else f"K3 nb={nb}"][0]
            print(f"  K3 nb={nb}: {t / rows['K1'][0]!r} x K1's device time, "
                  f"{t / nb!r} ms per right-hand side; x block "
                  f"{l2_share(m, nb)}", flush=True)
        return rows

    def k4_rows(self, rows, key, mat, plan, x, a_q, per_bucket=False):
        """K4's row ``key`` for a full plan: one launch per matvec through
        the plan's table, bit-equal to its plain version; with
        ``per_bucket``, also one row per bucket through a one-bucket
        table (``key bucket b``)."""
        from repro_torch.kernels import packsell_spmv as kpk

        reps, preps = self.reps, max(self.reps // 10, 2)
        kw = dict(codec_name=mat.codec_name, D=mat.D)
        kck = plan.kckpts
        sel = [list(range(len(mat.packs)))]
        if per_bucket:
            sel += [[b] for b in range(len(mat.packs))]
        for bs in sel:
            packs = [mat.packs[b] for b in bs]
            d0s = [mat.d0s[b] for b in bs]
            cks = None if kck is None else [kck[b] for b in bs]
            table = (plan.ktable if len(bs) == len(mat.packs) else
                     kpk.bucket_table(packs, d0s, cks,
                                      [plan.tiles[b][1] for b in bs]))

            def run():
                return self.k4(packs, d0s, cks, table, x, **kw)

            def plain():
                return kpk.packsell_spmv_buckets_plain(packs, d0s, cks,
                                                       table, x, **kw)

            self.note("K4", same_bits(run(), plain(),
                                      f"{key} at HPCG {self.main_side}^3"))
            words = sum(p.numel() for p in packs)
            nbytes = 4 * (words + sum(d.numel() for d in d0s) + table.total
                          + x.numel())
            name = key if len(bs) == len(mat.packs) else (
                f"K4 {mat.codec_name}/D{mat.D} bucket {bs[0]} "
                f"{list(packs[0].shape)}")
            lib = (timed(lambda: a_q @ x, reps)
                   if len(bs) == len(mat.packs) else None)
            rows[name] = (device_ms(run, reps),
                          timed(plain, preps), lib,
                          *bound_ms(nbytes, 2 * words), timed(run, reps))

    def times_bucket(self, mx):
        """K4 (the e8m/D8, D4, D12 and D1 tiers, one launch per matvec; D8
        and D1 also bucket by bucket), K5 (the e8m/D8 tier at nb = 8, its
        row, and at nb = 1, 2, 4), K6 (the uniform e8m/D8 band plan), K2-f64
        (the fp64 operator) and K2 with fp32 values (the fp32 tier) at the
        mixed path's shapes, each per matvec (K5: per SpMM)."""
        from repro_torch.core import codecs as cd
        from repro_torch.core import sell as sl
        from repro_torch.kernels import packsell_spmv as kpk

        ops_k = mx["ops"]
        s = ops_k.csr
        m = s.shape[1]
        rng = np.random.default_rng(14)
        x = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(
            self.dev)
        x64 = torch.from_numpy(rng.standard_normal(m)).to(self.dev)
        reps, preps = self.reps, max(self.reps // 10, 2)

        def bucket_row(k, mat, plan, xx, lib):
            """K5 (xx [m, nb]) or K6 (xx [m]) over all buckets of a plan,
            one launch through its table, bit-equal to its plain version.
            The bound counts the words, d0, K6's windows, x or X and the
            output once each."""
            args = (mat.packs, mat.d0s, plan.kckpts, plan.ktable, xx)
            kw = dict(codec_name=mat.codec_name, D=mat.D)
            if k == "K6":
                args = (mat.packs, mat.d0s, plan.wins, *args[2:])
                kw["hw"] = plan.hw
                kernel, plain = self.k6, kpk.packsell_spmv_band_buckets_plain
            else:
                kernel, plain = self.k5, kpk.packsell_spmm_buckets_plain
            got = kernel(*args, **kw)
            self.note(k, same_bits(got, plain(*args, **kw),
                                   f"{k} at HPCG {self.main_side}^3, x "
                                   f"{tuple(xx.shape)}"))

            def run():
                return kernel(*args, **kw)

            tp = timed(lambda: plain(*args, **kw), preps)
            words = sum(p.numel() for p in mat.packs)
            nbytes = 4 * (words + sum(d.numel() for d in mat.d0s)
                          + got.numel() + xx.numel())
            if k == "K6":
                nbytes += 4 * sum(w.numel() for w in plan.wins)
            cols = xx.shape[1] if xx.dim() == 2 else 1
            return (device_ms(run, reps), tp, timed(lambda: lib @ xx, reps),
                    *bound_ms(nbytes, 2 * words * cols), timed(run, reps))

        rows = {}
        for D, key in ((8, "K4"), (4, "K4 e8m/D4"), (12, "K4 e8m/D12"),
                       (1, "K4 e8m/D1")):
            mat, plan = ops_k.plan_pair(f"plan_e8m{D}")
            a_q = sparse_csr(s, cd.quantize_np(s.data, mat.codec, D),
                             self.dev)
            self.k4_rows(rows, key, mat, plan, x, a_q,
                         per_bucket=D in (8, 1))
        mat, plan = ops_k.plan_pair("plan_e8m8")
        a_q8 = sparse_csr(s, cd.quantize_np(s.data, mat.codec, 8), self.dev)
        # K5: nb = 8 is the kernel's row; nb = 1, 2, 4 show how its time
        # grows with the right-hand sides, nb = 12 and 16 past the L2 line
        for nb in (8, 1, 2, 4, 12, 16):
            X = torch.from_numpy(rng.standard_normal((m, nb)).astype(
                np.float32)).to(self.dev)
            rows["K5" if nb == 8 else f"K5 nb={nb}"] = bucket_row(
                "K5", mat, plan, X, a_q8)
        rows["K6"] = bucket_row("K6", mx["mat_u"], mx["band"], x, a_q8)

        def k2_row(k, sell, xx, acc, lib):
            """K2 over every bucket of a SELL operator, per matvec."""
            note = "K2-f64" if acc == torch.float64 else "K2"
            for v, c in zip(sell.vals, sell.cols):
                self.note(note, same_bits(
                    self.k2(v, c, xx, acc), sl.sell_bucket_spmv(v, c, xx, acc),
                    f"{k} at HPCG {self.main_side}^3"))

            def k2_all():
                for v, c in zip(sell.vals, sell.cols):
                    self.k2(v, c, xx, acc)

            tp = timed(lambda: [sl.sell_bucket_spmv(v, c, xx, acc)
                                for v, c in zip(sell.vals, sell.cols)],
                       preps)
            ent = sum(v.numel() for v in sell.vals)
            vbytes = sell.vals[0].element_size()
            obytes = xx.element_size()
            nbytes = ent * (vbytes + 4) + obytes * m + obytes * sum(
                v.shape[0] * v.shape[2] for v in sell.vals)
            rows[k] = (device_ms(k2_all, reps), tp,
                       timed(lambda: lib @ xx, reps),
                       *bound_ms(nbytes, 2 * ent), timed(k2_all, reps))

        k2_row("K2-f64", ops_k.stored("fp64"), x64, torch.float64,
               sparse_csr(s, s.data, self.dev, np.float64))
        k2_row("K2 fp32 values", ops_k.stored("fp32"), x, torch.float32,
               sparse_csr(s, s.data.astype(np.float32), self.dev))
        print_rows(rows, " per matvec")
        for nb in (1, 2, 4, 8, 12, 16):
            t = rows["K5" if nb == 8 else f"K5 nb={nb}"][0]
            print(f"  K5 nb={nb}: {t / rows['K4'][0]!r} x K4's device time "
                  f"(e8m/D8), {t / nb!r} ms per right-hand side; x block "
                  f"{l2_share(m, nb)}", flush=True)
        return rows

    # -- phase 7: where a solve's time goes --------------------------------
    def breakdown(self, mp, iters: int = 24, reps: int = 3):
        """A solve's cost split into set-up and iterations, and the device's
        busy share of the same run, for the eager loop and for the graphs
        (``iters`` a whole number of chunks, so no step runs again). Each
        solve is timed by CUDA events recorded around the call: its wall on
        the device's clock, host gaps included. ``maxiter=0`` is the
        set-up (the stored-order permutes, the first residual's matvec,
        the final gather); ``iters`` more iterations give the cost per
        iteration. The profiler's device time by kernel is divided by the
        event wall of the one solve it traced."""
        from statistics import median

        from repro_torch.solvers import cg, graphs

        mat, plan, s = mp["mat"], mp["plan"], mp["a"]
        b = torch.ones(s.shape[0], dtype=torch.float64, device=self.dev)
        t0 = time.perf_counter()
        diag = torch.as_tensor(s.diagonal(), device=self.dev)
        torch.cuda.synchronize()
        diag_ms = (time.perf_counter() - t0) * 1e3
        print(f"  host: the diagonal from scipy and its copy to the card "
              f"{diag_ms!r} ms, once, outside the solves", flush=True)
        if iters % cg.PCG_CHUNK:
            fail(f"breakdown: {iters} iterations are not whole chunks")

        def solve(k: int) -> float:    # tol 0: exactly k iterations
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            cg.jacobi_pcg_stored(mat, plan, diag, b, tol=0.0, maxiter=k)
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop)

        for mode in ("eager", "graphs"):
            with (graphs.eager() if mode == "eager"
                  else contextlib.nullcontext()):
                solve(iters)
                solve(0)
                set_up = median(solve(0) for _ in range(reps))
                whole = median(solve(iters) for _ in range(reps))
                per_iter = (whole - set_up) / iters
                print(f"  {mode}: solve walls (CUDA events, median of "
                      f"{reps}): set-up (maxiter=0) {set_up!r} ms, {iters} "
                      f"iterations {whole!r} ms; per iteration "
                      f"{per_iter!r} ms", flush=True)
                wall0, kern0 = profiled(lambda: cg.jacobi_pcg_stored(
                    mat, plan, diag, b, tol=0.0, maxiter=0))
                wall, kern = profiled(lambda: cg.jacobi_pcg_stored(
                    mat, plan, diag, b, tol=0.0, maxiter=iters))
            if not kern:
                print(f"  {mode}: device time by kernel: not measured (the "
                      f"profiler saw no device events)", flush=True)
                continue
            busy0, busy = sum(k[0] for k in kern0), sum(k[0] for k in kern)
            print(f"  {mode}: profiled set-up: device busy {busy0!r} ms of a "
                  f"{wall0!r} ms event wall", flush=True)
            dev_iter = (busy - busy0) / iters
            print(f"  {mode}: profiled {iters} iterations: device busy "
                  f"{busy!r} ms of a {wall!r} ms event wall (idle share "
                  f"{1 - busy / wall!r}); device time per iteration "
                  f"{dev_iter!r} ms, so an idle share per iteration of "
                  f"{1 - dev_iter / per_iter!r} against the unprofiled "
                  f"wall per iteration; {sum(k[1] for k in kern)} kernels; "
                  f"by kernel:", flush=True)
            for ms, count, key in kern[:12]:
                print(f"    {ms:10.4f} ms  {count:5d}x  {key[:90]}",
                      flush=True)

    # -- phase 8: the paper's solvers --------------------------------------
    def solvers_path(self, a_s, ops_k, m_in: int = 50):
        """The paper's solver experiments on the sym-scaled matrix ``a_s``
        with b = ones, each in :data:`TURNS` (eager, captured, captured,
        eager; x bit for bit): IO-CG (``m_in`` inner PCG iterations;
        variants fp64, fp32, fp16, e8m8, e8m12) and its baseline
        ``pcg_reference`` (fp64 PCG, the same Neumann preconditioner), F3R
        (presets fp64, fp16, packsell); then ``pcg_reference`` / IO-CG at
        m_in 20, 50 and 80 (fp32, e8m8, fp16), the e8m8 IO-CG on the plain
        bodies (:func:`plain_twin`), the fixed-iteration solvers under
        ``set_sync_debug_mode("error")``, and the PackSELL triangular
        solve of ``tril(a_s)`` with RCM's bandwidths. ``ops_k`` is phase
        5's operator set (its fp64 and fp32 SELL operators are reused).
        Each run's matvecs by kind and its launches must be what the
        solve's structure needs: in chunks (``pcg_reference``), the steps
        run. F3R's captured runs must make no Python call of an L3 or L4
        SpMV past the capture of L3's one graph (L4 inline in it)."""
        from repro_torch.kernels import ops as kops
        from repro_torch.solvers import cg, f3r, graphs, iocg

        n = a_s.shape[0]
        b_h = np.ones(n)
        b = torch.ones(n, dtype=torch.float64, device=self.dev)

        def true_rel(x):
            x_h = x.cpu().numpy().astype(np.float64)
            if not np.isfinite(x_h).all():
                fail("non-finite solution in the solver phase")
            return float(np.linalg.norm(b_h - a_s @ x_h)
                         / np.linalg.norm(b_h))

        kinds = ("fp64", "fp32", "fp16", "packsell_e8m8", "packsell_e8m12",
                 "packsell_fp16")
        t0 = time.perf_counter()
        for kind in kinds:
            ops_k.matvec(kind)
        ops_k.diag()
        print(f"  operators and the diagonal built in "
              f"{time.perf_counter() - t0:.1f} s (host; fp64 and fp32 are "
              f"phase 5's); each solve's wall below includes its "
              f"preconditioner's set-up from that diagonal; walls in the "
              f"order {', '.join(TURNS)}", flush=True)
        variants = {}
        for kind in kinds[3:]:
            mat = ops_k.stored(kind)
            plan = kops.percall_plan(mat, ops_k.force)
            variants[kind] = plan.variant
            print(f"  {kind}: buckets {len(mat.packs)}, words "
                  f"{mat.words_bucketed}, plan: {plan.policy}", flush=True)
        buckets = {k: len(ops_k.stored(k).vals) for k in kinds[:3]}

        def launches_of(calls):
            """The launches matvecs ``calls`` (by kind) make: one K2 per
            SELL bucket (with a float64 sum for fp64), one K1, K4 or K6 per
            packsell_ matvec by its plan."""
            want = dict.fromkeys(self.counts(), 0)
            for kind, c in calls.items():
                if kind in buckets:
                    want["K2"] += c * buckets[kind]
                    want["K2-f64"] += c * buckets[kind] * (kind == "fp64")
                else:
                    want[PLAN_KERNEL[variants[kind]]] += c
            return want

        cops = CountedOps(ops_k)

        def checked(label, want_calls):
            """An ``each`` for :meth:`in_turns`: the run's matvecs (the
            calls and the replays' calls) must be ``want_calls(turn,
            info)``, its launches theirs."""
            def each(turn, x, info, launched):
                ran, want = cops.ran(), want_calls(turn, info)
                if ran != {k: v for k, v in want.items() if v}:
                    fail(f"{label} {turn}: matvecs {ran}, want {dict(want)}")
                if launched != launches_of(ran):
                    fail(f"{label} {turn}: launches {launched}, want "
                         f"{launches_of(ran)}")
                self.seen[label] = (ran, launched)
            return each

        def start(turn):
            cops.reset()

        self.zero_counts()
        self.seen = {}
        k_ain = iocg.IOCGConfig().ainv_terms
        with cops.watch():
            ref = self.in_turns(
                lambda: iocg.pcg_reference(cops, b), "pcg_reference",
                checked("pcg_reference", lambda turn, info: {
                    "fp64": 2 + 2 * (info.iters if turn.startswith("eager")
                                     else chunk_steps(info.iters,
                                                       cg.PCG_CHUNK))}),
                start)
            x, info = ref["eager"][:2]
            rel = true_rel(x)
            steps = chunk_steps(info.iters, cg.PCG_CHUNK)
            print(f"  pcg_reference (fp64 PCG, Neumann {k_ain} terms, tol "
                  f"1e-9): iterations {info.iters} (captured: {steps} steps "
                  f"run, {steps - info.iters} more than the eager loop), "
                  f"true relres "
                  f"{rel!r}, "
                  f"walls {turn_walls(ref)}; captured run: matvecs, "
                  f"launches {self.seen['pcg_reference']}", flush=True)
            if not rel <= 5e-9:
                fail(f"pcg_reference true relres {rel} > 5e-9")
            iocg_walls = {}

            def iocg_turns(name, m, turns=TURNS, replays=3):
                cfg = iocg.variant(name, m_in=m)
                # each inner application: M once, then m × (A, M); one
                # application per outer step (chunks of 1: no step runs again)
                per = (cfg.ainv_terms - 1) + m * cfg.ainv_terms

                def want(turn, info):
                    w = collections.Counter({"fp64": 1 + info.iters})
                    w[cfg.inner_spmv] += (info.iters + 1) * per
                    return w

                label = f"IO-CG {name} m_in {m}"
                return cfg, self.in_turns(
                    lambda: iocg.solve(cops, b, cfg), label,
                    checked(label, want), start, turns, replays)

            xs, iters = {}, {}
            for name in ("fp64", "fp32", "fp16", "e8m8", "e8m12"):
                cfg, runs = iocg_turns(name, m_in)
                x, info = runs["eager"][:2]
                rel = true_rel(x)
                xs[name], iters[name] = x, info.iters
                iocg_walls[name, m_in] = runs
                print(f"  IO-CG {name:5s} (m_in {m_in}, inner "
                      f"{cfg.inner_spmv}, "
                      f"{variants.get(cfg.inner_spmv, 'SELL, K2')}): outer "
                      f"iterations {info.iters}, true relres {rel!r}, walls "
                      f"{turn_walls(runs)}; pcg_reference / IO-CG walls: "
                      f"eager {ref['eager'][2] / runs['eager'][2]!r}, "
                      f"replay {ref['replay'][2] / runs['replay'][2]!r}; "
                      f"captured run: matvecs, launches "
                      f"{self.seen[f'IO-CG {name} m_in {m_in}']}",
                      flush=True)
                bound = 1e-6 if name == "fp16" else 5e-9
                if not rel <= bound:
                    fail(f"IO-CG {name}: true relres {rel} > {bound}")

            cycles, x3, f3r_walls = {}, {}, {}
            for name in ("fp64", "fp16", "packsell"):
                cfg = f3r.presets(name)
                layers = {}

                def want(turn, info, cfg=cfg, layers=layers):
                    layers.update(f3r_layer_spmvs(cfg, info.iters))
                    w = collections.Counter()
                    for layer, kind in (("L1", cfg.spmv_outer),
                                        ("L2", cfg.spmv_mid),
                                        ("L3", cfg.spmv_inner),
                                        ("L4", cfg.spmv_inner)):
                        w[kind] += layers[layer]
                    return w

                counted = checked(f"F3R {name}", want)

                def each(turn, x, info, launched, cfg=cfg, layers=layers,
                         counted=counted, name=name):
                    counted(turn, x, info, launched)
                    self.seen[f"F3R {name} {turn} calls"] = dict(+cops.calls)
                    if turn.startswith("eager") or self.dev.type != "cuda":
                        return          # (a CPU graph runs its body again)
                    # eager: L1's and L2's SpMVs; L3's graph: its warm-up
                    # and capture (one L3 application each, L4 inline), then
                    # replays only
                    py = collections.Counter({cfg.spmv_outer: layers["L1"]})
                    py[cfg.spmv_mid] += layers["L2"]
                    if turn == "capture":
                        apps = info.iters * cfg.m_outer * cfg.m_mid
                        py[cfg.spmv_inner] += 2 * (
                            layers["L3"] + layers["L4"]) // apps
                    if +cops.calls != +py:
                        fail(f"F3R {name} {turn}: Python calls of SpMVs "
                             f"{dict(cops.calls)}, want {dict(py)} (L3 not "
                             f"replayed)")

                # fp64 in two turns and the others in three (no eager
                # again): the cuts that make room for phases 9-12 (each
                # capture still holds the graphs to eager)
                runs = self.in_turns(lambda: f3r.solve(cops, b, cfg),
                                     f"F3R {name}", each, start,
                                     turns=TURNS[:2] if name == "fp64"
                                     else TURNS[:3], replays=1)
                x, info = runs["eager"][:2]
                rel = true_rel(x)
                cycles[name], x3[name], f3r_walls[name] = info.iters, x, runs
                inner = (layers["L3"] + layers["L4"]) / sum(layers.values())
                print(f"  F3R {name:8s} ({cfg.spmv_outer}/{cfg.spmv_mid}/"
                      f"{cfg.spmv_inner}): cycles {info.iters}, relres "
                      f"history {info.history[:info.iters + 1].tolist()}, "
                      f"true relres {rel!r}, walls {turn_walls(runs)}, SpMVs "
                      f"per layer {layers} (L3 + L4 share {inner!r}); "
                      f"captured runs: each L3 application (L4 inside) one "
                      f"graph replay and the host's least-squares solve, "
                      f"L2 and L1 eager around them (their preconditioner "
                      f"reads the host): Python calls of SpMVs in the "
                      f"capture run {self.seen[f'F3R {name} capture calls']}"
                      f", in the replay run "
                      f"{self.seen.get(f'F3R {name} replay calls')}; captured "
                      f"run's launches {self.seen[f'F3R {name}'][1]}",
                      flush=True)
                if not rel <= 5e-9:
                    fail(f"F3R {name}: true relres {rel} > 5e-9")
            dx = float(torch.linalg.vector_norm(x3["fp16"] - x3["packsell"])
                       / torch.linalg.vector_norm(x3["fp16"]))
            ratios = ", ".join(
                f"{t} {f3r_walls['fp16'][t][2] / f3r_walls['packsell'][t][2]!r}"
                for t in TURNS[:3])
            print(f"  FP16-F3R and PackSELL-F3R: cycles {cycles['fp16']} "
                  f"and {cycles['packsell']}, ||x_fp16 - x_packsell|| / "
                  f"||x_fp16|| {dx!r}; FP16-F3R / PackSELL-F3R walls: "
                  f"{ratios}", flush=True)
            if cycles["fp16"] != cycles["packsell"]:
                fail(f"FP16-F3R took {cycles['fp16']} cycles, PackSELL-F3R "
                     f"{cycles['packsell']}")

            # the paper's settings of m_in: eager, then the graphs' capture
            # and replay-only solves
            for m in (20, 50, 80):
                for name in ("fp32", "e8m8", "fp16"):
                    if (name, m) not in iocg_walls:
                        iocg_walls[name, m] = iocg_turns(
                            name, m, ("eager", "capture", "replay"),
                            replays=1)[1]
                    runs = iocg_walls[name, m]
                    print(f"  m_in {m:2d}, IO-CG {name:4s}: outer iterations "
                          f"{runs['eager'][1].iters}, walls eager "
                          f"{runs['eager'][2]!r} s, capture "
                          f"{runs['capture'][2]!r} s, replay "
                          f"{runs['replay'][2]!r} s; pcg_reference / IO-CG: "
                          f"eager {ref['eager'][2] / runs['eager'][2]!r}, "
                          f"replay {ref['replay'][2] / runs['replay'][2]!r}",
                          flush=True)

        # the e8m8 IO-CG again on the plain bodies, on the card
        plain = CountedOps(plain_twin(ops_k, ["fp64", "packsell_e8m8"]))
        before = self.counts()
        (xp, info_p), plain_s = wall(lambda: iocg.solve(
            plain, b, iocg.variant("e8m8", m_in=m_in)))
        dx = float(torch.linalg.vector_norm(xs["e8m8"] - xp)
                   / torch.linalg.vector_norm(xs["e8m8"]))
        print(f"  IO-CG e8m8 on the plain bodies (force='jnp'), captured: "
              f"outer iterations {info_p.iters}, wall {plain_s!r} s, "
              f"||x - x_plain|| / ||x|| {dx!r}, true relres "
              f"{true_rel(xp)!r}", flush=True)
        if self.counts() != before:
            fail("the plain IO-CG launched a kernel")
        if info_p.iters != iters["e8m8"]:
            fail(f"plain IO-CG e8m8 took {info_p.iters} outer iterations, "
                 f"the kernels {iters['e8m8']}")
        self.sync_free(a_s, ops_k, m_in)
        self.tri_solve(a_s)
        launches = self.counts()
        print(f"  launches in this run: {launches}", flush=True)
        path = {"K2", "K2-f64", *(PLAN_KERNEL[v] for v in variants.values())}
        for k in sorted(path):
            if launches[k] < 1:
                fail(f"{k} never launched in the solver phase")
        return launches

    def sync_free(self, a_s, ops_k, m_in):
        """The fp16, fp32 and fp64 matvecs, ``neumann_ainv`` and the
        fixed-iteration solvers applied under
        ``set_sync_debug_mode("error")``: the eager bodies, then (after a
        first application that captures them) their graph replays. Then
        the host syncs of one F3R L3 application
        (``set_sync_debug_mode("warn")``, counted), and the device's busy
        share of one IO-CG inner application and one F3R L2 application,
        eager and through the graphs (the profiler, phase 7's method)."""
        from repro_torch.solvers import graphs, precond
        from repro_torch.solvers.cg import pcg_fixed_iters
        from repro_torch.solvers.gmres import fgmres_fixed_cycles
        from repro_torch.solvers.richardson import richardson_fixed_iters

        diag = a_s.diagonal()
        r = torch.from_numpy(np.random.default_rng(17).standard_normal(
            a_s.shape[0])).to(self.dev)
        A = {k: ops_k.matvec(k) for k in ("fp64", "fp32", "fp16",
                                          "packsell_e8m8", "packsell_fp16")}
        M = {k: precond.neumann_ainv(diag, A[k], device=self.dev)
             for k in ("fp32", "packsell_e8m8", "packsell_fp16", "fp16")}
        apply = {
            "fp16 matvec": A["fp16"], "fp32 matvec": A["fp32"],
            "fp64 matvec": A["fp64"],
            "neumann_ainv packsell_e8m8": M["packsell_e8m8"],
            f"pcg_fixed_iters fp32, m_in {m_in}": pcg_fixed_iters(
                A["fp32"], M["fp32"], m_in),
            f"pcg_fixed_iters packsell_e8m8, m_in {m_in}": pcg_fixed_iters(
                A["packsell_e8m8"], M["packsell_e8m8"], m_in),
            "richardson_fixed_iters packsell_fp16, 4 iterations":
                richardson_fixed_iters(A["packsell_fp16"],
                                       M["packsell_fp16"], 4)}
        for what, fn in apply.items():
            for mode in ("eager", "graph replays"):
                ctx = graphs.eager() if mode == "eager" \
                    else contextlib.nullcontext()
                if mode != "eager":
                    fn(r)                   # warm-up and capture
                try:
                    with ctx, sync_debug("error"):
                        y = fn(r)
                except RuntimeError as e:
                    fail(f"{what} ({mode}) synchronised the host: {e}")
                if not bool(torch.isfinite(y).all()):
                    fail(f"{what} ({mode}): non-finite output")
            print(f"  {what}: no host sync under set_sync_debug_mode"
                  f"('error'), eager and in graph replays", flush=True)
        l4 = richardson_fixed_iters(A["fp16"], M["fp16"], 4)
        l3 = fgmres_fixed_cycles(A["fp16"], l4, m=5)
        l3(r)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with sync_debug("warn"):
                l3(r)
        syncs = [str(w.message).splitlines()[0] for w in caught
                 if "synchroniz" in str(w.message)]
        print(f"  one F3R L3 application (fgmres_fixed_cycles m 5 over L4, "
              f"fp16; a graph replay and the least-squares solve): "
              f"{len(syncs)} host syncs under set_sync_debug_mode('warn') "
              f"{sorted(set(syncs))}", flush=True)
        l2 = fgmres_fixed_cycles(A["fp32"], l3, m=10)
        l2p = fgmres_fixed_cycles(A["fp32"], fgmres_fixed_cycles(
            A["packsell_fp16"], richardson_fixed_iters(
                A["packsell_fp16"], M["packsell_fp16"], 4), m=5), m=10)
        for what, fn in ((f"one IO-CG inner application (pcg_fixed_iters "
                          f"fp32, m_in {m_in})", apply[
                              f"pcg_fixed_iters fp32, m_in {m_in}"]),
                         ("one F3R L2 application (fp16 preset)", l2),
                         ("one F3R L2 application (packsell preset)", l2p)):
            for mode in ("eager", "graphs"):
                with (graphs.eager() if mode == "eager"
                      else contextlib.nullcontext()):
                    fn(r)
                    wall_ms, kern = profiled(lambda: fn(r))
                busy = sum(k[0] for k in kern)
                if not kern:
                    print(f"  {what}, {mode}: device time not measured (the "
                          f"profiler saw no device events)", flush=True)
                    continue
                print(f"  {what}, {mode}: device busy {busy!r} ms of a "
                      f"{wall_ms!r} ms event wall (idle share "
                      f"{1 - busy / wall_ms!r}), {sum(k[1] for k in kern)} "
                      f"kernels; largest: "
                      f"{[(round(k[0], 4), k[1], k[2][:60]) for k in kern[:6]]}",
                      flush=True)

    def tri_solve(self, a_s):
        """The PackSELL triangular solve of ``tril(a_s)`` (e8m, D = 1, as
        the reference) in :data:`TURNS` against scipy's
        ``spsolve_triangular`` in float64, and RCM's bandwidths of
        ``a_s``."""
        import scipy.sparse as sp
        from scipy.sparse.linalg import spsolve_triangular

        from repro_torch.core import reorder, trisolve

        t0 = time.perf_counter()
        lo = sp.tril(a_s).tocsr()
        lo.sort_indices()
        solver = trisolve.PackSELLTriSolver(lo, lower=True, C=32, sigma=256,
                                            D=1, codec="e8m", device=self.dev,
                                            force=self.force_mixed)
        built = time.perf_counter() - t0
        mat = solver.mat
        print(f"  tril: nnz {lo.nnz}; PackSELL e8m/D1 strict factor built "
              f"in {built:.1f} s (host, n_levels included): buckets "
              f"{len(mat.packs)}, words {mat.words_bucketed}, dummies "
              f"{mat.n_dummy}; n_levels {solver.levels}; plan: "
              f"{solver.plan.policy}", flush=True)
        b_h = np.random.default_rng(19).standard_normal(a_s.shape[0])
        b = torch.from_numpy(b_h).to(self.dev)
        want = dict.fromkeys(self.counts(), 0)
        want[PLAN_KERNEL[solver.plan.variant]] = solver.levels

        def each(turn, x, info, launched):
            if launched != want:
                fail(f"the triangular solve's {solver.levels} SpMVs "
                     f"launched {launched} in the {turn} run "
                     f"({solver.plan.variant} plan), want {want}")

        runs = self.in_turns(lambda: (solver.solve(b), None),
                             "the triangular solve", each)
        x = runs["eager"][0]
        t0 = time.perf_counter()
        ref = spsolve_triangular(lo, b_h, lower=True)
        ref_s = time.perf_counter() - t0
        x_h = x.cpu().numpy().astype(np.float64)
        err = float(np.linalg.norm(x_h - ref) / np.linalg.norm(ref))
        print(f"  solve: {solver.levels} Jacobi steps (one graph), walls "
              f"{turn_walls(runs)}, launches per run {want}; "
              f"||x - x_scipy|| / ||x_scipy|| {err!r} (scipy "
              f"spsolve_triangular, float64, {ref_s:.1f} s on the host)",
              flush=True)
        if not err <= 1e-5:
            fail(f"triangular solve relative error {err} > 1e-5")
        t0 = time.perf_counter()
        ar, _ = reorder.rcm_reorder(a_s)
        print(f"  RCM: bandwidth {reorder.bandwidth(a_s)} before, "
              f"{reorder.bandwidth(ar)} after ({time.perf_counter() - t0:.1f}"
              f" s on the host)", flush=True)

    # -- phase 9: the composite ----------------------------------------------
    def composite_path(self, a_s):
        """``MixedPackSELL`` over a hand-made three-class split of ``a_s``
        (its rows in contiguous thirds: fp16/D15 through K1, e8m/D8 through
        K4, fp32 through K2): one matvec and one SpMM (nb = 8) against the plain
        twin (every member's kernel's plain version, the same gather),
        their launches and device ops, Jacobi-PCG on it through
        ``cg.pcg``'s graphs in :data:`TURNS` and on the plain twin, and its
        device time against its members' kernels and its byte bound. Then
        the ``mixed:1e-3`` kind on a row-scaled scattered matrix through a
        precision store: a miss, a hit, and retile winners under
        ``@cuda``."""
        import os
        import tempfile

        from repro_torch.core import testmats
        from repro_torch.kernels import ref as kref
        from repro_torch.precision import PrecisionClass, PrecisionPlan
        from repro_torch.precision.mixed import MixedPackSELL
        from repro_torch.precision.store import (PrecisionStore,
                                                 matrix_fingerprint)
        from repro_torch.solvers import cg
        from repro_torch.solvers.operators import OperatorSet, row_scale

        n = a_s.shape[0]
        rows = np.arange(n)
        t0 = time.perf_counter()
        # by hand: the selector gives HPCG one class (e8m/D8 at 1e-3). In
        # thirds, not by row % 3: a class of every third row has columns
        # that run 3x faster than its rows, and at 104^3 its fused stream's
        # offsets overflow every compact encoding, so fp16/D15 would run
        # K4, not K1. The first third keeps the matrix's own band.
        thirds = np.array_split(rows, 3)
        pplan = PrecisionPlan(mode="rows", classes=tuple(
            PrecisionClass(c, D, tuple(r.tolist())) for r, (c, D) in zip(
                thirds, (("fp16", 15), ("e8m", 8), ("fp32", 0)))),
            error_budget=1e-3, rationale={"classes": "thirds, by hand"})
        mixed = MixedPackSELL(a_s, pplan, C=32, sigma=256, device=self.dev,
                              force=["fused", "full", "auto"])
        built = time.perf_counter() - t0
        m16, m8, m32 = mixed.blocks
        variants = [m16.plan.variant, m8.plan.variant, m32.fmt]
        buckets = len(m32.mat.vals)
        print(f"  three classes (contiguous thirds of the rows) of HPCG "
              f"{self.main_side}^3 built in "
              f"{built:.1f} s (host): {[b.label for b in mixed.blocks]}, "
              f"plans {variants}, SELL buckets {buckets}; memory "
              f"{mixed.memory_stats()['bytes_per_nnz']!r} B/nnz", flush=True)
        if variants != ["fused", "full", "sell"]:
            fail(f"composite member variants {variants}")
        rng = np.random.default_rng(21)
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
            self.dev)
        X = torch.from_numpy(rng.standard_normal((n, 8)).astype(
            np.float32)).to(self.dev)

        self.zero_counts()
        per = {"spmv": ({"K1": 1, "K4": 1, "K2": buckets}, lambda: mixed.spmv(x),
                        lambda: kref.composite_plain(mixed.cplan, x)),
               "spmm nb=8": ({"K3": 1, "K5": 1, "K2": 8 * buckets},
                             lambda: mixed.spmm(X),
                             lambda: kref.composite_plain(
                                 mixed.cplan, X, multi_rhs=True))}
        for what, (want, run, plain) in per.items():
            before = self.counts()
            out = run()
            got = {k: v - before[k] for k, v in self.counts().items()
                   if v != before[k]}
            if got != want:
                fail(f"composite {what} launched {got}, want {want}")
            before = self.counts()
            self.note("K1" if what == "spmv" else "K3",
                      same_bits(out, plain(), f"composite {what} vs its "
                                "plain twin"))
            if self.counts() != before:
                fail(f"the plain twin of the composite {what} launched a "
                     "kernel")
            print(f"  composite {what}: launches {got}, bit-equal to the "
                  "plain twin (each member's kernel's plain version, the "
                  "same gather)", flush=True)
        with sync_debug("error"):
            mixed.spmv(x)
            mixed.spmm(X)
        print("  composite spmv and spmm under set_sync_debug_mode('error'): "
              "no host sync", flush=True)

        # Jacobi-PCG on the composite, eager and through cg.pcg's graphs
        b = torch.ones(n, dtype=torch.float64, device=self.dev)
        dinv = 1.0 / torch.from_numpy(a_s.diagonal()).to(self.dev)
        M = lambda r: r * dinv                              # noqa: E731
        per_mv = {"K1": 1, "K4": 1, "K2": buckets}

        def each(turn, xs, info, launched):
            steps = info.iters if turn.startswith("eager") else \
                chunk_steps(info.iters, cg.PCG_CHUNK)
            want = {k: v * (steps + 1) for k, v in per_mv.items()}
            got = {k: launched[k] for k in per_mv}
            if got != want:
                fail(f"composite Jacobi-PCG {turn}: launches {got}, want "
                     f"{want}")

        cache = {}
        runs = self.in_turns(lambda: cg.pcg(
            mixed.spmv, b, M=M, tol=1e-8, maxiter=500, jit_cache=cache,
            jit_key="composite"), "composite Jacobi-PCG", each)
        xk, info = runs["capture"][:2]
        launches = self.counts()
        (xp, info_p), plain_s = wall(lambda: cg.pcg(
            lambda v: kref.composite_plain(mixed.cplan, v), b, M=M,
            tol=1e-8, maxiter=500))
        true_rel = float(np.linalg.norm(1.0 - a_s @ xk.cpu().numpy())
                         / np.sqrt(n))
        print(f"  Jacobi-PCG on the composite (tol 1e-8, maxiter 500): "
              f"iterations {info.iters}, recurrence relres "
              f"{float(info.relres)!r}, true relres vs s {true_rel!r} (the "
              f"rows at three precisions make the operator slightly "
              f"nonsymmetric: 1e-8 is reported, not required); walls "
              f"{turn_walls(runs)}; plain twin {info_p.iters} iterations, "
              f"relres {float(info_p.relres)!r}, wall {plain_s!r} s",
              flush=True)
        if (info_p.iters, float(info_p.relres)) != (info.iters,
                                                    float(info.relres)):
            fail("the composite's Jacobi-PCG and its plain twin's differ")
        same_bits(xp, xk, "composite Jacobi-PCG vs its plain twin")
        print(f"  launches in this run: {launches}", flush=True)

        # its device time against its members' kernels and its bound
        reps = self.reps
        t_all = device_ms(lambda: mixed.spmv(x), reps)
        w16, ck16 = m16.plan.fused
        lay = m16.plan.fused_layout
        kw16 = dict(codec_name="fp16", D=15, encoding=lay.encoding,
                    scale=lay.scale)
        p8 = m8.plan
        parts = {
            "K1": device_ms(lambda: self.k1(w16, ck16, x, **kw16), reps),
            "K4": device_ms(lambda: self.k4(
                m8.mat.packs, m8.mat.d0s, p8.kckpts, p8.ktable, x,
                codec_name="e8m", D=8), reps),
            "K2": device_ms(lambda: [self.k2(v, c, x) for v, c in zip(
                m32.mat.vals, m32.mat.cols)], reps)}
        ent32 = sum(v.numel() for v in m32.mat.vals)
        words = w16.numel() + sum(p.numel() for p in m8.mat.packs)
        nbytes = (4 * (w16.numel() + ck16.numel())
                  + 4 * sum(p.numel() + d.numel() for p, d in
                            zip(m8.mat.packs, m8.mat.d0s))
                  + 8 * ent32 + 4 * n + 4 * n + 4 * n)
        tb, by = bound_ms(nbytes, 2 * (words + ent32))
        before = self.raw_counts()
        ops_aten = aten_ops(lambda: mixed.spmv(x))
        ours = {k: v - before[k] for k, v in self.raw_counts().items()
                if v != before[k]}
        n_ops = sum(ours.values()) + len(ops_aten)
        _, kern = profiled(lambda: mixed.spmv(x))
        print(f"  one composite matvec: {t_all!r} ms on the device (a CUDA "
              f"graph of {reps} calls), its members' kernels alone "
              f"{parts} (sum {sum(parts.values())!r} ms), bound "
              f"{tb!r} ms by {by} ({nbytes} B: the members' operands, x, "
              f"the inverse and y once); {t_all / tb!r} x the bound; on "
              f"{card_line()}", flush=True)
        print(f"  its device ops (one matvec, counted on the host): {n_ops}: "
              f"the kernels {ours} and the aten ops {ops_aten}; "
              f"torch.profiler saw {sum(c for _, c, _ in kern)} kernels "
              f"{[(c, nm[:60]) for _, c, nm in kern]}", flush=True)

        # the mixed: kind through a precision store, on a scattered matrix
        t0 = time.perf_counter()
        sc, _ = row_scale(testmats.scattered(1_048_576, nnz_per_row=17))
        sc = sc.tocsr()
        gen_s = time.perf_counter() - t0
        x2 = torch.from_numpy(rng.standard_normal(sc.shape[1]).astype(
            np.float32)).to(self.dev)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "store.json")
            (p_miss, hit), miss_s = wall(lambda: PrecisionStore(
                path).lookup_or_select(sc, 1e-3, mode="rows", sigma=256))
            if hit:
                fail("an empty store hit")
            (p_hit, hit), hit_s = wall(lambda: PrecisionStore(
                path).lookup_or_select(sc, 1e-3, mode="rows", sigma=256))
            if not hit or p_hit.to_dict() != p_miss.to_dict():
                fail("the store did not hit its own selection")
            ops2 = OperatorSet(sc, C=32, sigma=256, device=self.dev,
                               store=path)
            mv, build_s = wall(lambda: ops2.matvec("mixed:1e-3"))
            mix2 = ops2.stored("mixed:1e-3")
            classes = [(c.codec, c.D, c.n_rows()) for c in p_hit.classes]
            plans = [None if m.plan is None else m.plan.variant
                     for m in mix2.blocks]
            print(f"  mixed:1e-3 on row-scaled scattered(1048576, 17): "
                  f"n={sc.shape[0]} nnz={sc.nnz} (generated in {gen_s:.1f} "
                  f"s); classes {classes}, plans {plans}; store miss (the "
                  f"selection) {miss_s!r} s, hit {hit_s!r} s, operator "
                  f"built from the hit in {build_s!r} s (host)", flush=True)
            y2 = mv(x2)
            same_bits(y2, kref.composite_plain(mix2.cplan, x2),
                      "mixed:1e-3 vs its plain twin")
            # retile winners under @cuda, applied to one member's plan
            i = next((i for i, m in enumerate(mix2.blocks)
                      if m.plan is not None and m.plan.variant in
                      ("full", "band")), 0)
            mem = mix2.blocks[i]
            tiles = [(4, 16)] * len(mem.plan.tiles)
            if mem.plan.variant not in ("full", "band"):
                wr = 16 if mem.plan.fused_layout.wr != 16 else 32
                tiles = [(8, 32, wr)] * len(mem.plan.tiles)
            fp = matrix_fingerprint(sc)
            store = PrecisionStore(path)
            store.put_retile(fp, f"mixed:1e-3/{i}", tiles,
                             backend=mem.plan.device)
            if not PrecisionStore(path).apply_retile(fp, f"mixed:1e-3/{i}",
                                                     mem.plan):
                fail("apply_retile did not apply the winners stored under "
                     f"@{mem.plan.device.type}")
            keys = sorted(PrecisionStore(path)._entries[fp]["retile"])
            y3 = mv(x2)
            same_bits(y3, kref.composite_plain(mix2.cplan, x2),
                      "the retiled mixed:1e-3 vs its plain twin")
            print(f"  retile under {keys}: member {i} ({mem.label}, "
                  f"{mem.plan.variant}) now {mem.plan.tiles[0]}"
                  f"{'' if mem.plan.fused_layout is None else ', wr ' + str(mem.plan.fused_layout.wr)}; "
                  f"y bit-equal to its plain twin; |y - y_before| max "
                  f"{max_abs(y3, y2)!r}", flush=True)
        # the suite's scattered_like, where the selector splits the rows
        sl_, _ = row_scale(testmats.suite("small")["scattered_like"])
        ops3 = OperatorSet(sl_.tocsr(), C=32, sigma=256, device=self.dev)
        mv3 = ops3.matvec("mixed:1e-3")
        mix3 = ops3.stored("mixed:1e-3")
        x3 = torch.from_numpy(rng.standard_normal(sl_.shape[1]).astype(
            np.float32)).to(self.dev)
        same_bits(mv3(x3), kref.composite_plain(mix3.cplan, x3),
                  "mixed:1e-3 on scattered_like vs its plain twin")
        print(f"  mixed:1e-3 on row-scaled scattered_like (n={sl_.shape[0]}): "
              f"classes {[(b.label, len(b.rows)) for b in mix3.blocks]}, "
              f"plans {[b.plan.variant for b in mix3.blocks]}; y bit-equal "
              "to its plain twin", flush=True)
        if len(mix3.blocks) < 2:
            fail("mixed:1e-3 on scattered_like gave one class")
        return dict(mixed=mixed, launches=launches, x=x)

    # -- phase 10: the guards ------------------------------------------------
    def guard_path(self, mp, mx, cp):
        """The ABFT guard on ``plan_fp16`` (K1) and ``plan_e8m8`` (K4): its
        build wall, full and light device time against ``plan.spmv``;
        every ported injector over 5 seeds (the composite's on phase 9's
        composite); an injection reaching a Jacobi-PCG graph captured
        before it; ``guarded_solve`` clean and with a fault at outer step
        2."""
        from repro_torch.robust import guard as gd
        from repro_torch.robust import inject
        from repro_torch.robust import recover
        from repro_torch.solvers import cg

        s = mp["a"]
        n = s.shape[0]
        pairs = {"plan_fp16": (mp["mat"], mp["plan"]),
                 "plan_e8m8": mx["ops"].plan_pair("plan_e8m8")}
        rng = np.random.default_rng(23)
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
            self.dev)
        self.zero_counts()
        guards, clean = {}, {}
        for kind, (mat, plan) in pairs.items():
            gs, build_s = wall(lambda: gd.build_guard(mat, plan))
            guards[kind] = gs
            y, ok, rel = gd.guarded_spmv(mat, plan, gs, x, full=True)
            _, ok_l, _ = gd.guarded_spmv(mat, plan, gs, x, full=False)
            if not (bool(ok) and bool(ok_l)):
                fail(f"the guard tripped on a clean {kind} matvec")
            same_bits(y, plan.spmv(mat, x), f"guarded {kind} y vs plan.spmv")
            clean[kind] = y
            print(f"  {kind} ({PLAN_KERNEL[plan.variant]}): build_guard "
                  f"{build_s!r} s (host: column sums and the operand "
                  f"checksum over {sum(t.numel() for t in gd.guard_arrays(mat, plan))} "
                  f"words); clean calls pass, full and light; analytic "
                  f"rel_err {float(rel)!r}", flush=True)

        # every ported injector, 5 seeds each
        fused, full = pairs["plan_fp16"], pairs["plan_e8m8"]
        cases = [("flip_fused_word", fused, "plan_fp16"),
                 ("corrupt_fused_checkpoint", fused, "plan_fp16"),
                 ("corrupt_permutation", fused, "plan_fp16"),
                 ("flip_pack_word", full, "plan_e8m8"),
                 ("corrupt_permutation", full, "plan_e8m8")]
        tally = {}
        for name, (mat, plan), kind in cases:
            gs = guards[kind]
            t = tally[f"{name} on {kind}"] = collections.Counter()
            for seed in range(5):
                inj = getattr(inject, name)(mat, plan, seed)
                y, ok, _ = gd.guarded_spmv(mat, plan, gs, x, full=True)
                tripped = not bool(ok)
                changed = not torch.equal(y, clean[kind])
                t["neutral" if inj.value_neutral else "affecting"] += 1
                t["tripped"] += tripped
                t["y changed"] += changed
                if not inj.value_neutral and not tripped:
                    fail(f"{name} seed {seed} on {kind}: value-affecting "
                         f"({inj.detail}) and the guard passed")
                if inj.value_neutral and changed:
                    fail(f"{name} seed {seed} on {kind}: value-neutral and y "
                         "changed")
                inj.undo()
                y, ok, _ = gd.guarded_spmv(mat, plan, gs, x, full=True)
                if not bool(ok):
                    fail(f"{name} seed {seed}: the guard trips after undo()")
                same_bits(y, clean[kind], f"{name} seed {seed}: y after "
                          "undo()")
        for kind, (mat, plan) in pairs.items():
            t = tally[f"poison_x on {kind}"] = collections.Counter()
            for seed in range(5):
                for mode in ("nan", "inf"):
                    xp, _ = inject.poison_x(x, seed, mode)
                    t["affecting"] += 1
                    for full_ in (True, False):
                        _, ok, _ = gd.guarded_spmv(mat, plan, guards[kind],
                                                   xp, full=full_)
                        if bool(ok):
                            fail(f"poison_x {mode} seed {seed}: the "
                                 f"{'full' if full_ else 'light'} guard "
                                 f"passed on {kind}")
                    t["tripped"] += 1
        mixed = cp["mixed"]
        y0 = mixed.spmv(cp["x"])
        for member in (0, 1):
            mem = mixed.cplan.members[member]
            ref = [int(v) for v in gd._checksum_torch(
                gd.guard_arrays(mem.mat, mem.plan))]
            t = tally[f"corrupt_composite_word, member {member} "
                      f"({mem.label}, {mem.plan.variant})"] = \
                collections.Counter()
            for seed in range(5):
                inj = inject.corrupt_composite_word(mixed.cplan, member, seed)
                got = [int(v) for v in gd._checksum_torch(
                    gd.guard_arrays(mem.mat, mem.plan))]
                y = mixed.spmv(cp["x"])
                t["neutral" if inj.value_neutral else "affecting"] += 1
                t["tripped"] += got != ref
                t["y changed"] += not torch.equal(y, y0)
                if got == ref:
                    fail(f"composite member {member} seed {seed}: the "
                         "checksum missed the injection")
                if inj.value_neutral and not torch.equal(y, y0):
                    fail(f"composite member {member} seed {seed}: "
                         "value-neutral and y changed")
                inj.undo()
                same_bits(mixed.spmv(cp["x"]), y0, f"composite member "
                          f"{member} seed {seed}: y after undo()")
        for what, t in tally.items():
            print(f"  {what}: {dict(t)}", flush=True)
        print("  (the exact operand checksum sees every operand change, "
              "value-neutral ones included, as the reference's does; "
              "value-neutral ones leave y bit-equal)", flush=True)

        # an injection reaches a Jacobi-PCG graph captured before it
        mat, plan = fused
        diag = s.diagonal()
        b = torch.ones(n, dtype=torch.float64, device=self.dev)
        x_clean, i_clean = cg.jacobi_pcg_stored(mat, plan, diag, b, tol=1e-8,
                                                maxiter=2000)
        loop = next(v for ent in plan._fns.values()
                    if isinstance(ent, tuple) for v in ent[2].values()
                    if (v.tol, v.maxiter) == (1e-8, 2000))
        replays, captured = loop.graph.replays, loop.graph.graph
        inj = next(i for i in (inject.flip_fused_word(mat, plan, sd, bit=27)
                               for sd in range(100))
                   if not i.value_neutral or i.undo())
        x_bad, i_bad = cg.jacobi_pcg_stored(mat, plan, diag, b, tol=1e-8,
                                            maxiter=2000)
        inj.undo()
        x_again, i_again = cg.jacobi_pcg_stored(mat, plan, diag, b, tol=1e-8,
                                                maxiter=2000)
        if loop.graph.graph is not captured or loop.graph.replays <= replays:
            fail("the Jacobi-PCG graph was captured again")
        if torch.equal(x_bad, x_clean):
            fail("an in-place injection did not reach the captured graph")
        same_bits(x_again, x_clean, "Jacobi-PCG replay after undo()")
        print(f"  Jacobi-PCG graph captured in phase 4, replayed "
              f"{loop.graph.replays - replays} times here: clean "
              f"{i_clean.iters} iterations; with {inj.detail} in place "
              f"{i_bad.iters} iterations, ||x - x_clean|| / ||x_clean|| "
              f"{float(torch.linalg.vector_norm(x_bad - x_clean) / torch.linalg.vector_norm(x_clean))!r}; "
              "after undo() the clean x bit for bit", flush=True)

        # guarded_solve, clean and with a fault at outer step 2, on phase 5's
        # operators (its e8m/D8 tier is the promotion's, already built)
        ops4 = mx["ops"]
        b_h = np.ones(n)

        def true_rel(xs):
            return float(np.linalg.norm(b_h - s @ xs) / np.linalg.norm(b_h))

        # m_in 50, not the default 16: at 16 inner iterations each outer
        # step cuts the true residual of this system by only about 0.74, so
        # the default 60 steps end near 1e-8; at 50, about 14 steps reach
        # 1e-9 (the history printed below shows the rate)
        kw = dict(tol=1e-9, m_in=50)
        (xs, info), clean_s = wall(lambda: recover.guarded_solve(
            ops4, "guarded:plan_fp16", b_h, **kw))
        rel = true_rel(xs)
        rates = info.history[1:] / info.history[:-1]
        print(f"  guarded_solve (b = ones, tol 1e-9, m_in 50) clean: "
              f"{info.iters} outer steps, trips "
              f"{info.trips}, final_kind {info.final_kind}, true relres "
              f"{rel!r}, wall {clean_s!r} s; true relres per step "
              f"{info.history.tolist()}, its ratio per step: median "
              f"{float(np.median(rates))!r}", flush=True)
        if info.trips or not rel <= 1e-9:
            fail("the clean guarded_solve tripped or missed 1e-9")
        fired = []

        def sabotage(step, ctx):
            if step == 2 and not fired:
                flip = (inject.flip_fused_word if ctx["plan"].fused is not None
                        else inject.flip_pack_word)
                fired.append(next(
                    i for i in (flip(ctx["mat"], ctx["plan"], sd, bit=27)
                                for sd in range(100))
                    if not i.value_neutral or i.undo()))

        try:
            (xs, info), fault_s = wall(lambda: recover.guarded_solve(
                ops4, "guarded:plan_fp16", b_h, on_step=sabotage, **kw))
        finally:
            for i in fired:
                i.undo()
            for k in ("plan_fp16", "plan_e8m8"):
                ops4.plan_pair(k)[1]._unhealthy = None
        rel = true_rel(xs)
        events = [(e["event"], e["action"]) for e in info.log]
        print(f"  guarded_solve, {fired[0].detail} flipped in place at "
              f"outer step 2: {info.iters} accepted steps, trips "
              f"{info.trips}, final_kind {info.final_kind}, true relres "
              f"{rel!r}, wall {fault_s!r} s; log {info.log}", flush=True)
        if events != [("guard_trip", "retry"), ("guard_trip", "promote")]:
            fail(f"guarded_solve's log {events}, want the reference policy's "
                 "retry then promote")
        if not rel <= 1e-9:
            fail(f"guarded_solve after the fault: true relres {rel}")
        launches = self.counts()
        print(f"  launches in this run: {launches}", flush=True)

        # the guard's cost per matvec, on the device
        rows = {}
        for kind, (mat, plan) in pairs.items():
            gs, reps = guards[kind], self.reps
            rows[kind] = {
                "plan.spmv": device_ms(lambda: plan.spmv(mat, x), reps),
                "guarded full": device_ms(lambda: gd.guarded_spmv(
                    mat, plan, gs, x, full=True), reps),
                "guarded light": device_ms(lambda: gd.guarded_spmv(
                    mat, plan, gs, x, full=False), reps),
                "checksum alone": device_ms(lambda: gd._checksum_torch(
                    gd.guard_arrays(mat, plan)), reps)}
            r = rows[kind]
            print(f"  {kind}: device ms per call {r}; full guard "
                  f"{r['guarded full'] / r['plan.spmv']!r} x the matvec, "
                  f"light {r['guarded light'] / r['plan.spmv']!r} x; on "
                  f"{card_line()}", flush=True)
        return dict(launches=launches, rows=rows)


    # -- phase 11: the recorder on the card ----------------------------------
    def recorder_path(self, mp, mx, k1_ms):
        """The flight recorder on phase 4's and phase 5's operators: the
        graph-run fp16 Jacobi-PCG and ``adaptive_pcg`` with ``REPRO_OBS``
        off and on (the same bits, the solve counters against ``info`` and
        the launches ``graphs.LEDGER`` counted), an eager ``plan.spmv`` and
        a graph replay under ``set_sync_debug_mode("error")`` off and on,
        the host µs the recorder adds per eager ``plan.spmv``,
        ``profile_dispatch`` of ``plan.spmv`` (K1 must land in
        ``packsell.fused_kernel``), and the Prometheus text and one JSONL
        flush written under ``build/obs/`` and read back."""
        from statistics import median

        from repro_torch import observe
        from repro_torch.observe import export, profile
        from repro_torch.solvers import cg, graphs

        mat, plan, s = mp["mat"], mp["plan"], mp["a"]
        n = s.shape[0]
        diag = s.diagonal()
        b = torch.ones(n, dtype=torch.float64, device=self.dev)
        self.zero_counts()
        prev = observe.enable(False)
        try:
            def run(label, fn, on):
                observe.enable(on)
                observe.reset()
                before, rep0 = self.counts(), graphs.LEDGER.replays
                (x, info), sec = wall(fn)
                launched = {k: v - before[k]
                            for k, v in self.counts().items()}
                snap = observe.report()
                if snap["graphs"]["replays"] != graphs.LEDGER.replays:
                    fail("report() does not carry the ledger's replays")
                print(f"  {label}, recorder {'on' if on else 'off'}: "
                      f"{info.iters} iterations, wall {sec!r} s, launches "
                      f"{ {k: v for k, v in launched.items() if v} }, graph "
                      f"replays {graphs.LEDGER.replays - rep0}", flush=True)
                return x, info, launched, snap

            def solve_counters(snap, name, path, info):
                c = snap["counters"]
                key = f"{{path={path},solver={name}}}"
                got = (c.get("solver.solves" + key),
                       c.get("solver.iters" + key))
                if got != (1, info.iters):
                    fail(f"{name}: solver.solves/iters {got}, want "
                         f"(1, {info.iters})")
                disp = {k: v for k, v in c.items()
                        if k.startswith("spmv.dispatch")}
                if disp:
                    fail(f"{name}: a cached solve is one dispatch, yet "
                         f"spmv.dispatch recorded {disp}")

            jp = lambda: cg.jacobi_pcg_stored(                # noqa: E731
                mat, plan, diag, b, tol=1e-8, maxiter=2000)
            out = [run("fp16 Jacobi-PCG (graphs)", jp, on)
                   for on in (False, True, False)]
            for x, info, launched, _ in out:
                same_bits(x, out[0][0], "Jacobi-PCG x, recorder on vs off")
                steps = chunk_steps(info.iters, cg.PCG_CHUNK)
                if info.iters != out[0][1].iters or \
                        launched["K1"] != steps + 1:
                    fail(f"Jacobi-PCG: {info.iters} iterations, K1 "
                         f"{launched['K1']} (want steps + 1 = {steps + 1})")
            solve_counters(out[1][3], "jacobi_pcg_stored", "fused",
                           out[1][1])

            ops_k = mx["ops"]
            tiers, _, _, hi = ops_k.adaptive_tiers(1e-3, n_probes=2)
            dg = torch.as_tensor(diag, device=self.dev)
            dinv = torch.where(dg == 0, torch.ones_like(dg), 1.0 / dg)
            rng = np.random.default_rng(0)
            bb = torch.from_numpy(rng.standard_normal(n)).to(self.dev)
            cache = {}
            ap = lambda: cg.adaptive_pcg(                     # noqa: E731
                tiers, bb, M=lambda r: r * dinv, matvec_hi=hi, tol=1e-8,
                maxiter=60, m_in=16, jit_cache=cache, jit_key="p11")
            aout = [run("adaptive_pcg (graphs; the first run captures)", ap,
                        on) for on in (False, True, False)]
            for x, info, _, _ in aout:
                same_bits(x, aout[0][0], "adaptive_pcg x, recorder on vs off")
                if info.iters != aout[0][1].iters or not torch.equal(
                        info.tier_history, aout[0][1].tier_history):
                    fail("adaptive_pcg: the schedule moved with the recorder")
            solve_counters(aout[1][3], "adaptive_pcg", "jit_cache",
                           aout[1][1])
            print(f"  recorder on: solver.solves and solver.iters equal "
                  f"info (1 solve, {out[1][1].iters} and {aout[1][1].iters} "
                  f"iterations); no spmv.dispatch inside a cached solve, "
                  f"which ran {out[1][2]['K1']} K1 and "
                  f"{aout[1][2]['K4']} K4 launches by the ledger", flush=True)

            # no sync, recorder off and on: an eager spmv and a replay
            x32 = b.float()
            sc = {}
            cg.pcg(lambda v: plan.spmv(mat, v), b, tol=1e-8, maxiter=64,
                   jit_cache=sc, jit_key="p11-sync")
            loop = next(iter(sc.values()))
            for on in (False, True):
                observe.enable(on)
                observe.reset()
                plan.spmv(mat, x32)            # the record is built once
                with sync_debug("error"):
                    plan.spmv(mat, x32)
                    loop.graph()
                disp = sum(v for k, v in observe.snapshot()["counters"]
                           .items() if k.startswith("spmv.dispatch"))
                if disp != (2 if on else 0):
                    fail(f"spmv.dispatch {disp} after 2 eager calls, "
                         f"recorder {'on' if on else 'off'}")
            print("  set_sync_debug_mode('error'): an eager plan.spmv and a "
                  "graph replay make no sync, recorder off and on",
                  flush=True)

            # the host µs the recorder adds per eager plan.spmv: 100 calls
            # enqueued after a sync (the device does not hold the host
            # back), median of 15 rounds, in turns off, on, on, off
            def host_us(on) -> float:
                observe.enable(on)
                per = []
                for _ in range(15):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(100):
                        plan.spmv(mat, x32)
                    per.append((time.perf_counter() - t0) / 100 * 1e6)
                torch.cuda.synchronize()
                return median(per)

            us = [(on, host_us(on)) for on in (False, True, True, False) * 3]
            off_us = median(u for on, u in us if not on)
            on_us = median(u for on, u in us if on)
            print(f"  host µs per eager plan.spmv (enqueue, median of 15 x "
                  f"100 calls), turns (off/on/on/off) x 3: "
                  f"{[round(u, 3) for _, u in us]}; the recorder adds "
                  f"{on_us - off_us!r} µs ({on_us!r} against {off_us!r})",
                  flush=True)

            # span attribution
            prof = profile.profile_dispatch(lambda v: plan.spmv(mat, v), x32,
                                            repeats=10, device=self.dev)
            if prof.profiler_unavailable:
                fail("profile_dispatch: profiler unavailable on the card")
            if any("fused_kernel" in u["op"] for u in prof.unattributed):
                fail(f"K1 landed in unattributed: {prof.unattributed}")
            if prof.spans.get("packsell.fused_kernel", {}).get(
                    "device_s", 0) <= 0:
                fail(f"no device time in packsell.fused_kernel: "
                     f"{prof.spans}")
            for name, sp in prof.spans.items():
                print(f"  profile_dispatch(plan.spmv): {name}: device "
                      f"{sp['device_s'] * 1e3!r} ms per call, host "
                      f"{sp['host_s'] * 1e3!r} ms, {sp['ops']} kernels",
                      flush=True)
            print(f"  unattributed (top by device time): "
                  f"{[(u['op'][:60], u['device_s'] * 1e3) for u in prof.unattributed]}; "
                  f"device total {prof.device_total_s * 1e3!r} ms, wall "
                  f"{prof.wall_s * 1e3!r} ms, attributed share "
                  f"{prof.attributed_frac!r}; phase 6's K1 (CUDA graph of "
                  f"50 calls): {k1_ms!r} ms; on {card_line()}", flush=True)

            # the exporters, written under build/obs and read back
            observe.enable(True)
            odir = Path(__file__).resolve().parent / "build" / "obs"
            odir.mkdir(parents=True, exist_ok=True)
            prom, jsonl = odir / "phase11.prom", odir / "phase11.jsonl"
            for p in (prom, jsonl):
                p.unlink(missing_ok=True)
            raw = observe.raw_snapshot()
            prom.write_text(export.prometheus_text(raw))
            back = export.parse_prometheus_text(prom.read_text())
            hist_f = ("p50", "p95", "p99", "count", "sum", "min", "max",
                      "last")
            if back["counters"] != raw["counters"] or \
                    back["gauges"] != raw["gauges"] or \
                    back["histograms"] != {k: {f: h[f] for f in hist_f}
                                           for k, h in
                                           raw["histograms"].items()}:
                fail("the Prometheus text does not parse back equal")
            export.JsonlSink(str(jsonl)).flush()
            recs = export.JsonlSink.read(str(jsonl))
            want = {k: v for k, v in observe.snapshot()["counters"].items()
                    if v}
            if recs[0]["kind"] != "meta" \
                    or recs[0]["backend"] != self.dev.type \
                    or recs[1]["counters"] != want:
                fail(f"the JSONL flush does not read back: {recs[:2]}")
            print(f"  {prom.relative_to(odir.parents[1])} "
                  f"({len(raw['counters'])} counters, "
                  f"{len(raw['gauges'])} gauges, {len(raw['histograms'])} "
                  f"histograms) and one {jsonl.name} flush (meta: "
                  f"{recs[0]['device']}, torch {recs[0]['torch_version']}) "
                  f"read back equal", flush=True)
        finally:
            observe.enable(prev)
            observe.reset()
        launches = self.counts()
        print(f"  launches in this run: {launches}", flush=True)
        return dict(launches=launches)

    # -- phase 12: the serving front end on the card -------------------------
    def serving_path(self, mp, seed: int = 0):
        """``ServingFrontend`` at the reference's defaults (4 slots, the
        default ladder and classes, the background worker, C = 32, σ = 64,
        the full guard on every slot) on phase 4's HPCG 104³ matrix: the
        warmup; steady traffic (96 spmv requests, a third per class, in
        bursts of 12, then one solve); an overload burst under
        ``AdmissionPolicy(max_queue=32)``; a flipped word in
        ``plan_fp16``'s stream while interactive traffic flows. Every ok
        response is held to its tier's error budget against the fp64 host
        product, 8 per tier to the tier's single matvec bit for bit, the
        solve to ``guarded_solve`` called directly, and each slot to one
        K3 (fused tiers) or K5 (``plan_e8m4``) launch."""
        import dataclasses
        from statistics import median

        from repro_torch import observe
        from repro_torch.robust import guard as gd
        from repro_torch.robust import inject, recover
        from repro_torch.serving import frontend as fe
        from repro_torch.serving import policy as pol

        s = mp["a"]
        n, m = s.shape
        s64 = s.astype(np.float64).tocsr()
        anorm = float(np.abs(s64).sum(axis=1).max())
        rng = np.random.default_rng(seed)
        classes = ("interactive", "standard", "batch")
        self.zero_counts()
        prev = observe.enable(True)
        observe.reset()
        cfg = fe.FrontendConfig(device=self.dev)
        print(f"  FrontendConfig: slots {cfg.slots}, ladder {cfg.ladder}, "
              f"classes {[(c.name, c.tier, c.deadline_s) for c in cfg.classes]}, "
              f"background {cfg.background}, C {cfg.C}, sigma {cfg.sigma}, "
              f"guard_every {cfg.guard_every}, admission limit "
              f"{cfg.admission._limit()} words (None: no limit; (m + n) x "
              f"slots = {(m + n) * cfg.slots})", flush=True)

        def budget_ok(reqs):
            """The chaos harness's contract: every ok spmv response within
            its tier's budget (safety 16) of the fp64 host product."""
            ok = [r for r in reqs if r.ok and r.op == "spmv"]
            if not ok:
                return 0
            X = np.stack([np.asarray(r.x, np.float64) for r in ok], 1)
            exact = s64 @ X
            for j, r in enumerate(ok):
                kind = ("fp32" if r.tier_kind == "fp32_fallback"
                        else r.tier_kind)
                bud = pol.tier_error_budget(kind, safety=16.0)
                err = float(np.abs(r.y - exact[:, j]).max())
                if not err <= bud * anorm * float(np.abs(X[:, j]).max()):
                    fail(f"request {r.uid} ({r.tier_kind}) out of budget: "
                         f"{err}")
            return len(ok)

        def drop_payloads(reqs):
            for r in reqs:
                r.x = r.y = None

        def tiers_of(reqs):
            return dict(collections.Counter(r.tier_kind for r in reqs
                                            if r.ok))

        with fe.ServingFrontend(cfg) as f:
            # warmup: the ladder kinds of the classes, built on the worker
            t0 = time.perf_counter()
            fp = f.register(s)
            f.drain_background(timeout=900)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            entry = f._entry(fp)
            print(f"  register + warmup until drain_background returns: "
                  f"{warm_s!r} s (host clock); warmed {sorted(entry.warmed)}",
                  flush=True)
            for kind in ("plan_fp16", "plan_e8m4"):
                pl = entry.ops.plan_pair(kind)[1]
                print(f"  {kind}: {PLAN_KERNEL[pl.variant]} for spmv, "
                      f"{'K3' if pl.variant == 'fused' else 'K5'} for a "
                      f"slot: {pl.policy}", flush=True)
            if entry.ops.plan_pair("plan_fp16")[1].variant != "fused":
                fail("plan_fp16 is not a fused plan at 104^3")
            sell32 = entry.ops.stored("fp32")
            k2_per_slot = cfg.slots * len(sell32.vals)

            def vectors(k):
                """``k`` request vectors, made before the clock starts."""
                return [rng.standard_normal(m).astype(np.float32)
                        for _ in range(k)]

            # steady traffic: bursts of 12, a third per class
            xs = vectors(96)
            before = self.counts()
            steady = []
            t0 = time.perf_counter()
            for k in range(8):
                for i in range(12):
                    steady.append(f.submit(fp, xs[12 * k + i],
                                           klass=classes[i % 3]))
                f.run_until_drained()
            torch.cuda.synchronize()
            steady_s = time.perf_counter() - t0
            launched = {k: v - before[k] for k, v in self.counts().items()}
            slots = collections.Counter()
            for k, v in observe.snapshot()["counters"].items():
                if k.startswith("frontend.matvec{"):
                    slots[k.split("tier=")[1].rstrip("}")] += v
            want = {"K3": slots["plan_fp16"] + slots["plan_bf16"],
                    "K5": slots["plan_e8m4"],
                    "K2": slots["fp32"] * k2_per_slot}
            got = {k: launched[k] for k in want}
            print(f"  steady: 96 requests in {steady_s!r} s, "
                  f"{96 / steady_s!r} requests/s; slots by tier "
                  f"{dict(slots)}; launches {got} (want {want}: one K3 per "
                  f"fused slot, one K5 per plan_e8m4 slot, K2 once per "
                  f"column and fp32 bucket)", flush=True)
            if got != want:
                fail(f"slot launches {got} != {want}")
            if not all(r.ok for r in steady):
                fail(f"steady requests not ok: "
                     f"{collections.Counter(r.status for r in steady)}")
            for klass in classes:
                lat = sorted(r.latency for r in steady
                             if r.klass.name == klass)
                print(f"  {klass}: latency p50 "
                      f"{lat[int(0.5 * (len(lat) - 1))] * 1e3!r} ms, p99 "
                      f"{lat[int(0.99 * (len(lat) - 1))] * 1e3!r} ms "
                      f"({len(lat)} requests, host clock)", flush=True)
            # y against each tier's single matvec, 8 responses per tier
            for kind in ("plan_fp16", "plan_e8m4", "fp32"):
                picked = [r for r in steady if r.tier_kind == kind][:8]
                if len(picked) < 8:
                    fail(f"fewer than 8 {kind} responses")
                for r in picked:
                    xd = torch.from_numpy(r.x).to(self.dev)
                    if kind == "fp32":
                        y1 = entry.ops.matvec("fp32")(xd)
                    else:
                        mat_k, plan_k, _ = entry.bind(kind)
                        y1 = plan_k.spmv(mat_k, xd)
                    same_bits(torch.from_numpy(r.y), y1.cpu(),
                              f"{kind} slot column vs its single matvec")
            print("  8 responses per tier equal the tier's single matvec "
                  "bit for bit (K3 column vs K1, K5 column vs K4, fp32 "
                  "column vs the SELL matvec)", flush=True)
            nb_ok = budget_ok(steady)

            # one slot's wall, its copies (rows of the [slots, m] staging
            # block each way) and its full guard
            xs = vectors(5 * cfg.slots)
            slot_walls = []
            for k in range(5):
                for i in range(cfg.slots):
                    f.submit(fp, xs[cfg.slots * k + i], klass="interactive")
                slot_walls.append(wall(f.step)[1])
            slot_s = median(slot_walls)
            Xh = np.stack(xs[:cfg.slots])
            Xr = torch.from_numpy(Xh).to(self.dev)
            Xd = Xr.t()
            h2d = median(wall(lambda: torch.from_numpy(Xh).to(self.dev))[1]
                         for _ in range(5))
            d2h = median(wall(lambda: Xr.cpu().numpy())[1]
                         for _ in range(5))
            mat16, plan16, gs16 = entry.bind("plan_fp16")
            spmm_ms = device_ms(lambda: plan16.spmm(mat16, Xd), self.reps)
            full_ms = device_ms(lambda: gd.guarded_spmm(
                mat16, plan16, gs16, Xd, full=True), self.reps)
            print(f"  one plan_fp16 slot (4 requests, f.step, host clock, "
                  f"median of 5): {slot_s * 1e3!r} ms; H2D of the [4, m] "
                  f"rows {h2d * 1e3!r} ms + D2H of [4, n] {d2h * 1e3!r} ms: "
                  f"copies {(h2d + d2h) / slot_s!r} of the slot; device: "
                  f"plan.spmm (K3 + epilogue) {spmm_ms!r} ms, full guarded "
                  f"spmm {full_ms!r} ms, so the guard "
                  f"{(full_ms - spmm_ms) * 1e-3 / slot_s!r} of the slot; on "
                  f"{card_line()}", flush=True)

            # device busy share over one burst of 12 (the profiler)
            xs = vectors(12)

            def burst():
                for i in range(12):
                    f.submit(fp, xs[i], klass=classes[i % 3])
                f.run_until_drained()

            bwall, kern = profiled(burst)
            # the recorder is on: its spans show as device rows too
            # (gpu_user_annotation), which would count their kernels twice
            from repro_torch.observe import profile as oprof
            kern = [k for k in kern if k[2] not in oprof.SPAN_NAMES]
            if kern:
                busy = sum(k[0] for k in kern)
                print(f"  one burst of 12 under the profiler: device busy "
                      f"{busy!r} ms of a {bwall!r} ms event wall, busy share "
                      f"{busy / bwall!r}; top kernels "
                      f"{[(round(k[0], 4), k[1], k[2][:40]) for k in kern[:6]]}",
                      flush=True)
            else:
                print("  device busy share: not measured (the profiler saw "
                      "no device events)", flush=True)
            drop_payloads(steady)

            # one solve request, standard class, b = ones
            b = np.ones(n)
            rs = f.submit(fp, b, klass="standard", op="solve")
            _, solve_s = wall(f.run_until_drained)
            if not rs.ok:
                fail(f"the solve request ended {rs.status}: {rs.reason}")
            info = rs.solve_info
            true_rel = float(np.linalg.norm(b - s64 @ rs.y)
                             / np.linalg.norm(b))
            start = "plan_e8m4"        # the standard class's tier
            xd, infod = recover.guarded_solve(entry.ops, start, b,
                                              tol=cfg.solve_tol,
                                              maxiter=cfg.solve_maxiter)
            same_bits(torch.from_numpy(rs.y), torch.from_numpy(xd),
                      "the solve response vs guarded_solve called directly")
            print(f"  solve (standard, b = ones, {rs.tier_kind}): "
                  f"{info.iters} outer steps, trips {info.trips}, relres "
                  f"{info.relres!r} against solve_tol {cfg.solve_tol} "
                  f"({'met' if info.relres < cfg.solve_tol else 'NOT met'}; "
                  f"m_in 16, maxiter {cfg.solve_maxiter}), true relres "
                  f"{true_rel!r}; wall {solve_s!r} s (deadline 1.0 s: "
                  f"{'missed' if rs.missed_deadline else 'met'}); equal bit "
                  f"for bit to guarded_solve called directly", flush=True)

            # overload: a burst over the shed watermark, max_queue 32. Cold,
            # as a front end meets it: register warmed only the classes'
            # own tiers, so the first demoted slot builds plan_bf16 on the
            # dispatching thread, and the longest tick is that stall
            cold = "plan_bf16" not in entry.ops._cache
            f.cfg = dataclasses.replace(
                cfg, admission=pol.AdmissionPolicy(max_queue=32))
            xs = vectors(40)
            snap0 = observe.snapshot()["counters"]
            over = [f.submit(fp, xs[i], klass=classes[i % 3])
                    for i in range(40)]
            ticks = []
            t0 = time.perf_counter()
            while f.queue and len(ticks) < 1000:  # no trips: nothing waits
                ticks.append(wall(f.step)[1])
            over_s = time.perf_counter() - t0
            f.cfg = cfg
            snap1 = observe.snapshot()["counters"]

            def delta(prefix):
                return {k: v - snap0.get(k, 0) for k, v in snap1.items()
                        if k.startswith(prefix) and v != snap0.get(k, 0)}

            by_status = collections.Counter(r.status for r in over)
            missed = collections.Counter(
                r.klass.name for r in over
                if r.missed_deadline or r.status == "deadline_miss")
            rest = sorted(ticks)[:-1]
            print(f"  overload (plan_bf16 built before: {not cold}): 40 "
                  f"requests at once under AdmissionPolicy(max_queue=32): "
                  f"{dict(by_status)}; tiers {tiers_of(over)}; sheds "
                  f"{delta('frontend.shed')}; demotion "
                  f"{delta('frontend.demote_level_change')}; deadline "
                  f"misses by class {dict(missed)}; {len(ticks)} ticks, "
                  f"the longest {max(ticks)!r} s (the first plan_bf16 "
                  f"slot: its build and guard on the dispatching thread), "
                  f"the rest {max(rest, default=None)!r} s at most; drained "
                  f"in {over_s!r} s (host clock)", flush=True)
            if f.queue:
                fail(f"the overload burst did not drain: {len(f.queue)} left")
            if by_status["rejected"] != 8 or not delta("frontend.shed"):
                fail("the overload burst did not reject and shed")
            if "plan_bf16" not in tiers_of(over):
                fail("overload did not demote to plan_bf16")
            nb_ok += budget_ok(over)
            drop_payloads(over)

            # a fault: one word of plan_fp16's stream flipped in place; as in
            # the reference's chaos campaign it survives the first repair
            # (flipped again once after the first rebuild), so the breaker
            # meets its fail_threshold
            mat16, plan16, _ = entry.bind("plan_fp16")
            flips = []

            def flip(mat_, plan_):
                flips.append(next(
                    i for i in (inject.flip_fused_word(mat_, plan_, sd,
                                                       bit=27)
                                for sd in range(100))
                    if not i.value_neutral or i.undo()))

            flip(mat16, plan16)
            real = entry.rebuild

            def sabotaged(kind):
                real(kind)
                if kind == "plan_fp16" and len(flips) == 1:
                    flip(*entry.bind(kind)[:2])

            entry.rebuild = sabotaged
            snap0 = observe.snapshot()["counters"]
            fault, fault_ok = [], 0
            t0 = time.perf_counter()
            edges = []
            while time.perf_counter() - t0 < 300:
                burst = [f.submit(fp, x, klass="interactive")
                         for x in vectors(cfg.slots)]
                f.run_until_drained()
                fault_ok += budget_ok(burst)
                fault += burst
                drop_payloads(burst)
                edges = [(a, c) for _, a, c in entry.breaker.transitions]
                if (pol.HALF_OPEN, pol.CLOSED) in edges:
                    break
            f.drain_background(timeout=900)
            del entry.rebuild
            fault_s = time.perf_counter() - t0
            snap1 = observe.snapshot()["counters"]
            print(f"  fault ({[i.detail for i in flips]}): "
                  f"{len(fault)} interactive requests in {fault_s!r} s: "
                  f"{dict(collections.Counter(r.status for r in fault))}; "
                  f"tiers {tiers_of(fault)}; guard trips "
                  f"{delta('frontend.guard_trip')}; rebuilds "
                  f"{delta('frontend.rebuild')}; breaker transitions "
                  f"{[(round(t, 3), a, c) for t, a, c in entry.breaker.transitions]}",
                  flush=True)
            if (pol.CLOSED, pol.OPEN) not in edges or \
                    (pol.HALF_OPEN, pol.CLOSED) not in edges:
                fail(f"the breaker did not open and close: {edges}")
            if "fp32_fallback" not in tiers_of(fault):
                fail("the fp32 fallback never answered")
            if not entry.healthy("plan_fp16"):
                fail("plan_fp16 is not healthy after the rebuild")
            nb_ok += fault_ok

            counters = observe.snapshot()["counters"]
            failed = [r for r in f.done if r.status == "failed"]
            if counters.get("frontend.background_failure", 0) or failed:
                fail(f"background failures "
                     f"{counters.get('frontend.background_failure', 0)}, "
                     f"failed requests {len(failed)}")
            print(f"  {nb_ok} ok spmv responses within their tier's budget "
                  f"(safety 16) of the fp64 host product; no background "
                  f"failure, no failed request", flush=True)
            print(f"  stats(): {f.stats()}", flush=True)
            rep = observe.report()
            print(f"  frontend.* series: "
                  f"{ {k: v for k, v in rep['counters'].items() if k.startswith('frontend.')} }",
                  flush=True)
            print(f"  frontend.latency_s: "
                  f"{ {k: {q: h[q] for q in ('count', 'p50', 'p99')} for k, h in rep['histograms'].items() if k.startswith('frontend.')} }",
                  flush=True)
        observe.enable(prev)
        observe.reset()
        launches = self.counts()
        print(f"  launches in this run: {launches}", flush=True)
        return dict(launches=launches)

def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 12's request vectors")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.solvers import graphs

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
    spilled = []
    for src, kernel, regs, st, ld in ptxas_table(logs):
        print(f"  {src}.cu {kernel}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B", flush=True)
        if st or ld:
            spilled.append(f"{src}.cu {kernel}")
    if spilled:
        fail(f"kernels that spill registers: {spilled}")

    smoke = Smoke(dev)
    phase_s = {}
    out = {}

    def phase(num: int, title: str, fn):
        print(f"== {num}. {title}", flush=True)
        t0 = time.perf_counter()
        out[num] = fn()
        phase_s[num] = time.perf_counter() - t0
        print(f"  phase {num}: {phase_s[num]:.1f} s", flush=True)
        return out[num]

    # graph replays make no Python call: the ledger counts their launches
    with graphs.LEDGER.watch(smoke.raw_counts):
        phase(3, "kernels against their plain versions, on the card",
              smoke.kernels_vs_plain)
        mp = phase(4, "main path: HPCG 104^3, plan_fp16, Jacobi-PCG, eager "
                   "and through CUDA graphs", smoke.main_path)
        mx = phase(5, "mixed-precision PCG, HPCG 104^3: adaptive_pcg over "
                   "the e8m tier ladder", lambda: smoke.mixed_path(mp["a"]))
        rows = phase(6, "times at the main paths' shapes (CUDA events)",
                     lambda: {**smoke.times(mp), **smoke.times_bucket(mx)})
        phase(7, "where a solve's time goes (torch.profiler), eager and "
              "through CUDA graphs", lambda: smoke.breakdown(mp))
        sv = phase(8, "the paper's solvers, HPCG 104^3, eager and through "
                   "CUDA graphs: IO-CG against fp64 PCG, F3R, the "
                   "fixed-iteration solvers without host syncs, the "
                   "PackSELL triangular solve",
                   lambda: smoke.solvers_path(mp["a"], mx["ops"]))
        cp = phase(9, "the composite, HPCG 104^3: three row classes through "
                   "K1, K4 and K2, Jacobi-PCG through CUDA graphs; the "
                   "mixed: kind and the precision store",
                   lambda: smoke.composite_path(mp["a"]))
        phase(10, "the guards, HPCG 104^3: guarded SpMV, every "
              "injector, an injection into a captured graph, "
              "guarded_solve", lambda: smoke.guard_path(mp, mx, cp))
        phase(11, "the recorder on the card, HPCG 104^3: REPRO_OBS off and "
              "on through the graphs, no sync, its host cost, "
              "profile_dispatch, the exporters",
              lambda: smoke.recorder_path(
                  mp, mx, rows["K1"][0]))
        phase(12, "the serving front end, HPCG 104^3: warmup, steady "
              "traffic and a solve, an overload burst, a fault that opens "
              "and heals a breaker", lambda: smoke.serving_path(
                  mp, seed=args.seed))

    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "K1": ("packsell_spmv_fused", src + "packsell_fused.cu",
               "src/repro/kernels/packsell_spmv.py:567"),
        "K2": ("sell_spmv_bucket", src + "sell_spmv.cu",
               "src/repro/kernels/sell_spmv.py:47"),
        "K3": ("packsell_spmm_fused", src + "packsell_fused.cu",
               "src/repro/kernels/packsell_spmv.py:620"),
        "K4": ("packsell_spmv_buckets", src + "packsell_bucket.cu",
               "src/repro/kernels/packsell_spmv.py:133"),
        "K5": ("packsell_spmm_buckets", src + "packsell_bucket.cu",
               "src/repro/kernels/packsell_spmv.py:412"),
        "K6": ("packsell_spmv_band_buckets", src + "packsell_bucket.cu",
               "src/repro/kernels/packsell_spmv.py:271"),
        "K2-f64": ("sell_spmv_bucket (float64 sum)", src + "sell_spmv.cu",
                   "src/repro/kernels/sell_spmv.py:47"),
    }
    print(f"== 13. done in {time.perf_counter() - t_start:.1f} s (phases "
          f"3-12: {phase_s})", flush=True)
    print(f"card: {card_line()}", flush=True)
    # each path ran with the counts set to 0 just before it
    runs = (mp["launches"], mx["launches"], sv, cp["launches"],
            out[10]["launches"], out[11]["launches"], out[12]["launches"])
    launches = {k: sum(run.get(k, 0) for run in runs) for k in meta}
    kernels = []
    for k, (kname, source, replaces) in meta.items():
        t, tp, tl, tb, by, te = rows[k]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[k],
                        "max_abs_err": smoke.err[k], "ms": t,
                        "plain_ms": tp, "bound_ms": tb, "bound_by": by,
                        "library_ms": tl, "eager_ms": te,
                        "checked_cases": smoke.cases[k]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
