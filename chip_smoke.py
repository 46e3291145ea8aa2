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
breaker); then distribution (the same matrix as four shards on the one
card: the distributed SpMV and SpMM in both exchange modes against the CPU
replay, ``jacobi_pcg_dist``, ``adaptive_pcg_dist``, ``dist_mixed:`` and
``dist_auto:``, a checkpoint fault); then the LM serving path
(granite-3-2b at full width and depth in ``DecodeEngine``, its decode
step one CUDA graph, the PackSELL-pruned head through K1 and K3); then
the moe family (qwen2-moe-a2.7b at full width and depth in one bf16 copy
through the engine, layer 0 against a float64 loop), the vlm family
(llava-next-mistral-7b, 2,880 patches a row, its decode step one CUDA
graph), the ssm family (mamba2-1.3b through the engine, decode against
prefill after 1,000 tokens), the hybrid family (zamba2-2.7b, the
shared attention block every 6th layer) and the encdec family
(seamless-m4t-large-v2: 4 x 1,500 audio-stub frames through the encoder,
cross-attention over the encoder's K/V, its decode step one CUDA graph);
then the training path (qwen2-0.5b at full width and depth through
``Trainer``: a float32 master, bf16 compute, checkpoints, a resume that
must equal the uninterrupted run bit for bit); then the launchers (a
STREAM-triad probe against the H100's HBM3 constant, the dry run's cells
counted on the meta device, the decode cells that fit the card run for
real with their FLOPs held to the meta count, the hotspot analyzer on
one real cell); then distribution across processes (phase 13's matrix
and tier ladder one rank per shard from the host dicts it built: one
NCCL rank whose solve's graphs capture the collectives, four gloo ranks
sharing the card against the stacked shards bit for bit, NCCL with one
rank per card where the machine has cards enough), the training mesh
across processes (the data axes, the model axis, the compressed steps
over it, the production mesh counted on meta) and the tensor-parallel
prefill and decode (qwen2-0.5b and mamba2-1.3b one rank per model shard,
the KV cache over the shards, each rank bit-equal to its stacked form,
the stacked form against the one-device forward, the serving cells of
the production meshes counted on meta)
-- times the kernels, and ends with one JSON line. Every solve runs as the port runs
it, through CUDA-graph replays (``repro_torch.solvers.graphs``), and in
turns with its eager loop (eager, captured, captured, eager), which it
must equal bit for bit.

    python3 chip_smoke.py [--seed N]

It needs one CUDA device and exits non-zero without one; it imports
nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.launch.roofline import HW  # noqa: E402

#: H100 SXM: HBM3 bandwidth, float32 (non-tensor-core) and dense bfloat16
#: tensor-core peaks, NVIDIA data sheet, at the full 700 W power limit: the
#: dry run's constants (``repro_torch.launch.roofline.HW``), so the kernel
#: bounds and the roofline terms cannot drift apart
PEAK_BYTES_PER_S = HW["hbm_bw"]
PEAK_F32_OPS_PER_S = HW["peak_flops_f32"]
PEAK_BF16_OPS_PER_S = HW["peak_flops_bf16"]
#: the decode-against-prefill checks of phases 14-19 in bfloat16 at full
#: width and depth: 16 bf16 ulps (2^-8 each) of the largest |logit|. The
#: two paths may round their products at other places (cuBLAS picks
#: kernels by row count; phase 15's expert products have 1 row a slot in
#: decode and 9 in the prefill, which moves qwen2-moe's logits by up to
#: 0.0145 of the largest at seeds 0 and 2); a cache that misplaced a
#: position would move the logits by their own scale
LM_DECODE_TOL = 2.0 ** -4
#: phase 15's layer check: the bf16 moe layer's y against the float64 loop,
#: relative to the largest |y|: 2^-9 per bf16 rounding, of which y takes
#: about four in turn (x, the two products, h, the output, the shared
#: sum), with 4x to spare
MOE_Y_TOL = 2.0 ** -5
#: phase 15's peak memory above the phase's start: qwen2-moe-a2.7b's 30.3 GB
#: of bf16 parameters, one float32 tensor drawn at a time (the largest, the
#: embedding, 1.25 GB), the KV cache and the activations
MOE_PEAK_BYTES = 33e9
#: phase 19's float64 check of decoder layer 0's cross-attention, relative
#: to the largest |y|: y = softmax(q K^T / 8) V W_o from bf16 tensors with
#: float32 inside the softmax. Its bf16 roundings: q (2^-9, which moves a
#: logit by up to 2^-9 of sum |q_i k_i| / 8, printed as the phase's logit
#: scale, and a softmax weight by twice that), the attention output (2^-9)
#: and y (2^-9); a row of y sums 1,024 products of random sign, so an
#: input's rounding reaches y at about its own size. The float32 softmax
#: over 1,500 terms adds about 1500 x 2^-24 = 2^-13.5. With a logit scale
#: up to 4 (2.95 at d 1,024, 16 heads of 64, on the CPU at seed 0): 2^-9
#: (1 + 1 + 1 + 2 x 4) = 11 x 2^-9 < 2^-5
XATTN_TOL = 2.0 ** -5
#: the kernel a plan variant's SpMV launches
PLAN_KERNEL = {"fused": "K1", "full": "K4", "band": "K6"}
#: phase 20's microbatch check (qwen2-0.5b, bf16, microbatch 4 of 8 rows
#: against the whole batch on the same master): the two runs differ only in
#: the rows of each bf16 product (4,096 tokens against 8,192), for which
#: cuBLAS may pick other tiles and K splits. That moves a product's float32
#: sums by a few ulps and flips the bf16 rounding (one ulp, 2^-8 relative)
#: of a share of its outputs. A flip of every stored activation the same
#: way moves the loss by at most 2^-8 of itself: the loss's limit. The
#: gradient passes 24 layers' backward products, each flip of random sign:
#: 2^-6 for its global norm
MB_LOSS_TOL = 2.0 ** -8
MB_GNORM_TOL = 2.0 ** -6
#: phase 20's bf16 step against a float32-compute evaluation of the same
#: master and batch: bf16 keeps 8 significant bits (u = 2^-8); a layer
#: rounds its residual stream and its products about 4 times, 96 roundings
#: in a chain over 24 layers whose errors add at random: sqrt(96) u, about
#: 2^-4.7 of the hidden state. At init the loss is ln V plus a term of the
#: logits' spread (about 0.6), which that error moves by a few percent, and
#: the mean over 8,192 tokens averages the rest: 2^-7 of the loss. The
#: gradient runs that chain twice (forward and backward): 2^-3 of its norm
BF16_LOSS_TOL = 2.0 ** -7
BF16_GNORM_TOL = 2.0 ** -3
#: phase 20's peak memory against its prediction (``Smoke.train_peak``)
TRAIN_PEAK_RATIO = 1.5
#: phase 20's learning signal: the mean of the last four losses below the
#: mean of the first four by more than this many nats. What 12 steps of
#: the synthetic stream at qwen2-0.5b's vocab can show: its Markov table
#: has 151,936 x 4 successors and 12 steps see 98,304 tokens, so the
#: transitions stay unlearnt, and the loss can fall only by the initial
#: logits' spread (about 0.18 above ln V) and the unigram's gap to ln V
#: (0.149, the chain's stationary entropy). The card fell 0.023 at lr 3e-4
#: with steps scattered by about 0.005 about the trend; a step that learns
#: nothing stays within that scatter
LEARN_DROP = 0.01
#: phase 23 (b): two ranks' losses against one device's on the same
#: model, master and batches. Each rank's products hold half the rows (4,096
#: tokens against 8,192): the microbatch check's difference
#: (``MB_LOSS_TOL``). The gradient's sum over two ranks rounds in float32,
#: far below the bf16 flips, over three steps at lr 3e-4
DP_LOSS_TOL = MB_LOSS_TOL
#: phases 23 (b) and 24 (b, c): the layers of qwen2-0.5b kept in the
#: ranks' runs (full width; phase 23 (a) and phase 24 (a) keep all 24)
DP_CUT_LAYERS = 4
#: phase 23 (b1)'s steps, and phase 24 (a)'s, after which phase 20 keeps
#: its master for phase 24 (a)'s master check
DP_STEPS = 3
#: phase 23 (b): two ranks' master after ``DP_STEPS`` steps against one
#: device's on the same model, |b1 - a| over |a - initial| (the 2-norms
#: over every element): the share of a's update that the second rank's
#: bf16 rounding moves.
#: A planted fault, each rank's slices updated from its own gradient
#: alone, is measured beside it in every run and must lie above the limit
DP_MASTER_TOL = 0.25
#: phase 24 (a): the stacked (1, 2) model axis's master after
#: ``DP_STEPS`` steps against phase 20's, |tp - a| over |a - initial| (the
#: 2-norms over every element): the share of the update that the model
#: shards' other bf16 roundings move. A planted fault, a row-parallel
#: reduce-scatter that keeps each shard's own partial alone
#: (:func:`own_partial_alone`), is measured beside it and must lie above
TP_MASTER_TOL = 0.25
#: phase 24 (a): the stacked model axis's losses against phase 20's on the
#: same master and batches: the model shards round their bf16 partial sums
#: in another order (the microbatch check's limit)
TP_LOSS_TOL = MB_LOSS_TOL
#: phase 25: the stacked tensor-parallel prefill and decode's logits against
#: the one-device forward's on the same bf16 parameters and tokens,
#: relative to the largest |logit|. A model shard rounds each row-parallel
#: product's partial to bf16 before the rank-order sum rounds again (2^-9
#: each, where one device rounds its float32 sum once), the prefill's
#: reduce-scatters too: about three more roundings a layer, 72 over
#: qwen2-0.5b's 24 layers, 96 over mamba2-1.3b's 48 (out_proj and the
#: gated norm's scale), of random sign: sqrt(96) x 2^-9, about 2^-5.7 of
#: the hidden state, which the head carries to the logits at about its own
#: size; with 3x to spare, the decode-against-prefill limit. A shard that
#: keeps its own partial drops the others' share of every product: the
#: logits move by their own scale
TP_SERVE_TOL = LM_DECODE_TOL
#: phase 25's Mamba2 run: the SSM's decay exp(dt A) turns a bf16 rounding
#: flip of dt's input (2^-8 of it: the shards' in_proj products take other
#: columns than the one device's and round elsewhere) into 2^-8 |dt A| of
#: the decay, and A reaches -16 at dt about 0.7: up to 2^-4.5 a flip,
#: where a product's extra rounding moves a value by 2^-9. Flips in a few
#: heads of 48 layers, of random sign, carry to the logits at about 2^-4
#: (0.065 read on the card at seed 0): twice the attention families'
#: limit. A shard that keeps its own partial moves the logits by their
#: own scale (1.36 read)
TP_SERVE_SSM_TOL = 2.0 ** -3
#: phase 25's prompts: rows, tokens a row, cache positions, greedy steps
SERVE_ROWS, SERVE_PROMPT, SERVE_MAX_LEN, SERVE_TICKS = 4, 512, 1024, 16
#: phase 25's runs in phase 22's spawn, at full width and depth: (arch,
#: data, model): qwen2-0.5b under the KV-head rule at (2, 2) and the
#: query-row rule at (1, 4) (the one it takes on 16 x 16), mamba2-1.3b by
#: head
SERVE_RUNS = {"kv": ("qwen2-0.5b", 2, 2), "qc": ("qwen2-0.5b", 1, 4),
              "ssm": ("mamba2-1.3b", 1, 2)}


def _count_cell(cell) -> tuple:
    """A spawned counter's job: ``dryrun.count_cell`` of ``(arch, shape)``
    on meta, and when it ended (host clock, seconds since the epoch)."""
    from repro_torch.launch import dryrun

    return dryrun.count_cell(*cell), time.time()


def _count_mesh_cell(cell) -> tuple:
    """A spawned counter's job: ``cell = (arch, shape, mesh name,
    pod_wire)`` per device on that production mesh, and when it ended."""
    from repro_torch.launch import dryrun

    arch, shape, name, wire = cell
    return (dryrun.count_mesh_cell(arch, shape, name, pod_wire=wire),
            time.time())


class MetaCounts:
    """Phase 21's dry-run cells (:data:`RUN_CELLS`) and phases 24 (h) and
    25's production-mesh cells (:data:`MESH_CELLS`), counted on meta in
    ``jobs`` spawned processes started before phase 14: host work, so it
    runs beside the card's phases and phases 21 and 24 read the records
    when they come (the pool re-imports this module as ``__mp_main__``: its work
    stays under ``main()``)."""

    def __init__(self, jobs: int = 2):
        import multiprocessing as mp

        self.t0 = time.time()
        self.pool = mp.get_context("spawn").Pool(jobs)
        self.cells = self.pool.map_async(_count_cell, RUN_CELLS,
                                         chunksize=1)
        self.mesh = self.pool.map_async(_count_mesh_cell, MESH_CELLS,
                                        chunksize=1)

    def get(self, jobs) -> tuple:
        """``(records, seconds from the counters' start to the last
        one)``."""
        got = jobs.get()
        return [r for r, _ in got], max(t for _, t in got) - self.t0

    def close(self) -> None:
        """Stop the counters (at the run's end, or at exit on a failure:
        ``main`` registers it with ``atexit``)."""
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None


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


#: the running phase's sub-walls: ``t`` where the current one began,
#: ``walls`` the closed ones by label (:func:`mark`)
MARKS = {"t": 0.0, "walls": {}}


def mark(label: str) -> None:
    """Close the running phase's current sub-wall under ``label``: the
    host seconds since the phase began or since the mark before (a label
    marked again adds up). ``main`` prints them after the phase's wall, so
    that a run cut by its time limit still shows where each phase's time
    went."""
    now = time.perf_counter()
    walls = MARKS["walls"]
    walls[label] = walls.get(label, 0.0) + now - MARKS["t"]
    MARKS["t"] = now


#: phase 21's dry-run cells: the decode cells that fit one H100, counted on
#: meta and run for real (``dryrun --all`` counts the rest)
RUN_CELLS = (("qwen2-0.5b", "decode_32k"), ("mamba2-1.3b", "decode_32k"),
             ("zamba2-2.7b", "long_500k"), ("mamba2-1.3b", "long_500k"))
#: phase 9's scattered matrix for the mixed: kind through a precision store
SCATTERED_ROWS = 262_144
#: (arch, shape, mesh, pod_wire) per device on a production mesh: phase 24
#: (h)'s qwen2-0.5b x train_4k on each (2 x 16 x 16 with the u16 pod
#: wire), then phase 25's serving cells
MESH_CELLS = (("qwen2-0.5b", "train_4k", "16x16", None),
              ("qwen2-0.5b", "train_4k", "2x16x16", "u16"),
              ("qwen2-0.5b", "prefill_32k", "16x16", None),
              ("qwen2-0.5b", "decode_32k", "16x16", None),
              ("zamba2-2.7b", "long_500k", "2x16x16", None))
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


def bound_ms(nbytes: int, ops: int,
             peak_ops: float = PEAK_F32_OPS_PER_S) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / peak_ops * 1e3
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


def tick_profile(eng, saved: dict, *, runs: int, reps: int, windows: int = 1,
                 sync: str | None = None) -> dict:
    """A ``DecodeEngine``'s decode tick from ``saved`` (its ``state()``):
    ``runs`` times an eager tick and a graph tick, each from ``saved``,
    whose logits and buffers must equal bit for bit (both under
    ``set_sync_debug_mode(sync)`` when ``sync`` is given), with their walls
    on the host clock; the graph tick's device time by CUDA events over
    ``reps`` replays, in ``windows`` windows (``ms`` is their median); the
    device ops of one eager tick counted on the host. Leaves the engine at
    ``saved``."""
    from repro_torch.solvers import graphs

    def once(eager: bool):
        eng.set_state(saved)
        torch.cuda.synchronize()
        with (sync_debug(sync) if sync else contextlib.nullcontext()), \
                (graphs.eager() if eager else contextlib.nullcontext()):
            t0 = time.perf_counter()
            out = eng._decode().clone()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, eng.state()

    walls = {"eager": [], "graph": []}
    for _ in range(runs):
        le, sec, after = once(True)
        walls["eager"].append(sec)
        lg, sec, got = once(False)
        walls["graph"].append(sec)
        same_bits(lg, le, "graph tick vs eager tick logits")
        for k, v in got.items():
            if not torch.equal(v, after[k]):
                fail(f"graph tick vs eager tick: {k} differs")
    device = []
    for _ in range(windows):
        eng.set_state(saved)
        device.append(timed(eng._decode, reps))
    eng.set_state(saved)
    with graphs.eager():
        ops = collections.Counter(aten_ops(eng._decode))
    eng.set_state(saved)
    return dict(walls=walls, wall_eager=float(np.median(walls["eager"])),
                wall_graph=float(np.median(walls["graph"])),
                ms=float(np.median(device)), windows=device, reps=reps,
                ops=ops)


@contextlib.contextmanager
def route_tap(moe, each, layers: int, *, exact: bool = True):
    """Inside the block every ``moe.route`` call hands ``(x, routing)`` to
    ``each``, and the layer goes on with the routing ``each`` returns. The
    model reaches the router through the module's ``route``; should it
    bind it otherwise, the tap would see nothing, so the block fails
    unless it saw ``layers`` calls (``exact``) or a positive multiple of
    them."""
    route, seen = moe.route, [0]

    def tap(p, cfg, x):
        seen[0] += 1
        return each(x, route(p, cfg, x))

    moe.route = tap
    try:
        yield
    finally:
        moe.route = route
    n = seen[0]
    if not (n == layers if exact else n > 0 and n % layers == 0):
        fail(f"moe.route was called {n} times, not "
             f"{'' if exact else 'a positive multiple of '}{layers}: the "
             "model no longer routes through moe.route")


def pinned(r, experts):
    """One token's routing ``r`` (S = 1) sent to ``experts`` ``[B, 1, k]``
    instead: the gates are the router's probabilities there, renormalised
    as ``moe.route`` renormalises them, and every assignment is kept (the
    one token ranks first at each of its k experts). With the experts
    ``r`` chose, the result equals ``r`` bit for bit."""
    import dataclasses

    B, S, k = r.experts.shape
    if S != 1 or experts.shape != r.experts.shape:
        fail(f"pinned: routing {tuple(r.experts.shape)}, experts "
             f"{tuple(experts.shape)}; one token a row only")
    gates = torch.gather(r.probs, -1, experts)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return dataclasses.replace(
        r, gates=gates, experts=experts, keep=torch.ones_like(r.keep),
        slot=experts.reshape(B, k) * r.cap)


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


# -- phase 22's ranks: module-level, so the spawned ranks import them -------


def _rank_wrappers() -> dict:
    from repro_torch.kernels import packsell_spmv as kpk
    from repro_torch.kernels import sell_spmv as ksl

    return {"K1": kpk.packsell_spmv_fused, "K2": ksl.sell_spmv_bucket,
            "K3": kpk.packsell_spmm_fused, "K4": kpk.packsell_spmv_buckets,
            "K5": kpk.packsell_spmm_buckets,
            "K6": kpk.packsell_spmv_band_buckets}


def _rank_raw() -> dict:
    """This rank's wrapper counts (K2-f64: K2's float64 launches)."""
    w = _rank_wrappers()
    return {**{k: f.launches for k, f in w.items()},
            "K2-f64": w["K2"].launches_f64}


def _rank_k7() -> dict:
    """This rank's K7 count (kept apart, as :meth:`Smoke.k7_counts`)."""
    from repro_torch.kernels.row_dots import row_dots

    return {"K7": row_dots.launches}


def _rank_counts() -> dict:
    """This rank's launches that ran: its counts and its graph replays'."""
    from repro_torch.solvers import graphs

    return graphs.LEDGER.ran(_rank_raw())


def _rank_all() -> dict:
    """:func:`_rank_counts` and K7's."""
    from repro_torch.solvers import graphs

    return {**_rank_counts(), **graphs.LEDGER.ran(_rank_k7())}


def _rank_zero() -> None:
    from repro_torch.kernels.row_dots import row_dots
    from repro_torch.solvers import graphs

    w = _rank_wrappers()
    for f in (*w.values(), row_dots):
        f.launches = 0
    w["K2"].launches_f64 = 0
    for k in (*_rank_raw(), "K7"):
        graphs.LEDGER.net[k] = 0


def _rank_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _rank_counts().items()
            if v != before[k]}


def _rank_ops(mesh, host_dir: str, meta):
    from repro_torch import distributed as dist
    from repro_torch.distributed.plan import read_host

    return dist.DistOperands.from_host(read_host(host_dir), meta,
                                       rank=mesh.rank, device=mesh.device)


def rank_nccl(mesh, host_dir: str, meta, xi, b, diag, solve_kw: dict,
              reps: int) -> dict:
    """Phase 22 (a) and (c) on one NCCL rank (one card each): the rank's
    operands from the parent's host dict, one matvec (its launches and
    its y), ``jacobi_pcg_dist`` in the four turns (the graphs capture the
    NCCL collectives), then a matvec's and the exchange's device time
    (a CUDA graph of ``reps`` calls) and the rank's peak memory."""
    from repro_torch import distributed as dist
    from repro_torch.distributed import halo as dh
    from repro_torch.solvers import cg, graphs

    t_in = time.time()
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    ops, load_s = wall(lambda: _rank_ops(mesh, host_dir, meta))
    plan = dist.DistSpMVPlan(ops, mesh)
    xt, bt = torch.from_numpy(xi).to(dev), torch.from_numpy(b).to(dev)
    out = {"rank": mesh.rank, "device": str(dev), "load_s": load_s,
           "turns": {}}
    with graphs.LEDGER.watch(_rank_raw), graphs.LEDGER.watch(_rank_k7):
        _rank_zero()
        before = _rank_counts()
        out["y"] = plan.spmv_sharded(plan.shard_vector(xt)).cpu().numpy()
        out["matvec"] = _rank_since(before)
        for turn in TURNS:
            before = _rank_counts()
            with (graphs.eager() if turn.startswith("eager")
                  else contextlib.nullcontext()):
                (x, info), sec = wall(lambda: cg.jacobi_pcg_dist(
                    plan, diag, bt, **solve_kw))
            out["turns"][turn] = dict(x=x.cpu().numpy(), iters=info.iters,
                                      relres=float(info.relres), s=sec,
                                      launched=_rank_since(before))
        out["launches"] = _rank_all()
    xs = plan.shard_vector(xt)
    out["ms"] = device_ms(lambda: plan.spmv_sharded(xs), reps)
    out["exchange_ms"] = device_ms(lambda: dh.gather_halo_rank(
        xs, ops.index, mesh=mesh, h_pad=ops.h_pad, mode=plan.exchange),
        reps) if ops.h_pad else 0.0
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["span"] = (t_in, time.time())
    return out


def rank_gloo(mesh, dirs: dict, metas: dict, k: dict, reps: int) -> dict:
    """Phase 22 (b) on one of four gloo ranks sharing the card (every
    collective staged through the host): dist_fp16's y in both exchange
    modes and the global y, Y at nb = 8, one matvec of every tier and of
    the fp64 operator with its launches, ``jacobi_pcg_dist`` and
    ``adaptive_pcg_dist`` (eager: gloo's collectives cannot be
    captured), then a matvec's time by CUDA events, the exchange's wall
    and the rank's peak memory."""
    from repro_torch import distributed as dist
    from repro_torch.distributed import halo as dh
    from repro_torch.solvers import cg, graphs

    t_in = time.time()
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    plan = dist.DistSpMVPlan(_rank_ops(mesh, dirs["dist_fp16"],
                                       metas["dist_fp16"]), mesh)
    tiers = [f"tier{i}" for i in range(len(k["labels"]))]
    ladder = dist.DistTierLadder(
        [_rank_ops(mesh, dirs[t], metas[t]) for t in tiers],
        _rank_ops(mesh, dirs["hi"], metas["hi"]), mesh,
        labels=k["labels"], sub32=k["sub32"])
    torch.cuda.synchronize(dev)
    out = {"rank": mesh.rank, "load_s": time.perf_counter() - t0,
           "per": {}}
    t0 = time.perf_counter()
    xt = torch.from_numpy(k["xi"]).to(dev)
    with graphs.LEDGER.watch(_rank_raw), graphs.LEDGER.watch(_rank_k7):
        _rank_zero()
        xs = plan.shard_vector(xt)
        for mode in ("ppermute", "all_gather"):
            before = _rank_counts()
            out[f"y_{mode}"] = plan.spmv_sharded(xs, mode=mode).cpu().numpy()
            out["per"]["dist_fp16"] = _rank_since(before)
        out["y_global"] = plan.spmv(xt).cpu().numpy()
        out["Y8"] = plan.spmv_sharded(plan.shard_vector(torch.from_numpy(
            k["Xi"]).to(dev)), multi_rhs=True).cpu().numpy()
        xis = ladder.shard_vector(xt.double())
        for t, ops in zip(tiers + ["hi"], ladder.tiers + [ladder.hi]):
            before = _rank_counts()
            ops.run(xis, mode=ladder.exchange, shared=ladder.dev["shared"])
            out["per"][t] = _rank_since(before)
        diag = k["diag"]
        out["checks_s"] = time.perf_counter() - t0
        before = _rank_counts()
        (x, info), out["jacobi_s"] = wall(lambda: cg.jacobi_pcg_dist(
            plan, diag, torch.from_numpy(k["b"]).to(dev), **k["jacobi_kw"]))
        out["jacobi"] = (x.cpu().numpy(), info.iters, float(info.relres),
                         _rank_since(before))
        before = _rank_counts()
        (x, info), out["adaptive_s"] = wall(lambda: cg.adaptive_pcg_dist(
            ladder, diag, torch.from_numpy(k["bn"]).to(dev),
            **k["adaptive_kw"]))
        out["adaptive"] = (x.cpu().numpy(), info.iters,
                           info.tier_history[:info.iters].tolist(),
                           info.promotions, info.tier_matvecs.tolist(),
                           info.hi_matvecs, _rank_since(before))
        out["launches"] = _rank_all()
    out["ms"] = timed(lambda: plan.spmv_sharded(xs), reps)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        dh.gather_halo_rank(xs, plan.ops.index, mesh=mesh,
                            h_pad=plan.ops.h_pad, mode=plan.exchange)
    torch.cuda.synchronize(dev)
    out["exchange_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["span"] = (t_in, time.time())
    return out


def fingerprint(t: torch.Tensor) -> tuple:
    """Two int64 sums of ``t``'s 32-bit patterns, plain and weighted by
    position (mod 65,521): equal tensors give equal pairs, a changed bit
    changes the first. Summed in chunks on ``t``'s device."""
    b = t.detach().contiguous().reshape(-1).view(torch.int32)
    s1 = torch.zeros((), dtype=torch.int64, device=b.device)
    s2 = torch.zeros((), dtype=torch.int64, device=b.device)
    step = 1 << 24
    for lo in range(0, b.numel(), step):
        c = b[lo:lo + step].to(torch.int64)
        w = torch.arange(lo, lo + c.numel(), device=b.device) % 65521 + 1
        s1 += c.sum()
        s2 += (c * w).sum()
    return int(s1), int(s2)


def state_fps(state, layout=None) -> dict:
    """:func:`fingerprint`s of a train state by reference leaf and layer:
    the master; m and v per shard held, a ``TrainState``'s modules as one
    shard, a ``ZeroState``'s slices (``layout``: its ``ZeroLeaf`` list; a
    stacked leaf's slice by its dim 0, which at one shard is its
    layers)."""
    from repro_torch.models import transformer as tfm

    def module(mod):
        named = dict(mod.named_parameters())
        return [[fingerprint(named[n]) for n in names]
                for _, names in tfm.reference_leaves(mod)]

    out = {"master": module(state.master)}
    for key in ("m", "v"):
        held = getattr(state, key)
        out[key] = [module(held)] if layout is None else [
            [[fingerprint(x[i]) for i in range(x.shape[0])] if leaf.stacked
             else [fingerprint(x)] for leaf, x in zip(layout, sl)]
            for sl in held]
    return out


def master_gap(params, ref: list, base=None) -> tuple:
    """(|params - ref|, |ref - base|): 2-norms over every element, summed
    in float64. ``params`` and ``base``: tensors on the card (``base``
    None: the second is 0.0); ``ref``: host tensors in the same order."""
    d1 = d0 = 0.0
    for i, p in enumerate(params):
        r = ref[i].to(p.device)
        d1 += float(torch.sum(torch.square((p.detach() - r).double())))
        if base is not None:
            d0 += float(torch.sum(torch.square((r - base[i]).double())))
    return d1 ** 0.5, d0 ** 0.5


def own_gradient_alone(reduce):
    """A planted fault for phase 23 (b)'s master check: ``reduce``
    (``launch.steps.reduce_gradients``) on a stacked mesh as if every
    shard had received its own gradient from each shard in place of the
    others', so each shard's slices come from its gradient alone."""
    def faulty(mesh, layout, grads, *, mean=True):
        return [reduce(mesh, layout, [g] * len(grads), mean=mean)[i]
                for i, g in enumerate(grads)]
    return faulty


def own_partial_alone(mesh, rows):
    """A planted fault for phase 24 (a)'s master check, in place of
    ``launch.mesh._scatter_rows`` (the row-parallel products'
    reduce-scatter): each shard keeps its own row of its own partial, the
    other model shards' partials dropped."""
    return [x[mesh.model_index(s)] for x, s in zip(rows, mesh.local)]


def _train_cfg(spec: dict, run: dict):
    import dataclasses

    cfg = spec["cfg"]
    return cfg if run.get("layers") is None else dataclasses.replace(
        cfg, n_layers=run["layers"])


def _train_tcfg(spec: dict, run: dict, ckpt_dir: str):
    from repro_torch.train import TrainerConfig

    return TrainerConfig(
        steps=run["steps"], ckpt_dir=ckpt_dir,
        ckpt_every=run.get("ckpt_every") or 10 ** 9, log_every=10 ** 9,
        seed=spec["seed"], seq_len=spec["seq_len"],
        global_batch=spec["batch"], data_axis=run["data"],
        pods=run["pods"], pod_wire=run.get("pod_wire"),
        grad_compression=run.get("grad_compression"))


def _wrap_collectives(stat: dict):
    """Wrap the collectives a rank's mesh calls: the exchange's wall into
    ``stat["s"]`` and the bytes this rank sends to the others by wire
    dtype into ``stat["b"]`` (the 16-bit patterns travel as bfloat16).
    Returns the undo."""
    from repro_torch.parallel import collectives as co

    stat.update(s=0.0, b=collections.Counter(), depth=0)
    orig = {name: getattr(co, name) for name in ("all_to_all", "all_gather")}

    def wrap(name):
        fn = orig[name]

        def call(x, mesh, members=None):
            if stat["depth"]:
                return fn(x, mesh, members)
            n = mesh.size if members is None else len(members)
            stat["depth"] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(x, mesh, members)
                torch.cuda.synchronize()
            finally:
                stat["depth"] -= 1
            stat["s"] += time.perf_counter() - t0
            nbytes = x.numel() * x.element_size()
            stat["b"][str(x.dtype).removeprefix("torch.")] += (
                nbytes * (n - 1) // n if name == "all_to_all"
                else nbytes * (n - 1))
            return out
        return call

    co.all_to_all, co.all_gather = wrap("all_to_all"), wrap("all_gather")

    def undo():
        co.all_to_all, co.all_gather = orig["all_to_all"], orig["all_gather"]
    return undo


def _timed_exchange(trainer, rec: dict):
    """Wrap ``trainer``'s step and the collectives its mesh calls: per step
    the host wall and CUDA-event time, and the exchange's wall and the
    bytes this rank sends (:func:`_wrap_collectives`). Returns the
    undo."""
    stat = {}
    step_fn = trainer._step_fn

    def step(state, errs, batches):
        stat["s"], stat["b"] = 0.0, collections.Counter()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        out = step_fn(state, errs, batches)
        e1.record()
        torch.cuda.synchronize()
        rec["wall"].append(time.perf_counter() - t0)
        rec["ev"].append(e0.elapsed_time(e1))
        rec["xchg_s"].append(stat["s"])
        rec["wire_bytes"].append(dict(stat["b"]))
        return out

    functools.update_wrapper(step, step_fn)
    trainer._step_fn = step
    undo_co = _wrap_collectives(stat)

    def undo():
        undo_co()
        trainer._step_fn = step_fn
    return undo


def _rank_train_run(mesh, spec: dict, key: str) -> dict:
    """One of phase 23's runs on this rank's mesh: the trainer from the
    seed's initial master, timed (:func:`_timed_exchange`), its losses,
    state fingerprints and peak memory."""
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer

    run = spec["runs"][key]
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    ckpt_dir = str(Path(spec["root"], key))
    t = Trainer(_train_cfg(spec, run), OptConfig(**spec["opt"]),
                _train_tcfg(spec, run, ckpt_dir), mesh=mesh,
                log_fn=lambda _: None)
    rec = {"wall": [], "ev": [], "xchg_s": [], "wire_bytes": []}
    undo = _timed_exchange(t, rec)
    try:
        state, sec = wall(t.run)
    finally:
        undo()
    rec.update(losses=[h["loss"] for h in t.history], run_s=sec,
               fps=state_fps(state, t._step_fn.layout),
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               ckpts=t.ckpt.steps(), backend=mesh.backend,
               n_par=sum(p.numel() for p in state.master.parameters()))
    return rec


def _warm_up(spec: dict, dev) -> None:
    """This process's first training step on the card (a process's first
    one takes 13-16 s), on one row: the first step of a run over both
    ranks then waits for no rank's."""
    from repro_torch.data import DataConfig, SyntheticTokenStream
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm

    cfg = spec["cfg"]
    master = tfm.init_params(cfg, spec["seed"], device=dev,
                             dtype=torch.float32).requires_grad_(True)
    batch = SyntheticTokenStream(DataConfig(
        vocab=cfg.vocab, seq_len=spec["seq_len"], global_batch=1,
        seed=spec["seed"])).next_batch(dev)
    steps.value_and_grad(cfg, master, batch)
    torch.cuda.synchronize(dev)


def rank_train(mesh, spec: dict) -> dict:
    """Phases 23 and 24 on one rank of a gloo group sharing the card (every
    collective staged through the host): (a) on rank 0 alone, over a
    one-rank group of ``spec["a_backend"]`` (NCCL), while the others take
    their first training step (:func:`_warm_up`; rank 1 on phase 23's
    model, the others on phase 24's) and wait; then each run of
    ``spec["order"]`` over ranks 0 and 1 (a subgroup every rank makes,
    where the group has more); then, with ``spec["model"]``, phase 24's
    runs over the same processes (:func:`rank_model`), so that their start
    and first steps are paid once, and with ``spec["serve"]`` phase 25's
    prefill and decode runs (:func:`rank_serve`). With ``spec["order"]``
    alone and no ``"a"`` run: the runs on whatever group spawned the ranks
    ((c): NCCL, one rank per card)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import collectives as co

    t_in = time.time()
    out = {"rank": mesh.rank, "device": str(mesh.device)}
    pair = dist.new_group([0, 1]) if mesh.size > 2 else None
    if "a" in spec["runs"]:
        one = dist.new_group([0], backend=spec["a_backend"])
        if mesh.rank == 0:
            out["a"] = _rank_train_run(make_debug_mesh(
                data=1, device=mesh.device, group=one), spec, "a")
        else:
            m = spec.get("model")
            warm = spec if mesh.rank == 1 or m is None else dict(
                m, cfg=_train_cfg(m, m["runs"]["b"]))
            out["warm_s"] = wall(lambda: _warm_up(warm, mesh.device))[1]
            gc.collect()
            torch.cuda.empty_cache()
        co.gather_values([0], mesh)        # the other ranks wait here
    if mesh.rank < 2:
        for key in spec["order"]:
            run = spec["runs"][key]
            out[key] = _rank_train_run(make_debug_mesh(
                data=run["data"], pods=run["pods"], device=mesh.device,
                group=pair), spec, key)
    if "model" in spec:
        co.gather_values([0], mesh)        # ranks 2 and 3 wait here
        out["model"] = rank_model(mesh, spec["model"], pair)
    if "serve" in spec:
        gc.collect()
        torch.cuda.empty_cache()
        out["serve"] = rank_serve(mesh, spec["serve"], pair)
    out["span"] = (t_in, time.time())
    return out


def rank_all(mesh, nccl_args: tuple, gloo_args: tuple, spec: dict) -> dict:
    """Phases 22, 23 and 24 on one of four gloo ranks sharing the card, in
    one spawn: 22 (a) on rank 0 over a one-rank NCCL group made inside the
    gloo world (:func:`rank_nccl`), the others waiting; 22 (b) on all four
    (:func:`rank_gloo`); then, their operands freed, the training runs of
    phases 23 and 24 (:func:`rank_train`)."""
    import torch.distributed as dist

    from repro_torch.parallel import collectives as co
    from repro_torch.parallel.sharding import make_rank_mesh

    t_in = time.time()
    one = dist.new_group([0], backend="nccl")
    out = {}
    if mesh.rank == 0:
        out["a"] = rank_nccl(make_rank_mesh(one, device=mesh.device),
                             *nccl_args)
    co.gather_values([0], mesh)            # the other ranks wait here
    out["b"] = rank_gloo(mesh, *gloo_args)
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = rank_train(mesh, spec)
    out["span"] = (t_in, time.time())
    return out


def tp_fps(state, errors=None) -> dict:
    """:func:`fingerprint`s of a mesh ``ZeroState``: each held shard's
    master (its pieces, or the whole model's parameters where every model
    shard holds it), m and v slices, and its error-feedback buffers where
    ``errors`` (``Trainer.errors``) holds them."""
    out = {"master": [[fingerprint(x) for x in sh]
                      for sh in state.held_masters()],
           **{k: [[fingerprint(x) for x in sh] for sh in getattr(state, k)]
              for k in ("m", "v")}}
    if errors is not None:
        out["errors"] = [[fingerprint(x) for x in sh] for sh in errors]
    return out


def _model_tcfg(spec: dict, run: dict, ckpt_dir: str):
    from repro_torch.train import TrainerConfig

    return TrainerConfig(
        steps=run["steps"], ckpt_dir=ckpt_dir, ckpt_every=10 ** 9,
        log_every=10 ** 9, seed=spec["seed"], seq_len=spec["seq_len"],
        global_batch=spec["batch"], data_axis=run["data"],
        model_axis=run["model"], pods=run.get("pods", 1),
        pod_wire=run.get("pod_wire"),
        grad_compression=run.get("grad_compression"))


def _flop_step(t) -> int:
    """``FlopCounterMode``'s FLOPs of one step of trainer ``t`` on a fresh
    state and the next batch, every rank of its mesh taking part. Counted
    apart from the run: the counter decomposes the ops it has no formula
    for, which can move the bits."""
    from torch.utils.flop_counter import FlopCounterMode

    state = t.init_or_restore()
    errs = None if t.tcfg.grad_compression is None else [
        [torch.zeros_like(p) for p in state.master.parameters()]
        for _ in t.mesh.local]
    batches = t.data.next_placed_batch(t.mesh)
    with FlopCounterMode(display=False) as fc:
        t._step_fn(state, errs, batches)
    return int(fc.get_total_flops())


def _rank_model_run(mesh, spec: dict, key: str) -> dict:
    """One of phase 24's runs on this rank's mesh: the trainer from the
    seed's initial master, timed (:func:`_timed_exchange`), its losses,
    state fingerprints and peak memory."""
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer

    run = spec["runs"][key]
    dev = mesh.device
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t = Trainer(_train_cfg(spec, run), OptConfig(**spec["opt"]),
                _model_tcfg(spec, run, str(Path(spec["root"], key))),
                mesh=mesh, log_fn=lambda _: None)
    rec = {"wall": [], "ev": [], "xchg_s": [], "wire_bytes": []}
    undo = _timed_exchange(t, rec)
    try:
        state, sec = wall(t.run)
    finally:
        undo()
    held = state.held_masters()[0]
    rec.update(losses=[h["loss"] for h in t.history], run_s=sec,
               fps=tp_fps(state, t.errors),
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               backend=mesh.backend, n_par=sum(p.numel() for p in held))
    if run.get("count_flops"):
        del state
        rec["flop_counter"], rec["flop_step_s"] = wall(lambda: _flop_step(t))
    return rec


def rank_model(mesh, spec: dict, pair=None) -> dict:
    """Phase 24's runs of ``spec["order"]`` on one rank, one after another,
    each over the ranks its mesh needs (the first two: ``pair``, a
    subgroup every rank made; all: the whole group), the others waiting
    for it: (b) and (c) over four gloo ranks sharing the card, in phase
    23's spawn (:func:`rank_train`); (d) over two NCCL ranks, one per
    card, spawned alone."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import collectives as co

    out = {"rank": mesh.rank, "span": [time.time()]}
    for key in spec["order"]:
        run = spec["runs"][key]
        pods = run.get("pods", 1)
        n = pods * run["data"] * run["model"]
        if mesh.rank < n:
            out[key] = _rank_model_run(make_debug_mesh(
                data=run["data"], model=run["model"], pods=pods,
                device=mesh.device, group=None if n == mesh.size else pair),
                spec, key)
        co.gather_values([0], mesh)        # the next run starts together
    out["span"].append(time.time())
    return out


def fp_any(t: torch.Tensor) -> tuple:
    """:func:`fingerprint` of a tensor of any 2- or 4-byte dtype (a 16-bit
    element's pattern widened to 32 bits)."""
    t = t.detach().contiguous()
    if t.element_size() == 2:
        t = t.view(torch.int16).to(torch.int32)
    return fingerprint(t)


def _serve_cfg(key: str):
    from repro_torch import configs

    return configs.get(SERVE_RUNS[key][0])


def own_partials(ctx, xs):
    """A planted fault for phase 25, in place of
    ``models.tensor_parallel._row_sum`` (the decode's row-parallel sums):
    each model shard keeps its own partial."""
    return list(xs)


def serve_steps(mesh, spec: dict, key: str, *, keep: bool = False) -> dict:
    """Phase 25's run ``key`` (:data:`SERVE_RUNS`) on ``mesh`` (a rank's,
    or the stacked form on the card): the model drawn from
    ``spec["seed"]`` in one bf16 copy, each held shard's pieces
    (``tensor_parallel.serve_pieces``), the prefill of the run's prompts
    into a cache of ``SERVE_MAX_LEN`` positions (``launch.steps.
    make_prefill_step`` on the mesh), then ``SERVE_TICKS`` greedy steps
    (``forward_decode``, then the argmax across the shards, as
    ``make_decode_step``'s). Returns per held shard the fingerprints of
    the logits and tokens of each step and of the cache after the prefill
    and after the last step; per step the host wall, the exchange's wall
    and the bytes sent by dtype (:func:`_wrap_collectives`); the peak
    memory. With ``keep`` also each step's logits and tokens on the host,
    the pieces and a copy of the prefill's cache (the planted fault's
    start)."""
    from repro_torch.launch import steps
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models import transformer as tfm

    cfg = _serve_cfg(key)
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    params = tfm.init_params(cfg, spec["seed"], device=dev, dtype=cfg.dtype)
    prefill = steps.make_prefill_step(cfg, SERVE_MAX_LEN, mesh)
    ctx = prefill.ctx
    pieces = tp.serve_pieces(ctx.layout, params, ctx.ranks)
    del params
    prompts = torch.from_numpy(spec["prompts"][SERVE_RUNS[key][0]]).to(dev)
    rows = SERVE_ROWS // mesh.dp_size
    batches = [{"tokens": prompts[q * rows:(q + 1) * rows]}
               for q in (mesh.dp_index(s) for s in mesh.local)]
    rec = {"wall": [], "xchg_s": [], "wire_bytes": [], "logits": [],
           "tokens": [], "rule": ctx.plan.rule, "host": []}
    stat = {}
    undo = _wrap_collectives(stat)

    def timed(fn):
        stat["s"], stat["b"] = 0.0, collections.Counter()
        out, sec = wall(fn)
        rec["wall"].append(sec)
        rec["xchg_s"].append(stat["s"])
        rec["wire_bytes"].append(dict(stat["b"]))
        return out

    def caches_fps(caches):
        return [{k: fp_any(v) for k, v in c.items()} for c in caches]

    def decode():
        lg, cs = tp.forward_decode(ctx, pieces, toks, caches)
        return lg, cs, tp.next_tokens(ctx, lg)

    try:
        logits, caches = timed(lambda: prefill(pieces, batches))
        rec["cache_prefill"] = caches_fps(caches)
        if keep:
            rec["start"] = [{k: v.clone() for k, v in c.items()}
                            for c in caches]
        toks = tp.next_tokens(ctx, logits)
        for i in range(SERVE_TICKS + 1):
            if i:
                logits, caches, toks = timed(decode)
            rec["logits"].append([fp_any(x) for x in logits])
            rec["tokens"].append([fp_any(x) for x in toks])
            if keep:
                rec["host"].append(([x.cpu() for x in logits],
                                    [x.cpu() for x in toks]))
    finally:
        undo()
    rec["cache"] = caches_fps(caches)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if keep:
        rec.update(pieces=pieces, ctx=ctx)
    return rec


def rank_serve(mesh, spec: dict, pair=None) -> dict:
    """Phase 25's runs of ``spec["order"]`` on one of four gloo ranks
    sharing the card, in phase 22's spawn after phase 24's runs, each over
    the ranks its mesh needs (the first two: ``pair``, a subgroup every
    rank made; all four: the whole group), the others waiting; and the
    launches of this repository's kernels the runs made."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import collectives as co

    out = {"rank": mesh.rank, "span": [time.time()]}
    before = _rank_all()
    for key in spec["order"]:
        _, data, model = SERVE_RUNS[key]
        n = data * model
        if mesh.rank < n:
            gc.collect()
            torch.cuda.empty_cache()
            out[key] = serve_steps(make_debug_mesh(
                data=data, model=model, device=mesh.device,
                group=None if n == mesh.size else pair), spec, key)
        co.gather_values([0], mesh)        # the next run starts together
    out["launches"] = {k: v - before[k] for k, v in _rank_all().items()}
    out["span"].append(time.time())
    return out


def _spans(t_spawn: float, t_end: float, out: list) -> str:
    """Where a spawn's wall went: the ranks' start (processes, imports,
    the process group, the card), their work, and their teardown."""
    t_in = min(r["span"][0] for r in out)
    t_out = max(r["span"][1] for r in out)
    return (f"start {t_in - t_spawn:.1f} s, work {t_out - t_in:.1f} s, "
            f"teardown {t_end - t_out:.1f} s")


class Smoke:
    """The phases; ``dev`` is the CUDA device, sizes are the full ones
    unless a caller shrinks them."""

    def __init__(self, dev, *, main_side=104, check_side=32,
                 suite="small", reps=50, force="auto", force_mixed="auto",
                 force_band="auto"):
        from repro_torch.core import testmats
        from repro_torch.kernels import packsell_spmv as kpk
        from repro_torch.kernels import row_dots as krd
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
        # K7, the distributed solvers' per-shard dots, runs in phases 13
        # and 22 only: its count stays out of counts(), so the other
        # phases' launch checks read K1-K6 alone
        self.k7 = krd.row_dots
        self.k7_row = None          # its times, from phase 13
        self.keep20 = None          # phase 20's first steps, for phase 23
        ids = ("K1", "K2", "K3", "K4", "K5", "K6", "K2-f64", "K7")
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

    def k7_counts(self) -> dict:
        """K7's count, watched by ``graphs.LEDGER`` beside
        :meth:`raw_counts`."""
        return {"K7": self.k7.launches}

    def k7_ran(self) -> int:
        from repro_torch.solvers import graphs

        return graphs.LEDGER.ran(self.k7_counts())["K7"]

    def zero_counts(self) -> None:
        from repro_torch.solvers import graphs

        for k in (self.k1, self.k2, self.k3, self.k4, self.k5, self.k6,
                  self.k7):
            k.launches = 0
        self.k2.launches_f64 = 0
        for k in (*self.raw_counts(), "K7"):
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
            if k != "K7":           # K7 is held to its plain version in 13
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
        mark("analysis and tier builds (host)")
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

        mark("adaptive_pcg in turns")
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
        mark("K5; e8m/D8 uniform build (host); K6")
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

        mark("the plain bodies' solve")
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
        mark("operator builds (host)")
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
            mark("pcg_reference in turns")
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

            mark("IO-CG's five variants in turns")
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

            mark("F3R's presets")
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

        mark("m_in 20, 50 and 80")
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
        mark("IO-CG e8m8 on the plain bodies")
        self.sync_free(a_s, ops_k, m_in)
        mark("the fixed-iteration solvers, sync-free")
        self.tri_solve(a_s)
        mark("the triangular solve")
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
        # (262,144 rows: the store's miss, hit and retile do not depend on
        # the size, and 1,048,576 rows took 41 s of host builds)
        t0 = time.perf_counter()
        sc, _ = row_scale(testmats.scattered(SCATTERED_ROWS, nnz_per_row=17))
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
            print(f"  mixed:1e-3 on row-scaled scattered({SCATTERED_ROWS}, "
                  f"17): "
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

            mark("register and warmup")
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

            mark("steady traffic and y per tier")
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

            mark("slot walls, copies, a burst's profile")
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

            mark("a solve request")
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

            mark("overload")
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
                # under the entry's lock, as the rebuild itself: no slot
                # binds the repaired plan before the second flip lands (a
                # success between the trips would reset the breaker's
                # count of consecutive failures)
                with entry.lock:
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

    # -- phase 13: distribution on the card -----------------------------------
    def dist_path(self, mp, mx, k1_ms, shards: int = 4):
        """Phase 4's matrix as ``shards`` row blocks on one card
        (``make_shard_mesh(shards, devices=[dev] * shards)``): the
        distributed fp16 SpMV and SpMM in both exchange modes against the
        port's ``reference_spmv`` (the stacked host arrays replayed on the
        CPU through the plain bodies), against ``plan_fp16`` and against
        P = 1; ``jacobi_pcg_dist`` and ``adaptive_pcg_dist`` (phase 5's
        tier ladder, ``OperatorSet.dist_adaptive_tiers``, each tier's and
        the fp64 operator's shard bodies held to the CPU replay first) in
        turns; ``dist_auto:1e-3`` at P = shards (the call that kind
        makes) and ``dist_mixed:1e-3`` at P = 1 through ``OperatorSet``,
        and three classes per shard through ``dist_mixed:``'s call at P =
        shards;
        ``corrupt_dist_checkpoint`` over 5 seeds, reaching a captured
        graph and undone; then the device time of a matvec, the exchange's
        share and the device ops."""
        from repro_torch import distributed as dist
        from repro_torch.distributed import halo as dh
        from repro_torch.kernels import packsell_spmv as kpk
        from repro_torch.distributed.partition import partition_rows
        from repro_torch.parallel import make_shard_mesh
        from repro_torch.precision import PrecisionClass, PrecisionPlan
        from repro_torch.precision.store import select_codec_per_shard
        from repro_torch.robust import inject
        from repro_torch.solvers import cg, graphs

        s = mp["a"]
        n = s.shape[0]
        P = shards
        self.zero_counts()
        mesh = make_shard_mesh(P, devices=[self.dev] * P)
        mesh1 = make_shard_mesh(1, devices=[self.dev])
        kw = dict(C=32, sigma=256)
        d4, b4 = wall(lambda: dist.build_dist_plan(
            s, mesh=mesh, codec="fp16", D=15, **kw))
        d1, b1 = wall(lambda: dist.build_dist_plan(
            s, mesh=mesh1, codec="fp16", D=15, **kw))
        st = d4.memory_stats()

        mark("dist_fp16 builds, P = 4 and 1 (host)")
        def variants(ops):
            """Each member's label and its shards' plan variants (SELL
            members run K2), of a plan's or a tier's operands."""
            return [(dm.label, ["sell"] if dm.plans is None else
                     sorted({p.variant for p in dm.plans}))
                    for dm in getattr(ops, "ops", ops).members]

        def per_matvec(ops):
            """The launches one matvec of a plan's or a tier's operands
            makes: each member runs its kernel once per shard (a SELL
            member once per bucket and shard; K2's count holds its float64
            launches too)."""
            want = collections.Counter()
            for dm in getattr(ops, "ops", ops).members:
                if dm.plans is None:
                    nk = sum(len(m.vals) for m in dm.mats)
                    want["K2"] += nk
                    if dm.codec == "fp64":
                        want["K2-f64"] += nk
                else:
                    for pl in dm.plans:
                        want[{"fused": "K1", "full": "K4",
                              "band": "K6"}[pl.variant]] += 1
            return dict(want)

        def launched(run):
            """``run()`` and the launches it made on the device."""
            before = self.counts()
            out = run()
            return out, {k: v - before[k] for k, v in self.counts().items()
                         if v != before[k]}

        print(f"  dist_fp16 at P = {P} on one card: built in {b4:.1f} s "
              f"(host), P = 1 in {b1:.1f} s; n_pad {st['n_pad']}, h_pad "
              f"{st['h_pad']}, halo entries {st['halo_entries']}, k_max "
              f"{st['halo_k_max']}, shard bytes max {st['max_shard_bytes']}"
              f" min {st['min_shard_bytes']}, composite "
              f"{st['composite_bytes']} B ({st['bytes_per_nnz']!r} B/nnz); "
              f"members {variants(d4)}; P = 1 {variants(d1)}", flush=True)
        print(f"  a member plan's policy: "
              f"{d4.ops.members[0].plans[0].policy}", flush=True)
        for dp in (d4, d1):
            for label, vs in variants(dp):
                if vs != ["fused"]:
                    fail(f"dist_fp16 member {label} runs {vs}, not K1")
        rng = np.random.default_rng(31)
        xi_h = rng.integers(-8, 9, n).astype(np.float32)
        xr_h = rng.standard_normal(n).astype(np.float32)
        xi = torch.from_numpy(xi_h).to(self.dev)
        xr = torch.from_numpy(xr_h).to(self.dev)
        Xr = torch.from_numpy(rng.standard_normal((n, 4)).astype(
            np.float32)).to(self.dev)

        # one matvec and one SpMM: their launches; the two modes
        members = len(d4.ops.members)
        for what, run, want in (
                ("spmv", lambda: d4.spmv(xi), {"K1": members * P}),
                ("spmm nb=4", lambda: d4.spmm(Xr), {"K3": members * P})):
            before = self.counts()
            run()
            got = {k: v - before[k] for k, v in self.counts().items()
                   if v != before[k]}
            if got != want:
                fail(f"dist_fp16 {what} launched {got}, want {want}")
        y_pp = d4.spmv(xi, mode="ppermute")
        y_ag = d4.spmv(xi, mode="all_gather")
        same_bits(y_pp, y_ag, "dist_fp16: ppermute vs all_gather")
        mark("spmv/spmm launches, the two modes")
        t0 = time.perf_counter()
        for mode in dh.EXCHANGE_MODES:
            y_cpu = torch.from_numpy(dist.reference_spmv(d4.ops, xi_h, mode))
            same_bits(y_pp.cpu(), y_cpu, f"dist_fp16 (integer x) vs the CPU "
                      f"replay ({mode})")
        replay_s = time.perf_counter() - t0
        mark("dist_fp16's CPU replays")
        y_replay = y_cpu            # dist_fp16's replay, kept for phase 22
        y4r = d4.spmv(xr)
        same_bits(y4r, d4.spmv(xr, mode="all_gather"),
                  "dist_fp16 (N(0, 1) x): ppermute vs all_gather")
        y1r = d1.spmv(xr)
        yp = mp["plan"].spmv(mp["mat"], xr)
        err4 = float(((y4r - yp).abs() - 2e-5 * yp.abs()).max())
        print(f"  y at P = {P}: ppermute and all_gather equal bit for bit; "
              f"equal to the CPU replay (reference_spmv, plain bodies) bit "
              f"for bit on integer x in both modes ({replay_s:.1f} s); on "
              f"N(0, 1) x |y4 - plan_fp16| max {max_abs(y4r, yp)!r}, "
              f"|y4 - y1| max {max_abs(y4r, y1r)!r}, |y1 - plan_fp16| max "
              f"{max_abs(y1r, yp)!r}", flush=True)
        if err4 > 2e-5:
            fail(f"dist_fp16 at P = {P} not within 2e-5 of plan_fp16: "
                 f"{err4}")
        Y = d4.spmm(Xr)
        for j in range(Xr.shape[1]):
            same_bits(Y[:, j], d4.spmv(Xr[:, j].contiguous()),
                      f"dist_fp16 spmm column {j} vs spmv")
        print("  spmm nb = 4 (K3 per member and shard): every column equal "
              "to the spmv of that column bit for bit", flush=True)

        mark("y and spmm checks")
        # jacobi_pcg_dist, as phase 4's solve
        b = torch.ones(n, dtype=torch.float64, device=self.dev)
        diag = s.diagonal()

        def each(turn, x, info, launched):
            steps = info.iters if turn.startswith("eager") else \
                chunk_steps(info.iters, cg.PCG_CHUNK)
            if launched["K1"] != members * P * (steps + 1):
                fail(f"jacobi_pcg_dist {turn}: K1 launches "
                     f"{launched['K1']} != {members * P} x (steps + 1) "
                     f"({steps + 1})")

        runs = self.in_turns(lambda: cg.jacobi_pcg_dist(
            d4, diag, b, tol=1e-8, maxiter=2000), "jacobi_pcg_dist", each)
        x, info = runs["capture"][:2]
        relres = float(info.relres)
        # phase 4's solve again (its graphs replay): the same fp16 operator
        # on one device
        x1, _ = cg.jacobi_pcg_stored(mp["mat"], mp["plan"], diag, b,
                                     tol=1e-8, maxiter=2000)
        dx = float(torch.linalg.vector_norm(x - x1)
                   / torch.linalg.vector_norm(x1))
        x_h = x.cpu().numpy()
        true_rel = float(np.linalg.norm(1.0 - s @ x_h) / np.sqrt(n))
        true_1 = float(np.linalg.norm(1.0 - s @ x1.cpu().numpy())
                       / np.sqrt(n))
        print(f"  jacobi_pcg_dist (fp16, tol 1e-8): iterations {info.iters} "
              f"(phase 4, one device: {mp['iters']}), recurrence relres "
              f"{relres!r}; ||x - x_phase4|| / ||x_phase4|| {dx!r}; true "
              f"relres vs unquantized s (host float64) {true_rel!r}, phase "
              f"4's x {true_1!r} (both the fp16 operator's quantization, "
              f"not the solve's); the same x bit for bit in every run; "
              f"walls {turn_walls(runs)}", flush=True)
        if not relres < 1e-8 or not np.isfinite(x_h).all():
            fail(f"jacobi_pcg_dist: recurrence relres {relres} not < 1e-8")
        if not dx <= 1e-4:         # the reference's rule (rtol 1e-4)
            fail(f"jacobi_pcg_dist: x {dx} from phase 4's x")

        mark("jacobi_pcg_dist in turns")
        # adaptive_pcg_dist over phase 5's ladder
        ops_k = mx["ops"]
        ladder, lb = wall(lambda: ops_k.dist_adaptive_tiers(
            1e-3, mesh=mesh, n_probes=2))
        print(f"  tier ladder at P = {P}: {ladder.labels} + fp64, built in "
              f"{lb:.1f} s (host); members "
              f"{[variants(o) for o in ladder.tiers]}", flush=True)
        # every tier's and the fp64 operator's shard bodies on the card,
        # at the solve's dtype, against the CPU replay (the plain bodies)
        mark("the ladder at P = 4 (host)")
        xis = ladder.shard_vector(xi.double())
        t0 = time.perf_counter()
        for label, t in zip(ladder.labels + ["fp64"],
                            ladder.tiers + [ladder.hi]):
            vs = sorted({v for _, v_ in variants(t) for v in v_})
            if label.startswith("e8m") and vs != ["full"]:
                fail(f"tier {label} runs {vs}, not K4 ('full')")
            ys, got = launched(lambda: t.run(
                xis, mode=ladder.exchange, shared=ladder.dev["shared"]))
            if got != per_matvec(t):
                fail(f"tier {label}: one matvec launched {got}, want "
                     f"{per_matvec(t)}")
            y = ladder.unshard_vector(ys).double().cpu()
            y_cpu = torch.from_numpy(dist.reference_spmv(t, xi_h)).double()
            for k in got:
                self.note(k, same_bits(y, y_cpu, f"tier {label} (integer "
                                       "x) vs its CPU replay"))
            print(f"  tier {label}: members {variants(t)}, one matvec "
                  f"launches {got}; y equal to the CPU replay bit for bit",
                  flush=True)
        print(f"  (the ladder's {len(ladder.tiers) + 1} CPU replays: "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        mark("the tiers' launches and CPU replays")
        b_h = np.random.default_rng(0).standard_normal(n)
        bn = torch.from_numpy(b_h).to(self.dev)
        runs = self.in_turns(lambda: cg.adaptive_pcg_dist(
            ladder, diag, bn, tol=1e-8, maxiter=60, m_in=16),
            "adaptive_pcg_dist")
        xa, ia = runs["capture"][:2]
        xa_h = xa.cpu().numpy()
        rel = float(np.linalg.norm(b_h - s @ xa_h) / np.linalg.norm(b_h))
        i5 = mx["info"]
        print(f"  adaptive_pcg_dist (tol 1e-8, m_in 16): outer steps "
              f"{ia.iters}, promotions {ia.promotions}, tier_history "
              f"{ia.tier_history[:ia.iters].tolist()}; phase 5 (one "
              f"device): {i5.iters} steps, {i5.promotions} promotions, "
              f"{i5.tier_history[:i5.iters].tolist()}; TRUE relres vs s "
              f"(host float64) {rel!r}; walls {turn_walls(runs)}", flush=True)
        if not rel <= 1e-8:
            fail(f"adaptive_pcg_dist: true relres {rel} > 1e-8")

        mark("adaptive_pcg_dist in turns")
        # dist_mixed:1e-3 and dist_auto:1e-3: each kind once and each P
        # once (at 1e-3 both select fp16/D15 alone on HPCG, the same
        # members); the pplan build at P = 4 runs below (three classes)
        want = s @ xr_h.astype(np.float64)
        pplan, sel_s = wall(lambda: ops_k.precision_plan(1e-3, mode="rows"))
        (_, fleet), fleet_s = wall(lambda: select_codec_per_shard(
            s, P, 1e-3, sigma=256))
        kinds = {
            f"dist_auto:1e-3, P = {P}": lambda: dist.build_dist_plan(
                s, classes=[(fleet.codec, fleet.D, None)], mesh=mesh, **kw),
            "dist_mixed:1e-3, P = 1": lambda: ops_k.dist_plan(
                "dist_mixed:1e-3")}
        print(f"  selection: rows mode {sel_s:.1f} s ({len(pplan.classes)} "
              f"classes {[(c.codec, c.D) for c in pplan.classes]}), per "
              f"shard at P = {P} {fleet_s:.1f} s (fleet {fleet.codec}/D"
              f"{fleet.D})", flush=True)
        mark("selection (host)")
        for what, build in kinds.items():
            dp, bs = wall(build)
            mark("dist_mixed: and dist_auto: builds (host)")
            y = dp.spmv(xr).double().cpu().numpy()
            err = float(np.abs(y - want).max() / np.abs(want).max())
            yi = dp.spmv(xi)
            same_bits(yi.cpu(), torch.from_numpy(dist.reference_spmv(
                dp.ops, xi_h)), f"{what} vs its CPU replay")
            print(f"  {what}: {dp.n_shards} shards, built in {bs:.1f} s; "
                  f"members {variants(dp)}; "
                  f"max |y - s x| / max |s x| {err!r} (budget 1e-3); equal "
                  f"to its CPU replay bit for bit on integer x", flush=True)
            mark("dist_mixed: and dist_auto: checks and CPU replays")
            if not err <= 1e-3:
                fail(f"{what}: error {err} over its budget 1e-3")

        # several classes per shard (the selector gives HPCG one class at
        # 1e-3, as above): each shard's rows in contiguous thirds at phase 9's
        # codecs, through the call dist_mixed: makes (pplan=). Each term
        # has three members; every shard has its own row maps.
        part = partition_rows(n, P)
        thirds = [np.array_split(np.arange(*part.rows_of(p)), 3)
                  for p in range(P)]
        pp3 = PrecisionPlan(mode="rows", classes=tuple(
            PrecisionClass(c, D, tuple(np.concatenate(
                [t[k] for t in thirds]).tolist()))
            for k, (c, D) in enumerate((("fp16", 15), ("e8m", 8),
                                        ("fp32", 0)))),
            error_budget=1e-3, rationale={"classes": "shard thirds, by hand"})
        d3, b3 = wall(lambda: dist.build_dist_plan(
            s, pplan=pp3, mesh=mesh, **kw))
        mark("three classes: build (host)")
        ys, got = launched(lambda: d3.spmv_sharded(d3.shard_vector(xi)))
        if got != per_matvec(d3):
            fail(f"three classes: one matvec launched {got}, want "
                 f"{per_matvec(d3)}")
        for mode in dh.EXCHANGE_MODES:
            y_cpu = torch.from_numpy(dist.reference_spmv(d3.ops, xi_h, mode))
            for k in got:
                self.note(k, same_bits(
                    d3.spmv(xi, mode=mode).cpu(), y_cpu,
                    f"three classes (integer x, {mode}) vs the CPU replay"))
        y = d3.spmv(xr).double().cpu().numpy()
        err = float(np.abs(y - want).max() / np.abs(want).max())
        print(f"  three classes per shard (thirds of each shard's rows: "
              f"fp16/D15, e8m/D8, fp32) at P = {P}: built in {b3:.1f} s; "
              f"members {variants(d3)}; one matvec launches {got}; equal to "
              f"the CPU replay bit for bit on integer x in both modes; max "
              f"|y - s x| / max |s x| {err!r} (budget 1e-3)", flush=True)
        if not err <= 1e-3:
            fail(f"three classes: error {err} over its budget 1e-3")

        mark("three classes: checks and CPU replays")
        # the fault: a shifted checkpoint, in place, reaching a graph
        xs = d4.shard_vector(xr)
        g = graphs.Graph(lambda: d4.spmv_sharded(xs), self.dev)
        y0g = g().clone()
        y0g = g().clone()
        y0 = d4.spmv(xr)
        for seed in range(5):
            inj = inject.corrupt_dist_checkpoint(d4, seed)
            k = int(inj.detail["key"][1:].split("_")[0])
            arr = d4.dev[inj.detail["key"]]
            p, gi, c = np.unravel_index(inj.detail["index"], arr.shape)
            dm = d4.ops.members[k]
            lay = dm.plans[p].fused_layout
            v, _ = kpk.fused_decode_word(
                dm.plans[p].fused[0][gi, :, c], dm.mats[p].codec, dm.D,
                lay.encoding, lay.scale)
            neutral = not bool((v != 0).any())
            y1 = d4.spmv(xr)
            y1g = g().clone()
            changed = not torch.equal(y1, y0)
            same_bits(d4.unshard_vector(y1g), y1,
                      f"fault seed {seed}: graph replay vs eager")
            inj.undo()
            same_bits(d4.spmv(xr), y0, f"fault seed {seed}: y after undo")
            same_bits(g(), y0g, f"fault seed {seed}: replay after undo")
            print(f"  fault seed {seed}: {inj.detail}, shard {p} of "
                  f"{dm.label}; y changed {changed} (the lane's words "
                  f"{'are all zero: value-neutral' if neutral else 'carry values'}), "
                  f"the captured graph's replay equal to the eager y; undo "
                  f"restores y and the replay bit for bit", flush=True)
            if changed == neutral:
                fail(f"fault seed {seed}: y changed {changed} but the lane "
                     f"is {'neutral' if neutral else 'not neutral'}")
        mark("corrupt_dist_checkpoint")
        torch.cuda.synchronize()
        launches = {**self.counts(), "K7": self.k7_ran()}
        print(f"  launches in this run: {launches}", flush=True)
        if launches["K7"] < 1:
            fail("the distributed solves never launched K7 (row_dots)")
        # what phase 22 holds the ranks to (host copies, after this
        # phase's launches were read)
        self.keep13 = self.keep_for_ranks(
            s=s, d4=d4, d1=d1, ladder=ladder, xi_h=xi_h, y_cpu=y_replay,
            jacobi=(x, info, b), adaptive=(xa, ia, b_h),
            per_rank={label: {k_: v // P for k_, v in per_matvec(o).items()}
                      for label, o in [("dist_fp16", d4)]
                      + list(zip(ladder.labels + ["fp64"],
                                 ladder.tiers + [ladder.hi]))})

        mark("keep for phase 22")
        # device time per matvec, the exchange's share, the device ops
        reps = self.reps
        xs1 = d1.shard_vector(xr)
        t4 = device_ms(lambda: d4.spmv_sharded(xs), reps)
        t1 = device_ms(lambda: d1.spmv_sharded(xs1), reps)
        ex = {mode: device_ms(lambda: dh.gather_halo(
            xs, d4.ops.index, n_shards=P, h_pad=d4.ops.h_pad, mode=mode),
            reps) for mode in dh.EXCHANGE_MODES}
        e4 = timed(lambda: d4.spmv_sharded(xs), reps)
        e1 = timed(lambda: d1.spmv_sharded(xs1), reps)
        def bound(dp):
            """The matvec's bound: every member's stream and checkpoints,
            x and y once."""
            nbytes = sum(4 * t.numel() for k_, t in dp.dev.items()
                         if k_.endswith(("_fwords", "_fckpt"))) + 8 * n
            return (nbytes,) + bound_ms(nbytes, 2 * s.nnz)

        (nb4, tb, by), (nb1, tb1, by1) = bound(d4), bound(d1)
        before = self.raw_counts()
        ops_aten = aten_ops(lambda: d4.spmv_sharded(xs))
        ours = {k_: v - before[k_] for k_, v in self.raw_counts().items()
                if v != before[k_]}
        n_ops = sum(ours.values()) + len(ops_aten)
        print(f"  one matvec (CUDA graph of {reps} calls, device): P = {P} "
              f"{t4!r} ms, P = 1 {t1!r} ms, phase 6's K1 alone {k1_ms!r} ms; "
              f"bound (every member's stream and checkpoints, x and y "
              f"once) P = {P} {tb!r} ms by {by} ({nb4} B), P = 1 {tb1!r} "
              f"ms by {by1} ({nb1} B): P = {P} at {t4 / tb!r} x, P = 1 at "
              f"{t1 / tb1!r} x; exchange alone "
              f"{ex} ms, share of the P = {P} matvec "
              f"{ex['ppermute'] / t4!r}; eager (CUDA events over {reps} "
              f"calls) P = {P} {e4!r} ms, P = 1 {e1!r} ms; on "
              f"{card_line()}", flush=True)
        print(f"  its device ops (one P = {P} matvec, counted on the host): "
              f"{n_ops}: the kernels {ours} and {len(ops_aten)} aten ops "
              f"{dict(collections.Counter(ops_aten))}", flush=True)
        mark("device times and ops")
        self.k7_row = self.check_k7(d4.ops.n_pad, reps)
        return dict(launches=launches, t4=t4, t1=t1, ex=ex)

    def check_k7(self, n_pad: int, reps: int):
        """K7 at the distributed solves' shapes, ``[4, n_pad]`` and its
        rows as ``[1, n_pad]``, in float64 (Jacobi-PCG, the outer steps)
        and float32: each row's bits whatever the row count, the sums
        within a rounding bound of the plain version's, and whether one
        torch reduction over ``[4, n_pad]`` gives each row the bits of
        that row reduced alone (why K7 exists). Then its time at
        ``[4, n_pad]`` float64 against the plain loop, one
        ``torch.linalg.vecdot`` over the stack (the library call) and the
        bound. Returns the kernels line's row."""
        from repro_torch.kernels.row_dots import row_dots_plain

        rng = np.random.default_rng(13)
        same_torch = {}
        for dt in (torch.float64, torch.float32):
            a, b = (torch.from_numpy(v).to(self.dev, dt) for v in
                    rng.standard_normal((2, 4, n_pad)))
            got = self.k7(a, b)
            for p in range(4):
                same_bits(got[p:p + 1], self.k7(a[p:p + 1], b[p:p + 1]),
                          f"K7 {dt}: row {p} of [4, {n_pad}] vs the row "
                          "alone")
            ab = a.double() * b.double()
            scale = (1e-6 if dt == torch.float32 else 1e-14) \
                * ab.abs().sum(1)
            plain = row_dots_plain(a, b)
            if not bool(((got.double() - plain.double()).abs()
                         <= scale).all()):
                fail(f"K7 {dt}: |kernel - plain| {max_abs(got, plain)} "
                     f"over the bound {scale.tolist()}")
            self.note("K7", max_abs(got, plain))
            whole = torch.linalg.vecdot(a, b)
            same_torch[str(dt)] = [bool(torch.equal(
                whole[p], torch.linalg.vecdot(a[p], b[p]))) for p in range(4)]
        print(f"  K7 (row_dots) at [4, {n_pad}] and its rows, float64 and "
              f"float32: each row bit-equal to the row alone; max |kernel - "
              f"plain| {self.err['K7']!r} ({self.cases['K7']} cases, within "
              f"1e-14 and 1e-6 of the sum of |a b|); one torch.linalg.vecdot "
              f"over [4, {n_pad}] gives row p the bits of row p alone: "
              f"{same_torch}", flush=True)
        a, b = (torch.from_numpy(v).to(self.dev) for v in
                rng.standard_normal((2, 4, n_pad)))
        t = device_ms(lambda: self.k7(a, b), reps)
        tp = timed(lambda: row_dots_plain(a, b), reps)
        tl = timed(lambda: torch.linalg.vecdot(a, b), reps)
        tlg = device_ms(lambda: torch.linalg.vecdot(a, b), reps)
        te = timed(lambda: self.k7(a, b), reps)
        nbytes = 2 * a.numel() * 8 + 4 * 8
        tb, by = bound_ms(nbytes, 2 * a.numel())
        print(f"  K7 at [4, {n_pad}] float64: {t!r} ms (device, a CUDA "
              f"graph of {reps} calls; eager {te!r} ms), the plain loop "
              f"{tp!r} ms, one torch.linalg.vecdot {tl!r} ms eager and "
              f"{tlg!r} ms on the device (a CUDA graph of {reps} calls, as "
              f"K7), bound {tb!r} ms by {by} ({nbytes} B): {tb / t!r} of "
              f"the bound; on {card_line()}", flush=True)
        return (t, tp, tl, tb, by, te)

    def keep_for_ranks(self, *, s, d4, d1, ladder, xi_h, y_cpu, jacobi,
                       adaptive, per_rank) -> dict:
        """Phase 13's matrix, host dicts and answers, on the host, for
        phase 22 (which runs after the earlier phases' objects are
        freed): the stacked P = 4 y on integer x (its rows) and its CPU
        replay, Y at nb = 8, the P = 1 plan's y and a P = 1
        ``jacobi_pcg_dist`` through the graphs, the P = 4 solves' x and
        schedules, and each operand's launches per matvec and shard."""
        from repro_torch.solvers import cg

        x, info, b = jacobi
        xa, ia, b_h = adaptive
        n = s.shape[0]
        xi = torch.from_numpy(xi_h).to(self.dev)
        Xi = np.random.default_rng(22).integers(-8, 9, (n, 8)).astype(
            np.float32)
        jacobi_kw = dict(tol=1e-8, maxiter=2000)
        x1, i1 = cg.jacobi_pcg_dist(d1, s.diagonal(), b, **jacobi_kw)
        tiers = [f"tier{i}" for i in range(len(ladder.tiers))]
        return dict(
            s=s, diag=s.diagonal(), xi=xi_h, Xi=Xi, b=b.cpu().numpy(),
            bn=b_h, y_cpu=y_cpu.numpy(),
            y4=d4.spmv_sharded(d4.shard_vector(xi)).cpu().numpy(),
            Y8=d4.spmv_sharded(d4.shard_vector(torch.from_numpy(Xi).to(
                self.dev)), multi_rhs=True).cpu().numpy(),
            y1=d1.spmv_sharded(d1.shard_vector(xi)).cpu().numpy(),
            hosts={"p4": (d4.ops.host, d4.ops.meta),
                   "p1": (d1.ops.host, d1.ops.meta),
                   **{t: (o.host, o.meta) for t, o in zip(
                       tiers + ["hi"], ladder.tiers + [ladder.hi])}},
            labels=list(ladder.labels), sub32=ladder.sub32.tolist(),
            jacobi_kw=jacobi_kw,
            adaptive_kw=dict(tol=1e-8, maxiter=60, m_in=16),
            jacobi4=(x.cpu().numpy(), info.iters),
            jacobi1=(x1.cpu().numpy(), i1.iters, float(i1.relres)),
            adaptive4=(xa.cpu().numpy(), ia.iters,
                       ia.tier_history[:ia.iters].tolist(), ia.promotions),
            per_rank=dict(zip(["dist_fp16"] + tiers + ["hi"],
                              per_rank.values())),
            members1=len(d1.ops.members))

    # -- phase 22: distribution across processes ----------------------------
    def ranks_path(self, reps: int = 20):
        """Phase 13's matrix (HPCG 104^3, fp16/D15) and phase 5's ladder
        (budget 1e-3) across processes, one rank per shard, from the
        host dicts phase 13 built (:meth:`keep_for_ranks`), handed to the
        ranks through files (``distributed.plan.write_host``): (a) one
        NCCL rank on the card, y against phase 13's P = 1 plan and
        ``jacobi_pcg_dist`` through graphs that capture the NCCL
        collectives, in turns, against a P = 1 solve of the stacked form;
        (b) four gloo ranks sharing the card (every collective staged
        through the host): y in both modes against the stacked P = 4 rows
        and the CPU replay, Y at nb = 8, each operand's launches per
        matvec, ``jacobi_pcg_dist`` and ``adaptive_pcg_dist`` eagerly
        against phase 13's P = 4 solves bit for bit; (c) NCCL with one
        rank per card where the machine has two cards or more."""
        import shutil
        import tempfile

        from repro_torch.distributed.plan import write_host
        from repro_torch.parallel.launch import spawn_ranks

        k = self.keep13
        card = card_line()
        runs, totals = [], collections.Counter()
        with tempfile.TemporaryDirectory(prefix="repro_ranks_host_") as tmp:
            dirs, t0 = {}, time.perf_counter()
            for key, (host, _) in k["hosts"].items():
                dirs[key] = str(Path(tmp, key))
                write_host(host, dirs[key])
            metas = {key: meta for key, (_, meta) in k["hosts"].items()}
            print(f"  host dicts of phase 13 ({len(dirs)} operand sets) "
                  f"written for the ranks in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)

            # one spawn of four gloo ranks sharing the card: (a) on rank 0
            # over a one-rank NCCL group, (b) on all four, then phases 23
            # and 24's rank runs (their start and first steps paid once)
            P = 4
            per, tiers = k["per_rank"], [f"tier{i}" for i in range(
                len(k["labels"]))]
            names = {"dist_fp16": "p4", **{t: t for t in tiers + ["hi"]}}
            ours = {key: dirs[src] for key, src in names.items()}
            mets = {key: metas[src] for key, src in names.items()}
            sub = {key: k[key] for key in (
                "xi", "Xi", "b", "bn", "diag", "labels", "sub32",
                "jacobi_kw", "adaptive_kw")}
            spec = self._train_spec()
            shutil.rmtree(spec["root"], ignore_errors=True)
            # phases 14-21 leave tens of GB cached: four ranks need the card
            gc.collect()
            torch.cuda.empty_cache()
            t_spawn = time.time()
            got, sec = wall(lambda: spawn_ranks(
                rank_all, P, backend="gloo", device=self.dev, timeout=1200,
                args=((dirs["p1"], metas["p1"], k["xi"], k["b"], k["diag"],
                       k["jacobi_kw"], reps), (ours, mets, sub, reps),
                      spec)))
            t_end = time.time()
            a, out = got[0]["a"], [r["b"] for r in got]
            self.train_ranks = dict(out=[r["train"] for r in got], spec=spec,
                                    sec=sec, spans=_spans(t_spawn, t_end,
                                                          got))
            print(f"  one spawn of four gloo ranks sharing {self.dev}: "
                  f"{sec:.1f} s ({_spans(t_spawn, t_end, got)}); (a) "
                  f"{a['span'][1] - a['span'][0]:.1f} s of it, (b) "
                  f"{max(r['span'][1] for r in out) - min(r['span'][0] for r in out):.1f}"
                  f" s, then phases 23 and 24's runs", flush=True)
            mark("the spawn (phases 22-24's ranks)")
            same_bits(torch.from_numpy(a["y"][0]),
                      torch.from_numpy(k["y1"][0]),
                      "(a) one NCCL rank's y vs phase 13's P = 1 plan")
            want = {"K1": k["members1"]}
            if a["matvec"] != want:
                fail(f"(a) one matvec launched {a['matvec']}, want {want}")
            x1, i1, rel1 = k["jacobi1"]
            for turn, r in a["turns"].items():
                steps = r["iters"] if turn.startswith("eager") else \
                    chunk_steps(r["iters"], 8)
                if r["iters"] != i1:
                    fail(f"(a) {turn}: {r['iters']} iterations, the "
                         f"stacked P = 1 solve {i1}")
                same_bits(torch.from_numpy(r["x"]), torch.from_numpy(x1),
                          f"(a) {turn}: x vs the stacked P = 1 solve")
                if r["launched"] != {"K1": k["members1"] * (steps + 1)}:
                    fail(f"(a) {turn}: launched {r['launched']}, want K1 "
                         f"{k['members1']} x {steps + 1}")
            if a["launches"]["K7"] < 1:
                fail("(a) the rank's solves never launched K7 (row_dots)")
            runs.append(a["launches"])
            print(f"  (a) one NCCL rank on {a['device']} (a one-rank "
                  f"group inside the spawn; operands uploaded in "
                  f"{a['load_s']:.2f} s): "
                  f"y equal to phase 13's P = 1 plan bit for bit; "
                  f"jacobi_pcg_dist {i1} iterations (relres {rel1!r}) in "
                  f"every turn, x equal to the stacked P = 1 solve's bit for "
                  f"bit, the graphs capturing the NCCL collectives; walls "
                  f"{ {t: r['s'] for t, r in a['turns'].items()} } s; one "
                  f"matvec {a['ms']!r} ms on the device (a CUDA graph of "
                  f"{reps}); peak {a['peak_bytes']} B; {card}", flush=True)

            # (b) four gloo ranks sharing the card
            xj, ij = k["jacobi4"]
            xa4, ia4, th4, prom4 = k["adaptive4"]
            for p, r in enumerate(out):
                for mode in ("ppermute", "all_gather"):
                    same_bits(torch.from_numpy(r[f"y_{mode}"][0]),
                              torch.from_numpy(k["y4"][p]),
                              f"(b) rank {p} y ({mode}) vs row {p} of phase "
                              "13's stacked P = 4 y")
                same_bits(torch.from_numpy(r["y_global"]),
                          torch.from_numpy(k["y_cpu"]),
                          f"(b) rank {p}: global y vs the CPU replay")
                same_bits(torch.from_numpy(r["Y8"][0]),
                          torch.from_numpy(k["Y8"][p]),
                          f"(b) rank {p}: Y at nb = 8 vs the stacked rows")
                for key, got in r["per"].items():
                    if got != per[key]:
                        fail(f"(b) rank {p}: one matvec of {key} launched "
                             f"{got}, want {per[key]}")
                x, it, rel, jl = r["jacobi"]
                if it != ij:
                    fail(f"(b) rank {p}: jacobi_pcg_dist {it} iterations, "
                         f"phase 13's P = 4 solve {ij}")
                same_bits(torch.from_numpy(x), torch.from_numpy(xj),
                          f"(b) rank {p}: jacobi_pcg_dist x vs phase 13's")
                want = {key: v * (it + 1)
                        for key, v in per["dist_fp16"].items()}
                if jl != want:
                    fail(f"(b) rank {p}: jacobi_pcg_dist launched {jl}, "
                         f"want {want}")
                x, it, th, prom, mvc, hic, al = r["adaptive"]
                if (it, th, prom) != (ia4, th4, prom4):
                    fail(f"(b) rank {p}: adaptive_pcg_dist {it} steps, "
                         f"tiers {th}, {prom} promotions; phase 13: {ia4}, "
                         f"{th4}, {prom4}")
                same_bits(torch.from_numpy(x), torch.from_numpy(xa4),
                          f"(b) rank {p}: adaptive_pcg_dist x vs phase 13's")
                want = collections.Counter()
                for t, m in zip(tiers + ["hi"], list(mvc) + [hic]):
                    for key, v in per[t].items():
                        want[key] += v * m
                if al != dict(want):
                    fail(f"(b) rank {p}: adaptive_pcg_dist launched {al}, "
                         f"want {dict(want)}")
                runs.append(r["launches"])
            k7 = [r["launches"]["K7"] for r in out]
            if min(k7) < 1 or len(set(k7)) != 1:
                fail(f"(b) K7 launches per rank {k7}: want the same count, "
                     "at least 1, on every rank")
            print(f"  (b) K7 (row_dots) launches per rank {k7}", flush=True)
            print(f"  (b) four gloo ranks sharing {self.dev} (in the "
                  f"spawn; operands uploaded in "
                  f"{[round(r['load_s'], 2) for r in out]} s): y in both "
                  f"exchange modes equal to the rows of phase 13's stacked "
                  f"P = 4 y and the global y to its CPU replay, bit for bit "
                  f"on integer x; Y at nb = 8 equal to the stacked rows; "
                  f"launches per matvec and rank {out[0]['per']}; "
                  f"jacobi_pcg_dist {ij} iterations and adaptive_pcg_dist "
                  f"{ia4} steps (tiers {th4}, {prom4} promotions) with x "
                  f"equal to phase 13's bit for bit, their launches "
                  f"{out[0]['jacobi'][3]} and {out[0]['adaptive'][6]} per "
                  f"rank; walls per rank: the matvec and tier checks "
                  f"{[round(r['checks_s'], 3) for r in out]} s, jacobi "
                  f"{[round(r['jacobi_s'], 3) for r in out]} s, adaptive "
                  f"{[round(r['adaptive_s'], 3) for r in out]} s", flush=True)
            print(f"  (b) four ranks share one card; the exchange goes "
                  f"through the host; not a multi-GPU figure: one matvec "
                  f"(CUDA events over {reps} eager calls) per rank "
                  f"{[r['ms'] for r in out]!r} ms, the exchange's wall per "
                  f"rank {[r['exchange_ms'] for r in out]!r} ms, peak memory "
                  f"per rank {[r['peak_bytes'] for r in out]} B; {card}",
                  flush=True)

            # (c) NCCL with one rank per card
            count = torch.cuda.device_count()
            if count < 2:
                print(f"  (c) did not run: NCCL with one rank per card needs "
                      f"two cards or more, and this machine has {count}",
                      flush=True)
            else:
                P = min(4, count)
                if P == 4:
                    host_dir, meta, y_rows = dirs["p4"], metas["p4"], k["y4"]
                else:
                    # another partition: its host dict, held to its replay
                    from repro_torch import distributed as dist
                    ops = dist.build_operands(k["s"], P, C=32, sigma=256,
                                              D=15, codec="fp16", device="cpu")
                    host_dir = str(Path(tmp, f"p{P}"))
                    write_host(ops.host, host_dir)
                    meta = ops.meta
                    y_rows = ops.stack_vector(dist.reference_spmv(
                        ops, k["xi"]))
                t_spawn = time.time()
                out, sec = wall(lambda: spawn_ranks(
                    rank_nccl, P, backend="nccl", timeout=300,
                    args=(host_dir, meta, k["xi"], k["b"], k["diag"],
                          k["jacobi_kw"], reps)))
                spans = _spans(t_spawn, time.time(), out)
                for p, r in enumerate(out):
                    same_bits(torch.from_numpy(r["y"][0]),
                              torch.from_numpy(y_rows[p]),
                              f"(c) rank {p}: y vs the stacked row {p}")
                    first = r["turns"]["eager"]
                    for turn, t in r["turns"].items():
                        same_bits(torch.from_numpy(t["x"]),
                                  torch.from_numpy(first["x"]),
                                  f"(c) rank {p} {turn}: x vs the eager loop")
                    if P == 4:
                        same_bits(torch.from_numpy(first["x"]),
                                  torch.from_numpy(xj),
                                  f"(c) rank {p}: x vs phase 13's P = 4")
                    runs.append(r["launches"])
                print(f"  (c) NCCL with one rank per card, P = {P} "
                      f"({sec:.1f} s: {spans}): jacobi_pcg_dist "
                      f"{out[0]['turns']['eager']['iters']} iterations in "
                      f"every turn, x equal across turns bit for bit; one "
                      f"matvec per rank {[r['ms'] for r in out]!r} ms and the "
                      f"exchange alone {[r['exchange_ms'] for r in out]!r} ms "
                      f"(device, CUDA graphs of {reps}); {card}", flush=True)
        for r in runs:
            totals.update(r)
        launches = dict(totals)
        print(f"  launches in this run (every rank): {launches}", flush=True)
        return dict(launches=launches)

    # -- phase 14: the LM serving path -------------------------------------
    def lm_path(self, seed: int = 0, cfg=None, max_len: int = 512,
                new_tokens: int = 32):
        """granite-3-2b at its published widths and depth (``cfg``
        overrides, for a rehearsal), weights from ``seed`` on the card: the
        allocated parameters against ``cfg.param_count()``; the LM head
        pruned to 30 % and stored as PackSELL bf16/D15 at C = 128, as
        ``examples/serve_sparse.py`` stores it; ``DecodeEngine`` with 4
        slots, its warmup (the decode step captured as one CUDA graph,
        the prompt lengths, the head's plan), 8 greedy requests of
        prompt lengths 4-11 and ``new_tokens`` new tokens
        each. Then, on the pool's state after them: a graph tick against
        an eager tick, bit for bit; the tick's walls and device time
        against its bound; decode against prefill at the full width
        (``LM_DECODE_TOL``); the head on the next tick's hidden state of
        slot 0 (K1) and of every slot (K3), each part bit-equal to its
        plain body and y within the bf16 codec's bound of the float64 product with
        the pruned weight, with the top-10 overlap against the dense
        head; K1 and K3 timed against their bounds, ``torch.matmul`` of
        the dense bf16 head and cuSPARSE CSR."""
        from repro_torch import configs
        from repro_torch.core import codecs as cd
        from repro_torch.kernels import packsell_spmv as kpk
        from repro_torch.models import transformer as tfm
        from repro_torch.models.sparse_linear import PackSELLLinear
        from repro_torch.precision.analyze import ulp_bound
        from repro_torch.serving import DecodeEngine, ServeConfig, WarmupSpec

        cfg = cfg or configs.get("granite-3-2b")
        slots, n_req = 4, 8
        dev = self.dev
        rng = np.random.default_rng(seed)
        params, sec = wall(lambda: tfm.init_params(cfg, seed, device=dev))
        n_par, want = params.param_count(), cfg.param_count()
        print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, "
              f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} "
              f"padded to {cfg.vocab_padded}, params {cfg.param_dtype}, "
              f"compute {cfg.dtype}; {n_par} parameters allocated on the "
              f"card in {sec!r} s (param_count() {want}, "
              f"{abs(n_par - want) / want!r} apart)", flush=True)
        if not abs(n_par - want) / want < 0.02:
            fail(f"{n_par} parameters allocated, param_count() {want}")

        # the head, pruned and packed on the host
        t0 = time.perf_counter()
        head_w = params.head.w.cpu().numpy()               # [d, vocab_padded]
        head = PackSELLLinear.from_dense(head_w, density=0.3, codec="bf16",
                                         D=15, C=128, sigma=256, device=dev)
        t_head = time.perf_counter() - t0
        mat, csr = head.mat, head._csr
        eng = DecodeEngine(cfg, params, ServeConfig(slots=slots,
                                                    max_len=max_len,
                                                    seed=seed), device=dev)
        del params
        prompts = [rng.integers(1, cfg.vocab, size=int(p))
                   for p in rng.integers(4, 12, size=n_req)]
        lens = tuple(sorted({len(p) for p in prompts}))
        self.zero_counts()
        _, t_warm = wall(lambda: eng.warmup(WarmupSpec(
            prompt_lens=lens, sparse_layers=(head,), nb=slots)))
        plan = head.plan
        print(f"  head [{mat.m} x {mat.n}] pruned to 30 % ({mat.nnz} stored "
              f"entries), bf16/D15, C 128, sigma 256: prune, CSR and "
              f"from_csr {t_head!r} s; plan {plan.variant} ({plan.policy}); "
              f"warmup (the decode graph, prefills at {list(lens)}, the "
              f"head's plan) {t_warm!r} s", flush=True)
        if plan.variant != "fused":
            fail(f"the head's plan is {plan.policy}, not the fused stream")

        reqs = [eng.submit(p, new_tokens) for p in prompts]
        _, t_run = wall(eng.run)
        short = [(r.uid, len(r.out_tokens)) for r in reqs
                 if len(r.out_tokens) != new_tokens]
        if short or len(eng.done) != n_req:
            fail(f"{len(eng.done)} of {n_req} requests done; with other "
                 f"than {new_tokens} tokens: {short}")
        st = eng.stats()
        print(f"  served {st['requests']} requests (prompts {lens[0]}-"
              f"{lens[-1]} tokens, {new_tokens} new each, greedy, {slots} "
              f"slots, max_len {max_len}) in {t_run!r} s: "
              f"{st['tokens_per_s']!r} tokens/s, mean TTFT "
              f"{st['mean_ttft_s']!r} s, mean latency "
              f"{st['mean_latency_s']!r} s (host clock)", flush=True)

        # the head on the next tick's hidden states: K1 for slot 0, K3 for
        # every slot, inside the counted run
        eng.tokens.copy_(torch.from_numpy(eng.last_token[:, None]))
        saved = eng.state()
        h = tfm.decode_hidden(cfg, eng.params, eng.tokens, eng.cache)[:, 0]
        eng.set_state(saved)
        x1, X = h[0].float().contiguous(), h.float()
        before = self.counts()
        y1, Y = head(x1), head(X)
        ran = {k: v - before[k] for k, v in self.counts().items()
               if v != before[k]}
        if ran != {"K1": 1, "K3": 1}:
            fail(f"head(h) on one and on {slots} slots launched {ran}, "
                 "not one K1 and one K3")
        torch.cuda.synchronize()
        launches = self.counts()
        print(f"  launches in this run: {launches}", flush=True)

        # a graph tick against an eager tick, on the same state
        reps = max(self.reps // 2, 2)
        prof = tick_profile(eng, saved, runs=5, reps=reps)
        t_tick, walls, tick_ops = prof["ms"], prof["walls"], prof["ops"]
        # what one tick must read: every weight but the embedding table
        # (its slots rows), and each slot's valid KV positions
        emb = eng.params.embed.w
        w_bytes = sum(p.numel() * p.element_size()
                      for p in eng.params.parameters()) \
            - emb.numel() * emb.element_size() \
            + slots * cfg.d_model * emb.element_size()
        kv = eng.cache["k"]
        pos = int(torch.clamp(saved["len"] + 1, max=max_len).sum())
        kv_bytes = 2 * pos * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim \
            * kv.element_size()
        tb, by = bound_ms(w_bytes + kv_bytes + 4 * slots * cfg.vocab_padded,
                          2 * slots * (w_bytes // emb.element_size()),
                          PEAK_BF16_OPS_PER_S)
        n_ops = sum(tick_ops.values())
        print(f"  the decode tick ({slots} slots): logits and cache of a "
              f"graph tick equal an eager tick's bit for bit (5 times); "
              f"wall eager {prof['wall_eager']!r} s, graph "
              f"{prof['wall_graph']!r} s (medians of 5: "
              f"{walls}); device {t_tick!r} ms (CUDA events over {reps} "
              f"replays); bound {tb!r} ms by {by} (weights {w_bytes} B "
              f"in {cfg.dtype}, the KV cache {kv_bytes} B): {t_tick / tb!r} "
              f"x; on {card_line()}", flush=True)
        print(f"  its device ops (one tick, counted on the host): {n_ops}, "
              f"{n_ops / cfg.n_layers!r} a layer, "
              f"{t_tick * 1e3 / max(n_ops, 1)!r} us of device time each; "
              f"most frequent {tick_ops.most_common(12)}", flush=True)

        # decode against prefill at the full width
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 9)).astype(
            np.int32)).to(dev)
        _, c8 = tfm.forward_prefill(cfg, eng.params, {"tokens": toks[:, :8]},
                                    16)
        l9d, _ = tfm.forward_decode(cfg, eng.params, toks[:, 8:9], c8)
        l9p, _ = tfm.forward_prefill(cfg, eng.params, {"tokens": toks}, 16)
        l9d, l9p = l9d[0, 0, :cfg.vocab], l9p[0, 0, :cfg.vocab]
        err, top = max_abs(l9d, l9p), float(l9p.abs().max())
        print(f"  decode of token 9 after a prefill of 8 vs a prefill of 9: "
              f"max |diff| {err!r}, {err / top!r} of max |logit| {top!r} "
              f"(limit {LM_DECODE_TOL!r}); argmax "
              f"{int(l9d.argmax())} vs {int(l9p.argmax())}", flush=True)
        if not err <= LM_DECODE_TOL * top:
            fail(f"decode vs prefill: {err} > {LM_DECODE_TOL} x {top}")

        # the head's kernels against their plain bodies, and y against the
        # float64 product with the pruned weight
        words, ckpt = plan.fused
        lay = plan.fused_layout
        kw = dict(codec_name=mat.codec_name, D=mat.D, encoding=lay.encoding,
                  scale=lay.scale)
        XT = X.T.contiguous()
        dev_ops = plan.device_operands()
        p1 = kpk.packsell_spmv_fused_plain(words, ckpt, x1, **kw)
        p3 = kpk.packsell_spmm_fused_plain(words, ckpt, XT, **kw)
        self.note("K1", same_bits(self.k1(words, ckpt, x1, **kw), p1,
                                  "K1 on the head"))
        self.note("K3", same_bits(self.k3(words, ckpt, XT, **kw), p3,
                                  f"K3 on the head, nb={slots}"))
        same_bits(y1, plan._fused_epilogue(p1, dev_ops, False),
                  "head(h) slot 0 vs its plain body")
        same_bits(Y, plan._fused_epilogue(p3, dev_ops, False).T,
                  "head(h) all slots vs its plain body")
        a64 = csr.astype(np.float64)
        Xh = X.cpu().numpy().astype(np.float64).T            # [d, slots]
        exact, mag = a64 @ Xh, abs(a64) @ np.abs(Xh)
        row_nnz = np.diff(csr.indptr)[:, None]
        lim = (ulp_bound("bf16", 15) + row_nnz * 2.0 ** -24) * mag
        got = Y.cpu().numpy().T.astype(np.float64)
        worst = float(np.max(np.abs(got - exact) / np.maximum(lim, 1e-300)))
        if not worst <= 1.0:
            fail(f"head y vs the float64 pruned product: {worst} x the "
                 "bf16 bound")
        dense = head_w.astype(np.float64).T @ Xh             # [vocab_p, slots]
        overlap = [len(set(np.argsort(-dense[:cfg.vocab, j])[:10])
                       & set(np.argsort(-got[:cfg.vocab, j])[:10]))
                   for j in range(slots)]
        rel = float(np.abs(got - exact).max() / np.abs(exact).max())
        print(f"  head(h): K1 (slot 0) and K3 (nb={slots}) bit-equal to "
              f"their plain bodies, the epilogue too; y within {worst!r} x "
              f"the bound (2^-8 per value + n_row 2^-24) of the float64 "
              f"product with the pruned weight, max |y - exact| / max "
              f"|exact| {rel!r}; top-10 overlap with the dense head per slot "
              f"{overlap}/10", flush=True)

        # times at the head's shape
        G, wr, C = words.shape
        m = mat.m
        preps = max(self.reps // 10, 2)
        w16 = torch.from_numpy(head_w).to(dev, torch.bfloat16)
        x16, X16 = x1.to(torch.bfloat16)[None], X.to(torch.bfloat16)
        a_q = sparse_csr(csr, cd.quantize_np(csr.data, mat.codec, mat.D),
                         dev)
        rows = {}
        for key, run, plain, full, mm, lib, nb in (
                ("K1", lambda: self.k1(words, ckpt, x1, **kw),
                 lambda: kpk.packsell_spmv_fused_plain(words, ckpt, x1, **kw),
                 lambda: head(x1), lambda: torch.matmul(x16, w16),
                 lambda: a_q @ x1, 1),
                (f"K3 nb={slots}", lambda: self.k3(words, ckpt, XT, **kw),
                 lambda: kpk.packsell_spmm_fused_plain(words, ckpt, XT, **kw),
                 lambda: head(X), lambda: torch.matmul(X16, w16),
                 lambda: a_q @ XT, slots)):
            nbytes = (4 * G * wr * C + 4 * G * C + 4 * m * nb
                      + 4 * G * C * nb)
            dbytes = 2 * w16.numel() + 2 * m * nb + 2 * mat.n * nb
            rows[key] = dict(
                ms=device_ms(run, self.reps), eager_ms=timed(run, self.reps),
                plain_ms=timed(plain, preps), head_ms=device_ms(full,
                                                                self.reps),
                bound=bound_ms(nbytes, 2 * G * wr * C * nb),
                matmul_ms=device_ms(mm, self.reps),
                matmul_bound=bound_ms(dbytes, 2 * w16.numel() * nb,
                                      PEAK_BF16_OPS_PER_S),
                csr_ms=timed(lib, self.reps))
            r = rows[key]
            print(f"  {key} at the head's shape: {r['ms']!r} ms on the "
                  f"device (eager {r['eager_ms']!r}), plain {r['plain_ms']!r}"
                  f" ms, bound {r['bound'][0]!r} ms by {r['bound'][1]} "
                  f"({r['ms'] / r['bound'][0]!r} x); head(h) with its "
                  f"epilogue {r['head_ms']!r} ms; torch.matmul of the dense "
                  f"bf16 head {r['matmul_ms']!r} ms (bound "
                  f"{r['matmul_bound'][0]!r} ms); cuSPARSE CSR "
                  f"{r['csr_ms']!r} ms; on {card_line()}", flush=True)
        print(f"  bytes per token: PackSELL {head.decode_bytes_per_token()} "
              f"B (memory_ratio {head.memory_ratio()!r} of fp32), stream "
              f"and checkpoints {4 * G * wr * C + 4 * G * C} B, dense bf16 "
              f"{2 * w16.numel()} B: "
              f"{2 * w16.numel() / head.decode_bytes_per_token()!r} x",
              flush=True)
        return dict(launches=launches, rows=rows, tick_ms=t_tick,
                    tick_ops=n_ops)

    # -- phases 15 and 16: the moe and vlm families --------------------------
    def _lm_params(self, cfg, seed: int):
        """``cfg``'s parameters from ``seed`` in the compute dtype, one copy
        on the card (``init_params(..., dtype=cfg.dtype)``), with the peak
        memory counted from here; prints and checks the allocated count
        against ``cfg.param_count()`` (2 %). Returns ``(params, base)``:
        ``base`` is the memory allocated before."""
        from repro_torch.models import transformer as tfm

        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, sec = wall(lambda: tfm.init_params(cfg, seed, device=self.dev,
                                                   dtype=cfg.dtype))
        n_par, want = params.param_count(), cfg.param_count()
        nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
        print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to "
              f"{cfg.vocab_padded}; {n_par} parameters drawn from seed {seed} "
              f"straight into {cfg.dtype} (one copy, {nbytes} B) in {sec!r} "
              f"s; param_count() {want}: {n_par - want:+d} "
              f"({abs(n_par - want) / want!r} apart); memory allocated "
              f"before the phase {base} B", flush=True)
        if not abs(n_par - want) / want < 0.02:
            fail(f"{n_par} parameters allocated, param_count() {want}")
        return params, base

    def moe_path(self, seed: int = 0, cfg=None, max_len: int = 512,
                 new_tokens: int = 32, check_len: int = 11):
        """qwen2-moe-a2.7b at its published widths and depth (``cfg``
        overrides, for a rehearsal), weights from ``seed`` in one bf16 copy
        (the peak memory after it at most ``MOE_PEAK_BYTES``); the engine
        with 4 slots, its warmup (the decode step captured), 8 greedy
        requests of prompt lengths 4-11 and ``new_tokens`` each, the
        assignments their prefills dropped counted. Then, on the pool's
        state: a graph tick against an eager tick, bit for bit, both under
        ``set_sync_debug_mode("error")``; the tick's device time and ops
        against two byte bounds, (a) the reference's dispatch (every padded
        expert read) and (b) a routed-only dispatch (the experts the slots
        picked); decode against prefill at ``capacity_factor = E/k``, the
        decode pinned to the prefill's experts (``LM_DECODE_TOL``; the
        free decode's routing reported); layer 0's ``moe.apply`` on
        ``check_len`` tokens of 4 rows against a float64 loop over tokens
        that applies the reference's rule (the kept set equal, y within
        ``MOE_Y_TOL``)."""
        import dataclasses

        from repro_torch import configs
        from repro_torch.models import moe
        from repro_torch.models import transformer as tfm
        from repro_torch.serving import DecodeEngine, ServeConfig, WarmupSpec
        from repro_torch.solvers import graphs

        cfg = cfg or configs.get("qwen2-moe-a2.7b")
        slots, n_req = 4, 8
        dev = self.dev
        E, k, d, ff = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
        Ep = moe.padded_experts(E)
        rng = np.random.default_rng(seed)
        params, base = self._lm_params(cfg, seed)
        eng = DecodeEngine(cfg, params, ServeConfig(slots=slots,
                                                    max_len=max_len,
                                                    seed=seed), device=dev)
        if eng.params is not params:
            fail("the engine copied parameters already in the compute dtype")
        del params
        prompts = [rng.integers(1, cfg.vocab, size=int(p))
                   for p in rng.integers(4, 12, size=n_req)]
        lens = tuple(sorted({len(p) for p in prompts}))
        self.zero_counts()
        _, t_warm = wall(lambda: eng.warmup(WarmupSpec(prompt_lens=lens)))
        print(f"  {E} routed experts padded to {Ep}, top-{k}, "
              f"{cfg.n_shared_experts} shared, capacity factor "
              f"{cfg.capacity_factor}: cap {[moe.capacity(cfg, s) for s in lens]}"
              f" at prompt lengths {list(lens)}, {moe.capacity(cfg, 1)} in a "
              f"decode tick; warmup (the decode graph, prefills at "
              f"{list(lens)}) {t_warm!r} s", flush=True)

        # the served prefills' dropped assignments, read after the run
        dropped = []

        def counting(x, r):
            if x.shape[1] > 1:
                dropped.append((~r.keep).sum())
            return r

        reqs = [eng.submit(p, new_tokens) for p in prompts]
        with route_tap(moe, counting, cfg.n_layers, exact=False):
            _, t_run = wall(eng.run)
        short = [(r.uid, len(r.out_tokens)) for r in reqs
                 if len(r.out_tokens) != new_tokens]
        if short or len(eng.done) != n_req:
            fail(f"{len(eng.done)} of {n_req} requests done; with other "
                 f"than {new_tokens} tokens: {short}")
        if not dropped:
            fail("no prefill of several tokens reached moe.route")
        n_drop = int(torch.stack(dropped).sum())
        n_assign = sum(len(p) for p in prompts) * k * cfg.n_layers
        st = eng.stats()
        print(f"  served {st['requests']} requests (prompts {lens[0]}-"
              f"{lens[-1]} tokens, {new_tokens} new each, greedy, {slots} "
              f"slots, max_len {max_len}) in {t_run!r} s: "
              f"{st['tokens_per_s']!r} tokens/s, mean TTFT "
              f"{st['mean_ttft_s']!r} s, mean latency "
              f"{st['mean_latency_s']!r} s (host clock); the prefills "
              f"dropped {n_drop} of {n_assign} assignments "
              f"({n_drop / n_assign!r}; {len(dropped)} layer calls), as the "
              f"reference's capacity rule drops them", flush=True)
        launches = self.counts()
        print(f"  launches in this run: {launches} (no kernel of this "
              "repository lies on the moe path)", flush=True)

        # a graph tick against an eager tick, both without a host sync
        eng.tokens.copy_(torch.from_numpy(eng.last_token[:, None]))
        saved = eng.state()
        reps = max(self.reps // 2, 2)
        prof = tick_profile(eng, saved, runs=3, reps=reps, sync="error")
        t_tick, tick_ops = prof["ms"], prof["ops"]
        # the experts this tick's slots picked, per layer
        picked = []

        def recording(x, r):
            picked.append(r.experts.reshape(-1))
            return r

        with route_tap(moe, recording, cfg.n_layers), graphs.eager():
            eng._decode()
        eng.set_state(saved)
        n_ops = sum(tick_ops.values())
        distinct = [int(torch.unique(t).numel()) for t in picked]
        bf = eng.params.embed.w.element_size()
        emb = eng.params.embed.w
        w_all = sum(p.numel() * p.element_size()
                    for p in eng.params.parameters()) \
            - emb.numel() * emb.element_size() + slots * d * bf
        expert_b = 3 * d * ff * bf
        w_routed = w_all - cfg.n_layers * Ep * expert_b \
            + sum(distinct) * expert_b
        w_max16 = w_all - cfg.n_layers * (Ep - min(Ep, slots * k)) * expert_b
        pos = int(torch.clamp(saved["len"] + 1, max=max_len).sum())
        kv_b = 2 * pos * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * bf
        out_b = 4 * slots * cfg.vocab_padded
        ta, _ = bound_ms(w_all + kv_b + out_b, 0)
        tb, _ = bound_ms(w_routed + kv_b + out_b, 0)
        t16, _ = bound_ms(w_max16 + kv_b + out_b, 0)
        print(f"  the decode tick ({slots} slots): logits and cache of a "
              f"graph tick equal an eager tick's bit for bit (3 times, "
              f"both under set_sync_debug_mode('error')); wall eager "
              f"{prof['wall_eager']!r} s, graph {prof['wall_graph']!r} s "
              f"(medians of 3); device {t_tick!r} ms (CUDA events over "
              f"{reps} replays); on {card_line()}", flush=True)
        print(f"  bound (a), the reference's dispatch (every padded expert "
              f"read): {w_all + kv_b + out_b} B, {ta!r} ms ({t_tick / ta!r} "
              f"x); bound (b), a routed-only dispatch (the {sum(distinct)} "
              f"experts this tick's slots picked, {distinct} a layer): "
              f"{w_routed + kv_b + out_b} B, {tb!r} ms ({t_tick / tb!r} x); "
              f"at the most {min(Ep, slots * k)} experts a layer {t16!r} ms; "
              f"KV {kv_b} B", flush=True)
        print(f"  its device ops (one tick, counted on the host): {n_ops}, "
              f"{n_ops / cfg.n_layers!r} a layer, "
              f"{t_tick * 1e3 / max(n_ops, 1)!r} us of device time each; "
              f"most frequent {tick_ops.most_common(12)}", flush=True)

        # decode against prefill, where the prefill drops nothing. Two runs
        # of top-k routing part where a token's k-th and (k+1)-th
        # probabilities tie within their rounding, so the verdict pins the
        # decode to the experts the prefill gave token 9 in each layer; the
        # free decode's routing and logits are reported beside it
        cfg_nd = dataclasses.replace(cfg, capacity_factor=E / k)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 9)).astype(
            np.int32)).to(dev)
        _, c8 = tfm.forward_prefill(cfg_nd, eng.params,
                                    {"tokens": toks[:, :8]}, 16)
        seen = {"prefill": [], "decode": [], "pinned": []}

        def record(into, pin=None):
            def each(x, r):
                if pin is not None:
                    r = pinned(r, pin[len(into)][0])
                into.append((r.experts[:, -1:], r.logits[0, -1],
                             r.probs[0, -1]))
                return r
            return each

        def decode():
            cache = {key: v.clone() for key, v in c8.items()}
            return tfm.forward_decode(cfg_nd, eng.params, toks[:, 8:9],
                                      cache)[0]

        logits = {}
        for mode, run in (
                ("prefill", lambda: tfm.forward_prefill(
                    cfg_nd, eng.params, {"tokens": toks}, 16)[0]),
                ("decode", decode), ("pinned", decode)):
            pin = seen["prefill"] if mode == "pinned" else None
            with route_tap(moe, record(seen[mode], pin), cfg.n_layers):
                logits[mode] = run()[0, 0, :cfg.vocab]
        pre, dec, pin = seen["prefill"], seen["decode"], seen["pinned"]
        flips = [i for i, (a, b) in enumerate(zip(dec, pre))
                 if not torch.equal(a[0].sort(-1).values,
                                    b[0].sort(-1).values)]
        first = flips[0] if flips else cfg.n_layers - 1
        # the router's logits against the prefill's: the free decode's up
        # to its first flip, the pinned decode's in every layer
        drift = max(max_abs(a[1], b[1]) for a, b in zip(dec[:first + 1], pre))
        drift_pin = max(max_abs(a[1], b[1]) for a, b in zip(pin, pre))
        scale = max(float(b[1].abs().max()) for b in pre)
        gaps = [float(-pre[i][2].sort(descending=True).values[k - 1:k + 1]
                      .diff()[0]) for i in flips]
        lp = logits["prefill"]
        err, top = max_abs(logits["decode"], lp), float(lp.abs().max())
        err_pin = max_abs(logits["pinned"], lp)
        if not flips:
            same_bits(logits["pinned"], logits["decode"], "the pinned decode "
                      "vs the free decode, which routes token 9 alike")
        print(f"  decode of token 9 after a prefill of 8 vs a prefill of 9 "
              f"at capacity_factor E/k = {E / k!r} (cap "
              f"{moe.capacity(cfg_nd, 9)} >= S, so the prefill drops "
              f"nothing; at the published {cfg.capacity_factor} a 9-token "
              f"prefill has cap {moe.capacity(cfg, 9)} and drops "
              f"assignments, which a decode step never does, in the "
              f"reference as here)", flush=True)
        print(f"  the decode pinned to the prefill's experts: max |diff| "
              f"{err_pin!r}, {err_pin / top!r} of max |logit| {top!r} "
              f"(limit {LM_DECODE_TOL!r}); argmax "
              f"{int(logits['pinned'].argmax())} vs {int(lp.argmax())}; its "
              f"router logits at most {drift_pin!r} from the prefill's over "
              f"all {cfg.n_layers} layers (max |router logit| {scale!r})",
              flush=True)
        print(f"  the free decode: max |diff| {err!r}, {err / top!r} of max "
              f"|logit|; token 9's {k} experts differ from the prefill's in "
              f"{len(flips)} of {cfg.n_layers} layers {flips}, where the "
              f"prefill's {k}th and {k + 1}th probabilities lie {gaps} apart; "
              f"its router logits up to layer {first} at most {drift!r} from "
              f"the prefill's", flush=True)
        if not err_pin <= LM_DECODE_TOL * top:
            fail(f"moe decode pinned to the prefill's experts vs prefill: "
                 f"{err_pin} > {LM_DECODE_TOL} x {top}")

        # layer 0 against a float64 loop over tokens (the reference's rule)
        p0 = eng.params.blocks[0].moe
        B, S = slots, check_len
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        x = torch.randn((B, S, d), generator=g, device=dev).to(
            getattr(torch, cfg.dtype))
        y, _ = moe.apply(p0, cfg, x, cfg.dtype, aux=False)
        r = moe.route(p0, cfg, x)
        got_kept = {(b, a // k, int(e)) for b, a, e in zip(
            *np.nonzero(r.keep.cpu().numpy()),
            r.experts.reshape(B, -1).cpu().numpy()[r.keep.cpu().numpy()])}
        y64, want_kept, ids64 = self._moe_f64(p0, cfg, x)
        same_ids = bool(np.array_equal(ids64, r.experts.cpu().numpy()))
        err = max_abs(y.double(), y64)
        top = float(y64.abs().max())
        print(f"  layer 0's moe.apply on {B} x {S} tokens ~ N(0, 1) in "
              f"{cfg.dtype} against a float64 loop over tokens (the "
              f"reference's rule, moe.py:77-150): expert ids equal "
              f"{same_ids}; kept {len(got_kept)} of {B * S * k} (cap "
              f"{r.cap}), the kept set equal {got_kept == want_kept}; max "
              f"|y - y64| {err!r}, {err / top!r} of max |y64| {top!r} "
              f"(limit {MOE_Y_TOL!r})", flush=True)
        if not same_ids or got_kept != want_kept:
            fail(f"moe routing: expert ids equal {same_ids}, kept sets "
                 f"differ by {sorted(got_kept ^ want_kept)[:8]}")
        if not err <= MOE_Y_TOL * top:
            fail(f"moe y vs the float64 loop: {err} > {MOE_Y_TOL} x {top}")
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak memory allocated in the phase: {peak} B "
              f"(max_memory_allocated; {peak - base} B above the "
              f"{base} B allocated before it; limit {MOE_PEAK_BYTES})",
              flush=True)
        if peak - base > MOE_PEAK_BYTES:
            fail(f"moe phase peak {peak - base} B > {MOE_PEAK_BYTES}")
        return dict(launches=launches, tick_ms=t_tick, tick_ops=n_ops,
                    bound_a=ta, bound_b=tb, peak=peak)

    @staticmethod
    def _moe_f64(p, cfg, x):
        """``moe.apply`` in float64 token by token: the router, softmax,
        top-k and the renormalised gates; per batch row each expert keeps
        its first ``cap`` assignments in assignment order; each kept
        (token, expert) adds its gated SwiGLU output; then the shared
        experts. Returns ``(y, kept set of (row, token, expert), ids)``."""
        from repro_torch.models import moe

        B, S, d = x.shape
        E, k = cfg.n_experts, cfg.top_k
        cap = moe.capacity(cfg, S)
        x64 = x.double()
        y = torch.zeros_like(x64)
        probs = torch.softmax(x64 @ p.router.double(), dim=-1)
        gates, ids = torch.topk(probs, k, dim=-1)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        ids_h = ids.cpu().numpy()
        kept, work = set(), collections.defaultdict(list)
        for b in range(B):
            seen = np.zeros(E, np.int64)
            for a in range(S * k):
                s, j = divmod(a, k)
                e = int(ids_h[b, s, j])
                if seen[e] < cap:
                    kept.add((b, s, e))
                    work[e].append((b, s, j))
                seen[e] += 1

        def swiglu64(wi, wg, wo, v):
            return (torch.nn.functional.silu(v @ wg.double())
                    * (v @ wi.double())) @ wo.double()

        ex = p.experts
        for e, items in work.items():
            bs = torch.tensor([(b, s) for b, s, _ in items], device=x.device)
            out = swiglu64(ex.wi[e], ex.wg[e], ex.wo[e], x64[bs[:, 0],
                                                             bs[:, 1]])
            for (b, s, j), o in zip(items, out):
                y[b, s] += gates[b, s, j] * o
        if p.shared is not None:
            for i in range(p.shared.wi.shape[0]):
                y += swiglu64(p.shared.wi[i], p.shared.wg[i], p.shared.wo[i],
                              x64)
        return y, kept, ids_h

    @staticmethod
    def _mamba_f64(p, cfg, x, at):
        """A Mamba2 layer in float64, token by token: the projection, the
        causal conv and SiLU, ``h <- exp(dt A) h + dt B x``, ``y = C h +
        D x``, the gated norm, ``out_proj``. Returns ``(y, [h after token
        n for n in at], max |sum over tokens of dt A|)``."""
        w = {n: t.double() for n, t in p.named_parameters()}
        B, S, _ = x.shape
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        K = cfg.ssm_conv
        zx = x.double() @ w["in_proj"]
        z, xbc, dtr = zx[..., :di], zx[..., di:2 * di + 2 * N], \
            zx[..., 2 * di + 2 * N:]
        xp = torch.nn.functional.pad(xbc, (0, 0, K - 1, 0))
        c = sum(xp[:, i:i + S] * w["conv_w"][i] for i in range(K)) \
            + w["conv_b"]
        c = torch.nn.functional.silu(c)
        xh = c[..., :di].unflatten(-1, (H, cfg.ssm_head_dim))
        Bc, Cc = c[..., di:di + N], c[..., di + N:]
        dt = torch.logaddexp(dtr + w["dt_bias"], torch.zeros((), dtype=
                                                             torch.float64,
                                                             device=x.device))
        A = -torch.exp(w["A_log"])
        h = torch.zeros((B, H, N, cfg.ssm_head_dim), dtype=torch.float64,
                        device=x.device)
        ys, hs = [], []
        for s in range(S):
            h = torch.exp(dt[:, s] * A)[..., None, None] * h \
                + (dt[:, s, :, None] * xh[:, s])[:, :, None, :] \
                * Bc[:, s, None, :, None]
            ys.append(torch.einsum("bn,bhnp->bhp", Cc[:, s], h)
                      + w["D"][:, None] * xh[:, s])
            if s + 1 in at:
                hs.append(h.clone())
        y = torch.stack(ys, 1).flatten(2) * torch.nn.functional.silu(z)
        y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + cfg.norm_eps)
        top = float((dt * A).sum(1).abs().max())
        return (y * w["norm_g"]) @ w["out_proj"], hs, top

    def vlm_path(self, seed: int = 0, cfg=None, batch: int = 4,
                 prompt: int = 8, new_tokens: int = 32):
        """llava-next-mistral-7b at its published widths and depth
        (``cfg`` overrides, for a rehearsal), weights from ``seed`` in one
        bf16 copy; ``forward_prefill`` of ``batch`` rows, each
        ``cfg.frontend_len`` patches ~ N(0, 1) (bf16) and ``prompt``
        tokens, into a cache of ``frontend_len + 64`` positions; then
        ``new_tokens`` greedy steps of ``forward_decode``, the step one
        CUDA graph over the static cache (``solvers.graphs.Graph``, as the
        engine's), the next token chosen on the device; a graph step
        against an eager step bit for bit; the step's device time against
        its byte bound; decode of the next position after a prefill
        against a prefill one token longer (``LM_DECODE_TOL``)."""
        from repro_torch import configs
        from repro_torch.models import io_spec
        from repro_torch.models import transformer as tfm
        from repro_torch.solvers import graphs

        cfg = cfg or configs.get("llava-next-mistral-7b")
        dev = self.dev
        B, P = batch, cfg.frontend_len
        max_len = P + 64
        rng = np.random.default_rng(seed)
        params, base = self._lm_params(cfg, seed)
        proj = params.projector.w.numel()
        print(f"  the projector: {proj} parameters ({io_spec.STUB_DIM} x "
              f"{cfg.d_model}) where param_count() takes d_model^2 = "
              f"{cfg.d_model ** 2}: {cfg.d_model ** 2 - proj} of the gap",
              flush=True)
        self.zero_counts()
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        patches = torch.randn((B, P, io_spec.STUB_DIM), generator=g,
                              device=dev).to(getattr(torch, cfg.dtype))
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, prompt))
                                .astype(np.int32)).to(dev)
        batch_in = {"tokens": toks, "patches": patches}
        (logits, cache), t_pre = wall(lambda: tfm.forward_prefill(
            cfg, params, batch_in, max_len))
        S = P + prompt
        if not torch.equal(cache["len"].cpu(), torch.full((B,), S,
                                                           dtype=torch.int32)):
            fail(f"vlm prefill: cache len {cache['len'].tolist()}, not {S}")
        if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
            fail("vlm prefill: logits not finite")
        print(f"  forward_prefill of {B} rows x ({P} patches + {prompt} "
              f"tokens) = {S} positions into a cache of {max_len}: "
              f"{t_pre!r} s (host clock, eager, first call)", flush=True)

        # the decode step as one graph over the static token and cache
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None].contiguous()

        def body():
            return tfm.forward_decode(cfg, params, tok, cache)[0]

        step = graphs.Graph(body, dev)
        saved = {key: v.clone() for key, v in cache.items()}
        saved_tok = tok.clone()
        _, t_cap = wall(step)
        for key, v in cache.items():
            v.copy_(saved[key])
        tok.copy_(saved_tok)
        gen = [tok.clone()]

        def greedy():
            for _ in range(new_tokens):
                out = step()
                tok.copy_(out[:, -1].argmax(-1).to(torch.int32)[:, None])
                gen.append(tok.clone())

        _, t_dec = wall(greedy)
        if not torch.equal(cache["len"].cpu(),
                           torch.full((B,), S + new_tokens,
                                      dtype=torch.int32)):
            fail(f"vlm decode: cache len {cache['len'].tolist()}")
        seqs = torch.cat(gen, 1).cpu().numpy()
        print(f"  {new_tokens} greedy steps (graph replays, the next token "
              f"chosen on the device): {t_dec!r} s, "
              f"{t_dec / new_tokens!r} s a step (host clock; the capture "
              f"{t_cap!r} s); row 0's tokens {seqs[0, :12].tolist()}...",
              flush=True)

        # a graph step against an eager step, on the same state
        saved = {key: v.clone() for key, v in cache.items()}
        saved_tok = tok.clone()

        def restore():
            for key, v in cache.items():
                v.copy_(saved[key])
            tok.copy_(saved_tok)

        for _ in range(3):
            restore()
            with graphs.eager():
                le = step().clone()
            after = {key: v.clone() for key, v in cache.items()}
            restore()
            lg = step().clone()
            same_bits(lg, le, "vlm graph step vs eager step logits")
            for key, v in cache.items():
                if not torch.equal(v, after[key]):
                    fail(f"vlm graph step vs eager step: {key} differs")
        restore()
        reps = max(self.reps // 5, 2)
        t_step = timed(step, reps)
        restore()
        with graphs.eager():
            step_ops = collections.Counter(aten_ops(step))
        restore()
        n_ops = sum(step_ops.values())
        bf = params.embed.w.element_size()
        skip = params.embed.w.numel() + proj
        w_b = sum(p.numel() * p.element_size() for p in params.parameters()) \
            - skip * bf + B * cfg.d_model * bf
        pos = int(torch.clamp(cache["len"] + 1, max=max_len).sum())
        kv_b = 2 * pos * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * bf
        tb, by = bound_ms(w_b + kv_b + 4 * B * cfg.vocab_padded,
                          2 * B * (w_b // bf), PEAK_BF16_OPS_PER_S)
        print(f"  the decode step ({B} rows at length {S + new_tokens}): "
              f"logits and cache of a graph step equal an eager step's bit "
              f"for bit (3 times); device {t_step!r} ms (CUDA events over "
              f"{reps} replays); bound {tb!r} ms by {by} (weights {w_b} B, "
              f"the embedding's rows and no projector; KV {kv_b} B): "
              f"{t_step / tb!r} x; on {card_line()}", flush=True)
        print(f"  its device ops (one step, counted on the host): {n_ops}, "
              f"{n_ops / cfg.n_layers!r} a layer, "
              f"{t_step * 1e3 / max(n_ops, 1)!r} us of device time each; "
              f"most frequent {step_ops.most_common(10)}", flush=True)
        del step, saved, after, cache

        # decode of the next position against a prefill one longer
        b1 = {"tokens": toks[:1, :prompt], "patches": patches[:1]}
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 1)).astype(
            np.int32)).to(dev)
        _, c1 = tfm.forward_prefill(cfg, params, b1, S + 8)
        ld, _ = tfm.forward_decode(cfg, params, nxt, c1)
        lp, _ = tfm.forward_prefill(
            cfg, params, {"tokens": torch.cat([b1["tokens"], nxt], 1),
                          "patches": patches[:1]}, S + 8)
        ld, lp = ld[0, 0, :cfg.vocab], lp[0, 0, :cfg.vocab]
        err, top = max_abs(ld, lp), float(lp.abs().max())
        print(f"  decode of position {S + 1} after a prefill of {S} vs a "
              f"prefill of {S + 1}: max |diff| {err!r}, {err / top!r} of max "
              f"|logit| {top!r} (limit {LM_DECODE_TOL!r}); argmax "
              f"{int(ld.argmax())} vs {int(lp.argmax())}", flush=True)
        if not err <= LM_DECODE_TOL * top:
            fail(f"vlm decode vs prefill: {err} > {LM_DECODE_TOL} x {top}")
        launches = self.counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"  launches in this run: {launches} (no kernel of this "
              f"repository lies on the vlm path); peak memory allocated "
              f"{peak} B ({peak - base} B above the phase's start)",
              flush=True)
        return dict(launches=launches, step_ms=t_step, step_ops=n_ops,
                    bound=tb, prefill_s=t_pre, peak=peak)


    # -- phases 17 and 18: the ssm and hybrid families -----------------------
    def ssm_path(self, seed: int = 0, cfg=None, max_len: int = 512,
                 new_tokens: int = 32, long_len: int = 1000):
        """An ssm or hybrid config (mamba2-1.3b, zamba2-2.7b) at its
        published widths and depth, weights from ``seed`` in one bf16 copy
        (``A_log``, ``D`` and ``dt_bias`` float32); the engine with 4
        slots, its warmup (the decode step captured), 8 greedy requests of
        prompt lengths 4-11 and ``new_tokens`` each. Then, on the pool's
        state: a graph tick against an eager tick, bit for bit, both under
        ``set_sync_debug_mode("error")``; the tick's device time and ops
        against its byte bound (the weights, the hybrid's shared block once
        per use, the SSM and conv states read and written, the attention
        cache read whole); decode against prefill (``LM_DECODE_TOL``)
        after 9 tokens (one SSD chunk) and after ``long_len`` (several
        chunks, the last padded: the recurrence between chunks and
        ``_final_state`` feed the decode), the hybrid's K/V rows per
        attention cache after the long prefill; one decode step's device
        time after each prefill; layer 0's Mamba2 in float32 over
        ``long_len`` + 1 tokens against a float64 loop over tokens
        (``_mamba_f64``)."""
        from repro_torch import configs
        from repro_torch.models import ssm
        from repro_torch.models import transformer as tfm
        from repro_torch.serving import DecodeEngine, ServeConfig, WarmupSpec
        from repro_torch.solvers import graphs

        cfg = cfg or configs.get("mamba2-1.3b")
        slots, n_req = 4, 8
        dev = self.dev
        rng = np.random.default_rng(seed)
        params, base = self._lm_params(cfg, seed)
        f32 = {n: str(t.dtype) for n, t in params.blocks[0].ssm
               .named_parameters() if t.dtype == torch.float32}
        print(f"  Mamba2: d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of "
              f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv "
              f"{cfg.ssm_conv}, chunk {cfg.ssm_chunk}"
              + (f"; the shared attention + SwiGLU block after every "
                 f"{cfg.attn_every}th layer ({cfg.n_heads} heads over "
                 f"{cfg.n_kv_heads} KV heads of {cfg.head_dim}, d_ff "
                 f"{cfg.d_ff})" if cfg.family == "hybrid" else "")
              + f"; float32 leaves of a block: {f32}", flush=True)
        if sorted(f32) != ["A_log", "D", "dt_bias"]:
            fail(f"Mamba2's float32 leaves are {sorted(f32)}")
        eng = DecodeEngine(cfg, params, ServeConfig(slots=slots,
                                                    max_len=max_len,
                                                    seed=seed), device=dev)
        if eng.params is not params:
            fail("the engine copied parameters already in the compute dtype")
        del params
        prompts = [rng.integers(1, cfg.vocab, size=int(p))
                   for p in rng.integers(4, 12, size=n_req)]
        lens = tuple(sorted({len(p) for p in prompts}))
        self.zero_counts()
        _, t_warm = wall(lambda: eng.warmup(WarmupSpec(prompt_lens=lens)))
        reqs = [eng.submit(p, new_tokens) for p in prompts]
        _, t_run = wall(eng.run)
        short = [(r.uid, len(r.out_tokens)) for r in reqs
                 if len(r.out_tokens) != new_tokens]
        if short or len(eng.done) != n_req:
            fail(f"{len(eng.done)} of {n_req} requests done; with other "
                 f"than {new_tokens} tokens: {short}")
        st = eng.stats()
        print(f"  warmup (the decode graph, prefills at {list(lens)}) "
              f"{t_warm!r} s; served {st['requests']} requests (prompts "
              f"{lens[0]}-{lens[-1]} tokens, {new_tokens} new each, greedy, "
              f"{slots} slots, max_len {max_len}) in {t_run!r} s: "
              f"{st['tokens_per_s']!r} tokens/s, mean TTFT "
              f"{st['mean_ttft_s']!r} s, mean latency "
              f"{st['mean_latency_s']!r} s (host clock)", flush=True)
        launches = self.counts()
        print(f"  launches in this run: {launches} (no kernel of this "
              f"repository lies on the {cfg.family} path); cache "
              f"{ {k: (tuple(v.shape), str(v.dtype)) for k, v in eng.cache.items()} }",
              flush=True)

        # a graph tick against an eager tick, both without a host sync
        eng.tokens.copy_(torch.from_numpy(eng.last_token[:, None]))
        saved = eng.state()
        reps = max(self.reps // 2, 2)
        prof = tick_profile(eng, saved, runs=3, reps=reps, sync="error")
        t_tick, tick_ops = prof["ms"], prof["ops"]
        n_ops = sum(tick_ops.values())
        emb, cache = eng.params.embed.w, eng.cache
        bf = emb.element_size()
        w_b = sum(p.numel() * p.element_size()
                  for p in eng.params.parameters()) \
            - emb.numel() * bf + slots * cfg.d_model * bf
        uses = 0
        if eng.params.shared is not None:
            uses = tfm.n_attn_caches(cfg)
            w_b += (uses - 1) * sum(p.numel() * p.element_size() for p in
                                    eng.params.shared.parameters())
        state_b = 2 * cache["ssm"].numel() * cache["ssm"].element_size()
        conv_b = 2 * cache["conv"].numel() * cache["conv"].element_size()
        kv_b = 2 * cache["k"].numel() * bf if "k" in cache else 0
        nbytes = w_b + state_b + conv_b + kv_b + 4 * slots * cfg.vocab_padded
        tb, by = bound_ms(nbytes, 2 * slots * (w_b // bf),
                          PEAK_BF16_OPS_PER_S)
        print(f"  the decode tick ({slots} slots): logits and cache of a "
              f"graph tick equal an eager tick's bit for bit (3 times, both "
              f"under set_sync_debug_mode('error')); wall eager "
              f"{prof['wall_eager']!r} s, graph {prof['wall_graph']!r} s "
              f"(medians of 3); device {t_tick!r} ms (CUDA events over "
              f"{reps} replays, windows {prof['windows']}); on "
              f"{card_line()}", flush=True)
        print(f"  bound {tb!r} ms by {by} ({t_tick / tb!r} x): {nbytes} B = "
              f"weights {w_b} B in {cfg.dtype} (the embedding's {slots} "
              f"rows" + (f"; the shared block read at each of its {uses} "
                         f"uses" if uses else "")
              + f"), the SSM state read and written {state_b} B "
              f"(float32), the conv state {conv_b} B, the attention cache "
              f"read whole {kv_b} B", flush=True)
        print(f"  its device ops (one tick, counted on the host): {n_ops}, "
              f"{n_ops / cfg.n_layers!r} a layer, "
              f"{t_tick * 1e3 / max(n_ops, 1)!r} us of device time each; "
              f"most frequent {tick_ops.most_common(12)}", flush=True)
        del saved

        # decode against prefill, after one chunk and after several
        big = long_len + 24
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, long_len + 1))
                                .astype(np.int32)).to(dev)
        steps = {}
        for n in (9, long_len):
            (_, c), t_pre = wall(lambda: tfm.forward_prefill(
                cfg, eng.params, {"tokens": toks[:, :n]}, big))
            ld, _ = tfm.forward_decode(
                cfg, eng.params, toks[:, n:n + 1],
                {k: v.clone() for k, v in c.items()})
            lp, _ = tfm.forward_prefill(cfg, eng.params,
                                        {"tokens": toks[:, :n + 1]}, big)
            ld, lp = ld[0, 0, :cfg.vocab], lp[0, 0, :cfg.vocab]
            err, top = max_abs(ld, lp), float(lp.abs().max())
            Q = min(cfg.ssm_chunk, n)
            nq = -(-n // Q)
            print(f"  decode of token {n + 1} after a prefill of {n} ({nq} "
                  f"chunk{'s' if nq > 1 else ''} of {Q}, the last padded by "
                  f"{nq * Q - n}; the prefill {t_pre!r} s) vs a prefill of "
                  f"{n + 1}: max |diff| {err!r}, {err / top!r} of max |logit| "
                  f"{top!r} (limit {LM_DECODE_TOL!r}); argmax "
                  f"{int(ld.argmax())} vs {int(lp.argmax())}", flush=True)
            if not err <= LM_DECODE_TOL * top:
                fail(f"{cfg.name} decode vs prefill at {n}: {err} > "
                     f"{LM_DECODE_TOL} x {top}")
            if n == long_len and "k" in c:
                rows = [int(c["k"][a, 0].flatten(1).ne(0).any(1).sum())
                        for a in range(c["k"].shape[0])]
                print(f"  after the prefill of {n}: len {c['len'].tolist()}; "
                      f"nonzero K rows per attention cache {rows} (layers "
                      f"{[i for i in range(cfg.n_layers) if i % cfg.attn_every == cfg.attn_every - 1]} "
                      f"write caches {list(range(len(rows)))})", flush=True)
                if rows != [n] * tfm.n_attn_caches(cfg):
                    fail(f"hybrid K rows per attention cache {rows}, not "
                         f"{n} in each of {tfm.n_attn_caches(cfg)}")
            # one decode step's device time from this state, as a graph
            tok = toks[:, n:n + 1].clone()
            step = graphs.Graph(lambda: tfm.forward_decode(
                cfg, eng.params, tok, c)[0], dev)
            step()
            steps[n] = timed(step, reps)
            del step, c
        print(f"  one decode step (batch 1, cache of {big}, a CUDA graph) "
              f"after a prefill of 9: {steps[9]!r} ms; after {long_len}: "
              f"{steps[long_len]!r} ms (CUDA events over {reps} replays; the "
              f"state's size does not depend on the length)", flush=True)

        # layer 0's Mamba2 in float32 against a float64 loop over tokens
        p32 = ssm.init(None, cfg, torch.float32, device=dev)
        with torch.no_grad():
            for t32, t in zip(p32.parameters(),
                              eng.params.blocks[0].ssm.parameters()):
                t32.copy_(t)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        x = torch.randn((1, long_len + 1, cfg.d_model), generator=g,
                        device=dev)
        y_pre, st = ssm.apply_full(p32, cfg, x[:, :long_len], torch.float32)
        h_pre = st["ssm"].clone()
        y_dec, st = ssm.apply_decode(p32, cfg, x[:, long_len:], st,
                                     torch.float32)
        y64, hs, top = self._mamba_f64(p32, cfg, x, (long_len, long_len + 1))
        tol = max(1e-5, 8 * float(np.spacing(np.float32(top))))
        errs = [max_abs(a.double(), b) / float(b.abs().max()) for a, b in (
            (torch.cat([y_pre, y_dec], 1), y64), (h_pre, hs[0]),
            (st["ssm"], hs[1]))]
        print(f"  layer 0's Mamba2 in float32 on {long_len} + 1 tokens ~ "
              f"N(0, 1) (apply_full, then apply_decode) against a float64 "
              f"loop over tokens: y {errs[0]!r}, the state handed to decode "
              f"{errs[1]!r}, after the decode step {errs[2]!r} of their max "
              f"|value| (limit {tol!r}: 8 float32 ulps of max |sum dt A| = "
              f"{top!r}, the exponent the SSD's sums carry)", flush=True)
        if not max(errs) <= tol:
            fail(f"{cfg.name} layer 0 vs the float64 loop: {errs} > {tol}")
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak memory allocated in the phase: {peak} B "
              f"({peak - base} B above the {base} B allocated before it)",
              flush=True)
        return dict(launches=launches, tick_ms=t_tick, tick_ops=n_ops,
                    bound=tb, step_ms=steps, peak=peak)

    # -- phase 19: the encdec family -----------------------------------------
    def encdec_path(self, seed: int = 0, cfg=None, batch: int = 4,
                    frames: int = 1500, prompt: int = 8,
                    new_tokens: int = 32):
        """seamless-m4t-large-v2 at its published widths and depth (``cfg``
        overrides, for a rehearsal), weights from ``seed`` in one bf16
        copy; ``forward_prefill`` of ``batch`` rows, each ``frames``
        audio-stub frames ~ N(0, 1) (bf16; 1,500 is 30 s of speech at a 20
        ms stride) and ``prompt`` tokens, into a cache of ``prompt + 64``
        positions; ``new_tokens`` greedy steps of ``forward_decode``, the
        step one CUDA graph over the static token and cache (as
        ``vlm_path``), the next token chosen on the device; a graph step
        against an eager step bit for bit, both under
        ``set_sync_debug_mode("error")``, with ``ek``/``ev`` bit-unchanged;
        the step's device time and ops against its byte bound; decode of
        the next position against a prefill one token longer
        (``LM_DECODE_TOL``); decoder layer 0's cross-attention of row 0's
        decode query over its ``frames`` encoder rows against a float64
        computation from the same bf16 tensors (``XATTN_TOL``)."""
        from repro_torch import configs
        from repro_torch.models import attention as attn
        from repro_torch.models import io_spec
        from repro_torch.models import transformer as tfm
        from repro_torch.solvers import graphs

        cfg = cfg or configs.get("seamless-m4t-large-v2")
        dev = self.dev
        B, Se, d = batch, frames, cfg.d_model
        max_len = prompt + 64
        rng = np.random.default_rng(seed)
        params, base = self._lm_params(cfg, seed)
        proj = params.projector.w.numel()
        pad = (cfg.vocab_padded - cfg.vocab) * d * 2
        print(f"  outside param_count(): the audio projector {proj} "
              f"({io_spec.STUB_DIM} x {d}), enc_lnf {d}, the vocab padding "
              f"of the embedding and the head {pad}: {proj + d + pad} in all; "
              f"{cfg.enc_layers} encoder and {cfg.n_layers} decoder layers",
              flush=True)
        self.zero_counts()
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        dt = getattr(torch, cfg.dtype)
        fr = torch.randn((B, Se, io_spec.STUB_DIM), generator=g,
                         device=dev).to(dt)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, prompt))
                                .astype(np.int32)).to(dev)
        batch_in = {"tokens": toks, "frames": fr}
        (logits, cache), t_pre = wall(lambda: tfm.forward_prefill(
            cfg, params, batch_in, max_len))
        if list(cache) != ["k", "v", "len", "ek", "ev"]:
            fail(f"encdec cache keys {list(cache)}")
        want = (cfg.n_layers, B, Se, cfg.n_kv_heads, cfg.head_dim)
        if tuple(cache["ek"].shape) != want or cache["ek"].dtype != dt:
            fail(f"encdec ek {tuple(cache['ek'].shape)} {cache['ek'].dtype}")
        if not torch.equal(cache["len"].cpu(), torch.full(
                (B,), prompt, dtype=torch.int32)):
            fail(f"encdec prefill: cache len {cache['len'].tolist()}")
        if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
            fail("encdec prefill: logits not finite")
        qc, kc = min(512, Se), min(1024, Se)
        print(f"  forward_prefill of {B} rows x ({Se} frames + {prompt} "
              f"tokens) into a cache of {max_len}: {t_pre!r} s (host clock, "
              f"eager, first call); the encoder's self-attention runs "
              f"{-(-Se // qc)} q-chunks of {qc} (the last {Se - (-(-Se // qc) - 1) * qc} "
              f"valid), each cross-attention {-(-Se // kc)} KV chunks of "
              f"{kc} (the last {Se - (-(-Se // kc) - 1) * kc} valid)",
              flush=True)
        ek0, ev0 = cache["ek"].clone(), cache["ev"].clone()

        # the decode step as one graph over the static token and cache
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None].contiguous()

        def body():
            return tfm.forward_decode(cfg, params, tok, cache)[0]

        step = graphs.Graph(body, dev)
        saved = {key: v.clone() for key, v in cache.items()}
        saved_tok = tok.clone()

        def restore():
            for key, v in cache.items():
                v.copy_(saved[key])
            tok.copy_(saved_tok)

        _, t_cap = wall(step)
        restore()
        gen = [tok.clone()]

        def greedy():
            for _ in range(new_tokens):
                out = step()
                tok.copy_(out[:, -1].argmax(-1).to(torch.int32)[:, None])
                gen.append(tok.clone())

        _, t_dec = wall(greedy)
        if not torch.equal(cache["len"].cpu(), torch.full(
                (B,), prompt + new_tokens, dtype=torch.int32)):
            fail(f"encdec decode: cache len {cache['len'].tolist()}")
        for key, v0 in (("ek", ek0), ("ev", ev0)):
            if not torch.equal(cache[key], v0):
                fail(f"encdec decode: {new_tokens} steps changed {key}")
        seqs = torch.cat(gen, 1).cpu().numpy()
        print(f"  {new_tokens} greedy steps (graph replays, the next token "
              f"chosen on the device): {t_dec!r} s, "
              f"{t_dec / new_tokens!r} s a step (host clock; the capture "
              f"{t_cap!r} s); ek/ev bit-unchanged; row 0's tokens "
              f"{seqs[0, :12].tolist()}...", flush=True)

        # a graph step against an eager step, on the same state
        saved = {key: v.clone() for key, v in cache.items()}
        saved_tok = tok.clone()
        for _ in range(3):
            restore()
            with sync_debug("error"), graphs.eager():
                le = step().clone()
            after = {key: v.clone() for key, v in cache.items()}
            restore()
            with sync_debug("error"):
                lg = step().clone()
            same_bits(lg, le, "encdec graph step vs eager step logits")
            for key, v in cache.items():
                if not torch.equal(v, after[key]):
                    fail(f"encdec graph step vs eager step: {key} differs")
            for key, v0 in (("ek", ek0), ("ev", ev0)):
                if not torch.equal(cache[key], v0):
                    fail(f"encdec step changed {key}")
            if not torch.equal(cache["len"], saved["len"] + 1):
                fail("encdec step: len did not advance in every row")
        restore()
        reps = max(self.reps // 5, 2)
        t_step = timed(step, reps)
        restore()
        with graphs.eager():
            step_ops = collections.Counter(aten_ops(step))
        restore()
        n_ops = sum(step_ops.values())
        bf = params.embed.w.element_size()
        # the weights a step reads: the decoder but the cross-attention's
        # wk/wv (prefill used them), lnf, the head, B rows of the embedding
        n_w = sum(p.numel() for b in params.blocks
                  for n, p in b.named_parameters()
                  if not n.startswith(("xattn.wk", "xattn.wv")))
        n_w += params.lnf.g.numel() + B * d + (
            params.head.w.numel() if params.head is not None else 0)
        w_b = n_w * bf
        enc_b = 2 * cache["ek"].numel() * bf
        kv_b = 2 * cache["k"].numel() * bf        # read whole at max_len
        flops = 2 * B * n_w + 4 * B * cfg.n_layers * cfg.n_heads \
            * cfg.head_dim * (Se + max_len)
        tb, by = bound_ms(w_b + enc_b + kv_b + 4 * B * cfg.vocab_padded,
                          flops, PEAK_BF16_OPS_PER_S)
        print(f"  the decode step ({B} rows at length "
              f"{prompt + new_tokens}): logits and cache of a graph step "
              f"equal an eager step's bit for bit, both under sync-debug "
              f"\"error\" (3 times), ek/ev untouched; device {t_step!r} ms "
              f"(CUDA events over {reps} replays); bound {tb!r} ms by {by} "
              f"(weights {w_b} B, the embedding's rows and no encoder; "
              f"ek/ev {enc_b} B; the self-attention cache {kv_b} B): "
              f"{t_step / tb!r} x; on {card_line()}", flush=True)
        print(f"  its device ops (one step, counted on the host): {n_ops}, "
              f"{n_ops / cfg.n_layers!r} a layer, "
              f"{t_step * 1e3 / max(n_ops, 1)!r} us of device time each; "
              f"most frequent {step_ops.most_common(10)}", flush=True)

        # decoder layer 0's cross-attention for row 0 against float64
        seen = []
        cross = attn.apply_cross

        def tap(p, cfg_, x, ek, ev, dtype):
            y = cross(p, cfg_, x, ek, ev, dtype)
            if not seen:
                seen.append((p, x.clone(), ek.clone(), ev.clone(), y.clone()))
            return y

        attn.apply_cross = tap
        try:
            restore()
            with graphs.eager():
                step()
        finally:
            attn.apply_cross = cross
        restore()
        if not seen or seen[0][0] is not params.blocks[0].xattn:
            fail("the decode step did not reach attention.apply_cross of "
                 "decoder layer 0 first")
        p0, x0, k0, v0, y0 = seen[0]
        err, top, lmax = self._cross_f64(p0, cfg, x0[0, 0], k0[0], v0[0],
                                         y0[0, 0])
        print(f"  decoder layer 0's cross-attention, row 0's decode query "
              f"over its {Se} encoder rows, against float64 from the same "
              f"bf16 tensors: max |diff| {err!r}, {err / top!r} of max |y| "
              f"{top!r} (limit {XATTN_TOL!r}); max over heads of "
              f"sum |q_i k_i| / sqrt(hd) {lmax!r}", flush=True)
        if not err <= XATTN_TOL * top:
            fail(f"encdec cross-attention vs float64: {err} > {XATTN_TOL} "
                 f"x {top}")
        del step, saved, after, cache, ek0, ev0, seen

        # decode of the next position against a prefill one longer
        b1 = {"tokens": toks[:1], "frames": fr[:1]}
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 1)).astype(
            np.int32)).to(dev)
        _, c1 = tfm.forward_prefill(cfg, params, b1, prompt + 8)
        ld, _ = tfm.forward_decode(cfg, params, nxt, c1)
        lp, _ = tfm.forward_prefill(
            cfg, params, {"tokens": torch.cat([b1["tokens"], nxt], 1),
                          "frames": fr[:1]}, prompt + 8)
        ld, lp = ld[0, 0, :cfg.vocab], lp[0, 0, :cfg.vocab]
        err, top = max_abs(ld, lp), float(lp.abs().max())
        print(f"  decode of position {prompt + 1} after a prefill of "
              f"{prompt} vs a prefill of {prompt + 1} (the same {Se} "
              f"frames): max |diff| {err!r}, {err / top!r} of max |logit| "
              f"{top!r} (limit {LM_DECODE_TOL!r}); argmax "
              f"{int(ld.argmax())} vs {int(lp.argmax())}", flush=True)
        if not err <= LM_DECODE_TOL * top:
            fail(f"encdec decode vs prefill: {err} > {LM_DECODE_TOL} x {top}")
        launches = self.counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"  launches in this run: {launches} (no kernel of this "
              f"repository lies on the encdec path); peak memory allocated "
              f"{peak} B ({peak - base} B above the phase's start)",
              flush=True)
        return dict(launches=launches, step_ms=t_step, step_ops=n_ops,
                    bound=tb, prefill_s=t_pre, peak=peak)

    @staticmethod
    def _cross_f64(p, cfg, x, k, v, y):
        """``attention.apply_cross`` of one query row ``x`` ``[d]`` over
        ``k``/``v`` ``[Se, KV, hd]`` in float64 from the same tensors
        (``p``'s weights); returns (max |y - y64|, max |y64|, the largest
        sum over a head of |q_i k_i| / sqrt(hd), which bounds how far q's
        rounding moves a logit, in units of that rounding)."""
        def f64(t):
            return t.double().cpu().numpy()

        def dense(lin, a):
            out = a @ f64(lin.w)
            return out + f64(lin.b) if lin.b is not None else out

        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = dense(p.wq, f64(x)).reshape(H, hd)
        # query head h reads KV head h // (H / KV), as flash_attention's
        # [KV, G] split of the heads
        kk = np.repeat(f64(k), H // KV, axis=1)            # [Se, H, hd]
        vv = np.repeat(f64(v), H // KV, axis=1)
        s = np.einsum("hd,shd->hs", q, kk) / np.sqrt(hd)
        s -= s.max(axis=1, keepdims=True)
        w = np.exp(s)
        w /= w.sum(axis=1, keepdims=True)
        y64 = dense(p.wo, np.einsum("hs,shd->hd", w, vv).reshape(-1))
        lmax = float(np.einsum("hd,shd->hs", np.abs(q), np.abs(kk)).max()
                     / np.sqrt(hd))
        return (float(np.abs(f64(y) - y64).max()), float(np.abs(y64).max()),
                lmax)

    # -- phase 20: the training path -----------------------------------------
    @staticmethod
    def train_peak(cfg, n_par: int, batch: int, seq_len: int,
                   chunk: int = 512) -> int:
        """Phase 20's predicted peak of allocated memory above its start:
        the float32 master, m, v and gradients (16 B a parameter); one CE
        chunk's float32 logits four times (the product's output, the
        masked copy, the softmax and its gradient); the compute copy of
        the embedding (the tied head) and its gradient in bf16; the update's
        temporaries on the largest leaf, five float32 copies; the layers'
        saved inputs, one bf16 ``[B, S, d]`` each."""
        vp, d = cfg.vocab_padded, cfg.d_model
        ce = 4 * batch * min(chunk, seq_len) * vp * 4
        emb = 2 * 2 * vp * d
        upd = 5 * 4 * vp * d
        acts = cfg.n_layers * batch * seq_len * d * 2
        return 16 * n_par + ce + emb + upd + acts

    def train_path(self, seed: int = 0, cfg=None, seq_len: int = 1024,
                   batch: int = 8, steps: int = 12, ckpt_every: int = 6,
                   root: str = "build/train_smoke",
                   learn: float = LEARN_DROP):
        """qwen2-0.5b at its published widths and depth (``cfg`` overrides,
        for a rehearsal): ``Trainer`` on the card with a float32 master and
        bf16 compute, the synthetic stream from ``seed`` (``seq_len`` x
        ``batch`` tokens a step), ``steps`` steps at the launcher's
        defaults (lr 3e-4, warmup steps // 10), a checkpoint every
        ``ckpt_every`` under ``root`` (removed after). First, on the
        initial master and the first batch: microbatch ``batch // 2``
        against the whole batch (``MB_*_TOL``) and the bf16 loss and
        gradient norm against float32 compute (``BF16_*_TOL``). Then the
        run: every loss finite, the mean of the last four below that of
        the first four by more than ``learn`` (``LEARN_DROP``); the last
        checkpoint removed, a new ``Trainer`` restores the one before and
        runs to the end, its master, m and v equal to the uninterrupted
        run's bit for bit, its losses too; peak memory against
        :meth:`train_peak`. Prints the step's host wall and
        CUDA-event time, tokens/s, the share of the dense bf16 peak,
        the checkpoint walls and the ops of one step."""
        import dataclasses
        import shutil

        from repro_torch import configs
        from repro_torch.data import DataConfig, SyntheticTokenStream
        from repro_torch.launch import steps as tsteps
        from repro_torch.models import transformer as tfm
        from repro_torch.optim import OptConfig, global_norm, init_state
        from repro_torch.train import Trainer, TrainerConfig

        cfg = cfg or configs.get("qwen2-0.5b")
        dev = self.dev
        root = Path(root)
        shutil.rmtree(root, ignore_errors=True)
        self.zero_counts()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        opt = OptConfig(lr_peak=3e-4, warmup=max(steps // 10, 1),
                        total_steps=steps)
        T = seq_len * batch

        # the checks on the initial master and the first batch
        (master, sec) = wall(lambda: init_state(
            tfm.init_params(cfg, seed, device=dev)).master)
        n_par = sum(p.numel() for p in master.parameters())
        print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to "
              f"{cfg.vocab_padded}, tied head; {n_par} parameters, a "
              f"float32 master from seed {seed} in {sec!r} s; compute "
              f"{cfg.dtype}; {batch} x {seq_len} = {T} tokens a step",
              flush=True)
        b0 = SyntheticTokenStream(DataConfig(
            vocab=cfg.vocab, seq_len=seq_len, global_batch=batch,
            seed=seed)).next_batch(dev)
        groups = tfm.reference_groups(master)

        def evaluate(c, mb=None):
            def run():
                loss, grads = tsteps.grads_of(c, master, b0, mb)
                return float(loss), float(global_norm(grads, groups))
            return wall(run)

        (lf, gf), tf = evaluate(cfg)
        (lm, gm), tm = evaluate(cfg, batch // 2)
        (l32, g32), t32 = evaluate(dataclasses.replace(cfg, dtype="float32"))
        del master, b0
        ml, mg = abs(lm - lf) / lf, abs(gm - gf) / gf
        bl, bg = abs(lf - l32) / l32, abs(gf - g32) / g32
        print(f"  the first batch, the initial master: {cfg.dtype} loss "
              f"{lf!r}, gradient norm {gf!r} ({tf!r} s, the first call); "
              f"microbatch {batch // 2} of {batch}: loss {lm!r}, norm "
              f"{gm!r} ({tm!r} s): {ml!r} and {mg!r} apart (limits "
              f"{MB_LOSS_TOL!r}, {MB_GNORM_TOL!r}); float32 compute: loss "
              f"{l32!r}, norm {g32!r} ({t32!r} s): {cfg.dtype} {bl!r} and "
              f"{bg!r} apart (limits {BF16_LOSS_TOL!r}, "
              f"{BF16_GNORM_TOL!r})", flush=True)
        if not (ml <= MB_LOSS_TOL and mg <= MB_GNORM_TOL):
            fail(f"microbatch vs full batch: loss {ml}, norm {mg} apart")
        if not (bl <= BF16_LOSS_TOL and bg <= BF16_GNORM_TOL):
            fail(f"{cfg.dtype} vs float32: loss {bl}, norm {bg} apart")

        mark("first-batch checks (microbatch, float32)")
        def timed_trainer(tr, keep_at=None, master_at=None):
            """``tr`` with its step and checkpoint save timed; the state's
            fingerprints after step ``keep_at`` and a host copy of its
            master after step ``master_at`` (for phase 23)."""
            rec = {"wall": [], "ev": [], "save": []}
            step_fn, save = tr._step_fn, tr.ckpt.save

            def step(state, b):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                out = step_fn(state, b)
                e1.record()
                torch.cuda.synchronize()
                rec["wall"].append(time.perf_counter() - t0)
                rec["ev"].append(e0.elapsed_time(e1))
                if len(rec["wall"]) == keep_at:
                    rec["fps"] = state_fps(out[0])
                if len(rec["wall"]) == master_at:
                    rec["master"] = [p.detach().to("cpu", copy=True)
                                     for p in out[0].master.parameters()]
                return out

            def timed_save(*a, **kw):
                out, sec = wall(lambda: save(*a, **kw))
                rec["save"].append(sec)
                return out

            tr._step_fn, tr.ckpt.save = step, timed_save
            return rec

        # the run
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tcfg = TrainerConfig(steps=steps, ckpt_dir=str(root),
                             ckpt_every=ckpt_every, log_every=1, seed=seed,
                             seq_len=seq_len, global_batch=batch)
        logs = []
        ta = Trainer(cfg, opt, tcfg, device=dev, log_fn=logs.append)
        rec = timed_trainer(ta, keep_at=min(4, steps),
                            master_at=min(DP_STEPS, steps))
        sa, t_run = wall(ta.run)
        mark("the run with its checkpoints")
        peak = torch.cuda.max_memory_allocated() - base
        losses = [h["loss"] for h in ta.history]
        n4 = min(4, len(losses) // 2)
        fell = (sum(losses[:n4]) - sum(losses[-n4:])) / max(n4, 1)
        lnv = float(np.log(cfg.vocab))
        print(f"  {steps} steps in {t_run!r} s (host clock, checkpoints "
              f"included): losses {losses} (ln V {lnv!r}); "
              f"the last {n4} below the first {n4} by {fell!r} on average "
              f"(needs more than {learn!r}); the last below the first by "
              f"{losses[0] - losses[-1]!r}", flush=True)
        if len(losses) != steps or not all(np.isfinite(losses)):
            fail(f"training losses {losses}")
        if not fell > learn:
            fail(f"no learning signal: the last {n4} losses below the first "
                 f"{n4} by {fell} on average, not more than {learn}")
        if ta.ckpt.steps() != list(range(ckpt_every, steps + 1,
                                         ckpt_every))[-3:]:
            fail(f"checkpoints {ta.ckpt.steps()}")

        # the resume: the last checkpoint removed, the one before restored
        shutil.rmtree(root / f"step_{steps}")
        # it writes no checkpoint: its save at the last step would repeat
        # the uninterrupted run's (phase 20's cut for time)
        tb = Trainer(cfg, opt, dataclasses.replace(tcfg, ckpt_every=10 ** 9),
                     device=dev, log_fn=logs.append)
        rec_b = timed_trainer(tb)
        sb0, t_restore = wall(tb.init_or_restore)
        if int(sb0.step) != steps - ckpt_every:
            fail(f"restored step {int(sb0.step)}")
        sb = tb.run(sb0)
        for name in ("master", "m", "v"):
            for (k, a), b in zip(getattr(sa, name).named_parameters(),
                                 getattr(sb, name).parameters()):
                if not torch.equal(a, b):
                    fail(f"resumed run: {name} {k} differs from the "
                         f"uninterrupted run's")
        if int(sb.step) != steps or [h["loss"] for h in tb.history] != \
                losses[steps - ckpt_every:]:
            fail(f"resumed run: losses {tb.history}, uninterrupted "
                 f"{losses[steps - ckpt_every:]}")
        print(f"  the resume: step_{steps} removed, a new Trainer restored "
              f"step {steps - ckpt_every} ({t_restore!r} s) and ran to "
              f"{steps}; master, m and v equal the uninterrupted run's bit "
              f"for bit, and its losses", flush=True)
        del sa, sb0

        mark("the resume")
        # the ops of one step, counted on the host
        step_fn = tsteps.make_train_step(cfg, opt)
        bx = tb.data.next_batch(dev)
        step_ops = collections.Counter(aten_ops(lambda: step_fn(sb, bx)))
        n_ops = sum(step_ops.values())
        del sb, bx, ta, tb

        walls = sorted(rec["wall"][1:] + rec_b["wall"][1:])
        evs = sorted(rec["ev"][1:] + rec_b["ev"][1:])
        wall_s, ev_ms = walls[len(walls) // 2], evs[len(evs) // 2]
        L, H, hd, d = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
        # the forward's attention products: QK^T and PV over the KV chunks
        # flash_attention computes (a q-chunk skips only whole KV chunks
        # above the diagonal)
        qc, kc = min(512, seq_len), min(1024, seq_len)
        kv = sum(min(-(-seq_len // kc), (i * qc + qc - 1) // kc + 1) * kc
                 * qc for i in range(-(-seq_len // qc)))
        attn_fwd = 4 * batch * kv * H * hd * L
        model = 6 * n_par * T + 3 * attn_fwd
        head = 2 * T * d * cfg.vocab_padded
        recompute = 2 * (n_par - cfg.vocab_padded * d) * T + attn_fwd + head
        share = model / (ev_ms * 1e-3 * PEAK_BF16_OPS_PER_S)
        share_all = (model + recompute) / (ev_ms * 1e-3
                                           * PEAK_BF16_OPS_PER_S)
        pred = self.train_peak(cfg, n_par, batch, seq_len)
        launches = self.counts()
        print(f"  a step (median of {len(walls)}, the first of each run left "
              f"out): host wall {wall_s!r} s, CUDA events {ev_ms!r} ms; "
              f"{T / wall_s!r} tokens/s; model FLOPs 6 N T + attention "
              f"{model} ({model / 1e12!r} T), the recompute {recompute} "
              f"more: {share!r} of the dense bf16 peak "
              f"({PEAK_BF16_OPS_PER_S!r}), {share_all!r} with the "
              f"recompute; on {card_line()}", flush=True)
        print(f"  every step's walls {rec['wall']} + {rec_b['wall']} s, "
              f"CUDA events {rec['ev']} + {rec_b['ev']} ms", flush=True)
        print(f"  checkpoints: save {rec['save']} + {rec_b['save']} s "
              f"(host clock; master, m, v and the step, "
              f"{12 * n_par + 4} B), restore {t_restore!r} s", flush=True)
        print(f"  its device ops (one step, counted on the host): {n_ops}; "
              f"most frequent {step_ops.most_common(10)}", flush=True)
        print(f"  peak memory allocated above the run's start {peak} B, "
              f"predicted {pred} B ({peak / pred!r} x; limit "
              f"{TRAIN_PEAK_RATIO!r} x); launches {launches} (no kernel of "
              f"this repository lies on the training path)", flush=True)
        if not peak <= TRAIN_PEAK_RATIO * pred:
            fail(f"training peak memory {peak} B > {TRAIN_PEAK_RATIO} x "
                 f"{pred} B")
        shutil.rmtree(root, ignore_errors=True)
        self.keep20 = dict(cfg=cfg, opt=dataclasses.asdict(opt), seed=seed,
                           seq_len=seq_len, batch=batch,
                           losses=losses[:min(4, steps)], fps=rec["fps"],
                           master=rec["master"],
                           master_at=min(DP_STEPS, steps),
                           step_wall=wall_s, step_ms=ev_ms)
        return dict(launches=launches, losses=losses, step_wall=wall_s,
                    step_ms=ev_ms, tokens_per_s=T / wall_s, share=share,
                    peak=peak, pred=pred, save=rec["save"] + rec_b["save"],
                    restore=t_restore, ops=n_ops)

    # -- phase 23: the training data axis across processes -----------------
    def _stacked_train(self, spec: dict, key: str, tag: str = ""):
        """Run ``key`` of phase 23 in the stacked form: its shards one
        after another in this process, on the card (its directory named
        ``key + tag``). Returns (losses, fingerprints, trainer, state)."""
        from repro_torch.launch.mesh import make_stacked_mesh
        from repro_torch.optim import OptConfig
        from repro_torch.train import Trainer

        run = spec["runs"][key]
        t = Trainer(_train_cfg(spec, run), OptConfig(**spec["opt"]),
                    _train_tcfg(spec, dict(run, ckpt_every=None),
                                str(Path(spec["root"], "stacked",
                                         key + tag))),
                    mesh=make_stacked_mesh(data=run["data"],
                                           pods=run["pods"], device=self.dev),
                    log_fn=lambda _: None)
        state = t.run()
        return ([h["loss"] for h in t.history],
                state_fps(state, t._step_fn.layout), t, state)

    def _master_gaps(self, spec: dict, master) -> tuple:
        """Phase 23 (b)'s master check: |b1 - a| / |a - initial| for b1's
        master (``master``, the stacked form's, bit-equal to the ranks')
        and for a planted fault's (the stacked b1 with each shard's slices
        from its own gradient alone, :func:`own_gradient_alone`); ``a`` is
        a one-device trainer's master after as many steps on b1's model
        (its ``layers``), from the same seed and batches. Returns (the two
        ratios, a's losses)."""
        from repro_torch.launch import steps as tsteps
        from repro_torch.models import transformer as tfm
        from repro_torch.optim import OptConfig
        from repro_torch.train import Trainer

        run = spec["runs"]["b1"]
        cfg = _train_cfg(spec, run)
        one = Trainer(cfg, OptConfig(**spec["opt"]), _train_tcfg(
            spec, dict(run, data=1, pods=1, ckpt_every=None),
            str(Path(spec["root"], "one_b1"))), device=self.dev,
            log_fn=lambda _: None)
        sa = one.run()
        ref = [p.detach().to("cpu", copy=True) for p in sa.master.parameters()]
        losses = [h["loss"] for h in one.history]
        del one, sa
        base = [p.float() for p in tfm.init_params(
            cfg, spec["seed"], device=self.dev).parameters()]
        sound, update = master_gap(master.parameters(), ref, base)
        del base
        reduce = tsteps.reduce_gradients
        tsteps.reduce_gradients = own_gradient_alone(reduce)
        try:
            _, _, t, state = self._stacked_train(spec, "b1", "_fault")
        finally:
            tsteps.reduce_gradients = reduce
        fault, _ = master_gap(state.master.parameters(), ref)
        del t, state
        return (sound / update, fault / update), losses

    def _codec_ms(self, mesh, n: int, reps: int = 3) -> float:
        """Mean device ms of one stacked ``compressed_wire_reduce`` (u16,
        across ``mesh``'s pods) of ``n`` float32 values a shard: the
        codec's passes and the stacked form's copies, no transport."""
        from repro_torch.optim.compression import compressed_wire_reduce

        g = torch.Generator(device=self.dev).manual_seed(0)
        xs = [torch.randn(n, generator=g, device=self.dev)
              for _ in mesh.local]
        t = timed(lambda: compressed_wire_reduce(xs, mesh, "pod", "u16"),
                  reps, warmup=1)
        del xs
        return t

    def _train_spec(self, steps_a: int = 4, steps_b: int = DP_STEPS,
                    steps_cut: int = 2, cut: int = DP_CUT_LAYERS,
                    root: str = "build/train_ranks_smoke",
                    a_backend: str = "nccl") -> dict:
        """Phase 23's rank runs on phase 20's model, seed, batches and
        schedule (:meth:`train_ranks_path`), phase 24's under
        ``"model"``."""
        k = self.keep20
        return dict(cfg=k["cfg"], opt=k["opt"], seed=k["seed"],
                    seq_len=k["seq_len"], batch=k["batch"], root=root,
                    a_backend=a_backend, order=("b1", "b3"), runs={
                        "a": dict(data=1, pods=1, steps=steps_a),
                        "b1": dict(data=2, pods=1, steps=steps_b,
                                   layers=cut),
                        "b3": dict(data=1, pods=2, steps=steps_cut,
                                   layers=cut, pod_wire="u16",
                                   ckpt_every=steps_cut)},
                    model=self._model_spec(), serve=self._serve_spec())

    def train_ranks_path(self):
        """Phase 20's model, seed, batches and schedule across processes,
        in phase 22's spawn of four gloo ranks sharing the card (every
        collective staged through the host; the runs of
        :meth:`_train_spec`): (a) on rank 0, one NCCL rank,
        ``Trainer(data_axis=1)`` over a one-rank process group for
        ``steps_a`` steps, its losses, master, m and v bit-equal to phase
        20's in-process trainer after as many steps; (b) over both ranks at
        ``cut`` layers, ``data_axis=2`` for ``steps_b`` steps, then a
        (pod 2, data 1) mesh with ``pod_wire='u16'`` (checkpointed at its
        last step) for ``steps_cut`` steps (``grad_compression`` runs in
        phase 24 (e), at (2, 2): the same step with the model shards
        replicated): each rank's losses, master, m and v bit-equal
        to the stacked form run here after the spawn, the plain run's
        losses within ``DP_LOSS_TOL`` of a one-device trainer's on the same
        model and its master within ``DP_MASTER_TOL`` of that trainer's
        update from its master, a planted fault's beyond that limit
        (:meth:`_master_gaps`), and the
        checkpoint restored at P = 1 by a one-device trainer equal to the
        stacked form's state bit for bit; (c) NCCL with one rank per card
        where the machine has two cards or more. Prints each rank's step
        walls, CUDA-event times, exchange walls, bytes on the wire and
        peak memory, and the spawn's start, work and teardown."""
        import shutil

        from repro_torch.optim import adamw
        from repro_torch.parallel.launch import spawn_ranks
        from repro_torch.train import Trainer

        k = self.keep20
        card = card_line()
        ranks = self.train_ranks
        out, spec, sec, spans = (ranks["out"], ranks["spec"], ranks["sec"],
                                 ranks["spans"])
        root = Path(spec["root"])
        runs = spec["runs"]
        steps_a, steps_b = runs["a"]["steps"], runs["b1"]["steps"]
        steps_cut, cut = runs["b3"]["steps"], runs["b1"]["layers"]
        cfg = k["cfg"]
        T = k["batch"] * k["seq_len"]
        self.model_ranks = [r["model"] for r in out]
        self.serve_ranks = [r["serve"] for r in out]
        warm = [r["warm_s"] for r in out[1:]]
        out = out[:2]

        # (a) against phase 20
        a = out[0]["a"]
        if a["losses"] != k["losses"][:steps_a]:
            fail(f"(a) one NCCL rank's losses {a['losses']}, phase 20's "
                 f"{k['losses'][:steps_a]}")
        for key in ("master", "m", "v"):
            if a["fps"][key] != k["fps"][key]:
                fail(f"(a) one NCCL rank's {key} after {steps_a} steps "
                     f"differs from phase 20's in-process trainer")
        print(f"  (a) one NCCL rank ({a['backend']}, a one-rank group inside "
              f"the spawn), {cfg.name} at full width and depth, "
              f"{k['batch']} x {k['seq_len']} tokens, {steps_a} steps: "
              f"losses {a['losses']} and master, m and v equal to phase "
              f"20's in-process Trainer bit for bit; step walls "
              f"{a['wall']} s, CUDA events {a['ev']} ms, exchange walls "
              f"{a['xchg_s']} s, bytes sent per step {a['wire_bytes']} "
              f"(one rank: none leave it), peak {a['peak_bytes']} B; phase "
              f"20's step {k['step_wall']!r} s, {k['step_ms']!r} ms; {card}",
              flush=True)

        # (b) against the stacked forms, run here
        gc.collect()
        torch.cuda.empty_cache()
        stacked = {}
        for key in spec["order"]:
            (losses, fps, t, state), st_s = wall(
                lambda: self._stacked_train(spec, key))
            stacked[key] = (losses, fps, st_s)
            mark("stacked runs")
            for r in out:
                got = r[key]
                if got["losses"] != losses:
                    fail(f"(b) {key} rank {r['rank']}: losses "
                         f"{got['losses']}, the stacked form's {losses}")
                if got["fps"]["master"] != fps["master"]:
                    fail(f"(b) {key} rank {r['rank']}: the master differs "
                         "from the stacked form's")
                for mv in ("m", "v"):
                    if got["fps"][mv][0] != fps[mv][r["rank"]]:
                        fail(f"(b) {key} rank {r['rank']}: its {mv} slices "
                             "differ from the stacked form's shard")
            if key == "b1":
                gaps, one_losses = self._master_gaps(spec, state.master)
                mark("b1's master check (one device, the fault)")
            if key == "b3":
                # the checkpoint the ranks wrote at P = 2, restored at P = 1
                full = {mv: adamw.gather_moments(
                    t.mesh, t._step_fn.layout, getattr(state, mv),
                    t._step_fn.buckets) for mv in ("m", "v")}
                one = Trainer(_train_cfg(spec, spec["runs"]["b3"]),
                              t.opt, _train_tcfg(
                                  spec, dict(data=1, pods=1, steps=steps_cut),
                                  str(root / "b3")), device=self.dev,
                              log_fn=lambda _: None)
                restored, restore_s = wall(one.init_or_restore)
                rfp = state_fps(restored)
                want = {"master": fps["master"], **{
                    mv: [[[fingerprint(x[i]) for i in range(x.shape[0])]
                          if leaf.stacked else [fingerprint(x)]
                          for leaf, x in zip(t._step_fn.layout, full[mv])]]
                    for mv in ("m", "v")}}
                if int(restored.step) != steps_cut or rfp != want:
                    fail("(b) the P = 2 checkpoint restored at P = 1 differs "
                         "from the stacked form's state")
                del one, restored, full
                mark("b3's checkpoint restored at P = 1")
                n_b3 = sum(p.numel() for p in state.master.parameters())
                codec_ms = self._codec_ms(t.mesh, n_b3)
            mark("the u16 codec's time")
            del t, state
            gc.collect()
            torch.cuda.empty_cache()
        b1 = out[0]["b1"]["losses"]
        rel = [abs(x - y) / y for x, y in zip(b1, one_losses)]
        if not max(rel) <= DP_LOSS_TOL:
            fail(f"(b) two ranks' losses {b1} against one device's "
                 f"{one_losses}: {rel} apart, over {DP_LOSS_TOL}")
        gap, fault = gaps
        print(f"  (b) b1's master after {steps_b} steps at {cut} layers "
              f"against a one-device trainer's on the same model, seed and "
              f"batches: {gap!r} of its update (2-norms); a planted fault, "
              f"each rank's slices from its own gradient alone: {fault!r} "
              f"(limit {DP_MASTER_TOL!r}, between them); {card}", flush=True)
        if not gap <= DP_MASTER_TOL < fault:
            fail(f"(b) b1's master {gap} of the one-device update from the "
                 f"one-device master, the planted fault's {fault}: the "
                 f"limit {DP_MASTER_TOL} must lie between them")
        print(f"  (b) two gloo ranks sharing {self.dev}, in phase 22's "
              f"spawn of four ({sec:.1f} s with the processes, phase 22's "
              f"and phase 24's rank runs: "
              f"{spans}; ranks 1-3's first training step, on one row while "
              f"rank 0 ran (a): {warm!r} s); "
              f"each rank's losses, master, m and "
              f"v equal to the stacked form's bit for bit in every run "
              f"(stacked runs {[round(v[2], 2) for v in stacked.values()]} "
              f"s); data_axis 2 losses {b1}, {rel} apart from the one-device "
              f"trainer's (limit {DP_LOSS_TOL!r}); the pod-wire run's checkpoint "
              f"(step {steps_cut}, P = 2) restored by a one-device trainer "
              f"in {restore_s!r} s equal to the stacked form's master, m "
              f"and v bit for bit; {card}", flush=True)
        for key, what in (("b1", f"plain, {cut} layers"),
                          ("b3", f"pod 2 x data 1, pod_wire u16, {cut} "
                                 f"layers")):
            r0, r1 = out[0][key], out[1][key]
            print(f"  (b) {key} ({what}; {r0['n_par']} parameters, {T} "
                  f"tokens a step over 2 ranks): step walls per rank "
                  f"{r0['wall']} / {r1['wall']} s, CUDA events {r0['ev']} / "
                  f"{r1['ev']} ms, the exchange's wall {r0['xchg_s']} / "
                  f"{r1['xchg_s']} s, bytes each rank sends per step "
                  f"{r0['wire_bytes']} / {r1['wire_bytes']} "
                  f"({sum(r0['wire_bytes'][-1].values()) / r0['n_par']!r} "
                  f"B a parameter), "
                  f"peak {r0['peak_bytes']} / {r1['peak_bytes']} B; "
                  f"losses {r0['losses']}; {card}", flush=True)
        print(f"  (b) two ranks share one card and every exchange goes "
              f"through the host: not a multi-GPU figure", flush=True)
        print(f"  (b) the u16 wire's codec, stacked (2 shards in one process, "
              f"no transport): compressed_wire_reduce over 2 x {n_b3} "
              f"float32 values, the b3 gradient as one flat leaf: "
              f"{codec_ms!r} ms a call (CUDA events, mean of 3), against "
              f"the ranks' exchange walls {out[0]['b3']['xchg_s']} s a "
              f"step; {card}", flush=True)

        # (c) NCCL with one rank per card
        count = torch.cuda.device_count()
        if count < 2:
            print(f"  (c) did not run: NCCL with one rank per card needs two "
                  f"cards or more, and this machine has {count}", flush=True)
        else:
            spec_c = dict(spec, order=("b1",), runs={"b1": spec["runs"]["b1"]},
                          root=str(root / "c"))
            del spec_c["model"]
            t_spawn = time.time()
            outc, sec = wall(lambda: spawn_ranks(
                rank_train, 2, backend="nccl", timeout=600, args=(spec_c,)))
            spans = _spans(t_spawn, time.time(), outc)
            losses, fps, _ = stacked["b1"]
            for r in outc:
                if r["b1"]["losses"] != losses or \
                        r["b1"]["fps"]["master"] != fps["master"]:
                    fail(f"(c) rank {r['rank']}: losses {r['b1']['losses']} "
                         f"or master differ from the stacked form's")
            print(f"  (c) NCCL with one rank per card, P = 2 ({sec:.1f} s: "
                  f"{spans}): losses and master equal to the stacked form's "
                  f"bit for bit; step walls {[r['b1']['wall'] for r in outc]}"
                  f" s, CUDA events {[r['b1']['ev'] for r in outc]} ms, "
                  f"exchange {[r['b1']['xchg_s'] for r in outc]} s; {card}",
                  flush=True)
        shutil.rmtree(root, ignore_errors=True)
        return dict(launches={})

    # -- phase 24: the model axis ---------------------------------------------
    def _stacked_model(self, spec: dict, key: str, fault: bool = False):
        """Run ``key`` of phase 24 in the stacked form (its shards one after
        another in this process, on the card), each step's wall timed; with
        ``fault`` the row-parallel reduce-scatter keeps each shard's own
        partial (:func:`own_partial_alone`). Returns (losses, trainer,
        state, step walls)."""
        from repro_torch.launch import mesh as lm
        from repro_torch.optim import OptConfig
        from repro_torch.train import Trainer

        run = spec["runs"][key]
        t = Trainer(_train_cfg(spec, run), OptConfig(**spec["opt"]),
                    _model_tcfg(spec, run, str(Path(spec["root"], "stacked",
                                                    key))),
                    mesh=lm.make_stacked_mesh(data=run["data"],
                                              model=run["model"],
                                              pods=run.get("pods", 1),
                                              device=self.dev),
                    log_fn=lambda _: None)
        walls, step_fn = [], t._step_fn

        def step(state, errs, batches):
            out, sec = wall(lambda: step_fn(state, errs, batches))
            walls.append(sec)
            return out

        functools.update_wrapper(step, step_fn)
        t._step_fn = step
        keep = lm._scatter_rows
        if fault:
            lm._scatter_rows = own_partial_alone
        try:
            state = t.run()
        finally:
            lm._scatter_rows = keep
            t._step_fn = step_fn
        return [h["loss"] for h in t.history], t, state, walls

    def _model_spec(self, steps_a: int = DP_STEPS, steps_b: int = 2,
                    steps_c: int = 2, cut: int = DP_CUT_LAYERS,
                    root: str = "build/model_axis_smoke") -> dict:
        """Phase 24's runs on phase 20's model, seed, batches and schedule:
        (a) (data 1, model 2) at full depth, ``steps_a`` steps; (b) (1, 2)
        and (c) (2, 2) at ``cut`` layers, ``steps_b`` and ``steps_c``
        steps; (e) ``grad_compression`` 10 at (2, 2) and (f) ``pod_wire``
        u16 at (pod 2, data 1, model 2), ``steps_c`` steps each at ``cut``
        layers."""
        k = self.keep20
        return dict(cfg=k["cfg"], opt=k["opt"], seed=k["seed"],
                    seq_len=k["seq_len"], batch=k["batch"], root=root,
                    order=("b", "c", "e", "f"), runs={
                        "a": dict(data=1, model=2, steps=steps_a),
                        "b": dict(data=1, model=2, steps=steps_b, layers=cut),
                        "c": dict(data=2, model=2, steps=steps_c,
                                  layers=cut, count_flops=True),
                        "e": dict(data=2, model=2, steps=steps_c,
                                  layers=cut, grad_compression=10),
                        "f": dict(pods=2, data=1, model=2, steps=steps_c,
                                  layers=cut, pod_wire="u16")})

    def model_axis_path(self, counts: MetaCounts):
        """Phase 20's model, seed, batches and schedule over a model axis
        (tensor-parallel layers, ``models.tensor_parallel``; the runs of
        :meth:`_model_spec`): (a) the stacked (data 1, model 2) form at full
        width and depth on the card, its losses within ``TP_LOSS_TOL`` of
        phase 20's and its master within ``TP_MASTER_TOL`` of phase 20's
        update from phase 20's master, a planted fault's
        (:func:`own_partial_alone`) beyond it; (b) two gloo ranks at (1,
        2), (c) four at (2, 2), (e) four with ``grad_compression`` 10 at
        (2, 2) (replicated over the model shards) and (f) four with
        ``pod_wire`` u16 at (pod 2, data 1, model 2), sharing the card,
        run in phase 22's spawn (``self.model_ranks``), each rank's losses,
        master, m, v (and (e)'s error buffers) bit-equal to the stacked
        form run here, (e)'s model shards of one data shard bit-equal to
        each other; (g) and (h), :meth:`meta_counts`; (d) NCCL with one
        rank per card at (1, 2) where the machine has two cards or more.
        Prints each rank's step walls, the exchange's wall, the bytes it
        sends and its peak memory."""
        import shutil

        from repro_torch.models import tensor_parallel as tp
        from repro_torch.models import transformer as tfm
        from repro_torch.parallel.launch import spawn_ranks

        k = self.keep20
        card = card_line()
        self.zero_counts()
        spec = self._model_spec()
        root = Path(spec["root"])
        shutil.rmtree(root, ignore_errors=True)
        steps_a, cut = spec["runs"]["a"]["steps"], spec["runs"]["b"]["layers"]
        cfg = k["cfg"]
        T = k["batch"] * k["seq_len"]

        # (a) the stacked form at full depth against phase 20
        gc.collect()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (losses, t, state, walls), sec_a = wall(
            lambda: self._stacked_model(spec, "a"))
        peak_a = torch.cuda.max_memory_allocated() - base_mem
        want = k["losses"][:steps_a]
        rel = [abs(x - y) / abs(y) for x, y in zip(losses, want)]
        if len(losses) != steps_a or not max(rel) <= TP_LOSS_TOL:
            fail(f"(a) the stacked model axis's losses {losses}, phase 20's "
                 f"{want}: {rel} apart, over {TP_LOSS_TOL}")
        if steps_a != k["master_at"]:
            fail(f"(a) runs {steps_a} steps, phase 20 kept its master after "
                 f"{k['master_at']}")
        layout = t._step_fn.ctx.layout
        initial = [p.float() for p in tfm.init_params(
            cfg, k["seed"], device=self.dev).parameters()]
        gap, update = master_gap(tp.whole_params(layout, state.master),
                                 k["master"], initial)
        del t, state, initial
        gc.collect()
        torch.cuda.empty_cache()
        (f_losses, t, state, _), sec_f = wall(
            lambda: self._stacked_model(spec, "a", fault=True))
        fault, _ = master_gap(tp.whole_params(layout, state.master),
                              k["master"])
        del t, state
        print(f"  (a) the stacked (data 1, model 2) form on {self.dev}, "
              f"{cfg.name} at full width and depth, {T} tokens a step, rule "
              f"{layout.plan.rule!r}: losses {losses}, {rel} from phase 20's "
              f"{want} (limit {TP_LOSS_TOL!r}); master after {steps_a} steps "
              f"{gap / update!r} of phase 20's update from phase 20's "
              f"(2-norms); a planted fault, each row-parallel "
              f"reduce-scatter keeping its own partial: {fault / update!r}, "
              f"losses {f_losses} (limit {TP_MASTER_TOL!r}, between them); "
              f"step walls {walls} s against phase 20's {k['step_wall']!r} "
              f"s; peak {peak_a} B above the phase's start; {sec_a:.1f} s "
              f"and {sec_f:.1f} s with the fault; {card}", flush=True)
        if not gap / update <= TP_MASTER_TOL < fault / update:
            fail(f"(a) master {gap / update} of phase 20's update from phase "
                 f"20's, the planted fault's {fault / update}: the limit "
                 f"{TP_MASTER_TOL} must lie between them")

        # (b), (c), (e), (f): four gloo ranks sharing the card, in phase
        # 22's spawn
        out = self.model_ranks
        gc.collect()
        torch.cuda.empty_cache()
        mark("(a) the stacked form at full depth, the fault")
        stacked = {}
        what = {"b": "tensor-parallel", "c": "tensor-parallel",
                "e": "grad_compression 10, replicated over the model shards",
                "f": "pod_wire u16 across the pods, tensor-parallel inside"}
        for key in spec["order"]:
            run = spec["runs"][key]
            shape = (run.get("pods", 1), run["data"], run["model"])
            ranks = out[:math.prod(shape)]
            (s_losses, t, state, s_walls), s_sec = wall(
                lambda: self._stacked_model(spec, key))
            fps = tp_fps(state, t.errors)
            stacked[key] = (s_losses, fps, s_walls)
            del t, state
            gc.collect()
            torch.cuda.empty_cache()
            for r in ranks:
                got = r[key]
                if got["losses"] != s_losses:
                    fail(f"({key}) rank {r['rank']}: losses {got['losses']}, "
                         f"the stacked form's {s_losses}")
                for mv in fps:
                    if got["fps"][mv][0] != fps[mv][r["rank"]]:
                        fail(f"({key}) rank {r['rank']}: its {mv} differs "
                             f"from the stacked form's shard")
            if run.get("grad_compression"):
                # replicated over "model": the model shards of a data shard
                # hold the same bits
                for a, b in ((0, 1), (2, 3)):
                    if ranks[a][key]["fps"] != ranks[b][key]["fps"]:
                        fail(f"({key}) ranks {a} and {b}, the model shards of "
                             "one data shard, differ")
            print(f"  ({key}) {len(ranks)} gloo ranks sharing {self.dev}, "
                  f"(pod, data, model) {shape}, {what[key]}, {cut} of "
                  f"{cfg.n_layers} layers at full width, {T} tokens a step: "
                  f"each rank's losses, {', '.join(fps)} equal to the "
                  f"stacked form's bit for bit"
                  f"{'; ranks 0 = 1 and 2 = 3 bit for bit' if key == 'e' else ''}"
                  f" (stacked {s_sec:.1f} s, its step walls {s_walls} s); "
                  f"losses {s_losses}; {card}", flush=True)
            for r in ranks:
                g = r[key]
                print(f"  ({key}) rank {r['rank']} ({g['n_par']} parameters "
                      f"held): step walls {g['wall']} s, CUDA events "
                      f"{g['ev']} ms, the exchange's wall {g['xchg_s']} s, "
                      f"bytes it sends per step {g['wire_bytes']}, peak "
                      f"{g['peak_bytes']} B; {card}", flush=True)
            mark(f"({key}) the stacked form and the checks")
        work = max(r["span"][1] for r in out) - min(r["span"][0] for r in out)
        print(f"  (b), (c), (e), (f): in phase 22's spawn of four ranks, after "
              f"phases 22 and 23's runs ({work:.1f} s of its work; the ranks' "
              f"first training steps taken there); the ranks share one card "
              f"and every exchange goes through the host: not a multi-GPU "
              f"figure", flush=True)
        self.meta_counts(spec, out, counts)

        # (d) NCCL with one rank per card
        count = torch.cuda.device_count()
        if count < 2:
            print(f"  (d) did not run: NCCL with one rank per card needs two "
                  f"cards or more, and this machine has {count}", flush=True)
        else:
            spec_d = dict(spec, order=("b",), root=str(root / "d"))
            t_spawn = time.time()
            outd, sec = wall(lambda: spawn_ranks(
                rank_model, 2, backend="nccl", timeout=600, args=(spec_d,)))
            spans = _spans(t_spawn, time.time(), outd)
            s_losses, fps, _ = stacked["b"]
            for r in outd:
                if r["b"]["losses"] != s_losses or \
                        r["b"]["fps"]["master"][0] != fps["master"][r["rank"]]:
                    fail(f"(d) rank {r['rank']}: losses {r['b']['losses']} "
                         f"or master differ from the stacked form's")
            print(f"  (d) NCCL with one rank per card, (1, 2) ({sec:.1f} s: "
                  f"{spans}): losses and master equal to the stacked form's "
                  f"bit for bit; step walls {[r['b']['wall'] for r in outd]}"
                  f" s, exchange {[r['b']['xchg_s'] for r in outd]} s; "
                  f"{card}", flush=True)
        shutil.rmtree(root, ignore_errors=True)
        launches = self.counts()
        if any(launches.values()):
            fail(f"phase 24 launched kernels of this repository: {launches}")
        print(f"  launches in this run: {launches} (no kernel of this "
              f"repository lies on the model-axis path)", flush=True)
        return dict(launches=launches)

    def meta_counts(self, spec: dict, ranks: list,
                    counts: MetaCounts) -> None:
        """Phase 24 (g), (h): the training step counted on one rank of a
        meta process group (``launch.mesh.MetaMesh``; nothing allocated,
        no process made). (g) At (1, 2) and (2, 2), phase 20's batch, runs
        (b) and (c)'s model: its wire bytes by dtype equal, byte for byte,
        what every rank of (b) and (c) sent in each step, and its FLOPs
        the ``FlopCounterMode`` count of one more step of each rank
        (:func:`_flop_step`). (h)
        qwen2-0.5b x train_4k per device on the 16 x 16 and the 2 x 16 x
        16 production meshes (``pod_wire`` u16 across the pods), each
        "ok", with its per-device terms."""
        from repro_torch.launch import dryrun
        from repro_torch.launch import mesh as lm
        from repro_torch.models.config import ShapeConfig

        card = card_line()
        shape = ShapeConfig("phase 20", spec["seq_len"], spec["batch"],
                            "train")
        for key in ("b", "c"):
            run = spec["runs"][key]
            mesh = lm.make_meta_mesh(data=run["data"], model=run["model"])
            (got, _), sec = wall(lambda: dryrun.count_on_mesh(
                _train_cfg(spec, run), shape, mesh))
            want = got["collective_bytes_by_dtype"]
            for r in ranks[:run["data"] * run["model"]]:
                g = r[key]
                if any(dict(w) != want for w in g["wire_bytes"]):
                    fail(f"(g) ({key}) rank {r['rank']} sent "
                         f"{g['wire_bytes']} a step, the meta count {want}")
                if "flop_counter" in g and \
                        g["flop_counter"] != got["cost"]["flops"]:
                    fail(f"(g) ({key}) rank {r['rank']}: FlopCounterMode "
                         f"{g['flop_counter']} FLOPs in a step, the meta "
                         f"count {got['cost']['flops']}")
            counted = [r[key]["flop_step_s"] for r in
                       ranks[:run["data"] * run["model"]]
                       if "flop_step_s" in r[key]]
            flops = (f"equal to FlopCounterMode on one more step of each "
                     f"rank (on a fresh state: the counter moves bits; "
                     f"{[round(t_, 2) for t_ in counted]} s)" if counted
                     else "(held to the ranks at (2, 2))")
            print(f"  (g) ({key}) counted on rank 0 of a {mesh.name} meta "
                  f"process group in {sec:.1f} s: wire bytes a step {want} "
                  f"(by kind {got['collectives']}) equal to what every rank "
                  f"sent in every step, byte for byte; FLOPs "
                  f"{got['cost']['flops']!r} {flops}; parameters "
                  f"{got['param_bytes_per_device']} B and optimizer state "
                  f"{got['opt_state_bytes_per_device']} B a rank", flush=True)
        mark("(g) the meta counts at (1, 2) and (2, 2)")
        recs, done = counts.get(counts.mesh)
        print(f"  (h) counted in a spawned counter started before phase 14, "
              f"done {done:.1f} s after its start", flush=True)
        for (_, shape, name, wire), rec in zip(MESH_CELLS, recs):
            if shape != "train_4k":
                continue
            sec = rec["trace_s"]
            if rec["status"] != "ok":
                fail(f"(h) qwen2-0.5b x train_4k on {name}: {rec['status']} "
                     f"{rec.get('error', '')}\n{rec.get('traceback', '')}")
            r, c = rec["roofline"], rec["cost"]
            print(f"  (h) qwen2-0.5b x train_4k per device of "
                  f"{rec['n_chips']} on the {name} mesh"
                  f"{'' if wire is None else ', pod_wire ' + wire} (meta, "
                  f"its trace {sec:.1f} s): FLOPs {c['flops']!r}, needed bytes "
                  f"{c['needed_bytes']!r}, meta peak "
                  f"{rec['meta_peak_live_bytes']} B, parameters "
                  f"{rec['param_bytes_per_device']} B, optimizer state "
                  f"{rec['opt_state_bytes_per_device']} B; collectives "
                  f"{rec['collectives']}, by dtype "
                  f"{rec['collective_bytes_by_dtype']}; roofline t_compute "
                  f"{r['t_compute_s']!r} s, t_memory {r['t_memory_s']!r} s, "
                  f"t_collective {r['t_collective_s']!r} s (at "
                  f"{dryrun.rl.HW['ici_bw']!r} B/s), dominant "
                  f"{r['dominant']}, roofline_fraction "
                  f"{r['roofline_fraction']!r}; counted on the host of "
                  f"{card}", flush=True)
        mark("(h) qwen2-0.5b x train_4k on the production meshes")

    # -- phase 25: the tensor-parallel prefill and decode ---------------------
    def _serve_spec(self, order=("kv", "qc", "ssm")) -> dict:
        """Phase 25's runs (:data:`SERVE_RUNS`) on phase 20's seed: each
        model's ``SERVE_ROWS`` prompts of ``SERVE_PROMPT`` tokens drawn by
        numpy from it."""
        from repro_torch import configs

        seed = self.keep20["seed"]
        prompts = {}
        for key in order:
            arch = SERVE_RUNS[key][0]
            if arch not in prompts:
                rng = np.random.default_rng(seed)
                prompts[arch] = rng.integers(
                    0, configs.get(arch).vocab,
                    (SERVE_ROWS, SERVE_PROMPT)).astype(np.int32)
        return dict(seed=seed, order=order, prompts=prompts)

    @staticmethod
    def _joined(mesh, plan, per_shard: list) -> torch.Tensor:
        """One step's logits (``[b, 1, V/M]`` per shard) or tokens (``[b,
        1]``) joined: a data shard's vocabulary shards in model order (its
        first model shard's tokens), the data shards' rows in turn."""
        M = mesh.model
        rows = []
        for q in range(mesh.dp_size):
            sh = per_shard[q * M:(q + 1) * M]
            rows.append(torch.cat(sh, -1) if plan.vocab and sh[0].dim() == 3
                        else sh[0])
        return torch.cat(rows, 0)

    def serve_path(self, counts: MetaCounts):
        """The tensor-parallel prefill and decode (``models.
        tensor_parallel``; the runs of :data:`SERVE_RUNS`, one bf16 copy
        drawn from the seed, ``SERVE_ROWS`` prompts of ``SERVE_PROMPT``
        tokens into a cache of ``SERVE_MAX_LEN`` positions, then
        ``SERVE_TICKS`` greedy steps): (a) four gloo ranks sharing the card
        in phase 22's spawn (``self.serve_ranks``), each rank's logits,
        tokens and cache pieces after the prefill and after the last step
        bit-equal to the stacked form run here on the card; (b) the
        stacked form's logits against the one-device ``forward_prefill``
        and ``forward_decode`` on the same parameters and tokens, within
        ``TP_SERVE_TOL`` (Mamba2: ``TP_SERVE_SSM_TOL``); (c) a planted
        fault, one decode step whose row-parallel sums keep each shard's
        own partial
        (:func:`own_partials`), beyond it; (d) the serving cells of
        :data:`MESH_CELLS` counted per device on the production meshes in
        the spawned counters, each "ok". Prints each rank's prefill and
        step walls, the exchange's wall, the bytes it sends by dtype and
        its peak memory. Launches none of K1-K7."""
        from repro_torch.launch import mesh as lm
        from repro_torch.models import tensor_parallel as tp
        from repro_torch.models import transformer as tfm

        card = card_line()
        self.zero_counts()
        spec = self._serve_spec()
        ranks = self.serve_ranks
        for r in ranks:
            if any(r["launches"].values()):
                fail(f"rank {r['rank']} launched kernels of this repository "
                     f"in phase 25: {r['launches']}")
        work = max(r["span"][1] for r in ranks) - min(r["span"][0]
                                                      for r in ranks)
        print(f"  the ranks' runs: {work:.1f} s of phase 22's spawn, after "
              f"phase 24's; the ranks share one card and every exchange "
              f"goes through the host: not a multi-GPU figure", flush=True)
        for key in spec["order"]:
            arch, d, m = SERVE_RUNS[key]
            cfg = _serve_cfg(key)
            gc.collect()
            torch.cuda.empty_cache()
            mesh = lm.make_stacked_mesh(data=d, model=m, device=self.dev)
            st, sec = wall(lambda: serve_steps(mesh, spec, key, keep=True))
            plan = st["ctx"].plan
            # (a) every rank against its stacked shard
            for r in ranks[:d * m]:
                got, s = r[key], r["rank"]
                for what in ("logits", "tokens"):
                    if [x[0] for x in got[what]] != [x[s] for x in st[what]]:
                        fail(f"({key}) rank {s}: its {what} differ from the "
                             "stacked form's shard")
                for what in ("cache_prefill", "cache"):
                    if got[what][0] != st[what][s]:
                        fail(f"({key}) rank {s}: its {what} differs from the "
                             "stacked form's shard")
            mark(f"({key}) the stacked form")
            # (b) the one-device forward on the same parameters and tokens
            params = tfm.init_params(cfg, spec["seed"], device=self.dev,
                                     dtype=cfg.dtype)
            prompts = torch.from_numpy(spec["prompts"][arch]).to(self.dev)
            logits, cache = tfm.forward_prefill(cfg, params,
                                                {"tokens": prompts},
                                                SERVE_MAX_LEN)
            # the real vocabulary's columns (the padded ones hold -1e30)
            V = cfg.vocab
            gaps, agree, first = [], 0, None
            for i, (lg, tk) in enumerate(st["host"]):
                whole = self._joined(mesh, plan, lg)[..., :V]
                toks = self._joined(mesh, plan, tk)
                ref = logits.float().cpu()[..., :V]
                gaps.append(max_abs(whole, ref) / float(ref.abs().max()))
                agree += int(torch.equal(torch.argmax(
                    ref[:, -1], dim=-1).to(torch.int32), toks[:, 0]))
                if i == 1:
                    first = ref
                if i < SERVE_TICKS:
                    logits, cache = tfm.forward_decode(cfg, params,
                                                       toks.to(self.dev),
                                                       cache)
            del params, cache, logits
            # (c) the planted fault: the first step from the prefill's cache
            keep = tp._row_sum
            tp._row_sum = own_partials
            try:
                flg, _ = tp.forward_decode(
                    st["ctx"], st["pieces"],
                    [t.to(self.dev) for t in st["host"][0][1]], st["start"])
            finally:
                tp._row_sum = keep
            fault = max_abs(self._joined(mesh, plan, [x.cpu() for x in flg])
                            [..., :V], first) / float(first.abs().max())
            walls = st["wall"]
            rule = f"rule {plan.rule!r}" if cfg.n_heads else "by head"
            tol = TP_SERVE_SSM_TOL if cfg.family == "ssm" else TP_SERVE_TOL
            print(f"  ({key}) {cfg.name} at full width, {cfg.n_layers} "
                  f"layers, {cfg.dtype}, (data, model) ({d}, {m}), {rule}: "
                  f"{SERVE_ROWS} prompts of {SERVE_PROMPT} "
                  f"tokens, cache {SERVE_MAX_LEN}, {SERVE_TICKS} greedy "
                  f"steps; each rank's logits, tokens and cache pieces equal "
                  f"to the stacked form's bit for bit; the stacked form "
                  f"against the one-device forward on the same tokens: "
                  f"logits within {max(gaps)!r} of the largest (limit "
                  f"{tol!r}; by step {[round(g, 4) for g in gaps]}; greedy "
                  f"tokens agree at {agree} of "
                  f"{SERVE_TICKS + 1} steps); a planted fault, one step "
                  f"whose row-parallel sums keep each shard's own partial: "
                  f"{fault!r}; stacked prefill {walls[0]:.3f} s, a step "
                  f"{statistics.median(walls[1:]):.4f} s (median), run "
                  f"{sec:.1f} s, peak {st['peak_bytes']} B; {card}",
                  flush=True)
            if not max(gaps) <= tol < fault:
                fail(f"({key}) the stacked form's logits {max(gaps)} from "
                     f"the one-device forward's, the planted fault's "
                     f"{fault}: the limit {tol} must lie between")
            for r in ranks[:d * m]:
                g = r[key]
                print(f"  ({key}) rank {r['rank']}: prefill {g['wall'][0]:.3f}"
                      f" s (exchange {g['xchg_s'][0]:.3f} s, sends "
                      f"{g['wire_bytes'][0]}); a step "
                      f"{min(g['wall'][1:]):.4f}-{max(g['wall'][1:]):.4f} s "
                      f"(exchange {min(g['xchg_s'][1:]):.4f}-"
                      f"{max(g['xchg_s'][1:]):.4f} s, sends "
                      f"{g['wire_bytes'][1]}); peak {g['peak_bytes']} B; "
                      f"{card}", flush=True)
            del st, flg
            mark(f"({key}) the one-device forward, the fault")
        # (d) the production meshes, per device
        recs, done = counts.get(counts.mesh)
        print(f"  (d) counted in a spawned counter started before phase 14, "
              f"done {done:.1f} s after its start", flush=True)
        for (arch, shape, name, _), rec in zip(MESH_CELLS, recs):
            if shape == "train_4k":
                continue
            if rec["status"] != "ok":
                fail(f"(d) {arch} x {shape} on {name}: {rec['status']} "
                     f"{rec.get('error', '')}\n{rec.get('traceback', '')}")
            r, c = rec["roofline"], rec["cost"]
            print(f"  (d) {arch} x {shape} per device of {rec['n_chips']} on "
                  f"the {name} mesh (meta, its trace {rec['trace_s']:.1f} "
                  f"s): FLOPs {c['flops']!r}, needed bytes "
                  f"{c['needed_bytes']!r}, meta peak "
                  f"{rec['meta_peak_live_bytes']} B, parameters "
                  f"{rec['param_bytes_per_device']} B, cache "
                  f"{rec['cache_bytes_per_device']} B; collectives "
                  f"{rec['collectives']}, by dtype "
                  f"{rec['collective_bytes_by_dtype']}; roofline t_compute "
                  f"{r['t_compute_s']!r} s, t_memory {r['t_memory_s']!r} s, "
                  f"t_collective {r['t_collective_s']!r} s, dominant "
                  f"{r['dominant']}, roofline_fraction "
                  f"{r['roofline_fraction']!r}; counted on the host of "
                  f"{card}", flush=True)
        mark("(d) the production meshes")
        launches = self.counts()
        k7 = self.k7_ran()
        if any(launches.values()) or k7:
            fail(f"phase 25 launched kernels of this repository: {launches}, "
                 f"K7 {k7}")
        print(f"  launches in this run: {launches}, K7 {k7} (no kernel of "
              f"this repository lies on the prefill and decode)", flush=True)
        return dict(launches=launches)

    def launch_path(self, counts: MetaCounts):
        """The launchers: (c) the STREAM-triad probe on the card, within
        [0.5, 1.05] of the H100's 3.35 TB/s; (a) the decode cells that fit
        the card (:data:`RUN_CELLS`) counted on meta by ``launch.dryrun``
        in ``counts``, each applicable cell "ok" and each skipped one
        skipped as ``cell_applicable`` says; (b) the decode cells among them that fit the card run for
        real, each step's FLOPs counted on the card equal to its meta
        trace's and to ``FlopCounterMode``'s, with its step ms (median of
        ``dryrun.STEP_REPS``), host ms, temporary bytes and measured share
        of the roofline bound; (d) ``launch.analyze`` on mamba2-1.3b x
        decode_32k on the card, its sections summing to the totals and the
        profiler's kernels ranked. Launches none of K1-K6."""
        from repro_torch import configs
        from repro_torch.launch import analyze, dryrun
        from repro_torch.launch import roofline as rl
        from repro_torch.models import SHAPES, cell_applicable

        analyzed = ("mamba2-1.3b", "decode_32k")
        self.zero_counts()
        card = card_line()
        bw = rl.stream_probe_bandwidth(device=self.dev)
        share = bw / rl.HW["hbm_bw"]
        n = rl._probe_elems(self.dev)
        print(f"  (c) STREAM triad over 3 x {n} float32 ({12 * n} B a "
              f"pass): {bw!r} B/s against the constant {rl.HW['hbm_bw']!r}"
              f" ({rl.peak_bandwidth('gpu')['source']}): {share!r}; card "
              f"{card}", flush=True)
        if not 0.5 <= share <= 1.05:
            fail(f"STREAM probe {bw} B/s is {share} of {rl.HW['hbm_bw']}")

        mark("the STREAM probe")

        def cfg_shape(rec):
            return configs.get(rec["arch"]), SHAPES[rec["shape"]]

        t0 = time.perf_counter()
        recs, done = counts.get(counts.cells)
        t_count = time.perf_counter() - t0
        mark("counting on meta")
        print(f"  (a) {len(recs)} cells counted on meta in a spawned counter "
              f"started before phase 14, done {done:.1f} s after its start; "
              f"waited {t_count:.1f} s for them here", flush=True)
        for rec in recs:
            print("  " + dryrun._line(rec).replace("\n", "\n  "),
                  flush=True)
            ok, _ = cell_applicable(*cfg_shape(rec))
            if rec["status"] != ("ok" if ok else "skipped"):
                fail(f"dry run {rec['arch']} x {rec['shape']}: "
                     f"{rec['status']} {rec.get('error', '')}")
        real = []
        for rec in recs:
            cfg, shape = cfg_shape(rec)
            if rec["status"] != "ok" or shape.kind != "decode":
                continue
            t0 = time.perf_counter()
            dryrun.run_counted(rec, device=self.dev, cfg=cfg, shape=shape)
            if rec["status"] != "ok":
                fail(f"real step {rec['arch']} x {rec['shape']}: "
                     f"{rec['error']}\n{rec['traceback']}")
            run = rec["run"]
            tag = f"{rec['arch']} x {rec['shape']}"
            if not run["fits"]:
                fail(f"(b) {tag}: needs {run['need_bytes']} B of "
                     f"{run['free_bytes']} B free: it fits one H100 and "
                     "runs for real here")
            if not run["flops"] == run["flop_counter"] == \
                    rec["cost"]["flops"]:
                fail(f"{tag}: FLOPs on the card {run['flops']}, "
                     f"FlopCounterMode {run['flop_counter']}, meta "
                     f"{rec['cost']['flops']}")
            mem, r = rec["memory_analysis"], rec["roofline"]
            bound = max(r["t_compute_s"], r["t_memory_s"])
            print(f"  (b) {tag} on the card in "
                  f"{time.perf_counter() - t0:.1f} s: FLOPs {run['flops']!r}"
                  f" = meta = FlopCounterMode; unfused bytes "
                  f"{run['bytes']!r} (meta "
                  f"{rec['cost']['counted_unfused_bytes']!r}), needed "
                  f"{rec['cost']['needed_bytes']!r}; step "
                  f"{run['step_ms']!r} ms (CUDA events, median of "
                  f"{run['step_ms_each']!r}), host {run['host_ms']!r} ms"
                  f"{' (host-bound)' if run['host_bound'] else ''}; "
                  f"arguments {mem['argument_size_in_bytes']} B, temp "
                  f"{mem['temp_size_in_bytes']} B (meta peak live "
                  f"{rec['meta_peak_live_bytes']} B); bound {r['dominant']} "
                  f"{bound!r} s (unfused memory "
                  f"{r['t_unfused_memory_s']!r} s): measured share "
                  f"{run['measured_roofline_fraction']!r}; {card}", flush=True)
            real.append(rec)
        mark("real decode steps")
        if not real:
            fail("no dry-run cell fits the card")
        print(f"  (d) analyze {analyzed[0]} x {analyzed[1]} on the card:",
              flush=True)
        cfg, shape = cfg_shape({"arch": analyzed[0], "shape": analyzed[1]})
        out = analyze.analyze_cell(*analyzed, top=8, device=self.dev,
                                   cfg=cfg, shape=shape)
        for key in ("bytes", "flops"):
            if sum(r[key] for r in out[key]) != out["totals"][key]:
                fail(f"analyze: the {key} section does not sum to the total")
        if not out["device_ms"]:
            fail("analyze: the profiler recorded no kernel")
        launches = self.counts()
        if any(launches.values()):
            fail(f"phase 21 launched kernels of this repository: {launches}")
        return dict(launches=launches, recs=recs, real=real, probe=bw,
                    count_s=t_count, analyzed=out["totals"])



def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 12's request vectors and of the "
                    "weights, requests and inputs of phases 14-19 and of "
                    "phase 20's weights and data")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    from repro_torch import configs
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
    phase_s, sub_s = {}, {}
    out = {}

    def phase(num: int, title: str, fn):
        print(f"== {num}. {title}", flush=True)
        t0 = time.perf_counter()
        MARKS.update(t=t0, walls={})
        out[num] = fn()
        phase_s[num] = time.perf_counter() - t0
        subs = ""
        if MARKS["walls"]:
            mark("the rest")
            sub_s[num] = {k: round(v, 1) for k, v in MARKS["walls"].items()}
            subs = f" ({sub_s[num]})"
        print(f"  phase {num}: {phase_s[num]:.1f} s{subs}", flush=True)
        return out[num]

    # graph replays make no Python call: the ledger counts their launches
    with graphs.LEDGER.watch(smoke.raw_counts), \
            graphs.LEDGER.watch(smoke.k7_counts):
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
        phase(13, "distribution on the card, HPCG 104^3 as 4 shards on one "
              "card: dist_fp16 SpMV and SpMM in both exchange modes, "
              "jacobi_pcg_dist and adaptive_pcg_dist through CUDA graphs, "
              "dist_mixed: and dist_auto:, a checkpoint fault",
              lambda: smoke.dist_path(mp, mx, rows["K1"][0]))
        # host work on meta for phases 21 and 24, beside the LM phases:
        # started after the kernel build and the solve phases, whose host
        # walls PERF.md quotes
        counts = MetaCounts()
        atexit.register(counts.close)
        phase(14, "the LM serving path: granite-3-2b at full width and "
              "depth, DecodeEngine with the decode step as one CUDA graph, "
              "8 requests, the PackSELL head through K1 and K3",
              lambda: smoke.lm_path(seed=args.seed))
        # each path ran with the counts set to 0 just before it
        runs = [mp["launches"], mx["launches"], sv, cp["launches"],
                out[10]["launches"], out[11]["launches"], out[12]["launches"],
                out[13]["launches"], out[14]["launches"]]
        # free the earlier phases' matrices, plans and graphs: phases 15-19
        # count their own peak memory
        del mp, mx, cp, sv
        out.clear()
        phase(15, "the moe family: qwen2-moe-a2.7b at full width and depth "
              "in one bf16 copy, DecodeEngine with the decode step as one "
              "CUDA graph, 8 requests, the tick against two byte bounds, "
              "layer 0 against a float64 loop",
              lambda: smoke.moe_path(seed=args.seed))
        phase(16, "the vlm family: llava-next-mistral-7b at full width and "
              "depth in one bf16 copy, a prefill of 4 x (2,880 patches + 8 "
              "tokens), 32 greedy steps as one CUDA graph",
              lambda: smoke.vlm_path(seed=args.seed))
        phase(17, "the ssm family: mamba2-1.3b at full width and depth in "
              "one bf16 copy, DecodeEngine with the decode step as one CUDA "
              "graph, 8 requests, the tick against its byte bound, decode "
              "against prefill after 9 and 1,000 tokens",
              lambda: smoke.ssm_path(seed=args.seed))
        phase(18, "the hybrid family: zamba2-2.7b at full width and depth in "
              "one bf16 copy, the shared attention block after every 6th "
              "Mamba2 layer, DecodeEngine as phase 17",
              lambda: smoke.ssm_path(seed=args.seed,
                                     cfg=configs.get("zamba2-2.7b")))
        runs += [out[k]["launches"] for k in (15, 16, 17, 18)]
        # phase 18's model goes before phase 19 draws its own
        out.clear()
        gc.collect()
        torch.cuda.empty_cache()
        phase(19, "the encdec family: seamless-m4t-large-v2 at full width "
              "and depth in one bf16 copy, a prefill of 4 x (1,500 frames + "
              "8 tokens), 32 greedy steps as one CUDA graph, layer 0's "
              "cross-attention against float64",
              lambda: smoke.encdec_path(seed=args.seed))
        runs.append(out[19]["launches"])
        # phase 19's model goes before phase 20 draws its own
        out.clear()
        gc.collect()
        torch.cuda.empty_cache()
        phase(20, "the training path: qwen2-0.5b at full width and depth, "
              "Trainer with a float32 master and bf16 compute, 12 steps of "
              "8 x 1,024 tokens, a checkpoint every 6, the resume bit for "
              "bit, microbatch and float32 checks",
              lambda: smoke.train_path(seed=args.seed))
        runs.append(out[20]["launches"])
        out.clear()
        gc.collect()
        torch.cuda.empty_cache()
        phase(21, "the launchers: the STREAM probe against the H100's HBM3 "
              "constant; the decode cells that fit the card counted on "
              "meta and run for real, their FLOPs against the meta trace; "
              "analyze on one real cell",
              lambda: smoke.launch_path(counts))
        runs.append(out[21]["launches"])
        out.clear()
        phase(22, "distribution across processes: phase 13's matrix and "
              "phase 5's ladder, one rank per shard from the host dicts "
              "phase 13 built, in one spawn of four gloo ranks sharing the "
              "card that goes on to phases 23 and 24's runs; (a) one NCCL "
              "rank, its solve's graphs capturing the collectives; (b) the "
              "four gloo ranks; (c) NCCL with one rank per card where there "
              "are cards enough", smoke.ranks_path)
        runs.append(out[22]["launches"])
        out.clear()
        phase(23, "the training data axis across processes: qwen2-0.5b at "
              "full width, phase 20's seed and batches; (a) one NCCL rank, "
              "bit-equal to phase 20; (b) two gloo ranks sharing the card at "
              "4 layers: data_axis 2 and a pod-wire u16 mesh, each "
              "bit-equal to its stacked form, a P = 2 checkpoint restored "
              "at P = 1; (c) NCCL with one rank per card where there are "
              "cards enough", smoke.train_ranks_path)
        out.clear()
        phase(24, "the training model axis: qwen2-0.5b at full width, phase "
              "20's seed and batches, tensor-parallel layers; (a) the "
              "stacked (data 1, model 2) form at full depth against phase "
              "20, a planted fault beside it; in phase 22's spawn of four "
              "gloo ranks sharing the card, at 4 layers: (b) (1, 2), (c) "
              "(2, 2), (e) grad_compression 10 at (2, 2), (f) pod_wire u16 "
              "at (2, 1, 2), each bit-equal to its stacked form; (g) the "
              "meta process group's count against (b) and (c)'s bytes and "
              "FLOPs; (h) qwen2-0.5b x train_4k on the 16x16 and 2x16x16 "
              "meshes; (d) NCCL with one rank per card where there are "
              "cards enough", lambda: smoke.model_axis_path(counts))
        runs.append(out[24]["launches"])
        out.clear()
        phase(25, "the tensor-parallel prefill and decode: qwen2-0.5b at "
              "full width and depth at (2, 2) and (1, 4), mamba2-1.3b at "
              "(1, 2), 4 prompts of 512 tokens, 16 greedy steps; (a) in "
              "phase 22's spawn of four gloo ranks sharing the card, each "
              "bit-equal to its stacked form; (b) the stacked form against "
              "the one-device forward, (c) a planted fault beside it; (d) "
              "the serving cells on the 16x16 and 2x16x16 meshes",
              lambda: smoke.serve_path(counts))
        runs.append(out[25]["launches"])

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
        # no Pallas kernel: the reference's per-shard jnp.vdot under psum
        "K7": ("row_dots", src + "row_dots.cu",
               "src/repro/solvers/cg.py:54"),
    }
    rows["K7"] = smoke.k7_row
    counts.close()
    print(f"== 26. done in {time.perf_counter() - t_start:.1f} s (phases "
          f"3-25: {phase_s}; sub-walls {sub_s})", flush=True)
    print(f"card: {card_line()}", flush=True)
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
