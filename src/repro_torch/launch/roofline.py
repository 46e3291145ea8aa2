"""Roofline terms of a dry-run cell, at one NVIDIA H100's constants.

The port of the reference's ``launch/roofline.py``. Three terms per (arch
× shape), in seconds:

    compute    = counted FLOPs / peak bf16 FLOP/s       (989 TF/s)
    memory     = bytes / HBM bandwidth                   (3.35 TB/s)
    collective = collective bytes / NVLink bandwidth     (450 GB/s)

The FLOPs come from ``launch.op_cost`` (the eager step's aten ops), not
from HLO; the dry run passes the bytes the step needs
(``dryrun.needed_bytes``), not the eager ops' unfused count. The
reference's ``collective_stats`` parses HLO and has no counterpart here:
on one card a step has no collectives, and on the production mesh the
collective bytes are those one rank of ``launch.mesh.MetaMesh`` puts on
the wire.
:func:`model_flops` and :func:`roofline_terms` are copies with the
reference's output keys; ``peak_bandwidth`` keeps its rule (a constant on
the GPU, a measured STREAM-triad probe on the CPU).
"""
from __future__ import annotations

import time

import torch

#: NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, at the full 700 W
#: power limit; a card set below it runs slower under load
HW = {
    # dense bfloat16 tensor-core FLOP/s (no sparsity), H100 SXM at 700 W
    "peak_flops_bf16": 989e12,
    # float32 FLOP/s outside the tensor cores, H100 SXM at 700 W
    "peak_flops_f32": 67e12,
    # HBM3 bytes/s, H100 SXM 80 GB at 700 W
    "hbm_bw": 3.35e12,
    # NVLink 4 bytes/s in one direction, H100 SXM (NVIDIA's data sheet:
    # 900 GB/s per GPU both ways together), under the reference's key. The
    # collective term charges every byte a rank of the production mesh
    # sends at it; 256 cards span many nodes, whose network links are
    # slower, so the term is a lower bound there
    "ici_bw": 450e9,
}

#: the achieved-vs-peak denominator by backend: the H100's HBM3 constant
#: on the GPU; the CPU has no trustworthy nominal figure and is probed
_PEAK_BW_CONSTANTS = {
    "gpu": ("constant:nvidia_h100_sxm_hbm3_700w", HW["hbm_bw"]),
}
_BW_CACHE: dict = {}


def _probe_elems(dev: torch.device) -> int:
    """8,000,000 float32 elements (the reference's) on the CPU; on the card
    each array at least 16 times the L2 cache, so the triad streams from
    HBM (the H100's 50 MB L2 would hold the reference's 32 MB arrays)."""
    if dev.type != "cuda":
        return 8_000_000
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return max(8_000_000, 16 * l2 // 4)


def stream_probe_bandwidth(elems: int | None = None, repeats: int = 7, *,
                           device=None) -> float:
    """STREAM-triad achieved bandwidth (bytes/s) on ``device`` (None: the
    GPU): ``a = b + 0.5·c`` in one kernel (``torch.add(..., alpha=,
    out=)``) over ``elems`` float32 elements (None: :func:`_probe_elems`),
    counting 3 × 4 bytes per element (two streamed reads, one write).
    Each call is timed by CUDA events on the card and by the host clock
    around a finished call on the CPU; the median of ``repeats``, in two
    bursts (a throttle window can swallow one), the faster kept."""
    from .. import _device

    dev = _device.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = _probe_elems(dev) if elems is None else int(elems)
    b = torch.arange(n, dtype=torch.float32, device=dev)
    c = torch.ones(n, dtype=torch.float32, device=dev)
    a = torch.empty_like(b)

    def once() -> float:
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.add(b, c, alpha=0.5, out=a)
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / 1e3
        t0 = time.perf_counter()
        torch.add(b, c, alpha=0.5, out=a)
        return time.perf_counter() - t0

    best = 0.0
    for _ in range(2):
        once()                              # warm / re-warm
        ts = sorted(once() for _ in range(repeats))
        best = max(best, 3 * 4 * n / ts[len(ts) // 2])
    return best


def peak_bandwidth(backend: str | None = None) -> dict:
    """``{backend, bw_bytes_per_s, source}``, the denominator of the
    achieved-vs-peak fraction: the H100's HBM3 constant on ``"gpu"``, a
    measured STREAM probe on the CPU (``"cpu"``). ``backend`` None: "gpu"
    where CUDA is available, else "cpu". Cached per backend."""
    backend = backend or ("gpu" if torch.cuda.is_available() else "cpu")
    ent = _BW_CACHE.get(backend)
    if ent is None:
        if backend in _PEAK_BW_CONSTANTS:
            src, bw = _PEAK_BW_CONSTANTS[backend]
        else:
            src, bw = "stream_probe", stream_probe_bandwidth(device="cpu")
        ent = _BW_CACHE[backend] = {
            "backend": backend, "bw_bytes_per_s": float(bw), "source": src}
    return dict(ent)


def roofline_terms(cost: dict, coll_bytes: int, model_flops_global: float,
                   n_chips: int) -> dict:
    """cost: ``{"flops", "bytes accessed"}`` per device."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / HW["peak_flops_bf16"]
    t_memory = bytes_accessed / HW["hbm_bw"]
    t_coll = coll_bytes / HW["ici_bw"]
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_memory, t_coll)
    useful = model_flops_global / n_chips
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": coll_bytes,
        "model_flops_per_device": useful,
        "useful_flops_ratio": useful / flops if flops else 0.0,
        # fraction of the roofline bound spent doing useful model math
        "roofline_fraction": (useful / HW["peak_flops_bf16"]) / bound
        if bound else 0.0,
    }


def model_flops(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode counts one token/seq.

    N counts *matmul-participating* params: the input-embedding table is a
    gather (0 FLOPs) and is excluded; the LM-head matmul is included. For
    tied embeddings ``param_count`` already counts the table once (and it
    does participate in the head matmul), so no correction applies there.
    """
    n_active = cfg.active_param_count()
    if not cfg.tie_embeddings:
        n_active -= cfg.vocab * cfg.d_model   # input embedding: gather only
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
