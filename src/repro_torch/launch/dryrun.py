"""Dry run of every (arch × shape) cell on one device: count each cell's
step on the meta device, and run it for real where it fits one card.

The port of the reference's ``launch/dryrun.py``. The reference lowers
and compiles each cell's jitted step on a 16 × 16 mesh of placeholder
TPU devices and reads XLA's memory and cost analyses. The port traces
the step of ``launch.steps`` eagerly on meta tensors (no allocation)
under ``launch.op_cost``: FLOPs, the bytes the eager ops move at their
boundaries (``counted_unfused_bytes``) and the peak of the live bytes the
step allocates, counted from shapes; argument, output and alias sizes
from the shapes (the donated state of a train step and the cache of a
decode step are written in place, the reference's ``donate_argnums``).
The roofline terms (``launch.roofline``, one H100's constants) take the
counted FLOPs and the bytes the step needs (:func:`needed_bytes`: each
argument that an op reads, read once; each output written once; a
decode cache's in-place slot not counted), not the unfused count: a
fused step moves fewer bytes than the eager one, and its share of the
bound must grow with it.

With ``--run`` each cell whose arguments plus that peak fit in
``FIT_SHARE`` of the device's free memory also runs for real on the
device (parameters drawn from seed ``SEED`` in one copy of the compute
dtype, a decode cache full to ``S - 1``): one step counted again on the
device (its FLOPs must equal the meta trace's), then ``STEP_REPS``
steps, or as many as start within ``TIMED_S`` seconds (one at least),
each between two CUDA events (``step_ms``, the median) and timed on the
host until the call returns (``host_ms``, the median). Where the
host's call takes at least ``HOST_BOUND_SHARE`` of the interval, the
interval is the host's dispatch, not device work: ``host_bound``. The
temporary bytes come from ``max_memory_allocated``, and the measured
fraction of the roofline bound is the bound over ``step_ms``. A cell
that does not fit records its temporary bytes as "not measured". A cell
that errors is recorded and the run exits 1; no cell falls back from
the device to meta.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape decode_32k [--run] [--device cuda|cpu] [--microbatch N]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 7 \\
        --out dryrun.json [--run]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --reduce --run \\
        --device cpu        # the reduced configs, run on the host

**The production mesh.** ``--multi-pod`` counts the cells on the 2 × 16
× 16 mesh, ``--both-meshes`` on 16 × 16 and 2 × 16 × 16 (the reference's
two meshes), per device: the step of ``launch.steps`` on one rank of
``launch.mesh.make_production_mesh`` (rank 0; for a prefill the last
model shard, :func:`count_mesh_cell`; a ``MetaMesh``: its exchanges
return meta tensors and count the bytes the rank sends), traced on meta
under ``op_cost`` like a one-device cell, with nothing allocated and no
process made. A ``train_4k`` cell runs the tensor-parallel step (ZeRO
over data × model, the plain rank-order sum across the pods;
``count_mesh_cell(pod_wire=)`` and ``analyze --pod-compress`` count the
integer wire there). Its record holds the mesh, the per-device
FLOPs, needed bytes and meta peak, the parameter bytes (the rank's master
pieces) and optimizer-state bytes (its m and v slices), the collective
bytes by kind (and by axis and dtype), and the roofline terms at
``n_chips`` = 256 or 512, the collective term the wire bytes over
``roofline.HW["ici_bw"]``. A prefill or decode cell runs the
tensor-parallel prefill or decode step (``models.tensor_parallel``: one
rank per model shard, the KV cache over the model shards), on its data
shard's rows, or on the whole batch where the data axes do not divide it
(long_500k's one row: the reference's ``sanitize_spec``); its record holds
the rank's pieces in the compute dtype as its parameter bytes and its
cache's bytes (``cache_bytes_per_device``: the cache a decode step is
given, donated and written in place, or the one a prefill returns).
Every cell is counted: ``--all --both-meshes`` gives 64 ``ok`` and 16
skipped records. ``--arch`` and ``--shape`` (comma-separated) narrow
``--all``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --arch qwen2-0.5b --shape train_4k,prefill_32k,decode_32k
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import time
import traceback

import torch

from .. import _device, configs
from ..models import SHAPES, cell_applicable, io_spec
from ..models import transformer as tfm
from ..models.config import ShapeConfig
from ..optim import OptConfig, init_state
from . import op_cost
from . import roofline as rl
from .mesh import make_debug_mesh, make_production_mesh, tally_bytes
from .steps import (init_mesh_state, make_decode_step, make_prefill_step,
                    make_train_step)

#: the share of the device's free memory a cell may take to run for real
FIT_SHARE = 0.9
NOT_MEASURED = "not measured"
#: the seed of a real run's parameters and inputs (a step's FLOPs, bytes
#: and time do not depend on the values)
SEED = 0
#: timed steps of a real run, after the counted one; no step starts after
#: ``TIMED_S`` seconds of them (a long step is timed once)
STEP_REPS = 3
TIMED_S = 20.0
#: a real step whose host call takes this share of its CUDA-event interval
#: is host-bound: the interval measures dispatch
HOST_BOUND_SHARE = 0.9
#: the one-device mesh and the production meshes, by name
ONE_DEVICE = "1x1"
PRODUCTION_MESHES = ("16x16", "2x16x16")


def _tensors(tree):
    """The tensors in ``tree`` (tensors, modules, dataclasses such as
    ``TrainState``, dicts, lists and tuples of them)."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _tree_bytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (:func:`_tensors`)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _abstract_state(cfg):
    """The train state on meta: three float32 ``Transformer``s (master, m,
    v) and the step."""
    return init_state(tfm.abstract_params(cfg)[0])


def _fill(spec: dict, cfg, gen) -> dict:
    """Tensors of ``spec``'s shapes and dtypes on ``gen``'s device: token
    ids and labels uniform over the vocabulary, a mask of ones, stub
    embeddings standard normal."""
    out = {}
    for k, v in spec.items():
        kw = dict(device=gen.device)
        if v.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                   dtype=torch.int32, **kw)
        elif k == "mask":
            out[k] = torch.ones(v.shape, dtype=v.dtype, **kw)
        else:
            out[k] = torch.randn(v.shape, generator=gen, **kw).to(v.dtype)
    return out


def _lower_cell(cfg, shape, microbatch=None, *, device="meta"):
    """``(step, args, donated)`` for one (arch, shape): the step of
    ``launch.steps``, its arguments, and the argument it writes in place
    (None for prefill). On meta the arguments are abstract; on another
    device they are drawn from ``SEED`` (the parameters in one copy of
    the compute dtype for prefill and decode, a float32 train state for
    train, a decode cache with ``len`` at ``S - 1``)."""
    dev = torch.device(device)
    meta = dev.type == "meta"
    gen = None
    if not meta:
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 1)
    S = shape.seq_len
    if shape.kind == "train":
        step = make_train_step(cfg, OptConfig(), microbatch=microbatch)
        state = _abstract_state(cfg) if meta else init_state(
            tfm.init_params(cfg, SEED, device=dev))
        batch = io_spec.train_batch_spec(cfg, shape)
        return step, (state, batch if meta else _fill(batch, cfg, gen)), \
            state
    params = (tfm.Transformer(cfg, dtype=cfg.dtype, device=dev) if meta else
              tfm.init_params(cfg, SEED, device=dev, dtype=cfg.dtype))
    if shape.kind == "prefill":
        batch = io_spec.prefill_batch_spec(cfg, shape)
        return make_prefill_step(cfg, S), \
            (params, batch if meta else _fill(batch, cfg, gen)), None
    tok, cache = io_spec.decode_spec(cfg, shape, device=dev)
    if not meta:
        tok = _fill(tok, cfg, gen)
        _full_context(cache, S)
    return make_decode_step(cfg), (params, tok["tokens"], cache), cache


def _full_context(cache: dict, S: int) -> None:
    """A decode cache's ``len`` at ``S - 1``: the step attends to a full
    context and writes the last position."""
    if "len" in cache:
        cache["len"].fill_(S - 1)


def _mesh_name() -> str:
    """The mesh a cell runs on: the one-device ``("data", "model")``
    mesh, ``"1x1"``."""
    return "x".join(str(n) for n in
                    make_debug_mesh(device="meta").shape.values())


def _shard_batch(spec: dict, rows: int) -> dict:
    """``spec``'s meta tensors cut to ``rows`` rows: one shard's batch."""
    return {k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device="meta") for k, v in spec.items()}


def _train_on_mesh(cfg, shape, mesh, *, pod_wire, microbatch,
                   grad_compression) -> tuple:
    """``(step, args, donated, held)`` of a train cell on ``mesh``: the
    ZeRO step, its state (donated) and one data shard's batch; ``held``:
    the rank's parameter and optimizer-state trees."""
    P = mesh.dp_size
    if shape.global_batch % P:
        raise ValueError(f"global batch {shape.global_batch} over {P} "
                         "data-parallel shards")
    step = make_train_step(cfg, OptConfig(), pod_wire,
                           None if microbatch is None else microbatch // P,
                           mesh=mesh, grad_compression=grad_compression)
    params = tfm.abstract_params(cfg)[0]
    state = init_mesh_state(step, params, mesh)
    errs = None if grad_compression is None else [
        [torch.zeros_like(p) for p in state.master.parameters()]]
    batch = _shard_batch(io_spec.train_batch_spec(cfg, shape),
                         shape.global_batch // P)
    return step, (state, errs, [batch]), state, {
        "param_bytes_per_device": _tree_bytes(state.master),
        "opt_state_bytes_per_device": _tree_bytes((state.m, state.v))}


def _serve_on_mesh(cfg, shape, mesh) -> tuple:
    """``(step, args, donated, held)`` of a prefill or decode cell on
    ``mesh``: the tensor-parallel step of ``launch.steps``, the rank's
    pieces in the compute dtype, its data shard's rows (the whole batch
    on every data shard where the data axes do not divide it: the
    reference's ``sanitize_spec``) and, for decode, its cache (donated,
    written in place)."""
    from ..models import tensor_parallel as tp

    P, B, S = mesh.dp_size, shape.global_batch, shape.seq_len
    rows = B // P if B % P == 0 else B
    step = (make_prefill_step(cfg, S, mesh=mesh) if shape.kind == "prefill"
            else make_decode_step(cfg, mesh=mesh))
    ctx = step.ctx
    params = tfm.Transformer(cfg, dtype=cfg.dtype, device="meta")
    pieces = tp.serve_pieces(ctx.layout, params, ctx.ranks)
    if shape.kind == "prefill":
        batch = _shard_batch(io_spec.prefill_batch_spec(cfg, shape), rows)
        args, donated = (pieces, [batch]), None
    else:
        caches = tp.init_caches(ctx, rows, S,
                                io_spec.frontend_lens(cfg, S)[0]
                                if cfg.family == "encdec" else 0)
        tokens = torch.empty((rows, 1), dtype=torch.int32, device="meta")
        args, donated = (pieces, [tokens], caches), caches
    return step, args, donated, {"param_bytes_per_device": _tree_bytes(
        pieces)}


def count_on_mesh(cfg, shape, mesh, *, pod_wire=None, microbatch=None,
                  grad_compression=None):
    """Trace one step of ``cfg`` at ``shape`` (train, prefill or decode) on
    the meta mesh ``mesh`` (``launch.mesh.MetaMesh``, rank ``mesh.index``)
    under ``op_cost``; returns ``(fields, cost)``: the per-device counts of
    the module docstring and the trace's ``OpCost``. ``pod_wire``,
    ``microbatch`` and ``grad_compression`` are the train step's."""
    t0 = time.time()
    if shape.kind == "train":
        step, args, donated, held = _train_on_mesh(
            cfg, shape, mesh, pod_wire=pod_wire, microbatch=microbatch,
            grad_compression=grad_compression)
    else:
        if pod_wire is not None or microbatch is not None or \
                grad_compression is not None:
            raise ValueError(f"a {shape.kind} step has no pod_wire, "
                             "microbatch or grad_compression")
        step, args, donated, held = _serve_on_mesh(cfg, shape, mesh)
    out, cost = op_cost.count(step, *args)
    mem = _mem_dict(_tree_bytes(args), _tree_bytes(out), _tree_bytes(donated),
                    NOT_MEASURED)
    agg = cost.totals()
    by_kind = {}
    for (kind, _, _), (nbytes, n) in mesh.tally.get(mesh.index,
                                                    {}).items():
        row = by_kind.setdefault(kind, {"bytes": 0, "count": 0})
        row["bytes"] += nbytes
        row["count"] += n
    fields = {
        "trace_s": round(time.time() - t0, 1), "memory_analysis": mem,
        "meta_peak_live_bytes": int(cost.peak_live_bytes),
        "n_chips": mesh.size, **held,
        "cost": {"flops": agg["flops"], "counted_unfused_bytes":
                 agg["bytes"], "needed_bytes": needed_bytes(
                     op_cost.read_bytes(_tensors(args), cost), mem,
                     shape.kind),
                 "transcendentals": agg["transcendentals"],
                 "ops": agg["ops"]},
        "collectives": by_kind,
        "collective_bytes_by_dtype": tally_bytes(mesh, mesh.index),
        "collective_bytes_by_axis": tally_bytes(mesh, mesh.index, "axis"),
        "collective_bytes": sum(v["bytes"] for v in by_kind.values())}
    if shape.kind != "train":
        # the cache a decode step is given, or the one a prefill returns
        fields["cache_bytes_per_device"] = _tree_bytes(
            donated if shape.kind == "decode" else out[1])
    return fields, cost


def compile_cell(arch: str, shape_name: str, microbatch=None, *, cfg=None,
                 shape=None):
    """Trace one cell's step on meta under ``op_cost``; returns ``(rec,
    cost)``, ``cost`` the ``op_cost.OpCost`` of the trace, ``rec`` with
    the memory analysis and ``rec["cost"]``. Raises on error (the sweep
    wrapper :func:`count_cell` catches and records)."""
    cfg = cfg or configs.get(arch)
    shape = shape or SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name()}
    t0 = time.time()
    step, args, donated = _lower_cell(cfg, shape, microbatch)
    out, cost = op_cost.count(step, *args)
    rec["trace_s"] = round(time.time() - t0, 1)
    mem = rec["memory_analysis"] = _mem_dict(
        _tree_bytes(args), _tree_bytes(out), _tree_bytes(donated),
        NOT_MEASURED)
    rec["meta_peak_live_bytes"] = int(cost.peak_live_bytes)
    agg = cost.totals()
    rec["cost"] = {
        "flops": agg["flops"], "counted_unfused_bytes": agg["bytes"],
        "needed_bytes": needed_bytes(
            op_cost.read_bytes(_tensors(args), cost), mem, shape.kind),
        "transcendentals": agg["transcendentals"], "ops": agg["ops"]}
    return rec, cost


def _free_bytes(dev: torch.device) -> int:
    """Free memory on ``dev``, after handing the allocator's cached blocks
    back (an earlier cell's)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        return int(torch.cuda.mem_get_info(dev)[0])
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _run(cfg, shape, rec: dict, device, microbatch) -> dict:
    """The cell's real steps on ``device`` if it fits (module docstring);
    updates ``rec["memory_analysis"]`` with the temporary bytes measured
    on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = _device.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mem = rec["memory_analysis"]
    need = mem["argument_size_in_bytes"] + rec["meta_peak_live_bytes"]
    free = _free_bytes(dev)
    run = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else dev.type),
           "need_bytes": int(need), "free_bytes": int(free),
           "fits": bool(need <= FIT_SHARE * free)}
    if not run["fits"]:
        return run
    step, args, donated = _lower_cell(cfg, shape, microbatch, device=dev)
    # the FLOPs again, counted on the device, and FlopCounterMode's total
    with FlopCounterMode(display=False) as fc:
        out, cost = op_cost.count(step, *args)
    del out
    meta_flops = rec["cost"]["flops"]
    got = cost.totals()
    if got["flops"] != meta_flops:
        raise RuntimeError(f"the step counts {got['flops']} FLOPs on "
                           f"{dev}, {meta_flops} on meta")
    run.update(flops=got["flops"], bytes=got["bytes"],
               flop_counter=int(fc.get_total_flops()))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    step_ms, host_ms = [], []
    t_end = time.perf_counter() + TIMED_S
    while len(host_ms) < STEP_REPS and (
            not host_ms or time.perf_counter() < t_end):
        if shape.kind == "decode":
            _full_context(args[2], shape.seq_len)
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = step(*args)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            stop.record()
            torch.cuda.synchronize(dev)
            step_ms.append(start.elapsed_time(stop))
        del out
    run["host_ms"] = statistics.median(host_ms)
    if cuda:
        ms = statistics.median(step_ms)
        peak = torch.cuda.max_memory_allocated(dev) - before
        temp = peak - (mem["output_size_in_bytes"]
                       - mem["alias_size_in_bytes"])
        rec["memory_analysis"] = _mem_dict(
            mem["argument_size_in_bytes"], mem["output_size_in_bytes"],
            mem["alias_size_in_bytes"], int(temp))
        bound = max(rec["roofline"]["t_compute_s"],
                    rec["roofline"]["t_memory_s"])
        run.update(step_ms=ms, step_ms_each=step_ms,
                   host_bound=run["host_ms"] >= HOST_BOUND_SHARE * ms,
                   peak_above_args_bytes=int(peak),
                   measured_roofline_fraction=bound / (ms / 1e3))
    del args, donated
    return run


def _error(rec: dict, e: Exception) -> dict:
    rec["status"] = "error"
    rec["error"] = f"{type(e).__name__}: {e}"
    rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def count_mesh_cell(arch: str, shape_name: str, mesh_name: str, *,
                    pod_wire=None, microbatch=None, cfg=None,
                    shape=None) -> dict:
    """One cell's record on a production mesh (``mesh_name`` in
    :data:`PRODUCTION_MESHES`): "skipped" as ``cell_applicable`` says,
    else "ok" or "error" (module docstring). A prefill is counted on the
    last model shard of the first data shard: under the query-row rule
    its causal attention grows with the model index, and the last
    shard's is the most."""
    cfg = cfg or configs.get(arch)
    shape = shape or SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        mesh = make_production_mesh(multi_pod=mesh_name == "2x16x16")
        if shape.kind == "prefill":
            mesh = dataclasses.replace(mesh, index=mesh.model - 1, tally={})
        fields, _ = count_on_mesh(cfg, shape, mesh, pod_wire=pod_wire,
                                  microbatch=microbatch)
        rec.update(fields)
        if pod_wire is not None:
            rec["pod_wire"] = pod_wire
        rec["roofline"] = rl.roofline_terms(
            {"flops": rec["cost"]["flops"],
             "bytes accessed": rec["cost"]["needed_bytes"]},
            rec["collective_bytes"], rl.model_flops(cfg, shape), mesh.size)
        rec["roofline"]["t_unfused_memory_s"] = \
            rec["cost"]["counted_unfused_bytes"] / rl.HW["hbm_bw"]
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        _error(rec, e)
    return rec


def count_cell(arch: str, shape_name: str, *, microbatch=None, cfg=None,
               shape=None, mesh: str = ONE_DEVICE) -> dict:
    """One cell's record, counted on meta: ``status`` "skipped"
    (``cell_applicable``), "ok" or "error" (with the error and its
    traceback). ``cfg`` / ``shape`` replace the arch's config and the
    named shape (reduced cells). ``mesh``: a production mesh's name
    counts per device there (:func:`count_mesh_cell`)."""
    if mesh != ONE_DEVICE:
        return count_mesh_cell(arch, shape_name, mesh, microbatch=microbatch,
                               cfg=cfg, shape=shape)
    cfg = cfg or configs.get(arch)
    shape = shape or SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name()}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        rec, cost = compile_cell(arch, shape_name, microbatch=microbatch,
                                 cfg=cfg, shape=shape)
        agg = cost.totals()
        rec["collectives"] = {k: v for k, v in agg["collectives"].items()
                              if v["count"]}
        rec["roofline"] = rl.roofline_terms(
            {"flops": agg["flops"],
             "bytes accessed": rec["cost"]["needed_bytes"]},
            agg["collective_bytes"], rl.model_flops(cfg, shape), 1)
        rec["roofline"]["t_unfused_memory_s"] = agg["bytes"] / rl.HW["hbm_bw"]
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        _error(rec, e)
    return rec


def run_counted(rec: dict, *, device=None, microbatch=None, cfg=None,
                shape=None) -> dict:
    """``rec`` (an "ok" record of :func:`count_cell`) with its real steps
    on ``device`` (None: the GPU) under ``rec["run"]`` if the cell fits;
    a step that fails (an allocation too) makes the record an error."""
    cfg = cfg or configs.get(rec["arch"])
    shape = shape or SHAPES[rec["shape"]]
    try:
        rec["run"] = _run(cfg, shape, rec, device, microbatch)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        _error(rec, e)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             run: bool = False, device=None, microbatch=None, cfg=None,
             shape=None) -> dict:
    """:func:`count_cell` (``multi_pod``: per device on the 2 × 16 × 16
    mesh), then with ``run``
    :func:`run_counted` (one device only)."""
    if multi_pod:
        return count_cell(arch, shape_name, microbatch=microbatch, cfg=cfg,
                          shape=shape, mesh="2x16x16")
    rec = count_cell(arch, shape_name, microbatch=microbatch, cfg=cfg,
                     shape=shape)
    if run and rec["status"] == "ok":
        run_counted(rec, device=device, microbatch=microbatch, cfg=cfg,
                    shape=shape)
    return rec


def _count_star(job) -> dict:
    return count_cell(*job[:2], **job[2])


def run_cells(cells, *, jobs: int = 1, run: bool = False, device=None,
              microbatch=None, reduce: bool = False, each=None,
              meshes=(ONE_DEVICE,)):
    """The records of ``cells`` (``(arch, shape name)`` pairs) on each of
    ``meshes`` in turn, in order: counted on meta in ``jobs`` processes
    (spawned; meta tracing is host work, one core a cell), then with
    ``run`` each "ok" one-device cell run in this process on ``device``.
    ``reduce``: the reduced configs at :func:`reduced_shape`. ``each(rec)``
    sees every record as it is done."""
    work = []
    for a, s in cells:
        for m in meshes:
            kw = {"microbatch": microbatch}
            if m != ONE_DEVICE:
                kw["mesh"] = m
            if reduce:
                kw.update(cfg=configs.reduce(configs.get(a)),
                          shape=reduced_shape(SHAPES[s]))
            work.append((a, s, kw))
    if jobs > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(jobs, len(work))) as pool:
            recs = pool.map(_count_star, work, chunksize=1)
    else:
        recs = [_count_star(job) for job in work]
    for rec, (_, _, kw) in zip(recs, work):
        if run and rec["status"] == "ok" and rec["mesh"] == ONE_DEVICE:
            run_counted(rec, device=device, **kw)
        if each is not None:
            each(rec)
    return recs


def needed_bytes(read: int, mem: dict, kind: str) -> int:
    """The bytes a step must move: ``read``, the bytes of the arguments
    that some op of its trace reads (a decode step reads no encoder
    weight), each once, and every output written once. A decode step
    writes one position of its cache in place, so the aliased cache is
    read and not counted again as written (a lower bound by that slot); a
    train step rewrites its whole donated state, which counts as
    written."""
    out = mem["output_size_in_bytes"]
    if kind == "decode":
        out -= mem["alias_size_in_bytes"]
    return int(read + out)


def _mem_dict(arg: int, out: int, alias: int, temp) -> dict:
    """The reference's memory-analysis keys; ``live_bytes_per_device``
    only where the temporary bytes were measured."""
    mem = {"argument_size_in_bytes": int(arg),
           "output_size_in_bytes": int(out),
           "alias_size_in_bytes": int(alias),
           "temp_size_in_bytes": temp}
    if temp != NOT_MEASURED:
        mem["live_bytes_per_device"] = int(arg + temp + out - alias)
    return mem


def reduced_shape(shape: ShapeConfig) -> ShapeConfig:
    """A cell's shape cut for the reduced configs: at most 64 tokens and
    2 sequences, its name and kind kept."""
    return dataclasses.replace(shape, seq_len=min(shape.seq_len, 64),
                               global_batch=min(shape.global_batch, 2))


def _line(rec: dict) -> str:
    tag = f"{rec['arch']} × {rec['shape']} × {rec['mesh']}"
    if rec["status"] == "skipped":
        return f"[skip] {tag}: {rec['reason']}"
    if rec["status"] != "ok":
        return f"[ERR]  {tag}: {rec['error']}"
    r = rec["roofline"]
    s = (f"[ok]   {tag}: trace {rec['trace_s']}s, "
         f"dominant={r['dominant']}, "
         f"t=(C {r['t_compute_s']:.2e}, M {r['t_memory_s']:.2e}, "
         f"X {r['t_collective_s']:.2e})s, "
         f"unfused M {r['t_unfused_memory_s']:.2e}s, "
         f"roofline_frac={r['roofline_fraction']:.3f}\n"
         f"       memory: {rec['memory_analysis']}, meta peak "
         f"{rec['meta_peak_live_bytes']}")
    if rec["mesh"] != ONE_DEVICE:
        held = (f"optimizer state {rec['opt_state_bytes_per_device']} B"
                if "opt_state_bytes_per_device" in rec else
                f"cache {rec['cache_bytes_per_device']} B")
        s += (f"\n       per device of {rec['n_chips']}: parameters "
              f"{rec['param_bytes_per_device']} B, {held}; collectives "
              f"{rec['collectives']}, by dtype "
              f"{rec['collective_bytes_by_dtype']}")
    run = rec.get("run")
    if run:
        s += f"\n       run: {run}"
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--run", action="store_true",
                    help="run each cell that fits for real")
    ap.add_argument("--device", default=None,
                    help="where --run runs (default: the GPU)")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--reduce", action="store_true",
                    help="the reduced configs at reduced_shape")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes that count the cells on meta")
    args = ap.parse_args(argv)
    meshes = ((ONE_DEVICE,) if not (args.multi_pod or args.both_meshes)
              else PRODUCTION_MESHES if args.both_meshes
              else PRODUCTION_MESHES[1:])
    if args.all:
        archs = (args.arch.split(",") if args.arch
                 else list(configs.ARCH_IDS))
        shapes = args.shape.split(",") if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]
    else:
        cells = [(args.arch, args.shape)]
    results = run_cells(cells, jobs=args.jobs, run=args.run,
                        device=args.device, microbatch=args.microbatch,
                        reduce=args.reduce, meshes=meshes,
                        each=lambda rec: print(_line(rec), flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_err = sum(r["status"] == "error" for r in results)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
