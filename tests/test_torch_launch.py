"""repro_torch's launchers against the reference's, on the CPU.

* ``models.io_spec``'s builders: the keys, shapes and dtypes of the
  reference's ``ShapeDtypeStruct``s, the cache's keys in its order, for
  all ten archs × four shapes; every tensor on meta.
* ``transformer.abstract_params`` / ``param_specs``: the reference's leaf
  shapes and dtypes and its ``PartitionSpec``s as tuples for the ten full
  configs, every tensor on meta, the total within 2 % of
  ``param_count()`` (the reference's own rule).
* ``launch.roofline``: ``model_flops`` equal to the reference's for all
  40 cells; ``roofline_terms``' keys, its arithmetic at the H100's
  constants; ``peak_bandwidth``'s rule and the CPU probe.
* ``launch.op_cost``: each family's reduced prefill, decode and train
  step counted on meta and on the CPU, row for row, and equal to
  ``FlopCounterMode``'s FLOPs; the prefill's and decode's dot FLOPs
  against the reference's ``hlo_cost.aggregate`` over its jitted step's
  compiled HLO: equal (``test_dot_flops_match_reference_hlo`` says why
  the hybrid family's are equal only with the shared block at every
  layer).
* ``launch.dryrun``: ``run_cell`` on every family's reduced cells, run
  for real on the CPU (the FLOPs counted there equal to the meta
  trace's); the skipped cells equal the reference's; the CLI on
  qwen2-0.5b × decode_32k at full size on meta; the multi-pod flags raise.
* ``launch.mesh`` raises past one device; ``launch.analyze``'s sections
  sum to ``aggregate``'s totals, through saved op rows too.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as rconfigs
from repro.launch import hlo_cost as rhc
from repro.launch import roofline as rrl
from repro.launch import steps as rsteps
from repro.models import SHAPES as RSHAPES
from repro.models import cell_applicable as rcell_applicable
from repro.models import io_spec as rio
from repro.models import transformer as rtfm
from repro.models.config import ShapeConfig as RShapeConfig
from repro_torch import configs
from repro_torch.launch import analyze, dryrun, mesh, op_cost
from repro_torch.launch import roofline as rl
from repro_torch.models import SHAPES, io_spec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ShapeConfig

ARCHS = configs.ARCH_IDS
FAMILIES = ("qwen2-0.5b", "qwen2-moe-a2.7b", "llava-next-mistral-7b",
            "mamba2-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2")
KINDS = ("prefill", "decode", "train")
B, S = 2, 64


def _sds(x) -> tuple:
    """(shape, dtype name) of a ShapeDtypeStruct or a tensor."""
    if torch.is_tensor(x):
        assert x.is_meta
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    return tuple(x.shape), str(x.dtype)


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_io_spec_builders_match_reference(arch, shape_name):
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    shape, rshape = SHAPES[shape_name], RSHAPES[shape_name]
    for ours, ref in ((io_spec.train_batch_spec(cfg, shape),
                       rio.train_batch_spec(rcfg, rshape)),
                      (io_spec.prefill_batch_spec(cfg, shape),
                       rio.prefill_batch_spec(rcfg, rshape))):
        assert list(ours) == list(ref)
        assert {k: _sds(v) for k, v in ours.items()} == \
            {k: _sds(v) for k, v in ref.items()}
    (tok, cache), (rtok, rcache) = (io_spec.decode_spec(cfg, shape),
                                    rio.decode_spec(rcfg, rshape))
    assert _sds(tok["tokens"]) == _sds(rtok["tokens"]) == ((
        shape.global_batch, 1), "int32")
    assert list(cache) == list(rcache)
    assert {k: _sds(v) for k, v in cache.items()} == \
        {k: _sds(v) for k, v in rcache.items()}


def _ref_leaves(rcfg) -> dict:
    """path -> (spec tuple, shape, dtype) of the reference's abstract
    parameters."""
    shapes, specs = rtfm.abstract_params(rcfg)
    fs = jax.tree_util.tree_flatten_with_path(shapes)[0]
    fl = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    assert [p for p, _ in fs] == [p for p, _ in fl]
    return {tuple(str(k.key) for k in p): (tuple(s), *_sds(x))
            for (p, x), (_, s) in zip(fs, fl)}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_specs_match_reference(arch):
    cfg = configs.get(arch)
    params, specs = tfm.abstract_params(cfg)
    assert all(p.is_meta for p in params.parameters())
    assert specs == tfm.param_specs(cfg)
    named = dict(params.named_parameters())
    ours = {}
    for path, names in tfm.reference_leaves(params):
        t = named[names[0]]
        lead = (len(names),) if path[0] in ("blocks", "enc_blocks") else ()
        ours[path] = (specs[path], lead + tuple(t.shape),
                      str(t.dtype).replace("torch.", ""))
    ref = _ref_leaves(rconfigs.get(arch))
    assert list(ours) == list(ref) == list(specs)
    assert ours == ref
    total = sum(p.numel() for p in params.parameters())
    assert abs(total - cfg.param_count()) / cfg.param_count() < 0.02


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch, shape_name):
    assert rl.model_flops(configs.get(arch), SHAPES[shape_name]) == \
        rrl.model_flops(rconfigs.get(arch), RSHAPES[shape_name])


def test_roofline_terms_keys_and_h100_constants():
    cost = {"flops": 2.0e15, "bytes accessed": 6.7e12}
    ours = rl.roofline_terms(cost, 0, 1.0e15, 1)
    assert list(ours) == list(rrl.roofline_terms(cost, 0, 1.0e15, 1))
    assert rl.HW["peak_flops_bf16"] == 989e12
    assert rl.HW["hbm_bw"] == 3.35e12
    assert rl.HW["ici_bw"] == 450e9
    assert ours["t_compute_s"] == 2.0e15 / 989e12
    assert ours["t_memory_s"] == 6.7e12 / 3.35e12 == 2.0
    assert ours["t_collective_s"] == 0.0
    assert ours["dominant"] == "compute"
    assert ours["useful_flops_ratio"] == 0.5
    assert ours["roofline_fraction"] == pytest.approx(
        (1.0e15 / 989e12) / (2.0e15 / 989e12))
    mem = rl.roofline_terms({"flops": 1.0, "bytes accessed": 3.35e12},
                            9e11, 1.0, 2)
    assert mem["dominant"] == "collective" and mem["t_collective_s"] == 2.0
    assert mem["model_flops_per_device"] == 0.5


def test_peak_bandwidth_rule():
    gpu = rl.peak_bandwidth("gpu")
    assert gpu["bw_bytes_per_s"] == 3.35e12
    assert "h100" in gpu["source"]
    assert 900e9 not in [v for _, v in rl._PEAK_BW_CONSTANTS.values()]
    assert set(rl._PEAK_BW_CONSTANTS) == {"gpu"}
    cpu = rl.peak_bandwidth("cpu")
    assert cpu["source"] == "stream_probe" and cpu["bw_bytes_per_s"] > 0
    assert rl.stream_probe_bandwidth(1_000_000, 3, device="cpu") > 0


def _cell(arch, kind):
    cfg = configs.reduce(configs.get(arch))
    return cfg, ShapeConfig(f"{kind}_test", S, B, kind)


def _counted(cfg, shape, device):
    step, args, _ = dryrun._lower_cell(cfg, shape, device=device)
    with FlopCounterMode(display=False) as fc:
        _, oc = op_cost.count(step, *args)
    return oc, fc.get_total_flops()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_op_cost_equal_on_meta_and_cpu(arch, kind):
    """The same step counts the same rows (op, call site, count, FLOPs,
    bytes, transcendentals) on meta and on the CPU, and its FLOPs equal
    ``FlopCounterMode``'s on both."""
    cfg, shape = _cell(arch, kind)
    meta, fc_meta = _counted(cfg, shape, "meta")
    cpu, fc_cpu = _counted(cfg, shape, "cpu")
    assert meta.records() == cpu.records()
    tot = meta.totals()
    assert tot["flops"] == fc_meta == fc_cpu > 0
    assert tot["bytes"] > 0 and tot["transcendentals"] > 0
    assert tot["collectives"] == {} and tot["collective_bytes"] == 0.0
    assert set(tot) >= {"flops", "bytes", "transcendentals", "collectives",
                        "collective_bytes"}
    again = op_cost.aggregate(*_lowered(cfg, shape))
    assert {k: v for k, v in tot.items() if k != "peak_live_bytes"} == \
        {k: v for k, v in again.items() if k != "peak_live_bytes"}
    sites = {r["site"] for r in meta.records()}
    assert any(s.startswith("models/") for s in sites)
    assert op_cost.OUTSIDE not in sites
    assert (op_cost.BACKWARD in sites) == (kind == "train")


@pytest.mark.parametrize("device", ("meta", "cpu"))
def test_op_cost_read_bytes_counts_what_an_op_reads(device):
    """``read_bytes`` counts a tensor whose storage an op reads, each
    storage once, and neither a tensor no op touches nor one that is only
    viewed."""
    a = torch.ones(4, 8, device=device)
    b = torch.ones(16, device=device)
    _, oc = op_cost.count(lambda x, y: x.t().sum(), a, b)
    assert op_cost.read_bytes([a, b], oc) == 4 * 8 * 4
    assert op_cost.read_bytes([a, a[:2], b], oc) == 4 * 8 * 4
    _, oc = op_cost.count(lambda x, y: (x.t(), y.view(4, 4)), a, b)
    assert op_cost.read_bytes([a, b], oc) == 0


def _lowered(cfg, shape):
    step, args, _ = dryrun._lower_cell(cfg, shape)
    return (step, *args)


def _ref_dot_flops(arch, kind) -> float:
    """The reference's FLOPs for the reduced cell, lowered as its dry run
    lowers it: with 64-bit types off (this suite turns them on; the
    reference's loop counters are then s64, and ``hlo_cost`` reads trip
    counts from s32 constants only)."""
    with jax.enable_x64(False):
        return _ref_dot_flops_x32(arch, kind)


def _ref_dot_flops_x32(arch, kind) -> float:
    rcfg = rconfigs.reduce(rconfigs.get(arch))
    shape = RShapeConfig("x", S, B, kind)
    params, _ = rtfm.abstract_params(rcfg)
    if kind == "prefill":
        step, _ = rsteps.make_prefill_step(rcfg, S)
        lowered = jax.jit(step).lower(params,
                                      rio.prefill_batch_spec(rcfg, shape))
    else:
        step, _ = rsteps.make_decode_step(rcfg)
        tok, cache = rio.decode_spec(rcfg, shape)
        lowered = jax.jit(step).lower(params, tok["tokens"], cache)
    return rhc.aggregate(lowered.compile().as_text())["flops"]


@pytest.mark.parametrize("kind", ("prefill", "decode"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_dot_flops_match_reference_hlo(arch, kind):
    """The port's FLOPs equal the reference's dot FLOPs from its compiled
    HLO exactly (measured: both run the same products, the flash
    attention's padded chunks included). The hybrid family's shared
    block is a ``lax.cond`` inside the reference's scan over layers, and
    ``hlo_cost`` counts a conditional's branches at every trip: its
    count is the shared block at all ``n_layers`` layers, which the port
    runs at every ``attn_every``-th (0.713 of the reference's count,
    measured on the reduced config). So the hybrid's reference count
    equals the port's with ``attn_every = 1``, exactly."""
    cfg, shape = _cell(arch, kind)
    ref = _ref_dot_flops(arch, kind)
    ours = op_cost.aggregate(*_lowered(cfg, shape))["flops"]
    if cfg.family == "hybrid":
        assert ours < ref
        cfg = dataclasses.replace(cfg, attn_every=1)
        ours = op_cost.aggregate(*_lowered(cfg, shape))["flops"]
    assert ours == ref


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_reduced(arch, shape_name):
    """Every family's reduced cell is ``ok`` (or skipped as the
    reference's), counted on meta and run for real on the CPU, with the
    reference's record keys."""
    cfg = configs.reduce(configs.get(arch))
    shape = dryrun.reduced_shape(SHAPES[shape_name])
    rec = dryrun.run_cell(arch, shape_name, run=True, device="cpu",
                          cfg=cfg, shape=shape)
    ok, why = rcell_applicable(rconfigs.reduce(rconfigs.get(arch)),
                               RSHAPES[shape_name])
    if not ok:
        assert rec == {"arch": arch, "shape": shape_name, "mesh": "1x1",
                       "status": "skipped", "reason": why}
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) >= {"arch", "shape", "mesh", "memory_analysis", "cost",
                        "collectives", "roofline", "status"}
    assert rec["collectives"] == {}
    r = rec["roofline"]
    assert r["model_flops_per_device"] == rl.model_flops(cfg, shape)
    assert r["hlo_flops_per_device"] == rec["cost"]["flops"] > 0
    mem = rec["memory_analysis"]
    assert mem["temp_size_in_bytes"] == dryrun.NOT_MEASURED
    assert "live_bytes_per_device" not in mem
    run = rec["run"]
    assert run["fits"] and run["device"] == "cpu"
    assert run["flops"] == run["flop_counter"] == rec["cost"]["flops"]
    assert run["bytes"] == rec["cost"]["counted_unfused_bytes"]
    assert "step_ms" not in run and run["host_ms"] > 0
    if shape.kind == "prefill":
        assert mem["alias_size_in_bytes"] == 0
    else:
        assert 0 < mem["alias_size_in_bytes"] <= mem["output_size_in_bytes"]
    # the roofline's bytes: the arguments an op reads, once; outputs written
    # once, a decode cache's in-place write not counted again. A decode
    # step reads neither the vision projector nor the audio encoder.
    written = mem["output_size_in_bytes"] - (
        mem["alias_size_in_bytes"] if shape.kind == "decode" else 0)
    unread = mem["argument_size_in_bytes"] + written - \
        rec["cost"]["needed_bytes"]
    assert r["hlo_bytes_per_device"] == rec["cost"]["needed_bytes"]
    if shape.kind == "decode" and cfg.family in ("vlm", "encdec"):
        assert unread > 0
    else:
        assert unread == 0
    assert r["t_memory_s"] == rec["cost"]["needed_bytes"] / rl.HW["hbm_bw"]
    assert r["t_unfused_memory_s"] == \
        rec["cost"]["counted_unfused_bytes"] / rl.HW["hbm_bw"]


@pytest.mark.parametrize("arch", ARCHS)
def test_skipped_cells_equal_reference(arch):
    for name in SHAPES:
        ok, why = rcell_applicable(rconfigs.get(arch), RSHAPES[name])
        if not ok:
            assert dryrun.run_cell(arch, name)["reason"] == why
        else:
            assert configs.get(arch).sub_quadratic or name != "long_500k"


def test_dryrun_cli_full_size_on_meta(tmp_path, capsys):
    """qwen2-0.5b × decode_32k at its full size, counted on meta: the
    bf16 parameters, the 51.5 GB cache written in place, no real run."""
    out = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                      "--out", str(out)])
    assert rc == 0
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and "run" not in rec
    assert "[ok]   qwen2-0.5b × decode_32k × 1x1" in capsys.readouterr().out
    cfg, shape = configs.get("qwen2-0.5b"), SHAPES["decode_32k"]
    params = tfm.Transformer(cfg, dtype=cfg.dtype, device="meta")
    cache_b = sum(t.numel() * t.element_size()
                  for t in io_spec.decode_spec(cfg, shape)[1].values())
    assert cache_b == 51_539_607_552 + 128 * 4      # k, v; len
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == \
        dryrun._tree_bytes(params) + 128 * 4 + cache_b
    assert mem["alias_size_in_bytes"] == cache_b
    assert mem["output_size_in_bytes"] == cache_b + 128 * 4
    # the bound reads the parameters and the cache once
    assert rec["cost"]["needed_bytes"] == \
        rec["roofline"]["hlo_bytes_per_device"] == \
        dryrun._tree_bytes(params) + 128 * 4 + cache_b + 128 * 4
    assert rec["cost"]["counted_unfused_bytes"] > rec["cost"]["needed_bytes"]
    assert rec["roofline"]["model_flops_per_device"] == \
        rrl.model_flops(rconfigs.get("qwen2-0.5b"), RSHAPES["decode_32k"])
    assert rec["roofline"]["dominant"] == "memory"


def test_multi_pod_flags_raise():
    """The production mesh counts every cell, and the train step's flags
    raise elsewhere: ``--pod-compress`` needs ``--multi-pod``, and a
    prefill or decode cell takes no ``pod_wire`` (a ``ValueError``, the
    record an error)."""
    with pytest.raises(ValueError, match="--multi-pod"):
        analyze.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                      "--pod-compress", "u8"])
    with pytest.raises(ValueError, match="pod_wire"):
        analyze.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                      "--multi-pod", "--pod-compress", "u16", "--reduce"])
    rec = dryrun.count_mesh_cell(
        "qwen2-0.5b", "prefill_32k", "2x16x16", pod_wire="u16",
        cfg=configs.reduce(configs.get("qwen2-0.5b")),
        shape=dryrun.reduced_shape(dryrun.SHAPES["prefill_32k"]))
    assert rec["status"] == "error" and "pod_wire" in rec["error"]


def test_mesh_one_device_only():
    m = mesh.make_debug_mesh(device="cpu")
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    assert m.devices == ((torch.device("cpu"),),)
    # more than one data shard runs one rank per shard (a process group)
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh.make_debug_mesh(device="cpu", data=2)
    # so does a model axis: one rank per model shard
    for kw in ({"model": 16}, {"data": 16, "model": 16}):
        with pytest.raises(RuntimeError, match="initialised process group"):
            mesh.make_debug_mesh(device="cpu", **kw)
    # the production mesh is counted on meta: rank 0 of 256 or 512
    for mp, shape in ((False, {"data": 16, "model": 16}),
                      (True, {"pod": 2, "data": 16, "model": 16})):
        m = mesh.make_production_mesh(multi_pod=mp)
        assert m.shape == shape and m.local == [0] and m.lead
        assert m.device == torch.device("meta") and m.tally == {}


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "zamba2-2.7b"))
def test_analyze_sections_sum_to_totals(arch, tmp_path, capsys):
    cfg, shape = _cell(arch, "train")
    saved = tmp_path / "ops.jsonl"
    out = analyze.analyze_cell(arch, "train_4k", top=5, cfg=cfg, shape=shape,
                               save_ops=str(saved))
    tot = op_cost.aggregate(*_lowered(cfg, shape))
    assert out["totals"] == {k: v for k, v in tot.items()
                             if k != "peak_live_bytes"}
    for key in ("bytes", "flops"):
        assert len(out[key]) == 6         # the top 5 and the rest
        assert sum(r[key] for r in out[key]) == tot[key]
        assert sum(r["count"] for r in out[key]) <= tot["ops"]
    assert out["device_ms"] is None
    text = capsys.readouterr().out
    assert "--- top 5 by memory bytes (x count) ---" in text
    assert "collectives: none on one device" in text
    back = analyze.analyze_ops([json.loads(line) for line in
                                saved.read_text().splitlines()], top=5)
    assert back["totals"] == out["totals"]
    assert analyze.main(["--ops", str(saved), "--top", "3"]) == 0
    # one real step on the CPU counts the same rows
    cpu = analyze.analyze_cell(arch, "train_4k", top=5, cfg=cfg, shape=shape,
                               device="cpu")
    assert cpu["records"] == out["records"]


def test_run_cells_in_processes_equal_one_process():
    """``run_cells`` counting in two spawned processes gives the records
    (but the trace walls) of one process, in the cells' order."""
    cells = [("qwen2-0.5b", "decode_32k"), ("yi-6b", "long_500k"),
             ("mamba2-1.3b", "long_500k")]
    seen = []
    one = dryrun.run_cells(cells, reduce=True, each=seen.append)
    two = dryrun.run_cells(cells, jobs=2, reduce=True)
    assert seen == one
    assert [r["status"] for r in two] == ["ok", "skipped", "ok"]
    for r in one + two:
        r.pop("trace_s", None)
    assert one == two


def test_microbatch_counts_the_same_flops():
    """``microbatch`` splits a train cell's batch into slices: the same
    products in two passes, so the same FLOPs in more ops."""
    cfg, shape = _cell("qwen2-0.5b", "train")
    full = dryrun.count_cell("qwen2-0.5b", "train_4k", cfg=cfg, shape=shape)
    sliced = dryrun.count_cell("qwen2-0.5b", "train_4k", microbatch=1,
                               cfg=cfg, shape=shape)
    assert full["status"] == sliced["status"] == "ok"
    assert sliced["cost"]["flops"] == full["cost"]["flops"]
    assert sliced["cost"]["ops"] > full["cost"]["ops"]
