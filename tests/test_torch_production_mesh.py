"""repro_torch's compressed steps over a model axis and the production
mesh counted on one rank of a meta process group, on the CPU.

One module-scoped spawn of four gloo ranks (``parallel.launch.spawn_ranks``;
the rank side is ``tests/torch_production_mesh_cases.py``) runs every case
on the world group; the parent runs each in the stacked form (every shard
in one process) with one intra-op thread, as the ranks have, while they
run, and the reference runs in six subprocesses side by side with eight
XLA host devices each, started first so that they overlap the rest (the
full-size dry run too, in a seventh). Reduced configs, seq 32, global
batch 8, 2 steps, from the reference's initial parameters:

* ``grad_compression`` 10 at (data 2, model 2) for dense, moe, ssm and
  hybrid, ``pod_wire`` u16 at (pod 2, data 1, model 2) for dense and moe
  and u8 for dense and ssm (whose split leaves share one u8 scale), and
  the plain tensor-parallel step at (2, 2): every rank's losses, master, m, v and error-feedback buffers equal the stacked
  form's bit for bit; under compression the model shards of one data
  shard end bit-equal to each other;
* the compressed runs against the reference's ``Trainer(grad_compression=
  10)`` and ``make_train_step(pod_wire=)`` on the same (Auto-axes) meshes:
  losses within ``RTOL``, the master within ``test_torch_train``'s rule
  with the wire's ``QUANTISED_FAR_SHARE``;
* under ``grad_compression`` every device's error-feedback buffers
  against the reference's (``ERR_FAR_SHARE``'s rule);
* planted faults: a pod reduction dropped (each pod keeps its own mean)
  fails the reference's rule; a data sum whose error feedback is reset
  fails the bit-equality with the stacked form, the error buffers' rule
  and the master's rule against the reference;
* the meta process group (``launch.mesh.MetaMesh``, rank 0) at (2, 2) and
  (2, 1, 2): its FLOPs and wire bytes by dtype equal what each gloo rank
  counted in each of its steps, exactly; its parameter and state bytes
  and its tally equal every stacked shard's; with the checkpoints' early
  stop off on both sides, its FLOPs equal every stacked shard's (with it
  on, torch's non-reentrant checkpoint stops a layer's recompute after
  the last tensor that layer saved, and in the stacked form that comes
  after the other shards' products: the stacked form recomputes more
  than a rank does);
* per-device dot FLOPs on (2, 2) and (2, 2, 2) meshes against the
  reference's ``hlo_cost`` of its compiled step: equal for dense, within
  ``HLO_RTOL`` where the port's train step differs on purpose;
* the CLIs: ``dryrun --all --both-meshes`` at full size on meta for
  qwen2-0.5b and dbrx-132b x train_4k, no ``not_ported`` cell (every
  prefill, decode and long_500k cell ``ok`` or skipped, reduced; and
  qwen2-0.5b x prefill_32k and x decode_32k ``ok`` at full size on
  16 x 16), ``analyze --multi-pod --pod-compress u16`` on a reduced cell,
  ``launch.train --model-axis 2 --grad-compression 10 --device cpu``;
* a compressed (2, 2) run's checkpoint restored on one device and on a
  (2, 2) mesh bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

import torch_production_mesh_cases as cases
from repro import configs as rconfigs
from repro.models import transformer as rtfm
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticTokenStream
from repro_torch.launch import analyze, dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import op_cost, steps
from repro_torch.launch import train as launch_train
from repro_torch.models import tensor_parallel as tp
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ShapeConfig
from repro_torch.parallel import launch
from repro_torch.train import Trainer
from repro_torch.train import checkpoint as ckpt
from test_torch_train import RTOL, _master_close
from test_torch_train_ranks import QUANTISED_FAR_SHARE

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
TIMEOUT = 300           # the spawn's and the reference's timeout, seconds
#: the learning rates of the 2 steps (warmup 1)
LR_SUM = cases.STEPS * 3e-4
#: the reference's processes: the compressed trainers (two families
#: each), the pod-wire steps (by wire), the compiled steps' FLOPs on each
#: mesh
REF_PARTS = ("comp:dense,moe", "comp:ssm,hybrid", "wire:u16", "wire:u8",
             "hlo:2x2", "hlo:2x2x2")
#: the dry run at full size, in a process of its own beside the fixture's
DRYRUN = ["-m", "repro_torch.launch.dryrun", "--all", "--both-meshes",
          "--arch", "qwen2-0.5b,dbrx-132b", "--shape", "train_4k",
          "--jobs", "2", "--out"]
#: each case's share of master elements past the rule against the
#: reference (``QUANTISED_FAR_SHARE``'s, by exchange)
SHARE = {"comp": QUANTISED_FAR_SHARE["comp"],
         "wire_u16": QUANTISED_FAR_SHARE["wire_u16"],
         "wire_u8": QUANTISED_FAR_SHARE["wire_u8"]}
#: the error-feedback buffers against the reference's: an element is far
#: where it differs by more than ``ERR_REL`` of its leaf's largest |error|
#: there, and at most ``ERR_FAR_SHARE`` of the elements may be (bf16
#: compute moves the gradients by more than E8M10's step, so a sound
#: run's buffers carry rounding noise). Measured over the four devices at
#: (2, 2): sound 0.58, 0.85, 0.10 and 0.19 % (dense, moe, ssm, hybrid); the
#: buffers reset every step 6.5, 2.8, 6.1 and 8.4 %
ERR_REL, ERR_FAR_SHARE = 0.1, 1.5e-2
#: the step the meta counts are held to: one data shard's rows of the
#: cases' global batch
SHAPE = ShapeConfig("x", cases.SEQ, cases.BATCH, "train")
#: per-device dot FLOPs against the reference's ``hlo_cost``: dense is
#: equal, on one device and on both meshes. The moe, ssm and hybrid train
#: steps count more than the reference's already on one device (the
#: reduced configs at seq 32, batch 8: 1.049, 1.060 and 1.010 of it; not
#: located yet, ROADMAP.md queue 1), and on the (2, 2) and (2, 2, 2)
#: meshes 1.020, 1.029 and 1.011 (their layouts differ on purpose too:
#: the experts over the model shards, Mamba2's index sets); the port may
#: count at most this much more
HLO_RTOL = {"dense": 0.0, "moe": 0.05, "ssm": 0.05, "hybrid": 0.05}
#: the cells a production mesh cannot count: none since the
#: tensor-parallel prefill and decode (``models.tensor_parallel``)
NOT_PORTED = set()
#: the cells that slice made countable: every prefill_32k and decode_32k
#: cell and the long_500k cells that apply (the sub-quadratic families)
SERVE_CELLS = {(a, s) for a in configs.ARCH_IDS
               for s in ("prefill_32k", "decode_32k")} | {
    ("zamba2-2.7b", "long_500k"), ("mamba2-1.3b", "long_500k")}
#: qwen2-0.5b's serving cells at full size on 16 x 16, counted in a
#: process of their own beside the fixture's work (the prefill's trace
#: takes about half a minute)
SERVE_FULL = ("import json, sys; from repro_torch.launch import dryrun; "
              "json.dump([dryrun.count_mesh_cell('qwen2-0.5b', s, '16x16') "
              "for s in ('prefill_32k', 'decode_32k')], "
              "open(sys.argv[1], 'w'))")

_REFERENCE = (Path(__file__).resolve().parent
              / "torch_production_mesh_reference.py")


def _stacked_mesh(pods, data, model, tally=False):
    m = tmesh.make_stacked_mesh(data=data, model=model, pods=pods,
                                device="cpu")
    return dataclasses.replace(m, tally={}) if tally else m


def _stacked(name: str, root: Path, inits: dict) -> dict:
    fam, pods, d, m, kw = cases.CASES[name]
    t = Trainer(cases.cfg(fam), cases.opt(),
                cases.tcfg(pods, d, m, str(root / name), **kw),
                mesh=_stacked_mesh(pods, d, m), log_fn=cases.quiet)
    s = t.run(t.initial_state(tfm.load_reference_params(
        cases.cfg(fam), inits[fam], device="cpu")))
    return {"losses": [h["loss"] for h in t.history],
            **cases.state_arrays(s, t.errors), "trainer": t, "state": s}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("production_mesh")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                   "--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1")
        (root / "ref").mkdir()
        procs = {part: subprocess.Popen(
            [sys.executable, str(_REFERENCE), str(root / "ref"), part,
             str(cases.STEPS)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)
            for part in REF_PARTS}
        procs["dryrun"] = subprocess.Popen(
            [sys.executable] + DRYRUN + [str(root / "dryrun.json")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=str(SRC)))
        procs["serve"] = subprocess.Popen(
            [sys.executable, "-c", SERVE_FULL, str(root / "serve.json")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=str(SRC)))
        try:
            inits = {fam: jax.tree.map(np.asarray, rtfm.init_params(
                rconfigs.reduce(rconfigs.get(arch)),
                jax.random.PRNGKey(0))[0])
                for fam, arch in cases.FAMILIES.items()}
            # the stacked forms here while the ranks run
            with ThreadPoolExecutor(1) as pool:
                ranks = pool.submit(
                    launch.spawn_ranks, cases.run_cases, WORLD,
                    backend="gloo", timeout=TIMEOUT,
                    args=({"root": str(root / "ranks"), "init": inits},))
                stacked = {name: _stacked(name, root / "stacked", inits)
                           for name in cases.CASES}
                ranks = ranks.result()
            done = {part: p.communicate(timeout=TIMEOUT)
                    for part, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        torch.set_num_threads(threads)
    ref, ref_meta = {}, {}
    dry = done.pop("dryrun")
    serve = done.pop("serve")
    for part, (stdout, stderr) in done.items():
        assert procs[part].returncode == 0, (part, stderr[-4000:])
        name = part.replace(":", "_").replace(",", "_")
        ref.update(np.load(root / "ref" / f"ref_{name}.npz"))
        ref_meta.update(json.loads(stdout.strip().splitlines()[-1]))
    return {"root": root, "inits": inits, "ranks": ranks,
            "stacked": stacked, "ref": ref, "ref_meta": ref_meta,
            "dryrun": (procs["dryrun"].returncode, *dry),
            "serve": (procs["serve"].returncode, *serve)}


def _same(a, b, what):
    np.testing.assert_array_equal(cases.bits(a), cases.bits(b),
                                  err_msg=str(what))


def _same_state(got: dict, want: dict, r: int, what) -> None:
    """Shard ``r``'s master, m, v and error buffers of ``want`` (the
    stacked form's arrays) against ``got`` (one shard's)."""
    assert len(got["errors"]) == len(want["errors"][r:r + 1]), what
    for key in ("master", "m", "v", "errors"):
        for held, w_ in zip(got[key], want[key][r:r + 1]):
            assert len(held) == len(w_), (what, key)
            for j, w in enumerate(w_):
                _same(held[j], w, (what, key, j))


def _whole_master(t: Trainer, state) -> dict:
    """The reference's whole master leaves of a mesh trainer's state."""
    return {k[2:]: v.detach().numpy() for k, v in t._leaves(state).items()
            if k.startswith("1/")}


# ---------------------------------------------------------------------------
# the rank form against the stacked form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(cases.CASES))
def test_ranks_bit_equal_to_the_stacked_form(run, name):
    want = run["stacked"][name]
    for r in range(WORLD):
        got = run["ranks"][r][name]
        assert got["losses"] == want["losses"], (r, got["losses"])
        _same_state(got, want, r, (name, r))


@pytest.mark.parametrize("name", [n for n in cases.CASES
                                  if n.startswith("comp_")])
def test_compressed_model_shards_stay_bit_equal(run, name):
    """The compressed step is replicated over ``"model"``: the model
    shards of a data shard hold the same master, m, v and error buffers;
    every shard the same master."""
    ranks = run["ranks"]
    for a, b in ((0, 1), (2, 3)):
        for key in ("master", "m", "v", "errors"):
            for x, y in zip(ranks[a][name][key][0], ranks[b][name][key][0]):
                _same(x, y, (name, a, b, key))
    for x, y in zip(ranks[0][name]["master"][0], ranks[2][name]["master"][0]):
        _same(x, y, (name, "master across data shards"))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _errors_close(run, name: str, st: dict) -> None:
    """Every shard's error buffers (whole model, per port parameter) as
    the reference's leaves against its device's at the same (data, model)
    index: :data:`ERR_FAR_SHARE`'s rule."""
    t = st["trainer"]
    names = [n for n, _ in st["state"].master.named_parameters()]
    far = total = 0
    for s, errs in enumerate(st["errors"]):
        by_name = dict(zip(names, errs))
        where = f"{t.mesh.dp_index(s)}{t.mesh.model_index(s)}"
        for path, ns in tfm.reference_leaves(st["state"].master):
            got = np.stack([by_name[n] for n in ns]) \
                if path[0] in tfm._STACKED else by_name[ns[0]]
            want = run["ref"][f"errors_{name}/{where}/{'/'.join(path)}"]
            far += int((np.abs(got - want)
                        > ERR_REL * np.abs(want).max()).sum())
            total += want.size
    assert total and far <= ERR_FAR_SHARE * total, (far, total)


def _close_to_reference(run, name: str, st: dict) -> None:
    """Losses within ``RTOL``, the master within the wire's rule, and
    under ``grad_compression`` the error buffers within theirs."""
    want = {k.split("/", 1)[1]: v for k, v in run["ref"].items()
            if k.startswith(f"master_{name}/")}
    assert want, name
    np.testing.assert_allclose(st["losses"],
                               run["ref_meta"][f"losses_{name}"], rtol=RTOL)
    got = _whole_master(st["trainer"], st["state"])
    assert sorted(got) == sorted(want)
    _master_close(got, want, LR_SUM, SHARE[name.rsplit("_", 1)[0]])
    if name.startswith("comp_"):
        _errors_close(run, name, st)


@pytest.mark.parametrize("name", [n for n in cases.CASES
                                  if not n.startswith("plain")])
def test_compressed_steps_match_the_reference(run, name):
    """``grad_compression = 10`` against the reference's compressed
    ``Trainer`` at (2, 2); ``pod_wire`` against its
    ``make_train_step(pod_wire=)`` on (2, 1, 2)."""
    _close_to_reference(run, name, run["stacked"][name])


def test_dropped_pod_reduction_fails_the_reference(run, tmp_path,
                                                   monkeypatch):
    """Each pod keeping its own mean (the wire reduction dropped) moves
    the master past the rule."""
    monkeypatch.setattr(steps, "compressed_wire_reduce",
                        lambda g, mesh, axis, wire, **kw: list(g))
    st = _stacked("wire_u16_dense", tmp_path, run["inits"])
    with pytest.raises(AssertionError):
        _close_to_reference(run, "wire_u16_dense", st)


@pytest.fixture(scope="module")
def reset_run(run, tmp_path_factory):
    """The stacked comp_dense run with a data sum whose error feedback is
    reset every step (each step's buffers start from zero)."""
    psum = steps.compressed_psum

    def reset(grads, errs, bits, **kw):
        return psum(grads, [[torch.zeros_like(e) for e in es]
                            for es in errs], bits, **kw)

    steps.compressed_psum = reset
    try:
        return _stacked("comp_dense", tmp_path_factory.mktemp("reset"),
                        run["inits"])
    finally:
        steps.compressed_psum = psum


def test_reset_error_feedback_fails_the_stacked_form(run, reset_run):
    """The reset run's error buffers and master differ from the sound
    run's bits."""
    sound = run["stacked"]["comp_dense"]
    for key in ("errors", "master"):
        assert any(not np.array_equal(cases.bits(a), cases.bits(b))
                   for a, b in zip(reset_run[key][0], sound[key][0])), key


def test_reset_error_feedback_fails_the_reference(run, reset_run):
    """The reset run against the reference's compressed ``Trainer``: its
    error buffers fail their rule, and its master the wire's rule."""
    with pytest.raises(AssertionError):
        _errors_close(run, "comp_dense", reset_run)
    want = {k.split("/", 1)[1]: v for k, v in run["ref"].items()
            if k.startswith("master_comp_dense/")}
    with pytest.raises(AssertionError):
        _master_close(_whole_master(reset_run["trainer"],
                                    reset_run["state"]), want, LR_SUM,
                      SHARE["comp"])


# ---------------------------------------------------------------------------
# the meta process group
# ---------------------------------------------------------------------------


def _meta(name: str, early_stop: bool = True):
    fam, pods, d, m, kw = cases.CASES[name]
    mesh = tmesh.make_meta_mesh(data=d, model=m, pods=pods)
    with set_checkpoint_early_stop(early_stop):
        fields, _ = dryrun.count_on_mesh(cases.cfg(fam), SHAPE, mesh, **kw)
    return fields, mesh


def _stacked_step(name: str, inits: dict) -> tuple:
    """One step of case ``name`` in the stacked form with its tally kept,
    counted with the checkpoints' early stop off: (FLOPs per shard, the
    mesh, the state)."""
    fam, pods, d, m, kw = cases.CASES[name]
    mesh = _stacked_mesh(pods, d, m, tally=True)
    step = steps.make_train_step(cases.cfg(fam), cases.opt(),
                                 kw.get("pod_wire"), mesh=mesh,
                                 grad_compression=kw.get("grad_compression"))
    params = tfm.load_reference_params(cases.cfg(fam), inits[fam],
                                       device="cpu")
    state = steps.init_mesh_state(step, params, mesh)
    errs = None if "grad_compression" not in kw else [
        [torch.zeros_like(p) for p in state.master.parameters()]
        for _ in mesh.local]
    batches = SyntheticTokenStream(DataConfig(
        vocab=cases.cfg(fam).vocab, seq_len=cases.SEQ,
        global_batch=cases.BATCH, seed=0)).next_placed_batch(mesh)
    with set_checkpoint_early_stop(False):
        _, cost = op_cost.count(step, state, errs, batches)
    return cost.totals()["flops"] / mesh.size, mesh, state


@pytest.mark.parametrize("name", cases.COUNTED)
def test_meta_count_equals_every_rank(run, name):
    meta, mesh = _meta(name)
    for r in range(WORLD):
        got = run["ranks"][r][name]
        assert got["flops"] == meta["cost"]["flops"], r
        assert got["wire"] == [meta["collective_bytes_by_dtype"]] \
            * cases.STEPS, r
    flops, smesh, state = _stacked_step(name, run["inits"])
    full, full_mesh = _meta(name, early_stop=False)
    assert full["cost"]["flops"] == flops
    for s in smesh.local:
        assert smesh.tally[s] == full_mesh.tally[0], s
    held = state.held_masters()
    for s in smesh.local:
        assert dryrun._tree_bytes(held[s]) == \
            meta["param_bytes_per_device"]
        assert dryrun._tree_bytes((state.m[s], state.v[s])) == \
            meta["opt_state_bytes_per_device"]


@pytest.mark.parametrize("tag", ["2x2", "2x2x2"])
@pytest.mark.parametrize("family", list(cases.FAMILIES))
def test_dot_flops_match_reference_hlo(run, family, tag):
    pods, d, m = {"2x2": (1, 2, 2), "2x2x2": (2, 2, 2)}[tag]
    cfg = cases.cfg(family)
    if cfg.family == "hybrid":
        # hlo_cost counts the lax.cond's shared block at every layer
        # (``test_torch_launch``): the port's with it at every layer
        cfg = dataclasses.replace(cfg, attn_every=1)
    fields, _ = dryrun.count_on_mesh(
        cfg, SHAPE, tmesh.make_meta_mesh(data=d, model=m, pods=pods))
    ref = run["ref_meta"][f"hlo_{family}_{tag}"]
    ours = fields["cost"]["flops"]
    if HLO_RTOL[family] == 0.0:
        assert ours == ref
    else:
        assert ref <= ours <= ref * (1 + HLO_RTOL[family]), ours / ref


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_dryrun_both_meshes_at_full_size(run):
    """``python -m repro_torch.launch.dryrun`` (:data:`DRYRUN`, run beside
    the fixture's work): both cells ``ok`` on both meshes."""
    rc, stdout, stderr = run["dryrun"]
    assert rc == 0, stderr[-4000:]
    assert stdout.count("[ok]") == 4
    recs = json.loads((run["root"] / "dryrun.json").read_text())
    assert [(r["arch"], r["mesh"], r["status"]) for r in recs] == [
        (a, m, "ok") for a in ("qwen2-0.5b", "dbrx-132b")
        for m in ("16x16", "2x16x16")]
    for r in recs:
        n = 256 if r["mesh"] == "16x16" else 512
        assert r["n_chips"] == n
        assert r["roofline"]["t_collective_s"] == \
            r["collective_bytes"] / dryrun.rl.HW["ici_bw"]
        assert r["collective_bytes"] == sum(
            r["collective_bytes_by_dtype"].values()) == sum(
            v["bytes"] for v in r["collectives"].values()) > 0
        # m and v: one device's over the chips, but for the leaves the
        # layout does not split over every chip
        cfg = configs.get(r["arch"])
        one = 8 * sum(p.numel() for p in tfm.abstract_params(cfg)[0]
                      .parameters())
        mesh = tmesh.make_production_mesh(multi_pod=n == 512)
        zl = tp.zero_layout(cfg, mesh, tp.Layout(cfg, mesh.model))
        whole = sum(8 * leaf.slice_numel for leaf in zl
                    if not (leaf.dim is not None and leaf.model_split))
        got = r["opt_state_bytes_per_device"]
        assert one / n <= got <= one / n + whole, (got, one / n, whole)


def test_dryrun_not_ported_cells(run, capsys, tmp_path):
    """No production-mesh cell is ``not_ported``: ``dryrun --all
    --both-meshes --reduce`` over the prefill, decode and long_500k shapes
    exits 0 with no ``[todo]`` line, every record ``ok`` or skipped as
    ``cell_applicable`` says (each of :data:`SERVE_CELLS` ``ok`` on both
    meshes); qwen2-0.5b x prefill_32k and x decode_32k are ``ok`` at full
    size on 16 x 16, on meta."""
    shapes = "prefill_32k,decode_32k,long_500k"
    out = tmp_path / "serve_cells.json"
    assert dryrun.main(["--all", "--both-meshes", "--reduce", "--shape",
                        shapes, "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "[todo]" not in text and "[ERR]" not in text
    assert text.count("[ok]") == 2 * len(SERVE_CELLS)
    recs = json.loads(out.read_text())
    assert len(recs) == 2 * 3 * len(configs.ARCH_IDS)
    assert {r["status"] for r in recs} == {"ok", "skipped"}
    ok = {(r["arch"], r["shape"]) for r in recs if r["status"] == "ok"}
    assert ok == SERVE_CELLS and not ok & NOT_PORTED
    for r in recs:
        if r["status"] == "ok":
            assert r["cache_bytes_per_device"] > 0
            assert r["collective_bytes"] == sum(
                r["collective_bytes_by_dtype"].values()) > 0
    rc, _, stderr = run["serve"]
    assert rc == 0, stderr[-4000:]
    full = json.loads((run["root"] / "serve.json").read_text())
    assert [(r["shape"], r["mesh"], r["status"]) for r in full] == [
        ("prefill_32k", "16x16", "ok"), ("decode_32k", "16x16", "ok")]
    # the decode's K/V: the whole 51,539,607,552 B over the 256 devices
    kv = 2 * 24 * 128 * 32_768 * 2 * 64 * 2
    assert full[1]["cache_bytes_per_device"] == kv // 256 + 8 * 4
    # the one-device records are the dry run's own
    one = dryrun.count_cell("qwen2-0.5b", "decode_32k", cfg=configs.reduce(
        configs.get("qwen2-0.5b")), shape=dryrun.reduced_shape(
        dryrun.SHAPES["decode_32k"]))
    assert one["mesh"] == "1x1" and one["status"] == "ok"
    assert one["collectives"] == {}


def test_analyze_multi_pod_pod_compress(capsys):
    assert analyze.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                         "--multi-pod", "--pod-compress", "u16", "--reduce",
                         "--top", "4"]) == 0
    text = capsys.readouterr().out
    assert "2x16x16 mesh, per device of 512" in text
    assert "--- top 4 by collective wire bytes ---" in text
    cfg = configs.reduce(configs.get("qwen2-0.5b"))
    mesh = tmesh.make_production_mesh(multi_pod=True)
    shape = dataclasses.replace(dryrun.reduced_shape(
        dryrun.SHAPES["train_4k"]), global_batch=mesh.dp_size)
    out = analyze.analyze_cell("qwen2-0.5b", "train_4k", top=4, cfg=cfg,
                               shape=shape, mesh=mesh, pod_wire="u16")
    tot = out["totals"]
    for key in ("bytes", "flops", "wire"):
        want = tot["collective_bytes" if key == "wire" else key]
        assert sum(r[key] for r in out[key]) == want > 0, key
    assert set(tot["collectives"]) == {"all-to-all", "all-gather"}
    assert sum(v["bytes"] for v in tot["collectives"].values()) == \
        tot["collective_bytes"]
    assert "all-to-all           wire=" in text


def test_launch_train_grad_compression_over_a_model_axis(tmp_path, capsys):
    hist = launch_train.main(["--arch", "qwen2-0.5b", "--reduce", "--device",
                              "cpu", "--model-axis", "2",
                              "--grad-compression", "10", "--steps", "2",
                              "--seq-len", "16", "--global-batch", "4",
                              "--ckpt-every", "2", "--ckpt-dir",
                              str(tmp_path)])
    out = capsys.readouterr().out
    assert "2 ranks: gloo, on the CPU" in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert ckpt.CheckpointManager(str(tmp_path)).steps() == [2]


def test_compressed_checkpoint_restores_across_meshes(run, tmp_path):
    """The stacked comp (2, 2) run's checkpoint (whole leaves) restored by
    a one-device trainer (master, m and v equal to the run's whole leaves)
    and by a (2, 2) trainer (each shard's slices equal to the run's)."""
    st = run["stacked"]["comp_dense"]
    t, state = st["trainer"], st["state"]
    leaves = {k: v.detach().numpy() for k, v in t._leaves(state).items()}
    one = Trainer(cases.cfg("dense"), cases.opt(), cases.tcfg(
        1, 1, 1, t.tcfg.ckpt_dir), device="cpu", log_fn=cases.quiet)
    back = {k: v.detach().numpy() for k, v in
            one._leaves(one.init_or_restore()).items()}
    assert sorted(back) == sorted(leaves)
    for k, w in leaves.items():
        _same(back[k], w, k)
    mesh_t = Trainer(cases.cfg("dense"), cases.opt(), cases.tcfg(
        1, 2, 2, t.tcfg.ckpt_dir, grad_compression=10),
        mesh=_stacked_mesh(1, 2, 2), log_fn=cases.quiet)
    got = cases.state_arrays(mesh_t.init_or_restore(), None)
    for key in ("master", "m", "v"):
        for r in range(WORLD):
            for a, b in zip(got[key][r], st[key][r]):
                _same(a, b, (key, r))
