"""repro_torch's model axis: tensor-parallel training over ``"model"``, one
rank per shard, on the CPU under gloo.

One module-scoped spawn of four ranks (``parallel.launch.spawn_ranks``;
the rank side is ``tests/torch_model_axis_cases.py``) runs every trainer
case at (data, model) = (1, 2) on a subgroup of two ranks and at (2, 2)
and (1, 4) on the world group; the parent runs each case in the stacked
form (``launch.mesh.make_stacked_mesh``: every shard in one process) with
one intra-op thread, as the ranks have, and the reference runs in four
subprocesses side by side, each with four XLA host devices, started first
so that they overlap the rest. Reduced configs, seq 32, global batch 8, 2
steps, from the reference's initial parameters:

* every rank's losses, master pieces, m and v equal the stacked form's bit
  for bit: dense (qwen2-0.5b), moe (qwen2-moe-a2.7b), ssm (mamba2-1.3b)
  and hybrid (zamba2-2.7b) at (1, 2), (2, 2), (1, 4), and a reduced
  config of 8 heads over 2 KV heads at (1, 4);
* each attention rule is taken: KV heads at model 2, the query rows at 4
  (2 KV heads, 2 groups), the GQA groups for the 8-head config at 4;
* the four families at (1, 2) and (2, 2): losses within ``RTOL`` and the
  master within ``test_torch_train``'s rule of the reference's
  ``Trainer`` on the same (Auto-axes) mesh;
* vlm and encdec (the reference's trainer makes neither ``patches`` nor
  ``frames``): ``forward_train``'s loss and every gradient leaf at (1, 2)
  against the reference's ``value_and_grad`` under the same mesh and the
  port's one-device gradients (``LOSS_RTOL``, ``GRAD_RTOL``);
* the MoE layer's kept set over the model shards equals the one-device
  kept set exactly, and its rows its output within ``GRAD_RTOL``;
* a planted fault, a row-parallel reduce-scatter that keeps only each
  shard's own partial, fails the master rule and the losses' ``RTOL``
  (and lies beyond ``chip_smoke.TP_MASTER_TOL`` where the sound run lies
  within it);
* checkpoints across mesh shapes and packages: (1, 2) -> (1, 1) and
  (2, 2), (1, 1) -> (1, 2), (2, 2) -> (1, 1), the reference's (1, 2)
  checkpoint into the port, each restored state's whole leaves equal to
  the file's bit for bit, a resumed step bit-equal to its stacked form;
* each rank's float32 master, m and v for qwen2-0.5b at its published
  shapes at (1, 2): at most 0.55 of one rank's at (1, 1), counted on the
  meta device;
* ``python -m repro_torch.launch.train --model-axis 2 --device cpu``.
"""
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_model_axis_cases as cases
from repro import configs as rconfigs
from repro.models import transformer as rtfm
from repro_torch import configs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as tmoe
from repro_torch.models import tensor_parallel as tp
from repro_torch.models import transformer as tfm
from repro_torch.parallel import launch
from repro_torch.train import Trainer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import state_leaves
from test_torch_train import MASTER_FAR_SHARE, RTOL, _master_close
from test_torch_train_models import GRAD_RTOL, LOSS_RTOL

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
TIMEOUT = 300           # the spawn's and the reference's timeout, seconds
#: the learning rates of the 2 steps (warmup 1): an element moves by at
#: most about one rate a step
LR_SUM = cases.STEPS * 3e-4
#: the (data, model) meshes the reference's trainer runs on
REF_MESHES = ((1, 2), (2, 2))
#: ``MASTER_FAR_SHARE`` per family where the one-device trainer already
#: passes it against the reference. The hybrid's float32 master has
#: elements whose gradient is near rounding level (most in Mamba2's
#: ``conv_b``, drawn at zero, where the rule's bound is 1e-5 of a leaf
#: whose largest |value| is about 2 lr): the port's one-device trainer
#: leaves 77 and 70 of its 704,192 past the rule against the reference's
#: (1, 2) and (2, 2) runs (1.1e-4, measured), the model axis 81 to 85
FAR_SHARE = {"hybrid": 2e-4}
#: the vlm and encdec gradient checks: batch rows, tokens, patches or
#: frames (their sequences split over 2 model shards)
GRAD_B, GRAD_S, GRAD_STUB = 2, 24, 6

_REFERENCE = r"""
import json, sys
import numpy as np, jax
from repro import configs
from repro.models import transformer as rtfm
from repro.optim import adamw as radamw
from repro.train import checkpoint as rckpt, trainer as rtrainer
assert jax.device_count() == 4, jax.device_count()
inp, root, arch, steps = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
auto = (jax.sharding.AxisType.Auto,) * 2
opt = radamw.OptConfig(warmup=1, total_steps=steps)
out, meta = {}, {}
rcfg = configs.reduce(configs.get(arch))
for d, m in ((1, 2), (2, 2)):
    mesh = jax.make_mesh((d, m), ("data", "model"), axis_types=auto,
                         devices=jax.devices()[:d * m])
    t = rtrainer.Trainer(
        rcfg, opt,
        rtrainer.TrainerConfig(steps=steps, ckpt_dir=f"{root}/{arch}_{d}x{m}",
                               ckpt_every=steps, log_every=100, seq_len=32,
                               global_batch=8, data_axis=d, model_axis=m),
        mesh=mesh, log_fn=lambda s: None)
    st = t.run()
    meta[f"losses_{d}x{m}"] = [h["loss"] for h in t.history]
    for k, v in rckpt.flatten_with_paths(st.master).items():
        out[f"master_{d}x{m}/{k}"] = np.asarray(v)
if arch == "qwen2-0.5b":
    # forward_train's loss and gradients of vlm and encdec on (1, 2)
    io = np.load(inp)
    mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=auto,
                         devices=jax.devices()[:2])
    for name in ("llava-next-mistral-7b", "seamless-m4t-large-v2"):
        c = configs.reduce(configs.get(name))
        p = rtfm.init_params(c, jax.random.PRNGKey(1))[0]
        b = {k.split("/", 1)[1]: io[k] for k in io.files
             if k.startswith(name + "/")}
        with mesh:
            loss, g = jax.jit(jax.value_and_grad(
                lambda p: rtfm.forward_train(c, p, b)))(p)
        meta[f"loss_{name}"] = float(loss)
        for k, v in rckpt.flatten_with_paths(g).items():
            out[f"grad_{name}/{k}"] = np.asarray(v)
np.savez(f"{root}/ref_{arch}.npz", **out)
print(json.dumps(meta))
"""


def _batch(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (GRAD_B, GRAD_S)).astype(
            np.int32),
         "labels": rng.integers(0, cfg.vocab, (GRAD_B, GRAD_S)).astype(
            np.int32),
         "mask": (rng.random((GRAD_B, GRAD_S)) > 0.1).astype(np.float32)}
    if cfg.frontend in ("vision_stub", "audio_stub"):
        key = "patches" if cfg.frontend == "vision_stub" else "frames"
        b[key] = rng.standard_normal((GRAD_B, GRAD_STUB, 1024)).astype(
            np.float32)
    return b


def _stacked(name: str, root: Path, inits: dict, **kw) -> dict:
    fam, d, m = cases.case_names()[name]
    t = Trainer(cases.cfg(fam), cases.opt(),
                cases.tcfg(d, m, str(root / name), **kw),
                mesh=tmesh.make_stacked_mesh(data=d, model=m, device="cpu"),
                log_fn=cases.quiet)
    s = t.run(cases.start(t, fam, inits.get(fam)))
    return {"losses": [h["loss"] for h in t.history],
            **cases.state_arrays(t, s), "trainer": t, "state": s}


def _one_device(root: Path, init, **kw):
    t = Trainer(cases.cfg("dense"), cases.opt(), cases.tcfg(1, 1, str(root),
                                                            **kw),
                device="cpu", log_fn=cases.quiet)
    s = t.run(t.initial_state(tfm.load_reference_params(
        cases.cfg("dense"), init, device="cpu")))
    return t, s


def _stacked_restore(directory: Path, d: int, m: int) -> dict:
    """:func:`cases.restore_case` in the stacked form."""
    mesh = tmesh.make_stacked_mesh(data=d, model=m, device="cpu")
    return cases.restore_case(mesh, str(directory))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("model_axis")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inits = {fam: jax.tree.map(np.asarray, rtfm.init_params(
            rconfigs.reduce(rconfigs.get(arch)), jax.random.PRNGKey(0))[0])
                 for fam, arch in cases.FAMILIES.items()}
        batches = {name: _batch(configs.reduce(configs.get(name)))
                   for name in ("llava-next-mistral-7b",
                                "seamless-m4t-large-v2")}
        np.savez(root / "inputs.npz", **{f"{n}/{k}": v for n, b in
                                         batches.items() for k, v in
                                         b.items()})
        # one thread each: four processes of XLA's thread pools on a few
        # cores take four times as long
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                   "--xla_cpu_multi_thread_eigen=false "
                   "intra_op_parallelism_threads=1")
        (root / "ref").mkdir()
        procs = {arch: subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(root / "inputs.npz"),
             str(root / "ref"), arch, str(cases.STEPS)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for arch in cases.FAMILIES.values()}
        try:
            # the checkpoints the ranks restore: the stacked (1, 2) form's
            # and the one-device trainer's, each at step 2
            stacked = {"dense_1x2": _stacked("dense_1x2", root / "stacked",
                                             inits)}
            _one_device(root / "one", inits["dense"])
            for key, src in (("restore_2x2", root / "stacked" / "dense_1x2"),
                             ("restore_1x2", root / "one")):
                shutil.copytree(src, root / key)
                shutil.copytree(src, root / f"{key}_stacked")
            spec = {"root": str(root / "ranks"), "init": inits,
                    "restore_2x2": str(root / "restore_2x2"),
                    "restore_1x2": str(root / "restore_1x2")}
            ranks = launch.spawn_ranks(cases.run_cases, WORLD,
                                       backend="gloo", timeout=TIMEOUT,
                                       args=(spec,))
            for name in cases.case_names():
                if name not in stacked:
                    stacked[name] = _stacked(name, root / "stacked", inits)
            restored = {"restore_2x2": _stacked_restore(
                root / "restore_2x2_stacked", 2, 2),
                "restore_1x2": _stacked_restore(
                    root / "restore_1x2_stacked", 1, 2)}
            done = {arch: p.communicate(timeout=TIMEOUT)
                    for arch, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        torch.set_num_threads(threads)
    ref, ref_meta = {}, {}
    for arch, (stdout, stderr) in done.items():
        assert procs[arch].returncode == 0, (arch, stderr[-4000:])
        ref[arch] = dict(np.load(root / "ref" / f"ref_{arch}.npz"))
        ref_meta[arch] = json.loads(stdout.strip().splitlines()[-1])
    return {"root": root, "inits": inits, "ranks": ranks,
            "stacked": stacked, "restored": restored, "ref": ref,
            "ref_meta": ref_meta, "batches": batches}


def _same(a, b, what):
    np.testing.assert_array_equal(cases.bits(a), cases.bits(b),
                                  err_msg=str(what))


def _whole_master(t: Trainer, state) -> dict:
    """The reference's whole master leaves of a model-sharded state."""
    leaves = tp.checkpoint_leaves(t.mesh, t._step_fn.ctx.layout,
                                  t._step_fn.layout, state)
    return {k[2:]: v.detach().numpy() for k, v in leaves.items()
            if k.startswith("1/")}


# ---------------------------------------------------------------------------
# the rank form against the stacked form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(cases.case_names()))
def test_ranks_bit_equal_to_the_stacked_form(run, name):
    _, d, m = cases.case_names()[name]
    want = run["stacked"][name]
    for r in range(d * m):
        got = run["ranks"][r][name]
        assert got["losses"] == want["losses"], (r, got["losses"])
        for key in ("master", "m", "v"):
            assert len(got[key][0]) == len(want[key][r])
            for j, w in enumerate(want[key][r]):
                _same(got[key][0][j], w, (r, key, j))


def test_each_attention_rule_is_taken():
    assert tp.attention_rule(cases.cfg("dense"), 2) == "kv"
    assert tp.attention_rule(cases.cfg("dense"), 4) == "qc"
    assert tp.attention_rule(cases.cfg("gqa"), 4) == "g"
    assert tp.attention_rule(configs.get("qwen2-0.5b"), 2) == "kv"
    # the GQA rule: each shard's query heads, one per KV head; K/V whole
    lay = tp.Layout(cases.cfg("gqa"), 4)
    wq = lay.parts[lay.index["blocks.0.attn.wq.w"]]
    assert wq.own[1] == ((32, 64), (4 * 32 + 32, 4 * 32 + 64))
    wk = lay.parts[lay.index["blocks.0.attn.wk.w"]]
    assert wk.own == ((),) * 4 and wk.shared == ((0, 64),)
    # the query rows: the attention whole on every shard
    lay = tp.Layout(cases.cfg("dense"), 4)
    assert lay.parts[lay.index["blocks.0.attn.wo.w"]].own == ((),) * 4
    # Mamba2's in_proj: z, x and dt by head, B and C on every shard
    c = cases.cfg("ssm")
    lay = tp.Layout(c, 2)
    di, N, H = c.d_inner, c.ssm_state, c.ssm_heads
    part = lay.parts[lay.index["blocks.0.ssm.in_proj"]]
    assert part.own[1] == ((di // 2, di), (di + di // 2, 2 * di),
                           (2 * di + 2 * N + H // 2, 2 * di + 2 * N + H))
    assert part.shared == ((2 * di, 2 * di + 2 * N),)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(cases.FAMILIES))
@pytest.mark.parametrize("mesh", REF_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_model_axis_matches_the_reference_trainer(run, family, mesh):
    arch = cases.FAMILIES[family]
    d, m = mesh
    tag = f"{d}x{m}"
    st = run["stacked"][f"{family}_{tag}"]
    np.testing.assert_allclose(st["losses"],
                               run["ref_meta"][arch][f"losses_{tag}"],
                               rtol=RTOL)
    want = {k.split("/", 1)[1]: v for k, v in run["ref"][arch].items()
            if k.startswith(f"master_{tag}/")}
    got = _whole_master(st["trainer"], st["state"])
    assert sorted(got) == sorted(want)
    _master_close(got, want, LR_SUM, FAR_SHARE.get(family, MASTER_FAR_SHARE))


def _tp_grads(cfg, params, batch, M: int = 2) -> tuple:
    """(loss, whole gradient leaves) of the stacked (1, M) form."""
    mesh = tmesh.make_stacked_mesh(data=1, model=M, device="cpu")
    ctx = tp.make_ctx(cfg, mesh)
    zl = tp.zero_layout(cfg, mesh, ctx.layout)
    st = tp.init_state(params, ctx.layout, zl, mesh)
    losses, grads = tp.value_and_grad(ctx, st.master, [batch] * mesh.size)
    assert all(x.item() == losses[0].item() for x in losses)
    sl = steps.reduce_gradients(mesh, zl, grads, mean=False)
    whole = tp.whole_leaves(mesh, ctx.layout, zl, sl)
    return losses[0].item(), {k: v.numpy() for k, v in whole.items()}


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_vlm_and_encdec_gradients_match_the_reference(run, arch):
    cfg = configs.reduce(configs.get(arch))
    rp = jax.tree.map(np.asarray, rtfm.init_params(
        rconfigs.reduce(rconfigs.get(arch)), jax.random.PRNGKey(1))[0])
    params = tfm.load_reference_params(cfg, rp, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in run["batches"][arch].items()}
    loss, got = _tp_grads(cfg, params, batch)
    meta, ref = run["ref_meta"]["qwen2-0.5b"], run["ref"]["qwen2-0.5b"]
    np.testing.assert_allclose(loss, meta[f"loss_{arch}"], rtol=LOSS_RTOL)
    master = tfm.load_reference_params(cfg, rp, device="cpu",
                                       dtype=torch.float32)
    master.requires_grad_(True)
    one_loss, one = steps.value_and_grad(cfg, master, batch)
    np.testing.assert_allclose(loss, one_loss.item(), rtol=LOSS_RTOL)
    g = tfm.Transformer(cfg, device="cpu")
    with torch.no_grad():
        for dst, t in zip(g.parameters(), one):
            dst.copy_(t)
    one = ckpt.flatten_with_paths(tfm.to_reference_params(g))
    want = {k.split("/", 1)[1]: v for k, v in ref.items()
            if k.startswith(f"grad_{arch}/")}
    assert sorted(got) == sorted(want) == sorted(one)
    for k, w in want.items():
        for other in (w, one[k]):
            scale = max(float(np.abs(other).max()), 1e-30)
            err = float(np.abs(got[k] - other).max()) / scale
            assert err <= GRAD_RTOL, (k, err)


def _one_device_grads(cfg, params, batch) -> tuple:
    master = tfm.cast_params(params, torch.float32)
    master.requires_grad_(True)
    loss, grads = steps.value_and_grad(cfg, master, batch)
    g = tfm.Transformer(cfg, device="cpu")
    with torch.no_grad():
        for dst, t in zip(g.parameters(), grads):
            dst.copy_(t)
    return loss.item(), ckpt.flatten_with_paths(tfm.to_reference_params(g))


@pytest.mark.parametrize("arch", cases.FAMILIES_ALL)
def test_model_size_that_divides_nothing(arch):
    """Three model shards: no leaf splits (the vocabulary, ``d_ff``, the
    padded experts and Mamba2's heads are not multiples of 3; attention
    takes the query rows), so every sublayer runs its whole-leaf path;
    the loss and every gradient leaf against the one-device ones."""
    cfg = configs.reduce(configs.get(arch))
    plan = tp.make_plan(cfg, 3)
    assert not (plan.mlp or plan.experts or plan.ssm or plan.vocab)
    params = tfm.init_params(cfg, 2, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, got = _tp_grads(cfg, params, batch, M=3)
    one_loss, one = _one_device_grads(cfg, params, batch)
    np.testing.assert_allclose(loss, one_loss, rtol=LOSS_RTOL)
    assert sorted(got) == sorted(one)
    for k, w in one.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= GRAD_RTOL, (k, err)


def test_moe_kept_set_is_the_one_device_set(monkeypatch):
    """Layer 0's MoE of reduced qwen2-moe on the same input: every model
    shard's routing (``route`` on the gathered row) equals the one-device
    routing exactly, and the rows of the output the one-device output
    (bit for bit where the shared experts' two partial sums round alike,
    within ``GRAD_RTOL`` of the largest |value| everywhere)."""
    cfg = dataclasses.replace(cases.cfg("moe"), capacity_factor=0.5)
    p = tfm.init_params(cfg, 3, device="cpu")
    g = torch.Generator().manual_seed(3)
    z = torch.randn(2, 32, cfg.d_model, generator=g)
    want_r = tmoe.route(p.blocks[0].moe, cfg, z)
    want_y, _ = tmoe.apply(p.blocks[0].moe, cfg, z, torch.float32)
    assert not bool(want_r.keep.all())     # the capacity drops some
    for M in (2, 4):
        mesh = tmesh.make_stacked_mesh(model=M, device="cpu")
        ctx = tp.make_ctx(cfg, mesh)
        pieces = [ctx.layout.take(list(p.parameters()), r) for r in range(M)]
        views = [ctx.layout.view(ps, r, "blocks.0.moe.",
                                 ctx.layout.meta.blocks[0].moe, ctx.dt)
                 for r, ps in enumerate(pieces)]
        taps = []

        def tap(*a, route=tmoe.route):
            taps.append(route(*a))
            return taps[-1]

        monkeypatch.setattr(tmoe, "route", tap)
        ys, _ = tp.moe(ctx, views, list(z.chunk(M, dim=1)))
        monkeypatch.undo()
        assert len(taps) == M
        for rt in taps:
            for key in ("experts", "keep", "slot", "gates"):
                assert torch.equal(getattr(rt, key), getattr(want_r, key)), \
                    (M, key)
        y = torch.cat(ys, dim=1)
        err = float((y - want_y).abs().max() / want_y.abs().max())
        assert err <= GRAD_RTOL, (M, err)


# ---------------------------------------------------------------------------
# a planted fault
# ---------------------------------------------------------------------------


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_planted_fault_fails_the_checks(run, tmp_path):
    cs = _chip_smoke()
    assert cs.own_partial_alone.__doc__
    keep = tmesh._scatter_rows
    tmesh._scatter_rows = cs.own_partial_alone
    try:
        fault = _stacked("dense_1x2", tmp_path, run["inits"])
    finally:
        tmesh._scatter_rows = keep
    arch = cases.FAMILIES["dense"]
    want = {k.split("/", 1)[1]: v for k, v in run["ref"][arch].items()
            if k.startswith("master_1x2/")}
    got = _whole_master(fault["trainer"], fault["state"])
    with pytest.raises(AssertionError):
        _master_close(got, want, LR_SUM)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(
            fault["losses"], run["ref_meta"][arch]["losses_1x2"], rtol=RTOL)
    # chip_smoke phase 24 (a)'s measure: |tp - a| / |a - initial|
    init = ckpt.flatten_with_paths(run["inits"]["dense"])
    keys = sorted(want)
    sound = _whole_master(run["stacked"]["dense_1x2"]["trainer"],
                          run["stacked"]["dense_1x2"]["state"])

    def t(d):
        return [torch.from_numpy(np.array(d[k])) for k in keys]

    gap, update = cs.master_gap(t(sound), t(want), t(init))
    bad, _ = cs.master_gap(t(got), t(want))
    assert gap / update <= cs.TP_MASTER_TOL < bad / update, (
        gap / update, bad / update)


# ---------------------------------------------------------------------------
# checkpoints across mesh shapes and packages
# ---------------------------------------------------------------------------


def _file(directory) -> dict:
    return ckpt.CheckpointManager(str(directory)).load_raw()[0]


@pytest.mark.parametrize("key", ["restore_2x2", "restore_1x2"])
def test_ranks_restore_across_mesh_shapes(run, key):
    """(1, 2)'s checkpoint at (2, 2) and (1, 1)'s at (1, 2): each rank's
    whole leaves after the restore equal the file's, and its next step
    equals the stacked form's bit for bit."""
    arrays = _file(run["root"] / key)
    d, m = (2, 2) if key == "restore_2x2" else (1, 2)
    want = run["restored"][key]
    for r in range(d * m):
        got = run["ranks"][r][key]
        assert got["restored_step"] == cases.STEPS
        assert sorted(got["leaves"]) == sorted(arrays)
        for k, a in arrays.items():
            np.testing.assert_array_equal(got["leaves"][k], a, err_msg=k)
        assert got["losses"] == want["losses"]
        for mv in ("master", "m", "v"):
            for j, w in enumerate(want[mv][r]):
                _same(got[mv][0][j], w, (r, mv, j))


@pytest.mark.parametrize("name", ["dense_1x2", "dense_2x2"])
def test_one_device_restores_a_model_axis_checkpoint(run, name):
    """The stacked (1, 2) and (2, 2) forms' checkpoints restored by a
    one-device trainer: its state's leaves equal the file's bit for
    bit."""
    directory = run["root"] / "stacked" / name
    arrays = _file(directory)
    t = Trainer(cases.cfg("dense"), cases.opt(), cases.tcfg(
        1, 1, str(directory)), device="cpu", log_fn=cases.quiet)
    got = state_leaves(t.init_or_restore())
    assert sorted(got) == sorted(arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(got[k].detach().numpy(), a, err_msg=k)


def test_port_restores_the_reference_checkpoint(run, tmp_path):
    src = run["root"] / "ref" / "qwen2-0.5b_1x2"
    arrays = _file(src)
    got = _stacked_restore(src, 1, 2)
    assert got["restored_step"] == cases.STEPS
    for k, a in arrays.items():
        np.testing.assert_array_equal(got["leaves"][k], a, err_msg=k)
    # the reference's step-2 master equals the one it returned
    for k, w in run["ref"]["qwen2-0.5b"].items():
        if k.startswith("master_1x2/"):
            np.testing.assert_array_equal(arrays["1/" + k.split("/", 1)[1]],
                                          w)


# ---------------------------------------------------------------------------
# memory, the mesh, the CLI
# ---------------------------------------------------------------------------


def test_per_rank_state_bytes_at_full_width():
    cfg = configs.get("qwen2-0.5b")
    one = tp.state_bytes(cfg, 1)
    assert one == 12 * tfm.Transformer(cfg, device="meta").param_count()
    assert tp.state_bytes(cfg, 2) <= 0.55 * one, tp.state_bytes(cfg, 2) / one


def test_mesh_rules_with_a_model_axis(tmp_path):
    m = tmesh.make_stacked_mesh(data=2, model=2, pods=2, device="cpu")
    assert m.axis_names == ("pod", "data", "model") and m.size == 8
    assert m.shape == {"pod": 2, "data": 2, "model": 2} and m.dp_size == 4
    assert m.members("model", 5) == [4, 5]
    assert m.members("data", 5) == [5, 7]
    assert m.members("pod", 5) == [1, 5]
    assert m.members("dp", 5) == [1, 3, 5, 7]
    assert m.members("world", 5) == list(range(8))
    from repro_torch.parallel import sharding
    assert sharding.shard_coords(m, 5) == {"pod": 1, "data": 0, "model": 1}
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_debug_mesh(data=1, model=2, device="cpu")
    assert m.members("in_pod", 5) == [4, 5, 6, 7]
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    mesh = tmesh.make_stacked_mesh(model=2, device="cpu")
    # the compressed step holds the whole model on every model shard; the
    # pod wire needs the reference's 2 pods
    step = steps.make_train_step(cases.cfg("dense"), cases.opt(), mesh=mesh,
                                 grad_compression=10)
    assert not steps.tensor_parallel(step)
    with pytest.raises(ValueError, match="2 pods"):
        steps.make_train_step(cases.cfg("dense"), cases.opt(), mesh=mesh,
                              pod_wire="u16")
    with pytest.raises(ValueError, match="equal rows"):
        t = Trainer(cases.cfg("dense"), cases.opt(), dataclasses.replace(
            cases.tcfg(1, 2, str(tmp_path)), seq_len=31), mesh=mesh,
            log_fn=cases.quiet)
        t.run(t.initial_state(tfm.init_params(cases.cfg("dense"), 0,
                                              device="cpu")))


def test_launch_train_model_axis_two_on_the_cpu(tmp_path, capsys):
    hist = launch_train.main(["--arch", "qwen2-0.5b", "--reduce", "--device",
                              "cpu", "--model-axis", "2", "--steps", "2",
                              "--seq-len", "16", "--global-batch", "4",
                              "--ckpt-every", "2", "--ckpt-dir",
                              str(tmp_path)])
    out = capsys.readouterr().out
    assert "2 ranks: gloo, on the CPU" in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert ckpt.CheckpointManager(str(tmp_path)).steps() == [2]
