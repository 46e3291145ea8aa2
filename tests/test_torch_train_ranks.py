"""repro_torch's training data axis across processes, on the CPU under gloo.

One module-scoped spawn of four ranks (``parallel.launch.spawn_ranks``;
the rank side is ``tests/torch_train_ranks_cases.py``) runs every case
at P = 4 on the world group and at P = 1 and 2 on subgroups; the parent
runs the same cases in the stacked form (``launch.mesh.make_stacked_mesh``:
every shard in one process, one after another) and today's one-device
trainer, with one intra-op thread as the ranks have, and the reference
runs in three subprocesses side by side, each with four XLA host
devices (started first, so they overlap the rest). Reduced qwen2-0.5b
(d 128, 2 layers, vocab 512), seq 32, global batch 8, 3 steps:

* each rank's rows equal its slice of ``next_host_batch``;
* ``zero_spec``/``zero_spec_tree`` equal the reference's on every leaf of
  the ten configs at data sizes 1, 2 and 4; the sharding rules and the
  batch and cache spec trees equal the reference's;
* ``compressed_wire_reduce`` (u16, u8) and ``compressed_psum`` (each
  rank's ZeRO slices of the sum) at P = 2 and 4 equal the reference's
  ``shard_map`` runs bit for bit;
* every rank's losses, master, m and v equal the stacked form's bit for
  bit (plain at P = 1, 2, 4, ``grad_compression = 10`` at 2 and 4,
  ``pod_wire`` u16 at 2 and 4 and u8 at 4), and P = 1 equals today's
  trainer (losses, master, m, v, the checkpoint's arrays);
* ``data_axis`` = 2 and 4, plain and ``grad_compression = 10``: losses
  within ``RTOL`` and the master within ``test_torch_train``'s rule of
  the reference's ``Trainer`` on the same mesh shape; ``pod_wire`` u16 at
  P = 2 and 4 and u8 at 4 against the reference's ``make_train_step``
  on the same (pod 2, data, model 1) mesh;
* checkpoints across P and packages: the port's P = 2 checkpoint restored
  by the ranks at P = 1, 2, 4 and by the reference on 4 devices, the
  reference's P = 4 checkpoint by the port at P = 1, 2, 4, leaf for leaf;
  a P = 4 trainer resumes the P = 2 checkpoint, bit-equal to its stacked
  form;
* ``chip_smoke.py`` phase 23 (b)'s master check: P = 2 within its limit
  of the one-device master, a planted fault beyond it;
* ``python -m repro_torch.launch.train --data-axis 2 --device cpu``.
"""
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_train_ranks_cases as cases
from repro import configs as rconfigs
from repro.launch import steps as rsteps
from repro.models import transformer as rtfm
from repro.optim import adamw as radamw
from repro.parallel import sharding as rsharding
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticTokenStream
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.parallel import launch, sharding
from repro_torch.train import Trainer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import state_leaves
from test_torch_train import MASTER_FAR_SHARE, RTOL, _master_close

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
TIMEOUT = 240           # the spawn's and the reference's timeout, seconds
#: the reference script's parts, each in a process of its own: the
#: reductions, the plain trainers and the checkpoint; the compressed
#: trainers; the pod-wire steps
REF_PARTS = ("base", "comp", "wire")
#: the learning rates of the 3 steps (warmup 1): an element moves by at
#: most about one rate a step
LR_SUM = 3 * 3e-4
#: ``MASTER_FAR_SHARE`` where the exchange quantises the gradients, per
#: wire. A float32 difference between the packages' gradients flips an
#: element's rounding to the wire's format with a chance of about the
#: difference over the format's step, and Adam's ``m/sqrt(v)`` turns a
#: flip on an element near zero into up to a rate a step (u8: the shared
#: scale puts most elements among e4m3's few subnormal steps, so an
#: element flips between 0 and the least step). Measured on the stacked
#: form: gradients perturbed by 4e-6 relative move 37 of 361,600 master
#: elements past the rule in the plain run (the packages' own difference
#: moves 35), 59 with E8M10 and 143 with u16; by 2e-7 relative, 1,542 with
#: u8. One pod's gradient alone in place of the pods' mean (a dropped
#: reduction) moves 99 % of them with either wire
QUANTISED_FAR_SHARE = {"comp": 4e-4, "wire_u16": 4e-4, "wire_u8": 1e-2}

_REFERENCE = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.data.synthetic import DataConfig, SyntheticTokenStream
from repro.launch import steps as rsteps
from repro.models import transformer as rtfm
from repro.optim import adamw as radamw, compression as rcomp
from repro.parallel import shard_map_compat
from repro.train import checkpoint as rckpt, trainer as rtrainer
assert jax.device_count() == 4, jax.device_count()
inp, root, port_ckpt, part = sys.argv[1:5]
io = np.load(inp)
auto = (jax.sharding.AxisType.Auto,) * 2
rcfg = configs.reduce(configs.get("qwen2-0.5b"))
opt = radamw.OptConfig(warmup=1, total_steps=3)
out, meta = {}, {}


def keep(name, losses, master):
    meta[f"losses_{name}"] = losses
    for k, v in rckpt.flatten_with_paths(master).items():
        out[f"master_{name}/{k}"] = np.asarray(v)


if part == "base":
    for n in (2, 4):
        mesh = jax.make_mesh((n, 1), ("data", "model"), axis_types=auto)
        for w in ("u16", "u8"):
            f = shard_map_compat(
                lambda g, w=w, n=n: rcomp.compressed_wire_reduce(
                    g[0], "data", n, w)[None],
                mesh, in_specs=P("data"), out_specs=P("data"))
            out[f"wire_{w}_{n}"] = np.asarray(jax.jit(f)(jnp.asarray(
                io[f"wire{n}"])))
        names = sorted(k for k in io.files if k.startswith(f"psum{n}_g"))
        gs = {k: jnp.asarray(io[k]) for k in names}
        es = {k: jnp.asarray(io[k.replace("_g", "_e")]) for k in names}
        f = shard_map_compat(
            lambda g, e: rcomp.compressed_psum(
                {k: v[0] for k, v in g.items()},
                {k: v[0] for k, v in e.items()}, "data", 10),
            mesh, in_specs=(P("data"), P("data")), out_specs=(P(), P("data")))
        s, e = jax.jit(f)(gs, es)
        for k in names:
            out[f"psum_s_{k}"] = np.asarray(s[k])
            out[f"psum_e_{k}"] = np.asarray(e[k])
# the trainers: plain (checkpointed at step 3) and grad_compression 10 at
# data 2 and 4, from PRNGKey(0)'s parameters and the seed-0 stream
runs = {"base": [("plain_p2", 2, {}), ("plain_p4", 4, {})],
        "comp": [("comp_p2", 2, {"grad_compression": 10}),
                 ("comp_p4", 4, {"grad_compression": 10})]}
for name, n, kw in runs.get(part, ()):
    mesh = jax.make_mesh((n, 1), ("data", "model"), axis_types=auto)
    t = rtrainer.Trainer(
        rcfg, opt,
        rtrainer.TrainerConfig(steps=3, ckpt_dir=f"{root}/{part}_p{n}",
                               ckpt_every=3,
                               log_every=100, seq_len=32, global_batch=8,
                               data_axis=n, **kw),
        mesh=mesh, log_fn=lambda s: None)
    st = t.run()
    keep(name, [h["loss"] for h in t.history], st.master)
# pod_wire: make_train_step's step on (pod 2, data d, model 1) meshes
if part == "wire":
    for name, d, w in (("wire_u16_p2", 1, "u16"), ("wire_u16_p4", 2, "u16"),
                       ("wire_u8_p4", 2, "u8")):
        mesh = jax.make_mesh((2, d, 1), ("pod", "data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 3,
                             devices=jax.devices()[:2 * d])
        fn, _, _ = rsteps.make_train_step(rcfg, opt, pod_wire=w)
        st = radamw.init_state(rtfm.init_params(rcfg,
                                                jax.random.PRNGKey(0))[0])
        data = SyntheticTokenStream(DataConfig(vocab=rcfg.vocab, seq_len=32,
                                               global_batch=8, seed=0))
        losses = []
        with mesh:
            step = jax.jit(fn)
            for _ in range(3):
                st, m = step(st, data.next_placed_batch(mesh))
                losses.append(float(m["loss"]))
        keep(name, losses, st.master)
if part == "base":
    # the port's checkpoint, restored onto the 4-device mesh
    mesh = jax.make_mesh((4, 1), ("data", "model"), axis_types=auto)
    shapes, _ = rtfm.abstract_params(rcfg)
    f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                       shapes)
    template = radamw.TrainState(jax.ShapeDtypeStruct((), jnp.int32), f32,
                                 f32, f32)
    arrays, cmeta = rckpt.CheckpointManager(port_ckpt).load_raw()
    state = rckpt.restore_resharded(template, arrays, cmeta, mesh=mesh)
    meta["restored"] = {}
    for k, v in rckpt.flatten_with_paths(state).items():
        meta["restored"][k] = [str(v.dtype), bool(np.array_equal(
            np.asarray(v), arrays[k])), [list(e) if isinstance(e, tuple)
                                         else e for e in v.sharding.spec]]
np.savez(f"{root}/ref_{part}.npz", **out)
print(json.dumps(meta))
"""


def _cfgs():
    return cases.cfg(), rconfigs.reduce(rconfigs.get(cases.ARCH))


def _start(t: Trainer, init: dict):
    return t.initial_state(tfm.load_reference_params(cases.cfg(), init,
                                                     device="cpu"))


def _stacked(name: str, root: Path, init: dict) -> dict:
    """The case ``name`` in the stacked form."""
    P, pods, kw = cases.CASES[name]
    t = Trainer(cases.cfg(), cases.opt(),
                cases.tcfg(P, pods, str(root / name), **dict(kw)),
                mesh=tmesh.make_stacked_mesh(data=P // pods, pods=pods,
                                             device="cpu"),
                log_fn=cases.quiet)
    s = t.run(_start(t, init))
    return {"losses": [h["loss"] for h in t.history],
            **cases.state_arrays(t, s)}


def _one_device(root: Path, init: dict) -> dict:
    t = Trainer(cases.cfg(), cases.opt(), cases.tcfg(1, 1, str(root)),
                device="cpu", log_fn=cases.quiet)
    s = t.run(_start(t, init))
    return {"losses": [h["loss"] for h in t.history],
            "leaves": {k: v.detach().numpy()
                       for k, v in state_leaves(s).items()}}


def _wire_inputs(rng):
    """Per P: one gradient per rank (odd sizes: the chunks pad), and per
    P the compressed_psum gradients and error buffers."""
    wire = {n: rng.standard_normal((n, 7, 13)).astype(np.float32)
            for n in (2, 4)}
    psum = {n: [([rng.standard_normal(s).astype(np.float32)
                  for s in ((5,), (3, 4))],
                 [(rng.standard_normal(s) * 1e-4).astype(np.float32)
                  for s in ((5,), (3, 4))]) for _ in range(n)]
            for n in (2, 4)}
    return wire, psum


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_ranks")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # the reference's initial parameters, which every run starts from
        init = jax.tree.map(np.asarray, rtfm.init_params(
            _cfgs()[1], jax.random.PRNGKey(0))[0])
        # the port's P = 2 checkpoint first: the reference restores it
        stacked = {"plain_p2": _stacked("plain_p2", root / "stacked", init)}
        wire, psum = _wire_inputs(np.random.default_rng(5))
        io = {f"wire{n}": w for n, w in wire.items()}
        for n, per in psum.items():
            for k in range(2):
                io[f"psum{n}_g{k}"] = np.stack([g[k] for g, _ in per])
                io[f"psum{n}_e{k}"] = np.stack([e[k] for _, e in per])
        np.savez(root / "inputs.npz", **io)
        port_ckpt = root / "stacked" / "plain_p2"
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        (root / "ref").mkdir()
        # its three parts in three processes, side by side
        procs = {part: subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(root / "inputs.npz"),
             str(root / "ref"), str(port_ckpt), part],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for part in REF_PARTS}
        try:
            resume = root / "resume"
            shutil.copytree(port_ckpt, resume)
            shutil.copytree(port_ckpt, root / "resume_stacked")
            spec = {"root": str(root / "ranks"),
                    "checkpoints": {"port_p2": str(port_ckpt)},
                    "resume": str(resume), "wire": wire, "psum": psum,
                    "init": init}
            ranks = launch.spawn_ranks(cases.run_cases, WORLD,
                                       backend="gloo", timeout=TIMEOUT,
                                       args=(spec,))
            for name in cases.CASES:
                if name not in stacked:
                    stacked[name] = _stacked(name, root / "stacked", init)
            one = _one_device(root / "one", init)
            t = Trainer(cases.cfg(), cases.opt(), cases.tcfg(
                4, 1, str(root / "resume_stacked"), ckpt_every=100),
                mesh=tmesh.make_stacked_mesh(data=4, device="cpu"),
                log_fn=cases.quiet)
            s = t.run()
            resume_stacked = {"losses": [h["loss"] for h in t.history],
                              **cases.state_arrays(t, s)}
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
    for part, (stdout, stderr) in done.items():
        assert procs[part].returncode == 0, (part, stderr[-4000:])
        ref.update(np.load(root / "ref" / f"ref_{part}.npz"))
        ref_meta.update(json.loads(stdout.strip().splitlines()[-1]))
    return {"root": root, "init": init, "ranks": ranks, "stacked": stacked,
            "one": one,
            "resume_stacked": resume_stacked, "wire": wire, "psum": psum,
            "ref": ref,
            "ref_meta": ref_meta,
            "port_ckpt": port_ckpt}


def _paths(tree, **kw) -> dict:
    return {"/".join(str(k.key) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, **kw)[0]}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _same(a, b, what):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(what))


def _fake_mesh(**sizes):
    """A mesh of ``sizes`` for both packages' spec rules (the reference
    reads ``axis_names`` and ``devices.shape``, the port ``shape``)."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())),
                                 shape=dict(sizes))


# ---------------------------------------------------------------------------
# specs and rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 2, 4])
def test_rank_rows_are_their_slice_of_the_batch(run, P):
    c = cases.cfg()
    data = SyntheticTokenStream(DataConfig(vocab=c.vocab, seq_len=cases.SEQ,
                                           global_batch=cases.BATCH, seed=0))
    want = [data.next_host_batch() for _ in range(2)]
    rows = cases.BATCH // P
    for r in range(P):
        got = run["ranks"][r][f"rows_p{P}"]
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(
                    g[k], w[k][r * rows:(r + 1) * rows], err_msg=(r, k))


@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_zero_specs_equal_the_reference(arch):
    params, specs = tfm.abstract_params(configs.get(arch))
    shapes = adamw.leaf_shapes(params)
    rshapes, rspecs = rtfm.abstract_params(rconfigs.get(arch))
    rshape_leaves = _paths(rshapes)
    for d in (1, 2, 4):
        got = adamw.zero_spec_tree(specs, shapes, data_size=d)
        want = _paths(radamw.zero_spec_tree(rspecs, rshapes, data_size=d),
                      is_leaf=lambda s: isinstance(s, rsharding.P))
        assert {"/".join(k): v for k, v in got.items()} == {
            k: tuple(v) for k, v in want.items()}, d
        for k, s in shapes.items():
            assert s == tuple(rshape_leaves["/".join(k)].shape), k
    assert adamw.zero_spec((None, "model")) == (("pod", "data"), "model")
    assert tuple(radamw.zero_spec(rsharding.P(None, "model"))) == \
        (("pod", "data"), "model")


def test_sharding_rules_equal_the_reference():
    specs = [(("pod", "data"), None), (None, "model"), ("data", "model"),
             ((("pod", "data")), "model", None), (("model", "data"),),
             (None, None, ("pod", "data"))]
    shapes = [(8, 6), (3, 16), (6, 4), (12, 16, 2), (16,), (2, 3, 10)]
    meshes = [_fake_mesh(data=2, model=1), _fake_mesh(pod=2, data=2, model=1),
              _fake_mesh(data=4, model=1), _fake_mesh(data=1, model=4)]
    for m in meshes:
        assert sharding.batch_axes(m) == rsharding.batch_axes(m)
        for spec, shape in zip(specs, shapes):
            rspec = rsharding.P(*spec)
            assert sharding.filter_spec(spec, m) == tuple(
                rsharding.filter_spec(rspec, m))
            assert sharding.sanitize_spec(spec, shape, m) == tuple(
                rsharding.sanitize_spec(rspec, shape, m))
    # the slices of a leaf over the shards tile it, pods outermost
    m = _fake_mesh(pod=2, data=2, model=1)
    x = np.arange(8 * 6).reshape(8, 6)
    got = [sharding.take_shard(x, (("pod", "data"), None), m, s)
           for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(got), x)
    assert sharding.take_shard(x, (("pod", "data"),), _fake_mesh(
        data=3, model=1), 1) is x      # 8 rows over 3: replicated


def test_batch_and_cache_spec_trees_equal_the_reference():
    cfg, rcfg = _cfgs()
    batch = {"tokens": np.zeros((4, 8), np.int32),
             "labels": np.zeros((4, 8), np.int32),
             "mask": np.zeros((4, 8), np.float32)}
    want = rsteps.batch_spec_tree(batch)
    assert steps.batch_spec_tree(batch) == {k: tuple(v)
                                            for k, v in want.items()}
    for arch in ("qwen2-0.5b", "mamba2-1.3b", "seamless-m4t-large-v2"):
        c = configs.reduce(configs.get(arch))
        rc = rconfigs.reduce(rconfigs.get(arch))
        cache = tfm.init_cache(c, 2, 16, **({"enc_len": 4} if
                                            c.family == "encdec" else {}),
                               device="meta")
        rcache = jax.eval_shape(lambda: rtfm.init_cache(
            rc, 2, 16, **({"enc_len": 4} if rc.family == "encdec" else {})))
        want = rsteps.cache_spec_tree(rc, rcache)
        assert sorted(cache) == sorted(rcache), arch
        assert steps.cache_spec_tree(c, cache) == {
            k: tuple(v) for k, v in want.items()}, arch


# ---------------------------------------------------------------------------
# the reductions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("wire", ["u16", "u8"])
def test_compressed_wire_reduce_bit_equal_to_the_reference(run, P, wire):
    want = run["ref"][f"wire_{wire}_{P}"]
    for r in range(P):
        _same(run["ranks"][r][f"wire_p{P}"][wire], want[r], (r, wire))
    # the stacked form gives the same bits
    m = tmesh.make_stacked_mesh(data=P, device="cpu")
    from repro_torch.optim import compression as comp
    got = comp.compressed_wire_reduce(
        [torch.from_numpy(g) for g in run["wire"][P]], m, "data", wire)
    for r in range(P):
        _same(got[r].numpy(), want[r], (r, wire, "stacked"))


@pytest.mark.parametrize("P", [2, 4])
def test_compressed_psum_over_ranks_bit_equal_to_the_reference(run, P):
    layout = cases.psum_layout(P)
    for r in range(P):
        s, e = run["ranks"][r][f"psum_p{P}"]
        for k in range(2):
            want = torch.from_numpy(run["ref"][f"psum_s_psum{P}_g{k}"])
            _same(s[k], layout[k].take(want, r).numpy(), (r, k))
            # each device's buffer, concatenated along dim 0 by out_specs
            _same(e[k], np.split(run["ref"][f"psum_e_psum{P}_g{k}"], P)[r],
                  (r, k))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(cases.CASES))
def test_ranks_bit_equal_to_the_stacked_form(run, name):
    P = cases.CASES[name][0]
    want = run["stacked"][name]
    for r in range(P):
        got = run["ranks"][r][name]
        assert got["losses"] == want["losses"], (r, got["losses"])
        for k, w in want["master"].items():
            _same(got["master"][k], w, (r, k))
        for key in ("m", "v"):
            for j, w in enumerate(want[key][r]):
                _same(got[key][0][j], w, (r, key, j))
    # the rank run's checkpoint equals the stacked form's
    a, _ = ckpt.CheckpointManager(str(run["root"] / "ranks" / name)) \
        .load_raw(2)
    b, mb = ckpt.CheckpointManager(str(run["root"] / "stacked" / name)) \
        .load_raw(2)
    assert sorted(a) == sorted(b)
    for k in b:
        _same(a[k], b[k], k) if b[k].dtype == np.float32 else \
            np.testing.assert_array_equal(a[k], b[k])


def test_one_rank_equals_the_one_device_trainer(run):
    one, got = run["one"], run["ranks"][0]["plain_p1"]
    assert got["losses"] == one["losses"]
    leaves = one["leaves"]
    for k, w in got["master"].items():
        _same(w, leaves["1/" + k], k)
    layout = adamw.zero_layout(cases.cfg(), tmesh.make_stacked_mesh(
        device="cpu"))
    for i, key in ((2, "m"), (3, "v")):
        for leaf, w in zip(layout, got[key][0]):
            _same(w, leaves[f"{i}/{leaf.key}"], (key, leaf.key))
    a, ma = ckpt.CheckpointManager(str(run["root"] / "ranks" / "plain_p1")) \
        .load_raw(2)
    b, mb = ckpt.CheckpointManager(str(run["root"] / "one")).load_raw(2)
    assert list(a) == list(b) and ma["leaves"] == mb["leaves"]
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def _matches_the_reference(run, name, share=MASTER_FAR_SHARE):
    """Every rank's losses within ``RTOL`` and master within
    ``test_torch_train``'s rule (with ``share``) of the reference's run of
    case ``name`` from the same parameters and batches."""
    want = {k.split("/", 1)[1]: v for k, v in run["ref"].items()
            if k.startswith(f"master_{name}/")}
    assert want, name
    for r in range(cases.CASES[name][0]):
        got = run["ranks"][r][name]
        np.testing.assert_allclose(got["losses"],
                                   run["ref_meta"][f"losses_{name}"],
                                   rtol=RTOL)
        _master_close(got["master"], want, LR_SUM, share)


@pytest.mark.parametrize("P", [2, 4])
def test_data_axis_matches_the_reference_trainer(run, P):
    _matches_the_reference(run, f"plain_p{P}")


@pytest.mark.parametrize("name", ["comp_p2", "comp_p4", "wire_u16_p2",
                                  "wire_u16_p4", "wire_u8_p4"])
def test_compressed_steps_match_the_reference(run, name):
    """``grad_compression = 10`` against the reference's compressed
    ``Trainer`` (its ``shard_map`` step) at data 2 and 4; ``pod_wire``
    against the reference's ``make_train_step(pod_wire=)`` on (pod 2,
    data 1 or 2, model 1) meshes. The master's share past the rule is the
    wire's, ``QUANTISED_FAR_SHARE``."""
    _matches_the_reference(run, name,
                           QUANTISED_FAR_SHARE[name.rsplit("_", 1)[0]])


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, loaded as a module (it
    imports nothing of JAX and needs no card to import)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_master_check_catches_a_planted_fault(run, tmp_path):
    """Phase 23 (b)'s master check at this size: the stacked P = 2
    master's distance from the one-device trainer's, over the latter's
    update, lies under ``DP_MASTER_TOL``, and the planted fault's (each
    shard's slices from its own gradient alone) above it."""
    cs = _chip_smoke()
    keys = sorted(run["stacked"]["plain_p2"]["master"])
    init = ckpt.flatten_with_paths(run["init"])

    def tensors(leaves, prefix=""):
        return [torch.from_numpy(np.array(leaves[prefix + k]))
                for k in keys]

    ref = tensors(run["one"]["leaves"], "1/")
    gap, update = cs.master_gap(tensors(run["stacked"]["plain_p2"]["master"]),
                                ref, tensors(init))
    reduce = steps.reduce_gradients
    steps.reduce_gradients = cs.own_gradient_alone(reduce)
    try:
        fault = _stacked("plain_p2", tmp_path, run["init"])["master"]
    finally:
        steps.reduce_gradients = reduce
    fault_gap, _ = cs.master_gap(tensors(fault), ref)
    assert update > 0
    assert gap / update <= cs.DP_MASTER_TOL < fault_gap / update, (
        gap / update, fault_gap / update)


# ---------------------------------------------------------------------------
# checkpoints across P and packages
# ---------------------------------------------------------------------------


def _spec(meta, key):
    return ckpt._spec_from_json(meta["leaves"][key]["spec"])


@pytest.mark.parametrize("P", [1, 2, 4])
def test_ranks_restore_the_port_checkpoint(run, P):
    arrays, meta = ckpt.CheckpointManager(str(run["port_ckpt"])).load_raw()
    m = tmesh.make_stacked_mesh(data=P, device="cpu")
    for r in range(P):
        got = run["ranks"][r][f"restore_port_p2_p{P}"]
        assert sorted(got) == sorted(arrays)
        for k, a in arrays.items():
            np.testing.assert_array_equal(
                got[k], sharding.take_shard(a, _spec(meta, k), m, r),
                err_msg=(r, k))


def test_reference_restores_the_port_checkpoint(run):
    arrays, meta = ckpt.CheckpointManager(str(run["port_ckpt"])).load_raw()
    restored = run["ref_meta"]["restored"]
    assert sorted(restored) == sorted(arrays)
    m = _fake_mesh(data=4, model=1)
    for k, (dtype, equal, spec) in restored.items():
        assert equal and dtype == str(arrays[k].dtype), k
        want = sharding.sanitize_spec(_spec(meta, k), arrays[k].shape, m)
        assert tuple(tuple(e) if isinstance(e, list) else e
                     for e in spec) == want[:len(spec)], k
    # the ZeRO specs went along: leaves of master, m and v are split
    for i in (1, 2, 3):
        assert any(any(e is not None for e in r[2])
                   for k, r in restored.items() if k.startswith(f"{i}/"))


@pytest.mark.parametrize("P", [1, 2, 4])
def test_port_restores_the_reference_checkpoint(run, P):
    d = str(run["root"] / "ref" / "base_p4")
    arrays, meta = ckpt.CheckpointManager(d).load_raw()
    template = {k: torch.empty(v.shape, device="meta",
                               dtype=torch.from_numpy(v).dtype)
                for k, v in arrays.items()}
    m = tmesh.make_stacked_mesh(data=P, device="cpu")
    for r in range(P):
        got = ckpt.restore_resharded(template, arrays, meta, mesh=m, index=r)
        for k, a in arrays.items():
            np.testing.assert_array_equal(
                got[k].numpy(), sharding.take_shard(a, _spec(meta, k), m, r),
                err_msg=(r, k))
    # the reference's step-3 master equals the one it returned
    for k, w in run["ref"].items():
        if k.startswith("master_plain_p4/"):
            np.testing.assert_array_equal(arrays["1/" + k.split("/", 1)[1]],
                                          w)


def test_p4_resumes_the_p2_checkpoint(run):
    got, want = run["ranks"][0]["resume_p4"], run["resume_stacked"]
    arrays, _ = ckpt.CheckpointManager(str(run["port_ckpt"])).load_raw(2)
    assert got["restored_step"] == 2
    layout = adamw.zero_layout(cases.cfg(), tmesh.make_stacked_mesh(
        data=4, device="cpu"))
    for leaf, w in zip(layout, got["m0"]):
        np.testing.assert_array_equal(w, leaf.take(torch.from_numpy(
            arrays["2/" + leaf.key]), 0).numpy())
    assert got["losses"] == want["losses"]
    for k, w in want["master"].items():
        _same(got["master"][k], w, k)
    np.testing.assert_allclose(got["losses"],
                               run["stacked"]["plain_p2"]["losses"][2:],
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# the mesh, the step's rules, the CLI
# ---------------------------------------------------------------------------


def test_mesh_and_step_rules(tmp_path):
    cfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_debug_mesh(data=2, device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_debug_mesh(data=2, model=2, device="cpu")
    m = tmesh.make_stacked_mesh(data=2, pods=2, device="cpu")
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 2, "model": 1} and m.size == 4
    assert m.members("pod", 1) == [1, 3] and m.members("data", 3) == [2, 3]
    opt = cases.opt()
    with pytest.raises(ValueError, match="2 pods"):
        steps.make_train_step(cfg, opt, pod_wire="u16")
    with pytest.raises(ValueError, match="2 pods"):
        steps.make_train_step(cfg, opt, pod_wire="u16", mesh=(
            tmesh.make_stacked_mesh(data=2, device="cpu")))
    with pytest.raises(ValueError, match="pick one"):
        steps.make_train_step(cfg, opt, pod_wire="u8", mesh=m,
                              grad_compression=10)
    with pytest.raises(ValueError, match="each shard needs the same rows"):
        Trainer(cfg, opt, dataclasses.replace(cases.tcfg(4, 1, str(tmp_path)),
                                              global_batch=6),
                mesh=tmesh.make_stacked_mesh(data=4, device="cpu"))
    assert [len(b) for b in steps.buckets(adamw.zero_layout(
        cfg, m), limit=1)] == [1] * len(adamw.zero_layout(cfg, m))


def test_launch_train_data_axis_two_on_the_cpu(tmp_path, capsys):
    hist = launch_train.main(["--arch", cases.ARCH, "--reduce", "--device",
                              "cpu", "--data-axis", "2", "--steps", "2",
                              "--seq-len", "16", "--global-batch", "4",
                              "--ckpt-every", "2", "--ckpt-dir",
                              str(tmp_path)])
    out = capsys.readouterr().out
    assert "2 ranks: gloo, on the CPU" in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert ckpt.CheckpointManager(str(tmp_path)).steps() == [2]
