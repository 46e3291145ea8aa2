"""The reference side of ``tests/test_torch_production_mesh.py``, run in a
subprocess with eight XLA host devices:

    python torch_production_mesh_reference.py ROOT PART STEPS

``PART``: ``comp:FAMILIES`` (the compressed ``Trainer`` at (data 2, model
2) for the comma-separated families, with every device's error-feedback
buffers after the last step), ``wire:WIRE`` (``make_train_step(
pod_wire=WIRE)`` on (pod 2, data 1, model 2)), ``hlo:MESH``
(``hlo_cost`` of the compiled train step on the ``2x2`` or ``2x2x2``
mesh), ``serve:MESH`` (``hlo_cost`` of the compiled prefill and decode
steps there, the six families) or ``decode:INPUTS`` (``forward_prefill``
and ``TICKS`` greedy ``forward_decode`` steps of the six families on one
device, from the prompts in the npz ``INPUTS``: their logits and tokens).
Writes each run's master (and error buffers, or logits) to
``ROOT/ref_<PART>.npz`` (``:`` and ``,`` as ``_``; ``decode:INPUTS``'s
to ``ROOT/ref_decode.npz``) and prints its losses and counts as one JSON
line.
"""
import dataclasses
import json
import sys

import numpy as np, jax
from repro import configs
from repro.data.synthetic import DataConfig, SyntheticTokenStream
from repro.launch import steps as rsteps
from repro.models import transformer as rtfm
from repro.models.config import ShapeConfig
from repro.optim import adamw as radamw
from repro.train import checkpoint as rckpt, trainer as rtrainer
root, part, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
FAM = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b",
       "ssm": "mamba2-1.3b", "hybrid": "zamba2-2.7b"}
#: the six families of the serving parts
SERVE_FAM = {**FAM, "vlm": "llava-next-mistral-7b",
             "encdec": "seamless-m4t-large-v2"}
#: the serving parts' shapes (``tests/test_torch_mesh_serve.py``): prefill
#: of 32 positions, decode into a cache of 64, 4 rows; the decode chain's
#: cache and steps
SERVE_SHAPES = (("prefill", 32), ("decode", 64))
SERVE_BATCH, MAX_LEN, TICKS = 4, 64, 4
opt = radamw.OptConfig(warmup=1, total_steps=steps)
out, meta = {}, {}


def mesh_of(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    n = int(np.prod(shape))
    return jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape))


def run_keeping_errors(t):
    """``t.run()`` and the error buffers its last step returned, as
    ``{(data, model): {leaf: array}}`` per device (the reference's
    ``Trainer`` drops them; its jitted step's outputs are recorded)."""
    last, jit = {}, jax.jit

    def recording(fn, **kw):
        inner = jit(fn, **kw)
        if fn != t._step_fn:
            return inner

        def call(*args):
            last["out"] = inner(*args)
            return last["out"]
        return call

    jax.jit = recording
    try:
        st = t.run()
    finally:
        jax.jit = jit
    where = {d: idx for idx, d in np.ndenumerate(t.mesh.devices)}
    errs = {}
    for k, leaf in rckpt.flatten_with_paths(last["out"][1]).items():
        for sh in leaf.addressable_shards:
            errs.setdefault(where[sh.device], {})[k] = np.asarray(sh.data)
    return st, errs


def keep(name, losses, master):
    meta[f"losses_{name}"] = losses
    for k, v in rckpt.flatten_with_paths(master).items():
        out[f"master_{name}/{k}"] = np.asarray(v)


if part.startswith("comp"):
    for fam in part.split(":")[1].split(","):
        t = rtrainer.Trainer(
            configs.reduce(configs.get(FAM[fam])), opt,
            rtrainer.TrainerConfig(steps=steps, ckpt_dir=f"{root}/c_{fam}",
                                   ckpt_every=100, log_every=100, seq_len=32,
                                   global_batch=8, data_axis=2, model_axis=2,
                                   grad_compression=10),
            mesh=mesh_of((2, 2)), log_fn=lambda s: None)
        st, errs = run_keeping_errors(t)
        keep(f"comp_{fam}", [h["loss"] for h in t.history], st.master)
        for (d, m), leaves in errs.items():
            for k, v in leaves.items():
                out[f"errors_comp_{fam}/{d}{m}/{k}"] = v
if part.startswith("wire"):
    for name, fam, w in (("wire_u16_dense", "dense", "u16"),
                         ("wire_u16_moe", "moe", "u16"),
                         ("wire_u8_dense", "dense", "u8"),
                         ("wire_u8_ssm", "ssm", "u8")):
        if w != part.split(":")[1]:
            continue
        rcfg = configs.reduce(configs.get(FAM[fam]))
        mesh = mesh_of((2, 1, 2))
        fn, _, _ = rsteps.make_train_step(rcfg, opt, pod_wire=w)
        st = radamw.init_state(rtfm.init_params(rcfg,
                                                jax.random.PRNGKey(0))[0])
        data = SyntheticTokenStream(DataConfig(vocab=rcfg.vocab, seq_len=32,
                                               global_batch=8, seed=0))
        losses = []
        with mesh:
            step = jax.jit(fn)
            for _ in range(steps):
                st, m = step(st, data.next_placed_batch(mesh))
                losses.append(float(m["loss"]))
        keep(name, losses, st.master)
if part.startswith("hlo"):
    # the reference's dry run asks XLA for 512 host devices on import
    from repro.launch import dryrun as rdry, hlo_cost as rhc
    # per-device dot FLOPs of the train step, lowered as the dry run
    # lowers it, with 64-bit types off (hlo_cost reads s32 trip counts)
    tag = part.split(":")[1]
    ms = tuple(int(n) for n in tag.split("x"))
    with jax.enable_x64(False):
        for fam, arch in FAM.items():
            rcfg = configs.reduce(configs.get(arch))
            if rcfg.family == "hybrid":
                rcfg = dataclasses.replace(rcfg, attn_every=1)
            with mesh_of(ms) as mesh:
                lowered = rdry._lower_cell(
                    rcfg, ShapeConfig("x", 32, 8, "train"), mesh)
                text = lowered.compile().as_text()
            meta[f"hlo_{fam}_{tag}"] = rhc.aggregate(text)["flops"]
if part.startswith("serve"):
    from repro.launch import dryrun as rdry, hlo_cost as rhc
    # per-device dot FLOPs of the prefill and decode steps, lowered as the
    # dry run lowers them (the hybrid's shared block at every layer)
    tag = part.split(":")[1]
    ms = tuple(int(n) for n in tag.split("x"))
    with jax.enable_x64(False):
        for fam, arch in SERVE_FAM.items():
            rcfg = configs.reduce(configs.get(arch))
            if rcfg.family == "hybrid":
                rcfg = dataclasses.replace(rcfg, attn_every=1)
            for kind, S in SERVE_SHAPES:
                with mesh_of(ms) as mesh:
                    lowered = rdry._lower_cell(
                        rcfg, ShapeConfig("x", S, SERVE_BATCH, kind), mesh)
                    text = lowered.compile().as_text()
                meta[f"hlo_{fam}_{kind}_{tag}"] = rhc.aggregate(text)["flops"]
if part.startswith("decode"):
    import jax.numpy as jnp
    io = np.load(part.split(":", 1)[1])
    for fam, arch in SERVE_FAM.items():
        rcfg = configs.reduce(configs.get(arch))
        p = rtfm.init_params(rcfg, jax.random.PRNGKey(0))[0]
        b = {k.split("/", 1)[1]: jnp.asarray(io[k]) for k in io.files
             if k.startswith(fam + "/")}
        logits, cache = rtfm.forward_prefill(rcfg, p, b, MAX_LEN)
        for i in range(TICKS + 1):
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            out[f"logits_{fam}/{i}"] = np.asarray(logits)
            out[f"tokens_{fam}/{i}"] = np.asarray(tok)
            if i < TICKS:
                logits, cache = rtfm.forward_decode(rcfg, p, tok[:, None],
                                                    cache)
        for k, v in cache.items():
            out[f"cache_{fam}/{k}"] = np.asarray(v)
name = part.split(":")[0] if part.startswith("decode") else part
np.savez(f"{root}/ref_{name.replace(':', '_').replace(',', '_')}.npz",
         **out)
print(json.dumps(meta))
