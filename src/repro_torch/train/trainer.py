"""The training loop: data + step + checkpoints + fault handling.

The port of ``repro.train.trainer``. On one device (``device=``; None is
the GPU, and raises without one) the state is a float32 master, m and v
(``optim.adamw.TrainState``) on the device; each step runs eagerly
(``launch.steps.make_train_step``, the reference's jitted step), reads
its loss back to the host (the reference's ``device_get``), checks the
preemption flag and the straggler monitor, and every ``ckpt_every``
steps writes a checkpoint in the reference's layout
(``train.checkpoint``, with the reference's ZeRO specs), from which a new
trainer on the same directory goes on. With ``grad_compression`` the
step quantizes each gradient to E8M<bits> with error feedback before the
update (the reference's ``shard_map`` step over one data shard, whose sum
is the identity).

**The data-parallel axes.** With ``data_axis × pods`` > 1, or a mesh
passed in, the trainer runs on a mesh of data-parallel shards
(``launch.mesh``): a ``ProcessMesh`` (one rank per shard; without a mesh
it is built over the initialised default process group) or its stacked
form (every shard in this process, the bit reference). The state is a
``ZeroState`` (``m`` and ``v`` sliced by the ZeRO specs), each shard takes
its own rows of every batch (``next_placed_batch``), the step is the ZeRO
step of ``launch.steps`` (compressed over the data axes with
``grad_compression``, across pods with ``pod_wire``), and the loss is the
rank-order mean. Only the lead rank logs and writes checkpoints (``m``
and ``v`` gathered whole first, every rank taking part); the straggler
monitor runs on every rank and reports on the lead; the lead's
preemption flag is shared with every rank each step, so all ranks stop
after the same step and no rank waits in a collective the others left.
A restore takes the master whole and each shard's slices of ``m`` and
``v`` by this mesh's ZeRO specs, whatever mesh wrote the checkpoint.

**The model axis.** With ``model_axis`` > 1 the mesh gains a model axis
(``pods × data_axis × model_axis`` shards, the model index innermost) and
the step is tensor-parallel (``models.tensor_parallel``): the model shards
of one data shard read the same rows; each shard's ``ZeroState`` master
is a list of its pieces of the leaves, and m and v its ZeRO slices of
them. A checkpoint holds the reference's whole leaves (gathered over both
axes before the lead writes), so it restores on any (data, model) shape,
and in either package. With ``pods=2`` and ``pod_wire`` the pieces'
gradients cross the pods through the wire (``launch.steps``). With
``grad_compression`` the step is the reference's compressed one,
replicated over ``"model"``: every model shard holds the whole master
(a ``ZeroState`` as on the data axes alone, m and v sliced over the data
shards) and the model shards of one data shard stay bit-equal.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable

import torch

from .. import _device
from ..data import DataConfig, SyntheticTokenStream
from ..launch import steps
from ..launch.mesh import Mesh, ProcessMesh, make_debug_mesh
from ..models import tensor_parallel as tp
from ..models import transformer as tfm
from ..models.config import ModelConfig
from ..optim import OptConfig, TrainState, adamw, apply_updates, init_state
from ..optim.compression import compressed_psum
from ..parallel import collectives as co
from .checkpoint import (CheckpointManager, flatten_with_paths,
                         restore_resharded, unflatten)
from .fault import PreemptionGuard, StepMonitor


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    # data
    seq_len: int = 256
    global_batch: int = 8
    # distribution
    data_axis: int = 1            # debug-mesh DP size (examples/tests)
    model_axis: int = 1
    pods: int = 1                 # a leading pod axis (the port's knob)
    pod_wire: str | None = None   # 'u16' | 'u8' across the pods
    # gradient accumulation: microbatch size per step (None = full batch)
    microbatch: int | None = None
    # fault tolerance
    straggler_threshold: float = 2.0
    # gradient compression (None = off; int = E8M<bits> mantissa)
    grad_compression: int | None = None


def state_leaves(state: TrainState) -> dict:
    """The checkpoint's leaves of a train state: ``{path: tensor}`` with
    the reference's paths (``0`` the step, ``1/...`` the master, ``2/...``
    m, ``3/...`` v, the blocks stacked)."""
    return flatten_with_paths((state.step,) + tuple(
        tfm.to_reference_params(t, host=False)
        for t in (state.master, state.m, state.v)))


def state_specs(cfg: ModelConfig, data_size: int = 1) -> dict:
    """The checkpoint's specs, as the reference's trainer writes them: the
    step replicated, master, m and v by their ZeRO specs at ``data_size``
    (``{path: spec}``, :func:`state_leaves`' paths)."""
    params, specs = tfm.abstract_params(cfg)
    z = adamw.zero_spec_tree(specs, adamw.leaf_shapes(params), data_size)
    out = {"0": ()}
    for i in (1, 2, 3):
        out.update({f"{i}/" + "/".join(k): v for k, v in z.items()})
    return out


def _tree(layout: list, leaves: list) -> dict:
    """The reference's nested tree of ``leaves`` (one per layout leaf)."""
    tree = {}
    for leaf, t in zip(layout, leaves):
        *head, last = leaf.key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptConfig,
                 tcfg: TrainerConfig, *, device=None, mesh=None,
                 log_fn: Callable[[str], None] = print):
        self.cfg = model_cfg
        self.opt = opt_cfg
        self.tcfg = tcfg
        self.log = log_fn
        if mesh is None and tcfg.data_axis * tcfg.pods * tcfg.model_axis > 1:
            mesh = make_debug_mesh(data=tcfg.data_axis, pods=tcfg.pods,
                                   model=tcfg.model_axis, device=device)
        if isinstance(mesh, Mesh):
            device = mesh.devices[0][0] if device is None else device
            mesh = None
        self.mesh = mesh
        if self.mesh is not None and (
                self.mesh.data, self.mesh.pods, self.mesh.model) != (
                tcfg.data_axis, tcfg.pods, tcfg.model_axis):
            raise ValueError(
                f"a {self.mesh.pods}x{self.mesh.data}x{self.mesh.model} (pod, "
                f"data, model) mesh for pods={tcfg.pods}, data_axis="
                f"{tcfg.data_axis}, model_axis={tcfg.model_axis}")
        self.dev = (self.mesh.device if self.mesh is not None
                    else _device.resolve_device(device))
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.monitor = StepMonitor(threshold=tcfg.straggler_threshold)
        self.data = SyntheticTokenStream(DataConfig(
            vocab=model_cfg.vocab, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))
        self.history: list[dict] = []
        #: the error-feedback buffers after the last step of ``run`` (with
        #: ``grad_compression``; per shard held on a mesh), else None
        self.errors = None
        if self.mesh is not None:
            self._step_fn = self._make_mesh_step()
        elif tcfg.pod_wire is not None:
            raise ValueError("pod_wire needs a mesh of 2 pods (pods=2)")
        else:
            self._step_fn = (self._make_step()
                             if tcfg.grad_compression is None
                             else self._make_compressed_step())
        self.specs = state_specs(model_cfg, tcfg.data_axis)

    @property
    def lead(self) -> bool:
        """Whether this process logs and writes the checkpoints."""
        return self.mesh is None or self.mesh.lead

    # ------------------------------------------------------------------
    def _make_step(self):
        mb, gb = self.tcfg.microbatch, self.tcfg.global_batch
        if mb is not None and (gb % mb != 0 or mb >= gb):
            raise ValueError(f"microbatch {mb} must divide global batch "
                             f"{gb} and be smaller")
        return steps.make_train_step(self.cfg, self.opt, microbatch=mb)

    def _make_mesh_step(self):
        """The ZeRO step over the mesh's data-parallel shards, each shard's
        microbatch ``microbatch / P`` rows."""
        P, gb, mb = self.mesh.dp_size, self.tcfg.global_batch, \
            self.tcfg.microbatch
        if gb % P:
            raise ValueError(f"global batch {gb} over {P} data-parallel "
                             "shards: each shard needs the same rows")
        if mb is not None and (gb % mb != 0 or mb >= gb or mb % P):
            raise ValueError(f"microbatch {mb} must divide global batch "
                             f"{gb}, be smaller, and split over {P} shards")
        return steps.make_train_step(
            self.cfg, self.opt, self.tcfg.pod_wire,
            None if mb is None else mb // P, mesh=self.mesh,
            grad_compression=self.tcfg.grad_compression)

    def _make_compressed_step(self):
        """The step with E8M<bits> gradient compression and error feedback
        (``compressed_psum`` over the one shard)."""
        cfg, opt, bits = self.cfg, self.opt, self.tcfg.grad_compression
        groups = tfm.reference_groups(tfm.Transformer(cfg, device="meta"))

        def train_step(state: TrainState, err, batch):
            loss, grads = steps.value_and_grad(cfg, state.master, batch)
            grads, err = compressed_psum(grads, err, bits)
            state = apply_updates(state, grads, opt, groups)
            return state, err, {"loss": loss}

        return train_step

    # ------------------------------------------------------------------
    def _template(self) -> dict:
        meta = tfm.Transformer(self.cfg, dtype=torch.float32, device="meta")
        tree = tfm.to_reference_params(meta, host=False)
        return flatten_with_paths(
            (torch.empty((), dtype=torch.int32, device="meta"),
             tree, tree, tree))

    def init_or_restore(self):
        latest = self.ckpt.latest_step()
        if latest is not None and self.mesh is not None:
            return self._restore_mesh()
        if latest is not None:
            arrays, meta = self.ckpt.restore(self._template(),
                                             device=self.dev)
            master, m, v = (tfm.load_reference_params(
                self.cfg, unflatten(arrays, str(i)), device=self.dev,
                dtype=torch.float32) for i in (1, 2, 3))
            master.requires_grad_(True)
            self.data.restore(meta["extra"]["data_state"])
            self.log(f"[trainer] restored step {meta['step']} "
                     f"from {self.tcfg.ckpt_dir}")
            return TrainState(arrays["0"], master, m, v)
        return self.initial_state(tfm.init_params(self.cfg, self.tcfg.seed,
                                                  device=self.dev))

    def initial_state(self, params):
        """The step-0 state of ``params`` (a ``Transformer``) for this
        trainer: a ``TrainState``, or on a mesh a ``ZeroState`` sliced by
        its ZeRO layout."""
        if self.mesh is not None:
            return steps.init_mesh_state(self._step_fn, params, self.mesh)
        return init_state(params)

    @property
    def model_sharded(self) -> bool:
        """Whether the state is split over a model axis (the
        tensor-parallel step; the compressed step holds the whole model on
        every model shard)."""
        return steps.tensor_parallel(self._step_fn)

    def _restore_mesh(self):
        """The latest checkpoint on the mesh: the step and the master
        whole, each held shard's slices of m and v by this mesh's ZeRO
        specs (``train.checkpoint.restore_resharded``)."""
        layout, template = self._step_fn.layout, self._template()
        arrays, meta = self.ckpt.load_raw()
        if self.model_sharded:
            whole = restore_resharded(template, arrays, meta, mesh=self.mesh,
                                      specs={k: () for k in template})
            self.data.restore(meta["extra"]["data_state"])
            if self.lead:
                self.log(f"[trainer] restored step {meta['step']} "
                         f"from {self.tcfg.ckpt_dir}")
            return tp.restore(self.mesh, self._step_fn.ctx.layout, layout,
                              whole)
        moment = {k: v for k, v in template.items()
                  if k.startswith(("2/", "3/"))}
        # each shard's slices over the data-parallel shards alone: over a
        # model axis the compressed step holds the leaves whole
        zspecs = {f"{i}/{leaf.key}": tuple(
            adamw.ZERO_ENTRY if d == leaf.dim else None
            for d in range(len(leaf.shape))) for leaf in layout
            for i in (2, 3)}
        m, v = [], []
        for s in self.mesh.local:
            got = restore_resharded(moment, arrays, meta, mesh=self.mesh,
                                    index=s, specs=zspecs)
            m.append([got[f"2/{leaf.key}"] for leaf in layout])
            v.append([got[f"3/{leaf.key}"] for leaf in layout])
        rest = {k: v for k, v in template.items() if k not in moment}
        whole = restore_resharded(rest, arrays, meta, mesh=self.mesh,
                                  specs={k: () for k in rest})
        master = tfm.load_reference_params(
            self.cfg, unflatten(whole, "1"), device=self.dev,
            dtype=torch.float32)
        master.requires_grad_(True)
        self.data.restore(meta["extra"]["data_state"])
        if self.lead:
            self.log(f"[trainer] restored step {meta['step']} "
                     f"from {self.tcfg.ckpt_dir}")
        return adamw.ZeroState(whole["0"], master, m, v)

    def _leaves(self, state) -> dict:
        """The checkpoint's leaves of ``state`` (on a mesh, m and v
        gathered whole: a collective every rank takes part in)."""
        if self.mesh is None:
            return state_leaves(state)
        layout, bks = self._step_fn.layout, self._step_fn.buckets
        if self.model_sharded:
            return tp.checkpoint_leaves(self.mesh, self._step_fn.ctx.layout,
                                        layout, state)
        m, v = (_tree(layout, adamw.gather_moments(self.mesh, layout, mo,
                                                   bks))
                for mo in (state.m, state.v))
        return flatten_with_paths((state.step, tfm.to_reference_params(
            state.master, host=False), m, v))

    def _save(self, state, step: int):
        leaves = self._leaves(state)
        if self.lead:
            info = self.ckpt.save(
                step, leaves, specs=self.specs,
                extra={"data_state": self.data.state(),
                       "model": self.cfg.name})
            self.log(f"[trainer] checkpoint step {step} "
                     f"({info['save_s']:.2f}s) -> {info['path']}")
        del leaves
        if self.mesh is not None:
            # no rank reads the directory before the lead has committed
            self._shared(0.0)

    def _shared(self, value: float) -> float:
        """The lead shard's ``value``, on every shard (a collective)."""
        if not isinstance(self.mesh, ProcessMesh):
            return value
        return float(co.gather_values([value], self.mesh.rank_mesh)[0, 0])

    # ------------------------------------------------------------------
    def run(self, state=None):
        tcfg = self.tcfg
        if state is None:
            state = self.init_or_restore()
        start = int(state.step)
        err = None
        if tcfg.grad_compression is not None:
            err = [torch.zeros_like(p, dtype=torch.float32)
                   for p in state.master.parameters()]
            if self.mesh is not None:
                err = [err] + [[torch.zeros_like(e) for e in err]
                               for _ in self.mesh.local[1:]]

        with PreemptionGuard() as guard:
            for step in range(start, tcfg.steps):
                self.monitor.start()
                if self.mesh is not None:
                    batch = self.data.next_placed_batch(self.mesh)
                    state, err, metrics = self._step_fn(state, err, batch)
                else:
                    batch = self.data.next_batch(self.dev)
                    if tcfg.grad_compression is None:
                        state, metrics = self._step_fn(state, batch)
                    else:
                        state, err, metrics = self._step_fn(state, err,
                                                            batch)
                loss = float(metrics["loss"])
                ev = self.monitor.stop(step)
                if ev is not None and self.lead:
                    self.log(f"[straggler] step {ev.step}: "
                             f"{ev.step_time:.3f}s = {ev.ratio:.1f}x "
                             f"EWMA {ev.ewma:.3f}s"
                             + ("  -> exclusion recommended"
                                if self.monitor.exclusion_recommended
                                else ""))
                rec = {"step": step + 1, "loss": loss}
                self.history.append(rec)
                if self.lead and ((step + 1) % tcfg.log_every == 0
                                  or step == start):
                    self.log(f"[train] step {step + 1:5d}  "
                             f"loss {loss:.4f}")
                if (step + 1) % tcfg.ckpt_every == 0:
                    self._save(state, step + 1)
                fired = guard.fired if self.mesh is None else bool(
                    self._shared(float(guard.fired)))
                if fired:
                    if self.lead:
                        self.log("[trainer] preemption signal — saving and "
                                 "exiting cleanly")
                    self._save(state, step + 1)
                    break
        self.errors = err
        return state

    def dump_history(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.history, f, indent=1)
