"""The training loop: data + step + checkpoints + fault handling.

The port of ``repro.train.trainer`` on one device (``device=``; None is
the GPU, and raises without one). The state is a float32 master, m and v
(``optim.adamw.TrainState``) on the device; each step runs eagerly
(``launch.steps.make_train_step``, the reference's jitted step), reads
its loss back to the host (the reference's ``device_get``), checks the
preemption flag and the straggler monitor, and every ``ckpt_every``
steps writes a checkpoint in the reference's layout
(``train.checkpoint``), from which a new trainer on the same directory
goes on. With ``grad_compression`` the step quantizes each gradient to
E8M<bits> with error feedback before the update (the reference's
``shard_map`` step over one data shard, whose sum is the identity).

Not copied: the mesh (``data_axis``/``model_axis`` other than 1 raise),
the ZeRO specs, and the placement of the batch over data shards.
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
from ..models import transformer as tfm
from ..models.config import ModelConfig
from ..optim import OptConfig, TrainState, apply_updates, init_state
from ..optim.compression import compressed_psum
from .checkpoint import CheckpointManager, flatten_with_paths, unflatten
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


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptConfig,
                 tcfg: TrainerConfig, *, device=None,
                 log_fn: Callable[[str], None] = print):
        if tcfg.data_axis != 1 or tcfg.model_axis != 1:
            raise NotImplementedError(
                f"data_axis={tcfg.data_axis}, model_axis={tcfg.model_axis}: "
                "more than one shard needs the multi-card mesh of the "
                "training side (data x model), which the port does not have "
                "yet")
        self.cfg = model_cfg
        self.opt = opt_cfg
        self.tcfg = tcfg
        self.log = log_fn
        self.dev = _device.resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.monitor = StepMonitor(threshold=tcfg.straggler_threshold)
        self.data = SyntheticTokenStream(DataConfig(
            vocab=model_cfg.vocab, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))
        self.history: list[dict] = []
        self._step_fn = (self._make_step() if tcfg.grad_compression is None
                         else self._make_compressed_step())

    # ------------------------------------------------------------------
    def _make_step(self):
        mb, gb = self.tcfg.microbatch, self.tcfg.global_batch
        if mb is not None and (gb % mb != 0 or mb >= gb):
            raise ValueError(f"microbatch {mb} must divide global batch "
                             f"{gb} and be smaller")
        return steps.make_train_step(self.cfg, self.opt, microbatch=mb)

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

    def init_or_restore(self) -> TrainState:
        latest = self.ckpt.latest_step()
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
        params = tfm.init_params(self.cfg, self.tcfg.seed, device=self.dev)
        return init_state(params)

    def _save(self, state: TrainState, step: int):
        info = self.ckpt.save(
            step, state_leaves(state),
            extra={"data_state": self.data.state(), "model": self.cfg.name})
        self.log(f"[trainer] checkpoint step {step} "
                 f"({info['save_s']:.2f}s) -> {info['path']}")

    # ------------------------------------------------------------------
    def run(self, state: TrainState | None = None) -> TrainState:
        tcfg = self.tcfg
        if state is None:
            state = self.init_or_restore()
        start = int(state.step)
        err = None
        if tcfg.grad_compression is not None:
            err = [torch.zeros_like(p, dtype=torch.float32)
                   for p in state.master.parameters()]

        with PreemptionGuard() as guard:
            for step in range(start, tcfg.steps):
                self.monitor.start()
                batch = self.data.next_batch(self.dev)
                if tcfg.grad_compression is None:
                    state, metrics = self._step_fn(state, batch)
                else:
                    state, err, metrics = self._step_fn(state, err, batch)
                loss = float(metrics["loss"])
                ev = self.monitor.stop(step)
                if ev is not None:
                    self.log(f"[straggler] step {ev.step}: "
                             f"{ev.step_time:.3f}s = {ev.ratio:.1f}x "
                             f"EWMA {ev.ewma:.3f}s"
                             + ("  -> exclusion recommended"
                                if self.monitor.exclusion_recommended
                                else ""))
                rec = {"step": step + 1, "loss": loss}
                self.history.append(rec)
                if (step + 1) % tcfg.log_every == 0 or step == start:
                    self.log(f"[train] step {step + 1:5d}  "
                             f"loss {loss:.4f}")
                if (step + 1) % tcfg.ckpt_every == 0:
                    self._save(state, step + 1)
                if guard.fired:
                    self.log("[trainer] preemption signal — saving and "
                             "exiting cleanly")
                    self._save(state, step + 1)
                    break
        return state

    def dump_history(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.history, f, indent=1)
