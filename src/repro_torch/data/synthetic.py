"""Deterministic synthetic token pipeline (the training-data substrate).

The port of ``repro.data.synthetic``, numpy and bit for bit: batch ``t``
is a pure function of ``(seed, t)`` through counter-based Philox streams,
so the stream's only state is the step, and any worker regenerates any
batch. Tokens follow an order-1 Markov chain whose successor table comes
from the seed (``branch`` likely successors per token plus a uniform
tail of mass ``noise``), so a model that learns the table goes below the
uniform entropy ``ln(vocab)``: a learning curve that can fail.

``next_batch(device)`` gives the global batch as tensors on one device.
On a mesh of data-parallel shards (``launch.mesh``) ``next_placed_batch``
gives each shard this process holds only its own rows, generated alone,
as the reference's per-shard callback does: :func:`place_batch` places
them by the batch spec of ``launch.steps.batch_spec_tree``, so shard
``r`` of ``P`` gets rows ``[r B / P, (r + 1) B / P)`` of the global
batch (all of them where ``P`` does not divide ``B``, the spec's
sanitising rule).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 4          # likely successors per token
    noise: float = 0.05      # probability mass on the uniform tail
    bos: int = 0


def markov_table(cfg: DataConfig) -> np.ndarray:
    """[vocab, branch] int64 successor table, derived from the seed."""
    rng = np.random.Generator(np.random.Philox(key=cfg.seed))
    return rng.integers(0, cfg.vocab, size=(cfg.vocab, cfg.branch),
                        dtype=np.int64)


def _gen_rows(cfg: DataConfig, table: np.ndarray, step: int,
              row_lo: int, row_hi: int) -> np.ndarray:
    """Rows [row_lo, row_hi) of global batch ``step`` (int64
    [rows, seq_len+1]): counter-based, so any shard is independently
    reproducible."""
    nrows = row_hi - row_lo
    # one Philox stream per (step, row): key = (seed, step, row)
    out = np.empty((nrows, cfg.seq_len + 1), dtype=np.int64)
    for i, r in enumerate(range(row_lo, row_hi)):
        rng = np.random.Generator(
            np.random.Philox(key=(cfg.seed + 1) * 1_000_003 + step,
                             counter=np.array([r, 0, 0, 0], np.uint64)))
        u = rng.random(cfg.seq_len + 1)
        pick = rng.integers(0, cfg.branch, size=cfg.seq_len + 1)
        unif = rng.integers(0, cfg.vocab, size=cfg.seq_len + 1)
        toks = np.empty(cfg.seq_len + 1, dtype=np.int64)
        toks[0] = cfg.bos
        for t in range(1, cfg.seq_len + 1):
            if u[t] < cfg.noise:
                toks[t] = unif[t]
            else:
                toks[t] = table[toks[t - 1], pick[t]]
        out[i] = toks
    return out


class SyntheticTokenStream:
    """Batch ``t`` = f(seed, t). ``state()``/``restore()`` are just the step
    counter; the stream is identical across restarts and worker counts."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.table = markov_table(cfg)
        self._step = 0

    # -- checkpointable iterator state -----------------------------------
    def state(self) -> dict:
        return {"step": self._step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "data seed mismatch"
        self._step = int(state["step"])

    # -- batch generation -------------------------------------------------
    def batch_rows(self, step: int, row_lo: int, row_hi: int) -> dict:
        rows = _gen_rows(self.cfg, self.table, step, row_lo, row_hi)
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
            "mask": np.ones((row_hi - row_lo, self.cfg.seq_len), np.float32),
        }

    def next_host_batch(self) -> dict:
        """Full global batch as host numpy (single-process path)."""
        b = self.batch_rows(self._step, 0, self.cfg.global_batch)
        self._step += 1
        return b

    def next_placed_batch(self, mesh) -> list:
        """The next global batch's rows of each shard this process holds
        (``mesh.local``), one dict of tensors on ``mesh.device`` per shard;
        each shard's rows are generated alone."""
        step = self._step
        self._step += 1
        return [place_batch(lambda lo, hi: self.batch_rows(step, lo, hi),
                            self.cfg.global_batch, mesh, s)
                for s in mesh.local]

    def next_batch(self, device=None) -> dict:
        """The next global batch as tensors on ``device`` (None: the GPU)."""
        dev = _device.resolve_device(device)
        return {k: torch.from_numpy(v).to(dev)
                for k, v in self.next_host_batch().items()}


def place_batch(row_fn, global_batch: int, mesh, index: int) -> dict:
    """The rows of data-parallel shard ``index`` of ``mesh`` under the
    batch spec (``launch.steps.batch_spec_tree``, sanitised for the mesh),
    ``row_fn(lo, hi) -> {name: array}`` generating only them, as tensors
    on ``mesh.device``."""
    from ..parallel.sharding import sanitize_spec, shard_range

    (entry,) = sanitize_spec((("pod", "data"),), (global_batch,), mesh)
    lo, hi = (shard_range(global_batch, entry, mesh, index)
              if entry is not None else (0, global_batch))
    return {k: torch.from_numpy(v).to(mesh.device)
            for k, v in row_fn(lo, hi).items()}
