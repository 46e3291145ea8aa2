"""Checkpoints with atomic commit and keep-k retention, in the reference's
layout.

The port of ``repro.train.checkpoint``. One checkpoint::

    <dir>/step_<k>/
        metadata.json      # per-leaf dtype/shape/spec, step, extra
        arrays.npz         # one entry per leaf, keyed by its tree path

Leaves are keyed by their tree paths with ``__`` for ``/`` (a train state
``(step, master, m, v)`` gives ``0``, ``1__blocks__attn__wq__w``, ...;
``flatten_with_paths``), the blocks stacked ``[L, ...]``, as the
reference writes them: a checkpoint of either package restores in the
other. Everything is written into ``<dir>/.tmp_step_<k>`` and renamed
into place; ``latest_step`` sees committed directories only; older
checkpoints beyond ``keep`` go after a commit, never before.

**Elastic re-shard restore.** Leaves are stored as global arrays with
their logical spec (the trainer's ZeRO specs, ``optim.adamw.zero_spec``),
as the reference stores them. :func:`restore_resharded` places each leaf
on the current mesh (``launch.mesh``): every data-parallel shard takes
its slice by the stored spec, filtered and sanitised for that mesh
(``parallel.sharding.take_shard``), so a checkpoint written on P shards
restores on any other P, or on one device, and in the other package.
On a mesh, the leaves are gathered to every rank and only the lead rank
writes (``train.trainer``). A mesh with a model axis restores the whole
leaves (``specs`` of ``()``) and takes its own index sets of them
(``models.tensor_parallel.restore``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time

import numpy as np
import torch

_SEP = "/"


def flatten_with_paths(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of nested dicts (sorted keys, as ``jax.tree``
    orders them) and tuples or lists (their indices)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_with_paths(v, f"{prefix}{_SEP}{k}" if prefix
                                      else str(k)))
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict of the leaves under ``prefix`` (a path's first
    part) in ``{path: leaf}``."""
    out = {}
    for key, leaf in flat.items():
        parts = key.split(_SEP)
        if parts[0] != prefix or len(parts) == 1:
            continue
        node = out
        for k in parts[1:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = leaf
    return out


def _spec_to_json(spec) -> list:
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


def _spec_from_json(entries) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- discovery ---------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.isfile(
                    os.path.join(self.dir, name, "metadata.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, leaves: dict, extra: dict | None = None,
             specs: dict | None = None):
        """Write checkpoint ``step`` of ``leaves`` (``{path: tensor or
        array}``, :func:`flatten_with_paths`), each with its logical spec
        from ``specs`` (``{path: spec}``; replicated where missing)."""
        t0 = time.time()
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {k: _host(v) for k, v in leaves.items()}
        specs = specs or {}
        meta_leaves = {k: {"dtype": str(a.dtype), "shape": list(a.shape),
                           "spec": _spec_to_json(specs.get(k, ()))}
                       for k, a in arrays.items()}
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace(_SEP, "__"): v for k, v in arrays.items()})
        meta = {
            "step": step,
            "leaves": meta_leaves,
            "extra": extra or {},
            "time": time.time(),
        }
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)             # atomic commit
        self._prune()
        return {"save_s": time.time() - t0, "path": final}

    def _prune(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def load_raw(self, step: int | None = None) -> tuple[dict, dict]:
        """(arrays by path-key, metadata) for a committed step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k.replace("__", _SEP): z[k] for k in z.files}
        return arrays, meta

    def restore(self, template: dict, step: int | None = None, device=None,
                *, mesh=None, index: int | None = None,
                specs: dict | None = None):
        """(:func:`restore_resharded` of committed step ``step`` (None: the
        latest), metadata)."""
        arrays, meta = self.load_raw(step)
        return restore_resharded(template, arrays, meta, mesh=mesh,
                                 device=device, index=index,
                                 specs=specs), meta


def restore_resharded(template: dict, arrays: dict, meta: dict, mesh=None,
                      *, device=None, index: int | None = None,
                      specs: dict | None = None) -> dict:
    """``{path: tensor}`` for every leaf of ``template`` (``{path:
    tensor}``, whose shapes and dtypes are wanted; the meta device will
    do) from the stored global ``arrays``: on ``device`` (None: the host;
    ``mesh.device`` on a mesh) and, on a mesh of data-parallel shards,
    the block data-parallel shard ``index`` (None: this process's first,
    ``mesh.local[0]``) holds under the leaf's stored spec (or ``specs[path]``
    where given), filtered and sanitised for ``mesh``."""
    from ..parallel.sharding import take_shard

    sharded = mesh is not None and hasattr(mesh, "local")
    if sharded:
        device = mesh.device if device is None else device
        index = mesh.local[0] if index is None else index
    out = {}
    for key, leaf in template.items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"template {tuple(leaf.shape)}")
        if sharded:
            spec = (specs[key] if specs is not None and key in specs
                    else _spec_from_json(meta["leaves"][key]["spec"]))
            arr = np.ascontiguousarray(take_shard(arr, spec, mesh, index))
        out[key] = torch.as_tensor(arr).to(device=device, dtype=leaf.dtype)
    return out
