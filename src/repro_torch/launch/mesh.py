"""Mesh builders: the port of the reference's ``launch/mesh.py``.

The reference builds its production mesh over TPU pods (16 × 16 chips in
``("data", "model")``, or 2 × 16 × 16 with a leading ``"pod"`` axis) and
a debug mesh over the local devices. The port has three meshes:

* :class:`Mesh`, the one-device 1 × 1 mesh (``make_debug_mesh()`` with
  no process group): every single-process caller, as before.
* :class:`ProcessMesh`, the data-parallel axes across processes:
  ``("data", "model")``, or ``("pod", "data", "model")`` with a leading pod
  axis, over a ``torch.distributed`` process group of ``pods × data``
  ranks, one data-parallel shard per rank (NCCL with one GPU per rank,
  gloo on the CPU or with ranks sharing a card). The rank knows its
  shard (its rank in the group; pods outermost) and holds the group's
  :class:`~..parallel.sharding.RankMesh`, on which
  :mod:`..parallel.collectives` run. An exchange along the pod or data
  axis runs over the whole group with zero-size chunks to the ranks off
  the axis, so an axis needs no process group of its own (and none is
  made: a subgroup made by its members alone hangs gloo where other
  groups were made before it).
* :class:`StackedMesh`, the same shards in one process, one after
  another: the bit reference every rank run is held to, as the stacked
  ``[P, ...]`` form is for the solve path.

Both multi-shard meshes offer the two exchanges the training step is
written in, over lists with one entry per shard this process holds
(``local``): :meth:`~ProcessMesh.all_to_all` and
:meth:`~ProcessMesh.all_gather` along ``"dp"``, ``"pod"`` or ``"data"``.
The rank form calls the collectives; the stacked form moves the rows in
memory. On them sit the reduce-scatter (the rows summed by
:func:`~..parallel.collectives.shard_sum`, in rank order), ``pmax`` and
:func:`all_sum`, one code for both forms.

Not copied yet (:data:`~..parallel.sharding.MULTI_DEVICE`): a model axis
other than 1 and the production mesh (model = 16) raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _device
from ..parallel import collectives as co
from ..parallel.sharding import MULTI_DEVICE

#: the exchanges' axes: the whole data-parallel domain, then each axis
AXES = ("dp", "pod", "data")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of devices: ``devices`` nested ``shape[0]`` ×
    ``shape[1]``, one axis per name in ``axis_names``."""

    axis_names: tuple
    devices: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names,
                        (len(self.devices), len(self.devices[0]))))

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


@dataclasses.dataclass(frozen=True)
class _DataMesh:
    """``pods × data`` data-parallel shards (model = 1) on ``device``;
    shard ``s`` sits at pod ``s // data``, data index ``s % data``."""

    pods: int
    data: int
    device: torch.device

    @property
    def axis_names(self) -> tuple:
        return (("pod",) if self.pods > 1 else ()) + ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names,
                        ((self.pods,) if self.pods > 1 else ())
                        + (self.data, 1)))

    @property
    def size(self) -> int:
        """The number of data-parallel shards."""
        return self.pods * self.data

    def members(self, axis: str, index: int) -> list:
        """The shards along ``axis`` through shard ``index``, in axis
        order."""
        D = self.data
        if axis == "dp":
            return list(range(self.size))
        if axis == "data":
            return [index // D * D + d for d in range(D)]
        if axis == "pod":
            return [p * D + index % D for p in range(self.pods)]
        raise ValueError(f"axis {axis!r} not in {AXES}")

    def axis_size(self, axis: str) -> int:
        return {"dp": self.size, "pod": self.pods, "data": self.data}[axis]

    def reduce_scatter(self, axis: str, xs: list) -> list:
        """Row ``i`` of every member's ``xs[s]`` (``[n, ...]``) summed over
        the members in rank order, for the member ``i`` along ``axis``:
        :meth:`all_to_all`, then ``collectives.shard_sum``."""
        return [co.shard_sum(r) for r in self.all_to_all(axis, xs)]

    def pmax(self, axis: str, xs: list) -> list:
        """The largest of the members' scalars ``xs[s]`` along ``axis``
        (exact in any order)."""
        return [g.amax() for g in self.all_gather(axis, [x.reshape(1)
                                                         for x in xs])]


@dataclasses.dataclass(frozen=True)
class StackedMesh(_DataMesh):
    """Every shard in this process (module docstring)."""

    @property
    def local(self) -> list:
        return list(range(self.size))

    @property
    def lead(self) -> bool:
        """Whether this process logs and writes checkpoints."""
        return True

    def all_to_all(self, axis: str, xs: list) -> list:
        """``xs[s]`` ``[n, ...]`` per shard; shard s gets row ``i`` of every
        member's, where ``i`` is its place along ``axis``."""
        out = [None] * self.size
        for s in self.local:
            mem = self.members(axis, s)
            i = mem.index(s)
            out[s] = torch.stack([xs[q][i] for q in mem])
        return out

    def all_gather(self, axis: str, xs: list) -> list:
        """Every member's ``xs[q]`` stacked in axis order, one tensor per
        group of members (shared by them)."""
        out = [None] * self.size
        for s in self.local:
            if out[s] is None:
                mem = self.members(axis, s)
                st = torch.stack([xs[q] for q in mem])
                for q in mem:
                    out[q] = st
        return out


@dataclasses.dataclass(frozen=True)
class ProcessMesh(_DataMesh):
    """This process's shard of a mesh over a process group (module
    docstring): ``index`` is its data-parallel shard, ``rank_mesh`` the
    :class:`~..parallel.sharding.RankMesh` of the whole group."""

    index: int = 0
    rank_mesh: object = None

    @property
    def local(self) -> list:
        return [self.index]

    @property
    def lead(self) -> bool:
        return self.index == 0

    @property
    def backend(self) -> str:
        return self.rank_mesh.backend

    def all_to_all(self, axis: str, xs: list) -> list:
        return [co.all_to_all(xs[0], self.rank_mesh,
                              self.members(axis, self.index))]

    def all_gather(self, axis: str, xs: list) -> list:
        return [co.all_gather(xs[0], self.rank_mesh,
                              self.members(axis, self.index))]


def all_sum(mesh, axis: str, xs: list) -> list:
    """The sum of every member's ``xs[s]`` along ``axis`` in rank order, on
    every member (an all-reduce made of a reduce-scatter and an
    all-gather of equal flat chunks, never ``all_reduce``); ``xs``: one
    tensor per shard this process holds, all of one shape."""
    n = mesh.axis_size(axis)
    shape, numel = xs[0].shape, xs[0].numel()
    pad = -numel % n
    flats = [torch.nn.functional.pad(x.reshape(-1), (0, pad)).reshape(n, -1)
             for x in xs]
    return [g.reshape(-1)[:numel].reshape(shape)
            for g in mesh.all_gather(axis, mesh.reduce_scatter(axis, flats))]


def make_production_mesh(*, multi_pod: bool = False):
    shape = "2x16x16" if multi_pod else "16x16"
    raise NotImplementedError(
        f"the production mesh ({shape} chips) spans several devices with a "
        f"model axis of 16: "
        f"{MULTI_DEVICE}; a launcher cell runs on one device "
        "(make_debug_mesh())")


def _process_mesh(pods: int, data: int, group, device) -> ProcessMesh:
    """The :class:`ProcessMesh` of this rank over ``group``."""
    import torch.distributed as dist

    from ..parallel.sharding import make_rank_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {pods}x{data}x1 (pod, data, model) mesh runs one process per "
            f"shard and needs an initialised process group of {pods * data} "
            "ranks (torch.distributed.init_process_group, or "
            "parallel.launch.spawn_ranks)")
    base = make_rank_mesh(group, axis_name="dp", device=device)
    if base.size != pods * data:
        raise ValueError(f"a {pods}x{data}x1 mesh needs {pods * data} ranks, "
                         f"the process group has {base.size}")
    return ProcessMesh(pods, data, base.device, index=base.rank,
                       rank_mesh=base)


def make_debug_mesh(*, data: int = 1, model: int = 1, pods: int = 1,
                    device=None, group=None):
    """The mesh of ``pods × data × model`` shards. With no ``group`` and one
    shard: the one-device :class:`Mesh` on ``device`` (None: the GPU).
    Else a :class:`ProcessMesh` over ``group`` (None: the default process
    group, which must be initialised and hold ``pods × data`` ranks), this
    rank's tensors on ``device`` (:func:`~..parallel.sharding.
    make_rank_mesh`'s rule). ``model`` other than 1 raises."""
    if model != 1:
        raise NotImplementedError(
            f"a {data}x{model} (data, model) mesh: {MULTI_DEVICE}")
    if min(data, pods) < 1:
        raise ValueError(f"data={data}, pods={pods}: each must be >= 1")
    if group is None and data * pods == 1:
        dev = _device.resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh(("data", "model"), ((dev,),))
    return _process_mesh(pods, data, group, device)


def make_stacked_mesh(*, data: int = 1, pods: int = 1,
                      device=None) -> StackedMesh:
    """``pods × data`` shards in this process on ``device`` (None: the
    GPU): the stacked form of :class:`ProcessMesh`."""
    if min(data, pods) < 1:
        raise ValueError(f"data={data}, pods={pods}: each must be >= 1")
    dev = _device.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return StackedMesh(pods, data, dev)
