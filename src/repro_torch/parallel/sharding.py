"""The shard meshes: the device axis the distributed layer partitions
matrices across (the port of ``repro.parallel.sharding``'s
``make_shard_mesh``), in two forms.

The reference is single-controller: one process jits one ``shard_map``
over a 1-D mesh of local devices, and on the CPU its tests get several
devices from ``XLA_FLAGS=--xla_force_host_platform_device_count=N``.

* :class:`ShardMesh` keeps that shape in one process: a list of devices
  that must all be one device, named once per shard. ``devices=["cuda:0"]
  * 4`` places four shards on one card (or ``["cpu"] * 4`` on the host),
  and the distributed layer runs their blocks, the halo exchange and the
  reductions there on stacked ``[P, ...]`` tensors. It is the reference's
  layout, and the form every other form is held to.
* :class:`RankMesh` is PyTorch's way across GPUs: one process per shard
  over a ``torch.distributed`` process group (NCCL with one GPU per rank,
  gloo on the CPU or with ranks sharing a card), each rank holding its own
  ``[1, ...]`` row of every stacked operand. The collectives it runs are
  in :mod:`.collectives`, the launcher in :mod:`.launch`.

A :class:`ShardMesh` holds every shard on one device; one shard per GPU
is the rank mesh's job, so a ``ShardMesh`` over several devices is
refused with ``NotImplementedError`` that says so.

The training side's logical specs (the reference's ``PartitionSpec``s
over ``"pod"``, ``"data"`` and ``"model"``) are kept as data: a spec is a
tuple with one entry per dim, ``None``, an axis name or a tuple of names.
:func:`batch_axes`, :func:`filter_spec` and :func:`sanitize_spec` are the
reference's rules over a mesh's axes and sizes, and :func:`shard_range` /
:func:`take_shard` give the slice of a leaf that one shard of the
data-parallel axes holds under such a spec: the port's stand-in for
``named_sharding``/``tree_shardings_shaped``, as slicing rules rather than
GSPMD. A mesh here is anything with ``axis_names`` and a ``shape`` dict
(``launch.mesh``); a shard's ``"model"`` coordinate is its index modulo
the model size. The tensor-parallel layers keep their own slicing rules
(``models.tensor_parallel``). The training mesh runs one rank per shard
(``launch.mesh.make_debug_mesh`` over a process group) with every step of
the reference, the compressed ones too, as do the prefill and decode
(``models.tensor_parallel``, the KV cache over the model shards), and the
production mesh counts every cell per device on one rank of a meta
process group (``launch.mesh.make_production_mesh``): :data:`MULTI_DEVICE`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import _device

#: where the meshes over several devices stand
MULTI_DEVICE = ("training, prefill and decode run one rank per shard on the "
                "(\"pod\", \"data\", \"model\") mesh "
                "(launch.mesh.make_debug_mesh over a process group; "
                "models.tensor_parallel, the KV cache over the model "
                "shards), as the solve path does (parallel.sharding."
                "RankMesh); every train, prefill and decode cell of the "
                "production mesh is counted per device "
                "(launch.dryrun --both-meshes; ROADMAP.md, \"Where the port "
                "stands\")")

#: the data-parallel axes, outermost first
DP_AXES = ("pod", "data")


def batch_axes(mesh) -> tuple:
    """The data-parallel axes of ``mesh``: ``("pod", "data")`` on a
    multi-pod mesh, ``("data",)`` else, ``()`` without a mesh."""
    if mesh is None:
        return ()
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def filter_spec(spec, mesh) -> tuple:
    """``spec`` with the axis names ``mesh`` lacks dropped (an entry left
    with none is ``None``, with one the name, as ``PartitionSpec`` writes
    it), so one logical spec fits any mesh."""
    names = set(mesh.axis_names) if mesh is not None else set()

    def keep(entry):
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return (kept if len(kept) > 1 else kept[0]) if kept else None
        return entry if entry in names else None

    return tuple(keep(e) for e in spec)


def sanitize_spec(spec, shape, mesh) -> tuple:
    """:func:`filter_spec`, then no sharding on a dim the entry's axes do
    not divide evenly (the reference's rule for jit argument shardings);
    entries past ``len(shape)`` go."""
    sizes = mesh.shape
    out = []
    for i, e in enumerate(filter_spec(spec, mesh)[:len(shape)]):
        n = math.prod(sizes.get(a, 1) for a in _names(e))
        out.append(e if e is not None and shape[i] % n == 0 else None)
    return tuple(out)


def shard_coords(mesh, index: int) -> dict:
    """The ``("pod", "data", "model")`` coordinates of shard ``index``, pods
    outermost, the model index innermost (``index = (pod * data +
    data_index) * model + model_index``)."""
    d, m = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    q = index // m
    return {"pod": q // d, "data": q % d, "model": index % m}


def shard_range(size: int, entry, mesh, index: int) -> tuple:
    """``(lo, hi)``: the part of a dim of ``size`` that shard ``index``
    holds under the spec ``entry`` (its axes row-major, the first
    outermost)."""
    coords, sizes = shard_coords(mesh, index), mesh.shape
    k, n = 0, 1
    for a in _names(entry):
        k, n = k * sizes.get(a, 1) + coords.get(a, 0), n * sizes.get(a, 1)
    step = size // n
    return k * step, (k + 1) * step


def take_shard(x, spec, mesh, index: int):
    """The block of ``x`` (a tensor or array) that shard ``index`` holds
    under the logical ``spec``, sanitised for ``mesh``
    (a view where slicing gives one)."""
    for dim, e in enumerate(sanitize_spec(spec, tuple(x.shape), mesh)):
        if e is not None:
            lo, hi = shard_range(x.shape[dim], e, mesh, index)
            x = x[(slice(None),) * dim + (slice(lo, hi),)]
    return x


def _normal(device) -> torch.device:
    """A device with its index filled in (``cuda`` → ``cuda:0``), so that
    two names of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A 1-D mesh of ``len(devices)`` shards along ``axis_name``. Every
    shard must sit on one device (see the module docstring)."""

    devices: tuple
    axis_name: str = "shards"

    def __post_init__(self):
        devs = tuple(_normal(d) for d in self.devices)
        if not devs:
            raise ValueError("a shard mesh needs at least one device")
        if len(set(devs)) > 1:
            raise NotImplementedError(
                f"shard mesh over {sorted({str(d) for d in devs})}: a "
                f"ShardMesh holds every shard on one device "
                f"(devices=[dev] * n); for one shard per GPU run one "
                f"process per shard on a RankMesh (make_rank_mesh, "
                f"parallel.launch.spawn_ranks); {MULTI_DEVICE}")
        object.__setattr__(self, "devices", devs)

    @property
    def axis_names(self) -> tuple:
        return (self.axis_name,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard sits on."""
        return self.devices[0]


def make_shard_mesh(n_shards: int | None = None, *,
                    axis_name: str = "shards", devices=None,
                    device=None) -> ShardMesh:
    """1-D mesh over (the first ``n_shards``) of ``devices``. Without
    ``devices``: every visible CUDA device when ``device`` resolves to
    CUDA (``None`` means the GPU), or one ``cpu`` device when the caller
    asks for the CPU, as ``jax.device_count()`` is without the XLA flag.
    ``n_shards`` past the device count raises ``ValueError``."""
    if devices is not None:
        devs = list(devices)
    else:
        dev = _device.resolve_device(device)
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" else [dev])
    if n_shards is not None:
        if n_shards > len(devs):
            raise ValueError(f"n_shards={n_shards} > {len(devs)} devices "
                             f"(place n shards on one device with "
                             f"devices=[dev] * n)")
        devs = devs[:n_shards]
    return ShardMesh(tuple(devs), axis_name)


#: the backends a rank mesh runs on
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A 1-D mesh of ``size`` shards, one per process of a
    ``torch.distributed`` process group: this process is shard ``rank``
    and holds its tensors on ``device``. ``group`` is the process group
    (None: the default one); every collective of the mesh goes through
    :mod:`.collectives` on it."""

    group: object
    size: int
    rank: int
    device: torch.device
    backend: str
    axis_name: str = "shards"

    @property
    def axis_names(self) -> tuple:
        return (self.axis_name,)

    @property
    def stages(self) -> bool:
        """Whether collectives stage through host buffers: gloo's
        transport reads host memory, so a gloo mesh whose ranks hold CUDA
        tensors copies them to the host and back (four ranks sharing one
        card)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_rank_mesh(group=None, *, axis_name: str = "shards",
                   device=None) -> RankMesh:
    """The rank mesh of this process over ``group`` (None: the default
    process group, which must be initialised). Under NCCL the device is
    ``cuda:<local rank>`` (``LOCAL_RANK``, else the global rank modulo the
    visible cards), or the card ``device`` names; NCCL refuses a CPU
    device. Under gloo it is ``device``, or the CPU. Under NCCL the
    communicator is warmed up here, so that no graph captures its
    creation."""
    import os

    import torch.distributed as dist

    from . import collectives

    if not dist.is_initialized():
        raise RuntimeError("make_rank_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group, "
                           "or parallel.launch.spawn_ranks)")
    backend = str(dist.get_backend(group)).lower()
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    if backend == "nccl":
        if device is None:
            local = int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % max(
                    torch.cuda.device_count(), 1)))
            device = torch.device("cuda", local)
        dev = _normal(device)
        if dev.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {dev}")
        torch.cuda.set_device(dev)
    else:
        dev = _normal("cpu" if device is None else device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    mesh = RankMesh(group=group, size=dist.get_world_size(group), rank=rank,
                    device=dev, backend=backend, axis_name=axis_name)
    if backend == "nccl":
        collectives.warm_up(mesh)
    return mesh
