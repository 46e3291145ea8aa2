"""The shard mesh: the device axis the distributed layer partitions
matrices across (the port of ``repro.parallel.sharding``'s
``make_shard_mesh``).

The reference is single-controller: one process jits one ``shard_map``
over a 1-D mesh of local devices, and on the CPU its tests get several
devices from ``XLA_FLAGS=--xla_force_host_platform_device_count=N``. The
port keeps that shape: a :class:`ShardMesh` is a list of devices in one
process, and the list may repeat a device. Repeating a device is the
port's form of the XLA flag: ``devices=["cuda:0"] * 4`` places four shards
on one card (or ``["cpu"] * 4`` on the host), and the distributed layer
runs their blocks, the halo exchange and the reductions there.

A mesh whose shards sit on more than one device (one shard per GPU, with
peer copies or NCCL between them) is not ported: it raises
``NotImplementedError`` naming the ROADMAP item that tracks it.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _device

#: where the mesh over several devices is tracked
MULTI_DEVICE = ("ROADMAP.md queue 1: a shard mesh over several devices "
                "(one shard per GPU) waits for a machine with more than "
                "one card")


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
                f"shard mesh over {sorted({str(d) for d in devs})}: "
                f"{MULTI_DEVICE}; place every shard on one device "
                f"(devices=[dev] * n)")
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
