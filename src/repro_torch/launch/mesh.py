"""Mesh builders: the port of the reference's ``launch/mesh.py``.

The reference builds its production mesh over TPU pods (16 × 16 chips in
``("data", "model")``, or 2 × 16 × 16 with a leading ``"pod"`` axis) and
a debug mesh over the local devices. The port's training and serving
launchers run on one device: the debug mesh of size 1 × 1 is the only
mesh built here, and any other size, and the production mesh, raise
``NotImplementedError`` naming the data × model mesh still to port
(``parallel.sharding.MULTI_DEVICE``), as ``Trainer`` does for
``data_axis`` / ``model_axis`` > 1. The solve path's mesh across
processes is ``parallel.sharding.RankMesh``.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _device
from ..parallel.sharding import MULTI_DEVICE


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


def make_production_mesh(*, multi_pod: bool = False):
    shape = "2x16x16" if multi_pod else "16x16"
    raise NotImplementedError(
        f"the production mesh ({shape} chips) spans many devices: "
        f"{MULTI_DEVICE}; a launcher cell runs on one device "
        "(make_debug_mesh())")


def make_debug_mesh(*, data: int = 1, model: int = 1, device=None) -> Mesh:
    """The one-device mesh with axes ``("data", "model")`` on ``device``
    (None: the GPU)."""
    if (data, model) != (1, 1):
        raise NotImplementedError(
            f"a {data}x{model} (data, model) mesh: {MULTI_DEVICE}; the "
            "launchers build the 1x1 mesh")
    dev = _device.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(("data", "model"), ((dev,),))
