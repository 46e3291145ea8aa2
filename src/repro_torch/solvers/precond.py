"""Preconditioners: identity, Jacobi, and the truncated Neumann
approximate inverse.

The paper's SD-AINV (a sparse approximate inverse applied as SpMV) is
external to it; the reference plays the same role with a truncated
scaled Neumann series,

    M r = sum_{k=0}^{K-1} (I - D^{-1} A)^k D^{-1} r,

evaluated by the Jacobi-style recurrence ``z <- D^{-1} r + (I - D^{-1}A)
z``: every application is K-1 SpMVs in whatever precision the supplied
matvec uses, and one CUDA graph (:class:`.graphs.Applied`).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import _device
from . import graphs

Matvec = Callable[[torch.Tensor], torch.Tensor]


def identity() -> Matvec:
    return lambda r: r


def _dinv(diag: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.where(diag == 0, 1.0, 1.0 / diag), dtype=dtype,
                           device=_device.resolve_device(device))


def jacobi(diag: np.ndarray, dtype=torch.float32, device=None) -> Matvec:
    dinv = _dinv(diag, dtype, device)
    return lambda r: dinv * r.to(dtype)


def neumann_ainv(diag: np.ndarray, matvec: Matvec, k: int = 2,
                 dtype=torch.float32, device=None) -> graphs.Applied:
    """Truncated Neumann approximate inverse (SD-AINV role), K terms: K-1
    matvecs per application, none of which reads a value on the host;
    one application is one graph (the eager body is ``.fn``)."""
    dinv = _dinv(diag, dtype, device)

    def apply(r: torch.Tensor) -> torch.Tensor:
        r = r.to(dtype)
        z = dinv * r
        for _ in range(k - 1):
            z = z + dinv * (r - matvec(z).to(dtype))
        return z

    return graphs.Applied(apply)
