"""Preconditioners: identity and Jacobi (the diagonal scaling)."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import _device

Matvec = Callable[[torch.Tensor], torch.Tensor]


def identity() -> Matvec:
    return lambda r: r


def jacobi(diag: np.ndarray, dtype=torch.float32, device=None) -> Matvec:
    dinv = torch.as_tensor(np.where(diag == 0, 1.0, 1.0 / diag), dtype=dtype,
                           device=_device.resolve_device(device))
    return lambda r: dinv * r.to(dtype)
