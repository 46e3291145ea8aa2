"""Preconditioned Richardson iteration: the innermost layer of F3R."""
from __future__ import annotations

from typing import Callable

import torch

from . import graphs

Matvec = Callable[[torch.Tensor], torch.Tensor]


def richardson_fixed_iters(matvec: Matvec, M: Matvec, iters: int,
                           dtype=torch.float32) -> graphs.Applied:
    """x_{k+1} = x_k + M (b - A x_k), x_0 = M b, a fixed iteration count;
    it reads nothing on the host. One application, ``M``'s included, is
    one graph (the eager body is ``.fn``)."""

    def apply(rhs: torch.Tensor) -> torch.Tensor:
        b = rhs.to(dtype)
        x = M(b).to(dtype)
        for _ in range(iters):
            x = x + M(b - matvec(x).to(dtype)).to(dtype)
        return x

    return graphs.Applied(apply)
