"""Where the port's tensors live.

Every entry point takes ``device=``. ``None`` means the GPU: the port is
written for the card, and with no CUDA device it raises instead of
carrying on quietly on the host. The CPU runs the plain PyTorch bodies
only when the caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default and no CUDA device "
                "is available; pass device='cpu' to run the plain PyTorch "
                "bodies on the host")
        return torch.device("cuda")
    return torch.device(device)
