"""Plain oracles for the kernels: the PyTorch bodies of ``core`` and the
dense float64 decode."""
from __future__ import annotations

import numpy as np
import torch

from ..core.packsell import PackSELLMatrix, decode_to_dense, packsell_spmv_torch
from ..core.sell import SELLMatrix, sell_spmv


def packsell_spmv_ref(mat: PackSELLMatrix, x: torch.Tensor) -> torch.Tensor:
    return packsell_spmv_torch(mat, x)


def sell_spmv_ref(mat: SELLMatrix, x: torch.Tensor) -> torch.Tensor:
    return sell_spmv(mat, x)


def packsell_spmv_dense_oracle(mat: PackSELLMatrix, x: np.ndarray) -> np.ndarray:
    """Slow exact oracle: decode to dense (quantized) and matvec in float64."""
    return decode_to_dense(mat) @ np.asarray(x, dtype=np.float64)
