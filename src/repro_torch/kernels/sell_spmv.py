"""SELL-C-σ baseline SpMV (K2): CUDA kernel and its plain PyTorch version.

Replaces the Pallas kernel ``sell_spmv_bucket`` of
``repro/kernels/sell_spmv.py`` (body ``_kernel``): per width bucket,
``y[s, c] = Σ_j cd(val[s,j,c]) · x[min(col[s,j,c], m-1)]`` for values in
f16, bf16, f32 or f64, in the compute dtype ``cd``: float32, or float64
(x and y float64 too) for the fp64 operator, as the reference's
``sell_spmv_jnp(mat, x, compute_dtype)`` computes it. SELL moves (value
bytes + 4) per stored entry across two arrays where PackSELL moves 4 from
one: the paper's contrast.

The wrapper takes the plain version (``core.sell.sell_bucket_spmv``) for
CPU tensors only; CUDA tensors launch ``csrc/sell_spmv.cu`` or raise. Both
add ``acc = 0; acc + v·x`` in j order with no fused multiply-add, so they
agree bit for bit on the card. The bound on the H100 is bytes: values
and columns are read once, coalesced across lanes, x is gathered from L2.
``sell_spmv_bucket.launches`` counts the kernel launches,
``sell_spmv_bucket.launches_f64`` those with a float64 sum.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.sell import sell_bucket_spmv as sell_spmv_bucket_plain
from . import _build

_VALUE_KIND = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2,
               torch.float64: 3}
_ACC_KIND = {torch.float32: 0, torch.float64: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("sell_spmv")
    if not getattr(lib, "_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.sell_spmv_bucket.argtypes = [P, P, P, P, L, I, I, L, I, I, P]
        lib.sell_spmv_bucket.restype = I
        lib._typed = True
    return lib


def sell_spmv_bucket(val: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """K2: one bucket's stored-row outputs [S, C] in ``compute_dtype``
    (float32, or float64 with a float64 x for the fp64 operator)."""
    if val.device.type == "cpu":
        return sell_spmv_bucket_plain(val, col, x, compute_dtype)
    dev = val.device
    if dev.type != "cuda" or col.device != dev or x.device != dev:
        raise ValueError("sell_spmv_bucket: val, col and x must lie on one "
                         f"CUDA device (got {dev}, {col.device}, {x.device})")
    if compute_dtype not in _ACC_KIND:
        raise TypeError(f"sell_spmv_bucket: compute_dtype {compute_dtype} "
                        "not in (float32, float64)")
    if val.dtype not in _VALUE_KIND or col.dtype != torch.int32 \
            or x.dtype != compute_dtype:
        raise TypeError(f"sell_spmv_bucket: got val {val.dtype}, col "
                        f"{col.dtype}, x {x.dtype}; want f16/bf16/f32/f64, "
                        f"int32, {compute_dtype}")
    if val.shape != col.shape or val.dim() != 3 or x.dim() != 1:
        raise ValueError(f"sell_spmv_bucket: shapes val {tuple(val.shape)}, "
                         f"col {tuple(col.shape)}, x {tuple(x.shape)}")
    if not (val.is_contiguous() and col.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("sell_spmv_bucket: operands must be contiguous")
    S, w, C = val.shape
    y = torch.empty((S, C), dtype=compute_dtype, device=dev)
    if S == 0 or x.shape[0] == 0:
        return y.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().sell_spmv_bucket(val.data_ptr(), col.data_ptr(),
                                     x.data_ptr(), y.data_ptr(), S, w, C,
                                     x.shape[0], _VALUE_KIND[val.dtype],
                                     _ACC_KIND[compute_dtype], stream)
    sell_spmv_bucket.launches += 1
    if compute_dtype == torch.float64:
        sell_spmv_bucket.launches_f64 += 1
    _build.check(rc, "sell_spmv_bucket")
    return y


sell_spmv_bucket.launches = 0
sell_spmv_bucket.launches_f64 = 0      # of which with a float64 sum
