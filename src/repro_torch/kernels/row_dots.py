"""Per-row dot products of two ``[P, n]`` arrays (K7): CUDA kernel and its
plain PyTorch version.

Replaces no Pallas kernel: the reference's distributed solvers take each
shard's ``jnp.vdot`` and ``psum`` it (``repro/solvers/cg.py`` ``dist_dot``,
``dist_norm``). The port's stacked solve reduces a ``[P, n_pad]`` vector
and a rank's solve its ``[1, n_pad]`` row, and the two must give each
shard's partial the same bits. A library reduction picks its order from
the whole tensor's shape, so ``csrc/row_dots.cu`` sums each row in an
order set by ``n`` alone (chunks of 4,096 in fixed trees, then the chunks
in a fixed tree): row ``p`` has the same bits whatever ``P`` is. One
call launches its two passes.

The wrapper takes the plain version for CPU tensors only: each row's
products summed on their own (``(a[p] * b[p]).sum()``), which gives a
row the same bits in both forms on the CPU. CUDA tensors launch the
kernel or raise. The kernel and the plain version add in other orders,
so they agree to rounding, not bit for bit. The bound on the H100 is
bytes: each element of ``a`` and ``b`` read once. ``row_dots.launches``
counts the kernel's calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_KIND = {torch.float32: 0, torch.float64: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("row_dots")
    if not getattr(lib, "_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.row_dots.argtypes = [P, P, P, P, I, L, L, L, I, P]
        lib.row_dots.restype = I
        lib.row_dots_chunks_of.argtypes = [L]
        lib.row_dots_chunks_of.restype = L
        lib._typed = True
    return lib


def row_dots_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[P]``: row ``p``'s dot, each row one reduction of its own."""
    return torch.stack([(a[p] * b[p]).sum() for p in range(a.shape[0])])


def row_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K7: ``[P]`` dots of the rows of two ``[P, n]`` float32 or float64
    arrays, each row summed in an order set by ``n`` alone."""
    if a.device.type == "cpu":
        return row_dots_plain(a, b)
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(f"row_dots: a and b must lie on one CUDA device "
                         f"(got {dev}, {b.device})")
    if a.dtype not in _KIND or b.dtype != a.dtype:
        raise TypeError(f"row_dots: got {a.dtype} and {b.dtype}; want two "
                        "float32 or two float64 arrays")
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"row_dots: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}; want two equal [P, n]")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("row_dots: rows must have unit stride")
    P, n = a.shape
    out = torch.empty(P, dtype=a.dtype, device=dev)
    if P == 0 or n == 0:
        return out.zero_()
    lib = _lib()
    part = torch.empty((P, lib.row_dots_chunks_of(n)), dtype=a.dtype,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.row_dots(a.data_ptr(), b.data_ptr(), part.data_ptr(),
                          out.data_ptr(), P, n, a.stride(0), b.stride(0),
                          _KIND[a.dtype], stream)
    row_dots.launches += 1
    _build.check(rc, "row_dots")
    return out


row_dots.launches = 0
