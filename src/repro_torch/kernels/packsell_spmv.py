"""The fused-stream PackSELL SpMV (K1) and SpMM (K3): CUDA kernels and
their plain PyTorch versions.

They replace the Pallas kernels ``packsell_spmv_fused`` and
``packsell_spmm_fused`` of ``repro/kernels/packsell_spmv.py`` (bodies
``_kernel_fused`` / ``_kernel_fused_mm``, decode ``fused_decode_word``).
Both walk the plan engine's fused stream: words ``[G, wr, C]`` (int32
bits of uint32 words) with one int32 checkpoint per group lane, and
return float32 group partials ``[G, C]`` (``[G, C, nb]`` for SpMM); the
plan applies the level-chain tail and the inverse-permutation gather.

Each wrapper takes its plain version for CPU tensors only; a CUDA tensor
launches the kernel (``csrc/packsell_fused.cu``) or raises. Both versions
add in the same order with no fused multiply-add, so on the card they
agree bit for bit. The column clamp is the jnp fused body's ``[0, m-1]``
(see the note in the CUDA source). The bound on the H100 is bytes: the
words are read once, coalesced across lanes, and x is gathered from L2.
``launches`` on each wrapper counts the kernel launches it made.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import codecs as cd
from ..core.packsell import _nonempty
from . import _build

ENCODINGS = {"f16": 0, "top16": 1, "fixed16": 2, "words": 3}


def _codec_id(codec_name: str) -> int:
    if codec_name.startswith("fixed"):
        return 3
    return {"fp16": 0, "bf16": 1, "e8m": 2}[codec_name]


def fused_decode_word(w: torch.Tensor, codec: cd.Codec, D: int,
                      encoding: str, scale: float):
    """(value float32, run-local column offset int64) of fused-stream
    words. The 16/16 split encodings are two fixed shifts; ``'words'`` is
    the canonical branch-free unpack with the delta field already
    rewritten to the re-based offset."""
    if encoding == "f16":
        v = (w >> 16).to(torch.int16).view(torch.float16)
        local = w & 0xFFFF
    elif encoding == "top16":
        v = (w & cd.as_int32(0xFFFF0000)).view(torch.float32)
        local = w & 0xFFFF
    elif encoding == "fixed16":
        v = (w >> 16).to(torch.float32) * scale
        local = w & 0xFFFF
    elif encoding == "words":
        v, local = cd.unpack_words_torch(w, codec, D)
    else:
        raise ValueError(f"unknown fused encoding {encoding!r}")
    return v.to(torch.float32), local.to(torch.int64)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def packsell_spmv_fused_plain(words3d: torch.Tensor, ckpt: torch.Tensor,
                              x: torch.Tensor, *, codec_name: str, D: int,
                              encoding: str, scale: float = 0.0
                              ) -> torch.Tensor:
    """Group partials [G, C]: decode the whole stream, add the
    checkpoints, gather x clamped to [0, m-1], then add the products in
    word order starting from the first."""
    G, wr, C = words3d.shape
    if G == 0:
        return torch.zeros((0, C), dtype=torch.float32, device=x.device)
    xc = _nonempty(x.to(torch.float32))
    v, local = fused_decode_word(words3d, cd.make_codec(codec_name), D,
                                 encoding, scale)
    cols = (ckpt.to(torch.int64)[:, None, :] + local).clamp_(
        0, xc.shape[0] - 1)
    p = v * xc[cols]
    acc = p[:, 0, :]
    for j in range(1, wr):
        acc = acc + p[:, j, :]
    return acc


def packsell_spmm_fused_plain(words3d: torch.Tensor, ckpt: torch.Tensor,
                              x: torch.Tensor, *, codec_name: str, D: int,
                              encoding: str, scale: float = 0.0
                              ) -> torch.Tensor:
    """Multi-RHS group partials [G, C, nb] for x: [m, nb]; per word
    position one decode, one [G, C, nb] gather and one add."""
    G, wr, C = words3d.shape
    nb = x.shape[1]
    if G == 0:
        return torch.zeros((0, C, nb), dtype=torch.float32, device=x.device)
    xc = _nonempty(x.to(torch.float32))
    codec = cd.make_codec(codec_name)
    ck = ckpt.to(torch.int64)
    acc = None
    for j in range(wr):
        v, local = fused_decode_word(words3d[:, j, :], codec, D, encoding,
                                     scale)
        t = v[..., None] * xc[(ck + local).clamp_(0, xc.shape[0] - 1)]
        acc = t if acc is None else acc + t
    return acc


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = _build.load("packsell_fused")
    if not getattr(lib, "_typed", False):
        lib.packsell_spmv_fused.argtypes = [_P, _P, _P, _P, _L, _I, _I, _L,
                                            _I, _I, _I, ctypes.c_float, _P]
        lib.packsell_spmv_fused.restype = _I
        lib.packsell_spmm_fused.argtypes = [_P, _P, _P, _P, _L, _I, _I, _I,
                                            _L, _I, _I, _I, ctypes.c_float,
                                            _P]
        lib.packsell_spmm_fused.restype = _I
        lib._typed = True
    return lib


def _check_operands(words3d, ckpt, x, xdim: int, what: str) -> None:
    dev = words3d.device
    if dev.type != "cuda" or ckpt.device != dev or x.device != dev:
        raise ValueError(f"{what}: words3d, ckpt and x must lie on one CUDA "
                         f"device (got {dev}, {ckpt.device}, {x.device})")
    if words3d.dtype != torch.int32 or ckpt.dtype != torch.int32:
        raise TypeError(f"{what}: words3d and ckpt must be int32 (got "
                        f"{words3d.dtype}, {ckpt.dtype})")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: x must be float32 (got {x.dtype})")
    G, wr, C = words3d.shape
    if tuple(ckpt.shape) != (G, C) or x.dim() != xdim:
        raise ValueError(f"{what}: shapes words3d {tuple(words3d.shape)}, "
                         f"ckpt {tuple(ckpt.shape)}, x {tuple(x.shape)} do "
                         "not fit")
    if not (words3d.is_contiguous() and ckpt.is_contiguous()
            and x.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")


def _scale_arg(codec_name: str, encoding: str, scale: float) -> float:
    """The kernel's ``scale``: the fixed16 dequant scale, or 2^-frac for
    canonical fixed-point words."""
    if encoding == "words" and codec_name.startswith("fixed"):
        return 2.0 ** -int(codec_name[len("fixed"):])
    return float(scale)


def packsell_spmv_fused(words3d: torch.Tensor, ckpt: torch.Tensor,
                        x: torch.Tensor, *, codec_name: str, D: int,
                        encoding: str, scale: float = 0.0) -> torch.Tensor:
    """K1: group partials [G, C] float32 of the fused stream. CPU tensors
    take :func:`packsell_spmv_fused_plain`; CUDA tensors launch the
    kernel."""
    if words3d.device.type == "cpu":
        return packsell_spmv_fused_plain(words3d, ckpt, x,
                                         codec_name=codec_name, D=D,
                                         encoding=encoding, scale=scale)
    _check_operands(words3d, ckpt, x, 1, "packsell_spmv_fused")
    G, wr, C = words3d.shape
    part = torch.empty((G, C), dtype=torch.float32, device=words3d.device)
    if G == 0:
        return part
    xc = _nonempty(x)
    with torch.cuda.device(words3d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().packsell_spmv_fused(
            words3d.data_ptr(), ckpt.data_ptr(), xc.data_ptr(),
            part.data_ptr(), G, wr, C, xc.shape[0], ENCODINGS[encoding],
            _codec_id(codec_name), D,
            _scale_arg(codec_name, encoding, scale), stream)
    packsell_spmv_fused.launches += 1
    _build.check(rc, "packsell_spmv_fused")
    return part


packsell_spmv_fused.launches = 0


def packsell_spmm_fused(words3d: torch.Tensor, ckpt: torch.Tensor,
                        x: torch.Tensor, *, codec_name: str, D: int,
                        encoding: str, scale: float = 0.0) -> torch.Tensor:
    """K3: multi-RHS group partials [G, C, nb] float32 for x: [m, nb].
    CPU tensors take :func:`packsell_spmm_fused_plain`; CUDA tensors
    launch the kernel."""
    if words3d.device.type == "cpu":
        return packsell_spmm_fused_plain(words3d, ckpt, x,
                                         codec_name=codec_name, D=D,
                                         encoding=encoding, scale=scale)
    _check_operands(words3d, ckpt, x, 2, "packsell_spmm_fused")
    G, wr, C = words3d.shape
    nb = x.shape[1]
    part = torch.empty((G, C, nb), dtype=torch.float32,
                       device=words3d.device)
    if G == 0 or nb == 0:
        return part
    xc = _nonempty(x)
    with torch.cuda.device(words3d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().packsell_spmm_fused(
            words3d.data_ptr(), ckpt.data_ptr(), xc.data_ptr(),
            part.data_ptr(), G, wr, C, nb, xc.shape[0], ENCODINGS[encoding],
            _codec_id(codec_name), D,
            _scale_arg(codec_name, encoding, scale), stream)
    packsell_spmm_fused.launches += 1
    _build.check(rc, "packsell_spmm_fused")
    return part


packsell_spmm_fused.launches = 0
