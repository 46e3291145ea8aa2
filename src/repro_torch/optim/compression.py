"""E8MY gradient compression with error feedback, and the integer wire
codecs.

The port of ``repro.optim.compression``. ``e8m_truncate`` rounds float32
to E8M<bits> (round to nearest even) by integer operations on the bits;
``compress`` adds the error-feedback buffer first and returns the new
error, so the truncation error is carried into the next step. The wire
codecs turn float32 into the bf16 bit pattern (``uint16``) or a
scale-normalised float8_e4m3fn byte (``uint8``) and back.

torch has no unsigned 32-bit arithmetic: the bits are read as int32 and
the rounding runs on int64 holding the unsigned value, masked back to 32
bits, so a carry out of the top bit wraps as the reference's uint32 add
does (NaN and values that round past the largest exponent included).

Not copied: ``compressed_wire_reduce``, the all-to-all / all-gather
reduction over a mesh axis, which needs the multi-card mesh;
``compressed_psum`` runs on one device, where the sum over one shard is
the identity and only the quantisation and the error feedback remain.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The float32 bits of ``x`` as unsigned values in int64."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & _U32


def _from_bits(u: torch.Tensor) -> torch.Tensor:
    """int64 holding unsigned 32-bit patterns -> float32 with those bits."""
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def e8m_truncate(x: torch.Tensor, mantissa_bits: int) -> torch.Tensor:
    """Round float32 to E8M<mantissa_bits> (RNE), staying in float32."""
    drop = 23 - mantissa_bits
    u = _bits(x)
    lsb = (u >> drop) & 1
    half = (1 << (drop - 1)) - 1
    r = (u + lsb + half) & (_U32 & ~((1 << drop) - 1))
    return _from_bits(r)


def compress(grad: torch.Tensor, err: torch.Tensor, mantissa_bits: int):
    """(gradient + error feedback) -> (quantized gradient, new error)."""
    g = grad.to(torch.float32) + err
    q = e8m_truncate(g, mantissa_bits)
    return q, g - q


def compressed_psum(grads, errs, mantissa_bits: int = 10):
    """Quantize each gradient with its error feedback, then sum over the
    data-parallel shards: on one device that sum is the quantized
    gradient itself. ``grads`` and ``errs`` are sequences in the same
    order; returns (summed, new errors) as lists."""
    out = [compress(g, e, mantissa_bits) for g, e in zip(grads, errs)]
    return [q for q, _ in out], [e for _, e in out]


def _f32_to_u16(x: torch.Tensor) -> torch.Tensor:
    """Top 16 bits of an RNE-rounded fp32 == the bf16 bit pattern."""
    return (_bits(e8m_truncate(x, 7)) >> 16).to(torch.uint16)


def _u16_to_f32(u: torch.Tensor) -> torch.Tensor:
    return _from_bits(u.to(torch.int64) << 16)


def _f32_to_u8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Scale-normalized float8_e4m3fn wire byte. A value past the largest
    finite one after rounding (|x/scale| > 464, or inf) gives the NaN byte
    of its sign, as the reference's conversion does; torch's saturates."""
    y = x / scale
    b = y.to(torch.float8_e4m3fn).view(torch.uint8)
    return torch.where(y.abs() > 464.0, b | 0x7F, b)


def _u8_to_f32(u: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The NaN bytes give the quiet NaN of their sign (``0x7FC00000``,
    ``0xFFC00000``), as the reference's conversion does; torch's sets more
    payload bits."""
    y = u.view(torch.float8_e4m3fn).to(torch.float32)
    y = torch.where(y.isnan(), torch.copysign(torch.full_like(y, torch.nan),
                                              y), y)
    return y * scale
