"""Value codecs + branch-free word pack/unpack for PackSELL (paper §4.2).

A PackSELL word (W = 32) is laid out as::

    flag = 1 :  [ value : V bits | delta : D bits | 1 ]     V = 31 - D
    flag = 0 :  [ delta  : 31 bits              | 0 ]     (dummy / padding)

The numpy encoders are those of ``repro.core.codecs``, byte for byte
(``pack_words_np`` and the RNE truncation with its inf/NaN rules); they
build the format on the host. The device decode is PyTorch.

Word dtype: PyTorch on the CPU has no ``>>``/``<<`` for ``uint32``, so the
port carries PackSELL words as ``int32`` bit patterns (``np.uint32``
arrays viewed as ``np.int32``). The torch decode widens to ``int64`` where
it needs logical shifts and masks after arithmetic ones; the CUDA kernels
reinterpret the same buffer as ``uint32_t``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

W = 32  # word width in bits


def vbits_for(D: int) -> int:
    """Value width V for a given delta width D (W = V + D + 1)."""
    return W - D - 1


def delta_mask(D: int) -> int:
    """Low-bit mask covering the delta+flag field: (1 << (D+1)) - 1."""
    return (1 << (D + 1)) - 1


def as_int32(u: int) -> int:
    """The int32 value with the bit pattern of the uint32 ``u``."""
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= (1 << 31) else u


def words_to_torch(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words → an int32 tensor holding the same bits."""
    arr = np.ascontiguousarray(np.asarray(words, np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 word tensor → the uint32 words it holds."""
    return words.detach().cpu().numpy().view(np.uint32)


@dataclasses.dataclass(frozen=True)
class Codec:
    """A V-bit value representation living in the top bits of a 32-bit word.

    ``encode_np(values, D)`` returns uint32 payloads whose low ``D+1`` bits
    are zero; ``decode_np`` / ``decode_torch`` map masked words (low bits
    already zeroed by the unpack) to values.
    """

    name: str
    min_D: int
    max_D: int
    encode_np: Callable[[np.ndarray, int], np.ndarray]
    decode_np: Callable[[np.ndarray, int], np.ndarray]
    decode_torch: Callable[[torch.Tensor, int], torch.Tensor]
    value_bits: Callable[[int], int]


# -- FP16 / BF16 direct embedding (top 16 bits) ------------------------------


def _encode_f16_np(values: np.ndarray, D: int) -> np.ndarray:
    assert D <= 15, "fp16 embed needs V >= 16 (D <= 15)"
    with np.errstate(over="ignore"):  # out-of-range -> inf, IEEE overflow
        h = values.astype(np.float16)
    return h.view(np.uint16).astype(np.uint32) << np.uint32(16)


def _decode_f16_np(vbits: np.ndarray, D: int) -> np.ndarray:
    return (vbits >> np.uint32(16)).astype(np.uint16).view(np.float16)


def _decode_f16_torch(vbits: torch.Tensor, D: int) -> torch.Tensor:
    # the arithmetic shift leaves the top half sign-extended, which fits
    # int16 exactly: its bits are the fp16 pattern
    return (vbits >> 16).to(torch.int16).view(torch.float16)


def _rne_truncate_f32_np(u: np.ndarray, low: int) -> np.ndarray:
    """RNE-truncate FP32 bit patterns to their top ``32 - low`` bits.

    inf/NaN (exponent all-ones) are truncated WITHOUT rounding: adding the
    rounding increment to an all-ones pattern wraps the uint32 and would
    silently turn a NaN into a small finite number. A NaN whose surviving
    mantissa bits are all zero keeps the quiet bit (bit 22) when that bit is
    kept, so NaN stays NaN; with no mantissa bits kept it collapses to inf.
    """
    u = np.asarray(u, dtype=np.uint32)
    mask = ~np.uint32((1 << low) - 1)
    lsb = (u >> np.uint32(low)) & np.uint32(1)
    with np.errstate(over="ignore"):
        rounded = (u + lsb + np.uint32((1 << (low - 1)) - 1)) & mask
    special = (u & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    if not np.any(special):
        return rounded
    trunc = u & mask
    is_nan = special & ((u & np.uint32(0x007FFFFF)) != 0)
    if low <= 22:  # quiet bit survives truncation
        trunc = np.where(is_nan, trunc | np.uint32(1 << 22), trunc)
    return np.where(special, trunc, rounded)


def _encode_bf16_np(values: np.ndarray, D: int) -> np.ndarray:
    assert D <= 15, "bf16 embed needs V >= 16 (D <= 15)"
    u = np.ascontiguousarray(values.astype(np.float32)).view(np.uint32)
    return _rne_truncate_f32_np(u, 16)


def _decode_bf16_np(vbits: np.ndarray, D: int) -> np.ndarray:
    return (vbits & np.uint32(0xFFFF0000)).view(np.float32)


def _decode_bf16_torch(vbits: torch.Tensor, D: int) -> torch.Tensor:
    # clear the delta bits below the bf16 payload (D < 15) before the view
    return (vbits & as_int32(0xFFFF0000)).view(torch.float32)


# -- E8MY: top V bits of an FP32 pattern (paper §4.2.2) ----------------------


def _encode_e8m_np(values: np.ndarray, D: int) -> np.ndarray:
    """Round an FP32 value to its top V = 31-D bits (RNE), low D+1 bits
    zero."""
    u = np.ascontiguousarray(values.astype(np.float32)).view(np.uint32)
    return _rne_truncate_f32_np(u, D + 1)


def _decode_e8m_np(vbits: np.ndarray, D: int) -> np.ndarray:
    return vbits.view(np.float32)


def _decode_e8m_torch(vbits: torch.Tensor, D: int) -> torch.Tensor:
    return vbits.view(torch.float32)


# -- Fixed point: signed V-bit integer with F fraction bits -------------------


def _make_fixed(frac_bits: int):
    def encode(values: np.ndarray, D: int) -> np.ndarray:
        V = vbits_for(D)
        scaled = np.round(values.astype(np.float64) * (1 << frac_bits))
        lo, hi = -(1 << (V - 1)), (1 << (V - 1)) - 1
        q = np.clip(scaled, lo, hi).astype(np.int64)
        return (q.astype(np.uint32) << np.uint32(D + 1)) & np.uint32(0xFFFFFFFF)

    def decode_np(vbits: np.ndarray, D: int) -> np.ndarray:
        signed = vbits.view(np.int32) >> np.int32(D + 1)
        return signed.astype(np.float32) * np.float32(2.0 ** (-frac_bits))

    def decode_torch(vbits: torch.Tensor, D: int) -> torch.Tensor:
        # int32 >> is arithmetic: it sign-extends the V-bit payload
        return (vbits >> (D + 1)).to(torch.float32) * (2.0 ** (-frac_bits))

    return encode, decode_np, decode_torch


def make_codec(name: str) -> Codec:
    if name == "fp16":
        return Codec("fp16", 1, 15, _encode_f16_np, _decode_f16_np,
                     _decode_f16_torch, lambda D: 16)
    if name == "bf16":
        return Codec("bf16", 1, 15, _encode_bf16_np, _decode_bf16_np,
                     _decode_bf16_torch, lambda D: 16)
    if name == "e8m":
        # Y = 22 - D mantissa bits; V = 31 - D total.
        return Codec("e8m", 1, 22, _encode_e8m_np, _decode_e8m_np,
                     _decode_e8m_torch, lambda D: vbits_for(D))
    if name.startswith("fixed"):
        frac = int(name[len("fixed"):])
        enc, dec_n, dec_t = _make_fixed(frac)
        return Codec(name, 1, 24, enc, dec_n, dec_t, lambda D: vbits_for(D))
    raise ValueError(f"unknown codec {name!r}")


# ---------------------------------------------------------------------------
# Word-level pack / unpack
# ---------------------------------------------------------------------------


def pack_words_np(values: np.ndarray, deltas: np.ndarray, flags: np.ndarray,
                  codec: Codec, D: int) -> np.ndarray:
    """Pack (value, delta, flag) triples into uint32 words (Fig. 3a).

    flags==1: value embedded, delta must fit D bits.
    flags==0: delta occupies 31 bits, value ignored (dummy / padding).
    """
    deltas = np.asarray(deltas)
    if np.any(deltas < 0):
        raise ValueError("negative delta in word stream")
    deltas = deltas.astype(np.uint64)
    flags = flags.astype(np.uint32)
    # a delta that overflows its field would wrap into the value/flag bits
    bad = (flags == 1) & (deltas >= (1 << D))
    if np.any(bad):
        k = int(np.nonzero(bad)[0][0])
        raise ValueError(
            f"flag=1 delta {int(deltas[k])} at word {k} overflows the "
            f"D={D}-bit field; insert a dummy word "
            f"(core.delta.emit_word_stream) or raise D")
    if np.any(deltas >= (1 << (W - 1))):
        k = int(np.nonzero(deltas >= (1 << (W - 1)))[0][0])
        raise ValueError(
            f"dummy delta {int(deltas[k])} at word {k} overflows the "
            f"{W - 1}-bit field; chain dummy words "
            f"(core.delta.dummies_for_deltas)")
    payload = codec.encode_np(np.asarray(values, dtype=np.float32), D)
    word1 = payload | ((deltas.astype(np.uint32)) << np.uint32(1)) | np.uint32(1)
    word0 = (deltas.astype(np.uint32)) << np.uint32(1)
    return np.where(flags == 1, word1, word0)


def unpack_words_np(words: np.ndarray, codec: Codec, D: int):
    """Branch-free unpack (Fig. 3b) on the host: (value, delta, flag)."""
    words = words.astype(np.uint32)
    flag = words & np.uint32(1)
    shift = (np.uint32(W - 1 - D) * flag).astype(np.uint32)
    delta = (words << shift) >> (shift + np.uint32(1))
    vbits = words & (~np.uint32(delta_mask(D)) * flag)
    value = codec.decode_np(vbits, D)
    return value, delta, flag


def unpack_words_torch(words: torch.Tensor, codec: Codec, D: int):
    """Branch-free unpack (Fig. 3b) of int32 word tensors.

    Returns ``(value, delta int64)``: the same fields as
    :func:`unpack_words_np`. The logical shifts run on the words widened
    to int64 (the low 32 bits are the uint32 word)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    flag = w & 1
    shift = (W - 1 - D) * flag
    delta = ((w << shift) & 0xFFFFFFFF) >> (shift + 1)
    vbits = words & (as_int32(~delta_mask(D)) * flag.to(torch.int32))
    return codec.decode_torch(vbits, D), delta


def quantize_np(values: np.ndarray, codec: Codec, D: int) -> np.ndarray:
    """Round-trip values through the codec (what SpMV will actually see)."""
    payload = codec.encode_np(np.asarray(values, np.float32), D)
    return np.asarray(codec.decode_np(payload, D), dtype=np.float32)
