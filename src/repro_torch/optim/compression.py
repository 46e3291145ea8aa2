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

Across the data-parallel shards of a mesh (``launch.mesh``: a
``ProcessMesh``, one rank per shard, or its stacked form in one process),
both reductions take one value per shard this process holds
(``mesh.local``) and exchange through the mesh:

* :func:`compressed_psum`: quantise with error feedback, then the sum
  over the shards in rank order (``launch.steps.reduce_gradients``: an
  all-to-all of equal chunks, each rank's chunk summed with
  ``collectives.shard_sum``; each shard keeps its ZeRO slice of a split
  leaf, and an all-gather gives it the whole sum of a leaf not split).
  The trainer's compressed step runs it. Each shard keeps its
  own error buffer. The reference's ``shard_map`` returns the buffer
  under a replicated ``out_spec``, but each device's buffer stays its
  own there too: nothing reduces it.
* :func:`compressed_wire_reduce`: the reference's integer-wire mean over
  one axis: scale, quantise, all-to-all, a local float32 sum, quantise
  again, all-gather, with a shared (``pmax``) scale per leg for ``u8``,
  in the reference's steps and order. The 16-bit patterns travel as
  ``bfloat16`` views (``collectives.u16_wire``): gloo refuses 16-bit
  integers and NCCL has no unsigned 16-bit type.

Without a mesh ``compressed_psum`` sums over one shard, the identity.
Over a model axis (``launch.steps``) ``compressed_psum`` runs over the
data shards of each model index, and ``compressed_wire_reduce`` over the
pods on each shard's chunk of its pieces, the ``u8`` scale shared over
every shard (``scale_axis="world"``).
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


def compressed_psum(grads, errs, mantissa_bits: int = 10, *, mesh=None,
                    layout=None):
    """Quantize each gradient with its error feedback, then sum over the
    data-parallel shards of ``mesh`` in rank order (module docstring).
    Without a mesh, ``grads`` and ``errs`` are sequences in the same order
    and the sum over one shard is the quantized gradient itself; returns
    (summed, new errors) as lists. With a mesh, both are lists per shard
    this process holds (``mesh.local``) of such sequences, and the sum is
    ``launch.steps.reduce_gradients`` over ``layout`` (``ZeroLeaf`` rules
    whose ``index`` points into the sequences): each held shard gets its
    slice of every leaf of ``layout``, the whole sum where the leaf is not
    split. Returns (slices, new errors) per shard held."""
    if mesh is None:
        out = [compress(g, e, mantissa_bits) for g, e in zip(grads, errs)]
        return [q for q, _ in out], [e for _, e in out]
    from ..launch.steps import reduce_gradients

    qs, es = [], []
    for gl, el in zip(grads, errs):
        out = [compress(g, e, mantissa_bits) for g, e in zip(gl, el)]
        qs.append([q for q, _ in out])
        es.append([e for _, e in out])
    return reduce_gradients(mesh, layout, qs, mean=False), es


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


def _u16_of(x: torch.Tensor) -> torch.Tensor:
    """:func:`_f32_to_u16`'s patterns in int64, as the wire carries them."""
    return _bits(e8m_truncate(x, 7)) >> 16


def _times_inverse(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` for a constant ``d`` as the reference computes it: XLA
    rewrites a division by a constant into a product with its float32
    reciprocal (``/ 448.0`` runs as ``* 0.00223214296``), which rounds
    differently unless ``d`` is a power of two."""
    return x * torch.full((), 1.0 / d, dtype=torch.float32, device=x.device)


def _scale(x: torch.Tensor) -> torch.Tensor:
    return _times_inverse(torch.clamp(torch.max(torch.abs(x)), min=1e-30),
                          448.0)


def compressed_wire_reduce(g, mesh, axis: str = "pod", wire: str = "u16",
                           *, scale_axis: str | None = None):
    """Mean of ``g`` over ``axis`` of ``mesh`` (``launch.mesh``) with an
    integer wire format, the reference's construction: ``g / n`` split into
    ``n`` chunks, quantised (``u16``: the bf16 pattern; ``u8``: float8_e4m3
    of a shared scale), all-to-all, dequantised and summed in float32 over
    the senders in rank order, quantised again (``u8``: a fresh shared
    scale), all-gathered and dequantised. ``g``: this shard's tensor, or a
    list with one per shard this process holds (``mesh.local``); returns
    the same form. ``scale_axis``: the shards whose largest |value| the
    ``u8`` scales share (None: ``axis``; ``"world"`` where each shard holds
    a part of one tensor)."""
    from ..parallel import collectives as co

    one = torch.is_tensor(g)
    gs = [g] if one else list(g)
    n = mesh.axis_size(axis)
    shape, numel = gs[0].shape, gs[0].numel()
    pad = -numel % n
    chunks = []
    for x in gs:
        flat = _times_inverse(x.reshape(-1).to(torch.float32), n)
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        chunks.append(flat.reshape(n, -1))
    if wire == "u16":
        recv = mesh.all_to_all(axis, [co.u16_wire(_u16_of(c))
                                      for c in chunks])
        parts = [co.shard_sum(_u16_to_f32(co.u16_from_wire(r)))
                 for r in recv]
        got = mesh.all_gather(axis, [co.u16_wire(_u16_of(p)) for p in parts])
        outs = [_u16_to_f32(co.u16_from_wire(w)).reshape(-1) for w in got]
    elif wire == "u8":
        scale_axis = axis if scale_axis is None else scale_axis
        scales = mesh.pmax(scale_axis, [_scale(c) for c in chunks])
        recv = mesh.all_to_all(axis, [_f32_to_u8(c, s)
                                      for c, s in zip(chunks, scales)])
        parts = [co.shard_sum(_u8_to_f32(r, s))
                 for r, s in zip(recv, scales)]
        # the sum of n quantised chunks can pass 448 scales: a fresh scale
        # for the gather leg (e4m3fn has no inf; past it is NaN)
        scales2 = mesh.pmax(scale_axis, [_scale(p) for p in parts])
        got = mesh.all_gather(axis, [_f32_to_u8(p, s)
                                     for p, s in zip(parts, scales2)])
        outs = [_u8_to_f32(w, s).reshape(-1) for w, s in zip(got, scales2)]
    else:
        raise ValueError(f"wire {wire!r} not in ('u16', 'u8')")
    outs = [(o[:numel] if pad else o).reshape(shape) for o in outs]
    return outs[0] if one else outs
