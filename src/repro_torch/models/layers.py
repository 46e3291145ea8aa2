"""Shared neural layers (PyTorch): norms, RoPE, MLP, embeddings.

The port of ``repro.models.layers``. Parameters live in small
``nn.Module`` containers (:class:`Dense`, :class:`RMSNorm`,
:class:`SwiGLU`, :class:`Embed`) whose tensors carry the reference's
names and layouts (a dense kernel ``w`` is ``[d_in, d_out]``); the
``*_apply`` functions are the reference's. There are no sharding specs:
the model axis calls them on each shard's parts
(``models.tensor_parallel``).

The ``*_init`` functions draw from an explicit ``torch.Generator`` (None
leaves the tensors uninitialised, for a copy to fill). They give other
numbers than ``jax.random`` from the same seed, so the tests carry the
reference's parameters over (``transformer.load_reference_params``).
Parameters are created with ``requires_grad=False``: serving needs no
gradients. The trainer's float32 master turns them on
(``optim.adamw.init_state``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def as_dtype(dtype) -> torch.dtype:
    """``"bfloat16"`` (a config's string) or a ``torch.dtype``."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """``y = x @ w (+ b)``; ``w``: ``[d_in, d_out]``."""

    def __init__(self, d_in: int, d_out: int, *, dtype, device,
                 bias: bool = False):
        super().__init__()
        dt = as_dtype(dtype)
        self.w = _param(torch.empty(d_in, d_out, dtype=dt, device=device))
        self.b = (_param(torch.zeros(d_out, dtype=dt, device=device))
                  if bias else None)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.g = _param(torch.ones(d, dtype=as_dtype(dtype), device=device))


class SwiGLU(nn.Module):
    def __init__(self, wi: Dense, wg: Dense, wo: Dense):
        super().__init__()
        self.wi, self.wg, self.wo = wi, wg, wo


class Embed(nn.Module):
    """The token table ``w``: ``[vocab, d]``."""

    def __init__(self, vocab: int, d: int, *, dtype, device):
        super().__init__()
        self.w = _param(torch.empty(vocab, d, dtype=as_dtype(dtype),
                                    device=device))


def draw_(t: torch.Tensor, sample) -> None:
    """Fill ``t`` with ``sample`` (an in-place sampler such as
    ``lambda s: s.uniform_(a, b, generator=gen)``) as a float32 draw: in
    place for a float32 tensor; else into a float32 scratch of ``t``'s
    shape, copied into ``t`` (round to nearest even, as ``astype``) and
    freed. The generator advances as for the float32 draw, so a model
    drawn this way in bfloat16 has the bits of one drawn in float32 and
    cast afterwards, without the float32 copy. (``uniform_`` on a
    bfloat16 tensor need not give those bits.)"""
    if t.dtype == torch.float32:
        sample(t)
        return
    scratch = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    sample(scratch)
    t.copy_(scratch)


def uniform_(t: torch.Tensor, scale: float, gen) -> None:
    """``t`` ~ U(-scale, scale) from ``gen``, drawn as :func:`draw_`."""
    draw_(t, lambda s: s.uniform_(-scale, scale, generator=gen))


def dense_init(gen, d_in: int, d_out: int, dtype, *, bias: bool = False,
               device=None) -> Dense:
    p = Dense(d_in, d_out, dtype=dtype, device=device, bias=bias)
    if gen is not None:
        uniform_(p.w, float(1.0 / np.sqrt(d_in)), gen)
    return p


def dense_apply(p: Dense, x, dtype):
    dt = as_dtype(dtype)
    y = x.to(dt) @ p.w.to(dt)
    if p.b is not None:
        y = y + p.b.to(dt)
    return y


def rmsnorm_init(d: int, dtype, *, device=None) -> RMSNorm:
    return RMSNorm(d, dtype=dtype, device=device)


def rmsnorm_apply(p: RMSNorm, x, eps: float, dtype):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.g.to(torch.float32)).to(as_dtype(dtype))


def swiglu_init(gen, d: int, ff: int, dtype, *, device=None) -> SwiGLU:
    wi = dense_init(gen, d, ff, dtype, device=device)
    wg = dense_init(gen, d, ff, dtype, device=device)
    wo = dense_init(gen, ff, d, dtype, device=device)
    return SwiGLU(wi, wg, wo)


def swiglu_apply(p: SwiGLU, x, dtype):
    h = F.silu(dense_apply(p.wg, x, dtype)) * dense_apply(p.wi, x, dtype)
    return dense_apply(p.wo, h, dtype)


def embed_init(gen, vocab: int, d: int, dtype, *, device=None) -> Embed:
    p = Embed(vocab, d, dtype=dtype, device=device)
    if gen is not None:
        draw_(p.w, lambda s: s.normal_(0.0, 0.02, generator=gen))
    return p


def embed_apply(p: Embed, tokens, dtype):
    """Rows of the table for ``tokens``, in ``dtype``. The reference
    casts the whole table and then gathers; gathering first gives the same
    bits and casts only the rows.

    Out-of-range ids follow the reference's ``jnp.take`` (fill mode): an
    id in ``[-V, 0)`` wraps to ``id + V``, and any id outside ``[-V, V)``
    gives a row of NaN. The gather reads the id clamped into ``[0, V)``,
    so a bad id neither raises on the host nor asserts on the card, and
    the step needs no host sync. The gather is ``F.embedding``: the same
    rows as ``index_select``, and a backward that sums each row's
    gradients in one order on the card (``index_select``'s adds them with
    atomics), so a training step repeats bit for bit."""
    V = p.w.shape[0]
    idx = tokens.reshape(-1)
    idx = torch.where(idx < 0, idx + V, idx)
    rows = F.embedding(idx.clamp(0, V - 1), p.w)
    ok = (idx >= 0) & (idx < V)
    rows = torch.where(ok[:, None], rows, float("nan"))
    return rows.reshape(*tokens.shape, -1).to(as_dtype(dtype))


@functools.lru_cache(maxsize=32)
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's frequencies, from numpy in float32, on ``device``.
    Kept per device, so a decode step captured into a CUDA graph after its
    first (eager) run copies nothing from the host."""
    half = hd // 2
    freqs = (1.0 / (theta ** (np.arange(0, half) * 2.0 / hd))).astype(
        np.float32)
    return torch.from_numpy(freqs).to(device)


def rope(q, k, positions, theta: float):
    """Rotary embeddings. q,k: [..., S, H, hd]; positions: [..., S]."""
    hd = q.shape[-1]
    half = hd // 2
    freqs = _rope_freqs(hd, float(theta), q.device)
    ang = positions[..., :, None].to(torch.float32) * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]   # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]

    def rot(x):
        xf1 = x[..., :half].to(torch.float32)
        xf2 = x[..., half:].to(torch.float32)
        return torch.cat([xf1 * cos - xf2 * sin,
                          xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)

    return rot(q), rot(k)
