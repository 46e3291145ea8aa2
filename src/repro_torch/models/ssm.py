"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060).

The port of ``repro.models.ssm``. Prefill runs the chunked SSD
algorithm: quadratic attention-like compute inside chunks of length
``Q = min(ssm_chunk, S)`` plus a linear recurrence between chunks.
Decode is the O(1) recurrent update of the ``[B, H, N, P]`` state.

The reference's rule, kept step by step: one B/C group, a scalar ``A``
per head, the ``D·x`` skip, the causal depthwise conv in the compute
dtype summed tap by tap, softplus as ``logaddexp(x, 0)``, the SSD in
float32 with the double ``where`` around ``exp(diff)`` (the masked
entries would overflow and poison gradients), and the gated RMSNorm in
the reference's rounding order: float32 ``y·rsqrt(mean(y²) + eps)``
rounded to the compute dtype, then times ``norm_g`` in that dtype
(:func:`gated_norm`; ``layers.rmsnorm_apply`` multiplies in float32
and rounds after, which differs in bfloat16). The state handed from
prefill to decode comes from :func:`_final_state`'s cumulative-sum
formula, as the reference's, not from the chunk recurrence's last
carry; the two agree within rounding only. That formula subtracts two
float32 sums of size ``S·|dt·A|`` (hundreds at S = 40) and keeps their
rounding, so the port sums in the reference's order (:func:`_cumsum`,
:func:`_sum`: XLA's rewrite of a long reduction into blocks) and its
state equals the reference's to float32 rounding, not to that of the
sums.

Not copied from the reference: the sharding specs, and ``lax.scan``
over the chunks (a Python loop over ``nq``; prefill runs eagerly).
``apply_decode`` reads nothing back to the host, so the engine's decode
step captures into one CUDA graph.

``A_log``, ``D`` and ``dt_bias`` stay float32 whatever dtype the other
parameters take, as the reference draws and serves them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L


class Mamba2(nn.Module):
    """``in_proj`` ``[d, 2·di + 2N + H]`` (z, x, B, C, dt), ``conv_w``
    ``[K, di + 2N]``, ``conv_b``, ``A_log``, ``D``, ``dt_bias`` ``[H]``
    (float32), ``norm_g`` ``[di]``, ``out_proj`` ``[di, d]``."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        dt, f32 = L.as_dtype(dtype), torch.float32
        d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        ch = di + 2 * N

        def w(shape, t=dt):
            return L._param(torch.empty(shape, dtype=t, device=device))

        self.in_proj = w((d, 2 * di + 2 * N + H))
        self.conv_w = w((cfg.ssm_conv, ch))
        self.conv_b = L._param(torch.zeros(ch, dtype=dt, device=device))
        self.A_log = w((H,), f32)
        self.D = L._param(torch.ones(H, dtype=f32, device=device))
        self.dt_bias = L._param(torch.zeros(H, dtype=f32, device=device))
        self.norm_g = L._param(torch.ones(di, dtype=dt, device=device))
        self.out_proj = w((di, d))


def init(gen, cfg, dtype, *, device=None) -> Mamba2:
    """The reference's distributions, drawn from ``gen`` (None: left
    uninitialised) in the order ``in_proj``, ``conv_w``, ``out_proj``;
    ``A_log = log(linspace(1, 16, H))``."""
    p = Mamba2(cfg, dtype=dtype, device=device)
    if gen is not None:
        d, di, K = cfg.d_model, cfg.d_inner, cfg.ssm_conv
        L.uniform_(p.in_proj, float(1.0 / np.sqrt(d)), gen)
        L.draw_(p.conv_w, lambda s: s.uniform_(-0.5, 0.5, generator=gen)
                .div_(K))
        L.uniform_(p.out_proj, float(1.0 / np.sqrt(di)), gen)
        with torch.no_grad():
            p.A_log.copy_(torch.linspace(1.0, 16.0, cfg.ssm_heads,
                                         dtype=torch.float32).log())
    return p


def _split_proj(cfg, zxbcdt):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, conv_state=None):
    """Depthwise causal conv along S, then SiLU. xbc: ``[B, S, Cch]``; w:
    ``[K, Cch]``; ``conv_state`` ``[B, K-1, Cch]`` (None: zeros). Returns
    the output and the new state, the last ``K-1`` rows of the padded
    input (prompts shorter than ``K-1`` keep rows of the old state)."""
    K = w.shape[0]
    B, S, ch = xbc.shape
    if conv_state is None:
        pad = torch.zeros((B, K - 1, ch), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return F.silu(out + b), new_state


def _seq(x, dim: int):
    """``x`` summed along ``dim`` left to right, and the running sums."""
    runs = [x.select(dim, 0)]
    for i in range(1, x.shape[dim]):
        runs.append(runs[-1] + x.select(dim, i))
    return torch.stack(runs, dim)


def _cumsum(x, base: int = 16):
    """Cumulative sum along dim 1 in the reference's order (XLA's rewrite
    of a long cumulative reduce-window): left to right within blocks of
    ``base``, each block's running sums plus the cumulative sum of the
    blocks before it, taken by the same rule."""
    S = x.shape[1]
    if S <= base:
        return _seq(x, 1)
    n = -(-S // base)
    xp = F.pad(x.movedim(1, -1), (0, n * base - S)).movedim(-1, 1)
    inner = _seq(xp.unflatten(1, (n, base)), 2)          # [B, n, base, ...]
    outer = _cumsum(inner[:, :, -1], base)
    prev = torch.cat([torch.zeros_like(outer[:, :1]), outer[:, :-1]], 1)
    return (inner + prev[:, :, None]).flatten(1, 2)[:, :S]


def _sum(x, base: int = 32):
    """Sum along dim 1, kept, in the reference's order (XLA's rewrite of
    a long reduction): the length padded to blocks of ``base`` (half the
    zeros in front), each block left to right, then the blocks' sums by
    the same rule."""
    S = x.shape[1]
    if S <= base:
        return _seq(x, 1)[:, -1:]
    n = -(-S // base)
    pad = n * base - S
    xp = F.pad(x.movedim(1, -1), (pad // 2, pad - pad // 2)).movedim(-1, 1)
    return _sum(_seq(xp.unflatten(1, (n, base)), 2)[:, :, -1], base)


def softplus(x):
    """The reference's ``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssd_chunked(cfg, xh, dt, Bc, Cc, A):
    """Chunked SSD scan, float32.

    xh: ``[B, S, H, P]``; dt: ``[B, S, H]`` (softplus'd); Bc, Cc:
    ``[B, S, N]``; A: ``[H]`` (negative). Returns y: ``[B, S, H, P]``.
    """
    Bsz, S, H, Pd = xh.shape
    N = Bc.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    nq = (S + Q - 1) // Q
    pad = nq * Q - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    # chunk views [B, nq, Q, ...]
    xh = xh.reshape(Bsz, nq, Q, H, Pd)
    dt = dt.reshape(Bsz, nq, Q, H)
    Bc = Bc.reshape(Bsz, nq, Q, N)
    Cc = Cc.reshape(Bsz, nq, Q, N)

    da = dt * A                                          # [B,nq,Q,H] (<=0)
    cums = _cumsum(da.flatten(0, 1)).unflatten(0, (Bsz, nq))  # in chunks
    seg_end = cums[:, :, -1, :]                          # [B,nq,H]

    # intra-chunk: L[b,c,i,j,h] = exp(cums_i - cums_j) for i >= j
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # [B,nq,Q,Q,H]
    ii = torch.arange(Q, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # double where: the masked (i < j) entries have diff > 0 and would
    # overflow in exp, poisoning gradients through the outer where
    diff = torch.where(causal, diff, 0.0)
    Lmat = torch.where(causal, torch.exp(diff), 0.0)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)     # [B,nq,Q,Q]
    M = scores[..., None] * Lmat                          # [B,nq,Q,Q,H]
    xdt = xh * dt[..., None]                              # [B,nq,Q,H,P]
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", M, xdt)

    # chunk states and the recurrence between chunks
    decay_to_end = torch.exp(seg_end[:, :, None, :] - cums)  # [B,nq,Q,H]
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp",
                          Bc, dt * decay_to_end, xh)       # [B,nq,H,N,P]
    h = torch.zeros_like(states[:, 0])
    h_prevs = []
    for c in range(nq):
        h_prevs.append(h)
        h = h * torch.exp(seg_end[:, c])[..., None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # [B,nq,H,N,P]

    y_off = torch.einsum("bcqn,bcqh,bchnp->bcqhp",
                         Cc, torch.exp(cums), h_prevs)
    return (y_diag + y_off).reshape(Bsz, nq * Q, H, Pd)[:, :S]


def _final_state(cfg, xh, dt, Bc, A):
    """h(S) = sum_j exp(sum_{i>j} da_i) dt_j B_j x_j: ``[B, H, N, P]``."""
    da = dt * A
    decay = torch.exp(_sum(da) - _cumsum(da))              # [B,S,H]
    return torch.einsum("bsn,bsh,bshp->bhnp", Bc, dt * decay, xh)


def gated_norm(p: Mamba2, y, z, eps: float, dtype):
    """Mamba2's gated RMSNorm, in the reference's rounding order: ``y·
    silu(z)`` in ``dtype``; float32 ``rsqrt(mean(y²) + eps)`` scaling,
    rounded to ``dtype``; then times ``norm_g`` in ``dtype``."""
    return _norm(y * F.silu(z), p.norm_g, eps, dtype)


def _norm(y, g, eps: float, dtype):
    dt = L.as_dtype(dtype)
    yf = y.to(torch.float32)
    r = torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return (yf * r).to(dt) * g.to(dt)


def _inputs(p: Mamba2, cfg, x, dtype, conv_state=None):
    """The projection and conv: ``(z, xh, Bc, Cc, dt)``, the last four in
    float32, and the new conv state."""
    B, S, _ = x.shape
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = L.as_dtype(dtype)
    zxbcdt = x.to(dt_) @ p.in_proj.to(dt_)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xbc, conv = _causal_conv(xbc, p.conv_w.to(dt_), p.conv_b.to(dt_),
                             conv_state)
    f32 = torch.float32
    xh = xbc[..., :di].reshape(B, S, H, Pd).to(f32)
    Bc = xbc[..., di:di + N].to(f32)
    Cc = xbc[..., di + N:].to(f32)
    dt = softplus(dt_raw.to(f32) + p.dt_bias)
    return z, xh, Bc, Cc, dt, conv


def _out(p: Mamba2, cfg, y, z, dtype):
    """``[B, S, H, P]`` float32 y through the gated norm and ``out_proj``."""
    B, S = y.shape[:2]
    dt = L.as_dtype(dtype)
    y = gated_norm(p, y.reshape(B, S, cfg.d_inner).to(dt), z, cfg.norm_eps,
                   dt)
    return y @ p.out_proj.to(dt)


def apply_full(p: Mamba2, cfg, x, dtype, *, state: bool = True):
    """Prefill. x: ``[B, S, d]`` -> ``(y, {"conv", "ssm"})``, the final
    conv and SSM states that decode goes on from; ``state=False`` (the
    training forward, which drops them) skips them: ``(y, None)``."""
    z, xh, Bc, Cc, dt, conv = _inputs(p, cfg, x, dtype)
    A = -torch.exp(p.A_log)
    y = _ssd_chunked(cfg, xh, dt, Bc, Cc, A)
    y = y + xh * p.D[None, None, :, None]
    y = _out(p, cfg, y, z, dtype)
    if not state:
        return y, None
    return y, {"conv": conv, "ssm": _final_state(cfg, xh, dt, Bc, A)}


def apply_decode(p: Mamba2, cfg, x, cache: dict, dtype):
    """Single-token decode. x: ``[B, 1, d]``; ``cache`` ``{"conv": [B, K-1,
    ch], "ssm": [B, H, N, P]}`` -> ``(y, new cache)``; the given tensors
    are not written."""
    z, xh, Bc, Cc, dt, conv = _inputs(p, cfg, x, dtype, cache["conv"])
    xh, Bc, Cc, dt = xh[:, 0], Bc[:, 0], Cc[:, 0], dt[:, 0]  # [B,H,P] ...
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)                              # [B,H]
    h = cache["ssm"] * decay[..., None, None] \
        + Bc[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", Cc, h) + xh * p.D[None, :, None]
    return _out(p, cfg, y[:, None], z, dtype), {"conv": conv, "ssm": h}
