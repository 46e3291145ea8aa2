"""Mixture-of-Experts layer: top-k routing, sort-based dispatch, capacity
dropping, optional shared experts (Qwen2-MoE style).

The port of ``repro.models.moe``. The reference's rule, step by step:
the router's logits in float32, softmax, the top k experts of each token
(sorted, as ``lax.top_k``) with their gates renormalised; per batch row,
the ``S·k`` assignments ordered by expert (a stable sort), each expert
keeping its first ``cap = ceil(S·k/E · capacity_factor)``; the kept
tokens scattered into a ``[B, Ep, cap, d]`` buffer over the padded
experts, the three expert products over the whole buffer, and each
token's gated outputs summed in float32; the shared experts added.

Not copied from the reference: the sharding constraints, and two scatter
rules that torch does not have.

* ``mode="drop"``: a dropped assignment is written to a sentinel row
  ``Ep·cap`` of a buffer one row longer, which is then sliced off.
* The combine's scatter-add: every token has exactly k assignments, so
  the port brings each assignment's rank and slot back into assignment
  order and sums the k gated outputs of a token over the k axis. On the
  card ``index_add_`` adds with atomics, whose order changes from run to
  run; this sum has one order, so a captured decode step equals its
  eager run bit for bit. The reference adds in expert order; the two
  differ in the last float32 bits only. Its backward repeats bit for
  bit too, though the gather's backward adds with atomics on the card:
  a kept slot is read once, and the dropped assignments' reads of the
  clamped last slot carry a zero gradient (the ``where``), so each sum
  has one addend that is not zero.

Nothing here reads a value back to the host (no ``nonzero``, ``unique``,
``bincount``, boolean-mask indexing or ``.item()``): the layer runs
inside the engine's captured decode step with no sync.

The router stays float32 whatever dtype the other parameters take, as
the reference draws it (``moe.init``) and serves it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L


def padded_experts(E: int, ep: int = 16) -> int:
    """Experts padded up to a multiple of the reference's EP axis (16):
    qwen2-moe's 60 experts pad to 64. Pad experts are never routed to."""
    return -(-E // ep) * ep


class Experts(nn.Module):
    """``n`` SwiGLU experts stacked: ``wi``, ``wg`` ``[n, d, ff]``, ``wo``
    ``[n, ff, d]``."""

    def __init__(self, n: int, d: int, ff: int, *, dtype, device):
        super().__init__()
        dt = L.as_dtype(dtype)

        def w(*shape):
            return L._param(torch.empty(shape, dtype=dt, device=device))

        self.wi, self.wg, self.wo = w(n, d, ff), w(n, d, ff), w(n, ff, d)

    def draw(self, gen, d: int, ff: int) -> None:
        L.uniform_(self.wi, float(1.0 / np.sqrt(d)), gen)
        L.uniform_(self.wg, float(1.0 / np.sqrt(d)), gen)
        L.uniform_(self.wo, float(1.0 / np.sqrt(ff)), gen)


class MoE(nn.Module):
    """``router`` ``[d, E]`` (float32), the routed ``experts`` (``Ep`` of
    them) and the ``shared`` experts (None without)."""

    def __init__(self, router, experts: Experts, shared: Experts | None):
        super().__init__()
        self.router, self.experts, self.shared = router, experts, shared


def init(gen, cfg, dtype, *, device=None) -> MoE:
    """The reference's distributions, drawn from ``gen`` (None: left
    uninitialised) in the order router, ``wi``, ``wg``, ``wo``, then the
    shared experts' ``wi``, ``wg``, ``wo`` (each over all of them)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(dtype=dtype, device=device)
    router = L._param(torch.empty(d, E, dtype=torch.float32, device=device))
    experts = Experts(padded_experts(E), d, ff, **kw)
    shared = (Experts(cfg.n_shared_experts, d, ff, **kw)
              if cfg.n_shared_experts else None)
    if gen is not None:
        L.uniform_(router, float(1.0 / np.sqrt(d)), gen)
        experts.draw(gen, d, ff)
        if shared is not None:
            shared.draw(gen, d, ff)
    return MoE(router, experts, shared)


@dataclasses.dataclass
class Routing:
    """One layer's routing of ``x`` ``[B, S, d]``, every assignment in
    assignment order (token ``s``'s ``j``-th choice is ``s·k + j``):
    ``logits``/``probs`` ``[B, S, E]`` float32; ``gates``/``experts``
    ``[B, S, k]``; ``keep`` and ``slot`` ``[B, S·k]``: whether the
    assignment was kept, and its row in the ``[B, Ep·cap (+1), d]``
    buffer (``Ep·cap``, the sentinel, when dropped)."""

    logits: torch.Tensor
    probs: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int


def capacity(cfg, S: int) -> int:
    """Assignments an expert keeps per batch row (``moe.py:93``)."""
    return int(math.ceil(S * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor))


def route(p: MoE, cfg, x) -> Routing:
    """The router and the capacity rule (``moe.py:77-100``)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    Ep, A, dev = padded_experts(E), S * k, x.device
    f32 = torch.float32
    logits = x.to(f32) @ p.router.to(f32)
    probs = torch.softmax(logits, dim=-1)                     # [B, S, E]
    gates, experts = torch.topk(probs, k, dim=-1, sorted=True)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    cap = capacity(cfg, S)
    flat = experts.reshape(B, A)
    # rank of each assignment within its expert, in the stable order of
    # the reference's argsort; then back in assignment order
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_e = torch.gather(flat, 1, order)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(B, E).contiguous())
    rank_sorted = torch.arange(A, device=dev)[None, :] - torch.gather(
        seg_start, 1, sorted_e)
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < cap
    slot = torch.where(keep, flat * cap + torch.clamp_max(rank, cap - 1),
                       Ep * cap)
    return Routing(logits, probs, gates, experts, keep, slot, cap)


def aux_losses(cfg, r: Routing) -> dict:
    """``moe_lb`` and ``moe_z`` (``moe.py:84-89``), float32 scalars."""
    E = cfg.n_experts
    f32 = torch.float32
    n = r.experts.numel()
    me = r.probs.reshape(-1, E).mean(dim=0)
    # every addend is the same value, so the scatter's order cannot move
    # the sum
    ce = torch.zeros(E, dtype=f32, device=r.probs.device).scatter_add_(
        0, r.experts.reshape(-1),
        torch.full((n,), 1.0 / n, dtype=f32, device=r.probs.device))
    lb = (E * torch.sum(me * ce)).to(f32)
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2).to(f32)
    return {"moe_lb": lb, "moe_z": z}


def _swiglu(e: Experts, x, dtype, eq_in: str, eq_out: str):
    dt = L.as_dtype(dtype)
    h = F.silu(torch.einsum(eq_in, x, e.wg.to(dt))) \
        * torch.einsum(eq_in, x, e.wi.to(dt))
    return torch.einsum(eq_out, h, e.wo.to(dt))


def apply(p: MoE, cfg, x, dtype, *, aux: bool = True):
    """x: ``[B, S, d]`` -> ``(y, aux_losses)``; ``aux=False`` skips the
    aux terms (an empty dict), as the reference's serving paths drop
    them unused."""
    B, S, d = x.shape
    k = cfg.top_k
    Ep, A = padded_experts(cfg.n_experts), S * k
    dt = L.as_dtype(dtype)
    r = route(p, cfg, x)
    cap = r.cap
    # dispatch: each kept assignment's token into its slot; the dropped
    # ones into the sentinel row, sliced off
    xs = x.to(dt).unsqueeze(2).expand(B, S, k, d).reshape(B, A, d)
    buf = torch.zeros((B, Ep * cap + 1, d), dtype=dt, device=x.device)
    buf.scatter_(1, r.slot.unsqueeze(-1).expand(B, A, d), xs)
    buf = buf[:, :Ep * cap].unflatten(1, (Ep, cap))          # [B, Ep, cap, d]
    out = _swiglu(p.experts, buf, dt, "becd,edf->becf", "becf,efd->becd")
    out = out.reshape(B, Ep * cap, d)
    # combine in float32: token s sums its k gated outputs, in one order
    picked = torch.gather(
        out, 1, torch.clamp_max(r.slot, Ep * cap - 1).unsqueeze(-1)
        .expand(B, A, d)).to(torch.float32)
    contrib = torch.where(r.keep.unsqueeze(-1),
                          picked * r.gates.reshape(B, A, 1), 0.0)
    y = contrib.view(B, S, k, d).sum(dim=2).to(dt)
    if p.shared is not None:
        ys = _swiglu(p.shared, x.reshape(B * S, d).to(dt), dt,
                     "td,ndf->ntf", "ntf,nfd->ntd")     # [n_sh, B·S, d]
        y = y + ys.sum(dim=0).reshape(B, S, d)
    return y, (aux_losses(cfg, r) if aux else {})
