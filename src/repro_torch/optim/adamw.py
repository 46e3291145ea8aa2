"""AdamW on a float32 master (no torch.optim).

The port of ``repro.optim.adamw`` on one device. The train state holds
the step and three parameter trees of one structure: the float32
``master`` parameters (``requires_grad``), and Adam's ``m`` and ``v``.
They are ``nn.Module`` trees (``models.transformer.Transformer``), so the
checkpoint and the tests see each one as the reference's tree
(``transformer.to_reference_params``). The compute parameters are cast
from the master each step (``launch.steps.to_compute`` and the layers'
own cast); gradients come back through autograd in float32.

The update is the reference's, op for op, in float32: ``lr_at``
computes the schedule on the device from the step tensor (a step
captured into a CUDA graph later needs no host value), and
``global_norm`` sums the leaves' squares in the reference's leaf order
(sorted tree paths; ``groups``), since the clip scale depends on the
bits of that sum. ``apply_updates`` writes the new master, m and v into
the state's tensors in place.

Not copied: ``zero_spec``/``zero_spec_tree``, ZeRO's sharding of the
master and moments over the data axes, which needs the multi-card mesh.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor      # int32, 0-dim, on the device
    master: nn.Module       # float32, requires_grad
    m: nn.Module            # float32
    v: nn.Module            # float32


def init_state(params: nn.Module) -> TrainState:
    """A float32 copy of ``params`` (a ``Transformer``: a module built by
    ``type(params)(params.cfg, dtype=, device=)``) as the master
    (``requires_grad``) and zero moments of its structure, step 0, on its
    device."""
    dev = next(params.parameters()).device
    master, m, v = (type(params)(params.cfg, dtype=torch.float32, device=dev)
                    for _ in range(3))
    with torch.no_grad():
        for dst, src, mm, vv in zip(master.parameters(), params.parameters(),
                                    m.parameters(), v.parameters()):
            dst.copy_(src)
            mm.zero_()
            vv.zero_()
    master.requires_grad_(True)
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                      master, m, v)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr_peak: float = 3e-4
    warmup: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cos, correctly rounded but for double rounding: computed in
    float64 and rounded. The reference's float32 cos is within one ulp of
    that (1.3 % of arguments in [0, pi] differ by one; none near pi, where
    ``1 + cos`` cancels); torch's float32 cos differs from the reference's
    at 5 % of them."""
    return torch.cos(x.to(torch.float64)).to(torch.float32)


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay, a float32 0-dim tensor on
    ``step``'s device (``step``: int32). Every op is the reference's in
    float32 but the cosine (:func:`_cos`): near the end of the decay
    ``1 + cos`` cancels, and one ulp of the cosine is many of the rate."""
    warm = cfg.lr_peak * (step + 1) / max(cfg.warmup, 1)
    t = torch.clamp((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup,
                                              1), 0.0, 1.0)
    cos = 0.5 * cfg.lr_peak * (1 + _cos(math.pi * t))
    return torch.where(step < cfg.warmup, warm, cos).to(torch.float32)


def global_norm(grads, groups=None) -> torch.Tensor:
    """sqrt of the sum of squares of ``grads`` in float32. ``groups``:
    lists of indices into ``grads``, one a reference leaf (the layers of a
    stacked leaf), in the reference's leaf order; None, each gradient a
    leaf in its own order."""
    groups = [[i] for i in range(len(grads))] if groups is None else groups
    leaf = [sum(torch.sum(torch.square(grads[i].to(torch.float32)))
                for i in g) for g in groups]
    return torch.sqrt(sum(leaf))


def apply_updates(state: TrainState, grads, opt: OptConfig,
                  groups=None) -> TrainState:
    """One AdamW step with global-norm clipping. ``grads``: float32
    gradients in ``state.master.parameters()`` order; ``groups`` as
    :func:`global_norm`. Writes master, m and v in place and returns the
    state with the next step."""
    step = state.step + 1
    lr = lr_at(opt, state.step)
    gnorm = global_norm(grads, groups)
    # a scalar over a tensor is reciprocal-then-multiply in torch: divide
    # a tensor by the tensor, as the reference's float32 division
    scale = torch.clamp(gnorm.new_tensor(opt.clip_norm) / (gnorm + 1e-12),
                        max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(stepf.new_tensor(opt.b1), stepf)
    bc2 = 1 - torch.pow(stepf.new_tensor(opt.b2), stepf)
    with torch.no_grad():
        for g, p, mm, vv in zip(grads, state.master.parameters(),
                                state.m.parameters(), state.v.parameters()):
            g = g.to(torch.float32) * scale
            m2 = opt.b1 * mm + (1 - opt.b1) * g
            v2 = opt.b2 * vv + (1 - opt.b2) * g * g
            mhat = m2 / bc1
            vhat = v2 / bc2
            p.copy_(p - lr * (mhat / (torch.sqrt(vhat) + opt.eps)
                              + opt.weight_decay * p))
            mm.copy_(m2)
            vv.copy_(v2)
    return TrainState(step, state.master, state.m, state.v)
