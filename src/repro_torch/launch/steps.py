"""The train, prefill and decode steps.

The port of ``repro.launch.steps`` on one device. ``make_train_step``
gives the step the trainer runs: the loss of :func:`loss_fn` (the
non-block leaves cast to the compute dtype once, the blocks one layer at
a time inside ``forward_train``), its float32 gradients by autograd with
respect to the master, and one AdamW update in place. With
``microbatch`` the batch's rows go through in consecutive slices of that
many and the step takes the exact mean: float32 sums of the slices'
losses and gradients, divided by their number, as the reference's scan.

Not copied: the sharding specs (``batch_spec_tree``, ``cache_spec_tree``,
the steps' spec trees) and ``pod_wire``, the per-pod step with the
integer-wire gradient reduction: both need the multi-card mesh.
"""
from __future__ import annotations

import torch

from ..models import transformer as tfm
from ..models.config import ModelConfig
from ..optim import OptConfig, TrainState, apply_updates


def loss_fn(cfg: ModelConfig, master, batch) -> torch.Tensor:
    """``forward_train`` of the compute parameters cast from ``master``."""
    return tfm.forward_train(cfg, tfm.to_compute(cfg, master), batch)


def value_and_grad(cfg: ModelConfig, master, batch):
    """(loss, float32 gradients in ``master.parameters()`` order); a
    parameter the loss does not reach (a padded expert) gets zeros, as
    ``jax.grad`` gives."""
    params = list(master.parameters())
    loss = loss_fn(cfg, master, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(params, grads)]


def grads_of(cfg: ModelConfig, master, batch, microbatch: int | None = None):
    """:func:`value_and_grad` of the whole batch, or the exact mean over
    its slices of ``microbatch`` rows."""
    if microbatch is None:
        return value_and_grad(cfg, master, batch)
    n_micro = batch["tokens"].shape[0] // microbatch
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    gsum = [torch.zeros_like(p, dtype=torch.float32)
            for p in master.parameters()]
    for i in range(n_micro):
        sl = slice(i * microbatch, (i + 1) * microbatch)
        loss, grads = value_and_grad(cfg, master,
                                     {k: v[sl] for k, v in batch.items()})
        loss_sum = loss_sum + loss
        gsum = [a + g for a, g in zip(gsum, grads)]
    return loss_sum / n_micro, [g / n_micro for g in gsum]


def make_train_step(cfg: ModelConfig, opt: OptConfig,
                    pod_wire: str | None = None,
                    microbatch: int | None = None):
    """``train_step(state, batch) -> (state, {"loss"})``: the gradients of
    :func:`grads_of`, then ``apply_updates`` with the global norm summed
    in the reference's leaf order."""
    if pod_wire is not None:
        raise NotImplementedError(
            "pod_wire (the per-pod step with the integer-wire gradient "
            "reduction) needs the multi-card mesh, which the port does not "
            "have yet")
    groups = tfm.reference_groups(tfm.Transformer(cfg, device="meta"))

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = grads_of(cfg, state.master, batch, microbatch)
        state = apply_updates(state, grads, opt, groups)
        return state, {"loss": loss}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        return tfm.forward_prefill(cfg, params, batch, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """serve_step: one new token against an existing cache (written in
    place); the next token by argmax, ``[B, 1]`` int32."""
    def decode_step(params, tokens, cache):
        logits, new_cache = tfm.forward_decode(cfg, params, tokens, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache

    return decode_step
