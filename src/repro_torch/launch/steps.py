"""The train, prefill and decode steps.

The port of ``repro.launch.steps``. ``make_train_step`` gives the step
the trainer runs: the loss of :func:`loss_fn` (the non-block leaves cast
to the compute dtype once, the blocks one layer at a time inside
``forward_train``), its float32 gradients by autograd with respect to
the master, and one AdamW update in place. With ``microbatch`` the
batch's rows go through in consecutive slices of that many and the step
takes the exact mean: float32 sums of the slices' losses and gradients,
divided by their number, as the reference's scan.

**On a mesh of data-parallel shards** (``launch.mesh``: one rank per
shard, or the stacked form, every shard in one process one after
another), ``make_train_step(..., mesh=)`` gives the ZeRO step. Each
shard computes the loss and gradients of its rows; the gradients are
reduced over the ``("pod", "data")`` shards, and each shard takes the
ZeRO update of its slices (``optim.adamw.apply_zero_updates``):

* plain: a reduce-scatter in buckets of :data:`BUCKET` elements (an
  all-to-all of equal chunks, each shard's chunk summed over the shards
  in rank order by ``collectives.shard_sum``, never ``all_reduce``: NCCL's
  ring and tree orders are not rank order), then ``/ P``;
* ``grad_compression=bits``: ``optim.compression.compressed_psum`` of
  ``g / P`` with each shard's own error buffer: the quantised values go
  through the same reduce-scatter (the reference's compressed step);
* ``pod_wire='u16'|'u8'``: the mean over the data axis inside a pod (a
  rank-order reduce-scatter into one chunk per data shard), then across
  the pod axis through ``optim.compression.compressed_wire_reduce`` on
  that chunk, leaf by reference leaf, the chunks gathered back inside
  the pod (:func:`pod_wire_gradients`); each shard then takes its
  slices. The reference hard-codes 2 pods, and so does the port.

The loss is the rank-order mean of the shards' losses. The rank form and
the stacked form run one code path over the mesh's exchanges, so the
stacked form is the bit reference of every rank run; on one shard the
step gives the one-device step's bits.

:func:`batch_spec_tree` and :func:`cache_spec_tree` are the reference's
logical specs, kept as data (``parallel.sharding``); the synthetic
stream places batches with the first (``data.synthetic.place_batch``).
The port's cache over the model shards is ``models.tensor_parallel``'s
(:func:`make_prefill_step` and :func:`make_decode_step` on a mesh: one
rank per model shard, each shard's pieces, rows and cache; never the
one-device step on each rank), which holds the same bytes a device as
the second.

**With a model axis** (``mesh.model`` > 1) each shard computes the
tensor-parallel loss of its data shard's rows (``models.
tensor_parallel``: every model shard of a data shard reads the same rows)
and the gradients of its pieces; a piece's gradient sums over the data
shards of its model index, or over every shard for a piece each model
shard holds (``ZeroLeaf.over``), before the ZeRO update within the model
shard. The two compressed exchanges there are the reference's:

* ``grad_compression=bits`` runs replicated over ``"model"``, as the
  reference's ``shard_map`` step: every model shard of a data shard holds
  the whole model and computes the same loss and gradients on the same
  rows, and ``compressed_psum`` with its own error buffers runs over the
  data shards of its model index (the step above, ``"dp"`` one model
  index at a time), so the model shards of a data shard stay bit-equal;
* ``pod_wire`` runs the tensor-parallel step with GSPMD's part done by
  hand inside each pod (:func:`pod_wire_gradients`): each piece's
  gradient is reduce-scattered over the pod's shards that sum it (its
  data shards, or all of the pod's for a piece every model shard holds)
  into one chunk per data index, divided by the pod's data shards, then
  ``compressed_wire_reduce`` runs across the pods on the chunks of a
  reference leaf's pieces joined, its ``u8`` scale shared by every shard
  (the whole leaf's, as the reference's), and the chunks are all-gathered
  over the pod's data shards before each shard takes its ZeRO slices.
"""
from __future__ import annotations

import itertools

import torch

from ..models import transformer as tfm
from ..models.config import ModelConfig
from ..optim import OptConfig, TrainState, apply_updates
from ..optim import adamw
from ..optim.compression import compressed_psum, compressed_wire_reduce
from ..parallel import collectives as co
from .mesh import Mesh, all_sum

#: elements of float32 gradient per exchange bucket (256 MiB): a staged
#: exchange holds one bucket on the host, not a rank's whole gradient
BUCKET = 1 << 26
#: the pod counts ``pod_wire`` runs over (the reference's 2)
WIRE_PODS = 2


def batch_spec_tree(batch_tree: dict) -> dict:
    """Every batch leaf's leading dim over the data-parallel axes."""
    return {k: (("pod", "data"),) + (None,) * (len(v.shape) - 1)
            for k, v in batch_tree.items()}


def cache_spec_tree(cfg: ModelConfig, cache_tree: dict) -> dict:
    """The reference's cache specs: batch over the data-parallel axes; the
    KV-head axis over ``"model"`` when the head count divides 16, else the
    head dim (GQA models with few KV heads); SSM states' heads and
    channels over ``"model"``. ``cache_tree``: ``{name: tensor}``
    (``transformer.init_cache``)."""
    kv_on_heads = cfg.n_kv_heads % 16 == 0
    dp = ("pod", "data")

    def spec(name, leaf):
        if name in ("k", "v", "ek", "ev"):          # [L, B, S, KV, hd]
            return (None, dp, None, "model", None) if kv_on_heads else \
                (None, dp, None, None, "model")
        if name == "conv":                          # [L, B, K-1, ch]
            return (None, dp, None, "model")
        if name == "ssm":                           # [L, B, H, N, P]
            return (None, dp, "model", None, None)
        if name == "len":
            return (dp,)
        return (None,) * len(leaf.shape)

    return {k: spec(k, v) for k, v in cache_tree.items()}


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


def buckets(layout: list, limit: int = BUCKET) -> list:
    """The leaves' indices in runs of consecutive leaves of at most
    ``limit`` elements (a larger leaf alone)."""
    out, cur, size = [], [], 0
    for j, leaf in enumerate(layout):
        n = leaf.slice_numel * leaf.n
        if cur and size + n > limit:
            out.append(cur)
            cur, size = [], 0
        cur.append(j)
        size += n
    return out + ([cur] if cur else [])


def reduce_gradients(mesh, layout: list, grads: list, *,
                     mean: bool = True) -> list:
    """The shards' gradients (``grads``: per shard this process holds, in
    the order ``layout``'s indices read) summed in rank order over the
    shards each leaf's ``over`` names (divided by the data-parallel shard
    count where ``mean``), as each held shard's slices, one per leaf of
    ``layout``: a reduce-scatter per bucket for the split leaves (over
    every shard, each data shard's slice to all its model shards), an
    all-reduce for the others."""
    P = mesh.dp_size
    out = [[None] * len(layout) for _ in grads]
    for axis in ("dp", "world"):
        split = [j for j, leaf in enumerate(layout)
                 if leaf.dim is not None and leaf.over == axis]
        for bucket in buckets([layout[j] for j in split]):
            idx = [split[k] for k in bucket]
            sends = [torch.cat([layout[j].chunks(layout[j].full(g))
                                for j in idx], dim=1) for g in grads]
            if axis == "world":
                sends = [x.repeat_interleave(mesh.model, 0) for x in sends]
            for i, tot in enumerate(mesh.reduce_scatter(axis, sends)):
                tot = tot / P if mean else tot
                off = 0
                for j in idx:
                    c = layout[j].slice_numel
                    out[i][j] = tot[off:off + c].view(layout[j].slice_shape)
                    off += c
    for j, leaf in enumerate(layout):
        if leaf.dim is None:
            tot = all_sum(mesh, leaf.over, [leaf.full(g) for g in grads])
            for i, t in enumerate(tot):
                out[i][j] = t / P if mean else t
    return out


def pod_wire_gradients(mesh, layout: list, grads: list, wire: str) -> list:
    """The shards' gradients (per shard held, in the order ``layout``'s
    indices read: whole leaves, or over a model axis each shard's pieces,
    ``models.tensor_parallel``) as each held shard's slices, through the
    pod wire (module docstring): per piece of ``layout``, the mean over
    the pod's data shards in one chunk per data index; per reference
    leaf, ``compressed_wire_reduce`` of its pieces' chunks joined, across
    the pods (its ``u8`` scale over every shard: the whole leaf's); the
    chunks gathered back over the data shards. The wire is elementwise but
    for that scale, so the result is the one of the mean and the wire on
    whole leaves."""
    D, M = mesh.data, mesh.model
    out = [[None] * len(layout) for _ in grads]
    for _, group in itertools.groupby(
            range(len(layout)),
            key=lambda j: layout[j].key.removesuffix("+shared")):
        group, pieces, shapes = list(group), [], []
        for j in group:
            fulls = [layout[j].full(g) for g in grads]
            shapes.append(fulls[0].shape)
            rows = [torch.nn.functional.pad(
                x.reshape(-1), (0, -x.numel() % D)).reshape(D, -1)
                for x in fulls]
            axis = "data"
            if layout[j].over == "world":
                axis = "in_pod"
                rows = [x.repeat_interleave(M, 0) for x in rows]
            pieces.append([t / D for t in mesh.reduce_scatter(axis, rows)])
        del fulls, rows
        sizes = [p[0].numel() for p in pieces]
        joined = compressed_wire_reduce(
            [torch.cat(ps) for ps in zip(*pieces)], mesh, "pod", wire,
            scale_axis="world")
        for j, shape, parts in zip(group, shapes, zip(
                *(torch.split(x, sizes) for x in joined))):
            for i, (g, s) in enumerate(zip(mesh.all_gather("data", parts),
                                           mesh.local)):
                whole = g.reshape(-1)[:shape.numel()].reshape(shape)
                out[i][j] = layout[j].take(whole, mesh.dp_index(s))
    return out


def mean_loss(mesh, losses: list) -> torch.Tensor:
    """The rank-order mean of the shards' losses (the same bits on every
    shard)."""
    got = mesh.all_gather("dp", [l.reshape(1) for l in losses])[0]
    return co.shard_sum(got.reshape(-1)) / mesh.dp_size


def _mesh_step(cfg: ModelConfig, opt: OptConfig, mesh, *, pod_wire,
               microbatch, grad_compression):
    """The step on a mesh of data-parallel shards (module docstring):
    ``train_step(state, errs, batches) -> (state, errs, {"loss"})`` with a
    ``ZeroState``, the error buffers per shard held (None without
    compression) and one batch per shard held."""
    if pod_wire is not None:
        if pod_wire not in ("u16", "u8"):
            raise ValueError(f"pod_wire {pod_wire!r} not in ('u16', 'u8')")
        if mesh.pods != WIRE_PODS:
            raise ValueError(f"pod_wire runs over {WIRE_PODS} pods (the "
                             f"reference's), the mesh has {mesh.pods}")
        if grad_compression is not None:
            raise ValueError("pod_wire and grad_compression are two ways to "
                             "compress the gradient exchange: pick one")
    if mesh.model > 1 and grad_compression is None:
        return _model_step(cfg, opt, mesh, pod_wire=pod_wire,
                           microbatch=microbatch)
    layout = adamw.zero_layout(cfg, mesh)
    bks = buckets(layout)
    P = mesh.dp_size

    def train_step(state, errs, batches):
        losses, grads = [], []
        for b in batches:
            loss, g = grads_of(cfg, state.master, b, microbatch)
            losses.append(loss)
            grads.append(g)
        if pod_wire is not None:
            slices = pod_wire_gradients(mesh, layout, grads, pod_wire)
        elif grad_compression is not None:
            slices, errs = compressed_psum(
                [[x / P for x in g] for g in grads], errs, grad_compression,
                mesh=mesh, layout=layout)
        else:
            slices = reduce_gradients(mesh, layout, grads)
        del grads
        state = adamw.apply_zero_updates(state, slices, opt, mesh, layout,
                                         bks)
        return state, errs, {"loss": mean_loss(mesh, losses)}

    train_step.layout = layout
    train_step.buckets = bks
    return train_step


def _model_step(cfg: ModelConfig, opt: OptConfig, mesh, *, pod_wire,
                microbatch):
    """The step on a mesh with a model axis (module docstring): the
    tensor-parallel loss and gradients of each held shard's pieces
    (``models.tensor_parallel``), reduced (across the pods through
    ``pod_wire`` where it is set), then the ZeRO update of its slices."""
    from ..models import tensor_parallel as tp

    # under the pod wire the reference's step sees one pod's batch
    ctx = tp.make_ctx(cfg, mesh,
                      batch_axis="dp" if pod_wire is None else "data")
    layout = tp.zero_layout(cfg, mesh, ctx.layout)
    bks = buckets(layout)

    def train_step(state, errs, batches):
        losses, grads = tp.grads_of(ctx, state.master, batches, microbatch)
        if pod_wire is None:
            slices = reduce_gradients(mesh, layout, grads)
        else:
            slices = pod_wire_gradients(mesh, layout, grads, pod_wire)
        del grads
        state = adamw.apply_zero_updates(state, slices, opt, mesh, layout,
                                         bks)
        return state, errs, {"loss": mean_loss(mesh, losses)}

    train_step.layout = layout
    train_step.buckets = bks
    train_step.ctx = ctx
    return train_step


def tensor_parallel(step) -> bool:
    """Whether ``step`` (``make_train_step``'s on a mesh) is the
    tensor-parallel step, whose state holds each shard's pieces (the
    compressed step holds the whole model on every model shard)."""
    return getattr(step, "ctx", None) is not None


def init_mesh_state(step, params, mesh):
    """The step-0 ``ZeroState`` of ``params`` (a ``Transformer``) for
    ``step``, the ZeRO step on ``mesh``: each held shard's pieces under
    the tensor-parallel step, else the whole model, sliced by the step's
    layout."""
    if tensor_parallel(step):
        from ..models import tensor_parallel as tp

        return tp.init_state(params, step.ctx.layout, step.layout, mesh)
    return adamw.init_zero_state(params, step.layout, mesh)


def make_train_step(cfg: ModelConfig, opt: OptConfig,
                    pod_wire: str | None = None,
                    microbatch: int | None = None, *, mesh=None,
                    grad_compression: int | None = None):
    """Without a mesh (or on the one-device :class:`~.mesh.Mesh`):
    ``train_step(state, batch) -> (state, {"loss"})``, the gradients of
    :func:`grads_of`, then ``apply_updates`` with the global norm summed
    in the reference's leaf order. On a mesh of data-parallel shards: the
    ZeRO step of the module docstring, ``train_step(state, errs,
    batches)``, with ``microbatch`` rows per slice of each shard's
    batch."""
    if mesh is not None and not isinstance(mesh, Mesh):
        return _mesh_step(cfg, opt, mesh, pod_wire=pod_wire,
                          microbatch=microbatch,
                          grad_compression=grad_compression)
    if pod_wire is not None:
        raise ValueError(
            "pod_wire reduces the gradients across the pod axis: it needs "
            "a mesh with 2 pods (launch.mesh.make_debug_mesh(pods=2, ...))")
    groups = tfm.reference_groups(tfm.Transformer(cfg, device="meta"))

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = grads_of(cfg, state.master, batch, microbatch)
        state = apply_updates(state, grads, opt, groups)
        return state, {"loss": loss}

    return train_step


def _serve_ctx(cfg: ModelConfig, mesh):
    """The tensor-parallel serving context on ``mesh`` (a mesh of shards),
    or None on the one-device mesh or without one."""
    if mesh is None or isinstance(mesh, Mesh):
        return None
    from ..models import tensor_parallel as tp

    return tp.make_ctx(cfg, mesh, serve=True)


def make_prefill_step(cfg: ModelConfig, max_len: int, mesh=None):
    """``prefill_step(params, batch) -> (logits, cache)``: the one-device
    ``forward_prefill``. On a mesh of shards (``launch.mesh``: one rank
    per shard, or the stacked form), ``prefill_step(pieces, batches)``:
    ``models.tensor_parallel.forward_prefill`` over each held shard's
    pieces (``tensor_parallel.serve_pieces``) and its data shard's batch,
    each shard's vocabulary columns of the logits and its cache."""
    ctx = _serve_ctx(cfg, mesh)
    if ctx is not None:
        from ..models import tensor_parallel as tp

        def prefill_step(pieces, batches):
            return tp.forward_prefill(ctx, pieces, batches, max_len)

        prefill_step.ctx = ctx
        return prefill_step

    def prefill_step(params, batch):
        return tfm.forward_prefill(cfg, params, batch, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """serve_step: one new token against an existing cache (written in
    place); the next token by argmax, ``[B, 1]`` int32. On a mesh of
    shards, ``decode_step(pieces, tokens, caches)`` over each held
    shard's pieces, tokens and cache (``tensor_parallel.forward_decode``),
    the next token the argmax across the shards' vocabulary columns,
    ``[b, 1]`` on every shard (``tensor_parallel.next_tokens``)."""
    ctx = _serve_ctx(cfg, mesh)
    if ctx is not None:
        from ..models import tensor_parallel as tp

        def decode_step(pieces, tokens, caches):
            logits, caches = tp.forward_decode(ctx, pieces, tokens, caches)
            return tp.next_tokens(ctx, logits), caches

        decode_step.ctx = ctx
        return decode_step

    def decode_step(params, tokens, cache):
        logits, new_cache = tfm.forward_decode(cfg, params, tokens, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache

    return decode_step
