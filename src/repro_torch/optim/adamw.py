"""AdamW on a float32 master (no torch.optim), and ZeRO over the
data-parallel shards.

The port of ``repro.optim.adamw``. The one-device train state holds the
step and three parameter trees of one structure: the float32 ``master``
parameters (``requires_grad``), and Adam's ``m`` and ``v``. They are
``nn.Module`` trees (``models.transformer.Transformer``), so the
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

**ZeRO over the data axes.** ``zero_spec``/``zero_spec_tree`` are the
reference's: each leaf's largest free dim that the data size divides is
marked ``("pod", "data")``. On a mesh of several data-parallel shards
(``launch.mesh``) :func:`zero_layout` turns those specs into slicing
rules per reference leaf (:class:`ZeroLeaf`, the blocks stacked
``[L, ...]``), and :class:`ZeroState` holds the whole master on every
shard (the forward needs it) but ``m`` and ``v`` only for the shard's
slice of each leaf. :func:`apply_zero_updates` updates the shard's slice
of the master and all-gathers the slices, so every shard's master is the
same bits. The clip scale comes from :func:`zero_norm`: each shard's
partial sum of squares per leaf over its slice (a stacked leaf's layers
summed one after another, as ``global_norm`` does), the partials summed
over the shards in rank order, then the leaves in the reference's order.
On one shard every slice is the whole leaf and each sum is
``global_norm``'s, so the one-shard mesh gives ``apply_updates``' bits.

**Over the model axis too** (``models.tensor_parallel``): each shard's
master is a list of its pieces (its index set of each leaf), and a
:class:`ZeroLeaf` is a piece, split by the ZeRO spec over the data shards
within it. A piece only one model shard holds (``model_split``) sums its
gradient over the data shards of that model index (``over="dp"``); one
that every model shard holds, over every shard (``over="world"``, each
data shard taking its slice). The clip norm counts each element once:
per-slice partials summed in rank order over the shards that hold
different elements (:attr:`ZeroLeaf.norm_over`), then the leaves in the
reference's order.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..parallel import collectives as co
from ..parallel.sharding import DP_AXES, sanitize_spec

#: the spec entry ZeRO marks a leaf's sharded dim with
ZERO_ENTRY = ("pod", "data")


def zero_spec(spec: tuple, shape=None, data_size: int = 16) -> tuple:
    """The reference's ZeRO spec of a leaf: ``spec`` with
    :data:`ZERO_ENTRY` on the largest unsharded dim of ``shape`` that
    ``data_size`` divides (no ``shape``: the first unsharded dim);
    unchanged where there is none. On a mesh without a ``"pod"`` axis the
    name is filtered out downstream (``parallel.sharding.filter_spec``)."""
    entries = list(spec)
    if shape is not None and len(entries) < len(shape):
        entries += [None] * (len(shape) - len(entries))
    best, best_dim = None, 0
    for i, e in enumerate(entries):
        if e is not None:
            continue
        if shape is None:
            best = i
            break
        if shape[i] % data_size == 0 and shape[i] > best_dim:
            best, best_dim = i, shape[i]
    if best is not None:
        entries[best] = ZERO_ENTRY
    return tuple(entries)


def zero_spec_tree(spec_tree: dict, shape_tree: dict | None = None,
                   data_size: int = 16) -> dict:
    """:func:`zero_spec` of every leaf of ``spec_tree`` (``{path: spec}``,
    ``transformer.param_specs``), with its shape from ``shape_tree``
    (``{path: shape}``, :func:`leaf_shapes`) where given."""
    if shape_tree is None:
        return {k: zero_spec(s) for k, s in spec_tree.items()}
    return {k: zero_spec(s, tuple(shape_tree[k]), data_size)
            for k, s in spec_tree.items()}


def leaf_shapes(params: nn.Module) -> dict:
    """``{path: shape}`` of the reference's leaves of ``params`` (a
    :class:`~..models.transformer.Transformer`, the meta device will do),
    the blocks stacked ``[L, ...]``."""
    from ..models import transformer as tfm

    named = dict(params.named_parameters())
    return {path: ((len(names),) if path[0] in tfm._STACKED else ())
            + tuple(named[names[0]].shape)
            for path, names in tfm.reference_leaves(params)}


@dataclasses.dataclass(frozen=True)
class ZeroLeaf:
    """One reference leaf under ZeRO on a mesh: ``key`` its path,
    ``index`` its tensors in ``master.parameters()`` (a stacked leaf's
    layers in order), ``shape`` its reference shape, ``spec`` its ZeRO
    spec, ``dim`` the dim split over the ``n`` data-parallel shards
    (None: every shard holds it whole)."""

    key: str
    index: tuple
    stacked: bool
    shape: tuple
    spec: tuple
    dim: int | None
    n: int
    #: the shards whose partial gradients sum: the data-parallel shards of
    #: one model index (``"dp"``), or every shard (``"world"``)
    over: str = "dp"
    #: whether the model shards hold different elements of the leaf
    model_split: bool = False

    @property
    def norm_over(self) -> str | None:
        """The shards whose sums of squares add up to the leaf's (None:
        each shard holds all of it)."""
        if self.model_split:
            return "world" if self.dim is not None else "model"
        return "dp" if self.dim is not None else None

    @property
    def slice_shape(self) -> tuple:
        if self.dim is None:
            return self.shape
        s = list(self.shape)
        s[self.dim] //= self.n
        return tuple(s)

    @property
    def slice_numel(self) -> int:
        return math.prod(self.slice_shape)

    def full(self, tensors: list) -> torch.Tensor:
        """The leaf from the port's tensors (``master.parameters()`` order),
        a stacked leaf as a new ``[L, ...]`` tensor."""
        if self.stacked:
            return torch.stack([tensors[i] for i in self.index])
        return tensors[self.index[0]]

    def chunks(self, full: torch.Tensor) -> torch.Tensor:
        """``[n, slice_numel]``: row ``s`` is shard s's slice, flat."""
        return full.unflatten(self.dim, (self.n, -1)).movedim(
            self.dim, 0).reshape(self.n, -1)

    def unchunk(self, rows: torch.Tensor) -> torch.Tensor:
        """:meth:`chunks`' inverse: the leaf from its ``n`` flat slices."""
        return rows.reshape((self.n,) + self.slice_shape).movedim(
            0, self.dim).reshape(self.shape)

    def take(self, full: torch.Tensor, index: int) -> torch.Tensor:
        """Shard ``index``'s slice (the whole leaf where it is not split),
        contiguous."""
        if self.dim is None:
            return full
        lo = index * (self.shape[self.dim] // self.n)
        return full.narrow(self.dim, lo, self.shape[self.dim] // self.n) \
            .contiguous()

    def write(self, full: torch.Tensor, tensors: list) -> None:
        """Copy the leaf ``full`` into the port's tensors."""
        with torch.no_grad():
            if self.stacked:
                for li, i in enumerate(self.index):
                    tensors[i].copy_(full[li])
            else:
                tensors[self.index[0]].copy_(full)


def zero_layout(cfg, mesh) -> list:
    """The :class:`ZeroLeaf` of every reference leaf of ``cfg``'s model, in
    the reference's leaf order, for ``mesh`` (``launch.mesh``): the ZeRO
    specs at the mesh's data size (the reference's ``Trainer`` passes
    ``mesh.shape["data"]``), sanitised for the mesh, which decides the
    split dim."""
    from ..models import transformer as tfm

    params, specs = tfm.abstract_params(cfg)
    shapes = leaf_shapes(params)
    zspecs = zero_spec_tree(specs, shapes, data_size=mesh.shape["data"])
    index = {n: i for i, (n, _) in enumerate(params.named_parameters())}
    sizes = mesh.shape
    out = []
    for path, names in tfm.reference_leaves(params):
        shape = shapes[path]
        dim, n = None, 1
        for i, e in enumerate(sanitize_spec(zspecs[path], shape, mesh)):
            names_e = e if isinstance(e, tuple) else (e,)
            if e is not None and set(names_e) & set(DP_AXES):
                dim = i
                n = math.prod(sizes.get(a, 1) for a in names_e)
        out.append(ZeroLeaf("/".join(path), tuple(index[m] for m in names),
                            path[0] in tfm._STACKED, shape, zspecs[path],
                            dim, n))
    return out


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


def _coefficients(step_t: torch.Tensor, opt: OptConfig,
                  gnorm: torch.Tensor):
    """``(step + 1, lr, clip scale, bias corrections 1 and 2)``."""
    step = step_t + 1
    lr = lr_at(opt, step_t)
    # a scalar over a tensor is reciprocal-then-multiply in torch: divide
    # a tensor by the tensor, as the reference's float32 division
    scale = torch.clamp(gnorm.new_tensor(opt.clip_norm) / (gnorm + 1e-12),
                        max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(stepf.new_tensor(opt.b1), stepf)
    bc2 = 1 - torch.pow(stepf.new_tensor(opt.b2), stepf)
    return step, lr, scale, bc1, bc2


def _adam(g, p, mm, vv, opt: OptConfig, coeffs) -> torch.Tensor:
    """One element-wise AdamW update: writes m and v into ``mm``/``vv``,
    returns the new ``p``."""
    _, lr, scale, bc1, bc2 = coeffs
    g = g.to(torch.float32) * scale
    m2 = opt.b1 * mm + (1 - opt.b1) * g
    v2 = opt.b2 * vv + (1 - opt.b2) * g * g
    mhat = m2 / bc1
    vhat = v2 / bc2
    mm.copy_(m2)
    vv.copy_(v2)
    return p - lr * (mhat / (torch.sqrt(vhat) + opt.eps)
                     + opt.weight_decay * p)


def apply_updates(state: TrainState, grads, opt: OptConfig,
                  groups=None) -> TrainState:
    """One AdamW step with global-norm clipping. ``grads``: float32
    gradients in ``state.master.parameters()`` order; ``groups`` as
    :func:`global_norm`. Writes master, m and v in place and returns the
    state with the next step."""
    coeffs = _coefficients(state.step, opt, global_norm(grads, groups))
    with torch.no_grad():
        for g, p, mm, vv in zip(grads, state.master.parameters(),
                                state.m.parameters(), state.v.parameters()):
            p.copy_(_adam(g, p, mm, vv, opt, coeffs))
    return TrainState(coeffs[0], state.master, state.m, state.v)


# ---------------------------------------------------------------------------
# ZeRO over the data-parallel shards
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ZeroState:
    """The train state on a mesh of data-parallel shards: the step, the
    float32 master (``requires_grad``): the whole model, one module with
    the same bits on every shard, or under the tensor-parallel step each
    held shard's list of pieces; and per shard this process holds
    (``mesh.local``) ``m`` and ``v`` as lists of slices, one per
    :class:`ZeroLeaf`."""

    step: torch.Tensor
    master: nn.Module | list
    m: list
    v: list

    def held_masters(self) -> list:
        """Each held shard's master tensors: the whole model's parameters
        (the one module every held shard shares), or its pieces."""
        if isinstance(self.master, nn.Module):
            return [list(self.master.parameters())] * len(self.m)
        return self.master


def zero_moments(layout: list, mesh) -> list:
    """Zero slices for every leaf, per shard this process holds."""
    return [[torch.zeros(leaf.slice_shape, dtype=torch.float32,
                         device=mesh.device) for leaf in layout]
            for _ in mesh.local]


def init_zero_state(params: nn.Module, layout: list, mesh) -> ZeroState:
    """:func:`init_state`'s master of ``params`` and zero moments sliced
    by ``layout``, step 0."""
    dev = mesh.device
    master = type(params)(params.cfg, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for dst, src in zip(master.parameters(), params.parameters()):
            dst.copy_(src)
    master.requires_grad_(True)
    return ZeroState(torch.zeros((), dtype=torch.int32, device=dev), master,
                     zero_moments(layout, mesh), zero_moments(layout, mesh))


def _partial(leaf: ZeroLeaf, s: torch.Tensor) -> torch.Tensor:
    """The sum of squares of slice ``s``: a stacked leaf's layers one after
    another (``global_norm``'s order for a leaf)."""
    if leaf.stacked:
        return sum(torch.sum(torch.square(s[i])) for i in range(s.shape[0]))
    return sum(torch.sum(torch.square(x)) for x in (s,))


def zero_norm(mesh, layout: list, slices: list) -> torch.Tensor:
    """The global norm of the gradients whose slices ``slices`` (per shard
    held, per leaf) the shards hold (module docstring): float32, the same
    bits on every shard."""
    terms = [None] * len(layout)
    for axis in ("dp", "world", "model"):
        idx = [j for j, leaf in enumerate(layout) if leaf.norm_over == axis]
        if axis != "dp" and not idx:
            continue
        vecs = [torch.stack([_partial(layout[j], sl[j]) for j in idx])
                if idx else torch.zeros(0, device=mesh.device)
                for sl in slices]
        total = co.shard_sum(mesh.all_gather(axis, vecs)[0])
        for k, j in enumerate(idx):
            terms[j] = total[k]
    leaf = [terms[j] if terms[j] is not None
            else _partial(layout[j], slices[0][j]) for j in range(len(layout))]
    return torch.sqrt(sum(leaf))


def apply_zero_updates(state: ZeroState, slices: list, opt: OptConfig,
                       mesh, layout: list, buckets: list) -> ZeroState:
    """One AdamW step on a mesh: each shard this process holds updates its
    slice of each leaf from its gradient slice (``slices``, per shard held,
    per leaf) and its m and v (in place), the clip scale from
    :func:`zero_norm`; the new slices of the leaves of each bucket
    (``buckets``: lists of leaf indices) are all-gathered over the
    data-parallel shards and written into the master, so every shard's
    master is the same (one module every held shard shares, or each held
    shard's list of pieces)."""
    coeffs = _coefficients(state.step, opt, zero_norm(mesh, layout, slices))
    own = state.held_masters()
    masters = own[:1] if isinstance(state.master, nn.Module) else own
    with torch.no_grad():
        for bucket in buckets:
            news = []
            for i, s in enumerate(mesh.local):
                q = mesh.dp_index(s)
                news.append([_adam(slices[i][j], layout[j].take(
                    layout[j].full(own[i]), q), state.m[i][j],
                    state.v[i][j], opt, coeffs) for j in bucket])
            split = [k for k, j in enumerate(bucket)
                     if layout[j].dim is not None]
            if split:
                got = mesh.all_gather("dp", [torch.cat(
                    [n[k].reshape(-1) for k in split]) for n in news])
                for i, params in enumerate(masters):
                    off = 0
                    for k in split:
                        leaf = layout[bucket[k]]
                        c = leaf.slice_numel
                        leaf.write(leaf.unchunk(got[i][:, off:off + c]),
                                   params)
                        off += c
            for i, params in enumerate(masters):
                for k, j in enumerate(bucket):
                    if layout[j].dim is None:
                        layout[j].write(news[i][k], params)
    return ZeroState(coeffs[0], state.master, state.m, state.v)


def gather_moments(mesh, layout: list, moments: list, buckets: list) -> list:
    """The whole leaves of ``moments`` (``ZeroState.m`` or ``.v``) in this
    process: the slices all-gathered over the shards (every shard takes
    part), one tensor per leaf."""
    out = [None] * len(layout)
    for bucket in buckets:
        split = [j for j in bucket if layout[j].dim is not None]
        if split:
            got = mesh.all_gather("dp", [torch.cat(
                [mo[j].reshape(-1) for j in split]) for mo in moments])[0]
            off = 0
            for j in split:
                c = layout[j].slice_numel
                out[j] = layout[j].unchunk(got[:, off:off + c])
                off += c
        for j in bucket:
            if layout[j].dim is None:
                out[j] = moments[0][j]
    return out
