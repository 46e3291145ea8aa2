"""Mesh builders: the port of the reference's ``launch/mesh.py``.

The reference builds its production mesh over TPU pods (16 × 16 chips in
``("data", "model")``, or 2 × 16 × 16 with a leading ``"pod"`` axis) and
a debug mesh over the local devices. The port has three meshes:

* :class:`Mesh`, the one-device 1 × 1 mesh (``make_debug_mesh()`` with
  no process group): every single-process caller, as before.
* :class:`ProcessMesh`: ``("data", "model")``, or ``("pod", "data",
  "model")`` with a leading pod axis, over a ``torch.distributed`` process
  group of ``pods × data × model`` ranks, one shard per rank (NCCL with one
  GPU per rank, gloo on the CPU or with ranks sharing a card). Shard ``s``
  sits at model index ``s % model`` of data-parallel shard ``s // model``
  (pods outermost, the model index innermost, as ``jax.make_mesh`` orders
  its devices): ``s = (pod · data + data_index) · model + model_index``.
  The rank knows its shard (its rank in the group) and holds the group's
  :class:`~..parallel.sharding.RankMesh`, on which
  :mod:`..parallel.collectives` run. An exchange along one axis runs over
  the whole group with zero-size chunks to the ranks off the axis, so an
  axis needs no process group of its own (and none is made: a subgroup
  made by its members alone hangs gloo where other groups were made
  before it).
* :class:`StackedMesh`, the same shards in one process, one after
  another: the bit reference every rank run is held to, as the stacked
  ``[P, ...]`` form is for the solve path.

Both multi-shard meshes offer the two exchanges the training step is
written in, over lists with one entry per shard this process holds
(``local``): :meth:`~ProcessMesh.all_to_all` and
:meth:`~ProcessMesh.all_gather` along ``"world"`` (every shard), ``"dp"``
(the data-parallel shards of one model index), ``"pod"``, ``"data"`` or
``"model"``. The rank form calls the collectives; the stacked form moves
the rows in memory. On them sit the reduce-scatter (the rows summed by
:func:`~..parallel.collectives.shard_sum`, in rank order), ``pmax`` and
:func:`all_sum`, one code for both forms.

**The model axis's exchanges** are autograd functions over those lists
(tensor-parallel layers, ``models.tensor_parallel``): :func:`gather_seq`
(an all-gather along ``"model"`` whose backward is the rank-order
reduce-scatter), :func:`scatter_seq` (the reduce-scatter, whose backward
is the all-gather) and :func:`model_sum` (a rank-order all-reduce whose
backward is another, or the identity where every shard goes on with the
same computation). Every rank runs every exchange, in one order: an
exchange along one axis is a collective of the whole group, so no
rank's graph may skip one another runs (a gradient a rank must not take
is multiplied by zero, not detached). In the stacked form each shard gets its own output
tensor, and every cross-shard sum, forward and backward, is
``shard_sum``'s: autograd never adds two shards' gradients itself, whose
order would not be rank order. :func:`fanout` gives a tensor's uses
copies of their own whose gradients it sums in a fixed order, where
autograd's order of accumulation could differ between the two forms.

**The production mesh** (:func:`make_production_mesh`: 16 × 16 in
``("data", "model")``, or 2 × 16 × 16 with a leading ``"pod"`` axis) is
counted, not run: :class:`MetaMesh` is one rank of such a process group
on the meta device. Its exchanges return meta tensors of the shapes the
real collective would give and record the bytes the rank puts on the
wire (``tally``: by kind, axis and dtype), so tracing a step on it under
``launch.op_cost`` gives one device's FLOPs, bytes and collectives with
nothing allocated and no process made. Every rank of a uniform mesh
holds the same shapes, so rank 0's count is every rank's. The stacked
form keeps a ``tally`` per shard the same way (:func:`tally_bytes`).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _device
from ..parallel import collectives as co

#: the exchanges' axes: every shard, the data-parallel shards of one model
#: index, each axis, then the shards of one pod
AXES = ("world", "dp", "pod", "data", "model", "in_pod")
#: the production mesh's axis sizes: (data, model), and the pods of the
#: multi-pod mesh (the reference's TPU v5e pods of 16 x 16 chips)
PRODUCTION = (16, 16)
PRODUCTION_PODS = 2


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of devices: ``devices`` nested ``shape[0]`` ×
    ``shape[1]``, one axis per name in ``axis_names``."""

    axis_names: tuple
    devices: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names,
                        (len(self.devices), len(self.devices[0]))))

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


@dataclasses.dataclass(frozen=True)
class _DataMesh:
    """``pods × data × model`` shards on ``device``; shard ``s`` sits at
    model index ``s % model`` of data-parallel shard ``s // model``, which
    sits at pod ``(s // model) // data``, data index ``(s // model) %
    data``."""

    pods: int
    data: int
    device: torch.device
    model: int = 1
    #: the bytes each held shard sends, ``{shard: {(kind, axis, dtype):
    #: [bytes, exchanges]}}`` (None: not kept; :meth:`_sent`)
    tally: dict | None = dataclasses.field(default=None, compare=False,
                                           repr=False)

    @property
    def axis_names(self) -> tuple:
        return (("pod",) if self.pods > 1 else ()) + ("data", "model")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names,
                        ((self.pods,) if self.pods > 1 else ())
                        + (self.data, self.model)))

    @property
    def size(self) -> int:
        """The number of shards."""
        return self.pods * self.data * self.model

    @property
    def dp_size(self) -> int:
        """The number of data-parallel shards."""
        return self.pods * self.data

    def dp_index(self, index: int) -> int:
        """The data-parallel shard of shard ``index``."""
        return index // self.model

    def model_index(self, index: int) -> int:
        """The model index of shard ``index``."""
        return index % self.model

    def members(self, axis: str, index: int) -> list:
        """The shards along ``axis`` through shard ``index``, in axis
        order."""
        D, M = self.data, self.model
        q, r = divmod(index, M)
        if axis == "world":
            return list(range(self.size))
        if axis == "dp":
            return [p * M + r for p in range(self.dp_size)]
        if axis == "data":
            return [(q // D * D + d) * M + r for d in range(D)]
        if axis == "pod":
            return [(p * D + q % D) * M + r for p in range(self.pods)]
        if axis == "model":
            return [q * M + m for m in range(M)]
        if axis == "in_pod":
            lo = q // D * D * M
            return list(range(lo, lo + D * M))
        raise ValueError(f"axis {axis!r} not in {AXES}")

    def axis_size(self, axis: str) -> int:
        return {"world": self.size, "dp": self.dp_size, "pod": self.pods,
                "data": self.data, "model": self.model,
                "in_pod": self.data * self.model}[axis]

    def _sent(self, shard: int, kind: str, axis: str, x: torch.Tensor,
              nbytes: int) -> None:
        """Count ``nbytes`` of ``x``'s dtype that ``shard`` puts on the
        wire in one exchange (kept where :attr:`tally` is a dict)."""
        if self.tally is None:
            return
        key = (kind, axis, str(x.dtype).removeprefix("torch."))
        row = self.tally.setdefault(shard, {}).setdefault(key, [0, 0])
        row[0] += nbytes
        row[1] += 1

    def _sent_a2a(self, shard: int, axis: str, x: torch.Tensor) -> None:
        """An all-to-all of ``x`` (``[n, ...]``): every row but the
        shard's own goes out."""
        n = self.axis_size(axis)
        self._sent(shard, "all-to-all", axis, x,
                   x.numel() * x.element_size() * (n - 1) // n)

    def _sent_gather(self, shard: int, axis: str, x: torch.Tensor) -> None:
        """An all-gather of ``x``: it goes to every other member."""
        self._sent(shard, "all-gather", axis, x,
                   x.numel() * x.element_size()
                   * (self.axis_size(axis) - 1))

    def reduce_scatter(self, axis: str, xs: list) -> list:
        """Row ``i`` of every member's ``xs[s]`` (``[n, ...]``) summed over
        the members in rank order, for the member ``i`` along ``axis``:
        :meth:`all_to_all`, then ``collectives.shard_sum``."""
        return [co.shard_sum(r) for r in self.all_to_all(axis, xs)]

    def pmax(self, axis: str, xs: list) -> list:
        """The largest of the members' scalars ``xs[s]`` along ``axis``
        (exact in any order)."""
        return [g.amax() for g in self.all_gather(axis, [x.reshape(1)
                                                         for x in xs])]


@dataclasses.dataclass(frozen=True)
class StackedMesh(_DataMesh):
    """Every shard in this process (module docstring)."""

    @property
    def local(self) -> list:
        return list(range(self.size))

    @property
    def lead(self) -> bool:
        """Whether this process logs and writes checkpoints."""
        return True

    def all_to_all(self, axis: str, xs: list) -> list:
        """``xs[s]`` ``[n, ...]`` per shard; shard s gets row ``i`` of every
        member's, where ``i`` is its place along ``axis``."""
        out = [None] * self.size
        for s in self.local:
            mem = self.members(axis, s)
            i = mem.index(s)
            out[s] = torch.stack([xs[q][i] for q in mem])
            self._sent_a2a(s, axis, xs[s])
        return out

    def all_gather(self, axis: str, xs: list) -> list:
        """Every member's ``xs[q]`` stacked in axis order, one tensor per
        group of members (shared by them)."""
        out = [None] * self.size
        for s in self.local:
            self._sent_gather(s, axis, xs[s])
            if out[s] is None:
                mem = self.members(axis, s)
                st = torch.stack([xs[q] for q in mem])
                for q in mem:
                    out[q] = st
        return out


@dataclasses.dataclass(frozen=True)
class ProcessMesh(_DataMesh):
    """This process's shard of a mesh over a process group (module
    docstring): ``index`` is its data-parallel shard, ``rank_mesh`` the
    :class:`~..parallel.sharding.RankMesh` of the whole group."""

    index: int = 0
    rank_mesh: object = None

    @property
    def local(self) -> list:
        return [self.index]

    @property
    def lead(self) -> bool:
        return self.index == 0

    @property
    def backend(self) -> str:
        return self.rank_mesh.backend

    def all_to_all(self, axis: str, xs: list) -> list:
        return [co.all_to_all(xs[0], self.rank_mesh,
                              self.members(axis, self.index))]

    def all_gather(self, axis: str, xs: list) -> list:
        return [co.all_gather(xs[0], self.rank_mesh,
                              self.members(axis, self.index))]


def all_sum(mesh, axis: str, xs: list) -> list:
    """The sum of every member's ``xs[s]`` along ``axis`` in rank order, on
    every member (an all-reduce made of a reduce-scatter and an
    all-gather of equal flat chunks, never ``all_reduce``); ``xs``: one
    tensor per shard this process holds, all of one shape."""
    n = mesh.axis_size(axis)
    shape, numel = xs[0].shape, xs[0].numel()
    pad = -numel % n
    flats = [torch.nn.functional.pad(x.reshape(-1), (0, pad)).reshape(n, -1)
             for x in xs]
    return [g.reshape(-1)[:numel].reshape(shape)
            for g in mesh.all_gather(axis, mesh.reduce_scatter(axis, flats))]


@dataclasses.dataclass(frozen=True)
class MetaMesh(_DataMesh):
    """Rank ``index`` of a process group of ``pods × data × model`` ranks,
    on the meta device (module docstring): each exchange returns a meta
    tensor of the real collective's shape and adds the bytes this rank
    sends to :attr:`tally`."""

    index: int = 0

    @property
    def local(self) -> list:
        return [self.index]

    @property
    def lead(self) -> bool:
        return self.index == 0

    @property
    def backend(self) -> str:
        return "meta"

    @property
    def name(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the sizes, pods first where there
        are several."""
        return "x".join(str(n) for n in self.shape.values())

    def all_to_all(self, axis: str, xs: list) -> list:
        self._sent_a2a(self.index, axis, xs[0])
        return [torch.empty_like(xs[0], device="meta")]

    def all_gather(self, axis: str, xs: list) -> list:
        x = xs[0]
        self._sent_gather(self.index, axis, x)
        return [torch.empty((self.axis_size(axis),) + tuple(x.shape),
                            dtype=x.dtype, device="meta")]


def make_meta_mesh(*, data: int = 1, model: int = 1, pods: int = 1,
                   index: int = 0) -> MetaMesh:
    """Rank ``index`` of a ``pods × data × model`` mesh on the meta device,
    its tally empty."""
    _check_sizes(data, model, pods)
    return MetaMesh(pods, data, torch.device("meta"), model, tally={},
                    index=index)


def make_production_mesh(*, multi_pod: bool = False) -> MetaMesh:
    """Rank 0 of the production mesh (:data:`PRODUCTION`: data 16 × model
    16; ``multi_pod``: 2 pods of them), counted on the meta device."""
    data, model = PRODUCTION
    return make_meta_mesh(data=data, model=model,
                          pods=PRODUCTION_PODS if multi_pod else 1)


def tally_bytes(mesh, shard: int | None = None, by: str = "dtype") -> dict:
    """The bytes a shard of ``mesh`` (None: the first held) sent, summed by
    ``"dtype"``, ``"kind"`` or ``"axis"`` (:attr:`_DataMesh.tally`)."""
    shard = mesh.local[0] if shard is None else shard
    at = {"kind": 0, "axis": 1, "dtype": 2}[by]
    out = {}
    for key, (nbytes, _) in (mesh.tally or {}).get(shard, {}).items():
        out[key[at]] = out.get(key[at], 0) + nbytes
    return out


def _process_mesh(pods: int, data: int, model: int, group,
                  device) -> ProcessMesh:
    """The :class:`ProcessMesh` of this rank over ``group``."""
    import torch.distributed as dist

    from ..parallel.sharding import make_rank_mesh

    n = pods * data * model
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {pods}x{data}x{model} (pod, data, model) mesh runs one "
            f"process per shard and needs an initialised process group of "
            f"{n} ranks (torch.distributed.init_process_group, or "
            "parallel.launch.spawn_ranks)")
    base = make_rank_mesh(group, axis_name="world", device=device)
    if base.size != n:
        raise ValueError(f"a {pods}x{data}x{model} mesh needs {n} ranks, "
                         f"the process group has {base.size}")
    return ProcessMesh(pods, data, base.device, model, index=base.rank,
                       rank_mesh=base)


def _check_sizes(data: int, model: int, pods: int) -> None:
    if min(data, model, pods) < 1:
        raise ValueError(f"data={data}, model={model}, pods={pods}: each "
                         "must be >= 1")


def make_debug_mesh(*, data: int = 1, model: int = 1, pods: int = 1,
                    device=None, group=None):
    """The mesh of ``pods × data × model`` shards. With no ``group`` and one
    shard: the one-device :class:`Mesh` on ``device`` (None: the GPU).
    Else a :class:`ProcessMesh` over ``group`` (None: the default process
    group, which must be initialised and hold ``pods × data × model``
    ranks), this rank's tensors on ``device`` (:func:`~..parallel.
    sharding.make_rank_mesh`'s rule)."""
    _check_sizes(data, model, pods)
    if group is None and data * pods * model == 1:
        dev = _device.resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh(("data", "model"), ((dev,),))
    return _process_mesh(pods, data, model, group, device)


def make_stacked_mesh(*, data: int = 1, model: int = 1, pods: int = 1,
                      device=None) -> StackedMesh:
    """``pods × data × model`` shards in this process on ``device`` (None:
    the GPU): the stacked form of :class:`ProcessMesh`."""
    _check_sizes(data, model, pods)
    dev = _device.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return StackedMesh(pods, data, dev, model)


# ---------------------------------------------------------------------------
# the model axis's exchanges, as autograd functions over per-shard lists
# ---------------------------------------------------------------------------


def _rows(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` cut into ``n`` equal chunks along ``dim``, stacked ``[n, ...]``
    (row i to member i)."""
    return x.unflatten(dim, (n, -1)).movedim(dim, 0)


def _joined(g: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`_rows`' inverse: a new tensor of the ``[n, ...]`` rows
    concatenated along ``dim``."""
    return torch.cat(g.unbind(0), dim)


def _grads(gs, like) -> list:
    """The output gradients, zeros where autograd passes none (``like``:
    the outputs' ``(shape, dtype)``)."""
    return [g if g is not None else torch.zeros(
        shape, dtype=dt, device=dev) for g, (shape, dt, dev) in zip(gs, like)]


def _like(outs) -> list:
    return [(o.shape, o.dtype, o.device) for o in outs]


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dim, *xs):
        ctx.mesh, ctx.dim = mesh, dim
        out = tuple(_joined(g, dim) for g in mesh.all_gather(
            "model", [x.contiguous() for x in xs]))
        ctx.like = _like(out)
        return out

    @staticmethod
    def backward(ctx, *gs):
        mesh, dim = ctx.mesh, ctx.dim
        rows = [_rows(g, dim, mesh.model) for g in _grads(gs, ctx.like)]
        return (None, None) + tuple(mesh.reduce_scatter("model", rows))


def _scatter_rows(mesh, rows: list) -> list:
    """The row-parallel products' reduce-scatter (:func:`scatter_seq`'s
    forward): row ``i`` of each model shard's ``rows`` summed over them in
    rank order, for model index ``i`` (``mesh.reduce_scatter`` along
    ``"model"``)."""
    return mesh.reduce_scatter("model", rows)


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dim, *xs):
        ctx.mesh, ctx.dim = mesh, dim
        out = tuple(_scatter_rows(mesh, [_rows(x, dim, mesh.model)
                                         for x in xs]))
        ctx.like = _like(out)
        return out

    @staticmethod
    def backward(ctx, *gs):
        got = ctx.mesh.all_gather("model", [g.contiguous() for g in
                                            _grads(gs, ctx.like)])
        return (None, None) + tuple(_joined(g, ctx.dim) for g in got)


class _AxisSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, summed, *xs):
        ctx.mesh, ctx.axis, ctx.summed = mesh, axis, summed
        out = tuple(t.clone() for t in all_sum(mesh, axis, list(xs)))
        ctx.like = _like(out)
        return out

    @staticmethod
    def backward(ctx, *gs):
        gs = _grads(gs, ctx.like)
        if not ctx.summed:
            return (None, None, None) + tuple(gs)
        return (None, None, None) + tuple(
            t.clone() for t in all_sum(ctx.mesh, ctx.axis, gs))


class _Fanout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, x):
        return tuple(x.clone() for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        total = None
        for g in gs:
            if g is not None:
                total = g if total is None else total + g
        return None, total


def gather_seq(mesh, xs: list, dim: int = 1) -> list:
    """Every model shard's ``xs[s]`` concatenated along ``dim`` in model
    order, one new tensor per shard held; backward: the rank-order
    reduce-scatter of the gradients along ``dim``."""
    return list(_GatherSeq.apply(mesh, dim, *xs))


def scatter_seq(mesh, xs: list, dim: int = 1) -> list:
    """The model shards' partial ``xs[s]`` summed in rank order, each shard
    keeping its chunk along ``dim``; backward: the all-gather."""
    return list(_ScatterSeq.apply(mesh, dim, *xs))


def model_sum(mesh, xs: list, *, replicated: bool = False,
              axis: str = "model") -> list:
    """The partial ``xs[s]`` of the shards along ``axis`` (the model shards)
    summed in rank order, on every one. Backward: the rank-order sum of the
    gradients (each shard goes on with its own computation), or with
    ``replicated`` the gradient as it is (every shard goes on with the
    same computation, so each holds the whole gradient)."""
    return list(_AxisSum.apply(mesh, axis, not replicated, *xs))


def model_max(mesh, xs: list) -> list:
    """The elementwise largest of the model shards' ``xs[s]`` (no
    gradient; exact in any order)."""
    return [g.amax(0) for g in mesh.all_gather(
        "model", [x.detach().contiguous() for x in xs])]


def fanout(x: torch.Tensor, n: int) -> tuple:
    """``n`` copies of ``x``, one per use, whose gradients the backward sums
    in their order."""
    return _Fanout.apply(n, x)
