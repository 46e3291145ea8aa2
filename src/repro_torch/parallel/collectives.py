"""The collectives of a rank mesh (:class:`.sharding.RankMesh`): the only
place the port calls ``torch.distributed``'s collectives.

* :func:`rank_sum`: a scalar summed over the ranks in rank order, the
  reference's ``psum`` as the stacked form sums its shards
  (:func:`shard_sum`). It is an ``all_gather`` of every rank's partial and
  then that sum, never an ``all_reduce``: NCCL's ring and tree orders
  differ from rank order, and the bits would then differ from the
  stacked run. Every rank gets the same value, so every rank takes the
  same branches.
* :func:`gather_blocks`: every rank's ``[1, n_pad(, nb)]`` block, stacked
  ``[P, n_pad(, nb)]`` (``all_gather_into_tensor``).
* :func:`ring_exchange`: one round of the ring (``batch_isend_irecv``):
  this rank's buffer to rank ``(p + shift) % P``, a buffer of the same
  shape from rank ``(p - shift) % P``.
* :func:`gather_values`: a few float64 values of every rank on the host
  (the solvers' end-of-solve cross-check, the memory sums).
* :func:`all_to_all`: equal chunks ``[n, ...]``, row i to rank
  ``members[i]`` (``all_to_all_single``; a subset of the ranks through
  zero-size chunks to the others); :func:`all_gather`: every member's
  block, stacked. The training side's meshes build the reduce-scatter
  (the received rows summed by :func:`shard_sum`, in rank order) and
  ``pmax`` on these (``launch.mesh``).

**Wire dtypes.** Gloo refuses ``int16``/``uint16`` and NCCL has no
16-bit unsigned type, so a 16-bit pattern travels as the same bits viewed
as ``bfloat16`` (:func:`u16_wire`), a byte as ``uint8``. No collective
sums on the wire: the sums are :func:`shard_sum`'s, after the exchange.

**The staging rule.** Gloo's transport reads and writes host memory.
Where a gloo mesh's ranks hold CUDA tensors (four ranks sharing one
card), every collective copies its inputs to host buffers, runs there and
copies the result back (:attr:`.sharding.RankMesh.stages`). The backend
chooses the rule before the call; nothing is tried and caught.

**Capture.** NCCL's collectives run on the card and a CUDA graph captures
them. Gloo's run on the host and cannot be captured: a gloo collective
called while the current stream captures raises.
"""
from __future__ import annotations

import numpy as np
import torch


def shard_sum(parts: torch.Tensor) -> torch.Tensor:
    """``[P]`` per-shard partials summed in rank order, the reference's
    ``psum`` (one add per shard, so the order is fixed)."""
    total = parts[0]
    for p in range(1, parts.shape[0]):
        total = total + parts[p]
    return total


def _check(mesh) -> None:
    if mesh.backend == "gloo" and mesh.device.type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a gloo collective runs on the host and cannot be captured "
            "into a CUDA graph: run the rank solvers of a gloo mesh under "
            "solvers.graphs.eager(), or use NCCL with one card per rank")


def _staged(mesh, out: torch.Tensor, inputs, call) -> torch.Tensor:
    """``call(out, *inputs)`` on the mesh's tensors, or, under the staging
    rule, on host copies with the result copied back into ``out``."""
    _check(mesh)
    if not mesh.stages:
        call(out, *inputs)
        return out
    host_out = torch.empty(out.shape, dtype=out.dtype)
    call(host_out, *(t.cpu() for t in inputs))
    out.copy_(host_out)
    return out


def _all_gather(mesh, block: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    # gloo takes the output only as the blocks concatenated along dim 0
    block = block.contiguous()
    out = block.new_empty((mesh.size * block.shape[0],)
                          + tuple(block.shape[1:]))
    # all_gather_into_tensor under its newer name where torch has it
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    _staged(mesh, out, (block,), lambda o, b: gather(o, b, group=mesh.group))
    return out.reshape((mesh.size,) + tuple(block.shape))


def rank_sum(partial: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's scalar ``partial`` summed over the mesh's ranks in rank
    order (module docstring): the same bits on every rank, and the bits
    the stacked form's :func:`shard_sum` gives for the same partials."""
    return shard_sum(_all_gather(mesh, partial.reshape(1)).reshape(-1))


def gather_blocks(block: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's ``[1, n_pad(, nb)]`` block and every other rank's,
    stacked ``[P, n_pad(, nb)]`` in rank order."""
    return _all_gather(mesh, block[0])


def _peer(mesh, group_rank: int) -> int:
    import torch.distributed as dist

    if mesh.group is None:
        return group_rank
    return dist.get_global_rank(mesh.group, group_rank)


def ring_exchange(buf: torch.Tensor, shift: int, mesh) -> torch.Tensor:
    """One round of the ring: ``buf`` goes to rank ``(p + shift) % P``,
    and the buffer rank ``(p - shift) % P`` sends comes back (every rank
    sends the same shape)."""
    import torch.distributed as dist

    P, p = mesh.size, mesh.rank
    dst, src = _peer(mesh, (p + shift) % P), _peer(mesh, (p - shift) % P)

    def call(out, sbuf):
        ops = [dist.P2POp(dist.isend, sbuf, dst, mesh.group),
               dist.P2POp(dist.irecv, out, src, mesh.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    buf = buf.contiguous()
    return _staged(mesh, torch.empty_like(buf), (buf,), call)


def all_to_all(chunks: torch.Tensor, mesh, members=None) -> torch.Tensor:
    """``chunks`` ``[n, ...]``: row i goes to rank ``members[i]``; returns
    the rows those ranks sent this one, ``[n, ...]`` in their order (every
    rank sends the same shape). ``members``: ascending ranks of the
    mesh's group, this one among them (None: every rank). A subset
    exchanges over the whole group with zero-size chunks to the others
    (``all_to_all_single``'s split sizes), so an axis of a mesh needs no
    process group of its own: every rank of the group calls together."""
    import torch.distributed as dist

    members = list(range(mesh.size)) if members is None else list(members)
    if chunks.shape[0] != len(members):
        raise ValueError(f"all_to_all of {chunks.shape[0]} chunks to "
                         f"{len(members)} ranks")
    if members != sorted(members) or mesh.rank not in members:
        raise ValueError(f"members {members} must ascend and hold rank "
                         f"{mesh.rank}")
    chunks = chunks.contiguous()
    if len(members) == mesh.size:
        return _staged(mesh, torch.empty_like(chunks), (chunks,),
                       lambda o, c: dist.all_to_all_single(
                           o, c, group=mesh.group))
    splits = [0] * mesh.size
    for m in members:
        splits[m] = 1
    return _staged(mesh, torch.empty_like(chunks), (chunks,),
                   lambda o, c: dist.all_to_all_single(
                       o, c, output_split_sizes=splits,
                       input_split_sizes=splits, group=mesh.group))


def all_gather(block: torch.Tensor, mesh, members=None) -> torch.Tensor:
    """This rank's ``block`` and every other member's (None: every rank),
    ``[n, *block.shape]`` in rank order."""
    if members is None or len(members) == mesh.size:
        return _all_gather(mesh, block)
    return all_to_all(block.unsqueeze(0).expand(
        (len(members),) + tuple(block.shape)), mesh, members)


def u16_wire(u: torch.Tensor) -> torch.Tensor:
    """16-bit patterns (int64 or int32 holding 0..65535) as ``bfloat16``
    tensors of the same bits, the form they travel in."""
    return u.to(torch.int32).to(torch.int16).view(torch.bfloat16)


def u16_from_wire(w: torch.Tensor) -> torch.Tensor:
    """:func:`u16_wire`'s inverse: the patterns as int64 in 0..65535."""
    return w.view(torch.int16).to(torch.int64) & 0xFFFF


def gather_values(values, mesh) -> np.ndarray:
    """A few float64 values of this rank, and every other rank's, as a
    host ``[P, k]`` array (a sync: for checks outside the solve loops)."""
    v = torch.as_tensor(np.asarray(values, np.float64).reshape(-1),
                        device=mesh.device)
    return _all_gather(mesh, v).cpu().numpy()


def same_on_every_rank(values, mesh, what: str) -> None:
    """Raise unless every rank passes the same ``values`` (bit for bit):
    the rank solvers' one-line cross-check that every rank took the same
    branches."""
    got = gather_values(values, mesh)
    if not (got == got[:1]).all():
        raise RuntimeError(f"{what} differs across the ranks: {got.tolist()}")


def warm_up(mesh) -> None:
    """One gather and one round of the ring per shift on the mesh, so
    that NCCL creates its communicators (the group's, and any it keeps
    for pairs of ranks) now and never inside a graph capture."""
    got = gather_values([mesh.rank], mesh)
    if got[:, 0].tolist() != list(range(mesh.size)):
        raise RuntimeError(f"warm-up gather returned {got[:, 0].tolist()}")
    one = torch.full((1,), float(mesh.rank), device=mesh.device)
    for shift in range(1, mesh.size):
        got = ring_exchange(one, shift, mesh)
        if int(got.item()) != (mesh.rank - shift) % mesh.size:
            raise RuntimeError(f"warm-up ring round {shift} returned "
                               f"{got.item()}")
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
