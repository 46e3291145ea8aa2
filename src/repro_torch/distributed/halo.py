"""Halo exchange for distributed PackSELL SpMV (DESIGN.md §7.2).

The port of ``repro.distributed.halo``. Before ``y_p = A_loc @ x_loc +
A_rem @ x_halo`` can run, each shard must receive the x-entries its halo
columns reference. Both exchange modes are driven by **precomputed index
maps**, host-built once per partition (:func:`build_halo_maps`, copied
from the reference as it is):

* ``'ppermute'`` (default): P-1 rounds. In round s every shard packs the
  entries shard ``(p+s) % P`` needs from it (``send_idx``), the ring
  rotates by s, and the receiver scatters the buffer into its halo slots
  (``recv_slot``). Buffers are padded to the fleet-wide per-pair maximum
  ``k_max``.
* ``'all_gather'``: the full x of every shard, then one gather through
  ``halo_src``.

A sharded vector here is a **stacked** ``[P, n_pad(, nb)]`` tensor on the
mesh's one device (the reference's ``stack_vector`` layout), so round s of
``'ppermute'`` is one gather of every shard's send buffer, a roll by s
along the shard axis (the ring's rotation) and one scatter into the halo
buffers; ``'all_gather'`` is a reshape and one gather. Pad entries of a
round land on slot ``h_pad`` of an ``[P, h_pad + 1]`` buffer, which is
sliced off: the reference's ``mode="drop"``. No index is clamped. Both
modes copy the same values, so they give the same bits.

On a rank mesh (one process per shard, :class:`~repro_torch.parallel.
sharding.RankMesh`) a rank holds its own ``[1, n_pad(, nb)]`` block, and
:func:`gather_halo_rank` gives its row of what :func:`gather_halo` gives:
``'all_gather'`` gathers every rank's block
(``parallel.collectives.gather_blocks``) and takes this rank's halo
entries; ``'ppermute'`` runs the P-1 rounds as rounds of the ring
(``parallel.collectives.ring_exchange``), each scattered into the halo
slots as above.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..observe import metrics as _obs
from ..parallel import collectives as _co
from ..parallel.sharding import RankMesh
from .partition import RowPartition, comm_counts

EXCHANGE_MODES = ("ppermute", "all_gather")


@dataclasses.dataclass(frozen=True)
class HaloMaps:
    """Host-built exchange index maps, stacked over shards (leading dim P).

    ``halo_src[p, k]``: flattened index into the all-gathered ``[P * n_pad]``
    x of shard p's k-th halo entry (pad → 0).
    ``send_idx[p, s-1, k]``: local x index of the k-th entry shard p sends in
    round s (pad → 0).
    ``recv_slot[p, s-1, k]``: halo slot filled by the k-th entry shard p
    receives in round s (pad → h_pad, dropped).
    """

    n_shards: int
    n_pad: int
    h_pad: int
    k_max: int
    halo_src: np.ndarray        # int32 [P, max(h_pad, 1)]
    send_idx: np.ndarray        # int32 [P, max(P-1, 1), max(k_max, 1)]
    recv_slot: np.ndarray       # int32 [P, max(P-1, 1), max(k_max, 1)]
    counts: np.ndarray          # int64 [P, P] traffic matrix


def build_halo_maps(part: RowPartition, halo_cols_list: list[np.ndarray],
                    *, n_pad: int, h_pad: int) -> HaloMaps:
    """Precompute both modes' index maps from the per-shard halo column
    sets (``ShardSplit.halo_cols``, sorted global ids)."""
    P = part.n_shards
    owners = [part.owner(hc) for hc in halo_cols_list]
    counts = comm_counts(part, halo_cols_list)
    k_max = int(counts.max(initial=0))

    halo_src = np.zeros((P, max(h_pad, 1)), np.int32)
    for p, hc in enumerate(halo_cols_list):
        own = owners[p]
        halo_src[p, :len(hc)] = (own * n_pad
                                 + (hc - part.starts[own])).astype(np.int32)

    n_steps = max(P - 1, 1)
    send_idx = np.zeros((P, n_steps, max(k_max, 1)), np.int32)
    recv_slot = np.full((P, n_steps, max(k_max, 1)), h_pad, np.int32)
    for s in range(1, P):
        for p in range(P):
            dst = (p + s) % P
            # entries dst needs from p, in dst's sorted-halo order
            need = halo_cols_list[dst][owners[dst] == p]
            send_idx[p, s - 1, :len(need)] = \
                (need - part.starts[p]).astype(np.int32)
            src = (p - s) % P
            slots = np.nonzero(owners[p] == src)[0]
            recv_slot[p, s - 1, :len(slots)] = slots.astype(np.int32)
    return HaloMaps(n_shards=P, n_pad=n_pad, h_pad=h_pad, k_max=k_max,
                    halo_src=halo_src, send_idx=send_idx,
                    recv_slot=recv_slot, counts=counts)


def exchange_index(maps: HaloMaps, device) -> dict:
    """The maps as int64 index tensors on ``device``, built once per plan:
    ``rows`` ``[P, 1]`` (the shard axis), ``send``/``recv`` ``[P, P-1,
    k]`` (round s at ``[:, s-1]``; pad → slot ``h_pad``) and ``src``
    ``[P, h_pad]`` (into the flattened ``[P * n_pad]`` x)."""
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    return {"rows": t(np.arange(maps.n_shards)[:, None]),
            "send": t(maps.send_idx), "recv": t(maps.recv_slot),
            "src": t(maps.halo_src[:, :maps.h_pad])}


def gather_halo(xs: torch.Tensor, index: dict, *, n_shards: int,
                h_pad: int, mode: str) -> torch.Tensor:
    """The exchange over every shard at once. ``xs`` is the stacked
    ``[P, n_pad(, nb)]`` x, ``index`` what :func:`exchange_index` returns.
    Returns the stacked ``x_halo`` ``[P, h_pad(, nb)]``."""
    tail = tuple(xs.shape[2:])
    if h_pad == 0:
        return xs.new_zeros((n_shards, 0) + tail)
    if mode == "all_gather":
        flat = xs.reshape((-1,) + tail)                  # [P * n_pad(, nb)]
        return flat[index["src"]]
    if mode != "ppermute":
        raise ValueError(f"mode={mode!r} not in {EXCHANGE_MODES}")
    rows = index["rows"]
    buf_h = xs.new_zeros((n_shards, h_pad + 1) + tail)
    for s in range(1, n_shards):
        buf = xs[rows, index["send"][:, s - 1]]          # [P, k(, nb)]
        buf = torch.roll(buf, s, dims=0)                 # p -> (p + s) % P
        slot = index["recv"][:, s - 1]
        if tail:
            slot = slot[..., None].expand((-1, -1) + tail)
        # pad entries carry recv_slot == h_pad: the column sliced off below
        buf_h.scatter_(1, slot, buf)
    return buf_h[:, :h_pad]


def rank_index(halo_src: torch.Tensor, send_idx: torch.Tensor,
               recv_slot: torch.Tensor, h_pad: int) -> dict:
    """A rank's exchange index from its ``[1, ...]`` rows of the stacked
    maps: ``send``/``recv`` ``[P-1, k]`` (round s at ``[s-1]``; pad →
    slot ``h_pad``) and ``src`` ``[h_pad]`` (into the gathered
    ``[P * n_pad]`` x), as int64 on the rows' device."""
    return {"send": send_idx[0].long(), "recv": recv_slot[0].long(),
            "src": halo_src[0, :h_pad].long()}


def gather_halo_rank(xs: torch.Tensor, index: dict, *, mesh: RankMesh,
                     h_pad: int, mode: str) -> torch.Tensor:
    """This rank's row of :func:`gather_halo`: ``xs`` is the rank's
    ``[1, n_pad(, nb)]`` x, ``index`` what :func:`rank_index` returns.
    Returns ``x_halo`` ``[1, h_pad(, nb)]``. Every rank of the mesh must
    call it (it runs collectives)."""
    tail = tuple(xs.shape[2:])
    if h_pad == 0:
        return xs.new_zeros((1, 0) + tail)
    if mode == "all_gather":
        flat = _co.gather_blocks(xs, mesh).reshape((-1,) + tail)
        return flat[index["src"]][None]
    if mode != "ppermute":
        raise ValueError(f"mode={mode!r} not in {EXCHANGE_MODES}")
    x = xs[0]
    buf_h = xs.new_zeros((h_pad + 1,) + tail)
    for s in range(1, mesh.size):
        got = _co.ring_exchange(x[index["send"][s - 1]], s, mesh)
        slot = index["recv"][s - 1]
        if tail:
            slot = slot[:, None].expand((-1,) + tail)
        # pad entries carry recv_slot == h_pad: the slot sliced off below
        buf_h.scatter_(0, slot, got)
    return buf_h[None, :h_pad]


def prestage(index: dict, *, n_shards: int, h_pad: int, mode: str,
             mesh=None):
    """The halo exchange packaged as a **composite pre-stage**: a function
    mapping the stacked x to the tuple of extra input vectors,
    ``(x_halo,)``, or ``()`` for halo-free partitions, that remote
    members consume as input index 1. The distributed tier ladder
    (``cg.adaptive_pcg_dist``) runs it once per matvec, outside the tier
    choice: every tier shares the maps. On a rank mesh (``mesh`` a
    :class:`~repro_torch.parallel.sharding.RankMesh`) it maps the rank's
    block through :func:`gather_halo_rank`."""
    rank = isinstance(mesh, RankMesh)

    def pre(xs: torch.Tensor) -> tuple:
        if h_pad == 0:
            return ()
        with _obs.span("packsell.halo_prestage"):
            if rank:
                return (gather_halo_rank(xs, index, mesh=mesh, h_pad=h_pad,
                                         mode=mode),)
            return (gather_halo(xs, index, n_shards=n_shards, h_pad=h_pad,
                                mode=mode),)
    return pre


def gather_halo_reference(x_stacked: np.ndarray, maps: HaloMaps,
                          mode: str = "all_gather") -> np.ndarray:
    """Host-side oracle of :func:`gather_halo` over the full stacked x
    ``[P, n_pad(, nb)]`` → ``[P, h_pad(, nb)]`` (device-free tests)."""
    P, h_pad = maps.n_shards, maps.h_pad
    out_shape = (P, h_pad) + tuple(x_stacked.shape[2:])
    out = np.zeros(out_shape, x_stacked.dtype)
    if h_pad == 0:
        return out
    if mode == "all_gather":
        flat = x_stacked.reshape((-1,) + tuple(x_stacked.shape[2:]))
        for p in range(P):
            out[p] = flat[maps.halo_src[p, :h_pad]]
        return out
    for s in range(1, P):
        for p in range(P):
            src = (p - s) % P
            buf = x_stacked[src][maps.send_idx[src, s - 1]]
            slots = maps.recv_slot[p, s - 1]
            ok = slots < h_pad
            out[p][slots[ok]] = buf[ok]
    return out
