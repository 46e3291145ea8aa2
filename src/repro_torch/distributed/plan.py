"""DistSpMVPlan: distributed SpMV over a shard mesh (DESIGN.md §7.3, §9).

The port of ``repro.distributed.plan``. Every host-side decision happens
once at build time. The per-shard execution body is the shared
block-composition engine
(:class:`~repro_torch.kernels.composite.CompositePlan`): the local/remote
block pair is a two-**term** composite (local members read the shard's
resident x-block, remote members the halo exchange's output; each term
ends in one inverse-permutation gather, terms add). Members may
themselves be per-precision-class blocks (``classes=`` / ``pplan=``),
which is what makes ``dist_mixed:<budget>`` and ``cg.adaptive_pcg_dist``.

* :func:`build_composite_operands` partitions the matrix
  (:mod:`.partition`), builds per-shard per-class blocks (PackSELL for
  packed codecs, uncompressed SELL for fp32/fp64), pads every member to
  one ``[S, w, C]`` shape across shards (``core.packsell.pad_uniform`` /
  ``core.sell.pad_uniform``) and **stacks** each member's operands along
  a leading shard axis, with the per-term inverse permutations, the halo
  maps (:mod:`.halo`) and a row-validity mask. ``host`` holds them as the
  reference's host dict, key for key and byte for byte.
* The stacked tensors live on the mesh's one device
  (:mod:`repro_torch.parallel.sharding`), and each shard's blocks and
  plans are views of row p of them: one copy on the device, and a write
  into the stacked tensor (``robust.inject.corrupt_dist_checkpoint``)
  reaches the shard's kernel and any CUDA graph captured over it.
* The reference's ``shard_map`` body becomes a loop over shards: the halo
  gather first (all shards at once), then each shard runs the shard-0
  template ``CompositePlan.execute_with`` on its own members' plans and
  its row of ``inv0``/``inv1``, and the row mask zeroes the pad rows of
  the stacked y. At P shards a matvec launches each member's kernel P
  times.
* **Member kernels.** The reference's members build ``force="jnp"``
  plans (its plain fused-stream body) unless ``REPRO_SPMV_POLICY=fused``.
  The port reads no environment variable: on CUDA its members build
  ``force="fused", fused_trim=False`` plans (K1 over the fused stream, K4
  where the stream is infeasible), on the CPU the plain body. One layout
  mismatch between shards demotes the whole member to the full cursor
  cache (on the card, K4), as in the reference.
* :func:`build_dist_tiers` builds one member set per codec tier over one
  shared partition: the ladder ``adaptive_pcg_dist`` promotes through.

:func:`reference_spmv` replays the stacked host arrays shard by shard on
the CPU through the plain bodies (no mesh): the oracle the card is held
to.

**One process per shard.** On a :class:`~repro_torch.parallel.sharding.
RankMesh` each rank holds only its own ``[1, ...]`` row of every stacked
operand: :meth:`DistOperands.from_host` uploads row ``rank`` of the host
dict (the reference's, or the port's ``host``, which equals it key for
key) with the statics of :attr:`DistOperands.meta`, and builds the rank's
member plans on its device (K1 for a fused stream on the card, K4 for a
member without one, K2 for SELL; the plain bodies on the CPU). The shard
body is the same template call on the rank's operands; the halo exchange
is ``halo.gather_halo_rank`` and the reductions are
``parallel.collectives.rank_sum``, so a rank's y is the stacked form's
row ``rank`` bit for bit. ``build_dist_plan`` / ``build_dist_tiers`` with
``mesh=rank_mesh`` build the host dict on every rank (deterministic
numpy) and take the rank's row; a caller that has the host dict already
(``chip_smoke.py``, ``python -m repro_torch.distributed.run``) builds it
once and hands it to the ranks.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.sparse as sp
import torch

from .. import _device
from ..core import codecs as cd
from ..core import packsell as pk
from ..core import sell as sl
from ..kernels import composite as kc
from ..kernels import packsell_spmv as _pk
from ..kernels import plan as kplan
from ..observe import metrics as _obs
from ..parallel import collectives as _co
from ..parallel.sharding import RankMesh, _normal, make_shard_mesh
from . import halo as dh
from . import partition as dp

_ceil_to = pk._ceil_to

#: stacked-operand keys shared by every member set (halo maps + row mask)
SHARED_KEYS = ("rowmask", "halo_src", "send_idx", "recv_slot")


def _host(key: str, t: torch.Tensor) -> np.ndarray:
    """A stacked tensor as the reference's host array (words as uint32)."""
    if key.endswith(("_fwords", "_pack")):
        return cd.words_to_numpy(t)
    return t.cpu().numpy()


@dataclasses.dataclass
class DistMember:
    """One composite member's per-shard blocks and its stacked operands.

    All shards share one block shape (padded), one codec, one term and one
    input index; the per-shard ``rows_local`` maps (block row →
    shard-local row) are baked into the stacked per-term inverse
    permutations. ``arrays`` are the stacked tensors under the
    reference's host keys (with the fused stream only
    ``{key}_fwords``/``{key}_fckpt``: the execution body reads no pack);
    each shard's matrix and plan hold views of their row p (a member that
    runs K4 keeps its width-block checkpoints in the shards' plans).
    """

    key: str                   # host-dict prefix, e.g. 'm0'
    fmt: str                   # 'packsell' | 'sell'
    codec: str
    D: int
    term: int                  # 0 = local, 1 = remote
    x_index: int               # 0 = x_loc, 1 = x_halo (pre-stage output)
    label: str
    mats: list                 # per-shard padded blocks (on the device)
    plans: list | None         # per-shard SpMVPlans (PackSELL members)
    rows_local: list           # per-shard int64 shard-local row ids
    #                            (None = all shard rows, identity map)
    arrays: dict               # stacked operands (see the class docstring)

    def n_rows(self) -> int:
        """Rows this member covers, summed over shards."""
        return sum(int(m.n) if r is None else len(r)
                   for r, m in zip(self.rows_local, self.mats))

    def shard_member(self, p: int) -> kc.CompositeMember:
        """This member's shard-p block as a CompositeMember (shard 0 is
        the composite template; the others feed inverse-perm builds)."""
        return kc.CompositeMember(
            mat=self.mats[p],
            plan=None if self.plans is None else self.plans[p],
            codec=self.codec, D=self.D, rows=self.rows_local[p],
            x_index=self.x_index, term=self.term, label=self.label)

    def shard_dev(self, p: int) -> dict:
        """Shard p's plan-held device operands (none for a SELL block)."""
        return {} if self.plans is None else self.plans[p].device_operands()

    def host_arrays(self) -> dict:
        """The member's stacked operands as host arrays, the reference's
        ``DistMember.host_arrays`` key for key."""
        return {k: _host(k, v) for k, v in self.arrays.items()}


def _normalize_classes(classes) -> list:
    """Accept ``(codec, D, rows|None)`` tuples or PrecisionClass objects."""
    out = []
    for c in classes:
        if isinstance(c, (tuple, list)):
            codec, D, rows = (tuple(c) + (None,))[:3]
        else:
            codec, D, rows = c.codec, c.D, c.rows
        out.append((codec, int(D),
                    None if rows is None else np.asarray(rows, np.int64)))
    return out


def _stack_views(leaves, device):
    """Stack per-shard host tensors on ``device``: ``(stacked, views)``,
    the views being row p of the stacked tensor."""
    st = torch.stack([t.cpu() for t in leaves]).to(device)
    return st, [st[p] for p in range(st.shape[0])]


def _member_plans(mats, on_cuda: bool) -> list:
    """The per-shard plans of one PackSELL member (module docstring)."""
    plans = [kplan.build_plan(m, force="fused" if on_cuda else "jnp",
                              fused_trim=False) for m in mats]
    # the layout is shape-derived, but the ENCODING is data-dependent
    # (column-span overflow falls back per shard): any mismatch demotes
    # the whole member to the full cursor cache
    lays = {(None if p.fused_layout is None else
             (p.fused_layout.wr, p.fused_layout.encoding)) for p in plans}
    if len(lays) > 1:
        plans = [kplan.build_plan(m, force="full") if on_cuda else
                 kplan.build_plan(m, force="jnp", decode_cache="full")
                 for m in mats]
    return plans


def _build_dist_member(idx: int, blocks, rows_local, codec: str, D: int, *,
                       C: int, sigma: int, term: int, x_index: int,
                       label: str, device: torch.device) -> DistMember:
    """Build one member's per-shard blocks padded to a common shape, on
    the host, and stack them on ``device``."""
    k = f"m{idx}"
    if codec in kc.SELL_CODECS:
        vd = {"fp32": "float32", "fp64": "float64"}[codec]
        raw = [sl.from_csr(b, C=C, sigma=sigma, value_dtype=vd,
                           bucket_strategy="uniform", device="cpu")
               for b in blocks]
        S = max(int(m.vals[0].shape[0]) for m in raw)
        w = max(int(m.vals[0].shape[1]) for m in raw)
        host = [sl.pad_uniform(m, n_slices=S, width=w, device=False)
                for m in raw]
        val, vals = _stack_views([m.vals[0] for m in host], device)
        col, cols = _stack_views([m.cols[0] for m in host], device)
        mats = [dataclasses.replace(
            m, vals=(v,), cols=(c,), outrows=(m.outrows[0].to(device),),
            perm=m.perm.to(device), slot=m.slot.to(device))
            for m, v, c in zip(host, vals, cols)]
        return DistMember(key=k, fmt="sell", codec=codec, D=D, term=term,
                          x_index=x_index, label=label, mats=mats,
                          plans=None, rows_local=rows_local,
                          arrays={f"{k}_val": val, f"{k}_col": col})
    raw = [pk.from_csr(b, C=C, sigma=sigma, D=D, codec=codec,
                       bucket_strategy="uniform", device="cpu")
           for b in blocks]
    S = max(int(m.packs[0].shape[0]) for m in raw)
    w = max(int(m.packs[0].shape[1]) for m in raw)
    host = [pk.pad_uniform(m, n_slices=S, width=w, device=False)
            for m in raw]
    pack, packs = _stack_views([m.packs[0] for m in host], device)
    d0, d0s = _stack_views([m.d0s[0] for m in host], device)
    mats = [dataclasses.replace(
        m, packs=(pw,), d0s=(d,), outrows=(m.outrows[0].to(device),),
        maxcols=(m.maxcols[0].to(device),), perm=m.perm.to(device))
        for m, pw, d in zip(host, packs, d0s)]
    plans = _member_plans(mats, device.type == "cuda")
    if plans[0].fused is not None:
        fw, fws = _stack_views([p.fused[0] for p in plans], device)
        ck, cks = _stack_views([p.fused[1] for p in plans], device)
        for p, w3, c in zip(plans, fws, cks):
            p.fused = (w3, c)
        arrays = {f"{k}_fwords": fw, f"{k}_fckpt": ck}
    else:
        arrays = {f"{k}_pack": pack, f"{k}_d0": d0}
        if plans[0].cols is not None:
            cc, ccs = _stack_views([p.cols[0] for p in plans], device)
            for p, c in zip(plans, ccs):
                p.cols = (c,)
            arrays[f"{k}_cols"] = cc
    return DistMember(key=k, fmt="packsell", codec=codec, D=D, term=term,
                      x_index=x_index, label=label, mats=mats, plans=plans,
                      rows_local=rows_local, arrays=arrays)


@dataclasses.dataclass(frozen=True)
class MemberMeta:
    """The statics of one member that a rank cannot read from its row of
    the host dict: the member's identity, each shard's block shape and
    row map, the fused stream's layout (shard 0's, which every shard
    shares: one layout mismatch demotes the member) and the per-bucket
    tiles of its plans."""

    key: str
    fmt: str
    codec: str
    D: int
    term: int
    x_index: int
    label: str
    shapes: tuple              # per shard (n, m)
    rows_local: tuple          # per shard: int64 row ids, or None
    value_dtype: str | None    # SELL members
    layout: kplan.FusedLayout | None
    tiles: tuple


@dataclasses.dataclass(frozen=True)
class DistMeta:
    """Everything :meth:`DistOperands.from_host` needs besides the host
    dict: the partition, the halo maps and each member's statics. It
    holds no tensor and pickles small."""

    part: dp.RowPartition
    maps: dh.HaloMaps
    n: int
    n_pad: int
    h_pad: int
    C: int
    sigma: int
    D: int
    codec: str
    classes: list
    members: tuple


def _member_meta(dm: DistMember) -> MemberMeta:
    p0 = None if dm.plans is None else dm.plans[0]
    return MemberMeta(
        key=dm.key, fmt=dm.fmt, codec=dm.codec, D=dm.D, term=dm.term,
        x_index=dm.x_index, label=dm.label,
        shapes=tuple((int(m.n), int(m.m)) for m in dm.mats),
        rows_local=tuple(dm.rows_local),
        value_dtype=getattr(dm.mats[0], "value_dtype", None),
        layout=None if p0 is None else p0.fused_layout,
        tiles=() if p0 is None else tuple(p0.tiles))


def _rank_member(mm: MemberMeta, arrays: dict, rank: int, C: int,
                 sigma: int, dev: torch.device) -> DistMember:
    """The rank's block and plan of one member over its rows of the
    operands (``arrays``, ``[1, ...]`` on ``dev``): K1 over a fused stream
    on the card, K4 for a member without one (its width-block checkpoints
    built here from the rank's words), K2 for SELL; on the CPU the plain
    bodies (the fused stream's, or the cursor cache's)."""
    k = mm.key
    n, m = mm.shapes[rank]
    z = torch.zeros((1,), dtype=torch.int32, device=dev)
    perm = torch.zeros((1,), dtype=torch.uint8, device=dev)
    sub = {key: v for key, v in arrays.items() if key.startswith(k + "_")}
    if mm.fmt == "sell":
        mat = sl.SELLMatrix(
            vals=(arrays[f"{k}_val"][0],), cols=(arrays[f"{k}_col"][0],),
            outrows=(z,), perm=perm, slot=z, n=n, m=m, C=C, sigma=sigma,
            value_dtype=mm.value_dtype, nnz=0, words_sell_padded=0,
            words_bucketed=0)
        return DistMember(key=k, fmt="sell", codec=mm.codec, D=mm.D,
                          term=mm.term, x_index=mm.x_index, label=mm.label,
                          mats=[mat], plans=None,
                          rows_local=[mm.rows_local[rank]], arrays=sub)
    on_cuda = dev.type == "cuda"
    fw = arrays.get(f"{k}_fwords")
    if fw is not None:
        pack, d0 = torch.zeros((1, 1, 1), dtype=torch.int32, device=dev), z
    else:
        pack, d0 = arrays[f"{k}_pack"][0], arrays[f"{k}_d0"][0]
    mat = pk.PackSELLMatrix(
        packs=(pack,), d0s=(d0,), outrows=(z,), maxcols=(z,), perm=perm,
        n=n, m=m, C=C, sigma=sigma, D=mm.D, codec_name=mm.codec, k_left=0,
        nnz=0, n_dummy=0, words_sell_padded=0, words_bucketed=0)
    common = dict(outrow_cat=torch.zeros((0,), dtype=torch.int32,
                                         device=dev),
                  n=n, m=m, device=dev, fused_trim=False, tiles=mm.tiles)
    if fw is not None:
        plan = kplan.SpMVPlan(
            variant="fused" if on_cuda else "jnp",
            policy="the rank's row of a fused member",
            total_stored=sum(seg.stored for seg in mm.layout.segments),
            fused=(fw[0], arrays[f"{k}_fckpt"][0]), fused_layout=mm.layout,
            cache_mode="checkpoint", **common)
    elif on_cuda:
        kck = kplan._build_block_checkpoints(mat, mm.tiles)
        plan = kplan.SpMVPlan(
            variant="full", policy="the rank's row of a bucketed member",
            total_stored=int(pack.shape[0]) * int(pack.shape[2]),
            kckpts=kck, cache_mode="checkpoint",
            ktable=_pk.bucket_table(mat.packs, mat.d0s, kck,
                                    [wb for _, wb in mm.tiles],
                                    sbs=[sb for sb, _ in mm.tiles]),
            **common)
    else:
        cols = arrays.get(f"{k}_cols")
        plan = kplan.SpMVPlan(
            variant="jnp", policy="the rank's row of a bucketed member",
            total_stored=int(pack.shape[0]) * int(pack.shape[2]),
            cols=(kplan._build_cursor_cache(mat) if cols is None
                  else (cols[0],)), cache_mode="full", **common)
    return DistMember(key=k, fmt="packsell", codec=mm.codec, D=mm.D,
                      term=mm.term, x_index=mm.x_index, label=mm.label,
                      mats=[mat], plans=[plan],
                      rows_local=[mm.rows_local[rank]], arrays=sub)


@dataclasses.dataclass
class DistOperands:
    """Distributed operands on one device: the partition, the halo maps,
    the per-shard member blocks, the shard-0 composite template, and every
    stacked operand the shard body reads (leading dim = shard): ``arrays``
    as tensors on ``device``, ``host`` as the reference's numpy dict.

    A rank's operands (:meth:`from_host`; ``rank`` is not None) hold one
    shard: row ``rank`` of every array (leading dim 1), its members'
    blocks and plans, and the template over them; ``mesh`` is the
    :class:`~repro_torch.parallel.sharding.RankMesh` a plan binds them
    to."""

    part: dp.RowPartition
    maps: dh.HaloMaps
    n: int
    n_pad: int                 # padded rows == padded local x length
    h_pad: int                 # padded halo buffer length (0: no halo)
    C: int
    sigma: int
    D: int
    codec: str                 # 'mixed' for multi-class member sets
    classes: list              # [(codec, D, rows|None)] build record
    arrays: dict               # str -> torch.Tensor [P, ...] on device
    members: list              # list[DistMember]
    tpl: kc.CompositePlan      # shard-0 template (statics equal ∀ shards)
    device: torch.device
    index: dict                # halo.exchange_index (a rank: rank_index)
    rank: int | None = None    # the one shard a rank's operands hold
    mesh: object = None        # the RankMesh a rank's operands run on
    _meta: DistMeta | None = dataclasses.field(default=None, repr=False)

    @property
    def held(self) -> int:
        """Shards these operands hold: every one, or a rank's one."""
        return len(self.members[0].mats)

    @property
    def meta(self) -> DistMeta:
        """The statics :meth:`from_host` needs besides the host dict."""
        if self._meta is None:
            self._meta = DistMeta(
                part=self.part, maps=self.maps, n=self.n, n_pad=self.n_pad,
                h_pad=self.h_pad, C=self.C, sigma=self.sigma, D=self.D,
                codec=self.codec, classes=self.classes,
                members=tuple(_member_meta(dm) for dm in self.members))
        return self._meta

    @classmethod
    def from_host(cls, host, meta: DistMeta, *, rank: int,
                  device=None) -> "DistOperands":
        """Rank ``rank``'s operands on ``device`` (``None``: the GPU) from
        the stacked host dict ``host`` (numpy arrays or memory maps, under
        the reference's keys; only row ``rank`` of each is read) and
        ``meta`` (:attr:`meta` of the operands that made ``host``)."""
        dev = _normal(_device.resolve_device(device))
        P = meta.part.n_shards
        if not 0 <= rank < P:
            raise ValueError(f"rank {rank} not in [0, {P})")

        def row(key):
            v = np.array(host[key][rank])         # a copy: maps are read-only
            t = (cd.words_to_torch(v, dev) if key.endswith(
                ("_fwords", "_pack")) else torch.from_numpy(v).to(dev))
            return t[None]

        arrays = {key: row(key) for key in host}
        members = [_rank_member(mm, arrays, rank, meta.C, meta.sigma, dev)
                   for mm in meta.members]
        n_terms = 1 + (1 if meta.h_pad > 0 else 0)
        tpl = kc.CompositePlan(
            [dm.shard_member(0) for dm in members], n=meta.n_pad,
            m=meta.n_pad, allow_uncovered=True, name="dist",
            invs=[arrays[f"inv{t}"][0].cpu().numpy()
                  for t in range(n_terms)])
        return cls(part=meta.part, maps=meta.maps, n=meta.n,
                   n_pad=meta.n_pad, h_pad=meta.h_pad, C=meta.C,
                   sigma=meta.sigma, D=meta.D, codec=meta.codec,
                   classes=meta.classes, arrays=arrays, members=members,
                   tpl=tpl, device=dev,
                   index=dh.rank_index(arrays["halo_src"],
                                       arrays["send_idx"],
                                       arrays["recv_slot"], meta.h_pad),
                   rank=rank, _meta=meta)

    @property
    def host(self) -> dict:
        """Every stacked operand as a host numpy array, under the
        reference's keys."""
        return {k: _host(k, v) for k, v in self.arrays.items()}

    @property
    def mats_loc(self) -> list:
        """Per-shard local blocks, flattened over members."""
        return [m for dm in self.members if dm.x_index == 0
                for m in dm.mats]

    @property
    def mats_rem(self) -> list:
        return [m for dm in self.members if dm.x_index == 1
                for m in dm.mats]

    # -- vector layout (host) ----------------------------------------------
    def stack_vector(self, v: np.ndarray) -> np.ndarray:
        """Global [n(, nb)] → stacked padded [P, n_pad(, nb)] (zeros pad)."""
        v = np.asarray(v)
        out = np.zeros((self.part.n_shards, self.n_pad) + v.shape[1:],
                       v.dtype)
        for p in range(self.part.n_shards):
            r0, r1 = self.part.rows_of(p)
            out[p, :r1 - r0] = v[r0:r1]
        return out

    def unstack_vector(self, ys: np.ndarray) -> np.ndarray:
        """Stacked padded [P, n_pad(, nb)] → global [n(, nb)]."""
        ys = np.asarray(ys)
        return np.concatenate([ys[p, :c]
                               for p, c in enumerate(self.part.counts)])

    # -- the shard bodies ---------------------------------------------------
    def shard_body(self, p: int, mats, devs, invs, x, x_halo=None, *,
                   multi_rhs: bool = False) -> torch.Tensor:
        """Shard p's ``Σ_term (gather ∘ concat ∘ members)`` through the
        composite template, unmasked: ``mats``/``devs`` per member,
        ``invs`` per term, ``x`` the shard's x-block and ``x_halo`` its
        halo buffer (None when the partition has no halo)."""
        xs = (x,) if x_halo is None else (x, x_halo)
        return self.tpl.execute_with(mats, devs, invs, xs,
                                     multi_rhs=multi_rhs)

    def run(self, xs: torch.Tensor, *, mode: str, multi_rhs: bool = False,
            x_halo: torch.Tensor | None = None,
            shared: dict | None = None) -> torch.Tensor:
        """Stacked ``[P, n_pad(, nb)]`` x → stacked y: the halo gather (the
        composite pre-stage) first, unless ``x_halo`` is given (the tier
        ladder's hoisted pre-stage), then every shard's body on its own
        members' plans, then the row mask. ``shared`` supplies the halo
        index and row mask when this member set's own are not the ones to
        use (the tier ladder). A rank's operands take and give its
        ``[1, n_pad(, nb)]`` block, and exchange on the shared ``mesh``."""
        sh = self.shared() if shared is None else shared
        if self.h_pad > 0 and x_halo is None:
            if self.rank is None:
                x_halo = dh.gather_halo(xs, sh["index"],
                                        n_shards=self.part.n_shards,
                                        h_pad=self.h_pad, mode=mode)
            else:
                x_halo = dh.gather_halo_rank(xs, sh["index"],
                                             mesh=sh["mesh"],
                                             h_pad=self.h_pad, mode=mode)
        invs = [self.arrays[f"inv{t}"] for t in range(self.tpl.n_terms)]
        ys = []
        for p in range(self.held):
            ys.append(self.shard_body(
                p, tuple(dm.mats[p] for dm in self.members),
                tuple(dm.shard_dev(p) for dm in self.members),
                tuple(inv[p] for inv in invs), xs[p],
                None if x_halo is None else x_halo[p],
                multi_rhs=multi_rhs))
        y = torch.stack(ys)
        mask = sh["rowmask"]
        return y * (mask[..., None] if multi_rhs else mask)

    def shared(self) -> dict:
        """The halo index and the row mask: what every member set over
        this partition shares."""
        sh = {"index": self.index, "rowmask": self.arrays["rowmask"]}
        if self.rank is not None:
            if self.mesh is None:
                raise ValueError("a rank's operands run on a RankMesh: "
                                 "bind them first (DistSpMVPlan(ops, mesh))")
            sh["mesh"] = self.mesh
        return sh

    # -- the host replay ----------------------------------------------------
    def _member_view(self, dm: DistMember, ops: dict):
        """A format block over shard operand slices (host tensors). Only
        the fields the composite execution path reads are meaningful;
        accounting fields are 0 / shard-0 statics."""
        t = dm.mats[0]
        if dm.fmt == "packsell":
            z = torch.zeros((1,), dtype=torch.int32)
            d0 = ops.get(f"{dm.key}_d0", z)
            pack = ops.get(f"{dm.key}_pack",
                           torch.zeros((1, 1, 1), dtype=torch.int32))
            return pk.PackSELLMatrix(
                packs=(pack,), d0s=(d0,), outrows=(d0,),
                maxcols=(torch.zeros_like(d0),),
                perm=torch.zeros((1,), dtype=torch.uint8),
                n=t.n, m=t.m, C=self.C, sigma=self.sigma, D=dm.D,
                codec_name=dm.codec, k_left=0, nnz=0, n_dummy=0,
                words_sell_padded=0, words_bucketed=0)
        return sl.SELLMatrix(
            vals=(ops[f"{dm.key}_val"],), cols=(ops[f"{dm.key}_col"],),
            outrows=(torch.zeros((1,), dtype=torch.int32),),
            perm=torch.zeros((1,), dtype=torch.uint8),
            slot=torch.zeros((1,), dtype=torch.int32),
            n=t.n, m=t.m, C=self.C, sigma=self.sigma,
            value_dtype=t.value_dtype, nnz=0, words_sell_padded=0,
            words_bucketed=0)

    def _member_dev(self, dm: DistMember, p: int, view, ops: dict) -> dict:
        """Shard p's plan operands over host slices ``ops``; a member that
        runs K4 reads shard p's width-block checkpoints from its plan."""
        if dm.fmt != "packsell":
            return {}
        cols = ops.get(f"{dm.key}_cols")
        fw = ops.get(f"{dm.key}_fwords")
        plan = dm.plans[p]
        kck = None if plan.kckpts is None else plan.kckpts[0].cpu()
        table = None
        if plan.variant in ("full", "band"):
            table = _pk.bucket_table(
                view.packs, view.d0s, None if kck is None else (kck,),
                [wb for _, wb in plan.tiles],
                sbs=[sb for sb, _ in plan.tiles])
        return {"cols": None if cols is None else (cols,),
                "inv": None, "outrow": None,
                "fused": None if fw is None else (fw, ops[f"{dm.key}_fckpt"]),
                "kckpt": None if kck is None else (kck,), "ktable": table}


@dataclasses.dataclass
class _PartitionCtx:
    """One partition/split/halo-map build, shared by every member set
    over the same matrix and fleet size (the tier ladder builds T+1 sets;
    the CSR split and map construction only need to happen once)."""

    part: dp.RowPartition
    splits: list
    maps: dh.HaloMaps
    n_pad: int
    h_pad: int


def _partition_context(a: sp.csr_matrix, n_shards: int,
                       C: int) -> _PartitionCtx:
    part = dp.partition_rows(a.shape[0], n_shards)
    n_pad = _ceil_to(max(int(part.counts.max(initial=0)), 1), C)
    splits, h_pad = dp.split_csr(a, part, n_pad=n_pad)
    maps = dh.build_halo_maps(part, [s.halo_cols for s in splits],
                              n_pad=n_pad, h_pad=h_pad)
    return _PartitionCtx(part=part, splits=splits, maps=maps, n_pad=n_pad,
                         h_pad=h_pad)


def build_composite_operands(a: sp.csr_matrix, n_shards: int, *,
                             classes, C: int = 32, sigma: int = 256,
                             ctx: _PartitionCtx | None = None,
                             device=None) -> DistOperands:
    """Partition ``a`` over ``n_shards`` row blocks and build the stacked
    member operands for a per-class composite on ``device`` (``None``:
    the GPU). ``classes``: ``(codec, D, rows|None)`` tuples or
    ``PrecisionClass`` objects whose row sets partition the global rows
    (``rows=None`` = all rows, single-class only). ``ctx`` reuses a
    precomputed :func:`_partition_context` (tier ladders share one)."""
    dev = _normal(_device.resolve_device(device))
    a = a.tocsr()
    n = a.shape[0]
    norm = _normalize_classes(classes)
    count = np.zeros(n, np.int64)
    for codec, D, rows in norm:
        if rows is None:
            count += 1
        else:
            count[rows] += 1
    if np.any(count != 1):
        raise ValueError(
            f"precision classes cover {int((count > 0).sum())} of {n} rows "
            f"(max multiplicity {int(count.max(initial=0))}); the classes "
            f"must partition the rows")

    ctx = ctx or _partition_context(a, n_shards, C)
    part, splits, maps = ctx.part, ctx.splits, ctx.maps
    n_pad, h_pad = ctx.n_pad, ctx.h_pad

    host = {
        "rowmask": (np.arange(n_pad)[None, :]
                    < part.counts[:, None]).astype(np.float32),
        "halo_src": maps.halo_src,
        "send_idx": maps.send_idx,
        "recv_slot": maps.recv_slot,
    }
    members: list[DistMember] = []
    sides = [("loc", 0, 0)] + ([("rem", 1, 1)] if h_pad > 0 else [])
    for side, term, x_index in sides:
        for codec, D, rows in norm:
            mask = np.ones(n, bool) if rows is None else \
                np.zeros(n, bool)
            if rows is not None:
                mask[rows] = True
            blocks, rows_local = [], []
            for p in range(part.n_shards):
                r0, r1 = part.rows_of(p)
                src = (splits[p].a_loc if side == "loc"
                       else splits[p].a_rem)
                if rows is None:
                    # all-rows class: the split block IS the member block
                    blocks.append(src)
                    rows_local.append(None)
                else:
                    rl = np.nonzero(mask[r0:r1])[0].astype(np.int64)
                    blocks.append(src[rl])
                    rows_local.append(rl)
            members.append(_build_dist_member(
                len(members), blocks, rows_local, codec, D, C=C,
                sigma=sigma, term=term, x_index=x_index,
                label=f"{side}:{codec}" + ("" if codec in kc.SELL_CODECS
                                           else f"/D={D}"), device=dev))

    n_terms = 1 + (1 if h_pad > 0 else 0)
    for t in range(n_terms):
        tms = [dm for dm in members if dm.term == t]
        host[f"inv{t}"] = np.stack([
            kc.term_inverse(n_pad, [dm.shard_member(p) for dm in tms],
                            allow_uncovered=True, term=t)
            for p in range(part.n_shards)])
    arrays = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    for dm in members:
        arrays.update(dm.arrays)

    tpl = kc.CompositePlan([dm.shard_member(0) for dm in members],
                           n=n_pad, m=n_pad, allow_uncovered=True,
                           name="dist")
    codec0, D0 = ((norm[0][0], norm[0][1]) if len(norm) == 1
                  else ("mixed", 0))
    return DistOperands(part=part, maps=maps, n=n, n_pad=n_pad, h_pad=h_pad,
                        C=C, sigma=sigma, D=D0, codec=codec0,
                        classes=norm, arrays=arrays, members=members,
                        tpl=tpl, device=dev,
                        index=dh.exchange_index(maps, dev))


def build_operands(a: sp.csr_matrix, n_shards: int, *, C: int = 32,
                   sigma: int = 256, D: int = 15, codec: str = "fp16",
                   device=None) -> DistOperands:
    """Single-class distributed operands: one local + one remote member
    per shard at a fleet-wide ``(codec, D)``."""
    return build_composite_operands(a, n_shards,
                                    classes=[(codec, D, None)],
                                    C=C, sigma=sigma, device=device)


def write_host(host: dict, directory) -> None:
    """The host dict as one ``<key>.npy`` per array under ``directory``:
    how a parent hands the ranks it spawns the operands it built once
    (:func:`read_host` maps them back, and each rank's
    :meth:`DistOperands.from_host` reads only its row)."""
    import os

    os.makedirs(directory, exist_ok=True)
    for key, v in host.items():
        np.save(os.path.join(directory, f"{key}.npy"), np.asarray(v))


def read_host(directory) -> dict:
    """The host dict :func:`write_host` wrote, as read-only memory maps."""
    import os

    return {f[:-4]: np.load(os.path.join(directory, f), mmap_mode="r")
            for f in sorted(os.listdir(directory)) if f.endswith(".npy")}


def reference_spmv(ops: DistOperands, x, mode: str = "all_gather",
                   multi_rhs: bool = False) -> np.ndarray:
    """Host oracle: replay the stacked host arrays shard by shard on the
    CPU, with the host-side exchange reference and every kernel's plain
    version (no mesh). Validates the partition, the maps and the padded
    member blocks, and is what the card's distributed SpMV is held to.
    It needs every shard's operands (the stacked form)."""
    if ops.rank is not None:
        raise ValueError("reference_spmv replays every shard: pass the "
                         "stacked operands, not a rank's")
    xs = ops.stack_vector(np.asarray(x, np.float32))
    xh = (dh.gather_halo_reference(xs, ops.maps, mode)
          if ops.h_pad > 0 else None)
    host = ops.host
    ys = []
    for p in range(ops.part.n_shards):
        ops_p = {k: torch.from_numpy(np.ascontiguousarray(v[p]))
                 for k, v in host.items()}
        for k in ops_p:
            if k.endswith(("_fwords", "_pack")):
                ops_p[k] = cd.words_to_torch(host[k][p], "cpu")
        views = [ops._member_view(dm, ops_p) for dm in ops.members]
        devs = [ops._member_dev(dm, p, v, ops_p)
                for dm, v in zip(ops.members, views)]
        y = ops.shard_body(
            p, tuple(views), tuple(devs),
            tuple(ops_p[f"inv{t}"] for t in range(ops.tpl.n_terms)),
            torch.from_numpy(xs[p]),
            None if xh is None else torch.from_numpy(xh[p]),
            multi_rhs=multi_rhs)
        mask = ops_p["rowmask"]
        ys.append((y * (mask[:, None] if multi_rhs else mask)).numpy())
    return ops.unstack_vector(np.stack(ys))


class _MeshBound:
    """Shared mesh-binding plumbing: the mesh check, vector shard/unshard,
    and the build-once cache of dispatches (``DistSpMVPlan`` and the tier
    ladder both use it). On a rank mesh the vectors a rank holds are its
    ``[1, n_pad(, nb)]`` blocks, and unsharding gathers every rank's."""

    def _bind(self, ops_like: DistOperands, mesh, dev: dict,
              operands=()) -> None:
        if len(mesh.axis_names) != 1:
            raise ValueError(f"need a 1-D mesh, got axes {mesh.axis_names}")
        if mesh.size != ops_like.part.n_shards:
            raise ValueError(
                f"mesh has {mesh.size} devices but operands were "
                f"built for {ops_like.part.n_shards} shards")
        ranked = isinstance(mesh, RankMesh)
        if ranked != (ops_like.rank is not None):
            raise ValueError(
                "a RankMesh runs one rank's operands "
                "(DistOperands.from_host(ops.host, ops.meta, rank=...)); "
                "a ShardMesh the stacked operands of every shard")
        if ranked and mesh.rank != ops_like.rank:
            raise ValueError(f"operands of rank {ops_like.rank} on rank "
                             f"{mesh.rank} of the mesh")
        if mesh.device != ops_like.device:
            raise ValueError(f"operands live on {ops_like.device}, the "
                             f"mesh's shards on {mesh.device}")
        self._ops0 = ops_like
        self.mesh = mesh
        self.rank = mesh.rank if ranked else None
        self.axis_name = mesh.axis_names[0]
        self.dev = dev
        self._fns: dict = {}
        if ranked:
            for o in (ops_like,) + tuple(operands):
                o.mesh = mesh
        # global row r <-> flat stacked slot p * n_pad + (r - starts[p])
        part = ops_like.part
        owner = part.owner(np.arange(ops_like.n))
        slot = owner * ops_like.n_pad + (np.arange(ops_like.n)
                                         - part.starts[owner])
        self._slot = torch.from_numpy(slot.astype(np.int64)).to(mesh.device)

    @property
    def n(self) -> int:
        return self._ops0.n

    @property
    def n_shards(self) -> int:
        return self._ops0.part.n_shards

    def cached_fn(self, key, builder):
        """Build-once cache of dispatch bodies (solvers park their graphs
        and static buffers here too)."""
        fn = self._fns.get(key)
        if fn is None:
            fn = builder()
            self._fns[key] = fn
        return fn

    def shard_vector(self, v) -> torch.Tensor:
        """Global [n(, nb)] → stacked [P, n_pad(, nb)] on the mesh's
        device, zeros in the pad rows (a rank: its [1, n_pad(, nb)]
        block). A tensor stays on the device (one zero fill and one
        ``index_copy_``, or a rank's slice copy: nothing read on the
        host), so ``dist_<codec>`` matvecs drop into the solvers'
        graphs."""
        ops = self._ops0
        if self.rank is not None:
            r0, r1 = ops.part.rows_of(self.rank)
            if not torch.is_tensor(v):
                v = torch.from_numpy(np.asarray(v))
            v = v.to(self.mesh.device)
            out = v.new_zeros((1, ops.n_pad) + tuple(v.shape[1:]))
            out[0, :r1 - r0] = v[r0:r1]
            return out
        if not torch.is_tensor(v):
            return torch.from_numpy(ops.stack_vector(v)).to(self.mesh.device)
        tail = tuple(v.shape[1:])
        out = v.new_zeros((self.n_shards * ops.n_pad,) + tail)
        out.index_copy_(0, self._slot, v)
        return out.reshape((self.n_shards, ops.n_pad) + tail)

    def unshard_vector(self, ys: torch.Tensor) -> torch.Tensor:
        """Stacked [P, n_pad(, nb)] → global [n(, nb)] (one gather; a
        rank gathers every rank's block first, so every rank gets the
        global vector)."""
        if self.rank is not None:
            ys = _co.gather_blocks(ys, self.mesh)
        tail = tuple(ys.shape[2:])
        return torch.index_select(ys.reshape((-1,) + tail), 0, self._slot)


class DistSpMVPlan(_MeshBound):
    """Stacked distributed operands bound to a shard mesh, with one cached
    dispatch body per (entry point, exchange mode).

    Entry points take and return **global** vectors (``spmv`` / ``spmm``)
    or stay in the stacked layout (``spmv_sharded``: solvers chain
    matvecs with no host round trip). ``shard_vector`` /
    ``unshard_vector`` convert between the two. On a rank mesh every rank
    calls every entry point (they run collectives); ``spmv_sharded``
    takes and gives the rank's ``[1, n_pad(, nb)]`` block.
    """

    def __init__(self, ops: DistOperands, mesh, *,
                 exchange: str = "ppermute"):
        if exchange not in dh.EXCHANGE_MODES:
            raise ValueError(f"exchange={exchange!r} not in "
                             f"{dh.EXCHANGE_MODES}")
        self.ops = ops
        self.exchange = exchange
        self._bind(ops, mesh, ops.arrays)

    def _spmv_fn(self, mode: str, multi_rhs: bool):
        return self.cached_fn(
            ("spmm" if multi_rhs else "spmv", mode),
            lambda: functools.partial(self.ops.run, mode=mode,
                                      multi_rhs=multi_rhs))

    def spmv_sharded(self, xs: torch.Tensor, *, mode: str | None = None,
                     multi_rhs: bool = False) -> torch.Tensor:
        """Stacked [P, n_pad(, nb)] → the same layout."""
        mode = mode or self.exchange
        if mode not in dh.EXCHANGE_MODES:
            # validate here, not only in gather_halo: halo-free partitions
            # (h_pad == 0) never reach the gather
            raise ValueError(f"mode={mode!r} not in {dh.EXCHANGE_MODES}")
        _obs.inc("dist.dispatch", mode=mode, shards=self.n_shards,
                 kind="spmm" if multi_rhs else "spmv")
        return self._spmv_fn(mode, multi_rhs)(xs)

    def spmv(self, x, *, mode: str | None = None) -> torch.Tensor:
        """y = A @ x for a global [n] vector (shard, dispatch, unshard)."""
        return self.unshard_vector(self.spmv_sharded(
            self.shard_vector(x), mode=mode))

    def spmm(self, x, *, mode: str | None = None) -> torch.Tensor:
        """Y = A @ X for a global [n, nb] block (each shard's members run
        their multi-RHS kernels: one pass over the words serves all nb
        right-hand sides)."""
        if len(tuple(x.shape)) != 2:
            raise ValueError(f"spmm expects [n, nb], got {tuple(x.shape)}")
        return self.unshard_vector(self.spmv_sharded(
            self.shard_vector(x), mode=mode, multi_rhs=True))

    def warmup(self, nb: int = 0, modes=None) -> "DistSpMVPlan":
        """Run each dispatch once ahead of the first real call."""
        dev = self.mesh.device
        for mode in (modes or (self.exchange,)):
            self.spmv(torch.zeros(self.n, device=dev), mode=mode)
            if nb:
                self.spmm(torch.zeros((self.n, nb), device=dev), mode=mode)
        return self

    # -- accounting ---------------------------------------------------------
    def memory_stats(self) -> dict:
        """Fleet memory and communication profile via the composite blend
        (:func:`repro_torch.kernels.composite.composite_memory_stats`):
        per-member breakdown over every shard's blocks, plus halo traffic
        and per-shard footprint extremes (load-balance signal). On a rank
        mesh: the bytes of the operand rows this rank holds, every rank's
        (one gather) and their sum, with the halo's figures."""
        ops = self.ops
        if self.rank is not None:
            mine = sum(t.numel() * t.element_size()
                       for t in ops.arrays.values())
            every = [int(v) for v in
                     _co.gather_values([mine], self.mesh)[:, 0]]
            return {"rank": self.rank, "shards": self.n_shards,
                    "n_pad": ops.n_pad, "h_pad": ops.h_pad,
                    "halo_entries": int(ops.maps.counts.sum()),
                    "halo_k_max": ops.maps.k_max, "exchange": self.exchange,
                    "rank_bytes": mine, "bytes_per_rank": every,
                    "total_bytes": sum(every),
                    "max_shard_bytes": max(every),
                    "min_shard_bytes": min(every)}
        st = kc.composite_memory_stats(
            [(dm.label, dm.codec, dm.D, dm.n_rows(), dm.mats)
             for dm in ops.members],
            halo={"shards": self.n_shards, "n_pad": ops.n_pad,
                  "h_pad": ops.h_pad,
                  "halo_entries": int(ops.maps.counts.sum()),
                  "halo_k_max": ops.maps.k_max,
                  "exchange": self.exchange})
        per_shard = [sum(kc._block_bytes(dm.mats[p]) for dm in ops.members)
                     for p in range(self.n_shards)]
        st["max_shard_bytes"] = max(per_shard) if per_shard else 0
        st["min_shard_bytes"] = min(per_shard) if per_shard else 0
        return st


def _mesh_for(mesh, n_shards, axis_name, devices, device):
    if mesh is None:
        mesh = make_shard_mesh(n_shards, axis_name=axis_name,
                               devices=devices, device=device)
    return mesh


def _operands_for(mesh, a, classes, *, C, sigma, ctx=None) -> DistOperands:
    """The operands a mesh runs: every shard's, stacked on a shard mesh's
    device; on a rank mesh the rank's row of the host dict built here on
    the CPU (deterministic numpy, the same on every rank)."""
    if not isinstance(mesh, RankMesh):
        return build_composite_operands(a, mesh.size, classes=classes, C=C,
                                        sigma=sigma, ctx=ctx,
                                        device=mesh.device)
    full = build_composite_operands(a, mesh.size, classes=classes, C=C,
                                    sigma=sigma, ctx=ctx, device="cpu")
    return DistOperands.from_host(full.host, full.meta, rank=mesh.rank,
                                  device=mesh.device)


def build_dist_plan(a: sp.csr_matrix, n_shards: int | None = None, *,
                    mesh=None, axis_name: str = "shards",
                    exchange: str = "ppermute", C: int = 32,
                    sigma: int = 256, D: int = 15, codec: str = "fp16",
                    classes=None, pplan=None, devices=None,
                    device=None) -> DistSpMVPlan:
    """Partition ``a`` across a shard mesh and build the distributed plan
    (the slow path, once per matrix). With no mesh,
    ``make_shard_mesh(n_shards, devices=devices, device=device)``: one
    shard per visible device of ``device`` (``None``: the GPU). With a
    :class:`~repro_torch.parallel.sharding.RankMesh`, every rank calls it
    and gets the plan over its own shard.

    ``classes`` (or ``pplan``, a rows-mode
    :class:`~repro_torch.precision.select.PrecisionPlan`) builds a
    distributed × mixed-precision composite: per-shard per-class members
    instead of one fleet-wide ``(codec, D)``.
    """
    mesh = _mesh_for(mesh, n_shards, axis_name, devices, device)
    if pplan is not None:
        if classes is not None:
            raise ValueError("pass either classes= or pplan=, not both")
        classes = [(c.codec, c.D, c.rows) for c in pplan.classes]
    if classes is None:
        classes = [(codec, D, None)]
    ops = _operands_for(mesh, a, classes, C=C, sigma=sigma)
    return DistSpMVPlan(ops, mesh, exchange=exchange)


# ---------------------------------------------------------------------------
# Distributed tier ladder (adaptive_pcg_dist)
# ---------------------------------------------------------------------------


class DistTierLadder(_MeshBound):
    """One member set per codec tier over ONE shared partition: what
    :func:`repro_torch.solvers.cg.adaptive_pcg_dist` promotes through.

    Every tier shares the halo index and row mask (``dev['shared']``);
    each tier's member arrays and inverse permutations are under
    ``dev['tiers'][k]``, the exact fp64 operator's (the outer
    true-residual recomputation of iterative refinement) under
    ``dev['hi']``. The tier is chosen on the host; the halo gather is the
    shared pre-stage, run once per matvec whatever the tier.
    """

    def __init__(self, tiers_ops: list, hi_ops: DistOperands, mesh, *,
                 labels, sub32, exchange: str = "ppermute"):
        if exchange not in dh.EXCHANGE_MODES:
            raise ValueError(f"exchange={exchange!r} not in "
                             f"{dh.EXCHANGE_MODES}")
        self.tiers = list(tiers_ops)
        self.hi = hi_ops
        self.labels = list(labels)
        self.sub32 = np.asarray(sub32, bool)
        self.exchange = exchange

        def member_only(ops):
            return {k: v for k, v in ops.arrays.items()
                    if k not in SHARED_KEYS}

        dev = {
            "shared": {**{k: self.tiers[0].arrays[k] for k in SHARED_KEYS},
                       "index": self.tiers[0].index},
            "tiers": [member_only(o) for o in self.tiers],
            "hi": member_only(hi_ops),
        }
        self._bind(self.tiers[0], mesh, dev,
                   operands=tuple(self.tiers[1:]) + (hi_ops,))
        if self.rank is not None:
            dev["shared"]["mesh"] = mesh

    @property
    def h_pad(self) -> int:
        return self.tiers[0].h_pad


def build_dist_tiers(a: sp.csr_matrix, ladder, *, mesh=None,
                     n_shards: int | None = None,
                     axis_name: str = "shards",
                     exchange: str = "ppermute", C: int = 32,
                     sigma: int = 256, devices=None,
                     device=None) -> DistTierLadder:
    """Materialize a whole-operator codec ladder (e.g.
    ``precision.select.tier_ladder``) as distributed member sets sharing
    one partition, plus the exact fp64 member set for the refinement
    outer step. A rank mesh gives each rank its own rows of every member
    set (:func:`build_dist_plan`)."""
    mesh = _mesh_for(mesh, n_shards, axis_name, devices, device)
    ncls = _normalize_classes(ladder)
    a = a.tocsr()
    ctx = _partition_context(a, mesh.size, C)
    tiers_ops = [_operands_for(mesh, a, [(codec, D, None)], C=C,
                               sigma=sigma, ctx=ctx)
                 for codec, D, _ in ncls]
    hi_ops = _operands_for(mesh, a, [("fp64", 0, None)], C=C, sigma=sigma,
                           ctx=ctx)
    labels = [codec if codec in kc.SELL_CODECS else f"{codec}/D={D}"
              for codec, D, _ in ncls]
    sub32 = [codec not in kc.SELL_CODECS for codec, D, _ in ncls]
    return DistTierLadder(tiers_ops, hi_ops, mesh, labels=labels,
                          sub32=sub32, exchange=exchange)
