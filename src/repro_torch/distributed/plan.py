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
from ..parallel.sharding import _normal, make_shard_mesh
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


@dataclasses.dataclass
class DistOperands:
    """Distributed operands on one device: the partition, the halo maps,
    the per-shard member blocks, the shard-0 composite template, and every
    stacked operand the shard body reads (leading dim = shard): ``arrays``
    as tensors on ``device``, ``host`` as the reference's numpy dict."""

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
    index: dict                # halo.exchange_index of the maps

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
        use (the tier ladder)."""
        sh = self.shared() if shared is None else shared
        P = self.part.n_shards
        if self.h_pad > 0 and x_halo is None:
            x_halo = dh.gather_halo(xs, sh["index"], n_shards=P,
                                    h_pad=self.h_pad, mode=mode)
        invs = [self.arrays[f"inv{t}"] for t in range(self.tpl.n_terms)]
        ys = []
        for p in range(P):
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
        return {"index": self.index, "rowmask": self.arrays["rowmask"]}

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


def reference_spmv(ops: DistOperands, x, mode: str = "all_gather",
                   multi_rhs: bool = False) -> np.ndarray:
    """Host oracle: replay the stacked host arrays shard by shard on the
    CPU, with the host-side exchange reference and every kernel's plain
    version (no mesh). Validates the partition, the maps and the padded
    member blocks, and is what the card's distributed SpMV is held to."""
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
    ladder both use it)."""

    def _bind(self, ops_like: DistOperands, mesh, dev: dict) -> None:
        if len(mesh.axis_names) != 1:
            raise ValueError(f"need a 1-D mesh, got axes {mesh.axis_names}")
        if mesh.size != ops_like.part.n_shards:
            raise ValueError(
                f"mesh has {mesh.size} devices but operands were "
                f"built for {ops_like.part.n_shards} shards")
        if mesh.device != ops_like.device:
            raise ValueError(f"operands live on {ops_like.device}, the "
                             f"mesh's shards on {mesh.device}")
        self._ops0 = ops_like
        self.mesh = mesh
        self.axis_name = mesh.axis_names[0]
        self.dev = dev
        self._fns: dict = {}
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
        device, zeros in the pad rows. A tensor stays on the device (one
        zero fill and one ``index_copy_``, nothing read on the host), so
        ``dist_<codec>`` matvecs drop into the solvers' graphs."""
        ops = self._ops0
        if not torch.is_tensor(v):
            return torch.from_numpy(ops.stack_vector(v)).to(self.mesh.device)
        tail = tuple(v.shape[1:])
        out = v.new_zeros((self.n_shards * ops.n_pad,) + tail)
        out.index_copy_(0, self._slot, v)
        return out.reshape((self.n_shards, ops.n_pad) + tail)

    def unshard_vector(self, ys: torch.Tensor) -> torch.Tensor:
        """Stacked [P, n_pad(, nb)] → global [n(, nb)] (one gather)."""
        tail = tuple(ys.shape[2:])
        return torch.index_select(ys.reshape((-1,) + tail), 0, self._slot)


class DistSpMVPlan(_MeshBound):
    """Stacked distributed operands bound to a shard mesh, with one cached
    dispatch body per (entry point, exchange mode).

    Entry points take and return **global** vectors (``spmv`` / ``spmm``)
    or stay in the stacked layout (``spmv_sharded``: solvers chain
    matvecs with no host round trip). ``shard_vector`` /
    ``unshard_vector`` convert between the two.
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
        and per-shard footprint extremes (load-balance signal)."""
        ops = self.ops
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


def build_dist_plan(a: sp.csr_matrix, n_shards: int | None = None, *,
                    mesh=None, axis_name: str = "shards",
                    exchange: str = "ppermute", C: int = 32,
                    sigma: int = 256, D: int = 15, codec: str = "fp16",
                    classes=None, pplan=None, devices=None,
                    device=None) -> DistSpMVPlan:
    """Partition ``a`` across a shard mesh and build the distributed plan
    (the slow path, once per matrix). With no mesh,
    ``make_shard_mesh(n_shards, devices=devices, device=device)``: one
    shard per visible device of ``device`` (``None``: the GPU).

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
    ops = build_composite_operands(a, mesh.size, classes=classes, C=C,
                                   sigma=sigma, device=mesh.device)
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
        self._bind(self.tiers[0], mesh, dev)

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
    outer step."""
    mesh = _mesh_for(mesh, n_shards, axis_name, devices, device)
    ncls = _normalize_classes(ladder)
    a = a.tocsr()
    ctx = _partition_context(a, mesh.size, C)
    tiers_ops = [build_composite_operands(
        a, mesh.size, classes=[(codec, D, None)], C=C, sigma=sigma, ctx=ctx,
        device=mesh.device) for codec, D, _ in ncls]
    hi_ops = build_composite_operands(
        a, mesh.size, classes=[("fp64", 0, None)], C=C, sigma=sigma,
        ctx=ctx, device=mesh.device)
    labels = [codec if codec in kc.SELL_CODECS else f"{codec}/D={D}"
              for codec, D, _ in ncls]
    sub32 = [codec not in kc.SELL_CODECS for codec, D, _ in ncls]
    return DistTierLadder(tiers_ops, hi_ops, mesh, labels=labels,
                          sub32=sub32, exchange=exchange)
