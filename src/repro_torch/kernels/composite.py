"""CompositePlan: one block-composition engine for every multi-block SpMV.

The port of ``repro.kernels.composite``. A :class:`CompositePlan` is an
ordered list of :class:`CompositeMember` s. Each member is one format
block, annotated with

* ``rows``    — the block-row → global-row map (``None``: block rows are
  global rows),
* ``term``    — the sum group. Members of one term cover disjoint row
  sets; their stored-row outputs are concatenated and ONE precomputed
  inverse-permutation gather per term gives a full-length vector. Terms
  are then added (the distributed ``A_loc x + A_rem x_halo`` pattern),
* ``x_index`` — which input vector the member reads (0 = x).

So mixed precision is one term of many members (``MixedPackSELL``), and
distribution two terms.

On CUDA each member runs its own kernel, in stored-row order
(``permuted=True``): a PackSELL block through its
:class:`~repro_torch.kernels.plan.SpMVPlan` (K1 for a fused plan, K4 for
``full``, K6 for ``band``; K3/K5 for ``spmm``), an uncompressed SELL block
(``fp32``/``fp64``) through K2, or K2 with a float64 sum, per bucket
(:func:`sell_stored_spmv`). Then one ``cat`` and one ``index_select`` per
term by the term's int32 inverse, which lives on the device from build
time. Nothing in a matvec reads the device from the host, so solvers
capture it into their CUDA graphs as it is. The kernel path's plain
twin (every member's kernels' plain versions, the same gather) is
:func:`repro_torch.kernels.ref.composite_plain`.

Everything host-side (member plans, term inverses, coverage checks)
happens at build time.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _device
from ..core import packsell as pk
from ..core import sell as sl
from ..core.packsell import PackSELLMatrix
from ..core.sell import SELLMatrix
from ..observe import metrics as _obs
from . import plan as kplan
from . import sell_spmv as _sk


# ---------------------------------------------------------------------------
# SELL member execution (stored-row order, gather-epilogue compatible)
# ---------------------------------------------------------------------------


def sell_stored_spmv(mat: SELLMatrix, x: torch.Tensor, *,
                     multi_rhs: bool = False) -> torch.Tensor:
    """One SELL block in stored-row order: the raw ``[S*C]`` slice outputs
    of every bucket, concatenated, with no per-block scatter (the
    composite's term gather maps them to global rows).

    The compute dtype is the value dtype promoted to at least float32, so
    fp32 blocks run K2 and fp64 blocks K2 with a float64 sum. A multi-RHS
    product runs K2 once per column: the reference's per-column arithmetic
    (its SELL member SpMM is no Pallas kernel)."""
    return stored_parts(mat, x, multi_rhs, _sk.sell_spmv_bucket)


def stored_parts(mat: SELLMatrix, x: torch.Tensor, multi_rhs: bool,
                 body) -> torch.Tensor:
    """:func:`sell_stored_spmv` with ``body(val, col, x, compute_dtype)``
    as each bucket's product (K2, or its plain version)."""
    cdt = torch.promote_types(sl.VALUE_DTYPES[mat.value_dtype],
                              torch.float32)
    xc = x.to(cdt).contiguous()
    parts = []
    for val, col in zip(mat.vals, mat.cols):
        if multi_rhs:
            t = torch.stack([body(val, col, xc[:, j].contiguous(), cdt)
                             for j in range(xc.shape[1])], dim=-1)
            parts.append(t.reshape(-1, xc.shape[1]))
        else:
            parts.append(body(val, col, xc, cdt).reshape(-1))
    if not parts:
        shape = (0, xc.shape[1]) if multi_rhs else (0,)
        return torch.zeros(shape, dtype=cdt, device=xc.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


# ---------------------------------------------------------------------------
# Members
# ---------------------------------------------------------------------------

#: codecs stored as uncompressed SELL value/column blocks
SELL_CODECS = ("fp32", "fp64")


@dataclasses.dataclass
class CompositeMember:
    """One format block inside a composite (see module docstring)."""

    mat: object                    # PackSELLMatrix | SELLMatrix
    plan: Optional[kplan.SpMVPlan]  # execution engine; None for SELL blocks
    codec: str
    D: int
    rows: Optional[np.ndarray] = None   # block row -> global row (ascending)
    x_index: int = 0
    term: int = 0
    label: str = ""

    @property
    def fmt(self) -> str:
        return "sell" if self.plan is None else "packsell"

    @property
    def stored(self) -> int:
        """Stored output slots this member emits."""
        if self.plan is not None:
            return self.plan.total_stored
        return sum(int(v.shape[0]) * int(v.shape[2]) for v in self.mat.vals)

    @property
    def block_n(self) -> int:
        return int(self.mat.n)

    def outrow_host(self) -> np.ndarray:
        """Host copy of the stored-slot → block-row map (sentinel >= n)."""
        if self.plan is not None:
            return self.plan.outrow_cat.cpu().numpy()
        outs = [o.cpu().numpy().reshape(-1) for o in self.mat.outrows]
        return (np.concatenate(outs) if outs
                else np.zeros((0,), np.int32))

    def device_operands(self) -> dict:
        """The member's plan-held device buffers (none for a SELL block).
        The member runs in stored-row order, so its inverse maps go
        unread: the composite's term gather replaces them."""
        return {} if self.plan is None else self.plan.device_operands()

    def execute(self, mat, dev: dict, x: torch.Tensor, *,
                multi_rhs: bool = False) -> torch.Tensor:
        """The block's output in stored-row order."""
        if self.plan is None:
            return sell_stored_spmv(mat, x, multi_rhs=multi_rhs)
        return self.plan.execute_with(mat, dev, x, permuted=True,
                                      multi_rhs=multi_rhs)


def member_from_csr(sub, codec: str, D: int, *, C: int = 32,
                    sigma: int = 256, rows=None, x_index: int = 0,
                    term: int = 0, label: str = "",
                    bucket_strategy: str | None = None, device=None,
                    force: str = "auto") -> CompositeMember:
    """Build one member from a CSR block on ``device`` (``None``: the
    GPU). ``codec`` in :data:`SELL_CODECS` builds an uncompressed SELL
    block; anything else a PackSELL block with its cached plan of
    ``force``."""
    dev = _device.resolve_device(device)
    if codec in SELL_CODECS:
        vd = {"fp32": "float32", "fp64": "float64"}[codec]
        mat = sl.from_csr(sub, C=C, sigma=sigma, value_dtype=vd,
                          bucket_strategy=bucket_strategy or "pow2",
                          device=dev)
        splan = None
    else:
        mat = pk.from_csr(sub, C=C, sigma=sigma, D=D, codec=codec,
                          bucket_strategy=bucket_strategy or "pow2",
                          device=dev)
        splan = kplan.get_plan(mat, force=force)
    return CompositeMember(
        mat=mat, plan=splan, codec=codec, D=D,
        rows=None if rows is None else np.asarray(rows, np.int64),
        x_index=x_index, term=term, label=label or f"{codec}/D={D}")


# ---------------------------------------------------------------------------
# Term inverse permutations (the one-gather epilogue)
# ---------------------------------------------------------------------------


def term_inverse(n: int, members: Sequence[CompositeMember], *,
                 allow_uncovered: bool = False,
                 term: int = 0) -> np.ndarray:
    """``inv[r]`` = slot of global row r in the term's concatenated member
    outputs. Requires disjoint member row sets; rows no member covers are
    an error unless ``allow_uncovered`` — then they point at the appended
    all-zero pad slot (index = term's total stored), so uncovered rows read
    exactly 0 through the gather.
    """
    inv = np.full(n, -1, np.int64)
    off = 0
    for mem in members:
        out = mem.outrow_host()
        valid = out < mem.block_n
        blk = out[valid]
        g = blk if mem.rows is None else mem.rows[blk]
        if np.any(inv[g] >= 0):
            raise ValueError(
                f"composite members overlap in rows (term {term})")
        inv[g] = off + np.nonzero(valid)[0]
        off += mem.stored
    missing = inv < 0
    if np.any(missing):
        if not allow_uncovered:
            raise ValueError(
                f"composite members cover {int((~missing).sum())} of {n} "
                f"rows in term {term}; every row needs exactly one class")
        inv[missing] = off          # the zero pad slot
    return inv.astype(np.int32)


# ---------------------------------------------------------------------------
# Memory accounting (one blend for plain/mixed/distributed)
# ---------------------------------------------------------------------------


def _block_bytes(mat) -> int:
    st = mat.memory_stats()
    return int(st.get("packsell_bytes", st.get("sell_bytes", 0)))


def composite_memory_stats(entries, *, halo: dict | None = None) -> dict:
    """Blend per-block memory stats into one profile with a per-member
    breakdown. ``entries``: iterable of ``(label, codec, D, n_rows, mats)``
    where ``mats`` is one block or a per-shard list of blocks; ``halo``: an
    optional communication profile merged in."""
    members = []
    total_bytes = total_nnz = 0
    for label, codec, D, n_rows, mats in entries:
        mats = mats if isinstance(mats, (list, tuple)) else [mats]
        b = sum(_block_bytes(m) for m in mats)
        nnz = sum(int(m.nnz) for m in mats)
        members.append({
            "label": label, "codec": codec, "D": D, "rows": n_rows,
            "bytes": b, "nnz": nnz, "bytes_per_nnz": b / max(nnz, 1)})
        total_bytes += b
        total_nnz += nnz
    out = {
        "composite_bytes": total_bytes,
        "bytes_per_nnz": total_bytes / max(total_nnz, 1),
        "nnz": total_nnz,
        "members": members,
    }
    if halo:
        out.update(halo)
    return out


# ---------------------------------------------------------------------------
# The composite plan
# ---------------------------------------------------------------------------


class CompositePlan:
    """Ordered member blocks, each through its own kernel, one gather per
    term. ``allow_uncovered=True`` routes rows no member covers to an
    appended all-zero pad slot instead of raising."""

    def __init__(self, members: Sequence[CompositeMember], n: int, m: int,
                 *, allow_uncovered: bool = False, name: str = "composite"):
        self.members = list(members)
        if not self.members:
            raise ValueError("composite needs at least one member")
        self.n = int(n)
        self.m = int(m)
        self.name = name
        self.pad_slot = bool(allow_uncovered)
        terms = sorted({mem.term for mem in self.members})
        if terms != list(range(len(terms))):
            raise ValueError(f"member terms must be 0..T-1, got {terms}")
        self.n_terms = len(terms)
        self.n_inputs = 1 + max(mem.x_index for mem in self.members)
        self._invs_np = tuple(
            term_inverse(self.n,
                         [mm for mm in self.members if mm.term == t],
                         allow_uncovered=allow_uncovered, term=t)
            for t in range(self.n_terms))
        self.device = self.members[0].mat.device
        self.invs = tuple(torch.from_numpy(v).to(self.device)
                          for v in self._invs_np)
        self.nnz = sum(int(mem.mat.nnz) for mem in self.members)
        self._cat: Optional[tuple] = None
        self._cat_built = False

    def validate(self, *, raise_: bool = True) -> list:
        """Structural integrity check over every member block and term
        inverse (``robust.guard.validate_composite``)."""
        from ..robust import guard as _guard
        return _guard.validate_composite(self, raise_=raise_)

    # -- operand plumbing --------------------------------------------------
    def member_mats(self) -> tuple:
        return tuple(mem.mat for mem in self.members)

    def member_devs(self) -> tuple:
        return tuple(mem.device_operands() for mem in self.members)

    def fused_cat(self) -> Optional[tuple]:
        """Every fused member's ``(words, ckpt)`` flattened into one
        ``(words_cat, ckpt_cat, slices)`` pair of device buffers plus the
        slice table (lazy; None unless two or more members carry a fused
        stream). The reference streams this one operand to keep its
        dispatch small; here each member's kernel reads its own plan's
        buffers, so nothing reads this copy on the matvec path."""
        if not self._cat_built:
            self._cat_built = True
            ws, cks, slices = [], [], []
            w_off = c_off = 0
            for mem in self.members:
                fz = None if mem.plan is None else mem.plan.fused
                if fz is None:
                    slices.append(None)
                    continue
                w3, ck = fz
                slices.append((w_off, tuple(w3.shape), c_off,
                               tuple(ck.shape)))
                ws.append(w3.reshape(-1))
                cks.append(ck.reshape(-1))
                w_off += w3.numel()
                c_off += ck.numel()
            if len(ws) >= 2:
                self._cat = (torch.cat(ws), torch.cat(cks), tuple(slices))
        return self._cat

    # -- execution body ----------------------------------------------------
    def execute_with(self, mats, devs, invs, xs, *,
                     multi_rhs: bool = False) -> torch.Tensor:
        """Run the composition body with externally supplied operands:
        per-member matrices and device-buffer dicts, per-term inverses and
        the input vectors (``xs[mem.x_index]`` feeds each member)."""
        parts = [[] for _ in range(self.n_terms)]
        for mem, mat, dev in zip(self.members, mats, devs):
            parts[mem.term].append(mem.execute(
                mat, dev, xs[mem.x_index], multi_rhs=multi_rhs))
        return self.gather(parts, invs)

    def gather(self, parts, invs) -> torch.Tensor:
        """Each term's stored-row member outputs (``parts[t]``, in member
        order) through one ``cat`` and one ``index_select`` by its inverse
        (``invs[t]``), the terms summed."""
        y = None
        for term_parts, inv in zip(parts, invs):
            dt = functools.reduce(torch.promote_types,
                                  [t.dtype for t in term_parts])
            term_parts = [t.to(dt) for t in term_parts]
            if self.pad_slot:
                term_parts.append(term_parts[0].new_zeros(
                    (1,) + tuple(term_parts[0].shape[1:])))
            t_cat = (term_parts[0] if len(term_parts) == 1
                     else torch.cat(term_parts))
            yt = torch.index_select(t_cat, 0, inv)
            y = yt if y is None else y + yt
        return y

    def _run(self, x: torch.Tensor, multi_rhs: bool) -> torch.Tensor:
        if self.n_inputs != 1:
            raise ValueError(
                "composite has members on input index > 0 (a distributed "
                "halo composition); drive it via execute_with")
        _obs.inc("composite.dispatch", composite=self.name,
                 kind="spmm" if multi_rhs else "spmv",
                 members=len(self.members), terms=self.n_terms)
        return self.execute_with(self.member_mats(), self.member_devs(),
                                 self.invs, (x,), multi_rhs=multi_rhs)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x: every member's kernel, then one gather per term."""
        return self._run(x, False)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """Y = A X for X: [m, nb] (every member's multi-RHS path)."""
        return self._run(x, True)

    @property
    def matvec(self):
        return self.spmv

    @property
    def shape(self):
        return (self.n, self.m)

    # -- unified plumbing --------------------------------------------------
    def warmup(self, nb: int = 0) -> "CompositePlan":
        """Run each product once ahead of the first real call (builds the
        kernels on the card)."""
        self.spmv(torch.zeros(self.m, device=self.device))
        if nb:
            self.spmm(torch.zeros((self.m, nb), device=self.device))
        return self

    def memory_stats(self, *, halo: dict | None = None) -> dict:
        return composite_memory_stats(
            [(mem.label, mem.codec, mem.D,
              mem.block_n if mem.rows is None else len(mem.rows), mem.mat)
             for mem in self.members], halo=halo)

    def describe(self) -> dict:
        """Machine-readable composite summary. ``plan`` is the member
        plan's variant: ``jnp`` on the CPU (as the reference's on a
        non-TPU backend), ``fused``/``full``/``band`` on the card."""
        return {
            "name": self.name, "n": self.n, "m": self.m,
            "terms": self.n_terms, "inputs": self.n_inputs,
            "members": [{
                "label": mem.label, "fmt": mem.fmt, "codec": mem.codec,
                "D": mem.D, "term": mem.term, "x_index": mem.x_index,
                "stored": mem.stored,
                "plan": None if mem.plan is None
                else mem.plan.describe()["variant"],
            } for mem in self.members],
        }

    def retile(self, member: int, tiles) -> None:
        """Install autotuned ``(sb, wb[, wr])`` winners into one member's
        plan (``SpMVPlan.retile``, which rebuilds its kernel table and
        drops its graphs)."""
        splan = self.members[member].plan
        if splan is None:
            raise ValueError(f"member {member} is a SELL block (no plan)")
        splan.retile(tiles)

    # -- constructors ------------------------------------------------------
    @classmethod
    def single(cls, mat, plan: kplan.SpMVPlan | None = None
               ) -> "CompositePlan":
        """The one-member composite: an ``SpMVPlan`` (or a SELL matrix) as
        the degenerate case of the composition engine."""
        if isinstance(mat, PackSELLMatrix):
            plan = plan or kplan.get_plan(mat)
            mem = CompositeMember(mat=mat, plan=plan, codec=mat.codec_name,
                                  D=mat.D, label=f"{mat.codec_name}/"
                                                 f"D={mat.D}")
        elif isinstance(mat, SELLMatrix):
            codec = {"float32": "fp32", "float64": "fp64"}.get(
                mat.value_dtype, mat.value_dtype)
            mem = CompositeMember(mat=mat, plan=None, codec=codec, D=0,
                                  label=codec)
        else:
            raise TypeError(f"cannot wrap {type(mat).__name__}")
        return cls([mem], n=mat.n, m=mat.m, name="single")

    @classmethod
    def from_classes(cls, a, classes, *, C: int = 32, sigma: int = 256,
                     name: str = "mixed", device=None,
                     force="auto") -> "CompositePlan":
        """Row-class composition over one CSR matrix: each ``(codec, D,
        rows)`` class becomes a member over its row submatrix (full column
        space — x is shared), all in one term. ``force`` is the plan
        variant of every PackSELL member, or a sequence of one per
        class."""
        a = a.tocsr()
        a.sort_indices()
        n = a.shape[0]
        forces = ([force] * len(classes) if isinstance(force, str)
                  else list(force))
        members = []
        for (codec, D, rows), f in zip(classes, forces):
            rows = (np.arange(n, dtype=np.int64) if rows is None
                    else np.asarray(rows, dtype=np.int64))
            members.append(member_from_csr(
                a[rows], codec, D, C=C, sigma=sigma, rows=rows,
                device=device, force=f))
        return cls(members, n=n, m=a.shape[1], name=name)


def from_arrays(entries, n: int, m: int, *, allow_uncovered: bool = False,
                name: str = "composite", device=None,
                force: str = "auto") -> CompositePlan:
    """A composite from host arrays, one entry per member: ``dict(fmt=
    'packsell' | 'sell', leaves=..., meta=..., codec=, D=, rows=,
    x_index=, term=, label=)``, where ``leaves``/``meta`` are what
    ``core.packsell.from_arrays``/``core.sell.from_arrays`` take. It takes
    the members of a ``repro`` composite (``np.asarray`` of each leaf)
    unchanged, which is how a reference composite carries over."""
    dev = _device.resolve_device(device)
    members = []
    for e in entries:
        if e["fmt"] == "sell":
            mat = sl.from_arrays(e["leaves"], e["meta"], device=dev)
            splan = None
        else:
            mat = pk.from_arrays(e["leaves"], e["meta"], device=dev)
            splan = kplan.get_plan(mat, force=force)
        rows = e.get("rows")
        members.append(CompositeMember(
            mat=mat, plan=splan, codec=e["codec"], D=e["D"],
            rows=None if rows is None else np.asarray(rows, np.int64),
            x_index=e.get("x_index", 0), term=e.get("term", 0),
            label=e.get("label", "")))
    return CompositePlan(members, n=n, m=m, allow_uncovered=allow_uncovered,
                         name=name)
