"""SpMVPlan: cached per-matrix plans and the fused-stream SpMV path.

The port of ``repro.kernels.plan`` for the main path. :func:`get_plan`
builds a :class:`SpMVPlan` once per matrix and caches it (token-keyed
LRU); every matvec then runs the plan's operands with no host work:

* the **fused stream** (:func:`_build_fused_stream`): all width buckets
  repacked once, on the host, into words ``[G, wr, C]`` plus one int32
  checkpoint per group lane, every word's delta rewritten to its column
  offset from the checkpoint, so the decode is one add per word;
* one kernel over the stream (``packsell_spmv_fused``, K1; K3 for SpMM),
  a level-chain tail (:func:`_fused_tail2`) and one 2-D inverse
  σ-permutation gather (:func:`_fused_unpermute2`), or no permutation at
  all with ``permuted=True`` (``cg.jacobi_pcg_stored``).

Variant policy (``force=``, default ``auto``; logged in
:attr:`SpMVPlan.policy`; the decision is :func:`choose_variant`). No
environment variable moves it: the reference's ``REPRO_SPMV_POLICY`` and
``REPRO_PLAN_CURSOR_CACHE`` are not read here.

* On CUDA, ``auto`` picks ``fused`` (K1) when the stream is feasible, then
  ``band`` (K6) when :func:`band_plan` is feasible and ``m >=
  _BAND_MIN_M``, else ``full`` (K4): the reference's order without its
  x-residency limit. ``force="full"``/``"band"`` pin the per-bucket
  kernels (an infeasible band raises ``ValueError``); a forced ``fused``
  whose stream is infeasible runs ``full``. ``force="jnp"`` asks for the
  plain PyTorch body explicitly.
* The per-bucket variants get width-block checkpoints ``int32[S, nw, C]``
  under ``decode_cache='checkpoint'`` (the width blocks of the sum, which
  the kernels' rows walk from ``d0``; the per-bucket plain versions seed
  each block from them and add the partials with
  ``packsell_spmv.sum_width_partials``) and none under ``'full'``/``'0'``
  (the carry body). Every bucket kernel is one launch over all buckets,
  through the :class:`~.packsell_spmv.BucketTable` built with the plan
  (``ktable``, with the band windows on a ``band`` plan): a ``full``
  plan's SpMV runs K4, a ``band`` plan's K6, and ``plan.spmm`` on either
  runs K5.
* On the CPU the decisions mirror the reference's on a non-TPU backend:
  ``auto`` gives ``jnp`` (the plain body over the fused stream, or the full
  cursor cache when the stream is infeasible), and ``force="fused"`` runs
  the kernel wrapper, which takes the plain version for CPU tensors.
* The reference's ``REPRO_FULL_X_LIMIT`` (x resident in TPU VMEM) does not
  apply: the CUDA kernels gather x from device memory through the 50 MB
  L2, so no size of x demotes a plan.
"""
from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Optional

import numpy as np
import torch

from .. import _generations
from ..core import codecs as cd
from ..core import packsell as pk
from ..core.packsell import PackSELLMatrix
from . import packsell_spmv as _pk

_POLICIES = ("auto", "full", "band", "jnp", "fused")
_CACHE_MODES = ("checkpoint", "full", "0")

#: candidate checkpoint row widths (words between checkpoints), largest
#: first. Power-of-two so pow2 bucket widths >= wr need no run padding.
_CKPT_WIDTHS = (128, 64, 32, 16, 8)

#: default half-window of the band variant (elements, a multiple of 128)
_DEF_HW = 4096
#: smallest m for which ``auto`` on CUDA takes a feasible band plan
_BAND_MIN_M = 65_536

_NO_X_LIMIT = ("; no x-residency limit (the CUDA kernels gather x from "
               "device memory through L2)")


# ---------------------------------------------------------------------------
# Band-window planning (host-side, per bucket)
# ---------------------------------------------------------------------------


def bucket_band_windows(d0, maxcol, sb: int, hw: int):
    """Per-slice-block window ids (half-window units) for one bucket, or
    None when some slice-block's column span exceeds the 2*hw window."""
    d0 = np.asarray(d0)
    mc = np.asarray(maxcol)
    S = len(d0)
    s_pad = -S % sb
    if s_pad:
        d0 = np.concatenate([d0, np.full(s_pad, d0[-1] if S else 0, np.int32)])
        mc = np.concatenate([mc, np.full(s_pad, mc[-1] if S else 0, np.int32)])
    d0b = d0.reshape(-1, sb).min(axis=1)
    mcb = mc.reshape(-1, sb).max(axis=1)
    win = d0b // hw
    if np.any(mcb - win * hw >= 2 * hw):
        return None
    return win.astype(np.int32)


def band_plan(mat: PackSELLMatrix, sb: int, hw: int):
    """Per-bucket window ids (numpy int32) if the band kernel is feasible
    for every slice-block, else None. Feasibility needs column locality
    within each ``sb``-slice block, so banded matrices want
    ``bucket_strategy='uniform'`` (contiguous slices)."""
    wins = []
    for d0, maxcol in zip(mat.d0s, mat.maxcols):
        win = bucket_band_windows(d0.cpu().numpy(), maxcol.cpu().numpy(), sb,
                                  hw)
        if win is None:
            return None
        wins.append(win)
    return wins


def choose_variant(policy: str, *, on_cuda: bool, fused_ok: bool,
                   band_ok: bool, m: int) -> tuple[str, str]:
    """``(variant, reason)`` for a policy, given whether the plan lives on
    CUDA, whether the fused stream and the band windows are feasible, and
    the column count ``m``. A forced band that is infeasible raises."""
    src = f"force={policy!r}"
    if policy == "jnp":
        return "jnp", f"forced via {src}: plain PyTorch body"
    if policy == "full":
        return "full", f"forced via {src}: per-bucket kernel K4"
    if policy == "band":
        if not band_ok:
            raise ValueError("band kernel infeasible for this matrix/hw")
        return "band", f"forced via {src}: band-windowed kernel K6"
    overflow = ("fused stream infeasible (group column span overflows every "
                "compact offset encoding)")
    if policy == "fused":
        if fused_ok:
            return "fused", f"forced via {src}"
        if on_cuda:
            return "full", (f"forced fused via {src} demoted to full: "
                            f"{overflow} — per-bucket kernel K4")
        return "jnp", f"forced fused via {src} demoted to jnp: {overflow}"
    if not on_cuda:
        return "jnp", ("auto on the CPU: plain PyTorch body (force='fused' "
                       "runs the kernel wrapper, which takes the plain "
                       "version for CPU tensors)")
    if fused_ok:
        return "fused", ("auto on CUDA: fused stream feasible — "
                         "fused-stream kernel K1")
    if band_ok and m >= _BAND_MIN_M:
        return "band", (f"auto on CUDA: {overflow}; band feasible and "
                        f"m={m} >= _BAND_MIN_M={_BAND_MIN_M} — "
                        "band-windowed kernel K6")
    why = ("band infeasible" if not band_ok else
           f"band feasible but m={m} < _BAND_MIN_M={_BAND_MIN_M}")
    return "full", f"auto on CUDA: {overflow}; {why} — per-bucket kernel K4"


# ---------------------------------------------------------------------------
# Host-side delta prefix sums (checkpoint + cursor-cache builders)
# ---------------------------------------------------------------------------


def _bucket_cursor_prefix(pack, d0, codec, D):
    """Exact int64 cursor BEFORE each word of one bucket: ``cum0[s, j, c]``
    = column cursor of stored row (s, c) before consuming word j
    (``cum0[:, 0, :]`` = d0). Shape [S, w+1, C]; entry ``w`` is the final
    cursor."""
    words = cd.words_to_numpy(pack)
    S, w, C = words.shape
    _, d, _ = cd.unpack_words_np(words.reshape(-1), codec, D)
    cum = np.cumsum(d.reshape(S, w, C).astype(np.int64), axis=1)
    zero = np.zeros((S, 1, C), np.int64)
    return d0.cpu().numpy()[:, None, None].astype(np.int64) + \
        np.concatenate([zero, cum], axis=1)


# ---------------------------------------------------------------------------
# Cursor-cached decode (jnp variant, mode='full')
# ---------------------------------------------------------------------------


def _cursor_spmv(pack, cols, xc, codec, D):
    """One bucket via the full cursor cache: value unpack + one gather +
    one reduction over the width axis (``[S, C]``, or ``[S, C, nb]`` for a
    2-D ``xc``)."""
    v, _ = cd.unpack_words_torch(pack, codec, D)
    tail = tuple(xc.shape[1:])
    v = v.to(torch.float32).reshape(v.shape + (1,) * len(tail))
    return (v * xc[cols.long()]).sum(dim=1)


def _build_cursor_cache(mat: PackSELLMatrix):
    """Decode every bucket's column cursors once (host numpy): the
    prefix-sum of word deltas, clamped to [0, m-1] as the runtime decode
    would."""
    mlim = max(mat.m - 1, 0)
    cols = []
    for pack, d0 in zip(mat.packs, mat.d0s):
        cum0 = _bucket_cursor_prefix(pack, d0, mat.codec, mat.D)
        cols.append(torch.from_numpy(
            np.minimum(cum0[:, 1:, :], mlim).astype(np.int32)).to(mat.device))
    return tuple(cols)


def _build_block_checkpoints(mat: PackSELLMatrix, tiles):
    """Per-bucket ``int32[S, nw, C]`` width-block checkpoints for the
    per-bucket kernels: the exact cursor before word ``wi * wb`` of each
    stored row, so width blocks need no cursor carry."""
    out = []
    for (_, wb), pack, d0 in zip(tiles, mat.packs, mat.d0s):
        S, w, C = pack.shape
        nw = -(-w // wb)
        cum0 = _bucket_cursor_prefix(pack, d0, mat.codec, mat.D)
        ck = cum0[:, ::wb, :][:, :nw, :]
        out.append(torch.from_numpy(ck.astype(np.int32)).to(mat.device))
    return tuple(out)


# ---------------------------------------------------------------------------
# Fused ragged stream + compact cursor checkpoints (mode='checkpoint')
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedSegment:
    """One width bucket's span inside the fused stream, laid out LEVEL-major
    over run-count-sorted slices: level k = run k of the first
    ``levels[k]`` sorted slices (a shrinking contiguous prefix)."""

    g0: int
    S: int
    C: int
    levels: tuple            # level k covers sorted slices [0, levels[k])

    @property
    def groups(self) -> int:
        return int(sum(self.levels))

    @property
    def stored(self) -> int:
        return self.S * self.C


@dataclasses.dataclass(frozen=True)
class FusedLayout:
    """Static shape of the fused ragged word stream (``words [groups, wr,
    C]`` + ``ckpt int32[groups, C]``) and how each word carries its
    (value, run-local column offset) pair:

    * ``'f16'``     — fp16 payload in the top 16 bits, offset in the low 16;
    * ``'top16'``   — top-16-of-fp32 payload (bf16; E8MY with V <= 16);
    * ``'fixed16'`` — fixed-point payload in the top 16 bits × ``scale``;
    * ``'words'``   — canonical pack words with the delta field rewritten
      to the re-based offset (any codec).
    """

    wr: int                  # words per group per lane == ckpt granularity
    groups: int
    C: int
    words_exact: int         # bucketed words before run padding
    segments: tuple          # of FusedSegment, in bucket order
    encoding: str = "words"
    scale: float = 0.0       # fixed16 dequant scale

    @property
    def pad_words(self) -> int:
        return self.groups * self.wr * self.C - self.words_exact

    @property
    def checkpoint_bytes(self) -> int:
        return 4 * self.groups * self.C

    @property
    def stream_bytes(self) -> int:
        return 4 * self.groups * self.wr * self.C


#: cost-model constants of the reference's checkpoint-width choice (kept so
#: the port picks the same ``wr``; re-fitting them for the H100 is later
#: work, ROADMAP.md)
_STREAM_PASSES = 3
_LEVEL_ADD_PASSES = 3
_LEVEL_OP_ELEMS = 40_000


def _pick_ckpt_width(widths, total: int) -> int:
    """Checkpoint width minimizing the modeled per-matvec cost, subject
    to the decode cache shrinking >= ``min(_CKPT_WIDTHS)``× vs the full
    cursor cache. ``widths`` is the list of (per-slice content widths, C)
    pairs per bucket; ties prefer the larger width."""
    floor = _CKPT_WIDTHS[-1]
    best = None                      # (ineligible, cost, -wr)
    for wr in _CKPT_WIDTHS:
        streamed = groups = levels = slices = 0
        for w, C in widths:
            runs = -(-np.maximum(w, 1) // wr)
            streamed += int(runs.sum()) * wr * C
            groups += int(runs.sum())
            levels += int(runs.max(initial=1)) - 1
            slices += len(w)
            last_C = C
        cbytes = groups * (last_C if widths else 1)
        shrink = total / cbytes if cbytes else float("inf")
        cost = _STREAM_PASSES * streamed \
            + _LEVEL_ADD_PASSES * (groups - slices) * (last_C if widths
                                                       else 1) \
            + _LEVEL_OP_ELEMS * levels
        key = (shrink < floor, cost, -wr)
        if best is None or key < best[0]:
            best = (key, wr)
    return best[1]


def _split16_encoding(mat: PackSELLMatrix):
    """The 16/16 split encoding for this matrix's codec, or None (valid
    when the word's value payload lives entirely in the top 16 bits)."""
    name, D = mat.codec_name, mat.D
    if name == "fp16":
        return "f16", 0.0
    if name == "bf16":
        return "top16", 0.0
    if name == "e8m" and cd.vbits_for(D) <= 16:
        return "top16", 0.0
    if name.startswith("fixed") and cd.vbits_for(D) <= 16:
        frac = int(name[len("fixed"):])
        return "fixed16", float(2.0 ** -(frac + D - 15))
    return None


def _build_fused_stream(mat: PackSELLMatrix, *, trim: bool = True,
                        wr: int | None = None):
    """Repack the bucketed words into the fused ragged-group layout, once,
    on the host. Returns ``((words3d, ckpt), layout, orders)`` with the
    tensors on the matrix's device — ``orders`` is the per-bucket slice
    permutation the caller bakes into ``outrow_cat`` — or ``(None, None,
    None)`` when no encoding fits (a group's column span overflows every
    offset field).

    Each bucket's slices are sorted by content width (descending run
    count, stable), their word runs padded to a multiple of ``wr`` with
    ``PAD_WORD`` and carved into ``wr``-word groups laid out level-major;
    all-padding trailing runs are trimmed. ``ckpt[g, c]`` is the exact
    column cursor before the group's first word (built in int64, stored as
    int32), and every word's delta is replaced by its build-time prefix sum
    re-based to that checkpoint. ``trim=False`` keeps the identity slice
    order and the full shape-derived run count; ``wr=`` pins the checkpoint
    width instead of the modeled pick.
    """
    C, D = mat.C, mat.D
    dmask = np.uint32(cd.delta_mask(D))
    total = sum(int(np.prod(p.shape)) for p in mat.packs)
    host_packs = [cd.words_to_numpy(p) for p in mat.packs]
    used_w = []
    for words in host_packs:
        S, w, C = words.shape
        if trim:
            nz = (words != pk.PAD_WORD).any(axis=2)        # [S, w]
            used = np.where(nz.any(axis=1),
                            w - np.argmax(nz[:, ::-1], axis=1), 1)
        else:
            used = np.full(S, w, np.int64)
        used_w.append((used.astype(np.int64), C))
    wr = _pick_ckpt_width(used_w, total) if wr is None else max(int(wr), 1)

    per_bucket, segs, orders = [], [], []
    g0 = 0
    locals_max = 0
    flag1_max = 0
    for (used, _), words, pack, d0 in zip(used_w, host_packs, mat.packs,
                                          mat.d0s):
        S, w, C = words.shape
        runs_s = -(-np.maximum(used, 1) // wr)             # >= 1 per slice
        order = np.argsort(-runs_s, kind="stable").astype(np.int64)
        runs_sorted = runs_s[order]
        maxr = int(runs_sorted[0]) if S else 1
        levels = tuple(int((runs_sorted > k).sum()) for k in range(maxr))
        wpad = maxr * wr
        cum0 = _bucket_cursor_prefix(pack, d0, mat.codec, D)[order]
        wp = np.full((S, wpad, C), pk.PAD_WORD, np.uint32)
        wk = min(w, wpad)           # trimming can shrink below w
        wp[:, :wk, :] = words[order][:, :wk, :]
        ck = cum0[:, ::wr, :][:, :maxr, :]                 # [S, maxr, C]
        # inclusive cursor per word, padding words frozen at the last real
        # cursor, re-based to the group checkpoint
        cum = np.concatenate(
            [cum0[:, 1:, :],
             np.broadcast_to(cum0[:, -1:, :],
                             (S, max(wpad - w, 0), C))], axis=1)[:, :wpad]
        local = (cum.reshape(S, maxr, wr, C)
                 - ck[:, :, None, :]).reshape(S, wpad, C)
        flag = wp & np.uint32(1)
        # only the KEPT groups constrain the encoding
        keep = np.zeros((S, maxr), bool)
        for k, Sk in enumerate(levels):
            keep[:Sk, k] = True
        keepw = np.repeat(keep, wr, axis=1)[:, :, None]
        lk = np.where(keepw, local, 0)
        locals_max = max(locals_max, int(lk.max(initial=0)))
        f1 = lk[(flag == 1) & keepw]
        flag1_max = max(flag1_max, int(f1.max(initial=0)))
        per_bucket.append((wp, flag, local, ck, S, maxr, levels))
        segs.append(FusedSegment(g0=g0, S=S, C=C, levels=levels))
        orders.append(order)
        g0 += int(sum(levels))

    split = _split16_encoding(mat)
    if split is not None and locals_max < (1 << 16):
        encoding, scale = split
    elif flag1_max < (1 << D) and locals_max < (1 << 31):
        encoding, scale = "words", 0.0
    else:
        return None, None, None     # span overflow: no compact encoding

    blk_w, blk_c = [], []
    for wp, flag, local, ck, S, maxr, levels in per_bucket:
        lu = np.minimum(local, (1 << 16) - 1 if encoding != "words"
                        else (1 << 31) - 1).astype(np.uint32)
        if encoding == "words":
            payload = wp & ~dmask
            w1 = payload | (lu << np.uint32(1)) | np.uint32(1)
            w0 = lu << np.uint32(1)
            nw = np.where(flag == 1, w1, w0)
        else:
            # value payload is top-16-aligned: keep it, splice the offset
            payload16 = np.where(flag == 1, wp & ~dmask, np.uint32(0))
            nw = (payload16 & np.uint32(0xFFFF0000)) | lu
        nw4 = nw.reshape(S, maxr, wr, nw.shape[-1])
        for k, Sk in enumerate(levels):
            blk_w.append(nw4[:Sk, k])
            blk_c.append(ck[:Sk, k])
    words3d = (np.concatenate(blk_w) if blk_w
               else np.zeros((0, wr, C), np.uint32))
    ckpt = (np.concatenate(blk_c) if blk_c
            else np.zeros((0, C), np.int64))
    layout = FusedLayout(
        wr=wr, groups=g0, C=C, words_exact=total,
        segments=tuple(segs), encoding=encoding, scale=scale)
    dev = mat.device
    return ((cd.words_to_torch(words3d, dev),
             torch.from_numpy(ckpt.astype(np.int32)).to(dev)),
            layout, orders)


def _fused_tail2(part, layout: FusedLayout):
    """Segmented reduction over group partials: [groups, C(, nb)] →
    [total_slices, C(, nb)] in sorted-slice-major stored order — per
    segment an add chain over shrinking slice prefixes, in level order.
    When every segment is single-level the partials ARE the result."""
    if not layout.segments or all(len(seg.levels) == 1
                                  for seg in layout.segments):
        return part
    outs = []
    for seg in layout.segments:
        t = part[seg.g0:seg.g0 + seg.levels[0]]
        off = seg.levels[0]
        for Sk in seg.levels[1:]:
            lk = part[seg.g0 + off:seg.g0 + off + Sk]
            if Sk < seg.S:
                pad = torch.zeros((seg.S - Sk,) + tuple(lk.shape[1:]),
                                  dtype=lk.dtype, device=lk.device)
                lk = torch.cat([lk, pad])
            t = t + lk
            off += Sk
        outs.append(t)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _fused_tail(part, layout: FusedLayout):
    """[groups, C(, nb)] → flat [total_stored(, nb)] in ``outrow_cat``
    order (the ``permuted=True`` contract)."""
    tail = tuple(part.shape[2:])
    if not layout.segments:
        return torch.zeros((0,) + tail, dtype=part.dtype, device=part.device)
    return _fused_tail2(part, layout).reshape((-1,) + tail)


def _fused_unpermute2(t2, inv2):
    """y[r] = t2[slice(r), lane(r)]: the σ-unpermutation applied directly
    to the 2-D slice-major tail (one gather, unique in-bounds indices)."""
    return t2[inv2[:, 0].long(), inv2[:, 1].long()]


def stored_permute(v, outrow_cat, n: int):
    """Original-row order → stored-row order (σ-padding slots become 0)."""
    o = outrow_cat.long()
    if n == 0:
        return torch.zeros((len(o),) + tuple(v.shape[1:]), dtype=v.dtype,
                           device=v.device)
    val = v[o.clamp(0, n - 1)]
    mask = (o < n).reshape((-1,) + (1,) * (v.dim() - 1))
    return torch.where(mask, val, torch.zeros((), dtype=v.dtype,
                                              device=v.device))


def stored_unpermute(t, inv_cat):
    """Stored-row order → original-row order: the σ-permutation as a
    gather by the precomputed inverse map (each original row has exactly
    one stored slot, so this equals the scatter). ``index_select`` takes
    the int32 map as it is, so no index cast runs per call."""
    return torch.index_select(t, 0, inv_cat)


def _build_inverse_perm(mat: PackSELLMatrix, outrow_cat: torch.Tensor):
    """inv[r] = stored slot of original row r (each row has exactly one),
    turning the σ-scatter epilogue into a gather."""
    outrow_np = outrow_cat.cpu().numpy()
    valid = outrow_np < mat.n
    inv = np.zeros(mat.n, np.int32)
    inv[outrow_np[valid]] = np.nonzero(valid)[0].astype(np.int32)
    return torch.from_numpy(inv).to(mat.device)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpMVPlan:
    """Everything host-side the hot path would otherwise recompute: the
    variant, the decode-cache layout and the σ-permutation maps, fixed at
    build time on the matrix's device."""

    variant: str                      # 'fused' | 'band' | 'full' | 'jnp'
    policy: str                       # human-readable decision log
    outrow_cat: torch.Tensor          # int32 [total_stored] stored → orig row
    n: int
    m: int
    total_stored: int
    device: torch.device
    inv_cat: Optional[torch.Tensor] = None   # int32 [n] inverse σ-permutation
    inv2_cat: Optional[torch.Tensor] = None  # int32 [n, 2] (slice, lane) form
    cols: Optional[tuple] = None      # per-bucket int32 [S, w, C] cursor cache
    cache_mode: str = "0"             # 'checkpoint' | 'full' | '0'
    fused: Optional[tuple] = None     # (words int32[G, wr, C], ckpt int32[G, C])
    fused_layout: Optional[FusedLayout] = None
    total_words: int = 0              # bucketed words (decode-cache pricing)
    fused_trim: bool = True
    hw: int = _DEF_HW                 # band half-window (elements)
    tiles: tuple = ()                 # per-bucket (sb, wb)
    wins: Optional[tuple] = None      # per-bucket int32 windows (band only)
    kckpts: Optional[tuple] = None    # per-bucket int32 [S, nw, C]
    ktable: Optional[_pk.BucketTable] = None  # K4/K5/K6 launch table
    #: the solvers' cached graphs on this plan (``cg.jacobi_pcg_stored``)
    _fns: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)
    #: the matrix the plan was built for (weakly: the cache holds the plan)
    _matref: Optional[weakref.ref] = dataclasses.field(
        default=None, repr=False, compare=False)
    #: why a guard tripped on this plan, or None while it is healthy
    #: (``robust.guard.mark_unhealthy``)
    _unhealthy: Optional[str] = dataclasses.field(default=None, repr=False,
                                                  compare=False)
    #: raised by each :meth:`retile`: a graph captured over the plan's
    #: earlier buffers captures again (``repro_torch._generations``)
    generation: int = dataclasses.field(default=0, repr=False,
                                        compare=False)

    # -- σ-permutation helpers (stored-row order <-> original order) -------
    def from_stored(self, t: torch.Tensor) -> torch.Tensor:
        """Map a stored-row-order vector [total_stored] (or
        [total_stored, nb]) back to original row order [n] ([n, nb])."""
        return stored_unpermute(t, self.inv_cat)

    def to_stored(self, v: torch.Tensor) -> torch.Tensor:
        """Gather an original-row-order vector into stored-row order;
        σ-padding slots become 0 (and stay 0 through SpMV)."""
        return stored_permute(v, self.outrow_cat, self.n)

    # -- execution ---------------------------------------------------------
    def device_operands(self) -> dict:
        return {"cols": self.cols, "inv": self.inv_cat,
                "inv2": self.inv2_cat, "outrow": self.outrow_cat,
                "fused": self.fused, "kckpt": self.kckpts,
                "ktable": self.ktable, "wins": self.wins}

    def execute_with(self, mat: PackSELLMatrix, dev: dict, x: torch.Tensor,
                     *, permuted: bool = False,
                     multi_rhs: bool = False) -> torch.Tensor:
        """Run the plan's execution body on the given operands (``dev`` as
        :meth:`device_operands` returns it)."""
        _generations.read(self)
        xc = x.to(torch.float32).contiguous()
        fused = dev.get("fused")
        if fused is not None:
            lay = self.fused_layout
            if self.variant == "fused":
                body = (_pk.packsell_spmm_fused if multi_rhs
                        else _pk.packsell_spmv_fused)
            else:
                body = (_pk.packsell_spmm_fused_plain if multi_rhs
                        else _pk.packsell_spmv_fused_plain)
            part = body(fused[0], fused[1], xc, codec_name=mat.codec_name,
                        D=mat.D, encoding=lay.encoding, scale=lay.scale)
            return self._fused_epilogue(part, dev, permuted)
        if self.variant == "fused":
            raise ValueError("fused plan dispatched without its stream "
                             "operand (dev['fused'] is None)")
        t_cat = self._bucket_parts(mat, dev, xc, multi_rhs)
        return t_cat if permuted else stored_unpermute(t_cat, dev["inv"])

    def _fused_epilogue(self, part, dev: dict, permuted: bool):
        if permuted:
            return _fused_tail(part, self.fused_layout)
        return _fused_unpermute2(_fused_tail2(part, self.fused_layout),
                                 dev["inv2"])

    def _bucket_parts(self, mat, dev, xc, multi_rhs: bool):
        """The bucket bodies: one launch over all buckets of a ``full`` or
        ``band`` plan (K4 or K6 for the SpMV; K5 for the SpMM of either,
        as the reference's band plan runs the full-x SpMM), else per bucket
        the plain full cursor cache, or the scan decode when there is no
        cache (``decode_cache='0'``)."""
        tail = tuple(xc.shape[1:])
        kck = dev.get("kckpt")
        kw = dict(codec_name=mat.codec_name, D=mat.D)
        if self.variant in ("full", "band"):
            args = (mat.packs, mat.d0s, kck, dev["ktable"], xc)
            if multi_rhs:
                return _pk.packsell_spmm_buckets(*args, **kw)
            if self.variant == "full":
                return _pk.packsell_spmv_buckets(*args, **kw)
            return _pk.packsell_spmv_band_buckets(
                mat.packs, mat.d0s, dev["wins"], *args[2:], hw=self.hw, **kw)
        xg = pk._nonempty(xc)
        parts = []
        for b, (pack, d0) in enumerate(zip(mat.packs, mat.d0s)):
            if dev["cols"] is not None:
                t = _cursor_spmv(pack, dev["cols"][b], xg, mat.codec, mat.D)
            else:
                t = pk._bucket_spmv_scan(pack, d0, xg, mat.codec, mat.D,
                                         max(mat.m - 1, 0))
            parts.append(t.reshape((-1,) + tail))
        if not parts:
            return torch.zeros((0,) + tail, dtype=torch.float32,
                               device=xc.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def spmv(self, mat: PackSELLMatrix, x: torch.Tensor, *,
             permuted: bool = False) -> torch.Tensor:
        """y = A @ x; ``permuted=True`` returns y in stored-row order,
        skipping the σ-permutation epilogue."""
        return self.execute_with(mat, self.device_operands(), x,
                                 permuted=permuted)

    def spmm(self, mat: PackSELLMatrix, x: torch.Tensor, *,
             permuted: bool = False) -> torch.Tensor:
        """Y = A @ X for X: [m, nb] (one pass over the words for all
        right-hand sides)."""
        return self.execute_with(mat, self.device_operands(), x,
                                 permuted=permuted, multi_rhs=True)

    def as_composite(self, mat: PackSELLMatrix):
        """This plan as the single-member case of the block-composition
        engine (:class:`~repro_torch.kernels.composite.CompositePlan`)."""
        from . import composite
        return composite.CompositePlan.single(mat, self)

    def validate(self, mat: PackSELLMatrix | None = None, *,
                 raise_: bool = True) -> list:
        """Full structural validation of the plan's derived operands
        (``robust.guard.validate_plan``): the issue list (``raise_=False``)
        or ``IntegrityError``."""
        from ..robust import guard as _guard

        if mat is None:
            mat = self._matref() if self._matref is not None else None
        if mat is None:
            raise ValueError("cannot validate: matrix is gone; pass mat=")
        return _guard.validate_plan(mat, self, raise_=raise_)

    def describe(self) -> dict:
        return {"variant": self.variant, "policy": self.policy,
                "tiles": [list(t) for t in self.tiles], "hw": self.hw,
                "device": str(self.device), "n": self.n, "m": self.m,
                "total_stored": self.total_stored,
                "cache_mode": self.cache_mode,
                "cursor_cache": self.cols is not None,
                "fused": self.fused is not None,
                "encoding": (None if self.fused_layout is None
                             else self.fused_layout.encoding),
                "ckpt_width": (None if self.fused_layout is None
                               else self.fused_layout.wr)}

    # -- autotune hook -----------------------------------------------------
    def retile(self, tiles) -> None:
        """Install per-bucket ``(sb, wb)`` (or ``(sb, wb, wr)``) winners:
        the band windows and width-block checkpoints are recomputed for
        the new tiles, and a third element pins the fused stream's
        checkpoint width ``wr`` (plan-global: all triples must agree),
        rebuilding the stream and both σ-permutation maps when it changes.

        The bucket kernels' table is rebuilt over the new checkpoints and
        windows. The plan's own graphs (``_fns``) are dropped, and its
        :attr:`generation` goes up, so every graph that
        ``solvers.graphs`` captured over the old buffers elsewhere (a
        caller's ``jit_cache``, ``OperatorSet.graphs``) captures again at
        its next call instead of replaying: the old buffers are freed. A
        graph captured by other means must be captured again by its
        owner."""
        tiles = tuple(tuple(int(v) for v in t) for t in tiles)
        if len(tiles) != len(self.tiles):
            raise ValueError(f"need {len(self.tiles)} (sb, wb[, wr]) "
                             "tuples")
        if any(len(t) not in (2, 3) for t in tiles):
            raise ValueError("tiles must be (sb, wb) or (sb, wb, wr)")
        wrs = {t[2] for t in tiles if len(t) == 3}
        if len(wrs) > 1:
            raise ValueError("the fused checkpoint width wr is plan-"
                             f"global; got conflicting values {sorted(wrs)}")
        new_wr = wrs.pop() if wrs else None
        tiles = tuple(t[:2] for t in tiles)
        mat = self._matref() if self._matref is not None else None
        # before any buffer is replaced, so that a retile that raises half
        # way leaves no graph over the buffers it did replace
        self._fns.clear()
        self.generation += 1
        if self.variant == "band":
            if mat is None:
                raise ValueError("cannot retile a band plan: matrix is gone")
            wins = []
            for (sb, _), d0, maxcol in zip(tiles, mat.d0s, mat.maxcols):
                win = bucket_band_windows(d0.cpu().numpy(),
                                          maxcol.cpu().numpy(), sb, self.hw)
                if win is None:
                    raise ValueError(
                        f"band kernel infeasible at sb={sb}, hw={self.hw}")
                wins.append(torch.from_numpy(win).to(self.device))
            self.wins = tuple(wins)
        if self.kckpts is not None:
            if mat is None:
                raise ValueError("cannot retile checkpoints: matrix is gone")
            self.kckpts = _build_block_checkpoints(mat, tiles)
        if self.ktable is not None:
            if mat is None:
                raise ValueError("cannot retile the bucket table: matrix is "
                                 "gone")
            self.ktable = _pk.bucket_table(
                mat.packs, mat.d0s, self.kckpts, [wb for _, wb in tiles],
                wins=self.wins, sbs=[sb for sb, _ in tiles])
        if (new_wr is not None and self.fused is not None
                and self.fused_layout is not None
                and new_wr != self.fused_layout.wr):
            if mat is None:
                raise ValueError(
                    "cannot re-width the fused stream: matrix is gone")
            fused, layout, orders = _build_fused_stream(
                mat, trim=self.fused_trim, wr=new_wr)
            if fused is None:
                raise ValueError(
                    f"wr={new_wr}: fused stream infeasible (group column "
                    "span overflows every compact offset encoding)")
            self.fused, self.fused_layout = fused, layout
            # the slice sort depends on runs-per-slice = f(wr): re-bake the
            # stored order and both inverse-permutation forms
            self.outrow_cat, self.inv_cat, self.inv2_cat = _stored_maps(
                mat, orders, True)
            _quick_validate(self)
        self.tiles = tiles

    def decode_cache_stats(self) -> dict:
        """Decode-cache device memory, priced against the full cursor
        cache (4 bytes per bucketed word)."""
        full = 4 * self.total_words
        if self.cache_mode == "checkpoint" and self.fused_layout is not None:
            cache = self.fused_layout.checkpoint_bytes
            stream = self.fused_layout.stream_bytes
            pad = self.fused_layout.pad_words
        elif self.cache_mode == "checkpoint" and self.kckpts is not None:
            cache = sum(4 * c.numel() for c in self.kckpts)
            stream, pad = 0, 0
        elif self.cols is not None:
            cache, stream, pad = full, 0, 0
        else:
            cache, stream, pad = 0, 0, 0
        return dict(cache_mode=self.cache_mode,
                    decode_cache_bytes=cache,
                    full_cursor_bytes=full,
                    fused_stream_bytes=stream,
                    fused_pad_words=pad,
                    shrink_vs_full=(full / cache) if cache else float("inf"))


# ---------------------------------------------------------------------------
# Plan construction + cache
# ---------------------------------------------------------------------------


def build_plan(mat: PackSELLMatrix, *, sb: int = 8, wb: int = 32,
               hw: int = _DEF_HW, force: str = "auto",
               decode_cache: str = "checkpoint", fused_trim: bool = True,
               ckpt_wr: int | None = None) -> SpMVPlan:
    """Host-side plan construction (run once per matrix; the policy is in
    the module docstring). ``sb``/``wb`` are the per-bucket kernels' slice
    and width blocks and ``hw`` the band half-window; ``decode_cache`` in
    {'checkpoint', 'full', '0'} picks the decode cache; ``fused_trim=False``
    keeps the fused layout shape-derived; ``ckpt_wr=`` pins the checkpoint
    width."""
    policy = force.lower()
    if policy not in _POLICIES:
        raise ValueError(f"force={policy!r} not in {_POLICIES}")
    mode = decode_cache.lower()
    if mode not in _CACHE_MODES:
        raise ValueError(f"decode_cache={mode!r} not in {_CACHE_MODES}")
    on_cuda = mat.device.type == "cuda"
    tiles = tuple((sb, wb) for _ in mat.packs)
    wins = None
    if policy in ("auto", "band") and mat.m > 0:
        wins = band_plan(mat, sb, hw)
    fused, layout, orders = (None, None, None)
    if policy == "fused" or (policy == "auto" and on_cuda):
        fused, layout, orders = _build_fused_stream(mat, trim=fused_trim,
                                                    wr=ckpt_wr)
    variant, reason = choose_variant(policy, on_cuda=on_cuda,
                                     fused_ok=fused is not None,
                                     band_ok=wins is not None, m=mat.m)
    if variant == "jnp" and policy == "fused":
        mode = "full"            # the demoted plan runs the cursor cache
    if variant != "jnp" and on_cuda:
        reason += _NO_X_LIMIT
    if variant != "band":
        wins = None
    if variant in ("full", "band"):
        fused, layout, orders = (None, None, None)

    cols = kckpts = ktable = None
    dev_wins = None if wins is None else tuple(
        torch.from_numpy(w).to(mat.device) for w in wins)
    if variant == "fused":
        if mode != "checkpoint":
            reason += (f"; decode_cache={mode!r} overridden to "
                       "'checkpoint' (the fused stream is the decode cache)")
            mode = "checkpoint"
    elif variant in ("full", "band"):
        if mode == "checkpoint":
            kckpts = _build_block_checkpoints(mat, tiles)
        ktable = _pk.bucket_table(mat.packs, mat.d0s, kckpts,
                                  [wb for _, wb in tiles], wins=dev_wins,
                                  sbs=[sb for sb, _ in tiles])
    else:
        if mode != "checkpoint":
            fused, layout, orders = (None, None, None)
        elif fused is None:
            fused, layout, orders = _build_fused_stream(mat, trim=fused_trim,
                                                        wr=ckpt_wr)
            if fused is None:
                mode = "full"
                reason += ("; checkpoint stream infeasible (group column "
                           "span overflow), fell back to full cursor cache")
        if mode == "full":
            cols = _build_cursor_cache(mat)
    outrow_cat, inv, inv2 = _stored_maps(mat, orders, fused is not None)
    plan = SpMVPlan(
        variant=variant, policy=f"{variant} ({reason})",
        outrow_cat=outrow_cat, n=mat.n, m=mat.m,
        total_stored=sum(int(p.shape[0]) * int(p.shape[2])
                         for p in mat.packs),
        device=mat.device, inv_cat=inv, inv2_cat=inv2, cols=cols,
        cache_mode=mode, fused=fused, fused_layout=layout,
        total_words=sum(int(np.prod(p.shape)) for p in mat.packs),
        fused_trim=fused_trim, hw=hw, tiles=tiles,
        wins=dev_wins, kckpts=kckpts, ktable=ktable,
        _matref=weakref.ref(mat))
    _quick_validate(plan)
    return plan


def _stored_maps(mat: PackSELLMatrix, orders, with_inv2: bool):
    """``(outrow_cat, inv_cat, inv2_cat)``: the stored order, with the
    fused layout's per-bucket slice sort ``orders`` baked in (None: the
    buckets' own order), its inverse, and (``with_inv2``) the inverse's
    (slice, lane) form."""
    if orders is not None:
        outs = [o.cpu().numpy().reshape(len(ordr), -1)[ordr].reshape(-1)
                for o, ordr in zip(mat.outrows, orders)]
    else:
        outs = [o.cpu().numpy().reshape(-1) for o in mat.outrows]
    outrow_cat = torch.from_numpy(
        np.concatenate(outs) if outs else np.zeros((0,), np.int32)
    ).to(mat.device)
    inv = _build_inverse_perm(mat, outrow_cat)
    inv2 = None
    if with_inv2:
        inv_np = inv.cpu().numpy()
        inv2 = torch.from_numpy(np.stack(
            [inv_np // mat.C, inv_np % mat.C], axis=1).astype(np.int32)
        ).to(mat.device)
    return outrow_cat, inv, inv2


def _quick_validate(plan: SpMVPlan) -> None:
    """Cheap build-time structural invariants. A violation is a
    construction bug, never input data: raise before any kernel reads
    out of bounds."""
    outrow = plan.outrow_cat.cpu().numpy()
    if len(outrow) != plan.total_stored:
        raise ValueError(
            f"plan build: outrow_cat length {len(outrow)} != total_stored "
            f"{plan.total_stored}")
    counts = np.bincount(outrow[outrow < plan.n], minlength=max(plan.n, 1))
    if plan.n and (counts[:plan.n].min() < 1 or counts[:plan.n].max() > 1):
        raise ValueError("plan build: outrow_cat is not a bijection onto "
                         "[0, n)")
    layout = plan.fused_layout
    if plan.fused is not None and layout is not None:
        w3, ck = plan.fused
        if tuple(w3.shape) != (layout.groups, layout.wr, layout.C):
            raise ValueError(
                f"plan build: fused stream shape {tuple(w3.shape)} != "
                f"layout ({layout.groups}, {layout.wr}, {layout.C})")
        if tuple(ck.shape) != (layout.groups, layout.C):
            raise ValueError(
                f"plan build: fused checkpoint shape {tuple(ck.shape)} != "
                f"({layout.groups}, {layout.C})")
        g_sum = sum(seg.groups for seg in layout.segments)
        if g_sum != layout.groups:
            raise ValueError(
                f"plan build: segment group accounting {g_sum} != "
                f"{layout.groups}")
        stored = sum(seg.stored for seg in layout.segments)
        if stored != plan.total_stored:
            raise ValueError(
                f"plan build: segment stored accounting {stored} != "
                f"{plan.total_stored}")


_PLANS: dict = {}
_STATS = {"hits": 0, "misses": 0, "evicted": 0}
_TOKENS = itertools.count()
#: most plans the cache holds before the least recently used one drops
PLAN_CACHE_CAP = 256


def _plan_token(mat: PackSELLMatrix) -> int:
    """Monotonic per-matrix cache token: unlike ``id(mat)`` it is never
    recycled, so a dead matrix's weakref callback cannot evict the plan of
    a new matrix at the same address."""
    tok = getattr(mat, "_plan_token", None)
    if tok is None:
        tok = next(_TOKENS)
        mat._plan_token = tok
    return tok


def get_plan(mat: PackSELLMatrix, *, sb: int = 8, wb: int = 32,
             hw: int = _DEF_HW, force: str = "auto",
             decode_cache: str = "checkpoint", fused_trim: bool = True,
             ckpt_wr: int | None = None) -> SpMVPlan:
    """Cached plan lookup, keyed on ``(matrix token, sb, wb, hw, policy,
    decode-cache mode, trim, ckpt_wr)``; entries drop when the matrix dies
    (weakref) or fall off the LRU end (:data:`PLAN_CACHE_CAP`)."""
    key = (_plan_token(mat), sb, wb, hw, force.lower(), decode_cache.lower(),
           fused_trim, ckpt_wr)
    ent = _PLANS.get(key)
    if ent is not None and ent[0]() is mat:
        _STATS["hits"] += 1
        _PLANS[key] = _PLANS.pop(key)       # move to MRU position
        return ent[1]
    plan = build_plan(mat, sb=sb, wb=wb, hw=hw, force=force,
                      decode_cache=decode_cache, fused_trim=fused_trim,
                      ckpt_wr=ckpt_wr)

    def _drop(_ref, key=key):
        if _PLANS.pop(key, None) is not None:
            _STATS["evicted"] += 1

    _PLANS[key] = (weakref.ref(mat, _drop), plan)
    _STATS["misses"] += 1
    while len(_PLANS) > PLAN_CACHE_CAP:
        _PLANS.pop(next(iter(_PLANS)))
        _STATS["evicted"] += 1
    return plan


def cache_stats() -> dict:
    return dict(_STATS, size=len(_PLANS))


def clear_cache() -> None:
    _PLANS.clear()
    _STATS.update(hits=0, misses=0, evicted=0)
