"""Seeded, deterministic fault injectors for every execution path.

The port of ``repro.robust.inject``. Each injector corrupts ONE operand
of a live plan and returns an
:class:`Injection` describing what changed and whether the corruption is
provably **value-neutral** (y bit-identical for every finite x, e.g. a
flip inside a padding word). The neutrality oracle is exact: it compares
the corrupted operand's per-row coefficient vectors with the originals
under the clamp rule the runtime gather uses. Each draws from
``np.random.default_rng(seed)`` exactly as the reference does, so the
same seed hits the same word where the operand shapes agree.

The reference copies, modifies and replaces an operand (JAX arrays are
immutable). Here every injector writes **in place**, and ``undo()``
writes the old value back in place: the kernels read the plan's buffers
by address (the bucket kernels through a table of addresses, which they
hold against the tensors they are given), and a CUDA graph captured
before the injection keeps those addresses, so a replaced tensor would
never be read. In place, the corruption reaches the next launch and the
next graph replay alike.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..core import codecs as cd
from .guard import _decode_stream_np


@dataclasses.dataclass
class Injection:
    """One injected fault: what was corrupted, where, and whether it can
    change any SpMV result (``value_neutral=False`` ⇒ some finite x sees a
    different y). ``undo()`` restores the original operand."""

    target: str                       # 'fused_word' | 'ckpt' | 'perm' | ...
    detail: dict
    value_neutral: bool
    _undo: Optional[Callable[[], None]] = None
    undone: bool = False

    def undo(self) -> None:
        if not self.undone and self._undo is not None:
            self._undo()
        self.undone = True


def _put(t: torch.Tensor, pos: tuple, value: int) -> None:
    """Write the 32-bit pattern ``value`` at ``pos`` of int32 ``t``."""
    t[pos] = cd.as_int32(int(value))


def _decode_word(word: np.uint32, mat, layout):
    """(value float64, run-local offset int) of one fused-stream word."""
    v, local = _decode_stream_np(
        np.asarray(word, np.uint32).reshape(1, 1, 1), mat, layout)
    return float(v[0, 0, 0]), int(local[0, 0, 0])


def _lane_coeff_fused(words, ck_val: int, mat, layout, m: int):
    """Coefficient vector of one fused group lane: coeff[col] = Σ v over
    the lane's words (runtime clamp rule). Equal coefficient vectors ⇔
    identical y for every finite x."""
    w3 = np.asarray(words, np.uint32).reshape(1, -1, 1)
    v, local = _decode_stream_np(w3, mat, layout)
    cols = np.clip(ck_val + local[0, :, 0], 0, max(m - 1, 0))
    coeff = np.zeros(max(m, 1), np.float64)
    contrib = v[0, :, 0] != 0
    np.add.at(coeff, cols[contrib], v[0, :, 0][contrib])
    return coeff


def _lane_coeff_pack(words, d0_val: int, codec, D, m: int,
                     cols_override=None):
    """Coefficient vector of one bucketed-pack lane (columns re-derived
    from the deltas; ``cols_override`` pins the build-time columns of a
    full cursor cache)."""
    v, d, flag = cd.unpack_words_np(np.asarray(words, np.uint32), codec, D)
    if cols_override is None:
        cols = d0_val + np.cumsum(d.astype(np.int64))
    else:
        cols = cols_override
    cols = np.clip(cols, 0, max(m - 1, 0))
    coeff = np.zeros(max(m, 1), np.float64)
    f1 = flag == 1
    np.add.at(coeff, cols[f1], v[f1].astype(np.float64))
    return coeff, cols


def _coeff_equal(a: np.ndarray, b: np.ndarray) -> bool:
    # array_equal is False on NaN: a corruption that decodes NaN is
    # value-affecting by definition
    return bool(np.array_equal(a, b))


def _row_dense(mat, r: int) -> np.ndarray:
    """Row ``r`` of the decoded (quantized) matrix, as
    ``core.packsell.decode_to_dense`` builds it, without the other
    rows."""
    out = np.zeros(mat.m, np.float64)
    for pack, d0, outrow in zip(mat.packs, mat.d0s, mat.outrows):
        slots = np.nonzero(outrow.cpu().numpy() == r)[0]
        if not len(slots):
            continue
        S, w, C = pack.shape
        s, lane = divmod(int(slots[0]), C)
        words = cd.words_to_numpy(pack[s, :, lane])
        v, d, flag = cd.unpack_words_np(words, mat.codec, mat.D)
        cols = int(d0[s]) + np.cumsum(d.astype(np.int64))
        sel = flag == 1
        out[cols[sel]] += v[sel].astype(np.float64)
    return out


# ---------------------------------------------------------------------------
# SpMVPlan operand injectors
# ---------------------------------------------------------------------------


def flip_fused_word(mat, plan, seed: int, *, bit: int | None = None,
                    pos: tuple | None = None) -> Injection:
    """Flip one bit of one word of the fused stream, in place. Fused
    columns are checkpoint-absolute (no carry across words), so exactly
    one (value, column) pair changes: the oracle compares that pair."""
    if plan.fused is None:
        raise ValueError("plan has no fused stream to corrupt")
    rng = np.random.default_rng(seed)
    words, ckpt = plan.fused
    G, wr, C = words.shape
    if words.numel() == 0:
        raise ValueError("fused stream is empty")
    g, j, c = (pos if pos is not None else
               (int(rng.integers(G)), int(rng.integers(wr)),
                int(rng.integers(C))))
    b = int(rng.integers(32)) if bit is None else int(bit)
    old = np.uint32(int(words[g, j, c]) & 0xFFFFFFFF)
    new = np.uint32(old ^ np.uint32(1 << b))
    ck_val = int(ckpt[g, c])
    layout = plan.fused_layout
    vo, lo = _decode_word(old, mat, layout)
    vn, ln = _decode_word(new, mat, layout)
    mlim = max(plan.m - 1, 0)
    neutral = bool(
        (vo == 0.0 and vn == 0.0)
        or (vo == vn and np.isfinite(vn)
            and min(max(ck_val + lo, 0), mlim)
            == min(max(ck_val + ln, 0), mlim)))
    _put(words, (g, j, c), new)
    return Injection("fused_word",
                     dict(pos=(g, j, c), bit=b, old=int(old), new=int(new),
                          v_old=vo, v_new=vn, seed=seed),
                     neutral, lambda: _put(words, (g, j, c), old))


def corrupt_fused_checkpoint(mat, plan, seed: int) -> Injection:
    """Shift one cursor checkpoint by a random nonzero offset, in place:
    every word of that group lane then gathers from the wrong columns.
    Neutral only when the lane carries no contributing word or the clamp
    maps every contributing column identically."""
    if plan.fused is None:
        raise ValueError("plan has no fused checkpoints to corrupt")
    rng = np.random.default_rng(seed)
    words, ckpt = plan.fused
    G, C = ckpt.shape
    if ckpt.numel() == 0:
        raise ValueError("fused checkpoint array is empty")
    g, c = int(rng.integers(G)), int(rng.integers(C))
    delta = int(rng.integers(1, max(plan.m, 2))) * (1 if rng.random() < 0.5
                                                    else -1)
    old = int(ckpt[g, c])
    lane = cd.words_to_numpy(words[g, :, c])
    co = _lane_coeff_fused(lane, old, mat, plan.fused_layout, plan.m)
    cn = _lane_coeff_fused(lane, old + delta, mat, plan.fused_layout,
                           plan.m)
    _put(ckpt, (g, c), old + delta)
    return Injection("ckpt", dict(pos=(g, c), old=old, delta=delta,
                                  seed=seed),
                     _coeff_equal(co, cn), lambda: _put(ckpt, (g, c), old))


def flip_pack_word(mat, plan, seed: int, *, bit: int | None = None) -> \
        Injection:
    """Flip one bit of one bucketed pack word, in place (the paths that
    read the buckets: K4/K5/K6, the cursor cache, the scan decode). Under
    the full cursor cache the columns were decoded at build time, so
    delta-field corruption is value-neutral there: the oracle accounts for
    the plan's cache mode."""
    rng = np.random.default_rng(seed)
    sizes = [int(np.prod(p.shape)) for p in mat.packs]
    if not sizes or sum(sizes) == 0:
        raise ValueError("matrix has no packed words")
    bkt = int(rng.choice(len(sizes), p=np.asarray(sizes, np.float64)
                         / sum(sizes)))
    pack = mat.packs[bkt]
    S, w, C = pack.shape
    s, j, c = (int(rng.integers(S)), int(rng.integers(w)),
               int(rng.integers(C)))
    b = int(rng.integers(32)) if bit is None else int(bit)
    old_lane = cd.words_to_numpy(pack[s, :, c]).copy()
    new_lane = old_lane.copy()
    new_lane[j] = np.uint32(new_lane[j] ^ np.uint32(1 << b))
    d0_val = int(mat.d0s[bkt][s])
    full_cache = plan.cache_mode == "full" and plan.cols is not None
    co, cols_old = _lane_coeff_pack(old_lane, d0_val, mat.codec, mat.D,
                                    mat.m)
    cn, _ = _lane_coeff_pack(new_lane, d0_val, mat.codec, mat.D, mat.m,
                             cols_override=cols_old if full_cache else None)
    _put(pack, (s, j, c), new_lane[j])
    return Injection("pack_word",
                     dict(bucket=bkt, pos=(s, j, c), bit=b, seed=seed,
                          cache_mode=plan.cache_mode),
                     _coeff_equal(co, cn),
                     lambda: _put(pack, (s, j, c), old_lane[j]))


def corrupt_permutation(mat, plan, seed: int) -> Injection:
    """Swap two rows of the inverse σ-permutation, in place: y's entries
    for those rows trade places. Sum-invariant, so the analytic identity
    alone cannot see it; the weighted checksum catches it exactly. Neutral
    only when the two matrix rows are identical."""
    if plan.n < 2:
        raise ValueError("need n >= 2 to swap permutation rows")
    rng = np.random.default_rng(seed)
    r1, r2 = rng.choice(plan.n, size=2, replace=False)
    r1, r2 = int(r1), int(r2)
    maps = [t for t in (plan.inv_cat, plan.inv2_cat) if t is not None]
    if not maps:
        raise ValueError("plan carries no inverse permutation")

    def swap():
        for t in maps:
            t[[r1, r2]] = t[[r2, r1]]

    swap()
    neutral = bool(np.array_equal(_row_dense(mat, r1), _row_dense(mat, r2)))
    return Injection("perm", dict(rows=(r1, r2), seed=seed), neutral, swap)


# ---------------------------------------------------------------------------
# Input poisoning
# ---------------------------------------------------------------------------


def poison_x(x, seed: int, mode: str = "nan"):
    """Poison one entry of an input vector with NaN/Inf. Returns
    ``(x_poisoned, Injection)``; the original is not modified, so no undo
    is needed. A tensor comes back as a tensor of its dtype and device,
    anything else as float64 numpy (the reference's return)."""
    if mode not in ("nan", "inf"):
        raise ValueError(f"mode={mode!r} not in ('nan', 'inf')")
    rng = np.random.default_rng(seed)
    size = x.numel() if torch.is_tensor(x) else np.asarray(x).size
    if size == 0:
        raise ValueError("cannot poison an empty vector")
    i = int(rng.integers(size))
    bad = float("nan") if mode == "nan" else float("inf")
    if torch.is_tensor(x):
        xp = x.clone()
        xp.view(-1)[i] = bad
    else:
        xp = np.asarray(x, np.float64).copy()
        xp.reshape(-1)[i] = bad
    return xp, Injection("x", dict(index=i, mode=mode, seed=seed), False)


# ---------------------------------------------------------------------------
# Precision-store corruption (the store must survive this)
# ---------------------------------------------------------------------------


def corrupt_store(path: str, seed: int, mode: str = "truncate") -> \
        Injection:
    """Truncate or garble the on-disk precision-store JSON (a crashed
    writer, a bad sector). Undo restores the original bytes."""
    if mode not in ("truncate", "garble"):
        raise ValueError(f"mode={mode!r} not in ('truncate', 'garble')")
    rng = np.random.default_rng(seed)
    with open(path, "rb") as f:
        orig = f.read()
    if mode == "truncate":
        cut = int(rng.integers(1, max(len(orig), 2)))
        bad = orig[:cut]
    else:
        bad = bytearray(orig if orig else b"{")
        for _ in range(max(1, len(bad) // 16)):
            bad[int(rng.integers(len(bad)))] = int(rng.integers(256))
        bad = bytes(bad)
    with open(path, "wb") as f:
        f.write(bad)

    def undo():
        with open(path, "wb") as f:
            f.write(orig)

    return Injection("store", dict(path=os.fspath(path), mode=mode,
                                   nbytes=len(bad), seed=seed),
                     False, undo)


# ---------------------------------------------------------------------------
# Composite operand injector
# ---------------------------------------------------------------------------


def corrupt_dist_checkpoint(dplan, seed: int) -> Injection:
    """Shift one cursor checkpoint inside a DistSpMVPlan's stacked
    operands (a ``*_fckpt`` tensor), in place. Each shard's fused plan
    reads row p of that tensor, so the corruption reaches the shard's
    kernel and every graph captured over it. The key, index and delta are
    drawn as the reference draws them (no neutrality oracle: as there,
    ``value_neutral`` is False).

    On a rank mesh every rank calls it with the same seed and draws the
    same index into the stacked tensor; the rank that owns that row
    writes its own row (and ``undo()`` restores it), and the others learn
    the old value through one gather, so every rank returns the same
    ``detail``. The other ranks meet the damage through the exchange, as
    the stacked form's other shards do."""
    keys = sorted(k for k in dplan.dev if k.endswith("_fckpt"))
    if not keys:
        raise ValueError("dist plan has no fused checkpoint operands")
    rng = np.random.default_rng(seed)
    key = keys[int(rng.integers(len(keys)))]
    flat = dplan.dev[key].view(-1)
    rank = getattr(dplan, "rank", None)
    i = int(rng.integers(flat.numel() * (1 if rank is None
                                         else dplan.n_shards)))
    delta = int(rng.integers(1, max(int(dplan.m) if hasattr(dplan, "m")
                                    else 2 ** 15, 2)))
    if rank is None:
        mine, j = True, i
        old = int(flat[i])
    else:
        from ..parallel import collectives as _co

        owner, j = divmod(i, flat.numel())
        mine = owner == rank
        old = int(_co.gather_values([int(flat[j]) if mine else 0],
                                    dplan.mesh)[owner, 0])
    if mine:
        _put(flat, (j,), old + delta)
    return Injection("dist_ckpt", dict(key=key, index=i, old=old,
                                       delta=delta, seed=seed),
                     False, (lambda: _put(flat, (j,), old)) if mine
                     else (lambda: None))


def corrupt_composite_word(comp, member: int, seed: int) -> Injection:
    """Flip a word inside one member block of a CompositePlan, in place:
    its fused stream if the member's plan has one, else its bucketed
    words. The member's kernel reads its own buffer, so the corruption
    reaches the next composite matvec with no invalidation; the
    composite's ``fused_cat`` copy (which no matvec reads) is dropped so
    it is rebuilt from the corrupted streams when asked for."""
    mem = comp.members[member]
    if mem.plan is None:
        raise ValueError(f"member {member} ({mem.label}) is not a "
                         f"PackSELL block")

    def _invalidate():
        comp._cat = None
        comp._cat_built = False

    if mem.plan.fused is not None:
        inj = flip_fused_word(mem.mat, mem.plan, seed)
    else:
        inj = flip_pack_word(mem.mat, mem.plan, seed)
    _invalidate()
    inner_undo = inj._undo

    def undo():
        if inner_undo is not None:
            inner_undo()
        _invalidate()

    inj._undo = undo
    inj.detail["member"] = member
    inj.target = "composite_" + inj.target
    return inj
