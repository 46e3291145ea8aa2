"""repro_torch plan engine and fused kernels' plain versions against the
reference, on the CPU.

* the fused stream (words, checkpoints, layout, slice orders) and the
  plan's permutation maps are byte-equal for every checkpoint width, with
  trimming on and off;
* the plain bucket bodies (full cursor cache, scan) of the jnp variant;
* the ``decode="loop"`` bodies (the word-by-word walk) against the
  reference's and against the scan bodies, bit for bit on integer data;
* the parity traps: the column clamp with inf in x (PAD words keep
  0 · inf = NaN), the empty stream (G = 0), the int32 checkpoints;
* the variant policy on the CPU mirrors the reference's decisions, the
  forced per-bucket variants build the reference's plans, and the
  token-keyed plan cache.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import packsell as rpk
from repro.core import testmats as rtm
from repro.kernels import packsell_spmv as rkp
from repro.kernels import plan as rpl
from repro_torch.core import codecs as tcd
from repro_torch.core import packsell as tpk
from repro_torch.kernels import packsell_spmv as tkp
from repro_torch.kernels import plan as tpl

SUITE = rtm.suite("tiny")
STREAM_CODECS = (("fp16", 15), ("bf16", 15), ("e8m", 8), ("e8m", 12),
                 ("e8m", 15), ("fixed12", 15))
WRS = (None,) + tpl._CKPT_WIDTHS


def _int_values(a, seed=11):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-8, 9, size=a.nnz).astype(np.float64)
    vals[vals == 0] = 1
    a = a.tocsr()
    return sp.csr_matrix((vals, a.indices, a.indptr), shape=a.shape)


INT_SUITE = {k: _int_values(a) for k, a in SUITE.items()}


def _int_x(m, seed=3, nb=None):
    rng = np.random.default_rng(seed)
    shape = (m,) if nb is None else (m, nb)
    return rng.integers(-8, 9, size=shape).astype(np.float32)


def _pair(a, codec, D, C=8, sigma=32):
    return (rpk.from_csr(a, C=C, sigma=sigma, D=D, codec=codec),
            tpk.from_csr(a, C=C, sigma=sigma, D=D, codec=codec, device="cpu"))


def _layout_fields(lay):
    return (lay.wr, lay.groups, lay.C, lay.words_exact, lay.encoding,
            lay.scale, tuple((s.g0, s.S, s.C, s.levels) for s in lay.segments))


def _assert_plans_equal(tp, rp):
    assert tp.variant == rp.variant
    assert tp.cache_mode == rp.cache_mode
    np.testing.assert_array_equal(tp.outrow_cat.numpy(),
                                  np.asarray(rp.outrow_cat))
    np.testing.assert_array_equal(tp.inv_cat.numpy(), np.asarray(rp.inv_cat))
    if rp.inv2_cat is None:
        assert tp.inv2_cat is None
    else:
        np.testing.assert_array_equal(tp.inv2_cat.numpy(),
                                      np.asarray(rp.inv2_cat))
    assert (tp.fused is None) == (rp.fused is None)
    if rp.fused is not None:
        np.testing.assert_array_equal(tcd.words_to_numpy(tp.fused[0]),
                                      np.asarray(rp.fused[0]))
        np.testing.assert_array_equal(tp.fused[1].numpy(),
                                      np.asarray(rp.fused[1]))
        assert _layout_fields(tp.fused_layout) == \
            _layout_fields(rp.fused_layout)
    assert (tp.cols is None) == (rp.cols is None)
    if rp.cols is not None:
        for ct, cr in zip(tp.cols, rp.cols):
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cr))
    assert tp.total_stored == rp.total_stored
    assert tp.decode_cache_stats() == rp.decode_cache_stats()


# ---------------------------------------------------------------------------
# the fused stream, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", STREAM_CODECS)
@pytest.mark.parametrize("trim", [True, False])
def test_fused_stream_byte_equal(klass, codec, D, trim):
    r, t = _pair(SUITE[klass], codec, D)
    for wr in WRS:
        rf, rl, ro = rpl._build_fused_stream(r, trim=trim, wr=wr)
        tf, tl, to = tpl._build_fused_stream(t, trim=trim, wr=wr)
        assert (tf is None) == (rf is None), wr
        if rf is None:
            continue
        assert _layout_fields(tl) == _layout_fields(rl)
        assert tf[0].dtype == torch.int32 and tf[1].dtype == torch.int32
        np.testing.assert_array_equal(tcd.words_to_numpy(tf[0]),
                                      np.asarray(rf[0]))
        np.testing.assert_array_equal(tf[1].numpy(), np.asarray(rf[1]))
        assert len(to) == len(ro)
        for a, b in zip(to, ro):
            np.testing.assert_array_equal(a, b)
        # the whole plan: outrow_cat, inv_cat, inv2_cat
        _assert_plans_equal(
            tpl.build_plan(t, force="jnp", decode_cache="checkpoint",
                           fused_trim=trim, ckpt_wr=wr),
            rpl.build_plan(r, force="jnp", decode_cache="checkpoint",
                           fused_trim=trim, ckpt_wr=wr))


@pytest.mark.parametrize("klass", sorted(SUITE))
def test_pick_ckpt_width_and_encoding_match(klass):
    for codec, D in STREAM_CODECS:
        r, t = _pair(SUITE[klass], codec, D, C=16, sigma=64)
        assert tpl._split16_encoding(t) == rpl._split16_encoding(r)
        rf, rl, _ = rpl._build_fused_stream(r)
        tf, tl, _ = tpl._build_fused_stream(t)
        if rf is not None:
            assert _layout_fields(tl) == _layout_fields(rl)


@pytest.mark.parametrize("mode", ["full", "0"])
def test_plain_bucket_bodies_match(mode):
    """The full cursor cache and the no-cache scan body."""
    for klass in ("banded", "scattered"):
        r, t = _pair(INT_SUITE[klass], "e8m", 8)
        rp = rpl.build_plan(r, force="jnp", decode_cache=mode)
        tp = tpl.build_plan(t, force="jnp", decode_cache=mode)
        _assert_plans_equal(tp, rp)
        x = _int_x(r.m)
        np.testing.assert_array_equal(
            tp.spmv(t, torch.from_numpy(x)).numpy(),
            np.asarray(rp.spmv(r, jnp.asarray(x))))
        X = _int_x(r.m, nb=3)
        np.testing.assert_array_equal(
            tp.spmm(t, torch.from_numpy(X), permuted=True).numpy(),
            np.asarray(rp.spmm(r, jnp.asarray(X), permuted=True)))


# ---------------------------------------------------------------------------
# parity traps
# ---------------------------------------------------------------------------


def _tall_matrix():
    """40 × 5, rows 8.. empty: the σ-padding and empty rows of the late
    slices hold only PAD words whose checkpoint lies past m - 1, so the
    column clamp decides what they read."""
    rows = np.repeat(np.arange(8), 3)
    cols = np.tile([0, 2, 4], 8)
    vals = np.arange(1, len(rows) + 1, dtype=np.float64)
    return sp.csr_matrix((vals, (rows, cols)), shape=(40, 5))


def test_trap_clamp_and_pad_words_keep_nan():
    a = _tall_matrix()
    r, t = _pair(a, "fp16", 15, C=8, sigma=8)
    rp = rpl.build_plan(r, force="jnp", decode_cache="checkpoint")
    tp = tpl.build_plan(t, force="fused")
    assert tp.variant == "fused"
    ck = tp.fused[1].numpy()
    assert ck.max() >= a.shape[1]           # PAD words reach columns >= m
    x = np.array([1, 2, 3, 4, np.inf], np.float32)
    lay = tp.fused_layout
    part = tkp.packsell_spmv_fused(tp.fused[0], tp.fused[1],
                                   torch.from_numpy(x), codec_name="fp16",
                                   D=15, encoding=lay.encoding).numpy()
    ref = np.asarray(rpl._fused_part_spmv(rp.fused[0], rp.fused[1],
                                          jnp.asarray(x), r.codec, 15,
                                          rp.fused_layout))
    np.testing.assert_array_equal(part, ref)    # NaN where NaN
    assert np.isnan(part).sum() > 0             # 0 · inf survived
    # the Pallas kernel clamps to len(xp) - 1 over zero-padded x, so its
    # out-of-range PAD reads see 0, not x[m - 1]: the port follows the jnp
    # body, which differs from it exactly there
    pallas = np.asarray(rkp.packsell_spmv_fused(
        rp.fused[0], rp.fused[1], jnp.asarray(x), codec_name="fp16", D=15,
        encoding=lay.encoding, interpret=True))
    differ = ~((part == pallas) | (np.isnan(part) & np.isnan(pallas)))
    assert differ.any() and np.isnan(part[differ]).all()
    np.testing.assert_array_equal(
        tp.spmv(t, torch.from_numpy(x)).numpy(),
        np.asarray(rp.spmv(r, jnp.asarray(x))))


def test_trap_empty_stream_returns_without_launch():
    for C, wr, nb in ((8, 32, 3), (32, 8, 1)):
        words = torch.zeros((0, wr, C), dtype=torch.int32)
        ckpt = torch.zeros((0, C), dtype=torch.int32)
        before = (tkp.packsell_spmv_fused.launches,
                  tkp.packsell_spmm_fused.launches)
        part = tkp.packsell_spmv_fused(words, ckpt, torch.ones(7),
                                       codec_name="fp16", D=15,
                                       encoding="f16")
        assert tuple(part.shape) == (0, C) and part.dtype == torch.float32
        part = tkp.packsell_spmm_fused(words, ckpt, torch.ones(7, nb),
                                       codec_name="fp16", D=15,
                                       encoding="f16")
        assert tuple(part.shape) == (0, C, nb)
        assert (tkp.packsell_spmv_fused.launches,
                tkp.packsell_spmm_fused.launches) == before


def test_trap_empty_matrix_matches_reference():
    a = sp.csr_matrix((5, 7))
    r, t = _pair(a, "fp16", 15, C=4, sigma=8)
    rp = rpl.build_plan(r, force="fused")
    tp = tpl.build_plan(t, force="fused")
    x = _int_x(7)
    np.testing.assert_array_equal(tp.spmv(t, torch.from_numpy(x)).numpy(),
                                  np.asarray(rp.spmv(r, jnp.asarray(x))))
    X = np.stack([x, x], axis=1)
    np.testing.assert_array_equal(tp.spmm(t, torch.from_numpy(X)).numpy(),
                                  np.zeros((5, 2), np.float32))


def test_trap_checkpoints_int64_then_int32():
    a = INT_SUITE["scattered"]
    r, t = _pair(a, "e8m", 12)
    tp = tpl.build_plan(t, force="fused")
    assert tp.fused[1].dtype == torch.int32
    # the exact int64 cursors, cast once
    cum0 = tpl._bucket_cursor_prefix(t.packs[0], t.d0s[0], t.codec, t.D)
    assert cum0.dtype == np.int64


def test_kernel_operand_checks_reject_cpu_tensors():
    words = torch.zeros((2, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        tkp._check_operands(words, torch.zeros((2, 4), dtype=torch.int32),
                            torch.zeros(3), 1, "packsell_spmv_fused")


# ---------------------------------------------------------------------------
# policy and plan cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("klass", sorted(SUITE))
def test_auto_policy_mirrors_reference_on_cpu(klass):
    for codec, D in (("fp16", 15), ("e8m", 8)):
        r, t = _pair(SUITE[klass], codec, D)
        rp = rpl.build_plan(r, interpret=True)
        tp = tpl.build_plan(t)
        assert tp.variant == rp.variant == "jnp"
        assert tp.cache_mode == rp.cache_mode
        _assert_plans_equal(tp, rp)


def test_forced_fused_demotion_mirrors_reference_on_cpu():
    r, t = _pair(SUITE["scattered"], "e8m", 8)
    rp = rpl.build_plan(r, force="fused")
    tp = tpl.build_plan(t, force="fused")
    assert rp.variant == tp.variant == "jnp"
    assert "demoted to jnp" in tp.policy and tp.cache_mode == "full"
    _assert_plans_equal(tp, rp)
    r, t = _pair(SUITE["scattered"], "fp16", 15)
    tp = tpl.build_plan(t, force="fused", decode_cache="full")
    assert tp.variant == "fused" and tp.cache_mode == "checkpoint"
    assert "overridden to 'checkpoint'" in tp.policy


@pytest.mark.parametrize("force", ["full", "band"])
def test_per_bucket_variants_build_and_match_reference(force):
    """force='full'/'band' build the per-bucket plans (K4/K6 on CUDA, their
    plain versions here) with the reference's layout, windows and
    checkpoints, and give its output bit for bit on integer data."""
    r, t = _pair(INT_SUITE["banded"], "fp16", 15)
    rp = rpl.build_plan(r, force=force, interpret=True)
    tp = tpl.build_plan(t, force=force)
    assert tp.variant == rp.variant == force
    _assert_plans_equal(tp, rp)
    assert (tp.wins is None) == (rp.wins is None) == (force == "full")
    for wt, wr in zip(tp.wins or (), rp.wins or ()):
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wr))
    for ct, cr in zip(tp.kckpts, rp.kckpts):
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cr))
    x = _int_x(r.m)
    np.testing.assert_array_equal(tp.spmv(t, torch.from_numpy(x)).numpy(),
                                  np.asarray(rp.spmv(r, jnp.asarray(x))))


def test_bad_policy_and_cache_mode_raise(monkeypatch):
    _, t = _pair(SUITE["banded"], "fp16", 15)
    with pytest.raises(ValueError, match="not in"):
        tpl.build_plan(t, force="fast")
    with pytest.raises(ValueError, match="not in"):
        tpl.build_plan(t, decode_cache="sometimes")
    # the reference's environment knobs do not reach the port
    monkeypatch.setenv("REPRO_SPMV_POLICY", "nope")
    monkeypatch.setenv("REPRO_PLAN_CURSOR_CACHE", "full")
    plan = tpl.build_plan(t)
    assert plan.variant == "jnp" and plan.cache_mode == "checkpoint"
    monkeypatch.setenv("REPRO_SPMV_POLICY", "fused")
    assert tpl.get_plan(t).variant == "jnp"
    assert tpl.build_plan(t, force="fused").variant == "fused"


def test_plan_cache_token_lru_and_weakref():
    tpl.clear_cache()
    _, t = _pair(SUITE["hpcg_mini"], "fp16", 15)
    p1 = tpl.get_plan(t)
    assert tpl.get_plan(t) is p1
    assert tpl.get_plan(t, force="fused") is not p1
    st = tpl.cache_stats()
    assert (st["hits"], st["misses"], st["size"]) == (1, 2, 2)
    del t, p1
    gc.collect()
    assert tpl.cache_stats()["size"] == 0
    assert tpl.cache_stats()["evicted"] == 2


def test_plan_cache_capacity(monkeypatch):
    tpl.clear_cache()
    monkeypatch.setattr(tpl, "PLAN_CACHE_CAP", 2)
    mats = [_pair(SUITE["hpcg_mini"], "fp16", 15)[1] for _ in range(3)]
    for m in mats:
        tpl.get_plan(m)
    assert tpl.cache_stats()["size"] == 2
    tpl.clear_cache()


def test_stored_order_roundtrip():
    r, t = _pair(SUITE["powerlaw"], "fp16", 15)
    tp = tpl.get_plan(t)
    rp = rpl.get_plan(r)
    v = np.random.default_rng(9).standard_normal(t.n)
    vt = torch.from_numpy(v)
    s = tp.to_stored(vt)
    np.testing.assert_array_equal(s.numpy(),
                                  np.asarray(rp.to_stored(jnp.asarray(v))))
    assert torch.equal(tp.from_stored(s), vt)
    assert (s[tp.outrow_cat.long() >= t.n] == 0).all()
    V = torch.from_numpy(np.stack([v, 2 * v], axis=1))
    assert torch.equal(tp.from_stored(tp.to_stored(V)), V)
    assert tp.describe()["variant"] == "jnp"


# ---------------------------------------------------------------------------
# the loop decode bodies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", (("fp16", 15), ("e8m", 8)))
@pytest.mark.parametrize("nb", [None, 1, 4], ids=["spmv", "nb1", "nb4"])
def test_loop_bodies_bit_equal_reference_and_scan(klass, codec, D, nb):
    """``decode="loop"`` (the word-by-word walk) equals the reference's
    ``decode="loop"`` body and the port's scan body bit for bit on
    integer data: SpMV, and SpMM at nb 1 and 4."""
    r, t = _pair(INT_SUITE[klass], codec, D)
    x = _int_x(r.m, nb=nb)
    if nb is None:
        rfn, tfn = rpk.packsell_spmv_jnp, tpk.packsell_spmv_torch
    else:
        rfn, tfn = rpk.packsell_spmm_jnp, tpk.packsell_spmm_torch
    got = tfn(t, torch.from_numpy(x), decode="loop")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(rfn(r, jnp.asarray(x), decode="loop")))
    np.testing.assert_array_equal(
        got.numpy(), tfn(t, torch.from_numpy(x), decode="scan").numpy())


def test_unknown_decode_raises_keyerror():
    """An unknown ``decode`` raises ``KeyError``, as the reference's dict
    lookup does."""
    r, t = _pair(INT_SUITE["hpcg_mini"], "fp16", 15)
    x = _int_x(r.m)
    with pytest.raises(KeyError):
        rpk.packsell_spmv_jnp(r, jnp.asarray(x), decode="walk")
    for fn, xx in ((tpk.packsell_spmv_torch, x),
                   (tpk.packsell_spmm_torch, _int_x(r.m, nb=2))):
        with pytest.raises(KeyError, match="walk"):
            fn(t, torch.from_numpy(xx), decode="walk")
