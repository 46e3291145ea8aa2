"""K4 and K5 of repro_torch against the reference, on the CPU.

The plain versions of the SpMV (K4) and the multi-RHS SpMV (K5) over all
buckets, in both bodies (the carry body from ``d0`` and the checkpoint
body whose width-block partials are added in wi order), run through plans
forced to ``full`` and are held against the reference plans of the same
variant, whose Pallas kernels run in interpret mode (computed once per
case by a module-scoped fixture), bit for bit on integer data (values and
x in [-8, 8], so every sum is exact) over fp16/bf16 at D = 15 and e8m at
D = 12, 8, 4, 1. Also byte for byte: the width-block checkpoints and the
band windows; the CUDA policy's decisions (``plan.choose_variant``); and
the bucket wrappers' operand checks. K6, real data and the PAD-word trap
are in ``test_torch_band_kernels.py``; the all-bucket K5 and K6 against
their per-bucket plain versions in ``test_torch_band_spmm_buckets.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packsell as rpk
from repro.core import testmats as rtm
from repro.kernels import plan as rpl
from repro_torch.core import packsell as tpk
from repro_torch.kernels import packsell_spmv as tkp
from repro_torch.kernels import plan as tpl
from test_torch_plan import INT_SUITE, _assert_plans_equal, _int_x

SUITE = rtm.suite("tiny")
CODECS = (("fp16", 15), ("bf16", 15), ("e8m", 12), ("e8m", 8), ("e8m", 4),
          ("e8m", 1))
WB = 8          # several width blocks per bucket on the tiny suite


def _pair(a, codec, D, strategy="pow2", C=8, sigma=32):
    return (rpk.from_csr(a, C=C, sigma=sigma, D=D, codec=codec,
                         bucket_strategy=strategy),
            tpk.from_csr(a, C=C, sigma=sigma, D=D, codec=codec,
                         bucket_strategy=strategy, device="cpu"))


def _smallest_hw(mat, sb=8):
    """The smallest multiple of 128 for which the band plan is feasible."""
    return next(h for h in range(128, 1 << 20, 128)
                if tpl.band_plan(mat, sb, h) is not None)


@pytest.fixture(scope="module")
def ref():
    """Reference plan outputs, each computed once per case: ``ref(klass,
    codec, D, variant, mode, data, out)`` → ``out='y'``: the SpMV, ``'Y'``:
    the SpMM over 3 right-hand sides."""
    memo = {}

    def get(klass, codec, D, variant, mode, data="int", out="y"):
        key = (klass, codec, D, variant, mode, data, out)
        if key not in memo:
            a = (INT_SUITE if data == "int" else SUITE)[klass]
            strategy = "uniform" if variant == "band" else "pow2"
            r, t = _pair(a, codec, D, strategy)
            hw = _smallest_hw(t) if variant == "band" else tpl._DEF_HW
            rp = rpl.build_plan(r, force=variant, decode_cache=mode, wb=WB,
                                hw=hw, interpret=True)
            if out == "y":
                memo[key] = np.asarray(rp.spmv(r, jnp.asarray(_x(r.m, data))))
            else:
                memo[key] = np.asarray(rp.spmm(r, jnp.asarray(
                    _x(r.m, data, nb=3))))
        return memo[key]

    return get


def _x(m, data, nb=None):
    if data == "int":
        return _int_x(m, nb=nb)
    rng = np.random.default_rng(5)
    return rng.standard_normal((m,) if nb is None else (m, nb)).astype(
        np.float32)


def _port(klass, codec, D, variant, mode, data="int"):
    a = (INT_SUITE if data == "int" else SUITE)[klass]
    strategy = "uniform" if variant == "band" else "pow2"
    r, t = _pair(a, codec, D, strategy)
    hw = _smallest_hw(t) if variant == "band" else tpl._DEF_HW
    tp = tpl.build_plan(t, force=variant, decode_cache=mode, wb=WB, hw=hw)
    rp = rpl.build_plan(r, force=variant, decode_cache=mode, wb=WB, hw=hw,
                        interpret=True)
    return r, t, tp, rp


# ---------------------------------------------------------------------------
# build-time layouts, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("klass", sorted(SUITE))
def test_block_checkpoints_and_band_windows_byte_equal(klass):
    for codec, D in (("fp16", 15), ("e8m", 8), ("e8m", 1)):
        for strategy in ("pow2", "uniform"):
            r, t = _pair(SUITE[klass], codec, D, strategy)
            for wb in (32, 8, 5):
                tiles = tuple((8, wb) for _ in r.packs)
                for ct, cr in zip(tpl._build_block_checkpoints(t, tiles),
                                  rpl._build_block_checkpoints(r, tiles)):
                    assert ct.dtype == torch.int32
                    np.testing.assert_array_equal(ct.numpy(), np.asarray(cr))
            for sb in (8, 4):
                for hw in (128, 512, 4096):
                    wt, wr = tpl.band_plan(t, sb, hw), rpl.band_plan(r, sb, hw)
                    assert (wt is None) == (wr is None), (strategy, sb, hw)
                    for a, b in zip(wt or (), wr or ()):
                        np.testing.assert_array_equal(a, np.asarray(b))
                for d0, mc in zip(r.d0s, r.maxcols):
                    got = tpl.bucket_band_windows(np.asarray(d0),
                                                  np.asarray(mc), sb, 256)
                    want = rpl.bucket_band_windows(d0, mc, sb, 256)
                    assert (got is None) == (want is None)
                    if want is not None:
                        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# K4 / K5 / K6 through the plans, against the reference's Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", CODECS)
@pytest.mark.parametrize("mode", ["checkpoint", "0"])
def test_k4_plain_bit_equal_reference(ref, klass, codec, D, mode):
    """K4 in the checkpoint body (mode 'checkpoint') and the carry body
    (mode '0'): the plan's layout and its output, bit for bit."""
    y = ref(klass, codec, D, "full", mode)
    r, t, tp, rp = _port(klass, codec, D, "full", mode)
    _assert_plans_equal(tp, rp)
    assert tp.variant == "full"
    assert (tp.kckpts is None) == (mode != "checkpoint")
    for ct, cr in zip(tp.kckpts or (), rp.kckpts or ()):
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cr))
    np.testing.assert_array_equal(
        tp.spmv(t, torch.from_numpy(_x(r.m, "int"))).numpy(), y)


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", [("bf16", 15), ("e8m", 8), ("e8m", 1)])
@pytest.mark.parametrize("mode", ["checkpoint", "0"])
def test_k5_plain_bit_equal_reference(ref, klass, codec, D, mode):
    Y = ref(klass, codec, D, "full", mode, out="Y")
    r, t, tp, _ = _port(klass, codec, D, "full", mode)
    got = tp.spmm(t, torch.from_numpy(_x(r.m, "int", nb=3)))
    assert got.shape == (r.n, 3)
    np.testing.assert_array_equal(got.numpy(), Y)


# ---------------------------------------------------------------------------
# the wrappers' bodies and the shared width sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec,D", CODECS)
def test_checkpoint_body_partials_sum_to_carry_body(codec, D):
    """Per bucket: the checkpoint body's partials, added by the shared
    ``sum_width_partials``, equal the carry body on integer data, and
    each partial equals a carry walk over its own block."""
    t = tpk.from_csr(INT_SUITE["hpcg_mini"], C=8, sigma=32, D=D,
                     codec=codec, device="cpu")
    x = torch.from_numpy(_int_x(t.m))
    X = torch.from_numpy(_int_x(t.m, nb=2))
    tiles = tuple((8, WB) for _ in t.packs)
    for pack, d0, ck in zip(t.packs, t.d0s,
                            tpl._build_block_checkpoints(t, tiles)):
        kw = dict(codec_name=codec, D=D, wb=WB)
        part = tkp.packsell_spmv_bucket_plain(pack, d0, x, ckpt=ck, **kw)
        assert part.shape == (ck.shape[1],) + tuple(pack.shape[::2])
        carry = tkp.packsell_spmv_bucket_plain(pack, d0, x, **kw)
        assert torch.equal(tkp.sum_width_partials(part), carry)
        mpart = tkp.packsell_spmm_bucket_plain(pack, d0, X, ckpt=ck, **kw)
        assert torch.equal(tkp.sum_width_partials(mpart),
                           tkp.packsell_spmm_bucket_plain(pack, d0, X, **kw))
        assert torch.equal(mpart[..., 1], tkp.packsell_spmv_bucket_plain(
            pack, d0, X[:, 1], ckpt=ck, **kw))
    with pytest.raises(ValueError, match="do not fit"):
        tkp.packsell_spmv_bucket_plain(t.packs[0], t.d0s[0], x, ckpt=ck,
                                       **kw)


def test_sum_width_partials_order_and_empty():
    part = torch.tensor([[1e8, 1.0], [1.0, 2.0], [-1e8, 3.0]])
    # wi order: (1e8 + 1) - 1e8 = 0 in float32, not 1
    assert torch.equal(tkp.sum_width_partials(part[:, None]),
                       torch.tensor([[0.0, 6.0]]))
    assert torch.equal(tkp.sum_width_partials(torch.zeros((0, 3, 4))),
                       torch.zeros((3, 4)))


@pytest.mark.parametrize("kernel,fault", [
    ("K4", "cpu"), ("K4", "buckets"), ("K4", "body"),
    ("K5", "cpu"), ("K5", "buckets"), ("K5", "body"),
    ("K6", "cpu"), ("K6", "buckets"), ("K6", "body"), ("K6", "windows"),
    ("K6", "no windows")])
def test_bucket_wrappers_reject_cpu_operands_for_the_kernel(kernel, fault):
    """The kernels' operand checks: CPU operands never reach a kernel, and
    a table built for other buckets, the other body or other windows (or
    none) raises, for the plain version too (it reads the table's width and
    slice blocks)."""
    _, t = _pair(SUITE["banded"], "e8m", 8, "uniform")
    hw = _smallest_hw(t)
    p = tpl.build_plan(t, force="band", hw=hw)
    x = torch.ones((t.m, 2)) if kernel == "K5" else torch.ones(t.m)
    packs, d0s, kck, wins = list(t.packs), list(t.d0s), p.kckpts, p.wins
    table = p.ktable
    if fault == "buckets":
        packs = [q.clone() for q in packs]
    elif fault == "body":
        kck = None
    elif fault == "windows":
        wins = [w.clone() for w in wins]
    elif fault == "no windows":
        table = tkp.bucket_table(packs, d0s, kck, [32] * len(packs))
    want = {"cpu": "CUDA device", "buckets": "other buckets",
            "body": "other body"}.get(fault, "other windows")
    kw = dict(codec_name="e8m", D=8)
    with pytest.raises(ValueError, match=want):
        if fault == "cpu":
            tkp._check_buckets("k", packs, d0s, kck, table, x, x.dim(),
                               wins if kernel == "K6" else None, hw)
        elif kernel == "K4":
            tkp.packsell_spmv_buckets(packs, d0s, kck, table, x, **kw)
        elif kernel == "K5":
            tkp.packsell_spmm_buckets(packs, d0s, kck, table, x, **kw)
        else:
            tkp.packsell_spmv_band_buckets(packs, d0s, wins, kck, table, x,
                                           hw=hw, **kw)


# ---------------------------------------------------------------------------
# the CUDA policy, as a pure function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,on_cuda,fused_ok,band_ok,m,want", [
    ("auto", True, True, True, 1 << 20, "fused"),
    ("auto", True, False, True, 1 << 20, "band"),
    ("auto", True, False, True, 1000, "full"),
    ("auto", True, False, False, 1 << 20, "full"),
    ("auto", True, False, True, tpl._BAND_MIN_M, "band"),
    ("auto", True, False, True, tpl._BAND_MIN_M - 1, "full"),
    ("auto", False, True, True, 1 << 20, "jnp"),
    ("fused", True, False, True, 1 << 20, "full"),
    ("fused", False, False, True, 1 << 20, "jnp"),
    ("fused", True, True, False, 10, "fused"),
    ("full", True, True, True, 10, "full"),
    ("band", True, True, True, 10, "band"),
    ("jnp", True, True, True, 10, "jnp"),
    ("band", True, True, False, 10, ValueError),
])
def test_choose_variant(policy, on_cuda, fused_ok, band_ok, m, want):
    kw = dict(on_cuda=on_cuda, fused_ok=fused_ok, band_ok=band_ok, m=m)
    if want is ValueError:
        with pytest.raises(ValueError, match="band kernel infeasible"):
            tpl.choose_variant(policy, **kw)
        return
    variant, reason = tpl.choose_variant(policy, **kw)
    assert variant == want and reason


def test_plan_cache_keys_on_tiles_and_half_window():
    tpl.clear_cache()
    _, t = _pair(SUITE["banded"], "e8m", 8, "uniform")
    p = tpl.get_plan(t, force="full")
    assert tpl.get_plan(t, force="full") is p
    assert tpl.get_plan(t, force="full", wb=8) is not p
    hw = _smallest_hw(t)
    pb = tpl.get_plan(t, force="band", hw=hw)
    assert pb.hw == hw and tpl.get_plan(t, force="band", hw=hw + 128) \
        is not pb
    assert pb.describe()["tiles"] == [[8, 32]] * len(t.packs)
    assert pb.decode_cache_stats()["decode_cache_bytes"] == sum(
        4 * c.numel() for c in pb.kckpts)
    tpl.clear_cache()
