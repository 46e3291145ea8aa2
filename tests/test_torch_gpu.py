"""repro_torch's CUDA kernels against their plain PyTorch versions, on the
card: K1 (fused-stream SpMV) and K3 (its multi-RHS twin, vector and scalar
X loads, chunks of 8 right-hand sides) on every stream encoding and
checkpoint width, K4 (the SpMV), K5 (multi-RHS, vector and scalar X
loads) and K6 (band-windowed), each over all buckets in one launch, in
both bodies over every codec, K2 (SELL)
on every value type and with a float64 accumulator, bit for bit over the
tiny suite; a Jacobi-PCG solve through K1 that stops at the plain body's
iteration, and a mixed-precision solve through K4 and K2-f64 with the
plain bodies' schedule. The solver layer: the fp16, fp32 and fp64
matvecs and the fixed-iteration solvers (``neumann_ainv``,
``pcg_fixed_iters``, ``richardson_fixed_iters``) run under
``torch.cuda.set_sync_debug_mode("error")`` without raising; a
``packsell_<codec>`` matvec launches its plan's kernel and equals the
plan's plain body bit for bit; IO-CG and F3R take the CPU's counts.
The LM serving path: the decode engine's graph tick equals its eager
tick bit for bit, ``PackSELLLinear`` runs K1 and K3 bit-equal to the
plain plan, and an idle slot runs past ``max_len``; a moe decode tick
(routing, dispatch, the expert products and the combine) replays from
its graph and runs eagerly under ``set_sync_debug_mode("error")``, the
two bit-equal, and so do the ssm and hybrid ticks (Mamba2's conv and SSM
states written in place, the shared attention block); so does the
encdec decode step (self-attention, cross-attention over the encoder's
K/V at 8 and 1,100 frames, SwiGLU) as one CUDA graph outside the engine,
which leaves ``ek``/``ev`` as they were; a prompt holding out-of-range
token ids leaves the CUDA context working and the other requests' tokens
as a clean engine's. The training side: a reduced float32 step of each
family on the card against the same step on the CPU, its gradients
repeated bit for bit; the data axis: two gloo ranks sharing the card
(plain, compressed, pod-wire u16 and u8 steps) against the stacked form,
and the wire codecs against the CPU's bits.

Run on a machine with a CUDA device:

    python -m pytest -m gpu tests/test_torch_gpu.py

Without one every test skips with its reason. The module imports neither
JAX nor ``repro``.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import packsell as pk
from repro_torch.core import sell as sl
from repro_torch.core import testmats
from repro_torch.kernels import ops
from repro_torch.kernels import packsell_spmv as kpk
from repro_torch.kernels import plan as kplan
from repro_torch.kernels import ref as kref
from repro_torch.kernels import sell_spmv as ksl
from repro_torch.precision import select as psel
from repro_torch.solvers import cg, graphs
from repro_torch.solvers.operators import OperatorSet, sym_scale

pytestmark = pytest.mark.gpu

SUITE = testmats.suite("tiny")
# (codec, D) -> the fused encoding each one exercises on the tiny suite
STREAMS = (("fp16", 15), ("bf16", 15), ("e8m", 15), ("fixed12", 15),
           ("e8m", 12))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for "
                    "sm_90a; the CPU tests run their plain versions)")
    return torch.device("cuda")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
        float((a - b).abs().max())


def _x(m, dev, nb=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (m,) if nb is None else (m, nb)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev)


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", STREAMS)
def test_k1_k3_bit_equal_plain(cuda, klass, codec, D):
    mat = pk.from_csr(SUITE[klass], C=32, sigma=64, D=D, codec=codec,
                      device=cuda)
    plan = kplan.build_plan(mat, force="fused")
    if plan.variant != "fused":
        pytest.skip(f"{codec}/D{D} has no fused stream on {klass}")
    words, ckpt = plan.fused
    lay = plan.fused_layout
    kw = dict(codec_name=codec, D=D, encoding=lay.encoding, scale=lay.scale)
    x = _x(mat.m, cuda)
    before = kpk.packsell_spmv_fused.launches
    _bits_equal(kpk.packsell_spmv_fused(words, ckpt, x, **kw),
                kpk.packsell_spmv_fused_plain(words, ckpt, x, **kw))
    assert kpk.packsell_spmv_fused.launches == before + 1
    for nb in (1, 3, 4, 8, 12):
        X = _x(mat.m, cuda, nb=nb, seed=nb)
        # a contiguous view 4 bytes past a 16-byte boundary: scalar loads
        Xm = _x(mat.m * nb + 1, cuda, seed=nb)[1:].view(mat.m, nb)
        assert not kpk.spmm_vector_loads(Xm)
        assert kpk.spmm_vector_loads(X) == (nb % 4 == 0)
        for XX in (X, Xm):
            before = kpk.packsell_spmm_fused.launches
            _bits_equal(kpk.packsell_spmm_fused(words, ckpt, XX, **kw),
                        kpk.packsell_spmm_fused_plain(words, ckpt, XX, **kw))
            assert kpk.packsell_spmm_fused.launches == before + 1
    plain = kplan.build_plan(mat, force="jnp")
    _bits_equal(plan.spmv(mat, x), plain.spmv(mat, x))
    torch.cuda.synchronize()


@pytest.mark.parametrize("wr", kplan._CKPT_WIDTHS)
def test_k1_every_checkpoint_width(cuda, wr):
    mat = pk.from_csr(SUITE["hpcg_mini"], C=32, sigma=64, D=15,
                      codec="fp16", device=cuda)
    plan = kplan.build_plan(mat, force="fused", ckpt_wr=wr)
    assert plan.fused_layout.wr == wr
    x = _x(mat.m, cuda)
    plain = kplan.build_plan(mat, force="jnp", ckpt_wr=wr)
    for permuted in (False, True):
        _bits_equal(plan.spmv(mat, x, permuted=permuted),
                    plain.spmv(mat, x, permuted=permuted))


def test_k1_clamp_and_pad_words_keep_nan(cuda):
    """PAD words of the σ-padding rows read x clamped to m - 1: with inf
    there, 0 · inf = NaN survives in the kernel as in the plain version."""
    import scipy.sparse as sp

    rows = np.repeat(np.arange(8), 3)
    a = sp.csr_matrix((np.arange(1.0, 25.0), (rows, np.tile([0, 2, 4], 8))),
                      shape=(40, 5))
    mat = pk.from_csr(a, C=8, sigma=8, D=15, codec="fp16", device=cuda)
    plan = kplan.build_plan(mat, force="fused")
    words, ckpt = plan.fused
    x = torch.tensor([1, 2, 3, 4, float("inf")], device=cuda)
    kw = dict(codec_name="fp16", D=15, encoding=plan.fused_layout.encoding)
    part = kpk.packsell_spmv_fused(words, ckpt, x, **kw)
    _bits_equal(part, kpk.packsell_spmv_fused_plain(words, ckpt, x, **kw))
    assert torch.isnan(part).any()


def test_k1_empty_stream_launches_nothing(cuda):
    words = torch.zeros((0, 32, 32), dtype=torch.int32, device=cuda)
    ckpt = torch.zeros((0, 32), dtype=torch.int32, device=cuda)
    before = kpk.packsell_spmv_fused.launches
    part = kpk.packsell_spmv_fused(words, ckpt, torch.ones(9, device=cuda),
                                   codec_name="fp16", D=15, encoding="f16")
    assert tuple(part.shape) == (0, 32)
    assert kpk.packsell_spmv_fused.launches == before


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("vdt", ["float16", "bfloat16", "float32",
                                 "float64"])
def test_k2_bit_equal_plain(cuda, klass, vdt):
    mat = sl.from_csr(SUITE[klass], C=32, sigma=64, value_dtype=vdt,
                      device=cuda)
    x = _x(mat.m, cuda)
    before = ksl.sell_spmv_bucket.launches
    for val, col in zip(mat.vals, mat.cols):
        _bits_equal(ksl.sell_spmv_bucket(val, col, x),
                    sl.sell_bucket_spmv(val, col, x))
    assert ksl.sell_spmv_bucket.launches == before + len(mat.vals)
    _bits_equal(ops.sell_spmv(mat, x), sl.sell_spmv(mat, x))


def test_wrappers_reject_bad_operands(cuda):
    mat = pk.from_csr(SUITE["banded"], C=32, sigma=64, D=15, codec="fp16",
                      device=cuda)
    plan = kplan.build_plan(mat, force="fused")
    words, ckpt = plan.fused
    kw = dict(codec_name="fp16", D=15, encoding="f16")
    with pytest.raises(ValueError, match="CUDA device"):
        kpk.packsell_spmv_fused(words, ckpt, torch.ones(mat.m), **kw)
    with pytest.raises(TypeError, match="float32"):
        kpk.packsell_spmv_fused(words, ckpt, torch.ones(
            mat.m, dtype=torch.float64, device=cuda), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kpk.packsell_spmm_fused(words, ckpt, torch.ones(
            (3, mat.m), device=cuda).t(), **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 255, 4096, 4097, 281_216])
def test_k7_rows_do_not_depend_on_the_row_count(cuda, dtype, n):
    from repro_torch.kernels import row_dots as krd

    rng = np.random.default_rng(n)
    a, b = (torch.from_numpy(v).to(cuda, dtype)
            for v in rng.standard_normal((2, 4, n)))
    before = krd.row_dots.launches
    stacked = krd.row_dots(a, b)
    assert krd.row_dots.launches == before + 1
    for p in range(4):
        assert torch.equal(stacked[p:p + 1],
                           krd.row_dots(a[p:p + 1], b[p:p + 1]))
    # each sum within a rounding bound of its terms' magnitude (the sums
    # are taken in other orders)
    ab = a.double() * b.double()
    scale = (1e-6 if dtype == torch.float32 else 1e-14) * ab.abs().sum(1)
    assert bool(((stacked.double() - ab.sum(1)).abs() <= scale).all())
    plain = krd.row_dots_plain(a, b).double()
    assert bool(((stacked.double() - plain).abs() <= scale).all())
    with pytest.raises(TypeError, match="float32"):
        krd.row_dots(a.half(), b.half())
    with pytest.raises(ValueError, match="unit stride"):
        krd.row_dots(torch.stack([a, a], -1)[..., 0], b)


def _k1_launches():
    return {"K1": kpk.packsell_spmv_fused.launches}


def test_jacobi_pcg_through_k1_matches_plain_iterations(cuda):
    s, _ = sym_scale(testmats.hpcg(12, 12, 12))
    mat, plan = OperatorSet(s, device=cuda).plan_pair("plan_fp16")
    assert plan.variant == "fused"
    b = torch.ones(s.shape[0], dtype=torch.float64, device=cuda)
    with graphs.LEDGER.watch(_k1_launches):
        before = graphs.LEDGER.ran(_k1_launches())["K1"]
        x, info = cg.jacobi_pcg_stored(mat, plan, s.diagonal(), b, tol=1e-8,
                                       maxiter=500)
        ran = graphs.LEDGER.ran(_k1_launches())["K1"] - before
    # the first residual, then whole chunks of steps, and the steps of
    # the chunk the loop stopped in again, up to the stop
    chunks = -(-info.iters // cg.PCG_CHUNK)
    assert ran == 1 + chunks * cg.PCG_CHUNK + info.iters % cg.PCG_CHUNK
    assert float(info.relres) < 1e-8
    xp, info_p = cg.jacobi_pcg_stored(mat, kplan.get_plan(mat, force="jnp"),
                                      s.diagonal(), b, tol=1e-8, maxiter=500)
    assert info_p.iters == info.iters
    assert torch.equal(x, xp)


# ---------------------------------------------------------------------------
# K4, K5, K6 and K2-f64
# ---------------------------------------------------------------------------

BUCKET_CODECS = (("fp16", 15), ("bf16", 15), ("e8m", 12), ("e8m", 8),
                 ("e8m", 4), ("e8m", 1), ("fixed12", 15))


def _smallest_hw(mat, sb=8):
    return next(h for h in range(128, 1 << 22, 128)
                if kplan.band_plan(mat, sb, h) is not None)


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", BUCKET_CODECS)
@pytest.mark.parametrize("wb", [None, 32, 8])
def test_k4_k5_k6_bit_equal_plain(cuda, klass, codec, D, wb):
    """Carry body (wb None) and checkpoint body, on uniform buckets so that
    K6 has windows: K4, K6 and K5 (nb = 1, 3, 4, 8, 11, 12 on a 16-byte
    aligned X and on a view 4 bytes past it) each over all buckets in one
    launch, bit-equal to their plain versions."""
    mat = pk.from_csr(SUITE[klass], C=32, sigma=64, D=D, codec=codec,
                      device=cuda, bucket_strategy="uniform")
    tiles = tuple((8, wb or 32) for _ in mat.packs)
    kck = kplan._build_block_checkpoints(mat, tiles) if wb else None
    hw = _smallest_hw(mat)
    wins = [torch.from_numpy(w).to(cuda) for w in kplan.band_plan(mat, 8, hw)]
    table = kpk.bucket_table(mat.packs, mat.d0s, kck, [t[1] for t in tiles],
                             wins=wins, sbs=[t[0] for t in tiles])
    x = _x(mat.m, cuda)
    kernels = (kpk.packsell_spmv_buckets, kpk.packsell_spmv_band_buckets,
               kpk.packsell_spmm_buckets)
    launches = [k.launches for k in kernels]
    kw = dict(codec_name=codec, D=D)
    args = (mat.packs, mat.d0s, kck, table)
    _bits_equal(kpk.packsell_spmv_buckets(*args, x, **kw),
                kpk.packsell_spmv_buckets_plain(*args, x, **kw))
    _bits_equal(
        kpk.packsell_spmv_band_buckets(mat.packs, mat.d0s, wins, kck, table,
                                       x, hw=hw, **kw),
        kpk.packsell_spmv_band_buckets_plain(mat.packs, mat.d0s, wins, kck,
                                             table, x, hw=hw, **kw))
    nbs = (1, 3, 4, 8, 11, 12)
    for nb in nbs:
        X = _x(mat.m, cuda, nb=nb, seed=nb)
        Xm = _x(mat.m * nb + 1, cuda, seed=nb)[1:].view(mat.m, nb)
        assert not kpk.spmm_vector_loads(Xm)
        for XX in (X, Xm):
            _bits_equal(kpk.packsell_spmm_buckets(*args, XX, **kw),
                        kpk.packsell_spmm_buckets_plain(*args, XX, **kw))
    assert [k.launches for k in kernels] == \
        [launches[0] + 1, launches[1] + 1, launches[2] + 2 * len(nbs)]
    # the plans: band and full agree bit for bit on finite x, and each
    # equals its plain body's plan output within float32 rounding
    mode = "checkpoint" if wb else "0"
    pb = kplan.build_plan(mat, force="band", hw=hw, decode_cache=mode,
                          wb=wb or 32)
    pf = kplan.build_plan(mat, force="full", decode_cache=mode, wb=wb or 32)
    assert (pb.variant, pf.variant) == ("band", "full")
    X = _x(mat.m, cuda, nb=11, seed=4)
    _bits_equal(pb.spmv(mat, x), pf.spmv(mat, x))
    _bits_equal(pb.spmm(mat, X), pf.spmm(mat, X))
    pj = kplan.build_plan(mat, force="jnp")
    torch.testing.assert_close(pf.spmv(mat, x), pj.spmv(mat, x), rtol=1e-5,
                               atol=1e-5)
    torch.cuda.synchronize()


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", BUCKET_CODECS)
@pytest.mark.parametrize("wb", [None, 32, 8])
def test_plan_spmm_is_one_k5_launch_and_band_spmv_one_k6(cuda, klass, codec,
                                                         D, wb):
    """pow2 buckets (several per matrix) for K5, uniform ones for K6: a
    ``full`` plan's ``spmm`` is one K5 launch and a ``band`` plan's ``spmv``
    one K6 launch, bit-equal to the plain versions over the plans'
    operands; column 0 of the SpMM equals the SpMV on it (K5 and K4 walk a
    row alike)."""
    mode = "checkpoint" if wb else "0"
    mat = pk.from_csr(SUITE[klass], C=32, sigma=64, D=D, codec=codec,
                      device=cuda)
    plan = kplan.build_plan(mat, force="full", decode_cache=mode,
                            wb=wb or 32)
    X = _x(mat.m, cuda, nb=8, seed=5)
    kw = dict(codec_name=codec, D=D)
    k5, k6 = kpk.packsell_spmm_buckets, kpk.packsell_spmv_band_buckets
    before = k5.launches
    Y = plan.spmm(mat, X, permuted=True)
    assert k5.launches == before + 1
    _bits_equal(Y, kpk.packsell_spmm_buckets_plain(
        mat.packs, mat.d0s, plan.kckpts, plan.ktable, X, **kw))
    _bits_equal(plan.spmm(mat, X)[:, 0],
                plan.spmv(mat, X[:, 0].contiguous()))
    mu = pk.from_csr(SUITE[klass], C=32, sigma=64, D=D, codec=codec,
                     device=cuda, bucket_strategy="uniform")
    hw = _smallest_hw(mu)
    band = kplan.build_plan(mu, force="band", hw=hw, decode_cache=mode,
                            wb=wb or 32)
    x = _x(mu.m, cuda, seed=6)
    before = k6.launches
    y = band.spmv(mu, x, permuted=True)
    assert k6.launches == before + 1
    _bits_equal(y, kpk.packsell_spmv_band_buckets_plain(
        mu.packs, mu.d0s, band.wins, band.kckpts, band.ktable, x, hw=hw,
        **kw))
    before = k5.launches
    band.spmm(mu, X[:mu.m])
    assert k5.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", BUCKET_CODECS)
@pytest.mark.parametrize("wb", [None, 32, 8])
def test_full_plan_spmv_is_one_k4_launch(cuda, klass, codec, D, wb):
    """pow2 buckets (several per matrix): the ``full`` plan's SpMV is one
    K4 launch, bit-equal to K4's plain version over the plan's operands,
    in both output orders; a table of other tensors and CPU x raise."""
    mat = pk.from_csr(SUITE[klass], C=32, sigma=64, D=D, codec=codec,
                      device=cuda)
    mode = "checkpoint" if wb else "0"
    plan = kplan.build_plan(mat, force="full", decode_cache=mode,
                            wb=wb or 32)
    x = _x(mat.m, cuda, seed=9)
    k4 = kpk.packsell_spmv_buckets
    kw = dict(codec_name=codec, D=D)
    want = kpk.packsell_spmv_buckets_plain(mat.packs, mat.d0s, plan.kckpts,
                                           plan.ktable, x, **kw)
    before = k4.launches
    _bits_equal(plan.spmv(mat, x, permuted=True), want)
    assert k4.launches == before + 1
    _bits_equal(plan.spmv(mat, x), plan.from_stored(want))
    assert k4.launches == before + 2
    if len(mat.packs) > 1:
        with pytest.raises(ValueError, match="other buckets"):
            k4(mat.packs[::-1], mat.d0s[::-1], plan.kckpts, plan.ktable, x,
               **kw)
    cpu_table = kpk.bucket_table([p.cpu() for p in mat.packs],
                                 [d.cpu() for d in mat.d0s], plan.kckpts,
                                 [t[1] for t in plan.tiles])
    with pytest.raises(ValueError, match="CUDA device"):
        k4(mat.packs, mat.d0s, plan.kckpts, cpu_table, x, **kw)
    assert k4.launches == before + 2


def test_k4_k6_pad_words_differ_only_past_m(cuda):
    """The σ-padding rows' PAD words have cursors past m - 1: K4 reads
    x[m - 1] (inf, so 0 · inf = NaN) where K6 reads the zero padding."""
    import scipy.sparse as sp

    rows = np.repeat(np.arange(8), 3)
    a = sp.csr_matrix((np.arange(1.0, 25.0), (rows, np.tile([0, 2, 4], 8))),
                      shape=(40, 5))
    mat = pk.from_csr(a, C=8, sigma=8, D=12, codec="e8m", device=cuda)
    x = torch.tensor([1, 2, 3, 4, float("inf")], device=cuda)
    hw = 128
    kw = dict(codec_name="e8m", D=12)
    wins = [torch.from_numpy(w).to(cuda) for w in kplan.band_plan(mat, 8, hw)]
    table = kpk.bucket_table(mat.packs, mat.d0s, None, [32] * len(mat.packs),
                             wins=wins)
    k4 = kpk.packsell_spmv_buckets(mat.packs, mat.d0s, None, table, x, **kw)
    _bits_equal(k4, kpk.packsell_spmv_buckets_plain(
        mat.packs, mat.d0s, None, table, x, **kw))
    k6 = kpk.packsell_spmv_band_buckets(mat.packs, mat.d0s, wins, None, table,
                                        x, hw=hw, **kw)
    _bits_equal(k6, kpk.packsell_spmv_band_buckets_plain(
        mat.packs, mat.d0s, wins, None, table, x, hw=hw, **kw))
    differ = ~((k4 == k6) | (torch.isnan(k4) & torch.isnan(k6)))
    assert torch.isnan(k4[differ]).all() and (k6[differ] == 0).all()
    assert int(differ.sum()) > 0


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("vdt", ["float16", "bfloat16", "float32",
                                 "float64"])
def test_k2_f64_accumulator_bit_equal_plain(cuda, klass, vdt):
    mat = sl.from_csr(SUITE[klass], C=32, sigma=64, value_dtype=vdt,
                      device=cuda)
    x = _x(mat.m, cuda).double()
    for val, col in zip(mat.vals, mat.cols):
        y = ksl.sell_spmv_bucket(val, col, x, torch.float64)
        assert y.dtype == torch.float64
        want = sl.sell_bucket_spmv(val, col, x, torch.float64)
        assert torch.equal(y.view(torch.int64), want.view(torch.int64))
    got = ops.sell_spmv(mat, x, torch.float64)
    assert torch.equal(got, sl.sell_spmv(mat, x, torch.float64))


def test_adaptive_pcg_through_k4_matches_plain_schedule(cuda):
    s, _ = sym_scale(testmats.hpcg(16, 16, 16))
    ops_k = OperatorSet(s, device=cuda)
    tiers, labels, sub32, hi = ops_k.adaptive_tiers(1e-3, n_probes=2)
    diag = torch.as_tensor(s.diagonal(), device=cuda)
    M = lambda r: r * (1.0 / diag)                    # noqa: E731
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        s.shape[0])).to(cuda)
    k4 = kpk.packsell_spmv_buckets

    def launches():
        return {"K4": k4.launches, "K2": ksl.sell_spmv_bucket.launches}

    with graphs.LEDGER.watch(launches):
        before = graphs.LEDGER.ran(launches())
        x, info = cg.adaptive_pcg(tiers, b, M=M, matvec_hi=hi, tol=1e-8,
                                  maxiter=60, m_in=16)
        ran = graphs.LEDGER.ran(launches())
    ladder = psel.tier_ladder(ops_k.precision_plan(1e-3, n_probes=2))
    want_k4 = 0                 # one launch per packed-tier matvec
    for i, c in enumerate(ladder):
        if c.codec == "e8m":
            mat, plan = ops_k.plan_pair(psel.operator_kind(c))
            if plan.variant == "full":
                want_k4 += int(info.tier_matvecs[i])
    # one outer step per replay: no step is masked
    assert ran["K4"] - before["K4"] == want_k4 > 0
    assert ran["K2"] - before["K2"] == info.hi_matvecs * len(
        ops_k.stored("fp64").vals) + int(info.tier_matvecs[-1]) * len(
        ops_k.stored("fp32").vals)
    assert float(info.relres) <= 1e-8
    # the same ladder over the plain bodies (no kernel launches)
    ops_p = OperatorSet(s, device=cuda, force="jnp")
    tiers_p, _, _ = psel.build_tier_matvecs(ops_p, ladder)
    xp, info_p = cg.adaptive_pcg(tiers_p, b, M=M,
                                 matvec_hi=ops_p.matvec("fp64"), tol=1e-8,
                                 maxiter=60, m_in=16)
    assert info_p.iters == info.iters
    assert torch.equal(info_p.tier_history, info.tier_history)
    assert torch.equal(info_p.tier_matvecs, info.tier_matvecs)
    assert info_p.hi_matvecs == info.hi_matvecs


# ---------------------------------------------------------------------------
# The solver layer on the card: no host sync where none is needed, the
# packsell_ kinds through the plan's kernels, and the CPU's counts
# ---------------------------------------------------------------------------


def _spd_system():
    """The reference tests' n = 576 SPD system, sym-scaled."""
    a = testmats.stencil_3d(8, 8, 9, neighbours=27)
    s, _ = sym_scale(a.tocsr())
    return s, np.random.default_rng(0).random(a.shape[0])


class _NoSync:
    """Raise on any device synchronisation inside the block."""

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")


def test_dense_matvecs_are_sync_free(cuda):
    s, b = _spd_system()
    ops_k = OperatorSet(s, C=8, sigma=32, device=cuda)
    mvs = {k: ops_k.matvec(k) for k in ("fp16", "fp32", "fp64")}
    x = torch.from_numpy(b).to(cuda)
    with _NoSync():
        ys = {k: mv(x) for k, mv in mvs.items()}
    for k, y in ys.items():
        mat = ops_k.stored(k)
        comp = torch.float64 if k == "fp64" else torch.float32
        assert torch.equal(y, sl.sell_spmv(mat, x, comp))


def test_fixed_iteration_solvers_are_sync_free(cuda):
    from repro_torch.solvers import precond
    from repro_torch.solvers.cg import pcg_fixed_iters
    from repro_torch.solvers.richardson import richardson_fixed_iters

    s, b = _spd_system()
    ops_k = OperatorSet(s, C=8, sigma=32, device=cuda)
    fns = []
    for kind in ("fp32", "packsell_e8m8", "fp16"):
        A = ops_k.matvec(kind)
        M = precond.neumann_ainv(ops_k.diag(), A, device=cuda)
        fns += [M, pcg_fixed_iters(A, M, 20), richardson_fixed_iters(A, M, 4)]
    r = torch.from_numpy(b).to(cuda)
    with _NoSync(), graphs.eager():
        outs = [f(r) for f in fns]          # the eager bodies
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    for f in fns:                           # warm-up and capture
        f(r)
    with _NoSync():
        replays = [f(r) for f in fns]
    for o, p in zip(outs, replays):
        assert torch.equal(o, p)


@pytest.mark.parametrize("codec", ["fp16", "bf16", "e8m8", "e8m12", "e8m1"])
def test_packsell_kind_equals_its_plain_plan_body(cuda, codec):
    s, b = _spd_system()
    kind = f"packsell_{codec}"
    ops_k = OperatorSet(s, C=8, sigma=32, device=cuda)
    ops_p = OperatorSet(s, C=8, sigma=32, device=cuda, force="jnp")
    x = torch.from_numpy(b.astype(np.float32)).to(cuda)
    k1, k4 = kpk.packsell_spmv_fused, kpk.packsell_spmv_buckets
    before = (k1.launches, k4.launches)
    y = ops_k.matvec(kind)(x)
    mat = ops_k.stored(kind)
    plan = kplan.get_plan(mat)
    y_plain = ops_p.matvec(kind)(x)
    if plan.variant == "fused":
        # the plain plan keeps the stream: the fused plain body
        assert (k1.launches - before[0], k4.launches - before[1]) == (1, 0)
        _bits_equal(y, y_plain)
    else:
        # e8m1: the stream is infeasible, the plan is full (K4) and the
        # plain plan the cursor cache, which sums in another order
        assert plan.variant == "full" and codec == "e8m1"
        assert (k1.launches - before[0], k4.launches - before[1]) == (0, 1)
        _bits_equal(y, plan.from_stored(kpk.packsell_spmv_buckets_plain(
            mat.packs, mat.d0s, plan.kckpts, plan.ktable, x,
            codec_name=mat.codec_name, D=mat.D)))
        np.testing.assert_allclose(y.cpu().numpy(), y_plain.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    # and within float32 rounding of the CPU's scan body
    ops_c = OperatorSet(s, C=8, sigma=32, device="cpu")
    np.testing.assert_allclose(y.cpu().numpy(), ops_c.matvec(kind)(
        x.cpu()).numpy(), rtol=1e-5, atol=1e-5)


def test_iocg_and_f3r_take_the_cpu_counts(cuda):
    from repro_torch.solvers import f3r, iocg

    s, b = _spd_system()
    counts = {}
    for dev in ("cpu", cuda):
        ops_d = OperatorSet(s, C=8, sigma=32, device=dev)
        bd = torch.from_numpy(b).to(dev)
        x1, i1 = iocg.solve(ops_d, bd, iocg.variant("e8m8", m_in=20))
        x2, i2 = f3r.solve(ops_d, bd, f3r.presets("packsell"))
        counts[str(dev)] = (i1.iters, i2.iters)
        for x in (x1, x2):
            x = x.cpu().numpy()
            assert np.linalg.norm(b - s @ x) / np.linalg.norm(b) < 5e-9
    assert counts["cpu"] == counts[str(cuda)]


# ---------------------------------------------------------------------------
# The solver loops as CUDA graphs: each captured solve against the eager
# loop on the card, replays without a host sync, a cached solve that
# captures nothing new, and the calls a replay runs
# ---------------------------------------------------------------------------


def _same_bits(a, b):
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(view), b.view(view))


def _graph_runs(ops_k, b, name):
    """A callable running the solve ``name`` of items 2-11 on ``ops_k``'s
    operators: ``() -> (x, iters or None)``."""
    import scipy.sparse as sp

    from repro_torch.core import trisolve
    from repro_torch.solvers import f3r, gmres, iocg, precond
    from repro_torch.solvers.richardson import richardson_fixed_iters

    s = ops_k.csr
    A16, A32 = ops_k.matvec("packsell_fp16"), ops_k.matvec("fp32")
    if name == "neumann_ainv":
        f = precond.neumann_ainv(ops_k.diag(), A32, device=b.device)
        return lambda: (f(b), None)
    if name == "richardson_fixed_iters":
        f = richardson_fixed_iters(A16, precond.neumann_ainv(
            ops_k.diag(), A16, device=b.device), 4)
        return lambda: (f(b), None)
    if name == "pcg_fixed_iters":
        f = cg.pcg_fixed_iters(A32, precond.neumann_ainv(
            ops_k.diag(), A32, device=b.device), 20)
        return lambda: (f(b), None)
    if name == "pcg":
        return lambda: iocg.pcg_reference(ops_k, b)
    if name == "jacobi_pcg_stored":
        mat, plan = ops_k.plan_pair("plan_fp16")
        return lambda: cg.jacobi_pcg_stored(mat, plan, s.diagonal(), b,
                                            tol=1e-8, maxiter=500)
    if name == "fcg":
        return lambda: iocg.solve(ops_k, b, iocg.variant("e8m8", m_in=20))
    if name == "adaptive_pcg":
        tiers, _, _, hi = ops_k.adaptive_tiers(1e-3, n_probes=2)
        dinv = 1.0 / torch.as_tensor(s.diagonal(), device=b.device)
        cache = {}
        return lambda: cg.adaptive_pcg(
            tiers, b, M=lambda r: r * dinv, matvec_hi=hi, tol=1e-8,
            maxiter=60, m_in=16, jit_cache=cache, jit_key="ladder")
    if name == "fgmres":
        l4 = richardson_fixed_iters(A16, precond.neumann_ainv(
            ops_k.diag(), A16, device=b.device), 4)
        l3 = gmres.fgmres_fixed_cycles(A16, l4, m=5)
        return lambda: (l3(b.float()), None)
    if name == "f3r":
        return lambda: f3r.solve(ops_k, b, f3r.presets("packsell"))
    assert name == "trisolve"
    lo = sp.tril(s).tocsr()
    lo.sort_indices()
    solver = trisolve.PackSELLTriSolver(lo, C=8, sigma=32, D=1, codec="e8m",
                                        device=b.device)
    return lambda: (solver.solve(b), None)


GRAPH_SOLVES = ("neumann_ainv", "richardson_fixed_iters", "pcg_fixed_iters",
                "pcg", "jacobi_pcg_stored", "fcg", "adaptive_pcg", "fgmres",
                "f3r", "trisolve")


@pytest.mark.parametrize("name", GRAPH_SOLVES)
def test_captured_solve_equals_the_eager_loop(cuda, name):
    """Eager, captured (the capture), captured (replays only), eager: the
    same iterations and x bit for bit; the second captured solve captures
    nothing new."""
    from repro_torch.solvers import gmres

    s, b = _spd_system()
    ops_k = OperatorSet(s, C=8, sigma=32, device=cuda)
    captures, arnoldis = [], []
    capture = graphs.Graph._warm_up_and_capture
    arnoldi_init = gmres._Arnoldi.__init__

    def counted(self):
        captures.append(self)
        return capture(self)

    def made(self, *args, **kwargs):
        arnoldi_init(self, *args, **kwargs)
        arnoldis.append(self)

    gmres._Arnoldi.__init__ = made
    try:
        run = _graph_runs(ops_k, torch.from_numpy(b).to(cuda), name)
        with graphs.eager():
            want = run()
        graphs.Graph._warm_up_and_capture = counted
        try:
            first = run()
            n_first = len(captures)
            second = run()
        finally:
            graphs.Graph._warm_up_and_capture = capture
        with graphs.eager():
            again = run()
    finally:
        gmres._Arnoldi.__init__ = arnoldi_init
    assert n_first >= 1
    assert len(captures) == n_first
    # F3R's L3 (and FGMRES's Arnoldi loop) replays after an eager first run
    if name in ("fgmres", "f3r"):
        assert arnoldis
        assert all(g.replays > 0 for a in arnoldis for g in a.graphs)
    for got in (first, second, again):
        x, info = got
        _same_bits(x, want[0])
        if info is not None:
            assert info.iters == want[1].iters
            _same_bits(info.history, want[1].history)


def test_replays_do_not_sync(cuda):
    from repro_torch.solvers import iocg

    s, b = _spd_system()
    ops_k = OperatorSet(s, C=8, sigma=32, device=cuda)
    bd = torch.from_numpy(b).to(cuda)
    iocg.pcg_reference(ops_k, bd)
    iocg.solve(ops_k, bd, iocg.variant("fp32", m_in=20))
    loops = [v for v in ops_k.graphs.values() if hasattr(v, "graph")]
    applied = [v for v in ops_k.graphs.values() if hasattr(v, "fn")]
    assert loops and applied
    with _NoSync():
        for loop in loops:
            loop.graph()                    # a chunk of steps
        outs = [f(bd) for f in applied]     # copy in, replay, clone out
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_graph_calls_times_replays_equal_eager_matvecs(cuda):
    """A counted matvec inside ``pcg_fixed_iters``: the calls a capture
    records, times the replays, plus the warm-up's, equal the eager
    loop's calls."""
    from repro_torch.solvers import precond

    s, b = _spd_system()
    ops_k = OperatorSet(s, C=8, sigma=32, device=cuda)
    A = ops_k.matvec("fp32")
    calls = {"A": 0}

    def counted(v):
        calls["A"] += 1
        return A(v)

    f = cg.pcg_fixed_iters(counted, precond.neumann_ainv(
        ops_k.diag(), counted, device=cuda), 10)
    r = torch.from_numpy(b).to(cuda)
    with graphs.eager():
        f(r)
    eager = calls["A"]
    calls["A"] = 0
    with graphs.LEDGER.watch(lambda: calls):
        net0 = graphs.LEDGER.net["A"]
        for _ in range(4):
            f(r)
        (_, graph), = f.graphs.values()
        ran = calls["A"] + graphs.LEDGER.net["A"] - net0
    assert graph.replays == 3 and graph.calls["A"] == eager
    assert ran == 4 * eager


# ---------------------------------------------------------------------------
# the composite and the guards on the card
# ---------------------------------------------------------------------------


def _three_class_composite(s, dev):
    from repro_torch.kernels import composite

    rows = np.arange(s.shape[0])
    return composite.CompositePlan.from_classes(
        s, [("fp16", 15, rows[rows % 4 == 0]), ("e8m", 8, rows[rows % 4 == 1]),
            ("fp32", 0, rows[rows % 4 == 2]), ("fp64", 0, rows[rows % 4 == 3])],
        C=8, sigma=32, device=dev, force=["fused", "full", "auto", "auto"])


def test_composite_bit_equal_plain_one_launch_each_and_sync_free(cuda):
    s, b = _spd_system()
    cp = _three_class_composite(s, cuda)
    assert [m.plan.variant for m in cp.members[:2]] == ["fused", "full"]
    x = torch.from_numpy(b.astype(np.float32)).to(cuda)
    X = torch.stack([x, 2 * x, -x, x * x, x, x, x, 3 * x], dim=1)
    cp.warmup(nb=8)
    before = {k: f.launches for k, f in (
        ("K1", kpk.packsell_spmv_fused), ("K4", kpk.packsell_spmv_buckets),
        ("K3", kpk.packsell_spmm_fused), ("K5", kpk.packsell_spmm_buckets))}
    with _NoSync():
        y = cp.spmv(x)
        Y = cp.spmm(X)
    assert kpk.packsell_spmv_fused.launches - before["K1"] == 1
    assert kpk.packsell_spmv_buckets.launches - before["K4"] == 1
    assert kpk.packsell_spmm_fused.launches - before["K3"] == 1
    assert kpk.packsell_spmm_buckets.launches - before["K5"] == 1
    _same_bits(y, kref.composite_plain(cp, x))
    _same_bits(Y, kref.composite_plain(cp, X, multi_rhs=True))
    for j in range(8):
        _same_bits(Y[:, j], cp.spmv(X[:, j].contiguous()))


def test_composite_jacobi_pcg_captured_equals_eager(cuda):
    s, b = _spd_system()
    cp = _three_class_composite(s, cuda)
    bd = torch.from_numpy(b).to(cuda)
    dinv = 1.0 / torch.from_numpy(s.diagonal()).to(cuda)
    M = lambda r: r * dinv                                    # noqa: E731
    with graphs.eager():
        xe, ie = cg.pcg(cp.spmv, bd, M=M, tol=1e-8, maxiter=500)
    cache = {}
    for _ in range(2):                      # the capture, then replays
        xg, ig = cg.pcg(cp.spmv, bd, M=M, tol=1e-8, maxiter=500,
                        jit_cache=cache, jit_key="composite")
        assert ig.iters == ie.iters
        _same_bits(xg, xe)


def test_guarded_kind_under_capture_runs_unguarded(cuda):
    from repro_torch.solvers.operators import OperatorSet as Ops

    s, b = _spd_system()
    ops_k = Ops(s, C=8, sigma=32, device=cuda)
    fn, plain = ops_k.matvec("guarded:plan_fp16"), ops_k.matvec("plan_fp16")
    bd = torch.from_numpy(b).to(cuda)
    dinv = 1.0 / torch.from_numpy(s.diagonal()).to(cuda)
    M = lambda r: r * dinv                                    # noqa: E731
    xp, ip = cg.pcg(plain, bd, M=M, tol=1e-8, maxiter=500, jit_cache={},
                    jit_key="plain")
    cache = {}
    xg, ig = cg.pcg(fn, bd, M=M, tol=1e-8, maxiter=500, jit_cache=cache,
                    jit_key="guarded")
    calls = fn.guard.calls          # the eager first residual and warm-ups
    xg2, ig2 = cg.pcg(fn, bd, M=M, tol=1e-8, maxiter=500, jit_cache=cache,
                      jit_key="guarded")
    assert ig.iters == ig2.iters == ip.iters
    _same_bits(xg, xp)
    _same_bits(xg2, xp)
    assert fn.guard.calls == calls + 1      # the replays ran no guard
    assert fn.trips() == 0


def test_in_place_injection_reaches_a_captured_graph(cuda):
    from repro_torch.robust import inject

    s, b = _spd_system()
    mat = pk.from_csr(s, C=8, sigma=32, D=15, codec="fp16", device=cuda)
    plan = kplan.get_plan(mat)
    bd = torch.from_numpy(b).to(cuda)
    x0, i0 = cg.jacobi_pcg_stored(mat, plan, s.diagonal(), bd, tol=1e-8)
    g = next(iter(plan._fns.values()))[2]
    loop = next(iter(g.values()))
    assert loop.graph.graph is not None     # captured before the fault
    inj = next(i for i in (inject.flip_fused_word(mat, plan, sd, bit=27)
                           for sd in range(40))
               if not i.value_neutral or i.undo())
    replays = loop.graph.replays
    x1, _ = cg.jacobi_pcg_stored(mat, plan, s.diagonal(), bd, tol=1e-8)
    assert loop.graph.replays > replays
    assert not torch.equal(x1, x0)
    inj.undo()
    x2, i2 = cg.jacobi_pcg_stored(mat, plan, s.diagonal(), bd, tol=1e-8)
    assert i2.iters == i0.iters
    _same_bits(x2, x0)


@pytest.mark.parametrize("force", ["full", "band"])
def test_retile_rebuilds_the_table_and_drops_graphs(cuda, force):
    s, b = _spd_system()
    mat = pk.from_csr(s, C=8, sigma=32, D=8, codec="e8m", device=cuda,
                      bucket_strategy="uniform")
    plan = kplan.build_plan(mat, force=force, hw=256)
    bd = torch.from_numpy(b).to(cuda)
    cg.jacobi_pcg_stored(mat, plan, s.diagonal(), bd, tol=1e-8)
    assert plan._fns
    # a graph captured outside the plan, before the retile
    dinv = 1.0 / torch.from_numpy(s.diagonal()).to(cuda)
    mv = lambda v: plan.spmv(mat, v)                          # noqa: E731
    M = lambda r: r * dinv                                    # noqa: E731
    ext = {}
    cg.pcg(mv, bd, M=M, tol=1e-8, jit_cache=ext, jit_key="ext")
    loop = next(iter(ext.values()))
    captured = loop.graph.graph
    stale, stale_wins = plan.ktable, plan.wins
    plan.retile([(4, 16)] * len(plan.tiles))
    assert plan._fns == {} and plan.ktable is not stale
    # it captures again over the new table: the retiled plan's result
    xr, ir = cg.pcg(mv, bd, M=M, tol=1e-8, jit_cache=ext, jit_key="ext")
    assert loop.graph.graph is not captured
    with graphs.eager():
        xe, ie = cg.pcg(mv, bd, M=M, tol=1e-8)
    assert ir.iters == ie.iters
    _same_bits(xr, xe)
    x = _x(mat.m, cuda)
    y = plan.spmv(mat, x)
    _bits_equal(y, kref.plan_plain(plan, mat, x))
    if force == "band":
        with pytest.raises(ValueError, match="other windows"):
            kpk.packsell_spmv_band_buckets(
                mat.packs, mat.d0s, plan.wins, plan.kckpts, stale, x,
                codec_name="e8m", D=8, hw=plan.hw)
        assert stale_wins is not plan.wins
    xs, info = cg.jacobi_pcg_stored(mat, plan, s.diagonal(), bd, tol=1e-8)
    with graphs.eager():
        xe, ie = cg.jacobi_pcg_stored(mat, plan, s.diagonal(), bd, tol=1e-8)
    assert info.iters == ie.iters
    _same_bits(xs, xe)


def test_outside_graph_captures_again_after_a_wr_change(cuda):
    """A graph captured outside the plan over its fused stream: a retile to
    another checkpoint width frees the old stream, and the graph captures
    again over the new one instead of replaying over freed memory."""
    import gc
    import weakref

    s, b = _spd_system()
    mat = pk.from_csr(s, C=8, sigma=32, D=15, codec="fp16", device=cuda)
    plan = kplan.build_plan(mat)
    assert plan.variant == "fused"
    bd = torch.from_numpy(b).to(cuda)
    dinv = 1.0 / torch.from_numpy(s.diagonal()).to(cuda)
    mv = lambda v: plan.spmv(mat, v)                          # noqa: E731
    M = lambda r: r * dinv                                    # noqa: E731
    ext = {}
    for _ in range(2):                      # the capture, then replays
        cg.pcg(mv, bd, M=M, tol=1e-8, jit_cache=ext, jit_key="ext")
    loop = next(iter(ext.values()))
    captured, old = loop.graph.graph, weakref.ref(plan.fused[0])
    wr = 8 if plan.fused_layout.wr != 8 else 16
    plan.retile([(8, 32, wr)] * len(plan.tiles))
    gc.collect()
    assert old() is None and plan.fused_layout.wr == wr
    with graphs.eager():
        xe, ie = cg.pcg(mv, bd, M=M, tol=1e-8)
    xr, ir = cg.pcg(mv, bd, M=M, tol=1e-8, jit_cache=ext, jit_key="ext")
    assert loop.graph.graph is not captured
    assert ir.iters == ie.iters
    _same_bits(xr, xe)
    replays = loop.graph.replays
    xr2, _ = cg.pcg(mv, bd, M=M, tol=1e-8, jit_cache=ext, jit_key="ext")
    assert loop.graph.replays > replays
    _same_bits(xr2, xe)


def test_guarded_solve_old_graphs_die_after_promote_and_rebuild(cuda):
    import gc
    import weakref

    from repro_torch.robust import inject, recover
    from repro_torch.solvers.operators import OperatorSet as Ops

    s, b = _spd_system()
    ops_k = Ops(s, C=8, sigma=32, device=cuda)
    made = []
    Binding = recover._Binding

    class Watched(Binding):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(weakref.ref(self))

    def always(step, ctx):
        if ctx["plan"] is not None:
            flip = (inject.flip_fused_word if ctx["plan"].fused is not None
                    else inject.flip_pack_word)
            flip(ctx["mat"], ctx["plan"], seed=step, bit=30)

    recover._Binding = Watched
    collecting = gc.isenabled()
    gc.disable()
    try:
        x, info = recover.guarded_solve(ops_k, "plan_fp16", b, tol=1e-8,
                                        on_step=always)
        actions = [e["action"] for e in info.log]
        assert actions[:2] == ["retry", "promote"]
        assert "rebuild" in actions and info.final_kind == "fp32"
        assert np.linalg.norm(b - s @ x) / np.linalg.norm(b) <= 1e-8
        assert all(r() is None for r in made)
    finally:
        recover._Binding = Binding
        if collecting:
            gc.enable()


@pytest.mark.parametrize("kind", ["csr64", "mixed:1e-3", "guarded:plan_fp16",
                                  "guarded:plan_e8m8"])
def test_new_kinds_run_on_the_card(cuda, kind):
    s, b = _spd_system()
    x = torch.from_numpy(b.astype(np.float32))
    want = OperatorSet(s, C=8, sigma=32, device="cpu").matvec(kind)(x)
    fn = OperatorSet(s, C=8, sigma=32, device=cuda).matvec(kind)
    got = fn(x.to(cuda))
    assert got.device.type == "cuda" and got.dtype == want.dtype
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    if kind.startswith("guarded:"):
        assert fn.trips() == 0


# ---------------------------------------------------------------------------
# The recorder and the serving front end on the card
# ---------------------------------------------------------------------------


class _Recorder:
    """The recorder on (or off) inside the block, reset, restored after."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        from repro_torch import observe

        self.prev = observe.enable(self.on)
        observe.reset()
        return observe

    def __exit__(self, *exc):
        from repro_torch import observe

        observe.reset()
        observe.enable(self.prev)


def test_recorder_is_bit_neutral_through_the_graphs(cuda):
    s, b = _spd_system()
    bd = torch.from_numpy(b).to(cuda)
    out = {}
    for on in (False, True):
        with _Recorder(on) as observe:
            kplan.clear_cache()
            ops_k = OperatorSet(s, C=8, sigma=32, device=cuda)
            mat, plan = ops_k.plan_pair("plan_fp16")
            runs = [cg.jacobi_pcg_stored(mat, plan, s.diagonal(), bd,
                                         tol=1e-8, maxiter=500)
                    for _ in range(2)]         # the capture, then replays
            tiers, _, _, hi = ops_k.adaptive_tiers(1e-3, n_probes=2)
            cache = {}
            runs += [cg.adaptive_pcg(tiers, bd, matvec_hi=hi, tol=1e-8,
                                     maxiter=40, m_in=8, jit_cache=cache,
                                     jit_key="t") for _ in range(2)]
            out[on] = (runs, observe.report())
    for (x0, i0), (x1, i1) in zip(out[False][0], out[True][0]):
        assert i0.iters == i1.iters
        _same_bits(x0, x1)
    counters = out[True][1]["counters"]
    assert counters["solver.solves{path=fused,solver=jacobi_pcg_stored}"] \
        == 2
    assert counters["solver.iters{path=fused,solver=jacobi_pcg_stored}"] \
        == sum(i.iters for _, i in out[True][0][:2])
    assert counters["solver.solves{path=jit_cache,solver=adaptive_pcg}"] \
        == 2
    # a cached solve is one dispatch: nothing inside it records
    assert not any(k.startswith("spmv.dispatch") for k in counters)
    assert out[True][1]["graphs"]["replays"] > 0


@pytest.mark.parametrize("on", [False, True])
def test_spmv_and_replay_make_no_sync_with_the_recorder(cuda, on):
    s, b = _spd_system()
    mat = pk.from_csr(s, C=8, sigma=32, D=15, codec="fp16", device=cuda)
    plan = kplan.get_plan(mat)
    bd = torch.from_numpy(b).to(cuda)
    x = bd.float()
    cache = {}
    mv = lambda v: plan.spmv(mat, v)                          # noqa: E731
    cg.pcg(mv, bd, tol=1e-8, maxiter=200, jit_cache=cache, jit_key="k")
    loop = next(iter(cache.values()))
    with _Recorder(on) as observe:
        plan.spmv(mat, x)                   # the record is built once
        with _NoSync():
            y = plan.spmv(mat, x)
            loop.graph()
        disp = [v for k, v in observe.snapshot()["counters"].items()
                if k.startswith("spmv.dispatch")]
    assert disp == ([2] if on else [])
    assert bool(torch.isfinite(y).all())


def test_profile_dispatch_credits_k1_to_its_span_and_raises_on_failure(
        cuda, monkeypatch):
    from repro_torch.observe import profile

    s, b = _spd_system()
    mat = pk.from_csr(s, C=8, sigma=32, D=15, codec="fp16", device=cuda)
    plan = kplan.get_plan(mat)
    assert plan.variant == "fused"
    x = torch.from_numpy(b.astype(np.float32)).to(cuda)
    prof = profile.profile_dispatch(lambda v: plan.spmv(mat, v), x,
                                    repeats=5, device=cuda)
    assert prof.mode == "trace" and not prof.profiler_unavailable
    assert prof.spans["packsell.fused_kernel"]["device_s"] > 0
    assert not any("fused" in u["op"] for u in prof.unattributed)

    def boom(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(profile, "_trace_events", boom)
    with pytest.raises(RuntimeError, match="on the card"):
        profile.profile_dispatch(lambda v: plan.spmv(mat, v), x, repeats=2,
                                 device=cuda)


def test_profile_dispatch_traces_again_when_a_trace_holds_no_kernel(
        cuda, monkeypatch):
    """A trace whose kernel activity was dropped is taken again; one that
    never holds a kernel raises after ``TRACE_ATTEMPTS`` traces."""
    from repro_torch.observe import profile

    s, b = _spd_system()
    mat = pk.from_csr(s, C=8, sigma=32, D=15, codec="fp16", device=cuda)
    plan = kplan.get_plan(mat)
    x = torch.from_numpy(b.astype(np.float32)).to(cuda)
    real, calls = profile._trace_events, []

    def dropped_once(*a, **k):
        events, t = real(*a, **k)
        calls.append(1)
        if len(calls) == 1:
            events = [e for e in events if e.get("cat") != "kernel"]
        return events, t

    monkeypatch.setattr(profile, "_trace_events", dropped_once)
    prof = profile.profile_dispatch(lambda v: plan.spmv(mat, v), x,
                                    repeats=2, device=cuda)
    assert len(calls) == 2
    assert prof.spans["packsell.fused_kernel"]["device_s"] > 0
    calls.clear()
    monkeypatch.setattr(profile, "_trace_events",
                        lambda *a, **k: (calls.append(1), ([], 0.0))[1])
    with pytest.raises(RuntimeError, match="no kernel event on the card"):
        profile.profile_dispatch(lambda v: plan.spmv(mat, v), x, repeats=2,
                                 device=cuda)
    assert len(calls) == profile.TRACE_ATTEMPTS


def test_worker_rebuilds_while_guarded_solve_captures(cuda):
    """The worker rebuilds a tier again and again while the dispatching
    thread runs ``guarded_solve``, whose correction solves capture
    graphs: the capture lock keeps them apart, no task fails, and the
    solve equals one run with an idle worker bit for bit."""
    from repro_torch.robust import recover
    from repro_torch.serving import frontend as fe

    s, b = _spd_system()
    want, _ = recover.guarded_solve(
        OperatorSet(s, C=32, sigma=64, device=cuda), "plan_e8m4", b,
        tol=1e-8, maxiter=60)
    with _Recorder(True) as observe:
        with fe.ServingFrontend(fe.FrontendConfig(device=cuda)) as f:
            fp = f.register(s, warm=True)
            entry = f._entry(fp)
            for _ in range(8):
                f._defer(lambda: entry.rebuild("plan_fp16"))
            got, info = recover.guarded_solve(entry.ops, "plan_e8m4", b,
                                              tol=1e-8, maxiter=60)
            f.drain_background(timeout=300)
        assert "frontend.background_failure" not in \
            observe.snapshot()["counters"]
    assert info.trips == 0
    np.testing.assert_array_equal(got, want)


def test_a_graph_over_a_rebuilt_entry_captures_again(cuda):
    from repro_torch.serving import frontend as fe

    s, b = _spd_system()
    bd = torch.from_numpy(b).to(cuda)
    with fe.ServingFrontend(fe.FrontendConfig(device=cuda,
                                              background=False)) as f:
        fp = f.register(s, warm=False)
        entry = f._entry(fp)
        entry.bind("plan_fp16")
        mv = lambda v: entry.ops.matvec("plan_fp16")(v)       # noqa: E731
        cache = {}
        x0, i0 = cg.pcg(mv, bd, tol=1e-8, maxiter=300, jit_cache=cache,
                        jit_key="entry")
        loop = next(iter(cache.values()))
        captured = loop.graph.graph
        cg.pcg(mv, bd, tol=1e-8, maxiter=300, jit_cache=cache,
               jit_key="entry")
        assert loop.graph.graph is captured            # replayed
        entry.rebuild("plan_fp16")
        x1, i1 = cg.pcg(mv, bd, tol=1e-8, maxiter=300, jit_cache=cache,
                        jit_key="entry")
        assert loop.graph.graph is not captured        # captured again
        assert i1.iters == i0.iters
        _same_bits(x1, x0)                  # the same CSR, the same operand


def test_frontend_serves_on_the_card(cuda):
    from repro_torch.kernels import packsell_spmv as kpk
    from repro_torch.serving import frontend as fe
    from repro_torch.serving import policy as pol

    s, _ = _spd_system()
    rng = np.random.default_rng(3)
    with fe.ServingFrontend(fe.FrontendConfig(device=cuda,
                                              background=False),
                            clock=pol.ManualClock()) as f:
        fp = f.register(s, warm=True)
        xs = [rng.standard_normal(s.shape[1]).astype(np.float32)
              for _ in range(12)]
        k3 = kpk.packsell_spmm_fused.launches
        reqs = [f.submit(fp, x, klass=k) for x, k in
                zip(xs, ["interactive", "standard", "batch"] * 4)]
        f.run_until_drained()
        assert all(r.status == "ok" for r in reqs)
        assert kpk.packsell_spmm_fused.launches - k3 == 1   # 4 interactive
        entry = f._entry(fp)
        for r in reqs:
            if r.tier_kind == "fp32":
                y1 = entry.ops.matvec("fp32")(
                    torch.from_numpy(r.x).to(cuda)).cpu().numpy()
            else:
                mat, plan, _ = entry.bind(r.tier_kind)
                y1 = plan.spmv(mat, torch.from_numpy(r.x).to(cuda)).cpu(
                ).numpy()
            np.testing.assert_array_equal(r.y, y1)


# ---------------------------------------------------------------------------
# distribution: four shards on one card
# ---------------------------------------------------------------------------


def _dist4(cuda, a, **kw):
    from repro_torch.distributed import build_dist_plan
    from repro_torch.parallel import make_shard_mesh

    mesh = make_shard_mesh(4, devices=[cuda] * 4)
    return build_dist_plan(a, mesh=mesh, C=32, sigma=64, **kw)


@pytest.mark.parametrize("codec,D", [("fp16", 15), ("e8m", 8), ("fp32", 0)])
def test_dist_p4_matches_the_cpu_replay(cuda, codec, D):
    """P = 4 on one card equals the port's ``reference_spmv`` (the
    stacked host arrays replayed on the CPU through the plain bodies) bit
    for bit on integer data, in both exchange modes, and launches each
    member's kernel once per shard."""
    from repro_torch.distributed import halo, reference_spmv

    a = SUITE["scattered"].tocsr().copy()
    rng = np.random.default_rng(5)
    a.data = rng.integers(1, 9, a.nnz).astype(np.float64)
    dp = _dist4(cuda, a, codec=codec, D=D)
    x = rng.integers(-8, 9, a.shape[0]).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda)
    k1 = kpk.packsell_spmv_fused.launches
    y = dp.spmv(xd)
    fused = [m for m in dp.ops.members
             if m.plans is not None and m.plans[0].variant == "fused"]
    assert kpk.packsell_spmv_fused.launches - k1 == 4 * len(fused)
    for mode in halo.EXCHANGE_MODES:
        _same_bits(dp.spmv(xd, mode=mode), y)
        np.testing.assert_array_equal(
            y.cpu().numpy(), reference_spmv(dp.ops, x, mode))


def test_dist_tier_ladder_and_classes_match_the_cpu_replay(cuda):
    """Every tier of a P = 4 ladder, its fp64 operator and a five-class
    composite (several members per term, per-shard row maps) equal the
    CPU replay bit for bit on integer data."""
    from repro_torch.distributed import build_dist_tiers, reference_spmv
    from repro_torch.parallel import make_shard_mesh

    a = SUITE["scattered"].tocsr().copy()
    rng = np.random.default_rng(6)
    a.data = rng.integers(1, 9, a.nnz).astype(np.float64)
    x = rng.integers(-8, 9, a.shape[0]).astype(np.float32)
    mesh = make_shard_mesh(4, devices=[cuda] * 4)
    ladder = build_dist_tiers(a, [("fp16", 15), ("e8m", 8), ("e8m", 1),
                                  ("fp32", 0)], mesh=mesh, C=32, sigma=64)
    xs = ladder.shard_vector(torch.from_numpy(x).double().to(cuda))
    for t in ladder.tiers + [ladder.hi]:
        y = ladder.unshard_vector(t.run(xs, mode=ladder.exchange,
                                        shared=ladder.dev["shared"]))
        np.testing.assert_array_equal(y.double().cpu().numpy(),
                                      reference_spmv(t, x))
    rows = np.arange(a.shape[0])
    classes = [(c, D, rows[rows % 5 == i]) for i, (c, D) in enumerate(
        (("fp16", 15), ("bf16", 12), ("e8m", 8), ("fp32", 0), ("fp64", 0)))]
    dp = _dist4(cuda, a, classes=classes)
    assert len(dp.ops.members) == 10
    y = dp.spmv(torch.from_numpy(x).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(y, reference_spmv(dp.ops, x))


def test_jacobi_pcg_dist_graph_equals_eager(cuda):
    s, b = _spd_system()
    dp = _dist4(cuda, s, codec="fp16", D=15)
    bd = torch.from_numpy(b).to(cuda)
    with graphs.eager():
        xe, ie = cg.jacobi_pcg_dist(dp, s.diagonal(), bd, tol=1e-8,
                                    maxiter=300)
    for _ in range(2):                         # the capture, then a replay
        xg, ig = cg.jacobi_pcg_dist(dp, s.diagonal(), bd, tol=1e-8,
                                    maxiter=300)
        assert ig.iters == ie.iters and float(ig.relres) < 1e-8
        _same_bits(xg, xe)


def test_corrupt_dist_checkpoint_reaches_a_captured_graph(cuda):
    from repro_torch.robust import inject

    s, b = _spd_system()
    dp = _dist4(cuda, s, codec="fp16", D=15)
    xs = dp.shard_vector(torch.from_numpy(b).float().to(cuda))
    g = graphs.Graph(lambda: dp.spmv_sharded(xs), cuda)
    g()
    y0 = g().clone()
    changed = 0
    for seed in range(5):
        inj = inject.corrupt_dist_checkpoint(dp, seed)
        y1 = g().clone()
        _same_bits(y1, dp.spmv_sharded(xs))        # replay == eager
        changed += not torch.equal(y1, y0)
        inj.undo()
        _same_bits(g(), y0)
    assert changed > 0


# -- the LM serving path -------------------------------------------------------


def _lm(cuda, **kw):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import DecodeEngine, ServeConfig

    cfg = dataclasses.replace(configs.reduce(configs.get("granite-3-2b")),
                              dtype="bfloat16")
    params = tfm.init_params(cfg, 0, device=cuda)
    return cfg, DecodeEngine(cfg, params, ServeConfig(**kw), device=cuda)


def test_decode_graph_tick_equals_eager_tick(cuda):
    cfg, eng = _lm(cuda, slots=3, max_len=32)
    eng.warmup()
    assert eng._decode.graph is not None          # captured in warmup
    rng = np.random.default_rng(0)
    for n in (5, 7, 3):
        eng.submit(rng.integers(1, cfg.vocab, size=n), 12)
    for _ in range(4):
        eng.step()
    saved = eng.state()
    with graphs.eager():
        le = eng.tick().clone()
    after = eng.state()
    eng.set_state(saved)
    lg = eng.tick().clone()
    _bits_equal(lg, le)
    for k, v in eng.state().items():
        assert torch.equal(v, after[k]), k
    eng.set_state(saved)
    eng.run()
    assert all(len(r.out_tokens) == 12 for r in eng.done)


def test_packsell_linear_k1_k3_bit_equal_plain(cuda):
    from repro_torch.models.sparse_linear import PackSELLLinear

    w = np.random.default_rng(1).standard_normal((256, 1000)).astype(
        np.float32)
    lin = PackSELLLinear.from_dense(w, density=0.3, codec="bf16", D=15,
                                    C=128, sigma=256, device=cuda)
    plan = lin.plan
    assert plan.variant == "fused"
    plain = kplan.build_plan(lin.mat, force="jnp")
    x = _x(256, cuda, seed=2)
    X = _x(4 * 256, cuda, seed=3).view(4, 256)
    k1, k3 = kpk.packsell_spmv_fused.launches, kpk.packsell_spmm_fused.launches
    y, Y = lin(x), lin(X)
    assert (kpk.packsell_spmv_fused.launches - k1,
            kpk.packsell_spmm_fused.launches - k3) == (1, 1)
    _bits_equal(y, plain.spmv(lin.mat, x))
    _bits_equal(Y.contiguous(), plain.spmm(lin.mat, X.T).T.contiguous())
    for i in range(4):
        np.testing.assert_allclose(Y[i].cpu().numpy(),
                                   lin(X[i]).cpu().numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_idle_slot_runs_past_max_len(cuda):
    """An idle slot's ``len`` passes ``max_len`` on the card: the KV write
    drops, nothing raises, and the tokens are the eager loop's."""
    reqs = [(np.arange(1, 13, dtype=np.int32), 3),
            (np.arange(5, 7, dtype=np.int32), 14)]
    outs = []
    for eager in (False, True):
        _, e = _lm(cuda, slots=2, max_len=16)
        for p, k in reqs:
            e.submit(p, k)
        with graphs.eager() if eager else contextlib.nullcontext():
            e.run()
        torch.cuda.synchronize()
        assert int(e.cache["len"][0]) > 16
        outs.append([r.out_tokens for r in e.done])
    assert outs[0] == outs[1]


def _lm_one_copy(cuda, arch, **kw):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import DecodeEngine, ServeConfig

    cfg = dataclasses.replace(configs.reduce(configs.get(arch)),
                              dtype="bfloat16")
    params = tfm.init_params(cfg, 0, device=cuda, dtype=cfg.dtype)
    return cfg, DecodeEngine(cfg, params, ServeConfig(**kw), device=cuda)


def test_params_in_the_compute_dtype_are_not_copied(cuda):
    """``DecodeEngine(device="cuda")`` keeps parameters drawn straight
    into the compute dtype on ``cuda:0``: no second copy."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import DecodeEngine, ServeConfig

    cfg = dataclasses.replace(configs.reduce(configs.get("qwen2-moe-a2.7b")),
                              dtype="bfloat16")
    params = tfm.init_params(cfg, 0, device=cuda, dtype=cfg.dtype)
    assert params.device == torch.device("cuda", 0)
    eng = DecodeEngine(cfg, params, ServeConfig(slots=1, max_len=8),
                       device=cuda)
    assert eng.params is params
    assert tfm.cast_params(params, cfg.dtype, device="cuda:0") is params


def test_moe_tick_captured_and_sync_free(cuda):
    cfg, eng = _lm_one_copy(cuda, "qwen2-moe-a2.7b", slots=3, max_len=32)
    eng.warmup()
    assert eng._decode.graph is not None
    rng = np.random.default_rng(1)
    for n in (5, 9, 3):
        eng.submit(rng.integers(1, cfg.vocab, size=n), 10)
    for _ in range(3):
        eng.step()
    eng.tokens.copy_(torch.from_numpy(eng.last_token[:, None]))
    saved = eng.state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg = eng._decode().clone()
        after = eng.state()
        eng.set_state(saved)
        with graphs.eager():
            le = eng._decode().clone()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _bits_equal(lg, le)
    for k, v in eng.state().items():
        assert torch.equal(v, after[k]), k
    eng.set_state(saved)
    eng.run()
    assert all(len(r.out_tokens) == 10 for r in eng.done)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_tick_captured_and_sync_free(cuda, arch):
    """The ssm and hybrid decode ticks (Mamba2's conv and SSM updates
    written into the cache, the hybrid's shared attention block): a graph
    tick and an eager tick, both under ``set_sync_debug_mode("error")``,
    equal bit for bit, logits and every cache buffer; a prompt of 37
    tokens prefills three SSD chunks."""
    cfg, eng = _lm_one_copy(cuda, arch, slots=3, max_len=64)
    eng.warmup()
    assert eng._decode.graph is not None
    rng = np.random.default_rng(2)
    for n in (5, 37, 2):
        eng.submit(rng.integers(1, cfg.vocab, size=n), 10)
    for _ in range(3):
        eng.step()
    eng.tokens.copy_(torch.from_numpy(eng.last_token[:, None]))
    saved = eng.state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg = eng._decode().clone()
        after = eng.state()
        eng.set_state(saved)
        with graphs.eager():
            le = eng._decode().clone()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _bits_equal(lg, le)
    for k, v in eng.state().items():
        assert torch.equal(v, after[k]), k
    assert not torch.equal(after["ssm"], saved["ssm"])
    eng.set_state(saved)
    eng.run()
    assert all(len(r.out_tokens) == 10 for r in eng.done)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-moe-a2.7b"])
def test_out_of_range_prompt_keeps_the_context(cuda, arch):
    cfg, eng = _lm_one_copy(cuda, arch, slots=2, max_len=24)
    V = cfg.vocab_padded
    bad = [eng.submit(np.array([5, V, 7], np.int32), 3),
           eng.submit(np.array([-V - 1, 2, -1], np.int32), 3)]
    good = eng.submit(np.arange(1, 6, dtype=np.int32), 4)
    eng.run()
    torch.cuda.synchronize()
    assert [len(r.out_tokens) for r in bad + [good]] == [3, 3, 4]
    assert float(torch.ones(3, device=cuda).sum()) == 3.0
    # the same schedule with valid prompts: the good request's slot and
    # ticks are the same, only the other slot's rows differ
    _, clean = _lm_one_copy(cuda, arch, slots=2, max_len=24)
    clean.submit(np.array([5, 6, 7], np.int32), 3)
    clean.submit(np.array([8, 2, 9], np.int32), 3)
    clean.submit(np.arange(1, 6, dtype=np.int32), 4)
    clean.run()
    assert clean.done[-1].out_tokens == good.out_tokens


@pytest.mark.parametrize("Se", [8, 1100])
def test_encdec_step_captured_and_sync_free(cuda, Se):
    """The encdec decode step in bf16 as one CUDA graph over a static
    token and cache (``forward_decode``; the engine does not serve the
    family): a graph step and an eager step, both under
    ``set_sync_debug_mode("error")``, equal bit for bit, logits and every
    cache buffer; ``ek``/``ev`` stay as the prefill wrote them and ``len``
    advances in every row. At 1,100 frames the cross-attention's second
    KV chunk holds 76 valid rows of 1,024."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import io_spec
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(
        configs.reduce(configs.get("seamless-m4t-large-v2")),
        dtype="bfloat16")
    params = tfm.init_params(cfg, 0, device=cuda, dtype=cfg.dtype)
    g = torch.Generator(device=cuda)
    g.manual_seed(Se)
    frames = torch.randn((3, Se, io_spec.STUB_DIM), generator=g,
                         device=cuda).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (3, 7), generator=g, device=cuda,
                         dtype=torch.int32)
    logits, cache = tfm.forward_prefill(
        cfg, params, {"tokens": toks, "frames": frames}, 32)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None].contiguous()
    step = graphs.Graph(
        lambda: tfm.forward_decode(cfg, params, tok, cache)[0], cuda)
    saved = {k: v.clone() for k, v in cache.items()}

    def restore():
        for k, v in cache.items():
            v.copy_(saved[k])

    step()                                  # warm up and capture
    assert step.graph is not None
    restore()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg = step().clone()
        after = {k: v.clone() for k, v in cache.items()}
        restore()
        with graphs.eager():
            le = step().clone()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _bits_equal(lg, le)
    for k, v in cache.items():
        assert torch.equal(v, after[k]), k
    for k in ("ek", "ev"):
        assert torch.equal(after[k], saved[k]), k
    assert torch.equal(after["len"], saved["len"] + 1)
    assert bool(torch.isfinite(lg[..., :cfg.vocab]).all())


# -- the training side ---------------------------------------------------------

TRAIN_FAMILIES = ("qwen2-0.5b", "qwen2-moe-a2.7b", "llava-next-mistral-7b",
                  "mamba2-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2")


def _train_batch(cfg, dev, B=2, S=40, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "mask": np.ones((B, S), np.float32)}
    if cfg.frontend == "vision_stub":
        b["patches"] = rng.standard_normal((B, 6, 1024)).astype(np.float32)
    if cfg.frontend == "audio_stub":
        b["frames"] = rng.standard_normal((B, 12, 1024)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced float32 training step on the card against the same step
    on the CPU: the loss within 1e-5 and every gradient within 3e-5 of
    its largest |value| (float32 sums in other orders; no TF32: torch's
    default); the card's gradients repeat bit for bit (the embedding's
    backward sums in one order); a full step with AdamW leaves a finite
    master."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import OptConfig, init_state

    cfg = configs.reduce(configs.get(arch))
    host = init_state(tfm.init_params(cfg, 0, device="cpu"))
    card = init_state(tfm.cast_params(host.master, torch.float32,
                                      device=cuda))
    lc, gc = steps.value_and_grad(cfg, host.master,
                                  _train_batch(cfg, "cpu"))
    lg, gg = steps.value_and_grad(cfg, card.master, _train_batch(cfg, cuda))
    np.testing.assert_allclose(lg.item(), lc.item(), rtol=1e-5)
    for a, b in zip(gg, gc):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a.cpu() - b).abs().max()) / scale <= 3e-5
    _, again = steps.value_and_grad(cfg, card.master, _train_batch(cfg, cuda))
    for a, b in zip(gg, again):
        _bits_equal(a, b)
    step = steps.make_train_step(cfg, OptConfig(warmup=1, total_steps=4))
    card, m = step(card, _train_batch(cfg, cuda))
    assert int(card.step) == 1 and torch.isfinite(m["loss"])
    assert all(bool(torch.isfinite(p).all()) for p in card.master.parameters())


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_dryrun_cell_on_the_card_counts_its_meta_trace(cuda, arch, kind):
    """A reduced dry-run cell run for real on the card: the same aten rows
    (op, call site, count, FLOPs, bytes) as its trace on meta, FLOPs
    equal to ``FlopCounterMode``'s on the card, the step's time and the
    temporary bytes measured."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.models.config import ShapeConfig

    cfg = configs.reduce(configs.get(arch))
    shape = ShapeConfig(f"{kind}_test", 64, 2, kind)
    rec = dryrun.run_cell(arch, shape.name, run=True, device=cuda, cfg=cfg,
                          shape=shape)
    assert rec["status"] == "ok", rec.get("traceback")
    run = rec["run"]
    assert run["fits"] and run["device"] == torch.cuda.get_device_name(0)
    assert run["flops"] == run["flop_counter"] == rec["cost"]["flops"]
    assert run["bytes"] == rec["cost"]["counted_unfused_bytes"]
    assert len(run["step_ms_each"]) == dryrun.STEP_REPS    # a short step
    assert run["step_ms"] > 0 and run["measured_roofline_fraction"] > 0
    assert run["host_bound"] == \
        (run["host_ms"] >= dryrun.HOST_BOUND_SHARE * run["step_ms"])
    assert isinstance(rec["memory_analysis"]["temp_size_in_bytes"], int)
    rows = []
    for dev in ("meta", cuda):
        step, args, _ = dryrun._lower_cell(cfg, shape, device=dev)
        with FlopCounterMode(display=False) as fc:
            _, oc = op_cost.count(step, *args)
        assert oc.totals()["flops"] == fc.get_total_flops()
        rows.append(oc.records())
    assert rows[0] == rows[1]


def test_stream_probe_within_band_of_hbm3(cuda):
    """The STREAM triad on the card over arrays 16 times the L2 reads
    within [0.5, 1.05] of the H100's 3.35 TB/s."""
    from repro_torch.launch import roofline as rl

    bw = rl.stream_probe_bandwidth(device=cuda)
    assert 0.5 <= bw / rl.HW["hbm_bw"] <= 1.05, bw


def _nccl_rank_solve(mesh):
    """One NCCL rank: ``jacobi_pcg_dist`` on ``_spd_system`` eagerly and
    through the graphs (the capture, then a replay), the collectives
    inside the captured loop."""
    from repro_torch.distributed import build_dist_plan

    s, b = _spd_system()
    plan = build_dist_plan(s, mesh=mesh, C=32, sigma=64, codec="fp16", D=15)
    bd = torch.from_numpy(b).to(mesh.device)
    with graphs.eager():
        xe, ie = cg.jacobi_pcg_dist(plan, s.diagonal(), bd, tol=1e-8,
                                    maxiter=300)
    runs = [cg.jacobi_pcg_dist(plan, s.diagonal(), bd, tol=1e-8,
                               maxiter=300) for _ in range(2)]
    return ((xe.cpu().numpy(), ie.iters),
            [(x.cpu().numpy(), i.iters, float(i.relres)) for x, i in runs])


def test_nccl_one_rank_captures_the_solve(cuda):
    """One NCCL rank on the card (``parallel.launch.spawn_ranks``): the
    graphs of ``jacobi_pcg_dist`` capture its NCCL collectives, and the
    capture and a replay equal the eager loop bit for bit."""
    from repro_torch.parallel.launch import spawn_ranks

    (xe, ie), runs = spawn_ranks(_nccl_rank_solve, 1, backend="nccl",
                                 timeout=120)[0]
    for x, iters, relres in runs:
        assert iters == ie and relres < 1e-8
        np.testing.assert_array_equal(x, xe)


# -- the training data axis across processes ---------------------------------

#: the data-axis runs on the card: (pods, data, TrainerConfig keywords)
DP_RUNS = {"plain": (1, 2, {}), "comp": (1, 2, {"grad_compression": 10}),
           "u16": (2, 1, {"pod_wire": "u16"}),
           "u8": (2, 1, {"pod_wire": "u8"})}


def _dp_trainer(key, mesh, root):
    from repro_torch import configs
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer, TrainerConfig

    pods, data, kw = DP_RUNS[key]
    tcfg = TrainerConfig(steps=2, ckpt_dir=f"{root}/{key}", ckpt_every=100,
                         seq_len=32, global_batch=8, data_axis=data,
                         pods=pods, **kw)
    return Trainer(configs.reduce(configs.get("qwen2-0.5b")),
                   OptConfig(warmup=1, total_steps=2), tcfg, mesh=mesh,
                   log_fn=lambda _: None)


def _dp_rank_runs(mesh, root):
    """Every run of ``DP_RUNS`` on this rank: losses and the master."""
    from repro_torch.launch.mesh import make_debug_mesh

    out = {}
    for key, (pods, data, _) in DP_RUNS.items():
        t = _dp_trainer(key, make_debug_mesh(data=data, pods=pods,
                                             device=mesh.device), root)
        s = t.run()
        out[key] = ([h["loss"] for h in t.history],
                    [p.detach().cpu() for p in s.master.parameters()])
    return out


def test_data_axis_ranks_sharing_the_card_match_the_stacked_form(
        cuda, tmp_path):
    """Two gloo ranks sharing the card (every collective staged through
    the host): the plain, compressed and pod-wire (u16, u8) data-parallel
    steps of reduced qwen2-0.5b equal the stacked form on the card (both
    shards in this process) bit for bit."""
    from repro_torch.launch.mesh import make_stacked_mesh
    from repro_torch.parallel.launch import spawn_ranks

    ranks = spawn_ranks(_dp_rank_runs, 2, backend="gloo", device=cuda,
                        timeout=300, args=(str(tmp_path / "ranks"),))
    for key, (pods, data, _) in DP_RUNS.items():
        t = _dp_trainer(key, make_stacked_mesh(data=data, pods=pods,
                                               device=cuda),
                        str(tmp_path / "stacked"))
        s = t.run()
        for losses, master in (r[key] for r in ranks):
            assert losses == [h["loss"] for h in t.history], key
            for a, b in zip(master, s.master.parameters()):
                _bits_equal(a, b.detach().cpu())


def test_wire_codec_on_the_card_matches_the_cpu(cuda):
    """``compressed_wire_reduce`` over two pods (the stacked form) gives
    the CPU's bits on the card, for both wires: the codecs are integer and
    element-wise, the sums in rank order."""
    from repro_torch.launch.mesh import make_stacked_mesh
    from repro_torch.optim.compression import compressed_wire_reduce

    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal((37, 129)).astype(np.float32))
          for _ in range(2)]
    for wire in ("u16", "u8"):
        host = compressed_wire_reduce(xs, make_stacked_mesh(
            pods=2, device="cpu"), "pod", wire)
        card = compressed_wire_reduce([x.to(cuda) for x in xs],
                                      make_stacked_mesh(pods=2, device=cuda),
                                      "pod", wire)
        for a, b in zip(card, host):
            _bits_equal(a.cpu(), b)
