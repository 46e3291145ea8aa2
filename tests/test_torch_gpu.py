"""repro_torch's CUDA kernels against their plain PyTorch versions, on the
card: K1 (fused-stream SpMV) and K3 (its multi-RHS twin) on every stream
encoding and checkpoint width, K2 (SELL) on every value type, bit for bit
over the tiny suite, and a Jacobi-PCG solve through K1 that stops at the
plain body's iteration.

Run on a machine with a CUDA device:

    python -m pytest -m gpu tests/test_torch_gpu.py

Without one every test skips with its reason. The module imports neither
JAX nor ``repro``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import packsell as pk
from repro_torch.core import sell as sl
from repro_torch.core import testmats
from repro_torch.kernels import ops
from repro_torch.kernels import packsell_spmv as kpk
from repro_torch.kernels import plan as kplan
from repro_torch.kernels import sell_spmv as ksl
from repro_torch.solvers import cg
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
    try:
        plan = kplan.build_plan(mat, force="fused")
    except NotImplementedError:
        pytest.skip(f"{codec}/D{D} has no fused stream on {klass}")
    words, ckpt = plan.fused
    lay = plan.fused_layout
    kw = dict(codec_name=codec, D=D, encoding=lay.encoding, scale=lay.scale)
    x = _x(mat.m, cuda)
    before = kpk.packsell_spmv_fused.launches
    _bits_equal(kpk.packsell_spmv_fused(words, ckpt, x, **kw),
                kpk.packsell_spmv_fused_plain(words, ckpt, x, **kw))
    assert kpk.packsell_spmv_fused.launches == before + 1
    for nb in (1, 3, 8):
        X = _x(mat.m, cuda, nb=nb, seed=nb)
        _bits_equal(kpk.packsell_spmm_fused(words, ckpt, X, **kw),
                    kpk.packsell_spmm_fused_plain(words, ckpt, X, **kw))
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


def test_jacobi_pcg_through_k1_matches_plain_iterations(cuda):
    s, _ = sym_scale(testmats.hpcg(12, 12, 12))
    mat, plan = OperatorSet(s, device=cuda).plan_pair("plan_fp16")
    assert plan.variant == "fused"
    b = torch.ones(s.shape[0], dtype=torch.float64, device=cuda)
    before = kpk.packsell_spmv_fused.launches
    x, info = cg.jacobi_pcg_stored(mat, plan, s.diagonal(), b, tol=1e-8,
                                   maxiter=500)
    assert kpk.packsell_spmv_fused.launches - before == info.iters + 1
    assert float(info.relres) < 1e-8
    xp, info_p = cg.jacobi_pcg_stored(mat, kplan.get_plan(mat, force="jnp"),
                                      s.diagonal(), b, tol=1e-8, maxiter=500)
    assert info_p.iters == info.iters
    assert torch.equal(x, xp)
