"""repro_torch formats against the reference, on the CPU: PackSELL and
SELL leaves, memory_stats and decode_to_dense byte for byte, the parameter
carry-over (``from_arrays``), the test-matrix generators, the plain scan
SpMV bodies, the package's isolation from JAX and its GPU-by-default
device rule. K2 is in ``test_torch_sell_kernel.py``."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import packsell as rpk
from repro.core import sell as rsl
from repro.core import testmats as rtm
from repro.kernels import ref as rref
from repro_torch.core import codecs as tcd
from repro_torch.core import packsell as tpk
from repro_torch.core import sell as tsl
from repro_torch.core import testmats as ttm
from repro_torch.kernels import ref as tref
from test_torch_plan import _int_values, _int_x

SUITE = rtm.suite("tiny")
CODECS = (("fp16", 15), ("bf16", 15), ("e8m", 8), ("e8m", 15),
          ("fixed12", 15))
SRC = Path(__file__).resolve().parents[1] / "src"


def _assert_packsell_equal(t, r):
    assert len(t.packs) == len(r.packs)
    for pt, pr in zip(t.packs, r.packs):
        np.testing.assert_array_equal(tcd.words_to_numpy(pt), np.asarray(pr))
    for name in ("d0s", "outrows", "maxcols"):
        for lt, lr in zip(getattr(t, name), getattr(r, name)):
            assert lt.dtype == torch.int32
            np.testing.assert_array_equal(lt.numpy(), np.asarray(lr))
    np.testing.assert_array_equal(t.perm.numpy(), np.asarray(r.perm))
    assert t.perm.numpy().dtype == np.asarray(r.perm).dtype
    for f in rpk.PackSELLMatrix._STATIC:
        assert getattr(t, f) == getattr(r, f), f


@pytest.mark.parametrize("klass", sorted(SUITE))
def test_testmats_identical(klass):
    t = ttm.suite("tiny")[klass]
    r = SUITE[klass]
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(t, f), getattr(r, f))
    assert t.shape == r.shape


def test_testmats_generators_identical():
    for args, fn in ((((6, 5, 4),), "hpcg"), (((6, 5, 4),), "hpgmp"),
                     (((300, 20, 5),), "random_banded"),
                     (((200,), ), "scattered"), (((200,),), "powerlaw"),
                     (((100, 3),), "stencil_1d")):
        a = getattr(ttm, fn)(*args[0], seed=3)
        b = getattr(rtm, fn)(*args[0], seed=3)
        assert (a != b).nnz == 0 and a.shape == b.shape
        np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", CODECS)
def test_packsell_from_csr_byte_equal(klass, codec, D):
    a = SUITE[klass]
    r = rpk.from_csr(a, C=8, sigma=32, D=D, codec=codec)
    t = tpk.from_csr(a, C=8, sigma=32, D=D, codec=codec, device="cpu")
    _assert_packsell_equal(t, r)
    assert t.memory_stats() == r.memory_stats()
    np.testing.assert_array_equal(tpk.decode_to_dense(t),
                                  rpk.decode_to_dense(r))


@pytest.mark.parametrize("strategy", ["pow2", "uniform", "exact"])
def test_packsell_bucket_strategies_byte_equal(strategy):
    for klass in ("powerlaw", "scattered"):
        a = SUITE[klass]
        r = rpk.from_csr(a, C=16, sigma=64, D=6, codec="fp16",
                         bucket_strategy=strategy)
        t = tpk.from_csr(a, C=16, sigma=64, D=6, codec="fp16",
                         bucket_strategy=strategy, device="cpu")
        _assert_packsell_equal(t, r)
        assert t.memory_stats() == r.memory_stats()


def test_packsell_dummy_chains_and_errors():
    n, m = 8, 1_000_001
    rows = np.repeat(np.arange(n), 3)
    cols = np.tile([0, 65_537, 999_999], n)
    a = sp.csr_matrix((np.tile([1.0, 2.0, 3.0], n), (rows, cols)),
                      shape=(n, m))
    for D, codec in ((1, "e8m"), (8, "e8m"), (15, "fp16"), (22, "e8m")):
        r = rpk.from_csr(a, C=4, sigma=8, D=D, codec=codec)
        t = tpk.from_csr(a, C=4, sigma=8, D=D, codec=codec, device="cpu")
        _assert_packsell_equal(t, r)
    bad = sp.csr_matrix(np.array([[np.inf, 1.0]]))
    with pytest.raises(ValueError, match="non-finite"):
        tpk.from_csr(bad, C=1, sigma=1, device="cpu")
    with pytest.raises(ValueError, match="multiple of C"):
        tpk.from_csr(a, C=4, sigma=6, device="cpu")


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("vdt", ["float16", "bfloat16", "float32", "float64"])
def test_sell_from_csr_byte_equal(klass, vdt):
    a = SUITE[klass]
    r = rsl.from_csr(a, C=8, sigma=32, value_dtype=vdt)
    t = tsl.from_csr(a, C=8, sigma=32, value_dtype=vdt, device="cpu")
    for vt, vr in zip(t.vals, r.vals):
        np.testing.assert_array_equal(vt.view(torch.uint8).numpy(),
                                      np.asarray(vr).view(np.uint8))
    for ct, cr in zip(t.cols, r.cols):
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cr))
    for ot, orr in zip(t.outrows, r.outrows):
        np.testing.assert_array_equal(ot.numpy(), np.asarray(orr))
    assert t.memory_stats() == r.memory_stats()
    for f in rsl.SELLMatrix._STATIC:
        assert getattr(t, f) == getattr(r, f), f


@pytest.mark.parametrize("klass", sorted(SUITE))
def test_from_arrays_carry_over(klass):
    """The reference matrix's leaves, carried over, equal the port's own
    from_csr — for PackSELL and SELL."""
    a = SUITE[klass]
    r = rpk.from_csr(a, C=8, sigma=32, D=8, codec="e8m")
    leaves, aux = r.tree_flatten()
    leaves = jax.tree_util.tree_map(np.asarray, leaves)
    t = tpk.from_arrays(leaves, dict(zip(r._STATIC, aux)), device="cpu")
    own = tpk.from_csr(a, C=8, sigma=32, D=8, codec="e8m", device="cpu")
    _assert_packsell_equal(t, r)
    _assert_packsell_equal(own, r)
    for vdt in ("bfloat16", "float64"):
        rs = rsl.from_csr(a, C=8, sigma=32, value_dtype=vdt)
        leaves, aux = rs.tree_flatten()
        leaves = jax.tree_util.tree_map(np.asarray, leaves)
        ts = tsl.from_arrays(leaves, dict(zip(rs._STATIC, aux)), device="cpu")
        own = tsl.from_csr(a, C=8, sigma=32, value_dtype=vdt, device="cpu")
        for v1, v2 in zip(ts.vals, own.vals):
            assert v1.dtype == v2.dtype
            assert torch.equal(v1.view(torch.uint8), v2.view(torch.uint8))
        for c1, c2 in zip(ts.cols, own.cols):
            assert torch.equal(c1, c2)
        assert ts.memory_stats() == own.memory_stats()


@pytest.mark.parametrize("codec,D", CODECS)
def test_scan_spmv_spmm_bit_equal_on_integer_data(codec, D):
    """The plain scan bodies against the reference's jnp scan bodies."""
    a = _int_values(SUITE["hpcg_mini"])
    r = rpk.from_csr(a, C=8, sigma=32, D=D, codec=codec)
    t = tpk.from_csr(a, C=8, sigma=32, D=D, codec=codec, device="cpu")
    x = _int_x(a.shape[1])
    np.testing.assert_array_equal(
        tpk.packsell_spmv_torch(t, torch.from_numpy(x)).numpy(),
        np.asarray(rpk.packsell_spmv_jnp(r, jnp.asarray(x))))
    X = _int_x(a.shape[1], seed=2, nb=3)
    np.testing.assert_array_equal(
        tpk.packsell_spmm_torch(t, torch.from_numpy(X)).numpy(),
        np.asarray(rpk.packsell_spmm_jnp(r, jnp.asarray(X))))


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", CODECS)
def test_scan_spmv_equals_reference_dense_on_integer_data(klass, codec, D):
    """Every class × codec: the plain scan body (the port's oracle
    ``ref.packsell_spmv_ref``) equals the reference's float64 dense
    oracle (exact on integer data), and the two dense oracles agree."""
    a = _int_values(SUITE[klass])
    r = rpk.from_csr(a, C=8, sigma=32, D=D, codec=codec)
    t = tpk.from_csr(a, C=8, sigma=32, D=D, codec=codec, device="cpu")
    x = _int_x(a.shape[1])
    want = rref.packsell_spmv_dense_oracle(r, x)
    np.testing.assert_array_equal(tref.packsell_spmv_dense_oracle(t, x), want)
    np.testing.assert_array_equal(
        tref.packsell_spmv_ref(t, torch.from_numpy(x)).numpy(),
        want.astype(np.float32))


@pytest.mark.parametrize("klass", sorted(SUITE))
def test_scan_spmv_real_values_rtol(klass):
    a = SUITE[klass]
    r = rpk.from_csr(a, C=8, sigma=32, D=15, codec="fp16")
    t = tpk.from_csr(a, C=8, sigma=32, D=15, codec="fp16", device="cpu")
    x = np.random.default_rng(5).standard_normal(a.shape[1]).astype(
        np.float32)
    want = rpk.decode_to_dense(r) @ x.astype(np.float64)
    got = tpk.packsell_spmv_torch(t, torch.from_numpy(x)).numpy()
    # float32 sums in another order: rtol 1e-6 of the largest |y|
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_package_imports_no_jax_and_no_repro():
    """A fresh interpreter imports repro_torch and every submodule without
    loading JAX or any module of the reference package; the walk reaches
    the recorder (``observe``) and the front end (``serving``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "need = ['repro_torch.observe.' + m for m in ('metrics', 'export', "
        "'profile')] + ['repro_torch.serving.' + m for m in ('policy', "
        "'frontend')]\n"
        "assert all(k in sys.modules for k in need), need\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_entry_points_default_to_the_gpu(monkeypatch):
    """Without ``device=`` an entry point means CUDA: with no CUDA device
    it raises instead of running on the CPU."""
    a = SUITE["hpcg_mini"]
    if torch.cuda.is_available():       # decide here: simulate its absence
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpk.from_csr(a, C=8, sigma=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsl.from_csr(a, C=8, sigma=32)
    from repro_torch.solvers.operators import OperatorSet
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OperatorSet(a)
    # an explicit CPU request runs the plain bodies
    assert tpk.from_csr(a, C=8, sigma=32, device="cpu").device.type == "cpu"
