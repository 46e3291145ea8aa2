"""K2 of repro_torch against the reference, on the CPU: the plain version
of the SELL bucket kernel, through ``ops.sell_spmv``, equals the reference
Pallas kernel run in interpret mode, bit for bit on integer data (values
and x in [-8, 8]) and rtol 1e-6 on real data; on CPU tensors the wrapper
launches nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sell as rsl
from repro.core import testmats as rtm
from repro.kernels import ops as rops
from repro.kernels import sell_spmv as rsk
from repro_torch.core import sell as tsl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sell_spmv as tsk
from test_torch_plan import _int_values, _int_x

SUITE = rtm.suite("tiny")


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("vdt", ["float16", "bfloat16", "float32", "float64"])
def test_k2_plain_matches_reference_kernel(klass, vdt):
    """K2's plain version (through ``ops.sell_spmv``, one call per bucket)
    against the reference Pallas kernel run in interpret mode: bit for bit
    on integer data."""
    a = _int_values(SUITE[klass])
    r = rsl.from_csr(a, C=8, sigma=32, value_dtype=vdt)
    t = tsl.from_csr(a, C=8, sigma=32, value_dtype=vdt, device="cpu")
    x = _int_x(a.shape[1])
    y_ref = np.asarray(rops.sell_spmv(r, jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(
        tops.sell_spmv(t, torch.from_numpy(x)).numpy(), y_ref)
    np.testing.assert_array_equal(
        tref.sell_spmv_ref(t, torch.from_numpy(x)).numpy(), y_ref)


def test_k2_plain_real_values_rtol():
    """On real values the sums may round differently: rtol 1e-6."""
    a = SUITE["banded"]
    r = rsl.from_csr(a, C=8, sigma=32, value_dtype="float32")
    t = tsl.from_csr(a, C=8, sigma=32, value_dtype="float32", device="cpu")
    x = np.random.default_rng(6).standard_normal(a.shape[1]).astype(
        np.float32)
    (vr, cr), (vt, ct) = (r.vals[0], r.cols[0]), (t.vals[0], t.cols[0])
    want = np.asarray(rsk.sell_spmv_bucket(vr, cr, jnp.asarray(x),
                                           interpret=True))
    got = tsk.sell_spmv_bucket(vt, ct, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_k2_wrapper_counts_no_cpu_launch():
    a = SUITE["hpcg_mini"]
    t = tsl.from_csr(a, C=8, sigma=32, value_dtype="float16", device="cpu")
    before = tsk.sell_spmv_bucket.launches
    tops.sell_spmv(t, torch.ones(a.shape[1]))
    assert tsk.sell_spmv_bucket.launches == before
