"""K1 on every encoding and on real data, and K3, of repro_torch against the
reference, on the CPU: the plain versions of the fused-stream SpMV and
SpMM equal the reference Pallas kernels run in interpret mode and the
reference's jnp fused body, bit for bit on integer data (values and x in
[-8, 8]) and rtol 1e-6 on real data, and the plans built on them give the
reference plan's outputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import testmats as rtm
from repro.kernels import packsell_spmv as rkp
from repro.kernels import plan as rpl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packsell_spmv as tkp
from repro_torch.kernels import plan as tpl
from test_torch_plan import INT_SUITE, _assert_plans_equal, _int_x, _pair

SUITE = rtm.suite("tiny")


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", [("bf16", 15), ("e8m", 12),
                                     ("e8m", 15), ("fixed12", 15)])
def test_k1_plain_every_encoding(klass, codec, D):
    r, t = _pair(INT_SUITE[klass], codec, D)
    rp = rpl.build_plan(r, force="jnp", decode_cache="checkpoint")
    tp = tpl.build_plan(t, force="jnp", decode_cache="checkpoint")
    _assert_plans_equal(tp, rp)
    x = _int_x(r.m)
    np.testing.assert_array_equal(
        tp.spmv(t, torch.from_numpy(x)).numpy(),
        np.asarray(rp.spmv(r, jnp.asarray(x))))


@pytest.mark.parametrize("klass", sorted(SUITE))
def test_k1_plain_real_values_rtol(klass):
    """Real values: the reference's compiled body may contract multiply
    and add, so the sums may differ in the last bits — rtol 1e-6."""
    r, t = _pair(SUITE[klass], "fp16", 15)
    rp = rpl.build_plan(r, force="jnp", decode_cache="checkpoint")
    tp = tpl.build_plan(t, force="fused")
    x = np.random.default_rng(4).standard_normal(r.m).astype(np.float32)
    want = np.asarray(rp.spmv(r, jnp.asarray(x)))
    np.testing.assert_allclose(tp.spmv(t, torch.from_numpy(x)).numpy(),
                               want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nb", [1, 3, 4, 8, 12])
@pytest.mark.parametrize("klass", ["hpcg_mini", "powerlaw"])
def test_k3_plain_bit_equal_reference(nb, klass):
    r, t = _pair(INT_SUITE[klass], "fp16", 15)
    rp = rpl.build_plan(r, force="fused")
    tp = tpl.build_plan(t, force="fused")
    assert tp.variant == "fused"
    X = _int_x(r.m, seed=5, nb=nb)
    lay = tp.fused_layout
    part = tkp.packsell_spmm_fused(tp.fused[0], tp.fused[1],
                                   torch.from_numpy(X), codec_name="fp16",
                                   D=15, encoding=lay.encoding)
    ref_k = rkp.packsell_spmm_fused(rp.fused[0], rp.fused[1],
                                    jnp.asarray(X), codec_name="fp16", D=15,
                                    encoding=lay.encoding, interpret=True)
    ref_j = rpl._fused_part_spmm(rp.fused[0], rp.fused[1], jnp.asarray(X),
                                 r.codec, 15, rp.fused_layout)
    np.testing.assert_array_equal(part.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(part.numpy(), np.asarray(ref_j))
    # the plan's tail and gather over the same partials
    np.testing.assert_array_equal(
        tops.packsell_spmm(t, torch.from_numpy(X), force="fused").numpy(),
        np.asarray(rpl._fused_unpermute2(
            rpl._fused_tail2(ref_k, rp.fused_layout), rp.inv2_cat)))
    np.testing.assert_array_equal(
        tops.packsell_spmm(t, torch.from_numpy(X), force="fused",
                           permuted=True).numpy(),
        np.asarray(rpl._fused_tail(ref_k, rp.fused_layout)))
