"""K1 of repro_torch against the reference, on the CPU, at every checkpoint
width: the plain version of the fused-stream SpMV equals the reference
Pallas kernel run in interpret mode and the reference's jnp fused body,
bit for bit on integer data (values and x in [-8, 8]), and the plans
built on it give the reference plan's outputs. The other encodings, real
data and K3 are in ``test_torch_fused_bodies.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import testmats as rtm
from repro.kernels import packsell_spmv as rkp
from repro.kernels import plan as rpl
from repro_torch.kernels import packsell_spmv as tkp
from repro_torch.kernels import plan as tpl
from test_torch_plan import INT_SUITE, _assert_plans_equal, _int_x, _pair

SUITE = rtm.suite("tiny")


# ---------------------------------------------------------------------------
# K1 / K3 plain versions vs the reference kernels and bodies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", [("fp16", 15), ("e8m", 8)])
@pytest.mark.parametrize("wr", tpl._CKPT_WIDTHS)
def test_k1_plain_bit_equal_reference(klass, codec, D, wr):
    """Every checkpoint width: K1's plain version equals the Pallas kernel
    in interpret mode, and the plan's tail and gather over those partials
    equal the reference's. The jnp fused body is held at wr = 32 (the
    main path's width); e8m/8 demotes at every width to the same
    full-cursor-cache plan, whose outputs are compared at wr = 32."""
    r, t = _pair(INT_SUITE[klass], codec, D)
    rp = rpl.build_plan(r, force="fused", ckpt_wr=wr)
    tp = tpl.build_plan(t, force="fused", ckpt_wr=wr)
    _assert_plans_equal(tp, rp)
    x = _int_x(r.m)
    xt = torch.from_numpy(x)
    if tp.variant != "fused":
        assert "demoted to jnp" in tp.policy and tp.cache_mode == "full"
        if wr == 32:
            for permuted in (False, True):
                np.testing.assert_array_equal(
                    tp.spmv(t, xt, permuted=permuted).numpy(),
                    np.asarray(rp.spmv(r, jnp.asarray(x),
                                       permuted=permuted)))
        return
    lay = tp.fused_layout
    part = tkp.packsell_spmv_fused(
        tp.fused[0], tp.fused[1], xt, codec_name=codec, D=D,
        encoding=lay.encoding, scale=lay.scale)
    ref_k = rkp.packsell_spmv_fused(
        rp.fused[0], rp.fused[1], jnp.asarray(x), codec_name=codec, D=D,
        encoding=lay.encoding, scale=lay.scale, interpret=True)
    np.testing.assert_array_equal(part.numpy(), np.asarray(ref_k))
    if wr == 32:
        ref_j = rpl._fused_part_spmv(rp.fused[0], rp.fused[1],
                                     jnp.asarray(x), r.codec, D,
                                     rp.fused_layout)
        np.testing.assert_array_equal(part.numpy(), np.asarray(ref_j))
    np.testing.assert_array_equal(
        tp.spmv(t, xt).numpy(),
        np.asarray(rpl._fused_unpermute2(
            rpl._fused_tail2(ref_k, rp.fused_layout), rp.inv2_cat)))
    np.testing.assert_array_equal(
        tp.spmv(t, xt, permuted=True).numpy(),
        np.asarray(rpl._fused_tail(ref_k, rp.fused_layout)))
