"""K6 of repro_torch against the reference, on the CPU, and the per-bucket
kernels on real data.

* K6's plain version (the band-windowed SpMV), in both bodies, on
  uniform-bucket matrices at the smallest feasible half-window, through
  plans forced to ``band``: bit for bit against the reference's Pallas K6
  in interpret mode on integer data, and bit for bit against the port's
  own ``full`` plan (K4), which reads the same columns;
* K4, K5 and K6 on real values and x: within rtol 1e-6;
* the PAD-word trap, where K4 (clamp to m - 1) and K6 (zero-padded
  window) read differently.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.kernels import plan as rpl
from repro_torch.kernels import plan as tpl
from test_torch_bucket_kernels import SUITE, WB, _pair, _port, _x, ref  # noqa: F401


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", [("fp16", 15), ("e8m", 12), ("e8m", 8),
                                     ("e8m", 4)])
@pytest.mark.parametrize("mode", ["checkpoint", "0"])
def test_k6_plain_bit_equal_reference(ref, klass, codec, D, mode):
    """K6 on uniform buckets at the smallest feasible half-window, and, in
    the carry body, its plan's spmm (the full-x K5, as the reference's band
    plan does)."""
    y = ref(klass, codec, D, "band", mode)
    r, t, tp, rp = _port(klass, codec, D, "band", mode)
    assert tp.variant == rp.variant == "band"
    for wt, wr in zip(tp.wins, rp.wins):
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wr))
    x = torch.from_numpy(_x(r.m, "int"))
    np.testing.assert_array_equal(tp.spmv(t, x).numpy(), y)
    if mode == "0":
        np.testing.assert_array_equal(
            tp.spmm(t, torch.from_numpy(_x(r.m, "int", nb=3))).numpy(),
            ref(klass, codec, D, "band", mode, out="Y"))
    # K6 and K4 read the same columns: on finite x the plans agree exactly
    full = tpl.build_plan(t, force="full", decode_cache=mode, wb=WB)
    np.testing.assert_array_equal(full.spmv(t, x).numpy(),
                                  tp.spmv(t, x).numpy())


@pytest.mark.parametrize("variant", ["full", "band"])
@pytest.mark.parametrize("codec,D", [("fp16", 15), ("e8m", 12), ("e8m", 1)])
@pytest.mark.parametrize("mode", ["checkpoint", "0"])
def test_bucket_kernels_real_data_within_rtol(ref, variant, codec, D, mode):
    """Real values and x: float32 sums in another order than the
    reference's (its width partials go through jnp.sum), so the tolerance
    is float32 rounding: rtol 1e-6 on the output's scale."""
    y = ref("hpcg_mini", codec, D, variant, mode, data="real")
    Y = ref("hpcg_mini", codec, D, variant, mode, data="real", out="Y")
    r, t, tp, _ = _port("hpcg_mini", codec, D, variant, mode, "real")
    got = tp.spmv(t, torch.from_numpy(_x(r.m, "real"))).numpy()
    np.testing.assert_allclose(got, y, rtol=1e-6,
                               atol=1e-6 * np.abs(y).max())
    got = tp.spmm(t, torch.from_numpy(_x(r.m, "real", nb=3))).numpy()
    np.testing.assert_allclose(got, Y, rtol=1e-6,
                               atol=1e-6 * np.abs(Y).max())


def test_band_forced_infeasible_raises_as_reference():
    r, t = _pair(SUITE["scattered"], "e8m", 8)
    with pytest.raises(ValueError, match="band kernel infeasible"):
        rpl.build_plan(r, force="band", hw=128)
    with pytest.raises(ValueError, match="band kernel infeasible"):
        tpl.build_plan(t, force="band", hw=128)


# ---------------------------------------------------------------------------
# parity trap: PAD words past m - 1
# ---------------------------------------------------------------------------


def test_trap_k4_clamps_where_k6_reads_zero_padding():
    """The σ-padding and empty rows of the late slices hold PAD words whose
    cursor lies past m - 1. K4 clamps to x[m - 1] (inf here, so 0 · inf =
    NaN), the jnp scan body's rule; K6 reads the window's zero padding, as
    the reference's K6 does. They differ exactly there."""
    rows = np.repeat(np.arange(8), 3)
    a = sp.csr_matrix((np.arange(1.0, 25.0), (rows, np.tile([0, 2, 4], 8))),
                      shape=(40, 5))
    r, t = _pair(a, "e8m", 12, C=8, sigma=8)
    x = np.array([1, 2, 3, 4, np.inf], np.float32)
    xt = torch.from_numpy(x)
    k4 = tpl.build_plan(t, force="full", decode_cache="0").spmv(t, xt)
    k6 = tpl.build_plan(t, force="band", decode_cache="0", hw=128).spmv(t, xt)
    scan = np.asarray(rpl.build_plan(r, force="jnp", decode_cache="0")
                      .spmv(r, jnp.asarray(x)))
    np.testing.assert_array_equal(k4.numpy(), scan)      # NaN where NaN
    ref6 = np.asarray(rpl.build_plan(r, force="band", decode_cache="0",
                                     hw=128, interpret=True)
                      .spmv(r, jnp.asarray(x)))
    np.testing.assert_array_equal(k6.numpy(), ref6)
    differ = ~((k4 == k6) | (torch.isnan(k4) & torch.isnan(k6)))
    assert differ.any()
    assert torch.isnan(k4[differ]).all() and (k6[differ] == 0).all()
