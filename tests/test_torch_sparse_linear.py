"""repro_torch's PackSELL pruned-weight linear layer against the
reference's, on the CPU.

* ``prune_magnitude`` equal;
* ``from_dense``'s packed words, slice bases, row maps and permutation
  byte-equal to the reference's, for each value codec;
* y of a 1-D call (``plan.spmv``, K1 on the card) and of a batched call
  (``plan.spmm`` on ``flat.T``, K3 on the card) bit-equal to the
  reference's on integer-valued data, and within ``Y_RTOL`` otherwise;
* ``codec="auto"``: the selection plan's ``to_dict()`` equal, and the
  precision store written by either package read back by both;
* ``rebuild``, ``describe``, ``memory_ratio``, ``decode_bytes_per_token``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import sparse_linear as rsl
from repro_torch.models import sparse_linear as tsl

#: float32 y against the reference's: sums in another order
Y_RTOL = 1e-5


def _w(seed, shape=(96, 160), integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        w = rng.integers(-8, 9, shape).astype(np.float32)
        w[w == 0] = 1.0
        return w
    return rng.standard_normal(shape).astype(np.float32)


def _pair(w, **kw):
    return (rsl.PackSELLLinear.from_dense(w, **kw),
            tsl.PackSELLLinear.from_dense(w, device="cpu", **kw))


def _bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if torch.is_tensor(a) else a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


@pytest.mark.parametrize("density", [0.05, 0.3, 0.5, 1.0])
def test_prune_magnitude_equal(density):
    w = _w(0)
    np.testing.assert_array_equal(tsl.prune_magnitude(w, density),
                                  rsl.prune_magnitude(w, density))
    with pytest.raises(ValueError):
        tsl.prune_magnitude(w, 0.0)


@pytest.mark.parametrize("codec,D", [("bf16", 15), ("fp16", 15),
                                     ("e8m", 8), ("e8m", 12)])
def test_words_byte_equal(codec, D):
    r, t = _pair(_w(1), density=0.3, codec=codec, D=D, C=8, sigma=32)
    rm, tm = r.mat, t.mat
    assert (tm.n, tm.m, tm.nnz, tm.codec_name, tm.D) == \
        (rm.n, rm.m, rm.nnz, rm.codec_name, rm.D)
    assert len(tm.packs) == len(rm.packs)
    for leaves in ("packs", "d0s", "outrows", "maxcols"):
        for a, b in zip(getattr(tm, leaves), getattr(rm, leaves)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(tm.perm.numpy(), np.asarray(rm.perm))
    assert t.fingerprint == r.fingerprint


@pytest.mark.parametrize("codec,D", [("bf16", 15), ("fp16", 15),
                                     ("e8m", 8)])
def test_spmv_spmm_bit_equal_on_integers(codec, D):
    """Integer weights and x: every product and sum is exact, so both
    packages give the same bits whatever their order."""
    r, t = _pair(_w(2, integer=True), density=0.4, codec=codec, D=D, C=8,
                 sigma=32)
    rng = np.random.default_rng(2)
    x = rng.integers(-4, 5, 96).astype(np.float32)
    y = t(torch.from_numpy(x))
    assert y.shape == (160,) and y.dtype == torch.float32
    np.testing.assert_array_equal(_bits(y), _bits(r(jnp.asarray(x))))
    for shape in ((4, 96), (2, 3, 96)):
        xb = rng.integers(-4, 5, shape).astype(np.float32)
        yb = t(torch.from_numpy(xb))
        assert yb.shape == shape[:-1] + (160,)
        np.testing.assert_array_equal(_bits(yb.contiguous()),
                                      _bits(r(jnp.asarray(xb))))


def test_spmv_spmm_real_values_within_rtol():
    r, t = _pair(_w(3), density=0.3, codec="bf16", D=15, C=8, sigma=32)
    rng = np.random.default_rng(3)
    for shape in ((96,), (4, 96)):
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(r(jnp.asarray(x)), np.float64)
        got = t(torch.from_numpy(x)).numpy()
        assert np.abs(got - want).max() <= Y_RTOL * np.abs(want).max()
    # the batched call is one SpMM: its columns are the single SpMVs
    xb = torch.from_numpy(rng.standard_normal((3, 96)).astype(np.float32))
    yb = t(xb)
    for i in range(3):
        np.testing.assert_allclose(yb[i].numpy(), t(xb[i]).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_auto_codec_plan_and_store_round_trip(tmp_path):
    w = _w(4, (64, 96))
    kw = dict(density=0.4, codec="auto", error_budget=1e-3, C=8, sigma=32)
    r, t = _pair(w, **kw)
    assert t.precision_plan.to_dict() == r.precision_plan.to_dict()
    assert (t.mat.codec_name, t.mat.D) == (r.mat.codec_name, r.mat.D)
    assert t.describe() == r.describe()
    # a store written by either package is a hit for both
    for first, second in ((rsl, tsl), (tsl, rsl)):
        path = str(tmp_path / f"{first.__name__}.json")
        dev = {} if first is rsl else {"device": "cpu"}
        a = first.PackSELLLinear.from_dense(w, store=path, **kw, **dev)
        dev = {} if second is rsl else {"device": "cpu"}
        b = second.PackSELLLinear.from_dense(w, store=path, **kw, **dev)
        assert (a.from_store, b.from_store) == (False, True)
        assert b.precision_plan.to_dict() == a.precision_plan.to_dict()
        assert (b.mat.codec_name, b.mat.D) == (a.mat.codec_name, a.mat.D)


def test_auto_codec_fp32_fallback_stores_e8m1(caplog):
    """A budget no packed codec meets: the layer stores e8m/D1 and says
    the budget is not met, as the reference's."""
    w = _w(5, (48, 64))
    kw = dict(density=0.5, codec="auto", error_budget=1e-12, C=8, sigma=32)
    r, t = _pair(w, **kw)
    assert (t.mat.codec_name, t.mat.D) == (r.mat.codec_name, r.mat.D) == \
        ("e8m", 1)
    assert t.describe()["budget_met"] is False
    assert t.describe() == r.describe()
    assert "budget is NOT met" in caplog.text


def test_rebuild_describe_and_memory():
    r, t = _pair(_w(6), density=0.3, codec="bf16", D=15, C=8, sigma=32)
    assert t.describe() == r.describe()
    assert t.memory_ratio() == r.memory_ratio()
    assert t.decode_bytes_per_token() == r.decode_bytes_per_token()
    old_plan, old_words = t.plan, [p.clone() for p in t.mat.packs]
    assert t.plan is old_plan            # cached
    new_plan = t.rebuild()
    assert new_plan is not old_plan and new_plan is t.plan
    for a, b in zip(t.mat.packs, old_words):
        assert torch.equal(a, b)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(96)
                         .astype(np.float32))
    np.testing.assert_array_equal(
        _bits(t(x)), _bits(old_plan.spmv(t.mat, x)))
    t._csr = None
    with pytest.raises(RuntimeError, match="no retained CSR"):
        t.rebuild()


def test_warmup_builds_the_plan():
    w = _w(7, (32, 40))
    t = tsl.PackSELLLinear.from_dense(w, density=0.5, C=8, sigma=32,
                                      device="cpu")
    r = rsl.PackSELLLinear.from_dense(w, density=0.5, C=8, sigma=32)
    plan = t.warmup(batch=3)
    assert plan is t.plan and plan.variant == "jnp"
    for a, b in zip(t.mat.packs, r.mat.packs):
        np.testing.assert_array_equal(_bits(a), _bits(b))
