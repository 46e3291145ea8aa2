"""K5 (SpMM) and K6 (band SpMV) over all buckets in one launch, on the CPU.

* K5's plain version (``packsell_spmm_buckets_plain``) equals the
  per-bucket plain SpMM with its width partials added by
  ``sum_width_partials`` and the buckets concatenated, bit for bit on real
  data, over the tiny suite × e8m/D12, D8, D4, D1 and bf16/D15 × wb in
  {carry, 32, 8} × nb in {1, 3, 4, 8, 12}; it equals a numpy model of the
  kernel's walk (one row per thread, the cursor carried from ``d0``
  through every width block, each rhs's block sums from +0 added in wi
  order), decoded by the reference's ``unpack_words_np``; and its first
  column equals K4's plain version on that column of X.
* K6's plain version (``packsell_spmv_band_buckets_plain``) the same way,
  on uniform buckets at the smallest feasible half-window, with the
  model's window and its zero at and past m; and where x[m - 1] is not
  finite it differs from K4 only past m.
* The ``band`` and ``full`` plans' ``spmm`` and the ``band`` plan's
  ``spmv`` equal the reference plan's on integer data (every order of the
  sums gives the same bits there), in both output orders.
* The table's window address and ``sb`` columns on ``full`` and ``band``
  plans, and with an empty bucket.

The kernels themselves run on the card (``tests/test_torch_gpu.py``).
Real data is standard normal, so the bit-for-bit comparisons are between
versions that add in the same order; no tolerance is needed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import packsell as rpk
from repro.core import testmats as rtm
from repro.kernels import plan as rpl
from repro_torch.core import packsell as tpk
from repro_torch.kernels import packsell_spmv as tkp
from repro_torch.kernels import plan as tpl
from test_torch_all_buckets import CODECS, _kernel_model
from test_torch_plan import INT_SUITE, _int_x

SUITE = rtm.suite("tiny")
NBS = (1, 3, 4, 8, 12)


def _mat(a, codec, D, strategy="pow2"):
    return tpk.from_csr(a, C=8, sigma=32, D=D, codec=codec, device="cpu",
                        bucket_strategy=strategy)


def _smallest_hw(mat, sb=8):
    return next(h for h in range(128, 1 << 20, 128)
                if tpl.band_plan(mat, sb, h) is not None)


def _args(mat, wb, hw=None):
    """(packs, d0s, kckpts, wins, table) at width block ``wb`` (None: the
    carry body), with the band windows at half-window ``hw`` if given."""
    tiles = tuple((8, wb or 32) for _ in mat.packs)
    kck = tpl._build_block_checkpoints(mat, tiles) if wb else None
    wins = (None if hw is None else
            [torch.from_numpy(w) for w in tpl.band_plan(mat, 8, hw)])
    table = tkp.bucket_table(mat.packs, mat.d0s, kck, [t[1] for t in tiles],
                             wins=wins, sbs=[t[0] for t in tiles])
    return mat.packs, mat.d0s, kck, wins, table


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", CODECS)
@pytest.mark.parametrize("wb", [None, 32, 8])
@pytest.mark.parametrize("nb", NBS)
def test_k5_plain_equals_per_bucket_sum_and_cat(klass, codec, D, wb, nb):
    mat = _mat(SUITE[klass], codec, D)
    packs, d0s, kck, _, table = _args(mat, wb)
    X = torch.from_numpy(np.random.default_rng(nb).standard_normal(
        (mat.m, nb)).astype(np.float32))
    kw = dict(codec_name=codec, D=D)
    got = tkp.packsell_spmm_buckets(packs, d0s, kck, table, X, **kw)
    assert got.shape == (table.total, nb)
    parts = []
    for b, (pack, d0) in enumerate(zip(packs, d0s)):
        ck = None if kck is None else kck[b]
        t = tkp.packsell_spmm_bucket_plain(pack, d0, X, wb=wb or 32, ckpt=ck,
                                           **kw)
        parts.append((t if ck is None else tkp.sum_width_partials(t))
                     .reshape(-1, nb))
    np.testing.assert_array_equal(_bits(got), _bits(torch.cat(parts)))
    kept = [i for i, p in enumerate(packs) if p.shape[0] * p.shape[2]]
    model = _kernel_model([packs[i] for i in kept], [d0s[i] for i in kept],
                          table, X.numpy(), codec, D)
    np.testing.assert_array_equal(_bits(got), _bits(model))
    # one rhs of K5 is K4 on that column (phase 5 of chip_smoke.py checks
    # the same on the card)
    col = tkp.packsell_spmv_buckets_plain(packs, d0s, kck, table,
                                          X[:, 0].contiguous(), **kw)
    np.testing.assert_array_equal(_bits(got[:, 0]), _bits(col))


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", CODECS)
@pytest.mark.parametrize("wb", [None, 32, 8])
def test_k6_plain_equals_per_bucket_sum_and_cat(klass, codec, D, wb):
    mat = _mat(SUITE[klass], codec, D, "uniform")
    hw = _smallest_hw(mat)
    packs, d0s, kck, wins, table = _args(mat, wb, hw)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        mat.m).astype(np.float32))
    kw = dict(codec_name=codec, D=D, hw=hw)
    got = tkp.packsell_spmv_band_buckets(packs, d0s, wins, kck, table, x,
                                         **kw)
    assert got.shape == (table.total,)
    parts = []
    for b, (pack, d0) in enumerate(zip(packs, d0s)):
        ck = None if kck is None else kck[b]
        t = tkp.packsell_spmv_band_bucket_plain(pack, d0, wins[b], x, sb=8,
                                                wb=wb or 32, ckpt=ck, **kw)
        parts.append((t if ck is None else tkp.sum_width_partials(t))
                     .reshape(-1))
    np.testing.assert_array_equal(_bits(got), _bits(torch.cat(parts)))
    kept = [i for i, p in enumerate(packs) if p.shape[0] * p.shape[2]]
    model = _kernel_model([packs[i] for i in kept], [d0s[i] for i in kept],
                          table, x.numpy(), codec, D,
                          window=([wins[i].numpy() for i in kept], hw))
    np.testing.assert_array_equal(_bits(got), _bits(model))


@pytest.mark.parametrize("wb", [None, 8])
def test_k6_reads_zero_past_m_where_k4_clamps(wb):
    """The σ-padding rows' PAD words have cursors past m - 1. With x[m - 1]
    = inf, K4 reads it (0 · inf = NaN) where K6 and its model read the
    window's zero: the two differ exactly there."""
    rows = np.repeat(np.arange(8), 3)
    a = sp.csr_matrix((np.arange(1.0, 25.0), (rows, np.tile([0, 2, 4], 8))),
                      shape=(40, 5))
    mat = tpk.from_csr(a, C=8, sigma=8, D=12, codec="e8m", device="cpu")
    packs, d0s, kck, wins, table = _args(mat, wb, 128)
    x = torch.tensor([1, 2, 3, 4, float("inf")])
    kw = dict(codec_name="e8m", D=12)
    k6 = tkp.packsell_spmv_band_buckets(packs, d0s, wins, kck, table, x,
                                        hw=128, **kw)
    kept = [i for i, p in enumerate(packs) if p.shape[0]]
    with np.errstate(invalid="ignore"):     # 0 · inf = NaN, as in K4
        model = _kernel_model([packs[i] for i in kept],
                              [d0s[i] for i in kept], table, x.numpy(),
                              "e8m", 12,
                              window=([wins[i].numpy() for i in kept], 128))
    np.testing.assert_array_equal(k6.numpy(), model)
    k4 = tkp.packsell_spmv_buckets(packs, d0s, kck, table, x, **kw)
    differ = ~((k4 == k6) | (torch.isnan(k4) & torch.isnan(k6)))
    assert differ.any()
    assert torch.isnan(k4[differ]).all() and (k6[differ] == 0).all()


# ---------------------------------------------------------------------------
# the plans against the reference, on integer data
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """The reference's plain plan outputs, each computed once:
    ``ref(klass, strategy, nb)`` → y [n] (nb None) or Y [n, nb]."""
    memo = {}

    def get(klass, strategy, nb=None):
        key = (klass, strategy, nb)
        if key not in memo:
            r = rpk.from_csr(INT_SUITE[klass], C=8, sigma=32, D=8,
                             codec="e8m", bucket_strategy=strategy)
            p = rpl.build_plan(r, force="jnp", decode_cache="0")
            x = jnp.asarray(_int_x(r.m, nb=nb))
            memo[key] = np.asarray(p.spmv(r, x) if nb is None
                                   else p.spmm(r, x))
        return memo[key]

    return get


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("variant,out", [("full", "spmm"), ("band", "spmm"),
                                         ("band", "spmv")])
@pytest.mark.parametrize("mode", ["checkpoint", "0"])
def test_plans_match_reference_on_integer_data(ref, klass, variant, out,
                                               mode):
    strategy = "uniform" if variant == "band" else "pow2"
    t = _mat(INT_SUITE[klass], "e8m", 8, strategy)
    hw = _smallest_hw(t) if variant == "band" else tpl._DEF_HW
    tp = tpl.build_plan(t, force=variant, decode_cache=mode, wb=8, hw=hw)
    assert tp.variant == variant and tp.ktable is not None
    nb = 3 if out == "spmm" else None
    x = torch.from_numpy(_int_x(t.m, nb=nb))
    want = ref(klass, strategy, nb)
    run = tp.spmm if out == "spmm" else tp.spmv
    np.testing.assert_array_equal(run(t, x).numpy(), want)
    np.testing.assert_array_equal(
        tp.from_stored(run(t, x, permuted=True)).numpy(), want)


# ---------------------------------------------------------------------------
# the table's window columns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,sb", [("full", 8), ("band", 8),
                                        ("band", 4)])
def test_plan_table_window_columns(variant, sb):
    """A ``full`` plan's table has no windows (address 0); a ``band``
    plan's holds each bucket's window address and its sb."""
    t = _mat(SUITE["banded"], "e8m", 8, "uniform")
    hw = _smallest_hw(t, sb)
    p = tpl.build_plan(t, force=variant, sb=sb, hw=hw)
    rows = p.ktable.rows.numpy()
    kept = [b for b, q in enumerate(t.packs) if q.shape[0]]
    assert rows.shape == (len(kept), 10)
    assert list(rows[:, 9]) == [sb] * len(kept) and p.ktable.sbs == (sb,) * \
        len(t.packs)
    if variant == "full":
        assert p.wins is None and p.ktable.win_ptrs is None
        assert (rows[:, 8] == 0).all()
    else:
        assert list(rows[:, 8]) == [p.wins[b].data_ptr() for b in kept]
        assert p.ktable.win_ptrs == tuple((w.data_ptr(), w.numel())
                                          for w in p.wins)


def test_table_window_columns_with_an_empty_bucket():
    """An empty bucket (and its empty windows) has no row and moves no
    offset; K6's plain version and the model agree around it; windows
    too short for a bucket's slices raise."""
    mat = _mat(SUITE["hpcg_mini"], "e8m", 8, "uniform")
    hw = _smallest_hw(mat)
    C = mat.C
    wins = [torch.from_numpy(w) for w in tpl.band_plan(mat, 8, hw)]
    packs = [torch.zeros((0, 4, C), dtype=torch.int32), *mat.packs]
    d0s = [torch.zeros(0, dtype=torch.int32), *mat.d0s]
    wins = [torch.zeros(0, dtype=torch.int32), *wins]
    table = tkp.bucket_table(packs, d0s, None, [32] * len(packs), wins=wins,
                             sbs=[8] * len(packs))
    rows = table.rows.numpy()
    assert rows.shape == (len(mat.packs), 10)
    assert list(rows[:, 8]) == [w.data_ptr() for w in wins[1:]]
    assert list(rows[:, 6]) == list(np.cumsum(
        [0] + [q.shape[0] * C for q in mat.packs[:-1]]))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        mat.m).astype(np.float32))
    y = tkp.packsell_spmv_band_buckets(packs, d0s, wins, None, table, x,
                                       codec_name="e8m", D=8, hw=hw)
    model = _kernel_model(packs[1:], d0s[1:], table, x.numpy(), "e8m", 8,
                          window=([w.numpy() for w in wins[1:]], hw))
    np.testing.assert_array_equal(_bits(y), _bits(model))
    with pytest.raises(ValueError, match="windows for"):
        tkp.bucket_table(packs, d0s, None, [32] * len(packs),
                         wins=[w[:0] for w in wins])
