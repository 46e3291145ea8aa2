"""K4 over all buckets in one launch, and K3's launch decision, on the CPU.

* K4's plain version (``packsell_spmv_buckets_plain``) equals the
  per-bucket plain SpMV with its width partials added by
  ``sum_width_partials`` and the buckets concatenated, bit for bit on real
  data, over the tiny suite × e8m/D12, D8, D4, D1 and bf16/D15 × wb in
  {carry, 32, 8}; and it equals a numpy model of the kernel's walk (one row
  per thread, the cursor carried from ``d0`` through every width block,
  block sums from +0 added in wi order), decoded by the reference's
  ``unpack_words_np``. The ``full`` plan's SpMV on integer data equals the
  reference plan's. The table's layout and an empty bucket are checked.
* K3's choice of X loads (16-byte vector loads or scalar loads) over nb
  in {1, 3, 4, 8, 12} (12: two chunks of right-hand sides) and a
  non-16-byte-aligned X view, and its plain version on those X against
  K1's plain version column by column.

The kernels themselves run on the card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codecs as rcd
from repro.core import packsell as rpk
from repro.core import testmats as rtm
from repro.kernels import plan as rpl
from repro_torch.core import codecs as tcd
from repro_torch.core import packsell as tpk
from repro_torch.kernels import packsell_spmv as tkp
from repro_torch.kernels import plan as tpl
from test_torch_plan import INT_SUITE, _int_x

SUITE = rtm.suite("tiny")
CODECS = (("e8m", 12), ("e8m", 8), ("e8m", 4), ("e8m", 1), ("bf16", 15))


def _mat(a, codec, D):
    return tpk.from_csr(a, C=8, sigma=32, D=D, codec=codec, device="cpu")


def _args(mat, wb):
    """(packs, d0s, kckpts, table) of a ``full`` plan's K4 at width block
    ``wb`` (None: the carry body)."""
    tiles = tuple((8, wb or 32) for _ in mat.packs)
    kck = tpl._build_block_checkpoints(mat, tiles) if wb else None
    wbs = [t[1] for t in tiles]
    return (mat.packs, mat.d0s, kck,
            tkp.bucket_table(mat.packs, mat.d0s, kck, wbs))


def _kernel_model(packs, d0s, table, x, codec_name, D, window=None):
    """The bucket kernels' walk in numpy float32: per stored row the cursor
    runs from d0 through all words; each width block's sum starts at +0
    and the row total is block 0, then + block wi. Words decode with the
    reference's unpack. ``x`` [m] (K4, K6) or [m, nb] (K5: each rhs its own
    sums). Columns clamp to [0, m-1]; with ``window = (wins, hw)`` (K6)
    slice s of bucket b reads x[base + clip(cur - base, 0, 2hw-1)], base =
    wins[b][s // sb] * hw, and 0 at and past m."""
    codec = rcd.make_codec(codec_name)
    xs = x if len(x) else np.zeros((1,) + x.shape[1:], np.float32)
    m, tail = len(xs), xs.shape[1:]
    outs = []
    for b, (pack, d0, row) in enumerate(zip(packs, d0s, table.rows.numpy())):
        S, w, C = pack.shape
        wb, nw, sb = row[4], row[5], row[9]
        v, d, _ = rcd.unpack_words_np(tcd.words_to_numpy(pack).reshape(-1),
                                      codec, D)
        v = np.asarray(v, np.float32).reshape((S, w, C) + (1,) * len(tail))
        d = d.astype(np.int64).reshape(S, w, C)
        cur = np.repeat(d0.numpy().astype(np.int64)[:, None], C, axis=1)
        if window is not None:
            wins, hw = window
            base = (np.asarray(wins[b]).astype(np.int64)[np.arange(S) // sb]
                    * hw)[:, None]
        total = np.zeros((S, C) + tail, np.float32)
        for wi in range(nw):
            blk = np.zeros((S, C) + tail, np.float32)
            for j in range(wi * wb, min((wi + 1) * wb, w)):
                cur = cur + d[:, j]
                if window is None:
                    xv = xs[np.clip(cur, 0, m - 1)]
                else:
                    g = base + np.clip(cur - base, 0, 2 * hw - 1)
                    live = (g < m).reshape((S, C) + (1,) * len(tail))
                    xv = np.where(live, xs[np.minimum(g, m - 1)],
                                  np.float32(0))
                blk = blk + v[:, j] * xv
            total = blk if wi == 0 else total + blk
        outs.append(total.reshape((-1,) + tail))
    return (np.concatenate(outs) if outs
            else np.zeros((0,) + tail, np.float32))


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("codec,D", CODECS)
@pytest.mark.parametrize("wb", [None, 32, 8])
def test_k4_plain_equals_per_bucket_sum_and_cat(klass, codec, D, wb):
    mat = _mat(SUITE[klass], codec, D)
    packs, d0s, kck, table = _args(mat, wb)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        mat.m).astype(np.float32))
    kw = dict(codec_name=codec, D=D)
    got = tkp.packsell_spmv_buckets(packs, d0s, kck, table, x, **kw)
    assert got.shape == (table.total,) == (sum(p.shape[0] * p.shape[2]
                                               for p in packs),)
    parts = []
    for b, (pack, d0) in enumerate(zip(packs, d0s)):
        if kck is None:
            t = tkp.packsell_spmv_bucket_plain(pack, d0, x, **kw)
        else:
            t = tkp.sum_width_partials(tkp.packsell_spmv_bucket_plain(
                pack, d0, x, wb=wb, ckpt=kck[b], **kw))
        parts.append(t.reshape(-1))
    want = torch.cat(parts)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    model = _kernel_model(packs, d0s, table, x.numpy(), codec, D)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  model.view(np.int32))
    if kck is not None:
        # the cursor carried from d0 meets every block's checkpoint
        for pack, d0, ck in zip(packs, d0s, kck):
            S, w, C = pack.shape
            _, d, _ = rcd.unpack_words_np(
                tcd.words_to_numpy(pack).reshape(-1), rcd.make_codec(codec),
                D)
            before = np.cumsum(d.astype(np.int64).reshape(S, w, C), axis=1) \
                - d.astype(np.int64).reshape(S, w, C)
            carried = d0.numpy().astype(np.int64)[:, None, None] + before
            np.testing.assert_array_equal(ck.numpy(), carried[:, ::wb])


@pytest.mark.parametrize("klass", sorted(SUITE))
@pytest.mark.parametrize("mode", ["checkpoint", "0"])
def test_full_plan_spmv_matches_reference_per_bucket_path(klass, mode):
    """The plan's one K4 call over all buckets against the reference's
    per-bucket path (its jnp bodies; integer data, so every order of the
    sums gives the same bits), at the default width block."""
    a = INT_SUITE[klass]
    r = rpk.from_csr(a, C=8, sigma=32, D=8, codec="e8m")
    t = _mat(a, "e8m", 8)
    tp = tpl.build_plan(t, force="full", decode_cache=mode)
    assert tp.ktable is not None and tp.ktable.carry == (mode != "checkpoint")
    x = _int_x(r.m)
    want = np.asarray(rpl.build_plan(r, force="jnp", decode_cache="0")
                      .spmv(r, jnp.asarray(x)))
    for permuted in (False, True):
        got = tp.spmv(t, torch.from_numpy(x), permuted=permuted)
        if permuted:
            got = tp.from_stored(got)
        np.testing.assert_array_equal(got.numpy(), want)


def test_bucket_table_layout_and_empty_buckets():
    """One row per bucket with stored rows, in bucket order: addresses, S,
    w, wb, nw, the first output row, the first thread block, the window
    address (0 without windows) and sb; an empty bucket has no row and
    moves no offset, a w = 0 bucket outputs +0."""
    mat = _mat(SUITE["powerlaw"], "e8m", 8)
    C = mat.C
    empty = torch.zeros((0, 4, C), dtype=torch.int32)
    flat = torch.zeros((3, 0, C), dtype=torch.int32)
    packs = [mat.packs[0], empty, flat, *mat.packs[1:]]
    d0s = [mat.d0s[0], torch.zeros(0, dtype=torch.int32),
           torch.zeros(3, dtype=torch.int32), *mat.d0s[1:]]
    wbs = [8] * len(packs)
    real = list(tpl._build_block_checkpoints(mat, ((8, 8),) * len(
        mat.packs)))
    ckpts = [real[0], torch.zeros((0, 1, C), dtype=torch.int32),
             torch.zeros((3, 0, C), dtype=torch.int32), *real[1:]]
    for kck in (None, ckpts):
        table = tkp.bucket_table(packs, d0s, kck, wbs)
        rows = table.rows.numpy()
        assert rows.shape == (len(packs) - 1, 10)
        assert table.win_ptrs is None and (rows[:, 8:] == [0, 8]).all()
        assert table.total == sum(p.shape[0] * C for p in packs)
        out = blk = 0
        kept = [p for p in packs if p.shape[0]]
        for row, pack in zip(rows, kept):
            S, w, _ = pack.shape
            wb, nw = (w, 1) if kck is None else (8, -(-w // 8))
            assert tuple(row[2:8]) == (S, w, wb, nw, out, blk)
            assert row[0] == pack.data_ptr()
            out += S * C
            blk += -(-S * C // 256)
        assert table.blocks == blk
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            mat.m).astype(np.float32))
        y = tkp.packsell_spmv_buckets(packs, d0s, kck, table, x,
                                      codec_name="e8m", D=8)
        model = _kernel_model([p for p in packs if p.shape[0]],
                              [d for p, d in zip(packs, d0s) if p.shape[0]],
                              table, x.numpy(), "e8m", 8)
        np.testing.assert_array_equal(y.numpy().view(np.int32),
                                      model.view(np.int32))
        n0 = mat.packs[0].shape[0] * C
        assert torch.equal(y[n0:n0 + 3 * C], torch.zeros(3 * C))
    none = tkp.bucket_table([], [], None, [])
    assert none.total == 0 and none.blocks == 0
    assert tkp.packsell_spmv_buckets([], [], None, none, torch.ones(4),
                                     codec_name="e8m", D=8).shape == (0,)


# ---------------------------------------------------------------------------
# K3: the launch decision and the chunks of right-hand sides
# ---------------------------------------------------------------------------


def _stream(klass="hpcg_mini"):
    t = _mat(SUITE[klass], "fp16", 15)
    tp = tpl.build_plan(t, force="fused")
    lay = tp.fused_layout
    return tp.fused, dict(codec_name="fp16", D=15, encoding=lay.encoding,
                          scale=lay.scale), t.m


def _misaligned(rng, m, nb):
    """A contiguous [m, nb] float32 view 4 bytes past a 16-byte boundary."""
    base = torch.from_numpy(rng.standard_normal(m * nb + 4).astype(
        np.float32))
    assert base.data_ptr() % 16 == 0
    return base[1:1 + m * nb].view(m, nb)


@pytest.mark.parametrize("nb", [1, 3, 4, 8, 12])
def test_k3_vector_loads_and_plain_per_column(nb):
    """Vector loads need nb % 4 == 0 and a 16-byte aligned X. Each rhs of
    the plain version equals K1's plain version on that column, bit for
    bit, aligned or not."""
    (words, ckpt), kw, m = _stream()
    rng = np.random.default_rng(nb)
    X = torch.from_numpy(rng.standard_normal((m, nb)).astype(np.float32))
    assert X.data_ptr() % 16 == 0
    assert tkp.spmm_vector_loads(X) == (nb % 4 == 0)
    Xm = _misaligned(rng, m, nb)
    assert Xm.is_contiguous() and Xm.data_ptr() % 16 == 4
    assert not tkp.spmm_vector_loads(Xm)
    for XX in (X, Xm):
        part = tkp.packsell_spmm_fused(words, ckpt, XX, **kw)
        assert part.shape == words.shape[::2] + (nb,)
        for b in range(nb):
            col = tkp.packsell_spmv_fused_plain(words, ckpt,
                                                XX[:, b].contiguous(), **kw)
            assert torch.equal(part[..., b].view(torch.int32),
                               col.view(torch.int32))
