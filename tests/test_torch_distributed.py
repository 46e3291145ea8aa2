"""repro_torch's distributed layer against the reference, on the CPU.

* the partitioner, the CSR split (a round trip through
  ``assemble_global``), the traffic matrix and the halo maps equal to the
  reference's arrays at P = 1, 2, 3, 4, 8, empty shards and an all-halo
  matrix included;
* ``pad_uniform`` for PackSELL and SELL byte for byte, and
  ``aggregate_memory_stats``;
* ``gather_halo`` in both modes equal to ``gather_halo_reference`` and to
  each other;
* ``build_composite_operands(...).host`` equal key for key and byte for
  byte (one codec, five precision classes, a tier ladder);
* the distributed SpMV and SpMM (P shards of one CPU device) against the
  reference's ``reference_spmv``: bit for bit on integer data, within
  1e-6 of max |y| on N(0, 1) data; ``memory_stats`` at P = 1;
* the shard mesh's rules: a mesh over two devices raises
  ``NotImplementedError``, ``n_shards`` past the device count
  ``ValueError``;
* ``jacobi_pcg_dist`` and ``adaptive_pcg_dist`` at P = 1 against the
  reference's in-process, at P = 4 against the port's single-device
  solvers (the reference's own rules), and against the reference's at
  P = 4 run in a subprocess under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``;
* the ``dist_*`` kinds through ``OperatorSet`` at P = 1, and
  ``corrupt_dist_checkpoint``'s ``detail`` for seeds 0-19.

Each reference output is computed once per module (the ``ref`` cache).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro import distributed as rd
from repro.core import packsell as rpk
from repro.core import sell as rsl
from repro.core import testmats as rtm
from repro.distributed import halo as rdh
from repro.robust import inject as rinj
from repro.solvers import cg as rcg
from repro.solvers import operators as rop
from repro_torch import distributed as td
from repro_torch.core import codecs as tcd
from repro_torch.core import packsell as tpk
from repro_torch.core import sell as tsl
from repro_torch.distributed import halo as tdh
from repro_torch.parallel import ShardMesh, make_shard_mesh
from repro_torch.robust import inject as tinj
from repro_torch.solvers import cg as tcg
from repro_torch.solvers import graphs
from repro_torch.solvers import operators as top

SRC = Path(__file__).resolve().parents[1] / "src"
SHARDS = (1, 2, 3, 4, 8)
CLASSES5 = (("fp16", 15), ("bf16", 12), ("e8m", 8), ("fp32", 0),
            ("fp64", 0))


def _all_halo(n=32):
    """A circulant with every column off its row's half: at P = 2 every
    referenced column is remote and A_loc is empty on both shards."""
    rows = np.arange(n)
    return sp.csr_matrix((np.ones(n), (rows, (rows + n // 2) % n)),
                         shape=(n, n))


def _integer(a, seed=11):
    """``a``'s pattern with integer values in [1, 8]."""
    a = a.tocsr().copy()
    a.data = np.random.default_rng(seed).integers(1, 9, a.nnz).astype(
        np.float64)
    return a


MATRICES = {
    "scattered": lambda: rtm.scattered(150, nnz_per_row=7, spd=True,
                                       seed=6),
    "banded": lambda: rtm.random_banded(200, 30, 6, seed=4),
    "stencil5": lambda: rtm.stencil_1d(5, 1),          # empty shards at 8
    "all_halo": _all_halo,
}


def _classes(n, which):
    if which == "single":
        return [("fp16", 15, None)]
    rows = np.arange(n)
    return [(c, D, rows[rows % len(CLASSES5) == i])
            for i, (c, D) in enumerate(CLASSES5)]


class _Ref:
    """The reference's operands and products, each computed once."""

    def __init__(self):
        self.cache = {}

    def get(self, key, fn):
        if key not in self.cache:
            self.cache[key] = fn()
        return self.cache[key]

    def ops(self, name, P, which, integer=False):
        def build():
            a = MATRICES[name]()
            a = _integer(a) if integer else a
            return a, rd.build_composite_operands(
                a, P, classes=_classes(a.shape[0], which), C=8, sigma=16)
        return self.get(("ops", name, P, which, integer), build)


@pytest.fixture(scope="module")
def ref():
    return _Ref()


def _port_ops(a, P, which):
    return td.build_composite_operands(
        a, P, classes=_classes(a.shape[0], which), C=8, sigma=16,
        device="cpu")


def _x(n, seed=1, integer=False, nb=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if nb is None else (n, nb)
    if integer:
        return rng.integers(-8, 9, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# partition and halo maps (host)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_partition_split_and_maps_equal_reference(name, P):
    a = MATRICES[name]()
    pr, pt = rd.partition_rows(a.shape[0], P), td.partition_rows(
        a.shape[0], P)
    np.testing.assert_array_equal(pt.starts, pr.starts)
    np.testing.assert_array_equal(pt.counts, pr.counts)
    np.testing.assert_array_equal(pt.owner(np.arange(a.shape[0])),
                                  pr.owner(np.arange(a.shape[0])))
    n_pad = max(int(pr.counts.max()), 1)
    sr, hr = rd.split_csr(a, pr, n_pad=n_pad)
    st, ht = td.split_csr(a, pt, n_pad=n_pad)
    assert ht == hr
    for x, y in zip(st, sr):
        np.testing.assert_array_equal(x.halo_cols, y.halo_cols)
        for blk_t, blk_r in ((x.a_loc, y.a_loc), (x.a_rem, y.a_rem)):
            assert (blk_t is None) == (blk_r is None)
            if blk_t is not None:
                assert blk_t.shape == blk_r.shape
                assert (blk_t != blk_r).nnz == 0
    back = td.assemble_global(pt, st, a.shape)
    assert (abs(back - a) > 0).nnz == 0
    np.testing.assert_array_equal(td.comm_matrix(pt, st),
                                  rd.comm_matrix(pr, sr))
    mr = rdh.build_halo_maps(pr, [s.halo_cols for s in sr], n_pad=n_pad,
                             h_pad=hr)
    mt = tdh.build_halo_maps(pt, [s.halo_cols for s in st], n_pad=n_pad,
                             h_pad=ht)
    assert (mt.n_shards, mt.n_pad, mt.h_pad, mt.k_max) == \
        (mr.n_shards, mr.n_pad, mr.h_pad, mr.k_max)
    for f in ("halo_src", "send_idx", "recv_slot", "counts"):
        got, want = getattr(mt, f), getattr(mr, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_partition_rejects_zero_shards():
    with pytest.raises(ValueError):
        td.partition_rows(5, 0)
    with pytest.raises(ValueError, match="square"):
        td.split_csr(sp.csr_matrix(np.ones((2, 3))),
                     td.partition_rows(2, 1), n_pad=2)


@pytest.mark.parametrize("nb", [None, 3])
@pytest.mark.parametrize("P", SHARDS)
def test_gather_halo_modes_equal_the_reference(P, nb):
    """Both exchange modes on a stacked tensor equal the host oracle (the
    reference's, copied), and each other on the valid halo slots; the
    oracle equals the reference's."""
    a = MATRICES["banded"]()
    part = td.partition_rows(a.shape[0], P)
    n_pad = int(part.counts.max())
    splits, h_pad = td.split_csr(a, part, n_pad=n_pad)
    maps = tdh.build_halo_maps(part, [s.halo_cols for s in splits],
                               n_pad=n_pad, h_pad=h_pad)
    rng = np.random.default_rng(P)
    shape = (P, n_pad) + (() if nb is None else (nb,))
    xs = rng.standard_normal(shape).astype(np.float32)
    index = tdh.exchange_index(maps, "cpu")
    got = {}
    for mode in tdh.EXCHANGE_MODES:
        want = tdh.gather_halo_reference(xs, maps, mode)
        np.testing.assert_array_equal(
            want, rdh.gather_halo_reference(xs, maps, mode))
        got[mode] = tdh.gather_halo(torch.from_numpy(xs), index,
                                    n_shards=P, h_pad=h_pad,
                                    mode=mode).numpy()
        np.testing.assert_array_equal(got[mode], want)
    # the modes agree on every shard's own halo slots (past them,
    # 'all_gather' reads the pad source 0 and 'ppermute' leaves 0)
    for p, sp_ in enumerate(splits):
        h = len(sp_.halo_cols)
        np.testing.assert_array_equal(got["ppermute"][p, :h],
                                      got["all_gather"][p, :h])
    with pytest.raises(ValueError, match="not in"):
        tdh.gather_halo(torch.from_numpy(xs), index, n_shards=P,
                        h_pad=max(h_pad, 1), mode="bogus")


# ---------------------------------------------------------------------------
# pad_uniform (core)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec,D", [("fp16", 15), ("e8m", 10),
                                     ("fixed16", 10)])
def test_pad_uniform_packsell_byte_equal(codec, D):
    a = rtm.random_banded(100, 10, 4, seed=5)
    r = rpk.from_csr(a, C=8, sigma=16, D=D, codec=codec,
                     bucket_strategy="uniform", device=False)
    t = tpk.from_csr(a, C=8, sigma=16, D=D, codec=codec,
                     bucket_strategy="uniform", device="cpu")
    S, w, C = r.packs[0].shape
    kw = dict(n_slices=S + 3, width=w + 5, n_rows=(S + 3) * C)
    rp = rpk.pad_uniform(r, device=False, **kw)
    tp = tpk.pad_uniform(t, device=False, **kw)
    np.testing.assert_array_equal(tcd.words_to_numpy(tp.packs[0]),
                                  np.asarray(rp.packs[0]))
    for f in ("d0s", "outrows", "maxcols"):
        np.testing.assert_array_equal(getattr(tp, f)[0].numpy(),
                                      np.asarray(getattr(rp, f)[0]))
    np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(rp.perm))
    for f in rpk.PackSELLMatrix._STATIC:
        assert getattr(tp, f) == getattr(rp, f), f
    assert tp.memory_stats() == rp.memory_stats()
    dense = tpk.decode_to_dense(tp)
    np.testing.assert_array_equal(dense, rpk.decode_to_dense(rp))
    assert not dense[t.n:].any()                  # padding rows stay dead
    with pytest.raises(ValueError, match="shrink"):
        tpk.pad_uniform(t, n_slices=S - 1)
    with pytest.raises(ValueError, match="cannot hold"):
        tpk.pad_uniform(t, n_rows=(S + 3) * C + 1, n_slices=S + 3)


def test_pad_uniform_rows_dead_through_the_gather():
    """Padding rows read exactly 0 through the plan engine's
    inverse-permutation gather (each padding row has its own all-PAD
    stored slot), and the real rows equal the unpadded matrix's."""
    from repro_torch.kernels import plan as tpl

    a = rtm.random_banded(100, 10, 4, seed=5)
    mat = tpk.from_csr(a, C=8, sigma=16, bucket_strategy="uniform",
                       device="cpu")
    S, w, C = mat.packs[0].shape
    padded = tpk.pad_uniform(mat, n_slices=S + 2, width=w + 3,
                             n_rows=(S + 2) * C)
    assert padded.device.type == "cpu"
    x = torch.from_numpy(_x(100, seed=12))
    plan = tpl.get_plan(padded)
    assert plan.inv_cat is not None
    y = plan.spmv(padded, x)
    torch.testing.assert_close(y[:mat.n], tpk.packsell_spmv_torch(mat, x),
                               rtol=1e-6, atol=1e-6)
    assert not y[mat.n:].any()


@pytest.mark.parametrize("vd", ["float32", "float64", "float16",
                                "bfloat16"])
def test_pad_uniform_sell_byte_equal(vd):
    a = rtm.random_banded(100, 10, 4, seed=5)
    r = rsl.from_csr(a, C=8, sigma=16, value_dtype=vd,
                     bucket_strategy="uniform")
    t = tsl.from_csr(a, C=8, sigma=16, value_dtype=vd,
                     bucket_strategy="uniform", device="cpu")
    S, w, C = r.vals[0].shape
    rp = rsl.pad_uniform(r, n_slices=S + 2, width=w + 4, device=False)
    tp = tsl.pad_uniform(t, n_slices=S + 2, width=w + 4, device=False)
    want = np.asarray(rp.vals[0])
    got = tp.vals[0]
    if vd == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tp.cols[0].numpy(), np.asarray(rp.cols[0]))
    np.testing.assert_array_equal(tp.outrows[0].numpy(),
                                  np.asarray(rp.outrows[0]))
    np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(rp.perm))
    assert tp.memory_stats() == rp.memory_stats()
    x = torch.from_numpy(_x(100, seed=2))
    torch.testing.assert_close(tsl.sell_spmv(tp, x), tsl.sell_spmv(t, x))
    with pytest.raises(ValueError, match="shrink"):
        tsl.pad_uniform(t, width=w - 1)


def test_aggregate_memory_stats_equal():
    mats = [(rpk.from_csr(rtm.stencil_1d(80, 2, seed=s), C=8, sigma=16,
                          device=False),
             tpk.from_csr(rtm.stencil_1d(80, 2, seed=s), C=8, sigma=16,
                          device="cpu")) for s in range(3)]
    assert tpk.aggregate_memory_stats([t for _, t in mats]) == \
        rpk.aggregate_memory_stats([r for r, _ in mats])
    assert tpk.aggregate_memory_stats([])["shards"] == 0


# ---------------------------------------------------------------------------
# the stacked operands and the distributed SpMV
# ---------------------------------------------------------------------------


def _host_equal(t_ops, r_ops):
    th, rh = t_ops.host, r_ops.host
    assert sorted(th) == sorted(rh)
    for k in rh:
        assert th[k].dtype == rh[k].dtype, k
        np.testing.assert_array_equal(th[k], rh[k], err_msg=k)
    assert (t_ops.n, t_ops.n_pad, t_ops.h_pad, t_ops.codec, t_ops.D) == \
        (r_ops.n, r_ops.n_pad, r_ops.h_pad, r_ops.codec, r_ops.D)
    assert [m.label for m in t_ops.members] == \
        [m.label for m in r_ops.members]
    for tm, rm in zip(t_ops.members, r_ops.members):
        got, want = tm.host_arrays(), rm.host_arrays()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("which", ["single", "classes5"])
@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name", ["scattered", "stencil5", "all_halo"])
def test_composite_operands_host_equal(ref, name, P, which):
    a, r_ops = ref.ops(name, P, which)
    t_ops = _port_ops(a, P, which)
    _host_equal(t_ops, r_ops)
    assert [m.nnz for m in t_ops.mats_loc] == [m.nnz for m in r_ops.mats_loc]
    assert [m.nnz for m in t_ops.mats_rem] == [m.nnz for m in r_ops.mats_rem]
    if name == "all_halo" and P == 2:
        assert all(m.nnz == 0 for m in t_ops.mats_loc)


@pytest.mark.parametrize("P", SHARDS)
def test_tier_ladder_operands_equal(P):
    """Every tier of a ladder (and the fp64 outer set) over one shared
    partition equals the reference's member set over the same partition
    context."""
    s, _ = rop.sym_scale(rtm.hpcg(6, 6, 6))
    ladder = [("fp16", 15, None), ("e8m", 8, None), ("fp32", 0, None)]
    t = td.build_dist_tiers(s, ladder, mesh=make_shard_mesh(
        P, devices=["cpu"] * P), C=8, sigma=16)
    assert t.labels == ["fp16/D=15", "e8m/D=8", "fp32"]
    np.testing.assert_array_equal(t.sub32, [True, True, False])
    ctx = rd.plan._partition_context(s, P, 8)
    for t_ops, (codec, D, _) in zip(t.tiers + [t.hi],
                                    ladder + [("fp64", 0, None)]):
        r_ops = rd.build_composite_operands(s, P, classes=[(codec, D, None)],
                                            C=8, sigma=16, ctx=ctx)
        _host_equal(t_ops, r_ops)
    assert t.h_pad == t.tiers[0].h_pad
    assert sorted(t.dev["shared"]) == sorted(rd.plan.SHARED_KEYS
                                             + ("index",))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("which", ["single", "classes5"])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_dist_spmv_and_spmm_match_reference_spmv(ref, P, which, integer):
    """The port's distributed product (P shards on the CPU) against the
    reference's ``reference_spmv`` over the same operands: bit for bit on
    integer data, within 1e-6 of max |y| on N(0, 1) data; the port's own
    host replay equals its product bit for bit."""
    a, r_ops = ref.ops("scattered", P, which, integer=integer)
    dp = td.DistSpMVPlan(_port_ops(a, P, which),
                         make_shard_mesh(P, devices=["cpu"] * P))
    n = a.shape[0]
    for nb in (None, 3):
        x = _x(n, seed=7, integer=integer, nb=nb)
        want = ref.get(("spmv", P, which, integer, nb),
                       lambda: rd.reference_spmv(r_ops, x,
                                                 multi_rhs=nb is not None))
        xt = torch.from_numpy(x)
        for mode in tdh.EXCHANGE_MODES:
            got = (dp.spmv(xt, mode=mode) if nb is None
                   else dp.spmm(xt, mode=mode)).numpy()
            np.testing.assert_array_equal(
                got, td.reference_spmv(dp.ops, x, mode,
                                       multi_rhs=nb is not None))
            if integer:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_dist_spmm_columns_equal_spmv():
    a = _integer(MATRICES["banded"]())
    dp = td.build_dist_plan(a, mesh=make_shard_mesh(4, devices=["cpu"] * 4),
                            C=8, sigma=16)
    X = torch.from_numpy(_x(a.shape[0], seed=9, nb=4))
    Y = dp.spmm(X)
    for j in range(4):
        np.testing.assert_array_equal(Y[:, j].numpy(),
                                      dp.spmv(X[:, j].contiguous()).numpy())
    with pytest.raises(ValueError, match=r"\[n, nb\]"):
        dp.spmm(X[:, 0])
    with pytest.raises(ValueError, match="not in"):
        dp.spmv(X[:, 0], mode="bogus")


def test_memory_stats_equal_reference_at_one_shard():
    a = rtm.random_banded(300, 20, 6, seed=7)
    r = rd.build_dist_plan(a, 1, C=8, sigma=32, D=15, codec="fp16")
    t = td.build_dist_plan(a, 1, C=8, sigma=32, D=15, codec="fp16",
                           device="cpu")
    assert t.memory_stats() == r.memory_stats()
    x = _x(300, seed=4)
    np.testing.assert_allclose(t.spmv(torch.from_numpy(x)).numpy(),
                               np.asarray(r.spmv(x)), rtol=1e-6, atol=1e-6)
    assert (t.n, t.n_shards, t.exchange, t.axis_name) == \
        (r.n, r.n_shards, r.exchange, r.axis_name)
    assert hasattr(t, "m") == hasattr(r, "m")
    t.warmup(nb=2, modes=tdh.EXCHANGE_MODES)
    assert sorted(t._fns) == [("spmm", m) for m in sorted(
        tdh.EXCHANGE_MODES)] + [("spmv", m) for m in sorted(
            tdh.EXCHANGE_MODES)]


def test_shard_vector_roundtrip_and_mask():
    a = rtm.stencil_1d(37, 2)
    dp = td.build_dist_plan(a, mesh=make_shard_mesh(3, devices=["cpu"] * 3),
                            C=8, sigma=8)
    v = torch.from_numpy(_x(37, seed=3))
    vs = dp.shard_vector(v)
    assert vs.shape == (3, dp.ops.n_pad)
    np.testing.assert_array_equal(vs.numpy(), dp.ops.stack_vector(v.numpy()))
    np.testing.assert_array_equal(dp.shard_vector(v.numpy()).numpy(),
                                  vs.numpy())
    np.testing.assert_array_equal(dp.unshard_vector(vs).numpy(), v.numpy())
    np.testing.assert_array_equal(
        dp.ops.host["rowmask"].sum(axis=1).astype(int), dp.ops.part.counts)


# ---------------------------------------------------------------------------
# the shard mesh
# ---------------------------------------------------------------------------


def test_shard_mesh_rules():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ShardMesh(("cpu", "cuda:0"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_shard_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="devices=\\[dev\\] \\* n"):
        make_shard_mesh(2, device="cpu")
    m = make_shard_mesh(device="cpu")
    assert m.size == 1 and m.axis_names == ("shards",)
    m4 = make_shard_mesh(4, devices=["cpu"] * 6)
    assert m4.size == 4 and m4.device == torch.device("cpu")
    assert ShardMesh(("cuda", "cuda:0")).size == 2      # one card, named twice
    a = rtm.stencil_1d(40, 2)
    ops = td.build_operands(a, 2, C=8, sigma=8, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        td.DistSpMVPlan(ops, make_shard_mesh(device="cpu"))
    with pytest.raises(ValueError, match="exchange"):
        td.DistSpMVPlan(ops, m4, exchange="ring")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dist_dot_partials_do_not_depend_on_the_shard_count(dtype):
    """A shard's partial has the same bits in a [4, n] stack as in its own
    [1, n] row (the rank form), at the row length of HPCG 104^3 in four
    shards, and the sums agree with float64 numpy."""
    from repro_torch.kernels.row_dots import row_dots

    rng = np.random.default_rng(5)
    a_h, b_h = rng.standard_normal((2, 4, 281_216))
    a = torch.from_numpy(a_h).to(dtype)
    b = torch.from_numpy(b_h).to(dtype)
    stacked = row_dots(a, b)
    for p in range(4):
        one = row_dots(a[p:p + 1], b[p:p + 1])
        assert torch.equal(stacked[p:p + 1], one), p
        assert torch.equal(tcg.dist_dot(a[p:p + 1], b[p:p + 1]), one[0])
    # within a rounding bound of the terms' magnitude (other orders)
    ab = a_h * b_h
    eps = 1e-6 if dtype == torch.float32 else 1e-14
    bound = eps * np.abs(ab).sum(1)
    assert (np.abs(stacked.double().numpy() - ab.sum(1)) <= bound).all()
    assert abs(float(tcg.dist_dot(a, b)) - ab.sum()) <= bound.sum()
    sq = (a.double().numpy() ** 2).sum()
    assert abs(float(tcg.dist_norm(a)) ** 2 - sq) <= 4 * eps * sq


# ---------------------------------------------------------------------------
# the distributed solvers
# ---------------------------------------------------------------------------


def _hpcg_system():
    s, _ = rop.sym_scale(rtm.hpcg(8, 8, 8))
    b = np.random.default_rng(11).standard_normal(s.shape[0])
    return s, b


def test_jacobi_pcg_dist_one_shard_matches_reference(ref):
    s, b = _hpcg_system()
    xr, ir = ref.get("jpcg1", lambda: rcg.jacobi_pcg_dist(
        rd.build_dist_plan(s, 1, C=32, sigma=64), s.diagonal(),
        jnp.asarray(b), tol=1e-6, maxiter=400, dtype=jnp.float64))
    dp = td.build_dist_plan(s, 1, C=32, sigma=64, device="cpu")
    xt, it = tcg.jacobi_pcg_dist(dp, s.diagonal(), torch.from_numpy(b),
                                 tol=1e-6, maxiter=400, dtype=torch.float64)
    assert it.iters == int(ir.iters)
    assert xt.dtype == torch.float64
    np.testing.assert_allclose(xt.numpy(), np.asarray(xr), rtol=1e-6,
                               atol=1e-9)
    k = it.iters
    np.testing.assert_allclose(it.history[:k + 1].numpy(),
                               np.asarray(ir.history)[:k + 1], rtol=1e-5)
    assert list(dp._fns) == [("pcg", 1e-6, 400, "float64", "ppermute")]


@pytest.mark.parametrize("mode", ["ppermute", "all_gather"])
def test_jacobi_pcg_dist_four_shards_matches_one_device(mode):
    """The reference's rule (``tests/test_distributed.py``): the same
    iterations as Jacobi-PCG in stored-row order, x within 1e-4, the
    history within 1e-5; the graphs equal the eager loop bit for bit."""
    s, b = _hpcg_system()
    ops = top.OperatorSet(s, C=32, sigma=64, device="cpu")
    mat, plan = ops.plan_pair("plan_fp16")
    bt = torch.from_numpy(b)
    x1, i1 = tcg.jacobi_pcg_stored(mat, plan, s.diagonal(), bt, tol=1e-6,
                                   maxiter=400, dtype=torch.float64)
    dp = td.build_dist_plan(s, mesh=make_shard_mesh(4, devices=["cpu"] * 4),
                            C=32, sigma=64, exchange=mode)
    with graphs.eager():
        xe, ie = tcg.jacobi_pcg_dist(dp, s.diagonal(), bt, tol=1e-6,
                                     maxiter=400, dtype=torch.float64)
    for _ in range(2):
        xd, idd = tcg.jacobi_pcg_dist(dp, s.diagonal(), bt, tol=1e-6,
                                      maxiter=400, dtype=torch.float64)
        assert idd.iters == ie.iters == i1.iters
        assert torch.equal(xd, xe)
    assert float(idd.relres) < 1e-6
    np.testing.assert_allclose(xd.numpy(), x1.numpy(), rtol=1e-4, atol=1e-6)
    k = i1.iters
    np.testing.assert_allclose(idd.history[:k + 1].numpy(),
                               i1.history[:k + 1].numpy(), rtol=1e-5,
                               atol=0)


def _adaptive_kw():
    return dict(tol=1e-8, maxiter=60, m_in=16)


def test_adaptive_pcg_dist_one_shard_matches_reference(ref):
    s, b = _hpcg_system()
    d = s.diagonal()
    xr, ir, labels = ref.get("adaptive1", lambda: _ref_adaptive(s, b, d))
    ops = top.OperatorSet(s, C=32, sigma=64, device="cpu")
    ladder = ops.dist_adaptive_tiers(1e-3)
    assert ladder.labels == labels and ladder.n_shards == 1
    xt, it = tcg.adaptive_pcg_dist(ladder, d, torch.from_numpy(b),
                                   dtype=torch.float64, **_adaptive_kw())
    k = it.iters
    assert k == int(ir.iters)
    np.testing.assert_array_equal(it.tier_history[:k].numpy(),
                                  np.asarray(ir.tier_history)[:k])
    np.testing.assert_array_equal(it.tier_matvecs.numpy(),
                                  np.asarray(ir.tier_matvecs))
    assert it.promotions == int(ir.promotions)
    assert float(it.relres) <= 1e-8
    np.testing.assert_allclose(xt.numpy(), np.asarray(xr), rtol=1e-4,
                               atol=1e-8)


def _ref_adaptive(s, b, d):
    ops = rop.OperatorSet(s, C=32, sigma=64)
    ladder = ops.dist_adaptive_tiers(1e-3)
    x, info = rcg.adaptive_pcg_dist(ladder, d, jnp.asarray(b),
                                    dtype=jnp.float64, **_adaptive_kw())
    return x, info, ladder.labels


def test_adaptive_pcg_dist_four_shards_matches_one_device():
    """The reference's rule (``tests/test_composite.py``): TRUE relres
    <= 1e-8, the same outer steps and tier history as ``adaptive_pcg``,
    x within 1e-4; the graphs equal the eager loop bit for bit."""
    s, b = _hpcg_system()
    d = s.diagonal()
    ops = top.OperatorSet(s, C=32, sigma=64, device="cpu")
    mvs, labels, sub32, hi = ops.adaptive_tiers(1e-3)
    dinv = torch.from_numpy(np.where(d == 0, 1.0, 1.0 / d))
    bt = torch.from_numpy(b)
    x1, i1 = tcg.adaptive_pcg(mvs, bt, M=lambda r: r * dinv, matvec_hi=hi,
                              dtype=torch.float64, **_adaptive_kw())
    ladder = ops.dist_adaptive_tiers(
        1e-3, mesh=make_shard_mesh(4, devices=["cpu"] * 4))
    assert ladder.labels == labels
    with graphs.eager():
        xe, ie = tcg.adaptive_pcg_dist(ladder, d, bt, dtype=torch.float64,
                                       **_adaptive_kw())
    xd, idd = tcg.adaptive_pcg_dist(ladder, d, bt, dtype=torch.float64,
                                    **_adaptive_kw())
    assert torch.equal(xd, xe) and idd.iters == ie.iters
    rel = np.linalg.norm(b - s @ xd.numpy()) / np.linalg.norm(b)
    assert rel <= 1e-8
    k = i1.iters
    assert idd.iters == k
    np.testing.assert_array_equal(idd.tier_history[:k].numpy(),
                                  i1.tier_history[:k].numpy())
    assert int(idd.tier_matvecs[np.asarray(sub32)].sum()) > 0
    np.testing.assert_allclose(xd.numpy(), x1.numpy(), rtol=1e-4,
                               atol=1e-8)


_SUBPROCESS = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from repro.core import testmats
from repro.distributed import build_dist_plan
from repro.solvers import cg, operators as op
assert jax.device_count() == 4, jax.device_count()
s, _ = op.sym_scale(testmats.hpcg(8, 8, 8))
b = np.random.default_rng(11).standard_normal(s.shape[0])
dp = build_dist_plan(s, 4, C=32, sigma=64, D=15, codec="fp16")
xj, ij = cg.jacobi_pcg_dist(dp, s.diagonal(), jnp.asarray(b), tol=1e-6,
                            maxiter=400, dtype=jnp.float64)
ladder = op.OperatorSet(s, C=32, sigma=64).dist_adaptive_tiers(
    1e-3, n_shards=4)
xa, ia = cg.adaptive_pcg_dist(ladder, s.diagonal(), jnp.asarray(b),
                              tol=1e-8, maxiter=60, m_in=16,
                              dtype=jnp.float64)
k = int(ia.iters)
np.savez(sys.argv[1], xj=np.asarray(xj), hj=np.asarray(ij.history),
         xa=np.asarray(xa), th=np.asarray(ia.tier_history)[:k])
print(json.dumps({"jacobi": int(ij.iters), "adaptive": k,
                  "labels": ladder.labels}))
"""


def test_dist_solvers_match_the_reference_at_four_shards(tmp_path):
    """The reference's ``jacobi_pcg_dist`` and ``adaptive_pcg_dist`` at
    P = 4 (four XLA host devices, in a subprocess) against the port's at
    P = 4 shards of the CPU: the same iterations and tier history, x
    within 1e-6 / 1e-4, the Jacobi history within 1e-5."""
    out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", _SUBPROCESS, str(out)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    meta = json.loads(run.stdout.strip().splitlines()[-1])
    want = np.load(out)
    s, b = _hpcg_system()
    mesh = make_shard_mesh(4, devices=["cpu"] * 4)
    bt = torch.from_numpy(b)
    dp = td.build_dist_plan(s, mesh=mesh, C=32, sigma=64)
    xj, ij = tcg.jacobi_pcg_dist(dp, s.diagonal(), bt, tol=1e-6,
                                 maxiter=400, dtype=torch.float64)
    assert ij.iters == meta["jacobi"]
    np.testing.assert_allclose(xj.numpy(), want["xj"], rtol=1e-6, atol=1e-9)
    k = ij.iters
    np.testing.assert_allclose(ij.history[:k + 1].numpy(),
                               want["hj"][:k + 1], rtol=1e-5)
    ladder = top.OperatorSet(s, C=32, sigma=64,
                             device="cpu").dist_adaptive_tiers(1e-3,
                                                               mesh=mesh)
    assert ladder.labels == meta["labels"]
    xa, ia = tcg.adaptive_pcg_dist(ladder, s.diagonal(), bt,
                                   dtype=torch.float64, **_adaptive_kw())
    assert ia.iters == meta["adaptive"]
    np.testing.assert_array_equal(ia.tier_history[:ia.iters].numpy(),
                                  want["th"])
    np.testing.assert_allclose(xa.numpy(), want["xa"], rtol=1e-4,
                               atol=1e-8)


# ---------------------------------------------------------------------------
# the operator kinds and the injector
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kinds_pair():
    s, _ = rop.sym_scale(rtm.hpcg(6, 6, 6))
    return s, rop.OperatorSet(s, C=8, sigma=16), top.OperatorSet(
        s, C=8, sigma=16, device="cpu")


@pytest.mark.parametrize("kind", ["dist_fp16", "dist_bf16", "dist_e8m8",
                                  "dist_auto:1e-3", "dist_mixed:1e-3",
                                  "dist_mixed:2.5e-2"])
def test_dist_kinds_match_reference(kinds_pair, kind):
    s, ref_ops, ops = kinds_pair
    x = _x(s.shape[0], seed=3)
    want = np.asarray(ref_ops.matvec(kind)(jnp.asarray(x)))
    got = ops.matvec(kind)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert ops.matvec(kind) is ops.matvec(kind)
    _host_equal(ops.dist_plan(kind).ops, ref_ops.dist_plan(kind).ops)
    assert ops.dist_plan(kind).n_shards == ref_ops.dist_plan(kind).n_shards
    # inside a solver, as any matvec
    diag = torch.from_numpy(s.diagonal())
    xs, info = tcg.pcg(ops.matvec(kind), torch.from_numpy(x).double(),
                       M=lambda r: r / diag, tol=1e-6, maxiter=200)
    assert float(info.relres) < 1e-6


@pytest.mark.parametrize("seed", range(20))
def test_corrupt_dist_checkpoint_detail_equals_reference(kinds_pair, seed):
    s, ref_ops, ops = kinds_pair
    rp, tp = ref_ops.dist_plan("dist_fp16"), ops.dist_plan("dist_fp16")
    x = torch.from_numpy(_x(s.shape[0], seed=5))
    y0 = tp.spmv(x)
    ri = rinj.corrupt_dist_checkpoint(rp, seed)
    ri.undo()
    ti = tinj.corrupt_dist_checkpoint(tp, seed)
    assert ti.detail == ri.detail
    assert (ti.target, ti.value_neutral) == (ri.target, ri.value_neutral)
    k, i = ti.detail["key"], ti.detail["index"]
    assert int(tp.dev[k].view(-1)[i]) == ti.detail["old"] + \
        ti.detail["delta"]
    ti.undo()
    assert int(tp.dev[k].view(-1)[i]) == ti.detail["old"]
    assert torch.equal(tp.spmv(x), y0)


def test_corrupt_dist_checkpoint_reaches_the_shard_kernels():
    """The write is in place in the stacked tensor, whose row p is shard
    p's plan operand: the product changes, and undo restores it."""
    a = _integer(rtm.hpcg(6, 6, 6))
    dp = td.build_dist_plan(a, mesh=make_shard_mesh(3, devices=["cpu"] * 3),
                            C=8, sigma=16)
    x = torch.from_numpy(_x(a.shape[0], seed=2))
    y0 = dp.spmv(x)
    changed = 0
    for seed in range(5):
        inj = tinj.corrupt_dist_checkpoint(dp, seed)
        changed += not torch.equal(dp.spmv(x), y0)
        inj.undo()
        assert torch.equal(dp.spmv(x), y0)
    assert changed > 0
    mixed = td.build_dist_plan(a, classes=[("fp32", 0, None)], C=8,
                               sigma=16, device="cpu")
    with pytest.raises(ValueError, match="no fused checkpoint"):
        tinj.corrupt_dist_checkpoint(mixed, 0)
