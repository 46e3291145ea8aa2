"""repro_torch's precision store against the reference, on the CPU.

* ``matrix_fingerprint`` gives the reference's string on every tiny and
  small suite matrix, and per row shard;
* a store file written by either package loads in the other, with the
  same ``PrecisionPlan.to_dict()`` and retile winners;
* corrupt files are quarantined and concurrent writers merge, as the
  reference's tests check it;
* retile winners are keyed ``<key>@cpu`` for a CPU plan, with the
  reference's legacy unqualified fallback; ``apply_retile`` installs them;
* ``lookup_or_select`` takes the reference's hit/miss decisions, and
  ``OperatorSet(store=...)`` reads through it;
* ``select_codec_per_shard`` picks the reference's fleet class.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro.core import testmats as rtm
from repro.precision import store as rst
from repro.robust import inject as rinj
from repro_torch.core import packsell as tpk
from repro_torch.distributed import partition as tdp
from repro_torch.kernels import plan as tpl
from repro_torch.precision import select as tsel
from repro_torch.precision import store as tst
from repro_torch.robust import inject as tinj
from repro_torch.solvers import operators as top


def _matrices():
    out = {f"tiny/{k}": v for k, v in rtm.suite("tiny").items()}
    out.update({f"small/{k}": v for k, v in rtm.suite("small").items()})
    return out


@pytest.fixture(scope="module")
def suite():
    return _matrices()


def test_fingerprints_equal_reference(suite):
    assert len(suite) == 11
    for name, a in suite.items():
        assert tst.matrix_fingerprint(a) == rst.matrix_fingerprint(a), name
    a = suite["tiny/powerlaw"]
    for shards in (1, 3, 7):
        assert tst.shard_fingerprints(a, shards) == \
            rst.shard_fingerprints(a, shards)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_file_reads_across_packages(tmp_path, writer):
    a = rtm.suite("tiny")["banded"]
    p = str(tmp_path / "store.json")
    W, R = (tst, rst) if writer == "port" else (rst, tst)
    plan, hit = W.PrecisionStore(p).lookup_or_select(a, 1e-3)
    assert not hit
    rows_plan, _ = W.PrecisionStore(p).lookup_or_select(a, 1e-3,
                                                        mode="rows")
    W.PrecisionStore(p).put_retile(plan.fingerprint, "plan_e8m12",
                                   [(8, 32)], backend="cpu")
    other = R.PrecisionStore(p)
    got, hit = other.lookup_or_select(a, 1e-3)
    assert hit and got.to_dict() == plan.to_dict()
    got, hit = other.lookup_or_select(a, 1e-3, mode="rows")
    assert hit and got.to_dict() == rows_plan.to_dict()
    assert other.get_retile(plan.fingerprint, "plan_e8m12",
                            backend="cpu") == [(8, 32)]
    assert tst.matrix_fingerprint(a) == plan.fingerprint


@pytest.mark.parametrize("mode", ["truncate", "garble"])
def test_store_corruption_quarantined(tmp_path, mode):
    p = str(tmp_path / "store.json")
    s = tst.PrecisionStore(p)
    s.put_retile("fp0", "plan_fp16", [(8, 32)])
    i = tinj.corrupt_store(p, seed=31, mode=mode)
    with open(p, "rb") as f:
        bad = f.read()
    # the same seed corrupts the same bytes as the reference's injector
    i.undo()
    ir = rinj.corrupt_store(p, seed=31, mode=mode)
    with open(p, "rb") as f:
        assert f.read() == bad
    assert ir.detail == i.detail
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s2 = tst.PrecisionStore(p)
    try:
        json.load(open(p))
        corrupted_parsed = True     # garble can leave valid JSON
    except Exception:
        corrupted_parsed = False
    if len(s2) == 0:
        assert any("quarantined" in str(x.message) for x in w)
        assert os.path.exists(p + ".corrupt")
        s2.put_retile("fp1", "plan_fp16", [(4, 16)])
        assert tst.PrecisionStore(p).get_retile("fp1", "plan_fp16") == \
            [(4, 16)]
    else:
        assert corrupted_parsed
    ir.undo()


def test_store_concurrent_writers_merge(tmp_path):
    p = str(tmp_path / "store.json")
    s1 = tst.PrecisionStore(p)
    s2 = tst.PrecisionStore(p)
    s1.put_retile("A", "k", [(8, 32)])
    s2.put_retile("B", "k", [(4, 16)])     # would clobber A without merge
    final = tst.PrecisionStore(p)
    assert final.get_retile("A", "k") == [(8, 32)]
    assert final.get_retile("B", "k") == [(4, 16)]
    assert os.path.exists(p + ".lock")
    with pytest.raises(ValueError, match="version"):
        json.dump({"version": 2, "entries": {}}, open(p, "w"))
        tst.PrecisionStore(p)


def test_retile_keys_are_device_qualified_with_legacy_fallback(tmp_path):
    p = str(tmp_path / "store.json")
    a = rtm.random_banded(256, 12, 4, seed=2)
    mat = tpk.from_csr(a, C=8, sigma=32, codec="e8m", D=8, device="cpu")
    plan = tpl.build_plan(mat, force="full")
    nb = len(plan.tiles)
    fp = tst.matrix_fingerprint(a)
    s = tst.PrecisionStore(p)
    # a legacy, unqualified entry resolves for any device
    s._entries.setdefault(fp, {}).setdefault("retile", {})["plan_e8m8"] = \
        [[4, 16]] * nb
    s.save()
    s = tst.PrecisionStore(p)
    assert s.get_retile(fp, "plan_e8m8", backend="cuda") == [(4, 16)] * nb
    # a qualified entry shadows it for its device only
    s.put_retile(fp, "plan_e8m8", [(2, 8)] * nb, backend="cuda")
    assert s.get_retile(fp, "plan_e8m8", backend="cuda") == [(2, 8)] * nb
    assert s.get_retile(fp, "plan_e8m8", backend=torch.device("cpu")) == \
        [(4, 16)] * nb
    assert s.apply_retile(fp, "plan_e8m8", plan)      # @cpu: the legacy
    assert plan.tiles == ((4, 16),) * nb and plan.ktable.wbs[0] == 16
    s.put_retile(fp, "plan_e8m8", [(8, 32)] * nb)     # default: this host
    key = f"plan_e8m8@{'cuda' if torch.cuda.is_available() else 'cpu'}"
    assert key in tst.PrecisionStore(p)._entries[fp]["retile"]
    assert s.apply_retile(fp, "plan_e8m8", plan, backend="cpu")
    assert plan.tiles == ((8, 32),) * nb
    assert not s.apply_retile(fp, "missing", plan)
    # the reference reads the port's qualified keys under its backend name
    assert rst.PrecisionStore(p).get_retile(fp, "plan_e8m8",
                                            backend="cuda") == [(2, 8)] * nb


def test_lookup_decisions_equal_reference(tmp_path):
    a = rtm.suite("tiny")["powerlaw"]
    seq = [(1e-3, {}), (1e-3, {}), (1e-2, {}), (1e-4, {}),
           (1e-3, {"mode": "rows"}), (1e-3, {"safety": 0.25}),
           (1e-3, {"candidates": (("e8m", 15), ("e8m", 12))}),
           (1e-3, {"validate": True})]
    outs = []
    for pkg, name in ((tst, "port"), (rst, "ref")):
        s = pkg.PrecisionStore(str(tmp_path / f"{name}.json"))
        outs.append([(p.to_dict(), hit) for p, hit in
                     (s.lookup_or_select(a, b, **kw) for b, kw in seq)])
    assert outs[0] == outs[1]
    hits = [hit for _, hit in outs[0]]
    assert hits[:2] == [False, True] and False in hits[2:]


def test_operator_set_reads_through_the_store(tmp_path):
    a = rtm.suite("tiny")["banded"]
    p = str(tmp_path / "store.json")
    ops = top.OperatorSet(a, device="cpu", store=p)
    plan = ops.precision_plan(1e-3)
    assert tst.PrecisionStore(p).get_plan(plan.fingerprint) is not None
    ops2 = top.OperatorSet(a, device="cpu")
    assert ops2.precision_plan(1e-3, store=p).to_dict() == plan.to_dict()
    # without a store the same selection, with no fingerprint recorded
    fresh = ops2.precision_plan(1e-3)
    assert fresh.classes == plan.classes and fresh.fingerprint is None
    mvs, labels, _, _ = ops2.adaptive_tiers(1e-3, store=p)
    assert labels == [c.label for c in tsel.tier_ladder(plan)]


def test_select_codec_per_shard_equals_reference(tmp_path):
    a = rtm.suite("tiny")["scattered"]
    for shards in (1, 2, 4):
        tp, tf = tst.select_codec_per_shard(
            a, shards, 1e-3, store=str(tmp_path / f"t{shards}.json"))
        rp, rf = rst.select_codec_per_shard(
            a, shards, 1e-3, store=str(tmp_path / f"r{shards}.json"))
        assert (tf.codec, tf.D, tf.rows) == (rf.codec, rf.D, rf.rows)
        assert [p.to_dict() for p in tp] == [p.to_dict() for p in rp]
    with pytest.raises(ValueError):
        tdp.partition_rows(5, 0)
    np.testing.assert_array_equal(tdp.partition_rows(10, 4).starts,
                                  [0, 3, 6, 8, 10])
