"""repro_torch's distribution across processes, on the CPU under gloo.

One module-scoped spawn of four ranks (``parallel.launch.spawn_ranks``;
the rank side is ``tests/torch_ranks_cases.py``) runs every case, at
P = 4 on the world group and at P = 1, 2, 3 on subgroups, and the tests
read what each rank returned:

* a rank's y and Y (nb = 4) in both exchange modes equal row p of the
  stacked port's bit for bit, ``gather_halo_rank`` equals
  ``gather_halo``'s row, and the global products equal the stacked ones
  on every rank, over one codec, three classes (several members per
  term), a partition with an empty shard and one with no halo;
* ``jacobi_pcg_dist`` and ``adaptive_pcg_dist`` over four ranks equal
  the stacked P = 4 solve in iterations, tier history and x bit for bit,
  and the reference's P = 4 run (a subprocess with four XLA host devices)
  in iterations and tier history, x within 1e-6 and 1e-4;
* the reference's host dict through ``from_host`` gives the reference's
  ``reference_spmv`` bit for bit on integer x; a ``dist_`` kind of an
  ``OperatorSet`` over the ranks; ``corrupt_dist_checkpoint`` on a rank
  plan against the stacked plan; ``memory_stats`` per rank;
* ``python -m repro_torch.distributed.run`` over two ranks in either
  exchange mode;
* the failures: a rank that raises fails the parent with its traceback,
  a rank that hangs is killed at the timeout, NCCL on the CPU raises, a
  mesh whose size differs from the operands' shard count raises.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import torch_ranks_cases as cases
from repro import distributed as rd
from repro.core import testmats as rtm
from repro.solvers import operators as rop
from repro_torch import distributed as td
from repro_torch.distributed import halo as tdh
from repro_torch.parallel import launch, make_shard_mesh
from repro_torch.robust import inject as tinj
from repro_torch.solvers import cg as tcg
from repro_torch.solvers import graphs
from repro_torch.solvers import operators as top

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
TIMEOUT = 120           # every spawn's join timeout, seconds
SPMV_CASES = ("fp16_p4", "classes_p4", "empty_p4", "nohalo_p4", "fp16_p1",
              "fp16_p2", "fp16_p3")
QUANTITIES = ("y_ppermute", "y_all_gather", "Y_ppermute", "Y_all_gather",
              "halo_ppermute", "halo_all_gather", "y_global", "Y_global")

_REFERENCE = r"""
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


def _integer(a, seed=11):
    a = a.tocsr().copy()
    a.data = np.random.default_rng(seed).integers(1, 9, a.nnz).astype(
        np.float64)
    return a


def _mesh(P):
    return make_shard_mesh(P, devices=["cpu"] * P)


def _spmv_case(a, P, classes, C=8, sigma=16, seed=3):
    """The stacked plan of one case, and what the ranks get."""
    n = a.shape[0]
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, n).astype(np.float32)
    X = rng.integers(-8, 9, (n, 4)).astype(np.float32)
    plan = td.build_dist_plan(a, mesh=_mesh(P), classes=classes, C=C,
                              sigma=sigma)
    return plan, {"P": P, "host": plan.ops.host, "meta": plan.ops.meta,
                  "x": x, "X": X}


def _stacked(plan, case) -> dict:
    """The stacked plan's answers to what each rank computes."""
    x, X = torch.from_numpy(case["x"]), torch.from_numpy(case["X"])
    xs, Xs = plan.shard_vector(x), plan.shard_vector(X)
    out = {"y_global": plan.spmv(x).numpy(), "Y_global": plan.spmm(X).numpy()}
    for mode in tdh.EXCHANGE_MODES:
        out[f"y_{mode}"] = plan.spmv_sharded(xs, mode=mode).numpy()
        out[f"Y_{mode}"] = plan.spmv_sharded(Xs, mode=mode,
                                             multi_rhs=True).numpy()
        out[f"halo_{mode}"] = tdh.gather_halo(
            xs, plan.ops.index, n_shards=plan.n_shards,
            h_pad=plan.ops.h_pad, mode=mode).numpy()
    return out


def _hpcg_system():
    s, _ = rop.sym_scale(rtm.hpcg(8, 8, 8))
    b = np.random.default_rng(11).standard_normal(s.shape[0])
    return s, b


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's P = 4 solves (a subprocess, started first), the
    stacked port's answers, and the four ranks' results."""
    out_npz = tmp_path_factory.mktemp("ranks") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(out_npz)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        hp = _integer(rtm.hpcg(6, 6, 6))
        rows = np.arange(hp.shape[0])
        three = [("fp16", 15, rows[rows % 3 == 0]),
                 ("e8m", 8, rows[rows % 3 == 1]),
                 ("fp32", 0, rows[rows % 3 == 2])]
        fp16 = [("fp16", 15, None)]
        builds = {
            "fp16_p4": _spmv_case(hp, 4, fp16),
            "classes_p4": _spmv_case(hp, 4, three),
            "empty_p4": _spmv_case(_integer(rtm.stencil_1d(3, 1)), 4, fp16,
                                   sigma=8),
            "nohalo_p4": _spmv_case(_integer(sp.diags(
                np.ones(40)).tocsr()), 4, fp16, sigma=8),
            "fp16_p1": _spmv_case(hp, 1, fp16),
            "fp16_p2": _spmv_case(hp, 2, fp16),
            "fp16_p3": _spmv_case(hp, 3, fp16),
        }
        stacked = {k: _stacked(p, c) for k, (p, c) in builds.items()}

        s, b = _hpcg_system()
        splan = td.build_dist_plan(s, mesh=_mesh(4), C=32, sigma=64)
        ladder = top.OperatorSet(s, C=32, sigma=64, device="cpu") \
            .dist_adaptive_tiers(1e-3, mesh=_mesh(4))
        bt = torch.from_numpy(b)
        with graphs.eager():
            xj, ij = tcg.jacobi_pcg_dist(splan, s.diagonal(), bt, tol=1e-6,
                                         maxiter=400, dtype=torch.float64)
            xa, ia = tcg.adaptive_pcg_dist(ladder, s.diagonal(), bt,
                                           dtype=torch.float64,
                                           **cases.ADAPTIVE)

        a_ref = _integer(rtm.hpcg(5, 5, 5), seed=4)
        x_ref = np.random.default_rng(8).integers(
            -8, 9, a_ref.shape[0]).astype(np.float32)
        r_ops = rd.build_operands(a_ref, 4, C=8, sigma=16)
        ref_host = {k: np.asarray(v) for k, v in r_ops.host.items()}
        t_meta = td.build_operands(a_ref, 4, C=8, sigma=16,
                                   device="cpu").meta
        s_kind, _ = rop.sym_scale(rtm.hpcg(6, 6, 6))
        x_kind = np.random.default_rng(5).standard_normal(
            s_kind.shape[0]).astype(np.float32)
        spec = {
            "spmv": {k: c for k, (_, c) in builds.items()},
            "solve": {"s": s, "b": b,
                      "jacobi": (splan.ops.host, splan.ops.meta),
                      "tiers": [(o.host, o.meta) for o in ladder.tiers],
                      "hi": (ladder.hi.host, ladder.hi.meta),
                      "labels": ladder.labels, "sub32": ladder.sub32},
            "ref_host": (ref_host, t_meta, x_ref),
            "kind": (s_kind, x_kind),
        }
        ranks = launch.spawn_ranks(cases.run_cases, WORLD, backend="gloo",
                                   timeout=TIMEOUT, args=(spec,))
        stdout, stderr = ref_proc.communicate(timeout=TIMEOUT)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    assert ref_proc.returncode == 0, stderr[-4000:]
    kind_plan = top.OperatorSet(s_kind, C=8, sigma=16, device="cpu")
    return {
        "builds": builds, "stacked": stacked, "ranks": ranks,
        "solve": {"jacobi": (xj.numpy(), ij.iters, ij.history.numpy()),
                  "adaptive": (xa.numpy(), ia.iters,
                               ia.tier_history[:ia.iters].numpy(),
                               ia.tier_matvecs.numpy(), ia.promotions,
                               list(ladder.labels))},
        "ref": (json.loads(stdout.strip().splitlines()[-1]),
                dict(np.load(out_npz))),
        "ref_host_y": rd.reference_spmv(r_ops, x_ref),
        "kind_plan": kind_plan.dist_plan("dist_fp16"),
        "kind_x": x_kind,
        "fp16_p4": builds["fp16_p4"],
    }


# ---------------------------------------------------------------------------
# a rank against the stacked form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("case", SPMV_CASES)
def test_rank_equals_stacked_row(run, case, quantity):
    """Each rank's block (or, for the global products, every rank's whole
    vector) equals the stacked port's bit for bit."""
    want = run["stacked"][case][quantity]
    P = run["builds"][case][1]["P"]
    got = [r[case][quantity] for r in run["ranks"][:P]]
    assert all(case not in r for r in run["ranks"][P:])
    for p, g in enumerate(got):
        if quantity.endswith("global"):
            np.testing.assert_array_equal(g, want)
        else:
            assert g.shape == (1,) + want.shape[1:]
            np.testing.assert_array_equal(g[0], want[p])


def test_cases_cover_empty_shards_and_no_halo(run):
    empty = run["builds"]["empty_p4"][0].ops
    assert empty.part.counts.tolist() == [1, 1, 1, 0]
    assert run["builds"]["nohalo_p4"][0].ops.h_pad == 0
    assert run["builds"]["fp16_p4"][0].ops.h_pad > 0
    assert len(run["builds"]["classes_p4"][0].ops.members) == 6


@pytest.mark.parametrize("solver", ["jacobi", "jacobi_built"])
def test_rank_jacobi_equals_stacked(run, solver):
    x, k, hist = run["solve"]["jacobi"]
    for r in run["ranks"]:
        xr, kr, hr = r["solve"][solver]
        assert kr == k
        np.testing.assert_array_equal(xr, x)
        np.testing.assert_array_equal(hr, hist)


@pytest.mark.parametrize("solver", ["adaptive", "adaptive_built"])
def test_rank_adaptive_equals_stacked(run, solver):
    x, k, th, mvc, prom, labels = run["solve"]["adaptive"]
    for r in run["ranks"]:
        xr, kr, thr, mvcr, promr, labr = r["solve"][solver]
        assert (kr, promr, labr) == (k, prom, labels)
        np.testing.assert_array_equal(thr, th)
        np.testing.assert_array_equal(mvcr, mvc)
        np.testing.assert_array_equal(xr, x)


# ---------------------------------------------------------------------------
# the ranks against the reference
# ---------------------------------------------------------------------------


def test_rank_jacobi_matches_reference_at_four_shards(run):
    meta, want = run["ref"]
    xr, kr, hr = run["ranks"][0]["solve"]["jacobi"]
    assert kr == meta["jacobi"]
    np.testing.assert_allclose(xr, want["xj"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(hr[:kr + 1], want["hj"][:kr + 1], rtol=1e-5)


def test_rank_adaptive_matches_reference_at_four_shards(run):
    meta, want = run["ref"]
    xr, kr, thr, _, _, labels = run["ranks"][0]["solve"]["adaptive"]
    assert labels == meta["labels"]
    assert kr == meta["adaptive"]
    np.testing.assert_array_equal(thr, want["th"])
    np.testing.assert_allclose(xr, want["xa"], rtol=1e-4, atol=1e-8)


def test_reference_host_through_from_host(run):
    """The reference's ``build_operands(...).host`` uploaded row by row
    gives the reference's ``reference_spmv`` bit for bit."""
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["ref_host_y"], run["ref_host_y"])


def test_operator_set_kind_over_ranks(run):
    plan = run["kind_plan"]
    want = plan.spmv(torch.from_numpy(run["kind_x"])).numpy()
    assert plan.n_shards == 1
    for r in run["ranks"]:
        assert r["kind_shards"] == WORLD
        np.testing.assert_allclose(r["kind_y"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("seed", range(5))
def test_corrupt_dist_checkpoint_on_ranks(run, seed):
    """Every rank draws the stacked form's detail; the owner's write
    changes every rank's y as the stacked write changes the stacked y,
    and undo restores it."""
    plan, case = run["fp16_p4"]
    x = torch.from_numpy(case["x"])
    y0 = plan.spmv(x).numpy()
    inj = tinj.corrupt_dist_checkpoint(plan, seed)
    y_bad = plan.spmv(x).numpy()
    inj.undo()
    for r in run["ranks"]:
        detail, yr_bad, yr_ok = r["faults"][seed]
        assert detail == inj.detail
        np.testing.assert_array_equal(yr_bad, y_bad)
        np.testing.assert_array_equal(yr_ok, y0)


def test_memory_stats_per_rank(run):
    ops = run["fp16_p4"][0].ops
    every = [r["memory"]["rank_bytes"] for r in run["ranks"]]
    want = [sum(v[p].nbytes for v in ops.host.values()) for p in range(4)]
    assert every == want
    for p, r in enumerate(run["ranks"]):
        st = r["memory"]
        assert st["rank"] == p and st["shards"] == WORLD
        assert st["bytes_per_rank"] == every
        assert st["total_bytes"] == sum(every)
        assert st["h_pad"] == ops.h_pad


def test_collectives_on_ranks(run):
    v = [0.1 * (r + 1) for r in range(WORLD)]
    want = ((v[0] + v[1]) + v[2]) + v[3]
    for r in run["ranks"]:
        assert r["rank_sum"] == want
        assert "differs across the ranks" in r["differs"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exchange", ["ppermute", "all_gather"])
def test_cli_runs_two_gloo_ranks(monkeypatch, capsys, exchange):
    from repro_torch.distributed import run as cli

    monkeypatch.setattr(cli, "TIMEOUT_S", TIMEOUT)
    rc = cli.main(["--ranks", "2", "--backend", "gloo", "--side", "6",
                   "--exchange", exchange])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and lines[-1] == "OK"
    out = json.loads(lines[-2])
    assert out["ranks"] == 2 and out["backend"] == "gloo"
    assert out["spmv_bit_equal"] is True
    assert 0 < out["iters"] < cli.MAXITER and out["relres"] < 1e-7
    # against the exact matrix: the solve's operator holds fp16 values
    # (relative rounding 2^-11), so the true residual stops near 1e-4
    assert out["true_relres"] < 1e-3
    assert len(out["solve_s"]) == len(out["matvec_ms"]) == 2


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------


def test_mesh_size_must_match_the_operands(run):
    for r in run["ranks"][:2]:
        assert "mesh has 2 devices but operands were built for 4 shards" \
            in r["mismatch"]
    with pytest.raises(ValueError, match="RankMesh"):
        td.DistSpMVPlan(td.DistOperands.from_host(
            run["fp16_p4"][0].ops.host, run["fp16_p4"][0].ops.meta, rank=0,
            device="cpu"), _mesh(4))


def test_a_failing_rank_fails_the_run_with_its_traceback():
    with pytest.raises(RuntimeError) as e:
        launch.spawn_ranks(cases.raise_on_rank_one, 3, timeout=TIMEOUT)
    msg = str(e.value)
    assert msg.startswith("rank 1 of 3 (gloo) failed first")
    assert "ValueError: rank one fails on purpose" in msg
    assert "Traceback" in msg


def test_a_hanging_rank_is_killed_at_the_timeout():
    with pytest.raises(TimeoutError, match="killed"):
        launch.spawn_ranks(cases.hang, 2, timeout=4, args=(60.0,))


def test_nccl_refused_on_the_cpu_and_on_a_shared_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL needs CUDA"):
        launch.spawn_ranks(cases.hang, 2, backend="nccl", args=(0.0,))
    with pytest.raises(ValueError, match="backend"):
        launch.spawn_ranks(cases.hang, 2, backend="mpi", args=(0.0,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="rejects two ranks on one card"):
        launch.spawn_ranks(cases.hang, 2, backend="nccl", device="cuda:0",
                           args=(0.0,))
