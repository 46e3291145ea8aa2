"""The rank side of ``tests/test_torch_ranks.py``: what each of four gloo
ranks runs, in processes started by
``repro_torch.parallel.launch.spawn_ranks``.

The parent builds every case's stacked operands once and passes their
host dicts and statics (``DistOperands.host`` / ``.meta``); each rank
takes its row (``DistOperands.from_host``), runs the case on its
``RankMesh`` and returns its results, which the launcher writes to a file
per rank. Cases at P = 1, 2 and 3 run on ``torch.distributed.new_group``
subgroups of the first P ranks inside the same spawn. The module imports
neither JAX nor ``repro``: the ranks run the port alone.
"""
import torch
import torch.distributed as dist

from repro_torch import distributed as td
from repro_torch.distributed import halo as dh
from repro_torch.parallel import collectives as co
from repro_torch.parallel import make_rank_mesh
from repro_torch.robust import inject
from repro_torch.solvers import cg
from repro_torch.solvers import operators as op

SUBGROUPS = (1, 2, 3)
ADAPTIVE = dict(tol=1e-8, maxiter=60, m_in=16)


def _rank_ops(mesh, host, meta):
    return td.DistOperands.from_host(host, meta, rank=mesh.rank,
                                     device=mesh.device)


def spmv_case(mesh, case: dict) -> dict:
    """y and Y (nb = 4) in both exchange modes on the rank's block, the
    rank's halo, and the global products."""
    plan = td.DistSpMVPlan(_rank_ops(mesh, case["host"], case["meta"]), mesh)
    x, X = torch.from_numpy(case["x"]), torch.from_numpy(case["X"])
    xs, Xs = plan.shard_vector(x), plan.shard_vector(X)
    out = {"y_global": plan.spmv(x).numpy(), "Y_global": plan.spmm(X).numpy()}
    for mode in dh.EXCHANGE_MODES:
        out[f"y_{mode}"] = plan.spmv_sharded(xs, mode=mode).numpy()
        out[f"Y_{mode}"] = plan.spmv_sharded(Xs, mode=mode,
                                             multi_rhs=True).numpy()
        out[f"halo_{mode}"] = dh.gather_halo_rank(
            xs, plan.ops.index, mesh=mesh, h_pad=plan.ops.h_pad,
            mode=mode).numpy()
    return out


def solve_case(mesh, sol: dict) -> dict:
    """``jacobi_pcg_dist`` and ``adaptive_pcg_dist`` over the parent's
    operands, and again over operands each rank builds itself
    (``build_dist_plan`` and ``OperatorSet(mesh=...)``)."""
    s, b, diag = sol["s"], torch.from_numpy(sol["b"]), sol["s"].diagonal()
    jkw = dict(tol=1e-6, maxiter=400, dtype=torch.float64)
    out = {}
    plan = td.DistSpMVPlan(_rank_ops(mesh, *sol["jacobi"]), mesh)
    x, info = cg.jacobi_pcg_dist(plan, diag, b, **jkw)
    out["jacobi"] = (x.numpy(), info.iters, info.history.numpy())
    built = td.build_dist_plan(s, mesh=mesh, C=32, sigma=64)
    x, info = cg.jacobi_pcg_dist(built, diag, b, **jkw)
    out["jacobi_built"] = (x.numpy(), info.iters, info.history.numpy())
    ladder = td.DistTierLadder(
        [_rank_ops(mesh, h, m) for h, m in sol["tiers"]],
        _rank_ops(mesh, *sol["hi"]), mesh, labels=sol["labels"],
        sub32=sol["sub32"])
    for key, lad in (("adaptive", ladder), (
            "adaptive_built", op.OperatorSet(
                s, C=32, sigma=64, mesh=mesh).dist_adaptive_tiers(1e-3))):
        x, info = cg.adaptive_pcg_dist(lad, diag, b, dtype=torch.float64,
                                       **ADAPTIVE)
        k = info.iters
        out[key] = (x.numpy(), k, info.tier_history[:k].numpy(),
                    info.tier_matvecs.numpy(), info.promotions,
                    list(lad.labels))
    return out


def extra_cases(mesh, spec: dict) -> dict:
    """The reference's host dict through ``from_host``, a ``dist_`` kind
    of an ``OperatorSet`` over the ranks, the checkpoint injector, the
    memory statistics and the collectives' checks."""
    out = {}
    ref_host, meta, x = spec["ref_host"]
    plan = td.DistSpMVPlan(_rank_ops(mesh, ref_host, meta), mesh)
    out["ref_host_y"] = plan.spmv(torch.from_numpy(x)).numpy()
    s_kind, xk = spec["kind"]
    ops = op.OperatorSet(s_kind, C=8, sigma=16, mesh=mesh)
    out["kind_y"] = ops.matvec("dist_fp16")(torch.from_numpy(xk)).numpy()
    out["kind_shards"] = ops.dist_plan("dist_fp16").n_shards
    case = spec["spmv"]["fp16_p4"]
    plan = td.DistSpMVPlan(_rank_ops(mesh, case["host"], case["meta"]), mesh)
    xt = torch.from_numpy(case["x"])
    faults = []
    for seed in range(5):
        inj = inject.corrupt_dist_checkpoint(plan, seed)
        y_bad = plan.spmv(xt).numpy()
        inj.undo()
        faults.append((inj.detail, y_bad, plan.spmv(xt).numpy()))
    out["faults"] = faults
    out["memory"] = plan.memory_stats()
    out["rank_sum"] = float(co.rank_sum(
        torch.tensor(0.1 * (mesh.rank + 1), dtype=torch.float64), mesh))
    try:
        co.same_on_every_rank([mesh.rank], mesh, "the rank")
        out["differs"] = None
    except RuntimeError as e:
        out["differs"] = str(e)
    return out


def run_cases(mesh, spec: dict) -> dict:
    """Every case of ``spec`` on this rank: ``{case: result}``."""
    # every rank makes every subgroup, in the same order
    groups = {P: dist.new_group(list(range(P))) for P in SUBGROUPS}
    sub = {P: make_rank_mesh(g) for P, g in groups.items() if mesh.rank < P}
    out = {}
    for name, case in spec["spmv"].items():
        P = case["P"]
        if P == mesh.size:
            out[name] = spmv_case(mesh, case)
        elif P in sub:
            out[name] = spmv_case(sub[P], case)
    if 2 in sub:
        case = spec["spmv"]["fp16_p4"]
        try:
            td.DistSpMVPlan(_rank_ops(sub[2], case["host"], case["meta"]),
                            sub[2])
            out["mismatch"] = None
        except ValueError as e:
            out["mismatch"] = str(e)
    out["solve"] = solve_case(mesh, spec["solve"])
    out.update(extra_cases(mesh, spec))
    return out


def raise_on_rank_one(mesh) -> None:
    """Rank 1 raises; the others wait in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    co.rank_sum(torch.zeros((), dtype=torch.float64), mesh)


def hang(mesh, seconds: float) -> None:
    """Every rank sleeps past the launcher's timeout."""
    import time
    time.sleep(seconds)
