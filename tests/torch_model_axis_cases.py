"""The rank side of ``tests/test_torch_model_axis.py``: what each of four
gloo ranks runs, in processes started by
``repro_torch.parallel.launch.spawn_ranks``.

Every rank makes the subgroup of the first two ranks, and runs each case
on a ``launch.mesh.ProcessMesh`` over the group of its size when it is a
member (ranks ``(pod · data + data index) · model + model index``). The
results go back to the parent, which holds them to the stacked form (every
shard in one process) and the reference. The module imports neither JAX
nor ``repro``: the ranks run the port alone.
"""
import dataclasses

import numpy as np
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import tensor_parallel as tp
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptConfig
from repro_torch.train import Trainer, TrainerConfig

SEQ, BATCH, STEPS = 32, 8, 2
#: the families the trainer runs (vlm and encdec: the reference's trainer
#: makes neither ``patches`` nor ``frames``)
FAMILIES = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b",
            "ssm": "mamba2-1.3b", "hybrid": "zamba2-2.7b"}
#: every family's config, the two the trainer cannot run included
FAMILIES_ALL = tuple(FAMILIES.values()) + ("llava-next-mistral-7b",
                                           "seamless-m4t-large-v2")
#: (data, model) meshes: the KV-head rule at model 2, the query rows at 4
MESHES = ((1, 2), (2, 2), (1, 4))
#: a reduced config with 8 heads over 2 KV heads: the GQA-group rule at 4
GQA = dict(n_heads=8, n_kv_heads=2)


def case_names() -> dict:
    """``{name: (family, data, model)}`` of the trainer cases."""
    out = {f"{fam}_{d}x{m}": (fam, d, m) for fam in FAMILIES
           for d, m in MESHES}
    out["gqa_1x4"] = ("gqa", 1, 4)
    return out


def cfg(family: str):
    if family == "gqa":
        return dataclasses.replace(configs.reduce(configs.get(
            FAMILIES["dense"])), **GQA)
    return configs.reduce(configs.get(FAMILIES[family]))


def opt():
    return OptConfig(warmup=1, total_steps=STEPS)


def tcfg(data: int, model: int, ckpt_dir: str, **kw) -> TrainerConfig:
    return TrainerConfig(steps=kw.pop("steps", STEPS), ckpt_dir=ckpt_dir,
                         ckpt_every=kw.pop("ckpt_every", STEPS),
                         log_every=100, seq_len=SEQ, global_batch=BATCH,
                         data_axis=data, model_axis=model, **kw)


def quiet(_):
    pass


def state_arrays(t: Trainer, state) -> dict:
    """Each held shard's master pieces and m and v slices, as numpy."""
    return {k: [[x.detach().numpy().copy() for x in sh]
                for sh in getattr(state, k)] for k in ("master", "m", "v")}


def start(t: Trainer, family: str, init):
    """The trainer's step-0 state from ``init`` (the reference's initial
    tree), or from the port's seed-0 draw where ``init`` is None."""
    c = cfg(family)
    params = (tfm.init_params(c, 0, device="cpu") if init is None
              else tfm.load_reference_params(c, init, device="cpu"))
    return t.initial_state(params)


def trainer_case(mesh, name: str, root: str, inits: dict) -> dict:
    family, d, m = case_names()[name]
    t = Trainer(cfg(family), opt(), tcfg(d, m, f"{root}/{name}"), mesh=mesh,
                log_fn=quiet)
    s = t.run(start(t, family, inits.get(family)))
    return {"losses": [h["loss"] for h in t.history], **state_arrays(t, s)}


def restore_case(mesh, directory: str, family: str = "dense") -> dict:
    """A trainer on this mesh restores the latest checkpoint in
    ``directory`` (copied by the parent); its whole leaves (on every rank:
    each takes part in the gathers) and one more step's state."""
    t = Trainer(cfg(family), opt(), tcfg(mesh.data, mesh.model, directory,
                                         steps=STEPS + 1, ckpt_every=100),
                mesh=mesh, log_fn=quiet)
    s0 = t.init_or_restore()
    leaves = {k: v.detach().numpy().copy() for k, v in
              tp.checkpoint_leaves(mesh, t._step_fn.ctx.layout,
                                   t._step_fn.layout, s0).items()}
    s = t.run(s0)
    return {"restored_step": int(s0.step), "leaves": leaves,
            "losses": [h["loss"] for h in t.history], **state_arrays(t, s)}


def run_cases(rank_mesh, spec: dict) -> dict:
    """Every case on this rank: ``{case: result}``."""
    pair = dist.new_group([0, 1])
    rank = rank_mesh.rank

    def mesh(d, m):
        return make_debug_mesh(data=d, model=m, device="cpu",
                               group=pair if d * m == 2 else None)

    out = {}
    for name, (_, d, m) in case_names().items():
        if rank < d * m:
            out[name] = trainer_case(mesh(d, m), name, spec["root"],
                                     spec["init"])
    for key, d, m in (("restore_2x2", 2, 2), ("restore_1x2", 1, 2)):
        if rank < d * m:
            out[key] = restore_case(mesh(d, m), spec[key])
    return out


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)
