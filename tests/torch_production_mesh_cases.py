"""The rank side of ``tests/test_torch_production_mesh.py``: what each of
four gloo ranks runs, in processes started by
``repro_torch.parallel.launch.spawn_ranks``.

Every case runs on a ``launch.mesh.ProcessMesh`` over the whole group of
four ranks: ``grad_compression`` at (data 2, model 2), ``pod_wire`` at
(pod 2, data 1, model 2), and the plain tensor-parallel step at (2, 2).
Each rank also counts the bytes it hands to the collectives by dtype in
every step (the calls of ``parallel.collectives.all_to_all`` and
``all_gather``, which are every exchange of the training mesh), and the
FLOPs of its aten ops (``launch.op_cost``) in one more step. The
module imports neither JAX nor ``repro``: the ranks run the port alone.
"""
import contextlib
import functools

import numpy as np

from repro_torch import configs
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptConfig
from repro_torch.parallel import collectives as co
from repro_torch.train import Trainer, TrainerConfig

SEQ, BATCH, STEPS = 32, 8, 2
FAMILIES = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b",
            "ssm": "mamba2-1.3b", "hybrid": "zamba2-2.7b"}
#: ``{case: (family, pods, data, model, trainer options)}``
CASES = {
    **{f"comp_{fam}": (fam, 1, 2, 2, {"grad_compression": 10})
       for fam in FAMILIES},
    "wire_u16_dense": ("dense", 2, 1, 2, {"pod_wire": "u16"}),
    "wire_u16_moe": ("moe", 2, 1, 2, {"pod_wire": "u16"}),
    "wire_u8_dense": ("dense", 2, 1, 2, {"pod_wire": "u8"}),
    "wire_u8_ssm": ("ssm", 2, 1, 2, {"pod_wire": "u8"}),
    "plain_dense": ("dense", 1, 2, 2, {}),
}


def cfg(family: str):
    return configs.reduce(configs.get(FAMILIES[family]))


def opt():
    return OptConfig(warmup=1, total_steps=STEPS)


#: the cases whose FLOPs the parent holds to the meta count
COUNTED = ("plain_dense", "comp_dense", "wire_u16_dense", "wire_u16_moe")


def tcfg(pods: int, data: int, model: int, ckpt_dir: str, *,
         ckpt_every: int = STEPS, **kw) -> TrainerConfig:
    return TrainerConfig(steps=STEPS, ckpt_dir=ckpt_dir,
                         ckpt_every=ckpt_every, log_every=100, seq_len=SEQ,
                         global_batch=BATCH, data_axis=data,
                         model_axis=model, pods=pods, **kw)


def quiet(_):
    pass


@contextlib.contextmanager
def wire_bytes():
    """``{dtype: bytes}`` this process hands to the collectives while the
    block runs: an all-to-all of ``[n, ...]`` sends all rows but its own,
    an all-gather its block to each other member (a gather over a subset
    of the ranks runs as an all-to-all: counted once)."""
    got, depth = {}, [0]
    orig = {name: getattr(co, name) for name in ("all_to_all", "all_gather")}

    def wrap(name):
        fn = orig[name]

        def call(x, mesh, members=None):
            if depth[0]:
                return fn(x, mesh, members)
            n = mesh.size if members is None else len(members)
            nbytes = x.numel() * x.element_size()
            key = str(x.dtype).removeprefix("torch.")
            got[key] = got.get(key, 0) + (nbytes * (n - 1) // n
                                          if name == "all_to_all"
                                          else nbytes * (n - 1))
            depth[0] += 1
            try:
                return fn(x, mesh, members)
            finally:
                depth[0] -= 1
        return call

    co.all_to_all, co.all_gather = wrap("all_to_all"), wrap("all_gather")
    try:
        yield got
    finally:
        co.all_to_all, co.all_gather = orig["all_to_all"], orig["all_gather"]


def counted(t: Trainer) -> tuple:
    """Wrap ``t``'s step: each step's wire bytes by dtype. Returns the
    record and the undo."""
    rec = {"wire": []}
    step_fn = t._step_fn

    def step(state, errs, batches):
        with wire_bytes() as w:
            out = step_fn(state, errs, batches)
        rec["wire"].append(dict(w))
        return out

    functools.update_wrapper(step, step_fn)
    t._step_fn = step

    def undo():
        t._step_fn = step_fn
    return rec, undo


def step_flops(t: Trainer, params) -> float:
    """``op_cost``'s FLOPs of one step of ``t`` from ``params`` on the
    next batch, every rank taking part. Counted apart from the run: the
    counter decomposes the ops it has no formula for, which can move the
    bits."""
    state = t.initial_state(params)
    errs = None if t.tcfg.grad_compression is None else [
        [x.new_zeros(x.shape) for x in state.master.parameters()]]
    _, cost = op_cost.count(t._step_fn, state, errs,
                            t.data.next_placed_batch(t.mesh))
    return cost.totals()["flops"]


def state_arrays(state, errors) -> dict:
    """Each held shard's master (pieces, or the whole model's parameters),
    m and v slices and error-feedback buffers, as numpy."""
    def arrays(x):
        return [t.detach().numpy().copy() for t in x]

    return {"master": [arrays(x) for x in state.held_masters()],
            "m": [arrays(x) for x in state.m],
            "v": [arrays(x) for x in state.v],
            "errors": [arrays(x) for x in (errors or [])]}


def trainer_case(mesh, name: str, root: str, inits: dict) -> dict:
    family, pods, d, m, kw = CASES[name]
    # the parent's stacked runs write the checkpoints it restores
    t = Trainer(cfg(family), opt(), tcfg(pods, d, m, f"{root}/{name}",
                                         ckpt_every=10 ** 9, **kw),
                mesh=mesh, log_fn=quiet)
    rec, undo = counted(t)
    params = tfm.load_reference_params(cfg(family), inits[family],
                                       device="cpu")
    s = t.run(t.initial_state(params))
    undo()
    out = {"losses": [h["loss"] for h in t.history], **rec,
           **state_arrays(s, t.errors)}
    if name in COUNTED:
        out["flops"] = step_flops(t, params)
    return out


def run_cases(rank_mesh, spec: dict) -> dict:
    """Every case on this rank: ``{case: result}``."""
    out = {}
    for name, (_, pods, d, m, _) in CASES.items():
        mesh = make_debug_mesh(data=d, model=m, pods=pods, device="cpu")
        out[name] = trainer_case(mesh, name, spec["root"], spec["init"])
    return out


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)
