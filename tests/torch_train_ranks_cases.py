"""The rank side of ``tests/test_torch_train_ranks.py``: what each of four
gloo ranks runs, in processes started by
``repro_torch.parallel.launch.spawn_ranks``.

Every rank makes the subgroups of the first one and two ranks (in the
same order), and runs each case on a ``launch.mesh.ProcessMesh`` over
the group of its size when it is a member. The results go back to the
parent, which holds them to the stacked form (every shard in one
process), to today's one-device trainer and to the reference. The module
imports neither JAX nor ``repro``: the ranks run the port alone.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticTokenStream
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import ZERO_ENTRY, ZeroLeaf
from repro_torch.optim import compression as comp
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt

ARCH = "qwen2-0.5b"
SEQ, BATCH, STEPS = 32, 8, 3
#: the trainer cases: (P, pods, TrainerConfig keywords beyond data_axis)
CASES = {
    "plain_p1": (1, 1, {}),
    "plain_p2": (2, 1, {}),
    "plain_p4": (4, 1, {}),
    "comp_p2": (2, 1, {"grad_compression": 10}),
    "comp_p4": (4, 1, {"grad_compression": 10}),
    "wire_u16_p2": (2, 2, {"pod_wire": "u16"}),
    "wire_u16_p4": (4, 2, {"pod_wire": "u16"}),
    "wire_u8_p4": (4, 2, {"pod_wire": "u8"}),
}
SUBGROUPS = (1, 2)


def cfg():
    return configs.reduce(configs.get(ARCH))


def opt():
    return OptConfig(warmup=1, total_steps=STEPS)


def tcfg(P: int, pods: int, ckpt_dir: str, **kw) -> TrainerConfig:
    return TrainerConfig(steps=kw.pop("steps", STEPS), ckpt_dir=ckpt_dir,
                         ckpt_every=kw.pop("ckpt_every", 2), log_every=100,
                         seq_len=SEQ, global_batch=BATCH, data_axis=P // pods,
                         pods=pods, **kw)


def quiet(_):
    pass


def state_arrays(t: Trainer, state) -> dict:
    """The master as reference leaves, and each held shard's m and v
    slices, as numpy."""
    return {"master": {k: np.asarray(v) for k, v in ckpt.flatten_with_paths(
                tfm.to_reference_params(state.master)).items()},
            "m": [[x.numpy() for x in sl] for sl in state.m],
            "v": [[x.numpy() for x in sl] for sl in state.v]}


def trainer_case(mesh, name: str, root: str, init: dict) -> dict:
    """Case ``name`` from the reference's initial parameters ``init``."""
    P, pods, kw = CASES[name]
    t = Trainer(cfg(), opt(), tcfg(P, pods, f"{root}/{name}", **dict(kw)),
                mesh=mesh, log_fn=quiet)
    s = t.run(t.initial_state(tfm.load_reference_params(cfg(), init,
                                                        device="cpu")))
    return {"losses": [h["loss"] for h in t.history], **state_arrays(t, s)}


def resume_case(mesh, src: str, root: str) -> dict:
    """A trainer on this mesh restores the latest checkpoint under ``src``
    (copied by the parent) and runs to step 3."""
    t = Trainer(cfg(), opt(), tcfg(mesh.size, 1, src, ckpt_every=100),
                mesh=mesh, log_fn=quiet)
    s0 = t.init_or_restore()
    out = {"restored_step": int(s0.step),
           "m0": [x.numpy().copy() for x in s0.m[0]]}
    s = t.run(s0)
    out["losses"] = [h["loss"] for h in t.history]
    out.update(state_arrays(t, s))
    return out


def restore_case(mesh, directory: str) -> dict:
    """``restore_resharded`` of every leaf of the latest checkpoint in
    ``directory`` by its stored spec on this mesh."""
    arrays, meta = ckpt.CheckpointManager(directory).load_raw()
    template = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
                if v.dtype == np.float32 else
                torch.empty(v.shape, dtype=torch.int32, device="meta")
                for k, v in arrays.items()}
    got = ckpt.restore_resharded(template, arrays, meta, mesh=mesh)
    return {k: v.numpy() for k, v in got.items()}


def rows_case(mesh) -> list:
    """This rank's rows of two consecutive batches."""
    c = cfg()
    data = SyntheticTokenStream(DataConfig(vocab=c.vocab, seq_len=SEQ,
                                           global_batch=BATCH, seed=0))
    return [{k: v.numpy() for k, v in data.next_placed_batch(mesh)[0].items()}
            for _ in range(2)]


def wire_case(mesh, inputs: dict) -> dict:
    """``compressed_wire_reduce`` over the data axis of this rank's input,
    for both wires."""
    g = torch.from_numpy(inputs[mesh.size][mesh.index])
    return {w: comp.compressed_wire_reduce(g, mesh, "data", w).numpy()
            for w in ("u16", "u8")}


def psum_layout(P: int) -> list:
    """``compressed_psum``'s rules for its two test leaves, ``(5,)`` whole
    on every rank (the all-reduce) and ``(3, 4)`` split along dim 1 over
    the ``P`` ranks (the reduce-scatter)."""
    return [ZeroLeaf("a", (0,), False, (5,), (None,), None, 1),
            ZeroLeaf("b", (1,), False, (3, 4), (None, ZERO_ENTRY), 1, P)]


def psum_case(mesh, inputs: dict) -> tuple:
    """``compressed_psum`` over the ranks of this rank's gradients and
    error buffers: its slices of the sum, and its new error buffers."""
    gs, es = inputs[mesh.size][mesh.index]
    s, e = comp.compressed_psum([[torch.from_numpy(g) for g in gs]],
                                [[torch.from_numpy(x) for x in es]], 10,
                                mesh=mesh, layout=psum_layout(mesh.size))
    return [x.numpy() for x in s[0]], [x.numpy() for x in e[0]]


def run_cases(rank_mesh, spec: dict) -> dict:
    """Every case of ``spec`` on this rank: ``{case: result}``."""
    groups = {P: dist.new_group(list(range(P))) for P in SUBGROUPS}
    rank = rank_mesh.rank

    def mesh(P, pods=1):
        return make_debug_mesh(data=P // pods, pods=pods, device="cpu",
                               group=groups.get(P))

    out = {}
    for name, (P, pods, _) in CASES.items():
        if rank < P:
            out[name] = trainer_case(mesh(P, pods), name, spec["root"],
                                     spec["init"])
    for P in (1, 2, 4):
        if rank < P:
            m = mesh(P)
            out[f"rows_p{P}"] = rows_case(m)
            for key, d in spec["checkpoints"].items():
                out[f"restore_{key}_p{P}"] = restore_case(m, d)
            if P > 1:
                out[f"wire_p{P}"] = wire_case(m, spec["wire"])
                out[f"psum_p{P}"] = psum_case(m, spec["psum"])
    out["resume_p4"] = resume_case(mesh(4), spec["resume"], spec["root"])
    return out
