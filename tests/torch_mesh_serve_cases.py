"""The rank side of ``tests/test_torch_mesh_serve.py``: what each of four
gloo ranks runs, in processes started by
``repro_torch.parallel.launch.spawn_ranks``, and the run the parent holds
them to in the stacked form.

Every rank makes the subgroup of the first two ranks and runs each case
on a ``launch.mesh.ProcessMesh`` over the group of its size when it is a
member: the prefill of ``BATCH`` prompts of ``SEQ`` tokens into a cache of
``MAX_LEN`` positions, then ``TICKS`` greedy decode steps, each step's
bytes handed to the collectives counted by dtype. The module imports
neither JAX nor ``repro``: the ranks run the port alone.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

import torch_model_axis_cases as axis_cases
from torch_production_mesh_cases import wire_bytes
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import io_spec
from repro_torch.models import tensor_parallel as tp
from repro_torch.models import transformer as tfm

SEQ, MAX_LEN, BATCH, TICKS = 32, 64, 4, 4
#: the vision stub's patches and the audio stub's frames a row
STUB = 8
FAMILIES = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b",
            "vlm": "llava-next-mistral-7b", "ssm": "mamba2-1.3b",
            "hybrid": "zamba2-2.7b", "encdec": "seamless-m4t-large-v2"}
#: (data, model): the KV-head rule at model 2, the query rows at 4
MESHES = axis_cases.MESHES


def case_names() -> dict:
    """``{name: (family, data, model)}``; the 8-head GQA config at (1, 4)
    takes the GQA-group rule."""
    out = {f"{fam}_{d}x{m}": (fam, d, m) for fam in FAMILIES
           for d, m in MESHES}
    out["gqa_1x4"] = ("gqa", 1, 4)
    return out


def cfg(family: str):
    if family == "gqa":
        return dataclasses.replace(cfg("dense"), **axis_cases.GQA)
    return configs.reduce(configs.get(FAMILIES[family]))


def inputs(family: str, seed: int = 0) -> dict:
    """The prompts of ``family`` as numpy arrays: ``BATCH`` x ``SEQ``
    token ids, and ``STUB`` patches or frames a row ~ N(0, 1)."""
    c = cfg(family)
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, c.vocab, (BATCH, SEQ)).astype(np.int32)}
    key = {"vision_stub": "patches", "audio_stub": "frames"}.get(c.frontend)
    if key:
        b[key] = rng.standard_normal((BATCH, STUB, io_spec.STUB_DIM)) \
            .astype(np.float32)
    return b


def params_of(family: str, inits: dict):
    """The one-device ``Transformer`` of ``family`` from the reference's
    initial tree (the 8-head config's: the dense one's, whose shapes it
    does not share, so drawn from seed 0 by the port)."""
    if family == "gqa":
        return tfm.init_params(cfg(family), 0, device="cpu")
    return tfm.load_reference_params(cfg(family), inits[family],
                                     device="cpu")


def _arrays(ts) -> list:
    return [t.detach().numpy().copy() for t in ts]


def serve_run(mesh, family: str, params, batch: dict, *,
              tally: bool = True) -> dict:
    """The prefill and ``TICKS`` greedy decode steps on ``mesh`` (a rank's
    or the stacked form), every held shard's arrays: ``logits`` (the
    prefill's, then each step's), ``tokens`` (the greedy token after each
    of them), ``cache_prefill`` and ``cache`` (after the last step), each
    ``{name: array}``; with ``tally`` each step's bytes handed to the
    collectives by dtype (``wire``)."""
    c = cfg(family)
    prefill = steps.make_prefill_step(c, MAX_LEN, mesh)
    ctx = prefill.ctx
    pieces = tp.serve_pieces(ctx.layout, params, ctx.ranks)
    rows = BATCH // mesh.dp_size
    batches = [{k: torch.from_numpy(v[q * rows:(q + 1) * rows])
                for k, v in batch.items()}
               for q in (mesh.dp_index(s) for s in mesh.local)]
    out = {"logits": [], "tokens": [], "wire": []}

    def step(fn):
        with wire_bytes() as w:
            got = fn()
        if tally:
            out["wire"].append(dict(w))
        return got

    def decode():
        lg, cs = tp.forward_decode(ctx, pieces, toks, caches)
        return lg, cs, tp.next_tokens(ctx, lg)

    # each decode step as ``launch.steps.make_decode_step``'s: the
    # forward, then the argmax across the shards
    logits, caches = step(lambda: prefill(pieces, batches))
    out["cache_prefill"] = [{k: v.numpy().copy() for k, v in cache.items()}
                            for cache in caches]
    toks = tp.next_tokens(ctx, logits)
    for i in range(TICKS + 1):
        if i:
            logits, caches, toks = step(decode)
        out["logits"].append(_arrays(logits))
        out["tokens"].append(_arrays(toks))
    out["cache"] = [{k: v.numpy().copy() for k, v in cache.items()}
                    for cache in caches]
    return out


def run_cases(rank_mesh, spec: dict) -> dict:
    """Every case on this rank: ``{case: result}``."""
    pair = dist.new_group([0, 1])
    rank = rank_mesh.rank
    out = {}
    for name, (family, d, m) in case_names().items():
        if rank >= d * m:
            continue
        mesh = make_debug_mesh(data=d, model=m, device="cpu",
                               group=pair if d * m == 2 else None)
        out[name] = serve_run(mesh, family, params_of(family, spec["init"]),
                              spec["inputs"][family])
    return out
