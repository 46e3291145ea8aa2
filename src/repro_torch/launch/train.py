"""Training launcher: ``--arch <id>`` selects an assigned architecture (the
published widths and depth, or with ``--reduce`` its reduced twin) and
runs the fault-tolerant Trainer: on the GPU unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        [--reduce] [--device cpu] [--steps 20 --seq-len 128 --global-batch 4]

With ``--data-axis N`` (and ``--pods 2``, ``--pod-wire u16|u8``) and
``--model-axis M`` it starts ``pods × N × M`` ranks through
``parallel.launch.spawn_ranks``, one shard each (the model index
innermost), on a ``launch.mesh.ProcessMesh``: tensor-parallel layers over
the M model shards (``models.tensor_parallel``), ZeRO over the data
shards within each. The backend is chosen before the run and printed, and
nothing is tried and caught:

* NCCL where the ranks run on the card and there is one card per rank;
* gloo otherwise: on the CPU (``--device cpu``), with ranks sharing one
  card (every collective staged through the host), or when ``--backend
  gloo`` asks for it. ``--backend nccl`` with too few cards raises.

Rank 0 logs and writes the checkpoints. ``--grad-compression N`` with
``--model-axis M`` runs the reference's compressed step replicated over
the model shards; ``--pods 2 --pod-wire u16|u8`` with ``--model-axis M``
the tensor-parallel step whose gradients cross the pods through the wire
(``launch.steps``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduce --device cpu --data-axis 2 --model-axis 2 \\
        --grad-compression 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduce --device cpu --pods 2 --model-axis 2 --pod-wire u16
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import _device, configs
from repro_torch.optim import OptConfig
from repro_torch.train import Trainer, TrainerConfig

#: the ranks' join timeout, seconds
TIMEOUT_S = 3600.0


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--reduce", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--microbatch", type=int, default=None,
                    help="gradient-accumulation microbatch size")
    ap.add_argument("--ckpt-dir", default="build/repro_launch_train")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", type=int, default=None)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1,
                    help="a leading pod axis (ranks = pods x data axis)")
    ap.add_argument("--pod-wire", choices=("u16", "u8"), default=None,
                    help="the gradient wire across the pods")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' backend (default: NCCL with a card per "
                    "rank, else gloo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def _trainer(args, device, mesh=None) -> Trainer:
    cfg = configs.get(args.arch)
    if args.reduce:
        cfg = configs.reduce(cfg)
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=max(args.steps // 10, 1),
        seq_len=args.seq_len, global_batch=args.global_batch,
        microbatch=args.microbatch,
        data_axis=args.data_axis, model_axis=args.model_axis,
        pods=args.pods, pod_wire=args.pod_wire,
        grad_compression=args.grad_compression)
    opt = OptConfig(lr_peak=args.lr, warmup=max(args.steps // 10, 1),
                    total_steps=args.steps)
    if mesh is None or mesh.lead:
        where = device if mesh is None else (
            f"{mesh.size} ranks ({mesh.pods} x {mesh.data} x {mesh.model} "
            f"pod x data x model, {mesh.backend}) on {device}")
        print(f"[launch] {cfg.name} ({cfg.family}) "
              f"~{cfg.param_count() / 1e6:.1f}M params on {where}",
              flush=True)
    return Trainer(cfg, opt, tcfg, device=device, mesh=mesh)


def _rank(rank_mesh, args) -> list:
    """One rank: the mesh over the spawned group, the trainer, its run;
    returns the history."""
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(data=args.data_axis, pods=args.pods,
                           model=args.model_axis, device=rank_mesh.device)
    trainer = _trainer(args, mesh.device, mesh)
    trainer.run()
    if mesh.lead:
        print(f"[launch] done; checkpoints: {trainer.ckpt.steps()}",
              flush=True)
    return trainer.history


def _backend(world: int, device: torch.device, backend: str | None) -> tuple:
    """``(backend, device of every rank (None: one card per rank), why)``
    for ``world`` ranks on ``device``."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if backend is None:
        backend = "nccl" if device.type == "cuda" and cards >= world \
            else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {device}")
        if cards < world:
            raise ValueError(f"{world} NCCL ranks need {world} cards, "
                             f"{cards} are visible")
        return "nccl", None, f"NCCL, one card per rank ({cards} visible)"
    why = ("on the CPU" if device.type != "cuda" else
           f"{world} ranks sharing {device}, every collective staged "
           f"through the host" if cards < world else
           f"on {device} (asked for)")
    return "gloo", device, f"gloo, {why}"


def main(argv=None):
    args = _parse(argv)
    dev = _device.resolve_device(args.device)
    world = args.data_axis * args.pods * args.model_axis
    if world > 1:
        from repro_torch.parallel.launch import spawn_ranks

        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        backend, rank_dev, why = _backend(world, dev, args.backend)
        print(f"[launch] {world} ranks: {why}", flush=True)
        return spawn_ranks(_rank, world, backend=backend, device=rank_dev,
                           timeout=TIMEOUT_S, args=(args,))[0]
    trainer = _trainer(args, dev)
    trainer.run()
    print(f"[launch] done; checkpoints: {trainer.ckpt.steps()}")
    return trainer


if __name__ == "__main__":
    main()
