"""Training launcher: ``--arch <id>`` selects an assigned architecture (the
published widths and depth, or with ``--reduce`` its reduced twin) and
runs the fault-tolerant Trainer on one device: the GPU unless ``--device
cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        [--reduce] [--device cpu] [--steps 20 --seq-len 128 --global-batch 4]

``--data-axis``/``--model-axis`` other than 1 raise: they need the
multi-card mesh.
"""
from __future__ import annotations

import argparse

from repro_torch import _device, configs
from repro_torch.optim import OptConfig
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None) -> Trainer:
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduce:
        cfg = configs.reduce(cfg)
    dev = _device.resolve_device(args.device)
    print(f"[launch] {cfg.name} ({cfg.family}) "
          f"~{cfg.param_count() / 1e6:.1f}M params on {dev}")
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=max(args.steps // 10, 1),
        seq_len=args.seq_len, global_batch=args.global_batch,
        microbatch=args.microbatch,
        data_axis=args.data_axis, model_axis=args.model_axis,
        grad_compression=args.grad_compression)
    opt = OptConfig(lr_peak=args.lr, warmup=max(args.steps // 10, 1),
                    total_steps=args.steps)
    trainer = Trainer(cfg, opt, tcfg, device=dev)
    trainer.run()
    print(f"[launch] done; checkpoints: {trainer.ckpt.steps()}")
    return trainer


if __name__ == "__main__":
    main()
