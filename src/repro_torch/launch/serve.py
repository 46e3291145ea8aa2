"""Serving launcher: the continuous-batching decode engine for an assigned
architecture (the dense, moe, ssm and hybrid families), fed with
synthetic requests. Reduced config by default, the published widths and
depth with ``--full``; on the GPU unless ``--device cpu``. The parameters are drawn
straight into the compute dtype (``init_params(..., dtype=cfg.dtype)``),
one copy on the device. A vlm config fails at its first prefill with a
``KeyError`` on ``'patches'``, as the reference's does: the engine
prefills tokens only. An encdec config exits before drawing anything, as
the reference's does: it needs encoder frames, which the engine does not
take (``forward_prefill``/``forward_decode`` serve it).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        [--full] [--device cpu] [--requests 8 --slots 4 --max-new 8]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --full
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import _device, configs
from repro_torch.models import transformer as tfm
from repro_torch.serving import DecodeEngine, ServeConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the published config, not the reduced one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if not args.full:
        cfg = configs.reduce(cfg)
    if cfg.family == "encdec":
        raise SystemExit("enc-dec serving needs encoder inputs; drive "
                         "models.transformer.forward_prefill (with "
                         "batch['frames']) and forward_decode directly")
    dev = _device.resolve_device(args.device)
    params = tfm.init_params(cfg, args.seed, device=dev, dtype=cfg.dtype)
    eng = DecodeEngine(cfg, params, ServeConfig(
        slots=args.slots, max_len=args.max_len,
        temperature=args.temperature, seed=args.seed), device=dev)
    del params
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(4, 12))
        eng.submit(rng.integers(1, cfg.vocab, size=plen), args.max_new)
    eng.run()
    st = eng.stats()
    print(f"[serve] {cfg.name} on {dev}: {st['requests']} requests, "
          f"{st['tokens']} tokens, {st['tokens_per_s']:.2f} tok/s, "
          f"mean TTFT {st['mean_ttft_s'] * 1e3:.0f} ms, "
          f"mean latency {st['mean_latency_s'] * 1e3:.0f} ms")


if __name__ == "__main__":
    main()
