#!/usr/bin/env python3
"""The LM decode tick of one checkout's ``repro_torch`` on one NVIDIA GPU.

Builds granite-3-2b at its published widths and depth from seed 0 on the
card, ``DecodeEngine`` with 4 slots and ``max_len`` 512, serves 8 greedy
requests of 4-11 tokens and 16 new tokens each, and then, from the pool's
state after them, profiles the decode tick as phase 14 of
``chip_smoke.py`` does (``chip_smoke.tick_profile``): a graph tick
against an eager tick bit for bit, their walls (medians of 5), the device
time by CUDA events over 25 graph replays (median of 5 such windows), and
the device ops counted on the host. It prints one JSON line with the
card's name and power limit.

    python3 scripts/compare_lm_tick.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is loaded
(default: this checkout's), so that two checkouts compare on one card in
one call: run parent, change, change, parent, each in its own process.
It takes checkouts whose ``init_params`` has no ``dtype`` argument (the
engine then casts a float32 model, 2.5 B parameters, which fits).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCH, SEED, REPS, WINDOWS = "granite-3-2b", 0, 25, 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_lm_tick: no CUDA device", file=sys.stderr)
        return 2
    # chip_smoke (its timers) puts this checkout's src first; --src goes
    # before it, and repro_torch is imported from there
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import DecodeEngine, ServeConfig, WarmupSpec

    dev = torch.device("cuda")
    cfg = configs.get(ARCH)
    rng = np.random.default_rng(SEED)
    params = tfm.init_params(cfg, SEED, device=dev)
    eng = DecodeEngine(cfg, params, ServeConfig(slots=4, max_len=512,
                                                seed=SEED), device=dev)
    del params
    prompts = [rng.integers(1, cfg.vocab, size=int(p))
               for p in rng.integers(4, 12, size=8)]
    eng.warmup(WarmupSpec(prompt_lens=tuple(sorted({len(p)
                                                     for p in prompts}))))
    for p in prompts:
        eng.submit(p, 16)
    eng.run()
    eng.tokens.copy_(torch.from_numpy(eng.last_token[:, None]))
    prof = cs.tick_profile(eng, eng.state(), runs=5, reps=REPS,
                           windows=WINDOWS)
    ops = prof["ops"]
    print(json.dumps({
        "src": args.src, "repro_torch": str(Path(tfm.__file__).parents[1]),
        "arch": cfg.name, "card": cs.card_line(),
        "tick_device_ms": prof["ms"], "tick_device_ms_runs": prof["windows"],
        "tick_wall_graph_s": prof["wall_graph"],
        "tick_wall_eager_s": prof["wall_eager"],
        "device_ops": sum(ops.values()),
        "ops": dict(ops.most_common(8)),
        "tokens": [r.out_tokens for r in eng.done][:2],
        "at": time.strftime("%Y-%m-%dT%H:%M:%S")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
