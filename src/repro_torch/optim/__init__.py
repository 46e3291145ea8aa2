"""Optimizer: AdamW on a float32 master, its schedule, ZeRO over the
data-parallel shards, and E8MY gradient compression with the integer
wire (the port of ``repro.optim``)."""
from . import adamw, compression  # noqa: F401
from .adamw import (OptConfig, TrainState, apply_updates,  # noqa: F401
                    global_norm, init_state, lr_at)
