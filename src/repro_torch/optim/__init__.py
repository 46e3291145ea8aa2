"""Optimizer: AdamW on a float32 master, its schedule, and E8MY gradient
compression (the port of ``repro.optim`` on one device)."""
from . import adamw, compression  # noqa: F401
from .adamw import (OptConfig, TrainState, apply_updates,  # noqa: F401
                    global_norm, init_state, lr_at)
