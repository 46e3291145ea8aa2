"""Training: the trainer loop, checkpoints, fault handling (the port of
``repro.train`` on one device)."""
from .checkpoint import CheckpointManager  # noqa: F401
from .fault import PreemptionGuard, StepMonitor  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
