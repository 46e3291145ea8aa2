"""Training: the trainer loop on one device or over the data-parallel
shards of a mesh, checkpoints with elastic restore, fault handling (the
port of ``repro.train``)."""
from .checkpoint import CheckpointManager  # noqa: F401
from .fault import PreemptionGuard, StepMonitor  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
