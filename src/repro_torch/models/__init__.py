"""The LM stack on PyTorch: configs, layers, attention, the dense
transformer and PackSELL-pruned linear layers (the port of
``repro.models``; the dense family so far, ROADMAP M11)."""
from . import (attention, config, layers, sparse_linear,  # noqa: F401
               transformer)
from .config import (SHAPES, ModelConfig, ShapeConfig,  # noqa: F401
                     cell_applicable)
