"""The LM stack on PyTorch: configs, layers, attention (cross-attention
included), the moe layer, Mamba2, the transformer and PackSELL-pruned
linear layers (the port of ``repro.models``' serving path, all six
families)."""
from . import (attention, config, layers, moe, sparse_linear,  # noqa: F401
               ssm, transformer)
from .config import (SHAPES, ModelConfig, ShapeConfig,  # noqa: F401
                     cell_applicable)
