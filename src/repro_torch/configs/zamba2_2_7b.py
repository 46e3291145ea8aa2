"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attn block.

Simplification (DESIGN.md §6): the shared transformer block (attention+MLP,
one parameter set) is applied every 6 Mamba2 layers; the reference model's
LoRA-specialized projections and concatenated residual stream are omitted.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, attn_every=6,
)
