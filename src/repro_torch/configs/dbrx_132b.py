"""DBRX-132B [hf:databricks/dbrx-base; unverified] — 16-expert top-4 MoE."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=10752, vocab=100352, head_dim=128,
    n_experts=16, top_k=4,
)
