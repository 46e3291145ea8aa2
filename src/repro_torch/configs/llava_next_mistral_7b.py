"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

anyres tiling: the frontend stub supplies 2880 precomputed patch embeddings
(5 tiles x 576 patches) per the assignment; only the LM backbone is built.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, head_dim=128,
    frontend="vision_stub", frontend_len=2880,
)
