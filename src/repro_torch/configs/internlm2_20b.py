"""InternLM2-20B [arXiv:2403.17297; hf] — dense GQA."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92544, head_dim=128,
)
