"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf] — enc-dec; speech frontend is
a stub providing precomputed frame embeddings (assignment rule)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206, head_dim=64,
    enc_layers=24, frontend="audio_stub",
)
