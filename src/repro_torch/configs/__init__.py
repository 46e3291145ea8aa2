"""Architecture registry: ``get(arch_id)`` and ``reduce()`` for smoke tests.

The 10 assigned architectures (exact public configs; shapes only, no
weights). A copy of the reference's registry and its ten config modules,
which are data: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "internlm2-20b": "internlm2_20b",
    "yi-6b": "yi_6b",
    "granite-3-2b": "granite_3_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "dbrx-132b": "dbrx_132b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> ModelConfig:
    key = arch_id.replace("_", "-") if arch_id not in _MODULES else arch_id
    if key not in _MODULES:
        # allow module-style ids too
        key = arch_id.replace("_", "-").replace("-0-5b", "-0.5b") \
            .replace("-a2-7b", "-a2.7b").replace("-2-7b", "-2.7b") \
            .replace("-1-3b", "-1.3b")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    return mod.CONFIG


def reduce(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (assignment rule: small
    layers/width, few experts, tiny vocab)."""
    r = dict(
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=128,
        d_ff=0 if cfg.family == "ssm" else 256,
        vocab=512,
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.n_heads:
        r.update(n_heads=4, n_kv_heads=2, head_dim=32)
    if cfg.family == "moe":
        r.update(n_experts=8, top_k=2,
                 n_shared_experts=min(cfg.n_shared_experts, 2), d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        r.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        r.update(attn_every=2)
    if cfg.enc_layers:
        r.update(enc_layers=2)
    if cfg.frontend:
        r.update(frontend_len=8)
    return dataclasses.replace(cfg, **r)
