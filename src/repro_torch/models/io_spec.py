"""The inputs of every (arch × shape) dry-run cell, as meta tensors.

The port of the reference's ``models/io_spec.py``: ``STUB_DIM`` and
``frontend_lens`` are copies (the port imports nothing of ``repro``), and
the builders return ``torch.empty(shape, dtype=..., device="meta")``
where the reference returns ``ShapeDtypeStruct``s, with its keys, shapes
and dtypes. Shapes are global: the port runs a cell on one device.
Modality frontends are stubs: ``patches`` / ``frames`` are precomputed
embeddings of width ``STUB_DIM``.
"""
from __future__ import annotations

import torch

from .config import ModelConfig, ShapeConfig

STUB_DIM = 1024


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def frontend_lens(cfg: ModelConfig, seq_len: int) -> tuple[int, int]:
    """(frontend tokens, text tokens) for a given total sequence length."""
    if cfg.frontend == "vision_stub":
        p = min(cfg.frontend_len, seq_len // 2)
        return p, seq_len - p
    if cfg.frontend == "audio_stub":
        return seq_len // 4, seq_len          # encoder frames, decoder tokens
    return 0, seq_len


def _frontend(cfg: ModelConfig, spec: dict, B: int, fl: int) -> dict:
    if cfg.frontend == "vision_stub":
        spec["patches"] = _meta((B, fl, STUB_DIM), torch.bfloat16)
    if cfg.frontend == "audio_stub":
        spec["frames"] = _meta((B, fl, STUB_DIM), torch.bfloat16)
    return spec


def train_batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    fl, tl = frontend_lens(cfg, S)
    spec = {
        "tokens": _meta((B, tl), torch.int32),
        "labels": _meta((B, tl), torch.int32),
        "mask": _meta((B, tl), torch.float32),
    }
    return _frontend(cfg, spec, B, fl)


def prefill_batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    fl, tl = frontend_lens(cfg, S)
    return _frontend(cfg, {"tokens": _meta((B, tl), torch.int32)}, B, fl)


def decode_spec(cfg: ModelConfig, shape: ShapeConfig, *,
                device="meta") -> tuple[dict, dict]:
    """(token spec, cache) for a serve step with a ``seq_len`` cache: the
    zeroed cache of ``transformer.init_cache`` on ``device`` (meta: no
    allocation), its keys sorted as the reference's (``jax.eval_shape``
    returns a dict in sorted key order); the encdec cache holds the
    encoder frames of ``frontend_lens``."""
    from . import transformer as tfm

    B, S = shape.global_batch, shape.seq_len
    cache = tfm.init_cache(cfg, B, S, enc_len=frontend_lens(cfg, S)[0],
                           device=device)
    tokens = torch.empty((B, 1), dtype=torch.int32, device=device)
    return {"tokens": tokens}, dict(sorted(cache.items()))
