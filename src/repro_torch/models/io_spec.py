"""The modality frontends' input sizes.

A copy of ``STUB_DIM`` and ``frontend_lens`` from the reference's
``models/io_spec.py`` (the port imports nothing of ``repro``): the
frontends are stubs whose ``patches`` / ``frames`` are precomputed
embeddings of width ``STUB_DIM``. The reference's ShapeDtypeStruct
builders belong to its dry-run launcher, which the port does not carry
yet (ROADMAP M11).
"""
from __future__ import annotations

from .config import ModelConfig

STUB_DIM = 1024


def frontend_lens(cfg: ModelConfig, seq_len: int) -> tuple[int, int]:
    """(frontend tokens, text tokens) for a given total sequence length."""
    if cfg.frontend == "vision_stub":
        p = min(cfg.frontend_len, seq_len // 2)
        return p, seq_len - p
    if cfg.frontend == "audio_stub":
        return seq_len // 4, seq_len          # encoder frames, decoder tokens
    return 0, seq_len
