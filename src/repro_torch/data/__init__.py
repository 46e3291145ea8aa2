"""Data: the deterministic, resumable synthetic token stream (the port of
``repro.data`` on one device)."""
from .synthetic import (DataConfig, SyntheticTokenStream,  # noqa: F401
                        markov_table)
