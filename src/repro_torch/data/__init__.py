"""Data: the deterministic, resumable synthetic token stream, each
data-parallel shard generating its own rows (the port of
``repro.data``)."""
from .synthetic import (DataConfig, SyntheticTokenStream,  # noqa: F401
                        markov_table)
