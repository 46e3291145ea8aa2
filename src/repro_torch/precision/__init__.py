"""Adaptive precision: the decision layer above the format.

* :mod:`.analyze` — per-matrix value/delta statistics, an a-priori
  quantization-error model per codec, and a cheap empirical probe;
* :mod:`.select` — an error budget → a
  :class:`~.select.PrecisionPlan` (globally or per row-class), and the
  tier ladder ``solvers.cg.adaptive_pcg`` promotes through;
* :mod:`.mixed` — :class:`~.mixed.MixedPackSELL`, rows split by required
  precision into format blocks at different codecs, one composite
  operator;
* :mod:`.store` — the on-disk store of selections and tile winners, keyed
  by a matrix fingerprint, in the reference's file format.

The port of ``repro.precision``.
"""
from .analyze import (AnalysisReport, CandidateReport, analyze_matrix,  # noqa: F401
                      matrix_stats, model_error, probe_error,
                      probe_error_rows)
from .mixed import MixedPackSELL  # noqa: F401
from .select import (PrecisionClass, PrecisionPlan, select_codec,  # noqa: F401
                     tier_ladder)
from .store import PrecisionStore, matrix_fingerprint  # noqa: F401
