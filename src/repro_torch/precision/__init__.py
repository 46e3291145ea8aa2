"""Adaptive precision: the decision layer above the format.

* :mod:`.analyze` — per-matrix value/delta statistics, an a-priori
  quantization-error model per codec, and a cheap empirical probe;
* :mod:`.select` — an error budget → a
  :class:`~.select.PrecisionPlan` (globally or per row-class), and the
  tier ladder ``solvers.cg.adaptive_pcg`` promotes through.

The port of ``repro.precision``; its ``MixedPackSELL`` and
``PrecisionStore`` are not ported yet (ROADMAP.md, M5).
"""
from .analyze import (AnalysisReport, CandidateReport, analyze_matrix,  # noqa: F401
                      matrix_stats, model_error, probe_error,
                      probe_error_rows)
from .select import (PrecisionClass, PrecisionPlan, select_codec,  # noqa: F401
                     tier_ladder)
