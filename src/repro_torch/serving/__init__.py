"""Serving: the resilient SpMV/solve request front end and its policies.

The port of ``repro.serving``'s front end. The reference's LM decode pool
(``serving.engine.DecodeEngine``) is not here: it serves the language
model stack, which the port does not carry yet.
"""
from .frontend import (AdmissionError, FrontendConfig,  # noqa: F401
                       PlanEntry, ServingFrontend)
from .frontend import Request as ServeRequest  # noqa: F401
from .policy import (AdmissionPolicy, BackoffPolicy,  # noqa: F401
                     CircuitBreaker, DegradationPolicy, ManualClock,
                     RequestClass, tier_error_budget)
