"""Serving: the LM decode pool with continuous batching, and the
resilient SpMV/solve request front end and its policies.

The port of ``repro.serving``. ``DecodeEngine`` serves the dense family
of ``repro_torch.models`` (the other families are ROADMAP M11's later
slices), its decode step one CUDA graph per engine.
"""
from .engine import (DecodeEngine, Request, ServeConfig,  # noqa: F401
                     WarmupSpec)
from .frontend import (AdmissionError, FrontendConfig,  # noqa: F401
                       PlanEntry, ServingFrontend)
from .frontend import Request as ServeRequest  # noqa: F401
from .policy import (AdmissionPolicy, BackoffPolicy,  # noqa: F401
                     CircuitBreaker, DegradationPolicy, ManualClock,
                     RequestClass, tier_error_budget)
