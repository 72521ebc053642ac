"""Serving runtime: fault tolerance, paged KV pools, slot scheduler,
telemetry, request-level tracing, and the continuous-batching engine."""

from repro_torch.runtime.trace import Tracer, validate_chrome_trace

__all__ = ["Tracer", "validate_chrome_trace"]
