"""Observability of the port: the metrics registry (with OpenMetrics
exemplars), the span tracer, request-scoped tracing, the flight recorder
SLO burn accounting, the sampled dispatch profiler and its cost model —
stdlib-only copies of the JAX package's
``obs/{metrics,trace,reqtrace,flight,slo,profile,costmodel}.py``
(``profile`` and ``costmodel`` are imported by name, as in the
reference)."""

from .flight import FlightRecorder
from .metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, default_registry)
from .reqtrace import (RequestContext, RequestTracer, format_traceparent,
                       parse_traceparent)
from .slo import SloBurn
from .trace import Tracer

__all__ = ["Counter", "DEFAULT_BUCKETS", "FlightRecorder", "Gauge",
           "Histogram", "MetricsRegistry", "RequestContext",
           "RequestTracer", "SloBurn", "Tracer", "default_registry",
           "format_traceparent", "parse_traceparent"]
