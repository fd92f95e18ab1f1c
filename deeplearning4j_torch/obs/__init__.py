"""Observability of the port: metrics registry, span tracer, request-scoped
tracing, flight recorder, SLO burn accounting, the cluster telemetry plane
(time-series store, federated scrape, alerting, burn forecasting), the
sampled dispatch profiler and its cost model, and training-step telemetry
— the surface of ``deeplearning4j_tpu/obs/__init__.py``.

``obs.metrics``, ``obs.trace``, ``obs.reqtrace``, ``obs.flight``,
``obs.slo``, ``obs.tsdb``, ``obs.scrape``, ``obs.alerts``,
``obs.profile``, ``obs.costmodel``, ``obs.forecast`` and
``obs.promcheck`` are stdlib-only copies of the reference's; ``obs.step``
imports torch only inside the calls that fence or read device memory.
So importing this package loads no torch: the control planes (``sim``,
``autoscale``, ``cluster``) import it in processes that never touch the
card. ``TelemetryListener``, a ``train`` listener, is imported on first
use of the name.
"""

from .alerts import (AlertEngine, AlertRule, StdoutNotifier,
                     WebhookNotifier, default_rules, rules_from_config)
from .costmodel import (CostProfile, ProfileAccumulator, get_profile,
                        put_profile)
from .flight import FlightRecorder
from .forecast import BurnForecaster, Forecast
from .metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, default_registry)
from .profile import Profiler
from .profile import install as install_profiler
from .profile import uninstall as uninstall_profiler
from .reqtrace import (RequestContext, RequestTracer, format_traceparent,
                       parse_traceparent)
from .scrape import FederatedScraper
from .slo import SloBurn
from .step import StepTelemetry
from .trace import Tracer
from .tsdb import TimeSeriesStore


def __getattr__(name):
    if name == "TelemetryListener":  # pulls in train (and torch)
        from .listener import TelemetryListener

        return TelemetryListener
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "default_registry", "Tracer", "StepTelemetry", "TelemetryListener",
    "RequestContext", "RequestTracer", "FlightRecorder", "SloBurn",
    "parse_traceparent", "format_traceparent",
    "TimeSeriesStore", "FederatedScraper",
    "AlertEngine", "AlertRule", "default_rules", "rules_from_config",
    "StdoutNotifier", "WebhookNotifier",
    "Profiler", "install_profiler", "uninstall_profiler",
    "CostProfile", "ProfileAccumulator", "get_profile", "put_profile",
    "BurnForecaster", "Forecast",
]
