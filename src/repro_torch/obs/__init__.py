"""Observability for the port's serving stack (metrics + request span
tracing) and its LM train and prefill steps (step spans, read by a
profiler).

Own copies of ``repro.obs`` (stdlib only) with the same metric names; the
port records into its own process-default :class:`Registry`.  Step spans
(``span``, ``spans_enabled``) are the port's own.
"""

from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, Counter, Family,
                                     Gauge, Histogram, Registry, REGISTRY,
                                     registry)
from repro_torch.obs.report import PeriodicReporter, summary_line
from repro_torch.obs.trace import (REQUEST_STAGES, Span, span,
                                   spans_enabled)

__all__ = ["Counter", "DEFAULT_TIME_BUCKETS", "Family", "Gauge",
           "Histogram", "PeriodicReporter", "REGISTRY", "REQUEST_STAGES",
           "Registry", "Span", "registry", "span", "spans_enabled",
           "summary_line"]
