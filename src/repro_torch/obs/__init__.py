"""Observability for the port's serving stack (metrics + span tracing).

Own copies of ``repro.obs`` (stdlib only) with the same metric names; the
port records into its own process-default :class:`Registry`.
"""

from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, Counter, Family,
                                     Gauge, Histogram, Registry, REGISTRY,
                                     registry)
from repro_torch.obs.report import PeriodicReporter, summary_line
from repro_torch.obs.trace import REQUEST_STAGES, Span

__all__ = ["Counter", "DEFAULT_TIME_BUCKETS", "Family", "Gauge",
           "Histogram", "PeriodicReporter", "REGISTRY", "REQUEST_STAGES",
           "Registry", "Span", "registry", "summary_line"]
