"""Async micro-batching serving tier for compiled LUT networks.

The port of ``repro.serve`` on one torch device: ``ServingTier``
coalesces concurrent ragged requests into ``block_b``-bucketed batches and
applies bounded-queue backpressure and per-request timeouts;
:class:`HttpIngress` puts a network front door on it (JSON / raw-int8 over
HTTP, per-tenant token-bucket quotas, typed 429/503/408 mappings,
``/metrics`` + ``/healthz``), and the load generators measure it
closed-loop (steady state) and open-loop (Poisson arrivals, in process or
over HTTP).  ``python -m repro_torch.launch.serve --lut`` is the CLI.
"""

from repro_torch.serve.ingress import (BackgroundIngress, HttpClientPool,
                                       HttpIngress, IngressConfig,
                                       QuotaConfig, QuotaExceeded,
                                       TokenBucket, http_infer)
from repro_torch.serve.loadgen import (LoadReport, make_requests,
                                       poisson_arrivals, run_closed_loop,
                                       run_open_loop)
from repro_torch.serve.tier import (RequestTimeout, ServingTier, TierClosed,
                                    TierConfig, TierError, TierOverloaded,
                                    run_requests, serve_once)

__all__ = ["BackgroundIngress", "HttpClientPool", "HttpIngress",
           "IngressConfig", "LoadReport", "QuotaConfig", "QuotaExceeded",
           "RequestTimeout", "ServingTier", "TierClosed", "TierConfig",
           "TierError", "TierOverloaded", "TokenBucket", "http_infer",
           "make_requests", "poisson_arrivals", "run_closed_loop",
           "run_open_loop", "run_requests", "serve_once"]
