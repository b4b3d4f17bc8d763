"""Async micro-batching serving tier for compiled LUT networks.

The port of ``repro.serve`` on one torch device: ``ServingTier``
coalesces concurrent ragged requests into ``block_b``-bucketed batches,
applies bounded-queue backpressure and per-request timeouts, and the load
generators measure it closed-loop (steady state) and open-loop (Poisson
arrivals).  The HTTP ingress waits for a later slice.
"""

from repro_torch.serve.loadgen import (LoadReport, make_requests,
                                       poisson_arrivals, run_closed_loop,
                                       run_open_loop)
from repro_torch.serve.tier import (RequestTimeout, ServingTier, TierClosed,
                                    TierConfig, TierError, TierOverloaded,
                                    run_requests, serve_once)

__all__ = ["LoadReport", "RequestTimeout", "ServingTier", "TierClosed",
           "TierConfig", "TierError", "TierOverloaded", "make_requests",
           "poisson_arrivals", "run_closed_loop", "run_open_loop",
           "run_requests", "serve_once"]
