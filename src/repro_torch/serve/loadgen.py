"""Closed- and open-loop load generators for the serving tier.

The port of ``repro.serve.loadgen``.  Two arrival models, one
:class:`LoadReport`:

* **closed loop** (:func:`run_closed_loop`) — a fixed pool of
  ``n_clients`` concurrent clients each issues its next request the
  moment the previous one resolves.  The offered load self-regulates to
  whatever the tier can absorb, so this measures *steady-state
  equilibrium* (p50/p99 latency, QPS) — the classic bench setup, and
  what ``python -m repro_torch.launch.serve --lut`` runs.
* **open loop** (:func:`run_open_loop`) — requests fire at seeded
  Poisson arrival times regardless of whether earlier ones finished,
  the way independent network clients actually behave.  Offered load is
  an *input* (``offered_rps``), so driving it past capacity is
  meaningful: the report separates goodput from rejections
  (quota / backpressure) and timeouts instead of letting the arrival
  process silently throttle — against the in-process tier or a live HTTP
  ingress (``url=...``; ``--open-loop RPS`` and ``--http`` on the CLI).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time

import numpy as np

from repro_torch.serve.tier import (RequestTimeout, ServingTier,
                                    TierClosed, TierConfig, TierError,
                                    TierOverloaded, _to_numpy)


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """Serving measurements from one load-generator run.

    Latencies are wall-clock per *successful* request (submit ->
    result), in milliseconds; ``qps`` counts completed requests per
    second over the whole run; ``rows_per_sec`` is the row-throughput
    view of the same number.  ``stats`` is the tier's own counter
    snapshot (:meth:`repro_torch.serve.ServingTier.stats`) taken at the
    end of the run — its ``retraces_after_warmup`` /
    ``compiler_runs_after_warmup`` fields are the compile-once serving
    contract (``{}`` when the run drove a remote ingress URL, whose
    tier lives elsewhere).

    Closed-loop runs complete every request, so the open-loop fields
    keep their defaults: ``offered_rps`` is the configured arrival
    rate (``nan`` = closed loop), ``goodput_rps`` counts only
    successful requests, ``outcomes`` histograms every request's fate
    (``ok`` / ``rejected_quota`` / ``rejected_overload`` / ``timeout`` /
    ``closed``), and ``rejection_rate`` is the non-``ok`` fraction.
    """

    n_clients: int
    n_requests: int
    rows: int
    wall_s: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    mean_ms: float
    qps: float
    rows_per_sec: float
    stats: dict
    breakdown: dict = dataclasses.field(default_factory=dict)
    offered_rps: float = float("nan")
    goodput_rps: float = float("nan")
    rejected: int = 0
    timed_out: int = 0
    rejection_rate: float = 0.0
    outcomes: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["stats"] = dict(self.stats)
        d["breakdown"] = {k: dict(v) for k, v in self.breakdown.items()}
        d["outcomes"] = dict(self.outcomes)
        return d


def _percentile(lat_ms: np.ndarray, q: float) -> float:
    """``np.percentile`` guarded for tiny runs: nan on an empty sample
    (np.percentile raises), the plain interpolated estimate otherwise —
    callers treat p99 of a 1-2 request run as indicative only."""
    if lat_ms.size == 0:
        return float("nan")
    return float(np.percentile(lat_ms, q))


def make_requests(n_in: int, n_requests: int, *, rows_min: int = 1,
                  rows_max: int = 8, bw: int = 2, seed: int = 0
                  ) -> list[np.ndarray]:
    """Ragged synthetic request batches: ``(rows, n_in)`` int32 codes.

    Row counts are uniform in ``[rows_min, rows_max]`` and code values in
    ``[0, 2**bw)`` — the shape of a trigger-style event stream hitting the
    tier with small, uneven batches.
    """
    rng = np.random.default_rng(seed)
    sizes = rng.integers(rows_min, rows_max + 1, n_requests)
    return [rng.integers(0, 2 ** bw, (int(k), n_in), dtype=np.int32)
            for k in sizes]


def poisson_arrivals(offered_rps: float, n_requests: int, *, seed: int = 0
                     ) -> np.ndarray:
    """Seeded Poisson arrival times (seconds from t=0), sorted ascending.

    Inter-arrival gaps are i.i.d. exponential with mean
    ``1 / offered_rps`` — the memoryless arrival process of independent
    network clients.  Same seed -> identical schedule, so open-loop
    runs are reproducible.
    """
    if offered_rps <= 0:
        raise ValueError(f"offered_rps must be positive, got {offered_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / offered_rps, n_requests)
    return np.cumsum(gaps)


async def _closed_loop(tier: ServingTier, requests: list[np.ndarray],
                       n_clients: int):
    """Serve ``requests`` through ``tier`` from a closed client pool."""
    loop = asyncio.get_running_loop()
    latencies: list[float] = []
    outs: list = [None] * len(requests)

    async def client(idxs):
        for i in idxs:
            t0 = loop.time()
            outs[i] = await tier.infer(requests[i])
            latencies.append(loop.time() - t0)

    await asyncio.gather(*[client(range(c, len(requests), n_clients))
                           for c in range(n_clients)])
    return outs, latencies


def run_closed_loop(net, *, config: TierConfig | None = None,
                    n_clients: int = 8, n_per_client: int = 16,
                    rows_min: int = 1, rows_max: int = 8, bw: int = 2,
                    seed: int = 0, check_outputs: bool = True
                    ) -> LoadReport:
    """Drive ``net`` through a :class:`ServingTier` under closed-loop load.

    Builds ``n_clients * n_per_client`` ragged synthetic requests
    (:func:`make_requests`), serves them from ``n_clients`` concurrent
    clients, and returns the latency/throughput :class:`LoadReport`.
    With ``check_outputs`` every response is verified bit-exact against a
    direct ``net(codes)`` call *after* the timed run (correctness must not
    perturb the measurement).

    >>> import numpy as np
    >>> from repro_torch import engine, serve
    >>> rng = np.random.default_rng(0)
    >>> idx = np.stack([np.sort(rng.choice(6, 2, replace=False))
    ...                 for _ in range(4)]).astype(np.int32)
    >>> tbl = rng.integers(0, 4, (4, 16), dtype=np.int32)
    >>> net = engine.compile_network([(idx, tbl, 2)], in_features=6,
    ...                              block_b=4, device="cpu")
    >>> rep = serve.run_closed_loop(net, n_clients=2, n_per_client=3,
    ...                             rows_max=3, seed=1)
    >>> rep.n_requests
    6
    >>> rep.stats["retraces_after_warmup"]          # compile-once contract
    0
    >>> rep.rejected, rep.timed_out                 # closed loop never sheds
    (0, 0)
    """
    n_requests = n_clients * n_per_client
    requests = make_requests(net.n_in, n_requests, rows_min=rows_min,
                             rows_max=rows_max, bw=bw, seed=seed)

    async def main():
        async with ServingTier(net, config) as tier:
            t0 = time.perf_counter()
            outs, lats = await _closed_loop(tier, requests, n_clients)
            wall = time.perf_counter() - t0
            return outs, lats, wall, tier.stats(), tier.latency_breakdown()

    outs, lats, wall, stats, breakdown = asyncio.run(main())
    if check_outputs:
        for req, out in zip(requests, outs):
            np.testing.assert_array_equal(out, _to_numpy(net(req)))
    lat_ms = np.sort(np.asarray(lats)) * 1e3
    rows = int(sum(r.shape[0] for r in requests))
    n_done = len(lats)
    return LoadReport(
        n_clients=n_clients,
        n_requests=n_done,
        rows=rows,
        wall_s=wall,
        p50_ms=_percentile(lat_ms, 50),
        p90_ms=_percentile(lat_ms, 90),
        p99_ms=_percentile(lat_ms, 99),
        mean_ms=float(lat_ms.mean()) if n_done else float("nan"),
        qps=n_done / wall,
        rows_per_sec=rows / wall,
        stats=stats,
        breakdown=breakdown,
    )


def _classify(exc: BaseException) -> str:
    # local import: ingress imports tier, and loadgen needs its
    # QuotaExceeded only here
    from repro_torch.serve.ingress import QuotaExceeded
    if isinstance(exc, QuotaExceeded):
        return "rejected_quota"
    if isinstance(exc, TierOverloaded):
        return "rejected_overload"
    if isinstance(exc, RequestTimeout):
        return "timeout"
    if isinstance(exc, TierClosed):
        return "closed"
    raise exc


async def _open_loop(submit, requests: list[np.ndarray],
                     arrivals: np.ndarray):
    """Fire ``requests`` at their arrival times; never wait for replies."""
    loop = asyncio.get_running_loop()
    latencies = np.full(len(requests), np.nan)
    outcomes: list[str | None] = [None] * len(requests)
    outs: list = [None] * len(requests)

    async def one(i: int, at: float, t_start: float):
        delay = t_start + at - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        t0 = loop.time()
        try:
            outs[i] = await submit(requests[i])
        except TierError as exc:
            outcomes[i] = _classify(exc)
            return
        latencies[i] = loop.time() - t0
        outcomes[i] = "ok"

    t_start = loop.time()
    await asyncio.gather(*[one(i, float(at), t_start)
                           for i, at in enumerate(arrivals)])
    return outs, latencies, outcomes


def run_open_loop(net=None, *, url: str | None = None,
                  config: TierConfig | None = None,
                  offered_rps: float = 200.0, n_requests: int = 64,
                  rows_min: int = 1, rows_max: int = 8, bw: int = 2,
                  seed: int = 0, tenant: str | None = None,
                  check_outputs: bool = True, verify_net=None,
                  n_in: int | None = None) -> LoadReport:
    """Drive open-loop Poisson-arrival load into a tier or HTTP ingress.

    Requests fire at :func:`poisson_arrivals` times whether or not
    earlier ones resolved, so ``offered_rps`` really is the offered
    load — push it past capacity and the report shows *how* the server
    sheds (``outcomes`` / ``rejection_rate``) and what it still
    completes (``goodput_rps``), instead of the arrival process backing
    off as a closed loop would.

    Exactly one target: ``net`` serves through an in-process
    :class:`ServingTier` (``config`` sets its knobs), or ``url``
    (``http://host:port``) posts raw-int8 bodies to a live HTTP ingress
    as ``tenant`` — rejections come back as the same typed exceptions
    either way, so the outcome accounting is identical.
    ``check_outputs`` verifies successful responses bit-exact after the
    timed run against ``verify_net`` (defaults to ``net``; pass it
    explicitly for ``url`` runs, or they go unverified); its outputs may
    live on any device.

    >>> import numpy as np
    >>> from repro_torch import engine, serve
    >>> rng = np.random.default_rng(0)
    >>> idx = np.stack([np.sort(rng.choice(6, 2, replace=False))
    ...                 for _ in range(4)]).astype(np.int32)
    >>> tbl = rng.integers(0, 4, (4, 16), dtype=np.int32)
    >>> net = engine.compile_network([(idx, tbl, 2)], in_features=6,
    ...                              block_b=4, device="cpu")
    >>> rep = serve.run_open_loop(net, offered_rps=500.0, n_requests=8,
    ...                           rows_max=3, seed=2)
    >>> rep.outcomes                                # capacity >> offered
    {'ok': 8}
    >>> rep.rejection_rate
    0.0
    """
    if (net is None) == (url is None):
        raise ValueError("pass exactly one of net= or url=")
    if n_in is None:
        if net is not None:
            n_in = net.n_in
        elif verify_net is not None:
            n_in = verify_net.n_in
        else:
            raise ValueError("url= mode needs verify_net= or n_in= to "
                             "size the synthetic requests")
    requests = make_requests(n_in, n_requests, rows_min=rows_min,
                             rows_max=rows_max, bw=bw, seed=seed)
    arrivals = poisson_arrivals(offered_rps, n_requests, seed=seed)

    if net is not None:
        async def main():
            async with ServingTier(net, config) as tier:
                t0 = time.perf_counter()
                res = await _open_loop(tier.infer, requests, arrivals)
                wall = time.perf_counter() - t0
                return (*res, wall, tier.stats(), tier.latency_breakdown())
    else:
        from repro_torch.serve.ingress import HttpClientPool
        host, _, port = url.removeprefix("http://").partition(":")

        async def main():
            # keep-alive pool: requests reuse warm connections, so the
            # timed run measures the server's admission path rather than
            # a TCP handshake per request
            pool = HttpClientPool(host, int(port), size=16, tenant=tenant)
            try:
                t0 = time.perf_counter()
                res = await _open_loop(pool.infer, requests, arrivals)
                wall = time.perf_counter() - t0
            finally:
                await pool.close()
            return (*res, wall, {}, {})

    outs, lats, outcomes, wall, stats, breakdown = asyncio.run(main())
    ref = verify_net if verify_net is not None else net
    if check_outputs and ref is not None:
        for req, out, oc in zip(requests, outs, outcomes):
            if oc == "ok":
                np.testing.assert_array_equal(out, _to_numpy(ref(req)))
    counts: dict[str, int] = {}
    for oc in outcomes:
        counts[oc] = counts.get(oc, 0) + 1
    n_ok = counts.get("ok", 0)
    ok_lat_ms = np.sort(lats[~np.isnan(lats)]) * 1e3
    ok_rows = int(sum(r.shape[0] for r, oc in zip(requests, outcomes)
                      if oc == "ok"))
    return LoadReport(
        n_clients=0,
        n_requests=n_requests,
        rows=ok_rows,
        wall_s=wall,
        p50_ms=_percentile(ok_lat_ms, 50),
        p90_ms=_percentile(ok_lat_ms, 90),
        p99_ms=_percentile(ok_lat_ms, 99),
        mean_ms=float(ok_lat_ms.mean()) if n_ok else float("nan"),
        qps=n_ok / wall,
        rows_per_sec=ok_rows / wall,
        stats=stats,
        breakdown=breakdown,
        offered_rps=float(offered_rps),
        goodput_rps=n_ok / wall,
        rejected=counts.get("rejected_quota", 0)
        + counts.get("rejected_overload", 0) + counts.get("closed", 0),
        timed_out=counts.get("timeout", 0),
        rejection_rate=1.0 - n_ok / n_requests if n_requests else 0.0,
        outcomes=counts,
    )
