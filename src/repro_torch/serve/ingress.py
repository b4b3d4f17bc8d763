"""HTTP ingress for the micro-batching serving tier (stdlib asyncio only).

The port of ``repro.serve.ingress``: the network front door of
:class:`~repro_torch.serve.ServingTier`, built on ``asyncio.start_server``
so the package's runtime dependencies stay torch + numpy:

* **inference endpoint** — ``POST /v1/infer`` terminates JSON
  (``{"codes": [[...], ...]}`` -> ``{"outputs": [[...], ...]}``) or raw
  int8 bodies (``application/octet-stream``: ``rows * n_in`` int8 codes in,
  ``rows * n_out`` int8 codes out) and feeds ``ServingTier.infer`` — the
  response is bit-exact with calling the artifact directly, through the
  kernel the engine chose on the artifact's device;
* **per-tenant admission** — a token-bucket row quota keyed by the tenant
  header (default ``x-tenant``) sits *in front of* the tier's row-bound
  backpressure: the bucket refills at ``rate_rows_per_s`` up to
  ``burst_rows``, and a request whose rows exceed the tenant's balance is
  rejected with **429** before it can occupy queue space;
* **typed error mapping** — every failure is an HTTP status carrying a JSON
  body, never a wedged connection: quota rejection -> **429**,
  :class:`TierOverloaded` -> **503**, :class:`RequestTimeout` -> **408**,
  :class:`TierClosed` (draining) -> **503**, malformed request -> **400**,
  oversized body -> **413**, unknown route -> **404**, wrong method ->
  **405**;
* **operations endpoints** — ``GET /metrics`` renders the process
  :class:`repro_torch.obs.Registry` as Prometheus text exposition,
  ``GET /healthz`` reports draining state + tier counters;
* **graceful drain** — ``stop()`` (the CLI wires it to SIGTERM) stops
  accepting connections, answers new inference requests with 503
  ``draining``, lets in-flight requests finish, and drains the tier's
  queue into final batches.

Keep-alive HTTP/1.1 is supported (the open-loop load generator and curl
both reuse connections); TLS, HTTP/2 and gRPC are out of scope.

The tier runs each batch in its event loop's executor thread and copies
the result to the host there (``serve.tier._to_numpy``), so the ingress
only ever sees host arrays: the artifact stays on its device, and the
kernels launch on that thread's current stream.

The per-request metrics: ``ingress_requests_total`` by route/status,
``ingress_rejected_total`` by reason, the decode/infer stage histograms
and the open-connection gauge.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch.serve.tier import (RequestTimeout, ServingTier,
                                    TierClosed, TierConfig, TierError,
                                    TierOverloaded, _to_numpy)

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}


class QuotaExceeded(TierError):
    """The tenant's token-bucket row quota is exhausted (HTTP 429)."""


@dataclasses.dataclass(frozen=True)
class QuotaConfig:
    """Per-tenant admission quota (a token bucket over request *rows*).

    Each tenant (the value of the tenant header; absent -> the shared
    ``default`` tenant) gets its own bucket holding up to ``burst_rows``
    tokens, refilled continuously at ``rate_rows_per_s``.  A request
    costing ``rows`` tokens is admitted only if the bucket holds that
    many; otherwise it is rejected with 429 *before* touching the tier's
    queue — quota protects tenants from each other, backpressure
    (``max_queue_rows``) protects the process from everyone.
    """

    rate_rows_per_s: float
    burst_rows: float | None = None   # default: one second of rate

    @property
    def burst(self) -> float:
        return (self.rate_rows_per_s if self.burst_rows is None
                else self.burst_rows)


class TokenBucket:
    """Continuous-refill token bucket; time source injectable for tests."""

    __slots__ = ("rate", "burst", "_tokens", "_t")

    def __init__(self, rate: float, burst: float,
                 now: float | None = None) -> None:
        if rate <= 0 or burst <= 0:
            raise ValueError("token bucket rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t = time.monotonic() if now is None else now

    def try_take(self, n: float, now: float | None = None) -> bool:
        """Take ``n`` tokens if available; refill happens lazily here."""
        now = time.monotonic() if now is None else now
        if now > self._t:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
        self._t = max(self._t, now)
        if n <= self._tokens:
            self._tokens -= n
            return True
        return False

    @property
    def tokens(self) -> float:
        return self._tokens


@dataclasses.dataclass(frozen=True)
class IngressConfig:
    """Knobs of the HTTP front-end (the tier has its own ``TierConfig``).

    * ``host`` / ``port`` — listen address; port ``0`` binds an ephemeral
      port (read it back from ``HttpIngress.port`` — tests and the
      ``--http 0`` CLI do).
    * ``quota`` — per-tenant :class:`QuotaConfig`; ``None`` disables
      admission control entirely (the tier's backpressure still applies).
    * ``tenant_header`` / ``default_tenant`` — where the tenant id comes
      from and what an anonymous request maps to.
    * ``max_body_bytes`` — requests larger than this get 413 without
      being buffered further.
    """

    host: str = "127.0.0.1"
    port: int = 0
    quota: QuotaConfig | None = None
    tenant_header: str = "x-tenant"
    default_tenant: str = "default"
    max_body_bytes: int = 8 << 20


class _IngressMetrics:
    """The ingress's slice of the process metrics registry."""

    def __init__(self) -> None:
        reg = obs.registry()
        self.requests = reg.counter(
            "ingress_requests_total", "HTTP requests by route and status",
            labels=("route", "status"))
        self.rejected = reg.counter(
            "ingress_rejected_total",
            "inference requests rejected, by reason "
            "(quota / overloaded / timeout / draining)",
            labels=("reason",))
        self.request_seconds = reg.histogram(
            "ingress_request_seconds",
            "whole HTTP request (read -> response flushed)")
        self.decode_seconds = reg.histogram(
            "ingress_decode_seconds",
            "request body parse + validation (JSON or raw int8)")
        self.infer_seconds = reg.histogram(
            "ingress_infer_seconds",
            "await ServingTier.infer (queue wait + batch + device)")
        self.connections = reg.gauge(
            "ingress_open_connections", "currently open HTTP connections")


class HttpIngress:
    """Asyncio HTTP server owning one :class:`ServingTier` over ``net``.

    Lifecycle: ``await ingress.start()`` (starts the tier — warmup
    included — then binds the listener), any number of concurrent HTTP
    requests, ``await ingress.stop()`` (graceful drain).  Use
    :class:`BackgroundIngress` to run it from synchronous code.
    """

    def __init__(self, net, tier_config: TierConfig | None = None,
                 config: IngressConfig | None = None):
        self._net = net
        self._cfg = config or IngressConfig()
        self.tier = ServingTier(net, tier_config)
        self._buckets: dict[str, TokenBucket] = {}
        self._server: asyncio.AbstractServer | None = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._draining = False
        self._metrics = _IngressMetrics()
        self.port: int | None = None

    @property
    def url(self) -> str:
        return f"http://{self._cfg.host}:{self.port}"

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "HttpIngress":
        await self.tier.start()
        self._server = await asyncio.start_server(
            self._handle_connection, self._cfg.host, self._cfg.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        """Graceful drain: stop accepting, finish in-flight, drain tier."""
        if self._draining:
            return
        self._draining = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        await self.tier.stop()

    async def __aenter__(self) -> "HttpIngress":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- connection handling ------------------------------------------------

    async def _handle_connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        self._metrics.connections.inc(1)
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except ValueError as exc:
                    # the framing is unreadable (or the body too large to
                    # buffer): answer, then close, since the stream's
                    # position is lost
                    await self._refuse(writer, exc)
                    break
                if req is None:
                    break
                keep_alive = await self._dispatch(req, writer)
                if not keep_alive or self._draining:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                                   # client went away
        finally:
            self._metrics.connections.inc(-1)
            self._conn_tasks.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:                # pragma: no cover
                pass

    async def _read_request(self, reader):
        """One HTTP/1.x request -> (method, path, headers, body) or None.

        ``None`` means the peer closed between requests (normal keep-alive
        teardown); malformed framing raises ``ValueError`` (answered 400)
        and a body over ``max_body_bytes`` raises ``_TooLarge`` (413).
        """
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise ValueError(f"malformed request line {line!r}")
        method, target, version = parts
        headers: dict[str, str] = {}
        while True:
            raw = await reader.readline()
            if raw in (b"\r\n", b"\n"):
                break
            if not raw:
                return None
            key, _, value = raw.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or "0")
        if length > self._cfg.max_body_bytes:
            raise _TooLarge(length)
        body = await reader.readexactly(length) if length else b""
        return method, target.split("?", 1)[0], version, headers, body

    async def _dispatch(self, req, writer) -> bool:
        t0 = time.perf_counter()
        method, path, version, headers, body = req
        keep_alive = (headers.get("connection", "").lower() != "close"
                      and not version.endswith("/1.0"))
        route = path if path in ("/v1/infer", "/healthz", "/metrics") else "*"
        try:
            if path == "/v1/infer":
                if method != "POST":
                    status, payload, ctype = 405, _err("method_not_allowed",
                                                       "POST only"), None
                else:
                    status, payload, ctype = await self._infer(headers, body)
            elif path == "/healthz":
                status, payload, ctype = self._healthz(method)
            elif path == "/metrics":
                status, payload, ctype = self._metrics_page(method)
            else:
                status, payload, ctype = 404, _err(
                    "not_found", f"no route {path}"), None
        except Exception as exc:                   # pragma: no cover
            status, payload, ctype = 500, _err("internal", repr(exc)), None
        await self._respond(writer, status, payload, ctype, keep_alive)
        self._metrics.requests.labels(route=route, status=str(status)).inc()
        self._metrics.request_seconds.observe(time.perf_counter() - t0)
        return keep_alive

    async def _refuse(self, writer, exc: ValueError) -> None:
        """Answer a request whose framing could not be read, and count it
        under route ``*``."""
        if isinstance(exc, _TooLarge):
            status, payload = 413, _err(
                "payload_too_large", f"body of {exc.args[0]} bytes exceeds "
                f"max_body_bytes={self._cfg.max_body_bytes}")
        else:
            status, payload = 400, _err("bad_request", str(exc))
        await self._respond(writer, status, payload, None, False)
        self._metrics.requests.labels(route="*", status=str(status)).inc()

    async def _respond(self, writer, status, payload, ctype, keep_alive):
        if ctype is None:
            body = json.dumps(payload).encode()
            ctype = "application/json"
        else:
            body = payload
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
                f"content-type: {ctype}\r\n"
                f"content-length: {len(body)}\r\n"
                f"connection: {'keep-alive' if keep_alive else 'close'}"
                "\r\n\r\n")
        writer.write(head.encode("latin-1") + body)
        await writer.drain()

    # -- routes -------------------------------------------------------------

    async def _infer(self, headers, body):
        """POST /v1/infer: decode -> quota -> tier -> encode."""
        m = self._metrics
        if self._draining:
            m.rejected.labels(reason="draining").inc()
            return 503, _err("draining", "ingress is shutting down"), None
        t_dec = time.perf_counter()
        raw = (headers.get("content-type", "application/json")
               .split(";")[0].strip() == "application/octet-stream")
        try:
            codes = self._decode(body, raw)
        except ValueError as exc:
            return 400, _err("bad_request", str(exc)), None
        m.decode_seconds.observe(time.perf_counter() - t_dec)

        tenant = headers.get(self._cfg.tenant_header,
                             self._cfg.default_tenant) or \
            self._cfg.default_tenant
        quota = self._cfg.quota
        if quota is not None:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets.setdefault(
                    tenant, TokenBucket(quota.rate_rows_per_s, quota.burst))
            if not bucket.try_take(codes.shape[0]):
                m.rejected.labels(reason="quota").inc()
                return 429, _err(
                    "quota_exceeded",
                    f"tenant {tenant!r} exceeded "
                    f"{quota.rate_rows_per_s:g} rows/s "
                    f"(burst {quota.burst:g})"), None

        t_inf = time.perf_counter()
        try:
            out = await self.tier.infer(codes)
        except TierOverloaded as exc:
            m.rejected.labels(reason="overloaded").inc()
            return 503, _err("overloaded", str(exc)), None
        except RequestTimeout as exc:
            m.rejected.labels(reason="timeout").inc()
            return 408, _err("timeout", str(exc)), None
        except TierClosed:
            m.rejected.labels(reason="draining").inc()
            return 503, _err("draining", "serving tier is stopping"), None
        m.infer_seconds.observe(time.perf_counter() - t_inf)

        out = _to_numpy(out)
        if raw:
            return 200, np.asarray(out, np.int8).tobytes(), \
                "application/octet-stream"
        return 200, {"outputs": out.tolist()}, None

    def _decode(self, body: bytes, raw: bool) -> np.ndarray:
        n_in = self._net.n_in
        if raw:
            if len(body) % n_in:
                raise ValueError(
                    f"octet-stream body of {len(body)} bytes is not a "
                    f"multiple of n_in={n_in}")
            return np.frombuffer(body, np.int8).reshape(-1, n_in) \
                .astype(np.int32)
        try:
            obj = json.loads(body or b"{}")
        except json.JSONDecodeError as exc:
            raise ValueError(f"body is not valid JSON: {exc}") from exc
        if not isinstance(obj, dict) or "codes" not in obj:
            raise ValueError('JSON body must be {"codes": [[...], ...]}')
        codes = np.asarray(obj["codes"], dtype=np.int32)
        if codes.ndim == 1:
            codes = codes[None, :]
        if codes.ndim != 2 or codes.shape[1] != n_in:
            raise ValueError(
                f"expected (rows, {n_in}) codes, got shape "
                f"{tuple(codes.shape)}")
        return codes

    def _healthz(self, method):
        if method != "GET":
            return 405, _err("method_not_allowed", "GET only"), None
        st = self.tier.stats()
        return 200, {
            "status": "draining" if self._draining else "ok",
            "queued_rows": st["queued_rows"],
            "requests": st["requests"],
            "batches": st["batches"],
            "retraces_after_warmup": st["retraces_after_warmup"],
            "compiler_runs_after_warmup": st["compiler_runs_after_warmup"],
        }, None

    def _metrics_page(self, method):
        if method != "GET":
            return 405, _err("method_not_allowed", "GET only"), None
        text = obs.registry().render_prometheus()
        return 200, text.encode(), "text/plain; version=0.0.4"


class _TooLarge(ValueError):
    pass


def _err(error: str, detail: str) -> dict:
    return {"error": error, "detail": detail}


# ---------------------------------------------------------------------------
# Async HTTP client (the open-loop load generator's and tests' counterpart)
# ---------------------------------------------------------------------------

def _encode_infer_request(host: str, port: int, codes: np.ndarray, *,
                          tenant: str | None, raw: bool,
                          close: bool) -> bytes:
    """Wire bytes of one ``POST /v1/infer`` (shared by the one-shot client
    and the keep-alive pool; ``close`` controls ``connection: close``)."""
    if raw:
        body = codes.astype(np.int8).tobytes()
        ctype = "application/octet-stream"
    else:
        body = json.dumps({"codes": codes.tolist()}).encode()
        ctype = "application/json"
    headers = ["POST /v1/infer HTTP/1.1", f"host: {host}:{port}",
               f"content-type: {ctype}", f"content-length: {len(body)}"]
    if close:
        headers.append("connection: close")
    if tenant is not None:
        headers.append(f"x-tenant: {tenant}")
    return ("\r\n".join(headers) + "\r\n\r\n").encode() + body


def _decode_infer_response(status: int, headers: dict, body: bytes,
                           rows: int) -> np.ndarray:
    """The inverse of the server's status mapping: 429 ->
    :class:`QuotaExceeded`, 503 -> :class:`TierOverloaded` (or
    :class:`TierClosed` when the body says ``draining``), 408 ->
    :class:`RequestTimeout`, anything else non-200 -> :class:`TierError`.
    """
    if status == 200:
        if headers.get("content-type", "").startswith(
                "application/octet-stream"):
            return np.frombuffer(body, np.int8) \
                .reshape(rows, -1).astype(np.int32)
        return np.asarray(json.loads(body)["outputs"], np.int32)
    detail = _error_detail(body)
    if status == 429:
        raise QuotaExceeded(detail)
    if status == 408:
        raise RequestTimeout(detail)
    if status == 503:
        if "draining" in detail:
            raise TierClosed(detail)
        raise TierOverloaded(detail)
    raise TierError(f"HTTP {status}: {detail}")


async def _close_connection(conn) -> None:
    _, writer = conn
    writer.close()
    try:
        await writer.wait_closed()
    except ConnectionError:                        # pragma: no cover
        pass


async def http_infer(host: str, port: int, codes: np.ndarray, *,
                     tenant: str | None = None, raw: bool = True,
                     timeout_s: float = 60.0) -> np.ndarray:
    """One ``POST /v1/infer`` round trip; raises the tier's typed errors.

    Opens (and closes) a fresh connection per call — fine for tests and
    one-shots; a load generator should use :class:`HttpClientPool`, which
    reuses keep-alive connections and so measures server behavior rather
    than connection-setup cost.  ``raw`` uses the int8 octet-stream
    encoding (the cheap path); ``raw=False`` posts JSON.
    """
    codes = np.asarray(codes, dtype=np.int32)
    payload = _encode_infer_request(host, port, codes, tenant=tenant,
                                    raw=raw, close=True)
    conn = await asyncio.open_connection(host, port)
    reader, writer = conn
    try:
        writer.write(payload)
        await writer.drain()
        status, resp_headers, resp_body = await asyncio.wait_for(
            _read_response(reader), timeout_s)
    finally:
        await _close_connection(conn)
    return _decode_infer_response(status, resp_headers, resp_body,
                                  codes.shape[0])


class HttpClientPool:
    """Keep-alive ``POST /v1/infer`` client over a bounded connection pool.

    The load generator's counterpart to the server's persistent
    connections: up to ``size`` concurrent requests each hold one pooled
    connection (opened lazily, reused across requests), so an open-loop
    sweep exercises the *server's* admission path instead of paying — and
    measuring — a TCP handshake per request (which flattered rejection
    latency under overload).

    A request that finds its reused connection dead (the server dropped a
    stale keep-alive) retries once on a fresh connection; server-level
    errors map to the same typed exceptions as :func:`http_infer`.
    ``close()`` drains the pool — call it only after in-flight requests
    finished (the loadgen awaits its workers first).
    """

    def __init__(self, host: str, port: int, *, size: int = 8,
                 tenant: str | None = None, raw: bool = True,
                 timeout_s: float = 60.0):
        self._host, self._port = host, int(port)
        self._tenant, self._raw = tenant, raw
        self._timeout_s = timeout_s
        # each slot is either a live (reader, writer) pair or None (open
        # lazily on first use); the bounded queue is the concurrency gate
        self._slots: asyncio.Queue = asyncio.Queue()
        for _ in range(max(1, int(size))):
            self._slots.put_nowait(None)
        self._closed = False

    async def infer(self, codes: np.ndarray, *,
                    tenant: str | None = None) -> np.ndarray:
        """One inference round trip on a pooled keep-alive connection."""
        if self._closed:
            raise RuntimeError("HttpClientPool is closed")
        codes = np.asarray(codes, dtype=np.int32)
        tenant = self._tenant if tenant is None else tenant
        payload = _encode_infer_request(self._host, self._port, codes,
                                        tenant=tenant, raw=self._raw,
                                        close=False)
        conn = await self._slots.get()
        reused = conn is not None
        try:
            while True:
                if conn is None:
                    conn = await asyncio.open_connection(self._host,
                                                         self._port)
                reader, writer = conn
                try:
                    writer.write(payload)
                    await writer.drain()
                    status, headers, body = await asyncio.wait_for(
                        _read_response(reader), self._timeout_s)
                except asyncio.TimeoutError:
                    # connection state unknown mid-response: never reuse
                    await _close_connection(conn)
                    conn = None
                    raise
                except (ConnectionError, asyncio.IncompleteReadError):
                    await _close_connection(conn)
                    conn = None
                    if reused:
                        # stale keep-alive connection — one fresh retry
                        reused = False
                        continue
                    raise
                if headers.get("connection", "").lower() == "close":
                    await _close_connection(conn)
                    conn = None
                return _decode_infer_response(status, headers, body,
                                              codes.shape[0])
        finally:
            self._slots.put_nowait(conn)

    async def close(self) -> None:
        """Close every idle pooled connection and refuse further infers."""
        self._closed = True
        while not self._slots.empty():
            conn = self._slots.get_nowait()
            if conn is not None:
                await _close_connection(conn)


async def _read_response(reader):
    line = (await reader.readline()).decode("latin-1")
    parts = line.split()
    if len(parts) < 2:
        raise TierError(f"malformed response status line {line!r}")
    status = int(parts[1])
    headers: dict[str, str] = {}
    while True:
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n", b""):
            break
        key, _, value = raw.decode("latin-1").partition(":")
        headers[key.strip().lower()] = value.strip()
    length = int(headers.get("content-length", "0") or "0")
    body = await reader.readexactly(length) if length else b""
    return status, headers, body


def _error_detail(body: bytes) -> str:
    try:
        obj = json.loads(body)
        return f"{obj.get('error', '?')}: {obj.get('detail', '')}"
    except (json.JSONDecodeError, AttributeError):
        return body.decode("latin-1", "replace")[:200]


# ---------------------------------------------------------------------------
# Background runner: the ingress on its own event-loop thread
# ---------------------------------------------------------------------------

class BackgroundIngress:
    """Run an :class:`HttpIngress` on a dedicated event-loop thread.

    The shape synchronous callers need — the ``--http`` CLI,
    ``chip_smoke.py`` and the tests drive a live localhost server while
    staying ordinary blocking code::

        with BackgroundIngress(net) as ing:
            rep = serve.run_open_loop(url=ing.url, offered_rps=200,
                                      n_requests=50, verify_net=net)

    ``stats()`` reads the tier's counters (thread-safe) while the server
    runs; leaving the context performs the graceful drain.
    """

    def __init__(self, net, tier_config: TierConfig | None = None,
                 config: IngressConfig | None = None):
        self._net = net
        self._tier_cfg = tier_config
        self._cfg = config
        self._ready = threading.Event()
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop_evt: asyncio.Event | None = None
        self._startup_exc: BaseException | None = None
        self.ingress: HttpIngress | None = None

    def start(self) -> "BackgroundIngress":
        if self._thread is not None:
            raise TierError("ingress already started")
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._main()),
            name="http-ingress", daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._startup_exc is not None:
            self._thread.join()
            raise self._startup_exc
        return self

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop_evt = asyncio.Event()
        try:
            self.ingress = HttpIngress(self._net, self._tier_cfg, self._cfg)
            await self.ingress.start()
        except BaseException as exc:
            self._startup_exc = exc
            self._ready.set()
            return
        self._ready.set()
        await self._stop_evt.wait()
        await self.ingress.stop()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._loop.call_soon_threadsafe(self._stop_evt.set)
        self._thread.join()
        self._thread = None

    @property
    def port(self) -> int:
        return self.ingress.port

    @property
    def url(self) -> str:
        return self.ingress.url

    def stats(self) -> dict:
        """The owned tier's counter snapshot (safe while serving)."""
        return self.ingress.tier.stats()

    def __enter__(self) -> "BackgroundIngress":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
