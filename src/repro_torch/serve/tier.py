"""Async micro-batching serving tier over ``CompiledLUTNet`` replicas.

The port of ``repro.serve.tier``.  Per-request work is a few thousand
table lookups, so the host-side request loop — not the kernel — is where a
serving stack squanders the hardware.  This module is the request side of
``repro_torch.engine``:

* **micro-batching** — incoming requests (each a ragged ``(rows, n_in)``
  code batch) are coalesced into ``block_b``-bucketed batches and flushed
  either when ``max_batch_rows`` rows have accumulated or when the oldest
  request has waited ``flush_deadline_s`` (size-or-deadline flush);
* **data-parallel replicas** — the tier holds one replica of the artifact
  on each of ``TierConfig.devices`` (every visible card by default) and
  splits each padded batch into one equal row shard a device, every
  shard launched (each on its replica's own CUDA stream) before any is
  waited on, the outputs joined in row order: the reference's
  ``shard_map`` over ``("data",)``.  One device runs the engine call as
  it is;
* **backpressure** — the queue is bounded at ``max_queue_rows`` queued
  rows; a request that would overflow it is rejected immediately with
  :class:`TierOverloaded` instead of growing an unbounded backlog;
* **per-request timeouts** — a request that has not been *launched* into a
  batch within ``request_timeout_s`` is dropped with
  :class:`RequestTimeout` (a request whose batch is already computing
  always gets its result);
* **compile-once steady state** — ``start()`` warms every batch bucket
  (building the kernel library on the card), so a steady-state serving
  loop performs **zero kernel builds and zero compiler runs**
  (``stats()["retraces_after_warmup"]`` /
  ``["compiler_runs_after_warmup"]``, the reference's key names).

Example::

    import asyncio
    import numpy as np
    from repro_torch import engine, serve

    net = engine.load("model_a_l3.npz")          # on cuda

    async def main():
        async with serve.ServingTier(net) as tier:
            out = await tier.infer(np.zeros((3, net.n_in), np.int32))
            print(out.shape, tier.stats()["batches"])

    asyncio.run(main())

Outputs are bit-exact with calling the ``CompiledLUTNet`` directly on the
same rows — coalescing and padding are pure layout.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import itertools
import math
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import engine as rengine
from repro_torch import obs

# each tier instance gets its own label value so per-tier stats stay
# separable in the shared process registry (stats() reads them back)
_TIER_IDS = itertools.count()


class _TierMetrics:
    """This tier's labeled children in the process metrics registry.

    One instance per ServingTier: counters mirror the ``stats()`` fields,
    the stage histograms are fed by the per-request spans (queue wait /
    batch assembly / device time), and the two ``*_after_warmup`` gauges
    carry the compile-once contract into the snapshot.
    """

    def __init__(self, tier_id: str) -> None:
        reg = obs.registry()
        t = {"tier": tier_id}

        def ctr(name, help_):
            return reg.counter(name, help_, labels=("tier",)).labels(**t)

        def hist(name, help_):
            return reg.histogram(name, help_, labels=("tier",)).labels(**t)

        def gauge(name, help_):
            return reg.gauge(name, help_, labels=("tier",)).labels(**t)

        self.requests = ctr("serve_requests_total",
                            "requests accepted by the serving tier")
        self.rows = ctr("serve_rows_total", "request rows accepted")
        self.batches = ctr("serve_batches_total", "coalesced batches run")
        self.padded_rows = ctr("serve_padded_rows_total",
                               "kernel rows launched incl. bucket padding")
        self.rejected = ctr("serve_rejected_total",
                            "requests rejected by backpressure")
        self.timed_out = ctr("serve_timed_out_total",
                             "requests expired before launch")
        self.expired_rows = ctr("serve_expired_rows_total",
                                "rows dropped by request timeouts")
        self.flush = reg.counter(
            "serve_flush_total", "batch flushes by cause",
            labels=("tier", "cause"))
        self.flush_by_cause = {
            cause: self.flush.labels(tier=tier_id, cause=cause)
            for cause in ("size", "deadline", "drain")}
        self.queue_wait = hist(
            "serve_queue_wait_seconds",
            "enqueue -> flush decision (span leg: queue wait)")
        self.assembly = hist(
            "serve_assembly_seconds",
            "flush -> device dispatch (batch concat + executor hand-off)")
        self.device = hist(
            "serve_device_seconds",
            "device dispatch -> completion (padded batch forward)")
        self.latency = hist(
            "serve_request_latency_seconds",
            "enqueue -> completion (whole request span)")
        self.queued_rows = gauge("serve_queued_rows",
                                 "rows currently queued")
        self.retraces = gauge(
            "serve_retraces_after_warmup",
            "kernel-library builds added after warmup (compile-once: must "
            "stay 0)")
        self.compiler_runs = gauge(
            "serve_compiler_runs_after_warmup",
            "compiler runs after warmup (compile-once: must stay 0)")


class TierError(Exception):
    """Base class for serving-tier request failures."""


class TierOverloaded(TierError):
    """The bounded request queue is full — the request was rejected."""


class TierClosed(TierError):
    """The tier is stopped (or stopping) and accepts no new requests."""


class RequestTimeout(TierError):
    """The request expired before its batch was launched."""


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Knobs of the micro-batching serving tier.

    * ``max_batch_rows`` — flush a batch once this many rows are queued
      (None: the artifact's ``block_b``).  A single request larger than
      this forms its own batch.
    * ``flush_deadline_s`` — flush a non-empty partial batch once its
      oldest request has waited this long (the latency bound under light
      load).
    * ``max_queue_rows`` — bounded-queue backpressure: a request that
      would push the queued-row count past this is rejected with
      :class:`TierOverloaded`.
    * ``request_timeout_s`` — per-request launch deadline; ``None``
      disables timeouts.
    * ``devices`` — torch devices for data-parallel batch sharding, one
      replica of the artifact and one row shard an entry (None: every
      visible CUDA device, or the artifact's own device when it is on
      the CPU).  One device means no sharding at all.  A device may
      repeat (``("cpu",) * 4``, ``("cuda:0", "cuda:0")``): torch has no
      multi-device CPU, and on a one-card machine the split runs only
      so; each entry holds a replica and a CUDA stream of its own.
    * ``warmup`` — run every batch bucket once in ``start()`` (on every
      replica) so steady state builds nothing.
    """

    max_batch_rows: int | None = None
    flush_deadline_s: float = 0.005
    max_queue_rows: int = 4096
    request_timeout_s: float | None = None
    devices: tuple | None = None
    warmup: bool = True


@dataclasses.dataclass
class _Request:
    codes: np.ndarray            # (rows, n_in) int32
    future: asyncio.Future       # resolves to (rows, n_out) np.ndarray
    enqueue_t: float
    deadline_t: float | None     # absolute launch deadline (None: never)
    span: obs.Span               # enqueue -> flush -> dispatch -> done


class ServingTier:
    """Async micro-batching front-end over one :class:`CompiledLUTNet`.

    Drive it from an event loop: ``await tier.start()`` (or ``async with
    ServingTier(net) as tier``), then any number of concurrent
    ``await tier.infer(codes)`` calls, then ``await tier.stop()``.
    ``infer`` accepts ``(rows, n_in)`` or a single ``(n_in,)`` row and
    returns the matching ``(rows, n_out)`` / ``(n_out,)`` int32 numpy
    output, bit-exact with ``net(codes)``.  Batches run on the replicas
    of ``TierConfig.devices``.
    """

    def __init__(self, net, config: TierConfig | None = None):
        cfg = config or TierConfig()
        self._net = net
        self._cfg = cfg
        # the artifact's ExecutionPlan is the source of truth for the batch
        # tile (an autotuned artifact may have picked a non-default
        # block_b); net.block_b is the fallback for plan-less stand-ins
        block_b = getattr(getattr(net, "plan", None), "block_b", None) \
            or net.block_b
        self._max_batch = cfg.max_batch_rows or block_b
        if self._max_batch <= 0:
            raise ValueError("max_batch_rows must be positive")
        own = getattr(net, "device", torch.device("cpu"))
        devices = tuple(torch.device(d) for d in cfg.devices or (
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if own.type == "cuda" else [own]))
        if not devices:
            raise ValueError("TierConfig.devices is empty")
        self._devices = devices
        self._replicas = _replicas(net, devices)
        self._sharded = len(devices) > 1
        self._streams = [torch.cuda.Stream(d) if self._sharded
                         and d.type == "cuda" else None for d in devices]
        # batches are padded to a multiple of this unit: block_b keeps the
        # engine on its bucket, len(devices) the row shards equal
        self._bucket_unit = math.lcm(block_b, len(devices))
        self._pending: collections.deque[_Request] = collections.deque()
        self._queued_rows = 0
        self._wake = asyncio.Event()
        self._stopping = False
        self._task: asyncio.Task | None = None
        self._started = False
        # every stats() counter lives in the process metrics registry
        # (labeled per tier); stats() reads them back
        self._metrics = _TierMetrics(str(next(_TIER_IDS)))
        self._recent_spans: collections.deque[obs.Span] = (
            collections.deque(maxlen=32))
        self._builds0 = 0
        self._compiler_runs0 = 0

    def _bucket(self, rows: int) -> int:
        return -(-rows // self._bucket_unit) * self._bucket_unit

    def _run_batch(self, batch: np.ndarray):
        """Pad to the bucket, run the forward, copy the result back, slice.

        Returns ``(out, padded_rows, t_dispatch, t_done)`` — the two
        timestamps bracket the device leg of every request span in the
        batch (copying the result to the host included).
        """
        rows = batch.shape[0]
        padded_rows = self._bucket(rows)
        if padded_rows != rows:
            batch = np.concatenate(
                [batch, np.zeros((padded_rows - rows, batch.shape[1]),
                                 dtype=batch.dtype)], axis=0)
        t_dispatch = time.perf_counter()
        if not self._sharded:
            out = _to_numpy(self._replicas[0](batch))[:rows]
            return out, padded_rows, t_dispatch, time.perf_counter()
        # every shard launched before any is waited on: each replica's
        # engine forward (no padding: the shard is the bucket's share),
        # enqueued on its own stream
        outs = []
        for net, stream, shard in zip(self._replicas, self._streams,
                                      np.split(batch, len(self._replicas))):
            with _on(stream):
                outs.append(net._apply(torch.from_numpy(shard).to(
                    net.device)))
        out = np.concatenate([_fetch(o, stream) for o, stream in
                              zip(outs, self._streams)])[:rows]
        return out, padded_rows, t_dispatch, time.perf_counter()

    def _sync(self) -> None:
        for dev in set(self._devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "ServingTier":
        """Warm the batch buckets and start the batcher task."""
        if self._started:
            raise TierError("tier already started")
        self._started = True
        if self._cfg.warmup:
            loop = asyncio.get_running_loop()
            for rows in range(self._bucket_unit,
                              self._bucket(self._max_batch) + 1,
                              self._bucket_unit):
                zeros = np.zeros((rows, self._net.n_in), dtype=np.int32)
                await loop.run_in_executor(None, self._run_batch, zeros)
            self._sync()
        self._builds0 = self._net.kernel_builds()
        self._compiler_runs0 = rengine.compile_runs()
        self._task = asyncio.create_task(self._batcher())
        return self

    async def stop(self) -> None:
        """Drain queued requests into final batches, then shut down.

        Safe on an empty queue (returns as soon as the batcher notices);
        requests submitted after ``stop`` raise :class:`TierClosed`.
        """
        if not self._started or self._stopping:
            return
        self._stopping = True
        self._wake.set()
        if self._task is not None:
            await self._task

    async def __aenter__(self) -> "ServingTier":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- request path -------------------------------------------------------

    async def infer(self, codes) -> np.ndarray:
        """Submit one request; resolves when its batch has been served.

        ``codes`` is ``(rows, n_in)`` (or one ``(n_in,)`` row) of int
        codes.  Raises :class:`TierOverloaded` when the bounded queue is
        full, :class:`RequestTimeout` when the request expires before
        launch, :class:`TierClosed` when the tier is stopped, and
        ``ValueError`` on a shape mismatch.

        >>> import asyncio, numpy as np
        >>> from repro_torch import engine, serve
        >>> rng = np.random.default_rng(0)
        >>> idx = np.stack([np.sort(rng.choice(6, 2, replace=False))
        ...                 for _ in range(4)]).astype(np.int32)
        >>> tbl = rng.integers(0, 4, (4, 16), dtype=np.int32)
        >>> net = engine.compile_network([(idx, tbl, 2)], in_features=6,
        ...                              block_b=4, device="cpu")
        >>> async def main():
        ...     async with serve.ServingTier(net) as tier:
        ...         codes = rng.integers(0, 4, (3, 6), dtype=np.int32)
        ...         out = await tier.infer(codes)
        ...         return codes, out, tier.stats()
        >>> codes, out, stats = asyncio.run(main())
        >>> bool((out == net(codes).numpy()).all())        # bit-exact
        True
        >>> stats["retraces_after_warmup"]                 # compile-once
        0
        """
        arr = np.asarray(codes, dtype=np.int32)
        single = arr.ndim == 1
        if single:
            arr = arr[None, :]
        if arr.ndim != 2 or arr.shape[1] != self._net.n_in:
            raise ValueError(
                f"expected (rows, {self._net.n_in}) codes, got "
                f"{np.asarray(codes).shape}")
        if self._stopping or not self._started:
            raise TierClosed("serving tier is not accepting requests")
        rows = arr.shape[0]
        if rows == 0:
            return arr.reshape(0, self._net.n_out)
        if self._queued_rows + rows > self._cfg.max_queue_rows:
            self._metrics.rejected.inc()
            raise TierOverloaded(
                f"queue holds {self._queued_rows} rows; request of {rows} "
                f"would exceed max_queue_rows={self._cfg.max_queue_rows}")
        loop = asyncio.get_running_loop()
        now = loop.time()
        deadline = (None if self._cfg.request_timeout_s is None
                    else now + self._cfg.request_timeout_s)
        req = _Request(arr, loop.create_future(), now, deadline,
                       obs.Span("request"))
        self._pending.append(req)
        self._queued_rows += rows
        self._metrics.requests.inc()
        self._metrics.rows.inc(rows)
        self._wake.set()
        out = await req.future
        return out[0] if single else out

    # -- batcher ------------------------------------------------------------

    def _expire_overdue(self, now: float) -> None:
        while self._pending:
            req = self._pending[0]
            if req.deadline_t is None or now < req.deadline_t:
                break
            self._pending.popleft()
            self._queued_rows -= req.codes.shape[0]
            self._metrics.timed_out.inc()
            self._metrics.expired_rows.inc(req.codes.shape[0])
            if not req.future.done():
                req.future.set_exception(RequestTimeout(
                    f"request waited past request_timeout_s="
                    f"{self._cfg.request_timeout_s}"))

    def _take_batch(self) -> list[_Request]:
        taken, rows = [], 0
        while self._pending:
            nxt = self._pending[0].codes.shape[0]
            if taken and rows + nxt > self._max_batch:
                break
            taken.append(self._pending.popleft())
            rows += nxt
            self._queued_rows -= nxt
            if rows >= self._max_batch:
                break
        return taken

    async def _batcher(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            while not self._pending and not self._stopping:
                self._wake.clear()
                await self._wake.wait()
            now = loop.time()
            self._expire_overdue(now)
            if not self._pending:
                if self._stopping:
                    break
                continue
            # size-or-deadline coalescing window, bounded by the oldest
            # request's timeout so an expiring request is noticed in time
            cause = "drain" if self._stopping else None
            while not self._stopping:
                if self._queued_rows >= self._max_batch:
                    cause = "size"
                    break
                oldest = self._pending[0]
                flush_at = oldest.enqueue_t + self._cfg.flush_deadline_s
                if oldest.deadline_t is not None:
                    flush_at = min(flush_at, oldest.deadline_t)
                remaining = flush_at - loop.time()
                if remaining <= 0:
                    cause = "deadline"
                    break
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), remaining)
                except asyncio.TimeoutError:
                    pass
            self._expire_overdue(loop.time())
            batch = self._take_batch()
            if not batch:
                continue
            cause = cause or "drain"
            t_flush = time.perf_counter()   # the flush decision: queue
            codes = (batch[0].codes if len(batch) == 1 else
                     np.concatenate([r.codes for r in batch], axis=0))
            try:
                out, padded_rows, t_dispatch, t_done = (
                    await loop.run_in_executor(None, self._run_batch, codes))
            except Exception as exc:               # pragma: no cover
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(
                            TierError(f"batch execution failed: {exc!r}"))
                continue
            self._metrics.batches.inc()
            self._metrics.padded_rows.inc(padded_rows)
            self._metrics.flush_by_cause[cause].inc()
            off = 0
            for req in batch:
                n = req.codes.shape[0]
                if not req.future.done():
                    req.future.set_result(out[off:off + n])
                off += n
                # close the request span with the batch's shared
                # timestamps and feed the stage histograms
                span = req.span
                span.mark("flush", t_flush)
                span.mark("dispatch", t_dispatch)
                span.mark("done", t_done)
                self._metrics.queue_wait.observe(
                    span.duration("enqueue", "flush"))
                self._metrics.assembly.observe(
                    span.duration("flush", "dispatch"))
                self._metrics.device.observe(
                    span.duration("dispatch", "done"))
                self._metrics.latency.observe(span.total)
                self._recent_spans.append(span)
        # post-drain: anything that slipped in after the final drain pass
        while self._pending:
            req = self._pending.popleft()
            self._queued_rows -= req.codes.shape[0]
            if not req.future.done():
                req.future.set_exception(TierClosed("tier stopped"))

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        """Steady-state serving counters (``loadgen.LoadReport`` builds the
        latency/QPS view on top of these).

        ``batch_occupancy`` is served rows / padded batch capacity — the
        fraction of kernel work doing real requests rather than bucket
        padding.  ``retraces_after_warmup`` (kernel-library builds, the
        port's counterpart of jit traces; the library is one a process,
        so the count covers every replica) and
        ``compiler_runs_after_warmup`` are the compile-once serving
        contract and must stay exactly 0 in steady state.  ``n_devices``
        counts the entries of ``TierConfig.devices``, ``sharded`` whether
        there is more than one, ``bucket_unit`` the row multiple batches
        pad to.  The same counters live in the process metrics
        registry (``repro_torch.obs``, labeled per tier); this dict is the
        flat view of this tier's slice of it, with the reference's keys.
        """
        m = self._metrics
        n_rows = int(m.rows.value)
        n_batches = int(m.batches.value)
        n_padded = int(m.padded_rows.value)
        served_rows = n_rows - int(m.expired_rows.value) - self._queued_rows
        retraces = self._net.kernel_builds() - self._builds0
        compiler_runs = rengine.compile_runs() - self._compiler_runs0
        # mirror the point-in-time quantities into the registry so a
        # snapshot taken after the run carries the compile-once contract
        m.queued_rows.set(self._queued_rows)
        m.retraces.set(retraces)
        m.compiler_runs.set(compiler_runs)
        return {
            "requests": int(m.requests.value),
            "rows": n_rows,
            "batches": n_batches,
            "padded_rows": n_padded,
            "batch_occupancy": served_rows / n_padded if n_padded else 0.0,
            "mean_batch_rows": (served_rows / n_batches
                                if n_batches else 0.0),
            "flush_causes": {cause: int(c.value)
                             for cause, c in m.flush_by_cause.items()},
            "rejected": int(m.rejected.value),
            "timed_out": int(m.timed_out.value),
            "queued_rows": self._queued_rows,
            "n_devices": len(self._devices),
            "sharded": self._sharded,
            "bucket_unit": self._bucket_unit,
            "max_batch_rows": self._max_batch,
            "retraces_after_warmup": retraces,
            "compiler_runs_after_warmup": compiler_runs,
        }

    def latency_breakdown(self) -> dict:
        """Per-stage latency summary from this tier's span histograms.

        ``{stage: {count, mean_ms, p50_ms, p99_ms}}`` for the three span
        legs (``queue_wait``, ``assembly``, ``device``) plus the whole
        request (``total``) — the "where did the latency go" view that
        ``loadgen.LoadReport.breakdown`` surfaces.  Percentiles are bucket-interpolated estimates;
        a stage with no observations reports zeros.
        """
        m = self._metrics
        out = {}
        for stage, h in (("queue_wait", m.queue_wait),
                         ("assembly", m.assembly),
                         ("device", m.device),
                         ("total", m.latency)):
            n = h.count
            out[stage] = {
                "count": n,
                "mean_ms": h.mean() * 1e3 if n else 0.0,
                "p50_ms": h.quantile(0.5) * 1e3 if n else 0.0,
                "p99_ms": h.quantile(0.99) * 1e3 if n else 0.0,
            }
        return out

    def recent_spans(self) -> list[obs.Span]:
        """The most recent completed request spans (bounded ring)."""
        return list(self._recent_spans)

    @property
    def replicas(self) -> tuple:
        """The replicas, one an entry of ``TierConfig.devices``; a sharded
        batch calls each one's ``_apply`` once, on its row shard."""
        return tuple(self._replicas)


async def serve_once(net, requests, config: TierConfig | None = None
                     ) -> list[np.ndarray]:
    """Convenience: start a tier, serve ``requests`` concurrently, stop.

    ``requests`` is an iterable of ``(rows, n_in)`` arrays; returns the
    outputs in order::

        outs = asyncio.run(serve.serve_once(net, [r0, r1, r2]))
    """
    async with ServingTier(net, config) as tier:
        return list(await asyncio.gather(
            *[tier.infer(r) for r in requests]))


def run_requests(net, requests, config: TierConfig | None = None
                 ) -> list[np.ndarray]:
    """Blocking wrapper over :func:`serve_once` for sync callers/tests."""
    return asyncio.run(serve_once(net, requests, config))


def _replicas(net, devices) -> list:
    """One replica of ``net`` a device of ``devices``: ``net`` itself for
    the first entry on its own device, every other a copy made by the
    engine's own artifact path (``save``, then ``load(..., device=)``),
    so each holds the same slabs, plan and kernel route, and a repeated
    device holds one a entry."""
    own = _device_key(getattr(net, "device", torch.device("cpu")))
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        path = None
        for dev in devices:
            if _device_key(dev) == own and net not in out:
                out.append(net)
                continue
            path = path or net.save(os.path.join(tmp, "replica.npz"))
            out.append(rengine.load(path, device=dev))
    return out


def _device_key(dev: torch.device) -> str:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing for a CPU replica."""
    return contextlib.nullcontext() if stream is None else \
        torch.cuda.stream(stream)


def _fetch(out: torch.Tensor, stream) -> np.ndarray:
    """A shard's output copied to the host on its replica's stream (the
    copy waits for the forward there)."""
    with _on(stream):
        return _to_numpy(out)


def _to_numpy(out) -> np.ndarray:
    """An engine result (a torch tensor on any device) as a numpy array."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)
