"""Operator-facing exporters: the one-line reporter and summary text.

``summary_line(registry)`` compresses the serving stack's metrics into a
single log line (requests, batches, stage latencies, compile-once
counters); :class:`PeriodicReporter` prints it from a daemon thread every
``interval_s`` while a load run is in flight — the ``python -m
repro_torch.launch.serve --lut`` CLI starts one so long-running serves are not
silent between start and the final report.
"""

from __future__ import annotations

import sys
import threading

from repro_torch.obs.metrics import Registry, registry as default_registry


def _sum_series(snapshot: dict, name: str, field: str = "value") -> float:
    entry = snapshot.get(name)
    if not entry:
        return 0.0
    return sum(s.get(field, 0.0) for s in entry["series"])


def _hist_totals(snapshot: dict, name: str) -> tuple[int, float]:
    entry = snapshot.get(name)
    if not entry:
        return 0, 0.0
    return (int(sum(s["count"] for s in entry["series"])),
            sum(s["sum"] for s in entry["series"]))


def summary_line(reg: Registry | None = None) -> str:
    """One line of the serving stack's state, for periodic logging."""
    snap = (reg or default_registry()).snapshot()
    requests = _sum_series(snap, "serve_requests_total")
    rows = _sum_series(snap, "serve_rows_total")
    batches = _sum_series(snap, "serve_batches_total")
    parts = [f"requests={requests:.0f}", f"rows={rows:.0f}",
             f"batches={batches:.0f}"]
    for label, name in (("queue_wait", "serve_queue_wait_seconds"),
                        ("device", "serve_device_seconds")):
        n, total = _hist_totals(snap, name)
        if n:
            parts.append(f"{label}_mean={total / n * 1e3:.2f}ms")
    retr = _sum_series(snap, "serve_retraces_after_warmup")
    cruns = _sum_series(snap, "serve_compiler_runs_after_warmup")
    parts.append(f"retraces={retr:.0f}")
    parts.append(f"compiler_runs={cruns:.0f}")
    return "[obs] " + " ".join(parts)


class PeriodicReporter:
    """Daemon thread printing :func:`summary_line` every ``interval_s``.

    Start/stop explicitly or use as a context manager; ``stop()`` joins
    the thread, so nothing prints after it returns.  A non-positive
    interval disables the thread entirely (the CLI's ``--report-every-s
    0``).
    """

    def __init__(self, interval_s: float = 5.0,
                 reg: Registry | None = None, stream=None) -> None:
        self.interval_s = interval_s
        self._reg = reg or default_registry()
        self._stream = stream if stream is not None else sys.stderr
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "PeriodicReporter":
        if self.interval_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="obs-reporter", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            print(summary_line(self._reg), file=self._stream, flush=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "PeriodicReporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
