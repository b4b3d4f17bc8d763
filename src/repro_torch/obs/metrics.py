"""Dependency-free metrics primitives: counters, gauges, histograms.

The port's own copy of ``repro.obs.metrics`` (stdlib only, same metric
names and snapshot format), with a process registry of its own.  The
serving stack (tier -> engine) needs stage-level visibility — "where did
this request's latency go?" — without pulling a metrics client into a
package whose runtime dependencies are torch + numpy.  This module is
the substrate:

* :class:`Counter` — monotonically increasing float (``_total`` names);
* :class:`Gauge` — a settable level (queue depth, steady-state deltas);
* :class:`Histogram` — fixed bucket edges chosen at registration time
  (so two snapshots are always mergeable/comparable), plus ``sum`` and
  ``count``; ``quantile()`` gives the standard linearly-interpolated
  bucket estimate;
* labeled families — ``registry.counter("serve_flush_total",
  labels=("tier", "cause"))`` returns a :class:`Family` whose
  ``labels(tier="0", cause="size")`` children are created on first use
  and cached;
* :class:`Registry` — the name -> metric table with an atomic
  ``snapshot()`` (JSON-ready dict) and Prometheus-style
  ``render_prometheus()`` text exposition.

Thread-safety: metric mutation happens on the asyncio loop *and* in the
tier's executor threads, so every metric guards its state with its own
``threading.Lock`` and ``Registry.snapshot()`` reads each metric under
that lock — a snapshot never observes a histogram whose ``count`` and
bucket counts disagree.  The hot path stays a few lock-guarded float
adds: no allocation, no rendering, no I/O.
"""

from __future__ import annotations

import bisect
import json
import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# serving latencies live in the 100us..1s decades on the CPU and sub-ms
# on the card; the default edges cover both with ~2-2.5x spacing
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def _fmt(v: float) -> str:
    """Prometheus number formatting: integral values without the '.0'."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Counter:
    """A monotonically increasing value.  ``inc(n)`` with ``n >= 0``."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _snapshot(self) -> float:
        return self.value


class Gauge:
    """A value that can go up and down (queue depth, contract deltas)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket histogram: per-bucket counts + sum + count.

    ``edges`` are the inclusive upper bounds of the finite buckets (must
    be strictly increasing); one overflow (+Inf) bucket is implicit.
    ``observe(v)`` costs one bisect + two adds under the metric lock.
    """

    __slots__ = ("_lock", "edges", "_counts", "_sum", "_count")

    def __init__(self, edges=DEFAULT_TIME_BUCKETS) -> None:
        edges = tuple(float(e) for e in edges)
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        if any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"bucket edges must strictly increase: {edges}")
        self._lock = threading.Lock()
        self.edges = edges
        self._counts = [0] * (len(edges) + 1)   # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _snapshot(self) -> dict:
        with self._lock:
            return {"buckets": list(self.edges),
                    "counts": list(self._counts),
                    "sum": self._sum, "count": self._count}

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (0 <= q <= 1).

        The standard Prometheus ``histogram_quantile`` scheme: find the
        bucket holding the q-th observation and interpolate linearly
        inside it.  Returns ``nan`` on an empty histogram; an estimate
        landing in the +Inf bucket clamps to the largest finite edge.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        snap = self._snapshot()
        total = snap["count"]
        if total == 0:
            return float("nan")
        rank = q * total
        cum = 0.0
        for i, c in enumerate(snap["counts"]):
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self.edges):          # +Inf bucket
                    return self.edges[-1]
                lo = 0.0 if i == 0 else self.edges[i - 1]
                hi = self.edges[i]
                return lo + (hi - lo) * (1.0 - (cum - rank) / c)
        return self.edges[-1]

    def mean(self) -> float:
        snap = self._snapshot()
        return snap["sum"] / snap["count"] if snap["count"] else float("nan")


class Family:
    """A labeled metric family: one child metric per label-value tuple."""

    __slots__ = ("_lock", "label_names", "_make", "_children")

    def __init__(self, label_names: tuple[str, ...], make) -> None:
        self._lock = threading.Lock()
        self.label_names = label_names
        self._make = make
        self._children: dict[tuple[str, ...], object] = {}

    def labels(self, **labels):
        """The child metric for this label set (created on first use)."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"expected labels {self.label_names}, got {tuple(labels)}")
        key = tuple(str(labels[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make())
        return child

    def _series(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class Registry:
    """Name -> metric table with atomic snapshot + text exposition.

    Registration is idempotent: asking for an existing name returns the
    existing metric, but re-registering under a different type, label
    set or bucket edges raises (two call sites silently disagreeing on a
    metric's meaning is the bug this catches).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, dict] = {}   # name -> entry

    # -- registration -------------------------------------------------------

    def _register(self, name: str, mtype: str, help_: str,
                  labels: tuple[str, ...], make):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            entry = self._metrics.get(name)
            if entry is not None:
                if entry["type"] != mtype or entry["labels"] != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{entry['type']}{entry['labels']}; cannot "
                        f"re-register as {mtype}{labels}")
                if (mtype == "histogram" and not labels
                        and entry["metric"].edges != make().edges):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"different bucket edges")
                return entry["metric"]
            metric = Family(labels, make) if labels else make()
            self._metrics[name] = {"type": mtype, "help": help_,
                                   "labels": labels, "metric": metric}
            return metric

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Counter | Family:
        return self._register(name, "counter", help, tuple(labels), Counter)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> Gauge | Family:
        return self._register(name, "gauge", help, tuple(labels), Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_TIME_BUCKETS,
                  labels: tuple[str, ...] = ()) -> Histogram | Family:
        edges = tuple(float(b) for b in buckets)
        return self._register(name, "histogram", help, tuple(labels),
                              lambda: Histogram(edges))

    def get(self, name: str):
        """The registered metric (or Family) under ``name``; None if
        absent — readers (stats bridges, tests) use this so a read never
        implicitly registers."""
        with self._lock:
            entry = self._metrics.get(name)
            return entry["metric"] if entry else None

    # -- export -------------------------------------------------------------

    def _entries(self) -> list[tuple[str, dict]]:
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self) -> dict:
        """JSON-ready view of every metric: ``{name: {type, help,
        label_names, series: [{labels, value|buckets...}]}}``.

        Each *series* is read under its metric's lock, so any single
        metric is internally consistent (histogram ``count`` == sum of
        its bucket counts) even while other threads keep incrementing.
        """
        out: dict = {}
        for name, entry in self._entries():
            metric, labels = entry["metric"], entry["labels"]
            if labels:
                series = [
                    {"labels": dict(zip(labels, key)),
                     **self._value_dict(entry["type"], child)}
                    for key, child in metric._series()]
            else:
                series = [{"labels": {},
                           **self._value_dict(entry["type"], metric)}]
            out[name] = {"type": entry["type"], "help": entry["help"],
                         "label_names": list(labels), "series": series}
        return out

    @staticmethod
    def _value_dict(mtype: str, metric) -> dict:
        snap = metric._snapshot()
        return snap if mtype == "histogram" else {"value": snap}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4) of the registry."""
        lines: list[str] = []
        for name, entry in sorted(self.snapshot().items()):
            if entry["help"]:
                lines.append(f"# HELP {name} {entry['help']}")
            lines.append(f"# TYPE {name} {entry['type']}")
            for series in entry["series"]:
                lbl = series["labels"]
                if entry["type"] == "histogram":
                    cum = 0
                    for edge, c in zip(series["buckets"], series["counts"]):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{_label_str({**lbl, 'le': _fmt(edge)})} {cum}")
                    cum += series["counts"][-1]
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str({**lbl, 'le': '+Inf'})} {cum}")
                    lines.append(
                        f"{name}_sum{_label_str(lbl)} "
                        f"{_fmt(series['sum'])}")
                    lines.append(
                        f"{name}_count{_label_str(lbl)} {series['count']}")
                else:
                    lines.append(
                        f"{name}{_label_str(lbl)} {_fmt(series['value'])}")
        return "\n".join(lines) + "\n"

    def dump_json(self, path: str) -> str:
        """Write ``snapshot()`` as JSON (the ``--metrics-json`` payload)."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


# the port's process-default registry: the serving tier and engine record
# here so one snapshot covers the whole stack (tests needing isolation
# construct their own Registry)
REGISTRY = Registry()


def registry() -> Registry:
    """The process-default :class:`Registry`."""
    return REGISTRY
