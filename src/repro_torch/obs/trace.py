"""Lightweight request-span tracing: where did this request's latency go?

A :class:`Span` is a named sequence of monotonic timestamps
(``time.perf_counter``): created at the first stage, ``mark(stage)``
appends one, and the finished span yields per-stage durations.  The
serving tier attaches one span to every request over its lifecycle::

    enqueue -> flush -> dispatch -> done
      |queue wait|assembly|device time|

* **queue wait** (``enqueue -> flush``) — time spent queued before the
  batcher's flush decision took the request into a batch;
* **assembly** (``flush -> dispatch``) — batch concatenation + executor
  hand-off, host-side work on the batch path;
* **device time** (``dispatch -> done``) — the padded batch inside the
  engine's forward on the device, result included.

Marking costs one ``perf_counter()`` call and a list append — cheap
enough to stay on unconditionally.  Finished spans
feed stage histograms in the metrics registry; the tier keeps the last
few in a ring for debugging (``ServingTier.recent_spans()``).
"""

from __future__ import annotations

import time

# the serving tier's request lifecycle, in order
REQUEST_STAGES = ("enqueue", "flush", "dispatch", "done")


class Span:
    """An ordered list of (stage, monotonic timestamp) marks."""

    __slots__ = ("name", "marks")

    def __init__(self, name: str, first_stage: str = "enqueue",
                 t: float | None = None) -> None:
        self.name = name
        self.marks: list[tuple[str, float]] = [
            (first_stage, time.perf_counter() if t is None else t)]

    def mark(self, stage: str, t: float | None = None) -> None:
        """Record ``stage`` at ``t`` (default: now).  Out-of-order
        timestamps are accepted — the batcher stamps whole batches with
        shared times — but stages must be unique within one span."""
        self.marks.append((stage, time.perf_counter() if t is None else t))

    def duration(self, a: str, b: str) -> float:
        """Seconds from stage ``a`` to stage ``b`` (KeyError if absent)."""
        times = dict(self.marks)
        return times[b] - times[a]

    def durations(self) -> dict[str, float]:
        """``{"stage_a->stage_b": seconds}`` between consecutive marks."""
        return {f"{a}->{c}": t2 - t1
                for (a, t1), (c, t2) in zip(self.marks, self.marks[1:])}

    @property
    def total(self) -> float:
        """Seconds from the first mark to the last."""
        return self.marks[-1][1] - self.marks[0][1]

    def as_dict(self) -> dict:
        return {"name": self.name,
                "stages": [s for s, _ in self.marks],
                "durations": self.durations(),
                "total": self.total}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        legs = " ".join(f"{k}={v * 1e3:.2f}ms"
                        for k, v in self.durations().items())
        return f"<Span {self.name} {legs}>"
