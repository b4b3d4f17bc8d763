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

Step spans name the parts of the LM train and prefill steps
(``train_step``, ``forward``, ``backward``, ``nan_guard``, ``adamw``,
``prefill_step``; inside the model ``attn``, ``ffn``, ``head``, ``loss``).
``with span(name):`` is free while spans are off, the default: it returns
one shared no-op context after one module-level check.  Inside
``spans_enabled()`` it opens a ``torch.profiler.record_function`` range,
so a profiler that records CPU activity puts the span on the same
timeline as the kernels it launched (a Chrome or TensorBoard trace shows
it); without a profiler the range records nothing.  Spans add no device
work and change no number.
"""

from __future__ import annotations

import contextlib
import time

# the serving tier's request lifecycle, in order
REQUEST_STAGES = ("enqueue", "flush", "dispatch", "done")

_NO_SPAN = contextlib.nullcontext()
# ``torch.profiler.record_function`` while spans are on, else None
_record = None


def span(name: str):
    """A context naming a part of a step: the shared no-op while spans are
    off, else a ``record_function`` range called ``name``."""
    if _record is None:
        return _NO_SPAN
    return _record(name)


@contextlib.contextmanager
def spans_enabled():
    """Turn step spans on, for every thread of the process, inside the
    ``with`` block (autograd's threads open the spans of a recomputed
    layer too)."""
    global _record
    from torch.profiler import record_function
    before, _record = _record, record_function
    try:
        yield
    finally:
        _record = before


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
