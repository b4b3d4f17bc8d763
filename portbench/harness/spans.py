"""The span segment of a traced run: the program's step spans on, device
time and launches put down to them, and idle gaps named by harness phase
and program span.

It runs as :func:`trace.traced` does (the same markers, lead units, stand
checks and tries), with the program's spans on
(``repro_torch.obs.trace.spans_enabled``) and the profiler recording CPU
activity too, so the trace holds each span as a host range beside the
kernel launches.  Every kernel, copy and fill of a measured unit goes to
exactly one span path or to ``outside``:

1. the innermost span open on the thread that launched it (the runtime
   call with the record's correlation id, on the thread of the operator
   it was launched from), at the launch: remat's recomputed ``attn`` and
   ``ffn`` on autograd's thread too;
2. else, inside autograd's ``evaluate_function`` range, the span that
   enclosed that node's forward operator (the profiler's ``sequence_nr``
   and ``fwd_thread_id``), grafted under the span open on the stepping
   thread: a backward record of the FFN is ``train_step/backward/ffn``;
3. else the innermost span open on the stepping thread at the launch.

A span's parent is the innermost span open on its own thread at its
start, else the one open on the stepping thread then; its path joins the
names from the top.  So the paths' device time sums to the unit's.  An
idle gap is named ``<harness phase>/<span>``: the innermost span open at
the gap's midpoint on the thread that launched the record ending the
gap (else on the stepping thread).  The profiler's host overhead widens
this segment's gaps; its device time a span does not depend on them.

A segment that does not stand after its tries, or a program without
spans, gives None, and the plain segment's readings stand alone.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import re
import time

from portbench.harness.log import note
from portbench.harness.trace import (KINDS, MARKER_CYCLES, Phases, _union,
                                     no_phases)

# the CUDA API's calls on the host (cudaLaunchKernel, cuLaunchKernelEx,
# cudaMemcpyAsync, ...): no operator is named so
LAUNCH = re.compile(r"cu(da)?[A-Z]")
BACKWARD_NODE = "autograd::engine::evaluate_function"
OUTSIDE = "outside"


def _flatten(intervals):
    """Nested ``(start, end, value)`` intervals of one thread as
    ``(times, values)``: ``values[i]`` is the innermost one open from
    ``times[i]`` to ``times[i + 1]`` (None where none is)."""
    times, values, stack = [], [], []

    def mark(t):
        v = stack[-1][2] if stack else None
        if times and times[-1] == t:
            values[-1] = v
        else:
            times.append(t)
            values.append(v)

    for iv in sorted(intervals, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= iv[0]:
            mark(stack.pop()[1])
        stack.append(iv)
        mark(iv[0])
    while stack:
        mark(stack.pop()[1])
    return times, values


def _at(timeline, t):
    times, values = timeline
    i = bisect.bisect_right(times, t) - 1
    return values[i] if i >= 0 else None


@dataclasses.dataclass
class _Span:
    name: str
    thread: int
    start: float
    end: float
    path: str = ""


class Program:
    """The host side of one profile: spans, launches, autograd's backward
    nodes and the forward operators they came from."""

    def __init__(self, spans, launches, ops, nodes, forward_ops):
        # spans: [(name, thread, start, end)]; launches: {correlation:
        # (start, thread, linked operator)}; ops: {correlation: thread};
        # nodes: [(start, end, thread, sequence_nr, forward thread)];
        # forward_ops: {(thread, sequence_nr): start}
        self.spans = [_Span(*s) for s in sorted(spans, key=lambda s: s[2])]
        self.launches, self.ops = launches, ops
        self.forward_ops = forward_ops
        by_thread: dict[int, list] = {}
        for s in self.spans:
            by_thread.setdefault(s.thread, []).append((s.start, s.end, s))
        self.open = {t: _flatten(iv) for t, iv in by_thread.items()}
        node_iv: dict[int, list] = {}
        for a, b, t, seq, fwd in nodes:
            node_iv.setdefault(t, []).append((a, b, (seq, fwd)))
        self.nodes = {t: _flatten(iv) for t, iv in node_iv.items()}
        self.stepping = None

    def set_stepping(self, thread) -> None:
        """Name the harness's thread and give every span its path."""
        if thread is None and self.spans:
            thread = self.spans[0].thread
        self.stepping = thread
        stacks: dict[int, list] = {}
        for s in sorted(self.spans, key=lambda s: (s.start, -s.end)):
            stack = stacks.setdefault(s.thread, [])
            while stack and stack[-1].end <= s.start:
                stack.pop()
            parent = stack[-1] if stack else None
            if parent is None and s.thread != thread:
                parent = self.innermost(thread, s.start)
            s.path = f"{parent.path}/{s.name}" if parent else s.name
            stack.append(s)

    def innermost(self, thread, t):
        line = self.open.get(thread)
        return _at(line, t) if line else None

    def launch(self, correlation):
        """``(thread, host time)`` of a device record's launch (the thread
        of the operator it was launched from, else the runtime call's), or
        None."""
        found = self.launches.get(correlation)
        if found is None:
            return None
        t, thread, op = found
        return self.ops.get(op, thread), t

    def path(self, correlation) -> str:
        """The span path a device record goes to (``OUTSIDE`` if its launch
        is not in the trace or no span is open)."""
        found = self.launch(correlation)
        if found is None:
            return OUTSIDE
        thread, t = found
        s = self.innermost(thread, t)
        if s is not None:
            return s.path
        step = self.innermost(self.stepping, t)
        if thread != self.stepping and thread in self.nodes:
            key = _at(self.nodes[thread], t)
            start = self.forward_ops.get((key[1], key[0])) if key else None
            linked = (self.innermost(key[1], start) if start is not None
                      else None)
            if linked is not None and step is not None:
                return _graft(step.path, linked.path)
        return step.path if step is not None else OUTSIDE


def _graft(here: str, linked: str) -> str:
    """The path of a backward record under ``here`` whose forward ran
    under ``linked``: ``linked`` below the spans the two share and the
    forward's own phase (``train_step/forward/ffn`` under
    ``train_step/backward`` gives ``train_step/backward/ffn``)."""
    a, b = here.split("/"), linked.split("/")
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return "/".join(a + b[n + 1:])


def program(events) -> Program:
    """The host side of a profile's raw records."""
    from torch.autograd import DeviceType
    spans, launches, ops, nodes, forward_ops = [], {}, {}, [], {}
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        start = e.start_ns() / 1e3
        if e.is_user_annotation():
            spans.append((e.name(), e.start_thread_id(), start,
                          e.end_ns() / 1e3))
        elif LAUNCH.match(e.name()):
            launches[e.correlation_id()] = (start, e.start_thread_id(),
                                            e.linked_correlation_id())
        else:
            thread = e.start_thread_id()
            ops[e.correlation_id()] = thread
            seq = e.sequence_nr()
            if e.name().startswith(BACKWARD_NODE):
                nodes.append((start, e.end_ns() / 1e3, thread, seq,
                              e.fwd_thread_id()))
            elif seq >= 0 and e.fwd_thread_id() == 0:
                key = (thread, seq)
                forward_ops[key] = min(forward_ops.get(key, math.inf), start)
    return Program(spans, launches, ops, nodes, forward_ops)


def kind(name: str) -> str:
    """A kernel's kind by its name (``trace.KINDS``, else ``other``)."""
    low = name.lower()
    return next((k for k, subs in KINDS if any(x in low for x in subs)),
                "other")


def device_records(events, span_names) -> list:
    """``(start, end, name, correlation)`` of every kernel, copy and fill,
    in µs, by start: the device's records but a span's projection onto
    the device's timeline, which bears the span's name."""
    from torch.autograd import DeviceType
    return sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(),
                   e.correlation_id()) for e in events
                  if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation()
                  and e.name() not in span_names)


@dataclasses.dataclass
class SpanTrace:
    units: list      # per measured unit: {"key", "device_s", "by_path":
    #                  {path: [device s, records]}, "by_kind": {path:
    #                  {kind: device s}}, "spans": spans opened}
    busy_s: float
    window_s: float
    gaps: dict       # {"<phase>/<span>": idle s}
    tries: int

    def _mean(self, value) -> float:
        return sum(value(u) for u in self.units) / len(self.units)

    def span_s(self, name: str) -> float:
        """Device seconds a unit under every span called ``name``."""
        return self._mean(lambda u: sum(
            s for p, (s, _) in u["by_path"].items()
            if name in p.split("/")))

    def records(self) -> float:
        """Device records (kernels, copies, fills) a unit."""
        return self._mean(lambda u: sum(n for _, n in u["by_path"].values()))

    def by_path(self) -> dict:
        """``{path: (device s, records)}`` a unit."""
        out: dict[str, list] = {}
        for u in self.units:
            for p, (s, n) in u["by_path"].items():
                acc = out.setdefault(p, [0.0, 0])
                acc[0] += s / len(self.units)
                acc[1] += n / len(self.units)
        return {p: tuple(v) for p, v in sorted(out.items())}

    def by_path_kind(self) -> dict:
        """``{path: {kind: device s}}`` a unit (kinds as
        :meth:`trace.Trace.by_kind`'s)."""
        out: dict[str, dict] = {}
        for u in self.units:
            for p, kinds in u["by_kind"].items():
                acc = out.setdefault(p, {})
                for k, s in kinds.items():
                    acc[k] = acc.get(k, 0.0) + s / len(self.units)
        return dict(sorted(out.items()))

    def conservation(self) -> float:
        """The largest gap over the units between the paths' device time
        (``outside`` included) and the unit's, over the unit's."""
        return max(abs(sum(s for s, _ in u["by_path"].values())
                       - u["device_s"]) / u["device_s"] for u in self.units)

    def fallback_share(self, name: str) -> float:
        """Of the device time under ``name``, the share put down to a span
        called ``name`` itself (in the backward pass: records linked to no
        span of the forward)."""
        total = self.span_s(name)
        own = self._mean(lambda u: sum(
            s for p, (s, _) in u["by_path"].items()
            if p.split("/")[-1] == name))
        return own / total if total else 0.0

    def breakdown(self, n: int = 10) -> dict:
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"idle_gaps": [[k, v] for k, v in gaps]}


def read(prof, n: int, phases: Phases, host0_us: float, keys: list):
    """``(SpanTrace, "")`` from a profile, or ``(None, why)`` when it
    does not stand (the rules of :func:`trace._read`)."""
    events = list(prof.profiler.kineto_results.events())
    prog = program(events)
    records = device_records(events, {s.name for s in prog.spans})
    marks = [i for i, r in enumerate(records) if "spin_kernel" in r[2]]
    if len(marks) != n + 1:
        return None, f"{len(marks)} of {n + 1} markers"
    # each marker's launch bounds a unit on the host's side
    hosts = [prog.launch(records[m][3]) for m in marks]
    prog.set_stepping(hosts[0][0] if hosts[0] else None)
    units, counts = [], {}
    for k, (key, a, b) in enumerate(zip(keys, marks, marks[1:])):
        run = records[a + 1:b]
        by_path: dict[str, list] = {}
        by_kind: dict[str, dict] = {}
        for start, end, name, corr in run:
            path = prog.path(corr)
            acc = by_path.setdefault(path, [0.0, 0])
            acc[0] += (end - start) / 1e6
            acc[1] += 1
            kinds = by_kind.setdefault(path, {})
            kinds[kind(name)] = (kinds.get(kind(name), 0.0)
                                 + (end - start) / 1e6)
        opened = (sum(hosts[k][1] <= s.start < hosts[k + 1][1]
                      for s in prog.spans)
                  if hosts[k] and hosts[k + 1] else None)
        units.append({"key": key, "by_path": by_path, "by_kind": by_kind,
                      "spans": opened,
                      "device_s": sum(e - s for s, e, _, _ in run) / 1e6})
        counts.setdefault(key, []).append(len(run))
    if any(len(set(c)) > 1 for c in counts.values()):
        return None, f"records a unit by shape {counts}"
    w0, w1 = records[marks[0]][1], records[marks[-1]][0]
    inner = [r for r in records[marks[0] + 1:marks[-1]]
             if "spin_kernel" not in r[2]]
    busy = _union((s, e) for s, e, _, _ in inner)
    # the record that opens each busy interval, and the last marker
    opener = {}
    for r in inner:
        opener.setdefault(r[0], r[3])
    offset = records[marks[0]][0] - host0_us
    host = sorted((a * 1e6 + offset, b * 1e6 + offset, name)
                  for name, a, b in phases.spans)
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        phase = next((nm for s, e, nm in host if s <= mid <= e), "loop")
        found = prog.launch(opener.get(b, records[marks[-1]][3]))
        span = prog.innermost(found[0], mid) if found else None
        span = span or prog.innermost(prog.stepping, mid)
        name = f"{phase}/{span.name}" if span else phase
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return SpanTrace(units=units, busy_s=sum(b - a for a, b in busy) / 1e6,
                     window_s=(w1 - w0) / 1e6, gaps=gaps, tries=0), ""


def traced(run_unit, n: int, lead: int = 1, tries: int = 3):
    """The span segment of ``n`` units of ``run_unit(phases) -> key``, as
    :func:`trace.traced` runs the plain one; None when the program has no
    spans or no try stands."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        from repro_torch.obs.trace import spans_enabled
    except ImportError:
        note("span segment: the program has no step spans")
        return None
    why = ""
    for attempt in range(1, tries + 1):
        phases, keys = Phases(), []
        with spans_enabled(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                run_unit(no_phases)
            torch.cuda.synchronize()
            host0 = time.perf_counter() * 1e6
            for k in range(n):
                torch.cuda._sleep(MARKER_CYCLES)
                keys.append(run_unit(phases))
            torch.cuda._sleep(MARKER_CYCLES)
            run_unit(no_phases)
            torch.cuda.synchronize()
        spans, why = read(prof, n, phases, host0, keys)
        if spans is not None:
            spans.tries = attempt
            return spans
    note(f"span segment: no trace of {tries} stood: {why}")
    return None


def _ms(name: str):
    return lambda spans: 1e3 * spans.span_s(name)


# each per-layer metric of the span segment: (unit, its reading of a
# SpanTrace); the suffix names the kind of cell that reports it
METRICS = {"forward_ms.train": ("ms", _ms("forward")),
           "backward_ms.train": ("ms", _ms("backward")),
           "adamw_ms.train": ("ms", _ms("adamw")),
           "attn_ms.train": ("ms", _ms("attn")),
           "ffn_ms.train": ("ms", _ms("ffn")),
           "loss_ms.train": ("ms", _ms("loss")),
           "launches_per_step.train": ("count", SpanTrace.records),
           "attn_ms.prefill": ("ms", _ms("attn")),
           "ffn_ms.prefill": ("ms", _ms("ffn")),
           "launches_per_call.prefill": ("count", SpanTrace.records)}


def metric(name: str, spans: SpanTrace | None):
    """The metric ``name`` of a span segment, None without one."""
    return None if spans is None else METRICS[name][1](spans)


def add_to_line(line: dict, kind: str, spans: SpanTrace | None) -> dict:
    """A traced run's result ``line`` with the span segment's metrics of a
    ``kind`` cell ("train", "prefill") added and its idle gaps named by
    span; ``line`` unchanged without a segment."""
    if spans is None:
        return line
    metrics = dict(line["metrics"])
    for name, (unit, _) in METRICS.items():
        if name.endswith("." + kind):
            metrics[name] = {"value": metric(name, spans), "unit": unit}
    breakdown = dict(line.get("breakdown", {}),
                     idle_gaps=spans.breakdown()["idle_gaps"])
    return dict(line, metrics=metrics, breakdown=breakdown)
